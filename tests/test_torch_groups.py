"""The port's grouped rwm chunk runner against the JAX package's, draw for draw.

Adaptation groups (kernel.py:404-429, 583-599, 697-745, 1467-1635 and
1931-1969 of the JAX package): each group has its own L, moments and
acceptance window.  Contiguous equal blocks run as reshapes and batched
products, irregular ``group_ids`` as ``index_add_`` and gathers.  The
draws are replayed from the JAX key as ``tests/test_torch_kernel.py``
does (``split(key, 3)``, normal, uniform per step) and injected through
``noise=``; every state array and output is compared after each of three
chunks with adaptation, in float64 at rtol 1e-9.  The cases cover the
per-group covariance refresh, ``covariance_source="ensemble"`` and the
per-group ``best-value`` refresh, each for contiguous and irregular
groups, and the state carried in by ``convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch.convert import state_from_numpy, walker_from_numpy
from lisp_mcmc_tpu import kernel as jkernel
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_torch import kernel as tkernel
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder
from lisp_mcmc_torch.ops import chunk_kernel as tck

FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
W, D, CHUNK = 256, 6, 100
RTOL = 1e-9
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")
OUT_KEYS = ("logprob_max", "logprob_mean", "logprob_min", "accept_rate",
            "group_accept")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flagship_data(seed=0):
    x = np.linspace(2000.0, 3600.0, 334)
    y = np.asarray(j_lorder(x, FLAGSHIP), np.float64)
    return x, y + 1e-7 * np.random.default_rng(seed).standard_normal(334)


@pytest.fixture(scope="module")
def setup():
    x, y = flagship_data()
    jw = jfit.walker_create(function=j_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, seed=3,
                            walker_jitter=1e-3)
    tw = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, dtype=torch.float64,
                            device="cpu")

    @jax.jit
    def draws(key):
        def body(k, _):
            k, k_prop, k_accept = jax.random.split(k, 3)
            return k, (jax.random.normal(k_prop, (W, D), jnp.float64),
                       jax.random.uniform(k_accept, (W,), jnp.float64))
        return lax.scan(body, key, None, length=CHUNK)

    return {"jw": jw, "tw": tw, "draws": draws}


def _arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}


def _group_ids(layout):
    if layout == "contiguous":
        return np.repeat(np.arange(2), W // 2), 2
    # every group present, walkers of a group scattered
    return np.random.default_rng(5).permutation(np.arange(W) % 3), 3


# (name, group layout, config fields); each group starts at its own L scale
CASES = [
    ("contiguous", "contiguous", {}),
    ("irregular", "irregular", {}),
    ("ensemble_contiguous", "contiguous", {"covariance_source": "ensemble"}),
    ("ensemble_irregular", "irregular", {"covariance_source": "ensemble"}),
    ("ensemble_ungrouped", None, {"covariance_source": "ensemble"}),
    ("best_value_contiguous", "contiguous", {"sampling_optimization": "best-value"}),
    ("best_value_irregular", "irregular", {"sampling_optimization": "best-value"}),
]
SCALES = (1e-2, 3e-3, 3e-2)


@pytest.mark.parametrize("name,layout,fields", CASES, ids=[c[0] for c in CASES])
def test_grouped_rwm_matches_jax(setup, name, layout, fields):
    jw = setup["jw"]
    gids, G = _group_ids(layout) if layout else (None, 1)
    jcfg = jfit.FitConfig(chunk_size=CHUNK, **fields)
    tcfg = tkernel.FitConfig(chunk_size=CHUNK, **fields)
    j_run, _ = jkernel.build_chunk_runner(jw._log_post_one, D, jcfg, group_ids=gids,
                                          n_groups=G, takes_data=True)
    t_run, _ = tkernel.build_chunk_runner(setup["tw"]._log_post, D, tcfg,
                                          group_ids=gids, n_groups=G)
    mags = np.abs(np.asarray(list(FLAGSHIP.values())))
    l0 = np.stack([s * np.diag(mags) for s in SCALES[:G]])
    j_state = dataclasses.replace(
        jw.state, l_matrix=jnp.asarray(l0), m_sum=jnp.zeros((G, D)),
        m_outer=jnp.zeros((G, D, D)), m_count=jnp.zeros((G,)))
    t_state, _ = state_from_numpy(_arrays(j_state), dtype=torch.float64, device="cpu")
    j_run = jax.jit(j_run)
    refreshed = False
    for chunk in range(3):
        cold = chunk == 2
        _, (z, u) = setup["draws"](j_state.key)
        j_state, j_out = j_run(j_state, True, True, cold, jw._posterior_data())
        t_state, t_out = t_run(t_state, True, True, cold,
                               noise=(torch.as_tensor(np.array(z)),
                                      torch.as_tensor(np.array(u))))
        for k, ja in _arrays(j_state).items():
            np.testing.assert_allclose(getattr(t_state, k).numpy(), ja, rtol=RTOL,
                                       atol=0, err_msg=f"{name} chunk {chunk}: {k}")
        for k in OUT_KEYS:
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                       rtol=RTOL, atol=0,
                                       err_msg=f"{name} chunk {chunk}: out[{k}]")
        assert t_out["group_accept"].shape == (G,)
        assert t_out["posterior_evals"] == CHUNK
        acc = t_out["group_accept"].numpy()
        refreshed |= bool(((acc > 0.2) & (acc < 0.4)).any())
    # the groups adapted apart: their L differ, and some chunk refreshed one
    if G > 1:
        assert not np.allclose(t_state.l_matrix[0].numpy(), t_state.l_matrix[-1].numpy())
    assert refreshed, f"{name}: no group was ever in band"


def test_grouped_history_runner_matches_jax(setup):
    """The thinned history runner with contiguous groups."""
    jw = setup["jw"]
    gids, G = _group_ids("contiguous")
    j_run = jax.jit(jkernel.build_chunk_runner(
        jw._log_post_one, D, jfit.FitConfig(chunk_size=CHUNK), group_ids=gids,
        n_groups=G, takes_data=True)[1])
    t_run = tkernel.build_chunk_runner(setup["tw"]._log_post, D,
                                       tkernel.FitConfig(chunk_size=CHUNK),
                                       group_ids=gids, n_groups=G)[1]
    l0 = np.stack([s * np.diag(np.abs(list(FLAGSHIP.values()))) for s in SCALES[:G]])
    j_state = dataclasses.replace(
        jw.state, l_matrix=jnp.asarray(l0), m_sum=jnp.zeros((G, D)),
        m_outer=jnp.zeros((G, D, D)), m_count=jnp.zeros((G,)))
    t_state, _ = state_from_numpy(_arrays(j_state), dtype=torch.float64, device="cpu")
    for _ in range(2):
        _, (z, u) = setup["draws"](j_state.key)
        j_state, j_out = j_run(j_state, True, True, False, jw._posterior_data())
        t_state, t_out = t_run(t_state, True, True, False,
                               noise=(torch.as_tensor(np.array(z)),
                                      torch.as_tensor(np.array(u))))
        for k in ("positions", "logprobs") + OUT_KEYS:
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                       rtol=RTOL, atol=0, err_msg=k)
        np.testing.assert_allclose(t_state.l_matrix.numpy(), np.asarray(j_state.l_matrix),
                                   rtol=RTOL, atol=0)


def test_grouped_state_carries_across():
    """``convert`` takes a grouped JAX state: (G, d, d) L, (G, d)
    moments, (G,) counts and group_ids; it refuses a misshapen one."""
    x, y = flagship_data()
    G = 4
    gids = np.repeat(np.arange(G), 16)
    rng = np.random.default_rng(9)
    arrays = {"position": 1.0 + 1e-3 * rng.standard_normal((64, D)),
              "logprob": rng.standard_normal(64),
              "l_matrix": rng.standard_normal((G, D, D)),
              "m_sum": rng.standard_normal((G, D)),
              "m_outer": rng.standard_normal((G, D, D)),
              "m_count": np.arange(G, dtype=np.float64),
              "group_ids": gids, "age": 400}
    arrays["best_position"], arrays["best_logprob"] = arrays["position"], arrays["logprob"]
    kw = dict(function=t_lorder, data=(x, y), params=FLAGSHIP, data_error=1e-7,
              dtype=torch.float64, device="cpu")
    w = walker_from_numpy(arrays, **kw)
    assert w.n_groups == G and (w.group_ids == gids).all() and w.age == 400
    for k in STATE_KEYS:
        np.testing.assert_array_equal(getattr(w.state, k).numpy(), arrays[k], err_msg=k)
    w._set_l_matrix(np.eye(D))
    assert w.state.l_matrix.shape == (G, D, D)
    with pytest.raises(ValueError, match="misshapen"):
        state_from_numpy({**arrays, "m_count": np.zeros(G + 1)}, device="cpu")
    with pytest.raises(ValueError, match="no group_ids"):
        walker_from_numpy({k: v for k, v in arrays.items() if k != "group_ids"}, **kw)
    with pytest.raises(ValueError, match="group_ids"):
        walker_from_numpy({**arrays, "group_ids": gids + 1}, **kw)


def test_chunk_kernel_refuses_grouped_fits():
    """As the JAX package keeps grouped fits off ``pallas_chunk``
    (fit.py:431-449), the chunk kernel refuses them by name, and a grouped
    walker that asks for it raises rather than fall back."""
    x, y = flagship_data()
    cfg = tfit.FitConfig(posterior_impl="chunk_kernel")
    w = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                           data_error=1e-7, n_walkers=256, walker_jitter=1e-3,
                           config=cfg, device="cpu")
    assert tck.chunk_coverage(w.terms, w.spec, cfg, 256, torch.float32) is None
    reason = tck.chunk_coverage(w.terms, w.spec, cfg, 256, torch.float32, n_groups=2)
    assert "adaptation group" in reason
    assert tck.build_chunk_kernel(w.terms, w.spec, cfg, 256, torch.float32) is not None
    w.group_ids, w.n_groups = np.repeat(np.arange(2), 128), 2
    with pytest.raises(ValueError, match="adaptation group"):
        w.adaptive_steps(200, collect_history=False)
    for bad in (tfit.FitConfig(posterior_impl="chunk_kernel", kernel="stretch"),
                tfit.FitConfig(posterior_impl="chunk_kernel", tempering_rungs=2)):
        assert "untempered rwm" in tck.chunk_coverage(w.terms, w.spec, bad, 256,
                                                      torch.float32)
