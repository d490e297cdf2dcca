"""The port's parallel tempering against the JAX package's, draw for draw.

A tempered chunk (kernel.py:431-463, 771-780 and 1878-1929 of the JAX
package) runs rwm steps with each rung's temperature and ends with one
replica-exchange round between adjacent rungs of the chunk's parity.
These tests replay the JAX key stream (``split(key, 3)``, normal,
uniform per step; then ``split(key)`` and the (K-1, B) swap uniforms)
into the port runner's ``noise=`` and compare every state array and the
swap rates after each chunk in float64 at rtol 1e-9, on the geometric
ladder and on explicit betas, including the cold finish (every rung at
T = 1: ``dbeta = 0``).  ``Walker.tempered_steps`` (with ``auto_ladder``),
``swap_rates`` and ``respace_ladder`` are held against the JAX verbs.
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
from lisp_mcmc_torch.convert import state_from_numpy
from lisp_mcmc_tpu import fit as jfitmod
from lisp_mcmc_tpu import kernel as jkernel
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_torch import fit as tfitmod
from lisp_mcmc_torch import kernel as tkernel
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder

FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
W, D, K, CHUNK = 256, 6, 4, 50
RTOL = 1e-9
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")


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


def _walkers(config=None, jitter=0.02):
    x, y = flagship_data()
    jw = jfit.walker_create(function=j_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, seed=8,
                            walker_jitter=jitter, config=config)
    tw = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, dtype=torch.float64,
                            device="cpu")
    return jw, tw


def _arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}


_REPLAYS = {}


def tempered_draws(chunk, k_rungs=K):
    """A jitted ``key -> (key, (z, u, swap))``: one tempered chunk's draws."""
    if (chunk, k_rungs) in _REPLAYS:
        return _REPLAYS[(chunk, k_rungs)]

    @jax.jit
    def draws(key):
        def body(k, _):
            k, k_prop, k_accept = jax.random.split(k, 3)
            return k, (jax.random.normal(k_prop, (W, D), jnp.float64),
                       jax.random.uniform(k_accept, (W,), jnp.float64))
        key, (z, u) = lax.scan(body, key, None, length=chunk)
        key, k_swap = jax.random.split(key)
        return key, (z, u, jax.random.uniform(k_swap, (k_rungs - 1, W // k_rungs),
                                              jnp.float64))

    def replay(key):
        key, noise = draws(key)
        return key, tuple(torch.as_tensor(np.array(a)) for a in noise)

    _REPLAYS[(chunk, k_rungs)] = replay
    return replay


LADDERS = [("geometric", ()), ("betas", (1.0, 0.5, 0.2, 0.04))]


@pytest.mark.parametrize("name,betas", LADDERS, ids=[x[0] for x in LADDERS])
def test_tempered_chunks_match_jax(name, betas):
    jw, tw = _walkers()
    gids = np.repeat(np.arange(K), W // K)
    fields = dict(chunk_size=CHUNK, tempering_rungs=K, tempering_betas=betas,
                  temperature=30.0, auto=None)
    j_run, _ = jkernel.build_chunk_runner(jw._log_post_one, D, jfit.FitConfig(**fields),
                                          group_ids=gids, n_groups=K, takes_data=True)
    t_run, _ = tkernel.build_chunk_runner(tw._log_post, D, tkernel.FitConfig(**fields),
                                          group_ids=gids, n_groups=K)
    l0 = 3e-3 * np.diag(np.abs(np.asarray(list(FLAGSHIP.values()))))
    j_state = dataclasses.replace(
        jw.state, l_matrix=jnp.broadcast_to(jnp.asarray(l0), (K, D, D)),
        m_sum=jnp.zeros((K, D)), m_outer=jnp.zeros((K, D, D)), m_count=jnp.zeros((K,)))
    t_state, _ = state_from_numpy(_arrays(j_state), dtype=torch.float64, device="cpu")
    j_run = jax.jit(j_run)
    replay = tempered_draws(CHUNK)
    key = j_state.key
    swapped = {False: 0.0, True: 0.0}
    for chunk in range(4):
        cold = chunk == 3          # the cold finish: every rung at T = 1
        key, noise = replay(key)
        j_state, j_out = j_run(j_state, True, True, cold, jw._posterior_data())
        t_state, t_out = t_run(t_state, True, True, cold, noise=noise)
        for k, ja in _arrays(j_state).items():
            np.testing.assert_allclose(getattr(t_state, k).numpy(), ja, rtol=RTOL, atol=0,
                                       err_msg=f"{name} chunk {chunk}: {k}")
        for k in ("swap_rate", "group_accept", "accept_rate", "logprob_max"):
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), rtol=RTOL,
                                       atol=0, err_msg=f"{name} chunk {chunk}: out[{k}]")
        np.testing.assert_array_equal(jax.random.key_data(j_state.key),
                                      jax.random.key_data(key))
        rate = t_out["swap_rate"].numpy()
        # pairs of the chunk's parity report a rate, the others NaN
        parity = (t_state.age // CHUNK) % 2
        assert np.isnan(rate[np.arange(K - 1) % 2 != parity]).all()
        swapped[cold] = max(swapped[cold], float(np.nanmax(rate)))
    assert 0.0 < swapped[False] < 1.0, swapped
    assert swapped[True] == 1.0       # dbeta = 0: every active pair swaps


def _patch_draws(tw, key):
    """``tw``'s chunk runners draw what the JAX walker's would from ``key``."""
    box = [key]
    real = tw._runner

    def runner(greedy=False, with_history=True):
        run = real(greedy, with_history)
        replay = tempered_draws(tw.config.chunk_size, tw.config.tempering_rungs)

        def wrapped(state, adapt, refresh, cold, *, generator=None, noise=None):
            box[0], nz = replay(box[0])
            return run(state, adapt, refresh, cold, noise=nz)
        return wrapped

    tw._runner = runner
    return box


@pytest.mark.parametrize("auto_ladder", [False, True], ids=["fixed", "auto_ladder"])
def test_tempered_steps_matches_jax(auto_ladder):
    """``Walker.tempered_steps`` and ``swap_rates`` against the JAX verbs:
    the groups widened to the rungs and collapsed back to the cold rung's
    L, the pilot's swap rates re-spacing the ladder, the same chains."""
    jw, tw = _walkers(config=jfit.FitConfig(chunk_size=CHUNK))
    tw.config = tkernel.FitConfig(chunk_size=CHUNK)
    tw.state, _ = state_from_numpy(_arrays(jw.state), dtype=torch.float64, device="cpu")
    box = _patch_draws(tw, jw.state.key)
    n = 12 * CHUNK
    jw.tempered_steps(n, rungs=K, t_max=30.0, auto_ladder=auto_ladder)
    tw.tempered_steps(n, rungs=K, t_max=30.0, auto_ladder=auto_ladder)
    np.testing.assert_array_equal(jax.random.key_data(jw.state.key),
                                  jax.random.key_data(box[0]))
    for k, ja in _arrays(jw.state).items():
        np.testing.assert_allclose(getattr(tw.state, k).numpy(), ja, rtol=RTOL, atol=0,
                                   err_msg=f"tempered_steps: {k}")
    assert tw.state.l_matrix.shape == (1, D, D) and tw.group_ids is None
    assert tw.n_groups == 1 and tw.config == tkernel.FitConfig(chunk_size=CHUNK)
    j_rates, t_rates = jw.swap_rates(), tw.swap_rates()
    np.testing.assert_allclose(t_rates["betas"], j_rates["betas"], rtol=1e-15)
    np.testing.assert_allclose(t_rates["pair_rates"], j_rates["pair_rates"], rtol=RTOL)
    assert t_rates["ok"] == j_rates["ok"]
    assert t_rates["min_rate"] == pytest.approx(j_rates["min_rate"], rel=RTOL)
    if auto_ladder:
        geometric = 1.0 / 30.0 ** (np.arange(K) / (K - 1))
        assert not np.allclose(t_rates["betas"], geometric)
    assert tw.age == int(jw.state.age) == n
    assert tw.posterior_evals == n


def test_respace_ladder_matches_jax():
    betas = 1.0 / 50.0 ** (np.arange(8) / 7)
    for rates in ([0.9, 0.5, 0.1, 0.02, 0.3, 0.6, 0.99],
                  [np.nan, 0.5, 0.5, 0.5, np.nan, 0.0, 1.0],
                  [0.4] * 7):
        np.testing.assert_allclose(tfitmod.respace_ladder(betas, rates),
                                   jfitmod.respace_ladder(betas, rates), rtol=1e-15)
    with pytest.raises(ValueError, match="pair rates"):
        tfitmod.respace_ladder(betas, [0.5] * 6)


def test_tempering_guards_and_runner_reuse():
    x, y = flagship_data()
    w = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                           data_error=1e-7, n_walkers=64, walker_jitter=1e-3,
                           dtype=torch.float64, device="cpu",
                           config=tfit.FitConfig(chunk_size=20))
    with pytest.raises(ValueError, match="divide n_walkers"):
        w.tempered_steps(40, rungs=3)
    with pytest.raises(ValueError, match="descend"):
        w.tempered_steps(40, rungs=4, betas=(1.0, 0.2, 0.5, 0.1))
    assert w.n_groups == 1 and w.state.l_matrix.shape[0] == 1
    with pytest.raises(ValueError, match="swap_rates"):
        w.swap_rates()
    w.tempered_steps(40, rungs=4)
    cached = len(w._runner_cache)
    w.tempered_steps(80, rungs=4)          # another length: the same runner
    assert len(w._runner_cache) == cached
    assert w.swap_rates()["pair_rates"].shape == (3,)
    w.group_ids, w.n_groups = np.repeat(np.arange(2), 32), 2
    with pytest.raises(ValueError, match="grouped"):
        w.tempered_steps(40, rungs=4)
