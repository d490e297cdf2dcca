"""The port's rwm chunk runner against the JAX package's, draw for draw.

The JAX chunk (``lisp_mcmc_tpu.kernel.build_chunk_runner``) draws its
proposals with ``split(key, 3)`` then ``normal``/``uniform`` each step
(kernel.py:770-791).  These tests replay that stream in a scan of their
own, feed the same draws to the port's runner (``noise=``), start both
from the same state (carried across with ``lisp_mcmc_torch.convert``) and
compare every state array after each of three chunks + adaptation, in
float64 at rtol 1e-9.  The scenarios cover the in-band covariance
refresh, the x0.1 and x1.9 rescales, the cold finish, adaptation off and
the history runner's thinned positions.
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
from lisp_mcmc_tpu import diagnostics as jdiag
from lisp_mcmc_tpu import kernel as jkernel
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_tpu.ops import reductions as jred
from lisp_mcmc_torch import kernel as tkernel
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder
from lisp_mcmc_torch.ops import reductions as tred

# The printed reference parameters with scale x10 (see test_torch_fit.py).
FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
W, D, CHUNK = 256, 6, 200
RTOL = 1e-9
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers, and
    torch's spinning thread pool would oversubscribe the machine."""
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
                            data_error=1e-7, n_walkers=W, seed=1,
                            walker_jitter=1e-3)
    tw = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, dtype=torch.float64,
                            device="cpu")
    j_run, j_hist = jkernel.build_chunk_runner(
        jw._log_post_one, D, jw.config, takes_data=True)
    t_run, t_hist = tkernel.build_chunk_runner(tw._log_post, D, tkernel.FitConfig())

    @jax.jit
    def draws(key):
        def body(k, _):
            k, k_prop, k_accept = jax.random.split(k, 3)
            return k, (jax.random.normal(k_prop, (W, D), jnp.float64),
                       jax.random.uniform(k_accept, (W,), jnp.float64))
        return lax.scan(body, key, None, length=CHUNK)

    return {"jw": jw, "data": jw._posterior_data(), "draws": draws,
            "j": {False: jax.jit(j_run), True: jax.jit(j_hist)},
            "t": {False: t_run, True: t_hist}}


def _arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}


# (name, proposal scale, adapt_enabled, allow_refresh, force_cold, history,
#  the acceptance branch that must occur in some chunk)
SCENARIOS = [
    ("in_band_refresh", 1e-2, True, True, False, False, "band"),
    ("scale_down", 3e-2, True, True, False, False, "low"),
    ("scale_up", 1e-3, True, True, False, False, "high"),
    ("force_cold", 1e-2, True, True, True, False, None),
    ("adapt_off", 1e-2, False, True, False, False, None),
    ("history", 3e-3, True, True, False, True, None),
]


@pytest.mark.parametrize("name,scale,adapt,refresh,cold,hist,branch", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_three_chunks_match_jax(setup, name, scale, adapt, refresh, cold, hist,
                                branch):
    jw = setup["jw"]
    l0 = scale * np.diag(np.abs(np.asarray(list(FLAGSHIP.values()))))
    j_state = dataclasses.replace(jw.state, l_matrix=jnp.asarray(l0)[None])
    arrays = _arrays(j_state)
    t_state, _ = state_from_numpy(arrays, dtype=torch.float64, device="cpu")
    j_run, t_run = setup["j"][hist], setup["t"][hist]
    seen = set()
    for chunk in range(3):
        _, (z, u) = setup["draws"](j_state.key)
        j_state, j_out = j_run(j_state, adapt, refresh, cold, setup["data"])
        t_state, t_out = t_run(t_state, adapt, refresh, cold,
                               noise=(torch.as_tensor(np.array(z)),
                                      torch.as_tensor(np.array(u))))
        for k, ja in _arrays(j_state).items():
            np.testing.assert_allclose(
                getattr(t_state, k).numpy(), ja, rtol=RTOL, atol=0,
                err_msg=f"{name} chunk {chunk}: {k}, rtol {RTOL}")
        for k in ("logprob_max", "logprob_mean", "logprob_min", "accept_rate",
                  "group_accept") + (("positions", "logprobs") if hist else ()):
            np.testing.assert_allclose(
                t_out[k].numpy(), np.asarray(j_out[k]), rtol=RTOL, atol=0,
                err_msg=f"{name} chunk {chunk}: out[{k}], rtol {RTOL}")
        assert t_state.age == int(j_state.age)
        acc = float(t_out["group_accept"][0])
        seen.add("low" if acc <= 0.2 else "band" if acc < 0.4 else "high")
    if branch is not None:
        assert branch in seen, f"{name}: wanted a {branch!r} chunk, saw {seen}"
    if not adapt:
        assert float(t_state.m_count[0]) == 0.0


def test_best_value_refresh_matches_jax(setup):
    """The sampling_optimization='best-value' branch (888-895)."""
    x, y = flagship_data()
    jcfg = jfit.FitConfig(sampling_optimization="best-value")
    jw = jfit.walker_create(function=j_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, seed=2,
                            walker_jitter=1e-3, config=jcfg)
    tw = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, dtype=torch.float64,
                            device="cpu")
    j_run, _ = jkernel.build_chunk_runner(jw._log_post_one, D, jcfg, takes_data=True)
    t_run, _ = tkernel.build_chunk_runner(
        tw._log_post, D, tkernel.FitConfig(sampling_optimization="best-value"))
    l0 = 1e-2 * np.diag(np.abs(np.asarray(list(FLAGSHIP.values()))))
    j_state = dataclasses.replace(jw.state, l_matrix=jnp.asarray(l0)[None])
    t_state, _ = state_from_numpy(_arrays(j_state), dtype=torch.float64, device="cpu")
    for _ in range(2):
        _, (z, u) = setup["draws"](j_state.key)
        j_state, _ = jax.jit(j_run)(j_state, True, True, False, jw._posterior_data())
        t_state, _ = t_run(t_state, True, True, False,
                           noise=(torch.as_tensor(np.array(z)),
                                  torch.as_tensor(np.array(u))))
        np.testing.assert_allclose(t_state.l_matrix.numpy(),
                                   np.asarray(j_state.l_matrix), rtol=RTOL, atol=0)


def test_temperature_schedule_and_reductions_match_jax():
    """temperature_schedule, autocorrelation, ESS and split R-hat on the same
    (T, W, d) input, rtol 1e-10."""
    cfg_j, cfg_t = jfit.FitConfig(), tkernel.FitConfig()
    steps = np.arange(0, 40000, 7)
    np.testing.assert_allclose(
        tkernel.temperature_schedule(torch.as_tensor(steps), D, cfg_t).numpy(),
        np.asarray(jkernel.temperature_schedule(jnp.asarray(steps), D, cfg_j)),
        rtol=1e-10, err_msg="temperature_schedule, rtol 1e-10")
    rng = np.random.default_rng(11)
    chains = np.cumsum(rng.standard_normal((300, 64, 3)), axis=0) * 0.1 \
        + rng.standard_normal((300, 64, 3))
    chains[:, 5, 1] = 2.0  # a frozen walker counts as one sample
    for i in range(3):
        c = chains[:, :, i]
        tc = torch.as_tensor(c)
        np.testing.assert_allclose(tred.autocorrelation(tc, 50).numpy(),
                                   np.asarray(jred.autocorrelation(c, 50)),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(tred.effective_sample_size(tc)),
                                   float(jred.effective_sample_size(c)),
                                   rtol=1e-10, err_msg="ESS, rtol 1e-10")
        np.testing.assert_allclose(float(tred.split_rhat(tc)),
                                   float(jred.split_rhat(c)),
                                   rtol=1e-10, err_msg="split R-hat, rtol 1e-10")
    keys = ("a", "b", "c")
    j_ess = jdiag.ess_from_history(chains, keys)
    t_ess = tfit.ess_from_history(chains, keys)
    j_rhat = jdiag.rhat_from_history(chains, keys)
    t_rhat = tfit.rhat_from_history(chains, keys)
    for k in keys:
        assert t_ess[k] == pytest.approx(j_ess[k], rel=1e-10)
        assert t_rhat[k] == pytest.approx(j_rhat[k], rel=1e-10)
    assert float(tred.split_rhat(torch.ones(40, 8, dtype=torch.float64))) == np.inf


def test_out_of_slice_configs_raise():
    for cfg in (tkernel.FitConfig(kernel="mala"),
                tkernel.FitConfig(tempering_rungs=4),
                tkernel.FitConfig(block_count=2, block_local=3)):
        with pytest.raises(NotImplementedError):
            tkernel.build_chunk_runner(lambda p: p.sum(1), D, cfg)
    with pytest.raises(ValueError, match="posterior_impl"):
        tkernel.FitConfig(posterior_impl="pallas")
    x = np.linspace(0.0, 1.0, 8)
    with pytest.raises(NotImplementedError):
        tfit.Walker([], tfit.ParamSpec(("m",)), [1.0], device="cpu",
                    group_ids=np.zeros(4))
    assert tkernel.resolve_accept_band(tkernel.FitConfig()) == (0.2, 0.4)
    assert tkernel.resolve_accept_band(tkernel.FitConfig(kernel="mala")) == (0.45, 0.7)
    del x
