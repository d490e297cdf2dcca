"""The rest of ``Walker``, the custom posteriors and ``unit_cube_view``
against the JAX package, float64 on the CPU.

- ``optimize`` (rounds 1 and 2) on a line fit and on the flagship from
  the same ensemble: positions, logprobs and best logprobs at rtol 1e-12
  (measured: at most 1.2e-15 apart, the Adam scalars' rounding); no
  walker's logprob falls, and every one rises.
- ``sample_region`` with the JAX key stream replayed into the port's
  greedy chunks: state, L and the tuner's acceptance log at rtol 1e-9
  (the rwm tests' tolerance).
- ``force_step`` and ``swap_data`` (the best points restart, and the
  kernel-1 closure the walker keeps is rebuilt on the new data),
  ``add_steps`` (each walker's own column's best, never a global one;
  one walker's history given to all), ``unique_steps``,
  ``forward_steps``, ``check_for_nonfinite`` and ``diagnose_params``:
  exact on the same history, 1e-12 for posterior values.
- Custom posteriors: ``log_posterior`` (one walker's, evaluated by
  ``torch.func.vmap``) and ``batched_log_posterior`` walkers over two
  adaptive chunks with the JAX key stream replayed, at rtol 1e-9;
  ``posterior_impl="kernel"``/``"chunk_kernel"`` and ``swap_data``
  refuse them by name; autograd differentiates them (``optimize``).
- ``unit_cube_view``: ``logpost_u(u) = logpost(theta(u)) -
  installed(theta(u))`` inside the cube against the JAX view at rtol
  1e-12, the wall outside, the u-ensemble at the clamped CDF image of the
  walker's (rtol 1e-12, atol 1e-15), and a run of the view that leaves
  the walker as it was.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import models, priors as tp
from lisp_mcmc_torch.convert import walker_from_numpy
from lisp_mcmc_torch.data import Dataset as TDataset
from lisp_mcmc_torch.roofline import FLAGSHIP, synthetic_flagship
from lisp_mcmc_tpu import priors as jp
from lisp_mcmc_tpu.data import Dataset as JDataset
from lisp_mcmc_tpu.models import zoo as jzoo

from test_torch_blocked import rwm_draws

STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _line_data(seed=2):
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 2.0, 50)
    return x, 1.5 * x + 0.7 + 0.05 * rng.standard_normal(50)


def _arrays(st, keys=None):
    out = {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}
    if keys is not None:
        out["keys"] = keys
    return out


def _pair(name, W, jitter, jprior=None, tprior=None, seed=3):
    if name == "line":
        x, y = _line_data()
        jf, tf, params, err = jzoo.line, models.line, {"m": 1.0, "b": 0.2}, 0.05
    else:
        x, y = synthetic_flagship()
        jf, tf, params, err = jzoo.lorder_mixed_bg, models.lorder_mixed_bg, FLAGSHIP, 1e-7
    jw = jfit.walker_create(function=jf, data=(x, y), params=params, data_error=err,
                            n_walkers=W, seed=seed, walker_jitter=jitter, dtype=jnp.float64,
                            log_prior=jprior)
    tw = walker_from_numpy(_arrays(jw.state, jw.spec.keys), function=tf, data=(x, y),
                           params=params, data_error=err, dtype=torch.float64,
                           device="cpu", log_prior=tprior)
    return jw, tw


def _compare(jw, tw, rtol, keys=STATE_KEYS, msg=""):
    for k in keys:
        np.testing.assert_allclose(getattr(tw.state, k).numpy(), np.asarray(getattr(jw.state, k)),
                                   rtol=rtol, atol=0, err_msg=f"{msg}: {k}")


def _patch_rwm_draws(tw, key):
    """Make ``tw``'s chunk runners draw what the JAX walker's rwm chunks
    would from ``key``."""
    box = [key]
    real = tw._runner

    def runner(greedy=False, with_history=True):
        run = real(greedy, with_history)

        def wrapped(state, adapt, refresh, cold, *, generator=None, noise=None):
            W, d = state.position.shape
            box[0], nz = rwm_draws(W, d, tw.config.chunk_size)(box[0])
            return run(state, adapt, refresh, cold, noise=nz)
        return wrapped

    tw._runner = runner
    return box


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("name,jitter,n", [("line", 0.3, 200), ("flagship", 1e-3, 100)])
def test_optimize_matches_jax(name, jitter, n, rounds):
    jw, tw = _pair(name, 32, jitter)
    lp0, best0 = tw.state.logprob.clone(), tw.state.best_logprob.max().item()
    jw.optimize(n, rounds=rounds)
    tw.optimize(n, rounds=rounds)
    _compare(jw, tw, 1e-12, ("position", "logprob", "best_position", "best_logprob"),
             f"optimize {name} rounds={rounds}")
    assert bool((tw.state.logprob >= lp0).all()), "a walker degraded"
    assert bool((tw.state.logprob > lp0).all()), "every walker should improve here"
    assert tw.state.best_logprob.max().item() >= best0
    assert torch.equal(tw.state.l_matrix, torch.as_tensor(np.asarray(jw.state.l_matrix)))
    with pytest.raises(ValueError, match="positive"):
        tw.optimize(0)
    with pytest.raises(ValueError, match="positive"):
        tw.optimize(10, rounds=0)


def test_optimize_keeps_walkers_whose_endpoint_is_worse():
    """A walker whose endpoint is not finite, or not better, stays where
    it was (here: all of them, at a too-large learning rate on a line
    fit started at its optimum)."""
    jw, tw = _pair("line", 16, 0.0)
    tw.optimize(1, learning_rate=1e6)
    assert torch.equal(tw.state.position, torch.as_tensor(np.asarray(jw.state.position)))


def test_sample_region_matches_jax():
    jw, tw = _pair("flagship", 128, 1e-3)
    box = _patch_rwm_draws(tw, jw.state.key)
    jw.sample_region(initial_scale=1e-3, n=200)
    tw.sample_region(initial_scale=1e-3, n=200)
    np.testing.assert_array_equal(jax.random.key_data(box[0]),
                                  jax.random.key_data(jw.state.key))
    _compare(jw, tw, 1e-9, msg="sample_region")
    np.testing.assert_allclose(tw.tuner_accept_log, jw.tuner_accept_log, rtol=1e-9)
    assert len(tw.tuner_accept_log) == 4 and tw.config.chunk_size == 200
    assert tw._accept_log == [] and len(tw) == 0, "the tuner stays out of the run's logs"


def test_force_step_and_swap_data_match_jax():
    jw, tw = _pair("line", 64, 0.2)
    x, y = _line_data(seed=9)
    y = y + 0.3
    jds = JDataset.create(x, y, 0.05, dtype=jnp.float64)
    tds = TDataset.create(x, y, 0.05, dtype=torch.float64, device="cpu")
    # the kernel-1 closure, built on the old data and kept
    tw.config = dataclasses.replace(tw.config, posterior_impl="kernel")
    old = tw._batched_posterior()
    assert tw._runner_cache["_fused"] is old
    jw.swap_data([jds])
    tw.swap_data([tds])
    assert "_fused" not in tw._runner_cache
    _compare(jw, tw, 1e-12, ("position", "logprob", "best_position", "best_logprob"),
             "swap_data")
    assert torch.equal(tw.state.best_logprob, tw.state.logprob)
    new = tw._batched_posterior()
    assert new is not old
    pos = tw.state.position
    np.testing.assert_allclose(new(pos).numpy(), tw._log_post(pos).numpy(), rtol=1e-12)
    assert not np.allclose(old(pos).numpy(), new(pos).numpy())
    tw.state = dataclasses.replace(tw.state, logprob=torch.zeros_like(tw.state.logprob))
    tw.force_step()
    np.testing.assert_allclose(tw.state.logprob.numpy(), np.asarray(jw.state.logprob), rtol=1e-12)
    with pytest.raises(ValueError, match="count"):
        tw.swap_data([tds, tds])


def test_history_verbs_match_jax():
    jw, tw = _pair("line", 8, 0.2)
    rng = np.random.default_rng(4)
    T = 12
    pos = rng.standard_normal((T, 8, 2))
    lp = rng.standard_normal((T, 8)) + 50.0
    lp[3:6, 2] = lp[2, 2]                    # repeats: rejected steps
    lp[5, 3] = 1e3                           # walker 3's best, mid-history
    pos[7, 5, 1] = np.nan                    # a leak in walker 5
    for w in (jw, tw):
        w.add_steps(pos, lp)
        w.add_steps(pos[:, 0], lp[:, 0])     # one walker's history for all
    _compare(jw, tw, 0, ("best_position", "best_logprob"), "add_steps")
    assert tw.state.best_logprob[3].item() == 1e3
    np.testing.assert_array_equal(tw.state.best_position[3].numpy(), pos[5, 3])
    for walker in (0, 2, 5):
        for verb in ("unique_steps", "forward_steps"):
            np.testing.assert_array_equal(getattr(tw, verb)(walker=walker),
                                          getattr(jw, verb)(walker=walker))
    assert tw.check_for_nonfinite() == jw.check_for_nonfinite() == [5]
    assert tw.check_for_nonfinite(take=4) == jw.check_for_nonfinite(take=4)
    p = {"m": 1.3, "b": 0.4}
    assert tw.diagnose_params(p) == pytest.approx(jw.diagnose_params(p), rel=1e-12)
    assert tw.diagnose_params(p, aux_index=3) == tw.diagnose_params(p)


def _gauss_post():
    """A correlated 3-D Gaussian as a custom posterior: data is a dict."""
    a = np.random.default_rng(6).standard_normal((3, 3))
    prec = a @ a.T + np.eye(3)
    mu = np.array([1.0, -2.0, 0.5])

    def j_one(theta, data):
        r = theta - data["mu"]
        return -0.5 * r @ data["prec"] @ r

    def t_one(theta, data):
        r = theta - data["mu"]
        return -0.5 * r @ data["prec"] @ r

    def t_batched(pos, data):
        r = pos - data["mu"]
        return -0.5 * torch.einsum("wi,ij,wj->w", r, data["prec"], r)

    j_data = {"mu": jnp.asarray(mu), "prec": jnp.asarray(prec)}
    t_data = {"mu": torch.as_tensor(mu), "prec": torch.as_tensor(prec)}
    return j_one, t_one, t_batched, j_data, t_data


@pytest.mark.parametrize("kind", ["log_posterior", "batched_log_posterior"])
def test_custom_posterior_walkers_match_jax(kind):
    j_one, t_one, t_batched, j_data, t_data = _gauss_post()
    spec = tfit.ParamSpec(("a", "b", "c"))
    from lisp_mcmc_tpu.params import ParamSpec as JSpec
    start = np.random.default_rng(2).standard_normal((64, 3)) + [1.0, -2.0, 0.5]
    cfg = dict(chunk_size=100)
    jw = jfit.Walker([], JSpec(("a", "b", "c")), start, seed=5, dtype=jnp.float64,
                     config=jfit.FitConfig(**cfg), log_posterior=j_one, posterior_data=j_data)
    custom = ({"log_posterior": t_one} if kind == "log_posterior"
              else {"batched_log_posterior": t_batched})
    tw = tfit.Walker([], spec, start, dtype=torch.float64, device="cpu",
                     config=tfit.FitConfig(**cfg), posterior_data=t_data, **custom)
    np.testing.assert_allclose(tw.state.logprob.numpy(), np.asarray(jw.state.logprob),
                               rtol=1e-12)
    _patch_rwm_draws(tw, jw.state.key)
    jw.adaptive_steps(200, auto=None)
    tw.adaptive_steps(200, auto=None)
    _compare(jw, tw, 1e-9, msg=f"custom {kind}")
    np.testing.assert_allclose(tw._history()[0], jw._history()[0], rtol=1e-9)
    # never on a kernel; no data swap; autograd through it
    for impl in ("kernel", "chunk_kernel"):
        tw.config = dataclasses.replace(tw.config, posterior_impl=impl)
        tw._runner_cache.clear()
        with pytest.raises(ValueError, match="custom posterior"):
            tw.adaptive_steps(100, auto=None, collect_history=False)
    tw.config = dataclasses.replace(tw.config, posterior_impl="auto")
    with pytest.raises(ValueError, match="custom posterior"):
        tw.swap_data([])
    before = tw.state.logprob.clone()
    tw.optimize(50)
    assert bool((tw.state.logprob >= before).all())
    assert tw.state.logprob.max().item() > -1e-3, "the optimum is 0 at mu"


def test_unit_cube_view_matches_jax():
    jspec = jp.PriorSpec({"m": jp.Gaussian(1.4, 0.3, low=0.0), "b": jp.LogNormal(0.0, 1.0)})
    tspec = tp.PriorSpec({"m": tp.Gaussian(1.4, 0.3, low=0.0), "b": tp.LogNormal(0.0, 1.0)})
    jw, tw = _pair("line", 16, 0.2, jprior=jspec, tprior=tspec)
    juw = jfit.unit_cube_view(jw, jspec)
    tuw = tfit.unit_cube_view(tw, tspec)
    np.testing.assert_allclose(tuw.state.position.numpy(), np.asarray(juw.state.position),
                               rtol=1e-12, atol=1e-15)
    assert tuw._unit_cube_spec is tspec and tuw.config.posterior_impl == "plain"
    u = np.random.default_rng(1).uniform(0.02, 0.98, (40, 2))
    u[0] = [0.3, 0.7]
    got = tuw._log_post(torch.as_tensor(u)).numpy()
    data = jw._posterior_data()
    want = [float(juw._log_post_one(jnp.asarray(r), data)) for r in u]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    th = tuw._theta_of_u(torch.as_tensor(u))
    rhs = tw._log_post(th) - tspec.installed_vec(th, tw.spec.keys)
    np.testing.assert_allclose(got, rhs.numpy(), rtol=1e-12)
    out = tuw._log_post(torch.tensor([[1.2, 0.5], [0.5, -0.1]], dtype=torch.float64))
    assert bool((out < -1e7).all()), "outside the cube the wall dominates"
    before = tw.state.position.clone()
    tuw.adaptive_steps(200, temperature=2.0, auto=None)
    assert torch.equal(before, tw.state.position)
    with pytest.raises(ValueError, match="missing"):
        tfit.unit_cube_view(tw, tp.PriorSpec({"m": (0.0, 1.0)}))
