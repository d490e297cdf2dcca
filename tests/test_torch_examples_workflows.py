"""The port's single-fit workflows (examples_torch/) against the JAX
package's (examples/): modern_workflow, informative_priors,
robust_fitting, hard_geometry.

For each: the data the JAX example builds (from its own functions, or
recorded from its ``main`` with the constructors captured) equals what
the port's builds; the posterior of each fit the port builds equals the
JAX fit's at the JAX walker's positions (float64, 1e-10); the port's
phase functions run at a tiny budget with finite results; downstream
verbs (WAIC, LOO-PIT, PSIS-LOO) of a JAX walker carried into the port
with its history match at 1e-10.
"""

import math

import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_tpu import diagnostics as jd
from lisp_mcmc_tpu.models import zoo as jzoo
from lisp_mcmc_torch import diagnostics as td
from lisp_mcmc_torch import models

from torch_examples_util import (Capture, Fake, Stop, carried, cheap_evidence, jax_example,
                                 port_example, same, same_data, same_posterior, short_chunks)

W = 16
F64 = torch.float64
tmw = port_example("modern_workflow")
tip = port_example("informative_priors")
trf = port_example("robust_fitting")
thg = port_example("hard_geometry")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _first_walker(monkeypatch, jmod):
    """The keyword arguments of the first walker_create in ``jmod.main``."""
    grab = Capture(stop_at=1)
    monkeypatch.setattr(jfit, "walker_create", grab)
    with pytest.raises(Stop):
        jmod.main()
    monkeypatch.undo()
    return grab.calls[0][1]


# ------------------------------------------------------------ modern_workflow


def test_modern_workflow_data_and_posteriors_equal_jax(monkeypatch):
    jmw = jax_example("modern_workflow")
    jx, jy, jtruth = jmw.make_spectrum()
    tx, ty, ttruth = tmw.make_spectrum()
    np.testing.assert_array_equal(tx, jx)
    same_data(ty, jy)
    assert ttruth == jtruth and tmw.BOUNDS1 == jmw.BOUNDS1 and tmw.BOUNDS2 == jmw.BOUNDS2
    kw = _first_walker(monkeypatch, jmw)
    assert kw["params"] == tmw.START2 and kw["data_error"] == 2e-6
    same_data(kw["data"][1], ty)
    jw2 = jfit.walker_create(**{**kw, "n_walkers": W})
    same_posterior(tmw.two_peak_walker(tx, ty, tmw.START2, 0, "cpu", F64), jw2, "two-peak")
    jw1 = jfit.walker_create(function=jzoo.lorentzian_bg, data=(jx, jy), params=tmw.START1,
                             data_error=2e-6, log_prior=jfit.make_bounds_prior(jmw.BOUNDS1),
                             n_walkers=W, seed=2, walker_jitter=0.05)
    same_posterior(tmw.one_peak_walker(tx, ty, 2, "cpu", F64), jw1, "one-peak")


def test_modern_workflow_waic_and_loo_pit_of_a_carried_walker():
    x, y, truth = tmw.make_spectrum()
    common = dict(data=(x, y), params=truth, data_error=2e-6)
    jw = jfit.walker_create(function=jzoo.double_lorentzian_bg, n_walkers=W, seed=0,
                            walker_jitter=1e-3, **common,
                            log_prior=jfit.make_bounds_prior(tmw.BOUNDS2))
    jw.adaptive_steps(400, temperature=1.0, auto=None)
    tw = carried(jw, function=models.double_lorentzian_bg, **common,
                 log_prior=tfit.make_bounds_prior(tmw.BOUNDS2))
    tr, jr = td.waic(tw), jd.waic(jw)
    same([tr.elpd, tr.p_waic], [jr.elpd, jr.p_waic], "waic")
    same(td.loo_pit(tw).p_value, jd.loo_pit(jw).p_value, "loo_pit")


def test_modern_workflow_phases_at_a_tiny_budget(monkeypatch):
    cheap_evidence(monkeypatch)
    short_chunks(monkeypatch)
    steps = {"prior_predictive": 16, "tempered": 200, "optimize": 10, "cold": 200,
             "mala": 20, "evidence": 160, "smc_move": 4, "n_live": 32, "advi": 10,
             "flow": 10, "waic_cold": 200, "waic_burn": 100, "sbc": 200,
             "sbc_mala": 20, "sbc_sims": 4}
    x, y, _ = tmw.make_spectrum()
    w = tmw.two_peak_walker(x, y, tmw.START2, 0, "cpu")
    best = tmw.search_and_sample(w, y, steps)
    assert set(best) == set(tmw.START2)
    conv, coverage = tmw.uncertainty(w)
    assert "ok" in conv and 0.0 <= coverage <= 1.0
    w1, w_smc, ev = tmw.model_choice(x, y, best, "cpu", steps)
    assert all(math.isfinite(r.log_z) for r in ev.values())
    pit2, pit1 = tmw.predictive_view(w1, w_smc, steps)
    assert np.isfinite([pit2.p_value, pit1.p_value]).all()
    sbc = tmw.pipeline_audit(x, "cpu", steps)
    assert sbc.n_sims == 4 and set(sbc.keys) == set(tmw.BOUNDS1)


# ------------------------------------------------------------ informative_priors


def test_informative_priors_data_and_posterior_equal_jax(monkeypatch):
    kw = _first_walker(monkeypatch, jax_example("informative_priors"))
    rng, x, y = tip.make_data()
    np.testing.assert_array_equal(x, np.asarray(kw["data"][0]))
    np.testing.assert_array_equal(y, np.asarray(kw["data"][1]))
    assert kw["data_error"] == tip.SIGMA and kw["n_walkers"] == 512
    jw = jfit.walker_create(**{**kw, "n_walkers": W})
    same_posterior(tip.make_walker(x, y, tip.make_spec(), "cpu", F64, n_walkers=W), jw,
                   "decay under the named prior")
    # the generator goes on as JAX's does (the shrinkage step's prior draws)
    want = np.random.default_rng(11)
    want.standard_normal(64)
    assert rng.bit_generator.state == want.bit_generator.state


def test_informative_priors_phases_at_a_tiny_budget(monkeypatch):
    cheap_evidence(monkeypatch)
    short_chunks(monkeypatch)
    steps = {"prior_predictive": 16, "anneal": 200, "optimize": 10, "sample": 200,
             "n_live": 32, "evidence": 160, "smc_move": 4, "draws": 100, "sbc": 200,
             "sbc_sims": 4}
    rng, x, y = tip.make_data()
    spec = tip.make_spec()
    w = tip.make_walker(x, y, spec, "cpu", n_walkers=64)
    conv = tip.fit(w, y, steps)
    assert "ok" in conv
    zs = tip.evidence(w, spec, steps)
    assert all(math.isfinite(r.log_z) for r in zs)
    sens = tip.shrinkage(w, spec, zs[1], rng, steps)
    assert isinstance(sens.ok, bool)
    assert tip.audit(x, spec, "cpu", steps).n_sims == 4


# ------------------------------------------------------------ robust_fitting


def _jax_robust(monkeypatch):
    """Every fit JAX's robust_fitting.main builds: (fit calls,
    BatchedFit call)."""
    jrf = jax_example("robust_fitting")
    fits, batches = Capture(), Capture(stop_at=1)
    pits = iter([False, True])        # claimed sigma, then fitted: what main asserts
    monkeypatch.setattr(jrf, "fit", fits)
    monkeypatch.setattr(jrf, "diagnostics", Fake(
        loo_pit=lambda w: Fake(ok=next(pits), p_value=0.0)))
    monkeypatch.setattr(jfit, "BatchedFit", batches)
    with pytest.raises(Stop):
        jrf.main()
    monkeypatch.undo()
    return fits.calls, batches.calls[0]


def test_robust_fitting_data_and_posteriors_equal_jax(monkeypatch):
    fits, (bargs, bkw) = _jax_robust(monkeypatch)
    d = trf.make_data()
    want = [(d["x"], d["y_out"]), (d["x"], d["y_out"]), (d["x"], d["y2"]),
            (d["x"], d["y2"]), (d["x_obs"], d["y3"]), (d["x_obs"], d["y3"])]
    assert len(fits) == len(want)
    for (args, _), (x, y) in zip(fits, want):
        np.testing.assert_array_equal(args[0], x)
        np.testing.assert_array_equal(args[1], y)
    for (tx, ty), (jx, jy) in zip(d["grids"], bargs[1]):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    # each likelihood's posterior: JAX's fit() settings, at its positions
    cases = [("gaussian", {}, {}),
             ("student_t", {"log_likelihood": jfit.make_student_t_likelihood(4.0)},
              {"likelihood": tfit.make_student_t_likelihood(4.0)}),
             ("noise_scale",
              {"log_likelihood": jfit.make_noise_scale_likelihood(), "data_error": 1.0,
               "params": {"m": 1.5, "b": 0.5, "noise_scale": 1.0},
               "log_prior": jfit.make_bounds_prior({"noise_scale": (1e-3, 1e3)})},
              {"likelihood": tfit.make_noise_scale_likelihood(), "data_error": 1.0,
               "params": {"m": 1.5, "b": 0.5, "noise_scale": 1.0},
               "prior": tfit.make_bounds_prior({"noise_scale": (1e-3, 1e3)})}),
             ("x_error", {"log_likelihood": jfit.make_x_error_likelihood(0.8),
                          "data_error": 0.2},
              {"likelihood": tfit.make_x_error_likelihood(0.8), "data_error": 0.2})]
    for name, jkw, tkw in cases:
        x, y = (d["x_obs"], d["y3"]) if name == "x_error" else (d["x"], d["y_out"])
        jw = jfit.walker_create(function=jzoo.line, data=(x, y),
                                **{"params": {"m": 1.5, "b": 0.5}, "data_error": 0.1, **jkw},
                                n_walkers=W, seed=0, walker_jitter=0.05)
        tw = trf.fit(x, y, device="cpu", dtype=F64, n_steps=200, **tkw)
        same_posterior(tw, jw, name)
    jb = jfit.BatchedFit(jzoo.line, bargs[1], {"m": 1.5, "b": 0.5}, data_error=0.1,
                         log_likelihood=jfit.make_student_t_likelihood(4.0),
                         walkers_per_dataset=4, seed=0)
    tb = tfit.BatchedFit(models.line, d["grids"], {"m": 1.5, "b": 0.5}, data_error=0.1,
                         log_likelihood=tfit.make_student_t_likelihood(4.0),
                         walkers_per_dataset=4, seed=0, dtype=F64, device="cpu")
    same_posterior(tb, jb, "t(4) batch")


def test_robust_fitting_loo_of_a_carried_walker():
    d = trf.make_data()
    common = dict(data=(d["x"], d["y_out"]), params={"m": 2.0, "b": 1.0}, data_error=0.1)
    jw = jfit.walker_create(function=jzoo.line, n_walkers=W, seed=0, walker_jitter=0.05,
                            log_likelihood=jfit.make_student_t_likelihood(4.0), **common)
    jw.adaptive_steps(400, auto=None)
    tw = carried(jw, function=models.line,
                 log_likelihood=tfit.make_student_t_likelihood(4.0), **common)
    tr, jr = td.loo(tw), jd.loo(jw)
    same([tr.elpd, tr.p_loo], [jr.elpd, jr.p_loo], "loo")
    same(tr.pareto_k, jr.pareto_k, "pareto k")


def test_robust_fitting_phases_at_a_tiny_budget(monkeypatch):
    short_chunks(monkeypatch)
    steps = {"fit": 200, "batch": 200, "sbc": 200, "sbc_sims": 4}
    d = trf.make_data()
    w_g, w_t = trf.outliers(d, "cpu", steps)
    w_k, pit_fixed, pit_fitted = trf.unknown_noise(d, "cpu", steps)
    assert "noise_scale" in w_k.most_likely_params()
    w_naive, w_xe = trf.noisy_x(d, "cpu", steps)
    batch, worst = trf.scan_grid(d, "cpu", steps)
    assert batch.n_datasets == trf.S and math.isfinite(worst)
    assert trf.audit(d, "cpu", steps).n_sims == 4


# ------------------------------------------------------------ hard_geometry


def test_hard_geometry_posterior_equals_jax():
    jhg = jax_example("hard_geometry")
    assert thg.TRUTH == jhg.TRUTH and thg.BOUNDS == jhg.BOUNDS
    jw = jfit.walker_create(function=jhg.model, data=([0.0, 1.0], [0.0, 0.0]),
                            params={"t1": 0.5, "t2": 0.5}, log_likelihood=jhg.loglik,
                            n_walkers=W, seed=0, walker_jitter=0.5,
                            log_prior=jfit.make_bounds_prior(jhg.BOUNDS))
    tw = thg.make_walker("cpu")
    same_posterior(tw, jw, "banana")
    assert tw.dtype == F64


def test_hard_geometry_phases_at_a_tiny_budget(monkeypatch):
    short_chunks(monkeypatch)
    steps = {"anneal": 200, "advi": 10, "flow": 10, "evidence": 160, "respread": 100,
             "chees": 20, "neutra": 10}
    w = thg.make_walker("cpu")
    g, fv, ev = thg.fit_and_flow(w, steps)
    assert all(math.isfinite(r.log_z) for r in (g, fv, ev))
    tr = thg.chees(w, steps)
    assert tr["budget"] > 0
    res, same_ = thg.neutra_and_chain(w, fv, steps)
    assert same_ and res.samples_by_step.shape[1] == 128
