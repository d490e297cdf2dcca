"""The port's batched and hierarchical workflows (examples_torch/) against
the JAX package's (examples/): scan_model_comparison, hierarchical_scan,
hierarchical_calibration.

For each: the data the JAX example builds (its ``make_scan``, or recorded
from its ``main`` with the constructors captured) equals the port's; the
posterior of each ``BatchedFit`` and ``HierarchicalFit`` the port builds
equals the JAX fit's at the JAX fit's positions (float64, 1e-10); the
port's phase functions run at a tiny budget with finite results.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
from lisp_mcmc_tpu.models import zoo as jzoo

from torch_examples_util import (Capture, Fake, Stop, cheap_evidence, jax_example, port_example,
                                 same_data, same_posterior, short_chunks,
                                 short_refits)

F64 = torch.float64
tsc = port_example("scan_model_comparison")
ths = port_example("hierarchical_scan")
thc = port_example("hierarchical_calibration")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ scan_model_comparison


def test_scan_data_and_posteriors_equal_jax():
    jsc = jax_example("scan_model_comparison")
    jx, jspectra, jsplits = jsc.make_scan()
    tx, tspectra, tsplits = tsc.make_scan()
    np.testing.assert_array_equal(tx, jx)
    assert tsplits == jsplits and tsc.BOUNDS1 == jsc.BOUNDS1 and tsc.BOUNDS2 == jsc.BOUNDS2
    for (a, b), (c, e) in zip(tspectra, jspectra):
        np.testing.assert_array_equal(a, c)
        same_data(b, e)
    for jmodel, tmodel, guess, bounds in (
            (jzoo.double_lorentzian_bg, tsc.double_lorentzian_bg, tsc.GUESS2, tsc.BOUNDS2),
            (jzoo.lorentzian_bg, tsc.lorentzian_bg, tsc.GUESS1, tsc.BOUNDS1)):
        jf = jfit.BatchedFit(jmodel, jspectra, guess, data_error=2e-6,
                             log_prior=jfit.make_bounds_prior(bounds),
                             walkers_per_dataset=128, seed=0, walker_jitter=0.05)
        tf = tsc.make_family(tmodel, tspectra, guess, bounds, "cpu", F64)
        same_posterior(tf, jf, tmodel.__name__)


def test_scan_phases_at_a_tiny_budget(monkeypatch):
    cheap_evidence(monkeypatch)
    short_chunks(monkeypatch)
    steps = {"anneal": 200, "optimize": 10, "cold": 200, "max_samples": 32, "n_live": 32}
    x, spectra, splits = tsc.make_scan()
    fit2 = tsc.fit_family(tsc.double_lorentzian_bg, spectra, tsc.GUESS2, tsc.BOUNDS2,
                          "cpu", steps)
    fit1 = tsc.fit_family(tsc.lorentzian_bg, spectra, tsc.GUESS1, tsc.BOUNDS1, "cpu", steps)
    conv, per_ok, failing, lap2, lap1 = tsc.compare(fit2, fit1, splits, steps)
    assert len(per_ok) == 6 and failing <= set(range(6))
    assert all(math.isfinite(r.log_z) for r in (*lap2, *lap1))
    ns2, ns1 = tsc.nested_column(fit2, fit1, splits, lap2, lap1, steps)
    assert len(ns2) == len(ns1) == 6 and all(math.isfinite(r.log_z) for r in ns2)


# ------------------------------------------------------------ hierarchical_scan


def _jax_hier_scan(monkeypatch):
    """JAX hierarchical_scan.main's two fits: (BatchedFit, HierarchicalFit)
    calls."""
    jhs = jax_example("hierarchical_scan")
    indep, hier = Capture(), Capture(stop_at=1)
    monkeypatch.setattr(jfit, "BatchedFit", indep)
    monkeypatch.setattr(jfit, "HierarchicalFit", hier)
    with pytest.raises(Stop):
        jhs.main()
    monkeypatch.undo()
    return jhs, indep.calls[0], hier.calls[0]


def test_hierarchical_scan_data_and_posteriors_equal_jax(monkeypatch):
    jhs, (iargs, ikw), (hargs, hkw) = _jax_hier_scan(monkeypatch)
    datasets, truths = ths.make_scan()
    jdatasets, jtruths = jhs.make_scan()
    assert truths == jtruths and ths.NOISE == jhs.NOISE
    for (a, b), (c, e), (f, g), (h, k) in zip(datasets, jdatasets, iargs[1], hargs[1]):
        for x in (c, f, h):
            np.testing.assert_array_equal(a, x)
        for y in (e, g, k):
            same_data(b, y)
    assert iargs[2] == hargs[2] == ths.GUESS
    jb = jfit.BatchedFit(*iargs, **{**ikw, "walkers_per_dataset": 4})
    from lisp_mcmc_torch import BatchedFit, models
    tb = BatchedFit(models.double_lorentzian_bg, datasets, ths.GUESS,
                    data_error=[float(n) for n in ths.NOISE], walkers_per_dataset=4,
                    seed=0, walker_jitter=0.05, dtype=F64, device="cpu")
    same_posterior(tb, jb, "independent fits")
    assert ikw["walkers_per_dataset"] == 64
    jh = jfit.HierarchicalFit(*hargs, **hkw)
    th = ths.make_hierarchical(datasets, "cpu", F64)
    assert th.n_walkers == hkw["n_walkers"] == 128
    same_posterior(th, jh, "hierarchical fit")


def test_hierarchical_scan_phases_at_a_tiny_budget(monkeypatch):
    short_chunks(monkeypatch)
    steps = {"indep": 200, "hier": 30, "burn": 15, "max_samples": 16, "optimize": 10,
             "pool": 40, "pool_max_samples": 16}
    datasets, truths = ths.make_scan()
    indep, hier, err_i, err_h, hier_med = ths.fit_both(datasets, truths, "cpu", steps)
    assert len(err_i) == len(err_h) == 4 and len(hier_med) == 6
    (lo, hi), (tlo, thi) = ths.next_pixel(hier, steps)
    assert np.isfinite(lo).all() and np.isfinite(thi).all()
    assert math.isfinite(ths.evidence(hier, steps).log_z)
    cmp = ths.pooling_verdict(truths, "cpu", steps)
    assert set(cmp.weights) == {"pooled", "partial", "independent"}


# ------------------------------------------------------------ hierarchical_calibration


def test_hierarchical_calibration_data_and_posterior_equal_jax(monkeypatch):
    jhc = jax_example("hierarchical_calibration")
    hier = Capture(stop_at=1)
    monkeypatch.setattr(jfit, "sbc_check_hierarchical", lambda *a, **k: Fake())
    monkeypatch.setattr(jfit, "HierarchicalFit", hier)
    with pytest.raises(Stop):
        jhc.main()
    monkeypatch.undo()
    (fn, jdatasets, params), kw = hier.calls[0]
    datasets = thc.make_data()
    for (a, b), (c, e) in zip(datasets, jdatasets):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)
    assert params == {"m": 1.5, "b": 0.5} and kw["data_error"] == 0.3
    jh = jfit.HierarchicalFit(fn, jdatasets, params, **kw)
    th = thc.make_fit(datasets, "cpu", F64)
    same_posterior(th, jh, "pooled line fit")


def test_hierarchical_calibration_phases_at_a_tiny_budget(monkeypatch):
    steps = {"sbc_sims": 4, "sbc": 200, "sbc_mala": 20, "anneal": 200, "chees": 20,
             "refit": 100}
    sbc = thc.calibrate("cpu", steps)
    assert sbc.n_sims == 4 and "c__tau" in sbc.p_values
    short_chunks(monkeypatch)
    short_refits(monkeypatch)
    fit = thc.fit_grid(thc.make_data(), "cpu", steps)
    base = thc.verify(fit)
    assert base.pareto_k.shape == (thc.S * thc.N,)
    # at this budget most points are flagged, more than reloo refits: keep
    # the planted outlier's flag alone
    k = np.where(np.arange(thc.S * thc.N) == thc.N + 7, 1.0, 0.1)
    exact, kf = thc.refit(fit, dataclasses.replace(base, pareto_k=k), steps)
    assert exact.pareto_k[thc.N + 7] <= 0.7
    assert math.isfinite(exact.elpd) and math.isfinite(kf.elpd)
