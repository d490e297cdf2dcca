"""Partial pooling across a scan grid: HierarchicalFit end to end, on PyTorch.

The counterpart of ``examples/hierarchical_scan.py``.  The reference's
batch workflow fits every spectrum of an NV scan independently
(``dir->nv-walkers``, nv-specific.lisp:58-66).  On a real field map the
resonance positions vary point to point, but the linewidth, contrast,
and background are properties of the SAME device — fitting them
independently throws that information away, and the sparsest pixels pay
for it.  This example fits a simulated 6-pixel scan three ways:

  1. independent per-pixel fits (``BatchedFit`` — the reference's
     pattern, vectorized);
  2. one hierarchical fit pooling (sigma, bg0) through a population
     (``HierarchicalFit``, non-centered, chees kernel);
  3. the closed-loop check: on the LOW-SNR pixels the hierarchical
     linewidth errors beat the independent ones (borrowed strength),
     while resonance positions stay per-pixel.

It also shows the evidence layer riding the hierarchy for free: the
non-centered prior is a product of independent 1-D distributions, so
the evidence verbs consume the fit without any extra declaration.

The hierarchical posterior is d = 2*2 + 6*6 = 40.  For real NV scan
grids, ``nv.HierarchicalNVFit(spectra)`` is the one-call version of fit
#2.  :data:`STEPS` holds the step counts (the JAX example's), which a
caller may cut; the forest plot is drawn only into a given ``figures``
directory.

Run: ``python examples_torch/hierarchical_scan.py [figure-dir]``
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch._common import phase, setup_device  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lisp_mcmc_torch as mfit  # noqa: E402
from lisp_mcmc_torch.models import double_lorentzian_bg  # noqa: E402
from lisp_mcmc_torch.priors import Gaussian, LogNormal  # noqa: E402

TRUE_SIGMA = 8.0          # device linewidth, shared up to ~5% pixel scatter
TRUE_BG = 1.0e-4
NOISE = [2e-6, 2e-6, 8e-6, 8e-6, 1.2e-5, 1.2e-5]   # SNR falls across pixels
GUESS = {"scale1": 8e-5, "scale2": 8e-5, "mu1": 2862.0, "mu2": 2878.0,
         "sigma": 9.0, "bg0": 1e-4}
STEPS = {"indep": 10000, "hier": 10000, "burn": 7000, "max_samples": 256,
         "optimize": 300, "pool": 3000, "pool_max_samples": 128}


def make_scan(seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(2800.0, 2940.0, 160)
    datasets, truths = [], []
    for i, noise in enumerate(NOISE):
        split = 10.0 + 3.0 * i
        truth = {
            "scale1": 9e-5, "scale2": 8.5e-5,
            "mu1": 2870.0 - split / 2, "mu2": 2870.0 + split / 2,
            "sigma": TRUE_SIGMA * (1.0 + 0.05 * rng.standard_normal()),
            "bg0": TRUE_BG,
        }
        p = {k: torch.tensor(v, dtype=torch.float64) for k, v in truth.items()}
        y = double_lorentzian_bg(torch.tensor(x), p).numpy()
        datasets.append((x, y + noise * rng.standard_normal(x.shape)))
        truths.append(truth)
    return datasets, truths


def make_independent(datasets, device, dtype=None):
    return mfit.BatchedFit(
        double_lorentzian_bg, datasets, GUESS,
        data_error=[float(n) for n in NOISE],
        walkers_per_dataset=64, seed=0, walker_jitter=0.05, dtype=dtype, device=device)


def make_hierarchical(datasets, device, dtype=None):
    # Resonances and contrasts stay per-pixel (local_priors), the
    # device-level linewidth/background share a population.
    return mfit.HierarchicalFit(
        double_lorentzian_bg, datasets, GUESS,
        data_error=[float(n) for n in NOISE],
        pooled=["sigma", "bg0"],
        hyper={
            "sigma": (Gaussian(9.0, 4.0, low=0.5),
                      LogNormal(np.log(0.8), 0.7)),
            "bg0": (Gaussian(1e-4, 5e-5),
                    LogNormal(np.log(3e-6), 1.0)),
        },
        local_priors={
            "scale1": (0.0, 1e-3), "scale2": (0.0, 1e-3),
            # Split at the zero-field center: the identifiability
            # constraint the reference encodes as a -1e9 mu1<mu2 penalty
            # (nv-specific.lisp:31-34) — without it the two dips are
            # exchangeable and walkers label-switch.
            "mu1": (2800.0, 2870.0), "mu2": (2870.0, 2940.0),
        },
        n_walkers=128, seed=0,
        config=mfit.FitConfig(kernel="chees"), dtype=dtype, device=device)


def fit_both(datasets, truths, device, steps=STEPS, dtype=None):
    """Fits 1-2 and the per-pixel table; returns ``(indep, hier, err_i,
    err_h, hier_med)``."""
    S = len(datasets)
    # ---- 1. independent fits (the reference's batch pattern) ----------
    with phase("1. independent fits"):
        indep = make_independent(datasets, device, dtype)
        indep.adaptive_steps(steps["indep"], auto=None)
        indep_best = indep.best_params_per_dataset()

    # ---- 2. hierarchical fit: pool (sigma, bg0) ------------------------
    with phase("2. hierarchical fit"):
        hier = make_hierarchical(datasets, device, dtype)
        hier.adaptive_steps(steps["hier"], auto=None)
        hier.burn_steps(steps["burn"])
        hier_med = hier.params_per_dataset("median")
        hyp = hier.hyper_params("median")

    print("population: sigma_mu=%.2f sigma_tau=%.2f (truth %.1f +- ~0.4)"
          % (hyp["mu"]["sigma"], hyp["tau"]["sigma"], TRUE_SIGMA))
    print("pixel  noise   sigma_true  sigma_indep  sigma_hier")
    err_i, err_h = [], []
    for s in range(S):
        st = truths[s]["sigma"]
        si = indep_best[s]["sigma"]
        sh = hier_med[s]["sigma"]
        print(f"  {s}   {NOISE[s]:7.0e}   {st:8.2f}   {si:9.2f}   {sh:8.2f}")
        if NOISE[s] >= 8e-6:                  # the weak pixels
            err_i.append(abs(si - st))
            err_h.append(abs(sh - st))
    print("weak-pixel mean |sigma error|: indep %.3f  hier %.3f"
          % (np.mean(err_i), np.mean(err_h)))
    return indep, hier, err_i, err_h, hier_med


def next_pixel(hier, steps=STEPS):
    """Step 3: the next pixel's predictive band; returns the two bands."""
    # A new pixel's resonances/contrasts are its own business (pin them
    # at the design values via fixed=); its linewidth and background come
    # from the fitted POPULATION: each posterior hyper draw decodes a
    # fresh group theta = mu + tau*z, so the band carries the population
    # spread AND the hyper uncertainty.  population_mean=True pins z=0
    # (the population-typical curve) — necessarily tighter.
    with phase("3. next-pixel prediction"):
        grid = np.linspace(2840.0, 2950.0, 200)
        pin = {"scale1": 8e-5, "scale2": 8e-5, "mu1": 2862.0, "mu2": 2878.0}
        nxt = hier.predict_new(grid, fixed=pin, max_samples=steps["max_samples"], seed=5)
        typ = hier.predict_new(grid, fixed=pin, population_mean=True,
                               max_samples=steps["max_samples"], seed=5)
        lo, hi = nxt.band()
        tlo, thi = typ.band()
        print("next-pixel curve band (max half-width): %.2e  "
              "population-typical: %.2e" % (np.max(hi - lo) / 2,
                                            np.max(thi - tlo) / 2))
    return (lo, hi), (tlo, thi)


def evidence(hier, steps=STEPS):
    """Step 4: a Laplace evidence of the hierarchy; returns it."""
    # d = 2*2 + 6*6 = 40; a cheap Laplace pass demonstrates the surface
    # (nested/smc work the same way via the auto-recovered PriorSpec).
    with phase("4. Laplace evidence"):
        hier.optimize(steps["optimize"])
        lap = hier.laplace_approx()
        print("hierarchical log Z (Laplace): %.1f  (spec auto-recovered: %s)"
              % (lap.log_z, hier.prior_spec is not None))
    return lap


def pooling_verdict(truths, device, steps=STEPS, dtype=None):
    """Step 5: compare_pooling on a const-parameter slice; returns it."""
    # compare_pooling fits {complete pooling, partial, independent} on a
    # small const-parameter slice of the question and scores them by
    # PSIS-LOO on the same points + stacking weights.  On this grid the
    # linewidths genuinely share a population, so complete pooling of
    # EVERYTHING over-constrains while independence over-fits the noisy
    # pixels — the verdict machinery makes that a one-liner instead of
    # a hand-built study.
    with phase("compare_pooling verdict"):
        xs = np.linspace(0.0, 1.0, 10)
        rng2 = np.random.default_rng(9)
        sub = [(xs, t["sigma"] + 0.8 * rng2.standard_normal(10))
               for t in truths]
        cmpres = mfit.compare_pooling(
            lambda x, p: p["c"] + 0.0 * x, sub, {"c": 25.0},
            data_error=0.8,
            hyper={"c": (Gaussian(25.0, 10.0), LogNormal(np.log(2.0), 0.7))},
            n_steps=steps["pool"], n_walkers=96, walkers_per_dataset=32,
            max_samples=steps["pool_max_samples"], dtype=dtype, device=device)
        print(cmpres)
    return cmpres


def main(device=None, steps=None, dtype=None, figures=None):
    """The whole example; ``steps`` overrides :data:`STEPS`."""
    device = setup_device() if device is None else device
    steps = {**STEPS, **(steps or {})}
    datasets, truths = make_scan()
    S = len(datasets)

    indep, hier, err_i, err_h, hier_med = fit_both(datasets, truths, device, steps, dtype)
    # Borrowed strength: pooling must not LOSE on the weak pixels.
    assert np.mean(err_h) < np.mean(err_i) * 1.25, (err_h, err_i)

    # Resonance positions stay per-pixel (no pooling distortion).
    for s in range(S):
        assert abs(hier_med[s]["mu1"] - truths[s]["mu1"]) < 1.0
        assert abs(hier_med[s]["mu2"] - truths[s]["mu2"]) < 1.0

    # The one-glance summary: per-pixel linewidth intervals over the
    # population band (shrinkage made visible).
    if figures is not None:
        from lisp_mcmc_torch import plotting

        plotting.forest_plot(hier, "sigma", filename=os.path.join(figures, "hier_forest.png"))
        print(f"forest plot -> {os.path.join(figures, 'hier_forest.png')}")

    # ---- 3. what will the NEXT pixel look like? ------------------------
    (lo, hi), (tlo, thi) = next_pixel(hier, steps)
    assert np.all(np.isfinite(lo)) and np.all(np.isfinite(hi))
    assert np.max(hi - lo) >= 0.98 * np.max(thi - tlo)

    # ---- 4. the evidence layer rides for free --------------------------
    lap = evidence(hier, steps)
    assert hier.prior_spec is not None and np.isfinite(lap.log_z)

    # ---- 5. should I pool at all? (one call) ---------------------------
    cmpres = pooling_verdict(truths, device, steps, dtype)
    return {"indep": indep, "hier": hier, "errors": (err_i, err_h), "laplace": lap,
            "pooling": cmpres}


if __name__ == "__main__":
    main(figures=sys.argv[1] if len(sys.argv) > 1 else None)
