"""Scan-grid model comparison: one peak or two, per spectrum, batched, on PyTorch.

The counterpart of ``examples/scan_model_comparison.py``.  The lab
question the reference pipeline could not ask: across a scan of spectra
(nv-specific's dir->nv-walkers workflow, one walker per file), WHICH
spectra actually resolve two peaks?  Here both model families fit every
spectrum as one batched ensemble each, and the per-dataset comparison
tools answer it spectrum-by-spectrum:

  - `laplace_per_dataset`  — S evidences per family from one batched
                             Hessian (instant, curvature-based)
  - `waic_per_dataset`     — S predictive scores per family from the
                             collected histories (prior-free)
  - `nested_per_dataset`   — S nested-sampling evidences per family as
                             ONE batched program (exact ridge-safe
                             integrals where Laplace flags n_clamped)

:data:`STEPS` holds the step counts (the JAX example's), which a caller
may cut.

Run: ``python examples_torch/scan_model_comparison.py``
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch._common import phase, setup_device  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lisp_mcmc_torch as mfit  # noqa: E402
from lisp_mcmc_torch import diagnostics  # noqa: E402
from lisp_mcmc_torch.models import double_lorentzian_bg, lorentzian_bg  # noqa: E402

STEPS = {"anneal": 16000, "optimize": 300, "cold": 6000, "max_samples": 256,
         "n_live": 256}


def make_scan(n_spectra=6, seed=0):
    """A field scan: peak splitting shrinks from resolved to merged."""
    rng = np.random.default_rng(seed)
    x = np.linspace(2800.0, 2940.0, 192)
    spectra, splits = [], []
    for i in range(n_spectra):
        split = 24.0 * (1.0 - i / (n_spectra - 1))        # 24 .. 0 MHz
        truth = {"scale1": 9e-5, "scale2": 8e-5,
                 "mu1": 2870.0 - split / 2, "mu2": 2870.0 + split / 2,
                 "sigma": 8.0, "bg0": 1e-4}
        p = {k: torch.tensor(v, dtype=torch.float64) for k, v in truth.items()}
        y = double_lorentzian_bg(torch.tensor(x), p).numpy()
        spectra.append((x, y + 2e-6 * rng.standard_normal(x.shape)))
        splits.append(split)
    return x, spectra, splits


BOUNDS2 = {"scale1": (0.0, 1e-3), "scale2": (0.0, 1e-3),
           "mu1": (2800.0, 2940.0), "mu2": (2800.0, 2940.0),
           "sigma": (1.0, 40.0), "bg0": (0.0, 1e-3)}
# The scan data is DIPS below a background (double_lorentzian_bg is
# bg0 - L1 - L2); the one-peak lorentzian_bg is bg + scale*L, so its
# scale must be allowed NEGATIVE or it can only fit the background and
# the comparison is rigged (measured in the JAX package: with scale >= 0
# every spectrum read "two peaks" by ~25+ log-units even at zero
# splitting).
BOUNDS1 = {"scale": (-1e-3, 1e-3), "x0": (2800.0, 2940.0),
           "linewidth": (1.0, 40.0), "bg0": (0.0, 1e-3),
           "bg1": (-1e-6, 1e-6)}
GUESS2 = {"scale1": 8e-5, "scale2": 8e-5, "mu1": 2860.0, "mu2": 2880.0,
          "sigma": 9.0, "bg0": 1e-4}
GUESS1 = {"scale": -1.6e-4, "x0": 2870.0, "linewidth": 12.0, "bg0": 1e-4, "bg1": 1e-12}


def make_family(model, spectra, guess, bounds, device, dtype=None):
    return mfit.BatchedFit(model, spectra, guess, data_error=2e-6,
                           log_prior=mfit.make_bounds_prior(bounds),
                           walkers_per_dataset=128, seed=0,
                           walker_jitter=0.05, dtype=dtype, device=device)


def fit_family(model, spectra, guess, bounds, device, steps=STEPS, dtype=None):
    fit = make_family(model, spectra, guess, bounds, device, dtype)
    fit.adaptive_steps(steps["anneal"], temperature=10.0, auto=None,
                       collect_history=False)
    fit.optimize(steps["optimize"])
    # WAIC needs POSTERIOR history: collapse anneal stragglers (each
    # dataset to its own best — the batched override) and sample cold.
    # Without this the hot-phase rows inflate p_waic by ~1e6 (measured
    # in the JAX package; see diagnostics.waic's docstring).
    fit.reset_to_most_likely()
    fit.adaptive_steps(steps["cold"], temperature=1.0, auto=None)
    fit.burn_steps(len(fit) // 2)
    return fit


def compare(fit2, fit1, splits, steps=STEPS):
    """The per-dataset convergence verdict, Laplace and WAIC columns;
    returns ``(conv, per_ok, failing, lap2, lap1)``."""
    # Quality gate before comparing anything: the per-dataset convergence
    # verdict (BatchedFit.convergence) — a failing spectrum would make
    # its WAIC/Laplace row meaningless, and the verdict names WHICH
    # spectrum to distrust instead of silently blessing the grid.  On
    # THIS grid the verdict is genuinely informative: as the splitting
    # merges (datasets 4-5), the two-peak model's mu1<->mu2 swap makes
    # the block multimodal and rank R-hat reads it loudly — the same
    # degeneracy n_clamped flags in the Laplace column below.
    with phase("per-dataset convergence, Laplace, WAIC"):
        conv = fit2.convergence(rhat_tol=1.05, min_tail_ess=50.0)
        per_ok = [v["ok"] for v in conv["per_dataset"]]
        print(f"two-peak fit per-dataset convergence: {per_ok}")
        if conv["failures"]:
            print(f"  gate names the suspect spectra: {conv['failures'][:4]}")
        failing = {int(msg.split()[1].rstrip(":")) for msg in conv["failures"]}

        lap2 = fit2.laplace_per_dataset()
        lap1 = fit1.laplace_per_dataset()
        waic2 = fit2.waic_per_dataset(max_samples=steps["max_samples"])
        waic1 = fit1.waic_per_dataset(max_samples=steps["max_samples"])

        # Verdict from the PAIRED WAIC difference with its standard error
        # (the honest margin); the Laplace dlogZ is the instant cross-check
        # — note n_clamped: at merged splits the two-peak model's mu1=mu2
        # ridge is degenerate and its Laplace evidence is flagged unreliable
        # exactly where the comparison gets delicate.
        print("spectrum  split  dlogZ(Laplace) clamped  dELPD+-se(WAIC)  verdict")
        for s, split in enumerate(splits):
            dz = lap2[s].log_z - lap1[s].log_z
            cmpd = diagnostics.waic_compare(waic2[s], waic1[s])
            de, se = cmpd["elpd_diff"], cmpd["se_diff"]
            verdict = ("two peaks" if de > 2 * se else
                       "one peak" if de < -2 * se else "undecided")
            print(f"    {s}    {split:5.1f}   {dz:10.1f}      {lap2[s].n_clamped}"
                  f"     {de:8.1f}+-{se:5.1f}   {verdict}")
        # Expected shape: decisively two-peak at large splits, shrinking
        # toward undecided as the splitting vanishes below the linewidth
        # (at tiny-but-nonzero splits the high-SNR data may still resolve
        # the asymmetry — "undecided" is a statement about margins, not a
        # guarantee of label "one peak").
    return conv, per_ok, failing, lap2, lap1


def nested_column(fit2, fit1, splits, lap2, lap1, steps=STEPS):
    """The nested-sampling column; returns ``(ns2, ns1)``."""
    # Third column where it matters: on the merged spectra the two-peak
    # Laplace evidence was FLAGGED (n_clamped > 0: the mu1=mu2 ridge is
    # degenerate, a Gaussian integral there is a guess).  Nested sampling
    # integrates the ridge exactly — all S runs per family ride one
    # batched device program, fresh live sets from the prior (the fits'
    # ensembles are untouched).
    with phase("nested per dataset"):
        ns2 = fit2.nested_per_dataset(n_live=steps["n_live"], seed=0)
        ns1 = fit1.nested_per_dataset(n_live=steps["n_live"], seed=0)
        print("spectrum  split  dlogZ(nested)+-err   dlogZ(Laplace)")
        for s, split in enumerate(splits):
            dz_n = ns2[s].log_z - ns1[s].log_z
            err = float(np.hypot(ns2[s].log_z_err, ns1[s].log_z_err))
            dz_l = lap2[s].log_z - lap1[s].log_z
            print(f"    {s}    {split:5.1f}   {dz_n:10.1f}+-{err:4.2f}"
                  f"   {dz_l:10.1f}")
    return ns2, ns1


def main(device=None, steps=None, dtype=None):
    """The whole comparison; ``steps`` overrides :data:`STEPS`."""
    device = setup_device() if device is None else device
    steps = {**STEPS, **(steps or {})}
    x, spectra, splits = make_scan()

    with phase("two-peak family"):
        fit2 = fit_family(double_lorentzian_bg, spectra, GUESS2, BOUNDS2, device, steps,
                          dtype)
    with phase("one-peak family"):
        fit1 = fit_family(lorentzian_bg, spectra, GUESS1, BOUNDS1, device, steps, dtype)

    conv, per_ok, failing, lap2, lap1 = compare(fit2, fit1, splits, steps)
    assert len(per_ok) == fit2.n_datasets
    # well-separated spectra must pass; the merged-split tail is ALLOWED
    # to fail (that failure is the signal, not a bug)
    assert all(per_ok[:3]), conv["failures"]
    assert failing <= {3, 4, 5}, conv["failures"]

    ns2, ns1 = nested_column(fit2, fit1, splits, lap2, lap1, steps)
    # On clean-curvature spectra the two estimators agree; the resolved
    # end must be decisively two-peak under BOTH.
    for s in (0, 1, 2):
        dz_n = ns2[s].log_z - ns1[s].log_z
        assert dz_n > 10.0, (s, dz_n)
    return {"fits": (fit2, fit1), "convergence": conv, "laplace": (lap2, lap1),
            "nested": (ns2, ns1)}


if __name__ == "__main__":
    main()
