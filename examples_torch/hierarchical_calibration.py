"""The hierarchical calibration loop: trust, verify, refit, on PyTorch.

The counterpart of ``examples/hierarchical_calibration.py``.  Partial
pooling (``HierarchicalFit``) is the model class where miscalibration
hides best: tau posteriors concentrate near boundaries, shrinkage can
bury a discrepant dataset, and PSIS-LOO's importance ratios break exactly
at the influential points you care about.  This example runs the full
closed loop the framework provides for it:

  1. **Before fitting** — ``sbc_check_hierarchical``: simulation-based
     calibration of the whole pipeline (prior -> simulate -> refit ->
     rank) in walk space.  tau/z rank uniformity is the funnel check
     nothing else provides.  All simulations refit as ONE grouped
     ensemble.
  2. **Fit** — a 5-dataset grid with one contaminated dataset (a gross
     outlier point), pooled slope through a population.
  3. **Verify** — joint ``diagnostics.loo`` over the dataset-major
     point axis flags the outlier (Pareto k > 0.7: importance sampling
     cannot reach its leave-one-out posterior).
  4. **Refit** — ``diagnostics.reloo`` masks each flagged point out of
     its stacked block and refits the FULL joint non-centered posterior
     (all leave-out posteriors as adaptation groups of one ensemble),
     replacing the flagged elpds with exact values; ``kfold`` cross-
     checks wholesale.

No reference analogue at any step: the Lisp original has no pooling, no
LOO, and no refit machinery (its closest workflow is the sequential
independent batch driver, nv-specific.lisp:58-66).  :data:`STEPS` holds
the step counts (the JAX example's), which a caller may cut.

Run: ``python examples_torch/hierarchical_calibration.py``
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch._common import phase, setup_device  # noqa: E402

import numpy as np  # noqa: E402

import lisp_mcmc_torch as mfit  # noqa: E402
from lisp_mcmc_torch.diagnostics import kfold, loo, reloo  # noqa: E402
from lisp_mcmc_torch.models import line  # noqa: E402
from lisp_mcmc_torch.priors import Gaussian, LogNormal  # noqa: E402

HYPER = {"m": (Gaussian(2.0, 1.0), LogNormal(np.log(0.3), 0.5)),
         "b": (Gaussian(1.0, 1.0), LogNormal(np.log(0.3), 0.5))}
S, N = 5, 16
STEPS = {"sbc_sims": 40, "sbc": 3000, "sbc_mala": 3000, "anneal": 3000, "chees": 3000,
         "refit": 1200}


def calibrate(device, steps=STEPS, dtype=None):
    """Step 1: SBC of the partial-pooling pipeline; returns the result."""
    print("== 1. SBC of the partial-pooling pipeline (walk space) ==")
    with phase("1. hierarchical SBC"):
        x_sbc = np.linspace(0.0, 1.0, 8)
        sbc = mfit.sbc_check_hierarchical(
            lambda x, p: p["c"] + 0.0 * x, x_sbc, {"c": 0.0}, 4,
            data_error=0.5,
            hyper={"c": (Gaussian(0.0, 1.0), LogNormal(np.log(0.5), 0.4))},
            n_sims=steps["sbc_sims"], walkers_per_sim=24, n_steps=steps["sbc"],
            sampling_steps=steps["sbc_mala"], sampling_kernel="mala", seed=0,
            dtype=dtype, device=device)
        print(f"   {sbc}")
        print(f"   tau uniformity p = {sbc.p_values['c__tau']:.3f} "
              f"(the funnel check)\n")
    return sbc


def make_data():
    """The 5-dataset grid with the planted outlier, from ``default_rng(7)``
    after nothing else drew from it."""
    rng = np.random.default_rng(7)
    x = np.linspace(0.0, 10.0, N)
    ms = rng.normal(2.0, 0.3, S)
    datasets = [(x, m * x + 1.0 + rng.normal(0, 0.3, N)) for m in ms]
    datasets[1][1][7] += 4.5                      # the contamination
    return datasets


def make_fit(datasets, device, dtype=None):
    return mfit.HierarchicalFit(line, datasets, {"m": 1.5, "b": 0.5},
                                data_error=0.3, hyper=HYPER,
                                n_walkers=128, seed=0, dtype=dtype, device=device)


def fit_grid(datasets, device, steps=STEPS, dtype=None):
    """Step 2: the pooled fit; returns it."""
    print("== 2. 5-dataset pooled fit, one gross outlier planted ==")
    with phase("2. pooled fit"):
        fit = make_fit(datasets, device, dtype)
        fit.adaptive_steps(steps["anneal"], auto=None)
        fit.reset()
        fit.sampling_steps(steps["chees"], kernel="chees")
        fit.burn_steps(len(fit) // 2)
        hp = fit.hyper_params("median")
        print(f"   population slope: mu={hp['mu']['m']:.3f} "
              f"tau={hp['tau']['m']:.3f}\n")
    return fit


def verify(fit):
    """Step 3: joint PSIS-LOO over every point; returns the result."""
    # ---- 3. joint LOO flags the point IS cannot handle --------------
    print("== 3. joint PSIS-LOO over all 80 points ==")
    with phase("3. joint PSIS-LOO"):
        base = loo(fit)
        flagged = np.where(base.pareto_k > 0.7)[0]
        planted = 1 * N + 7                           # dataset-major index
        print(f"   {base}")
        print(f"   flagged (k > 0.7): {flagged.tolist()} "
              f"(planted outlier is index {planted})\n")
    return base


def refit(fit, base, steps=STEPS):
    """Step 4: reloo of the flagged points, then kfold; returns ``(exact,
    kf)``."""
    # ---- 4. exact refits: the loop closes ---------------------------
    print("== 4. reloo (exact leave-one-out refits of the JOINT fit) ==")
    with phase("4. reloo + kfold"):
        exact = reloo(fit, base, n_steps=steps["refit"], walkers_per_dataset=16)
        print(f"   {exact}")
        print(f"   elpd PSIS -> exact: {base.elpd:.2f} -> {exact.elpd:.2f}; "
              f"all flags cleared: {bool((exact.pareto_k <= 0.7).all())}")
        kf = kfold(fit, k=5, n_steps=steps["refit"], walkers_per_dataset=16)
        print(f"   kfold cross-check: {kf}")
    print("\nThe loop: calibrate -> fit -> flag -> refit exactly. "
          "Every stage is one vectorized ensemble program.")
    return exact, kf


def main(device=None, steps=None, dtype=None):
    """The whole loop; ``steps`` overrides :data:`STEPS`."""
    device = setup_device() if device is None else device
    steps = {**STEPS, **(steps or {})}
    sbc = calibrate(device, steps, dtype)
    fit = fit_grid(make_data(), device, steps, dtype)
    base = verify(fit)
    exact, kf = refit(fit, base, steps)
    return {"sbc": sbc, "fit": fit, "loo": base, "reloo": exact, "kfold": kf}


if __name__ == "__main__":
    main()
