"""Messy-data fitting tour: outliers, unknown noise, noisy abscissae, on PyTorch.

The counterpart of ``examples/robust_fitting.py``.  Real lab data breaks
the textbook Gaussian assumptions three ways, and each breakage has a
likelihood factory (all of them WAIC/LOO/PPC-ready, all beyond anything
the Lisp reference could express):

1. outliers            — `make_student_t_likelihood` (heavy tails
                         discount bad points instead of letting one
                         veto the fit)
2. unknown noise level — `make_noise_scale_likelihood` (fit sigma as a
                         parameter; predictive coverage then reflects
                         the FITTED noise)
3. noisy x             — `make_x_error_likelihood` (York/ODR profile
                         form; autodiff df/dx corrects regression
                         dilution)

Plus the scale story: S spectra with per-spectrum outliers fit as ONE
``BatchedFit`` under the t likelihood, and the robust pipeline audited
end to end by ``sbc_check(log_likelihood=...)``.  These likelihoods are
custom, so the fits run the plain PyTorch posterior.

:func:`make_data` draws every step's data from the script's one seeded
stream, in the order the JAX example draws it; :data:`STEPS` holds the
step counts, which a caller may cut.

Run: ``python examples_torch/robust_fitting.py``
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch._common import phase, setup_device  # noqa: E402

import numpy as np  # noqa: E402

import lisp_mcmc_torch as mfit  # noqa: E402
from lisp_mcmc_torch import diagnostics  # noqa: E402
from lisp_mcmc_torch.models import line  # noqa: E402

TRUE_M, TRUE_B = 2.0, 1.0
S = 6
STEPS = {"fit": 5000, "batch": 5000, "sbc": 2500, "sbc_sims": 30}


def make_data() -> dict:
    """Every step's data from one ``default_rng(0)``, in the script's order."""
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 80)
    # 1. Outliers: 10% of points are garbage.
    y = TRUE_M * x + TRUE_B + rng.normal(0, 0.1, 80)
    bad = rng.choice(80, 8, replace=False)
    y_out = y.copy()
    y_out[bad] += rng.choice([-1, 1], 8) * rng.uniform(2, 4, 8)
    # 2. Unknown noise.
    y2 = TRUE_M * x + TRUE_B + rng.normal(0, 0.3, 80)
    # 3. Noisy abscissae.
    x_obs = x + rng.normal(0, 0.8, 80)
    y3 = TRUE_M * x + TRUE_B + rng.normal(0, 0.2, 80)
    # 4. S spectra, each with its own gross outlier.
    grids = []
    for s in range(S):
        ys = (1.5 + 0.2 * s) * x + TRUE_B + rng.normal(0, 0.1, x.size)
        ys[5 + s] += 5.0                         # one gross outlier each
        grids.append((x, ys))
    return {"x": x, "y_out": y_out, "y2": y2, "x_obs": x_obs, "y3": y3, "grids": grids}


def fit(x, y, likelihood=None, data_error=0.1, params=None, prior=None, device=None,
        dtype=None, n_steps=STEPS["fit"]):
    w = mfit.walker_create(
        function=line, data=(x, y),
        params=params or {"m": 1.5, "b": 0.5},
        data_error=data_error, log_likelihood=likelihood,
        log_prior=prior, n_walkers=32, seed=0, walker_jitter=0.05,
        dtype=dtype, device=device)
    w.adaptive_steps(n_steps, auto=None)
    w.burn_steps(len(w) // 2)
    return w


def outliers(d, device, steps=STEPS, dtype=None):
    """Step 1: Gaussian vs Student-t on a line with 10 % outliers."""
    with phase("1. outliers"):
        x, y_out = d["x"], d["y_out"]
        w_g = fit(x, y_out, device=device, dtype=dtype, n_steps=steps["fit"])
        w_t = fit(x, y_out, mfit.make_student_t_likelihood(nu=4.0), device=device,
                  dtype=dtype, n_steps=steps["fit"])
        print(f"outliers:   gaussian m={w_g.most_likely_params()['m']:.3f}  "
              f"student-t m={w_t.most_likely_params()['m']:.3f}  (truth 2.0)")
        r_t, r_g = diagnostics.loo(w_t), diagnostics.loo(w_g)
        print(f"            PSIS-LOO prefers t by "
              f"{diagnostics.loo_compare(r_t, r_g)['elpd_diff']:.1f} elpd "
              f"({r_g.n_bad_k} Pareto-k flags on the gaussian fit)")
    return w_g, w_t


def unknown_noise(d, device, steps=STEPS, dtype=None):
    """Step 2: the noise scale fitted; returns ``(w_k, pit_fixed,
    pit_fitted)``."""
    with phase("2. unknown noise"):
        x, y2 = d["x"], d["y2"]
        w_k = fit(x, y2, mfit.make_noise_scale_likelihood(), data_error=1.0,
                  params={"m": 1.5, "b": 0.5, "noise_scale": 1.0},
                  prior=mfit.make_bounds_prior({"noise_scale": (1e-3, 1e3)}),
                  device=device, dtype=dtype, n_steps=steps["fit"])
        (dd,) = w_k.posterior_predictive(max_samples=256)
        print(f"unknown sigma: fitted noise_scale="
              f"{w_k.most_likely_params()['noise_scale']:.3f} (truth 0.30), "
              f"predictive coverage@90%={dd.coverage():.1%}")
        # LOO-PIT tells the same story out-of-sample: trusting the claimed
        # sigma=1 is UNDER-confident (PIT humps at 0.5); the fitted noise
        # scale restores calibration.
        pit_fixed = diagnostics.loo_pit(fit(x, y2, data_error=1.0, device=device,
                                            dtype=dtype, n_steps=steps["fit"]))
        pit_fitted = diagnostics.loo_pit(w_k)
        print(f"            LOO-PIT: claimed sigma ok={pit_fixed.ok} "
              f"(p={pit_fixed.p_value:.2g}) -> fitted ok={pit_fitted.ok} "
              f"(p={pit_fitted.p_value:.2g})")
    return w_k, pit_fixed, pit_fitted


def noisy_x(d, device, steps=STEPS, dtype=None):
    """Step 3: regression dilution corrected by the York likelihood."""
    with phase("3. noisy x"):
        x, x_obs, y3 = d["x"], d["x_obs"], d["y3"]
        w_naive = fit(x_obs, y3, data_error=0.2, device=device, dtype=dtype,
                      n_steps=steps["fit"])
        w_xe = fit(x_obs, y3, mfit.make_x_error_likelihood(0.8), data_error=0.2,
                   device=device, dtype=dtype, n_steps=steps["fit"])
        dil = 1.0 / (1.0 + 0.8**2 / np.var(x))
        print(f"noisy x:    naive m={w_naive.most_likely_params()['m']:.3f} "
              f"(analytic dilution predicts {TRUE_M * dil:.3f}), "
              f"york m={w_xe.most_likely_params()['m']:.3f}  (truth 2.0)")
    return w_naive, w_xe


def scan_grid(d, device, steps=STEPS, dtype=None):
    """Step 4: S spectra as one BatchedFit under t(4); returns the batch
    and the worst slope error."""
    # 4. Robust fits at scan-grid scale: S spectra, each with its own
    #    gross outlier, fit as ONE BatchedFit under the t likelihood
    #    (BatchedFit is likelihood-agnostic), then the pipeline
    #    itself is audited by SBC under the SAME likelihood — the
    #    simulator derives from the factory's generative twin.
    with phase("4. scan grid"):
        batch = mfit.BatchedFit(
            line, d["grids"], {"m": 1.5, "b": 0.5}, data_error=0.1,
            log_likelihood=mfit.make_student_t_likelihood(4.0),
            walkers_per_dataset=64, seed=0, dtype=dtype, device=device)
        batch.adaptive_steps(steps["batch"], auto=None)
        slopes = [batch.best_params_per_dataset()[s]["m"] for s in range(S)]
        worst = max(abs(m - (1.5 + 0.2 * s)) for s, m in enumerate(slopes))
        print(f"scan grid:  {S} spectra, one outlier each, worst slope "
              f"error {worst:.3f} under t(4) (gaussian would be dragged)")
    return batch, worst


def audit(d, device, steps=STEPS, dtype=None):
    """The SBC audit of the robust pipeline; returns the SBC result."""
    with phase("4. SBC audit"):
        sbc = mfit.sbc_check(
            line, {"m": (0.5, 3.0), "b": (-1.0, 2.0)}, d["x"][:40], 0.5,
            n_sims=steps["sbc_sims"], walkers_per_dataset=32, n_steps=steps["sbc"],
            seed=0, log_likelihood=mfit.make_student_t_likelihood(4.0),
            dtype=dtype, device=device)
        print(f"SBC audit:  robust pipeline calibrated ok={sbc.ok()} "
              f"(worst p={min(sbc.p_values.values()):.2g})")
    return sbc


def main(device=None, steps=None, dtype=None):
    """The whole tour; ``steps`` overrides :data:`STEPS`."""
    device = setup_device() if device is None else device
    steps = {**STEPS, **(steps or {})}
    d = make_data()
    outliers(d, device, steps, dtype)
    _, pit_fixed, pit_fitted = unknown_noise(d, device, steps, dtype)
    assert pit_fitted.ok and not pit_fixed.ok
    noisy_x(d, device, steps, dtype)
    _, worst = scan_grid(d, device, steps, dtype)
    assert worst < 0.1
    sbc = audit(d, device, steps, dtype)
    assert sbc.ok()
    return {"pit": (pit_fixed, pit_fitted), "worst": worst, "sbc": sbc}


if __name__ == "__main__":
    main()
