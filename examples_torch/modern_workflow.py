"""The capabilities the Lisp reference never had, as one workflow, on PyTorch.

The counterpart of ``examples/modern_workflow.py``.  A complete Bayesian
analysis on a synthetic two-peak spectrum:

0. prior check     — prior predictive replicates vs the data's scale
1. global search   — parallel tempering (`tempered_steps`)
2. MAP polish      — multi-start gradient ascent (`optimize`)
3. posterior draws — gradient MALA at T=1 (`sampling_steps`)
4. uncertainty     — rank-R-hat/tail-ESS/MCSE convergence verdict,
                     derived-quantity intervals, posterior predictive
                     coverage (`convergence`, `posterior_predictive`)
5. model choice    — evidence + Bayes factor between one- and two-peak
                     models, triangulated across all SIX estimators
                     (`log_evidence`, `smc_sample`, `laplace_approx`,
                     `nested_sample`, `advi`, `flow_advi`), plus the prior-free
                     predictive view (`diagnostics.waic`)
6. pipeline audit  — simulation-based calibration of the whole fit
                     pipeline, all simulated datasets as one batched
                     ensemble (`sbc_check`)

Each step is a function of its own; :data:`STEPS` holds the step counts
(the JAX example's), which a caller may cut.

Run: ``python examples_torch/modern_workflow.py``
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
from lisp_mcmc_torch.priors import make_bounds_prior  # noqa: E402

STEPS = {"prior_predictive": 200, "tempered": 8000, "optimize": 400, "cold": 4000,
         "mala": 6000, "evidence": 12000, "smc_move": 600, "n_live": 1024,
         "advi": 1200, "flow": 2000, "waic_cold": 4000, "waic_burn": 2000,
         "sbc": 12000, "sbc_mala": 6000, "sbc_sims": 24}


def make_spectrum(seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(2800.0, 2940.0, 256)
    truth = {"scale1": 9e-5, "scale2": 7e-5, "mu1": 2858.0, "mu2": 2876.0,
             "sigma": 9.0, "bg0": 1e-4}
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in truth.items()}
    y = double_lorentzian_bg(torch.tensor(x), p).numpy()
    return x, y + 2e-6 * rng.standard_normal(x.shape), truth


BOUNDS2 = {"scale1": (0.0, 1e-3), "scale2": (0.0, 1e-3),
           "mu1": (2800.0, 2940.0), "mu2": (2800.0, 2940.0),
           "sigma": (1.0, 40.0), "bg0": (0.0, 1e-3)}
BOUNDS1 = {"scale": (0.0, 1e-3), "x0": (2800.0, 2940.0),
           "linewidth": (1.0, 40.0), "bg0": (0.0, 1e-3), "bg1": (-1e-6, 1e-6)}
START2 = {"scale1": 5e-5, "scale2": 5e-5, "mu1": 2850.0, "mu2": 2885.0,
          "sigma": 12.0, "bg0": 8e-5}
START1 = {"scale": 1.5e-4, "x0": 2866.0, "linewidth": 15.0, "bg0": 8e-5, "bg1": 1e-9}


def two_peak_walker(x, y, params, seed, device, dtype=None):
    return mfit.walker_create(
        function=double_lorentzian_bg, data=(x, y),
        params=dict(params), data_error=2e-6, log_prior=make_bounds_prior(BOUNDS2),
        n_walkers=256, seed=seed, walker_jitter=0.05, dtype=dtype, device=device)


def one_peak_walker(x, y, seed, device, dtype=None):
    return mfit.walker_create(
        function=lorentzian_bg, data=(x, y),
        params=START1, data_error=2e-6, log_prior=make_bounds_prior(BOUNDS1),
        n_walkers=256, seed=seed, walker_jitter=0.05, dtype=dtype, device=device)


def search_and_sample(w, y, steps=STEPS):
    """Steps 0-3: prior predictive, tempered search, polish, cold mala;
    returns the best point after the polish."""
    # 0. Prior predictive check BEFORE fitting: do prior + model even
    # generate data on the observed scale?  (A prior whose replicates
    # never reach the data's magnitude is fighting the fit.)
    with phase("0. prior predictive"):
        (pp,) = w.prior_predictive(n_samples=steps["prior_predictive"])
        print(f"prior predictive: y_rep spans [{pp.y_rep.min():.2e}, "
              f"{pp.y_rep.max():.2e}], data spans [{y.min():.2e}, {y.max():.2e}]")

    # 1. Tempered global search: hot rungs cross the peak-swap barriers.
    with phase("1-2. tempered search + polish"):
        w.tempered_steps(steps["tempered"], rungs=8)
        # 2. Gradient polish of whatever basins the search found.
        w.optimize(steps["optimize"])
        lp_map, best = w.most_likely_step()
        print(f"MAP after search+polish: lp={lp_map:.2f} "
              f"mu1={best['mu1']:.2f} mu2={best['mu2']:.2f} (truth 2858/2876)")

    # 3. Posterior sampling with the gradient kernel from the cold mode.
    with phase("3. cold mala sampling"):
        w.reset_to_most_likely()
        w.adaptive_steps(steps["cold"], temperature=1.0, auto=None)
        w.sampling_steps(steps["mala"], kernel="mala")
    return best


def uncertainty(w):
    """Step 4: diagnostics, a derived quantity, the convergence verdict and
    predictive coverage; returns ``(convergence report, coverage)``."""
    with phase("4. uncertainty"):
        print(diagnostics.summary(w))
        mid, lo, hi = mfit.expression_credible_interval(w, "(- :mu2 :mu1)")
        print(f"peak splitting mu2-mu1 = {mid:.2f}  [{lo:.2f}, {hi:.2f}] @95%")

        # The one-call modern convergence verdict (Vehtari 2021): rank-
        # normalized bulk+tail R-hat < 1.01 AND tail ESS > 100 per param.
        rep = diagnostics.convergence(w)
        print(f"convergence: ok={rep['ok']}"
              + ("" if rep["ok"] else f" failures={rep['failures'][:2]}"))

        # Posterior predictive: replicates carry the observation noise, so
        # coverage says whether the noise model explains the scatter.
        (d,) = w.posterior_predictive(max_samples=128)
        print(f"posterior predictive coverage @90% band: {d.coverage():.1%}")
    return rep, d.coverage()


def model_choice(x, y, best, device, steps=STEPS, dtype=None):
    """Step 5: the evidence of both models by the six estimators; returns
    the one-peak walker, the SMC walker and the results by name."""
    # 5. Model comparison: does the data support two peaks over one?
    with phase("5. evidence ladder, two models"):
        w2 = two_peak_walker(x, y, best, 1, device, dtype)
        res2 = w2.log_evidence(n_steps=steps["evidence"], rungs=16, t_max=1e5)

        w1 = one_peak_walker(x, y, 2, device, dtype)
        res1 = w1.log_evidence(n_steps=steps["evidence"], rungs=16, t_max=1e5)

        lb, err = mfit.log_bayes_factor(res2, res1)
        print(f"log Z (two-peak) = {res2.log_z:.1f} +- {res2.error:.2f}")
        print(f"log Z (one-peak) = {res1.log_z:.1f} +- {res1.error:.2f}")
        print(f"log10 Bayes factor (two vs one) = {lb:.1f} +- {err:.2f} "
              f"({'decisive for two peaks' if lb > 2 else 'inconclusive'})")

    # Cross-check the two-peak evidence with tempered SMC — entirely
    # different machinery (adaptive schedule + resampling vs replica
    # exchange + stepping-stone).  On stiff fits like this one SMC is
    # the more accurate of the two (it matches the Laplace anchor to
    # ~1.5 log-units; the fit-seeded ladder reads a few units high —
    # see evidence.py's docstring for the measured tradeoff).
    with phase("5. SMC, Laplace, nested"):
        w_smc = two_peak_walker(x, y, best, 3, device, dtype)
        res_smc = w_smc.smc_sample(BOUNDS2, n_move=steps["smc_move"])
        print(f"log Z (two-peak, SMC) = {res_smc.log_z:.1f} "
              f"in {res_smc.n_stages} adaptive stages "
              f"(ladder-vs-SMC gap: {abs(res_smc.log_z - res2.log_z):.2f})")

        # Third estimator, instant: one Hessian at the MAP.  On this smooth
        # unimodal-per-mode posterior all three should sit within a few
        # log-units of each other (times 2 for the two symmetric peak
        # labelings, ~0.7 log-units, inside the tolerance here).
        lap = w_smc.laplace_approx()
        print(f"log Z (two-peak, Laplace) = {lap.log_z:.1f} "
              f"(n_clamped={lap.n_clamped}, "
              f"Laplace-vs-SMC gap: {abs(lap.log_z - res_smc.log_z):.2f})")

        # Fourth estimator: batched nested sampling — needs no converged
        # ensemble at all (its own live set starts from the prior box) and
        # returns posterior draws alongside the evidence.
        ns = w_smc.nested_sample(n_live=steps["n_live"], seed=0)
        print(f"log Z (two-peak, nested) = {ns.log_z:.1f} +- {ns.log_z_err:.2f} "
              f"({ns.n_iter} rounds, posterior ESS {ns.ess:.0f}, "
              f"nested-vs-SMC gap: {abs(ns.log_z - res_smc.log_z):.2f})")

    # Fifth estimator: ADVI importance sampling — a Gaussian q + a
    # Pareto-k-guarded log_z.  vi.converged_evidence says whether the
    # weight tail is healthy enough to trust the number; on a posterior
    # the Gaussian family cannot cover, the guard refuses instead of
    # misreporting — that refusal is the feature.
    with phase("5. ADVI and flow VI"):
        vi = w_smc.advi(n_steps=steps["advi"], seed=3)
        trust = "trusted" if vi.converged_evidence else "REFUSED (k >= 0.7)"
        print(f"log Z (two-peak, ADVI-IS) = {vi.log_z:.1f} "
              f"(elbo {vi.elbo:.1f}, pareto_k {vi.pareto_k:.2f}: {trust}; "
              f"advi-vs-SMC gap: {abs(vi.log_z - res_smc.log_z):.2f})")

        # Sixth: the RealNVP flow's importance sampling — the escalation
        # rung for when the Gaussian family's k refuses (here the target is
        # near-Gaussian, so the identity-initialized flow agrees cheaply;
        # examples_torch/hard_geometry.py shows the curved case it exists for).
        fv = w_smc.flow_advi(n_steps=steps["flow"], n_samples=64, seed=3)
        ftrust = "trusted" if fv.converged_evidence else "REFUSED (k >= 0.7)"
        print(f"log Z (two-peak, flow-IS) = {fv.log_z:.1f} "
              f"(pareto_k {fv.pareto_k:.2f}: {ftrust}; "
              f"flow-vs-SMC gap: {abs(fv.log_z - res_smc.log_z):.2f})")
    return w1, w_smc, {"ladder2": res2, "ladder1": res1, "smc": res_smc, "laplace": lap,
                       "nested": ns, "advi": vi, "flow": fv}


def predictive_view(w1, w_smc, steps=STEPS):
    """WAIC, stacking weights and LOO-PIT of both models after cold
    sampling; returns ``(pit2, pit1)``."""
    # The predictive (prior-free) view of the same comparison: WAIC off
    # posterior histories alone.  The one-peak model also LOSES
    # predictively here, not just on evidence — both lenses agree.
    # Both ensembles just ran tempered machinery, which leaves straggler
    # walkers stranded at hot-phase positions; collapse them before the
    # cold sampling pass or they dominate p_waic (see diagnostics.waic).
    with phase("5. predictive view (WAIC, LOO-PIT)"):
        w1.reset_to_most_likely()
        w1.adaptive_steps(steps["waic_cold"], temperature=1.0, auto=None)
        w1.burn_steps(steps["waic_burn"])
        w_smc.reset_to_most_likely()
        w_smc.adaptive_steps(steps["waic_cold"], temperature=1.0, auto=None)
        w_smc.burn_steps(steps["waic_burn"])
        r2, r1 = diagnostics.waic(w_smc), diagnostics.waic(w1)
        cmp = diagnostics.waic_compare(r2, r1)
        print(f"WAIC elpd: two-peak {r2.elpd:.1f} (p={r2.p_waic:.1f})  "
              f"one-peak {r1.elpd:.1f} (p={r1.p_waic:.1f})  "
              f"diff {cmp['elpd_diff']:.1f} +- {cmp['se_diff']:.1f}")
        wts = diagnostics.model_weights([r2, r1])
        print(f"stacking weights: two-peak {wts[0]:.3f}, one-peak {wts[1]:.3f}")

        # LOO-PIT closes the loop out-of-sample: the RIGHT model's points
        # are plausible draws from their own leave-one-out predictives
        # (uniform PIT); the one-peak model's are not.
        pit2, pit1 = diagnostics.loo_pit(w_smc), diagnostics.loo_pit(w1)
        print(f"LOO-PIT: two-peak ok={pit2.ok} (p={pit2.p_value:.3g})  "
              f"one-peak ok={pit1.ok} (p={pit1.p_value:.3g})")
    return pit2, pit1


def pipeline_audit(x, device, steps=STEPS, dtype=None):
    """Step 6: SBC of the one-peak pipeline; returns the SBC result."""
    # 6. Audit the pipeline itself: simulate datasets from the one-peak
    # prior, fit ALL of them as one batched ensemble, and test that the
    # truth's rank among posterior draws is uniform.  Non-uniform ranks
    # would mean the machinery above (kernel, anneal, noise model) is
    # producing miscalibrated posteriors — for every model it touches.
    # SBC catches real defects, measured on this very model in the JAX
    # package: (a) at n_steps=3000/T=2 it fails (some sims never find
    # their narrow mode) until the canonical hot-anneal recipe is used;
    # (b) at data_error=2e-6 it fails in float32 while passing in
    # float64 — the float32 posterior widths are wrong at that SNR; (c)
    # rwm-only audits of THIS wide box are seed-lottery: large-linewidth
    # truths make scale-bg0 a ridge the random walk never traverses, so
    # the production recipe ranks from a cold mala phase (see
    # sbc_check's docstring).
    with phase("6. SBC pipeline audit"):
        sbc = mfit.sbc_check(
            lorentzian_bg, BOUNDS1, x, 5e-6,
            n_sims=steps["sbc_sims"], walkers_per_dataset=32, n_steps=steps["sbc"],
            temperature=10.0, burn_fraction=0.33, seed=4,
            sampling_steps=steps["sbc_mala"], sampling_kernel="mala",
            dtype=dtype, device=device)
        print(f"SBC pipeline audit: ok={sbc.ok()} "
              f"(worst p={min(sbc.p_values.values()):.3g} over "
              f"{len(sbc.keys)} params, {sbc.n_sims} simulated fits "
              f"in one batched run)")
    return sbc


def main(device=None, steps=None, dtype=None):
    """The whole workflow; ``steps`` overrides :data:`STEPS`.  Returns the
    results by step."""
    device = setup_device() if device is None else device
    steps = {**STEPS, **(steps or {})}
    x, y, truth = make_spectrum()

    w = two_peak_walker(x, y, START2, 0, device, dtype)
    best = search_and_sample(w, y, steps)
    conv, coverage = uncertainty(w)
    w1, w_smc, evidence = model_choice(x, y, best, device, steps, dtype)
    pit2, pit1 = predictive_view(w1, w_smc, steps)
    assert pit2.ok and not pit1.ok
    sbc = pipeline_audit(x, device, steps, dtype)
    return {"walker": w, "convergence": conv, "coverage": coverage, "evidence": evidence,
            "pit": (pit2, pit1), "sbc": sbc}


if __name__ == "__main__":
    main()
