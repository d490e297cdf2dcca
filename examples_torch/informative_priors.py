"""Informative (named) priors end to end: fit, evidence, calibration, on PyTorch.

The counterpart of ``examples/informative_priors.py``.  The reference's
prior contract is a log-density TERM (prior-bounds-let,
mcmc-fitting.lisp:346-369; data-dependent fixers 837-845) — so a user
with a Gaussian prior from an earlier experiment could always FIT with
it, but no box-free tool existed to integrate or calibrate against it.
This workflow shows the surface that closes that gap:

1. declare   — ``PriorSpec``: Gaussian / LogNormal / Uniform per
               parameter, truncations included; ``log_prior=spec`` fits
               with its exact normalized density.
2. sanity    — ``prior_predictive`` draws parameters from the spec.
3. fit       — the usual anneal + polish; the spec rides along.
4. evidence  — all four estimators (ladder / SMC / Laplace / nested)
               return the TRUE integral ``∫ L·π`` under the declared
               prior, triangulating one number from four independent
               mechanisms (unit-cube prior transform under the hood).
5. shrinkage — prior vs posterior: what the data actually learned.
6. audit     — ``sbc_check`` calibrates the whole pipeline against the
               SAME spec it fits with.

:data:`STEPS` holds the step counts (the JAX example's), which a caller
may cut.

Run: ``python examples_torch/informative_priors.py``
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch._common import phase, setup_device  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lisp_mcmc_torch as mfit  # noqa: E402

SIGMA = 0.15
STEPS = {"prior_predictive": 256, "anneal": 6000, "optimize": 300, "sample": 4000,
         "n_live": 512, "evidence": 12000, "smc_move": 200, "draws": 4000,
         "sbc": 2500, "sbc_sims": 32}


def decay(x, p):
    return p["amp"] * torch.exp(-x / p["tau"]) + p["bg"]


def make_data():
    """``(rng, x, y)``: the decay curve and the generator the shrinkage
    step draws its prior percentiles from afterwards."""
    rng = np.random.default_rng(11)
    x = np.linspace(0.0, 8.0, 64)
    y = 2.1 * np.exp(-x / 1.8) + 0.25 + SIGMA * rng.standard_normal(64)
    return rng, x, y


def make_spec():
    # 1. The prior story: amp was measured before (2.0 +- 0.3), tau is a
    # positive timescale best expressed log-normally, bg is only known
    # to sit in a band.
    return mfit.PriorSpec({
        "amp": mfit.Gaussian(2.0, 0.3, low=0.0),          # truncated at 0
        "tau": mfit.LogNormal(np.log(2.0), 0.5),          # positive scale
        "bg": mfit.Uniform(0.0, 1.0),
    })


def make_walker(x, y, spec, device, dtype=None, n_walkers=512):
    return mfit.walker_create(
        function=decay, data=(x, y),
        params={"amp": 1.5, "tau": 1.0, "bg": 0.3},
        data_error=SIGMA, n_walkers=n_walkers, seed=0, walker_jitter=0.2,
        log_prior=spec, dtype=dtype, device=device)


def fit(w, y, steps=STEPS):
    """Steps 2-3: prior predictive, then anneal, polish, cold samples."""
    # 2. Before fitting: do prior + model even generate data on the
    # observed scale?
    with phase("2. prior predictive"):
        pp = w.prior_predictive(n_samples=steps["prior_predictive"])[0]
        print(f"prior predictive: replicate scale {pp.y_rep.std():.2f} "
              f"vs data scale {y.std():.2f}")

    # 3. Fit: anneal, polish, cold samples.
    with phase("3. fit"):
        w.adaptive_steps(steps["anneal"], temperature=3.0, auto=None)
        w.optimize(steps["optimize"])
        w.reset_to_most_likely()
        w.sampling_steps(steps["sample"])
        best = w.most_likely_params()
        print("MAP:", {k: round(v, 4) for k, v in best.items()})
        conv = w.convergence(min_tail_ess=50.0)
        print("convergence ok:", conv["ok"])
    return conv


def evidence(w, spec, steps=STEPS):
    """Step 4: the evidence under the declared prior, four ways; returns
    ``(laplace, nested, ladder, smc)``."""
    # 4. Evidence under the DECLARED prior, four independent ways.
    with phase("4. evidence, four estimators"):
        la = w.laplace_approx()                       # spec recovered from fit
        ns = w.nested_sample(n_live=steps["n_live"], stop_frac=1e-5, seed=3)
        ev = w.log_evidence(n_steps=steps["evidence"], rungs=16, t_max=1e4, prior=spec)
        sm = w.smc_sample(prior=spec, n_move=steps["smc_move"])  # re-seeds from the prior
        print(f"log Z: laplace {la.log_z:.2f} | nested {ns.log_z:.2f} "
              f"+- {ns.log_z_err:.2f} | ladder {ev.log_z:.2f} +- {ev.error:.2f} "
              f"| smc {sm.log_z:.2f}")
    return la, ns, ev, sm


def shrinkage(w, spec, ns, rng, steps=STEPS):
    """Steps 5-6: prior vs posterior percentiles, then the power-scaling
    sensitivity; returns the sensitivity result."""
    # 5. Shrinkage: what did the data teach us beyond the prior?
    with phase("5-6. shrinkage + prior sensitivity"):
        draws = ns.posterior_draws(steps["draws"], seed=0)
        for i, k in enumerate(["amp", "tau", "bg"]):
            lo_p, hi_p = (np.percentile(spec.sample(rng, steps["draws"], [k]), [16, 84]))
            lo, hi = np.percentile(draws[:, i], [16, 84])
            print(f"  {k}: prior 68% [{lo_p:.2f}, {hi_p:.2f}] -> "
                  f"posterior 68% [{lo:.2f}, {hi:.2f}]")

        # 6. Was the declared prior load-bearing — and does it fight the
        # data?  Power-scaling sensitivity from the history already
        # collected, no refits (Kallioinen et al. 2023).
        sens = w.prior_sensitivity()
        print("prior sensitivity:", sens)
    return sens


def audit(x, spec, device, steps=STEPS, dtype=None):
    """Step 7: SBC with the same spec; returns the SBC result."""
    # 7. Pipeline audit with the SAME spec (prior/simulator agreement is
    # the contract SBC checks *given*).
    with phase("7. SBC"):
        res = mfit.sbc_check(decay, spec, x, SIGMA, n_sims=steps["sbc_sims"],
                             walkers_per_dataset=32, n_steps=steps["sbc"], seed=5,
                             dtype=dtype, device=device)
        print("SBC:", res)
    return res


def main(device=None, steps=None, dtype=None):
    """The whole workflow; ``steps`` overrides :data:`STEPS`."""
    device = setup_device() if device is None else device
    steps = {**STEPS, **(steps or {})}
    rng, x, y = make_data()
    spec = make_spec()
    print("prior spec:", spec)

    w = make_walker(x, y, spec, device, dtype)
    conv = fit(w, y, steps)
    la, ns, ev, sm = evidence(w, spec, steps)
    zs = [la.log_z, ns.log_z, ev.log_z, sm.log_z]
    assert max(zs) - min(zs) < 2.0, "estimators disagree — investigate"
    sens = shrinkage(w, spec, ns, rng, steps)
    assert sens.ok, sens.diagnosis   # this prior agrees with this data
    res = audit(x, spec, device, steps, dtype)
    assert res.ok(), res.p_values
    print("informative-prior workflow complete")
    return {"walker": w, "convergence": conv, "log_z": zs, "sensitivity": sens, "sbc": res}


if __name__ == "__main__":
    main()
