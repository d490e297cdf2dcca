"""Curved posteriors: the hard-geometry toolchain in one arc, on PyTorch.

The counterpart of ``examples/hard_geometry.py``.  Some posteriors are
hard not because they are high-dimensional or expensive but because they
are BENT — a curved ridge (here the classic banana: one parameter's
location depends quadratically on another) defeats every Gaussian
summary at once: the adapted proposal L, the Laplace/ADVI evidence, and
any ellipse-shaped credible region.

The arc, using only public verbs:

1. fit + audit      — the random walk samples it fine, but the GAUSSIAN
                      evidence reads biased: `advi` reports a low ELBO
                      with Pareto-k near/over 0.7 (the "my family is
                      too small" flag).
2. flow upgrade     — `flow_advi` bends a RealNVP to the curvature:
                      ELBO rises by the KL the Gaussian was losing,
                      Pareto-k drops, and its IS evidence now agrees
                      with the ladder estimator (the banana here has a
                      CLOSED-FORM evidence to check against).
3. self-tuning HMC  — `sampling_steps(kernel="chees")`: ChEES-HMC finds
                      the trajectory length on its own;
                      `chees_trajectory()` shows what it chose.
4. NeuTra sampling  — `flow.neutra_sample` runs the kernel in the
                      flow's LATENT space, where the banana looks like
                      N(0,I): near-iid mixing, exact samples, no
                      importance weights.
5. chain the result — `flow.seed_walker` restarts the ensemble from the
                      flow for instant posterior-shaped starts.

The whole arc runs in float64, as the JAX example does (it switches x64
on).  :data:`STEPS` holds the step counts, which a caller may cut.

Run: ``python examples_torch/hard_geometry.py``
"""

import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch._common import phase, setup_device  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lisp_mcmc_torch as mfit  # noqa: E402

# ----------------------------------------------------------------------
# The target: t1 ~ N(0,1), t2 | t1 ~ N(t1^2, 0.25^2) under a uniform box
# prior.  A volume-preserving shear of a Gaussian, so the exact evidence
# is known: log Z = log(2 pi sigma1 sigma2) - log V_box.
# ----------------------------------------------------------------------
BOUNDS = {"t1": (-6.0, 6.0), "t2": (-2.0, 10.0)}
TRUTH = math.log(2 * math.pi * 1.0 * 0.25) - math.log(12.0 * 12.0)
STEPS = {"anneal": 6000, "advi": 1500, "flow": 12000, "evidence": 6000,
         "respread": 2000, "chees": 4000, "neutra": 2000}


def model(x, p):
    return torch.zeros_like(x)


def loglik(fn, params, dataset):
    t1, t2 = params["t1"].reshape(-1), params["t2"].reshape(-1)
    return -0.5 * t1 ** 2 - 0.5 * ((t2 - t1 ** 2) / 0.25) ** 2


def make_walker(device, dtype=torch.float64):
    return mfit.walker_create(
        function=model, data=([0.0, 1.0], [0.0, 0.0]),
        params={"t1": 0.5, "t2": 0.5}, log_likelihood=loglik,
        n_walkers=512, seed=0, walker_jitter=0.5,
        log_prior=mfit.make_bounds_prior(BOUNDS), dtype=dtype, device=device)


def fit_and_flow(w, steps=STEPS):
    """Steps 1-2: anneal, Gaussian ADVI, the flow, the ladder cross-check;
    returns ``(g, fv, ev)``."""
    # -- 1. fit; the Gaussian family flags itself -----------------------
    with phase("1. fit + Gaussian ADVI"):
        w.adaptive_steps(steps["anneal"], temperature=2.0, auto=None)
        g = w.advi(n_steps=steps["advi"], seed=1)
        print(f"[1] Gaussian ADVI : elbo={g.elbo:+.3f}  log_z={g.log_z:+.3f} "
              f"(truth {TRUTH:+.3f})  pareto_k={g.pareto_k:.2f}")
        print(f"    -> biased {g.log_z - TRUTH:+.3f} nats: the ELBO gap IS "
              "the KL to the best Gaussian; k near 0.7 says 'family too small'")

    # -- 2. bend a flow to the curvature --------------------------------
    with phase("2. flow ADVI + ladder evidence"):
        fv = w.flow_advi(n_steps=steps["flow"], seed=1)
        print(f"[2] flow ADVI     : elbo={fv.elbo:+.3f}  log_z={fv.log_z:+.3f} "
              f"(truth {TRUTH:+.3f})  pareto_k={fv.pareto_k:.2f}  "
              f"trust={fv.converged_evidence}")
        s = fv.sample(4000, seed=2)
        curv = np.polyfit(s[:, 0], s[:, 1], 2)[0]
        print(f"    -> learned quadratic ridge coefficient {curv:.2f} (true 1.0)")

        # cross-check against the tempering-ladder estimator
        ev = w.log_evidence(n_steps=steps["evidence"], rungs=8, t_max=30.0)
        print(f"    ladder evidence {ev.log_z:+.3f} +- {ev.error:.3f} "
              f"(tail={ev.tail:+.2f}: the prior-MC closure measured the "
              "evidence mass below the hottest rung instead of assuming it)")
    return g, fv, ev


def chees(w, steps=STEPS):
    """Step 3: ChEES-HMC from the re-spread ensemble; returns the
    trajectory report."""
    # -- 3. ChEES-HMC: trajectory length found, not guessed -------------
    with phase("3. ChEES-HMC"):
        w.reset_to_most_likely()
        w.adaptive_steps(steps["respread"], temperature=1.0, auto=None)   # re-spread
        w.sampling_steps(steps["chees"], kernel="chees")
        tr = w.chees_trajectory()
        print(f"[3] ChEES-HMC     : acceptance={w.acceptance():.2f}  adapted "
              f"trajectory={tr['leapfrog'][0]:.1f} leapfrog steps "
              f"(budget {tr['budget']}, at_cap={tr['at_cap']})")
        if tr["at_cap"]:
            print("    at_cap=True is the tuning signal: the bent ridge wants "
                  "longer trajectories — raise chees_max_leapfrog to buy them")
        pos, _ = w.steps(take=2000)
        curv_mcmc = np.polyfit(pos[:, 0], pos[:, 1], 2)[0]
        print(f"    MCMC ridge coefficient {curv_mcmc:.2f} — kernel follows "
              "the bend the flow learned to describe")
    return tr


def neutra_and_chain(w, fv, steps=STEPS):
    """Steps 4-5: NeuTra in the flow's latent space, then the flow as the
    next start and a checkpoint round trip; returns ``(res, same)``."""
    # -- 4. NeuTra: sample in the flow's latent space -------------------
    # The flow is more than a density: it is a TRANSPORT.  Running the
    # kernel on eps with target log p(T(eps)) + log|det dT| makes the
    # banana look like N(0, I) — near-iid mixing, every mapped point an
    # exact posterior sample, no importance weights.
    with phase("4. NeuTra"):
        res = fv.neutra_sample(w, n_steps=steps["neutra"], kernel="mala", n_walkers=128)
        T, W, _ = res.samples_by_step.shape
        print(f"[4] NeuTra         : acceptance={res.acceptance:.2f}  min-ESS "
              f"{res.min_ess():.0f} of {T * min(W, 64)} chain samples "
              f"({100 * res.min_ess() / (T * min(W, 64)):.0f}% of iid) — "
              f"ridge coefficient "
              f"{np.polyfit(res.samples[:, 0], res.samples[:, 1], 2)[0]:.2f}")

    # -- 5. chain: the flow is an artifact, not a one-off ---------------
    with phase("5. seed + checkpoint"):
        fv.seed_walker(w, seed=3)
        print(f"[5] seeded ensemble logprob mean "
              f"{float(w.state.logprob.mean()):.2f} — the flow "
              "IS the warm start for the next experiment")
        with tempfile.TemporaryDirectory() as work:
            path = os.path.join(work, "flow.npz")
            fv.save(path)
            fv2 = mfit.load_flow(path, w)
        same = np.array_equal(fv.sample(64, seed=4), fv2.sample(64, seed=4))
        print(f"    checkpointed transport reloads bitwise: {same} — train "
              "once per model, reuse across sessions")
    return res, same


def main(device=None, steps=None, dtype=torch.float64):
    """The whole arc; ``steps`` overrides :data:`STEPS`."""
    device = setup_device() if device is None else device
    steps = {**STEPS, **(steps or {})}
    w = make_walker(device, dtype)
    g, fv, ev = fit_and_flow(w, steps)
    tr = chees(w, steps)
    res, same = neutra_and_chain(w, fv, steps)
    return {"advi": g, "flow": fv, "evidence": ev, "chees": tr, "neutra": res,
            "reload_same": same}


if __name__ == "__main__":
    main()
