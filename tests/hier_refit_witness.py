"""chip_smoke.py's hier_refit phase in both packages on the CPU, at reduced W.

    JAX_PLATFORMS=cpu OMP_NUM_THREADS=4 python3 tests/hier_refit_witness.py [port|jax|sbc] [W]

``port``: the port's ``chip_smoke.hier_refit_fit("cpu", W)`` and
``chip_smoke.hier_refit_cv`` (kfold, loo, reloo, logo at the phase's
settings); ``jax``: the JAX package's ``nv.HierarchicalNVFit`` on the same
grid (``synthetic.nv_scan_grid(4, 4)``), float32, through the same
schedule and the same verbs; ``sbc``: the port's hierarchical SBC study and
its Cauchy control (``chip_smoke.hier_sbc_study``) in float32 on the CPU.
Each prints one JSON line: the per-pixel mu1 and field-offset errors, the
pooled sigma's mean, each verb's elpd, gate verdicts and seconds (the fit at
W, default 512; the refits at the phase's walkers per dataset).  The phase's
gates were set from these lines and the truth; a CPU run gives no device
number.  Not collected by pytest: a package takes ~30-60 minutes.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def port(W):
    fit, _, s = cs.hier_refit_fit("cpu", W)
    return {**s, **cs.hier_refit_cv(fit)}


def jax_run(W):
    import numpy as np
    from lisp_mcmc_tpu import diagnostics, nv
    from lisp_mcmc_torch import synthetic

    x, ys, truths = synthetic.nv_scan_grid(*cs.HIER_GRID, seed=0)
    fit = nv.HierarchicalNVFit([(x, y) for y in ys], n_walkers=W, seed=0)
    t0 = time.perf_counter()
    fit.adaptive_steps(cs.HIER_ANNEAL, auto=None)
    anneal_acc = fit.acceptance()
    fit.reset()
    fit.sampling_steps(cs.HIER_COLD, kernel=cs.HIER_COLD_KERNEL)
    fit.reset_to_most_likely()
    fit.sampling_steps(cs.HIER_SAMPLE, kernel=cs.HIER_COLD_KERNEL)
    out = {"W": W, "d": fit.spec.ndim, "fit_seconds": time.perf_counter() - t0,
           "acceptance_anneal": anneal_acc, "acceptance_cold": fit.acceptance(),
           **cs.hier_fit_errors(fit, truths)}
    cv = dict(n_steps=cs.HIER_CV_STEPS, walkers_per_dataset=cs.HIER_CV_WALKERS,
              max_samples=cs.HIER_MAX_SAMPLES, seed=0)
    secs = {}
    t0 = time.perf_counter()
    kf = diagnostics.kfold(fit, k=cs.HIER_KFOLD, **cv)
    secs["kfold"] = time.perf_counter() - t0
    lo = diagnostics.loo(fit, max_samples=cs.HIER_LOO_SAMPLES)
    k = np.sort(lo.pareto_k)
    thr = min(0.7, float(k[-cs.HIER_RELOO_RANK]) - 1e-6)
    t0 = time.perf_counter()
    rl = diagnostics.reloo(fit, lo, k_threshold=thr, max_refits=cs.HIER_RELOO_MAX, **cv)
    secs["reloo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lg = fit.logo(n_z=cs.HIER_LOGO_Z, **cv)
    secs["logo"] = time.perf_counter() - t0
    out.update({
        "seconds": secs,
        "kfold": {"elpd": kf.elpd, "se": kf.se, "fold_ok": np.asarray(kf.fold_ok).tolist()},
        "loo": {"elpd": lo.elpd, "threshold": thr, "flagged": int((lo.pareto_k > thr).sum())},
        "reloo": {"elpd": rl.elpd, "refit_failed": list(rl.refit_failed)},
        "logo": {"elpd": lg.elpd, "se": lg.se,
                 "elpd_per_dataset": np.asarray(lg.elpd_per_dataset).tolist(),
                 "refit_ok": np.asarray(lg.refit_ok).tolist()},
        "kfold_minus_reloo": kf.elpd - rl.elpd})
    return out


def sbc():
    return {name: cs.hier_sbc_summary("cpu", name) for name in ("calibrated", "cauchy")}


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "port"
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    t0 = time.perf_counter()
    out = {"port": port, "jax": jax_run}[which](W) if which != "sbc" else sbc()
    print(json.dumps({"package": "lisp_mcmc_tpu" if which == "jax" else "lisp_mcmc_torch",
                      "run": which, **out, "total_seconds": time.perf_counter() - t0}),
          flush=True)


if __name__ == "__main__":
    main()
