"""chip_smoke.py's pooling phase in both packages on the CPU, at W = 1024.

    JAX_PLATFORMS=cpu OMP_NUM_THREADS=8 python3 tests/pooling_witness.py

Runs the port's ``chip_smoke.pooling_compare("cpu", 1024, 128)`` and the JAX
package's ``compare_pooling`` on the same inputs (``chip_smoke.pooling_inputs()``:
the 8 spectra, test.lisp's start, the declared population), both in float32,
and prints one JSON line a package: each model's elpd and se, the weights, the
partial fit's best population means and their distance from the truth as the
phase's gates read it (``chip_smoke.pooling_mu_err``), and the seconds.  The
phase's gates were set from these lines; a CPU run gives no device number.
Not collected by pytest: it takes ~12 minutes.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def jax_compare():
    import numpy as np
    import lisp_mcmc_tpu as jm
    from lisp_mcmc_tpu.models import lorder_mixed_bg

    g, guess, hyper = cs.pooling_inputs()
    jhyper = {k: (jm.Gaussian(m.mu, m.sigma), jm.LogNormal(t.mu, t.sigma))
              for k, (m, t) in hyper.items()}
    data = [(np.asarray(x), np.asarray(y)) for x, y in g["data"]]
    t0 = time.perf_counter()
    r = jm.compare_pooling(lorder_mixed_bg, data, guess, data_error=1e-7,
                           pooled=list(cs.POOL_KEYS), hyper=jhyper, n_steps=cs.POOL_STEPS,
                           n_walkers=1024, walkers_per_dataset=128,
                           max_samples=cs.POOL_MAX_SAMPLES, seed=0)
    mu = {k: float(v) for k, v in r.fits["partial"].hyper_params("best")["mu"].items()}
    return {"elpd": r.elpd, "se": r.se, "weights": r.weights, "mu": mu,
            "mu_err": cs.pooling_mu_err(mu), "seconds": time.perf_counter() - t0}


def main():
    _, s = cs.pooling_compare("cpu", 1024, 128)
    print(json.dumps({"package": "lisp_mcmc_torch", "elpd": s["elpd"], "se": s["se"],
                      "weights": s["weights"], "mu": s["hyper_best"]["mu"],
                      "mu_err": s["mu_err"], "seconds": s["compare_seconds"]}), flush=True)
    print(json.dumps({"package": "lisp_mcmc_tpu", **jax_compare()}), flush=True)


if __name__ == "__main__":
    main()
