"""Run the five BASELINE.json configurations end to end, on PyTorch.

The counterpart of ``examples/baseline_configs.py``.  Each config is a
named fit scenario from BASELINE.json; on the CPU this script runs a
scaled-down version of each, on the GPU the accelerator widths (W =
16384, 32768 walkers a spectrum), and prints a JSON summary line per
config.  Each config is a function of its own (``config_1`` ..
``config_5``) returning its walker or fit; :func:`make_data` draws all
five configs' data from one seeded numpy stream, in the order the
script uses it.

Run: ``python examples_torch/baseline_configs.py``
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch._common import phase, setup_device  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lisp_mcmc_torch as mfit  # noqa: E402
from lisp_mcmc_torch import models, nv  # noqa: E402
from lisp_mcmc_torch.models import double_lorentzian_bg, gaussian_peak, line, lorder_mixed_bg  # noqa: E402,E501

# Walker counts: the accelerator's, else the CPU's (JAX: TPU or not).
WIDTHS = {"cuda": {"W": 16384, "wps": 32768}, "cpu": {"W": 256, "wps": 64}}
STEPS = {1: 30000, 2: 10000, 3: 10000, 4: 10000, 5: 8000}
# Config 1's synthetic spectrum, used when no data file is found.
SPECTRUM_1 = {"scale": 2.3e-6, "linewidth": 16.5, "x0": 2789.0, "mix": 3.1,
              "bg0": 2.3e-7, "bg1": -1e-10}
SHARED_M = 1.8
# The tolerances ``params_ok`` holds each config's best point to.
EXPECT = {2: {"x0": (0.7, 0.1), "sigma": (1.3, 0.15)},
          3: {"m": (2.5, 0.4), "b": (4.0, 1.2)},
          4: {"m": (SHARED_M, 0.1)}}
NV_FREQS = np.linspace(2840, 2900, 256)
# Config 1's data file, read when it exists (the reference's example data).
DATA_FILE = os.path.join(os.path.dirname(__file__), "..", "data", "example-data.xls")

# 4. the global fit's two lines share the slope; each has its own offset
line_a = models.renamed(line, {"b": "ba"}, name="line_a")
line_b = models.renamed(line, {"b": "bb"}, name="line_b")


def params_ok(best, expect):
    """Whether the best point ``best`` is within each ``expect`` tolerance."""
    return all(abs(best[k] - v) < tol for k, (v, tol) in expect.items())


def report(name, walker, t0, expect=None):
    lp, best = walker.most_likely_step()
    out = {
        "config": name,
        "best_logprob": round(float(lp), 3),
        "acceptance": round(walker.acceptance(), 3),
        "seconds": round(time.perf_counter() - t0, 2),
        "chain_steps_per_sec": round(walker.age * walker.n_walkers /
                                     (time.perf_counter() - t0), 1),
    }
    if expect:
        out["params_ok"] = params_ok(best, expect)
    print(json.dumps(out))
    return out


def _model(fn, x, params):
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    return fn(torch.as_tensor(x, dtype=torch.float64), p).numpy()


def make_data(path: str | None = None) -> dict:
    """Every config's data, from one ``default_rng(0)`` in the script's
    order: config 1 reads ``path`` when it exists (test.lisp's columns 1
    and 4), else draws the synthetic spectrum; then configs 2-5."""
    rng = np.random.default_rng(0)
    data = {}
    if path is not None and os.path.exists(path):
        table = mfit.read_file_data(path)
        x, y = mfit.create_walker_data(table, 1, 4)
    else:
        x = np.linspace(2000, 3000, 334)
        y = _model(lorder_mixed_bg, x, SPECTRUM_1)
        y = np.asarray(y) + 1e-7 * rng.standard_normal(334)
    data[1] = (x, y)
    xg = np.linspace(-5, 5, 200)
    yg = 3.0 * np.exp(-0.5 * ((xg - 0.7) / 1.3) ** 2) + 0.05 * rng.standard_normal(200)
    data[2] = (xg, yg)
    xp = np.linspace(0, 10, 150)
    counts = rng.poisson(4.0 + 2.5 * xp).astype(float)
    data[3] = (xp, counts)
    xa = np.linspace(0, 8, 120)
    ya = SHARED_M * xa + 0.5 + 0.1 * rng.standard_normal(120)
    yb = SHARED_M * xa - 2.0 + 0.2 * rng.standard_normal(120)
    data[4] = [(xa, ya), (xa, yb)]

    def spectrum(mu1, mu2):
        clean = _model(double_lorentzian_bg, NV_FREQS, {
            "scale1": 1e-5, "scale2": 1e-5, "mu1": mu1, "mu2": mu2,
            "sigma": 10.0, "bg0": 1e-4})
        return NV_FREQS, np.asarray(clean) + 2e-7 * rng.standard_normal(len(NV_FREQS))

    data[5] = [spectrum(2858 + i, 2876 + i) for i in range(4)]
    return data


def walker_1(data, W, device, dtype=None):
    """1. test.lisp single-dataset fit (weighted normal + flat prior)."""
    x, y = data[1]
    return mfit.walker_create(
        function=lorder_mixed_bg, data=(x, y),
        params={"scale": 1e-5, "linewidth": 7, "x0": 2200, "mix": 0.9,
                "bg0": 1e-7, "bg1": 1e-9},
        data_error=1e-7, n_walkers=W, seed=0, walker_jitter=0.05,
        log_likelihood=mfit.log_likelihood_normal_weighted,
        dtype=dtype, device=device,
    )


def config_1(data, W, device, n_steps=STEPS[1], dtype=None):
    t0 = time.perf_counter()
    w1 = walker_1(data, W, device, dtype)
    # summary-only run: skip history capture
    w1.adaptive_steps(n_steps, collect_history=False)
    report("1-test.lisp-single-fit", w1, t0)
    return w1


def walker_2(data, W, device, dtype=None):
    """2. Gaussian peak fit with bounded priors + adaptive covariance."""
    xg, yg = data[2]
    prior = mfit.make_bounds_prior({"scale": (0.1, 10), "x0": (-3, 3), "sigma": (0.3, 5)})
    return mfit.walker_create(
        function=gaussian_peak, data=(xg, yg),
        params={"scale": 1.0, "x0": 0.0, "sigma": 1.0},
        data_error=0.05, log_prior=prior, n_walkers=W, seed=1, walker_jitter=0.1,
        dtype=dtype, device=device,
    )


def config_2(data, W, device, n_steps=STEPS[2], dtype=None):
    t0 = time.perf_counter()
    w2 = walker_2(data, W, device, dtype)
    w2.adaptive_steps(n_steps, collect_history=False)
    report("2-bounded-gaussian-peak", w2, t0, expect=EXPECT[2])
    return w2


def walker_3(data, W, device, dtype=None):
    """3. Poisson counting-data fit."""
    xp, counts = data[3]
    return mfit.walker_create(
        function=line, data=(xp, counts), params={"m": 1.0, "b": 1.0},
        log_likelihood=mfit.log_likelihood_poisson,
        n_walkers=W, seed=2, walker_jitter=0.1, dtype=dtype, device=device,
    )


def config_3(data, W, device, n_steps=STEPS[3], dtype=None):
    t0 = time.perf_counter()
    w3 = walker_3(data, W, device, dtype)
    w3.adaptive_steps(n_steps, collect_history=False)
    report("3-poisson-counts", w3, t0, expect=EXPECT[3])
    return w3


def walker_4(data, W, device, dtype=None):
    """4. Global multi-dataset fit with shared parameters."""
    (xa, ya), (_, yb) = data[4]
    return mfit.walker_create(
        function=[line_a, line_b], data=[(xa, ya), (xa, yb)],
        params={"m": 1.0, "ba": 0.0, "bb": 0.0},
        data_error=[0.1, 0.2], n_walkers=W, seed=3, walker_jitter=0.1,
        dtype=dtype, device=device,
    )


def config_4(data, W, device, n_steps=STEPS[4], dtype=None):
    t0 = time.perf_counter()
    w4 = walker_4(data, W, device, dtype)
    w4.adaptive_steps(n_steps, collect_history=False)
    report("4-global-shared-params", w4, t0, expect=EXPECT[4])
    return w4


def _world_size():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def fit_5(data, wps, device, dtype=None):
    """5. NV spectra batch: many walkers, sharded when ranks allow."""
    return nv.BatchedNVFit(data[5], walkers_per_spectrum=wps, seed=4, dtype=dtype,
                           device=device)


def config_5(data, wps, device, n_steps=STEPS[5], dtype=None):
    t0 = time.perf_counter()
    fit = fit_5(data, wps, device, dtype)
    n_dev = _world_size()
    if n_dev > 1 and fit.n_walkers % n_dev == 0:
        fit.shard()
    fit.adaptive_steps(n_steps, collect_history=False)
    report("5-nv-batched-sharded", fit, t0)
    print(json.dumps({"config": "5-details",
                      "n_walkers": fit.n_walkers,
                      "devices": n_dev,
                      "field_offsets": [round(o, 3) for o in fit.field_offsets()]}))
    return fit


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5}


def main(device=None, steps=None, path=DATA_FILE):
    """Every config at this device's widths; ``steps`` overrides
    :data:`STEPS` per config.  Returns ``{config: walker or fit}``."""
    device = setup_device() if device is None else device
    steps = {**STEPS, **(steps or {})}
    widths = WIDTHS["cuda" if torch.device(device).type == "cuda" else "cpu"]
    data = make_data(path)
    out = {}
    for k, run in CONFIGS.items():
        with phase(f"config {k}"):
            out[k] = run(data, widths["wps" if k == 5 else "W"], device, steps[k])
    return out


if __name__ == "__main__":
    main()
