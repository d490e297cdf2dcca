"""Roofline account of the port on one GPU: the card's per-op ceilings,
and where the two posterior kernels sit against them.

Port of ``benchmarks/roofline.py``.  On a machine with an NVIDIA GPU:

    python -m lisp_mcmc_torch.roofline [--data FILE] [--walkers W]

It measures, on the flagship configuration (W walkers, 200-step rwm
chunk, ``lorder_mixed_bg`` on 334 points):

1. the chunk time of both runners, by the host clock around chunks that
   end in a synchronize: the default path (the fused posterior kernel once
   per step) and ``posterior_impl="chunk_kernel"`` (one launch per chunk);
2. the pure likelihood time: K back-to-back launches of the fused kernel,
   timed with CUDA events at two values of K (the K-difference cancels
   fixed costs).  Eager PyTorch launches every call it is given, so
   nothing can merge or drop the repeated evaluations, and the JAX
   script's ``0 * lp`` dependency between them is not needed;
3. the card's ceilings (:func:`microbench_ceilings`): FMA, division, cos,
   exp, log and add issue rates from the chain-probe kernel
   (``ops/microbench.py``, ``csrc/microbench.cu``) by the K-difference,
   the SM clock during each probe, and HBM bandwidth from ``x + 1`` at two
   sizes by the size difference;
4. the op census of the kernels (``ops/loglik_kernel.py``,
   ``ops/chunk_kernel.py``): each kernel's op-mix bound at the measured
   rates (``loglik_kernel.class_rates``: on the GPU the add probe's time
   taken out of the div, exp and log probes) and its bound at the
   published peaks, and the share of each that the kernel reaches.

Data: the JAX script reads the reference's example file; ``data=None``
fits the synthetic flagship instead (:func:`synthetic_flagship`, seeded),
and a path reads a file through ``io.files.read_file_data``.  The report
names which.  ``device=None`` means the GPU and raises without one;
``device="cpu"`` rehearses the whole flow on the CPU with the kernels'
plain versions, and its times are then the CPU's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .data import create_walker_data
from .device import resolve_device
from .fit import walker_create
from .io import read_file_data
from .kernel import FitConfig
from .models import lorder_mixed_bg
from .ops.chunk_kernel import chunk_bytes, chunk_census
from .ops.loglik_kernel import (census_totals, class_rates, fused_bytes,
                                fused_posterior, opmix_bound_ms,
                                posterior_census, prepare_fused_terms)
from .ops.microbench import (CHAINS, FLOPS_PER_OP, OPS, UNROLL, chain_probe,
                             sm_clock_mhz)

__all__ = ["FLAGSHIP", "START", "N_POINTS", "PEAK_F32", "PEAK_F64",
           "PEAK_BYTES", "BOOST_MHZ", "synthetic_flagship", "wall", "chain_rate",
           "full_occupancy", "microbench_ceilings", "peak_bound", "main"]

# Published peaks of an H100 SXM at its 700 W limit (NVIDIA data sheet):
# FP32 and FP64 outside the tensor cores, HBM3 bandwidth; the arithmetic
# peaks are at the 1980 MHz boost clock (132 SMs x 128 FP32 lanes x 2).
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12
BOOST_MHZ = 1980

# The reference's printed flagship parameters with scale x10 (at the
# printed scale the resonance is worth 1.5 log-units under sigma = 1e-7
# and x0 is not identified), and the test.lisp starting point.
FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
START = {"scale": 1e-5, "linewidth": 7.0, "x0": 2200.0, "mix": 0.9,
         "bg0": 1e-7, "bg1": 1e-9}
N_POINTS = 334
PROBE_SECONDS = 2e-3    # the K2 launch of each probe lasts at least this
PROBE_N_CPU = 8 * 128   # probe elements on the CPU rehearsal
# elements of the HBM copy (the JAX script's 256 x 1024 x 1024 and
# 64 x 1024 x 1024), and the CPU rehearsal's
HBM_SIZES = {"cuda": (256 << 20, 64 << 20), "cpu": (1 << 22, 1 << 20)}
# timed chunks per runner after up to three warm ones (the JAX script's
# 10), and the CPU rehearsal's
CHUNKS = {"cuda": 10, "cpu": 1}


def synthetic_flagship(seed=0):
    """334 points of the flagship model plus sigma = 1e-7 noise (numpy)."""
    x = np.linspace(2000.0, 3600.0, N_POINTS)
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in FLAGSHIP.items()}
    y = lorder_mixed_bg(torch.tensor(x), p).numpy()
    return x, y + 1e-7 * np.random.default_rng(seed).standard_normal(N_POINTS)


def wall(fn, *args, iters=6, warmup=2):
    """Mean seconds per call of ``fn(*args)`` after ``warmup`` calls.

    ``fn`` returns a tensor; on the GPU the calls are timed with CUDA
    events, on the CPU with the host clock.
    """
    for _ in range(warmup):
        out = fn(*args)
    if not out.is_cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def chain_rate(make_chain, work_per_pass, k1=64, k2=512):
    """ops/sec via the K-difference method (fixed overheads cancel).

    ``make_chain(K)`` returns ``(fn, *args)`` doing K passes.
    """
    f1, f2 = make_chain(k1), make_chain(k2)
    t1, t2 = wall(*f1), wall(*f2)
    return (k2 - k1) * work_per_pass / (t2 - t1), (t1, t2)


def full_occupancy(device) -> int:
    """Threads that fill every SM of the card at full occupancy."""
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count * p.max_threads_per_multi_processor


def _k_pair(x, op: str) -> tuple[int, int]:
    """``(K1, K2)`` for one probe: K2 doubles from 8 until one launch lasts
    :data:`PROBE_SECONDS`; K1 = K2 / 8."""
    k = 8
    while k < 2 ** 20 and wall(chain_probe, x, op, k, iters=1, warmup=1) < PROBE_SECONDS:
        k *= 2
    return k // 8, k


def microbench_ceilings(dtype, device=None, n=None):
    """Per-op issue-rate ceilings and HBM bandwidth, measured on the card.

    Each op runs in the chain-probe kernel (``ops/microbench.py``): P
    independent chains per thread, U-unrolled, so the issue rate and not
    the op's latency is timed, with all state in registers.  ``n``
    elements (default: every SM at full occupancy) run K1 and K2 outer
    iterations, and the K-difference cancels the launch.  HBM bandwidth
    is ``x + 1`` at two sizes far above the 50 MB L2, by the size
    difference.

    Returns the JAX script's six keys (``fma_flops_per_sec``, an FMA
    counted as 2 flops; ``div_per_sec``, ``cos_per_sec``, ``exp_per_sec``,
    ``log_per_sec``; ``hbm_bytes_per_sec``), ``add_per_sec``, ``n`` and
    ``probes``: each op's K1, K2, the ms of one launch at each and, on the
    GPU, the SM clock (MHz) during one more launch at K2.
    """
    dev = resolve_device(device)
    if n is None:
        n = full_occupancy(dev) if dev.type == "cuda" else PROBE_N_CPU
    x = torch.full((n,), 1.0001, dtype=dtype, device=dev)
    out = {"n": n, "probes": {}}
    for op in OPS:
        k1, k2 = _k_pair(x, op)
        rate, (t1, t2) = chain_rate(lambda K, op=op: (chain_probe, x, op, K),
                                    UNROLL[op] * CHAINS * n * FLOPS_PER_OP[op], k1, k2)
        key = "fma_flops_per_sec" if op == "fma" else f"{op}_per_sec"
        out[key] = rate
        out["probes"][op] = {"k1": k1, "k2": k2, "t1_ms": t1 * 1e3, "t2_ms": t2 * 1e3}
        if dev.type == "cuda":
            out["probes"][op]["sm_mhz"] = sm_clock_mhz(x, op, k2)

    n_big, n_small = HBM_SIZES[dev.type]
    big = torch.ones(n_big, dtype=dtype, device=dev)
    small = torch.ones(n_small, dtype=dtype, device=dev)
    tb = wall(torch.add, big, 1.0, iters=4)
    ts = wall(torch.add, small, 1.0, iters=4)
    out["hbm_bytes_per_sec"] = 2 * (n_big - n_small) * big.element_size() / (tb - ts)
    del big, small
    return out


def peak_bound(census, W, N, steps, nbytes, dtype) -> dict:
    """The bound at the published peaks: the larger of every counted
    operation (a division or a transcendental counted as one) over the
    FP32 or FP64 peak, and ``nbytes`` over the HBM rate."""
    ops = sum(census_totals(census, W, N, steps).values())
    t_ops = 1e3 * ops / (PEAK_F64 if dtype == torch.float64 else PEAK_F32)
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _card():
    """The card's name, power limit and SM clock from nvidia-smi."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    name, power, clock = (s.strip() for s in line.split(","))
    return {"name": name, "power_limit": power, "clocks_sm": clock}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _chunk_seconds(walker, chunks: int) -> float:
    """Host seconds per non-history chunk of the walker's runner."""
    runner = walker._runner(with_history=False)
    st = walker.state
    for _ in range(min(3, chunks)):
        st, _ = runner(st, True, True, False, generator=walker.generator)
    _sync(walker.device)
    t0 = time.perf_counter()
    for _ in range(chunks):
        st, _ = runner(st, True, True, False, generator=walker.generator)
    _sync(walker.device)
    walker.state = st
    return (time.perf_counter() - t0) / chunks


def _repeat_fused(pos, post, K):
    for _ in range(K):
        out = fused_posterior(pos, post)
    return out


def main(data=None, walkers: int = 131072, device=None) -> dict:
    """The roofline report of the flagship fit (a dict; see the module)."""
    dev = resolve_device(device)
    chunks = CHUNKS[dev.type]
    if data is None:
        x, y = synthetic_flagship()
    else:
        x, y = create_walker_data(read_file_data(data), 1, 4)

    def walker(config=None):
        return walker_create(function=lorder_mixed_bg, data=(x, y), params=START,
                             data_error=1e-7, n_walkers=walkers, seed=0,
                             walker_jitter=0.05, config=config, device=dev)

    w = walker()
    dtype, d, chunk = w.dtype, w.ndim, w.config.chunk_size
    post = prepare_fused_terms(w.terms, w.spec, dtype)
    if post is None:
        raise ValueError("roofline: the fit is outside the fused kernel's coverage")
    n_pts = sum(t.n for t in post.terms)

    # ---- achieved chunk time of both runners
    chunk_t = _chunk_seconds(w, chunks)
    wk = walker(FitConfig(posterior_impl="chunk_kernel"))
    chunk_kernel_t = _chunk_seconds(wk, chunks)

    # ---- pure likelihood time by the K-difference
    lik_rate, _ = chain_rate(lambda K: (_repeat_fused, w.state.position, post, K),
                             1, k1=8, k2=64)
    lik_t = 1.0 / lik_rate

    ceil = microbench_ceilings(dtype, dev)
    card = _card() if dev.type == "cuda" else None
    rates = class_rates(ceil, take_out_add=dev.type == "cuda")

    # ---- the census and the bounds of both kernels (the posterior's
    # census sums every point already: N = 1)
    fc = posterior_census(post)
    cc = chunk_census(fc, d)
    step_ops = census_totals(cc, walkers, 1, 1)
    chunk_nbytes = chunk_bytes(post, walkers, chunk)
    kernels = {}
    for name, census, steps, ms, nbytes in (
            ("fused_posterior", fc, 1, lik_t * 1e3, fused_bytes(post, walkers)),
            ("chunk_rwm", cc, chunk, chunk_kernel_t * 1e3, chunk_nbytes)):
        peak = peak_bound(census, walkers, 1, steps, nbytes, dtype)
        opmix = opmix_bound_ms(census, walkers, 1, steps, rates)
        kernels[name] = {"ms": ms, "opmix_bound_ms": opmix, "opmix_share": opmix / ms,
                         "peak_bound_ms": peak["bound_ms"],
                         "peak_bound_by": peak["bound_by"],
                         "peak_share": peak["bound_ms"] / ms}

    chunk_flops = step_ops["flops"] * chunk
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card,
        "data": "synthetic flagship (seed 0)" if data is None else str(data),
        "walkers": walkers,
        "dtype": str(dtype).split(".")[-1],
        "chunk_steps": chunk,
        "chunk_seconds": chunk_t,
        "steps_per_sec": chunk * walkers / chunk_t,
        "chunk_kernel_chunk_seconds": chunk_kernel_t,
        "chunk_kernel_steps_per_sec": chunk * walkers / chunk_kernel_t,
        "likelihood_eval_seconds": lik_t,
        "likelihood_share_of_step": lik_t * chunk / chunk_t,
        "points": n_pts,
        "census_per_walker_step": {c: n / walkers for c, n in step_ops.items()},
        "census_flops_per_step": step_ops["flops"],
        "census_flops_per_chunk": chunk_flops,
        "census_bytes_per_chunk": chunk_nbytes,
        "achieved_flops_per_sec": chunk_flops / chunk_t,
        "ceilings": ceil,
        "class_rates": rates,
        "pct_of_fma_ceiling": 100.0 * (chunk_flops / chunk_t) / ceil["fma_flops_per_sec"],
        "kernels": kernels,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        description="Per-op ceilings of the GPU and the op-mix bounds of the "
                    "posterior kernels (a JSON report)")
    ap.add_argument("--data", default=None, help="a data file (default: the "
                    "synthetic flagship)")
    ap.add_argument("--walkers", type=int, default=131072)
    args = ap.parse_args()
    print(json.dumps(main(data=args.data, walkers=args.walkers), indent=2))
