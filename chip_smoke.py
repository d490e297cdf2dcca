"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA GPU (written for
an H100) and the CUDA toolkit.  It

1. prints the card (``nvidia-smi``), the nvcc and torch versions;
2. builds the three CUDA kernels from ``lisp_mcmc_torch/csrc`` (one nvcc
   per source, started together);
3. the roofline path: holds the chain-probe kernel against its plain
   version for its six ops in float32 and float64 (and, where cuobjdump
   exists, counts the FFMA/DFMA of the fma probes), measures the card's
   ceilings in both types and checks them against the published peaks,
   then runs ``lisp_mcmc_torch.roofline.main()`` at W = 131072;
4. holds the fused posterior kernel against its plain PyTorch version at
   the flagship's shape (W = 131072 walkers, d = 6, N = 334 points), in
   float32 and float64, with a flat and a bounds prior, and times both;
5. holds the whole-chunk rwm kernel against its plain version for one
   200-step chunk at W = 131072 from the same state and seed, and times
   both;
6. runs the flagship journey on the default path (fused kernel per step):
   ``walker_create`` + ``adaptive_steps(30000, temperature=10)`` with
   history, then ``most_likely_step`` and ``ess_from_history``;
7. runs the journey again with ``posterior_impl="chunk_kernel"``
   (``adaptive_steps(10000, collect_history=False)``);
8. profiles two chunks of the default path (wall clock, device time by
   kernel, the device's busy share);
9. prints the ``kernels`` summary line (each kernel's time, launches on
   its path, bound at the published peaks, op-mix bound at the measured
   float32 ceilings, plain and library times), the card line and, last,
   ``{"ok": true, "device": {...}}``.

Each phase prints one JSON line.  Any failed check raises, and the script
exits non-zero without the last line; it also refuses to run without a
CUDA device.  The data is synthetic, made from a seed: the flagship model
at the reference's printed parameters with scale x10 (at the printed scale
the resonance is worth 1.5 log-units under sigma = 1e-7 and x0 is not
identified) plus 1e-7 Gaussian noise.  Everything printed is also written
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

W_FLAGSHIP = 131072
DEVICE = "cuda"
# Relative tolerance of the chain probe against its plain version.  The
# plain version rounds as the kernel does: the float32 fma once (it is exact
# in float64 before the rounding), the division as one IEEE division, and
# torch's CUDA cos, exp and log are the same library functions as the
# kernel's; so float32 should agree bit for bit, and 1e-6 is 8 ulps of the
# sum.  In float64 the kernel contracts the fma op into one DFMA where the
# plain version rounds twice: ~1e-16 per application, 1e-12 after 512.
PROBE_RTOL = {"float32": 1e-6, "float64": 1e-12}
# At K = 4 one outer iteration moves every op's sum by more than the
# tolerance (relative: fma 1e-5, add 1.6e-5, div 6e-6, cos 6e-5, log 3e-2),
# so a kernel one iteration short fails the check; the check also asserts
# it.  Not exp: exp(x * 1e-6) reaches its fixed point in one application,
# and its probe's time growing with K (the ceilings check) shows that its
# loop runs.
PROBE_K = 4
PROBE_CONVERGED = ("exp",)
OUT = {"phases": []}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    OUT["phases"].append(obj)
    print(json.dumps(obj), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` warm runs, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_card():
    import torch

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    line = card_line()
    print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": line, "nvcc": nvcc,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def _nvcc():
    import shutil

    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def phase_build():
    from lisp_mcmc_torch.device import build_all

    t0 = time.perf_counter()
    logs = build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln][:24]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": secs, "built": sorted(logs),
          "ptxas": ptxas})


def _sass_fma_counts():
    """FFMA / DFMA instructions in the float32 / float64 fma probes, read
    from the built library with cuobjdump; None where there is none."""
    import re
    import shutil
    from lisp_mcmc_torch.device import _target

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(_target("microbench"))], check=True,
                          capture_output=True, text=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        for tag, ins in (("IfLi0E", "FFMA"), ("IdLi0E", "DFMA")):
            if "chain_kernel" + tag in block.split()[0]:
                counts[ins] = len(re.findall(rf"\b{ins}\b", block))
    return counts


def _max_rel(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def phase_roofline(counters):
    """The third kernel and the path that runs it.

    The chain probe against its plain version for every op in both types,
    with a check that the chains move far enough for the tolerance to see
    a missing iteration; the ceilings in float32 and float64, checked
    against the published peaks and for each probe's time growing with K;
    then ``roofline.main()`` at the flagship's W with every launch count
    set to 0 just before it.  Returns the float32 ceilings and the probe's
    row of the kernels line.
    """
    import torch
    from lisp_mcmc_torch import roofline
    from lisp_mcmc_torch.ops.loglik_kernel import class_rates, opmix_bound_ms
    from lisp_mcmc_torch.ops.microbench import (CHAINS, OPS, UNROLL, chain_probe,
                                                chain_probe_plain, probe_census)

    n = roofline.full_occupancy(0)
    checks = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        rtol = PROBE_RTOL[name]
        x = torch.linspace(0.5, 2.0, n, dtype=dtype, device=DEVICE)
        for op in OPS:
            got = chain_probe(x, op, PROBE_K)
            ref = chain_probe_plain(x, op, PROBE_K)
            moved = _max_rel(chain_probe_plain(x, op, 0), ref)
            last = _max_rel(chain_probe_plain(x, op, PROBE_K - 1), ref)
            torch.cuda.synchronize()
            rel = _max_rel(got, ref)
            what = f"chain probe {op} {name}"
            check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
            check(rel <= rtol, f"{what}: max relative error {rel} > {rtol}")
            check(moved > 10 * rtol, f"{what}: the chains moved {moved} from their "
                  f"start, not 10x the tolerance {rtol}")
            check(op in PROBE_CONVERGED or last > rtol, f"{what}: the last "
                  f"iteration moved the sum {last}, within the tolerance {rtol}")
            checks[f"{op}_{name}"] = {"max_rel_err": rel,
                                      "max_abs_err": float((got - ref).abs().max()),
                                      "moved": moved, "last_iteration_moved": last}
    sass = _sass_fma_counts()
    want = UNROLL["fma"] * CHAINS
    if sass is not None:
        check(sass == {"FFMA": want, "DFMA": want},
              f"fma probes: {sass} FFMA/DFMA, want {want} each")
    emit({"phase": "roofline_probe_check", "n": n, "K": PROBE_K,
          "rtol": PROBE_RTOL, "results": checks, "sass_fma": sass})

    ceilings = {}
    for dtype in (torch.float32, torch.float64):
        ceilings[str(dtype).split(".")[-1]] = roofline.microbench_ceilings(dtype, DEVICE)
    card = roofline._card()
    c32, c64 = ceilings["float32"], ceilings["float64"]
    # each FMA ceiling against the published peak scaled to the SM clock
    # its own probe ran at
    at_clock = {name: c["fma_flops_per_sec"] / (peak * c["probes"]["fma"]["sm_mhz"]
                                                / roofline.BOOST_MHZ)
                for name, c, peak in (("float32", c32, roofline.PEAK_F32),
                                      ("float64", c64, roofline.PEAK_F64))}
    emit({"phase": "ceilings", "card": card, "fma_share_of_peak_at_its_clock": at_clock,
          **ceilings})
    peak32 = c32["fma_flops_per_sec"] / roofline.PEAK_F32
    check(0.5 <= peak32 <= 1.03, f"f32 FMA ceiling at {peak32:.3f} of the peak")
    peak64 = c64["fma_flops_per_sec"] / roofline.PEAK_F64
    check(peak64 <= 1.03, f"f64 FMA ceiling at {peak64:.3f} of the peak")
    for name, c in ceilings.items():
        hbm = c["hbm_bytes_per_sec"] / roofline.PEAK_BYTES
        check(0.5 <= hbm <= 1.03, f"{name} HBM ceiling at {hbm:.3f} of the peak")
        for op, p in c["probes"].items():
            check(p["t2_ms"] / p["t1_ms"] >= p["k2"] / p["k1"] / 2,
                  f"{name} {op} probe: {p['t2_ms']} ms at K={p['k2']} against "
                  f"{p['t1_ms']} ms at K={p['k1']}: its time does not grow with K")
    check(c32["div_per_sec"] < c32["fma_flops_per_sec"] / 2,
          "f32 division rate at or above the FMA instruction rate")

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    report = roofline.main(walkers=W_FLAGSHIP, device=DEVICE)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    check(launches["chain_probe"] > 0, "roofline: the chain probe was never launched")
    check(report["device"] == torch.cuda.get_device_name(0), "roofline: wrong device")
    for k, v in report["kernels"].items():
        check(v["ms"] > 0 and 0 < v["opmix_share"], f"roofline: {k} row {v}")
    emit({"phase": "roofline", "report": report, "launches": launches})

    # the kernels row: the float32 fma probe's K2 launch
    probe, n32 = c32["probes"]["fma"], c32["n"]
    x = torch.full((n32,), 1.0001, dtype=torch.float32, device=DEVICE)
    plain_ms = cuda_time_ms(lambda: chain_probe_plain(x, "fma", probe["k2"]), 1)
    census, apps = probe_census("fma"), probe["k2"] * UNROLL["fma"] * CHAINS
    row = {"name": "microbench", "route": "cuda",
           "source": "lisp_mcmc_torch/csrc/microbench.cu",
           "replaces": "benchmarks/roofline.py:55",
           "launches": launches["chain_probe"],
           "max_abs_err": checks["fma_float32"]["max_abs_err"],
           "ms": probe["t2_ms"], "plain_ms": plain_ms,
           **roofline.peak_bound(census, n32, apps, 1, 8 * n32, torch.float32),
           "opmix_bound_ms": opmix_bound_ms(census, n32, apps, 1, class_rates(c32)),
           "library_ms": None}
    return c32, row


def _flagship_walker(n_walkers, dtype, device, config=None, log_prior=None,
                     params=None, jitter=0.05):
    """The flagship fit on the synthetic data, from ``params`` (default:
    the test.lisp start)."""
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.models import lorder_mixed_bg
    from lisp_mcmc_torch.roofline import START, synthetic_flagship

    x, y = synthetic_flagship()
    params = START if params is None else params
    return mfit.walker_create(
        function=lorder_mixed_bg, data=(x, y), params=params, data_error=1e-7,
        log_prior=log_prior, n_walkers=n_walkers, seed=0, walker_jitter=jitter,
        config=config, dtype=dtype, device=device)


def phase_fused(ceilings):
    """Kernel 1 against its plain version at the flagship's shape."""
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_census,
                                                   fused_posterior,
                                                   fused_posterior_plain,
                                                   prepare_fused_terms)
    from lisp_mcmc_torch.roofline import FLAGSHIP, N_POINTS

    bounds = mfit.make_bounds_prior({"linewidth": (1.0, 500.0),
                                     "x0": (2700.0, 2900.0), "mix": (0.0, 6.3)})
    results = {}
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
        for prior_name, prior in (("flat", None), ("bounds", bounds)):
            w = _flagship_walker(W_FLAGSHIP, dtype, DEVICE, log_prior=prior,
                                 params=FLAGSHIP, jitter=0.02)
            term = prepare_fused_terms(w.terms, w.spec, dtype)
            check(term is not None, "flagship term outside the kernel's coverage")
            # near the peak (where f32 cancellation bites) and the far start
            pos = torch.cat([w.state.position[: W_FLAGSHIP // 2],
                             _flagship_walker(W_FLAGSHIP // 2, dtype, DEVICE).state.position])
            pos = pos.contiguous()
            got = fused_posterior(pos, term)
            ref = fused_posterior_plain(pos, term)
            torch.cuda.synchronize()
            check(got.shape == (W_FLAGSHIP,) and bool(torch.isfinite(got).all()),
                  "fused posterior: non-finite or misshapen output")
            err = (got - ref).abs()
            rel = float((err / ref.abs().clamp_min(1.0)).max())
            check(rel <= rtol, f"fused posterior {dtype} {prior_name}: max "
                  f"relative error {rel} > {rtol}")
            n_out = int((prior(w.spec.unflatten(pos)) < 0).sum()) if prior else 0
            ms = cuda_time_ms(lambda: fused_posterior(pos, term), 50)
            plain_ms = cuda_time_ms(lambda: fused_posterior_plain(pos, term), 5)
            key = f"{str(dtype).split('.')[-1]}_{prior_name}"
            if key == "float32_flat":
                main_term = term
            results[key] = {"max_rel_err": rel, "rtol": rtol,
                            "max_abs_err": float(err.max()), "ms": ms,
                            "plain_ms": plain_ms, "walkers_far_out": n_out}
    emit({"phase": "fused_posterior", "W": W_FLAGSHIP, "d": 6, "N": N_POINTS,
          "results": results})
    main = results["float32_flat"]
    census = fused_census(main_term.model_id, main_term.kind)
    return {"name": "fused_posterior", "route": "cuda",
            "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
            "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117",
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            **_bounds(census, 1, fused_bytes(main_term, W_FLAGSHIP), ceilings),
            "library_ms": None}


def _bounds(census, steps, nbytes, ceilings):
    """The published-peak bound and the op-mix bound (measured float32
    ceilings) of ``steps`` flagship evaluations of a float32 kernel."""
    import torch
    from lisp_mcmc_torch.ops.loglik_kernel import class_rates, opmix_bound_ms
    from lisp_mcmc_torch.roofline import N_POINTS, peak_bound

    return {**peak_bound(census, W_FLAGSHIP, N_POINTS, steps, nbytes, torch.float32),
            "opmix_bound_ms": opmix_bound_ms(census, W_FLAGSHIP, N_POINTS, steps,
                                             class_rates(ceilings))}


def phase_chunk(ceilings):
    """Kernel 2 against its plain version: one chunk at W = 131072."""
    import torch
    from lisp_mcmc_torch.ops.chunk_kernel import (build_chunk_kernel, chunk_bytes,
                                                  chunk_census, chunk_rwm,
                                                  chunk_rwm_plain)
    from lisp_mcmc_torch.roofline import FLAGSHIP

    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, params=FLAGSHIP,
                         jitter=1e-3)
    ck = build_chunk_kernel(w.terms, w.spec, w.config, W_FLAGSHIP, torch.float32)
    check(ck is not None, "flagship chunk outside the kernel's scope")
    st = w.state
    L = torch.diag(3e-3 * torch.as_tensor(list(FLAGSHIP.values()),
                                          dtype=torch.float32).abs()).to(DEVICE)
    seed = torch.tensor([20240607], dtype=torch.int32, device=DEVICE)
    args = (st.position, st.logprob, st.best_position, st.best_logprob, L,
            1000, 0.0, seed)
    got = chunk_rwm(ck, *args)
    ref = chunk_rwm_plain(ck, *args)
    torch.cuda.synchronize()
    # A walker agrees when its accept count and its final position match
    # (rtol 1e-4): one near-tie flip, from a 1-ulp difference of logf/cosf,
    # sends a walker down another path, and at W = 131072 a few such paths
    # end with equal counts but other positions.
    same_count = got["accept_counts"] == ref["accept_counts"]
    walker_rel = ((got["position"] - ref["position"]).abs()
                  / ref["position"].abs().clamp_min(1e-30)).amax(dim=1)
    same = same_count & (walker_rel <= 1e-4)
    count_agree = float(same_count.float().mean())
    agree = float(same.float().mean())
    rate = float(got["accept_counts"].mean()) / ck.chunk
    check(agree >= 0.99, f"chunk: {agree} of walkers agree in accept count and "
          "position (rtol 1e-4); need >= 0.99")
    pos_rel = float(walker_rel[same].max())
    check(float(got["m_count"]) == float(got["accept_counts"].sum()),
          "chunk: m_count != sum of accept counts")
    check(bool(torch.isfinite(got["logprob"]).all()), "chunk: non-finite logprob")
    lp_err = float((got["logprob"] - ref["logprob"]).abs()[same].max())
    ms = cuda_time_ms(lambda: chunk_rwm(ck, *args), 5)
    plain_ms = cuda_time_ms(lambda: chunk_rwm_plain(ck, *args), 1)
    emit({"phase": "chunk_rwm", "W": W_FLAGSHIP, "chunk": ck.chunk,
          "accept_rate": rate, "count_agreement": count_agree,
          "walker_agreement": agree,
          "pos_max_rel_err": pos_rel, "logprob_max_abs_err": lp_err,
          "ms": ms, "plain_ms": plain_ms})
    census = chunk_census(ck.term.model_id, ck.term.kind, ck.d)
    return {"name": "chunk_rwm", "route": "cuda",
            "source": "lisp_mcmc_torch/csrc/chunk_rwm.cu",
            "replaces": "lisp_mcmc_tpu/ops/chunk_pallas.py:95",
            "max_abs_err": lp_err, "ms": ms, "plain_ms": plain_ms,
            **_bounds(census, ck.chunk, chunk_bytes(ck.term, W_FLAGSHIP, ck.chunk),
                      ceilings),
            "library_ms": None}


def _lp_generating():
    import torch
    from lisp_mcmc_torch.roofline import FLAGSHIP

    w = _flagship_walker(1, torch.float64, DEVICE, params=FLAGSHIP, jitter=0.0)
    return float(w.state.logprob[0])


def _quality(w, lp_gen, name):
    from lisp_mcmc_torch.roofline import FLAGSHIP

    lp, best = w.most_likely_step()
    acc = w.acceptance()
    check(lp >= lp_gen - 5.0, f"{name}: best lp {lp} < lp(generating) {lp_gen} - 5")
    check(abs(best["x0"] - FLAGSHIP["x0"]) <= 0.01 * FLAGSHIP["x0"],
          f"{name}: x0 {best['x0']} not within 1% of {FLAGSHIP['x0']}")
    check(0.2 <= acc <= 0.4, f"{name}: final acceptance {acc} outside 0.2-0.4")
    return lp, best, acc


def phase_journey(counters):
    """The default path: fused kernel per step, history on."""
    import torch
    import lisp_mcmc_torch as mfit

    lp_gen = _lp_generating()
    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE)
    n_steps = 30000
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.adaptive_steps(n_steps, temperature=10.0, auto=None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    lp, best, acc = _quality(w, lp_gen, "journey")
    check(launches["fused_posterior"] > 0,
          "journey: the fused posterior kernel was never launched")
    pos, _ = w._history()
    t1 = time.perf_counter()
    ess = mfit.ess_from_history(torch.as_tensor(pos, device=DEVICE), w.spec.keys)
    ess_secs = time.perf_counter() - t1
    emit({"phase": "journey_default", "W": W_FLAGSHIP, "steps": n_steps,
          "seconds": secs, "chain_steps_per_sec": W_FLAGSHIP * n_steps / secs,
          "best_lp": lp, "lp_generating": lp_gen, "x0": best["x0"],
          "acceptance": acc, "history": list(pos.shape), "ess": ess,
          "ess_seconds": ess_secs, "min_ess_per_sec": min(ess.values()) / secs,
          "launches": launches})
    return launches


def phase_chunk_journey(counters):
    """The chunk-kernel path: one launch per non-history chunk."""
    import torch
    import lisp_mcmc_torch as mfit

    lp_gen = _lp_generating()
    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE,
                         config=mfit.FitConfig(posterior_impl="chunk_kernel"))
    n_steps = 10000
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.adaptive_steps(n_steps, temperature=10.0, auto=None, collect_history=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    lp, best, acc = _quality(w, lp_gen, "chunk journey")
    check(launches["chunk_rwm"] > 0, "chunk journey: the chunk kernel was never launched")
    emit({"phase": "journey_chunk_kernel", "W": W_FLAGSHIP, "steps": n_steps,
          "seconds": secs, "chain_steps_per_sec": W_FLAGSHIP * n_steps / secs,
          "best_lp": lp, "lp_generating": lp_gen, "x0": best["x0"],
          "acceptance": acc, "launches": launches})
    return launches


def phase_profile():
    """Where one default-path chunk spends its time: wall clock of two warm
    chunks, then the device time by kernel (torch.profiler) of two more."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE)
    runner = w._runner(with_history=True)
    st = w.state

    def chunks(n):
        nonlocal st
        for _ in range(n):
            st, _ = runner(st, True, True, False, generator=w.generator)
        torch.cuda.synchronize()

    chunks(2)
    t0 = time.perf_counter()
    chunks(2)
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunks(2)
    # device-side events only: a CPU op's entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3 / 2, e.count / 2)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    emit({"phase": "profile_default_chunk", "W": W_FLAGSHIP, "chunk_wall_ms": wall_ms,
          "device_busy_ms": device_ms if rows else None,
          "device_busy_share": device_ms / wall_ms if rows else None,
          "kernels_per_chunk": sum(r[2] for r in rows),
          "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:8]]})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from lisp_mcmc_torch.ops.chunk_kernel import chunk_rwm
        from lisp_mcmc_torch.ops.loglik_kernel import fused_posterior
        from lisp_mcmc_torch.ops.microbench import chain_probe
    except ImportError as e:
        print(f"chip_smoke: lisp_mcmc_torch not found beside this script: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (fused_posterior, chunk_rwm, chain_probe)
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    ceilings, probe_row = phase_roofline(counters)
    kernels = [phase_fused(ceilings), phase_chunk(ceilings)]
    main_launches = phase_journey(counters)
    chunk_launches = phase_chunk_journey(counters)
    phase_profile()
    kernels[0]["launches"] = main_launches["fused_posterior"]
    kernels[1]["launches"] = chunk_launches["chunk_rwm"]
    kernels.append(probe_row)
    summary = {"kernels": kernels}
    OUT["kernels"] = kernels
    OUT["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(OUT, f, indent=1)
    print(json.dumps(summary), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
