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
4. counts kernel 1's shared loads in SASS by width (cuobjdump; the
   float32 point loop reads its points with 128-bit LDS), then holds the fused posterior kernel against its
   plain PyTorch version at the flagship's shape (W = 131072 walkers,
   d = 6, N = 334 points), in float32 and float64, with a flat and a
   bounds prior, and times both; every kernel-1 timing here prints the
   launch plan (``loglik_kernel.fused_plan``: threads, R, S, blocks,
   waves, registers, spills; the plan's kernel may not spill), the
   wrapper's ms and the kernel's own ms (``torch.profiler``);
5. holds the whole-chunk rwm kernel against its plain version for one
   200-step chunk at W = 131072 from the same state, seed and dense L
   (``synthetic.dense_l``), and times both; reports its block size,
   blocks per SM and waves (``chunk_kernel.chunk_plan``) and registers;
6. ``twins``: the fused kernel against its plain version at W = 131072,
   N = 334 for each of the 13 zoo twins, with and without their optional
   parameters, for every likelihood kind (Poisson where the model's mean
   is positive), in float32 and float64; times each twin;
7. ``global``: test.lisp:52-78's global fit (two datasets, 9 parameters,
   the second model declared with ``models.renamed``): both kernels
   against their plain versions at W = 131072 (the chunk kernel at d = 9,
   and again on 1500-point datasets, which it stages tile by tile every
   step), then the journey through ``mcmc_fit`` on the default path and through
   ``adaptive_steps(collect_history=False)`` on
   ``posterior_impl="chunk_kernel"``, each held to the flagship's gates;
8. ``chunk_wide``: the chunk kernel against its plain version on a
   five-dataset global fit (d = 18) at W = 131072;
9. runs the flagship journey on the default path (fused kernel per step):
   ``walker_create`` + ``adaptive_steps(30000, temperature=10)`` with
   history, then ``most_likely_step`` and ``ess_from_history``;
9a. ``plotting``: every ``Walker`` plot verb of that journey's walker into
    ``chiprun_out/plots/`` where matplotlib is installed (the plots' device
    work alone where it is not: the envelope and the autocorrelation
    curves), each timed; the envelope against its float64 CPU evaluation
    and the curves against numpy's;
10. runs the journey again with ``posterior_impl="chunk_kernel"``
    (``adaptive_steps(10000, collect_history=False)``);
11. ``nv``: ``nv.fit_nv_file`` on a ';'-delimited file of the first
    synthetic spectrum (``NV_FILE_SPECTRA``) with W = 131072, the NV prior's
    bounds and declared constraints inside the fused kernel (nothing left
    for torch); gates on mu1, mu2, the field offset and the acceptance;
12. ``nv_chunk``: the chunk kernel against its plain version on the NV
    fit (its constraints in the kernel), then the three spectra as a
    ``WalkerSet`` of ``nv.nv_walker`` on ``posterior_impl="chunk_kernel"``,
    ``adaptive_steps(40000, collect_history=False)``, held to the ``nv``
    gates;
13. ``half_width``: the fused kernel on the red-black samplers'
    half-ensembles, W/2 = 65536 walkers (the ungrouped low half, and the
    low halves of 8 groups flattened), against its plain version, timed
    in turns against the full launch, with both bounds at each width;
14. ``tempered``: ``tempered_steps(6000, rungs=8, t_max=50)`` from the
    test.lisp start (8 rungs as adaptation groups, replica swaps at every
    chunk end, the fused kernel once a step), held to the flagship's best
    lp and x0 gates and to one launch a step; records the swap rates and
    times the fused kernel on the tempered ensemble;
15. ``ensemble``: ``sampling_steps(n, kernel=k)`` for stretch, demc and
    slice from the generating parameters with history, the fused kernel on
    each half-ensemble; gates best lp, x0, the sampled x0 median, the
    acceptance (slice: the landed share), the x0 spreads against each
    other and the launch counts; records chain-steps/sec and min-ESS/sec;
16. ``slice_poll``: one slice chunk per ``kernel.SLICE_POLL`` value (how
    often the slice loops read "every walker done" back), timed in turns,
    the same chains checked on injected draws;
17. profiles chunks of the default path (wall clock, device time by
    kernel, the device's busy share);
18. ``gradient``: an rwm warm-in from the ensemble journeys' start, then
    ``sampling_steps`` with mala (2000 steps), hmc (200) and chees (400)
    on the same walkers, their gradients by autograd through the plain
    posterior (checked: no kernel-1 launch inside one) and the rescue's
    two half-rounds a chunk on kernel 1 at W/2 (checked: the launches);
    gates best lp, x0, the sampled x0 median, acceptance in the sampler's
    band widened by 0.1, the x0 spread against the ensemble journeys',
    a finite state, kernel 1 against autograd on the rescued walkers;
    reports ms a step and an ``eval_vg`` (wrapper and device), the chees
    step's host sync (profiled 20-step chees and hmc chunks), peak memory,
    ``chees_trajectory`` and ESS/s by bench.py's recipe;
19. ``chees_d24``: bench.py's correlated Gaussian (d = 24, W = 2048), rwm
    warm-in then chees; gates every marginal variance within 25 %;
    reports ESS/s;
20. ``blocked``: block-diagonal proposals on a Gaussian of 2 hyper + 8
    local blocks of 3 (W = 4096; rwm, then mala), gates L's cross blocks
    exactly 0 after refreshes and the variances within 25 %; then blocked
    rwm on the chunk kernel (the global pair ordered hyper-first, W =
    131072), the kernel against its plain version with the fit's
    block-diagonal L, and the journeys' gates;
21. ``priors``: named priors as the kernels' declared tables.  Kernel 1
    against its plain version at W = 131072, N = 334, float32 and float64,
    with ``synthetic.flagship_prior_spec`` (a truncated Gaussian on x0, a
    LogNormal on the linewidth, a one-sided truncated Gaussian on mix,
    boxes on the rest; walkers past every wall and at the LogNormal's x
    <= 0) and with an ``MVGaussian`` over (linewidth, x0, mix) built from
    the named-prior journey's ``covariance_matrix()``, timed beside the
    flat prior; kernel 2 against its plain version on one chunk with the
    spec; the named-prior journey (``walker_create(log_prior=spec)``,
    ``sample_region(n=1000)``, ``adaptive_steps(20000, temperature=10)``
    with history on the default path: the flagship's gates with lp(gen)
    under the same prior, one kernel-1 launch a step, nothing of the prior
    left for torch), then on ``posterior_impl="chunk_kernel"`` (10000
    steps without history, the same gates); ``optimize(400, rounds=1)`` on
    the journey's walker and ``optimize(400, rounds=1)`` on the global
    journey's (no walker falls, the best lp does not fall and stays >=
    lp(gen) - 5; ms a step, peak memory, the lp gained); a
    ``unit_cube_view`` of the journey's walker, its posterior identity
    on 1024 walkers (1e-5) and, after ``adaptive_steps(2000,
    temperature=1)``, its theta-image's median x0 within 1 % of the fit's;
22. ``batched_nv``: a 16 x 16 scan grid of NV spectra
    (``synthetic.nv_scan_grid``) as one ``nv.BatchedNVFit`` of 128
    walkers a spectrum (W = 32768, float32) on the plain batched
    posterior (checked: no kernel launches, by design), a
    40000-step anneal and 4000 rwm steps at T = 1, then ``sampling_steps``
    with stretch (200 steps)
    and mala (50) on the same batch and ``laplace_per_dataset``; gates
    every spectrum's mu1, mu2 and field offset within 0.5 MHz, its
    acceptance over 1000 steps after the anneal in 0.2-0.4, finite states,
    positive-definite Laplace covariances; reports ms a step,
    chain-steps/sec, the device's busy share (two profiled chunks), peak
    memory;
22a. ``shard``: two worker processes as a 2-rank gloo group on the card
    (``lisp_mcmc_torch.parallel``, 65536 walkers a rank, kernel 1 with the
    unsharded W's plan) and an NCCL world of one, beside ``batched_nv``:
    rwm, mala (with the rescue), stretch and chees chunks against the
    unsharded chunk, a sharded 20000-step flagship fit held to the
    journey's gates, the all-reduces a chunk; kernel 1 at a rank's W/2
    against its plain version;
23. ``evidence``: ``synthetic.line_evidence_case`` (a line under a box
    prior, log Z in closed form) at W = 131072, float32:
    ``log_evidence(n_steps=16000, rungs=16, t_max=1e4)`` (the line twin of
    kernel 1 once a ladder step; gates the JAX test's 0.25 / 0.35 / 0.2),
    ``smc_sample`` on the default path and on ``chunk_kernel`` (kernel 2
    at each stage's temperature; each within 0.25), ``laplace_approx``
    (within 0.05), ``nested_sample`` at n_live = 131072 (kernel 1 on every
    refill move at W = 32768; within max(0.25, 4 log_z_err) of the closed
    form, log_z_err < 0.05, launches 1 + rounds x 32), the launch counts
    of both kernels, kernel 1 against its plain version on the ladder's
    ensemble and at the refills' width, and kernel 2 on the SMC particles
    at a stage temperature (T = 10);
24. ``criticism``: on the flagship journey's walker, after
    ``reset_to_most_likely`` and 4000 adaptive steps at T = 1 (the same on
    the named-prior journey's walker), reading the last 2000 steps:
    ``waic``, ``loo``, ``loo_pit``, ``audit``, ``posterior_predictive`` and
    ``ppc_pvalue``, ``predict`` on 2048 points, ``prior_predictive``,
    ``profile_likelihood("x0")`` (kernel 1 on its 168 rows),
    ``prior_sensitivity`` with ``synthetic.flagship_prior_spec``,
    ``kfold(k=10)`` and ``reloo`` of the 4 highest Pareto k (1000 anneal
    steps; their refits on the plain batched posterior), and
    ``nested_per_dataset`` on 16
    line cases (``synthetic.line_evidence_batch``); gates loo within 2.0
    of waic, kfold within 2 max(se, 1) of loo, loo_pit ok, the profile's
    maximum inside its grid with x0 within 1 %, 4 refits, each nested run
    within max(0.25, 4 log_z_err) of its closed form, every result finite
    and every launch count; reports each verb's seconds, the refits' ms a
    step and the device's busy share over profiled mala chunks;
25. ``variational``: ADVI on the evidence line case (W = 131072, warmed
    in on kernel 1): ``advi()`` full rank and meanfield, their
    evaluation draws on kernel 1 at W = 2048 (held against the plain
    posterior), then ``seed_walker`` and 1000 steps at T = 1; on the
    banana of JAX tests/test_flow_vi.py ``flow_advi(n_steps=8000)``, a
    Gaussian ``advi`` and ``neutra_sample`` (mala, 4096 walkers, 2000
    steps) with that test's gates, and a ``save``/``load_flow`` round
    trip; ``advi_per_dataset`` and ``flow_advi_per_dataset`` on 16 line
    cases; ``sbc_check`` of 128 simulations (8192 walkers, 3000 steps,
    plain batched posterior) and its understated-noise control; reports
    each verb's seconds and launches and the optimizer's ms, kernels and
    device busy share a step (its steps are CUDA graphs);
26. ``pooling``: ``compare_pooling`` over ``synthetic.global_fit(8)``'s
    spectra (the flagship model each, pooled linewidth, x0 and mix) at W =
    8192 (1024 a dataset for the independent fit), its complete-pooling
    fit on kernel 1 over 8 terms; kernel 1 against its plain version at
    that shape, the float32 hierarchical posterior against float64,
    profiled hierarchical rwm and mala chunks; gates in its constants
    (``pooling_compare`` is also its CPU rehearsal);
27. ``hier_refit``: ``nv.HierarchicalNVFit`` over a 4 x 4 scan grid (16
    pixels, d = 100, block proposals), W = 4096, from the pixels' own
    guesses: 6000 rwm steps at T = 10, then 300 chees; gates each pixel's
    mu1 and field offset and the pooled linewidth's population mean; then
    ``kfold(k=4)``, ``reloo`` of the highest Pareto k and ``logo()`` on
    it, each the joint posterior refit as K groups of one walker (plain):
    every refit through its collapse gate, every elpd finite, kfold within
    a stated number of nats of reloo, no kernel launch; reports each
    verb's seconds, a profiled 20-step mala chunk of reloo's refit and its
    posterior in float32 against float64.  The fit and each verb run in
    processes of their own (``hier_worker``), started before
    ``batched_nv`` and overlapping it (all are host-paced), the fit handed
    from one to the others by ``checkpoint.hierarchical_save`` (``hier_refit_fit`` and
    ``hier_refit_cv`` are also its CPU witness's,
    ``tests/hier_refit_witness.py``);
28. ``hier_sbc``: ``sbc_check_hierarchical`` at JAX
    tests/test_sbc_hierarchical.py's settings and its Cauchy control (each
    in a worker process, as ``hier_refit``'s jobs), with that file's gates;
    then the ``checkpoint`` step: a flagship walker
    saved on the card mid-run, reloaded and run on (kernel 1, then one
    chunk of kernel 2) beside the walker it came from, bit for bit equal,
    and the ``hier_refit`` fit through ``hierarchical_save`` /
    ``hierarchical_load`` with its log posterior bit for bit equal;
29. prints the ``kernels`` summary line (each kernel's time, launches on
    its path, bound at the published peaks, op-mix bound at the measured
    float32 ceilings, plain and library times; kernel 1 also at half
    width, with its launches on the ensemble journeys, at the rescue's
    W/2, with its launches on the gradient journeys, with the named
    prior, with its launches on the named-prior journey, the line twin
    with its launches on the evidence journeys, and the line twin at the
    nested refills' W = 32768 with its launches there, the line twin at
    the VI evaluation draws' W = 2048 with its launches on the line's VI
    path, and over the pooled fit's 8 terms with its launches on the
    pooling phase; kernel 2 with the
    named prior, with its launches on its chunk-kernel journey, and at an
    SMC stage's temperature, with its launches on the SMC journey; kernel
    1's rows with the kernel-only ms and the plan), the card line and,
    last, ``{"ok": true, "device": {...}}``.

Each phase prints one JSON line.  Any failed check raises, and the script
exits non-zero without the last line; it also refuses to run without a
CUDA device.  The data is synthetic, made from a seed: the flagship model
at the reference's printed parameters with scale x10 (at the printed scale
the resonance is worth 1.5 log-units under sigma = 1e-7 and x0 is not
identified) plus 1e-7 Gaussian noise; the global fit's and the NV
spectra's from ``lisp_mcmc_torch.synthetic``.  Everything printed is also
written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
# Steps of the global journeys (the flagship's 30000 on the default path;
# the chunk path costs a second per 10000 steps) and of each NV spectrum.
# The NV fits run the whole schedule (auto=None, as the flagship journeys
# do): with the prob-settle stop, one spectrum entered the 2000-step cold
# finish right after a x0.1 rescale and ended at acceptance 0.48.
N_GLOBAL = 30000
N_GLOBAL_CHUNK = 30000
N_NV = 40000
# Spectra of the sequential NV journey: the first of the three since the
# pooling phase took its share of the script's time (the three took 135.4
# to 171.3 s; at 20000 steps a spectrum the second ended at acceptance
# 0.484, outside the gate).  nv_chunk still fits all three.
NV_FILE_SPECTRA = 1
# The NV gates, fixed before the first chip run: mu1 and mu2 of the best
# point, and the field offset, within 0.5 MHz of the generating values
# (the dips are 20x the noise), acceptance in 0.2-0.4.
NV_TOL_MHZ = 0.5
# Points per dataset of the tiled chunk check: more than one 512-point
# tile, so the chunk kernel stages the data tile by tile every step.
N_TILED = 1500
RTOL = {"float32": 1e-4, "float64": 1e-9}   # a fused kernel against its plain version
OUT = {"phases": []}
T_START = time.perf_counter()     # each emitted line carries its time since this


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    obj["at_s"] = time.perf_counter() - T_START
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
    """Build every kernel library, one nvcc each, all at once; returns
    each library's ptxas table (registers, stack, spills per kernel)."""
    from lisp_mcmc_torch.device import KERNEL_SOURCES, build_all, build_log, ptxas_table

    t0 = time.perf_counter()
    logs = build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: ptxas_table(build_log(name)) for name in KERNEL_SOURCES}
    emit({"phase": "build", "seconds": secs, "built": sorted(logs), "ptxas": ptxas})
    return ptxas


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


# Kernel 1's point loop by the shared loads it issues (cuobjdump), for the
# flagship's twin class (lorder_mixed_bg, 0) at every R in both types.
KERNEL1_SASS = {(t, r): f"_ZN3lmt22fused_posterior_kernelI{t}Li{r}ELi0EE"
                for t in "fd" for r in (1, 2, 4)}


def _start_kernel1_sass(out_file):
    """Start ``cuobjdump -sass`` of kernel 1's lorder_mixed_bg kernels
    (``-fun``: the whole library's SASS took ~40 s to dump), writing to
    ``out_file``; returns the process, or None without cuobjdump.  It runs
    beside the next phases (its ~28 s are host work the GPU phases do not
    wait on); :func:`phase_kernel1_sass` reads it."""
    import shutil
    from lisp_mcmc_torch.device import _target

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    names = ",".join(f"{prefix}EvNS_9FusedArgsIT_EE" for prefix in KERNEL1_SASS.values())
    return subprocess.Popen([tool, "-sass", "-fun", names, str(_target("fused_posterior"))],
                            stdout=out_file, stderr=subprocess.DEVNULL)


def _sass_kernel1_loads(sass):
    """``{"f32_R1": {instruction: count}, ...}``: the shared (LDS*),
    generic (LD.*) and async-copy (LDGSTS*) loads of kernel 1's
    lorder_mixed_bg kernels in the SASS text ``sass``.  Every LDS is a
    load of the point loop (the staging is cp.async, the walkers' rows and
    the prior's tables are global loads)."""
    import re

    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        for (t, r), prefix in KERNEL1_SASS.items():
            if name.startswith(prefix):
                c = {}
                for ins in re.findall(r"\b(LDS(?:\.[A-Z0-9.]+)?|LD(?:\.[A-Z0-9.]+)?|"
                                      r"LDGSTS(?:\.[A-Z0-9.]+)?)\s", block):
                    c[ins] = c.get(ins, 0) + 1
                counts[f"{'f32' if t == 'f' else 'f64'}_R{r}"] = c
    return counts


def phase_kernel1_sass(proc, out_file):
    """Kernel 1's shared loads in SASS, by width: the float32 point loop
    must read its packed records with 128-bit LDS.  ``proc`` and
    ``out_file`` are :func:`_start_kernel1_sass`'s (None: no cuobjdump)."""
    counts = None
    if proc is not None:
        check(proc.wait() == 0, f"kernel 1 SASS: cuobjdump exited {proc.returncode}")
        out_file.seek(0)
        counts = _sass_kernel1_loads(out_file.read().decode())
        check(len(counts) == len(KERNEL1_SASS), f"kernel 1 SASS: found {sorted(counts)}")
        for r in (1, 2, 4):
            check(counts[f"f32_R{r}"].get("LDS.128", 0) > 0,
                  f"kernel 1 f32 R={r}: no 128-bit shared load ({counts[f'f32_R{r}']})")
    emit({"phase": "kernel1_sass", "loads": counts})


def _kernel1(pos, post, ptxas, reps=50):
    """Kernel 1 at ``pos``: the plan it launches with (the registers and
    spills of that kernel; none may spill), the wrapper's ms (CUDA events
    around back-to-back calls) and the kernel's own ms (torch.profiler)."""
    from lisp_mcmc_torch.device import kernel_time_ms
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_kernel_entry, fused_plan,
                                                   fused_posterior)

    plan = fused_plan(post, pos.shape[0])
    entry = fused_kernel_entry(ptxas["fused_posterior"], post.dtype, plan)
    check(entry is not None, f"kernel 1: no ptxas entry for the plan {plan}")
    check(entry["spill_stores"] == 0 and entry["spill_loads"] == 0,
          f"kernel 1: the plan's kernel spills ({plan}, {entry})")

    def fn():
        return fused_posterior(pos, post)

    kernel_ms = kernel_time_ms(fn, reps, "fused_posterior")
    check(kernel_ms is not None, "kernel 1: torch.profiler recorded no fused_posterior kernel")
    keep = ("threads", "R", "S", "blocks", "blocks_per_sm", "waves", "twin_class")
    return {"plan": {**{k: plan[k] for k in keep}, "registers": entry["registers"],
                     "spill_stores": entry["spill_stores"]},
            "ms": cuda_time_ms(fn, reps), "kernel_ms": kernel_ms}


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


def phase_fused(ceilings, ptxas):
    """Kernel 1 against its plain version at the flagship's shape; each
    launch's plan, wrapper ms and kernel-only ms."""
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior,
                                                   fused_posterior_plain,
                                                   posterior_census,
                                                   prepare_fused_terms)
    from lisp_mcmc_torch.roofline import FLAGSHIP, N_POINTS

    bounds = mfit.make_bounds_prior({"linewidth": (1.0, 500.0),
                                     "x0": (2700.0, 2900.0), "mix": (0.0, 6.3)})
    results = {}
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
        for prior_name, prior in (("flat", None), ("bounds", bounds)):
            w = _flagship_walker(W_FLAGSHIP, dtype, DEVICE, log_prior=prior,
                                 params=FLAGSHIP, jitter=0.02)
            post = prepare_fused_terms(w.terms, w.spec, dtype)
            check(post is not None, "flagship fit outside the kernel's coverage")
            # near the peak (where f32 cancellation bites) and the far start
            pos = torch.cat([w.state.position[: W_FLAGSHIP // 2],
                             _flagship_walker(W_FLAGSHIP // 2, dtype, DEVICE).state.position])
            pos = pos.contiguous()
            got = fused_posterior(pos, post)
            ref = fused_posterior_plain(pos, post)
            torch.cuda.synchronize()
            check(got.shape == (W_FLAGSHIP,) and bool(torch.isfinite(got).all()),
                  "fused posterior: non-finite or misshapen output")
            err = (got - ref).abs()
            rel = float((err / ref.abs().clamp_min(1.0)).max())
            check(rel <= rtol, f"fused posterior {dtype} {prior_name}: max "
                  f"relative error {rel} > {rtol}")
            n_out = int((prior(w.spec.unflatten(pos)) < 0).sum()) if prior else 0
            plain_ms = cuda_time_ms(lambda: fused_posterior_plain(pos, post), 5)
            key = f"{str(dtype).split('.')[-1]}_{prior_name}"
            if key == "float32_flat":
                main_post = post
            results[key] = {"max_rel_err": rel, "rtol": rtol,
                            "max_abs_err": float(err.max()), **_kernel1(pos, post, ptxas),
                            "plain_ms": plain_ms, "walkers_far_out": n_out}
    emit({"phase": "fused_posterior", "W": W_FLAGSHIP, "d": 6, "N": N_POINTS,
          "results": results})
    main = results["float32_flat"]
    return {"name": "fused_posterior", "route": "cuda",
            "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
            "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117",
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "kernel_ms": main["kernel_ms"], "plan": main["plan"],
            "plain_ms": main["plain_ms"],
            **_bounds(posterior_census(main_post), 1,
                      fused_bytes(main_post, W_FLAGSHIP), ceilings),
            "library_ms": None}


def _bounds(census, steps, nbytes, ceilings, walkers=W_FLAGSHIP):
    """The published-peak bound and the op-mix bound (measured float32
    ceilings) of ``steps`` evaluations at W = ``walkers`` of a float32
    kernel; ``census`` is a posterior's (``posterior_census``: every point
    summed already)."""
    import torch
    from lisp_mcmc_torch.ops.loglik_kernel import class_rates, opmix_bound_ms
    from lisp_mcmc_torch.roofline import peak_bound

    return {**peak_bound(census, walkers, 1, steps, nbytes, torch.float32),
            "opmix_bound_ms": opmix_bound_ms(census, walkers, 1, steps,
                                             class_rates(ceilings))}


# The chunk kernel's accepted-move moments against its plain version's,
# entry by entry relative to sqrt(m_ii m_jj) (m_sum: sqrt(m_ii), after
# taking out the end-position difference of the walkers that disagree).
# Only the walkers that disagree (<= 1 %, in practice 0.1 %) take other
# steps; with a diagonal L they moved the moments by 2e-5 at most (NVIDIA
# H100 80GB HBM3, 700 W).  With synthetic.dense_l the off-diagonal entries
# are signal, of a median size above 10x this tolerance (checked), so a
# misplaced or dropped entry fails.
MOMENT_RTOL = 5e-3
# Of the walkers that agree, the share whose best point matches the plain
# version's at rtol 1e-4: a new logprob within rounding of the walker's
# best can flip the best-tracking test (0.99978-0.99996 at the five chunk
# checks, NVIDIA H100 80GB HBM3, 700 W).  Every walker's best point is
# also held to its own best logprob (the plain posterior there, RTOL
# float32), which a stale or misplaced best point fails.
BEST_AGREEMENT = 0.999
# The per-step trace (max, mean and min over all walkers) against the plain
# version's, by posterior_rel_err: the walkers that disagree move it (by
# 8e-8 to 4.5e-7 at the five chunk checks, same card).
TRACE_RTOL = 1e-4
# The trace's last step against the max, mean and min of the kernel's own
# final logprob: max and min exactly, the mean to float32 summation.
TRACE_LAST_RTOL = 1e-5


def _chunk_check(ck, state, L, what, dense_l=True, temp=0.0):
    """One 200-step chunk of the kernel against its plain version from the
    same state, L (dense: ``synthetic.dense_l``) and seed at anneal step
    1000 (``temp`` > 0: at that temperature, the override an SMC stage
    gives); returns the measurements (``chunk_kernel.chunk_diff``).

    A walker agrees when its accept count and its final position match
    (rtol 1e-4): one near-tie flip, from a 1-ulp difference of logf/cosf,
    sends a walker down another path, and at W = 131072 a few such paths
    end with equal counts but other positions.  At least 99 % must agree,
    and on those the logprob and best logprob are held to the fused
    kernel's RTOL float32 (``posterior_rel_err``) and the best point to
    :data:`BEST_AGREEMENT`.  A kernel that read L transposed would propose
    other steps everywhere.  Every walker's best point must give its best
    logprob, which is no lower than its logprob.  The moments are held to
    :data:`MOMENT_RTOL`, the trace to :data:`TRACE_RTOL` and
    :data:`TRACE_LAST_RTOL`.  ``dense_l`` False (a block-diagonal L) drops
    the check that the off-diagonal moments are large enough to see: the
    cross-block ones are near 0 by design.
    """
    import torch
    from lisp_mcmc_torch.ops.chunk_kernel import chunk_diff, chunk_rwm, chunk_rwm_plain

    seed = torch.tensor([20240607], dtype=torch.int32, device=DEVICE)
    args = (state.position, state.logprob, state.best_position, state.best_logprob,
            L, 1000, temp, seed)
    got = chunk_rwm(ck, *args)
    ref = chunk_rwm_plain(ck, *args)
    torch.cuda.synchronize()
    diff = chunk_diff(got, ref, ck.post)
    rate = float(got["accept_counts"].mean()) / ck.chunk
    rtol = RTOL["float32"]
    check(diff["walker_agreement"] >= 0.99,
          f"{what}: {diff['walker_agreement']} of walkers agree in accept count and "
          "position (rtol 1e-4); need >= 0.99")
    check(0.05 < rate < 0.95, f"{what}: uninformative acceptance {rate}")
    check(float(got["m_count"]) == float(got["accept_counts"].sum()),
          f"{what}: m_count != sum of accept counts")
    check(bool(torch.isfinite(got["logprob"]).all()), f"{what}: non-finite logprob")
    for k in ("logprob_rel_err", "best_logprob_rel_err", "best_self_rel_err"):
        check(diff[k] <= rtol, f"{what}: {k} {diff[k]} > {rtol}")
    check(diff["best_below"] == 0,
          f"{what}: {diff['best_below']} walkers' best logprob is below their logprob")
    check(diff["best_agreement"] >= BEST_AGREEMENT,
          f"{what}: {diff['best_agreement']} of the agreeing walkers' best points "
          f"match (rtol 1e-4); need >= {BEST_AGREEMENT}")
    signal = diff["moments_offdiag_median"]
    check(not dense_l or signal >= 10 * MOMENT_RTOL, f"{what}: off-diagonal moments of median {signal} "
          f"of sqrt(m_ii m_jj), too small for the {MOMENT_RTOL} check to see them")
    for k in ("msum_err", "mouter_err"):
        check(diff[k] <= MOMENT_RTOL, f"{what}: moments {k} {diff[k]} > {MOMENT_RTOL}")
    check(diff["trace_rel_err"] <= TRACE_RTOL,
          f"{what}: trace {diff['trace_rel_err']} from the plain version's > {TRACE_RTOL}")
    check(diff["trace_last_err"] <= TRACE_LAST_RTOL,
          f"{what}: the trace's last step is {diff['trace_last_err']} from the final "
          f"logprob's max, mean and min (> {TRACE_LAST_RTOL})")
    ms = cuda_time_ms(lambda: chunk_rwm(ck, *args), 5)
    plain_ms = cuda_time_ms(lambda: chunk_rwm_plain(ck, *args), 1)
    return {"W": int(state.position.shape[0]), "d": ck.d, "chunk": ck.chunk,
            "accept_rate": rate, **diff, "ms": ms, "plain_ms": plain_ms}


def _chunk_launch(ck, ptxas):
    """How the chunk kernel launches at W = 131072: block size, blocks per
    SM (the card's residency for it), waves, and the registers, stack and
    spills of the block size's instantiation."""
    from lisp_mcmc_torch.ops.chunk_kernel import chunk_plan

    plan = chunk_plan(ck, W_FLAGSHIP)
    regs = [v for k, v in ptxas["chunk_rwm"].items()
            if f"chunk_rwm_kernelILi{plan['threads']}E" in k]
    check(len(regs) == 1, f"chunk kernel: no ptxas entry for {plan['threads']} threads")
    return {**plan, **regs[0]}


def phase_chunk(ceilings, ptxas):
    """Kernel 2 against its plain version: one chunk at W = 131072."""
    import numpy as np
    import torch
    from lisp_mcmc_torch.ops.chunk_kernel import (build_chunk_kernel, chunk_bytes,
                                                  chunk_census)
    from lisp_mcmc_torch.ops.loglik_kernel import posterior_census
    from lisp_mcmc_torch.roofline import FLAGSHIP
    from lisp_mcmc_torch.synthetic import dense_l

    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, params=FLAGSHIP,
                         jitter=1e-3)
    ck = build_chunk_kernel(w.terms, w.spec, w.config, W_FLAGSHIP, torch.float32)
    check(ck is not None, "flagship chunk outside the kernel's scope")
    L = dense_l(3e-3 * np.asarray(list(FLAGSHIP.values()))).to(DEVICE)
    res = _chunk_check(ck, w.state, L, "chunk")
    launch = _chunk_launch(ck, ptxas)
    emit({"phase": "chunk_rwm", **res, "launch": launch})
    census = chunk_census(posterior_census(ck.post), ck.d)
    return {"name": "chunk_rwm", "route": "cuda",
            "source": "lisp_mcmc_torch/csrc/chunk_rwm.cu",
            "replaces": "lisp_mcmc_tpu/ops/chunk_pallas.py:95",
            "max_abs_err": res["logprob_max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            **_bounds(census, ck.chunk, chunk_bytes(ck.post, W_FLAGSHIP, ck.chunk),
                      ceilings),
            "library_ms": None, "registers": launch["registers"],
            "threads": launch["threads"], "blocks_per_sm": launch["blocks_per_sm"],
            "waves": launch["waves"]}


_KINDS = ("normal", "normal_cutoff", "poisson")


def _fused_check(post, pos, rtol, what):
    """The fused kernel against its plain version at ``pos``: the largest
    error relative to max(|plain|, |plain - scalar constant|, 1)
    (``posterior_rel_err``: the constant can cancel the misfit to a sum
    near 0)."""
    import torch
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_posterior, fused_posterior_plain,
                                                   posterior_rel_err)

    got = fused_posterior(pos, post)
    ref = fused_posterior_plain(pos, post)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"{what}: non-finite or misshapen output")
    rel = posterior_rel_err(got, ref, post)
    check(rel <= rtol, f"{what}: max relative error {rel} > {rtol}")
    return rel, float((got - ref).abs().max())


def phase_twins(ceilings, ptxas):
    """Every twin, with and without its optional parameters, every kind it
    takes, both types, at W = 131072 and N = 334; times each in float32.

    The Poisson kind fits counts of the model (y rounded).  The check is
    ``posterior_rel_err``, which is not fooled by a log-normalisation
    that cancels the misfit.
    """
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import synthetic
    from lisp_mcmc_torch.models import DEVICE_MODELS
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior,
                                                   fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)
    from lisp_mcmc_torch.roofline import N_POINTS

    likelihoods = dict(zip(_KINDS, (mfit.log_likelihood_normal,
                                    mfit.log_likelihood_normal_cutoff,
                                    mfit.log_likelihood_poisson)))
    results, checked = {}, 0
    for model in sorted(DEVICE_MODELS, key=lambda f: f.__name__):
        row = {}
        for optional in (True, False):
            for kind in synthetic.twin_case(model, optional, N_POINTS)[3]:
                x, yk, params, _ = synthetic.twin_case(model, optional, N_POINTS)
                if kind == "poisson":
                    yk = np.round(np.abs(yk))
                for dtype in (torch.float32, torch.float64):
                    dname = str(dtype).split(".")[-1]
                    w = mfit.walker_create(
                        function=model, data=(x, yk), params=params,
                        data_error=0.01 * np.abs(yk).max(),
                        log_likelihood=likelihoods[kind], n_walkers=W_FLAGSHIP,
                        walker_jitter=0.02, dtype=dtype, device=DEVICE)
                    post = prepare_fused_terms(w.terms, w.spec, dtype)
                    check(post is not None, f"{model.__name__}: outside the coverage")
                    what = f"twin {model.__name__} {kind} {dname} optional={optional}"
                    rel, _ = _fused_check(post, w.state.position, RTOL[dname], what)
                    checked += 1
                    row[f"{kind}_{dname}_{'all' if optional else 'required'}"] = rel
                    if optional and kind == "normal" and dtype == torch.float32:
                        pos = w.state.position
                        row.update(_kernel1(pos, post, ptxas, 20))
                        row["plain_ms"] = cuda_time_ms(
                            lambda: fused_posterior_plain(pos, post), 3)
                        row.update(_bounds(posterior_census(post), 1,
                                           fused_bytes(post, W_FLAGSHIP), ceilings))
        results[model.__name__] = row
    emit({"phase": "twins", "W": W_FLAGSHIP, "N": N_POINTS, "checked": checked,
          "rtol": RTOL, "results": results})


def _global_walker(g, params, n_walkers, dtype, jitter, config=None):
    import lisp_mcmc_torch as mfit

    return mfit.walker_create(function=g["functions"], data=g["data"], params=params,
                              data_error=1e-7, n_walkers=n_walkers, seed=0,
                              walker_jitter=jitter, config=config, dtype=dtype,
                              device=DEVICE)


def phase_global(ceilings, counters, ptxas):
    """test.lisp:52-78's global fit: both kernels against their plain
    versions, then the journey on both paths."""
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import synthetic
    from lisp_mcmc_torch.ops.chunk_kernel import (build_chunk_kernel, chunk_bytes,
                                                  chunk_census)
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior,
                                                   fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)

    g = synthetic.global_fit(2)
    out = {"phase": "global", "W": W_FLAGSHIP, "d": len(g["truth"]),
           "terms": len(g["functions"])}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        near = _global_walker(g, g["truth"], W_FLAGSHIP // 2, dtype, 0.02)
        far = _global_walker(g, g["start"], W_FLAGSHIP // 2, dtype, 0.05)
        pos = torch.cat([near.state.position, far.state.position]).contiguous()
        post = prepare_fused_terms(near.terms, near.spec, dtype)
        check(post is not None and len(post.terms) == 2,
              "global: the fit is outside the fused kernel's coverage")
        rel, abs_err = _fused_check(post, pos, RTOL[dname], f"global fused {dname}")
        out[f"fused_{dname}"] = {"max_rel_err": rel, "max_abs_err": abs_err}
        if dtype == torch.float32:
            out["fused"] = _kernel1(pos, post, ptxas)
            out["fused_ms"] = out["fused"]["ms"]
            out["fused_plain_ms"] = cuda_time_ms(lambda: fused_posterior_plain(pos, post), 5)
            out["fused_bounds"] = _bounds(posterior_census(post), 1,
                                          fused_bytes(post, W_FLAGSHIP), ceilings)
    w = _global_walker(g, g["truth"], W_FLAGSHIP, torch.float32, 1e-3)
    ck = build_chunk_kernel(w.terms, w.spec, w.config, W_FLAGSHIP, torch.float32)
    check(ck is not None, "global: outside the chunk kernel's scope")
    L = synthetic.dense_l(3e-3 * np.asarray(list(g["truth"].values()))).to(DEVICE)
    out["chunk"] = {**_chunk_check(ck, w.state, L, "global chunk d=9"),
                    "launch": _chunk_launch(ck, ptxas)}
    # the plan that ran (chunk_plan, kept on ck): the data stayed resident
    check(out["chunk"]["launch"]["resident"] == 1, "global: the data was not resident")
    out["chunk_bounds"] = _bounds(chunk_census(posterior_census(ck.post), ck.d), ck.chunk,
                                  chunk_bytes(ck.post, W_FLAGSHIP, ck.chunk), ceilings)
    # the tiled path: 1500 points are more than one tile
    gt = synthetic.global_fit(2, n_points=N_TILED)
    wt = _global_walker(gt, gt["truth"], W_FLAGSHIP, torch.float32, 1e-3)
    ckt = build_chunk_kernel(wt.terms, wt.spec, wt.config, W_FLAGSHIP, torch.float32)
    out["chunk_tiled"] = {"points": N_TILED,
                          **_chunk_check(ckt, wt.state, L, "global chunk d=9 tiled"),
                          "launch": _chunk_launch(ckt, ptxas),
                          **_bounds(chunk_census(posterior_census(ckt.post), ckt.d),
                                    ckt.chunk, chunk_bytes(ckt.post, W_FLAGSHIP, ckt.chunk),
                                    ceilings)}
    check(out["chunk_tiled"]["launch"]["resident"] == 0,
          "global tiled: the data was resident")
    lp_gen = float(_global_walker(g, g["truth"], 1, torch.float64, 0.0).state.logprob[0])

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = mfit.mcmc_fit(function=g["functions"], data=g["data"], params=g["start"],
                      data_error=1e-7, n_steps=N_GLOBAL, n_walkers=W_FLAGSHIP, seed=0,
                      walker_jitter=0.05, config=mfit.FitConfig(auto=None), device=DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    check(launches["fused_posterior"] > 0, "global journey: the fused kernel never launched")
    out["journey_default"] = {"steps": N_GLOBAL, "seconds": secs,
                              "chain_steps_per_sec": W_FLAGSHIP * N_GLOBAL / secs,
                              "launches": launches,
                              **_global_report(w, g, lp_gen, "global journey")}
    global_walker = w

    w = _global_walker(g, g["start"], W_FLAGSHIP, torch.float32, 0.05,
                       config=mfit.FitConfig(posterior_impl="chunk_kernel"))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.adaptive_steps(N_GLOBAL_CHUNK, temperature=10.0, auto=None, collect_history=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    check(launches["chunk_rwm"] > 0, "global chunk journey: the chunk kernel never launched")
    out["journey_chunk_kernel"] = {"steps": N_GLOBAL_CHUNK, "seconds": secs,
                                   "chain_steps_per_sec": W_FLAGSHIP * N_GLOBAL_CHUNK / secs,
                                   "launches": launches,
                                   **_global_report(w, g, lp_gen, "global chunk journey")}
    emit(out)
    return global_walker, lp_gen


def phase_chunk_wide(ceilings, ptxas):
    """The chunk kernel on a five-dataset global fit, d = 18."""
    import numpy as np
    import torch
    from lisp_mcmc_torch import synthetic
    from lisp_mcmc_torch.ops.chunk_kernel import build_chunk_kernel, chunk_bytes, chunk_census
    from lisp_mcmc_torch.ops.loglik_kernel import posterior_census

    g = synthetic.global_fit(5)
    w = _global_walker(g, g["truth"], W_FLAGSHIP, torch.float32, 1e-3)
    ck = build_chunk_kernel(w.terms, w.spec, w.config, W_FLAGSHIP, torch.float32)
    check(ck is not None and ck.d == 18, "chunk_wide: not the d = 18 fit")
    L = synthetic.dense_l(3e-3 * np.asarray(list(g["truth"].values()))).to(DEVICE)
    res = _chunk_check(ck, w.state, L, "chunk_wide d=18")
    emit({"phase": "chunk_wide", "terms": len(g["functions"]), **res,
          "launch": _chunk_launch(ck, ptxas),
          **_bounds(chunk_census(posterior_census(ck.post), ck.d), ck.chunk,
                    chunk_bytes(ck.post, W_FLAGSHIP, ck.chunk), ceilings)})


def phase_nv(ceilings, counters, ptxas):
    """The NV pipeline: fit_nv_file on a file of NV_FILE_SPECTRA synthetic
    spectra, one after another, the prior's bounds and declared constraints
    inside the fused kernel; times the fused kernel on the first
    spectrum's ensemble."""
    import tempfile
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import nv, synthetic
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior,
                                                   fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)

    with tempfile.TemporaryDirectory() as tmp:
        path = synthetic.write_nv_file(os.path.join(tmp, "nv-spectra.txt"),
                                       n_spectra=NV_FILE_SPECTRA)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walkers = nv.fit_nv_file(path, n_steps=N_NV, n_walkers=W_FLAGSHIP, device=DEVICE,
                                 config=mfit.FitConfig(auto=None))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    check(len(walkers) == NV_FILE_SPECTRA, "nv: wrong number of spectra")
    check(launches["fused_posterior"] > 0, "nv: the fused kernel never launched")
    spectra = []
    for i, (w, truth) in enumerate(zip(walkers, synthetic.NV_SPECTRA)):
        post = prepare_fused_terms(w.terms, w.spec, w.dtype)
        check("_fused" in w._runner_cache and post is not None and post.rest == ()
              and len(post.constraints) == 3,
              f"nv {i}: not the fused path with the constraints inside the kernel")
        # a walker that breaks mu1 < mu2 gets the -1e9 penalties on the kernel
        # path as on the plain one
        pos = w.state.position.clone()
        mu1, mu2 = w.spec.index("mu1"), w.spec.index("mu2")
        pos[::2, [mu1, mu2]] = pos[::2, [mu2, mu1]]
        rel, _ = _fused_check(post, pos, RTOL["float32"], f"nv {i} constraints")
        spectra.append({**_nv_report(w, truth), "constraint_check_rel_err": rel})
        if i == 0:
            kernel1 = {**_kernel1(pos, post, ptxas),
                       "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(pos, post), 5),
                       **_bounds(posterior_census(post), 1, fused_bytes(post, W_FLAGSHIP),
                                 ceilings)}
    emit({"phase": "nv", "W": W_FLAGSHIP, "spectra": spectra, "seconds": secs,
          "chain_steps_per_sec": W_FLAGSHIP * sum(s["steps"] for s in spectra) / secs,
          "launches": launches, "tolerance_mhz": NV_TOL_MHZ, "fused_kernel": kernel1})
    _nv_gates(spectra, "nv")


def _nv_report(w, truth):
    """One NV fit's numbers against its generating parameters."""
    from lisp_mcmc_torch import nv

    lp, best = w.most_likely_step()
    return {"best_lp": lp, "mu1": best["mu1"], "mu2": best["mu2"],
            "truth_mu1": truth["mu1"], "truth_mu2": truth["mu2"],
            "field_offset": nv.walker_field_offset(w),
            "field_offset_truth": (truth["mu2"] - truth["mu1"]) / 2 / 2.8,
            "acceptance": w.acceptance(), "steps": w.age}


def _nv_gates(spectra, name):
    """mu1, mu2 and the field offset within NV_TOL_MHZ, acceptance 0.2-0.4."""
    for i, sp in enumerate(spectra):
        for k, want in (("mu1", "truth_mu1"), ("mu2", "truth_mu2"),
                        ("field_offset", "field_offset_truth")):
            check(abs(sp[k] - sp[want]) <= NV_TOL_MHZ,
                  f"{name} {i}: {k} {sp[k]} not within {NV_TOL_MHZ} of {sp[want]}")
        check(0.2 <= sp["acceptance"] <= 0.4,
              f"{name} {i}: final acceptance {sp['acceptance']} outside 0.2-0.4")


# The NV chunk check's proposal: about one posterior standard deviation of
# scale1, scale2, mu1, mu2, sigma and bg0 each (spectrum 2, noise 0.001).
NV_CHUNK_STEP = (1.3e-4, 1.3e-4, 0.1, 0.1, 0.1, 5e-5)


def phase_nv_chunk(ceilings, counters, ptxas):
    """The NV fit on the chunk kernel: the kernel against its plain version
    on spectrum 2 started at scale1 / scale2 = 1.08 (so proposals cross the
    0.9-1.1 window and must be refused), then the three spectra as a
    WalkerSet of nv_walker on posterior_impl="chunk_kernel"."""
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import nv, synthetic
    from lisp_mcmc_torch.models import double_lorentzian_bg
    from lisp_mcmc_torch.ops.chunk_kernel import (build_chunk_kernel, chunk_bytes,
                                                  chunk_census, chunk_rwm)
    from lisp_mcmc_torch.ops.loglik_kernel import posterior_census
    from lisp_mcmc_torch.walker_set import WalkerSet

    x, ys = synthetic.nv_spectra()
    start = {**synthetic.NV_SPECTRA[1], "scale1": 1.08 * synthetic.NV_SPECTRA[1]["scale2"]}
    w = mfit.walker_create(function=double_lorentzian_bg, data=(x, ys[1]), params=start,
                           data_error=nv.nv_data_std_dev(ys[1]),
                           log_prior=nv.make_nv_prior(ys[1]), n_walkers=W_FLAGSHIP,
                           seed=0, walker_jitter=2e-4, device=DEVICE)
    ck = build_chunk_kernel(w.terms, w.spec, w.config, W_FLAGSHIP, torch.float32)
    check(ck is not None and ck.post.rest == () and len(ck.post.constraints) == 3,
          "nv_chunk: the NV fit's constraints are not in the chunk kernel")
    L = synthetic.dense_l(NV_CHUNK_STEP).to(DEVICE)
    res = _chunk_check(ck, w.state, L, "nv chunk")
    # the kernel's walkers end inside the constraints, some at the edge
    st = w.state
    end = chunk_rwm(ck, st.position, st.logprob, st.best_position, st.best_logprob, L,
                    1000, 0.0, torch.tensor([20240607], dtype=torch.int32, device=DEVICE))
    cols = {k: end["position"][:, j] for j, k in enumerate(w.spec.keys)}
    broken = int((nv._nv_constraints(cols, None, None) != 0).sum())
    ratio_max = float((cols["scale1"] / cols["scale2"]).max())
    check(broken == 0, f"nv chunk: {broken} walkers end outside the constraints")
    check(ratio_max > 1.095, f"nv chunk: the walkers never neared the ratio's edge "
          f"({ratio_max})")
    out = {"phase": "nv_chunk", "W": W_FLAGSHIP,
           "check": {**res, "ratio_max": ratio_max, "launch": _chunk_launch(ck, ptxas),
                     **_bounds(chunk_census(posterior_census(ck.post), ck.d), ck.chunk,
                               chunk_bytes(ck.post, W_FLAGSHIP, ck.chunk), ceilings)}}

    cfg = mfit.FitConfig(posterior_impl="chunk_kernel", auto=None)
    walkers = WalkerSet(nv.nv_walker((x, y), n_walkers=W_FLAGSHIP, config=cfg,
                                     device=DEVICE) for y in ys)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walkers.adaptive_steps(N_NV, collect_history=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    check(launches["chunk_rwm"] > 0, "nv_chunk: the chunk kernel never launched")
    spectra = [_nv_report(w, truth) for w, truth in zip(walkers, synthetic.NV_SPECTRA)]
    out.update(spectra=spectra, seconds=secs, launches=launches, tolerance_mhz=NV_TOL_MHZ,
               chain_steps_per_sec=W_FLAGSHIP * sum(s["steps"] for s in spectra) / secs)
    emit(out)
    _nv_gates(spectra, "nv_chunk")


def _lp_generating():
    import torch
    from lisp_mcmc_torch.roofline import FLAGSHIP

    w = _flagship_walker(1, torch.float64, DEVICE, params=FLAGSHIP, jitter=0.0)
    return float(w.state.logprob[0])


def _quality(w, lp_gen, x0, name):
    """The journeys' gates: best lp >= lp(generating) - 5, x0 within 1 %,
    final acceptance in 0.2-0.4."""
    lp, best = w.most_likely_step()
    acc = w.acceptance()
    check(lp >= lp_gen - 5.0, f"{name}: best lp {lp} < lp(generating) {lp_gen} - 5")
    check(abs(best["x0"] - x0) <= 0.01 * x0,
          f"{name}: x0 {best['x0']} not within 1% of {x0}")
    check(0.2 <= acc <= 0.4, f"{name}: final acceptance {acc} outside 0.2-0.4")
    return lp, best, acc


def _global_report(w, g, lp_gen, name):
    lp, best, acc = _quality(w, lp_gen, g["truth"]["x0"], name)
    return {"best_lp": lp, "lp_generating": lp_gen, "acceptance": acc,
            "shared": {k: best[k] for k in ("linewidth", "x0", "mix")}, "best": best}


def phase_journey(counters):
    """The default path: fused kernel per step, history on; returns the
    launches and the walker (the criticism phase reads its fit)."""
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.roofline import FLAGSHIP

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
    lp, best, acc = _quality(w, lp_gen, FLAGSHIP["x0"], "journey")
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
    return launches, w


def phase_chunk_journey(counters):
    """The chunk-kernel path: one launch per non-history chunk."""
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.roofline import FLAGSHIP

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
    lp, best, acc = _quality(w, lp_gen, FLAGSHIP["x0"], "chunk journey")
    check(launches["chunk_rwm"] > 0, "chunk journey: the chunk kernel was never launched")
    emit({"phase": "journey_chunk_kernel", "W": W_FLAGSHIP, "steps": n_steps,
          "seconds": secs, "chain_steps_per_sec": W_FLAGSHIP * n_steps / secs,
          "best_lp": lp, "lp_generating": lp_gen, "x0": best["x0"],
          "acceptance": acc, "launches": launches})
    return launches


# The red-black samplers' half-ensembles: the flagship's W/2 walkers, and
# (tempering's layout) the low halves of G = 8 groups, flattened.
HALF_GROUPS = 8
HALF_TURNS = 3


def phase_half_width(ceilings, ptxas):
    """Kernel 1 at W/2: the ungrouped low half (a contiguous slice) and the
    low halves of 8 groups flattened (a copy), each against its plain
    version; the full and half launches timed in turns, with both bounds
    at each width, each width's plan and kernel-only ms."""
    import torch
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior,
                                                   fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)
    from lisp_mcmc_torch.roofline import FLAGSHIP

    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, params=FLAGSHIP, jitter=0.02)
    post = prepare_fused_terms(w.terms, w.spec, torch.float32)
    pos = w.state.position
    half_w = W_FLAGSHIP // 2
    shapes = {"full": pos, "half": pos[:half_w],
              "grouped_half": pos.reshape(HALF_GROUPS, -1, pos.shape[1])
              [:, : W_FLAGSHIP // HALF_GROUPS // 2].reshape(-1, pos.shape[1])}
    check(shapes["half"].is_contiguous() and shapes["grouped_half"].shape == (half_w, 6),
          "half_width: the halves are not (W/2, d) contiguous batches")
    out = {"phase": "half_width", "W": W_FLAGSHIP, "groups": HALF_GROUPS}
    census = posterior_census(post)
    for name, x in shapes.items():
        rel, abs_err = _fused_check(post, x, RTOL["float32"], f"half_width {name}")
        out[name] = {"W": int(x.shape[0]), "max_rel_err": rel, "max_abs_err": abs_err,
                     **_bounds(census, 1, fused_bytes(post, x.shape[0]), ceilings,
                               walkers=x.shape[0])}
    # HALF_TURNS rounds of turns full, half, grouped, grouped, half, full;
    # each shape's median turn (one turn of a round once read 40 % high)
    order = ("full", "half", "grouped_half")
    times = {k: [] for k in order}
    for _ in range(HALF_TURNS):
        for k in order + order[::-1]:
            x = shapes[k]
            times[k].append(cuda_time_ms(lambda: fused_posterior(x, post), 200))
    for k in order:
        one = _kernel1(shapes[k], post, ptxas, 200)
        out[k].update(plan=one["plan"], kernel_ms=one["kernel_ms"],
                      kernel_opmix_share=out[k]["opmix_bound_ms"] / one["kernel_ms"])
        out[k]["ms_turns"] = times[k]
        out[k]["ms"] = sorted(times[k])[len(times[k]) // 2]
        out[k]["opmix_share"] = out[k]["opmix_bound_ms"] / out[k]["ms"]
    x = shapes["half"]
    out["half"]["plain_ms"] = cuda_time_ms(lambda: fused_posterior_plain(x, post), 5)
    out["half_over_full"] = out["half"]["ms"] / out["full"]["ms"]
    emit(out)
    return out


# The tempered journey (README's second recipe): steps, rungs and the
# hottest rung's temperature, from the test.lisp start (x0 = 2200).
N_TEMPERED = 6000       # 10000 until the hierarchical phases took their share
TEMPERED_RUNGS, TEMPERED_T_MAX = 8, 50.0


def phase_tempered(ceilings, counters, ptxas):
    """``tempered_steps`` at W = 131072: kernel 1 once a step on the whole
    ensemble (8 rungs as adaptation groups), replica swaps at every chunk
    end; gates best lp and x0; times kernel 1 on the tempered ensemble
    (the wrapper, and the kernel alone with its plan)."""
    import torch
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior,
                                                   fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)
    from lisp_mcmc_torch.roofline import FLAGSHIP

    lp_gen = _lp_generating()
    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.tempered_steps(N_TEMPERED, rungs=TEMPERED_RUNGS, t_max=TEMPERED_T_MAX)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    lp, best = w.most_likely_step()
    rates = w.swap_rates()
    out = {"phase": "tempered", "W": W_FLAGSHIP, "steps": N_TEMPERED,
           "rungs": TEMPERED_RUNGS, "t_max": TEMPERED_T_MAX, "seconds": secs,
           "chain_steps_per_sec": W_FLAGSHIP * N_TEMPERED / secs, "best_lp": lp,
           "lp_generating": lp_gen, "x0": best["x0"], "launches": launches,
           "posterior_evals": w.posterior_evals,
           "swap_rates": {k: v.tolist() if hasattr(v, "tolist") else v
                          for k, v in rates.items()}}
    emit(out)
    check(lp >= lp_gen - 5.0, f"tempered: best lp {lp} < lp(generating) {lp_gen} - 5")
    check(abs(best["x0"] - FLAGSHIP["x0"]) <= 0.01 * FLAGSHIP["x0"],
          f"tempered: x0 {best['x0']} not within 1% of {FLAGSHIP['x0']}")
    # one evaluation a step, plus the fit's equivalence probe
    check(w.posterior_evals == N_TEMPERED and launches["fused_posterior"] == N_TEMPERED + 1,
          f"tempered: {launches['fused_posterior']} kernel-1 launches for "
          f"{N_TEMPERED} steps (+1 probe)")
    check(launches["chunk_rwm"] == 0, "tempered: the chunk kernel ran")
    post = prepare_fused_terms(w.terms, w.spec, torch.float32)
    pos = w.state.position
    rel, abs_err = _fused_check(post, pos, RTOL["float32"], "tempered ensemble")
    one = _kernel1(pos, post, ptxas, 100)
    kernel1 = {"max_rel_err": rel, "max_abs_err": abs_err,
               "kernel_ms": one["kernel_ms"], "plan": one["plan"],
               "ms": cuda_time_ms(lambda: fused_posterior(pos, post), 100),
               "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(pos, post), 5),
               **_bounds(posterior_census(post), 1, fused_bytes(post, W_FLAGSHIP), ceilings)}
    emit({"phase": "tempered_kernel1", **kernel1})
    return out


# The ensemble journeys: sampling_steps from the generating parameters
# (relative jitter 1e-3; the ensembles spread to the posterior in a few
# hundred steps), history kept (4096 walkers); the second half of each
# run is read as posterior samples.
# slice 500 steps (1000 before the variational phase took its share of the
# script's time limit; its x0 std was within 0.3 % of stretch's at 1000,
# and 0.4 % at 500; the gates are unchanged; at 250 its evaluations, 79 a
# step while the ensemble spreads, broke the 2 x 38 a step bound).
N_ENSEMBLE = {"stretch": 3000, "demc": 3000, "slice": 500}
ENSEMBLE_JITTER = 1e-3
# Gates, fixed before the first chip run.
ENSEMBLE_MIN_ACCEPT = 0.1      # stretch, demc
SLICE_MIN_LANDED = 0.95
ENSEMBLE_STD_FACTOR = 2.0      # each sampler's x0 std within 2x of the others'
# SLICE_POLL values timed against each other, in turns, on one chunk.
SLICE_POLLS = (0, 1, 4)
SLICE_POLL_STEPS = 20


def phase_ensemble(counters):
    """stretch, demc and slice via ``sampling_steps`` at W = 131072, kernel
    1 on each half-ensemble (W/2) twice a step (slice: once per
    expansion side and shrink iteration); gates best lp, x0, the sampled
    x0 median and spread, acceptance, and the launch counts."""
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.roofline import FLAGSHIP

    lp_gen = _lp_generating()
    x0 = FLAGSHIP["x0"]
    results, walkers = {}, {}
    for kind, n in N_ENSEMBLE.items():
        w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, params=FLAGSHIP,
                             jitter=ENSEMBLE_JITTER)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.sampling_steps(n, kernel=kind)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        lp, best = w.most_likely_step()
        pos, _ = w._history(n // 2)
        t1 = time.perf_counter()
        ess = mfit.ess_from_history(torch.as_tensor(pos, device=DEVICE), w.spec.keys)
        ess_secs = time.perf_counter() - t1
        xs = pos[:, :, w.spec.index("x0")].ravel()
        r = {"steps": n, "seconds": secs, "chain_steps_per_sec": W_FLAGSHIP * n / secs,
             "best_lp": lp, "lp_generating": lp_gen, "x0_best": best["x0"],
             "x0_median": float(np.median(xs)), "x0_std": float(xs.std()),
             "acceptance": w.acceptance(), "history": list(pos.shape), "ess": ess,
             "ess_seconds": ess_secs, "min_ess_per_sec": min(ess.values()) / secs,
             "launches": launches, "posterior_evals": w.posterior_evals,
             "kernel1_launches_per_step": (launches["fused_posterior"] - 1) / n}
        results[kind], walkers[kind] = r, w
        emit({"phase": f"ensemble_{kind}", "W": W_FLAGSHIP, **r})
        check(lp >= lp_gen - 5.0, f"{kind}: best lp {lp} < lp(generating) {lp_gen} - 5")
        check(abs(best["x0"] - x0) <= 0.01 * x0, f"{kind}: best x0 {best['x0']} not within 1%")
        check(abs(r["x0_median"] - x0) <= 0.01 * x0,
              f"{kind}: sampled x0 median {r['x0_median']} not within 1% of {x0}")
        # the equivalence probe, then every evaluation the runner made
        check(launches["fused_posterior"] == w.posterior_evals + 1,
              f"{kind}: {launches['fused_posterior']} kernel-1 launches, "
              f"{w.posterior_evals} evaluations + 1 probe")
        if kind == "slice":
            check(r["acceptance"] >= SLICE_MIN_LANDED,
                  f"slice: landed share {r['acceptance']} < {SLICE_MIN_LANDED}")
            check(2 * 3 * n <= w.posterior_evals <= 2 * 38 * n,
                  f"slice: {w.posterior_evals} evaluations for {n} steps")
        else:
            check(r["acceptance"] > ENSEMBLE_MIN_ACCEPT,
                  f"{kind}: acceptance {r['acceptance']} <= {ENSEMBLE_MIN_ACCEPT}")
            check(w.posterior_evals == 2 * n, f"{kind}: {w.posterior_evals} evaluations "
                  f"for {n} steps, want 2 a step")
    stds = [r["x0_std"] for r in results.values()]
    check(max(stds) <= ENSEMBLE_STD_FACTOR * min(stds),
          f"ensemble: x0 sample stds {stds} differ by more than {ENSEMBLE_STD_FACTOR}x")
    return results, walkers["slice"]


# The gradient journeys: an rwm warm-in from the ensemble journeys' start
# (its L adapted and refreshed, then its cold finish), then sampling_steps
# with mala, hmc and chees in turn on the same walkers, history kept.
N_GRADIENT_WARM = 4000
# hmc 200 steps (400 before the variational phase took its share of the
# script's time limit): one chunk, its gates reading the same quantities.
N_GRADIENT = {"mala": 2000, "hmc": 200, "chees": 400}
# Gates, fixed before the first chip run: acceptance inside the sampler's
# band (kernel.resolve_accept_band) widened by this on both sides; each
# x0 std within ENSEMBLE_STD_FACTOR of the ensemble journeys' geometric
# mean; kernel 1 against autograd on the rescued walkers within the fused
# kernel's float32 tolerance.
GRADIENT_BAND_SLACK = 0.1
# bench.py's ESS recipe (bench.py:288-313): history chunks timed at T = 1
# (mala 4 and chees 2 until the hierarchical phases took their share of
# the script's time; a readout, not a gate).
GRADIENT_ESS_CHUNKS = {"mala": 2, "chees": 1}
# Steps of the profiled chunks (the chees host sync): five keep the
# profiler's trace small (an hmc step is ~1100 kernels).
GRADIENT_PROFILE_STEPS = 5


def _device_ms(fn, reps):
    """Device time of one ``fn()`` by torch.profiler (every kernel it
    launches, summed) and its kernels a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    check(rows, "torch.profiler recorded no device time")
    return (sum(e.self_device_time_total for e in rows) / 1e3 / reps,
            sum(e.count for e in rows) / reps)


def _kernel_ess(w, kind, n_chunks):
    """bench.py's recipe: one warm history chunk at T = 1, then ``n_chunks``
    timed ones; min-ESS over their positions (on the device) per second."""
    import dataclasses
    import torch
    import lisp_mcmc_torch as mfit

    prev = w.config
    w.config = dataclasses.replace(w.config, kernel=kind)
    try:
        runner = w._runner(with_history=True)
        w.state, _ = runner(w.state, True, True, True, generator=w.generator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist, acc = [], []
        for _ in range(n_chunks):
            w.state, h = runner(w.state, True, True, True, generator=w.generator)
            hist.append(h["positions"])
            acc.append(h["accept_rate"])
        pos = torch.cat(hist)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        w.config = prev
    ess = mfit.ess_from_history(pos, w.spec.keys)
    return {"steps": n_chunks * w.config.chunk_size, "seconds": secs,
            "acceptance": float(torch.stack(acc).mean()),
            "min_ess": min(ess.values()), "ess_per_sec": min(ess.values()) / secs}, pos


def phase_gradient(ceilings, counters, ptxas, ensemble):
    """mala, hmc and chees via ``sampling_steps`` at W = 131072 after an
    rwm warm-in: values and gradients by autograd through the plain
    posterior (checked: no kernel-1 launch inside one), the rescue's two
    half-rounds a chunk on kernel 1 at W/2 (checked: the launches).  Gates
    best lp, x0, the sampled x0 median and spread, the acceptance and a
    finite state; reports ms a step and an ``eval_vg``, the chees host
    sync, peak memory, ``chees_trajectory``, kernel 1 against autograd on
    the rescued walkers and ESS/s.  Returns kernel 1's rescue row."""
    import dataclasses
    import numpy as np
    import torch
    from lisp_mcmc_torch.kernel import build_chunk_runner, make_eval_vg, resolve_accept_band
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)
    from lisp_mcmc_torch.roofline import FLAGSHIP

    fused = counters[0]
    lp_gen = _lp_generating()
    x0 = FLAGSHIP["x0"]
    ens_std = float(np.exp(np.mean([np.log(r["x0_std"]) for r in ensemble.values()])))
    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, params=FLAGSHIP,
                         jitter=ENSEMBLE_JITTER)
    t0 = time.perf_counter()
    w.adaptive_steps(N_GRADIENT_WARM, temperature=1.0, auto=None, collect_history=False)
    torch.cuda.synchronize()
    warm_secs = time.perf_counter() - t0
    real, inside, calls = w._log_post, [0], [0]

    def watched(x):
        before = fused.launches
        out = real(x)
        inside[0] += fused.launches - before
        calls[0] += 1
        return out

    w._log_post = watched
    eval_vg = make_eval_vg(real)
    results, rescue_launches = {}, 0
    for kind, n in N_GRADIENT.items():
        for c in counters:
            c.launches = 0
        probed = "_fused" in w._runner_cache
        evals0, vg0, calls[0] = w.posterior_evals, w.gradient_evals, 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.sampling_steps(n, kernel=kind)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {c.__name__: c.launches for c in counters}
        chunks = -(-n // w.config.chunk_size)
        n_vg = w.gradient_evals - vg0
        lp, best = w.most_likely_step()
        pos, _ = w._history(n // 2)
        xs = pos[:, :, w.spec.index("x0")].ravel()
        st = w.state
        finite = all(bool(torch.isfinite(getattr(st, k)).all()) for k in
                     ("position", "logprob", "best_position", "best_logprob", "l_matrix",
                      "chees"))
        # kernel 1 against autograd: the walkers whose stored logprob is
        # not autograd's were last moved by the rescue (kernel 1 at W/2)
        lp_ag = eval_vg(st.position)[0]
        moved = st.logprob != lp_ag
        gap = ((st.logprob - lp_ag).abs() / lp_ag.abs().clamp_min(1.0))
        r = {"steps": n, "seconds": secs, "ms_per_step": secs * 1e3 / n,
             "chain_steps_per_sec": W_FLAGSHIP * n / secs, "gradient_evals": n_vg,
             "gradient_evals_per_step": n_vg / n, "posterior_evals": w.posterior_evals - evals0,
             "ms_per_gradient_eval": secs * 1e3 / n_vg,
             "best_lp": lp, "lp_generating": lp_gen, "x0_best": best["x0"],
             "x0_median": float(np.median(xs)), "x0_std": float(xs.std()),
             "acceptance": w.acceptance(), "band": resolve_accept_band(
                 dataclasses.replace(w.config, kernel=kind)),
             "peak_memory_bytes": peak, "launches": launches,
             "fused_launches_inside_eval_vg": inside[0],
             "rescued_walkers": int(moved.sum()),
             "kernel1_vs_autograd_max_rel": float(gap[moved].max()) if bool(moved.any())
             else None}
        if kind == "chees":
            r["chees_trajectory"] = {k: v.tolist() if hasattr(v, "tolist") else v
                                     for k, v in w.chees_trajectory().items()}
        results[kind] = r
        emit({"phase": f"gradient_{kind}", "W": W_FLAGSHIP, **r})
        low, high = r["band"]
        check(finite, f"{kind}: non-finite state")
        check(lp >= lp_gen - 5.0, f"{kind}: best lp {lp} < lp(generating) {lp_gen} - 5")
        check(abs(best["x0"] - x0) <= 0.01 * x0, f"{kind}: best x0 {best['x0']} not within 1%")
        check(abs(r["x0_median"] - x0) <= 0.01 * x0,
              f"{kind}: sampled x0 median {r['x0_median']} not within 1% of {x0}")
        check(low - GRADIENT_BAND_SLACK <= r["acceptance"] <= high + GRADIENT_BAND_SLACK,
              f"{kind}: acceptance {r['acceptance']} outside its band {low}-{high} "
              f"widened by {GRADIENT_BAND_SLACK}")
        check(max(r["x0_std"], ens_std) <= ENSEMBLE_STD_FACTOR * min(r["x0_std"], ens_std),
              f"{kind}: x0 std {r['x0_std']} not within {ENSEMBLE_STD_FACTOR}x of the "
              f"ensemble journeys' {ens_std}")
        check(inside[0] == 0 and calls[0] == n_vg > 0,
              f"{kind}: {inside[0]} kernel-1 launches inside {calls[0]} gradient evaluations "
              f"(the gradients must come from the plain posterior)")
        check(r["posterior_evals"] == 2 * chunks
              and launches["fused_posterior"] == 2 * chunks + (0 if probed else 1),
              f"{kind}: {launches['fused_posterior']} kernel-1 launches, want the rescue's "
              f"2 a chunk x {chunks} chunks (+1 probe: {not probed})")
        check(r["kernel1_vs_autograd_max_rel"] is None
              or r["kernel1_vs_autograd_max_rel"] <= RTOL["float32"],
              f"{kind}: kernel 1's logprob {r['kernel1_vs_autograd_max_rel']} from autograd's")
        rescue_launches += 2 * chunks
    w._log_post = real
    # one eval_vg at the flagship's shape: the wrapper (CUDA events) and
    # its kernels (torch.profiler)
    pos = w.state.position
    vg_ms = cuda_time_ms(lambda: eval_vg(pos), 20)
    vg_device_ms, vg_kernels = _device_ms(lambda: eval_vg(pos), 5)
    # the chees step's host sync: a profiled chees chunk beside an hmc one
    prof = {}
    for kind in ("hmc", "chees"):
        cfg = dataclasses.replace(w.config, kernel=kind, chunk_size=GRADIENT_PROFILE_STEPS)
        run, _ = build_chunk_runner(w._batched_posterior(), w.ndim, cfg,
                                    eval_plain=w._log_post)
        prof[kind] = _profile_chunks(f"profile_{kind}_chunk", run, w.state, w.generator,
                                     args=(False, False, True), steps=GRADIENT_PROFILE_STEPS)
    ess = {k: _kernel_ess(w, k, c)[0] for k, c in GRADIENT_ESS_CHUNKS.items()}
    # What a chees step costs beyond its evaluations at hmc's price of one
    # (an upper bound on the cost of its host sync, which shares it with
    # the ChEES gradient's reductions); the host's time blocked in the
    # sync itself is the device's queue draining, not a cost.
    hmc_ms_per_eval = results["hmc"]["seconds"] * 1e3 / results["hmc"]["gradient_evals"]
    chees = results["chees"]
    emit({"phase": "gradient", "W": W_FLAGSHIP, "warm_in_steps": N_GRADIENT_WARM,
          "warm_in_seconds": warm_secs, "eval_vg_ms": vg_ms,
          "eval_vg_device_ms": vg_device_ms, "eval_vg_kernels": vg_kernels,
          "chees_overhead_ms_per_step": chees["ms_per_step"]
          - chees["gradient_evals_per_step"] * hmc_ms_per_eval,
          "chees_sync_host_blocked_ms_per_step": prof["chees"]["host_sync_ms"]
          / GRADIENT_PROFILE_STEPS,
          "device_busy_share": {k: p["device_busy_share"] for k, p in prof.items()},
          "ess": ess, "ess_per_sec_mala": ess["mala"]["ess_per_sec"],
          "ess_per_sec_chees": ess["chees"]["ess_per_sec"]})
    # kernel 1 at the rescue's shape: the W/2 proposals of a half-round
    post = prepare_fused_terms(w.terms, w.spec, torch.float32)
    half = w.state.position[: W_FLAGSHIP // 2]
    rel, abs_err = _fused_check(post, half, RTOL["float32"], "rescue half-round")
    one = _kernel1(half, post, ptxas, 200)
    return {"name": "fused_posterior_rescue", "route": "cuda",
            "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
            "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117",
            "launches": rescue_launches, "max_abs_err": abs_err, "ms": one["ms"],
            "kernel_ms": one["kernel_ms"], "plan": one["plan"],
            "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(half, post), 5),
            **_bounds(posterior_census(post), 1, fused_bytes(post, half.shape[0]),
                      ceilings, walkers=half.shape[0]),
            "library_ms": None}


def _gaussian_walker(cov, n_walkers, config=None, start=0.1, jitter=1.0):
    """A walker on a zero-mean Gaussian of covariance ``cov`` (a custom
    likelihood: the plain posterior, as bench.py's d = 24 row)."""
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit

    d = cov.shape[0]
    keys = tuple(f"p{i}" for i in range(d))
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32, device=DEVICE)

    def loglik(fn, params, dataset):
        v = torch.stack([params[k].reshape(-1) for k in keys], dim=1)
        return -0.5 * torch.sum((v @ prec) * v, dim=1)

    return mfit.walker_create(
        function=lambda x, p: torch.zeros_like(x), data=([0.0, 1.0], [0.0, 0.0]),
        params={k: start for k in keys}, log_likelihood=loglik, n_walkers=n_walkers,
        seed=0, walker_jitter=jitter, config=config, dtype=torch.float32, device=DEVICE)


# bench.py:327-370's correlated Gaussian: d = 24, W = 2048, 20 rwm chunks
# of warm-in, then chees: 2 chunks of adaptation, 1 warm and 2 timed
# history chunks, each of CHEES_D24_CHUNK steps (bench.py: 10 chunks of
# adaptation and 200-step chunks).  Cut for time: the trajectory reaches
# its 64-leapfrog cap within ~100 steps, and a step then costs ~87 ms on
# the host-bound W = 2048 path (an NVIDIA H100 80GB HBM3 at 700 W took
# 177 s for bench.py's 2000 adaptation steps).  Gate, fixed before the first chip run: every
# marginal variance of the timed chunks within 25 % of the target's.
CHEES_D24_VAR_RTOL = 0.25
CHEES_D24_CHUNK = 100


def phase_chees_d24():
    import dataclasses
    import numpy as np
    import torch

    d, W = 24, 2048
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    scales = np.geomspace(1.0, 300.0, d) ** 0.5
    cov = (q * scales ** 2) @ q.T
    w = _gaussian_walker(cov, W)
    run = w._runner(with_history=False)
    t0 = time.perf_counter()
    for _ in range(20):
        w.state, _ = run(w.state, True, True, True, generator=w.generator)
    # the chees chunks: _kernel_ess's warm chunk, then the timed one (two
    # more warm chunks until the hierarchical phases took their share of the
    # script's time: 11.9-19.5 s a chunk at 64 leapfrogs a step)
    w.config = dataclasses.replace(w.config, kernel="chees", chunk_size=CHEES_D24_CHUNK)
    torch.cuda.synchronize()
    warm_secs = time.perf_counter() - t0
    # one timed history chunk (two until the pooling phase took its share of
    # the script's time; the variances then read 1.6 % from the target's)
    res, pos = _kernel_ess(w, "chees", 1)
    var = pos.reshape(-1, d).var(dim=0).double().cpu().numpy()
    rel = np.abs(var / np.diag(cov) - 1.0)
    out = {"phase": "chees_d24", "d": d, "W": W, "warm_seconds": warm_secs, **res,
           "chees_trajectory": w.chees_trajectory()["leapfrog"].tolist(),
           "max_var_rel_err": float(rel.max())}
    emit(out)
    check(float(rel.max()) <= CHEES_D24_VAR_RTOL,
          f"chees_d24: marginal variances {rel.max()} from the target's (> "
          f"{CHEES_D24_VAR_RTOL})")
    return out


# Blocked proposals: a block-diagonal Gaussian of 2 hyper + 8 local blocks
# of 3 (d = 26), W = 4096, rwm (adaptive_steps) then mala (sampling_steps);
# then blocked rwm on the chunk kernel: the global fit of two datasets
# ordered [linewidth, x0, mix | scale, bg0, bg1 | scale2, bg02, bg12].
# Gates, fixed before the first chip run: L's cross-block entries exactly
# 0 and its in-block ones refreshed, the sampled variances within 25 % of
# the target's, and on the chunk kernel the journeys' best lp and x0 gates
# with the acceptance in rwm's band widened by 0.1.
BLOCKED = {"block_hyper": 2, "block_local": 3, "block_count": 8}
N_BLOCKED = {"rwm": 4000, "mala": 2000}
BLOCKED_VAR_RTOL = 0.25
BLOCKED_CHUNK = {"block_hyper": 3, "block_local": 3, "block_count": 2}
N_BLOCKED_CHUNK = 6000


def _block_mask(bh, bl, nb):
    import numpy as np

    d = bh + nb * bl
    m = np.zeros((d, d), bool)
    m[:bh, :bh] = True
    for s in range(nb):
        m[bh + s * bl:bh + (s + 1) * bl, bh + s * bl:bh + (s + 1) * bl] = True
    return m


def _check_blocks(L, mask, what):
    """Cross-block entries exactly 0; in-block off-diagonals refreshed."""
    import numpy as np

    L = L.detach().cpu().numpy()
    check(np.all(L[:, ~mask] == 0.0), f"{what}: L has non-zero cross-block entries")
    check(np.all(np.abs(np.tril(L, k=-1)).sum(axis=(1, 2)) > 0.0),
          f"{what}: L's blocks were never refreshed (no off-diagonal entries)")


def phase_blocked(counters):
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import synthetic
    from lisp_mcmc_torch.ops.chunk_kernel import build_chunk_kernel

    mask = _block_mask(BLOCKED["block_hyper"], BLOCKED["block_local"],
                       BLOCKED["block_count"])
    d = mask.shape[0]
    rng = np.random.default_rng(5)
    a = rng.standard_normal((d, d))
    sd = np.geomspace(0.5, 5.0, d)
    cov = np.where(mask, a @ a.T / d + np.eye(d), 0.0) * np.outer(sd, sd)
    w = _gaussian_walker(cov, 4096, config=mfit.FitConfig(**BLOCKED))
    out = {"phase": "blocked", "d": d, "W": 4096, "layout": BLOCKED}
    for kind, n in N_BLOCKED.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "rwm":
            w.adaptive_steps(n, temperature=1.0, auto=None)
        else:
            w.sampling_steps(n, kernel=kind)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        pos, _ = w._history(n // 2)
        var = pos.reshape(-1, d).var(axis=0)
        rel = np.abs(var / np.diag(cov) - 1.0)
        out[kind] = {"steps": n, "seconds": secs, "ms_per_step": secs * 1e3 / n,
                     "acceptance": w.acceptance(), "max_var_rel_err": float(rel.max())}
        _check_blocks(w.state.l_matrix, mask, f"blocked {kind}")
        check(float(rel.max()) <= BLOCKED_VAR_RTOL,
              f"blocked {kind}: sampled variances {rel.max()} from the target's "
              f"(> {BLOCKED_VAR_RTOL})")
    # blocked rwm on the chunk kernel
    g = synthetic.global_fit(2)
    order = ("linewidth", "x0", "mix", "scale", "bg0", "bg1", "scale2", "bg02", "bg12")
    truth = {k: g["truth"][k] for k in order}
    cfg = mfit.FitConfig(posterior_impl="chunk_kernel", **BLOCKED_CHUNK)
    wc = mfit.walker_create(function=g["functions"], data=g["data"], params=truth,
                            data_error=1e-7, n_walkers=W_FLAGSHIP, seed=0,
                            walker_jitter=ENSEMBLE_JITTER, config=cfg,
                            dtype=torch.float32, device=DEVICE)
    check(wc.spec.keys == order, f"blocked chunk: parameter order {wc.spec.keys}")
    lp_gen = float(mfit.walker_create(function=g["functions"], data=g["data"],
                                      params=truth, data_error=1e-7, n_walkers=1,
                                      dtype=torch.float64, device=DEVICE).state.logprob[0])
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wc.adaptive_steps(N_BLOCKED_CHUNK, temperature=1.0, auto=None, collect_history=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    lp, best = wc.most_likely_step()
    acc = wc.acceptance()
    cmask = _block_mask(BLOCKED_CHUNK["block_hyper"], BLOCKED_CHUNK["block_local"],
                        BLOCKED_CHUNK["block_count"])
    _check_blocks(wc.state.l_matrix, cmask, "blocked chunk kernel")
    ck = build_chunk_kernel(wc.terms, wc.spec, wc.config, W_FLAGSHIP, torch.float32)
    kcheck = _chunk_check(ck, wc.state, wc.state.l_matrix[0], "blocked chunk kernel",
                          dense_l=False)
    out["chunk_kernel"] = {"W": W_FLAGSHIP, "d": len(order), "layout": BLOCKED_CHUNK,
                           "steps": N_BLOCKED_CHUNK, "seconds": secs,
                           "chain_steps_per_sec": W_FLAGSHIP * N_BLOCKED_CHUNK / secs,
                           "best_lp": lp, "lp_generating": lp_gen, "x0": best["x0"],
                           "acceptance": acc, "launches": launches, "check": kcheck}
    emit(out)
    check(launches["chunk_rwm"] == -(-N_BLOCKED_CHUNK // cfg.chunk_size),
          f"blocked chunk: {launches['chunk_rwm']} chunk-kernel launches")
    check(lp >= lp_gen - 5.0, f"blocked chunk: best lp {lp} < lp(generating) {lp_gen} - 5")
    check(abs(best["x0"] - truth["x0"]) <= 0.01 * truth["x0"],
          f"blocked chunk: x0 {best['x0']} not within 1%")
    check(0.2 - GRADIENT_BAND_SLACK <= acc <= 0.4 + GRADIENT_BAND_SLACK,
          f"blocked chunk: acceptance {acc} outside 0.2-0.4 widened by {GRADIENT_BAND_SLACK}")
    return out


# The named-prior phase: the journey's sample_region steps, its optimize
# schedule and the global polish (examples/reference_journey.py:123), the
# unit-cube view's steps and identity tolerance.
N_PRIOR_REGION = 1000
N_PRIOR_JOURNEY = 20000   # 30000 until the hierarchical phases took their share
N_PRIOR_CHUNK = 10000
# 1 round (2 until the pooling phase took its share of the script's time:
# 8.1 s, the best lp +0.003)
PRIOR_OPTIMIZE = (400, 1)
# 1 round on the global walker since the pooling phase took its share of
# the script's time (4 rounds: 22.4 s, the best lp unchanged).
GLOBAL_OPTIMIZE = (400, 1)
# 1000 steps (2000 until the pooling phase took its share of the script's
# time: 9.5 s, the view's median x0 0.15 % from the fit's)
N_UNIT_CUBE = 1000
UNIT_CUBE_WALKERS = 1024
UNIT_CUBE_RTOL = 1e-5


def _mv_from_fit(w, keys=("linewidth", "x0", "mix"), take=None):
    """Experiment chaining: an MVGaussian over ``keys`` from a fit's last
    ``take`` steps, their median and their ``covariance_matrix()``."""
    import numpy as np
    import lisp_mcmc_torch as mfit

    idx = [w.spec.index(k) for k in keys]
    cov = np.asarray(w.covariance_matrix(take), np.float64)[np.ix_(idx, idx)]
    med = w.median_params(take)
    return mfit.MVGaussian({k: med[k] for k in keys}, cov)


def _optimize_report(w, n, rounds, what, lp_gen):
    """``w.optimize(n, rounds)`` with its gates: no walker's logprob falls,
    the best lp does not fall and stays >= lp(gen) - 5."""
    import torch

    lp0 = w.state.logprob.clone()
    best0 = w.most_likely_step()[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w.optimize(n, rounds=rounds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    best1 = w.most_likely_step()[0]
    fell = int((w.state.logprob < lp0).sum())
    check(fell == 0, f"{what}: {fell} walkers' logprob fell")
    check(best1 >= best0, f"{what}: the best lp fell from {best0} to {best1}")
    check(best1 >= lp_gen - 5.0, f"{what}: best lp {best1} < lp(generating) {lp_gen} - 5")
    return {"steps": n, "rounds": rounds, "seconds": secs,
            "ms_per_step": 1e3 * secs / (n * rounds),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "best_lp_before": best0, "best_lp_after": best1, "lp_gained": best1 - best0,
            "walkers_improved": float((w.state.logprob > lp0).float().mean())}


def phase_priors(ceilings, counters, ptxas, global_walker, global_lp_gen):
    """Named priors as declared tables in both kernels: the named-prior
    journey on both paths, each kernel against its plain version with the
    spec (kernel 1 also with an MVGaussian from the journey's fit),
    ``optimize`` and ``unit_cube_view``; returns the kernels line's two
    rows and the named-prior journey's walker."""
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import synthetic
    from lisp_mcmc_torch.ops.chunk_kernel import (build_chunk_kernel, chunk_bytes,
                                                  chunk_census)
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)
    from lisp_mcmc_torch.roofline import FLAGSHIP, N_POINTS

    t_phase = time.perf_counter()
    spec = synthetic.flagship_prior_spec()
    out = {"phase": "priors", "W": W_FLAGSHIP, "d": 6, "N": N_POINTS,
           "prior_spec": {k: v.to_meta() for k, v in spec.items()}}
    lp_gen = float(_flagship_walker(1, torch.float64, DEVICE, params=FLAGSHIP, jitter=0.0,
                                    log_prior=spec).state.logprob[0])

    # c. the named-prior journey on the default path
    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, log_prior=spec)
    post = prepare_fused_terms(w.terms, w.spec, torch.float32)
    check(post is not None and post.rest == () and len(post.densities) == 3
          and len(post.bounds) == 5,
          "priors: the spec is not the kernels' table (5 walls, 3 densities, no torch rest)")
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.sample_region(n=N_PRIOR_REGION)
    torch.cuda.synchronize()
    region_secs = time.perf_counter() - t0
    t1 = time.perf_counter()
    w.adaptive_steps(N_PRIOR_JOURNEY, temperature=10.0, auto=None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    launches = {c.__name__: c.launches for c in counters}
    # one launch a step: sample_region's greedy steps, the journey's, and
    # the walker's one equivalence probe
    want = N_PRIOR_REGION + N_PRIOR_JOURNEY + 1
    check(launches["fused_posterior"] == want,
          f"priors journey: {launches['fused_posterior']} kernel-1 launches, want {want}")
    lp, best, acc = _quality(w, lp_gen, FLAGSHIP["x0"], "priors journey")
    pos, _ = w._history()
    ess = mfit.ess_from_history(torch.as_tensor(pos, device=DEVICE), w.spec.keys)
    flat = next(p for p in OUT["phases"] if p.get("phase") == "journey_default")
    journey = {"W": W_FLAGSHIP, "steps": N_PRIOR_JOURNEY, "seconds": secs,
               "sample_region_seconds": region_secs,
               "tuner_accept_log": w.tuner_accept_log,
               "chain_steps_per_sec": W_FLAGSHIP * N_PRIOR_JOURNEY / secs,
               "min_ess_per_sec": min(ess.values()) / secs, "ess": ess,
               "best_lp": lp, "lp_generating": lp_gen, "x0": best["x0"], "best": best,
               "acceptance": acc, "launches": launches}
    journey["shift_vs_flagship_default"] = {
        k: journey[k] / flat[k] - 1.0 for k in ("chain_steps_per_sec", "min_ess_per_sec")}
    journey["kernel1_launches_per_step"] = (
        (launches["fused_posterior"] - 1) / (N_PRIOR_REGION + N_PRIOR_JOURNEY))
    out["journey_default"] = journey
    print(json.dumps({"phase": "priors_journey", **journey}), flush=True)

    # a. kernel 1 with the spec and with an MVGaussian from this fit
    mv = _mv_from_fit(w, take=2000)
    out["mv_gaussian"] = mv.to_meta()
    out["kernel1"] = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        near = _flagship_walker(W_FLAGSHIP // 2, dtype, DEVICE, params=FLAGSHIP, jitter=0.02)
        far = _flagship_walker(W_FLAGSHIP // 2, dtype, DEVICE)
        base = torch.cat([near.state.position, far.state.position]).contiguous()
        flat_post = prepare_fused_terms(near.terms, near.spec, dtype)
        flat_ms = _kernel1(base, flat_post, ptxas)
        for name, prior in (("prior_spec", spec), ("mv_gaussian", mv)):
            wp = _flagship_walker(1, dtype, DEVICE, log_prior=prior, params=FLAGSHIP, jitter=0.0)
            pp = prepare_fused_terms(wp.terms, wp.spec, dtype)
            check(pp is not None and pp.rest == (), f"priors {name}: not a table")
            # walkers past every wall among those near the peak (from the
            # far start a scale past its box overflows the misfit in f32)
            pos = torch.cat([synthetic.prior_edge_walkers(base[: W_FLAGSHIP // 2],
                                                          wp.spec.keys),
                             base[W_FLAGSHIP // 2:]]).contiguous()
            rel, abs_err = _fused_check(pp, pos, RTOL[dname], f"priors kernel 1 {name} {dname}")
            row = {"max_rel_err": rel, "max_abs_err": abs_err, **_kernel1(pos, pp, ptxas),
                   "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(pos, pp), 5),
                   "flat_kernel_ms": flat_ms["kernel_ms"], "flat_ms": flat_ms["ms"],
                   "walls": len(pp.bounds), "densities": len(pp.densities)}
            if dtype == torch.float32:
                row.update(_bounds(posterior_census(pp), 1, fused_bytes(pp, W_FLAGSHIP),
                                   ceilings))
                if name == "prior_spec":
                    spec_post = pp
            out["kernel1"][f"{name}_{dname}"] = row
            print(json.dumps({"phase": f"priors_kernel1_{name}_{dname}", **row}), flush=True)

    # b. kernel 2 with the spec: one chunk from the generating parameters
    wc = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, params=FLAGSHIP, jitter=1e-3,
                          log_prior=spec)
    ck = build_chunk_kernel(wc.terms, wc.spec, wc.config, W_FLAGSHIP, torch.float32)
    check(ck is not None and len(ck.post.densities) == 3, "priors: chunk kernel refused the spec")
    L = synthetic.dense_l(3e-3 * np.asarray(list(FLAGSHIP.values()))).to(DEVICE)
    out["chunk"] = {**_chunk_check(ck, wc.state, L, "priors chunk"),
                    "launch": _chunk_launch(ck, ptxas)}
    chunk_row_bounds = _bounds(chunk_census(posterior_census(ck.post), ck.d), ck.chunk,
                               chunk_bytes(ck.post, W_FLAGSHIP, ck.chunk), ceilings)
    del wc

    # c6. the same fit on the chunk kernel, without history
    wk = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, log_prior=spec,
                          config=mfit.FitConfig(posterior_impl="chunk_kernel"))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wk.adaptive_steps(N_PRIOR_CHUNK, temperature=10.0, auto=None, collect_history=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    chunk_launches = {c.__name__: c.launches for c in counters}
    check(chunk_launches["chunk_rwm"] == N_PRIOR_CHUNK // wk.config.chunk_size,
          f"priors chunk journey: {chunk_launches['chunk_rwm']} chunk-kernel launches")
    lpk, bestk, acck = _quality(wk, lp_gen, FLAGSHIP["x0"], "priors chunk journey")
    out["journey_chunk_kernel"] = {"steps": N_PRIOR_CHUNK, "seconds": secs,
                                   "chain_steps_per_sec": W_FLAGSHIP * N_PRIOR_CHUNK / secs,
                                   "best_lp": lpk, "x0": bestk["x0"], "acceptance": acck,
                                   "launches": chunk_launches}
    del wk

    # d. optimize: the journey's walker, then the global polish
    out["optimize"] = _optimize_report(w, *PRIOR_OPTIMIZE, "priors optimize", lp_gen)
    out["optimize_global"] = _optimize_report(global_walker, *GLOBAL_OPTIMIZE,
                                              "global optimize", global_lp_gen)

    # e. the unit-cube view of the journey's walker
    uw = mfit.unit_cube_view(w, spec)
    u = uw.state.position[:UNIT_CUBE_WALKERS]
    check(bool(((u > 0) & (u < 1)).all()), "unit cube: the view's start leaves the cube")
    th = uw._theta_of_u(u)
    lhs = uw._log_post(u).double()
    rhs = (w._log_post(th) - spec.installed_vec(th, w.spec.keys)).double()
    ident = float(((lhs - rhs).abs() / rhs.abs().clamp_min(1.0)).max())
    check(ident <= UNIT_CUBE_RTOL, f"unit cube: posterior identity {ident} > {UNIT_CUBE_RTOL}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uw.adaptive_steps(N_UNIT_CUBE, temperature=1.0)
    torch.cuda.synchronize()
    view_secs = time.perf_counter() - t0
    theta = uw._theta_of_u(uw.state.position)
    x0_view = float(theta[:, w.spec.index("x0")].median())
    x0_fit = w.median_params(N_UNIT_CUBE)["x0"]
    check(abs(x0_view - x0_fit) <= 0.01 * abs(x0_fit),
          f"unit cube: the view's median x0 {x0_view} not within 1% of the fit's {x0_fit}")
    out["unit_cube"] = {"identity_rel_err": ident, "steps": N_UNIT_CUBE, "seconds": view_secs,
                        "x0_median_view": x0_view, "x0_median_fit": x0_fit,
                        "acceptance": uw.acceptance()}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    k1 = out["kernel1"]["prior_spec_float32"]
    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "fused_posterior_prior_spec", **common,
         "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
         "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117",
         "launches": launches["fused_posterior"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "kernel_ms": k1["kernel_ms"], "plan": k1["plan"],
         "plain_ms": k1["plain_ms"], "flat_kernel_ms": k1["flat_kernel_ms"],
         **_bounds(posterior_census(spec_post), 1, fused_bytes(spec_post, W_FLAGSHIP),
                   ceilings)},
        {"name": "chunk_rwm_prior_spec", **common,
         "source": "lisp_mcmc_torch/csrc/chunk_rwm.cu",
         "replaces": "lisp_mcmc_tpu/ops/chunk_pallas.py:95",
         "launches": chunk_launches["chunk_rwm"],
         "max_abs_err": out["chunk"]["logprob_max_abs_err"], "ms": out["chunk"]["ms"],
         "plain_ms": out["chunk"]["plain_ms"], **chunk_row_bounds,
         "registers": out["chunk"]["launch"]["registers"],
         "threads": out["chunk"]["launch"]["threads"],
         "blocks_per_sm": out["chunk"]["launch"]["blocks_per_sm"],
         "waves": out["chunk"]["launch"]["waves"]},
    ], w


# The batched NV journey: a BATCHED_GRID scan grid of spectra
# (synthetic.nv_scan_grid) as one BatchedNVFit of 128 walkers a spectrum,
# float32, on the plain batched posterior (neither kernel
# reads a per-walker dataset); the anneal is 40000 steps (a 30000-step
# anneal left 3 of 1024 spectra above 0.4 acceptance after the cold steps,
# max 0.503, on an H100; with 6000 cold steps, 1 of 256 at 0.499).
# Gates, fixed before the first chip run: each spectrum's best mu1, mu2
# and field offset within NV_TOL_MHZ of its truth; each spectrum's
# acceptance in 0.2-0.4 over 1000 steps (5 chunks at the cold finish's
# settings) after the fit; finite states after stretch and mala; a
# finite, positive-definite Laplace covariance with no clamped eigenvalue
# per spectrum; no kernel launch.  Read right after the anneal, that
# acceptance had 48 of 1024 spectra above 0.4 (max 0.54, on an H100):
# the schedule's cold finish starts at T = 9.7 (the cosine
# of mcmc-fitting.lisp:878 at step 38000 of 40000), so each group's L,
# tuned at T ~ 10, collapses the acceptance at T = 1, takes the x0.1
# rescale and climbs back by x1.9 a chunk, and in 2000 steps without
# refresh some groups are still climbing.  The fit now samples at T = 1
# for 4000 adaptive steps after the anneal (sampling_steps with rwm: ten
# chunks with the in-band refresh, then the ten-chunk cold finish), the
# recipe after an anneal, and the gate reads the acceptance after that;
# the acceptance right after the anneal is reported beside it.
# 16 x 16 spectra, W = 32768 (32 x 32, W = 131072, until the pooling phase
# took its share of the script's time: 156-190 s; each spectrum's fit, 128
# walkers over 401 points, and every per-spectrum gate are as before, over
# fewer spectra; the phase's ms a step and busy share are not comparable
# across the change)
BATCHED_GRID = (16, 16)
BATCHED_WALKERS = 128
N_BATCHED = 40000
N_BATCHED_COLD = 4000
N_BATCHED_STRETCH = 200
N_BATCHED_MALA = 50
BATCHED_ACCEPT_STEPS = 1000
BATCHED_PROFILE_STEPS = 20


def phase_batched_nv(counters):
    """``BatchedNVFit`` on a ``BATCHED_GRID`` scan grid: the anneal (ms a step,
    chain-steps/sec, the device's busy share from two profiled chunks),
    the per-spectrum gates, short stretch and mala runs on the same batch
    (ms a step), ``laplace_per_dataset``, peak memory and the launches
    (none).  The per-spectrum ``convergence()`` readout (not gated; 19-22
    s of host work over 1024 spectra) left the phase for the script's time
    limit."""
    import dataclasses
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import nv, synthetic

    t_phase = time.perf_counter()
    rows, cols = BATCHED_GRID
    x, ys, truths = synthetic.nv_scan_grid(rows, cols, seed=0)
    torch.cuda.reset_peak_memory_stats()
    fit = nv.BatchedNVFit([(x, y) for y in ys], walkers_per_spectrum=BATCHED_WALKERS,
                          seed=0, dtype=torch.float32, device=DEVICE,
                          config=mfit.FitConfig(auto=None))
    W = fit.n_walkers
    check(W == rows * cols * BATCHED_WALKERS, f"batched_nv: W = {W}")
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit.adaptive_steps(N_BATCHED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    check(all(v == 0 for v in launches.values()),
          f"batched_nv: a kernel launched on the plain batched path ({launches})")
    out = {"phase": "batched_nv", "grid": [rows, cols], "W": W, "N": int(x.shape[0]),
           "steps": N_BATCHED, "seconds": secs, "ms_per_step": 1e3 * secs / N_BATCHED,
           "chain_steps_per_sec": W * N_BATCHED / secs, "launches": launches}

    def group_acceptance():
        """Each spectrum's acceptance over BATCHED_ACCEPT_STEPS at the cold
        finish's settings (adaptation on, no refresh, T = 1)."""
        runner = fit._runner(with_history=False)
        st, acc = fit.state, []
        for _ in range(BATCHED_ACCEPT_STEPS // fit.config.chunk_size):
            st, o = runner(st, True, False, True, generator=fit.generator)
            acc.append(o["group_accept"])
        fit.state = st
        a = torch.stack(acc).mean(0).cpu().numpy()
        return a, {"min": float(a.min()), "max": float(a.max()), "mean": float(a.mean()),
                   "outside_band": int(((a < 0.2) | (a > 0.4)).sum())}

    out["acceptance_after_anneal"] = group_acceptance()[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit.sampling_steps(N_BATCHED_COLD, kernel="rwm")
    torch.cuda.synchronize()
    out["cold"] = {"steps": N_BATCHED_COLD, "seconds": time.perf_counter() - t0}
    out["acceptance"] = group_acceptance()[1]
    # the busy share over 20-step chunks: a 200-step chunk launches ~34000
    # kernels, and profiling two of them took ~40 s of host time (H100 host)
    prev = fit.config
    fit.config = dataclasses.replace(prev, chunk_size=BATCHED_PROFILE_STEPS)
    prof = _profile_chunks("batched_nv_profile", fit._runner(with_history=True), fit.state,
                           fit.generator, args=(True, False, True),
                           steps=BATCHED_PROFILE_STEPS)
    fit.config = prev
    out["device_busy_share"] = prof["device_busy_share"]
    out["chunk_wall_ms"] = prof["chunk_wall_ms"]

    best = fit.best_params_per_spectrum()
    offsets = fit.field_offsets()
    errs = {k: np.abs([b[k] - t[k] for b, t in zip(best, truths)]) for k in ("mu1", "mu2")}
    errs["field_offset"] = np.abs([o - (t["mu2"] - t["mu1"]) / 2 / 2.8
                                   for o, t in zip(offsets, truths)])
    out["max_err_mhz"] = {k: float(v.max()) for k, v in errs.items()}


    # the same batch: short stretch and mala runs
    for kind, n in (("stretch", N_BATCHED_STRETCH), ("mala", N_BATCHED_MALA)):
        prev = fit.config
        fit.config = dataclasses.replace(prev, chunk_size=min(prev.chunk_size, n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit.sampling_steps(n, kernel=kind)
        torch.cuda.synchronize()
        ksecs = time.perf_counter() - t0
        fit.config = prev
        finite = bool(torch.isfinite(fit.state.position).all()
                      and torch.isfinite(fit.state.logprob).all())
        out[kind] = {"steps": n, "seconds": ksecs, "ms_per_step": 1e3 * ksecs / n,
                     "acceptance": fit.acceptance(), "finite": finite}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lap = fit.laplace_per_dataset()
    torch.cuda.synchronize()
    pd = [bool(np.all(np.isfinite(r.cov))) and bool(np.all(np.linalg.eigvalsh(r.cov) > 0))
          for r in lap]
    out["laplace"] = {"seconds": time.perf_counter() - t0, "positive_definite": sum(pd),
                      "clamped": sum(r.n_clamped for r in lap),
                      "median_sd_mu1": float(np.median([r.sd["mu1"] for r in lap]))}
    out["launches_after_anneal"] = {c.__name__: c.launches for c in counters}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds_phase"] = time.perf_counter() - t_phase
    emit(out)
    for k, v in errs.items():
        bad = np.flatnonzero(v > NV_TOL_MHZ)
        check(bad.size == 0, f"batched_nv: {k} off by more than {NV_TOL_MHZ} MHz at "
              f"spectra {bad[:8].tolist()} (max {float(v.max())})")
    check(out["acceptance"]["outside_band"] == 0,
          f"batched_nv: {out['acceptance']['outside_band']} spectra with acceptance "
          f"outside 0.2-0.4 ({out['acceptance']})")
    for kind in ("stretch", "mala"):
        check(out[kind]["finite"], f"batched_nv: a non-finite state after {kind}")
    check(sum(pd) == len(lap) and out["laplace"]["clamped"] == 0,
          f"batched_nv: Laplace covariances not positive definite ({out['laplace']})")
    check(all(v == 0 for v in out["launches_after_anneal"].values()),
          f"batched_nv: a kernel launched ({out['launches_after_anneal']})")
    return out


# The evidence journeys (synthetic.line_evidence_case: a line of 334
# points, sigma = 2, box m in (-4, 8), b in (-3, 5), log Z in closed
# form), W = 131072, float32, the line twin of kernel 1 on the default
# path.  Gates, fixed before the first chip run (the JAX package's
# tests/test_evidence.py:39 gates for the ladder): |log_z - closed form|
# <= 0.25, |log_z_ti - log_z| <= 0.35, error < 0.2; each SMC run's log_z
# and the Laplace log_z within 0.25 and 0.05 of the closed form; kernel-1
# launches equal to the steps' evaluations plus the probe and the
# closure (ladder) or the box draws (SMC); kernel-2 launches equal to the
# chunks the SMC stages ran.
# Nested sampling on the ladder's walker (the line case, W = 131072,
# float32): n_live = 131072, k_batch and n_repeat at their defaults
# (n_live / 4 = 32768 refills a round, 8 d + 16 = 32 constrained moves each,
# every move one kernel-1 launch at W = 32768).  Gates, fixed before the
# first chip run: log_z within max(0.25, 4 log_z_err) of the closed form
# (the phase's SMC bound; JAX tests/test_nested.py:69's 4-sigma form) and
# log_z_err < 0.05; the launches 1 + n_iter x n_repeat exactly (the
# initial live set, then the moves; the fit's probe ran on the ladder).
EVIDENCE_NESTED_LIVE = 131072
EVIDENCE_NESTED_TOL = 0.25
EVIDENCE_NESTED_ERR = 0.05
EVIDENCE_LADDER = {"n_steps": 16000, "rungs": 16, "t_max": 1e4}
EVIDENCE_SMC_MOVE = 400
EVIDENCE_TOL = {"ladder": 0.25, "ti": 0.35, "error": 0.2, "smc": 0.25, "laplace": 0.05}
# the kernel-2 check's temperature: a late SMC stage's (T = 1/beta; the
# stages of this case run at T ~ 145, 32, 9.4, 2.8, 1 on the CPU at W =
# 4096, acceptance 0.82 at T = 10 there)
EVIDENCE_CHUNK_TEMP = 10.0


def _line_ti_bias(case, betas):
    """The trapezoid's own error on the ladder ``betas``: TI (with the exact
    [0, beta_min] segment) minus the exact log Z, both by quadrature of
    the line's likelihood on a 1201 x 801 grid over the box (float64)."""
    import math
    import numpy as np

    x, y, s = case["x"], case["y"], case["sigma"]
    (m0, m1), (b0, b1) = case["bounds"]["m"], case["bounds"]["b"]
    m, b = np.meshgrid(np.linspace(m0, m1, 1201), np.linspace(b0, b1, 801), indexing="ij")
    n = x.size
    rss = ((y * y).sum() - 2 * m * (x * y).sum() - 2 * b * y.sum() + m * m * (x * x).sum()
           + 2 * m * b * x.sum() + n * b * b)
    log_l = -0.5 * n * math.log(2 * math.pi * s * s) - 0.5 * rss / s ** 2
    top = log_l.max()

    def log_z(beta):
        return float(np.log(np.exp(beta * (log_l - top)).mean()) + beta * top)

    def mean_log_l(beta):
        w = np.exp(beta * (log_l - top))
        return float((w * log_l).sum() / w.sum())

    bs = np.asarray(betas, np.float64)[::-1]
    trap = getattr(np, "trapezoid", None) or np.trapz
    ti = float(trap([mean_log_l(v) for v in bs], bs)) + log_z(bs[0])
    return ti - log_z(1.0)


def phase_evidence(ceilings, counters, ptxas):
    """The evidence layer on the line case: ``log_evidence`` (the tempered
    ladder, kernel 1 once a step), ``smc_sample`` on the default path and
    on ``posterior_impl="chunk_kernel"`` (kernel 2 at each stage's
    temperature), ``laplace_approx``, ``nested_sample`` (kernel 1 on every
    refill move, at W = n_live / 4); kernel 1 and kernel 2 against their
    plain versions on those paths' own inputs; returns the kernels line's
    three rows."""
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import models, synthetic
    from lisp_mcmc_torch.ops.chunk_kernel import (build_chunk_kernel, chunk_bytes,
                                                  chunk_census)
    from lisp_mcmc_torch.nested import _nested_budget as nested_budget
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)

    t_phase = time.perf_counter()
    case = synthetic.line_evidence_case()
    truth = case["log_z"]

    def walker(**cfg):
        return mfit.walker_create(
            function=models.line, data=(case["x"], case["y"]), params=case["truth"],
            data_error=case["sigma"], log_prior=mfit.make_bounds_prior(case["bounds"]),
            n_walkers=W_FLAGSHIP, seed=0, walker_jitter=0.05, dtype=torch.float32,
            device=DEVICE, config=mfit.FitConfig(**cfg))

    def launches():
        return {c.__name__: c.launches for c in counters}

    out = {"phase": "evidence", "W": W_FLAGSHIP, "N": int(case["x"].size),
           "closed_form_log_z": truth}

    # the ladder
    w = walker()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = w.log_evidence(**EVIDENCE_LADDER)
    torch.cuda.synchronize()
    ladder = {"seconds": time.perf_counter() - t0, "log_z": res.log_z,
              "log_z_ti": res.log_z_ti, "error": res.error, "tail": res.tail,
              "posterior_evals": w.posterior_evals, "launches": launches(),
              "ti_trapezoid_bias": _line_ti_bias(case, res.betas),
              "min_swap_rate": w.swap_rates()["min_rate"]}
    out["ladder"] = ladder
    post = prepare_fused_terms(w.terms, w.spec, torch.float32)
    check(post is not None and post.rest == (), "evidence: the line fit is not on kernel 1")
    pos = w.state.position
    rel, abs_err = _fused_check(post, pos, RTOL["float32"], "evidence ladder")
    one = _kernel1(pos, post, ptxas)
    kernel1 = {"max_rel_err": rel, "max_abs_err": abs_err, **one,
               "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(pos, post), 5),
               **_bounds(posterior_census(post), 1, fused_bytes(post, W_FLAGSHIP), ceilings)}
    out["kernel1"] = kernel1

    # SMC on the default path, then on the chunk kernel
    smc = {}
    for impl in ("auto", "chunk_kernel"):
        w2 = walker(posterior_impl=impl)
        stages = []
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = w2.smc_sample(case["bounds"], n_move=EVIDENCE_SMC_MOVE,
                          on_stage=lambda info: stages.append(info) and False)
        torch.cuda.synchronize()
        smc[impl] = {"seconds": time.perf_counter() - t0, "log_z": r.log_z,
                     "stages": r.n_stages, "chunks": sum(i["chunks"] for i in stages),
                     "final_acceptance": float(r.acceptance[-1]),
                     "posterior_evals": w2.posterior_evals, "launches": launches()}
        if impl == "auto":
            lap_walker = w2
    out["smc"] = smc

    # kernel 2 at an SMC stage's temperature, from the chunk-kernel run's
    # particles, with a dense L of the posterior's correlation sign
    ck = build_chunk_kernel(w2.terms, w2.spec, w2.config, W_FLAGSHIP, torch.float32)
    check(ck is not None, "evidence: the line fit is outside the chunk kernel's scope")
    L = torch.linalg.cholesky(torch.tensor([[0.09, -0.036], [-0.036, 0.04]])).to(DEVICE)
    chunk = _chunk_check(ck, w2.state, L, "evidence chunk", temp=EVIDENCE_CHUNK_TEMP)
    chunk.update(temperature=EVIDENCE_CHUNK_TEMP, launch=_chunk_launch(ck, ptxas),
                 **_bounds(chunk_census(posterior_census(ck.post), ck.d), ck.chunk,
                           chunk_bytes(ck.post, W_FLAGSHIP, ck.chunk), ceilings))
    out["chunk"] = chunk

    # Laplace at the default-path SMC run's best point
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lap = lap_walker.laplace_approx(bounds=case["bounds"])
    out["laplace"] = {"seconds": time.perf_counter() - t0, "log_z": lap.log_z,
                      "n_clamped": lap.n_clamped, "sd": lap.sd,
                      "sd_closed_form": dict(zip(("m", "b"), np.sqrt(np.diag(case["cov"]))))}

    # nested sampling on the ladder's walker: kernel 1 on every refill move
    rounds = []
    probed = "_fused" in w._runner_cache
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns = w.nested_sample(case["bounds"], n_live=EVIDENCE_NESTED_LIVE,
                         on_round=lambda info: rounds.append(info) and False)
    torch.cuda.synchronize()
    k_batch, n_repeat = nested_budget(EVIDENCE_NESTED_LIVE, None, None, w.ndim)
    nested = {"seconds": time.perf_counter() - t0, "n_live": EVIDENCE_NESTED_LIVE,
              "k_batch": k_batch, "n_repeat": n_repeat, "log_z": ns.log_z,
              "log_z_err": ns.log_z_err, "h": ns.h, "n_iter": ns.n_iter, "ess": ns.ess,
              "insertion_p": ns.insertion_p, "logl_max": ns.logl_max,
              "final_acceptance": rounds[-1]["acceptance"],
              "final_scale": rounds[-1]["scale"],
              "acceptance_by_round": [r["acceptance"] for r in rounds],
              "probe_cached": probed, "launches": launches()}
    # kernel 1 at the refills' width, on the run's last 32768 points (the
    # final live set's best quarter)
    refill = torch.as_tensor(ns.samples[-k_batch:], dtype=torch.float32, device=DEVICE)
    rel, abs_err = _fused_check(post, refill, RTOL["float32"], "evidence nested kernel 1")
    nested["kernel1"] = {"W": k_batch, "max_rel_err": rel, "max_abs_err": abs_err,
                         **_kernel1(refill, post, ptxas),
                         "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(refill, post),
                                                  5),
                         **_bounds(posterior_census(post), 1, fused_bytes(post, k_batch),
                                   ceilings, walkers=k_batch)}
    out["nested"] = nested
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    tol = EVIDENCE_TOL
    check(abs(res.log_z - truth) <= tol["ladder"],
          f"evidence: ladder log_z {res.log_z} not within {tol['ladder']} of {truth}")
    check(abs(res.log_z_ti - res.log_z) <= tol["ti"],
          f"evidence: TI {res.log_z_ti} not within {tol['ti']} of the stepping stones' "
          f"{res.log_z}")
    check(res.error < tol["error"], f"evidence: ladder error {res.error} >= {tol['error']}")
    steps = EVIDENCE_LADDER["n_steps"]
    check(w.posterior_evals == steps and ladder["launches"]["fused_posterior"] == steps + 2,
          f"evidence: {ladder['launches']['fused_posterior']} kernel-1 launches for "
          f"{steps} ladder steps (+ the probe and the closure)")
    for impl, r in smc.items():
        check(abs(r["log_z"] - truth) <= tol["smc"],
              f"evidence: smc ({impl}) log_z {r['log_z']} not within {tol['smc']} of {truth}")
    a, k = smc["auto"], smc["chunk_kernel"]
    check(a["launches"]["fused_posterior"] == a["posterior_evals"] + 2
          and a["launches"]["chunk_rwm"] == 0,
          f"evidence: smc default path launched {a['launches']} for "
          f"{a['posterior_evals']} move evaluations (+ the probe and the box draws)")
    check(k["launches"]["chunk_rwm"] == k["chunks"] and k["chunks"] > 0
          and k["launches"]["fused_posterior"] == 2,
          f"evidence: smc on the chunk kernel launched {k['launches']} for "
          f"{k['chunks']} chunks (kernel 1: the probe and the box draws)")
    check(lap.log_z is not None and abs(lap.log_z - truth) <= tol["laplace"],
          f"evidence: Laplace log_z {lap.log_z} not within {tol['laplace']} of {truth}")
    band = max(EVIDENCE_NESTED_TOL, 4.0 * ns.log_z_err)
    check(np.isfinite(ns.log_z) and abs(ns.log_z - truth) <= band,
          f"evidence: nested log_z {ns.log_z} not within {band} of {truth}")
    check(ns.log_z_err < EVIDENCE_NESTED_ERR,
          f"evidence: nested log_z_err {ns.log_z_err} >= {EVIDENCE_NESTED_ERR}")
    want = 1 + ns.n_iter * n_repeat + (0 if probed else 1)
    check(nested["launches"]["fused_posterior"] == want
          and nested["launches"]["chunk_rwm"] == 0,
          f"evidence: nested launched {nested['launches']}, want {want} of kernel 1 "
          f"(1 + {ns.n_iter} rounds x {n_repeat} moves)")

    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "fused_posterior_line_evidence", **common,
         "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
         "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117",
         "launches": ladder["launches"]["fused_posterior"]
         + a["launches"]["fused_posterior"],
         **{k: kernel1[k] for k in ("max_abs_err", "ms", "kernel_ms", "plan", "plain_ms",
                                    "bound_ms", "bound_by", "opmix_bound_ms")}},
        {"name": "chunk_rwm_smc", **common,
         "source": "lisp_mcmc_torch/csrc/chunk_rwm.cu",
         "replaces": "lisp_mcmc_tpu/ops/chunk_pallas.py:95",
         "launches": k["launches"]["chunk_rwm"], "max_abs_err": chunk["logprob_max_abs_err"],
         "ms": chunk["ms"], "plain_ms": chunk["plain_ms"],
         **{k2: chunk[k2] for k2 in ("bound_ms", "bound_by", "opmix_bound_ms")},
         "temperature": EVIDENCE_CHUNK_TEMP, "registers": chunk["launch"]["registers"],
         "threads": chunk["launch"]["threads"],
         "blocks_per_sm": chunk["launch"]["blocks_per_sm"], "waves": chunk["launch"]["waves"]},
        {"name": "fused_posterior_line_nested", **common,
         "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
         "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117", "W": k_batch,
         "launches": nested["launches"]["fused_posterior"],
         **{k: nested["kernel1"][k] for k in ("max_abs_err", "ms", "kernel_ms", "plan",
                                              "plain_ms", "bound_ms", "bound_by",
                                              "opmix_bound_ms")}},
    ]


# The criticism phase: model checking and comparison on the flagship
# journey's walker (W = 131072, float32).  The JAX package's recipe for
# this fit (diagnostics.waic's docstring: walkers left in a far mode after
# the anneal dominate the variance): reset_to_most_likely, then
# CRITICISM_COLD adaptive steps at T = 1 with history (kernel 1 once a
# step); every history verb reads the last CRITICISM_TAKE of them.  The
# named-prior journey's walker takes the same recipe before
# prior_sensitivity (which refuses draws outside the prior's walls).
# Gates, fixed before the first chip run and never widened: loo's elpd
# within 2.0 of waic's (JAX tests/test_loo.py:73); kfold's (k = 10, 64
# walkers a fold, CRITICISM_KFOLD_STEPS anneal steps) within 2 max(se, 1) of loo's
# (JAX tests/test_kfold.py:38); loo_pit ok; the profile's maximum inside
# its grid with x0 there within 1 % of 2784.68; reloo refitting exactly
# 4 points; each of the 16 nested_per_dataset runs within max(0.25, 4
# log_z_err) of its closed form; every result finite; kernel-1 launches
# as the structure implies (the cold steps; profile_likelihood's 1 +
# rounds value-only evaluations at W = 168; none elsewhere) and no launch
# inside the refits and nested_per_dataset (their fits have per-walker
# aux: plain by design).
CRITICISM_COLD = 4000
CRITICISM_TAKE = 2000
CRITICISM_GRID = 2048
CRITICISM_PRIOR_DRAWS = 256
CRITICISM_KFOLD = 10
# kfold's anneal (then max(2000, half) mala steps): 1000, as reloo's, for
# the script's time limit (8000 took 38.1 s, with the kfold elpd 4.5 from
# loo's within a band of 28.4; 4000: 3.9 from it, 17.0 s; 2000, until the
# hierarchical phases took their share: 4.0 from it, 21.6 s on a slow host).
CRITICISM_KFOLD_STEPS = 1000
CRITICISM_RELOO = 4
# reloo's anneal (then max(2000, half) mala steps): an eighth of kfold's
# default 8000, to keep the script inside its time limit (8000 took 36.9
# s, 4000 16.3 s, 2000 23.0 s on a slow host)
CRITICISM_RELOO_STEPS = 1000
CRITICISM_DATASETS = 16
CRITICISM_NESTED_LIVE = 512
CRITICISM_TOL = {"loo_waic": 2.0, "kfold_se": 2.0, "x0": 0.01, "nested": 0.25}
# prior_predictive's box: each flagship parameter within a factor 2 of its
# generating value
CRITICISM_BOX_FACTOR = 2.0


def _finite(*arrays):
    import numpy as np

    return all(bool(np.all(np.isfinite(np.asarray(a, np.float64)))) for a in arrays)


def phase_criticism(counters, w, prior_walker):
    """Model criticism and nested sampling per dataset (see the constants
    above): on the journey's walker ``waic``, ``loo``, ``loo_pit``,
    ``audit``, ``posterior_predictive``, ``ppc_pvalue``, ``predict``,
    ``prior_predictive``, ``profile_likelihood("x0")``, ``kfold`` and
    ``reloo``; ``prior_sensitivity`` on the named-prior journey's walker;
    ``nested_per_dataset`` on a ``BatchedFit`` of 16 line cases.  Reports
    each verb's seconds and launches, the refits' ms a step and the device's
    busy share over profiled mala chunks of the kfold refit."""
    import dataclasses
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import diagnostics, models, synthetic
    from lisp_mcmc_torch.roofline import FLAGSHIP

    t_phase = time.perf_counter()
    out = {"phase": "criticism", "W": W_FLAGSHIP, "cold_steps": CRITICISM_COLD,
           "take": CRITICISM_TAKE, "seconds_by_verb": {}, "launches_by_verb": {}}

    def timed(name, fn):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out["seconds_by_verb"][name] = time.perf_counter() - t0
        out["launches_by_verb"][name] = {c.__name__: c.launches for c in counters}
        return r

    take = CRITICISM_TAKE
    probed = "_fused" in w._runner_cache and "_fused" in prior_walker._runner_cache
    for walker in (w, prior_walker):
        walker.reset_to_most_likely()
    timed("cold_steps", lambda: w.adaptive_steps(CRITICISM_COLD, temperature=1.0, auto=None))
    timed("prior_cold_steps", lambda: prior_walker.adaptive_steps(
        CRITICISM_COLD, temperature=1.0, auto=None))
    out["history"] = list(w._history(take)[0].shape)
    out["acceptance"] = w.acceptance()
    wa = timed("waic", lambda: diagnostics.waic(w, take=take))
    lo = timed("loo", lambda: diagnostics.loo(w, take=take))
    pit = timed("loo_pit", lambda: diagnostics.loo_pit(w, take=take))
    aud = timed("audit", lambda: w.audit(take=take))
    draws = timed("posterior_predictive", lambda: w.posterior_predictive(take=take))
    ppc = timed("ppc_pvalue", lambda: w.ppc_pvalue(draws=draws))
    grid = np.linspace(2000.0, 3600.0, CRITICISM_GRID)
    pred = timed("predict", lambda: w.predict(grid, take=take, noise=1e-7))
    box = {k: tuple(sorted((v / CRITICISM_BOX_FACTOR, v * CRITICISM_BOX_FACTOR)))
           for k, v in FLAGSHIP.items()}
    prior_draws = timed("prior_predictive", lambda: w.prior_predictive(
        bounds=box, n_samples=CRITICISM_PRIOR_DRAWS))
    prof = timed("profile_likelihood", lambda: w.profile_likelihood("x0"))
    sens = timed("prior_sensitivity", lambda: prior_walker.prior_sensitivity(
        prior=synthetic.flagship_prior_spec(), take=take))

    # the refits, timed inside (anneal and mala phases together)
    refits = {}
    real_run = diagnostics._run_refit

    def run_refit(fit, n_steps, temperature, burn_fraction):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_run(fit, n_steps, temperature, burn_fraction)
        torch.cuda.synchronize()
        steps = n_steps + max(2000, n_steps // 2)
        refits[len(refits)] = {"fit": fit, "walkers": fit.n_walkers, "steps": steps,
                               "seconds": time.perf_counter() - t0}

    diagnostics._run_refit = run_refit
    try:
        kf = timed("kfold", lambda: diagnostics.kfold(w, k=CRITICISM_KFOLD,
                                                     n_steps=CRITICISM_KFOLD_STEPS))
        k_sorted = np.sort(lo.pareto_k)
        thr = float(np.nextafter(k_sorted[-CRITICISM_RELOO], -np.inf))
        rl = timed("reloo", lambda: diagnostics.reloo(w, lo, k_threshold=thr,
                                                      n_steps=CRITICISM_RELOO_STEPS))
    finally:
        diagnostics._run_refit = real_run
    kfit = refits[0]["fit"]
    for r in refits.values():
        del r["fit"]
        r["ms_per_step"] = r["seconds"] * 1e3 / r["steps"]
    out["refits"] = {"kfold": refits[0], "reloo": refits.get(1)}
    # the device's busy share over mala chunks of the kfold refit (20 steps)
    kfit.config = dataclasses.replace(kfit.config, kernel="mala", chunk_size=20)
    out["refits"]["kfold_mala_profile"] = _profile_chunks(
        "criticism_refit_mala", kfit._runner(with_history=False), kfit.state,
        kfit.generator, args=(True, False, True), steps=20)
    del kfit

    batch = synthetic.line_evidence_batch(CRITICISM_DATASETS)
    bf = mfit.BatchedFit(models.line, batch["datasets"], batch["truth"],
                         data_error=batch["sigma"],
                         log_prior=mfit.make_bounds_prior(batch["bounds"]),
                         walkers_per_dataset=8, dtype=torch.float32, device=DEVICE)
    nested = timed("nested_per_dataset", lambda: bf.nested_per_dataset(
        n_live=CRITICISM_NESTED_LIVE))
    from lisp_mcmc_torch import plotting

    out["plot_seconds"] = {
        "loo_pit_plot": save_plot(lambda f: plotting.loo_pit_plot(pit, filename=f),
                                  "criticism_loo_pit"),
        "prior_sensitivity_plot": save_plot(
            lambda f: plotting.prior_sensitivity_plot(sens, filename=f),
            "criticism_prior_sensitivity"),
        "ppc_plot": save_plot(lambda f: w.ppc_plot(take=take, filename=f),
                              "criticism_ppc")}

    out.update({
        "waic": {"elpd": wa.elpd, "p_waic": wa.p_waic, "se": wa.se,
                 "n_samples": wa.n_samples},
        "loo": {"elpd": lo.elpd, "p_loo": lo.p_loo, "se": lo.se, "n_bad_k": lo.n_bad_k,
                "max_k": float(lo.pareto_k.max())},
        "loo_pit": {"ok": pit.ok, "ks": pit.ks_stat, "p": pit.p_value,
                    "n_bad_k": pit.n_bad_k},
        "audit": {"ok": aud.ok, "advice": aud.advice, "skipped": aud.skipped,
                  "convergence_ok": aud.convergence["ok"]},
        "ppc": {"p": ppc["p"], "coverage_90": draws[0].coverage()},
        "predict": {"N": CRITICISM_GRID, "draws": int(pred.mu.shape[0])},
        "prior_predictive": {"draws": int(prior_draws[0].y_rep.shape[0])},
        "profile": {"at_max": prof.at_max, "lp_max": prof.lp_max,
                    "grid": [float(prof.grid[0]), float(prof.grid[-1])],
                    "ci95": prof.ci()[:2], "probe_cached": probed},
        "prior_sensitivity": {"prior": sens.prior, "likelihood": sens.likelihood,
                              "diagnosis": sens.diagnosis},
        "kfold": {"elpd": kf.elpd, "se": kf.se, "fold_ok": kf.fold_ok.tolist(),
                  "n_samples": kf.n_samples},
        "reloo": {"threshold": thr, "refits": int((lo.pareto_k > thr).sum()),
                  "elpd": rl.elpd, "refit_failed": list(rl.refit_failed)},
        "nested_per_dataset": [
            {"log_z": r.log_z, "log_z_err": r.log_z_err, "closed_form": float(z),
             "n_iter": r.n_iter, "insertion_p": r.insertion_p}
            for r, z in zip(nested, batch["log_z"])],
    })
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    tol = CRITICISM_TOL
    check(abs(lo.elpd - wa.elpd) <= tol["loo_waic"],
          f"criticism: loo elpd {lo.elpd} not within {tol['loo_waic']} of waic's {wa.elpd}")
    band = tol["kfold_se"] * max(kf.se, 1.0)
    check(abs(kf.elpd - lo.elpd) <= band,
          f"criticism: kfold elpd {kf.elpd} not within {band} of loo's {lo.elpd}")
    check(pit.ok, f"criticism: loo_pit not ok (KS p {pit.p_value})")
    inside = prof.grid[0] < prof.at_max < prof.grid[-1]
    check(inside and abs(prof.at_max - FLAGSHIP["x0"]) <= tol["x0"] * FLAGSHIP["x0"],
          f"criticism: the profile's maximum {prof.at_max} is not inside its grid "
          f"{prof.grid[0]}..{prof.grid[-1]} within 1% of {FLAGSHIP['x0']}")
    check(out["reloo"]["refits"] == CRITICISM_RELOO,
          f"criticism: reloo refit {out['reloo']['refits']} points, want {CRITICISM_RELOO}")
    for i, (r, z) in enumerate(zip(nested, batch["log_z"])):
        b = max(tol["nested"], 4.0 * r.log_z_err)
        check(np.isfinite(r.log_z) and abs(r.log_z - z) <= b,
              f"criticism: nested_per_dataset {i}: log_z {r.log_z} not within {b} of {z}")
    check(_finite(wa.pointwise, lo.pointwise, pit.pit, draws[0].y_rep, draws[0].mu,
                  pred.mu, pred.y_rep, prior_draws[0].mu, prof.profile_lp,
                  list(sens.prior.values()), list(sens.likelihood.values()),
                  kf.pointwise, rl.pointwise, [ppc["p"]]),
          "criticism: a non-finite result")
    lv = out["launches_by_verb"]
    # the walker's equivalence probe ran on the journey unless it is cached
    probe = 0 if probed else 1
    want = {"cold_steps": CRITICISM_COLD + probe, "prior_cold_steps": CRITICISM_COLD + probe,
            "profile_likelihood": 3}
    for verb, counts in lv.items():
        check(counts["fused_posterior"] == want.get(verb, 0) and counts["chunk_rwm"] == 0,
              f"criticism: {verb} launched {counts}, want {want.get(verb, 0)} of kernel 1")
    return out


# The variational phase: ADVI, RealNVP flow VI, NeuTra, per-dataset
# VI and SBC, float32, synthetic data from seed 0.  Gates, fixed before the
# first chip run and never widened:
# - the line case (synthetic.line_evidence_case, W = 131072 warmed in on
#   kernel 1): full-rank advi() at its defaults within 0.1 of the closed
#   form with Pareto k < 0.7; its means within 0.25 closed-form sd of
#   beta_hat and its sds within 15 % of the closed form's; the meanfield
#   elbo no greater than full rank's + 0.05; the evaluation draws on kernel
#   1 (its launches, and its values against the plain posterior at RTOL);
#   after seed_walker, 1000 steps at T = 1 with acceptance in 0.2-0.4 and
#   the ensemble mean within 3 sd of beta_hat;
# - the banana (JAX tests/test_flow_vi.py:48-117's target and gates, float64
#   as there, flow_advi at its defaults; see VI_BANANA_DTYPE): the flow's
#   log_z within 0.15 of the truth, the Gaussian's at least 0.3
#   below it, flow elbo > Gaussian elbo + 0.3, Pareto k < 0.7, the
#   samples' quadratic coefficient > 0.8; neutra_sample (4096 walkers, mala,
#   2000 steps; :165-189's gates) |mean t1| < 0.15, |mean t2 - 1| < 0.25,
#   curvature > 0.9, min ESS > 0.3 of the retained chain samples,
#   acceptance 0.45-0.75; a save/load_flow round trip drawing identical
#   samples from one seed;
# - per dataset (16 line cases, 128 walkers each): every Gaussian log_z
#   within 0.1 of its closed form, every flow log_z within 0.2 of its
#   Gaussian, every converged_evidence true;
# - SBC (the line case's model, box and grid, 128 simulations of 64
#   walkers, 3000 steps; plain batched posterior): the study ok(), the
#   negative control (fitted with a third of the simulated noise) with its
#   worst p below 1e-3.
# The line fit's warm-in: 2000 adaptive steps at T = 1 from the generating
# parameters (kernel 1 once a step).  seed_walker keeps L and the moments
# (the JAX contract), and moments gathered at T = 10 make the cold run's
# first refresh overshoot: on the CPU at W = 2048 its chunks read 0.28,
# 0.14, 0.83, 0.69, 0.47 after a T = 10 anneal (0.48 over the 1000 steps;
# the first chip run, 0.483), and 0.37, 0.21, 0.20, 0.21, 0.21 after the
# T = 1 warm-in.
VI_LINE_ANNEAL = 2000
VI_LINE_COLD = 1000
VI_TOL = {"log_z": 0.1, "pareto_k": 0.7, "mean_sd": 0.25, "sd_rel": 0.15,
          "meanfield_elbo": 0.05, "cold_mean_sd": 3.0}
# The banana runs in float64, as the JAX test whose gates these are (its
# tests run with x64), and flow_advi at its defaults (12000 steps; the JAX
# test's 8000 stalled at partial curvature at seed 1 on the card).  Measured
# on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): at 8000
# steps the float32 flow met every flow gate at 2 of 5 seeds, seed 1 not
# (Pareto k 0.756); at 12000, 4 of 5 in float32 and in float64, seed 1 in
# both; the Gaussian's "0.3 below" gate held at 4 of 6 seeds in either
# type, at seed 1 in float64 (0.435 below) and not in float32 (0.245).
# The JAX package in float32 on the CPU misses it at 4 of 6 seeds too.
VI_BANANA_DTYPE = "float64"
VI_BANANA_WALKERS = 512
VI_BANANA_ANNEAL = 4000
VI_GAUSS_STEPS = 1200
VI_BANANA_TOL = {"flow_log_z": 0.15, "gauss_below": 0.3, "elbo_gap": 0.3, "curvature": 0.8}
VI_NEUTRA = {"n_steps": 2000, "kernel": "mala", "n_walkers": 4096, "seed": 1}
VI_NEUTRA_TOL = {"t1": 0.15, "t2": 0.25, "curvature": 0.9, "ess_share": 0.3,
                 "acceptance": (0.45, 0.75)}
VI_DATASETS = 16
VI_DATASET_WALKERS = 128
VI_DATASET_ANNEAL = 3000
VI_FLOW_PER_DATASET = {"n_steps": 1200, "n_samples": 64}
VI_DATASET_TOL = {"gauss": 0.1, "flow": 0.2}
VI_SBC = {"n_sims": 128, "walkers_per_dataset": 64, "n_steps": 3000, "seed": 0}
VI_SBC_CONTROL_P = 1e-3
# 100 steps a profiled optimizer run (400 until the pooling phase took its
# share of the script's time; a readout, run three times a verb)
VI_PROFILE_STEPS = 100
VI_SBC_PROFILE_STEPS = 20


def _banana_walker():
    """JAX tests/test_flow_vi.py:74-90's banana: t1 ~ N(0, 1), t2 | t1 ~
    N(t1^2, 0.25^2) under the box t1 in (-6, 6), t2 in (-2, 10), annealed at
    T = 2; returns it and the closed-form log Z."""
    import math
    import torch
    import lisp_mcmc_torch as mfit

    bounds = {"t1": (-6.0, 6.0), "t2": (-2.0, 10.0)}

    def model(x, p):
        return torch.zeros_like(x)

    def loglik(fn, params, dataset):
        t1, t2 = params["t1"].reshape(-1), params["t2"].reshape(-1)
        return -0.5 * t1 ** 2 - 0.5 * ((t2 - t1 ** 2) / 0.25) ** 2

    w = mfit.walker_create(function=model, data=([0.0, 1.0], [0.0, 0.0]),
                           params={"t1": 0.5, "t2": 0.5}, log_likelihood=loglik,
                           n_walkers=VI_BANANA_WALKERS, seed=0, walker_jitter=0.5,
                           log_prior=mfit.make_bounds_prior(bounds),
                           dtype=getattr(torch, VI_BANANA_DTYPE), device=DEVICE)
    w.adaptive_steps(VI_BANANA_ANNEAL, temperature=2.0, auto=None)
    return w, math.log(2 * math.pi * 0.25) - math.log(12.0 * 12.0)


def _profile_steps(name, fn, steps):
    """Wall ms and the device's time (torch.profiler) of one warm ``fn()``
    that runs ``steps`` optimizer steps, per step: kernels a step and the
    device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return {"what": name, "steps": steps, "ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps if rows else None,
            "kernels_per_step": sum(e.count for e in rows) / steps,
            "device_busy_share": device_ms / wall_ms if rows else None}


def _curvature(samples):
    import numpy as np

    return float(np.polyfit(samples[:, 0], samples[:, 1], 2)[0])


def phase_variational(ceilings, counters, ptxas):
    """Variational inference and SBC on the card (see the constants above):
    ADVI on the line case with its evaluation draws on kernel 1, then
    seed_walker and 1000 cold steps on kernel 1; the flow, a Gaussian and
    NeuTra on the banana (plain: a custom likelihood); advi_per_dataset and
    flow_advi_per_dataset on 16 line cases; sbc_check and its negative
    control.  Reports each verb's seconds and kernel-1 launches, the
    optimizer's ms and kernels a step and the device's busy share; returns
    the kernels line's ``fused_posterior_line_vi`` row (kernel 1 at the
    evaluation draws' W = 2048)."""
    import dataclasses
    import numpy as np
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import batched, models, synthetic
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)

    t_phase = time.perf_counter()
    out = {"phase": "variational", "seconds_by_verb": {}, "launches_by_verb": {}}

    def timed(name, fn):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out["seconds_by_verb"][name] = time.perf_counter() - t0
        out["launches_by_verb"][name] = {c.__name__: c.launches for c in counters}
        return r

    # 1. the line case: ADVI with its evaluation draws on kernel 1
    case = synthetic.line_evidence_case()
    sd_cf = dict(zip(("m", "b"), np.sqrt(np.diag(case["cov"]))))
    w = mfit.walker_create(
        function=models.line, data=(case["x"], case["y"]), params=case["truth"],
        data_error=case["sigma"], log_prior=mfit.make_bounds_prior(case["bounds"]),
        n_walkers=W_FLAGSHIP, seed=0, walker_jitter=0.05, dtype=torch.float32,
        device=DEVICE)
    timed("line_anneal", lambda: w.adaptive_steps(VI_LINE_ANNEAL, temperature=1.0,
                                                  auto=None))
    post = prepare_fused_terms(w.terms, w.spec, torch.float32)
    check(post is not None and post.rest == (), "variational: the line fit is not on kernel 1")
    fused = w._runner_cache["_fused"]
    seen = []

    def recorded(positions):
        seen.append(positions)
        return fused(positions)

    w._runner_cache["_fused"] = recorded
    vi = timed("advi", lambda: w.advi())
    mf = timed("advi_meanfield", lambda: w.advi(rank="meanfield"))
    w._runner_cache["_fused"] = fused
    lv = out["launches_by_verb"]
    vi_launches = {k: lv["advi"][k] + lv["advi_meanfield"][k] for k in lv["advi"]}
    evals = [p for p in seen if p.shape[0] == 2048]
    check(len(evals) == 2 and len(seen) == 2,
          f"variational: kernel 1 saw {[tuple(p.shape) for p in seen]}, want two "
          "evaluations of 2048 draws")
    rel, abs_err = _fused_check(post, evals[0], RTOL["float32"], "variational advi draws")
    timed("seed_walker", lambda: vi.seed_walker(w, seed=1))
    timed("cold_steps", lambda: w.adaptive_steps(VI_LINE_COLD, temperature=1.0, auto=None))
    cold_mean = dict(zip(w.spec.keys, w.state.position.double().mean(0).cpu().numpy()))
    line = {"W": W_FLAGSHIP, "closed_form_log_z": case["log_z"],
            "full": {"log_z": vi.log_z, "elbo": vi.elbo, "log_z_error": vi.log_z_error,
                     "pareto_k": vi.pareto_k, "mean": vi.mean, "sd": vi.sd},
            "meanfield": {"log_z": mf.log_z, "elbo": mf.elbo, "pareto_k": mf.pareto_k},
            "beta_hat": case["beta_hat"], "sd_closed_form": sd_cf,
            "eval_max_rel_err": rel, "cold_acceptance": w.acceptance(),
            "cold_mean": {k: float(v) for k, v in cold_mean.items()}}
    out["line"] = line
    pos = evals[0]
    kernel1 = {"W": int(pos.shape[0]), "max_rel_err": rel, "max_abs_err": abs_err,
               **_kernel1(pos, post, ptxas),
               "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(pos, post), 20),
               **_bounds(posterior_census(post), 1, fused_bytes(post, pos.shape[0]),
                         ceilings, walkers=int(pos.shape[0]))}
    out["kernel1"] = kernel1
    out["line"]["advi_step"] = _profile_steps(
        "advi full rank, 8 draws", lambda: w.advi(n_steps=VI_PROFILE_STEPS, n_eval=64),
        VI_PROFILE_STEPS)
    del w

    # 2. the banana: the flow, a Gaussian, NeuTra, a checkpoint round trip
    bw, truth = timed("banana_anneal", _banana_walker)
    fv = timed("flow_advi", lambda: bw.flow_advi(seed=1))
    g = timed("banana_advi", lambda: bw.advi(n_steps=VI_GAUSS_STEPS, seed=1))
    s = fv.sample(4000, seed=2)
    before = bw.state.position.clone()
    res = timed("neutra_sample", lambda: fv.neutra_sample(bw, **VI_NEUTRA))
    T, W_n, _ = res.samples_by_step.shape
    chain = T * min(W_n, 64)
    path = os.path.join(ROOT, "build", "variational_flow.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fv.save(path)
    loaded = mfit.load_flow(path, bw)
    same_samples = bool(np.array_equal(fv.sample(4096, seed=9), loaded.sample(4096, seed=9)))
    banana = {"truth": truth, "walkers": VI_BANANA_WALKERS, "dtype": VI_BANANA_DTYPE,
              "flow_steps": fv.n_steps,
              "flow": {"log_z": fv.log_z, "elbo": fv.elbo, "pareto_k": fv.pareto_k,
                       "log_z_error": fv.log_z_error, "curvature": _curvature(s)},
              "gauss": {"log_z": g.log_z, "elbo": g.elbo, "pareto_k": g.pareto_k},
              "neutra": {"mean": res.mean(), "curvature": _curvature(res.samples),
                         "min_ess": res.min_ess(), "chain_samples": chain,
                         "acceptance": res.acceptance, "rows": int(T), "walkers": int(W_n),
                         "walker_untouched": bool(torch.equal(bw.state.position, before))},
              "checkpoint_same_samples": same_samples}
    out["banana"] = banana
    out["banana"]["flow_step"] = _profile_steps(
        "flow_advi, 4 layers x 32, 256 draws",
        lambda: bw.flow_advi(n_steps=VI_PROFILE_STEPS, n_eval=256, seed=1), VI_PROFILE_STEPS)
    del bw

    # 3. per dataset: 16 line cases
    batch = synthetic.line_evidence_batch(VI_DATASETS)
    bf = mfit.BatchedFit(models.line, batch["datasets"], batch["truth"],
                         data_error=batch["sigma"],
                         log_prior=mfit.make_bounds_prior(batch["bounds"]),
                         walkers_per_dataset=VI_DATASET_WALKERS, dtype=torch.float32,
                         device=DEVICE)
    timed("per_dataset_anneal", lambda: bf.adaptive_steps(VI_DATASET_ANNEAL, auto=None))
    gs = timed("advi_per_dataset", lambda: bf.advi_per_dataset())
    fs = timed("flow_advi_per_dataset", lambda: bf.flow_advi_per_dataset(**VI_FLOW_PER_DATASET))
    out["per_dataset"] = [
        {"closed_form": float(z), "gauss_log_z": a.log_z, "gauss_k": a.pareto_k,
         "flow_log_z": f.log_z, "flow_k": f.pareto_k,
         "converged": [a.converged_evidence, f.converged_evidence]}
        for a, f, z in zip(gs, fs, batch["log_z"])]
    del bf

    # 4. SBC on the plain batched posterior, timed inside
    made, fit_secs = [], []

    class TimedFit(batched.BatchedFit):
        def adaptive_steps(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = super().adaptive_steps(*args, **kwargs)
            torch.cuda.synchronize()
            fit_secs.append(time.perf_counter() - t0)
            made.append(self)
            return r

    box, x = case["bounds"], case["x"]
    real = batched.BatchedFit
    batched.BatchedFit = TimedFit
    try:
        ok_run = timed("sbc_check", lambda: mfit.sbc_check(
            models.line, box, x, case["sigma"], dtype=torch.float32, device=DEVICE,
            **VI_SBC))
        bad_run = timed("sbc_control", lambda: mfit.sbc_check(
            models.line, box, x, case["sigma"] / 3.0, dtype=torch.float32, device=DEVICE,
            simulate=lambda rng, mu: mu + case["sigma"] * rng.standard_normal(mu.shape),
            **VI_SBC))
    finally:
        batched.BatchedFit = real
    from lisp_mcmc_torch import plotting

    sbc_plot_seconds = {
        "sbc_rank_plot": save_plot(lambda f: plotting.sbc_rank_plot(ok_run, filename=f),
                                   "variational_sbc_ranks"),
        "sbc_rank_plot_control": save_plot(
            lambda f: plotting.sbc_rank_plot(bad_run, filename=f),
            "variational_sbc_ranks_control")}
    # the busy share over 20-step chunks of the study's fit (as batched_nv)
    sfit = made[0]
    sfit.config = dataclasses.replace(sfit.config, chunk_size=VI_SBC_PROFILE_STEPS)
    prof = _profile_chunks("variational_sbc_chunk", sfit._runner(with_history=False),
                           sfit.state, sfit.generator, args=(True, False, True),
                           steps=VI_SBC_PROFILE_STEPS)
    out["sbc"] = {"W": sfit.n_walkers, "p_values": ok_run.p_values, "ok": ok_run.ok(),
                  "sim_ok": int(np.sum(ok_run.sim_ok)),
                  "control_p_values": bad_run.p_values,
                  "fit_seconds": fit_secs, "ms_per_step": 1e3 * fit_secs[0] / VI_SBC["n_steps"],
                  "kernels_per_step": prof["kernels_per_chunk"] / VI_SBC_PROFILE_STEPS,
                  "device_busy_share": prof["device_busy_share"],
                  "plot_seconds": sbc_plot_seconds}
    del made, sfit
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    # the gates
    check(vi.log_z is not None and abs(vi.log_z - case["log_z"]) <= VI_TOL["log_z"],
          f"variational: advi log_z {vi.log_z} not within {VI_TOL['log_z']} of "
          f"{case['log_z']}")
    check(vi.pareto_k < VI_TOL["pareto_k"], f"variational: advi Pareto k {vi.pareto_k}")
    for k in ("m", "b"):
        check(abs(vi.mean[k] - case["beta_hat"][k]) <= VI_TOL["mean_sd"] * sd_cf[k],
              f"variational: advi mean {k} {vi.mean[k]} not within {VI_TOL['mean_sd']} sd "
              f"of {case['beta_hat'][k]}")
        check(abs(vi.sd[k] / sd_cf[k] - 1.0) <= VI_TOL["sd_rel"],
              f"variational: advi sd {k} {vi.sd[k]} not within 15 % of {sd_cf[k]}")
        check(abs(cold_mean[k] - case["beta_hat"][k]) <= VI_TOL["cold_mean_sd"] * sd_cf[k],
              f"variational: after seed_walker the mean {k} {cold_mean[k]} is not within "
              f"3 sd of {case['beta_hat'][k]}")
    check(mf.elbo <= vi.elbo + VI_TOL["meanfield_elbo"],
          f"variational: meanfield elbo {mf.elbo} above full rank's {vi.elbo} + 0.05")
    check(vi_launches["fused_posterior"] == 2 and lv["advi"]["fused_posterior"] == 1
          and lv["advi_meanfield"]["fused_posterior"] == 1
          and vi_launches["chunk_rwm"] == 0,
          f"variational: the advi evaluations launched {vi_launches}, want 2 of kernel 1")
    check(lv["cold_steps"]["fused_posterior"] == VI_LINE_COLD
          and lv["seed_walker"]["fused_posterior"] == 0,
          f"variational: {lv['cold_steps']} for {VI_LINE_COLD} cold steps")
    check(0.2 <= line["cold_acceptance"] <= 0.4,
          f"variational: cold acceptance {line['cold_acceptance']} outside 0.2-0.4")
    bt = VI_BANANA_TOL
    check(abs(fv.log_z - truth) < bt["flow_log_z"],
          f"variational: flow log_z {fv.log_z} not within {bt['flow_log_z']} of {truth}")
    check(g.log_z - truth < -bt["gauss_below"],
          f"variational: Gaussian log_z {g.log_z} not {bt['gauss_below']} below {truth}")
    check(fv.elbo > g.elbo + bt["elbo_gap"],
          f"variational: flow elbo {fv.elbo} not above Gaussian {g.elbo} + {bt['elbo_gap']}")
    check(fv.pareto_k < VI_TOL["pareto_k"], f"variational: flow Pareto k {fv.pareto_k}")
    check(banana["flow"]["curvature"] > bt["curvature"],
          f"variational: flow samples' curvature {banana['flow']['curvature']}")
    nt, nm = VI_NEUTRA_TOL, res.mean()
    check(abs(nm["t1"]) < nt["t1"] and abs(nm["t2"] - 1.0) < nt["t2"],
          f"variational: NeuTra mean {nm}")
    check(banana["neutra"]["curvature"] > nt["curvature"],
          f"variational: NeuTra curvature {banana['neutra']['curvature']}")
    check(banana["neutra"]["min_ess"] > nt["ess_share"] * chain,
          f"variational: NeuTra min ESS {banana['neutra']['min_ess']} of {chain}")
    lo, hi = nt["acceptance"]
    check(lo < res.acceptance < hi, f"variational: NeuTra acceptance {res.acceptance}")
    check(banana["neutra"]["walker_untouched"], "variational: NeuTra moved the caller's walker")
    check(same_samples, "variational: the reloaded flow draws other samples")
    for i, r in enumerate(out["per_dataset"]):
        check(abs(r["gauss_log_z"] - r["closed_form"]) <= VI_DATASET_TOL["gauss"],
              f"variational: dataset {i}: Gaussian log_z {r['gauss_log_z']} not within "
              f"{VI_DATASET_TOL['gauss']} of {r['closed_form']}")
        check(abs(r["flow_log_z"] - r["gauss_log_z"]) <= VI_DATASET_TOL["flow"],
              f"variational: dataset {i}: flow log_z {r['flow_log_z']} not within "
              f"{VI_DATASET_TOL['flow']} of its Gaussian's {r['gauss_log_z']}")
        check(all(r["converged"]), f"variational: dataset {i}: not converged_evidence ({r})")
    check(ok_run.ok(), f"variational: the SBC study failed ({ok_run.p_values})")
    check(min(bad_run.p_values.values()) < VI_SBC_CONTROL_P,
          f"variational: the SBC control passed ({bad_run.p_values})")
    for verb in ("banana_anneal", "flow_advi", "banana_advi", "neutra_sample",
                 "per_dataset_anneal", "advi_per_dataset", "flow_advi_per_dataset",
                 "sbc_check", "sbc_control"):
        check(lv[verb]["fused_posterior"] == 0 and lv[verb]["chunk_rwm"] == 0,
              f"variational: {verb} launched {lv[verb]}: its posterior is plain by design")

    return {"name": "fused_posterior_line_vi", "route": "cuda", "library_ms": None,
            "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
            "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117", "W": kernel1["W"],
            "launches": vi_launches["fused_posterior"] + lv["cold_steps"]["fused_posterior"],
            **{k: kernel1[k] for k in ("max_abs_err", "ms", "kernel_ms", "plan", "plain_ms",
                                       "bound_ms", "bound_by", "opmix_bound_ms")}}


# The pooling phase: compare_pooling on test.lisp's lineshape over 8
# spectra (synthetic.global_fit(8)'s data: 334 points each, the flagship's
# lineshape with each spectrum's own scale and background; the flagship
# model for every spectrum, sigma 1e-7, float32), pooled = the three
# parameters the truth shares.  The pooled fit is kernel 1 over 8 terms at
# d = 6, W = 8192; the partial fit the plain hierarchical posterior (d =
# 2*3 + 8*6 = 54, dense proposal) at W = 8192; the independent fit a
# BatchedFit of 8 x 1024.
# The guess is test.lisp's start (synthetic._GLOBAL_START's six flagship
# keys: linewidth 17.4 % low, x0 3.04 % low, and mix 0.1 where the truth
# is 3.1415: 0.10 rad from it modulo pi, since a sign of scale turns the
# angle by pi).  The population is declared from the guess (the default
# hyperpriors are "for exploration", hierarchical.py): mu ~
# Gaussian(guess, |guess|), the default, and tau ~ LogNormal(log(1e-3
# |guess|), 0.5), a spread of ~0.1 % of each parameter across the grid
# (the truth's is 0); the default tau ~ LogNormal(log(|guess|/4), 1)
# would let each spectrum's x0 wander ~700 from the population's, which
# pools nothing where the truth shares x0 exactly.  The W = 1024
# rehearsal in both packages (tests/pooling_witness.py, PERF.md PR 13)
# lands alike: x0 0.15-0.16 % from the truth, the linewidth mean 13.8-14.1
# % low and mix 0.1025 rad from it modulo pi (a single spectrum's best
# linewidth scatters ~15 % about the truth, and the population mean moves
# slowly from a tight population's start), the partial model 107-298 elpd
# below the independent one.  Gates, fixed before this start's first run
# on the card and never widened:
# - the three models score the same 2672 points, the weights sum to 1
#   (1e-6);
# - complete pooling loses decisively: its elpd below both others' by more
#   than 2 paired SEs (the spectra's scales differ up to 100x);
# - the partial fit's best hyper mu against roofline.FLAGSHIP within
#   POOL_MU_BAND: x0 within 1 % (relative), a third of the start's
#   offset, so the gate reads the fit's recovery; the linewidth within 29
#   % (relative) and mix within 0.21 rad modulo pi, twice the worse
#   package's rehearsal error rounded up: these two hold the start too, so
#   they read only that the fit stays on its branch and does not wander;
# - the card's float32 hierarchical posterior within POOL_F32_RTOL of a
#   float64 evaluation of the same inputs on the card at 64 walkers
#   (relative to max(|lp|, 1));
# - kernel 1 against its plain version at the pooled fit's shape within
#   RTOL["float32"], the global rows' bound;
# - launches over compare_pooling: kernel 1 n + 1 (the pooled fit's steps
#   and its equivalence probe) plus the pooled fit's cold mala rescue, 2 a
#   200-step chunk; kernel 2 none.  The partial and independent fits run
#   neither kernel (plain by design) and PSIS-LOO reads the plain
#   per-point likelihood.
POOL_SPECTRA = 8
POOL_KEYS = ("linewidth", "x0", "mix")
POOL_WALKERS = 8192
POOL_PER_DATASET = 1024
POOL_STEPS = 4000
POOL_MAX_SAMPLES = 256
POOL_MU_BAND = {"linewidth": 0.29, "x0": 0.01, "mix": 0.21}
POOL_F32_RTOL = 1e-4
POOL_TAU_SHARE = 1e-3
POOL_TAU_SIGMA = 0.5
POOL_F64_WALKERS = 64
POOL_PROFILE_STEPS = 20


def pooling_inputs():
    """The pooling phase's spectra (``synthetic.global_fit``), guess and
    declared population (``{key: (mu prior, tau prior)}``)."""
    import numpy as np
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch import synthetic
    from lisp_mcmc_torch.roofline import FLAGSHIP

    g = synthetic.global_fit(POOL_SPECTRA)
    guess = {k: synthetic._GLOBAL_START[k] for k in FLAGSHIP}
    hyper = {k: (mfit.Gaussian(guess[k], abs(guess[k])),
                 mfit.LogNormal(float(np.log(POOL_TAU_SHARE * abs(guess[k]))), POOL_TAU_SIGMA))
             for k in POOL_KEYS}
    return g, guess, hyper


def pooling_mu_err(mu):
    """The population means' distance from roofline.FLAGSHIP, as
    POOL_MU_BAND reads it: relative for the linewidth and x0, in radians
    modulo pi for mix."""
    import math
    from lisp_mcmc_torch.roofline import FLAGSHIP

    turn = (mu["mix"] - FLAGSHIP["mix"]) % math.pi
    return {"linewidth": abs(mu["linewidth"] / FLAGSHIP["linewidth"] - 1.0),
            "x0": abs(mu["x0"] / FLAGSHIP["x0"] - 1.0), "mix": min(turn, math.pi - turn)}


def pooling_compare(device, n_walkers=POOL_WALKERS, walkers_per_dataset=POOL_PER_DATASET):
    """``compare_pooling`` on the phase's inputs at ``n_walkers`` (and
    ``walkers_per_dataset`` for the independent fit) on ``device``, float32:
    ``(result, summary)``, the summary a dict of what the gates read.  The
    phase calls it on the card; ``tests/pooling_witness.py``, the CPU
    rehearsal its gates came from, calls it beside the JAX package."""
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.models import lorder_mixed_bg

    g, guess, hyper = pooling_inputs()
    t0 = time.perf_counter()
    r = mfit.compare_pooling(lorder_mixed_bg, g["data"], guess, data_error=1e-7,
                             pooled=list(POOL_KEYS), hyper=hyper, n_steps=POOL_STEPS,
                             n_walkers=n_walkers, walkers_per_dataset=walkers_per_dataset,
                             max_samples=POOL_MAX_SAMPLES, seed=0, dtype=torch.float32,
                             device=device)
    h = r.fits["partial"]
    hp = h.hyper_params("best")
    summary = {
        "W": n_walkers, "walkers_per_dataset": walkers_per_dataset, "steps": POOL_STEPS,
        "guess": {k: guess[k] for k in POOL_KEYS},
        "compare_seconds": time.perf_counter() - t0, "fit_seconds": r.seconds,
        "fits": {k: {"d": f.spec.ndim, "W": f.n_walkers, "acceptance": f.acceptance()}
                 for k, f in r.fits.items()},
        "elpd": r.elpd, "se": r.se, "weights": r.weights, "best": r.best,
        "decisive": r.decisive, "pairwise": r.pairwise,
        "n_points": {k: v.n_points for k, v in r.results.items()},
        "hyper_best": hp, "hyper_median": h.hyper_params("median"),
        "mu_err": pooling_mu_err(hp["mu"]),
        "x0_per_dataset": [p["x0"] for p in h.params_per_dataset("best")],
        "partial_best_lp": h.most_likely_step()[0]}
    return r, summary


def phase_pooling(ceilings, counters, ptxas):
    """compare_pooling on the card (see the constants above): each fit's
    seconds, the launches, kernel 1 at the pooled 8-term shape against its
    plain version (the kernels line's ``fused_posterior_pooled8`` row), the
    float32 hierarchical posterior against float64, and 20-step rwm and
    mala chunks of the hierarchical fit profiled (ms a step, torch kernels a
    step, the device's busy share)."""
    import dataclasses
    import torch
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.models import lorder_mixed_bg
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)
    from lisp_mcmc_torch.roofline import FLAGSHIP, N_POINTS

    t_phase = time.perf_counter()
    # 1. compare_pooling, the launches counted over all three fits
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    r, summary = pooling_compare(DEVICE)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    out = {"phase": "pooling", "spectra": POOL_SPECTRA, **summary, "launches": launches}
    h, w_pool = r.fits["partial"], r.fits["pooled"]

    # 2. kernel 1 at the pooled fit's shape (8 terms x 334 points, d = 6)
    post = prepare_fused_terms(w_pool.terms, w_pool.spec, torch.float32)
    check(post is not None and len(post.terms) == POOL_SPECTRA,
          "pooling: the pooled fit is outside kernel 1's coverage")
    pos = w_pool.state.position.contiguous()
    rel, abs_err = _fused_check(post, pos, RTOL["float32"], "pooling fused 8 terms")
    kernel1 = {"W": int(pos.shape[0]), "terms": len(post.terms), "max_rel_err": rel,
               "max_abs_err": abs_err, **_kernel1(pos, post, ptxas),
               "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(pos, post), 20),
               **_bounds(posterior_census(post), 1, fused_bytes(post, pos.shape[0]),
                         ceilings, walkers=int(pos.shape[0]))}
    out["kernel1"] = kernel1

    # 3. the card's float32 hierarchical posterior against float64
    g, guess, hyper = pooling_inputs()
    h64 = mfit.HierarchicalFit(lorder_mixed_bg, g["data"], guess, data_error=1e-7,
                               pooled=list(POOL_KEYS), hyper=hyper,
                               n_walkers=POOL_F64_WALKERS, seed=0,
                               dtype=torch.float64, device=DEVICE)
    idx = torch.linspace(0, POOL_WALKERS - 1, POOL_F64_WALKERS).long().to(DEVICE)
    at = h.state.position[idx]
    lp32 = h._log_post(at).double()
    lp64 = h64._log_post(at.double())
    f32_rel = float(((lp32 - lp64).abs() / lp64.abs().clamp_min(1.0)).max())
    out["float32_vs_float64"] = {"walkers": POOL_F64_WALKERS, "max_rel_err": f32_rel,
                                 "lp64_max": float(lp64.max())}

    # 4. where a hierarchical step's time goes: 20-step rwm and mala chunks
    prof = {}
    for kind in ("rwm", "mala"):
        prev = h.config
        h.config = dataclasses.replace(prev, kernel=kind, chunk_size=POOL_PROFILE_STEPS)
        try:
            run = h._runner(with_history=False)
        finally:
            h.config = prev
        p = _profile_chunks(f"pooling_hierarchical_{kind}_chunk", run, h.state, h.generator,
                            args=(True, False, True), steps=POOL_PROFILE_STEPS)
        prof[kind] = {"ms_per_step": p["chunk_wall_ms"] / POOL_PROFILE_STEPS,
                      "kernels_per_step": p["kernels_per_chunk"] / POOL_PROFILE_STEPS,
                      "device_busy_share": p["device_busy_share"]}
    out["hierarchical_step"] = prof
    from lisp_mcmc_torch import plotting

    out["plot_seconds"] = {
        f"forest_{name}": save_plot(lambda f: plotting.forest_plot(r.fits[name], "x0",
                                                                    filename=f),
                                    f"pooling_forest_{name}")
        for name in ("partial", "independent")}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    # the gates
    n_real = POOL_SPECTRA * N_POINTS
    check(set(out["n_points"].values()) == {n_real},
          f"pooling: the models scored {out['n_points']}, want {n_real} points each")
    check(abs(sum(r.weights.values()) - 1.0) <= 1e-6, f"pooling: weights {r.weights}")
    for other in ("partial", "independent"):
        d = r.pairwise[f"pooled_vs_{other}"]
        check(d["elpd_diff"] < -2.0 * d["se_diff"],
              f"pooling: complete pooling does not lose decisively to {other} ({d})")
    mu = out["hyper_best"]["mu"]
    for k in POOL_KEYS:
        check(out["mu_err"][k] <= POOL_MU_BAND[k],
              f"pooling: the partial fit's mu of {k} {mu[k]} is {out['mu_err'][k]} from "
              f"{FLAGSHIP[k]}, the band {POOL_MU_BAND[k]}")
    check(f32_rel <= POOL_F32_RTOL,
          f"pooling: float32 hierarchical posterior {f32_rel} from float64")
    mala_chunks = -(-max(2000, POOL_STEPS // 2) // 200)
    want = POOL_STEPS + 1 + 2 * mala_chunks
    check(launches["fused_posterior"] == want and launches["chunk_rwm"] == 0,
          f"pooling: compare_pooling launched {launches}, want {want} of kernel 1 (the "
          "pooled fit) and none of kernel 2")

    return {"name": "fused_posterior_pooled8", "route": "cuda", "library_ms": None,
            "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
            "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117", "W": kernel1["W"],
            "terms": kernel1["terms"], "launches": want,
            **{k: kernel1[k] for k in ("max_abs_err", "ms", "kernel_ms", "plan", "plain_ms",
                                       "bound_ms", "bound_by", "opmix_bound_ms")}}


# The hier_refit phase: nv.HierarchicalNVFit over synthetic.nv_scan_grid(4,
# 4) (16 pixels of 401 points; d = 4 + 16 x 6 = 100, so the block proposals
# run), W = 4096, float32, started from the fit's own guesses
# (guess_nv_params of each pixel's data), not from the truth: an anneal of
# HIER_ANNEAL rwm steps at T = 10, then HIER_COLD chees steps at T = 1 (in
# the CPU witness rwm alone, 20000 steps, and 4000 mala steps after it each
# left pixels 0.5 MHz off and the fit ~170 nats under lp(truth); 200 chees
# steps reached the mode), then every walker restarted at the best point
# and HIER_SAMPLE more chees steps, the history the gates and the
# cross-validation read (the first chees phase's history holds walkers
# still climbing, and PSIS-LOO then flags 6355 of the 6416 points).  Gates,
# fixed before the phase's first chip call from the CPU witness
# (tests/hier_refit_witness.py: both packages at W = 512, float32; the port
# / JAX landed at max |mu1 err| 0.381 / 0.273 MHz, max |field offset err|
# 0.078 / 0.061 Oe, sigma's mean 10.289 / 10.078, kfold - reloo +27.0 /
# -13.0 nats, every refit through its gate, logo -6.98e8 / -6.91e8) and
# the truth (the guesses start 0-6.13 MHz off in mu1 and 0.71-1.71 Oe in
# the field offset):
# - each pixel's best mu1 within HIER_MU1_TOL MHz of its truth and its
#   field offset within HIER_OFFSET_TOL Oe (about twice the witness's
#   worst; a pixel that kept its guess fails both); the pooled sigma's
#   population mean (the median over the sampled history) within
#   HIER_SIGMA_TOL of 10 (every pixel's guessed linewidth is 10, so this
#   reads only that the population stays with its pixels);
# - the cross-validation of that fit, each verb's refits the joint
#   hierarchical posterior as K groups of one walker (plain, no kernel):
#   kfold(k=4), reloo of the points whose Pareto k is at or above the 4th
#   highest (capped at 0.7, tests/test_hier_refit.py:82-116), logo(); every
#   fold_ok / refit_ok true and no refit_failed, every elpd finite, and
#   kfold's elpd within HIER_KFOLD_RELOO_NATS of reloo's (about twice the
#   witness's larger gap; kfold's se is ~48).  logo's elpd is ~-7e8: a new
#   pixel's resonances and amplitudes are not pooled, so they are drawn
#   from their uniform boxes, and nearly every such spectrum misses the
#   held-out one by many noise widths;
# - no kernel launch anywhere in the phase (the hierarchical and grouped
#   posteriors are plain by design, as in the JAX package).
HIER_GRID = (4, 4)
HIER_WALKERS = 4096
HIER_ANNEAL = 6000
HIER_COLD = 300
HIER_COLD_KERNEL = "chees"
HIER_SAMPLE = 200
HIER_MU1_TOL = 0.75
HIER_OFFSET_TOL = 0.2
HIER_SIGMA_TOL = 0.5
HIER_CV_STEPS = 2000
HIER_CV_WALKERS = 64
HIER_KFOLD = 4
HIER_RELOO_RANK = 4
HIER_RELOO_MAX = 8
HIER_LOGO_Z = 16
HIER_MAX_SAMPLES = 128
HIER_LOO_SAMPLES = 512
HIER_KFOLD_RELOO_NATS = 60.0
HIER_F64_WALKERS = 64
HIER_PROFILE_STEPS = 20
HIER_WAIT_S = 900.0      # how long a cross-validation worker waits for the fit


def hier_refit_fit(device, n_walkers=HIER_WALKERS):
    """The hier_refit phase's fit on ``device``, float32: ``(fit, truths,
    summary)``, the summary what the gates read.  The phase calls it on the
    card; ``tests/hier_refit_witness.py`` on the CPU beside the JAX
    package."""
    import torch
    from lisp_mcmc_torch import nv, synthetic

    x, ys, truths = synthetic.nv_scan_grid(*HIER_GRID, seed=0)
    fit = nv.HierarchicalNVFit([(x, y) for y in ys], n_walkers=n_walkers, seed=0,
                               dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    fit.adaptive_steps(HIER_ANNEAL, auto=None)
    anneal_acc = fit.acceptance()
    fit.reset()
    fit.sampling_steps(HIER_COLD, kernel=HIER_COLD_KERNEL)
    fit.reset_to_most_likely()
    fit.sampling_steps(HIER_SAMPLE, kernel=HIER_COLD_KERNEL)
    _sync(device)
    summary = {"W": n_walkers, "d": fit.spec.ndim, "pixels": fit.n_spectra,
               "blocks": [fit.config.block_hyper, fit.config.block_local,
                          fit.config.block_count],
               "anneal": HIER_ANNEAL, "cold": [HIER_COLD_KERNEL, HIER_COLD, HIER_SAMPLE],
               "fit_seconds": time.perf_counter() - t0,
               "acceptance_anneal": anneal_acc, "acceptance_cold": fit.acceptance()}
    summary.update(hier_fit_errors(fit, truths))
    return fit, truths, summary


def hier_fit_errors(fit, truths):
    """Each pixel's best mu1 and field offset against the truth, and the
    pooled sigma's population mean (the median over the history)."""
    import numpy as np

    best = fit.best_params_per_spectrum()
    mu1 = np.asarray([b["mu1"] - t["mu1"] for b, t in zip(best, truths)])
    offset = np.asarray([o - (t["mu2"] - t["mu1"]) / 2 / 2.8
                         for o, t in zip(fit.field_offsets(), truths)])
    sigma_mu = float(fit.hyper_params("median")["mu"]["sigma"])
    return {"mu1_err": mu1.tolist(), "offset_err": offset.tolist(),
            "max_mu1_err": float(np.abs(mu1).max()),
            "max_offset_err": float(np.abs(offset).max()),
            "sigma_mu": sigma_mu, "sigma_mu_err": abs(sigma_mu - 10.0)}


def hier_cv_verb(fit, verb, flagged=None, on_refit=None):
    """One cross-validation verb of the phase on ``fit`` (``"kfold"``,
    ``"loo"``, ``"reloo"`` of the points above the returned ``loo``'s
    threshold, given as ``flagged = (loo result, threshold)``, or
    ``"logo"``): ``(result, summary)``, timed with a synchronize around it;
    ``on_refit(refit_walker)`` is called after its refit's run."""
    import numpy as np
    from lisp_mcmc_torch import diagnostics

    cv = dict(n_steps=HIER_CV_STEPS, walkers_per_dataset=HIER_CV_WALKERS,
              max_samples=HIER_MAX_SAMPLES, seed=0)
    real_run = diagnostics._run_refit

    def run_refit(rfit, n_steps, temperature, burn_fraction):
        real_run(rfit, n_steps, temperature, burn_fraction)
        if on_refit is not None:
            on_refit(rfit)

    diagnostics._run_refit = run_refit
    try:
        _sync(fit.device)
        t0 = time.perf_counter()
        if verb == "kfold":
            r = diagnostics.kfold(fit, k=HIER_KFOLD, **cv)
        elif verb == "loo":
            r = diagnostics.loo(fit, max_samples=HIER_LOO_SAMPLES)
        elif verb == "reloo":
            r = diagnostics.reloo(fit, flagged[0], k_threshold=flagged[1],
                                  max_refits=HIER_RELOO_MAX, **cv)
        else:
            r = fit.logo(n_z=HIER_LOGO_Z, **cv)
        _sync(fit.device)
        secs = time.perf_counter() - t0
    finally:
        diagnostics._run_refit = real_run
    if verb == "kfold":
        out = {"elpd": r.elpd, "se": r.se, "fold_ok": r.fold_ok.tolist(),
               "n_points": r.n_points, "folds": r.folds.tolist(),
               "finite": _finite(r.pointwise)}
    elif verb == "loo":
        k = np.sort(r.pareto_k)
        thr = min(0.7, float(k[-HIER_RELOO_RANK]) - 1e-6)
        out = {"elpd": r.elpd, "se": r.se, "max_k": float(k[-1]), "threshold": thr,
               "flagged": np.flatnonzero(r.pareto_k > thr).tolist()}
    elif verb == "reloo":
        out = {"elpd": r.elpd, "refit_failed": list(r.refit_failed),
               "max_k": float(r.pareto_k.max()), "finite": _finite(r.pointwise)}
    else:
        out = {"elpd": r.elpd, "se": r.se, "elpd_per_dataset": r.elpd_per_dataset.tolist(),
               "refit_ok": r.refit_ok.tolist(),
               "finite": _finite(r.elpd_per_dataset, [r.elpd, r.se])}
    return r, {**out, "seconds": secs}


def _launches():
    """This process's launches of the three kernels so far."""
    from lisp_mcmc_torch.ops.chunk_kernel import chunk_rwm
    from lisp_mcmc_torch.ops.loglik_kernel import fused_posterior
    from lisp_mcmc_torch.ops.microbench import chain_probe

    return {c.__name__: c.launches for c in (fused_posterior, chunk_rwm, chain_probe)}


def hier_reloo(fit, profile=None):
    """loo, then reloo of the points at or above the HIER_RELOO_RANK-th
    highest Pareto k, on ``fit``: their summaries, and with ``profile``
    (a callable of the refit walker, after its run) its result too."""
    kept = []
    lo, loo = hier_cv_verb(fit, "loo")
    _, reloo = hier_cv_verb(fit, "reloo", (lo, loo["threshold"]), kept.append)
    return {"loo": loo, "reloo": reloo,
            **({"refit": profile(kept[0], loo["flagged"])} if profile else {})}


def hier_refit_cv(fit):
    """kfold, loo, reloo and logo on ``fit`` in turn at the phase's
    settings (the CPU witness; on the card each runs in a process of its
    own, :func:`hier_worker`)."""
    out = {"kfold": hier_cv_verb(fit, "kfold")[1], **hier_reloo(fit),
           "logo": hier_cv_verb(fit, "logo")[1]}
    return _cv_totals(out)


def _cv_totals(out):
    out["seconds"] = {v: out[v]["seconds"] for v in ("kfold", "loo", "reloo", "logo")}
    out["kfold_minus_reloo"] = out["kfold"]["elpd"] - out["reloo"]["elpd"]
    return out


def _refit_profile(r, flagged):
    """A profiled 20-step mala chunk of the grouped refit walker ``r`` (ms a
    step, torch kernels a step, the device's busy share, in this process),
    and its posterior in float32 against float64 at its walkers (the same
    leave-out blocks, rebuilt in float64 from the phase's data)."""
    import dataclasses
    import numpy as np
    import torch
    from lisp_mcmc_torch import nv, synthetic

    prev = r.config
    r.config = dataclasses.replace(prev, kernel="mala", chunk_size=HIER_PROFILE_STEPS)
    try:
        run = r._runner(with_history=False)
    finally:
        r.config = prev
    p = _profile_chunks("hier_refit_grouped_mala_chunk", run, r.state, r.generator,
                        args=(True, False, True), steps=HIER_PROFILE_STEPS)
    x, ys, _ = synthetic.nv_scan_grid(*HIER_GRID, seed=0)
    f64 = nv.HierarchicalNVFit([(x, y) for y in ys], n_walkers=HIER_F64_WALKERS, seed=0,
                               dtype=torch.float64, device=r.device)
    n = f64._n_real_points
    g64 = f64._grouped_joint_walker(
        f64._holdout_data("reloo", [np.arange(n) != i for i in flagged]), len(flagged),
        r.n_walkers // len(flagged), 0, r.state.position.double().cpu())
    lp32 = r._log_post(r.state.position).double()
    lp64 = g64._log_post(r.state.position.double())
    return {"grouped_step": {"W": r.n_walkers, "groups": r.n_groups,
                             "ms_per_step": p["chunk_wall_ms"] / HIER_PROFILE_STEPS,
                             "kernels_per_step": p["kernels_per_chunk"] / HIER_PROFILE_STEPS,
                             "device_busy_share": p["device_busy_share"]},
            "float32_vs_float64": {
                "walkers": int(r.n_walkers),
                "max_rel_err": float(((lp32 - lp64).abs() / lp64.abs().clamp_min(1.0)).max())}}


HIER_JOBS = ("fit", "kfold", "reloo", "logo", "calibrated", "cauchy")


def hier_worker(path, job):
    """One job of the hierarchical phases in a process of its own, its
    summary (and the process's launches) printed as the last line of
    stdout: ``"fit"`` fits the phase's HierarchicalNVFit and hands it on
    through ``checkpoint.hierarchical_save`` to ``path`` (then
    ``path + ".done"``); ``"kfold"``, ``"reloo"`` (with loo and the refit's
    profile) and ``"logo"`` wait for that file and load the fit from it;
    ``"calibrated"`` and ``"cauchy"`` are the SBC study and its control.
    chip_smoke starts them all before ``batched_nv``: host-paced, they
    overlap it and each other."""
    import torch
    from lisp_mcmc_torch import checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    if job in ("calibrated", "cauchy"):
        out = hier_sbc_summary(DEVICE, job)
    elif job == "fit":
        fit, _, out = hier_refit_fit(DEVICE, HIER_WALKERS)
        checkpoint.hierarchical_save(fit, path)
        open(path + ".done", "w").close()
    else:
        t0 = time.perf_counter()
        while not os.path.exists(path + ".done"):
            check(time.perf_counter() - t0 < HIER_WAIT_S,
                  f"{job}: the fit never reached {path}")
            time.sleep(0.5)
        fit = checkpoint.hierarchical_load(path, device=DEVICE)
        out = (hier_reloo(fit, _refit_profile) if job == "reloo"
               else hier_cv_verb(fit, job)[1])
    print(json.dumps({**out, "launches": _launches()}), flush=True)


def start_hier_workers(path):
    """Every job of :func:`hier_worker`, each started in a process of its
    own; the hier phases collect them."""
    return {job: _spawn(f"hier_worker({path!r}, {job!r})", f"hier_{job}")
            for job in HIER_JOBS}


def _spawn(call, name):
    """``chip_smoke.<call>`` in a new Python process on DEVICE, its stderr
    kept in chiprun_out/worker_<name>.log."""
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    err = open(os.path.join(ROOT, "chiprun_out", f"worker_{name}.log"), "w")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as cs; "
            f"cs.DEVICE = {DEVICE!r}; cs.{call}")
    try:
        return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                                stdout=subprocess.PIPE, stderr=err)
    finally:
        err.close()


def _collect(proc, name):
    """A worker's summary (the last line of its stdout); its failure fails."""
    out, _ = proc.communicate()
    check(proc.returncode == 0 and out.strip(),
          f"worker {name} exited with {proc.returncode} (chiprun_out/worker_{name}.log)")
    return json.loads(out.strip().splitlines()[-1])


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_hier_refit(counters, procs, path):
    """The hierarchical NV fit and its refit cross-validation (see the
    constants above), from the worker processes ``procs`` of
    :func:`start_hier_workers` (the fit handed from one to the others by
    ``checkpoint.hierarchical_save`` at ``path``): each verb's seconds, the
    launches (none), the profiled grouped mala chunk of reloo's refit and
    its posterior in float32 against float64.  Returns the fit, loaded
    here, for the checkpoint step."""
    from lisp_mcmc_torch import checkpoint

    t_phase = time.perf_counter()
    res = {job: _collect(procs.pop(job), f"hier_{job}")
           for job in ("fit", "kfold", "reloo", "logo")}
    launches = {c.__name__: 0 for c in counters}
    for r in res.values():
        for k, v in r.pop("launches").items():
            launches[k] += v
    rl = res.pop("reloo")
    cv = _cv_totals({"kfold": res["kfold"], "loo": rl["loo"], "reloo": rl["reloo"],
                     "logo": res["logo"]})
    fit = checkpoint.hierarchical_load(path, device=DEVICE)
    for f in (path, path + ".done"):
        os.remove(f)
    out = {"phase": "hier_refit", **res["fit"], **cv, **rl["refit"], "launches": launches,
           "seconds_waited": time.perf_counter() - t_phase}
    emit(out)

    bad = [i for i, e in enumerate(out["mu1_err"]) if abs(e) > HIER_MU1_TOL]
    check(not bad, f"hier_refit: mu1 off by more than {HIER_MU1_TOL} MHz at pixels {bad} "
          f"({out['max_mu1_err']})")
    bad = [i for i, e in enumerate(out["offset_err"]) if abs(e) > HIER_OFFSET_TOL]
    check(not bad, f"hier_refit: field offset off by more than {HIER_OFFSET_TOL} Oe at "
          f"pixels {bad} ({out['max_offset_err']})")
    check(out["sigma_mu_err"] <= HIER_SIGMA_TOL,
          f"hier_refit: the pooled sigma's mean {out['sigma_mu']} not within "
          f"{HIER_SIGMA_TOL} of 10")
    kf, rl, lg = cv["kfold"], cv["reloo"], cv["logo"]
    check(all(kf["fold_ok"]) and not rl["refit_failed"] and all(lg["refit_ok"]),
          f"hier_refit: a refit failed its collapse gate (kfold {kf['fold_ok']}, "
          f"reloo {rl['refit_failed']}, logo {lg['refit_ok']})")
    flagged = cv["loo"]["flagged"]
    check(1 <= len(flagged) <= HIER_RELOO_MAX,
          f"hier_refit: reloo flagged {len(flagged)} points")
    check(kf["finite"] and rl["finite"] and lg["finite"], "hier_refit: a non-finite elpd")
    check(abs(out["kfold_minus_reloo"]) <= HIER_KFOLD_RELOO_NATS,
          f"hier_refit: kfold elpd {kf['elpd']} not within {HIER_KFOLD_RELOO_NATS} of "
          f"reloo's {rl['elpd']}")
    check(all(v == 0 for v in launches.values()),
          f"hier_refit: a kernel launched on the plain hierarchical path ({launches})")
    return fit


# The hier_sbc phase: sbc_check_hierarchical at the settings of JAX
# tests/test_sbc_hierarchical.py:27-59 (a pooled constant over 4 datasets of
# 8 points, sigma 0.5, mu ~ N(0, 1), tau ~ LogNormal(log 0.5, 0.4); 40
# simulations of 24 walkers, 3000 anneal + 3000 mala steps, seed 0), float32
# on the card.  Gates, that file's: the study ok() (every walk coordinate's
# ranks uniform at alpha 0.01, Bonferroni) with ranks spanning < 10 to > 53;
# the Cauchy-noise control not ok() with p(c__tau) < 1e-6.  Then the
# checkpoint step: a flagship walker (W = 131072) saved on the card after
# CHECKPOINT_STEPS, loaded, run on (CHECKPOINT_RESUME steps on kernel 1 and
# one chunk on the chunk kernel) beside the walker it came from: every state
# array bit for bit equal; and hier_refit's fit through hierarchical_save /
# hierarchical_load: its log posterior at the live ensemble bit for bit.
HIER_SBC = dict(n_sims=40, walkers_per_sim=24, n_steps=3000, sampling_steps=3000,
                sampling_kernel="mala", seed=0)
HIER_SBC_CONTROL_P = 1e-6
CHECKPOINT_STEPS = 400
CHECKPOINT_RESUME = 200


def hier_sbc_study(device, simulate=None, dtype=None):
    """One sbc_check_hierarchical study of the phase on ``device``."""
    import numpy as np
    import lisp_mcmc_torch as mfit

    def const_model(x, p):
        return p["c"] + 0.0 * x

    hyper = {"c": (mfit.Gaussian(0.0, 1.0), mfit.LogNormal(float(np.log(0.5)), 0.4))}
    return mfit.sbc_check_hierarchical(const_model, np.linspace(0.0, 1.0, 8), {"c": 0.0}, 4,
                                       data_error=0.5, hyper=hyper, simulate=simulate,
                                       device=device, dtype=dtype, **HIER_SBC)


def cauchy_sim(rng, mu):
    """The negative control's noise: Cauchy, where the fit declares Gaussian."""
    return mu + 0.5 * rng.standard_t(1, size=mu.shape)


def hier_sbc_summary(device, name):
    """The ``"calibrated"`` study or the ``"cauchy"`` control on ``device``:
    what the gates read, and its seconds (a synchronize around it)."""
    _sync(device)
    t0 = time.perf_counter()
    r = hier_sbc_study(device, simulate=cauchy_sim if name == "cauchy" else None)
    _sync(device)
    return {"ok": r.ok(), "p_values": r.p_values, "sim_ok": int(r.sim_ok.sum()),
            "rank_min": int(r.ranks.min()), "rank_max": int(r.ranks.max()),
            "seconds": time.perf_counter() - t0}


def phase_hier_sbc(counters, hier_fit, procs):
    """Hierarchical SBC and its negative control (their worker processes in
    ``procs``, from :func:`start_hier_workers`), then the checkpoint step
    (see the constants above)."""
    import dataclasses
    import torch
    from lisp_mcmc_torch import checkpoint

    t_phase = time.perf_counter()
    out = {"phase": "hier_sbc", **HIER_SBC,
           "launches": {c.__name__: 0 for c in counters}}
    for name in ("calibrated", "cauchy"):
        out[name] = _collect(procs.pop(name), f"hier_{name}")
        for k, v in out[name].pop("launches").items():
            out["launches"][k] += v
    out["seconds_waited"] = time.perf_counter() - t_phase
    emit(out)
    cal, cau = out["calibrated"], out["cauchy"]
    check(cal["ok"] and cal["rank_min"] < 10 and cal["rank_max"] > 53,
          f"hier_sbc: the calibrated study failed ({cal})")
    check(not cau["ok"] and cau["p_values"]["c__tau"] < HIER_SBC_CONTROL_P,
          f"hier_sbc: the Cauchy control passed ({cau})")
    check(all(v == 0 for v in out["launches"].values()),
          f"hier_sbc: a kernel launched on the plain grouped path ({out['launches']})")

    # the checkpoint step
    t0 = time.perf_counter()
    ck = {"phase": "checkpoint", "W": W_FLAGSHIP, "steps": CHECKPOINT_STEPS,
          "resume": CHECKPOINT_RESUME}

    def run_on(w):
        for c in counters:
            c.launches = 0
        w.adaptive_steps(CHECKPOINT_RESUME, auto=None)
        w.config = dataclasses.replace(w.config, posterior_impl="chunk_kernel")
        w.adaptive_steps(w.config.chunk_size, auto=None, collect_history=False)
        w.config = dataclasses.replace(w.config, posterior_impl="auto")
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in counters}

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "checkpoint_flagship.npz")
    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE)
    w.adaptive_steps(CHECKPOINT_STEPS, auto=None)
    checkpoint.walker_save(w, path)
    ck["launches_uninterrupted"] = run_on(w)
    r = checkpoint.walker_load(path, device=DEVICE)
    ck["launches_resumed"] = run_on(r)
    ck["bit_identical"] = {k: bool(torch.equal(getattr(r.state, k), getattr(w.state, k)))
                           for k in ("position", "logprob", "best_position", "best_logprob",
                                     "l_matrix", "m_sum", "m_outer", "m_count")}
    ck["file_mb"] = os.path.getsize(path) / 2**20
    os.remove(path)
    hpath = os.path.join(ROOT, "chiprun_out", "checkpoint_hier.npz")
    checkpoint.hierarchical_save(hier_fit, hpath)
    h = checkpoint.hierarchical_load(hpath, device=DEVICE)
    os.remove(hpath)
    at = hier_fit.state.position
    ck["hierarchical_equal"] = bool(torch.equal(h._log_post(at), hier_fit._log_post(at))
                                    and torch.equal(h.state.position, at))
    ck["seconds"] = time.perf_counter() - t0
    ck["seconds_phase"] = time.perf_counter() - t_phase
    emit(ck)
    check(all(ck["bit_identical"].values()),
          f"checkpoint: the resumed walker differs from the uninterrupted one "
          f"({ck['bit_identical']})")
    for run in ("launches_uninterrupted", "launches_resumed"):
        check(ck[run]["fused_posterior"] >= CHECKPOINT_RESUME and ck[run]["chunk_rwm"] == 1,
              f"checkpoint: {run} launched {ck[run]}, want kernel 1 a step and one chunk")
    check(ck["hierarchical_equal"],
          "checkpoint: the reloaded hierarchical fit's log posterior differs")
    return out


def _slice_noise(W, steps, cfg, generator):
    """One slice chunk's draws in the runner's ``noise=`` layout (ungrouped:
    G = 1, Bh = W/2), the shrink uniforms for the whole budget."""
    import torch

    bh = W // 2
    shape = (steps, 2, 1, bh)
    kw = dict(generator=generator, device=DEVICE)
    return {"j": torch.stack([torch.randint(0, bh, shape, **kw),
                              torch.randint(0, bh - 1, shape, **kw)], dim=-1),
            "e": torch.rand(shape, **kw), "i": torch.rand(shape, **kw),
            "k": torch.randint(0, cfg.slice_max_expand, shape, **kw),
            "shrink": torch.rand((steps, 2, cfg.slice_max_shrink, 1, bh), **kw)}


def phase_slice_poll(w):
    """One slice chunk of SLICE_POLL_STEPS steps at W = 131072 from the
    slice journey's end, for each SLICE_POLL value, in turns, its draws
    from the generator (the real path: timed); then each once more on the
    same injected draws, which must give the same chains."""
    import dataclasses
    import torch
    from lisp_mcmc_torch import kernel

    cfg = dataclasses.replace(w.config, kernel="slice", chunk_size=SLICE_POLL_STEPS)
    kept = kernel.SLICE_POLL
    times, evals, ends = {p: [] for p in SLICE_POLLS}, {}, {}
    g = torch.Generator(device=DEVICE)
    g.manual_seed(7)
    noise = _slice_noise(W_FLAGSHIP, SLICE_POLL_STEPS, cfg, g)
    try:
        for p in SLICE_POLLS + SLICE_POLLS[::-1]:
            kernel.SLICE_POLL = p
            run, _ = kernel.build_chunk_runner(w._batched_posterior(), w.ndim, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, out = run(w.state, True, True, True, generator=g)
            torch.cuda.synchronize()
            times[p].append((time.perf_counter() - t0) * 1e3 / SLICE_POLL_STEPS)
            if p not in ends:
                st, out = run(w.state, True, True, True, noise=noise)
                evals[p] = out["posterior_evals"] / SLICE_POLL_STEPS
                ends[p] = st.position
    finally:
        kernel.SLICE_POLL = kept
    same = all(torch.equal(ends[p], ends[SLICE_POLLS[0]]) for p in SLICE_POLLS)
    best = min(SLICE_POLLS, key=lambda p: sum(times[p]))
    out = {"phase": "slice_poll", "W": W_FLAGSHIP, "steps": SLICE_POLL_STEPS,
           "ms_per_step": times, "evals_per_step": evals, "same_chains": same,
           "fastest": best, "module_constant": kept}
    emit(out)
    check(same, "slice_poll: the SLICE_POLL values gave different chains")
    return out


def _profile_chunks(name, runner, state, generator, args=(True, True, False), steps=200):
    """Wall clock of two warm chunks of ``runner``, then the device time by
    kernel (torch.profiler) of one more and the host's time blocked in
    device-to-host reads (``aten::_local_scalar_dense``: a chees step's
    leapfrog count, a slice loop's poll); emits the ``name`` phase and
    returns it.  One profiled chunk, not two, since the pooling phase took
    its share of the script's time: the profiler's own processing of a
    slice chunk's events took ~40 s for two."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st = state

    def chunks(n):
        nonlocal st
        for _ in range(n):
            st, _ = runner(st, *args, generator=generator)
        torch.cuda.synchronize()

    chunks(2)
    t0 = time.perf_counter()
    chunks(2)
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunks(1)
    # device-side events only: a CPU op's entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    syncs = [e for e in prof.key_averages() if e.key == "aten::_local_scalar_dense"]
    out = {"phase": name, "W": int(state.position.shape[0]), "steps": steps,
           "chunk_wall_ms": wall_ms,
           "device_busy_ms": device_ms if rows else None,
           "device_busy_share": device_ms / wall_ms if rows else None,
           "kernels_per_chunk": sum(r[2] for r in rows),
           "host_sync_ms": sum(e.cpu_time_total for e in syncs) / 1e3,
           "host_syncs_per_chunk": sum(e.count for e in syncs),
           "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:8]]}
    emit(out)
    return out


def phase_profile():
    """Where a chunk of the default path (200 steps) spends its time.  The
    20-step slice chunk's profile left when the pooling phase took its share
    of the script's time (25.2 s, most of it the profiler's own processing;
    ``slice_poll`` still times the slice loops)."""
    import torch

    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE)
    _profile_chunks("profile_default_chunk", w._runner(with_history=True), w.state,
                    w.generator)


# The plotting step (after the journey): every Walker plot verb of the
# journey's walker (W = 131072, float32, the history keeping 4096 evenly
# spaced walkers) into chiprun_out/plots/, each figure's seconds, where
# matplotlib is installed; where it is not (the card's machine has none),
# the plots' device work alone: the envelope and the autocorrelation
# curves, each timed.  JAX's
# corner plots draw every retained point of ``take`` steps (1000 by
# default: 409,600 points a panel here, fifteen lower panels for six
# parameters), which matplotlib takes seconds a panel to draw at this
# scale (ROADMAP Queue 3); PLOT_TAKE keeps each scatter under
# PLOT_MAX_POINTS.  Gates: the card's _fit_envelope (the top 66 % of
# take = 1000's samples, capped at 20,000, over a 1000-point grid: 2e7
# model evaluations in one batched call) against the same top samples
# evaluated in float64 on the CPU, within PLOT_ENVELOPE_TOL of max |y|;
# autocorrelation_plot's curves against the plain numpy reduction (float64
# FFT of the same history), within PLOT_ACF_TOL.  Both tolerances were
# fixed from a CPU rehearsal before the first card run (float32 against
# float64 on the CPU, the journey's walker at W = 4096 after 4000 steps:
# envelope 1.08e-4 of max |y|, the float32 model's own rounding; curves
# 6.3e-6), at ~10x those.
PLOT_TAKE = {"corner_plot": 1000, "all_corner_plots": 200}
PLOT_MAX_POINTS = 2_000_000
PLOT_ENVELOPE_TOL = 1e-3
PLOT_ACF_TOL = 1e-4


def envelope_reference(w, term_index=0, take=1000, grid_points=1000, fraction=0.66,
                       rows=2048):
    """``plotting._fit_envelope`` recomputed in float64 on the CPU from the
    same top samples of the history, ``rows`` samples at a time:
    ``(grid, y_best, y_lo, y_hi)`` as numpy arrays."""
    import numpy as np
    import torch

    f64 = torch.float64
    term = w.terms[term_index]
    x = term.dataset.x[: term.dataset.n].detach().cpu().to(f64)
    grid = torch.linspace(float(x.min()), float(x.max()), grid_points, dtype=f64)
    pos, lp = w._history(take)
    flat_pos = np.asarray(pos).reshape(-1, w.ndim)
    flat_lp = np.asarray(lp).reshape(-1)
    keep = min(max(1, int(len(flat_lp) * fraction)), 20_000)
    params = torch.as_tensor(flat_pos[np.argsort(flat_lp)[-keep:]], dtype=f64)
    lo = torch.full((grid_points,), np.inf, dtype=f64)
    hi = torch.full((grid_points,), -np.inf, dtype=f64)
    for i in range(0, keep, rows):
        cols = {k: v[:, None] for k, v in w.spec.unflatten(params[i:i + rows]).items()}
        ys = torch.broadcast_to(term.fn(grid, cols), (cols[w.spec.keys[0]].shape[0],
                                                      grid_points))
        lo, hi = torch.minimum(lo, ys.amin(dim=0)), torch.maximum(hi, ys.amax(dim=0))
    best = w.spec.flatten(w.most_likely_params(), dtype=f64)
    y_best = torch.broadcast_to(term.fn(grid, w.spec.unflatten(best)), (grid_points,))
    return grid.numpy(), y_best.numpy(), lo.numpy(), hi.numpy()


def acf_reference(chain, max_lag=None):
    """The mean normalized autocorrelation over the walkers of a (T, W)
    history, in float64 on the host (``ops.reductions.autocorrelation``'s
    recipe: a zero-padded FFT, the unbiased normalization; numpy, with
    scipy's FFT on every core)."""
    import numpy as np
    from scipy import fft

    x = np.asarray(chain, np.float64)
    T = x.shape[0]
    x = x - x.mean(axis=0, keepdims=True)
    n = 1 << (2 * T - 1).bit_length()
    f = fft.rfft(x, n=n, axis=0, workers=-1)
    acov = fft.irfft(f * np.conj(f), n=n, axis=0, workers=-1)[:T]
    acov = acov / np.arange(T, 0, -1, dtype=np.float64)[:, None]
    var0 = np.where(acov[0] > 0, acov[0], 1.0)
    return (acov / var0)[: max_lag or T].mean(axis=1)


def plot_checks(w, plotting):
    """The envelope and the autocorrelation curves of ``w`` against their
    plain float64 versions: ``{"envelope_rel_err", "acf_abs_err"}``."""
    import numpy as np

    got = plotting._fit_envelope(w, 0, 1000, 1000, 0.66)
    ref = envelope_reference(w, 0, 1000, 1000, 0.66)
    scale = max(float(np.abs(ref[1]).max()), float(np.abs(ref[2]).max()),
                float(np.abs(ref[3]).max()))
    env = max(float(np.abs(np.asarray(g, np.float64) - r).max()) for g, r in
              zip(got[1:], ref[1:])) / scale
    pos, _ = w._history(None)
    acf = 0.0
    for k, rho, _ in plotting._autocorrelation_curves(w, None, None, None):
        want = acf_reference(np.asarray(pos)[:, :, w.spec.index(k)])
        acf = max(acf, float(np.abs(np.asarray(rho, np.float64) - want).max()))
    return {"envelope_rel_err": env, "acf_abs_err": acf, "envelope_keep":
            min(max(1, int(np.asarray(w._history(1000)[1]).size * 0.66)), 20_000)}


def phase_plotting(w):
    """The plotting step (see the constants above) on the journey's walker."""
    import numpy as np
    import torch
    from lisp_mcmc_torch import plotting

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "plots")
    os.makedirs(out_dir, exist_ok=True)
    drawn = plotting.plt is not None
    out = {"phase": "plotting", "W": W_FLAGSHIP, "history": list(w._history()[0].shape),
           "matplotlib": drawn, "seconds_by_figure": {}}
    rows = {k: int(np.prod(w._history(t)[0].shape[:2])) for k, t in PLOT_TAKE.items()}
    out["points_by_scatter"] = rows
    check(max(rows.values()) <= PLOT_MAX_POINTS,
          f"plotting: a scatter would draw {rows} points, over {PLOT_MAX_POINTS}")
    figures = [
        ("plot_data_and_fit", lambda f: w.plot_data_and_fit(filename=f)),
        ("plot_residuals", lambda f: w.plot_residuals(filename=f)),
        ("caterpillar_plots", lambda f: w.caterpillar_plots(filename=f)),
        ("likelihood_plot", lambda f: w.likelihood_plot(filename=f)),
        ("autocorrelation_plot", lambda f: w.autocorrelation_plot(filename=f)),
        ("corner_plot", lambda f: w.corner_plot("x0", "linewidth",
                                                take=PLOT_TAKE["corner_plot"], filename=f)),
        ("all_corner_plots", lambda f: w.all_corner_plots(
            take=PLOT_TAKE["all_corner_plots"], filename=f)),
        ("param_histogram", lambda f: w.param_histogram("x0", filename=f)),
        ("ppc_plot", lambda f: w.ppc_plot(filename=f)),
    ]
    if not drawn:
        figures = [
            ("envelope", lambda f: plotting._fit_envelope(w, 0, 1000, 1000, 0.66)),
            ("autocorrelation_curves",
             lambda f: plotting._autocorrelation_curves(w, None, None, None))]
    for name, draw in figures:
        path = os.path.join(out_dir, f"journey_{name}.png")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draw(path)
        torch.cuda.synchronize()
        out["seconds_by_figure"][name] = time.perf_counter() - t0
        check(not drawn or os.path.getsize(path) > 0, f"plotting: {name} wrote nothing")
    t0 = time.perf_counter()
    out.update(plot_checks(w, plotting))
    out["seconds_checks"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(out["envelope_rel_err"] <= PLOT_ENVELOPE_TOL,
          f"plotting: the card's envelope is {out['envelope_rel_err']} of max|y| from "
          f"the float64 CPU one (> {PLOT_ENVELOPE_TOL})")
    check(out["acf_abs_err"] <= PLOT_ACF_TOL,
          f"plotting: autocorrelation curves {out['acf_abs_err']} from numpy's "
          f"(> {PLOT_ACF_TOL})")
    return out


def save_plot(fig_fn, name):
    """Draw one figure of a later phase into chiprun_out/plots/: its
    seconds (None where matplotlib is not installed)."""
    from lisp_mcmc_torch import plotting

    if plotting.plt is None:
        return None
    out_dir = os.path.join(ROOT, "chiprun_out", "plots")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.png")
    t0 = time.perf_counter()
    fig_fn(path)
    secs = time.perf_counter() - t0
    check(os.path.getsize(path) > 0, f"{name}: the plot wrote nothing")
    return secs


# How many cold steps the journey's walker needs after reset_to_most_likely
# before audit's convergence verdict reads ok (ROADMAP Queue 3 item 3): one
# adaptive run at T = 1 of up to CONVERGE_CAP steps, audit(take =
# CRITICISM_TAKE) read every CONVERGE_READ steps from its on_chunk hook (so
# the run refreshes L as one long run does), stopping at the first ok.
CONVERGE_READ = 2000
CONVERGE_CAP = 30000


def measure_criticism_convergence(w):
    """Restart ``w`` at its best point and step it cold, reading audit's
    verdict every CONVERGE_READ steps until it reads ok or CONVERGE_CAP;
    emits each reading (steps, ok, worst rank R-hat, worst tail ESS,
    acceptance)."""
    import torch

    t0 = time.perf_counter()
    w.reset_to_most_likely()
    readings = []

    def on_chunk(step, m):
        if step % CONVERGE_READ:
            return False
        conv = w.audit(take=CRITICISM_TAKE).convergence
        readings.append({"steps": step, "ok": conv["ok"],
                         "rank_rhat": max(max(v) if isinstance(v, (list, tuple)) else v
                                          for v in conv["rank_rhat"].values()),
                         "tail_ess": min(conv["tail_ess"].values()),
                         "acceptance": m["accept_rate"]})
        return conv["ok"]

    w.adaptive_steps(CONVERGE_CAP, temperature=1.0, auto=None, on_chunk=on_chunk)
    torch.cuda.synchronize()
    out = {"phase": "criticism_convergence", "W": W_FLAGSHIP, "read_every": CONVERGE_READ,
           "take": CRITICISM_TAKE, "readings": readings,
           "converged_at": readings[-1]["steps"] if readings and readings[-1]["ok"] else None,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


# The shard phase: chain-axis sharding (lisp_mcmc_torch.parallel) on the one
# card.  Two worker processes (shard_worker) form a 2-rank gloo group on
# localhost (NCCL refuses two ranks on one device); each holds 65536 of the
# flagship's 131072 walkers, and gloo carries each all-reduce of CUDA
# tensors through host memory (the transport only: every computation stays
# on the card).  Kernel 1 evaluates a rank's walkers with the unsharded W's
# launch plan (fused_plan(post, W, force=)), so each walker's sums run in
# the unsharded order.  A third worker runs a world of one over NCCL.  The
# workers start before batched_nv and overlap it.  Every rank first steps
# SHARD_WARM rwm steps unsharded (the same on each), then:
# - one rwm chunk sharded and the same chunk unsharded in the same worker:
#   every position and logprob bit for bit equal, the moments within
#   SHARD_MOMENT_RTOL of sqrt(m_ii) / sqrt(m_ii m_jj) (float32 summation
#   rounding: the ranks' partial sums add in another order), one all-reduce;
# - a SHARD_MALA_STEPS mala chunk with the rescue, a stretch chunk and a
#   SHARD_CHEES_STEPS chees chunk likewise: positions within SHARD_RTOL (relative, per
#   coordinate) of the unsharded chunk's (JAX tests/test_parallel.py holds
#   these at rtol 1e-10 in float64; here float32, kernel 1's W/2 rescue and
#   half-step evaluations at their own plan, autograd through the plain
#   posterior at W/2);
# - a SHARD_FIT_STEPS sharded adaptive fit from the test.lisp start
#   (walker.shard()): the journey's gates (_quality), kernel-1 launches per
#   rank == steps + 1 (its probe) at W/2;
# - the NCCL world of one: the rwm chunk bit for bit, one all-reduce.
# Rank 0 and the world of one compute the unsharded chunks (the gathered
# sharded state is the same on every rank); rank 1 steps only its share.
SHARD_RANKS = 2
SHARD_WARM = 400
SHARD_MALA_STEPS = 100
SHARD_CHEES_STEPS = 20
SHARD_FIT_STEPS = 20000
SHARD_MOMENT_RTOL = 1e-4
SHARD_RTOL = 1e-5


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_shard_workers():
    """The shard phase's worker processes: SHARD_RANKS gloo ranks and the
    NCCL world of one."""
    port = _free_port()
    procs = {f"rank{r}": _spawn(f"shard_worker({r}, {SHARD_RANKS}, {port})",
                                f"shard_rank{r}") for r in range(SHARD_RANKS)}
    procs["nccl"] = _spawn(f"shard_worker(0, 1, {_free_port()})", "shard_nccl")
    return procs


def _moment_err(a, b):
    """Moments ``a`` against ``b`` (G, d) / (G, d, d), entry by entry
    relative to sqrt(m_ii) and sqrt(m_ii m_jj) of ``b``."""
    import torch

    diag = torch.diagonal(b.m_outer, dim1=1, dim2=2).clamp_min(1e-30)
    e_sum = ((a.m_sum - b.m_sum).abs() / diag.sqrt()).max()
    e_out = ((a.m_outer - b.m_outer).abs()
             / (diag[:, :, None] * diag[:, None, :]).sqrt()).max()
    return max(float(e_sum), float(e_out), float((a.m_count - b.m_count).abs().max()))


def shard_worker(rank, world, port):
    """One rank of the shard phase (see the constants above): prints its
    summary as the last line of its stdout."""
    import dataclasses
    import torch
    from lisp_mcmc_torch.kernel import build_chunk_runner
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_plan, fused_posterior,
                                                   prepare_fused_terms)
    from lisp_mcmc_torch.parallel import (chain_comm, initialize_distributed, make_mesh,
                                          shard_state)
    from lisp_mcmc_torch.roofline import FLAGSHIP

    backend = "gloo" if world > 1 else "nccl"
    initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                           world_size=world, backend=backend, device=DEVICE, timeout=300)
    mesh = make_mesh()
    comm = chain_comm(mesh)
    wl = W_FLAGSHIP // world
    out = {"rank": rank, "world": world, "backend": comm.backend, "W": W_FLAGSHIP,
           "W_rank": wl, "cases": {}}
    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE)
    w.adaptive_steps(SHARD_WARM, temperature=10.0, auto=None, collect_history=False)
    start = w.state
    post = prepare_fused_terms(w.terms, w.spec, torch.float32)
    plan = fused_plan(post, W_FLAGSHIP)
    force = (plan["threads"], plan["R"], plan["S"])
    out["plan"] = force

    def natural(positions):
        return fused_posterior(positions, post)

    def forced(positions):
        """Kernel 1 on a rank's walkers with the unsharded W's plan."""
        return fused_posterior(positions, post,
                               force=force if positions.shape[0] == wl else None)

    def whole(st):
        lo = comm.rank * st.position.shape[0]
        _, rows = comm.exchange(None, torch.cat([st.position, st.logprob[:, None]], 1),
                                lo, W_FLAGSHIP)
        return rows[:, :-1], rows[:, -1]

    def case(kernel, steps, flags):
        cfg = dataclasses.replace(w.config, kernel=kernel, chunk_size=steps)
        run, _ = build_chunk_runner(natural, w.ndim, cfg, eval_plain=w._log_post)
        run_m, _ = build_chunk_runner(forced if kernel == "rwm" else natural, w.ndim, cfg,
                                      eval_plain=w._log_post, mesh=mesh)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        (got, got_out), t_got = timed(lambda: run_m(
            shard_state(start, mesh), *flags,
            generator=torch.Generator(device=DEVICE).manual_seed(11)))
        pos, lp = whole(got)
        out = {"steps": steps, "collectives": int(got_out["collectives"]),
               "accept_rate_sharded": float(got_out["accept_rate"]),
               "seconds_sharded": t_got}
        if comm.rank:
            return out
        (ref, ref_out), t_ref = timed(lambda: run(
            start, *flags, generator=torch.Generator(device=DEVICE).manual_seed(11)))
        rel = ((pos - ref.position).abs() / ref.position.abs().clamp_min(1e-30)).max()
        return {**out, "positions_equal": bool(torch.equal(pos, ref.position)),
                "logprobs_equal": bool(torch.equal(lp, ref.logprob)),
                "position_rel_err": float(rel),
                "moment_err": _moment_err(got, ref),
                "l_rel_err": float(((got.l_matrix - ref.l_matrix).abs()
                                    / ref.l_matrix.abs().max()).max()),
                "accept_rate": float(ref_out["accept_rate"]),
                "seconds_unsharded": t_ref}

    out["cases"]["rwm"] = case("rwm", 200, (True, True, False))
    if world > 1:
        out["cases"]["mala_rescue"] = case("mala", SHARD_MALA_STEPS, (True, True, True))
        out["cases"]["stretch"] = case("stretch", 200, (True, True, False))
        out["cases"]["chees"] = case("chees", SHARD_CHEES_STEPS, (True, True, True))
        # the sharded adaptive fit, kernel 1 forced to the unsharded plan
        fit = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE).shard(mesh)
        fused_posterior.launches = 0
        fit._fused_posterior_probed("kernel")          # its probe: one launch at W/2
        fit_post = prepare_fused_terms(fit.terms, fit.spec, torch.float32)
        fit._runner_cache["_fused"] = lambda x: fused_posterior(
            x, fit_post, force=force if x.shape[0] == wl else None)
        calls = comm.calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit.adaptive_steps(SHARD_FIT_STEPS, temperature=10.0, auto=None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lp, best = fit.most_likely_step()
        out["fit"] = {"steps": SHARD_FIT_STEPS, "seconds": secs, "best_lp": lp,
                      "x0": best["x0"], "acceptance": fit.acceptance(),
                      "launches": fused_posterior.launches,
                      "collectives": comm.calls - calls,
                      "history": list(fit._history()[0].shape),
                      "x0_truth": FLAGSHIP["x0"]}
    print(json.dumps(out), flush=True)
    torch.distributed.barrier()
    # Leave without the group's teardown: a rank that tears down after its
    # peer (rank 0 hosts the store) has exited can abort in it.
    os._exit(0)


def phase_shard(ceilings, counters, procs, ptxas):
    """Collect the shard workers (see the constants above), gate them, and
    time kernel 1 at a rank's W/2 with the forced plan against its plain
    version: the kernels line's ``fused_posterior_shard`` row."""
    import torch
    from lisp_mcmc_torch.device import kernel_time_ms
    from lisp_mcmc_torch.ops.loglik_kernel import (fused_bytes, fused_kernel_entry,
                                                   fused_plan, fused_posterior,
                                                   fused_posterior_plain,
                                                   posterior_census, prepare_fused_terms)
    from lisp_mcmc_torch.roofline import FLAGSHIP

    t_phase = time.perf_counter()
    ranks = [_collect(procs.pop(f"rank{r}"), f"shard_rank{r}") for r in range(SHARD_RANKS)]
    nccl = _collect(procs.pop("nccl"), "shard_nccl")
    out = {"phase": "shard", "ranks": ranks, "nccl": nccl,
           "seconds_waited": time.perf_counter() - t_phase}

    # kernel 1 at a rank's W/2 with the unsharded plan, against its plain version
    wl = W_FLAGSHIP // SHARD_RANKS
    w = _flagship_walker(W_FLAGSHIP, torch.float32, DEVICE, params=FLAGSHIP, jitter=0.02)
    post = prepare_fused_terms(w.terms, w.spec, torch.float32)
    plan = fused_plan(post, W_FLAGSHIP)
    force = (plan["threads"], plan["R"], plan["S"])
    x = w.state.position[:wl]
    for c in counters:
        c.launches = 0
    got = fused_posterior(x, post, force=force)
    ref = fused_posterior_plain(x, post)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    rel = float((err / ref.abs().clamp_min(1.0)).max())
    fplan = fused_plan(post, wl, force)
    entry = fused_kernel_entry(ptxas["fused_posterior"], torch.float32, fplan)
    row = {"name": "fused_posterior_shard", "route": "cuda",
           "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
           "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117",
           "launches": ranks[0]["fit"]["launches"], "max_abs_err": float(err.max()),
           "ms": cuda_time_ms(lambda: fused_posterior(x, post, force=force), 200),
           "kernel_ms": kernel_time_ms(lambda: fused_posterior(x, post, force=force), 200,
                                       "fused_posterior"),
           "plan": {k: fplan[k] for k in ("threads", "R", "S", "blocks", "blocks_per_sm",
                                          "waves", "twin_class")},
           "plain_ms": cuda_time_ms(lambda: fused_posterior_plain(x, post), 5),
           **_bounds(posterior_census(post), 1, fused_bytes(post, wl), ceilings, walkers=wl),
           "library_ms": None}
    out["kernel1_forced"] = {"max_rel_err": rel, "registers": entry and entry["registers"],
                             "spills": entry and entry["spill_stores"], **row}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)

    check(rel <= RTOL["float32"], f"shard: kernel 1 at W/2 with the forced plan, relative "
          f"error {rel} > {RTOL['float32']}")
    check(entry is not None and entry["spill_stores"] == 0 and entry["spill_loads"] == 0,
          f"shard: the forced plan's kernel spills or has no ptxas entry ({entry})")
    lp_gen = _lp_generating()
    for r in ranks + [nccl]:
        tag = f"shard rank {r['rank']} of {r['world']} ({r['backend']})"
        rw = r["cases"]["rwm"]
        check(rw["collectives"] == 1, f"{tag}: {rw['collectives']} all-reduces a rwm chunk")
        if r["rank"] == 0:
            check(rw["positions_equal"] and rw["logprobs_equal"],
                  f"{tag}: the sharded rwm chunk differs from the unsharded one ({rw})")
            check(rw["moment_err"] <= SHARD_MOMENT_RTOL,
                  f"{tag}: moments {rw['moment_err']} > {SHARD_MOMENT_RTOL}")
            for name, c in r["cases"].items():
                check(c["position_rel_err"] <= SHARD_RTOL,
                      f"{tag}: {name} positions {c['position_rel_err']} from the unsharded "
                      f"chunk's (> {SHARD_RTOL})")
        if r["world"] > 1:
            f = r["fit"]
            check(f["launches"] == f["steps"] + 1,
                  f"{tag}: kernel 1 launched {f['launches']} times, want {f['steps']} + 1")
            check(f["best_lp"] >= lp_gen - 5.0,
                  f"{tag}: best lp {f['best_lp']} < lp(generating) {lp_gen} - 5")
            check(abs(f["x0"] - f["x0_truth"]) <= 0.01 * f["x0_truth"],
                  f"{tag}: x0 {f['x0']} not within 1% of {f['x0_truth']}")
            check(0.2 <= f["acceptance"] <= 0.4,
                  f"{tag}: final acceptance {f['acceptance']} outside 0.2-0.4")
    check(ranks[0]["fit"]["best_lp"] == ranks[1]["fit"]["best_lp"],
          "shard: the ranks disagree on the global best point")
    return row


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
    ptxas = phase_build()
    sass_file = tempfile.TemporaryFile()
    sass_proc = _start_kernel1_sass(sass_file)
    try:
        ceilings, probe_row = phase_roofline(counters)
        kernels = [phase_fused(ceilings, ptxas), phase_chunk(ceilings, ptxas)]
        phase_twins(ceilings, ptxas)
        phase_kernel1_sass(sass_proc, sass_file)
    finally:
        if sass_proc is not None and sass_proc.poll() is None:
            sass_proc.kill()
            sass_proc.wait()
        sass_file.close()
    global_walker, global_lp_gen = phase_global(ceilings, counters, ptxas)
    phase_chunk_wide(ceilings, ptxas)
    main_launches, journey_walker = phase_journey(counters)
    phase_plotting(journey_walker)
    chunk_launches = phase_chunk_journey(counters)
    phase_nv(ceilings, counters, ptxas)
    phase_nv_chunk(ceilings, counters, ptxas)
    half = phase_half_width(ceilings, ptxas)
    phase_tempered(ceilings, counters, ptxas)
    ensemble, slice_walker = phase_ensemble(counters)
    phase_slice_poll(slice_walker)
    phase_profile()
    rescue_row = phase_gradient(ceilings, counters, ptxas, ensemble)
    phase_chees_d24()
    phase_blocked(counters)
    prior_rows, prior_walker = phase_priors(ceilings, counters, ptxas, global_walker,
                                            global_lp_gen)
    del global_walker
    # the hierarchical phases' jobs, in processes of their own from here on
    hier_path = os.path.join(ROOT, "chiprun_out", "hier_refit_fit.npz")
    os.makedirs(os.path.dirname(hier_path), exist_ok=True)
    hier_procs = start_hier_workers(hier_path)
    shard_procs = start_shard_workers()
    try:
        phase_batched_nv(counters)
        shard_row = phase_shard(ceilings, counters, shard_procs, ptxas)
        evidence_rows = phase_evidence(ceilings, counters, ptxas)
        phase_criticism(counters, journey_walker, prior_walker)
        del journey_walker, prior_walker
        vi_row = phase_variational(ceilings, counters, ptxas)
        pool_row = phase_pooling(ceilings, counters, ptxas)
        hier_fit = phase_hier_refit(counters, hier_procs, hier_path)
        phase_hier_sbc(counters, hier_fit, hier_procs)
        del hier_fit
    finally:
        _stop(list(hier_procs.values()) + list(shard_procs.values()))
    kernels[0]["launches"] = main_launches["fused_posterior"]
    kernels[1]["launches"] = chunk_launches["chunk_rwm"]
    kernels.append(probe_row)
    # kernel 1 on the red-black samplers' half-ensembles: launches on the
    # three ensemble journeys (less each fit's full-width probe)
    h = half["half"]
    kernels.append({
        "name": "fused_posterior_half", "route": "cuda",
        "source": "lisp_mcmc_torch/csrc/fused_posterior.cu",
        "replaces": "lisp_mcmc_tpu/ops/loglik_pallas.py:117",
        "launches": sum(r["launches"]["fused_posterior"] - 1 for r in ensemble.values()),
        "max_abs_err": h["max_abs_err"], "ms": h["ms"], "kernel_ms": h["kernel_ms"],
        "plan": h["plan"], "plain_ms": h["plain_ms"],
        **{k: h[k] for k in ("bound_ms", "bound_by", "opmix_bound_ms")},
        "library_ms": None})
    # kernel 1 on the gradient samplers' rescue half-rounds (W/2)
    kernels.append(rescue_row)
    # kernel 1 and kernel 2 with the flagship's named prior as a table
    kernels.extend(prior_rows)
    # kernel 1 (the line twin) on the evidence journeys, kernel 2 on the
    # SMC stages, kernel 1 at the nested refills' width
    kernels.extend(evidence_rows)
    # kernel 1 (the line twin) at the VI evaluation draws' W = 2048
    kernels.append(vi_row)
    # kernel 1 over compare_pooling's complete-pooling fit: 8 terms, d = 6
    kernels.append(pool_row)
    # kernel 1 on a shard rank's W/2 walkers with the unsharded plan, its
    # launches the rank's sharded journey
    kernels.append(shard_row)
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
