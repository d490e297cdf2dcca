"""Whole-chunk rwm stepper: ``chunk_size`` MH steps in one kernel launch.

Port of ``lisp_mcmc_tpu/ops/chunk_pallas.py``.  The CUDA kernel
(``csrc/chunk_rwm.cu``) keeps each walker's state on the chip across the
chunk: proposal draw (keyed counter hash + Box-Muller), the fused
posterior of every term (``csrc/models.cuh``), the bounds table, the
declared constraints and the declared densities, MH accept, best tracking and the accepted-move
moments.  Adaptation and the trace contract stay with the chunk runner
(``kernel.py``), which reads the dict this returns.

Scope (:func:`chunk_coverage` names what is outside it): ungrouped,
untempered rwm, float32, the fused kernel's coverage
(``loglik_kernel.kernel_coverage``), priors that are declared tables: a
bounds table, declared constraints (``priors.declared_constraints``),
both, or a named prior (``priors.PriorSpec``, ``priors.MVGaussian``; a
torch closure cannot run inside a 200-step launch), a walker count with a
128-multiple block, and d <= :data:`MAX_D`.  One kernel serves every d:
the walker's position and step are rows of shared memory, and the block
size (256 or 128 threads) follows from d, the shared memory and the
residency the card reports (:func:`chunk_plan`).  The data stays in
shared memory for the whole chunk where :func:`data_resident` says so,
and is staged tile by tile every step otherwise.

The random stream is the JAX kernel's, bit for bit in its uniforms:
:func:`_hash_bits` / :func:`_uniform_from_bits` below reproduce
``chunk_pallas._hash_bits`` / ``_uniform_from_bits`` in int64 with
explicit 32-bit wraparound (torch has little uint32 arithmetic).  The
normals then differ from the TPU's by the rounding of log, cos and sqrt.

:func:`chunk_rwm` is the wrapper: the kernel on CUDA tensors, the plain
version :func:`chunk_rwm_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..device import check_launch, load_library
from .loglik_kernel import (FusedPosterior, fused_posterior_plain, kernel_coverage,
                            pick_block, posterior_raw_plain, posterior_rel_err,
                            prepare_fused_terms, split_prior, table_floats, table_ints)

__all__ = ["ChunkKernel", "build_chunk_kernel", "chunk_bytes", "chunk_census",
           "chunk_coverage", "chunk_diff", "chunk_plan", "chunk_rwm", "chunk_rwm_plain", "MAX_D",
           "MOMENT_GROUP", "RESIDENT_FLOATS", "TILE", "data_resident"]

MAX_D = 64              # csrc/chunk_rwm.cu: MAX_D
RESIDENT_FLOATS = 8192  # data kept in shared memory for the whole chunk (csrc/chunk_rwm.cu)
TILE = 512              # data points per shared-memory tile (csrc/models.cuh)
MOMENT_GROUP = 8        # moment entries warp-summed together (csrc/chunk_rwm.cu: GROUP)
_M32 = 0xFFFFFFFF
_DRAW_OFFSET = 0x68E31DA4
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def _mul32(x, m: int):
    """``(x * m) mod 2**32`` for int64 ``x`` in [0, 2**32) without overflow."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fin(x, m1: int, m2: int):
    x = x ^ (x >> 16)
    x = _mul32(x, m1)
    x = x ^ (x >> 13)
    x = _mul32(x, m2)
    return x ^ (x >> 16)


def _hash_bits(idx, key1, key2):
    """Keyed counter hash (two murmur3-finalizer rounds), uint32 in int64.

    ``idx`` is the element's linear index, ``key1``/``key2`` the key words;
    all int64 tensors (or ints) holding values in [0, 2**32).
    """
    x = _fin(idx ^ key1, 0x7FEB352D, 0x846CA68B)
    return _fin(x ^ key2, 0x85EBCA6B, 0xC2B2AE35)


def _uniform_from_bits(bits):
    """uint32 bits (int64) -> float32 uniform in (0, 1): 23 mantissa bits
    into [1, 2), minus 1, clamped off 0."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 1.1754944e-38)


@dataclasses.dataclass(frozen=True)
class ChunkKernel:
    """A built chunk stepper: the posterior and the chunk's constants."""

    post: FusedPosterior
    chunk: int
    wb: int               # logical block of the random stream
    ts: float             # annealing constants (kernel.temperature_schedule)
    phase_rate: float
    temp_amp: float
    greedy: bool
    neg_floor: float
    # chunk_plan's plan by walker count, worked out once
    plans: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def d(self) -> int:
        return self.post.d


def data_resident(post: FusedPosterior) -> bool:
    """Whether the chunk kernel may stage the data once for the whole
    chunk (``lmt_chunk_rwm``): every term fits one tile and all terms'
    columns, each at the tile's stride, fit :data:`RESIDENT_FLOATS`.
    Otherwise it stages each term tile by tile every step, as it also does
    where that lets more warps reside (:func:`chunk_plan`'s ``resident``)."""
    return (all(t.n <= TILE for t in post.terms)
            and sum(len(t.cols) for t in post.terms) * TILE <= RESIDENT_FLOATS)


def chunk_coverage(terms, spec, config, n_walkers: int, dtype,
                   n_groups: int = 1, aux=None) -> str | None:
    """Why the chunk kernel cannot run this fit, or None.  Like the JAX
    package's ``pallas_chunk`` it runs ungrouped, untempered rwm without
    per-walker ``aux`` data."""
    if aux is not None:
        return kernel_coverage(terms, spec, aux)
    if dtype != torch.float32:
        return f"the chunk kernel runs float32 fits (got {dtype})"
    if config.tempering_rungs > 1 or config.kernel != "rwm":
        return "the chunk kernel runs the untempered rwm sampler"
    if n_groups > 1:
        return (f"the chunk kernel runs one adaptation group (the fit has "
                f"{n_groups}): one L for every walker")
    if pick_block(n_walkers, 1024) is None:
        return (f"the chunk kernel needs a walker count that is a multiple of "
                f"128 (got W={n_walkers})")
    if spec.ndim > MAX_D:
        return f"d = {spec.ndim} is above the chunk kernel's {MAX_D}"
    reason = kernel_coverage(terms, spec)
    if reason is not None:
        return reason
    for i, t in enumerate(terms):
        rest = split_prior(t.prior, spec.keys)[1]
        if rest is not None:
            closure = getattr(t.prior, "_extra", None) or t.prior
            name = getattr(closure, "__name__", repr(closure))
            return (f"term {i}: prior {name!r} is not a declared table (a "
                    "bounds table alone or with declared constraints, "
                    "priors.declared_constraints, or a named prior, "
                    "priors.PriorSpec / MVGaussian); the chunk kernel "
                    "evaluates no torch code inside its 200-step launch")
    return None


def build_chunk_kernel(terms, spec, config, n_walkers: int, dtype,
                       *, block_walkers: int = 1024) -> ChunkKernel | None:
    """Build a whole-chunk MH stepper, or None outside its scope
    (:func:`chunk_coverage`)."""
    if chunk_coverage(terms, spec, config, n_walkers, dtype) is not None:
        return None
    post = prepare_fused_terms(terms, spec, torch.float32)
    # Annealing schedule constants (kernel.temperature_schedule).
    ts = float(config.temp_steps(spec.ndim))
    mult = 1 + 2 * (int(ts) // config.temp_period)
    return ChunkKernel(
        post=post, chunk=config.chunk_size, wb=pick_block(n_walkers, block_walkers),
        ts=ts, phase_rate=math.pi * mult / (2.0 * ts),
        temp_amp=float(config.temperature), greedy=bool(config.greedy),
        neg_floor=float(np.finfo(np.float32).min / 4))


def _temperature(ck: ChunkKernel, step: int, temp_override: float) -> float:
    """The kernel's float32 temperature for one step."""
    f32 = np.float32
    step_f = f32(step)
    sched = max(f32(1.0), f32(np.cos(step_f * f32(ck.phase_rate))) * f32(ck.temp_amp))
    sched = sched if step_f < f32(ck.ts) else f32(1.0)
    return float(f32(temp_override) if f32(temp_override) > 0 else sched)


def chunk_rwm_plain(ck: ChunkKernel, position, logprob, best_position,
                    best_logprob, l_matrix, anneal_step: int,
                    temp_override: float, seed):
    """The chunk stepper in plain PyTorch (any device), float32.

    Same arguments and result as :func:`chunk_rwm`.  ``seed`` is an int or
    a one-element int32 tensor.
    """
    post = ck.post
    dev = position.device
    f32 = torch.float32
    W, d = position.shape
    const = post.scalar_const.to(f32)
    pos = position.to(f32)
    lp = (logprob - post.scalar_const).to(f32)
    best = best_position.to(f32)
    best_lp = (best_logprob - post.scalar_const).to(f32)
    L = l_matrix.to(f32)

    w = torch.arange(W, device=dev, dtype=torch.int64)
    c = w % ck.wb
    seed = torch.as_tensor(seed, device=dev).reshape(-1)[:1].to(torch.int64) & _M32
    key_sp = (_mul32(seed, 0x9E3779B9) + _mul32(w // ck.wb, 0x85EBCA6B)) & _M32
    idx = torch.arange(d, device=dev, dtype=torch.int64)[None, :] * ck.wb + c[:, None]
    key_sp2 = key_sp[:, None]

    acc = torch.zeros(W, dtype=f32, device=dev)
    msum = torch.zeros(W, d, dtype=f32, device=dev)
    mouter = torch.zeros(W, d, d, dtype=f32, device=dev)
    trace = []
    for i in range(ck.chunk):
        temp = _temperature(ck, anneal_step + i, temp_override)
        key_step = (i * 0xB5297A4D) & _M32
        u1 = _uniform_from_bits(_hash_bits(idx, key_sp2, key_step))
        u2 = _uniform_from_bits(_hash_bits(idx, key_sp2, (key_step + _DRAW_OFFSET) & _M32))
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)
        rows = []
        for r in range(d):
            srow = L[r, 0] * z[:, 0]
            for k in range(1, r + 1):
                srow = srow + L[r, k] * z[:, k]
            rows.append(srow)
        step_vec = torch.stack(rows, dim=1)
        prop = pos + step_vec
        lp_prop = posterior_raw_plain(prop, post)
        lp_prop = torch.where(torch.isfinite(lp_prop), lp_prop, ck.neg_floor)
        log_u = torch.log(_uniform_from_bits(
            _hash_bits(c, key_sp, (key_step + 2 * _DRAW_OFFSET) & _M32)))
        if ck.greedy:
            accept = lp_prop > lp
        else:
            accept = (lp_prop > lp) | ((lp_prop - lp) / temp > log_u)
        accf = accept.to(f32)
        pos = torch.where(accept[:, None], prop, pos)
        lp = torch.where(accept, lp_prop, lp)
        delta = step_vec * accf[:, None]
        msum = msum + delta
        mouter = mouter + delta[:, :, None] * delta[:, None, :]
        acc = acc + accf
        better = lp > best_lp
        best = torch.where(better[:, None], pos, best)
        best_lp = torch.where(better, lp, best_lp)
        trace.append(torch.stack([lp.max(), lp.sum(), lp.min()]))
    trace = torch.stack(trace)                                   # (chunk, 3)
    return {
        "position": pos,
        "logprob": lp + const,
        "best_position": best,
        "best_logprob": best_lp + const,
        "accept_counts": acc,
        "m_sum": msum.sum(dim=0),
        "m_outer": mouter.sum(dim=0),
        "m_count": acc.sum(),
        "trace_max": trace[:, 0] + const,
        "trace_mean": trace[:, 1] / W + const,
        "trace_min": trace[:, 2] + const,
    }


_CHUNK_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_PLAN_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def chunk_plan(ck: ChunkKernel, W: int) -> dict:
    """How the kernel launches one chunk of W walkers on the current card
    (``lmt_chunk_plan``): ``threads`` per block, ``blocks``,
    ``blocks_per_sm`` (the residency the card reports for that block's
    registers and shared memory), ``sms``, ``smem_bytes`` per block,
    ``resident`` (1: the data stays in shared memory for the chunk; 0: it
    is staged tile by tile every step, which the plan also takes where it
    lets more warps reside) and ``waves``, the blocks over the blocks the
    SMs hold at once.  Worked out once per W and kept on ``ck``: every
    launch of W walkers takes this plan (:func:`chunk_rwm`)."""
    if W in ck.plans:
        return dict(ck.plans[W])
    post = ck.post
    lib = load_library("chunk_rwm")
    fn = lib.lmt_chunk_plan
    fn.argtypes, fn.restype = _PLAN_ARGTYPES, ctypes.c_int
    out = (ctypes.c_int * 6)()
    code = fn(ck.d, len(post.terms), ctypes.addressof(post.meta), len(post.bounds),
              len(post.constraints), post.didx.numel() + post.dval.numel(), int(W),
              ctypes.addressof(out))
    check_launch(lib, code, "chunk_plan")
    plan = dict(zip(("threads", "blocks", "blocks_per_sm", "sms", "smem_bytes",
                     "resident"), out))
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    ck.plans[W] = plan
    return dict(plan)


def _launch_chunk(ck: ChunkKernel, position, logprob, best_position,
                  best_logprob, l_matrix, anneal_step: int,
                  temp_override: float, seed):
    post = ck.post
    dev = position.device
    f32 = torch.float32
    W, d = position.shape
    if d != ck.d or dev != post.device:
        raise ValueError(f"chunk_rwm: position must be (W, {ck.d}) on "
                         f"{post.device}, got {tuple(position.shape)} on {dev}")
    if W % ck.wb:
        raise ValueError(f"chunk_rwm: W={W} is not a multiple of the "
                         f"random stream's block {ck.wb}")
    if not (torch.is_tensor(seed) and seed.dtype == torch.int32
            and seed.device == dev):
        raise ValueError("chunk_rwm: seed must be an int32 tensor on the "
                         "walkers' device")

    def f32c(t):
        return t.to(f32).contiguous()

    pos = f32c(position)
    lp = f32c(logprob - post.scalar_const)
    best = f32c(best_position)
    best_lp = f32c(best_logprob - post.scalar_const)
    L = f32c(l_matrix)
    lib = load_library("chunk_rwm")
    fn = lib.lmt_chunk_rwm
    fn.argtypes, fn.restype = _CHUNK_ARGTYPES, ctypes.c_int
    plan = chunk_plan(ck, W)
    nblk = plan["blocks"]

    def empty(*shape):
        return torch.empty(*shape, dtype=f32, device=dev)

    pos_out, best_out = empty(W, d), empty(W, d)
    lp_out, best_lp_out, acc_out = empty(W), empty(W), empty(W)
    msum_p, mouter_p = empty(nblk, d), empty(nblk, d, d)
    trace_p = empty(nblk, ck.chunk, 3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(d, len(post.terms), ctypes.addressof(post.meta),
              ctypes.addressof(post.col_ptrs),
              pos.data_ptr(), lp.data_ptr(), best.data_ptr(), best_lp.data_ptr(),
              L.data_ptr(), seed.data_ptr(), post.bcol.data_ptr(),
              post.blo.data_ptr(), post.bhi.data_ptr(), len(post.bounds),
              post.cidx.data_ptr(), post.cval.data_ptr(), len(post.constraints),
              post.didx.data_ptr(), post.dval.data_ptr(), len(post.densities),
              post.didx.numel(), post.dval.numel(),
              pos_out.data_ptr(), lp_out.data_ptr(), best_out.data_ptr(),
              best_lp_out.data_ptr(), acc_out.data_ptr(), msum_p.data_ptr(),
              mouter_p.data_ptr(), trace_p.data_ptr(),
              W, ck.wb, ck.chunk, int(anneal_step), float(temp_override),
              ck.ts, ck.phase_rate, ck.temp_amp, ck.neg_floor, int(ck.greedy),
              plan["threads"], nblk, plan["smem_bytes"], plan["resident"], stream)
    check_launch(lib, code, "chunk_rwm")
    chunk_rwm.launches += 1
    const = post.scalar_const.to(f32)
    return {
        "position": pos_out,
        "logprob": lp_out + const,
        "best_position": best_out,
        "best_logprob": best_lp_out + const,
        "accept_counts": acc_out,
        "m_sum": msum_p.sum(dim=0),
        "m_outer": mouter_p.sum(dim=0),
        "m_count": acc_out.sum(),
        "trace_max": trace_p[:, :, 0].amax(dim=0) + const,
        "trace_mean": trace_p[:, :, 1].sum(dim=0) / W + const,
        "trace_min": trace_p[:, :, 2].amin(dim=0) + const,
    }


def chunk_rwm(ck: ChunkKernel, position, logprob, best_position, best_logprob,
              l_matrix, anneal_step: int, temp_override: float, seed):
    """One chunk of ``ck.chunk`` rwm steps from the given state.

    ``position (W, d)``, ``logprob (W,)``, ``best_position``,
    ``best_logprob``, ``l_matrix (d, d)``; ``anneal_step`` indexes the
    annealing schedule, ``temp_override > 0`` pins the temperature;
    ``seed`` keys the random stream (an int32 tensor on the device for the
    kernel).  Returns the updated state plus ``accept_counts (W,)``,
    ``m_sum (d,)``, ``m_outer (d, d)``, ``m_count ()`` and
    ``trace_max/mean/min (chunk,)``, all float32.
    """
    if position.device.type == "cpu":
        return chunk_rwm_plain(ck, position, logprob, best_position,
                               best_logprob, l_matrix, anneal_step,
                               temp_override, seed)
    return _launch_chunk(ck, position, logprob, best_position, best_logprob,
                         l_matrix, anneal_step, temp_override, seed)


chunk_rwm.launches = 0  # kernel launches, for proof that a path used it


def chunk_diff(got: dict, ref: dict, post: FusedPosterior) -> dict:
    """How far one chunk's result ``got`` is from ``ref``, the same chunk
    from the same state, L and seed run another way (the kernel against
    :func:`chunk_rwm_plain`), measure by measure.

    A walker *agrees* when its accept count and its final position (rtol
    1e-4) match: a 1-ulp difference of logf/cosf can flip a near-tie
    accept and send a walker down another path (``walker_agreement`` is
    their share).  Over the agreeing walkers: ``logprob_rel_err`` and
    ``best_logprob_rel_err`` (``loglik_kernel.posterior_rel_err``),
    ``logprob_max_abs_err`` and
    ``best_agreement``, the share whose best point matches at rtol 1e-4
    (a logprob within rounding of the best can flip the best-tracking test
    the same way).  Over every walker: ``best_self_rel_err``, ``got``'s
    best logprob against the plain posterior at its best point (a best
    point that is stale or another walker's fails it), ``best_below``, the
    walkers whose best logprob is below their logprob, ``msum_err``, the
    moment sums against ``ref``'s plus the end-position difference of the
    walkers that disagree (a walker's accepted moves add up to its
    displacement), relative to sqrt(m_ii), ``mouter_err``, the outer
    products entry by entry relative to sqrt(m_ii m_jj)
    (``moments_offdiag_median``: the off-diagonal entries' median size on
    that scale), ``trace_rel_err``, the per-step
    max, mean and min by posterior_rel_err (the walkers that disagree move
    them), and ``trace_last_err``, the largest of ``got``'s last step's
    max and min against those of its own final logprob (0 unless the
    trace is written at the wrong step) and its mean's posterior_rel_err.
    """
    pos_rel = ((got["position"] - ref["position"]).abs()
               / ref["position"].abs().clamp_min(1e-30)).amax(dim=1)
    same_count = got["accept_counts"] == ref["accept_counts"]
    same = same_count & (pos_rel <= 1e-4)
    best_rel = ((got["best_position"] - ref["best_position"]).abs()
                / ref["best_position"].abs().clamp_min(1e-30)).amax(dim=1)
    best_self = fused_posterior_plain(got["best_position"].to(post.dtype), post)
    diag = ref["m_outer"].diagonal()
    scale = (diag[:, None] * diag[None, :]).sqrt()
    off = ~torch.eye(diag.shape[0], dtype=torch.bool, device=diag.device)
    moved = (got["position"] - ref["position"])[~same].sum(dim=0)
    lp = got["logprob"]
    last = torch.stack([got["trace_max"][-1] - lp.max(), got["trace_min"][-1] - lp.min()])
    return {
        "walker_agreement": float(same.float().mean()),
        "count_agreement": float(same_count.float().mean()),
        "pos_max_rel_err": float(pos_rel[same].max()),
        "logprob_rel_err": posterior_rel_err(lp[same], ref["logprob"][same], post),
        "logprob_max_abs_err": float((lp - ref["logprob"]).abs()[same].max()),
        "best_logprob_rel_err": posterior_rel_err(
            got["best_logprob"][same], ref["best_logprob"][same], post),
        "best_agreement": float((best_rel[same] <= 1e-4).float().mean()),
        "best_self_rel_err": posterior_rel_err(got["best_logprob"], best_self, post),
        "best_below": int((got["best_logprob"] < lp).sum()),
        "msum_err": float(((got["m_sum"] - ref["m_sum"] - moved).abs() / diag.sqrt()).max()),
        "mouter_err": float(((got["m_outer"] - ref["m_outer"]).abs() / scale).max()),
        "moments_offdiag_median": (float((ref["m_outer"].abs() / scale)[off].median())
                                   if diag.shape[0] > 1 else None),
        "trace_rel_err": max(posterior_rel_err(got[k], ref[k], post)
                             for k in ("trace_max", "trace_mean", "trace_min")),
        "trace_last_err": max(float(last.abs().max()), posterior_rel_err(
            got["trace_mean"][-1:], lp.mean()[None], post)),
    }


def chunk_census(census: dict, d: int) -> dict:
    """Operations of one walker-step of the chunk kernel, by class.

    ``census`` is the posterior's (``loglik_kernel.fused_census`` or
    ``posterior_census``); this adds ``per_step``, read off
    ``csrc/chunk_rwm.cu``, per walker-step:

    - temperature: ``cos(step * rate) * amp``: 2 flops, 1 cos;
    - Box-Muller per parameter: two uniforms (``f - 1``), ``-2 log u1``,
      ``2 pi u2``, ``sqrt * cos``: 5 flops, 1 log, 1 sqrt, 1 cos;
    - ``step = L z``: d multiplies and d(d-1)/2 FMAs = d^2; the proposal
      ``pos + step``, once per parameter the posterior reads: counted as d;
    - the accept uniform and its log: 1 flop, 1 log; ``(lp' - lp) / T``:
      1 flop, 1 division; ``pos += step`` and ``acc += accf``: d + 1
      (the position's adds run on accepted steps only; counted always);
    - moments: ``step[r] * step[c]`` per lower-triangle entry, d(d+1)/2
      multiplies; each group of :data:`MOMENT_GROUP` entries is summed over
      the warp by 9 shuffles, each with an add, and one add into the
      warp's row (10 adds: a warp instruction is counted for each of its
      walkers, whatever its active lanes); the shuffles themselves, like
      the selects and the shared-memory loads, are not counted;
    - the trace's warp sum: 5 adds.

    So ``d^2 + d(d+1)/2 + 7 d + 10 + 10 ceil(m / 8)`` flops, m = d +
    d(d+1)/2 moment entries, ``d + 1`` logs, ``d + 1`` cos, ``d`` square
    roots and 1 division per walker-step.
    """
    groups = -(-(d + d * (d + 1) // 2) // MOMENT_GROUP)
    census = {row: dict(v) for row, v in census.items()}
    census["per_step"].update(flops=d * d + d * (d + 1) // 2 + 7 * d + 10 + 10 * groups,
                              div=1, log=d + 1, cos=d + 1, sqrt=d)
    return census


def chunk_bytes(post: FusedPosterior, W: int, chunk: int) -> int:
    """Bytes one chunk launch must move: position, logprob, best point and
    best logprob in and out, the accept counts, every term's data columns,
    L, the prior's tables and the (chunk, 3) trace, all 4-byte values."""
    d = post.d
    data = sum(len(t.cols) * t.n for t in post.terms)
    return 4 * (W * (2 * d + 2) * 2 + W + data + d * d + chunk * 3
                + table_floats(post) + table_ints(post))
