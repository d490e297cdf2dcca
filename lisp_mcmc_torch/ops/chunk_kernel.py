"""Whole-chunk rwm stepper: ``chunk_size`` MH steps in one kernel launch.

Port of ``lisp_mcmc_tpu/ops/chunk_pallas.py``.  The CUDA kernel
(``csrc/chunk_rwm.cu``) keeps each walker's state on the chip across the
chunk: proposal draw (keyed counter hash + Box-Muller), the fused
posterior of every term (``csrc/models.cuh``), MH accept, best tracking
and the accepted-move moments.  Adaptation and the trace contract stay
with the chunk runner (``kernel.py``), which reads the dict this returns.

Scope (:func:`chunk_coverage` names what is outside it): ungrouped,
untempered rwm, float32, the fused kernel's coverage
(``loglik_kernel.kernel_coverage``), priors that are bounds tables only
(nothing else can run inside a 200-step launch), a walker count with a
128-multiple block, and d <= :data:`MAX_D`.  Up to d = 16 the walker's
state is in registers (variants for d <= 8 and d <= 16); above, a
runtime-d variant keeps it in local memory.  The data stays in shared
memory for the whole chunk where :func:`data_resident` says so, and is
staged tile by tile every step otherwise.

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
from .loglik_kernel import (FusedPosterior, kernel_coverage, pick_block,
                            posterior_raw_plain, prepare_fused_terms, split_prior)

__all__ = ["ChunkKernel", "build_chunk_kernel", "chunk_bytes", "chunk_census",
           "chunk_coverage", "chunk_rwm", "chunk_rwm_plain", "MAX_D",
           "REGISTER_D", "RESIDENT_FLOATS", "TILE", "data_resident"]

MAX_D = 64         # the runtime-d variant's limit (csrc/chunk_rwm.cu: MAX_D_RUNTIME)
REGISTER_D = 16    # up to here the walker's state is in registers
RESIDENT_FLOATS = 8192  # data kept in shared memory for the whole chunk (csrc/chunk_rwm.cu)
TILE = 512              # data points per shared-memory tile (csrc/models.cuh)
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

    @property
    def d(self) -> int:
        return self.post.d


def data_resident(post: FusedPosterior) -> bool:
    """Whether the chunk kernel stages the data once for the whole chunk
    (``lmt_chunk_rwm``): every term fits one tile and all terms' columns,
    each at the tile's stride, fit :data:`RESIDENT_FLOATS`.  Otherwise it
    stages each term tile by tile every step."""
    return (all(t.n <= TILE for t in post.terms)
            and sum(len(t.cols) for t in post.terms) * TILE <= RESIDENT_FLOATS)


def chunk_coverage(terms, spec, config, n_walkers: int, dtype) -> str | None:
    """Why the chunk kernel cannot run this fit, or None."""
    if dtype != torch.float32:
        return f"the chunk kernel runs float32 fits (got {dtype})"
    if config.tempering_rungs > 1 or config.kernel != "rwm":
        return "the chunk kernel runs the untempered rwm sampler"
    if pick_block(n_walkers, 1024) is None:
        return (f"the chunk kernel needs a walker count that is a multiple of "
                f"128 (got W={n_walkers})")
    if spec.ndim > MAX_D:
        return f"d = {spec.ndim} is above the chunk kernel's {MAX_D}"
    reason = kernel_coverage(terms, spec)
    if reason is not None:
        return reason
    for i, t in enumerate(terms):
        if split_prior(t.prior, spec.keys)[1] is not None:
            name = getattr(t.prior, "__name__", repr(t.prior))
            return (f"term {i}: prior {name!r} is not a bounds table alone; "
                    "the chunk kernel evaluates no torch code inside its "
                    "200-step launch")
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
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])


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
    lib.lmt_chunk_blocks.argtypes, lib.lmt_chunk_blocks.restype = [ctypes.c_int], ctypes.c_int
    nblk = lib.lmt_chunk_blocks(W)

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
              pos_out.data_ptr(), lp_out.data_ptr(), best_out.data_ptr(),
              best_lp_out.data_ptr(), acc_out.data_ptr(), msum_p.data_ptr(),
              mouter_p.data_ptr(), trace_p.data_ptr(),
              W, ck.wb, ck.chunk, int(anneal_step), float(temp_override),
              ck.ts, ck.phase_rate, ck.temp_amp, ck.neg_floor, int(ck.greedy),
              stream)
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


def chunk_census(census: dict, d: int) -> dict:
    """Operations of one walker-step of the chunk kernel, by class.

    ``census`` is the posterior's (``loglik_kernel.fused_census`` or
    ``posterior_census``); this adds ``per_step``, read off
    ``csrc/chunk_rwm.cu``, per walker-step:

    - temperature: ``cos(step * rate) * amp``: 2 flops, 1 cos;
    - Box-Muller per parameter: two uniforms (``f - 1``), ``-2 log u1``,
      ``2 pi u2``, ``sqrt * cos``: 5 flops, 1 log, 1 sqrt, 1 cos;
    - ``prop = pos + L z``: d multiplies, d(d-1)/2 FMAs, d adds = d^2 + d;
    - the accept uniform and its log: 1 flop, 1 log; ``(lp' - lp) / T``:
      1 flop, 1 division;
    - moments: ``step * accf`` and ``msum +=`` per parameter, one FMA per
      lower-triangle entry = d^2 + 3d; ``acc += accf``: 1;
    - the trace's warp sum: 5 adds.

    So ``2 d^2 + 9 d + 10`` flops, ``d + 1`` logs, ``d + 1`` cos, ``d``
    square roots and 1 division per walker-step.  The runtime-d variant
    (d > 16) warp-sums each moment entry every step, 5 adds more per entry,
    which are not counted.
    """
    census = {row: dict(v) for row, v in census.items()}
    census["per_step"].update(flops=2 * d * d + 9 * d + 10, div=1, log=d + 1,
                              cos=d + 1, sqrt=d)
    return census


def chunk_bytes(post: FusedPosterior, W: int, chunk: int) -> int:
    """Bytes one chunk launch must move: position, logprob, best point and
    best logprob in and out, the accept counts, every term's data columns,
    L and the (chunk, 3) trace, all float32."""
    d = post.d
    data = sum(len(t.cols) * t.n for t in post.terms)
    return 4 * (W * (2 * d + 2) * 2 + W + data + d * d + chunk * 3)
