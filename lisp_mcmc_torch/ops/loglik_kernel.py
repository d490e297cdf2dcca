"""Fused posterior kernel: positions (W, d) -> (W,) log-posterior.

Port of ``lisp_mcmc_tpu/ops/loglik_pallas.py``.  The CUDA kernel
(``csrc/fused_posterior.cu``) runs one thread per walker: the model at
every data point, the likelihood's reduction and the bounds prior stay in
registers, with the data columns staged in shared memory; nothing of size
W x N reaches device memory.  The walker-independent constant is added
here, outside the kernel, as in the JAX package.

Pallas traced any jnp model and prior into its kernel; CUDA cannot trace
a Python callable, so the kernel covers what has a device twin:

- one posterior term (one model, one dataset);
- a library likelihood (normal, normal_cutoff, poisson) over 1-D x;
- a zoo model listed in ``models.DEVICE_MODELS`` (``csrc/models.cuh``);
- the flat prior, or a bounds prior without ``extra``.

:func:`prepare_fused_terms` returns None outside that coverage, and the
caller decides at build time: ``posterior_impl="auto"`` then takes the
plain path, a forced ``"kernel"`` raises.

:func:`fused_posterior` is the wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs :func:`fused_posterior_plain`,
the same function in plain PyTorch, which is also what the kernel is held
against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from ..device import check_launch, load_library
from ..likelihoods import (log_likelihood_normal, log_likelihood_normal_cutoff,
                           log_likelihood_poisson)
from ..models.zoo import DEVICE_MODELS, device_model
from ..priors import bound_penalty, log_prior_flat

__all__ = ["FusedTerm", "OP_CLASSES", "build_fused_posterior",
           "census_totals", "class_rates", "fusable_terms", "fused_bytes",
           "fused_census", "fused_posterior", "fused_posterior_plain",
           "kernel_coverage", "op_census", "opmix_bound_ms", "pick_block",
           "prepare_fused_terms"]

_CUTOFF_DEFAULT = -5000.0
KIND_IDS = {"normal": 0, "normal_cutoff": 1, "poisson": 2}


def _likelihood_kind(likelihood: Callable) -> str | None:
    """Classify a likelihood reduction for in-kernel fusion.

    Identity-based: only the library reductions have known algebra; a
    custom or data-specialized likelihood returns None (not fusable).
    """
    if likelihood is log_likelihood_normal:  # weighted variant is an alias
        return "normal"
    if likelihood is log_likelihood_normal_cutoff:
        return "normal_cutoff"
    if likelihood is log_likelihood_poisson:
        return "poisson"
    return None


def fusable_terms(terms) -> bool:
    """True if every term's likelihood reduction can run in a kernel."""
    for t in terms:
        if _likelihood_kind(t.likelihood) is None:
            return False
        if t.dataset.x.ndim != 1:
            return False  # multi-column x
    return True


def pick_block(n_walkers: int, preferred: int = 2048) -> int | None:
    """Largest walker block <= preferred (128-multiple) that divides W.

    The CUDA kernels do not need it for their own blocks; the chunk
    stepper uses it as the *logical* block of the random stream, which
    must match the JAX kernel's.
    """
    for wb in (preferred, 1024, 512, 256, 128):
        if wb <= n_walkers and n_walkers % wb == 0:
            return wb
    return None


def _bounds_table(prior, keys) -> dict[int, tuple[float, float]] | None:
    """``{column: (lo, hi)}`` for a prior the kernel evaluates, else None."""
    if prior is log_prior_flat:
        return {}
    bounds = getattr(prior, "_bounds", None)
    if bounds is None or getattr(prior, "_extra", None) is not None:
        return None
    table = {}
    for name, (lo, hi) in bounds.items():
        key = name[1:] if name.startswith(":") else name
        if key not in keys or keys.index(key) in table:
            return None
        table[keys.index(key)] = (float(lo), float(hi))
    return table


def kernel_coverage(terms, spec) -> str | None:
    """Why the fused kernels cannot evaluate this posterior, or None."""
    if len(terms) != 1:
        return f"{len(terms)} posterior terms (the kernels take one)"
    t = terms[0]
    if not fusable_terms(terms):
        return ("a custom likelihood or multi-column x (the kernels take "
                "the library normal/normal_cutoff/poisson reductions of 1-D x)")
    if device_model(t.fn, spec.keys) is None:
        name = getattr(t.fn, "__name__", repr(t.fn))
        return (f"model {name!r} has no CUDA twin with all its parameters "
                f"fitted (twins: {[f.__name__ for f in DEVICE_MODELS]})")
    if _bounds_table(t.prior, spec.keys) is None:
        return "a prior other than flat or a bounds table without extra"
    return None


@dataclasses.dataclass(frozen=True)
class FusedTerm:
    """Everything the kernels read for one term, on the term's device."""

    kind: str
    fn: Callable          # the torch model (the plain version's)
    model_id: int
    names: tuple          # twin parameter names, in twin order
    pidx_host: tuple      # column of each twin parameter
    pidx: torch.Tensor    # the same, (NP,) int32 on the device
    bounds: dict          # {column: (lo, hi)} in the prior's order
    cols: tuple           # (x, y, inv_sigma[, c_pt, mask]) or (x, y, mask)
    bflag: torch.Tensor   # (d,) int32: 1 where the parameter is bounded
    blo: torch.Tensor     # (d,) dtype
    bhi: torch.Tensor     # (d,) dtype
    scalar_const: torch.Tensor  # () dtype, added outside the kernel
    d: int

    @property
    def dtype(self) -> torch.dtype:
        return self.cols[0].dtype


def prepare_fused_terms(terms, spec, dtype) -> FusedTerm | None:
    """Host-side precomputation for the kernels, or None outside coverage.

    The scalar normalization constant is kept apart (it cancels in MH
    ratios and is added outside the kernel).
    """
    if kernel_coverage(terms, spec) is not None:
        return None
    t = terms[0]
    ds = t.dataset
    dev = ds.device
    kind = _likelihood_kind(t.likelihood)
    model_id, pidx = device_model(t.fn, spec.keys)

    def col(a):
        return a.to(dtype).contiguous()

    if kind == "normal":
        cols = (col(ds.x), col(ds.y), col(ds.inv_sigma))
        const = ds.log_norm_const.to(dtype)
    elif kind == "normal_cutoff":
        cols = (col(ds.x), col(ds.y), col(ds.inv_sigma),
                col(ds.log_norm_const_point), col(ds.mask))
        const = torch.zeros((), dtype=dtype, device=dev)
    else:  # poisson
        cols = (col(ds.x), col(ds.y), col(ds.mask))
        const = -torch.sum(ds.log_fact_y.to(dtype))
    d = spec.ndim
    table = _bounds_table(t.prior, spec.keys)
    bflag = torch.zeros(d, dtype=torch.int32)
    blo = torch.zeros(d, dtype=torch.float64)
    bhi = torch.zeros(d, dtype=torch.float64)
    for r, (lo, hi) in table.items():
        bflag[r], blo[r], bhi[r] = 1, lo, hi
    return FusedTerm(
        kind=kind, fn=t.fn, model_id=model_id, names=DEVICE_MODELS[t.fn][1],
        pidx_host=pidx, pidx=torch.tensor(pidx, dtype=torch.int32, device=dev),
        bounds=table,
        cols=cols, bflag=bflag.to(dev), blo=blo.to(dtype=dtype, device=dev),
        bhi=bhi.to(dtype=dtype, device=dev), scalar_const=const, d=d)


def posterior_raw_plain(positions, term: FusedTerm):
    """The kernel's function minus the scalar constant, in plain PyTorch.

    Shared with the chunk stepper's plain version.
    """
    params = {n: positions[:, i, None] for n, i in
              zip(term.names, term.pidx_host)}
    x, y = term.cols[0], term.cols[1]
    mu = term.fn(x, params)                                  # (W, N)
    if term.kind == "normal":
        z = (y - mu) * term.cols[2]
        total = -0.5 * torch.sum(z * z, dim=-1)
    elif term.kind == "normal_cutoff":
        z = (y - mu) * term.cols[2]
        lp = torch.clamp_min(term.cols[3] - 0.5 * z * z, _CUTOFF_DEFAULT)
        total = torch.sum(lp * term.cols[4], dim=-1)
    else:
        total = torch.sum((y * torch.log(mu) - mu) * term.cols[2], dim=-1)
    for r, (lo, hi) in term.bounds.items():
        total = total + bound_penalty(positions[:, r], lo, hi)
    return total


def fused_posterior_plain(positions, term: FusedTerm):
    """The fused posterior in plain PyTorch (any device)."""
    return posterior_raw_plain(positions, term) + term.scalar_const


_FUSED_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 5)


def _launch_fused(positions, term: FusedTerm):
    if positions.dtype != term.dtype or positions.device != term.cols[0].device:
        raise ValueError(
            f"fused_posterior: positions are {positions.dtype} on "
            f"{positions.device}, the term is {term.dtype} on "
            f"{term.cols[0].device}")
    if positions.ndim != 2 or positions.shape[1] != term.d:
        raise ValueError(f"fused_posterior: positions must be (W, {term.d}), "
                         f"got {tuple(positions.shape)}")
    if not positions.is_contiguous():
        raise ValueError("fused_posterior: positions must be contiguous")
    if term.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused_posterior: no kernel for {term.dtype}")
    lib = load_library("fused_posterior")
    fn = lib.lmt_fused_posterior
    fn.argtypes, fn.restype = _FUSED_ARGTYPES, ctypes.c_int
    W = positions.shape[0]
    out = torch.empty(W, dtype=term.dtype, device=positions.device)
    cols = [c.data_ptr() for c in term.cols] + [None] * (5 - len(term.cols))
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    code = fn(0 if term.dtype == torch.float32 else 1, term.model_id,
              KIND_IDS[term.kind], positions.data_ptr(), W, term.d,
              term.pidx.data_ptr(), *cols, term.cols[0].shape[0],
              term.bflag.data_ptr(), term.blo.data_ptr(), term.bhi.data_ptr(),
              out.data_ptr(), stream)
    check_launch(lib, code, "fused_posterior")
    fused_posterior.launches += 1
    return out


def fused_posterior(positions, term: FusedTerm):
    """Log-posterior of each walker: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if positions.device.type == "cpu":
        return fused_posterior_plain(positions, term)
    return _launch_fused(positions, term) + term.scalar_const


fused_posterior.launches = 0  # kernel launches, for proof that a path used it


def build_fused_posterior(terms, spec, dtype):
    """``positions (W, d) -> (W,)`` through the fused kernel, or None.

    None when the fit is outside the kernel's coverage
    (:func:`kernel_coverage`); the caller then decides.
    """
    term = prepare_fused_terms(terms, spec, dtype)
    if term is None:
        return None
    return lambda positions: fused_posterior(positions, term)


# ---------------------------------------------------------------- op census
#
# Operations the kernels execute, by class, read off the CUDA source
# (csrc/models.cuh).  "flops" are the non-division floating-point adds,
# multiplies and FMAs, an FMA counted as 2; a division, square root, log,
# exp or cos/sin is one operation of its own class (sin counts as cos).
# Compares, selects, min/max and integer work are not counted, so a bound
# built on the census is a lower bound.

OP_CLASSES = ("flops", "div", "sqrt", "log", "exp", "cos")

# twin id -> (per walker-point: Model::eval, per walker: Model::setup)
_MODEL_CENSUS = {
    # eval: u, u*u, u2+lw2, lw2-u2, c2*(.), c1*u+(.) (FMA), s*s, +bg0,
    # bg1*x+(.) (FMA) = 11 flops, and num/(s*s); setup: lw*lw, three
    # multiplies for c1, two for c2, cos(mix) and sin(mix)
    0: ({"flops": 11, "div": 1}, {"flops": 6, "cos": 2}),
    1: ({"flops": 2}, {}),  # b + m*x (FMA)
}
# likelihood kind -> (per walker-point: tile_sum, per walker: finish)
_KIND_CENSUS = {
    "normal": ({"flops": 4}, {"flops": 1}),       # (y-mu)*is, acc+z*z; -0.5*acc
    "normal_cutoff": ({"flops": 7}, {}),          # (y-mu)*is, c-0.5*z*z, acc+lp*mask
    "poisson": ({"flops": 4, "log": 1}, {}),      # y*log(mu)-mu, acc+(.)*mask
}
# per bounded parameter per walker: bound_penalty's two distances,
# 1e-5*dist, exp, -1, *-1e10, and prior += (.)
_BOUND_CENSUS = {"flops": 6, "exp": 1}


def _classes(*parts):
    """The sum of ``{class: count}`` dicts over every class."""
    out = dict.fromkeys(OP_CLASSES, 0)
    for part in parts:
        for c, n in part.items():
            out[c] += n
    return out


def op_census(per_point=(), per_walker=(), per_step=()) -> dict:
    """An op census from partial ``{class: count}`` dicts (absent classes
    count 0): per walker-point, per walker and per walker-step."""
    return {"per_point": _classes(dict(per_point)),
            "per_walker": _classes(dict(per_walker)),
            "per_step": _classes(dict(per_step))}


def fused_census(model_id: int, kind: str, n_bounded: int = 0) -> dict:
    """Operations of one fused-posterior evaluation, by class.

    ``{"per_point": ..., "per_walker": ..., "per_step": ...}``, each a dict
    over :data:`OP_CLASSES`: per walker-point (model and reduction), per
    walker (model setup, finish, ``total + prior`` and ``n_bounded``
    bound penalties) and, for the chunk stepper, per walker-step beyond
    the posterior (zero here).
    """
    point_m, walker_m = _MODEL_CENSUS[model_id]
    point_k, walker_k = _KIND_CENSUS[kind]
    return op_census(per_point=_classes(point_m, point_k),
                     per_walker=_classes(walker_m, walker_k, {"flops": 1},
                                         {c: n_bounded * n
                                          for c, n in _BOUND_CENSUS.items()}))


def census_totals(census: dict, W: int, N: int, steps: int = 1) -> dict:
    """Operations by class for ``steps`` evaluations of W walkers over N
    points."""
    return {c: steps * W * (N * census["per_point"][c] + census["per_walker"][c]
                            + census["per_step"][c])
            for c in OP_CLASSES}


def class_rates(ceilings: dict, take_out_add: bool = True) -> dict:
    """The rate of each census class, from ``roofline.microbench_ceilings``.

    Non-division flops run at the FMA ceiling; divisions and square roots
    (an IEEE reciprocal-and-refine sequence alike) at the division rate;
    log, exp and cos at theirs.  The div, exp and log probes each apply one
    add or multiply besides their op (``1.0001 / (x + 1e-6)``,
    ``exp(x * 1e-6)``, ``log(x + 1)``), which the census counts as a flop
    of its own: with ``take_out_add`` the add probe's time per application
    is taken out of theirs.  The add probe runs at the same unroll, so its
    share of the loop's own instructions goes too.  Without it the probes'
    raw rates are used, as on the CPU, where the plain probes' times are
    the dispatch of one or two ops and too noisy to take one from another.
    """
    t_add = 1.0 / ceilings["add_per_sec"] if take_out_add else 0.0

    def net(key):
        t = 1.0 / ceilings[key] - t_add
        if t <= 0:
            raise ValueError(f"class_rates: the add probe is not faster than "
                             f"{key} ({ceilings['add_per_sec']} vs {ceilings[key]})")
        return 1.0 / t

    div = net("div_per_sec")
    return {"flops": ceilings["fma_flops_per_sec"], "div": div, "sqrt": div,
            "log": net("log_per_sec"), "exp": net("exp_per_sec"),
            "cos": ceilings["cos_per_sec"]}


def opmix_bound_ms(census: dict, W: int, N: int, steps: int,
                   rates: dict) -> float:
    """The op-mix roofline: ms the census takes at the given rates.

    ``sum over classes of count / rate`` (DESIGN.md's ``t_min`` over every
    class); ``rates`` maps each class to its operations per second
    (:func:`class_rates`); a class the census does not use needs no rate.
    """
    totals = census_totals(census, W, N, steps)
    return 1e3 * sum(n / rates[c] for c, n in totals.items() if n)


def fused_bytes(term: FusedTerm, W: int) -> int:
    """Bytes one evaluation must move: positions in, the data columns
    once, the posterior out."""
    size = term.cols[0].element_size()
    return size * (W * term.d + len(term.cols) * term.cols[0].shape[0] + W)
