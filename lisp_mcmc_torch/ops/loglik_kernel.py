"""Fused posterior kernel: positions (W, d) -> (W,) log-posterior.

Port of ``lisp_mcmc_tpu/ops/loglik_pallas.py``.  The CUDA kernel
(``csrc/fused_posterior.cu``) loops over the posterior's terms as the
Pallas kernel does: each term's model at every data point, its
likelihood's reduction, then the bounds prior, the declared
constraints and the declared densities, then the walker-independent
constant, all in registers,
with each term's points staged in shared memory as packed records
(:func:`pack_records`); nothing of size W x N reaches device memory.
Each thread evaluates R walkers and S threads share one walker's points;
:func:`fused_plan` picks the block size, R and S for each W from the
card's occupancy, once per W.

Pallas traced any jnp model and prior into its kernel; CUDA cannot trace
a Python callable, so:

- a term's model runs as its CUDA twin (``csrc/models.cuh``): any zoo
  model (``models.DEVICE_MODELS``), or one declared with
  ``models.renamed``;
- a prior is split in four.  Its bounds table (``make_bounds_prior``'s
  ``._bounds``, or the walls of a named prior), its declared constraints
  (an ``extra`` made by ``priors.declared_constraints``, as the NV
  prior's) and its declared densities (a ``PriorSpec``'s Gaussian and
  LogNormal components, an ``MVGaussian``'s quadratic form:
  :func:`declared_densities`) are evaluated in the kernel; whatever
  remains (an undeclared ``extra``, or a prior that is not a table at
  all) is evaluated per walker by the prior's own torch code on the
  ``(W,)`` parameter columns and added to the kernel's output.

:func:`kernel_coverage` refuses only what the Pallas kernel refuses too (a
custom likelihood, multi-column x) and a model with no twin;
:func:`prepare_fused_terms` returns None outside that coverage, and the
caller decides at build time (``fit.Walker._batched_posterior``):
``posterior_impl="auto"`` then takes the plain path, a forced
``"kernel"`` raises.

:func:`fused_posterior` is the wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs :func:`fused_posterior_plain`,
the same function in plain PyTorch, which is also what the kernel is held
against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from collections.abc import Mapping
from typing import Callable

import numpy as np
import torch

from ..device import build_log, check_launch, load_library, ptxas_table
from ..likelihoods import (log_likelihood_normal, log_likelihood_normal_cutoff,
                           log_likelihood_poisson)
from ..models.zoo import MAX_POLY, device_model, model_coverage
from ..priors import (Gaussian, MVGaussian, PriorSpec, Uniform, bound_penalty,
                      constraint_total, log_prior_flat, prior_bounds)

__all__ = ["FusedPosterior", "FusedTerm", "MAX_TERMS", "OP_CLASSES",
           "census_totals", "class_rates", "constraints_plain",
           "declared_densities", "density_census", "densities_plain",
           "fusable_terms", "fused_bytes", "fused_census", "fused_kernel_entry",
           "fused_plan", "fused_posterior", "fused_posterior_plain",
           "kernel_coverage", "model_census", "op_census", "opmix_bound_ms",
           "pack_records", "pick_block", "posterior_census",
           "posterior_raw_plain", "posterior_rel_err", "prepare_fused_terms",
           "split_prior", "table_floats", "table_ints", "twin_class"]

_CUTOFF_DEFAULT = -5000.0
KIND_IDS = {"normal": 0, "normal_cutoff": 1, "poisson": 2}
CONSTRAINT_IDS = {"le": 0, "diff_ge": 1, "ratio_in": 2}  # csrc/models.cuh
DENSITY_IDS = {"gauss": 0, "logn": 1, "quad": 2}           # csrc/models.cuh
# Limits of csrc/models.cuh: MAX_TERMS terms a launch, MAX_NP twin
# parameters, MAX_COLS data columns; a term's row of the host metadata is
# (model, kind, n, np, column of each of MAX_NP parameters), its META_STRIDE.
MAX_TERMS = 8
MAX_NP = MAX_POLY
MAX_COLS = 5


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


class _Penalties(Mapping):
    """``prior_bounds(params, bounds)``, computed when first read: an
    ``extra`` that ignores its penalties (as the NV constraints do) costs
    no per-step torch work for a table the kernel has evaluated."""

    def __init__(self, params, bounds):
        self._args, self._value = (params, bounds), None

    def _get(self):
        if self._value is None:
            self._value = prior_bounds(*self._args)
        return self._value

    def __getitem__(self, key):
        return self._get()[key]

    def __iter__(self):
        return iter(self._get())

    def __len__(self):
        return len(self._get())


def declared_densities(spec, keys):
    """A named prior as the kernels' tables: ``(bounds entries, density
    entries)``, or None when it names a parameter the fit lacks.

    Per component of a ``PriorSpec``, in declaration order: a Uniform is a
    bounds entry ``(column, low, high)``; a Gaussian or a LogNormal is a
    density entry ``("gauss" | "logn", (column,), (mu, 1 / sigma, c))``
    with ``c = -log sigma - log(2 pi) / 2 - log mass``, whose value is
    ``-z^2 / 2 + c``, ``z = (x - mu) / sigma`` (the LogNormal's x its
    ``log max(x, tiny)``, and ``-log x`` added), plus a bounds entry where
    it is truncated (an infinite edge kept infinite).  An ``MVGaussian``
    over k parameters is one entry ``("quad", columns, (mean..., M...,
    log_norm))``, M the k(k+1)/2 rows of the inverse of the covariance's
    Cholesky factor, lower triangle row by row; its value is ``-|M (x -
    mean)|^2 / 2 + log_norm``.
    """
    if isinstance(spec, MVGaussian):
        if any(k not in keys for k in spec.keys_order):
            return None
        inv = np.linalg.solve(spec.chol, np.eye(len(spec.keys_order)))
        packed = [float(inv[r, c]) for r in range(inv.shape[0]) for c in range(r + 1)]
        return (), (("quad", tuple(keys.index(k) for k in spec.keys_order),
                     (*(float(v) for v in spec.mean), *packed, float(spec.log_norm))),)
    bounds, dens = [], []
    for name, dist in spec.items():
        if name not in keys:
            return None
        col = keys.index(name)
        if isinstance(dist, Uniform):
            bounds.append((col, float(dist.low), float(dist.high)))
            continue
        if dist.truncated:
            bounds.append((col, float(dist.low), float(dist.high)))
        c = -math.log(dist.sigma) - 0.5 * math.log(2.0 * math.pi) - dist._log_mass
        kind = "gauss" if isinstance(dist, Gaussian) else "logn"
        dens.append((kind, (col,), (float(dist.mu), 1.0 / float(dist.sigma), c)))
    return tuple(bounds), tuple(dens)


def split_prior(prior, keys):
    """``(bounds entries, rest, constraints, densities)`` of a prior on a
    fit with these ``keys``.

    The entries ``((column, lo, hi), ...)`` are the bounds table the
    kernels evaluate; the constraints ``((Constraint, column a, column
    b), ...)`` are the declared ``extra``'s entries
    (``priors.declared_constraints``), which the kernels evaluate after
    the table; the densities are a named prior's (``._prior_spec``, a
    ``PriorSpec`` that is not all Uniform or an ``MVGaussian``), as
    :func:`declared_densities` lays them out, which the kernels evaluate
    last; ``rest(params, dataset)`` is what remains, for torch to evaluate
    beside them (None when nothing does): an undeclared ``extra`` of
    ``make_bounds_prior`` (given the table's penalties, as the prior gives
    them), or the whole of a prior that is no table.  A pure-Uniform spec
    carries ``_bounds`` and runs as the bounds table it is.  None when a
    table names a parameter the fit lacks.
    """
    if prior is log_prior_flat:
        return (), None, (), ()
    bounds = getattr(prior, "_bounds", None)
    if bounds is None:
        spec = getattr(prior, "_prior_spec", None)
        if isinstance(spec, (PriorSpec, MVGaussian)):
            tables = declared_densities(spec, keys)
            return None if tables is None else (tables[0], None, (), tables[1])
        return (), prior, (), ()
    entries = []
    for name, (lo, hi) in bounds.items():
        key = name[1:] if name.startswith(":") else name
        if key not in keys:
            return None
        entries.append((keys.index(key), float(lo), float(hi)))
    extra = getattr(prior, "_extra", None)
    if extra is None:
        return tuple(entries), None, (), ()
    declared = getattr(extra, "_constraints", None)
    if declared is not None:
        if any(c.a not in keys or c.b not in keys for c in declared):
            return None
        return (tuple(entries), None,
                tuple((c, keys.index(c.a), keys.index(c.b)) for c in declared), ())

    def rest(params, dataset=None):
        return extra(params, _Penalties(params, bounds), dataset)

    return tuple(entries), rest, (), ()


def kernel_coverage(terms, spec, aux=None) -> str | None:
    """Why the fused kernel cannot evaluate this posterior, or None.
    ``aux``: the fit's per-walker aux data, an input the kernel lacks."""
    if aux is not None:
        return ("per-walker aux data (aux=): the kernel reads one dataset per "
                "term for every walker")
    if len(terms) > MAX_TERMS:
        return f"{len(terms)} posterior terms (a launch takes up to {MAX_TERMS})"
    if not fusable_terms(terms):
        return ("a custom likelihood or multi-column x (the kernels take "
                "the library normal/normal_cutoff/poisson reductions of 1-D x)")
    for i, t in enumerate(terms):
        reason = model_coverage(t.fn, spec.keys)
        if reason is not None:
            return f"term {i}: {reason}"
        if split_prior(t.prior, spec.keys) is None:
            return (f"term {i}: its bounds table, constraints or named prior "
                    "name a parameter the fit lacks")
    return None


@dataclasses.dataclass(frozen=True)
class FusedTerm:
    """One term as the kernels read it, on the term's device."""

    kind: str
    base: Callable        # the zoo model the twin mirrors (the plain version's)
    model_id: int
    names: tuple          # twin parameter names, in twin order
    pidx_host: tuple      # column of each, -1 for an absent optional one
    cols: tuple           # (x, y, inv_sigma[, c_pt, mask]) or (x, y, mask)
    packed: torch.Tensor  # kernel 1's records of the points (pack_records)

    @property
    def n(self) -> int:
        return self.cols[0].shape[0]


@dataclasses.dataclass(frozen=True)
class FusedPosterior:
    """Everything one evaluation reads: the terms, the bounds table, the
    declared constraints and the declared densities of every term's prior,
    the rest of the priors and the scalar constant."""

    terms: tuple          # FusedTerm, in the fit's order
    bounds: tuple         # ((column, lo, hi), ...), every term's table in turn
    constraints: tuple    # ((Constraint, column a, column b), ...), in turn
    rest: tuple           # ((prior remainder, dataset), ...) for torch
    keys: tuple           # the fit's parameter names (the remainders read them)
    scalar_const: torch.Tensor  # () dtype: kernel 1 adds it last, kernel 2 leaves it out
    bcol: torch.Tensor    # (nb,) int32
    blo: torch.Tensor     # (nb,) dtype
    bhi: torch.Tensor     # (nb,) dtype
    cidx: torch.Tensor    # (nc, 3) int32: kind (CONSTRAINT_IDS), column a, column b
    cval: torch.Tensor    # (nc, 2) dtype: lo, hi (rounded to dtype, as torch compares)
    densities: tuple      # ((kind, columns, values), ...): declared_densities, in turn
    didx: torch.Tensor    # int32: each entry's (DENSITY_IDS kind, k, k columns), in turn
    dval: torch.Tensor    # dtype: each entry's values, in turn
    meta: ctypes.Array    # host rows of csrc/models.cuh's make_terms
    col_ptrs: ctypes.Array  # every term's columns (kernel 2)
    rec_ptrs: ctypes.Array  # every term's packed records (kernel 1)
    # kernel 1's launch plans, kept per (W, forced threads, R, S): fused_plan
    plans: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def d(self) -> int:
        return len(self.keys)

    @property
    def dtype(self) -> torch.dtype:
        return self.terms[0].cols[0].dtype

    @property
    def device(self) -> torch.device:
        return self.terms[0].cols[0].device


def pack_records(kind: str, cols) -> torch.Tensor:
    """Kernel 1's records of one term's points: ``(N, 4)`` rows ``(x, y,
    inv_sigma, 0)`` for the normal kind, ``(x, y, mask, 0)`` for poisson;
    the cutoff kind two rows a point, ``(x, y, inv_sigma, c_pt)`` then
    ``(mask, 0, 0, 0)``: ``(2N, 4)``.  One record is one 16-byte shared
    load in float32."""
    zero = torch.zeros_like(cols[0])
    if kind == "normal_cutoff":
        x, y, inv_sigma, c_pt, mask = cols
        return torch.stack([torch.stack([x, y, inv_sigma, c_pt], dim=-1),
                            torch.stack([mask, zero, zero, zero], dim=-1)],
                           dim=1).reshape(-1, 4).contiguous()
    return torch.stack([*cols, zero], dim=-1).contiguous()


def prepare_fused_terms(terms, spec, dtype) -> FusedPosterior | None:
    """Host-side precomputation for the kernels, or None outside coverage.

    The scalar normalization constant of every term is kept apart (it
    cancels in MH ratios); kernel 1 adds it last, kernel 2 leaves it out.
    """
    if kernel_coverage(terms, spec) is not None:
        return None
    dev = terms[0].dataset.device

    def col(a):
        return a.to(dtype).contiguous()

    fused, bounds, constraints, densities, rest = [], [], [], [], []
    const = torch.zeros((), dtype=dtype, device=dev)
    for t in terms:
        ds = t.dataset
        kind = _likelihood_kind(t.likelihood)
        model_id, names, pidx, base = device_model(t.fn, spec.keys)
        if kind == "normal":
            cols = (col(ds.x), col(ds.y), col(ds.inv_sigma))
            const = const + ds.log_norm_const.to(dtype)
        elif kind == "normal_cutoff":
            cols = (col(ds.x), col(ds.y), col(ds.inv_sigma),
                    col(ds.log_norm_const_point), col(ds.mask))
        else:  # poisson
            cols = (col(ds.x), col(ds.y), col(ds.mask))
            const = const - torch.sum(ds.log_fact_y.to(dtype))
        fused.append(FusedTerm(kind=kind, base=base, model_id=model_id,
                               names=names, pidx_host=pidx, cols=cols,
                               packed=pack_records(kind, cols)))
        entries, remainder, declared, dens = split_prior(t.prior, spec.keys)
        bounds.extend(entries)
        constraints.extend(declared)
        densities.extend(dens)
        if remainder is not None:
            rest.append((remainder, ds))

    meta = []
    for ft in fused:
        pidx = list(ft.pidx_host) + [-1] * (MAX_NP - len(ft.pidx_host))
        meta += [ft.model_id, KIND_IDS[ft.kind], ft.n, len(ft.pidx_host), *pidx]
    ptrs = []
    for ft in fused:
        ptrs += [c.data_ptr() for c in ft.cols] + [None] * (MAX_COLS - len(ft.cols))
    return FusedPosterior(
        terms=tuple(fused), bounds=tuple(bounds), constraints=tuple(constraints),
        rest=tuple(rest), keys=tuple(spec.keys), scalar_const=const,
        bcol=torch.tensor([b[0] for b in bounds], dtype=torch.int32, device=dev),
        blo=torch.tensor([b[1] for b in bounds], dtype=dtype, device=dev),
        bhi=torch.tensor([b[2] for b in bounds], dtype=dtype, device=dev),
        cidx=torch.tensor([[CONSTRAINT_IDS[c.kind], a, b] for c, a, b in constraints],
                          dtype=torch.int32, device=dev).reshape(-1, 3),
        cval=torch.tensor([[c.lo, c.hi] for c, _, _ in constraints],
                          dtype=dtype, device=dev).reshape(-1, 2),
        densities=tuple(densities),
        didx=torch.tensor([v for kind, cols, _ in densities
                           for v in (DENSITY_IDS[kind], len(cols), *cols)],
                          dtype=torch.int32, device=dev),
        dval=torch.tensor([v for _, _, vals in densities for v in vals],
                          dtype=dtype, device=dev),
        meta=(ctypes.c_int * len(meta))(*meta),
        col_ptrs=(ctypes.c_void_p * len(ptrs))(*ptrs),
        rec_ptrs=(ctypes.c_void_p * len(fused))(*(ft.packed.data_ptr() for ft in fused)))


def posterior_raw_plain(positions, post: FusedPosterior):
    """What the kernels compute, in plain PyTorch: every term's likelihood
    minus the scalar constant, plus the bounds table, plus the declared
    constraints, plus the declared densities.

    Each term runs its twin's zoo model on the twin's columns, so the
    parameter mapping is the kernel's.  Shared with the chunk stepper's
    plain version.
    """
    total = 0.0
    for t in post.terms:
        params = {n: positions[:, i, None]
                  for n, i in zip(t.names, t.pidx_host) if i >= 0}
        x, y = t.cols[0], t.cols[1]
        mu = t.base(x, params)                               # (W, N)
        if t.kind == "normal":
            z = (y - mu) * t.cols[2]
            total = total + -0.5 * torch.sum(z * z, dim=-1)
        elif t.kind == "normal_cutoff":
            z = (y - mu) * t.cols[2]
            lp = torch.clamp_min(t.cols[3] - 0.5 * z * z, _CUTOFF_DEFAULT)
            total = total + torch.sum(lp * t.cols[4], dim=-1)
        else:
            total = total + torch.sum((y * torch.log(mu) - mu) * t.cols[2], dim=-1)
    for r, lo, hi in post.bounds:
        total = total + bound_penalty(positions[:, r], lo, hi)
    if post.constraints:
        total = total + constraints_plain(positions, post.constraints)
    if post.densities:
        total = total + densities_plain(positions, post.densities)
    return total


def constraints_plain(positions, constraints):
    """The declared constraints' penalties per walker (``(Constraint,
    column a, column b)`` entries), summed as the prior sums them."""
    cols = {}
    for c, a, b in constraints:
        cols[c.a], cols[c.b] = positions[:, a], positions[:, b]
    return constraint_total([c for c, _, _ in constraints], cols.__getitem__)


def densities_plain(positions, densities):
    """The declared densities per walker (:func:`declared_densities`'
    entries), summed in order, each operation rounded apart in the
    positions' type as ``csrc/models.cuh:density_total`` does (only log
    may differ by its rounding)."""
    total = None
    for kind, cols, vals in densities:
        v = torch.tensor(vals, dtype=positions.dtype, device=positions.device)
        if kind == "quad":
            k = len(cols)
            mean, m, log_norm = v[:k], v[k:-1], v[-1]
            q, o = None, 0
            for r in range(k):
                z = None
                for c in range(r + 1):
                    t = m[o] * (positions[:, cols[c]] - mean[c])
                    z = t if z is None else z + t
                    o += 1
                q = z * z if q is None else q + z * z
            term = (-0.5 * q) + log_norm
        else:
            x = positions[:, cols[0]]
            if kind == "logn":
                lx = torch.log(torch.maximum(x, x.new_tensor(torch.finfo(x.dtype).tiny)))
                x = lx
            z = (x - v[0]) * v[1]
            t = (-0.5 * z) * z
            if kind == "logn":
                t = t - lx
            term = t + v[2]
        total = term if total is None else total + term
    return total


def _rest(positions, post: FusedPosterior):
    """The priors' remainders at ``positions``, in torch; 0 when none."""
    if not post.rest:
        return 0.0
    cols = {k: positions[:, i] for i, k in enumerate(post.keys)}
    total = 0.0
    for prior, ds in post.rest:
        total = total + prior(cols, ds)
    return total


def fused_posterior_plain(positions, post: FusedPosterior):
    """The fused posterior in plain PyTorch (any device)."""
    return posterior_raw_plain(positions, post) + post.scalar_const + _rest(positions, post)


_PLAN_KEYS = ("threads", "R", "S", "blocks", "blocks_per_sm", "sms", "smem_bytes",
              "cap", "nbuf", "twin_class")
_PLAN_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_PLAN_R = (1, 2, 4)
_FUSED_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3)


def _dtype_id(dtype) -> int:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused_posterior: no kernel for {dtype}")
    return 0 if dtype == torch.float32 else 1


def _entry(lib, name, argtypes):
    """``lib.name`` with its C signature (set once: ctypes keeps the
    function object on the library)."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def twin_class(post: FusedPosterior) -> int:
    """The kernel-1 twin class of a launch (``csrc/fused_posterior.cu``:
    ``twin_class``): the terms' common twin id, the polynomial as 13 (up
    to 4 coefficients), 14 (up to 8) or 3 (up to 16), or 15 where the
    terms mix twins."""
    ids = {t.model_id for t in post.terms}
    if len(ids) > 1:
        return 15
    model = ids.pop()
    if model == 3:
        n = max(len(t.pidx_host) for t in post.terms)
        return 13 if n <= 4 else 14 if n <= 8 else 3
    return model


def _spill_free_r(post: FusedPosterior) -> int:
    """Bit mask of the R (bit 0: 1, bit 1: 2, bit 2: 4) whose kernel for
    this posterior's type and twin class has no register spills in the
    build's ptxas log; every R where none is free."""
    table = ptxas_table(build_log("fused_posterior"))
    tc = twin_class(post)
    mask = 0
    for bit, r in enumerate(_PLAN_R):
        e = fused_kernel_entry(table, post.dtype, {"R": r, "twin_class": tc})
        if e is not None and e["spill_stores"] == 0 and e["spill_loads"] == 0:
            mask |= 1 << bit
    return mask or 7


def fused_plan(post: FusedPosterior, W: int, force=None) -> dict:
    """How kernel 1 launches W walkers of ``post`` on the current card
    (``lmt_fused_plan``): ``threads`` a block, ``R`` walkers a thread,
    ``S`` threads a walker, ``blocks``, ``blocks_per_sm`` (the residency
    the card reports for that kernel's registers and shared memory),
    ``sms``, ``smem_bytes`` a block (``cap`` records a buffer, ``nbuf``
    buffers), ``twin_class`` (the kernel's twin, 15: any) and ``waves``,
    the blocks over the blocks the SMs hold at once.

    The plan weighs, for each block size in (64, 128, 256), R and S in (1,
    2, 4), the walkers its busiest SM evaluates against the warps and
    warps x R walker chains it keeps resident there, the shared loads
    (1/R a walker-point) and the S-fold twin setups, and of the plans
    within 3 % of the cheapest takes the one with the most resident warps.
    It takes only an R whose kernel has no register spills (the build's
    ptxas log), where the twin class has one.  ``force=(threads, R, S)``
    (any of them None: chosen) takes those values instead, for tests; a
    value no plan has raises.  Worked out once per W (and force) and kept
    on ``post``.
    """
    key = (int(W), *(force or (None, None, None)))
    if key not in post.plans:
        lib = load_library("fused_posterior")
        fn = _entry(lib, "lmt_fused_plan", _PLAN_ARGTYPES)
        out = (ctypes.c_int * len(_PLAN_KEYS))()
        forced = [int(v or 0) for v in (force or (0, 0, 0))]
        code = fn(_dtype_id(post.dtype), int(W), len(post.terms),
                  ctypes.addressof(post.meta), *forced, _spill_free_r(post),
                  ctypes.addressof(out))
        check_launch(lib, code, f"fused_plan (W={W}, force={force})")
        plan = dict(zip(_PLAN_KEYS, out))
        plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
        post.plans[key] = (plan, out)
    return dict(post.plans[key][0])


def fused_kernel_entry(ptxas: dict, dtype, plan: dict) -> dict | None:
    """The ptxas table entry (``device.ptxas_table`` of the
    ``fused_posterior`` build: registers, stack, spills) of the kernel a
    plan launches, found by its symbol ``lmt::fused_posterior_kernel<T,
    R, twin_class>``; None where the table lacks it."""
    prefix = (f"_ZN3lmt22fused_posterior_kernelI{'f' if dtype == torch.float32 else 'd'}"
              f"Li{plan['R']}ELi{plan['twin_class']}EE")
    return next((v for k, v in ptxas.items() if k.startswith(prefix)), None)


def _launch_fused(positions, post: FusedPosterior, force=None):
    if positions.dtype != post.dtype or positions.device != post.device:
        raise ValueError(
            f"fused_posterior: positions are {positions.dtype} on "
            f"{positions.device}, the posterior is {post.dtype} on {post.device}")
    if positions.ndim != 2 or positions.shape[1] != post.d:
        raise ValueError(f"fused_posterior: positions must be (W, {post.d}), "
                         f"got {tuple(positions.shape)}")
    if not positions.is_contiguous():
        raise ValueError("fused_posterior: positions must be contiguous")
    dtype_id = _dtype_id(post.dtype)
    W = positions.shape[0]
    key = (W, *(force or (None, None, None)))
    if key not in post.plans:
        fused_plan(post, W, force)
    plan = post.plans[key][1]
    lib = load_library("fused_posterior")
    fn = _entry(lib, "lmt_fused_posterior", _FUSED_ARGTYPES)
    out = torch.empty(W, dtype=post.dtype, device=positions.device)
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    code = fn(dtype_id, ctypes.addressof(plan), positions.data_ptr(), W, post.d,
              len(post.terms), ctypes.addressof(post.meta),
              ctypes.addressof(post.rec_ptrs), post.bcol.data_ptr(),
              post.blo.data_ptr(), post.bhi.data_ptr(), len(post.bounds),
              post.cidx.data_ptr(), post.cval.data_ptr(), len(post.constraints),
              post.didx.data_ptr(), post.dval.data_ptr(), len(post.densities),
              post.scalar_const.data_ptr(), out.data_ptr(), stream)
    check_launch(lib, code, "fused_posterior")
    fused_posterior.launches += 1
    return out


def fused_posterior(positions, post: FusedPosterior, force=None):
    """Log-posterior of each walker: on a CUDA tensor one launch of the
    kernel (constant included; a prior's undeclared remainder, if any,
    added in torch), on a CPU tensor the plain version.  ``force=(threads,
    R, S)`` fixes the launch plan (:func:`fused_plan`); the CPU ignores
    it."""
    if positions.device.type == "cpu":
        return fused_posterior_plain(positions, post)
    out = _launch_fused(positions, post, force)
    return out + _rest(positions, post) if post.rest else out


fused_posterior.launches = 0  # kernel launches, for proof that a path used it


def posterior_rel_err(got, ref, post: FusedPosterior) -> float:
    """Largest ``|got - ref|`` between two evaluations of ``post``'s
    posterior, relative to ``max(|ref|, |ref - C|, 1)``, where ``C`` is
    the whole log-normalisation: the scalar constant (added last) plus the
    cutoff kind's per-point constants (summed with the points).

    The log-normalisation can cancel the data's misfit to a posterior near
    0, where ``|ref|`` alone measures nothing but the cancellation;
    ``|ref - C|`` is the size of the misfit the kernel sums.  Pairs with a
    non-finite value are left out.
    """
    got, ref = got.double(), ref.double()
    finite = torch.isfinite(got) & torch.isfinite(ref)
    if not bool(finite.any()):
        return 0.0
    got, ref = got[finite], ref[finite]
    norm = post.scalar_const.double()
    for t in post.terms:
        if t.kind == "normal_cutoff":
            norm = norm + torch.sum(t.cols[3].double() * t.cols[4].double())
    scale = torch.maximum(torch.maximum(ref.abs(), (ref - norm).abs()),
                          torch.ones_like(ref))
    return float(((got - ref).abs() / scale).max())


# ---------------------------------------------------------------- op census
#
# Operations the kernels execute, by class, read off the CUDA source
# (csrc/models.cuh).  "flops" are the non-division floating-point adds,
# multiplies and FMAs, an FMA counted as 2; a division, square root, log,
# exp or cos/sin is one operation of its own class (sin counts as cos).
# Compares, selects, min/max, negations and integer work are not counted,
# so a bound built on the census is a lower bound.

OP_CLASSES = ("flops", "div", "sqrt", "log", "exp", "cos")

# twin id -> (per walker-point: Model::eval, per walker: Model::setup).
# The polynomial (id 3) depends on its coefficient count: model_census.
_MODEL_CENSUS = {
    # eval: u, u*u, u2+lw2, lw2-u2, c2*(.), c1*u+(.) (FMA), s*s, +bg0,
    # bg1*x+(.) (FMA) = 11 flops, and num/(s*s); setup: lw*lw, three
    # multiplies for c1, two for c2, cos(mix) and sin(mix)
    0: ({"flops": 11, "div": 1}, {"flops": 6, "cos": 2}),
    1: ({"flops": 2}, {}),                                 # b + m*x (FMA)
    # eval: a + s*x (FMA); setup: -3*m, b + (.), m - (.), and b/60
    2: ({"flops": 2}, {"flops": 3, "div": 1}),
    # eval: x - x0, (.)/sigma, -0.5*z, *z, exp, scale*e+bg0 (FMA),
    # bg1*x+(.) (FMA)
    4: ({"flops": 7, "div": 1, "exp": 1}, {}),
    # eval: x - x0, u*u+lw2 (FMA), num/(.), +bg0, bg1*x+(.) (FMA);
    # setup: scale*lw, *lw, lw*lw
    5: ({"flops": 6, "div": 1}, {"flops": 3}),
    # eval: two of (x - mu, u*u+s2 (FMA), a/(.), and a subtraction);
    # setup: sigma*sigma, scale1*s2, scale2*s2
    6: ({"flops": 8, "div": 2}, {"flops": 3}),
    # eval: -x/tau, exp, scale*e+bg0 (FMA)
    7: ({"flops": 2, "div": 1, "exp": 1}, {}),
    # eval: w*x, +phase (rounded apart), sin, scale*s+bg0 (FMA); setup 2pi*freq
    8: ({"flops": 4, "cos": 1}, {"flops": 1}),
    # eval: w*x, +phase, sin, -x/tau, exp, scale*e, *osc, +bg0; setup 2pi*freq
    9: ({"flops": 5, "div": 1, "exp": 1, "cos": 1}, {"flops": 1}),
    # eval: x/tau, log, beta*lg, exp, exp(-(.)), scale*d+bg0 (FMA)
    10: ({"flops": 3, "div": 1, "log": 1, "exp": 2}, {}),
    # eval: log, expo*lg, exp, scale*(.)+bg0 (FMA)
    11: ({"flops": 3, "log": 1, "exp": 1}, {}),
    # eval: x - x0, u*u, u2+w2, w2/(.), -ln2*u2, /w2, exp, eta*lor,
    # one_m_eta*gau+(.) (FMA), scale*(.), +bg0, bg1*x+(.) (FMA);
    # setup: w*w, 1 - eta
    12: ({"flops": 11, "div": 2, "exp": 1}, {"flops": 2}),
}
# likelihood kind -> (per walker-point: tile_sum, per walker: finish)
_KIND_CENSUS = {
    "normal": ({"flops": 4}, {"flops": 1}),       # (y-mu)*is, acc+z*z; -0.5*acc
    "normal_cutoff": ({"flops": 7}, {}),          # (y-mu)*is, c-0.5*z*z, acc+lp*mask
    "poisson": ({"flops": 4, "log": 1}, {}),      # y*log(mu)-mu, acc+(.)*mask
}
# per bounds entry per walker: bound_penalty's two distances,
# 1e-5*dist, exp, -1, *-1e10, and prior += (.)
_BOUND_CENSUS = {"flops": 6, "exp": 1}
# per declared constraint per walker (csrc/models.cuh: constraint_total):
# total += penalty, and diff_ge's difference or ratio_in's IEEE division;
# once per walker when there is any, prior += total
_CONSTRAINT_CENSUS = {"le": {"flops": 1}, "diff_ge": {"flops": 2},
                      "ratio_in": {"flops": 1, "div": 1}}


def density_census(kind: str, k: int = 1) -> dict:
    """Operations of one declared density entry per walker
    (``csrc/models.cuh: density_total``): a Gaussian's ``x - mu``, ``*
    1/sigma``, ``-0.5 z``, ``* z``, ``+ c`` and ``total +=`` (6 flops); a
    LogNormal's log and its ``- log x`` besides (7 flops, 1 log); a
    k-parameter quadratic form's subtraction, multiply and add per
    lower-triangle entry, ``z * z`` and ``q +`` per row, ``-0.5 q``, ``+
    log_norm`` and ``total +=``."""
    if kind == "gauss":
        return {"flops": 6}
    if kind == "logn":
        return {"flops": 7, "log": 1}
    return {"flops": 3 * k * (k + 1) // 2 + 2 * k + 3}


def model_census(model_id: int, n_params: int | None = None) -> tuple[dict, dict]:
    """``(per walker-point, per walker)`` operations of one twin; the
    polynomial's Horner step (a multiply and an add, rounded apart) runs
    once per coefficient after the leading one."""
    if model_id == 3:
        return {"flops": 2 * (n_params - 1)}, {}
    return _MODEL_CENSUS[model_id]


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


def fused_census(model_id: int, kind: str, n_bounded: int = 0,
                 n_params: int | None = None) -> dict:
    """Operations of one single-term fused-posterior evaluation, by class.

    ``{"per_point": ..., "per_walker": ..., "per_step": ...}``, each a dict
    over :data:`OP_CLASSES`: per walker-point (model and reduction), per
    walker (model setup, finish, ``total + term`` and ``n_bounded`` bound
    penalties) and, for the chunk stepper, per walker-step beyond the
    posterior (zero here).  ``n_params``: the polynomial's coefficients.
    """
    point_m, walker_m = model_census(model_id, n_params)
    point_k, walker_k = _KIND_CENSUS[kind]
    return op_census(per_point=_classes(point_m, point_k),
                     per_walker=_classes(walker_m, walker_k, {"flops": 1},
                                         {c: n_bounded * n
                                          for c, n in _BOUND_CENSUS.items()}))


def posterior_census(post: FusedPosterior) -> dict:
    """The census of one evaluation of a posterior of any number of terms.

    Its ``per_point`` row already sums every term's points (term t's
    per-point row times its N), so count it with ``N = 1``.  The bounds
    table, the declared constraints and the declared densities
    (:func:`density_census`) are counted per walker; the priors'
    remainders run in torch beside the kernel and are not.
    """
    point, walker = {}, {}
    for t in post.terms:
        c = fused_census(t.model_id, t.kind, n_params=len(t.pidx_host))
        point = _classes(point, {k: t.n * v for k, v in c["per_point"].items()})
        walker = _classes(walker, c["per_walker"])
    walker = _classes(walker, {c: len(post.bounds) * n for c, n in _BOUND_CENSUS.items()},
                      *(_CONSTRAINT_CENSUS[c.kind] for c, _, _ in post.constraints),
                      {"flops": 1 if post.constraints else 0},
                      *(density_census(kind, len(cols)) for kind, cols, _ in post.densities),
                      {"flops": 1 if post.densities else 0})
    return op_census(per_point=point, per_walker=walker)


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


def table_floats(post: FusedPosterior) -> int:
    """Values of the prior's tables in the fit's type: bounds, constraints
    and densities."""
    return 2 * len(post.bounds) + 2 * len(post.constraints) + post.dval.numel()


def table_ints(post: FusedPosterior) -> int:
    """int32 entries of the prior's tables."""
    return len(post.bounds) + 3 * len(post.constraints) + post.didx.numel()


def fused_bytes(post: FusedPosterior, W: int) -> int:
    """Bytes one evaluation must move: positions in, every term's data
    columns once, the prior's tables once, the posterior out."""
    size = post.terms[0].cols[0].element_size()
    data = sum(len(t.cols) * t.n for t in post.terms)
    return size * (W * post.d + data + W + table_floats(post)) + 4 * table_ints(post)
