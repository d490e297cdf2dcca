"""Prior system: flat priors, smooth bound penalties, constraint combinators.

Rebuilds the reference's prior layer (mcmc-fitting.lisp):
  - ``log-prior-flat`` (340-343): always 0.
  - ``prior-bounds-let`` (346-369): per-parameter (low, high) bounds with
    the smooth exterior penalty ``-1d10 * (exp(1d-5 * dist) - 1)``, where
    ``dist`` is the distance to the nearer bound (358-360); exactly 0
    inside the open interval.
  - data-dependent prior factories (``log-prior-fixer``, 837-840).
  - the hard constraint style of ``nv-specific.lisp:31-34``, and its
    declared form (:func:`declared_constraints` of :func:`le`,
    :func:`diff_ge` and :func:`ratio_in` entries);
and the JAX package's named priors (``lisp_mcmc_tpu/priors.py``):
:class:`PriorSpec` of :class:`Uniform`, :class:`Gaussian` and
:class:`LogNormal` distributions, the correlated :class:`MVGaussian`, and
the unit-cube maps the evidence layer reads.

A prior is ``prior(params, dataset) -> scalar or (W,)``; batched
parameter values are ``(W,)`` columns.  The CUDA kernels cover the flat
prior, a bounds prior whose ``extra`` is absent or declared (they read
``._bounds`` and the extra's ``._constraints``) and a named prior (they
read ``._prior_spec`` as a table of walls and densities,
``ops/loglik_kernel.split_prior``); any other prior is a closure that
only torch can evaluate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import numpy as np
import torch

__all__ = [
    "log_prior_flat",
    "bound_penalty",
    "prior_bounds",
    "make_bounds_prior",
    "constraint_penalty",
    "Constraint",
    "le",
    "diff_ge",
    "ratio_in",
    "constraint_total",
    "declared_constraints",
    "combine_priors",
    "resolve_prior",
    "Uniform",
    "Gaussian",
    "LogNormal",
    "MVGaussian",
    "PriorSpec",
    "as_prior_spec",
    "resolve_prior_spec",
    "unit_cube_wall",
]

# Exact constants from mcmc-fitting.lisp:360.
PENALTY_SCALE = -1e10
PENALTY_RATE = 1e-5


def log_prior_flat(params, dataset=None):
    """``log-prior-flat`` (mcmc-fitting.lisp:340-343)."""
    return 0.0


def bound_penalty(value, low, high):
    """Smooth exterior penalty for one parameter (mcmc-fitting.lisp:358-360).

    0 inside the open interval (low, high); outside,
    ``-1e10 * (exp(1e-5 * min(|v-high|, |v-low|)) - 1)``.
    """
    value = torch.as_tensor(value)
    dist = torch.minimum(torch.abs(value - high), torch.abs(value - low))
    outside = PENALTY_SCALE * (torch.exp(PENALTY_RATE * dist) - 1.0)
    inside = (low < value) & (value < high)
    return torch.where(inside, 0.0, outside)


def prior_bounds(params: Mapping, bounds: Mapping[str, tuple]) -> dict:
    """Per-parameter penalties + total, the ``prior-bounds-let`` anaphora.

    Returns ``{"<name>_bound": penalty, ..., "bounds_total": sum}``
    (mcmc-fitting.lisp:366-368).
    """
    out = {}
    total = 0.0
    for name, (low, high) in bounds.items():
        key = name[1:] if name.startswith(":") else name
        p = bound_penalty(params[key], low, high)
        out[f"{key}_bound"] = p
        total = total + p
    out["bounds_total"] = total
    return out


def make_bounds_prior(bounds: Mapping[str, tuple], extra: Callable | None = None):
    """Build a prior from a bounds table; the common ``prior-bounds-let`` use.

    ``extra(params, penalties, dataset) -> scalar`` may add constraint terms
    on top of ``penalties["bounds_total"]`` (e.g. nv-specific.lisp:31-34).
    The table rides on the closure as ``._bounds`` (and ``._extra``), which
    is how the fused kernels recognise a prior they can evaluate.
    """

    def prior(params, dataset=None):
        penalties = prior_bounds(params, bounds)
        total = penalties["bounds_total"]
        if extra is not None:
            total = total + extra(params, penalties, dataset)
        return total

    prior._bounds = dict(bounds)
    prior._extra = extra
    prior.__name__ = "bounds_prior"
    return prior


def constraint_penalty(satisfied, penalty=-1e9):
    """Hard constraint term: 0 when satisfied, ``penalty`` otherwise."""
    return torch.where(torch.as_tensor(satisfied), 0.0, penalty)


@dataclasses.dataclass(frozen=True)
class Constraint:
    """One declared hard constraint between parameters ``a`` and ``b``.

    ``kind`` is ``"le"`` (``p[a] <= p[b]``), ``"diff_ge"`` (``p[b] - p[a]
    >= lo``) or ``"ratio_in"`` (``lo < p[a] / p[b] < hi``, strict on both
    sides: a NaN ratio fails).  A failed entry adds
    :func:`constraint_penalty`'s -1e9.  The CUDA kernels evaluate the same
    comparisons (``csrc/models.cuh``: ``constraint_total``).
    """

    kind: str
    a: str
    b: str
    lo: float = 0.0
    hi: float = 0.0

    def satisfied(self, pa, pb):
        """Whether the entry holds at parameter values ``pa``, ``pb``."""
        if self.kind == "le":
            return pa <= pb
        if self.kind == "diff_ge":
            return pb - pa >= self.lo
        ratio = pa / pb
        return (self.lo < ratio) & (ratio < self.hi)


def le(a: str, b: str) -> Constraint:
    """``p[a] <= p[b]``."""
    return Constraint("le", a, b)


def diff_ge(b: str, a: str, c: float) -> Constraint:
    """``p[b] - p[a] >= c``."""
    return Constraint("diff_ge", a, b, float(c))


def ratio_in(a: str, b: str, lo: float, hi: float) -> Constraint:
    """``lo < p[a] / p[b] < hi``, strict on both sides."""
    return Constraint("ratio_in", a, b, float(lo), float(hi))


def constraint_total(entries, column: Callable):
    """The sum of every entry's penalty, in order; ``column(name)`` gives a
    parameter's value (or ``(W,)`` column).  0.0 without entries."""
    total = 0.0
    for i, c in enumerate(entries):
        pen = constraint_penalty(c.satisfied(column(c.a), column(c.b)))
        total = pen if i == 0 else total + pen
    return total


def declared_constraints(*entries: Constraint):
    """An ``extra`` for :func:`make_bounds_prior` made of declared entries.

    ``extra(params, penalties, dataset)`` returns the entries' penalties
    summed in order; the entries ride on it as ``._constraints``, which is
    how the CUDA kernels recognise an extra they can evaluate (a closure
    of any other kind stays in torch).
    """

    def extra(params, penalties=None, dataset=None):
        return constraint_total(entries, params.__getitem__)

    extra._constraints = tuple(entries)
    extra.__name__ = "declared_constraints"
    return extra


def combine_priors(*priors: Callable):
    """Sum several priors into one."""

    def prior(params, dataset=None):
        total = 0.0
        for p in priors:
            total = total + p(params, dataset)
        return total

    return prior


def resolve_prior(prior, params, dataset):
    """Resolve a data-dependent prior factory (``log-prior-fixer``, 837-840)."""
    result = prior(params, dataset)
    if callable(result):
        return result
    return prior


# --------------------------------------------------------------------------
# Named priors (the JAX package's PriorSpec layer, priors.py:150-814).
#
# A PriorSpec carries both halves of a prior for a product of independent
# 1-D distributions: exact draws (``sample``, host numpy RNG) and the
# normalised density (``log_pdf``); the term it adds to the posterior
# (``installed``: 0 for Uniform, the normalised log-density otherwise, plus
# a penalty wall at any truncation edge); and the per-parameter inverse-CDF
# map from the unit cube (``transform``/``inverse``), on which the declared
# prior is the Lebesgue measure (``fit.unit_cube_view``).  Values are torch
# tensors: a Python number becomes a float64 0-d tensor, and a tensor keeps
# its dtype and device.


def _col(x):
    """``x`` as a floating tensor: a tensor keeps its type (an integer one
    becomes float64), anything else becomes float64."""
    if torch.is_tensor(x):
        return x if x.is_floating_point() else x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64))


def _ndtr_np(x):
    from scipy.special import ndtr

    return ndtr(x)


def _ndtri_np(x):
    from scipy.special import ndtri

    return ndtri(x)


def _unit_eps(dtype) -> float:
    """How far the unit-cube maps keep ``u`` from 0 and 1."""
    return 1e-12 if dtype == torch.float64 else 1e-6


@dataclasses.dataclass(frozen=True)
class Uniform:
    """Uniform(low, high): the reference's flat-in-bounds prior as a spec."""

    low: float
    high: float

    def __post_init__(self):
        if not self.high > self.low:
            raise ValueError(f"Uniform: need high > low, got ({self.low}, {self.high})")
        if not (math.isfinite(self.low) and math.isfinite(self.high)):
            # An infinite box has no normalisable width.
            raise ValueError(
                f"Uniform: bounds must be finite, got ({self.low}, {self.high}); "
                "use Gaussian/LogNormal for unbounded support")

    @property
    def support(self):
        return (float(self.low), float(self.high))

    def sample(self, rng, n):
        return rng.uniform(self.low, self.high, size=n)

    def log_pdf(self, x):
        x = _col(x)
        inside = (self.low < x) & (x < self.high)
        return torch.where(inside, x.new_tensor(-math.log(self.high - self.low)),
                           x.new_tensor(-math.inf))

    def installed_log_pdf(self, x):
        # A bounds prior adds 0 inside the box: the normalisation lives in
        # the declared measure, not in the term.
        return torch.zeros_like(_col(x))

    def wall(self, x):
        return bound_penalty(_col(x), self.low, self.high)

    def icdf(self, u):
        return self.low + (self.high - self.low) * _col(u)

    def cdf(self, x):
        return torch.clip((_col(x) - self.low) / (self.high - self.low), 0.0, 1.0)

    def to_meta(self):
        return {"kind": "uniform", "low": float(self.low), "high": float(self.high)}


def _trunc_z(mu, sigma, low, high):
    """(z_low, z_high): the CDF values of the truncation points."""
    za = 0.0 if math.isinf(low) else float(_ndtr_np((low - mu) / sigma))
    zb = 1.0 if math.isinf(high) else float(_ndtr_np((high - mu) / sigma))
    if not zb > za:
        raise ValueError(
            f"truncation ({low}, {high}) leaves no mass under N({mu}, {sigma}^2)")
    return za, zb


@dataclasses.dataclass(frozen=True)
class Gaussian:
    """Gaussian(mu, sigma), optionally truncated to (low, high)."""

    mu: float
    sigma: float
    low: float = -math.inf
    high: float = math.inf

    def __post_init__(self):
        if not self.sigma > 0:
            raise ValueError(f"Gaussian: need sigma > 0, got {self.sigma}")
        if not self.high > self.low:
            raise ValueError(f"Gaussian: need high > low, got ({self.low}, {self.high})")
        _trunc_z(self.mu, self.sigma, self.low, self.high)  # validates the mass

    @property
    def support(self):
        return (float(self.low), float(self.high))

    @property
    def truncated(self) -> bool:
        """Whether a wall stands at either edge (:meth:`wall` nonzero)."""
        return not (math.isinf(self.low) and math.isinf(self.high))

    @property
    def _log_mass(self):
        za, zb = _trunc_z(self.mu, self.sigma, self.low, self.high)
        return math.log(zb - za)

    def sample(self, rng, n):
        za, zb = _trunc_z(self.mu, self.sigma, self.low, self.high)
        u = rng.uniform(za, zb, size=n)
        return self.mu + self.sigma * _ndtri_np(u)

    def _smooth_log_pdf(self, x):
        z = (_col(x) - self.mu) / self.sigma
        return (-0.5 * z * z
                - math.log(self.sigma) - 0.5 * math.log(2.0 * math.pi)
                - self._log_mass)

    def log_pdf(self, x):
        x = _col(x)
        inside = (self.low < x) & (x < self.high)
        return torch.where(inside, self._smooth_log_pdf(x), -math.inf)

    def installed_log_pdf(self, x):
        return self._smooth_log_pdf(x)

    def wall(self, x):
        x = _col(x)
        if not self.truncated:
            return torch.zeros_like(x)
        # bound_penalty takes an infinite edge as it is: |v - inf| = inf
        # loses every min() and the inside test stays right.
        return bound_penalty(x, self.low, self.high)

    def icdf(self, u):
        za, zb = _trunc_z(self.mu, self.sigma, self.low, self.high)
        return self.mu + self.sigma * torch.special.ndtri(za + (zb - za) * _col(u))

    def cdf(self, x):
        za, zb = _trunc_z(self.mu, self.sigma, self.low, self.high)
        z = torch.special.ndtr((_col(x) - self.mu) / self.sigma)
        return torch.clip((z - za) / (zb - za), 0.0, 1.0)

    def to_meta(self):
        return {"kind": "gaussian", "mu": float(self.mu), "sigma": float(self.sigma),
                "low": None if math.isinf(self.low) else float(self.low),
                "high": None if math.isinf(self.high) else float(self.high)}


@dataclasses.dataclass(frozen=True)
class LogNormal:
    """LogNormal: ``log x ~ N(mu, sigma^2)``, optionally truncated to (low, high)."""

    mu: float
    sigma: float
    low: float = 0.0
    high: float = math.inf

    def __post_init__(self):
        if not self.sigma > 0:
            raise ValueError(f"LogNormal: need sigma > 0, got {self.sigma}")
        if self.low < 0 or not self.high > self.low:
            raise ValueError(
                f"LogNormal: need 0 <= low < high, got ({self.low}, {self.high})")
        self._trunc_z()  # validates the mass

    def _trunc_z(self):
        lo = -math.inf if self.low <= 0.0 else math.log(self.low)
        hi = math.inf if math.isinf(self.high) else math.log(self.high)
        return _trunc_z(self.mu, self.sigma, lo, hi)

    @property
    def support(self):
        return (float(self.low), float(self.high))

    @property
    def truncated(self) -> bool:
        """Whether a wall stands at either edge (:meth:`wall` nonzero)."""
        return not (self.low <= 0.0 and math.isinf(self.high))

    @property
    def _log_mass(self):
        za, zb = self._trunc_z()
        return math.log(zb - za)

    def sample(self, rng, n):
        za, zb = self._trunc_z()
        u = rng.uniform(za, zb, size=n)
        return np.exp(self.mu + self.sigma * _ndtri_np(u))

    def _smooth_log_pdf(self, x):
        # The clamped log keeps the value finite at x <= 0, where the
        # quadratic term drives it far down anyway.  The clamp is the
        # column type's smallest normal: a literal 1e-300 is 0 in float32,
        # which would make log(0) and the value NaN there.
        x = _col(x)
        lx = torch.log(torch.clamp_min(x, torch.finfo(x.dtype).tiny))
        z = (lx - self.mu) / self.sigma
        return (-lx - 0.5 * z * z
                - math.log(self.sigma) - 0.5 * math.log(2.0 * math.pi)
                - self._log_mass)

    def log_pdf(self, x):
        x = _col(x)
        inside = (x > self.low) & (x < self.high)
        return torch.where(inside, self._smooth_log_pdf(x), -math.inf)

    def installed_log_pdf(self, x):
        return self._smooth_log_pdf(x)

    def wall(self, x):
        x = _col(x)
        if not self.truncated:
            # The smooth density already collapses at x <= 0.
            return torch.zeros_like(x)
        return bound_penalty(x, self.low, self.high)

    def icdf(self, u):
        za, zb = self._trunc_z()
        return torch.exp(self.mu + self.sigma * torch.special.ndtri(za + (zb - za) * _col(u)))

    def cdf(self, x):
        za, zb = self._trunc_z()
        lx = torch.log(torch.clamp_min(_col(x), 1e-300))
        z = torch.special.ndtr((lx - self.mu) / self.sigma)
        return torch.clip((z - za) / (zb - za), 0.0, 1.0)

    def to_meta(self):
        return {"kind": "lognormal", "mu": float(self.mu), "sigma": float(self.sigma),
                "low": float(self.low),
                "high": None if math.isinf(self.high) else float(self.high)}


_DIST_KINDS = {"uniform": Uniform, "gaussian": Gaussian, "lognormal": LogNormal}


def _dist_from_meta(meta: dict):
    kind = meta["kind"]
    cls = _DIST_KINDS[kind]
    kwargs = {k: v for k, v in meta.items() if k != "kind"}
    if kind == "gaussian":
        kwargs["low"] = -math.inf if kwargs.get("low") is None else kwargs["low"]
        kwargs["high"] = math.inf if kwargs.get("high") is None else kwargs["high"]
    if kind == "lognormal":
        kwargs["high"] = math.inf if kwargs.get("high") is None else kwargs["high"]
    return cls(**kwargs)


def _norm_key(k):
    return k[1:] if isinstance(k, str) and k.startswith(":") else k


def _kind_grouped(dists: Mapping, keys, walls: bool, dtype, device) -> Callable:
    """:meth:`PriorSpec.vector_log_prior`'s evaluator: the Gaussian and
    LogNormal densities as :meth:`Gaussian._smooth_log_pdf` and
    :meth:`LogNormal._smooth_log_pdf` compute them, one gathered column
    block a kind, then the walls of the Uniform and truncated ones."""
    kw = dict(dtype=dtype, device=device)
    rows = {Gaussian: [], LogNormal: []}
    edges = []
    for i, k in enumerate(keys):
        d = dists.get(k)
        if d is None:
            continue
        if type(d) in rows:
            rows[type(d)].append((i, d.mu, d.sigma, -math.log(d.sigma)
                                  - 0.5 * math.log(2.0 * math.pi) - d._log_mass))
        if walls and (isinstance(d, Uniform) or d.truncated):
            edges.append((i, *d.support))

    def table(entries):
        if not entries:
            return None
        cols = list(zip(*entries))
        return (torch.as_tensor(cols[0], device=device),
                *(torch.as_tensor(c, **kw) for c in cols[1:]))

    gauss, lognorm, wall = table(rows[Gaussian]), table(rows[LogNormal]), table(edges)

    def log_prior(theta):
        total = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
        if gauss is not None:
            idx, mu, sig, c = gauss
            z = (theta[..., idx] - mu) / sig
            total = total + torch.sum(c - 0.5 * z * z, dim=-1)
        if lognorm is not None:
            idx, mu, sig, c = lognorm
            lx = torch.log(torch.clamp_min(theta[..., idx], torch.finfo(theta.dtype).tiny))
            z = (lx - mu) / sig
            total = total + torch.sum(c - lx - 0.5 * z * z, dim=-1)
        if wall is not None:
            idx, low, high = wall
            total = total + torch.sum(bound_penalty(theta[..., idx], low, high), dim=-1)
        return total

    return log_prior


class PriorSpec(Mapping):
    """A named prior: one independent 1-D distribution per parameter.

    Values may be :class:`Uniform`/:class:`Gaussian`/:class:`LogNormal`
    instances or ``(low, high)`` tuples (read as :class:`Uniform`, so every
    bounds table is a spec).  The Mapping protocol gives the
    distributions; :meth:`as_log_prior` builds the posterior term to fit
    with, which the CUDA kernels evaluate as a table
    (``ops/loglik_kernel.split_prior``).
    """

    def __init__(self, dists: Mapping):
        out = {}
        for k, v in dists.items():
            key = _norm_key(k)
            if isinstance(v, (Uniform, Gaussian, LogNormal)):
                out[key] = v
            elif isinstance(v, (tuple, list)) and len(v) == 2:
                out[key] = Uniform(float(v[0]), float(v[1]))
            else:
                raise ValueError(
                    f"PriorSpec: parameter {key!r} must be a distribution or "
                    f"a (low, high) tuple, got {v!r}")
        self._dists = out
        self._vec_cache = {}

    def __getitem__(self, k):
        return self._dists[k]

    def __iter__(self):
        return iter(self._dists)

    def __len__(self):
        return len(self._dists)

    def __repr__(self):
        inner = ", ".join(f"{k}: {v}" for k, v in self._dists.items())
        return f"PriorSpec({{{inner}}})"

    def __eq__(self, other):
        return isinstance(other, PriorSpec) and self._dists == other._dists

    @classmethod
    def from_bounds(cls, bounds: Mapping[str, tuple]) -> "PriorSpec":
        return cls(bounds)

    @property
    def is_uniform(self) -> bool:
        return all(isinstance(d, Uniform) for d in self._dists.values())

    @property
    def bounds(self):
        """The box table when every support is finite, else None."""
        box = {}
        for k, d in self._dists.items():
            lo, hi = d.support
            if math.isinf(lo) or math.isinf(hi):
                return None
            box[k] = (lo, hi)
        return box

    def _ordered(self, keys):
        missing = [k for k in keys if k not in self._dists]
        if missing:
            raise ValueError(f"PriorSpec: missing parameters {missing}")
        return [self._dists[k] for k in keys]

    def sample(self, rng, n: int, keys=None):
        """(n, d) exact prior draws (host numpy RNG), columns in ``keys`` order."""
        keys = list(keys) if keys is not None else list(self._dists)
        cols = [np.asarray(d.sample(rng, n)) for d in self._ordered(keys)]
        return np.stack(cols, axis=-1)

    def log_pdf(self, params: Mapping, dataset=None):
        """The normalised log prior density at a params dict."""
        total = 0.0
        for k, d in self._dists.items():
            total = total + d.log_pdf(params[k])
        return _col(total)

    def installed_vec(self, theta, keys, *, walls: bool = False):
        """The installed density terms summed at ``(..., d)`` parameter
        vectors: ``(...)``; with ``walls`` the truncation walls too, so the
        sum is :meth:`as_log_prior`'s (:meth:`vector_log_prior`)."""
        self._ordered(keys)
        theta = _col(theta)
        return self.vector_log_prior(keys, walls=walls, dtype=theta.dtype,
                                     device=theta.device)(theta)

    def vector_log_prior(self, keys, *, walls: bool = True, dtype=torch.float64,
                         device=None) -> Callable:
        """``theta (..., d) -> (...)`` over the columns named ``keys``: each
        distribution's installed log density (and, with ``walls``, its wall)
        summed, evaluated a distribution kind at a time on gathered columns,
        so a few torch kernels serve any d.  A column the spec has no
        distribution for adds nothing (a flat parameter).  The gathered
        tables are built once for each ``(keys, walls, dtype, device)``."""
        device = torch.device("cpu") if device is None else torch.device(device)
        cache_key = (tuple(keys), walls, dtype, device)
        if cache_key not in self._vec_cache:
            self._vec_cache[cache_key] = _kind_grouped(self._dists, keys, walls, dtype,
                                                       device)
        return self._vec_cache[cache_key]

    def transform(self, u, keys):
        """Inverse-CDF map: ``(..., d)`` unit-cube points to parameter
        vectors.  ``u`` is clamped away from 0 and 1 so the map stays finite
        where a proposal steps outside the cube (the wall rejects it)."""
        u = _col(u)
        eps = _unit_eps(u.dtype)
        uc = torch.clip(u, eps, 1.0 - eps)
        cols = [d.icdf(uc[..., i]) for i, d in enumerate(self._ordered(keys))]
        return torch.stack(cols, dim=-1).to(u.dtype)

    def inverse(self, theta, keys):
        """CDF map: ``(..., d)`` parameter vectors to unit-cube points."""
        theta = _col(theta)
        cols = [d.cdf(theta[..., i]) for i, d in enumerate(self._ordered(keys))]
        return torch.stack(cols, dim=-1)

    def as_log_prior(self) -> Callable:
        """The posterior prior term to fit with.

        Uniform components add the reference's exterior bound penalty (0
        inside, mcmc-fitting.lisp:358-360); named ones their normalised
        log-density, plus a wall at any truncation edge.  The callable
        carries ``_prior_spec`` (and, for a pure-uniform spec, ``_bounds``
        and ``_extra = None``, so it runs as the bounds table it is).
        """
        dists = self._dists

        def prior(params, dataset=None):
            total = 0.0
            for k, d in dists.items():
                total = total + d.installed_log_pdf(params[k]) + d.wall(params[k])
            return _col(total)

        prior._prior_spec = self
        prior.__name__ = "prior_spec"
        if self.is_uniform:
            prior._bounds = {k: d.support for k, d in dists.items()}
            prior._extra = None
        return prior

    def to_meta(self) -> dict:
        return {k: d.to_meta() for k, d in self._dists.items()}

    @classmethod
    def from_meta(cls, meta: dict) -> "PriorSpec | MVGaussian":
        if "__mv_gaussian__" in meta:
            return MVGaussian.from_meta(meta)
        return cls({k: _dist_from_meta(m) for k, m in meta.items()})


def as_prior_spec(prior_or_bounds) -> "PriorSpec | MVGaussian":
    """A PriorSpec from a PriorSpec, a bounds dict or a dict of
    distributions.  An :class:`MVGaussian` passes through: its Mapping face
    would keep only the marginals and drop the correlations."""
    if isinstance(prior_or_bounds, (PriorSpec, MVGaussian)):
        return prior_or_bounds
    if isinstance(prior_or_bounds, Mapping):
        return PriorSpec(prior_or_bounds)
    raise ValueError(
        f"expected a PriorSpec or a {{param: (low, high) | distribution}} "
        f"mapping, got {type(prior_or_bounds).__name__}")


def resolve_prior_spec(walker, prior=None, bounds=None):
    """The spec the evidence and calibration layer works with: an explicit
    ``prior=``, then ``bounds=`` (as a Uniform spec), then a fitted term's
    ``_prior_spec``, then a fitted term's ``_bounds`` table, else None."""
    if prior is not None:
        return as_prior_spec(prior)
    if bounds is not None:
        return as_prior_spec(bounds)
    for t in getattr(walker, "terms", None) or []:
        s = getattr(t.prior, "_prior_spec", None)
        if s is not None:
            return s
        b = getattr(t.prior, "_bounds", None)
        if b:
            return PriorSpec.from_bounds(b)
    return None


def unit_cube_wall(u):
    """Exterior penalty that keeps a u-space walk inside the unit cube,
    summed over the last axis: ``(..., d) -> (...)``.

    The reference's 1e-5 rate suits physical scales; on the unit cube it
    is too shallow for the hottest rung of an evidence ladder, so the wall
    uses a unit rate: ``-1e10 * expm1(dist)`` is ~1e8 one percent outside.
    """
    u = _col(u)
    dist = torch.clamp_min(torch.maximum(-u, u - 1.0), 0.0)
    return torch.sum(torch.where(dist > 0, PENALTY_SCALE * torch.expm1(dist), 0.0), dim=-1)


class MVGaussian(Mapping):
    """Correlated Gaussian prior over several parameters jointly.

    The experiment-chaining prior: one fit's posterior summary (an object
    with ``.mode``, a ``{name: value}`` mapping, ``.cov`` and
    ``.n_clamped``, as the JAX package's ``laplace_approx`` returns; see
    :meth:`from_laplace`) becomes the next fit's prior, correlations
    included.  The unit-cube map is ``theta = mean + L ndtri(u)`` with
    ``L`` the covariance's Cholesky factor.  Mapping access gives the 1-D
    marginal ``Gaussian(mu_k, sqrt(cov_kk))``, for display; the joint
    density is what ``log_pdf`` and ``installed_vec`` use.
    """

    def __init__(self, mean: Mapping, cov):
        self._keys = [_norm_key(k) for k in mean]
        self._mean = np.asarray([float(mean[k]) for k in mean], np.float64)
        self._cov = np.asarray(cov, np.float64)
        d = len(self._keys)
        if self._cov.shape != (d, d):
            raise ValueError(f"MVGaussian: cov shape {self._cov.shape} != ({d}, {d})")
        self._cov = 0.5 * (self._cov + self._cov.T)
        try:
            self._chol = np.linalg.cholesky(self._cov)
        except np.linalg.LinAlgError:
            raise ValueError("MVGaussian: covariance is not positive definite") from None
        self._log_norm = (-0.5 * d * math.log(2.0 * math.pi)
                          - float(np.sum(np.log(np.diag(self._chol)))))

    @classmethod
    def from_laplace(cls, laplace, inflate: float = 1.0) -> "MVGaussian":
        """The next fit's prior from a Laplace summary; ``inflate`` scales
        the standard deviations.  A clamped Hessian direction is refused:
        the posterior never constrained it."""
        if getattr(laplace, "n_clamped", 0):
            raise ValueError(
                f"MVGaussian.from_laplace: {laplace.n_clamped} Hessian "
                "direction(s) were clamped — the Laplace covariance is "
                "unreliable along them; fix the fit (or build the prior "
                "by hand) instead of chaining a degenerate curvature")
        return cls(laplace.mode, float(inflate) ** 2 * np.asarray(laplace.cov))

    def __getitem__(self, k):
        try:
            i = self._keys.index(k)
        except ValueError:
            # The Mapping protocol (``k in spec``) relies on KeyError.
            raise KeyError(k) from None
        return Gaussian(float(self._mean[i]), float(np.sqrt(self._cov[i, i])))

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __repr__(self):
        return f"MVGaussian(keys={self._keys}, mean={list(self._mean)})"

    def __eq__(self, other):
        return (isinstance(other, MVGaussian) and self._keys == other._keys
                and np.array_equal(self._mean, other._mean)
                and np.array_equal(self._cov, other._cov))

    @property
    def is_uniform(self) -> bool:
        return False

    @property
    def bounds(self):
        return None

    @property
    def keys_order(self) -> tuple:
        """The parameters in the order of ``mean`` and ``cov``."""
        return tuple(self._keys)

    @property
    def mean(self) -> np.ndarray:
        return self._mean.copy()

    @property
    def chol(self) -> np.ndarray:
        """The covariance's lower Cholesky factor."""
        return self._chol.copy()

    @property
    def log_norm(self) -> float:
        """``-k/2 log 2 pi - log det L``, the density's constant."""
        return self._log_norm

    def _perm(self, keys):
        """The index in the internal order of each requested key."""
        keys = list(keys)
        missing = [k for k in keys if k not in self._keys]
        if missing:
            raise ValueError(f"MVGaussian: missing parameters {missing}")
        if len(keys) != len(self._keys):
            raise ValueError(
                "MVGaussian: a correlated prior covers ALL its parameters "
                f"jointly; asked for {keys}, declared {self._keys}")
        return [self._keys.index(k) for k in keys]

    def _inv_perm(self, keys):
        inv = [0] * len(self._keys)
        for j, i in enumerate(self._perm(keys)):
            inv[i] = j
        return inv

    def sample(self, rng, n: int, keys=None):
        keys = list(keys) if keys is not None else list(self._keys)
        p = self._perm(keys)
        z = rng.standard_normal((n, len(self._keys)))
        th = self._mean + z @ self._chol.T
        return th[:, p]

    def _installed_internal(self, th_i):
        chol = torch.as_tensor(self._chol, dtype=th_i.dtype, device=th_i.device)
        mean = torch.as_tensor(self._mean, dtype=th_i.dtype, device=th_i.device)
        z = torch.linalg.solve_triangular(chol, (th_i - mean)[..., None], upper=False)[..., 0]
        return -0.5 * torch.sum(z * z, dim=-1) + self._log_norm

    def log_pdf(self, params: Mapping, dataset=None):
        """The joint log density at a params dict of values or ``(W,)``
        columns."""
        cols = torch.broadcast_tensors(*(_col(params[k]) for k in self._keys))
        dtype = torch.promote_types(cols[0].dtype, cols[-1].dtype)
        theta = torch.stack([c.to(dtype) for c in cols], dim=-1)
        return self._installed_internal(theta)

    def installed_vec(self, theta, keys):
        theta = _col(theta)
        return self._installed_internal(theta[..., self._inv_perm(keys)])

    def transform(self, u, keys):
        u = _col(u)
        p = self._perm(keys)
        eps = _unit_eps(u.dtype)
        z_i = torch.special.ndtri(torch.clip(u, eps, 1.0 - eps))[..., self._inv_perm(keys)]
        chol = torch.as_tensor(self._chol, dtype=u.dtype, device=u.device)
        mean = torch.as_tensor(self._mean, dtype=u.dtype, device=u.device)
        th_i = mean + (chol @ z_i[..., None])[..., 0]
        return th_i[..., p].to(u.dtype)

    def inverse(self, theta, keys):
        theta = _col(theta)
        th_i = theta[..., self._inv_perm(keys)]
        chol = torch.as_tensor(self._chol, dtype=theta.dtype, device=theta.device)
        mean = torch.as_tensor(self._mean, dtype=theta.dtype, device=theta.device)
        z = torch.linalg.solve_triangular(chol, (th_i - mean)[..., None], upper=False)[..., 0]
        return torch.special.ndtr(z)[..., self._perm(keys)]

    def as_log_prior(self) -> Callable:
        def prior(params, dataset=None):
            return self.log_pdf(params)

        prior._prior_spec = self
        prior.__name__ = "mv_gaussian_prior"
        return prior

    def to_meta(self) -> dict:
        return {"__mv_gaussian__": {
            "keys": list(self._keys),
            "mean": [float(v) for v in self._mean],
            "cov": [[float(v) for v in row] for row in self._cov],
        }}

    @classmethod
    def from_meta(cls, meta: dict) -> "MVGaussian":
        m = meta["__mv_gaussian__"]
        return cls(dict(zip(m["keys"], m["mean"])), m["cov"])
