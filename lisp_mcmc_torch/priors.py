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
    :func:`diff_ge` and :func:`ratio_in` entries).

A prior is ``prior(params, dataset) -> scalar or (W,)``; batched
parameter values are ``(W,)`` columns.  The CUDA kernels cover the flat
prior and a bounds prior whose ``extra`` is absent or declared (they read
``._bounds`` and the extra's ``._constraints``); any other prior is a
closure that only torch can evaluate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

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
