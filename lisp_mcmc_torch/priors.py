"""Prior system: flat priors, smooth bound penalties, constraint combinators.

Rebuilds the reference's prior layer (mcmc-fitting.lisp):
  - ``log-prior-flat`` (340-343): always 0.
  - ``prior-bounds-let`` (346-369): per-parameter (low, high) bounds with
    the smooth exterior penalty ``-1d10 * (exp(1d-5 * dist) - 1)``, where
    ``dist`` is the distance to the nearer bound (358-360); exactly 0
    inside the open interval.
  - data-dependent prior factories (``log-prior-fixer``, 837-840).
  - the hard constraint style of ``nv-specific.lisp:31-34``.

A prior is ``prior(params, dataset) -> scalar or (W,)``; batched
parameter values are ``(W,)`` columns.  The fused kernels cover the flat
prior and a bounds prior without ``extra`` (they read ``._bounds``).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

__all__ = [
    "log_prior_flat",
    "bound_penalty",
    "prior_bounds",
    "make_bounds_prior",
    "constraint_penalty",
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
