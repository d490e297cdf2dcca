"""Dataset likelihood reductions.

Rebuilds the reference's reductions (mcmc-fitting.lisp):
  - ``log-liklihood-normal`` (393-400): sum of Gaussian log-pdfs of the
    residuals over all data points;
  - ``log-liklihood-normal-cutoff`` (419-427): per-point log-pdf clamped to
    ``max(-5000, .)``;
  - ``log-liklihood-normal-weighted`` (README.md:19-25): the same reduction
    once the scalar error is broadcast (done in ``Dataset.create``);
  - a Poisson reduction over ``log-poisson`` (382-383);
  - data-dependent likelihood factories (``log-liklihood-fixer``, 842-845).

A likelihood is ``likelihood(fn, params, dataset)``; with ``(W, 1)``
parameter columns the model gives ``(W, P)`` and the reduction over the
last axis gives ``(W,)``.  These are the plain versions and the ground
truth of the fused kernel (``ops/loglik_kernel.py``).
"""

from __future__ import annotations

import torch

from .data import Dataset

__all__ = [
    "log_likelihood_normal",
    "log_likelihood_normal_cutoff",
    "log_likelihood_normal_weighted",
    "log_likelihood_poisson",
    "resolve_likelihood",
]


def log_likelihood_normal(fn, params, dataset: Dataset):
    """Masked sum of Gaussian log-pdfs (``log-liklihood-normal``, 393-400).

    The walker-independent terms (``-log sigma - log(2 pi)/2`` and
    ``1/sigma``) are cached on the dataset, so the per-walker work is
    multiplies and one reduction.
    """
    mu = fn(dataset.x, params)
    z = (dataset.y - mu) * dataset.inv_sigma
    return dataset.log_norm_const - 0.5 * torch.sum(z * z, dim=-1)


def log_likelihood_normal_cutoff(fn, params, dataset: Dataset, cutoff=-5000.0):
    """Clamped per-point normal (``log-liklihood-normal-cutoff``, 419-427)."""
    mu = fn(dataset.x, params)
    z = (dataset.y - mu) * dataset.inv_sigma
    lp = torch.clamp_min(dataset.log_norm_const_point - 0.5 * z * z, cutoff)
    return torch.sum(lp * dataset.mask, dim=-1)


# The README's weighted variant differs from the plain normal reduction
# only by broadcasting a scalar error, which Dataset.create performs.
log_likelihood_normal_weighted = log_likelihood_normal


def log_likelihood_poisson(fn, params, dataset: Dataset):
    """Poisson counting-data likelihood: model = rate, y = counts."""
    lam = fn(dataset.x, params)
    lp = (dataset.y * torch.log(lam) - lam) * dataset.mask
    return torch.sum(lp, dim=-1) - torch.sum(dataset.log_fact_y)


def resolve_likelihood(likelihood, fn, params, dataset: Dataset):
    """Resolve a data-dependent likelihood factory to a plain likelihood.

    If calling ``likelihood`` yields a callable, that callable replaces it
    (``log-liklihood-fixer``, mcmc-fitting.lisp:842-845).
    """
    result = likelihood(fn, params, dataset)
    if callable(result):
        return result
    return likelihood
