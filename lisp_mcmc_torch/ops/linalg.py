"""Proposal linear algebra: covariance, clamped Cholesky, Haario scale.

Rebuilds the reference's L2 layer (mcmc-fitting.lisp):
  - ``cholesky-decomp`` (583-598): lower-triangular factor with the diagonal
    clamp ``sqrt(max(0, .))`` (596) so a semi-definite input degrades
    instead of erroring;
  - ``lplist-covariance`` (614-643): population-normalized covariance
    (divides by N, line 643);
  - the Haario ``2.38^2/d`` factor applied to the L-matrix (890).

Everything is batched over leading axes.  The Cholesky is an unrolled
column algorithm (d is small) that returns an ``ok`` flag beside L, so
the caller keeps the previous L on failure with a ``where`` instead of
the reference's condition handler (891-894).
"""

from __future__ import annotations

import torch

__all__ = ["cholesky_clamped", "sample_covariance", "moments_covariance",
           "haario_scale"]


def cholesky_clamped(a):
    """Lower Cholesky factor with the reference's diagonal clamp.

    ``a``: (..., d, d) symmetric.  Returns ``(L, ok)`` where ``ok`` is True
    when the factorization is usable (finite, strictly positive diagonal).
    Off-diagonal entries in columns with a zero pivot are set to 0 rather
    than dividing by zero.
    """
    d = a.shape[-1]
    L = torch.zeros_like(a)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for j in range(d):
        # r = a[j:, j] - L[j:, :j] @ L[j, :j]
        lj = L[..., j, :j]
        r = a[..., j:, j] - torch.sum(L[..., j:, :j] * lj[..., None, :], dim=-1)
        pivot = torch.sqrt(torch.maximum(zero, r[..., 0]))
        safe = pivot > 0
        inv = torch.where(safe, pivot, 1.0)
        col = torch.where(safe[..., None], r[..., 1:] / inv[..., None], 0.0)
        L[..., j, j] = pivot
        if j + 1 < d:
            L[..., j + 1:, j] = col
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = torch.isfinite(L).all(dim=-1).all(dim=-1) & (diag > 0).all(dim=-1)
    return L, ok


def sample_covariance(samples, weights=None):
    """Population covariance of ``(..., M, d)`` samples over axis -2.

    ``weights``: optional (..., M) weights; the normalization divides by
    the weight total (mcmc-fitting.lisp:643 with masking folded in).
    """
    samples = torch.as_tensor(samples)
    if weights is None:
        count = samples.shape[-2]
        centered = samples - samples.mean(dim=-2, keepdim=True)
        return torch.einsum("...mi,...mj->...ij", centered, centered) / count
    w = weights[..., None]
    count = torch.clamp_min(weights.sum(dim=-1), 1.0)
    mean = (samples * w).sum(dim=-2, keepdim=True) / count[..., None, None]
    centered = samples - mean
    # One factor of w: sum w (x-mu)(x-mu)^T / sum w.
    return (torch.einsum("...mi,...mj->...ij", centered * w, centered)
            / count[..., None, None])


def moments_covariance(m_sum, m_outer, m_count):
    """Covariance from accumulated first/second moments.

    ``m_sum``: (..., d) sum of samples, ``m_outer``: (..., d, d) sum of
    outer products, ``m_count``: (...) count.  The streaming form of
    ``lplist-covariance``, population-normalized like the reference.
    """
    count = torch.clamp_min(m_count, 1.0)
    mean = m_sum / count[..., None]
    return m_outer / count[..., None, None] - mean[..., :, None] * mean[..., None, :]


def haario_scale(d: int) -> float:
    """The ``2.38^2 / d`` factor (mcmc-fitting.lisp:890), applied to L."""
    return 2.38**2 / d
