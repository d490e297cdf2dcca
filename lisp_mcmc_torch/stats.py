"""Descriptive statistics (reference C17, mcmc-fitting.lisp:1491-1538).

Port of ``lisp_mcmc_tpu/stats.py``: ``nth-percentile`` (1495), ``95cr``
(1508), ``iqr`` (1511), ``median`` (1515), ``mean`` (1518), ``variance``
(1521), ``standard-deviation`` (1526), and the robust normal sigma from
the 84.1th percentile (1529-1538); also the histogram binning of the plot
layer (``make-histo``, 1542-1564).

The tensor functions accept array-likes and tensors and work on the last
axis by default, on the tensor's device, so they can run over ``(W, T)``
chain batches on the GPU before the host copy.  ``hdi`` and
``make_histogram`` are numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "nth_percentile",
    "credible_interval_95",
    "hdi",
    "iqr",
    "median",
    "mean",
    "variance",
    "standard_deviation",
    "std_from_84th_percentile",
    "multivariate_gaussian_random",
    "make_histogram",
]


def _tensor(x):
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float64)


def _quantile(x, q, axis):
    """Quantiles ``q`` (a scalar or 1-D, in [0, 1]) of ``x`` along
    ``axis`` (None: flattened), interpolated linearly between the sorted
    neighbours as ``jnp.percentile`` does: at ``i = q (n - 1)``,
    ``s[lo] + (i - lo) (s[hi] - s[lo])``.  A NaN anywhere in a slice
    gives NaN.  Sorts, so it has no size limit (``torch.quantile``
    refuses more than 2^24 entries).  The q axes come first in the
    result, as in ``torch.quantile``."""
    x = _tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    s = torch.movedim(x, axis, -1)
    n = s.shape[-1]
    if n == 0:
        raise ValueError("quantile of an empty axis")
    s = torch.sort(s, dim=-1).values
    q = torch.as_tensor(q, dtype=s.dtype, device=s.device)
    i = q * (n - 1)
    lo = torch.floor(i).to(torch.int64).clamp(0, n - 1)
    hi = torch.ceil(i).to(torch.int64).clamp(0, n - 1)
    frac = i - lo.to(s.dtype)
    s_lo = torch.index_select(s, -1, lo.reshape(-1))
    s_hi = torch.index_select(s, -1, hi.reshape(-1))
    v = s_lo + frac.reshape(-1) * (s_hi - s_lo)
    v = torch.where(torch.isnan(s).any(dim=-1, keepdim=True),
                    torch.full_like(v, float("nan")), v)
    return torch.movedim(v, -1, 0).reshape((*q.shape, *s.shape[:-1]))


def nth_percentile(x, n, axis=-1):
    """``nth-percentile`` (mcmc-fitting.lisp:1495): linear interpolation."""
    x = _tensor(x)
    return _quantile(x, torch.as_tensor(n, dtype=x.dtype, device=x.device) / 100.0,
                     axis)


def hdi(samples, level: float = 0.95):
    """Highest-density interval: the shortest interval holding ``level``
    of the samples (the sliding-window minimum over the sorted samples).
    Non-finite samples are dropped."""
    s = np.asarray(samples, float).ravel()
    s = np.sort(s[np.isfinite(s)])
    n = s.size
    if n < 2:
        raise ValueError("hdi: need at least 2 finite samples")
    if not 0.0 < level < 1.0:
        raise ValueError(f"hdi: level must be in (0, 1), got {level}")
    k = max(2, int(np.ceil(level * n)))
    widths = s[k - 1:] - s[: n - k + 1]
    i = int(np.argmin(widths))
    return float(s[i]), float(s[i + k - 1])


def credible_interval_95(x, axis=-1):
    """Central 95% credible interval (``95cr``, 1508): (2.5th, 97.5th)."""
    return nth_percentile(x, 2.5, axis), nth_percentile(x, 97.5, axis)


def iqr(x, axis=-1):
    """Interquartile range (``iqr``, 1511)."""
    return nth_percentile(x, 75, axis) - nth_percentile(x, 25, axis)


def median(x, axis=-1):
    """The median, the mean of the two middle values for an even count."""
    return _quantile(x, 0.5, axis)


def mean(x, axis=-1):
    return torch.mean(_tensor(x), dim=axis)


def variance(x, axis=-1):
    """Population variance (``variance``, 1521 divides by N)."""
    return torch.var(_tensor(x), dim=axis, correction=0)


def standard_deviation(x, axis=-1):
    return torch.std(_tensor(x), dim=axis, correction=0)


def std_from_84th_percentile(x, axis=-1):
    """Robust sigma: 84.1th percentile minus median (mcmc-fitting.lisp:1529-1538).

    For a Gaussian, P84.1 - P50 = 1 sigma; robust to heavy tails.
    """
    return nth_percentile(x, 84.1, axis) - median(x, axis)


def multivariate_gaussian_random(generator, stddevs):
    """Independent per-axis Gaussian draw (``multivariate-gaussian-random``,
    1492), from a ``torch.Generator`` (or None: torch's default one)."""
    stddevs = _tensor(stddevs)
    return torch.randn(stddevs.shape, generator=generator, dtype=stddevs.dtype,
                       device=stddevs.device) * stddevs


def make_histogram(samples, bins: int | None = None):
    """Histogram with the reference's auto-binning (``make-histo``, 1542-1557).

    Bin count defaults to a Freedman-Diaconis-style rule; returns
    ``(counts, centers)`` like the reference's (histo, centers) pair
    (1559-1564).
    """
    samples = np.asarray(samples).ravel()
    if bins is None:
        spread = np.subtract(*np.percentile(samples, [75, 25]))
        width = 2.0 * spread / max(1.0, len(samples) ** (1.0 / 3.0))
        if width <= 0:
            bins = 10
        else:
            bins = int(np.clip(np.ceil((samples.max() - samples.min()) / width), 1, 200))
    counts, edges = np.histogram(samples, bins=bins)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return counts, centers
