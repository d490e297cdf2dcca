"""Data normalization: user data -> device-resident datasets.

Reference behavior being rebuilt (mcmc-fitting.lisp):
  - ``clean-data`` (807-825): force data to list-of-datasets of proper depth;
    a single ``(x y)`` pair is wrapped into a one-dataset list; errors if the
    dataset count doesn't match the function count.
  - ``clean-data-error`` (774-805): broadcast a scalar error over the y
    structure, or keep a structure-matching error as given.
  - ``create-walker-data`` (827-831): column extraction from an ingested table.

A :class:`Dataset` holds tensors on the fit's device with an explicit
mask, so every likelihood reduction is a masked sum.  The JAX package
pads to a multiple of 128 (a TPU lane layout); the port pads only to a
requested ``min_len`` (a ragged batch of datasets stacked to one shape,
``batched.py``), and a padded dataset, its own or one carried over from
the JAX package (``convert.py``), stays exact because its mask zeroes
the padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from .device import resolve_device

__all__ = ["Dataset", "clean_data", "clean_data_error", "create_walker_data"]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Dataset:
    """One (x, y, sigma, mask) dataset.

    ``x``: (P,) or (P, C) independent variable(s); ``y``: (P,) observations;
    ``sigma``: (P,) per-point errors (broadcast from scalar upstream);
    ``mask``: (P,) 1.0 for real points, 0.0 for padding; ``n``: true count.
    The walker-independent likelihood terms are cached at construction.
    """

    x: Any
    y: Any
    sigma: Any
    mask: Any
    n: int
    inv_sigma: Any = None
    log_norm_const: Any = None
    log_norm_const_point: Any = None
    log_fact_y: Any = None

    def __post_init__(self):
        if self.inv_sigma is None:
            object.__setattr__(self, "inv_sigma", self.mask / self.sigma)
        if self.log_norm_const_point is None:
            object.__setattr__(
                self, "log_norm_const_point",
                self.mask * (-0.5 * _LOG_2PI - torch.log(self.sigma)))
        if self.log_norm_const is None:
            object.__setattr__(self, "log_norm_const",
                               torch.sum(self.log_norm_const_point))
        if self.log_fact_y is None:
            # lgamma(y!) for the Poisson reduction, masked.
            object.__setattr__(self, "log_fact_y",
                               torch.lgamma(self.y + 1.0) * self.mask)

    @property
    def device(self) -> torch.device:
        return self.y.device

    @classmethod
    def create(cls, x, y, sigma=None, dtype=torch.float64, device=None, min_len: int = 0):
        """Validate and move to ``device``: ``None`` means the GPU
        (``device.resolve_device``: it raises without one); pass
        ``device="cpu"`` for the CPU.  ``min_len``: pad to at least this
        many points (JAX data.py:84-89), repeating the last x and y, with
        sigma 1 and mask 0, so every reduction stays exact."""
        device = resolve_device(device)
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if y.ndim != 1:
            raise ValueError(f"y must be 1-D, got shape {y.shape}")
        n = y.shape[0]
        if x.shape[0] != n:
            raise ValueError(f"x length {x.shape[0]} != y length {y.shape[0]}")
        if sigma is None:
            sigma = 1.0
        sigma = np.asarray(sigma, dtype=np.float64)
        if sigma.ndim == 0:
            sigma = np.full((n,), float(sigma))
        elif sigma.shape != (n,):
            raise ValueError(f"sigma shape {sigma.shape} != y shape {(n,)}")
        if not np.all(sigma > 0):
            # A zero/negative error would give inf inv_sigma and a
            # -inf/NaN posterior that silently never accepts.
            bad = int(np.argmin(sigma))
            raise ValueError(
                f"data_error must be positive everywhere; got "
                f"{sigma[bad]} at point {bad}")

        p = max(n, int(min_len))
        mask = np.zeros(p)
        mask[:n] = 1.0
        if p > n:
            x = np.pad(x, [(0, p - n)] + [(0, 0)] * (x.ndim - 1), mode="edge")
            y = np.pad(y, (0, p - n), mode="edge")
            sigma = np.pad(sigma, (0, p - n), mode="constant", constant_values=1.0)

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(x=t(x), y=t(y), sigma=t(sigma), mask=t(mask), n=n)

    def astype(self, dtype) -> "Dataset":
        """The dataset in another floating type (JAX data.py:128): x, y,
        sigma and mask converted, the cached terms recomputed in it."""
        return Dataset(x=self.x.to(dtype), y=self.y.to(dtype), sigma=self.sigma.to(dtype),
                       mask=self.mask.to(dtype), n=self.n)


def _depth(tree) -> int:
    """Depth of the first element (``get-depth``, mcmc-fitting.lisp:761-772)."""
    if isinstance(tree, np.ndarray):
        return tree.ndim
    if np.isscalar(tree):
        return 0
    if hasattr(tree, "__len__"):
        if len(tree) == 0:
            return 1
        return 1 + _depth(tree[0])
    return 0


def clean_data(data, num_functions: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Normalize to a list of ``(x, y)`` ndarray pairs, one per model function.

    Mirrors ``clean-data`` (mcmc-fitting.lisp:807-825): depth-1 input is an
    error; a single ``(x, y)`` dataset (depth 2) is wrapped; the dataset count
    must equal the function count.
    """
    d = _depth(data)
    if d <= 1:
        raise ValueError("clean_data: data is of insufficient depth or improperly structured.")
    if d == 2:
        data = [data]
    if len(data) != num_functions:
        raise ValueError(
            f"clean_data: insufficient number of datasets, {len(data)}, "
            f"for the given number of functions, {num_functions}."
        )
    out = []
    for ds in data:
        cols = [np.asarray(c, dtype=np.float64) for c in ds]
        if len(cols) < 2:
            raise ValueError("clean_data: each dataset needs at least (x, y) columns.")
        # >2 columns: all but the last stack into a multi-column x.
        x = cols[0] if len(cols) == 2 else np.stack(cols[:-1], axis=-1)
        out.append((x, cols[-1]))
    return out


def clean_data_error(data_error, cleaned: Sequence[tuple[np.ndarray, np.ndarray]]):
    """Broadcast errors over each dataset's y (``clean-data-error``, 774-805).

    ``data_error`` may be: a scalar (uniform error for all datasets), a
    per-dataset list of scalars/arrays, or arrays matching each y.  A
    structure mismatch falls back to broadcasting the first scalar found,
    like the reference.
    """

    def first_scalar(tree):
        if np.isscalar(tree):
            return float(tree)
        arr = np.asarray(tree, dtype=object).ravel()
        for v in arr:
            if np.isscalar(v) or isinstance(v, (int, float, np.floating)):
                return float(v)
        return 1.0

    if data_error is None:
        data_error = 1.0
    if np.isscalar(data_error):
        return [np.full(y.shape, float(data_error)) for _, y in cleaned]
    err_list = list(data_error)
    out = []
    for i, (_, y) in enumerate(cleaned):
        e = err_list[i] if i < len(err_list) else first_scalar(data_error)
        if np.isscalar(e):
            out.append(np.full(y.shape, float(e)))
        else:
            e = np.asarray(e, dtype=np.float64)
            if e.size == 1:
                out.append(np.full(y.shape, float(e.ravel()[0])))
            elif e.shape == y.shape:
                out.append(e)
            else:
                out.append(np.full(y.shape, first_scalar(e)))
    return out


def create_walker_data(table, *columns: int) -> list[np.ndarray]:
    """Extract columns from an ingested table (``create-walker-data``, 827-831).

    ``table`` is a column-major sequence (as returned by
    :func:`lisp_mcmc_torch.io.read_file_data`); returns ``[col_i, ...]`` as
    float arrays, typically ``(x, y)``.
    """
    return [np.asarray(table[c], dtype=np.float64) for c in columns]
