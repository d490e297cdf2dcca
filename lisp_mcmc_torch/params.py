"""Parameter model: named parameter dicts <-> flat vectors.

The reference represents model parameters as keyword plists
``(:scale 1d-5 :x0 2200 ...)``.  Here the canonical representation is a
flat ``(d,)`` tensor (batched to ``(W, d)`` over walkers); named access
is a view through :class:`ParamSpec`, which records the key order once
at fit-creation time (``walker-param-keys``, mcmc-fitting.lisp:469).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .device import resolve_device

__all__ = ["ParamSpec", "normalize_params", "map_params", "scale_params", "reduce_params"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Ordered parameter names; the bridge between dicts and vectors."""

    keys: tuple[str, ...]

    @classmethod
    def from_params(cls, params: Mapping[str, Any] | Sequence[float]) -> "ParamSpec":
        if isinstance(params, Mapping):
            return cls(tuple(_norm_key(k) for k in params.keys()))
        arr = np.asarray(params)
        return cls(tuple(f"p{i}" for i in range(arr.shape[-1])))

    @property
    def ndim(self) -> int:
        return len(self.keys)

    def index(self, key: str) -> int:
        return self.keys.index(_norm_key(key))

    def flatten(self, params: Mapping[str, Any] | Sequence[float], dtype=None,
                device=None):
        """Dict or array -> flat ``(d,)`` tensor (key order = spec order)."""
        if isinstance(params, Mapping):
            params = {_norm_key(k): v for k, v in params.items()}
            params = [float(params[k]) for k in self.keys]
        return torch.as_tensor(np.asarray(params, dtype=np.float64),
                               dtype=dtype, device=device)

    def unflatten(self, vector) -> dict[str, Any]:
        """Flat ``(..., d)`` vector -> ``{name: (...)}`` dict.

        Works on batched vectors: each value keeps the leading batch dims.
        """
        return {k: vector[..., i] for i, k in enumerate(self.keys)}

    def make(self, values: Sequence[float]) -> dict[str, float]:
        return dict(zip(self.keys, values))


def _norm_key(key: str) -> str:
    """Accept ``":scale"`` (reference keyword syntax) as well as ``"scale"``."""
    return key[1:] if key.startswith(":") else key


def normalize_params(params, dtype=torch.float64, device=None):
    """Normalize user params to ``(spec, (d,) tensor)``.

    Accepts a ``{name: scalar}`` dict or a flat list/tuple/array, coerced
    to float like ``to-double-floats`` (mcmc-fitting.lisp:833).
    ``device=None`` means the GPU (``device.resolve_device``: it raises
    without one); pass ``device="cpu"`` for the CPU.
    """
    spec = ParamSpec.from_params(params)
    return spec, spec.flatten(params, dtype=dtype, device=resolve_device(device))


def map_params(fn, params: Mapping[str, Any]) -> dict[str, Any]:
    """Apply ``fn`` to every value (``map-plist``, mcmc-fitting.lisp:450)."""
    return {k: fn(v) for k, v in params.items()}


def scale_params(scale, params: Mapping[str, Any]) -> dict[str, Any]:
    """``scale-plist`` (mcmc-fitting.lisp:456)."""
    return map_params(lambda v: v * scale, params)


def reduce_params(fn, p1: Mapping[str, Any], p2: Mapping[str, Any]) -> dict[str, Any]:
    """Combine two param dicts key by key (``reduce-plists``, 442)."""
    return {k: fn(v, p2[k]) for k, v in p1.items()}
