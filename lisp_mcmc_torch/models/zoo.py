"""Model zoo: the fitting functions of the reference's scripts.

Model protocol: ``f(x, params) -> y`` on tensors.  ``x`` is the
dataset's ``(P,)`` column; each ``params`` value is a scalar for one
walker or a ``(W, 1)`` column for a walker batch, so the batch result
is ``(W, P)`` by broadcasting (the batch dimension written out where
the JAX package vmaps).

A model with a CUDA twin in ``csrc/models.cuh`` is listed in
:data:`DEVICE_MODELS` with the twin's id and the parameter names in the
order the twin reads them; the fused kernels cover exactly those models.
"""

from __future__ import annotations

import torch

MODEL_REGISTRY: dict[str, object] = {}

__all__ = ["MODEL_REGISTRY", "DEVICE_MODELS", "register_model", "get_model",
           "device_model", "line", "lorder_mixed_bg"]


def register_model(fn=None, *, name: str | None = None):
    """Register a model for by-name lookup."""

    def wrap(f):
        MODEL_REGISTRY[name or f.__name__] = f
        return f

    return wrap(fn) if fn is not None else wrap


def get_model(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}"
        ) from None


@register_model
def line(x, p):
    """Straight line ``b + m*x``."""
    return p["b"] + p["m"] * x


@register_model
def lorder_mixed_bg(x, p):
    """Mixed Lorentzian derivative (FMR) lineshape + linear background.

    The model behind test.lisp:14-21 (params ``scale, linewidth, x0,
    mix, bg0, bg1``), in the factored form of the JAX package
    (``lisp_mcmc_tpu/models/zoo.py:108-158``): one reciprocal and two
    per-point FMAs,

        y = [c1 u + c2 (lw^2 - u^2)] / (u^2 + lw^2)^2 + bg0 + bg1 x,
        u = x - x0,  c1 = -2 cos(mix) lw^2 scale,  c2 = sin(mix) lw scale.
    """
    u = x - p["x0"]
    lw = p["linewidth"]
    lw2 = lw * lw
    c1 = -2.0 * torch.cos(p["mix"]) * lw2 * p["scale"]
    c2 = torch.sin(p["mix"]) * lw * p["scale"]
    u2 = u * u
    s = u2 + lw2
    num = c1 * u + c2 * (lw2 - u2)
    return num / (s * s) + p.get("bg0", 0.0) + p.get("bg1", 0.0) * x


# model function -> (twin id in csrc/models.cuh, parameter names in the
# order the twin reads them).  Keep the ids in step with MODEL_* there.
DEVICE_MODELS = {
    lorder_mixed_bg: (0, ("scale", "linewidth", "x0", "mix", "bg0", "bg1")),
    line: (1, ("b", "m")),
}


def device_model(fn, keys) -> tuple[int, tuple[int, ...]] | None:
    """``(twin id, column of each twin parameter in keys)`` or None.

    None when ``fn`` has no CUDA twin or a parameter the twin reads is
    not among ``keys`` (the torch model would default it; the twin does
    not).
    """
    entry = DEVICE_MODELS.get(fn)
    if entry is None:
        return None
    model_id, names = entry
    if not all(n in keys for n in names):
        return None
    return model_id, tuple(keys.index(n) for n in names)
