"""Model zoo: the fitting functions of the reference's scripts.

Model protocol: ``f(x, params) -> y`` on tensors.  ``x`` is the
dataset's ``(P,)`` column; each ``params`` value is a scalar for one
walker or a ``(W, 1)`` column for a walker batch, so the batch result
is ``(W, P)`` by broadcasting (the batch dimension written out where
the JAX package vmaps).  Each model computes what its namesake in
``lisp_mcmc_tpu/models/zoo.py`` computes, in the same order of
operations.

Every zoo model has a CUDA twin in ``csrc/models.cuh``, listed in
:data:`DEVICE_MODELS` with the twin's id and the parameters in the order
the twin reads them.  Pallas traced any jnp function into its kernel;
CUDA traces nothing, so a wrapper that only renames a zoo model's
parameters (test.lisp's ``lorder-mixed-bg2``) is declared with
:func:`renamed`, and :func:`device_model` resolves it to the base twin.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

MODEL_REGISTRY: dict[str, object] = {}

# The most coefficients a polynomial's twin reads (c0..c15).
MAX_POLY = 16

__all__ = ["MODEL_REGISTRY", "DEVICE_MODELS", "MAX_POLY", "Twin",
           "register_model", "get_model", "renamed", "model_coverage",
           "device_model", "line", "example_line", "polynomial",
           "gaussian_peak", "lorentzian_bg", "lorder_mixed_bg",
           "double_lorentzian_bg", "exponential_decay", "sinusoid",
           "damped_sinusoid", "stretched_exponential", "power_law",
           "pseudo_voigt"]


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
def example_line(x, p):
    """The reference's example function (mcmc-fitting.lisp:1178):
    ``b + (-3 m) + (m - b/60) * x``."""
    return p["b"] + (-3.0 * p["m"]) + (p["m"] - p["b"] / 60.0) * x


def _poly_names(keys) -> list[str]:
    """The coefficient names ``c0, c1, ...`` among ``keys``, by index."""
    return sorted((k for k in keys if k.startswith("c")), key=lambda k: int(k[1:]))


@register_model
def polynomial(x, p):
    """Polynomial with coefficients ``c0, c1, c2, ...`` (Horner)."""
    names = _poly_names(p)
    acc = torch.zeros_like(x) + p[names[-1]]
    for k in reversed(names[:-1]):
        acc = acc * x + p[k]
    return acc


@register_model
def gaussian_peak(x, p):
    """Gaussian peak + linear background:
    ``scale * exp(-(x-x0)^2 / (2 sigma^2)) + bg0 + bg1*x``."""
    z = (x - p["x0"]) / p["sigma"]
    return p["scale"] * torch.exp(-0.5 * z * z) + p.get("bg0", 0.0) + p.get("bg1", 0.0) * x


@register_model
def lorentzian_bg(x, p):
    """Lorentzian absorption peak + linear background:
    ``scale * lw^2 / ((x-x0)^2 + lw^2) + bg0 + bg1*x``."""
    u = x - p["x0"]
    lw = p["linewidth"]
    return p["scale"] * lw * lw / (u * u + lw * lw) + p.get("bg0", 0.0) + p.get("bg1", 0.0) * x


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


@register_model
def double_lorentzian_bg(x, p):
    """Two Lorentzian dips below a flat background (NV ODMR spectra,
    nv-specific.lisp:51): ``bg0 - scale1 L(x; mu1) - scale2 L(x; mu2)``,
    ``L(x; mu) = sigma^2 / ((x - mu)^2 + sigma^2)``."""
    s = p["sigma"]
    s2 = s * s
    u1 = x - p["mu1"]
    u2 = x - p["mu2"]
    return (
        p["bg0"]
        - p["scale1"] * s2 / (u1 * u1 + s2)
        - p["scale2"] * s2 / (u2 * u2 + s2)
    )


@register_model
def exponential_decay(x, p):
    """``scale * exp(-x / tau) + bg0``."""
    return p["scale"] * torch.exp(-x / p["tau"]) + p.get("bg0", 0.0)


@register_model
def sinusoid(x, p):
    """``scale * sin(2 pi freq x + phase) + bg0``."""
    return p["scale"] * torch.sin(2.0 * math.pi * p["freq"] * x + p["phase"]) + p.get("bg0", 0.0)


@register_model
def damped_sinusoid(x, p):
    """Exponentially damped oscillation (Rabi/ringdown traces):
    ``scale * exp(-x / tau) * sin(2 pi freq x + phase) + bg0``."""
    osc = torch.sin(2.0 * math.pi * p["freq"] * x + p["phase"])
    return p["scale"] * torch.exp(-x / p["tau"]) * osc + p.get("bg0", 0.0)


@register_model
def stretched_exponential(x, p):
    """Kohlrausch stretched exponential ``scale * exp(-(x / tau)^beta) + bg0``.

    The power is ``exp(beta * log(x/tau))`` with the x/tau <= 0 points
    masked before the log, so they give ``scale + bg0`` instead of NaN.
    """
    r = x / p["tau"]
    safe = torch.where(r > 0.0, r, 1.0)
    pow_ = torch.exp(p["beta"] * torch.log(safe))
    decay = torch.exp(-torch.where(r > 0.0, pow_, 0.0))
    return p["scale"] * decay + p.get("bg0", 0.0)


@register_model
def power_law(x, p):
    """``scale * x^exponent + bg0`` (x <= 0 points give bg0; the masked
    log of :func:`stretched_exponential`)."""
    safe = torch.where(x > 0.0, x, 1.0)
    pow_ = torch.exp(p["exponent"] * torch.log(safe))
    return p["scale"] * torch.where(x > 0.0, pow_, 0.0) + p.get("bg0", 0.0)


@register_model
def pseudo_voigt(x, p):
    """Pseudo-Voigt peak + linear background:
    ``scale [eta L(u) + (1 - eta) G(u)] + bg0 + bg1 x`` with
    ``L = w^2 / (u^2 + w^2)``, ``G = exp(-ln2 u^2 / w^2)``, ``u = x - x0``."""
    u = x - p["x0"]
    w = p["w"]
    w2 = w * w
    u2 = u * u
    lor = w2 / (u2 + w2)
    gau = torch.exp(-math.log(2.0) * u2 / w2)
    eta = p["eta"]
    peak = p["scale"] * (eta * lor + (1.0 - eta) * gau)
    return peak + p.get("bg0", 0.0) + p.get("bg1", 0.0) * x


@dataclasses.dataclass(frozen=True)
class Twin:
    """A model's CUDA twin: its id in ``csrc/models.cuh`` and the
    parameters it reads, in order.  An ``optional`` parameter absent from
    a fit reads 0, as the torch model's ``p.get(name, 0.0)`` does.
    ``names`` is None for the polynomial, whose twin reads the fit's
    ``c0..cK`` (at most :data:`MAX_POLY`)."""

    id: int
    names: tuple | None
    optional: frozenset = frozenset()


_BG = frozenset({"bg0", "bg1"})
# Keep the ids in step with MODEL_* in csrc/models.cuh.
DEVICE_MODELS = {
    lorder_mixed_bg: Twin(0, ("scale", "linewidth", "x0", "mix", "bg0", "bg1"), _BG),
    line: Twin(1, ("b", "m")),
    example_line: Twin(2, ("b", "m")),
    polynomial: Twin(3, None),
    gaussian_peak: Twin(4, ("scale", "x0", "sigma", "bg0", "bg1"), _BG),
    lorentzian_bg: Twin(5, ("scale", "linewidth", "x0", "bg0", "bg1"), _BG),
    double_lorentzian_bg: Twin(6, ("scale1", "scale2", "mu1", "mu2", "sigma", "bg0")),
    exponential_decay: Twin(7, ("scale", "tau", "bg0"), frozenset({"bg0"})),
    sinusoid: Twin(8, ("scale", "freq", "phase", "bg0"), frozenset({"bg0"})),
    damped_sinusoid: Twin(9, ("scale", "tau", "freq", "phase", "bg0"), frozenset({"bg0"})),
    stretched_exponential: Twin(10, ("scale", "tau", "beta", "bg0"), frozenset({"bg0"})),
    power_law: Twin(11, ("scale", "exponent", "bg0"), frozenset({"bg0"})),
    pseudo_voigt: Twin(12, ("scale", "x0", "w", "eta", "bg0", "bg1"), _BG),
}


def renamed(base, mapping: Mapping[str, str], name: str | None = None):
    """``base`` with some parameters read under other names.

    ``mapping`` is ``{base's name: the fit's name}``.  The result is a
    plain model that computes ``base`` on the renamed parameters; a
    renamed parameter the fit lacks is absent for ``base`` (an optional
    one reads 0), never the value under the base name.  The declaration
    rides on the function, so :func:`device_model` resolves it to the
    base's CUDA twin.  test.lisp's second dataset::

        lorder_mixed_bg2 = renamed(lorder_mixed_bg,
                                   {"scale": "scale2", "bg0": "bg02", "bg1": "bg12"})
    """
    mapping = dict(mapping)
    hidden = set(mapping) | set(mapping.values())

    def model(x, p):
        q = {k: v for k, v in p.items() if k not in hidden}
        q.update({old: p[new] for old, new in mapping.items() if new in p})
        return base(x, q)

    model._renamed = (base, mapping)
    model.__name__ = name or f"{base.__name__}_renamed"
    return model


def _resolve(fn, keys):
    """``(zoo model, {base's name: column})`` of the names ``fn`` reads
    from a fit with these ``keys``; None for a function outside the zoo."""
    base, mapping = getattr(fn, "_renamed", (fn, {}))
    if base not in DEVICE_MODELS:
        return None
    hidden = set(mapping) | set(mapping.values())
    view = {k: i for i, k in enumerate(keys) if k not in hidden}
    view.update({old: keys.index(new) for old, new in mapping.items() if new in keys})
    return base, view


def model_coverage(fn, keys) -> str | None:
    """Why ``fn`` on a fit with these parameter ``keys`` has no CUDA twin,
    or None."""
    name = getattr(fn, "__name__", repr(fn))
    resolved = _resolve(fn, keys)
    if resolved is None:
        return (f"model {name!r} has no CUDA twin (twins: the zoo's "
                f"{sorted(f.__name__ for f in DEVICE_MODELS)}, or one of them "
                "declared with models.renamed)")
    base, view = resolved
    twin = DEVICE_MODELS[base]
    if twin.names is None:
        coef = _poly_names(view)
        if not 1 <= len(coef) <= MAX_POLY:
            return (f"model {name!r} has {len(coef)} polynomial coefficients; "
                    f"the twin reads 1 to {MAX_POLY}")
        return None
    missing = [n for n in twin.names if n not in view and n not in twin.optional]
    if missing:
        return f"model {name!r} needs parameters {missing} the fit does not have"
    return None


def device_model(fn, keys) -> tuple[int, tuple[str, ...], tuple[int, ...], object] | None:
    """``(twin id, names, columns, base model)`` for ``fn`` on a fit with
    these ``keys``, or None (:func:`model_coverage` says why).

    ``names`` are the parameters the twin reads, in its order; ``columns``
    the column of each in ``keys``, -1 for an optional one the fit lacks;
    ``base`` is the zoo model that evaluates them by those names.
    """
    if model_coverage(fn, keys) is not None:
        return None
    base, view = _resolve(fn, keys)
    twin = DEVICE_MODELS[base]
    names = tuple(_poly_names(view)) if twin.names is None else twin.names
    return twin.id, names, tuple(view.get(n, -1) for n in names), base
