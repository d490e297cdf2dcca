"""Dataset likelihood reductions.

Rebuilds the reference's reductions (mcmc-fitting.lisp):
  - ``log-liklihood-normal`` (393-400): sum of Gaussian log-pdfs of the
    residuals over all data points;
  - ``log-liklihood-normal-cutoff`` (419-427): per-point log-pdf clamped to
    ``max(-5000, .)``;
  - ``log-liklihood-normal-weighted`` (README.md:19-25): the same reduction
    once the scalar error is broadcast (done in ``Dataset.create``);
  - a Poisson reduction over ``log-poisson`` (382-383);
  - ``log-normal`` (372-377), ``log-poisson`` and ``log-factorial``
    (379-383), ``create-log-liklihood-function`` (402-417);
  - data-dependent likelihood factories (``log-liklihood-fixer``, 842-845);
and the JAX package's robust likelihoods (Student-t, a fitted noise
scale, errors in x) and per-point forms (``pointwise_log_likelihood``,
``pointwise_cdf``).

A likelihood is ``likelihood(fn, params, dataset)``; with ``(W, 1)``
parameter columns the model gives ``(W, P)`` and the reduction over the
last axis gives ``(W,)``.  These are the plain versions and the ground
truth of the fused kernel (``ops/loglik_kernel.py``), which takes the
normal, cutoff and Poisson reductions only (the JAX kernel fuses no
other, ``loglik_pallas.py:64-71``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .data import Dataset

__all__ = [
    "log_normal",
    "log_poisson",
    "log_factorial",
    "log_likelihood_normal",
    "log_likelihood_normal_cutoff",
    "log_likelihood_normal_weighted",
    "log_likelihood_poisson",
    "make_student_t_likelihood",
    "make_noise_scale_likelihood",
    "make_x_error_likelihood",
    "create_log_likelihood_function",
    "resolve_likelihood",
    "pointwise_log_likelihood",
    "pointwise_cdf",
    "LIBRARY_POINTWISE",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _t(x):
    """A floating tensor: a tensor keeps its type, anything else is float64."""
    if torch.is_tensor(x):
        return x if x.is_floating_point() else x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64))


def log_normal(x, mu, sigma):
    """Gaussian log-pdf (``log-normal``, mcmc-fitting.lisp:372-377)."""
    z = (_t(x) - mu) / sigma
    return -0.5 * _LOG_2PI - torch.log(_t(sigma)) - 0.5 * z * z


def log_factorial(n):
    """``log-factorial`` (379-380) through lgamma: exact for integer n >= 0."""
    return torch.lgamma(_t(n) + 1.0)


def log_poisson(lam, k):
    """Poisson log-pmf (``log-poisson``, 382-383)."""
    k = _t(k)
    return k * torch.log(_t(lam)) - lam - log_factorial(k)


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


def make_student_t_likelihood(nu: float = 4.0):
    """Outlier-robust Student-t likelihood with ``nu`` degrees of freedom
    (JAX ``make_student_t_likelihood``): a point costs ``(nu + 1)/2
    log(1 + z^2 / nu)``, so outliers are discounted rather than fatal.
    Carries its per-point form, predictive CDF, a predictive sampler
    (``_predictive_sampler(rng, mu, dataset)``, a numpy Generator) and the
    host simulator of SBC."""
    nu = float(nu)
    if nu <= 0:
        raise ValueError("make_student_t_likelihood: nu must be > 0")
    const = (math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0)
             - 0.5 * math.log(nu * math.pi))
    half = 0.5 * (nu + 1.0)

    def likelihood(fn, params, dataset: Dataset):
        mu = fn(dataset.x, params)
        z = (dataset.y - mu) * dataset.inv_sigma
        n_real = torch.sum(dataset.mask)
        return (dataset.log_norm_const
                + (const + 0.5 * _LOG_2PI) * n_real
                - half * torch.sum(torch.log1p(z * z / nu), dim=-1))

    def _pointwise(fn, params, dataset: Dataset):
        mu = fn(dataset.x, params)
        z = (dataset.y - mu) * dataset.inv_sigma
        per = (dataset.log_norm_const_point
               + (const + 0.5 * _LOG_2PI) * dataset.mask
               - half * torch.log1p(z * z / nu))
        return per * dataset.mask

    def _sampler(rng, mu, dataset):
        sigma = dataset.sigma[None, : mu.shape[1]]
        t = torch.as_tensor(rng.standard_t(nu, tuple(mu.shape)), dtype=mu.dtype,
                            device=mu.device)
        return mu + sigma * t

    def _cdf(fn, params, dataset: Dataset):
        from scipy.special import betainc

        mu = fn(dataset.x, params)
        z = (dataset.y - mu) * dataset.inv_sigma
        # F(z) = 1 - I_{nu/(nu+z^2)}(nu/2, 1/2) / 2 for z >= 0, mirrored
        # below (the regularized incomplete beta, on the host).
        arg = (nu / (nu + z * z)).detach().cpu().numpy()
        tail = 0.5 * torch.as_tensor(betainc(nu / 2.0, 0.5, arg), dtype=z.dtype,
                                     device=z.device)
        return torch.where(z >= 0.0, 1.0 - tail, tail)

    def _sbc_simulator(rng, mu, sigma, params):
        return mu + sigma * rng.standard_t(nu, mu.shape)

    likelihood.__name__ = f"student_t_likelihood_nu{nu:g}"
    likelihood._pointwise = _pointwise
    likelihood._predictive_sampler = _sampler
    likelihood._pointwise_cdf = _cdf
    likelihood._sbc_simulator = _sbc_simulator
    likelihood._nu = nu
    return likelihood


def make_noise_scale_likelihood(key: str = "noise_scale"):
    """Gaussian likelihood with the noise level as a fitted parameter
    ``params[key]`` = k (JAX ``make_noise_scale_likelihood``): every sigma
    is scaled by k, so the correction is ``-N log k`` and ``/k^2`` on the
    cached sums.  Give k a positive prior; k <= 0 hits the NaN floor."""

    def likelihood(fn, params, dataset: Dataset):
        k = _t(params[key])
        mu = fn(dataset.x, params)
        z = (dataset.y - mu) * dataset.inv_sigma
        n_real = torch.sum(dataset.mask)
        # k is a (W, 1) column (or a value): reduce with the last axis kept.
        zz = torch.sum(z * z, dim=-1, keepdim=True)
        out = dataset.log_norm_const - n_real * torch.log(k) - 0.5 * zz / (k * k)
        return out[..., 0]

    def _pointwise(fn, params, dataset: Dataset):
        k = _t(params[key])
        mu = fn(dataset.x, params)
        z = (dataset.y - mu) * dataset.inv_sigma
        per = (dataset.log_norm_const_point - torch.log(k) * dataset.mask
               - 0.5 * z * z / (k * k))
        return per * dataset.mask

    def _sampler(rng, mu, dataset, params_s):
        sigma = dataset.sigma[None, : mu.shape[1]]
        k = torch.as_tensor(np.asarray(params_s[key]), dtype=mu.dtype,
                            device=mu.device)[:, None]
        z = torch.as_tensor(rng.standard_normal(tuple(mu.shape)), dtype=mu.dtype,
                            device=mu.device)
        return mu + k * sigma * z

    def _cdf(fn, params, dataset: Dataset):
        k = _t(params[key])
        mu = fn(dataset.x, params)
        z = (dataset.y - mu) * dataset.inv_sigma
        return torch.special.ndtr(z / k)

    def _sbc_simulator(rng, mu, sigma, params):
        k = float(params[key])
        return mu + k * sigma * rng.standard_normal(mu.shape)

    likelihood.__name__ = f"noise_scale_likelihood[{key}]"
    likelihood._pointwise = _pointwise
    likelihood._predictive_sampler = _sampler
    likelihood._pointwise_cdf = _cdf
    likelihood._sbc_simulator = _sbc_simulator
    likelihood._noise_key = key
    return likelihood


def make_x_error_likelihood(sigma_x):
    """Errors-in-variables (York / orthogonal-distance) likelihood: x and y
    both uncertain (JAX ``make_x_error_likelihood``).  The profile form
    ``-sum r^2 / (2 sigma_eff^2)``, ``sigma_eff^2 = sigma_y^2 + (df/dx
    sigma_x)^2``, with no parameter-dependent normalisation (the marginal
    form's ``-log sigma_eff`` attenuates the slope).  df/dx is the model's
    elementwise derivative by ``torch.func.jvp``.  ``sigma_x``: scalar or
    per point; 1-D x only."""
    sigma_x = _t(sigma_x)
    if sigma_x.ndim > 1:
        raise ValueError("make_x_error_likelihood: sigma_x must be a "
                         "scalar or a 1-D per-point array")

    def _xe(dataset: Dataset):
        """sigma_x on the dataset's device and type, padded to its length."""
        if dataset.x.ndim != 1:
            raise ValueError(
                "make_x_error_likelihood: multi-column x is unsupported "
                "(an isotropic sigma_x is ambiguous across columns)")
        xe = sigma_x.to(dtype=dataset.sigma.dtype, device=dataset.sigma.device)
        if xe.ndim == 0:
            return xe
        p, n = dataset.sigma.shape[0], xe.shape[0]
        if n > p:
            raise ValueError(f"make_x_error_likelihood: sigma_x has {n} entries but "
                             f"the dataset holds {int(dataset.n)} points")
        if n < p:
            return torch.cat([xe, xe.new_zeros(p - n)])
        return xe

    def _mu_dmu(fn, params, x):
        return torch.func.jvp(lambda xx: fn(xx, params), (x,), (torch.ones_like(x),))

    def _per_point(fn, params, dataset: Dataset):
        mu, dmu = _mu_dmu(fn, params, dataset.x)
        var_eff = dataset.sigma ** 2 + (dmu * _xe(dataset)) ** 2
        r = dataset.y - mu
        return (dataset.log_norm_const_point - 0.5 * r * r / var_eff) * dataset.mask

    def likelihood(fn, params, dataset: Dataset):
        return torch.sum(_per_point(fn, params, dataset), dim=-1)

    def _sampler(rng, mu, dataset):
        p = mu.shape[1]
        sigma_y = dataset.sigma[None, :p]
        x = dataset.x[:p]
        spacing = torch.gradient(x)[0]
        spacing = torch.where(spacing.abs() < 1e-30, 1e-30, spacing)
        dx = torch.gradient(mu, dim=1)[0] / spacing[None, :]
        xe = _xe(dataset)
        xe = xe[None, :p] if xe.ndim else xe
        sig = torch.sqrt(sigma_y ** 2 + (dx * xe) ** 2)
        z = torch.as_tensor(rng.standard_normal(tuple(mu.shape)), dtype=mu.dtype,
                            device=mu.device)
        return mu + sig * z

    likelihood.__name__ = "x_error_likelihood"
    likelihood._pointwise = _per_point
    likelihood._predictive_sampler = _sampler
    likelihood._sigma_x = sigma_x
    return likelihood


def create_log_likelihood_function(point_log_likelihood: Callable):
    """A dataset likelihood from a per-point ``(y, model, sigma) -> logp``
    (``create-log-liklihood-function``, mcmc-fitting.lisp:402-417)."""

    def likelihood(fn, params, dataset: Dataset):
        mu = fn(dataset.x, params)
        lp = point_log_likelihood(dataset.y, mu, dataset.sigma)
        return torch.sum(lp * dataset.mask, dim=-1)

    def _pointwise(fn, params, dataset: Dataset):
        mu = fn(dataset.x, params)
        return point_log_likelihood(dataset.y, mu, dataset.sigma) * dataset.mask

    likelihood.__name__ = getattr(point_log_likelihood, "__name__", "custom") + "_likelihood"
    likelihood._pointwise = _pointwise
    return likelihood


LIBRARY_POINTWISE = (log_likelihood_normal, log_likelihood_normal_cutoff,
                     log_likelihood_poisson)


def pointwise_log_likelihood(likelihood, fn, params, dataset: Dataset):
    """Per-point log densities, ``(..., P)`` (padding 0): the un-reduced
    likelihood, whose sum over the points is the reduction (the cached
    constants included per point).  The library reductions are known by
    identity; a factory's likelihood carries ``_pointwise``."""
    if likelihood is log_likelihood_normal:
        mu = fn(dataset.x, params)
        z = (dataset.y - mu) * dataset.inv_sigma
        return dataset.log_norm_const_point - 0.5 * z * z
    if likelihood is log_likelihood_normal_cutoff:
        mu = fn(dataset.x, params)
        z = (dataset.y - mu) * dataset.inv_sigma
        lp = torch.clamp_min(dataset.log_norm_const_point - 0.5 * z * z, -5000.0)
        return lp * dataset.mask
    if likelihood is log_likelihood_poisson:
        lam = fn(dataset.x, params)
        return (dataset.y * torch.log(lam) - lam) * dataset.mask - dataset.log_fact_y
    pw = getattr(likelihood, "_pointwise", None)
    if pw is not None:
        return pw(fn, params, dataset)
    raise ValueError(
        "pointwise_log_likelihood: unrecognized likelihood "
        f"{getattr(likelihood, '__name__', likelihood)!r} — use a library "
        "reduction or create_log_likelihood_function (custom reductions "
        "have no recoverable per-point form)")


def pointwise_cdf(likelihood, fn, params, dataset: Dataset):
    """Per-point predictive CDF ``P(Y_i <= y_i | theta)``, ``(..., P)``:
    the normal kinds' ndtr(z), the Poisson's mid-p ``F(y) - p(y)/2``
    (padding 0.5), or a factory's ``_pointwise_cdf``."""
    if likelihood in (log_likelihood_normal, log_likelihood_normal_cutoff):
        mu = fn(dataset.x, params)
        return torch.special.ndtr((dataset.y - mu) * dataset.inv_sigma)
    if likelihood is log_likelihood_poisson:
        lam = fn(dataset.x, params)
        cdf_y = torch.special.gammaincc(dataset.y + 1.0, lam)
        pmf = torch.exp(dataset.y * torch.log(lam) - lam - dataset.log_fact_y)
        return torch.where(dataset.mask > 0, cdf_y - 0.5 * pmf, 0.5)
    cdf = getattr(likelihood, "_pointwise_cdf", None)
    if cdf is not None:
        return cdf(fn, params, dataset)
    raise ValueError(
        "pointwise_cdf: no per-point predictive CDF for likelihood "
        f"{getattr(likelihood, '__name__', likelihood)!r} — LOO-PIT needs "
        "a library reduction or a factory that ships _pointwise_cdf "
        "(student-t and noise-scale do; custom reductions don't)")


def resolve_likelihood(likelihood, fn, params, dataset: Dataset):
    """Resolve a data-dependent likelihood factory to a plain likelihood.

    If calling ``likelihood`` yields a callable, that callable replaces it
    (``log-liklihood-fixer``, mcmc-fitting.lisp:842-845).
    """
    result = likelihood(fn, params, dataset)
    if callable(result):
        return result
    return likelihood
