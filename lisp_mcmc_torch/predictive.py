"""Posterior and prior predictive draws, predictions and predictive checks.

Port of ``lisp_mcmc_tpu/predictive.py``.  Replicated datasets ``y_rep ~
p(y | theta_s)`` are drawn at history rows (or prior draws) and compared
with the observed data (Gelman, Meng & Stern 1996).  The model curves of
every draw are one batched call a term (the parameters as ``(S, 1)``
columns) on the walker's device; only the ``(S, N)`` results reach the
host.

Noise models follow the likelihood: the Gaussian reductions draw ``N(f(x,
theta), sigma)``, the Poisson reduction ``Poisson(f(x, theta))``, a
factory likelihood its own ``_predictive_sampler`` (which takes a numpy
``Generator``, as ``likelihoods.py`` defines them), and any other a
``sampler=`` the caller gives.  The library draws come from a
``torch.Generator`` on the walker's device seeded from ``seed`` (the JAX
package splits a PRNG key), through :func:`_normal` and :func:`_poisson`,
which tests replace to inject another stream.  A user ``sampler(generator,
mu, dataset)`` (the JAX package's takes ``(key, mu, dataset)``) gets that
generator.  ``predict``'s noise and ``prior_predictive``'s parameter draws
are numpy's, seeded from ``seed``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Sequence

import numpy as np
import torch

from .diagnostics import _history_samples
from .fit import _host
from .likelihoods import (log_likelihood_normal, log_likelihood_normal_cutoff,
                          log_likelihood_poisson)

__all__ = ["PredictiveDraws", "Prediction", "posterior_predictive", "prior_predictive",
           "predict", "ppc_pvalue"]


@dataclasses.dataclass(frozen=True)
class PredictiveDraws:
    """Replicated observations of one term (real points only): ``x`` (N,)
    or (N, k), ``y_obs`` (N,), ``y_rep`` (S, N) replicates, ``mu`` (S, N)
    the noiseless model curves."""

    term_index: int
    x: np.ndarray
    y_obs: np.ndarray
    y_rep: np.ndarray
    mu: np.ndarray

    def band(self, lo: float = 0.05, hi: float = 0.95):
        """Pointwise (lo, hi) predictive quantile band, each (N,)."""
        return (np.quantile(self.y_rep, lo, axis=0), np.quantile(self.y_rep, hi, axis=0))

    def coverage(self, lo: float = 0.05, hi: float = 0.95) -> float:
        """Share of observed points inside the (lo, hi) band: a calibrated
        model covers about ``hi - lo`` of its own data."""
        b_lo, b_hi = self.band(lo, hi)
        return float(np.mean((self.y_obs >= b_lo) & (self.y_obs <= b_hi)))


@dataclasses.dataclass(frozen=True)
class Prediction:
    """A posterior prediction on a given grid: ``mu`` (S, N) curve draws,
    ``y_rep`` (S, N) with observation noise or None; ``band`` reads
    ``y_rep`` when there is one (a prediction interval), else ``mu`` (a
    credible interval of the curve)."""

    x: np.ndarray
    mu: np.ndarray
    y_rep: np.ndarray | None

    def mean(self):
        return self.mu.mean(axis=0)

    def band(self, lo: float = 0.05, hi: float = 0.95):
        src = self.y_rep if self.y_rep is not None else self.mu
        return np.quantile(src, lo, axis=0), np.quantile(src, hi, axis=0)


def _normal(generator, shape, dtype, device):
    """Standard normals of ``shape`` from ``generator``."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)


def _poisson(generator, rates):
    """Poisson draws at ``rates`` from ``generator``."""
    return torch.poisson(rates, generator=generator)


def _gaussian_sampler(generator, mu, dataset):
    sigma = dataset.sigma[None, : mu.shape[1]]
    return mu + sigma * _normal(generator, mu.shape, mu.dtype, mu.device)


def _poisson_sampler(generator, mu, dataset):
    # Rates are positive where the likelihood is finite; the clamp guards
    # degenerate history rows only.
    return _poisson(generator, torch.clamp_min(mu, 1e-300)).to(mu.dtype)


_SAMPLERS = {
    log_likelihood_normal: _gaussian_sampler,
    log_likelihood_normal_cutoff: _gaussian_sampler,
    log_likelihood_poisson: _poisson_sampler,
}


def _check_decomposable(walker, name: str) -> None:
    if getattr(walker, "group_ids", None) is not None:
        raise ValueError(f"{name}: grouped/batched fits mix per-dataset "
                         "populations in one history; compute per dataset "
                         "(BatchedFit -> per-dataset walkers)")
    if getattr(walker, "_custom_log_post", None) is not None or \
            getattr(walker, "_custom_batched", None) is not None:
        raise ValueError(f"{name}: custom posteriors have no dataset terms to replicate")


def _curves(term, spec, samples, x):
    """``term.fn`` at every draw: ``(S, N)``."""
    pts = {k: v[:, None] for k, v in spec.unflatten(samples).items()}
    return term.fn(x, pts)


def predict(walker, x, term_index: int | None = 0, noise=None, take: int | None = None,
            max_samples: int = 256, seed: int = 0) -> "Prediction | list[Prediction]":
    """Posterior prediction at new abscissae (JAX ``predict``,
    predictive.py:91-139): the model curve at ``x`` for at most
    ``max_samples`` evenly spaced history rows; ``noise`` (a sigma, scalar
    or per point) adds Gaussian observation noise (numpy, seeded from
    ``seed``).  ``term_index=None`` predicts every term's model from the
    same draws (a list)."""
    _check_decomposable(walker, "predict")
    samples = _history_samples(walker, "predict", take, max_samples)
    terms = walker.terms if term_index is None else [walker.terms[term_index]]
    x_arr = torch.as_tensor(np.asarray(x, np.float64), dtype=walker.dtype,
                            device=samples.device)
    rng = np.random.default_rng(seed)
    out = []
    for term in terms:
        mu = _host(_curves(term, walker.spec, samples, x_arr))
        y_rep = None
        if noise is not None:
            sigma = np.broadcast_to(np.asarray(noise, np.float64), mu.shape[1:])
            y_rep = mu + sigma * rng.standard_normal(mu.shape)
        out.append(Prediction(x=np.asarray(x), mu=mu, y_rep=y_rep))
    return out if term_index is None else out[0]


def posterior_predictive(walker, take: int | None = None, max_samples: int = 256,
                         seed: int = 0, sampler: Callable | None = None
                         ) -> list[PredictiveDraws]:
    """Replicated datasets from the posterior history, one
    :class:`PredictiveDraws` a term (JAX ``posterior_predictive``,
    predictive.py:163-190): at most ``max_samples`` evenly spaced history
    rows, each term's curves in one call, noise by the term's likelihood
    or ``sampler(generator, mu, dataset)`` for every term.  The history
    must hold posterior draws (burn the anneal first)."""
    _check_decomposable(walker, "posterior_predictive")
    samples = _history_samples(walker, "posterior_predictive", take, max_samples)
    return _replicate(walker, samples, seed, sampler, "posterior_predictive")


def prior_predictive(walker, bounds=None, n_samples: int = 256, seed: int = 0,
                     sampler: Callable | None = None, prior=None) -> list[PredictiveDraws]:
    """Replicated datasets from the prior (JAX ``prior_predictive``,
    predictive.py:193-223): ``n_samples`` parameter draws of ``prior`` /
    ``bounds`` / the fit's own prior recipe (``priors.resolve_prior_spec``;
    numpy, seeded from ``seed``), then :func:`posterior_predictive`'s noise."""
    _check_decomposable(walker, "prior_predictive")
    from .priors import resolve_prior_spec

    spec = resolve_prior_spec(walker, prior, bounds)
    if spec is None:
        raise ValueError("prior_predictive: pass bounds= or prior= (the walker's prior "
                         "carries no recipe, so there is nothing to draw parameters from)")
    keys = walker.spec.keys
    missing = [k for k in keys if k not in spec]
    if missing:
        raise ValueError(f"prior_predictive: prior/bounds missing {missing}")
    draws = spec.sample(np.random.default_rng(seed), n_samples, keys)
    samples = torch.as_tensor(np.asarray(draws, np.float64), dtype=walker.dtype,
                              device=walker.device)
    return _replicate(walker, samples, seed, sampler, "prior_predictive")


def _replicate(walker, samples, seed: int, sampler: Callable | None,
               name: str) -> list[PredictiveDraws]:
    """(S, d) parameter draws to one :class:`PredictiveDraws` a term.  The
    sampler is ``sampler``, else the likelihood's ``_predictive_sampler``
    (given a numpy Generator seeded from ``seed``), else the library's; a
    sampler of four arguments also gets the draws as ``{name: (S,)}``."""
    spec = walker.spec
    generator = torch.Generator(device=samples.device)
    generator.manual_seed(int(seed))
    rng = np.random.default_rng(seed)
    out = []
    for ti, term in enumerate(walker.terms):
        own = getattr(term.likelihood, "_predictive_sampler", None)
        draw = sampler or own or _SAMPLERS.get(term.likelihood)
        if draw is None:
            raise ValueError(f"{name}: no noise model for likelihood "
                             f"{getattr(term.likelihood, '__name__', term.likelihood)!r}"
                             " — pass sampler=(generator, mu, dataset) -> y_rep")
        stream = rng if (sampler is None and own is not None) else generator
        mu = _curves(term, spec, samples, term.dataset.x)            # (S, P) padded
        if len(inspect.signature(draw).parameters) >= 4:
            y_rep = draw(stream, mu, term.dataset,
                         {k: _host(v) for k, v in spec.unflatten(samples).items()})
        else:
            y_rep = draw(stream, mu, term.dataset)
        n = term.dataset.n
        out.append(PredictiveDraws(term_index=ti, x=_host(term.dataset.x)[:n],
                                   y_obs=_host(term.dataset.y)[:n],
                                   y_rep=_host(y_rep)[:, :n], mu=_host(mu)[:, :n]))
    return out


def ppc_pvalue(walker, stat: Callable[[np.ndarray], float] = np.std,
               take: int | None = None, max_samples: int = 256, seed: int = 0,
               sampler: Callable | None = None,
               draws: Sequence[PredictiveDraws] | None = None) -> dict[str, object]:
    """Posterior predictive p-value ``mean_s [T(y_rep_s) >= T(y_obs)]`` of a
    statistic, every term's real points pooled (JAX ``ppc_pvalue``,
    predictive.py:286-321); ``"per_term"`` holds each term's.  ``draws``
    reuses :func:`posterior_predictive` output."""
    if draws is None:
        draws = posterior_predictive(walker, take=take, max_samples=max_samples,
                                     seed=seed, sampler=sampler)
    per_term = {}
    for d in draws:
        t_obs = float(stat(d.y_obs))
        t_rep = np.apply_along_axis(stat, 1, d.y_rep)
        per_term[d.term_index] = float(np.mean(t_rep >= t_obs))
    pooled_obs = float(stat(np.concatenate([d.y_obs for d in draws])))
    pooled_rep = np.apply_along_axis(stat, 1, np.concatenate([d.y_rep for d in draws],
                                                             axis=1))
    return {"p": float(np.mean(pooled_rep >= pooled_obs)), "stat_obs": pooled_obs,
            "stat_rep_mean": float(pooled_rep.mean()), "per_term": per_term}
