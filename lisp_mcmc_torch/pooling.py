"""One-call pooling verdict: complete vs partial vs independent.

Port of ``lisp_mcmc_tpu/pooling.py``.  The reference leaves the
cross-dataset choice to the user: fit every file on its own
(``dir->nv-walkers``, nv-specific.lisp:58-66) or share parameters
globally (test.lisp:52-78).  :func:`compare_pooling` fits all three model
classes on the same data,

  - ``"pooled"``: one parameter set for every dataset, the global fit of
    S terms (on the GPU kernel 1 evaluates it, up to
    ``ops.loglik_kernel.MAX_TERMS`` terms of a zoo twin),
  - ``"partial"``: :class:`~lisp_mcmc_torch.hierarchical.HierarchicalFit`,
  - ``"independent"``: :class:`~lisp_mcmc_torch.BatchedFit`,

scores each by PSIS-LOO on the same dataset-major real-point axis, and
returns per-model elpd and se, stacking weights
(:func:`~lisp_mcmc_torch.diagnostics.model_weights`) and the pairwise
differences with their paired SEs.  Every fit comes back fitted, so the
evidence verbs run on it directly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

import numpy as np

__all__ = ["PoolingComparison", "compare_pooling"]


@dataclasses.dataclass(frozen=True)
class PoolingComparison:
    """Result of :func:`compare_pooling`: ``elpd``/``se`` PSIS-LOO per
    model; ``weights`` stacking weights over {pooled, partial,
    independent}; ``best`` the highest elpd; ``decisive`` whether it beats
    the runner-up by more than 2 paired SEs; ``pairwise``
    ``{"a_vs_b": {"elpd_diff", "se_diff"}}``; ``results``/``fits`` the
    per-model ``LOOResult`` and the fitted objects; ``seconds`` each
    model's wall seconds from its build through its LOO score (the score
    reads the history back to the host, so the device's work is in it;
    the port's addition)."""

    elpd: dict
    se: dict
    weights: dict
    best: str
    decisive: bool
    pairwise: dict
    results: dict
    fits: dict
    seconds: dict = dataclasses.field(default_factory=dict)

    def __repr__(self):
        rows = ", ".join(f"{k}: {self.elpd[k]:.1f}±{self.se[k]:.1f} "
                         f"(w={self.weights[k]:.2f})" for k in self.elpd)
        tag = "decisive" if self.decisive else "not decisive"
        return f"PoolingComparison(best={self.best!r} [{tag}]; {rows})"


def _anneal_then_cold_sample(fit, n_steps: int, burn_fraction: float):
    """The LOO scoring recipe on an annealed fit (JAX pooling.py:70-87):
    every model the same budget (auto-stop off), a restart at its best
    point (``BatchedFit``'s each block at its own), a cold mala phase of
    ``max(2000, n_steps // 2)`` steps, then ``burn_fraction`` of it burnt."""
    fit.adaptive_steps(n_steps, auto=None)
    fit.reset_to_most_likely()
    fit.sampling_steps(max(2000, n_steps // 2), kernel="mala")
    fit.burn_steps(int(len(fit) * burn_fraction))


def _combined_loo(fit, max_samples: int):
    """A ``BatchedFit``'s per-dataset LOO results as one dataset-major
    ``LOOResult``."""
    from .diagnostics import LOOResult

    parts = fit.loo_per_dataset(max_samples=max_samples)
    pointwise = np.concatenate([p.pointwise for p in parts])
    pareto_k = np.concatenate([p.pareto_k for p in parts])
    n = pointwise.size
    se = float(np.sqrt(n * pointwise.var(ddof=1))) if n > 1 else 0.0
    lppd = float(sum(p.lppd for p in parts))
    return LOOResult(
        elpd=float(pointwise.sum()), p_loo=float(lppd - pointwise.sum()), lppd=lppd,
        se=se, n_points=n, n_samples=min(p.n_samples for p in parts),
        pointwise=pointwise, pareto_k=pareto_k)


def compare_pooling(function: Callable, datasets: Sequence, params: Mapping,
                    data_error=None, *, pooled: Sequence[str] | None = None,
                    hyper: Mapping | None = None, local_priors: Mapping | None = None,
                    log_likelihood=None, n_steps: int = 6000, n_walkers: int = 256,
                    walkers_per_dataset: int = 64, burn_fraction: float = 0.5,
                    max_samples: int = 256, seed: int = 0, method: str = "stacking",
                    hierarchical_kwargs: Mapping | None = None, dtype=None,
                    device=None) -> PoolingComparison:
    """Fit {pooled, partial, independent} on the same data and compare
    (JAX ``compare_pooling``, pooling.py:107-217).

    ``params``: one guess dict for the three builds; ``pooled``/``hyper``/
    ``local_priors``/``hierarchical_kwargs`` (merged last, e.g.
    ``{"correlation": "full"}``) configure the partial model as
    :class:`HierarchicalFit` takes them; ``log_likelihood`` applies to all
    three.  Each model anneals ``n_steps`` (auto-stop off), restarts at
    its best point, samples cold with mala for ``max(2000, n_steps // 2)``
    steps and burns ``burn_fraction`` of them.  The pooled fit scores
    term-major (its terms are the datasets, in order), the hierarchical
    one dataset-major through its joint pointwise hook, the independent
    one per dataset, concatenated: the same real-point axis.  ``dtype``
    and ``device`` (None: the GPU) go to all three fits.
    """
    from .batched import BatchedFit
    from .device import resolve_device
    from .diagnostics import loo, model_weights
    from .fit import walker_create
    from .hierarchical import HierarchicalFit

    S = len(datasets)
    if S < 2:
        raise ValueError("compare_pooling: need >= 2 datasets (one "
                         "dataset has nothing to pool)")
    device = resolve_device(device)
    datasets = [tuple(d) for d in datasets]
    lls = [log_likelihood] * S if log_likelihood is not None else None
    common = dict(data_error=data_error, dtype=dtype, device=device)
    fits, results, seconds = {}, {}, {}

    # complete pooling: the reference's shared-parameter global fit
    t0 = time.perf_counter()
    w_pool = walker_create(function=[function] * S, data=list(datasets),
                           params=dict(params), log_likelihood=lls,
                           n_walkers=n_walkers, seed=seed, **common)
    _anneal_then_cold_sample(w_pool, n_steps, burn_fraction)
    fits["pooled"] = w_pool
    results["pooled"] = loo(w_pool, max_samples=max_samples)
    seconds["pooled"] = time.perf_counter() - t0

    # partial pooling
    t0 = time.perf_counter()
    h = HierarchicalFit(function, datasets, dict(params), pooled=pooled, hyper=hyper,
                        local_priors=local_priors, log_likelihood=log_likelihood,
                        n_walkers=n_walkers, seed=seed, **common,
                        **dict(hierarchical_kwargs or {}))
    _anneal_then_cold_sample(h, n_steps, burn_fraction)
    fits["partial"] = h
    results["partial"] = loo(h, max_samples=max_samples)
    seconds["partial"] = time.perf_counter() - t0

    # independent
    t0 = time.perf_counter()
    b = BatchedFit(function, datasets, dict(params), log_likelihood=log_likelihood,
                   walkers_per_dataset=walkers_per_dataset, seed=seed, **common)
    _anneal_then_cold_sample(b, n_steps, burn_fraction)
    fits["independent"] = b
    results["independent"] = _combined_loo(b, max_samples)
    seconds["independent"] = time.perf_counter() - t0

    names = list(results)
    n_pts = {k: results[k].n_points for k in names}
    if len(set(n_pts.values())) != 1:
        raise RuntimeError(
            f"compare_pooling: internal axis mismatch {n_pts} — the "
            "three models must score the same real-point axis")

    w = model_weights([results[k] for k in names], method=method, seed=seed)
    weights = dict(zip(names, (float(x) for x in w)))
    elpd = {k: float(results[k].elpd) for k in names}
    se = {k: float(results[k].se) for k in names}
    order = sorted(names, key=lambda k: elpd[k], reverse=True)
    best, runner = order[0], order[1]

    pairwise = {}
    for i, a in enumerate(names):
        for bname in names[i + 1:]:
            d = results[a].pointwise - results[bname].pointwise
            n = d.size
            sd = float(np.sqrt(n * d.var(ddof=1))) if n > 1 else 0.0
            pairwise[f"{a}_vs_{bname}"] = {"elpd_diff": float(d.sum()), "se_diff": sd}
    key = f"{best}_vs_{runner}" if f"{best}_vs_{runner}" in pairwise \
        else f"{runner}_vs_{best}"
    gap = abs(pairwise[key]["elpd_diff"])
    decisive = gap > 2.0 * max(pairwise[key]["se_diff"], 1e-12)

    return PoolingComparison(elpd=elpd, se=se, weights=weights, best=best,
                             decisive=decisive, pairwise=pairwise,
                             results=results, fits=fits, seconds=seconds)
