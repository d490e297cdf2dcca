"""Vectorized walker sets: S same-model datasets fitted as one ensemble.

Port of ``lisp_mcmc_tpu/batched.py``.  The reference fits many spectra
as a Lisp list of walkers advanced one after another
(``dir->nv-walkers``, nv-specific.lisp:58-66); here

  - the S datasets stack into ``(S, P)`` tensors (a ragged batch pads to
    its longest dataset, each mask keeping its reduction exact);
  - the ensemble has ``S * walkers_per_dataset`` walkers, each dataset's
    walkers one contiguous block;
  - each dataset is its own adaptation group (its own L, acceptance
    window and annealing state, the runner's block layout);
  - the posterior evaluates the whole batch as ``(S, B, d)`` blocks
    against the ``(S, P)`` stacks, no per-walker gathers.

The default Gaussian reduction runs a z-sum against the cached
per-dataset constants; any other likelihood (Student-t, noise-scale,
Poisson, errors in x, ``create_log_likelihood_function``) runs the
single fit's ``likelihood(fn, params, dataset)`` contract over a stacked
``Dataset`` under ``torch.func.vmap``.  The per-walker posterior
``log_post(theta, dataset_idx, data)`` is the walker's aux posterior
(``aux`` = each walker's dataset index), which ``laplace_per_dataset``,
``diagnose_params`` and the u-space view read.  A batch runs on the
plain posterior by design, as the JAX package keeps it off Pallas
(fit.py:364): neither CUDA kernel has a per-walker dataset.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .data import Dataset
from .device import resolve_device
from .fit import Walker, _Term, _host, default_dtype, history_block_columns
from .likelihoods import log_likelihood_normal, resolve_likelihood
from .params import ParamSpec
from .priors import log_prior_flat

__all__ = ["BatchedFit"]

_DATASET_FIELDS = ("x", "y", "sigma", "mask", "inv_sigma", "log_norm_const",
                   "log_norm_const_point", "log_fact_y")


def _pick(t, idx):
    """``t[idx]`` for a 0-d index tensor, as an ``index_select`` (plain
    indexing by a tensor reads its value, which ``torch.func.hessian``
    under ``vmap`` refuses)."""
    return torch.index_select(t, 0, idx.reshape(1))[0]


def _posterior_stack(dsets, gaussian: bool) -> dict:
    """A stacked posterior's data: the datasets' ``(S, P)`` stacks, all of
    them as ``{"ds": fields}``, or for the Gaussian z-sum path only x, y,
    inv_sigma and the (S,) constants (``BatchedFit`` and
    ``hierarchical.HierarchicalFit``)."""
    stack = {k: torch.stack([getattr(ds, k) for ds in dsets]) for k in _DATASET_FIELDS}
    if not gaussian:
        return {"ds": stack}
    return {"x": stack["x"], "y": stack["y"], "inv_sigma": stack["inv_sigma"],
            "const": stack["log_norm_const"]}


class _DatasetView:
    """Read-only single-dataset view of one walker block of a
    :class:`BatchedFit` (JAX batched.py:45-91): ``spec``, ``dtype``,
    ``device``, ``terms`` (the block's own dataset), ``_history``,
    ``steps`` and ``most_likely_params``, the history columns mapped
    through :func:`fit.history_block_columns` (the whole ensemble, the
    retained subsample, or, before any history, the live ensemble).  It is
    the surface the criticism verbs read (``diagnostics.waic``, ``loo``,
    ``loo_pit``, ``audit``, ``prior_sensitivity``, and
    ``predictive.posterior_predictive``), so each runs on one dataset
    unmodified."""

    group_ids = None
    _custom_log_post = None
    _custom_batched = None

    def __init__(self, fit: "BatchedFit", s: int):
        self.spec = fit.spec
        self.dtype = fit.dtype
        self.device = fit.device
        self.terms = [dataclasses.replace(fit.terms[0], dataset=fit._datasets[s])]
        self._fit = fit
        self._s = s

    def _history(self, take=None):
        pos, lp = self._fit._history(take)
        cols = np.asarray(history_block_columns(self._fit, pos.shape[1])[self._s])
        return np.asarray(pos)[:, cols, :], np.asarray(lp)[:, cols]

    def steps(self, take=None):
        pos, lp = self._history(take)
        return pos.reshape(-1, pos.shape[-1]), lp.reshape(-1)

    def most_likely_params(self) -> dict:
        """The block's own best params (not the batch's argmax, which may
        be another dataset's optimum)."""
        return self._fit.best_params_per_dataset()[self._s]


class BatchedFit(Walker):
    """S independent fits as one ``(S * B, d)`` walker ensemble (JAX
    ``BatchedFit``, batched.py:94-273).

    ``function``: one model ``f(x, params)`` for every dataset.
    ``datasets``: ``(x, y)`` pairs; lengths and grids may differ (a ragged
    batch pads to the longest, the masks keep each reduction exact).
    ``params``: one guess dict (shared) or one per dataset.
    ``data_error``: a scalar, one entry per dataset (scalar or per-point
    array), or one per-point array shared by every dataset (ambiguous,
    and refused, when the point count equals S).  ``log_prior``: one prior
    callable, ``PriorSpec`` or ``MVGaussian``, applied per walker with
    ``dataset=None``.  ``log_likelihood``: any library or factory
    reduction (default the Gaussian, which keeps the z-sum path); a
    data-dependent factory resolves once, against dataset 0.
    ``walkers_per_dataset`` walkers start at each dataset's guess with a
    relative ``walker_jitter``.  ``dtype`` defaults to float32;
    ``device=None`` means the GPU.
    """

    def __init__(self, function: Callable, datasets: Sequence, params, data_error=None,
                 *, log_prior: Callable | None = None,
                 log_likelihood: Callable | None = None, walkers_per_dataset: int = 128,
                 seed: int = 0, walker_jitter: float = 0.02, dtype=None, config=None,
                 device=None):
        device = resolve_device(device)
        dtype = dtype or default_dtype()
        S = len(datasets)
        if S == 0:
            raise ValueError("no datasets provided")
        if hasattr(log_prior, "as_log_prior"):          # PriorSpec / MVGaussian
            log_prior = log_prior.as_log_prior()
        prior = log_prior or log_prior_flat
        guesses = params if isinstance(params, (list, tuple)) else [params] * S
        if len(guesses) != S:
            raise ValueError(f"{len(guesses)} parameter guesses for {S} datasets")
        errors = self._normalize_errors(data_error, datasets)
        n_max = max(len(np.asarray(d[0])) for d in datasets)
        dsets = [Dataset.create(x, y, err, dtype=dtype, device=device, min_len=n_max)
                 for (x, y), err in zip(datasets, errors)]
        spec = ParamSpec.from_params(guesses[0])
        B = int(walkers_per_dataset)
        self.n_datasets = S
        self.walkers_per_dataset = B
        self._datasets = dsets

        if log_likelihood is not None and log_likelihood is not log_likelihood_normal:
            g0 = {k: torch.as_tensor(float(v), dtype=dtype, device=device)
                  for k, v in guesses[0].items()}
            likelihood = resolve_likelihood(log_likelihood, function, g0, dsets[0])
        else:
            likelihood = log_likelihood_normal

        self._gaussian = likelihood is log_likelihood_normal
        data = self._posterior_stack(dsets)
        if self._gaussian:
            def log_post(theta, dataset_idx, data):
                p = spec.unflatten(theta)
                z = (_pick(data["y"], dataset_idx)
                     - function(_pick(data["x"], dataset_idx), p)) \
                    * _pick(data["inv_sigma"], dataset_idx)
                return (_pick(data["const"], dataset_idx) - 0.5 * torch.sum(z * z)
                        + prior(p, None))

            def blocks_lp(blocks, data):
                # (S, m, 1) parameter columns against (S, 1, P) data.
                cols = spec.unflatten(blocks)
                pts = {k: v[..., None] for k, v in cols.items()}
                z = (data["y"][:, None, :] - function(data["x"][:, None, :], pts)) \
                    * data["inv_sigma"][:, None, :]
                return (data["const"][:, None] - 0.5 * torch.sum(z * z, dim=-1)
                        + prior(cols, None))
        else:
            def as_dataset(fields):
                return Dataset(n=int(fields["x"].shape[0]), **fields)

            def log_post(theta, dataset_idx, data):
                p = spec.unflatten(theta)
                ds = as_dataset({k: _pick(v, dataset_idx) for k, v in data["ds"].items()})
                return likelihood(function, p, ds) + prior(p, None)

            def per_dataset(theta_block, fields):
                cols = spec.unflatten(theta_block)
                pts = {k: v[:, None] for k, v in cols.items()}
                return likelihood(function, pts, as_dataset(fields)) + prior(cols, None)

            per_batch = torch.func.vmap(per_dataset)

            def blocks_lp(blocks, data):
                """(S, m, d) blocks against the stacked datasets."""
                return per_batch(blocks, data["ds"])

        def batched_log_post(positions, data):
            # Any whole number of blocks: a sharded rank holds its own.
            return blocks_lp(positions.reshape(-1, B, positions.shape[-1]),
                             data).reshape(positions.shape[0])

        self._blocks_lp = blocks_lp
        self._whole_data = data

        group_ids = np.repeat(np.arange(S), B)
        init = np.stack([np.asarray([float(g[k]) for k in spec.keys], np.float64)
                         for g in guesses])
        super().__init__(
            terms=[_Term(fn=function, dataset=dsets[0], likelihood=likelihood, prior=prior)],
            spec=spec, initial_vector=np.repeat(init, B, axis=0), n_walkers=S * B,
            seed=seed, walker_jitter=walker_jitter, config=config, dtype=dtype,
            device=device, aux=torch.as_tensor(group_ids), group_ids=group_ids,
            n_groups=S, log_posterior=log_post, posterior_data=data,
            batched_log_posterior=batched_log_post)

    def _posterior_stack(self, dsets):
        return _posterior_stack(dsets, self._gaussian)

    def _set_datasets(self, dsets):
        """Install S datasets of one padded length in place of the batch's
        (``convert.batched_from_numpy``: a JAX batch's own); the posterior
        and the runners are rebuilt on them."""
        if len(dsets) != self.n_datasets:
            raise ValueError(f"{len(dsets)} datasets for a batch of {self.n_datasets}")
        self._datasets = list(dsets)
        self.terms[0].dataset = self._datasets[0]
        self._custom_data = self._posterior_stack(self._datasets)
        self._whole_data = self._custom_data
        self._log_post = self._build_log_posterior()
        self._rows_post = self._build_rows_posterior()
        self._runner_cache.clear()

    @staticmethod
    def _normalize_errors(data_error, datasets):
        """One per-point error array per dataset (JAX batched.py:276-314)."""
        lens = [len(np.asarray(d[0])) for d in datasets]
        S = len(datasets)
        if data_error is None:
            return [np.ones(n) for n in lens]
        if np.isscalar(data_error):
            return [np.full(n, float(data_error)) for n in lens]
        try:
            arr = np.asarray(data_error, np.float64)
        except (ValueError, TypeError):
            arr = None                    # ragged per-dataset list
        same_len = all(n == lens[0] for n in lens)
        if arr is not None and arr.ndim == 1 and same_len and arr.shape[0] == lens[0]:
            # One shared per-point array; with n == S it could as well be S
            # per-dataset scalars, so that reading is refused.
            if lens[0] == S:
                raise ValueError(
                    f"data_error of length {lens[0]} is ambiguous with {S} datasets "
                    f"of {lens[0]} points; pass a list of per-dataset entries")
            return [arr.copy() for _ in range(S)]
        out = []
        for i, e in enumerate(data_error):
            e = np.asarray(e, np.float64)
            out.append(np.full(lens[min(i, S - 1)], float(e)) if e.ndim == 0 else e)
        if len(out) != S:
            raise ValueError(f"{len(out)} errors for {S} datasets")
        for i, (e, n) in enumerate(zip(out, lens)):
            if e.shape[0] != n:
                raise ValueError(f"dataset {i}: error array length {e.shape[0]} != "
                                 f"{n} points")
        return out

    def _localize(self, lo: int, hi: int):
        """A rank's share of the batch: whole dataset blocks ``lo // B ..
        hi // B``, their stacked data, and the aux dataset index relative
        to them (the batched posterior takes any whole number of blocks)."""
        B = self.walkers_per_dataset
        if lo % B or hi % B:
            raise ValueError(f"shard: each rank must hold whole dataset blocks of {B} "
                             f"walkers; walkers {lo}..{hi} split one")
        s0 = lo // B
        self._custom_data = self._posterior_stack(self._datasets[s0:hi // B])
        self.aux = self.aux[lo:hi] - s0
        self._log_post = self._build_log_posterior()
        self._rows_post = self._build_rows_posterior()

    # ------------------------------------------------------------- queries

    def _best_walker_per_dataset(self, best_lp=None) -> np.ndarray:
        """(S,) walker index of each dataset block's best step."""
        if best_lp is None:
            (best_lp,) = self._gather(self.state.best_logprob)
        B = self.walkers_per_dataset
        return (np.arange(self.n_datasets) * B
                + _host(best_lp).reshape(self.n_datasets, B).argmax(1))

    def best_params_per_dataset(self) -> list[dict]:
        """Each dataset's most-likely params: the argmax within its block."""
        best_pos, best_lp = self._gather(self.state.best_position, self.state.best_logprob)
        best_pos = _host(best_pos)
        return [self.spec.make(best_pos[w].tolist())
                for w in self._best_walker_per_dataset(best_lp)]

    def best_logprob_per_dataset(self) -> list[float]:
        (best_lp,) = self._gather(self.state.best_logprob)
        host = _host(best_lp)
        return [float(host[w]) for w in self._best_walker_per_dataset(best_lp)]

    def expressions_per_dataset(self, expr: str) -> list[float]:
        """A derived-quantity expression at each dataset's best fit (the
        vectorized ``walker-set-get-f``, nv-specific.lisp:87)."""
        from .expressions import eval_expression

        return [eval_expression(expr, p) for p in self.best_params_per_dataset()]

    def reset_to_most_likely(self):
        """Restart each dataset's walkers at that dataset's best step (the
        base verb's global argmax would put every block at one dataset's
        optimum; JAX batched.py:342-364)."""
        best_pos, best_lp = self._gather(self.state.best_position, self.state.best_logprob)
        idx = torch.as_tensor(self._best_walker_per_dataset(best_lp), device=self.device)
        lo, wl = self._rank_rows()
        idx = idx.repeat_interleave(self.walkers_per_dataset)[lo:lo + wl]
        self.state = dataclasses.replace(
            self.state, position=best_pos[idx].clone(), logprob=best_lp[idx].clone())
        self.reset()

    def dataset_view(self, s: int) -> _DatasetView:
        """Dataset ``s``'s walker block behind the single-fit surface."""
        if not 0 <= s < self.n_datasets:
            raise IndexError(f"dataset {s} of {self.n_datasets}")
        return _DatasetView(self, s)

    def _dataset_posterior(self, positions):
        """``(S, m, d) -> (S, m)``: each dataset's posterior at its own m
        points, for any m (``nested_per_dataset``'s refills), on the
        batch's plain posterior."""
        return self._blocks_lp(positions, self._whole_data)

    # ---------------------------------------------- per-dataset criticism

    def _per_dataset(self, verb, **kwargs) -> list:
        return [verb(self.dataset_view(s), **kwargs) for s in range(self.n_datasets)]

    def waic_per_dataset(self, **kwargs) -> list:
        """``diagnostics.waic`` on each dataset's view (JAX batched.py:374-379)."""
        from .diagnostics import waic

        return self._per_dataset(waic, **kwargs)

    def loo_per_dataset(self, **kwargs) -> list:
        """``diagnostics.loo`` on each dataset's view, Pareto k and all."""
        from .diagnostics import loo

        return self._per_dataset(loo, **kwargs)

    def posterior_predictive_per_dataset(self, **kwargs) -> list:
        """One ``PredictiveDraws`` a dataset (``predictive.posterior_predictive``)."""
        from .predictive import posterior_predictive

        return [d[0] for d in self._per_dataset(posterior_predictive, **kwargs)]

    def loo_pit_per_dataset(self, **kwargs) -> list:
        """``diagnostics.loo_pit`` on each dataset's view."""
        from .diagnostics import loo_pit

        return self._per_dataset(loo_pit, **kwargs)

    def prior_sensitivity_per_dataset(self, prior=None, **kwargs) -> list:
        """``diagnostics.prior_sensitivity`` on each dataset's view."""
        from .diagnostics import prior_sensitivity

        return self._per_dataset(prior_sensitivity, prior=prior, **kwargs)

    def audit_per_dataset(self, **kwargs) -> list:
        """``diagnostics.audit`` report cards, one a dataset."""
        from .diagnostics import audit

        return self._per_dataset(audit, **kwargs)

    def advi_per_dataset(self, *args, **kwargs) -> list:
        """S per-dataset Gaussian variational fits in one batched loop
        (:func:`variational.advi_per_dataset`; JAX batched.py:442-450): one
        ``VIResult`` a dataset, each with its own Pareto-k-guarded evidence."""
        from .variational import advi_per_dataset

        return advi_per_dataset(self, *args, **kwargs)

    def flow_advi_per_dataset(self, *args, **kwargs) -> list:
        """S per-dataset RealNVP flows in one batched loop
        (:func:`variational.flow_advi_per_dataset`; JAX batched.py:452-461):
        one ``FlowVIResult`` a dataset, each with its own evidence,
        checkpoint and NeuTra surface."""
        from .variational import flow_advi_per_dataset

        return flow_advi_per_dataset(self, *args, **kwargs)

    def nested_per_dataset(self, bounds=None, **kwargs) -> list:
        """S nested-sampling runs as one stacked state
        (``nested.nested_per_dataset``; JAX batched.py:464-473): one
        ``NestedResult`` a dataset."""
        from .nested import nested_per_dataset

        return nested_per_dataset(self, bounds, **kwargs)

    def convergence(self, take: int | None = None, **kwargs) -> dict:
        """The batch's convergence verdict in one call (JAX
        batched.py:409-436): the worst case over the datasets (``ok`` only
        when every block passes), each failure prefixed with its dataset,
        and ``"per_dataset"``, one verdict each."""
        from .diagnostics import convergence_per_dataset, merge_worst_verdict

        per = convergence_per_dataset(self, take, **kwargs)
        out = {"rank_rhat": {}, "tail_ess": {}, "mcse": {}}
        failures = []
        for s, v in enumerate(per):
            merge_worst_verdict(out, v, self.spec.keys)
            failures.extend(f"dataset {s}: {msg}" for msg in v["failures"])
        out["ok"] = not failures
        out["failures"] = failures
        out["per_dataset"] = per
        return out

    def laplace_per_dataset(self, bounds=None, prior=None, eig_floor: float = 1e-12):
        """One Laplace approximation per dataset from one batched Hessian
        (JAX batched.py:475-511): ``torch.func.vmap(torch.func.hessian)``
        of the per-walker posterior at each dataset's best point.
        ``bounds`` resolves from a bounds prior when omitted; without any,
        ``log_z`` is None.  Returns a list of ``evidence.LaplaceResult``."""
        from .evidence import _laplace_from_hessian
        from .priors import resolve_prior_spec

        data = self._whole_data
        best = self.best_params_per_dataset()
        thetas = torch.as_tensor(np.stack([[p[k] for k in self.spec.keys] for p in best]),
                                 dtype=self.dtype, device=self.device)
        idx = torch.arange(self.n_datasets, device=self.device)

        def lp_fn(theta, s):
            return self._custom_log_post(theta, s, data)

        neg_hess = -torch.func.vmap(torch.func.hessian(lp_fn))(thetas, idx)
        lps = torch.func.vmap(lp_fn)(thetas, idx)
        spec = resolve_prior_spec(self, prior, bounds)
        neg_hess, lps = _host(neg_hess), _host(lps)
        return [_laplace_from_hessian(float(lps[s]), best[s], neg_hess[s], self.spec.keys,
                                      spec, eig_floor, "laplace_per_dataset")
                for s in range(self.n_datasets)]
