"""Hierarchical (partial-pooling) fits: S datasets, one shared population.

Port of ``lisp_mcmc_tpu/hierarchical.py``, its refit cross-validation
included: ``diagnostics.kfold``/``reloo`` reach :meth:`HierarchicalFit.
_refit_cv` (joint leave-out refits), and :meth:`HierarchicalFit.logo`
leaves a whole dataset out.  The reference fits each spectrum of a scan grid on its own (``dir->nv-walkers``,
nv-specific.lisp:58-66) or shares parameters globally (test.lisp:58-70);
between those sits the model here,

    theta[s, p] ~ Normal(mu_p, tau_p)        for pooled parameter p,
    mu_p, tau_p ~ declared hyperpriors,

so sparse spectra borrow strength from the rest of the grid.

- **Non-centered walk space.**  The walk coordinates are ``z[s, p]`` with
  ``theta = mu + tau * z`` (``correlation="full"``: ``mu + diag(tau)
  (I + C) z`` with a strictly lower slant matrix ``C``), decoded inside
  the posterior.  The prior is a product of independent 1-D
  distributions, one :class:`~lisp_mcmc_torch.PriorSpec`, so every
  estimator on the named-prior convention (``log_evidence``,
  ``laplace_approx``, ``smc_sample``, ``nested_sample``, ``advi``,
  ``flow_advi``) runs on a hierarchical fit unchanged.
- **One batched posterior, no vmap over walkers.**  Positions ``(W, 2P +
  S*d_local)`` decode to ``(W, S, d_local)``; the Gaussian likelihood is
  one z-sum over the ``(W, S, N)`` residuals against the stacked ``(S, N)``
  datasets (``batched._posterior_stack``), any other likelihood one
  ``torch.func.vmap`` over the dataset axis; the prior is
  :meth:`PriorSpec.vector_log_prior`, evaluated by distribution kind on
  gathered columns (a handful of torch kernels for any d, where a term
  per coordinate would cost the host a dispatch each).  The posterior takes any leading axes, so it serves a whole
  ensemble, a half-ensemble and one walker alike: the fit is a custom
  posterior of the plain path, as in the JAX package (hierarchical.py:
  611-617), which neither CUDA kernel evaluates.
- **Starting positions come from numpy.**  ``np.random.default_rng(seed)``
  draws the start exactly as the JAX constructor does (hierarchical.py:
  621), so both packages start bit for bit alike where the hyperpriors'
  medians are exact arithmetic (a Gaussian's mu, ``exp(0)``) and within
  2 ulp elsewhere (a LogNormal median's ``exp`` and a truncated prior's
  ``ndtri`` round apart in XLA and PyTorch); :meth:`prior_predictive` and
  :meth:`predict_new` draw from numpy as well.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .batched import _DATASET_FIELDS, _posterior_stack
from .data import Dataset
from .fit import Walker, _host, _nonzero_scales, _Term, default_dtype
from .likelihoods import log_likelihood_normal, resolve_likelihood
from .params import ParamSpec
from .priors import Gaussian, LogNormal, PriorSpec, Uniform, _col, log_prior_flat

__all__ = ["HierarchicalFit", "LOGOResult"]


@dataclasses.dataclass(frozen=True)
class LOGOResult:
    """Leave-one-group-out CV (:meth:`HierarchicalFit.logo`; JAX
    hierarchical.py:71-95): ``elpd`` the sum over datasets of ``log p(y_s |
    y_-s)``, the expected log predictive density of a new group;
    ``elpd_per_dataset`` the per-group terms (a very negative one flags a
    dataset the population does not describe, ``-inf`` one whose every
    draw underflowed); ``se`` the standard error over the finite terms
    (``sqrt(n var)``, ddof 1); ``refit_ok`` each group's collapse gate
    (``diagnostics.grouped_refit_health``): a False entry's elpd is
    unreliable."""

    elpd: float
    se: float
    elpd_per_dataset: np.ndarray
    refit_ok: np.ndarray | None = None

    def __repr__(self):
        return (f"LOGOResult(elpd={self.elpd:.2f}, se={self.se:.2f}, "
                f"S={len(self.elpd_per_dataset)})")


def _as_dist(v, what):
    if isinstance(v, (Uniform, Gaussian, LogNormal)):
        return v
    if isinstance(v, (tuple, list)) and len(v) == 2:
        return Uniform(float(v[0]), float(v[1]))
    raise ValueError(f"{what}: expected a distribution or (low, high) "
                     f"tuple, got {v!r}")


def _dist_median(d) -> float:
    return float(d.icdf(torch.tensor(0.5, dtype=torch.float64)))


def _term_branch_model(fns, one_col: bool):
    """The branching model of the term-id-column recipe (JAX
    hierarchical.py:111-129): the last x column is the term id, term t's
    function answers where ``id >= t - 0.5``."""
    T = len(fns)

    def model(x, p):
        tid = x[..., -1]
        xin = x[..., 0] if one_col else x[..., :-1]
        out = fns[0](xin, p)
        for t in range(1, T):
            out = torch.where(tid < t - 0.5, out, fns[t](xin, p))
        return out

    model.__name__ = "hier_multiterm[" + ",".join(
        getattr(f, "__name__", "f") for f in fns) + "]"
    # checkpoint.hierarchical_save records the terms by name
    model._term_fns = tuple(fns)
    model._term_one_col = one_col
    return model


def _term_errors(e, ns, T: int, s: int):
    """Dataset ``s``'s sigmas for terms of ``ns`` points: a scalar, a
    per-term list of T entries, or a flat per-point array.

    A list or tuple of T scalars, where the dataset also holds T points,
    reads either way: JAX hierarchical.py:188 takes it per term.  The port
    refuses it; a per-point sigma is then a numpy array, a per-term one a
    list of per-term arrays."""
    if isinstance(e, (list, tuple)) and len(e) == T:
        if sum(ns) == T and all(np.ndim(et) == 0 for et in e):
            raise ValueError(
                f"data_error[{s}]: a list of {T} scalars for a dataset of {T} points "
                f"over {T} terms reads as per-term or per-point sigmas; pass a numpy "
                "array for per-point sigmas, or per-term arrays of each term's length")
        return np.concatenate([np.broadcast_to(np.asarray(et, np.float64), (n,))
                               for et, n in zip(e, ns)])
    arr = np.asarray(e, np.float64)
    if arr.ndim == 0:
        return float(arr)
    if arr.shape == (sum(ns),):
        return arr
    raise ValueError(
        f"data_error[{s}]: expected a scalar, a per-term list of {T} entries, "
        f"or a flat array of {sum(ns)} sigmas, got shape {arr.shape}")


def _build_term_id_blocks(fns, datasets, data_error):
    """First-class multi-term blocks (JAX hierarchical.py:132-203): each
    dataset is a list of T ``(x, y)`` pairs, which become one multi-column
    x whose last column is the term id, with y and the sigmas
    concatenated; the model is :func:`_term_branch_model`'s."""
    T = len(fns)
    S = len(datasets)
    if T < 1:
        raise ValueError("function=[]: need at least one term function")
    new_sets = []
    ndims = set()
    for s, terms in enumerate(datasets):
        if not isinstance(terms, (list, tuple)) or len(terms) != T or \
                not all(isinstance(t, (list, tuple)) and len(t) == 2 for t in terms):
            raise ValueError(
                f"function is a list of {T} terms, so each dataset must "
                f"be a list of {T} (x, y) pairs — dataset {s} is "
                f"{type(terms).__name__} of len "
                f"{len(terms) if hasattr(terms, '__len__') else '?'}")
        xs = [np.asarray(x, np.float64) for x, _ in terms]
        ys = [np.asarray(y, np.float64) for _, y in terms]
        ndims.update(x.ndim for x in xs)
        if len(ndims) > 1:
            raise ValueError("multi-term blocks: every term's x must "
                             "have the same column count")
        cols = []
        for t, x in enumerate(xs):
            x2 = x[:, None] if x.ndim == 1 else x
            cols.append(np.concatenate([x2, np.full((x2.shape[0], 1), float(t))], axis=1))
        new_sets.append((np.concatenate(cols, axis=0), np.concatenate(ys)))

    model = _term_branch_model(fns, ndims == {1})
    if data_error is None or np.isscalar(data_error):
        new_err = data_error
    else:
        if len(data_error) != S:
            raise ValueError(f"data_error: {len(data_error)} entries "
                             f"for {S} datasets")
        new_err = [_term_errors(e, [np.asarray(x).shape[0] for x, _ in datasets[s]], T, s)
                   for s, e in enumerate(data_error)]
    return model, new_sets, new_err


class _HierarchicalView:
    """Single-dataset facade over a :class:`HierarchicalFit`, in natural
    space (JAX hierarchical.py:206-260): ``spec``/``dtype``/``device``/
    ``terms``/``_history``/``steps``/``most_likely_params``, the history
    decoded from the walk coordinates to dataset ``s``'s parameters, so
    ``diagnostics.waic``/``loo``/``loo_pit``/``audit`` and
    ``predictive.posterior_predictive`` run on it unmodified.  The logprob
    column is the fit's joint log posterior."""

    group_ids = None
    _custom_log_post = None
    _custom_batched = None
    # A refit of the view would rebuild another model (one dataset, a flat
    # prior, no population term); diagnostics._global_batched_refit reads
    # this marker.
    _refit_unsupported = (
        "hierarchical dataset views cannot be refit: the rebuilt "
        "posterior would drop the population prior (a different model "
        "than the one that produced the Pareto-k flags); use waic/loo "
        "on the view, or the joint toolchain on the full fit")
    # The view's flat stand-in prior would read "robust" for every
    # parameter: the pooled prior lives in walk space.
    _prior_sensitivity_unsupported = (
        "hierarchical dataset views carry a flat stand-in prior (the "
        "pooled prior lives in walk space), so per-dataset power-"
        "scaling would trivially read 'robust'; run prior_sensitivity "
        "on the FULL fit instead")

    def __init__(self, fit: "HierarchicalFit", s: int):
        self.spec = fit.local_spec
        self.dtype = fit.dtype
        self.device = fit.device
        self.terms = [_Term(fn=fit.terms[0].fn, dataset=fit._datasets[s],
                            likelihood=fit._likelihood, prior=log_prior_flat)]
        self._fit = fit
        self._s = s

    def _history(self, take=None):
        pos, lp = self._fit._history(take)          # (T, W, d), (T, W)
        return self._fit._decode_np_one(np.asarray(pos), self._s), np.asarray(lp)

    def steps(self, take=None):
        pos, lp = self._history(take)
        return pos.reshape(-1, pos.shape[-1]), lp.reshape(-1)

    def most_likely_params(self) -> dict:
        return self._fit.params_per_dataset("best")[self._s]


class _SeededLWalker(Walker):
    """A walker whose initial proposal L is given (JAX hierarchical.py:
    262-278): a refit or SBC ensemble in walk space starts from the parent
    fit's adapted factor, where the diagonal of magnitudes would give the
    z coordinates (near 0) meaningless scales."""

    def __init__(self, *args, l_seed=None, **kwargs):
        self._l_seed_matrix = l_seed
        super().__init__(*args, **kwargs)

    def _initial_l_matrix(self, vec):
        if self._l_seed_matrix is None:
            return super()._initial_l_matrix(vec)
        return torch.as_tensor(self._l_seed_matrix, dtype=self.dtype, device=self.device)


class HierarchicalFit(Walker):
    """Partial pooling across S datasets as one walker ensemble (JAX
    ``HierarchicalFit``, hierarchical.py:281-1343).

    ``function``: one model ``f(x, params)`` for every dataset, or a list
    of T term functions with each dataset a list of T ``(x, y)`` pairs
    (multi-term blocks).  ``datasets``: ``(x, y)`` pairs (a ragged batch
    pads as :class:`~lisp_mcmc_torch.BatchedFit`'s).  ``params``: one
    guess dict or one per dataset.  ``pooled``: the local names drawn from
    the population (default all); the rest stay per dataset.  ``hyper``:
    ``{name: (mu_prior, tau_prior)}``, distributions or ``(low, high)``
    tuples, a ``tau`` prior of non-negative support (default ``mu ~
    Gaussian(guess, |guess|)``, ``tau ~ LogNormal(log(|guess|/4), 1)``).
    ``local_priors``: priors of the non-pooled locals; with one for each,
    :attr:`prior_spec` is a complete ``PriorSpec`` and the evidence verbs
    apply (else those locals are flat and ``prior_spec`` is None).
    ``correlation="full"``: the correlated population ``theta_s = mu +
    diag(tau) (I + C) z_s``, one slant a pooled pair under ``corr_prior``
    (default ``Gaussian(0, 0.5)``).  ``proposal``: ``"dense"``,
    ``"block"`` (per-block L: the hypers, then one block a dataset) or
    ``"auto"`` (block from d = 96).  ``dtype`` defaults to
    :func:`~lisp_mcmc_torch.fit.default_dtype`; ``device=None`` means the
    GPU.

    Walk-space names (``spec.keys``): ``{p}__mu``, ``{p}__tau``,
    ``{p_i}__c_{p_j}``, ``{p}__z{s}`` for pooled ``p``, ``{p}__{s}`` for a
    non-pooled one.  Natural space: :meth:`params_per_dataset`,
    :meth:`hyper_params`, :meth:`population_covariance`,
    :meth:`dataset_view`.  Refit cross-validation: ``diagnostics.kfold``
    and ``reloo`` (through :meth:`_refit_cv`) and :meth:`logo`.
    """

    def __init__(self, function: Callable, datasets: Sequence, params, data_error=None, *,
                 pooled: Sequence[str] | None = None, hyper: Mapping | None = None,
                 local_priors: Mapping | None = None,
                 log_likelihood: Callable | None = None, n_walkers: int = 256,
                 seed: int = 0, walker_jitter: float = 0.02, dtype=None, config=None,
                 proposal: str = "auto", correlation: str = "diag", corr_prior=None,
                 device=None):
        from .batched import BatchedFit
        from .device import resolve_device
        from .kernel import FitConfig

        if proposal not in ("auto", "dense", "block"):
            raise ValueError(
                f"proposal must be 'auto', 'dense' or 'block', got {proposal!r}")
        if correlation not in ("diag", "full"):
            raise ValueError(f"correlation must be 'diag' or 'full', "
                             f"got {correlation!r}")
        if isinstance(function, (list, tuple)):
            function, datasets, data_error = _build_term_id_blocks(
                list(function), datasets, data_error)

        device = resolve_device(device)
        dtype = dtype or default_dtype()
        S = len(datasets)
        if S < 2:
            raise ValueError("HierarchicalFit: need >= 2 datasets to pool "
                             "(one dataset has no population to share)")

        guesses = params if isinstance(params, (list, tuple)) else [params] * S
        if len(guesses) != S:
            raise ValueError(f"{len(guesses)} parameter guesses for {S} datasets")
        local_spec = ParamSpec.from_params(guesses[0])
        local_keys = local_spec.keys
        dl = local_spec.ndim

        pooled = list(local_keys) if pooled is None else \
            [k[1:] if k.startswith(":") else k for k in pooled]
        unknown = [p for p in pooled if p not in local_keys]
        if unknown:
            raise ValueError(f"pooled names {unknown} not in params "
                             f"{list(local_keys)}")
        if not pooled:
            raise ValueError("HierarchicalFit: pooled=[] pools nothing — "
                             "use BatchedFit for independent fits")
        dp = len(pooled)
        pooled_cols = np.asarray([local_spec.index(p) for p in pooled])

        # ----- hyperpriors (mu_p, tau_p)
        g0 = np.asarray([float(np.mean([float(g[k]) for g in guesses]))
                         for k in local_keys])
        scales = _nonzero_scales(g0)
        hyper = dict(hyper or {})
        self._hyper = {}
        for p in pooled:
            j = local_spec.index(p)
            if p in hyper:
                mu_d, tau_d = hyper.pop(p)
                mu_d = _as_dist(mu_d, f"hyper[{p}].mu")
                tau_d = _as_dist(tau_d, f"hyper[{p}].tau")
            else:
                s_p = abs(float(scales[j]))
                mu_d = Gaussian(float(g0[j]), s_p)
                tau_d = LogNormal(float(np.log(s_p / 4.0)), 1.0)
            if tau_d.support[0] < 0:
                raise ValueError(
                    f"hyper[{p}]: tau prior must have non-negative support, "
                    f"got {tau_d.support}")
            self._hyper[p] = (mu_d, tau_d)
        if hyper:
            raise ValueError(f"hyper entries for non-pooled names: "
                             f"{sorted(hyper)}")

        # ----- non-pooled local priors
        non_pooled = [k for k in local_keys if k not in pooled]
        local_priors = {(k[1:] if k.startswith(":") else k): v
                        for k, v in dict(local_priors or {}).items()}
        unknown = [k for k in local_priors if k not in non_pooled]
        if unknown:
            raise ValueError(
                f"local_priors for {unknown} — only NON-pooled local "
                f"parameters take one (pooled parameters get theirs from "
                f"the population; non-pooled here: {non_pooled})")
        self._local_dists = {k: _as_dist(v, f"local_priors[{k}]")
                             for k, v in local_priors.items()}

        # ----- population correlation: unit-lower-triangular slants
        if correlation == "full" and dp < 2:
            raise ValueError(
                "correlation='full' needs >= 2 pooled parameters "
                f"(got {dp}: {list(pooled)}) — there is no off-diagonal "
                "to correlate")
        nc = dp * (dp - 1) // 2 if correlation == "full" else 0
        self.correlation = correlation
        self.n_corr = nc
        corr_pairs = [(i, j) for i in range(dp) for j in range(i)] if nc else []
        self._corr_pairs = np.asarray(corr_pairs, dtype=int).reshape(nc, 2)
        if nc:
            self._corr_dist = (Gaussian(0.0, 0.5) if corr_prior is None
                               else _as_dist(corr_prior, "corr_prior"))
        elif corr_prior is not None:
            raise ValueError("corr_prior= given but correlation='diag' "
                             "(set correlation='full' to use it)")
        else:
            self._corr_dist = None

        # ----- walk-space layout: [mu | tau | c | S local blocks of dl]
        keys = [f"{p}__mu" for p in pooled] + [f"{p}__tau" for p in pooled]
        keys += [f"{pooled[i]}__c_{pooled[j]}" for i, j in corr_pairs]
        for s in range(S):
            keys += [f"{k}__z{s}" if k in pooled else f"{k}__{s}" for k in local_keys]
        spec = ParamSpec(tuple(keys))
        self.local_spec = local_spec
        self.pooled = tuple(pooled)
        self.n_datasets = S
        self._n_hyper = 2 * dp + nc
        self._pooled_cols = pooled_cols

        # ----- proposal structure: the coupling is hyper <-> local only
        d_walk = spec.ndim
        if proposal == "block" or (proposal == "auto" and d_walk >= 96):
            base = config or FitConfig()
            if base.kernel in ("rwm", "mala", "hmc", "chees"):
                config = dataclasses.replace(base, block_hyper=2 * dp + nc,
                                             block_local=dl, block_count=S)
            elif proposal == "block":
                raise ValueError(
                    f"proposal='block' needs an L-matrix kernel "
                    f"(rwm/mala/hmc/chees), not {base.kernel!r} "
                    "(stretch/demc/slice are L-free)")

        # ----- decode: P (dl, dp) selects the pooled columns, E scatters
        # the slants into the strictly lower C
        P = np.zeros((dl, dp))
        P[pooled_cols, np.arange(dp)] = 1.0
        mask = np.zeros(dl)
        mask[pooled_cols] = 1.0
        E = np.zeros((max(nc, 1), dp, dp))
        for k, (i, j) in enumerate(corr_pairs):
            E[k, i, j] = 1.0
        self._P_np, self._mask_np, self._E_np = P, mask, E
        kw = dict(dtype=dtype, device=device)
        P_t, mask_t, E_t = (torch.as_tensor(a, **kw) for a in (P, mask, E))
        nh = 2 * dp + nc

        def decode(theta):
            """(..., d) walk coordinates -> (..., S, dl) natural theta."""
            mu = theta[..., :dp]
            tau = theta[..., dp:2 * dp]
            loc = theta[..., nh:]
            loc = loc.reshape(loc.shape[:-1] + (S, dl))
            if nc:
                # z_eff = (I + C) z in the pooled columns; nc == 0 skips it
                c = theta[..., 2 * dp:nh]
                z = loc @ P_t                               # (..., S, dp)
                C = torch.einsum("...k,kpq->...pq", c, E_t)
                cz = torch.einsum("...pq,...sq->...sp", C, z)
                loc = loc + cz @ P_t.T
            mu_cols = mu @ P_t.T                            # (..., dl)
            tau_cols = (1.0 - mask_t) + tau @ P_t.T
            return loc * tau_cols[..., None, :] + mu_cols[..., None, :]

        self._decode = decode

        # ----- the stacked data
        errors = BatchedFit._normalize_errors(data_error, datasets)
        n_max = max(len(np.asarray(d[0])) for d in datasets)
        dsets = [Dataset.create(x, y, err, dtype=dtype, device=device, min_len=n_max)
                 for (x, y), err in zip(datasets, errors)]
        self._datasets = dsets
        # every field stacked (S, N): the pointwise hooks' data
        self._stack_fields = _posterior_stack(dsets, False)["ds"]
        self._stacked = Dataset(n=int(dsets[0].x.shape[0]), **self._stack_fields)

        if log_likelihood is not None and log_likelihood is not log_likelihood_normal:
            g_t = {k: torch.as_tensor(float(v), **kw) for k, v in guesses[0].items()}
            likelihood = resolve_likelihood(log_likelihood, function, g_t, dsets[0])
        else:
            likelihood = log_likelihood_normal
        self._likelihood = likelihood
        gaussian = likelihood is log_likelihood_normal
        self._gaussian = gaussian
        batch_data = _posterior_stack(dsets, gaussian)

        columns = self._local_columns
        if gaussian:
            def log_likelihood_total(nat, data):
                z = (data["y"] - function(data["x"], columns(nat))) * data["inv_sigma"]
                return torch.sum(data["const"] - 0.5 * torch.sum(z * z, dim=-1), dim=-1)
        else:
            def per_dataset(th, fields):
                return likelihood(function, columns(th),
                                  Dataset(n=int(fields["x"].shape[0]), **fields))

            over_datasets = torch.func.vmap(per_dataset, in_dims=(-2, 0), out_dims=-1)

            def log_likelihood_total(nat, data):
                return torch.sum(over_datasets(nat, data["ds"]), dim=-1)

        # ----- the prior: a product of independent 1-D distributions
        dists = {f"{p}__mu": self._hyper[p][0] for p in pooled}
        dists.update({f"{p}__tau": self._hyper[p][1] for p in pooled})
        dists.update({f"{pooled[i]}__c_{pooled[j]}": self._corr_dist
                      for i, j in corr_pairs})
        for s in range(S):
            for k in local_keys:
                if k in pooled:
                    dists[f"{k}__z{s}"] = Gaussian(0.0, 1.0)
                elif k in self._local_dists:
                    dists[f"{k}__{s}"] = self._local_dists[k]
        self._complete_prior = len(dists) == spec.ndim
        declared = PriorSpec(dists)
        vector_prior = declared.vector_log_prior(spec.keys, dtype=dtype, device=device)
        self.prior_spec = declared if self._complete_prior else None

        def prior(params, dataset=None):
            cols = [_col(params[k]) for k in spec.keys]
            return vector_prior(torch.stack(torch.broadcast_tensors(*cols), dim=-1))

        if self.prior_spec is not None:
            # resolve_prior_spec finds it: the evidence layer applies
            prior._prior_spec = self.prior_spec
            prior.__name__ = "prior_spec"
        else:
            # flat non-pooled locals: a valid posterior, no prior measure
            prior.__name__ = "hierarchical_partial_prior"

        def log_post(theta, data):
            """(..., d) walk vectors -> (...) joint log posterior."""
            return log_likelihood_total(decode(theta), data) + vector_prior(theta)

        # ----- initial ensemble, numpy as the JAX constructor draws it
        rng = np.random.default_rng(seed)
        mu0 = g0[pooled_cols]
        tau0 = np.asarray([_dist_median(self._hyper[p][1]) for p in pooled])
        guess_mat = np.asarray([[float(g[k]) for k in local_keys] for g in guesses])
        z0 = (guess_mat[:, pooled_cols] - mu0) / np.maximum(tau0, 1e-300)
        z0 = np.clip(z0, -3.0, 3.0)

        pos = np.empty((n_walkers, spec.ndim))
        jit = walker_jitter
        mu_scale = np.maximum(np.abs(mu0), tau0)   # spread even at mu0 = 0
        pos[:, :dp] = mu0 + jit * mu_scale * rng.standard_normal((n_walkers, dp))
        pos[:, dp:2 * dp] = tau0 * np.exp(jit * rng.standard_normal((n_walkers, dp)))
        if nc:
            # slants start at the prior median, jittered at its central spread
            c0 = _dist_median(self._corr_dist)
            q = self._corr_dist.icdf(torch.tensor([0.84, 0.16], dtype=torch.float64))
            c_scale = float(q[0] - q[1]) / 2.0
            pos[:, 2 * dp:nh] = c0 + jit * c_scale * rng.standard_normal((n_walkers, nc))
        loc = np.broadcast_to(guess_mat, (n_walkers, S, dl)).copy()
        loc[:, :, pooled_cols] = z0 + 0.3 * rng.standard_normal((n_walkers, S, dp))
        np_cols = np.asarray([j for j in range(dl) if j not in pooled_cols], dtype=int)
        if np_cols.size:
            # additive jitter at the derived scale: a zero guess spreads too
            loc[:, :, np_cols] += (jit * np.abs(scales[np_cols])[None, None, :]
                                   * rng.standard_normal((n_walkers, S, np_cols.size)))
        pos[:, nh:] = loc.reshape(n_walkers, S * dl)

        # proposal seed scales in walk space: mu ~ tau0, tau ~ tau0 / 2,
        # slants ~ half their prior spread, z ~ 0.5, non-pooled locals ~
        # their magnitudes from the full guess vector
        l_scales = np.empty(spec.ndim)
        l_scales[:dp] = np.maximum(tau0, np.abs(mu0) * 1e-3 + 1e-300)
        l_scales[dp:2 * dp] = 0.5 * tau0
        if nc:
            l_scales[2 * dp:nh] = 0.5 * max(c_scale, 1e-3)
        lscale_loc = np.empty((S, dl))
        lscale_loc[:, pooled_cols] = 0.5
        if np_cols.size:
            lscale_loc[:, np_cols] = np.abs(scales[np_cols])[None, :]
        l_scales[nh:] = lscale_loc.reshape(-1)
        self._l_seed = l_scales

        super().__init__(
            terms=[_Term(fn=function, dataset=dsets[0], likelihood=likelihood, prior=prior)],
            spec=spec, initial_vector=pos, n_walkers=n_walkers, seed=seed,
            walker_jitter=0.0,   # jitter applied above, walk-space aware
            config=config, dtype=dtype, device=device,
            log_posterior=log_post, posterior_data=batch_data)

    def _build_log_posterior(self):
        """The joint posterior takes any leading axes, so a batch of
        walkers evaluates in one call, without vmap."""
        post, data = self._custom_log_post, self._posterior_data()
        return lambda positions: post(positions, data)

    def _local_columns(self, nat):
        """(..., dl) natural parameters -> ``{name: (..., 1)}`` columns."""
        return {k: nat[..., j, None] for j, k in enumerate(self.local_spec.keys)}

    def _initial_l_matrix(self, vec):
        """Walk-space proposal seed (the z coordinates start near 0, where
        the base class's diag-of-magnitudes would give them a fallback)."""
        return torch.as_tensor(np.diag(self._l_seed), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ decode

    def _slant_np(self, pos: np.ndarray) -> np.ndarray:
        """(..., d) walk vectors -> (..., dp, dp) strictly lower slant
        matrix C (zeros when correlation='diag')."""
        dp = len(self.pooled)
        c = pos[..., 2 * dp:self._n_hyper]
        return np.einsum("...k,kpq->...pq", c, self._E_np[:self.n_corr])

    def _decode_np(self, pos: np.ndarray) -> np.ndarray:
        """Host twin of the decode: (..., d) -> (..., S, dl)."""
        dp = len(self.pooled)
        S, dl = self.n_datasets, self.local_spec.ndim
        nh = self._n_hyper
        mu = pos[..., :dp]
        tau = pos[..., dp:2 * dp]
        loc = pos[..., nh:].reshape(pos.shape[:-1] + (S, dl))
        if self.n_corr:
            z = loc @ self._P_np
            cz = np.einsum("...pq,...sq->...sp", self._slant_np(pos), z)
            loc = loc + cz @ self._P_np.T
        mu_cols = mu @ self._P_np.T
        tau_cols = (1.0 - self._mask_np) + tau @ self._P_np.T
        return loc * tau_cols[..., None, :] + mu_cols[..., None, :]

    def _decode_np_one(self, pos: np.ndarray, s: int) -> np.ndarray:
        """Dataset ``s``'s block alone: (..., d) -> (..., dl), so the
        per-dataset view loops stay O(S) in decode work."""
        dp = len(self.pooled)
        dl = self.local_spec.ndim
        nh = self._n_hyper
        mu = pos[..., :dp]
        tau = pos[..., dp:2 * dp]
        loc = pos[..., nh + s * dl:nh + (s + 1) * dl]
        if self.n_corr:
            z = loc @ self._P_np
            cz = np.einsum("...pq,...q->...p", self._slant_np(pos), z)
            loc = loc + cz @ self._P_np.T
        mu_cols = mu @ self._P_np.T
        tau_cols = (1.0 - self._mask_np) + tau @ self._P_np.T
        return loc * tau_cols + mu_cols

    def decode_params(self, theta) -> np.ndarray:
        """Walk-space vector(s) -> natural (..., S, d_local) array."""
        return self._decode_np(np.asarray(_host(theta), np.float64))

    # ----------------------------------------------------------- queries

    def _best_vector(self) -> np.ndarray:
        best_lp = _host(self.state.best_logprob)
        return _host(self.state.best_position)[int(best_lp.argmax())]

    def params_per_dataset(self, kind: str = "best") -> list[dict]:
        """Per-dataset natural parameter dicts: ``"best"`` decodes the
        ensemble's most likely walk point (one coherent joint estimate),
        ``"median"`` takes each coordinate's median of the decoded history."""
        if kind == "best":
            nat = self._decode_np(self._best_vector())
        elif kind == "median":
            pos, _ = self._history(None)
            nat = np.median(self._decode_np(np.asarray(pos)), axis=(0, 1))
        else:
            raise ValueError(f"kind must be 'best' or 'median', got {kind!r}")
        return [self.local_spec.make(nat[s].tolist()) for s in range(self.n_datasets)]

    def hyper_params(self, kind: str = "best") -> dict:
        """The population: ``{"mu": {name: v}, "tau": {name: v}}``, and
        with ``correlation="full"`` ``"c"``, the raw slants keyed
        ``"{p_i}|{p_j}"`` (the implied covariance is
        :meth:`population_covariance`)."""
        dp = len(self.pooled)
        if kind == "best":
            vec = self._best_vector()
        elif kind == "median":
            pos, _ = self._history(None)
            vec = np.median(np.asarray(pos).reshape(-1, self.spec.ndim), axis=0)
        else:
            raise ValueError(f"kind must be 'best' or 'median', got {kind!r}")
        out = {"mu": dict(zip(self.pooled, vec[:dp].tolist())),
               "tau": dict(zip(self.pooled, vec[dp:2 * dp].tolist()))}
        if self.n_corr:
            out["c"] = {f"{self.pooled[i]}|{self.pooled[j]}": float(vec[2 * dp + k])
                        for k, (i, j) in enumerate(self._corr_pairs)}
        return out

    def population_covariance(self, kind: str = "best") -> np.ndarray:
        """The implied population covariance over :attr:`pooled`, ``Sigma =
        D (I+C) (I+C)^T D`` with ``D = diag(tau)``: the marginal sd of a
        pooled parameter is ``sqrt(Sigma[p, p])``, not ``tau_p``, once the
        slants are nonzero.  ``kind="draws"``: the (n, P, P) posterior of
        Sigma over the history."""
        dp = len(self.pooled)
        if kind == "draws":
            pos, _ = self._history(None)
            vecs = np.asarray(pos, np.float64).reshape(-1, self.spec.ndim)
        elif kind in ("best", "median"):
            hp = self.hyper_params(kind)
            vecs = np.concatenate([
                np.asarray([hp["mu"][p] for p in self.pooled]),
                np.asarray([hp["tau"][p] for p in self.pooled]),
                np.asarray([hp.get("c", {}).get(f"{self.pooled[i]}|{self.pooled[j]}", 0.0)
                            for i, j in self._corr_pairs]),
                np.zeros(self.spec.ndim - self._n_hyper)])[None, :]
        else:
            raise ValueError(f"kind must be 'best', 'median' or 'draws', got {kind!r}")
        tau = vecs[:, dp:2 * dp]
        L = tau[:, :, None] * (np.eye(dp)[None, :, :] + self._slant_np(vecs))
        sigma = np.einsum("npq,nrq->npr", L, L)
        return sigma if kind == "draws" else sigma[0]

    def dataset_view(self, s: int) -> _HierarchicalView:
        """Dataset ``s`` in natural space, behind the single-fit surface."""
        if not 0 <= s < self.n_datasets:
            raise IndexError(f"dataset {s} of {self.n_datasets}")
        return _HierarchicalView(self, s)

    def expressions_per_dataset(self, expr: str) -> list[float]:
        """A derived-quantity expression at each dataset's decoded best fit
        (``walker-set-get-f``, nv-specific.lisp:87)."""
        from .expressions import eval_expression

        return [eval_expression(expr, p) for p in self.params_per_dataset("best")]

    # ---------------------------------------------- per-dataset criticism

    def _per_dataset(self, verb, **kwargs) -> list:
        return [verb(self.dataset_view(s), **kwargs) for s in range(self.n_datasets)]

    def waic_per_dataset(self, **kwargs) -> list:
        """``diagnostics.waic`` on each dataset's natural-space view."""
        from .diagnostics import waic

        return self._per_dataset(waic, **kwargs)

    def loo_per_dataset(self, **kwargs) -> list:
        """``diagnostics.loo`` on each dataset's view."""
        from .diagnostics import loo

        return self._per_dataset(loo, **kwargs)

    def posterior_predictive_per_dataset(self, **kwargs) -> list:
        """One ``PredictiveDraws`` a dataset."""
        from .predictive import posterior_predictive

        return [d[0] for d in self._per_dataset(posterior_predictive, **kwargs)]

    def loo_pit_per_dataset(self, **kwargs) -> list:
        """``diagnostics.loo_pit`` on each dataset's view."""
        from .diagnostics import loo_pit

        return self._per_dataset(loo_pit, **kwargs)

    def audit_per_dataset(self, **kwargs) -> list:
        """``diagnostics.audit`` on each view (prior sensitivity records as
        skipped there: the pooled prior lives in walk space; run
        ``prior_sensitivity`` on the full fit)."""
        from .diagnostics import audit

        return self._per_dataset(audit, **kwargs)

    # ----------------------------------------- joint pointwise toolchain

    def _pointwise_matrix(self, samples, values) -> np.ndarray:
        """(n, d) walk samples -> (n, N_real): ``values(nat (n, S, dl))``
        over the stacked ``(n, S, P)`` points, dataset-major, real points
        only; one batched call for every draw and dataset."""
        samples = torch.as_tensor(samples, dtype=self.dtype, device=self.device)
        out = _host(values(self._decode(samples))).astype(np.float64)
        real = _host(self._stacked.mask).reshape(-1) > 0.0
        return out.reshape(out.shape[0], -1)[:, real]

    def _pointwise_ll(self, samples):
        """Joint pointwise log-likelihood hook (``diagnostics.
        _pointwise_ll_matrix``): waic/loo/loo_pit/prior_sensitivity of the
        whole fit, on the same real points as a pooled or independent
        model of the data."""
        from .likelihoods import pointwise_log_likelihood

        lik, fn = self._likelihood, self.terms[0].fn

        def per_dataset(th, fields):
            return pointwise_log_likelihood(lik, fn, self._local_columns(th),
                                            Dataset(n=int(fields["x"].shape[0]), **fields))

        over = torch.func.vmap(per_dataset, in_dims=(-2, 0), out_dims=-2)
        return self._pointwise_matrix(samples, lambda nat: over(nat, self._stack_fields))

    def _pointwise_cdf(self, samples):
        """Joint per-point predictive CDF hook (``diagnostics.loo_pit``):
        the CDF forms are elementwise, so one call on the stacked data."""
        from .likelihoods import pointwise_cdf

        return self._pointwise_matrix(samples, lambda nat: pointwise_cdf(
            self._likelihood, self.terms[0].fn, self._local_columns(nat), self._stacked))

    # ----------------------------------------------------------- predictive

    def prior_predictive(self, n_samples: int = 256, seed: int = 0, sampler=None) -> list:
        """Per-dataset prior predictive draws: the full declared prior
        (hypers, z, non-pooled locals) sampled with numpy from ``seed``,
        decoded, and every dataset replicated under its own term, one
        ``PredictiveDraws`` a dataset.  Needs a complete prior."""
        from .predictive import _replicate

        if self.prior_spec is None:
            raise ValueError(
                "prior_predictive: the prior is incomplete (non-pooled "
                "locals without local_priors have no measure to draw "
                "from) — declare local_priors for every non-pooled name")
        rng = np.random.default_rng(seed)
        samples = self.prior_spec.sample(rng, n_samples, self.spec.keys)
        nat = self._decode_np(np.asarray(samples, np.float64))       # (n, S, dl)
        return [_replicate(self.dataset_view(s),
                           torch.as_tensor(nat[:, s, :], dtype=self.dtype,
                                           device=self.device),
                           seed + s, sampler, "prior_predictive")[0]
                for s in range(self.n_datasets)]

    def predict_new(self, x, noise=None, take: int | None = None, max_samples: int = 256,
                    seed: int = 0, population_mean: bool = False,
                    fixed: Mapping | None = None):
        """Posterior prediction for an unseen dataset from the population
        (JAX hierarchical.py:944-1046): for each of at most ``max_samples``
        history rows, a new group's pooled parameters decode as the fitted
        groups' do with a fresh ``z ~ N(0, 1)`` (``population_mean=True``
        pins z = 0: the population-typical curve); a non-pooled local
        samples its ``local_priors`` entry or takes ``fixed={name:
        value}``, else raises.  ``noise`` (scalar or (N,)) adds Gaussian
        observation noise.  numpy draws from ``seed``; returns a
        ``predictive.Prediction``."""
        from .predictive import Prediction

        pos, _ = self.steps(take)
        if pos.shape[0] == 0:
            raise ValueError(
                "predict_new: no collected history (run adaptive_steps "
                "with collect_history=True first)")
        n_avail = pos.shape[0]
        idx = np.unique(np.linspace(0, n_avail - 1, min(max_samples, n_avail)).astype(int))
        samples = np.asarray(pos, np.float64)[idx]
        n = samples.shape[0]
        dp = len(self.pooled)
        mu = samples[:, :dp]
        tau = samples[:, dp:2 * dp]
        rng = np.random.default_rng(seed)
        z = np.zeros((n, dp)) if population_mean else rng.standard_normal((n, dp))
        if self.n_corr:
            # a fresh group is drawn correlated, as the fitted ones decode
            z = z + np.einsum("npq,nq->np", self._slant_np(samples), z)

        dl = self.local_spec.ndim
        loc = np.empty((n, dl))
        loc[:, self._pooled_cols] = mu + tau * z
        fixed = {(k[1:] if k.startswith(":") else k): float(v)
                 for k, v in dict(fixed or {}).items()}
        bad = [k for k in fixed if k not in self.local_spec.keys or k in self.pooled]
        if bad:
            raise ValueError(
                f"predict_new: fixed= entries {bad} are not non-pooled "
                f"local parameters (non-pooled: "
                f"{[k for k in self.local_spec.keys if k not in self.pooled]})")
        for j, k in enumerate(self.local_spec.keys):
            if k in self.pooled:
                continue
            if k in fixed:
                loc[:, j] = fixed[k]
            elif k in self._local_dists:
                loc[:, j] = np.asarray(self._local_dists[k].sample(rng, n))
            else:
                raise ValueError(
                    f"predict_new: non-pooled local {k!r} has no "
                    f"population to draw from — declare "
                    f"local_priors[{k!r}] or pin it via fixed=")

        kw = dict(dtype=self.dtype, device=self.device)
        x_arr = torch.as_tensor(np.asarray(x, np.float64), **kw)
        cols = self._local_columns(torch.as_tensor(loc, **kw))
        mu_curves = _host(self.terms[0].fn(x_arr, cols)).astype(np.float64)
        y_rep = None
        if noise is not None:
            sigma = np.broadcast_to(np.asarray(noise, np.float64), mu_curves.shape[1:])
            y_rep = mu_curves + sigma * rng.standard_normal(mu_curves.shape)
        return Prediction(x=np.asarray(x), mu=mu_curves, y_rep=y_rep)

    # ------------------------------------------------------------ refit-CV

    def _joint_blocks(self, blocks) -> dict:
        """K blocks of S datasets -> ``{"ds": {field: (K, S, N)}}``, the
        stacked data of :meth:`_grouped_joint_walker`."""
        return {"ds": {k: torch.stack([_posterior_stack(b, False)["ds"][k] for b in blocks])
                       for k in _DATASET_FIELDS}}

    def _grouped_joint_walker(self, refit_data, K: int, B: int, seed: int, pos0,
                              config=None) -> _SeededLWalker:
        """K copies of this fit's joint posterior, each over its own ``(S,
        N)`` datasets, as the adaptation groups of one walker (JAX
        hierarchical.py:1050-1123).

        ``refit_data = {"ds": {field: (K, S, N)}}`` (:meth:`_joint_blocks`);
        block g's posterior is the whole non-centered model (hyperpriors,
        z priors, every dataset's likelihood) against block g's datasets.
        The batched posterior evaluates the ``(K, B, d)`` blocks against the
        stacks in one call: the Gaussian z-sum broadcasts the blocks' data
        over their walkers, any other likelihood is ``torch.func.vmap``-ed
        over the blocks.  ``pos0``: (K*B, d) walk-space starts.  A blocked
        parent keeps its block layout; ``history_walkers`` is zeroed so
        every block stays in the history.  The fit is custom with per-walker
        aux (the block index), so it runs the plain posterior: neither
        kernel reads a dataset per block."""
        from .batched import _pick
        from .kernel import FitConfig

        if config is None and self.config.block_count > 0:
            config = dataclasses.replace(
                FitConfig(), block_hyper=self.config.block_hyper,
                block_local=self.config.block_local, block_count=self.config.block_count)
        post, d = self._custom_log_post, self.spec.ndim
        ds = refit_data["ds"]
        if self._gaussian:
            data = {"x": ds["x"], "y": ds["y"], "inv_sigma": ds["inv_sigma"],
                    "const": ds["log_norm_const"]}
            def batched_log_post(positions, data):
                # each block's data broadcast over its B walkers: (K, 1, S, N)
                spread = {k: v[:, None] for k, v in data.items()}
                return post(positions.reshape(K, B, d), spread).reshape(positions.shape[0])

            def one_block(block_idx, data):
                return {k: _pick(v, block_idx) for k, v in data.items()}
        else:
            data = refit_data
            over_blocks = torch.func.vmap(lambda th, fields: post(th, {"ds": fields}))

            def batched_log_post(positions, data):
                return over_blocks(positions.reshape(K, B, d), data["ds"]).reshape(
                    positions.shape[0])

            def one_block(block_idx, data):
                return {"ds": {k: _pick(v, block_idx) for k, v in data["ds"].items()}}

        def log_post(theta, block_idx, data):
            """One walker's posterior: block ``block_idx``'s datasets."""
            return post(theta, one_block(block_idx, data))

        group_ids = np.repeat(np.arange(K), B)
        fit = _SeededLWalker(
            list(self.terms), self.spec, np.asarray(pos0, np.float64), n_walkers=K * B,
            seed=seed, walker_jitter=0.0, dtype=self.dtype, device=self.device,
            config=config, aux=torch.as_tensor(group_ids), group_ids=group_ids,
            n_groups=K, log_posterior=log_post, posterior_data=data,
            batched_log_posterior=batched_log_post,
            l_seed=self.state.l_matrix[0].detach().clone())
        if fit.config.history_walkers and fit.config.history_walkers < K * B:
            # scoring and ranking need every block in the history
            fit.config = dataclasses.replace(fit.config, history_walkers=0)
        return fit

    def _holdout_data(self, name: str, holdouts) -> dict:
        """The K leave-out blocks' stacked data (:meth:`_joint_blocks`):
        each holdout, a boolean keep-mask over the dataset-major real
        points, zeroes the held-out points' mask, rebuilt dataset by
        dataset so each dataset's cached constants are exact for its
        reduced points (JAX hierarchical.py:1174-1200)."""
        mask_np = _host(self._stacked.mask).astype(np.float64)        # (S, N)
        flat = mask_np.reshape(-1)
        real_pos = np.nonzero(flat > 0.0)[0]
        blocks = []
        for keep in holdouts:
            keep = np.asarray(keep)
            if keep.shape != (real_pos.size,):
                raise ValueError(
                    f"{name}: holdout mask has shape {keep.shape}, expected "
                    f"({real_pos.size},) (dataset-major real-point axis)")
            new_flat = flat.copy()
            new_flat[real_pos] *= keep.astype(np.float64)
            new_mask = new_flat.reshape(mask_np.shape)
            blocks.append([Dataset(x=ds.x, y=ds.y, sigma=ds.sigma, n=ds.n,
                                   mask=torch.as_tensor(new_mask[s], dtype=ds.mask.dtype,
                                                        device=ds.mask.device))
                           for s, ds in enumerate(self._datasets)])
        return self._joint_blocks(blocks)

    @property
    def _n_real_points(self) -> int:
        """Length of the dataset-major real-point axis, the axis of every
        joint pointwise verb (waic, loo, loo_pit, the refit holdouts)."""
        return int(torch.count_nonzero(self._stacked.mask > 0.0))

    def _refit_cv(self, name: str, holdouts, n_steps: int, temperature: float,
                  walkers_per_dataset: int, burn_fraction: float, max_samples: int,
                  seed: int):
        """Leave-out refits of the joint posterior as the adaptation groups
        of one walker, the hook ``diagnostics._batched_refit`` takes for
        ``reloo`` and ``kfold`` (JAX hierarchical.py:1132-1229).

        Each holdout is a boolean keep-mask over the dataset-major real
        points (:meth:`_holdout_data`).  Each block's walkers start at a resample of this
        fit's live ensemble (``np.random.default_rng(seed)``, JAX's draws)
        and its L at this fit's adapted factor; then ``diagnostics.
        _run_refit``: the anneal, ``reset``, ``max(2000, n_steps // 2)``
        mala steps, the burn.  Returns ``(fit, score_block)``,
        ``score_block(j) -> (n, N_real)`` the original data's pointwise
        log-likelihood under block j's draws (:meth:`_pointwise_ll`)."""
        from .diagnostics import _require_per_point, _run_refit
        from .fit import history_block_columns

        _require_per_point(name, self._likelihood)
        K, B, d = len(holdouts), int(walkers_per_dataset), self.spec.ndim
        rng = np.random.default_rng(seed)
        live = _host(self.state.position).astype(np.float64)           # (W, d)
        pos0 = live[rng.integers(0, live.shape[0], size=K * B)]
        fit = self._grouped_joint_walker(self._holdout_data(name, holdouts), K, B, seed,
                                         pos0)
        _run_refit(fit, n_steps, temperature, burn_fraction)
        cache: dict = {}

        def score_block(j):
            if "pos" not in cache:
                pos, _ = fit._history(None)                            # (T, K*B, d)
                cache["pos"] = np.asarray(pos)
                cache["cols"] = history_block_columns(fit, cache["pos"].shape[1])
            block = cache["pos"][:, cache["cols"][j], :].reshape(-1, d)
            idx = np.unique(np.linspace(0, block.shape[0] - 1,
                                        min(max_samples, block.shape[0])).astype(int))
            # the original (unreduced) data at the decoded parameters
            return self._pointwise_ll(block[idx])

        return fit, score_block

    def logo(self, n_steps: int = 6000, temperature: float = 2.0,
             walkers_per_dataset: int = 64, burn_fraction: float = 0.3,
             max_samples: int = 128, n_z: int = 16, seed: int = 0) -> LOGOResult:
        """Leave-one-group-out CV: does the population predict a dataset it
        never saw? (JAX hierarchical.py:1231-1334).

        For each dataset s the joint posterior is refit with all of s's
        points masked out (:meth:`_refit_cv`: the S refits as the groups of
        one walker), then ``elpd_s = log E[p(y_s | theta_new)]``,
        ``theta_new`` decoded from block s's draws with the held-out group's
        coordinates redrawn from their priors ``n_z`` times a draw (pooled
        z ~ N(0, 1), non-pooled locals from ``local_priors``; numpy,
        ``default_rng(seed + 1)``).  Needs a complete prior: a held-out
        group's flat local would make its refit improper and leave nothing
        to draw."""
        if not self._complete_prior:
            raise ValueError(
                "logo: non-pooled locals without local_priors make the "
                "held-out group's refit posterior improper and give the "
                "new-group predictive nothing to draw from — declare "
                "local_priors for every non-pooled name")
        from .diagnostics import grouped_refit_health
        from .fit import history_block_columns

        mask_np = _host(self._stacked.mask)
        S, N = self.n_datasets, mask_np.shape[1]
        ds_of_real = np.nonzero(mask_np.reshape(-1) > 0.0)[0] // N
        fit, _ = self._refit_cv("logo", [ds_of_real != s for s in range(S)], n_steps,
                                temperature, walkers_per_dataset, burn_fraction,
                                max_samples, seed)
        refit_ok = grouped_refit_health(fit, "logo")

        pos, _ = fit._history(None)                                    # (T, S*B, d)
        pos = np.asarray(pos, np.float64)
        cols = history_block_columns(fit, pos.shape[1])
        dp, dl = len(self.pooled), self.local_spec.ndim
        pooled_cols = np.asarray(self._pooled_cols)
        np_cols = [j for j in range(dl) if j not in set(pooled_cols.tolist())]
        rng = np.random.default_rng(seed + 1)
        elpd = np.empty(S)
        for s in range(S):
            block = pos[:, cols[s], :].reshape(-1, self.spec.ndim)
            idx = np.unique(np.linspace(0, block.shape[0] - 1,
                                        min(max_samples, block.shape[0])).astype(int))
            draws = np.repeat(block[idx], n_z, axis=0)                 # (n * n_z, d)
            lo = self._n_hyper + s * dl
            draws[:, lo + pooled_cols] = rng.standard_normal((draws.shape[0], dp))
            for j in np_cols:
                k = self.local_spec.keys[j]
                draws[:, lo + j] = np.asarray(self._local_dists[k].sample(rng, draws.shape[0]))
            joint = self._pointwise_ll(draws)[:, ds_of_real == s].sum(axis=1)
            m = joint.max()
            if not np.isfinite(m):
                # every draw underflowed: the population cannot describe
                # this group, a -inf elpd, not a NaN
                elpd[s] = -np.inf
                continue
            elpd[s] = m + np.log(np.mean(np.exp(joint - m)))
        # the standard error over the finite groups (a -inf makes var NaN)
        fin = elpd[np.isfinite(elpd)]
        se = float(np.sqrt(fin.size * np.var(fin, ddof=1))) if fin.size > 1 else 0.0
        return LOGOResult(elpd=float(elpd.sum()), se=se, elpd_per_dataset=elpd,
                          refit_ok=refit_ok)
