"""High-level fitting API: Walker facade, adaptive loop, mcmc_fit.

Port of ``lisp_mcmc_tpu/fit.py``'s gradient-free verbs, the reference's
L4 layer (mcmc-fitting.lisp):
  - ``walker-create`` (1132-1163): normalize fn/data/error/likelihood/prior
    to parallel lists, resolve data-dependent closures, evaluate the first
    step;
  - ``walker-adaptive-steps[-full]`` (862-947): the adaptive loop, split
    at the host/device boundary: each 200-step chunk is enqueued on the
    device (``kernel.py``), and the host loop handles auto-stop, estop,
    history capture and the cold finish between chunks;
  - ``walker-many-steps`` (849-853): fixed-L stepping;
  - ``walker-get`` / ``walker-modify`` (487-580): query and mutation verbs,
    and ``walker-with-exp`` (1052-1064);
  - ``mcmc-fit`` (1165-1176): create + adaptive steps;
  - ``walker-sample-region`` (949-969), ``walker-force-take-step``
    (1124-1129) and the other ``walker-get``/``walker-modify`` verbs;
and the JAX package's adaptation groups (``group_ids``, ``n_groups``),
``tempered_steps`` (parallel tempering, ``auto_ladder``, ``swap_rates``,
``respace_ladder``), ``sampling_steps`` with every sampler (rwm, stretch,
demc, slice, mala, hmc, chees) and ``chees_trajectory``, ``optimize``
(multi-start Adam with warm restarts, :func:`make_adam_sgdr_runner`),
custom posteriors (``log_posterior=``, ``batched_log_posterior=``),
named priors (a ``priors.PriorSpec`` or ``MVGaussian`` as ``log_prior``),
:func:`unit_cube_view`, per-walker ``aux`` data (the batched walker sets
of ``batched.py``), the evidence verbs (``log_evidence``, ``smc_sample``,
``laplace_approx``, ``nested_sample``), the criticism verbs
(``posterior_predictive``, ``ppc_pvalue``, ``prior_predictive``,
``predict``, ``profile_likelihood``, ``prior_sensitivity``, ``audit``) and
the variational verbs (``advi``, ``flow_advi``).

The Walker lives on one device: ``device=None`` means the GPU, and the
CPU is used only when asked for (``device="cpu"``).  Its random stream is
a ``torch.Generator`` on that device, seeded from ``seed``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from . import control
from .data import Dataset, clean_data, clean_data_error
from .device import resolve_device
from .kernel import (ENSEMBLE_KERNELS, FitConfig, _neg_floor, build_chunk_runner,
                     init_state, make_eval_vg, resolve_accept_band, rung_betas)
from .likelihoods import log_likelihood_normal, resolve_likelihood
from .ops.chunk_kernel import build_chunk_kernel, chunk_coverage
from .ops.linalg import cholesky_clamped
from .ops.loglik_kernel import (fused_posterior, kernel_coverage, posterior_rel_err,
                                prepare_fused_terms)
from .params import ParamSpec, normalize_params
from .priors import as_prior_spec, log_prior_flat, resolve_prior, unit_cube_wall

__all__ = ["Walker", "walker_create", "mcmc_fit", "default_dtype", "respace_ladder",
           "unit_cube_view", "make_adam_sgdr_runner", "history_block_columns"]


def default_dtype():
    """The floating type the constructors take when given none: float32,
    the card's working type.  JAX ``fit.default_dtype`` (fit.py:52) reads
    its x64 switch; the port has none, so this is float32 always and a
    float64 fit asks for it (``dtype=torch.float64``)."""
    return torch.float32


def _force_list(item):
    """``force-list`` (mcmc-fitting.lisp:755-759)."""
    if isinstance(item, (list, tuple)):
        return list(item)
    return [item]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _split_rhat_host(pos: np.ndarray) -> np.ndarray:
    """Split Gelman-Rubin over a host (T, W, d) history -> (d,).

    +inf for fewer than 4 retained steps and for a frozen ensemble, so
    callers read "not enough history" as "not converged".
    """
    t2 = pos.shape[0] // 2 * 2
    if t2 < 4:
        return np.full(pos.shape[-1], np.inf)
    halves = np.concatenate([pos[: t2 // 2], pos[t2 // 2: t2]], axis=1)
    n = halves.shape[0]
    chain_means = halves.mean(axis=0)
    chain_vars = halves.var(axis=0, ddof=1)
    w = chain_vars.mean(axis=0)
    b = n * chain_means.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    ok = w > 1e-12 * var_plus
    return np.where(ok, np.sqrt(var_plus / np.where(ok, w, 1.0)), np.inf)


def _rank_normalize_host(pos: np.ndarray) -> np.ndarray:
    """Average-rank Blom normal scores per parameter over a (T, W, d) block."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    t, w, d = pos.shape
    flat = pos.reshape(-1, d)
    r = rankdata(flat, method="average", axis=0)
    return ndtri((r - 0.375) / (t * w + 0.25)).reshape(t, w, d)


def make_adam_sgdr_runner(vg, n_steps: int):
    """Whitened Adam with cosine warm restarts, the ascent core of
    :meth:`Walker.optimize` (JAX ``fit.make_adam_sgdr_runner``,
    fit.py:87-128).

    ``vg(pos, data) -> (values, grads)``, batched over walkers; returns
    ``run(pos0, s, lr, data)``, which takes ``n_steps`` Adam steps of
    every walker in coordinates whitened by ``s`` (a zero scale freezes
    its coordinate), in cycles of ``min(n_steps, 200)`` steps: each cycle
    starts from fresh moments and decays its rate to zero on a cosine
    (SGDR), which reaches the bottom of narrow correlated valleys where one
    long decay runs out of step.  One ``vg`` a step, a Python loop over
    tensors; non-finite gradient entries count as 0.
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    cycle = min(n_steps, 200)

    def run(pos0, s, lr, data):
        pos = pos0
        m = v = torch.zeros_like(pos0)
        for i in range(n_steps):
            ic = float(i % cycle)
            if ic == 0:
                m = v = torch.zeros_like(pos0)
            _, g = vg(pos, data)
            gz = torch.where(torch.isfinite(g), g, 0.0) * s
            m = b1 * m + (1 - b1) * gz
            v = b2 * v + (1 - b2) * gz * gz
            mhat = m / (1 - b1 ** (ic + 1.0))
            vhat = v / (1 - b2 ** (ic + 1.0))
            lr_t = lr * 0.5 * (1.0 + math.cos(math.pi * ic / cycle))
            pos = pos + lr_t * s * mhat / (torch.sqrt(vhat) + eps)
        return pos

    return run


def history_block_columns(walker, width: int) -> list[np.ndarray]:
    """Column-index arrays, one per adaptation group, for a history of
    ``width`` walker columns (JAX ``fit.history_block_columns``,
    fit.py:131-157): the history holds every walker, the evenly spaced
    ``history_walkers`` subsample, or (no rows collected) the live
    ensemble, and each maps group ids its own way."""
    g = getattr(walker, "group_ids", None)
    if g is None or getattr(walker, "n_groups", 1) <= 1:
        return [np.arange(width)]
    g = np.asarray(g)
    if width != g.size:
        retained = walker._history_walker_idx()
        if retained is not None and width == len(retained):
            g = g[_host(retained)]
        else:
            raise ValueError(
                f"history width {width} matches neither the ensemble "
                f"({g.size}) nor the retained walker subsample — "
                "cannot map dataset blocks")
    return [np.nonzero(g == s)[0] for s in range(int(walker.n_groups))]


def _aux_take(aux, idx):
    """Walkers ``idx`` of per-walker ``aux`` data: a tensor, or a dict of
    tensors, each with the walkers on its leading axis."""
    if isinstance(aux, dict):
        return {k: v[idx] for k, v in aux.items()}
    return aux[idx]


def _aux_on(aux, device, n_walkers: int):
    """``aux`` as tensors on ``device``, each checked for a leading axis W."""
    def one(name, a):
        a = torch.as_tensor(a.detach() if torch.is_tensor(a) else np.asarray(a), device=device)
        if a.ndim == 0 or a.shape[0] != n_walkers:
            raise ValueError(f"aux{name} has shape {tuple(a.shape)}; per-walker aux data "
                             f"needs a leading axis of {n_walkers} walkers")
        return a
    if isinstance(aux, dict):
        return {k: one(f"[{k!r}]", v) for k, v in aux.items()}
    return one("", aux)


def _nonzero_scales(vec):
    """Per-parameter magnitudes with zeros replaced by a small derived
    scale (so no proposal coordinate is permanently stuck)."""
    v = np.asarray(vec, dtype=np.float64)
    nonzero = np.abs(v[v != 0])
    fallback = 1e-3 * nonzero.mean() if nonzero.size else 1e-3
    return np.where(v == 0, fallback, v)


@dataclasses.dataclass
class _Term:
    """One (function, dataset, likelihood, prior) posterior term."""

    fn: Callable
    dataset: Dataset
    likelihood: Callable
    prior: Callable


class Walker:
    """Host facade over a walker ensemble on one device.

    Query verbs (``walker-get``, mcmc-fitting.lisp:487-543):
    ``most_likely_step``, ``most_likely_params``, ``median_params``,
    ``mean_params``, ``stddev_params``, ``acceptance``, ``steps``,
    ``log_likelihoods``, ``param_trace``, ``covariance_matrix``,
    ``l_matrix_estimate``, ``unique_steps``, ``forward_steps``,
    ``check_for_nonfinite``, ``diagnose_params``, ``with_expression``,
    ``swap_rates``, ``summary``, ``metrics``, ``convergence``, the
    evidence verbs ``log_evidence``, ``smc_sample``, ``laplace_approx``,
    ``nested_sample``, and the criticism verbs ``posterior_predictive``,
    ``ppc_pvalue``, ``prior_predictive``, ``predict``,
    ``profile_likelihood``, ``prior_sensitivity``, ``audit``, and the
    variational verbs ``advi``, ``flow_advi``.  Mutation
    verbs (``walker-modify``, 547-580): ``reset``, ``reset_to_most_likely``,
    ``burn_steps``, ``keep_steps``, ``add_steps``, ``delete``, and
    ``force_step``, ``swap_data``, ``sample_region``, ``optimize``.

    ``group_ids`` (W,) and ``n_groups`` split the walkers into adaptation
    groups, each with its own L, moments and acceptance window.

    A custom posterior replaces the terms' (JAX ``Walker``, fit.py:207-231):
    ``batched_log_posterior(positions (W, d), data) -> (W,)`` wins when
    given, and is taken to need the whole ensemble (the red-black halves
    and the rescue evaluate a full ensemble with their proposals in the
    active slots, as the JAX package does); else ``log_posterior(theta
    (d,), data) -> ()``, one walker's, is evaluated over the batch by
    ``torch.func.vmap``.  ``data`` is ``posterior_data``.  With ``aux``
    (a tensor, or a dict of tensors, with the W walkers on the leading
    axis, moved to the walker's device) the per-walker posterior is
    ``log_posterior(theta, aux_w, data)``, vmapped over the walkers and
    their aux; a half-ensemble takes the aux of its own walkers.  Autograd
    differentiates any of them (``optimize`` and the gradient samplers).
    A custom posterior or aux data never runs on the CUDA kernels:
    ``posterior_impl="kernel"`` or ``"chunk_kernel"`` raises, naming which.
    """

    def __init__(self, terms: list[_Term], spec: ParamSpec, initial_vector, *,
                 n_walkers: int = 1, seed: int = 0, walker_jitter: float = 0.0,
                 config: FitConfig | None = None, dtype=None, device=None,
                 aux=None, group_ids=None, n_groups: int = 1,
                 log_posterior: Callable | None = None, posterior_data=None,
                 batched_log_posterior: Callable | None = None):
        if aux is not None and log_posterior is None:
            raise ValueError("aux= is read by a custom log_posterior(theta, aux_w, data); "
                             "this walker has none")
        self._custom_log_post = log_posterior
        self._custom_data = posterior_data
        self._custom_batched = batched_log_posterior
        self.device = resolve_device(device)
        self.terms = terms
        self.spec = spec
        self.config = config or FitConfig()
        self.dtype = dtype or default_dtype()
        self.n_walkers = int(n_walkers)
        self._runner_cache: dict[Any, Any] = {}
        self.group_ids = None if group_ids is None else np.asarray(group_ids, np.int64)
        self.n_groups = int(n_groups)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

        d = spec.ndim
        kw = dict(dtype=self.dtype, device=self.device)
        initial_vector = torch.as_tensor(np.asarray(initial_vector, np.float64))
        if initial_vector.ndim == 2 and initial_vector.shape[0] > 1:
            if initial_vector.shape[1] != d:
                raise ValueError(
                    f"initial_vector has {initial_vector.shape[1]} parameters "
                    f"but the spec defines {d} ({spec.keys})")
            position = initial_vector.to(**kw)
            vec = position[0]
            if self.n_walkers not in (1, position.shape[0]):
                raise ValueError(
                    f"initial_vector has {position.shape[0]} walkers but "
                    f"n_walkers={self.n_walkers}")
            self.n_walkers = int(position.shape[0])
        else:
            vec = initial_vector.reshape(-1).to(**kw)
            position = vec.expand(self.n_walkers, d).clone()
        self.aux = None if aux is None else _aux_on(aux, self.device, self.n_walkers)
        if walker_jitter > 0:
            noise = torch.randn(position.shape, generator=self.generator, **kw)
            position = position * (1.0 + walker_jitter * noise)

        self._log_post = self._build_log_posterior()
        # Whether the posterior needs the whole ensemble (a batched custom
        # one), and the evaluation of a subset of walker slots where the
        # posterior reads per-walker aux (else None: any batch will do).
        self._whole_batch = batched_log_posterior is not None
        self._rows_post = self._build_rows_posterior()
        logprob = self._eval_batch(position)
        l0 = self._initial_l_matrix(vec)
        if self.group_ids is not None and self.group_ids.shape != (self.n_walkers,):
            raise ValueError(f"group_ids has shape {self.group_ids.shape}, want "
                             f"({self.n_walkers},)")
        self.state = init_state(position, logprob, l0, n_groups=self.n_groups)

        # Host-side thinned history (the walker's "walk", 471).
        self._hist_positions: list[np.ndarray] = []  # each (K, W', d)
        self._hist_logprobs: list[np.ndarray] = []   # each (K, W')
        # Chunk logs hold DEVICE values, converted when read, so recording
        # a chunk never waits for the device.
        self._accept_log: list = []
        self._lpmax_trace: list = []
        self._lpmean_trace: list = []
        self._swap_trace: list = []                  # per-chunk (K-1,) swap rates
        self._swap_betas: np.ndarray | None = None   # last tempered ladder
        self.posterior_evals = 0                     # batched-posterior calls in chunks
        self.gradient_evals = 0                      # value-and-gradient evaluations

    # ------------------------------------------------------------------ build

    @property
    def _custom(self) -> bool:
        """Whether a custom posterior replaces the terms'."""
        return self._custom_batched is not None or self._custom_log_post is not None

    def _posterior_data(self):
        """The data a custom posterior is given (``posterior_data``), or
        the terms' datasets."""
        if self._custom_data is not None:
            return self._custom_data
        return tuple(t.dataset for t in self.terms)

    def _build_log_posterior(self):
        """Batched posterior ``positions (W, d) -> (W,)``, plain PyTorch.

        Likelihoods see ``(W, 1)`` parameter columns (so the model gives
        ``(W, P)``); priors see ``(W,)`` columns.  A custom posterior
        takes the terms' place: the batched one as it is, the per-walker
        one under ``torch.func.vmap``.
        """
        data = self._posterior_data()
        if self._custom_batched is not None:
            batched = self._custom_batched
            return lambda positions: batched(positions, data)
        if self._custom_log_post is not None:
            one = self._custom_log_post
            if self.aux is not None:
                aux = self.aux
                with_aux = torch.func.vmap(lambda theta, aux_w: one(theta, aux_w, data))
                return lambda positions: with_aux(positions, aux)
            vmapped = torch.func.vmap(lambda theta: one(theta, data))
            return lambda positions: vmapped(positions)
        terms, spec = self.terms, self.spec

        def log_post(positions):
            cols = spec.unflatten(positions)
            pts = {k: v[:, None] for k, v in cols.items()}
            total = 0.0
            for t in terms:
                total = total + t.likelihood(t.fn, pts, t.dataset)
                total = total + t.prior(cols, t.dataset)
            return total

        return log_post

    def _build_rows_posterior(self):
        """``(positions (n, d), rows (n,)) -> (n,)``: the posterior of
        proposals placed at walker slots ``rows``, each with that walker's
        aux (JAX kernel.py:515-547, 1761-1771); None without aux."""
        if self.aux is None or self._whole_batch:
            return None
        one, data, aux = self._custom_log_post, self._posterior_data(), self.aux
        with_aux = torch.func.vmap(lambda theta, aux_w: one(theta, aux_w, data))
        return lambda positions, rows: with_aux(positions, _aux_take(aux, rows))

    def _initial_l_matrix(self, vec):
        """Cold-start proposal: diag of parameter values (mcmc-fitting.lisp:899),
        with exact zeros replaced by a small derived scale."""
        return torch.as_tensor(np.diag(_nonzero_scales(_host(vec))),
                               dtype=self.dtype, device=self.device)

    def _eval_batch(self, positions):
        """The plain posterior with the kernel's non-finite floor: a NaN
        start would otherwise freeze every accept comparison."""
        lp = self._log_post(positions)
        return torch.where(torch.isfinite(lp), lp, _neg_floor(lp.dtype))

    def _batched_posterior(self):
        """The value-only posterior: the fused kernel or the plain version.

        ``"auto"`` takes the kernel on CUDA when the fit is inside its
        coverage (``ops.loglik_kernel.kernel_coverage``) and the plain path
        otherwise; ``"kernel"`` and ``"chunk_kernel"`` require the
        coverage and raise outside it.  A kernel that fails to build or
        launch raises.  The gradient samplers' values and gradients come
        from autograd through the plain posterior whatever this returns
        (``kernel.make_eval_vg``); only their value-only evaluations (the
        rescue) take it.
        """
        impl = self.config.posterior_impl
        if impl == "plain":
            return self._log_post
        if self._custom:
            self._refuse_custom(impl)
            return self._log_post
        reason = kernel_coverage(self.terms, self.spec)
        if impl == "auto" and (reason is not None or self.device.type != "cuda"):
            return self._log_post
        if reason is not None:
            raise ValueError(f"posterior_impl={impl!r}: the fit is outside "
                             f"the fused kernel's coverage: {reason}")
        return self._fused_posterior_probed(impl)

    def _refuse_custom(self, impl: str):
        """A custom posterior is plain PyTorch, and per-walker aux data is
        an input neither kernel has: a kernel cannot run either (JAX
        fit.py:364, 435 keep such fits off Pallas)."""
        if impl in ("kernel", "chunk_kernel") and self.aux is not None:
            raise ValueError(
                f"posterior_impl={impl!r}: the fit is outside the kernels' coverage: "
                f"{kernel_coverage(self.terms, self.spec, self.aux)}; use "
                "posterior_impl='auto' or 'plain'")
        if impl in ("kernel", "chunk_kernel"):
            raise ValueError(
                f"posterior_impl={impl!r}: this walker has a custom posterior "
                "(log_posterior= or batched_log_posterior=), which the CUDA "
                "kernels cannot evaluate; use posterior_impl='auto' or 'plain'")

    def _fused_posterior_probed(self, impl_name: str):
        """Build the fused posterior, verified against the plain one.

        The equivalence probe at the current ensemble catches a kernel
        that computes another posterior than the plain path (relative
        1e-4, ``ops.loglik_kernel.posterior_rel_err``); it raises rather
        than run the wrong kernel.
        """
        fused = self._runner_cache.get("_fused")
        if fused is not None:
            return fused
        post = prepare_fused_terms(self.terms, self.spec, self.dtype)
        if post is None:
            raise ValueError(f"posterior_impl={impl_name!r}: the fit is "
                             "outside the fused kernel's coverage")

        def fused(positions):
            return fused_posterior(positions, post)

        pos = self.state.position
        if posterior_rel_err(fused(pos), self._eval_batch(pos), post) > 1e-4:
            raise ValueError(
                f"posterior_impl={impl_name!r}: the fused kernel disagrees "
                "with the plain posterior at the current ensemble")
        self._runner_cache["_fused"] = fused
        return fused

    def _runner(self, greedy: bool = False, with_history: bool = True):
        cfg = dataclasses.replace(self.config, greedy=greedy)
        if cfg.tempering_rungs > 1:
            # The ladder replaces the n_steps-dependent schedule: runs of
            # any length share one runner.
            cfg = dataclasses.replace(cfg, n_steps=0)
        cache_key = (cfg, with_history, self.n_groups,
                     None if self.group_ids is None else self.group_ids.tobytes())
        if cache_key not in self._runner_cache:
            chunk = None
            if self._custom:
                self._refuse_custom(cfg.posterior_impl)
            elif cfg.posterior_impl == "chunk_kernel" and not with_history:
                # Non-history chunks run as one kernel launch each; history
                # chunks keep the per-step path.  The probe gates it too.
                reason = chunk_coverage(self.terms, self.spec, cfg,
                                        self.n_walkers, self.dtype, self.n_groups)
                if reason is not None:
                    raise ValueError("posterior_impl='chunk_kernel': the fit is "
                                     f"outside the chunk kernel's coverage: {reason}")
                self._fused_posterior_probed("chunk_kernel")
                chunk = build_chunk_kernel(self.terms, self.spec, cfg,
                                           self.n_walkers, self.dtype)
            run, run_hist = build_chunk_runner(
                self._batched_posterior(), self.spec.ndim, cfg,
                chunk_kernel=chunk, group_ids=self.group_ids, n_groups=self.n_groups,
                eval_plain=self._log_post, whole_batch=self._whole_batch,
                eval_rows=self._rows_post)
            self._runner_cache[cache_key] = run_hist if with_history else run
        return self._runner_cache[cache_key]

    # ----------------------------------------------------------- adaptive loop

    @property
    def ndim(self) -> int:
        return self.spec.ndim

    @property
    def age(self) -> int:
        return int(self.state.age)

    @property
    def _thin(self) -> int:
        """History thinning as the runner applies it (min(thin, chunk))."""
        return max(1, min(self.config.thin, self.config.chunk_size))

    def __len__(self) -> int:
        """Retained history length in steps (walker-length analogue)."""
        return sum(h.shape[0] for h in self._hist_positions) * self._thin

    def adaptive_steps(self, n: int | None = None, *, temperature: float | None = None,
                       auto: str | None = "default", collect_history: bool = True,
                       progress: bool = False, l_matrix=None,
                       on_chunk: Callable | None = None):
        """Adaptive MH loop (``walker-adaptive-steps[-full]``, 862-947).

        Runs up to ``n`` steps in 200-step chunks; auto-stop, the cold
        finish, estop and history capture happen between chunks.
        ``l_matrix`` seeds the proposal factor (862).
        """
        if l_matrix is not None:
            self._set_l_matrix(l_matrix)
        cfg = self.config
        if n is not None or temperature is not None or auto != "default":
            cfg = dataclasses.replace(
                cfg,
                n_steps=int(n) if n is not None else cfg.n_steps,
                temperature=float(temperature) if temperature is not None else cfg.temperature,
                auto=cfg.auto if auto == "default" else auto,
            )
        prev_config = self.config
        self.config = cfg
        try:
            self._adaptive_loop(cfg, collect_history, progress, on_chunk)
        finally:
            self.config = prev_config

    def _adaptive_loop(self, cfg: FitConfig, collect_history: bool,
                       progress: bool, on_chunk: Callable | None = None):
        control.clear_stop()
        if cfg.auto in ("rhat", "rank-rhat") and not collect_history:
            raise ValueError(
                f"auto={cfg.auto!r} computes split R-hat from the retained "
                "walker history; run with collect_history=True (or another "
                "auto mode)")
        if cfg.kernel in ENSEMBLE_KERNELS and not cfg.greedy:
            # Ensemble moves cannot create spread they lack: a coordinate
            # every walker of a group agrees on stays frozen, at
            # acceptance 1 (walker_jitter=0, reset_to_most_likely).
            pos = self.state.position
            if self.group_ids is not None and self.n_groups:
                pos = pos.reshape(self.n_groups, -1, self.ndim)
            else:
                pos = pos[None]
            if bool(((pos.amax(dim=1) - pos.amin(dim=1)) == 0).any()):
                raise ValueError(
                    f"{cfg.kernel} kernel: the ensemble has zero spread in "
                    "at least one coordinate (per adaptation group), which "
                    "ensemble moves can never escape — create the walker "
                    "with walker_jitter > 0 AND nonzero initial guesses "
                    "(the jitter is multiplicative, so a parameter guessed "
                    "at exactly 0 stays 0 for every walker), or run an rwm "
                    "anneal first (after reset_to_most_likely, take some "
                    "rwm steps before switching kernels)")
        # Each adaptive run gets a fresh annealing clock (919-921).
        self.state = dataclasses.replace(self.state, anneal_step=0)
        settle = cfg.steps_to_settle(self.ndim)
        chunk = cfg.chunk_size
        n_chunks = max(1, math.ceil(cfg.n_steps / chunk))
        # A tempered search keeps its ladder for the whole budget: no cold
        # finish.
        shutdown_chunks = (0 if cfg.tempering_rungs > 1
                           else max(1, math.ceil(max(2000, settle) / chunk)))
        runner = self._runner(greedy=False, with_history=collect_history)

        shutting_down = False
        remaining = n_chunks
        i_chunk = 0
        # The previous chunk's outputs are recorded AFTER the next chunk is
        # enqueued, so the history copy overlaps the device's work.
        pending_out = None
        with control.interruptible():
            while remaining > 0 and not control.stop_requested():
                # Shutdown = the reference's cold finish (915-917): refresh
                # off and the temperature pinned to 1.
                if cfg.refresh_every > 0:
                    refresh_due = ((i_chunk + 1) * chunk) % cfg.refresh_every < chunk
                else:
                    refresh_due = True
                self.state, out = runner(
                    self.state, True, refresh_due and not shutting_down,
                    shutting_down, generator=self.generator)
                out = self._stage_history(out)
                if pending_out is not None:
                    self._record_chunk(pending_out)
                pending_out = out
                i_chunk += 1
                remaining -= 1
                step = i_chunk * chunk

                if on_chunk is not None:
                    # Observability hook: return True to request a stop.
                    if on_chunk(step, {
                        "accept_rate": float(out["accept_rate"]),
                        "logprob_max": float(out["logprob_max"][-1]),
                        "logprob_mean": float(out["logprob_mean"][-1]),
                        "shutting_down": shutting_down,
                    }):
                        control.request_stop()
                if progress and i_chunk % 25 == 0:
                    print(f"step {step}: acc={float(out['accept_rate']):.3f} "
                          f"best={float(self.state.best_logprob.max()):.3f}")

                if shutting_down:
                    continue
                # Enter shutdown when close to the end (906) ...
                if remaining <= shutdown_chunks:
                    shutting_down = True
                    continue
                # ... or when auto-stop triggers (907-917), gated on the
                # kernel's acceptance band (+0.1, as at 911).
                if (cfg.auto and step % 1000 < chunk and step > 2 * settle
                        and self._accept_log):
                    k = max(1, 1000 // chunk)
                    acc = float(torch.stack(self._accept_log[-k:]).mean())
                    gate_low, gate_high = resolve_accept_band(cfg)
                    if (gate_low < acc < gate_high + 0.1
                            and self._auto_settled(cfg, settle)):
                        shutting_down = True
                        remaining = max(1, shutdown_chunks)
            if pending_out is not None:
                self._record_chunk(pending_out)

    def _stage_history(self, out):
        """Start the history's device->host copy right behind its chunk.

        The retained walkers are sliced on the device first; on CUDA the
        copy goes into pinned memory on the stream, ordered before the
        next chunk's work, and an event marks when it has landed.
        """
        if "positions" not in out:
            return out
        pos, lp = out["positions"], out["logprobs"]
        idx = self._history_walker_idx()
        if idx is not None:
            pos = pos.index_select(1, idx)
            lp = lp.index_select(1, idx)
        out = dict(out)
        if pos.is_cuda:
            host_pos = torch.empty(pos.shape, dtype=pos.dtype, pin_memory=True)
            host_lp = torch.empty(lp.shape, dtype=lp.dtype, pin_memory=True)
            host_pos.copy_(pos, non_blocking=True)
            host_lp.copy_(lp, non_blocking=True)
            out["copied"] = torch.cuda.Event()
            out["copied"].record()
            pos, lp = host_pos, host_lp
        out["positions"], out["logprobs"] = pos, lp
        return out

    def _record_chunk(self, out):
        self._accept_log.append(out["accept_rate"])
        self._lpmax_trace.append(out["logprob_max"])
        self._lpmean_trace.append(out["logprob_mean"])
        self.posterior_evals += out["posterior_evals"]
        self.gradient_evals += out["gradient_evals"]
        if "swap_rate" in out:
            self._swap_trace.append(out["swap_rate"])   # device (K-1,)
        # Only the last few settle windows are ever read.
        max_trace_chunks = max(
            1, 4 * max(self.config.steps_to_settle(self.ndim), 2500)
            // self.config.chunk_size)
        if len(self._lpmax_trace) > 2 * max_trace_chunks:
            del self._lpmax_trace[:-max_trace_chunks]
            del self._lpmean_trace[:-max_trace_chunks]
            del self._accept_log[:-max_trace_chunks]
        if len(self._swap_trace) > 2 * max_trace_chunks:
            del self._swap_trace[:-max_trace_chunks]
        if "positions" in out:
            if "copied" in out:
                out["copied"].synchronize()
            self._hist_positions.append(out["positions"].numpy())
            self._hist_logprobs.append(out["logprobs"].numpy())
            self._trim_history()

    def _history_walker_idx(self):
        """Evenly-spaced walker subsample kept in the host history, or None
        when every walker is kept (W <= history_walkers)."""
        k = self.config.history_walkers
        if not k or self.n_walkers <= k:
            return None
        cached = getattr(self, "_hist_idx", None)
        if cached is None or cached[0] != (k, self.n_walkers):
            self._hist_idx = ((k, self.n_walkers), torch.as_tensor(
                np.linspace(0, self.n_walkers - 1, k).astype(np.int64),
                device=self.device))
        return self._hist_idx[1]

    def _trim_history(self):
        max_entries = max(1, self.config.max_history // self._thin)
        first = self._hist_positions[0]
        row_bytes = (first.shape[1] * (first.shape[2] + 1)) * first.dtype.itemsize
        max_entries = min(max_entries,
                          max(1, self.config.max_history_bytes // row_bytes))
        total = sum(h.shape[0] for h in self._hist_positions)
        while total > max_entries and len(self._hist_positions) > 1:
            total -= self._hist_positions.pop(0).shape[0]
            self._hist_logprobs.pop(0)

    def _auto_settled(self, cfg: FitConfig, settle: int) -> bool:
        trace = (np.concatenate([_host(t) for t in self._lpmax_trace])
                 if self._lpmax_trace else np.empty(0))
        if trace.size < max(settle, 400):
            return False
        if cfg.auto == "prob-settle":
            # stable-probs-p (880-885): stable max values + healthy spread.
            window = trace[-settle:]
            early_max = window[:200].max()
            late_max = window[-200:].max()
            if self.n_walkers == 1:
                return (abs(early_max - late_max) < 0.5
                        and 4 < (early_max - window.min()) < 9)
            # Ensemble: both the max trace and the mean trace stopped drifting.
            mean_trace = np.concatenate([_host(t) for t in self._lpmean_trace])[-settle:]
            mean_drift = abs(mean_trace[:200].mean() - mean_trace[-200:].mean())
            return abs(early_max - late_max) < 0.5 and mean_drift < 0.5
        if cfg.auto in ("rhat", "rank-rhat"):
            if not self._hist_positions:
                return False
            pos, _ = self._history(max(settle, 1000))
            if pos.shape[0] * self._thin < settle:
                return False
            if cfg.auto == "rhat":
                return float(np.max(_split_rhat_host(pos))) < 1.01
            bulk = _split_rhat_host(_rank_normalize_host(pos))
            folded = np.abs(pos - np.median(pos, axis=(0, 1), keepdims=True))
            tail = _split_rhat_host(_rank_normalize_host(folded))
            return float(max(np.max(bulk), np.max(tail))) < 1.01
        if cfg.auto == "slope-settle":
            # stable-prob-slope-p (886-887) as a closed-form OLS slope.
            window = trace[-max(2500, settle):]
            x = np.arange(window.size, dtype=np.float64)
            slope = np.polyfit(x, window, 1)[0]
            return abs(slope) * window.size < 1.0
        return False

    def _set_l_matrix(self, l_matrix):
        l = torch.as_tensor(np.asarray(_host(l_matrix), np.float64),
                            dtype=self.dtype, device=self.device)
        if l.ndim == 2:
            l = l.expand(self.n_groups, *l.shape).clone()
        self.state = dataclasses.replace(self.state, l_matrix=l)

    def many_steps(self, n: int, l_matrix=None):
        """Fixed-L stepping, no adaptation, T=1 (``walker-many-steps``, 849-853)."""
        if l_matrix is not None:
            self._set_l_matrix(l_matrix)
        else:
            # Reference default: diag(1e-2 * median params) (851), with the
            # zero-parameter guard of the cold start.
            med = self.median_params_vector()
            self._set_l_matrix(np.diag(1e-2 * _nonzero_scales(med)))
        runner = self._runner(greedy=False, with_history=True)
        chunks = max(1, math.ceil(n / self.config.chunk_size))
        control.clear_stop()
        with control.interruptible():
            for _ in range(chunks):
                if control.stop_requested():
                    break
                self.state, out = runner(self.state, False, False, True,
                                         generator=self.generator)
                self._record_chunk(self._stage_history(out))

    def sample_region(self, initial_scale: float = 1e-3, n: int = 3000):
        """Greedy proposal tuner (``walker-sample-region``, 949-969).

        Greedy steps (no temperature, adaptation off) from L =
        ``initial_scale`` diag(best params), in 50-step chunks: L x 0.25
        when a chunk's acceptance is at most 0.02, x 1.7 above 0.08
        (967-968).  The chunks' acceptances go to ``tuner_accept_log``,
        not to the adaptive run's logs.
        """
        control.clear_stop()
        best = _nonzero_scales(_host(self.best_params_vector()))
        self._set_l_matrix(initial_scale * np.diag(best))
        prev_config = self.config
        self.config = dataclasses.replace(self.config, chunk_size=50)
        try:
            self._sample_region_loop(n)
        finally:
            self.config = prev_config

    def _sample_region_loop(self, n: int):
        runner = self._runner(greedy=True, with_history=False)
        chunks = max(1, math.ceil(n / self.config.chunk_size))
        self.tuner_accept_log: list[float] = []
        for _ in range(chunks):
            if control.stop_requested():
                break
            state, out = runner(self.state, False, False, True, generator=self.generator)
            acc = float(out["accept_rate"])
            scale = 0.25 if acc <= 0.02 else (1.7 if acc > 0.08 else 1.0)
            self.state = dataclasses.replace(state, l_matrix=state.l_matrix * scale)
            self.tuner_accept_log.append(acc)

    def force_step(self):
        """Re-evaluate the posterior at the current positions
        (``walker-force-take-step``, 1124-1129; after a data swap)."""
        self.state = dataclasses.replace(self.state,
                                         logprob=self._eval_batch(self.state.position))

    def swap_data(self, datasets):
        """Replace the datasets term by term and re-evaluate in place; the
        best points restart under the new posterior.  The kernel caches
        (kernel 1's packed data among them) are dropped, so the next
        chunk builds them on the new data."""
        if self._custom:
            raise ValueError(
                "swap_data: this walker uses a custom posterior that closes "
                "over its data; recreate the fit with the new data instead")
        if len(datasets) != len(self.terms):
            raise ValueError("swap_data: dataset count must match term count")
        self.terms = [dataclasses.replace(t, dataset=d) for t, d in zip(self.terms, datasets)]
        self._log_post = self._build_log_posterior()
        self._runner_cache.clear()
        self.force_step()
        self.state = dataclasses.replace(self.state, best_position=self.state.position,
                                         best_logprob=self.state.logprob)

    def optimize(self, n_steps: int = 500, learning_rate: float = 0.05, rounds: int = 1):
        """Multi-start gradient ascent on the log posterior (JAX
        ``Walker.optimize``, fit.py:1275-1330).

        Every walker runs :func:`make_adam_sgdr_runner` in coordinates
        whitened by the ensemble's median |position| per parameter, so one
        ``learning_rate`` serves parameters of very different magnitudes.
        ``rounds`` reruns it with the scales refit to the improved
        ensemble.  A walker moves only where its finite endpoint improved
        its log posterior, so the ensemble never degrades; the best points
        follow.  L and the moments are untouched.  Values and gradients
        come from autograd through the plain posterior; the endpoints'
        values from the value-only posterior (kernel 1 on CUDA).
        """
        if n_steps <= 0:
            raise ValueError(f"n_steps must be positive, got {n_steps}")
        if rounds <= 0:
            raise ValueError(f"rounds must be positive, got {rounds}")
        for _ in range(rounds):
            if control.stop_requested():
                break
            self._optimize_round(n_steps, learning_rate)

    def _optimize_round(self, n_steps: int, learning_rate: float):
        st = self.state
        s = torch.as_tensor(_nonzero_scales(np.median(np.abs(_host(st.position)), axis=0)),
                            dtype=self.dtype, device=self.device)
        key = ("optimize", int(n_steps))
        fn = self._runner_cache.get(key)
        if fn is None:
            eval_vg = make_eval_vg(self._log_post)
            fn = make_adam_sgdr_runner(lambda pos, data: eval_vg(pos)[:2], n_steps)
            self._runner_cache[key] = fn
        new_pos = fn(st.position, s, float(learning_rate), self._posterior_data())
        new_pos = torch.where(torch.isfinite(new_pos).all(dim=1)[:, None], new_pos,
                              st.position)
        new_lp = self._batched_posterior()(new_pos)
        new_lp = torch.where(torch.isfinite(new_lp), new_lp, _neg_floor(new_lp.dtype))
        improved = new_lp > st.logprob
        position = torch.where(improved[:, None], new_pos, st.position)
        logprob = torch.where(improved, new_lp, st.logprob)
        better = logprob > st.best_logprob
        self.state = dataclasses.replace(
            st, position=position, logprob=logprob,
            best_position=torch.where(better[:, None], position, st.best_position),
            best_logprob=torch.where(better, logprob, st.best_logprob))

    def tempered_steps(self, n: int, rungs: int = 8, t_max: float | None = None,
                       collect_history: bool = False, betas=None,
                       auto_ladder: bool = False):
        """Parallel-tempering search phase (replica exchange; JAX
        ``Walker.tempered_steps``, fit.py:790-901).

        Splits the ensemble into ``rungs`` contiguous blocks on a
        temperature ladder from 1 to ``t_max`` (default: the config
        temperature, at least 10), geometric unless ``betas`` gives it
        (descending from 1.0); each rung is an adaptation group, and
        adjacent rungs swap replicas at every chunk end.  ``logprob``
        stays untempered, so best-step tracking is exact; history mixes
        temperatures and is off by default.  ``auto_ladder`` runs a pilot
        (about a fifth of ``n``) on the starting ladder, re-spaces the
        rungs by the measured swap rates (:func:`respace_ladder`) and runs
        the rest on the new ladder; with ``collect_history`` it drops the
        pilot's history.  Afterwards the ensemble is one group again with
        the cold rung's L.
        """
        if self.aux is not None or self.group_ids is not None:
            raise ValueError("tempering is unavailable for batched/grouped fits")
        K = int(rungs)
        if K < 2 or self.n_walkers % K:
            raise ValueError(f"rungs must be >= 2 and divide n_walkers={self.n_walkers}")
        prev_config, prev_groups = self.config, (self.group_ids, self.n_groups)
        prev_chees = self.state.chees
        d = self.ndim
        kw = dict(dtype=self.dtype, device=self.device)
        try:
            # One adaptation group per rung: widen the group-axis state.
            self.group_ids = np.repeat(np.arange(K), self.n_walkers // K)
            self.n_groups = K
            self.state = dataclasses.replace(
                self.state, l_matrix=self.state.l_matrix[0].expand(K, d, d).clone(),
                m_sum=torch.zeros((K, d), **kw), m_outer=torch.zeros((K, d, d), **kw),
                m_count=torch.zeros((K,), **kw), chees=torch.zeros((K, 4), **kw))
            self.config = dataclasses.replace(
                self.config, tempering_rungs=K, kernel="rwm", n_steps=int(n), auto=None,
                temperature=float(t_max if t_max is not None
                                  else max(self.config.temperature, 10.0)),
                tempering_betas=tuple(float(b) for b in betas) if betas is not None else ())
            self._swap_trace = []
            self._swap_betas = rung_betas(self.config)
            if auto_ladder:
                # A pilot on the starting ladder, without history, then the
                # rest on the ladder its swap rates give.
                chunk = self.config.chunk_size
                n_pilot = min(max(8 * chunk, int(n) // 5), max(chunk, int(n) // 2))
                n_pilot = max(2 * chunk, (n_pilot // chunk) * chunk)
                self.config = dataclasses.replace(self.config, n_steps=int(n_pilot))
                self._adaptive_loop(self.config, False, False)
                new_betas = respace_ladder(self._swap_betas,
                                           self.swap_rates()["pair_rates"])
                self._swap_trace = []
                self._swap_betas = new_betas
                if collect_history:
                    self.reset()
                self.config = dataclasses.replace(
                    self.config, n_steps=int(max(chunk, int(n) - n_pilot)),
                    tempering_betas=tuple(float(b) for b in new_betas))
            self._adaptive_loop(self.config, collect_history, False)
        finally:
            self.config = prev_config
            self.group_ids, self.n_groups = prev_groups
            # Collapse the group axis back: keep the cold rung's proposal,
            # and restore the trajectory state the rwm search never used.
            self.state = dataclasses.replace(
                self.state, l_matrix=self.state.l_matrix[:1],
                m_sum=torch.zeros((1, d), **kw), m_outer=torch.zeros((1, d, d), **kw),
                m_count=torch.zeros((1,), **kw), chees=prev_chees[:1].to(**kw))

    def swap_rates(self) -> dict:
        """Replica-exchange diagnostics of the last tempered run (JAX
        ``Walker.swap_rates``, fit.py:924-949): ``{"betas": (K,),
        "pair_rates": (K-1,), "min_rate", "ok"}``.  ``pair_rates[k]`` is
        the swap acceptance between rungs k and k+1 over the chunks where
        the pair was active; a pair near 0 is a gap in the ladder, near 1
        a wasted rung.  ``ok``: every pair above 0.05."""
        if not self._swap_trace or self._swap_betas is None:
            raise ValueError("swap_rates: no tempered run recorded — call "
                             "tempered_steps first")
        rates = np.nanmean(np.stack([_host(r).astype(np.float64)
                                     for r in self._swap_trace]), axis=0)
        return {"betas": self._swap_betas.copy(), "pair_rates": rates,
                "min_rate": float(np.nanmin(rates)),
                "ok": bool(np.nanmin(rates) > 0.05)}

    def log_evidence(self, n_steps: int = 20000, rungs: int = 16, t_max: float = 1e5,
                     **kwargs):
        """Marginal-likelihood estimate off the tempering ladder
        (:func:`evidence.log_evidence`; JAX ``Walker.log_evidence``,
        fit.py:951-966).  The box path leaves the ensemble spread over the
        ladder; the named-prior path runs on a u-space view."""
        from .evidence import log_evidence

        return log_evidence(self, n_steps=n_steps, rungs=rungs, t_max=t_max, **kwargs)

    def smc_sample(self, bounds=None, **kwargs):
        """Tempered SMC from the prior box (or a named ``prior=``) to the
        posterior (:func:`smc.smc_sample`; JAX ``Walker.smc_sample``,
        fit.py:968-975): an ``SMCResult`` with the evidence, the ensemble
        left posterior-distributed."""
        from .smc import smc_sample

        return smc_sample(self, bounds, **kwargs)

    def laplace_approx(self, *args, **kwargs):
        """Curvature covariance and the Laplace evidence at the best step
        (:func:`evidence.laplace_approx`)."""
        from .evidence import laplace_approx

        return laplace_approx(self, *args, **kwargs)

    def advi(self, *args, **kwargs):
        """Gaussian variational posterior and its importance-sampled
        evidence (:func:`variational.advi`; the evaluation draws on kernel 1
        on the GPU)."""
        from .variational import advi

        return advi(self, *args, **kwargs)

    def flow_advi(self, *args, **kwargs):
        """RealNVP normalizing-flow variational posterior, the curved-posterior
        upgrade of :meth:`advi` (:func:`variational.flow_advi`)."""
        from .variational import flow_advi

        return flow_advi(self, *args, **kwargs)

    # ------------------------------------------------ criticism and nested

    def posterior_predictive(self, *args, **kwargs):
        """Replicated datasets from the posterior history
        (:func:`predictive.posterior_predictive`)."""
        from .predictive import posterior_predictive

        return posterior_predictive(self, *args, **kwargs)

    def ppc_pvalue(self, *args, **kwargs):
        """Posterior predictive p-value of a data statistic
        (:func:`predictive.ppc_pvalue`)."""
        from .predictive import ppc_pvalue

        return ppc_pvalue(self, *args, **kwargs)

    def prior_predictive(self, *args, **kwargs):
        """Replicated datasets from the prior (:func:`predictive.prior_predictive`)."""
        from .predictive import prior_predictive

        return prior_predictive(self, *args, **kwargs)

    def predict(self, x, **kwargs):
        """Posterior curve band or prediction interval at new abscissae
        (:func:`predictive.predict`)."""
        from .predictive import predict

        return predict(self, x, **kwargs)

    def nested_sample(self, bounds=None, **kwargs):
        """Batched nested sampling, the evidence and posterior from one run
        (:func:`nested.nested_sample`; its refills on kernel 1 on the GPU)."""
        from .nested import nested_sample

        return nested_sample(self, bounds, **kwargs)

    def profile_likelihood(self, name: str, **kwargs):
        """Profile-likelihood interval of one parameter
        (:func:`profile.profile_likelihood`)."""
        from .profile import profile_likelihood

        return profile_likelihood(self, name, **kwargs)

    def prior_sensitivity(self, prior=None, **kwargs):
        """Power-scaling prior and likelihood sensitivity
        (:func:`diagnostics.prior_sensitivity`)."""
        from .diagnostics import prior_sensitivity

        return prior_sensitivity(self, prior=prior, **kwargs)

    def audit(self, **kwargs):
        """Convergence, LOO-PIT and prior sensitivity in one report card
        (:func:`diagnostics.audit`)."""
        from .diagnostics import audit

        return audit(self, **kwargs)

    def sampling_steps(self, n: int, kernel: str = "mala", **kwargs):
        """Cold sampling phase at T=1 with the given kernel (JAX
        ``Walker.sampling_steps``, fit.py:986-1017): after an anneal, draw
        posterior samples with ``kernel="mala"`` (the default: Langevin
        drift), ``"hmc"`` (leapfrog trajectories of ``hmc_leapfrog``
        steps), ``"chees"`` (HMC whose trajectory length adapts itself;
        see :meth:`chees_trajectory`), ``"stretch"`` (affine-invariant
        moves), ``"demc"`` (differential evolution), ``"slice"`` (ensemble
        slice sampling) or ``"rwm"``.  The gradient samplers differentiate
        the plain posterior by autograd.  ``auto`` defaults to None; other
        keywords go to :meth:`adaptive_steps`."""
        prev_config = self.config
        self.config = dataclasses.replace(self.config, kernel=kernel)
        try:
            self.adaptive_steps(n, temperature=1.0, auto=kwargs.pop("auto", None),
                                **kwargs)
        finally:
            self.config = prev_config

    def chees_trajectory(self) -> dict:
        """ChEES trajectory-length diagnostics (JAX
        ``Walker.chees_trajectory``, fit.py:903-922): ``{"leapfrog": (G,),
        "budget", "at_cap"}``, the adapted length t per group in leapfrog
        steps (a step integrates ``ceil(U(0,1) t)`` steps, t/2 gradient
        evaluations on average), ``chees_max_leapfrog``, and whether a
        group sits within 1 % of that cap.  Before any chees step t reads
        ``hmc_leapfrog``."""
        t_init = float(max(1, self.config.hmc_leapfrog))
        t = t_init * np.exp(_host(self.state.chees)[:, 0].astype(np.float64))
        budget = int(self.config.chees_max_leapfrog)
        return {"leapfrog": t, "budget": budget,
                "at_cap": bool(np.any(t >= 0.99 * budget))}

    # ------------------------------------------------------------- query verbs

    def _history(self, take: int | None = None):
        """Stacked host history: (T, W', d) positions, (T, W') logprobs."""
        if not self._hist_positions:
            pos = _host(self.state.position)[None]
            lp = _host(self.state.logprob)[None]
        else:
            pos = np.concatenate(self._hist_positions, axis=0)
            lp = np.concatenate(self._hist_logprobs, axis=0)
        if take is not None:
            k = max(1, int(take) // self._thin)
            pos, lp = pos[-k:], lp[-k:]
        return pos, lp

    def steps(self, take: int | None = None):
        """Flattened samples: ((T*W), d) params + (T*W,) logprobs (``:steps``)."""
        pos, lp = self._history(take)
        return pos.reshape(-1, self.ndim), lp.reshape(-1)

    def unique_steps(self, take: int | None = None, walker: int = 0):
        """One walker's steps without consecutive repeats (``:unique-steps``, 492)."""
        pos, lp = self._history(take)
        p, l = pos[:, walker], lp[:, walker]
        keep = np.ones(len(l), dtype=bool)
        keep[1:] = l[1:] != l[:-1]
        return p[keep]

    def forward_steps(self, take: int | None = None, walker: int = 0):
        """One walker's steps that raised its posterior (``:forward-steps``, 497-502)."""
        pos, lp = self._history(take)
        p, l = pos[:, walker], lp[:, walker]
        keep = np.zeros(len(l), dtype=bool)
        keep[1:] = l[1:] > l[:-1]
        keep[0] = True
        return p[keep]

    def check_for_nonfinite(self, take: int | None = None):
        """The history columns holding a non-finite position or posterior
        (``walker-check-for-complex-walks``, 483-485), or None."""
        pos, lp = self._history(take)
        bad = np.flatnonzero(~np.isfinite(pos).all(axis=(0, 2)) | ~np.isfinite(lp).all(axis=0))
        return bad.tolist() if bad.size else None

    def diagnose_params(self, params, aux_index: int = 0):
        """The posterior at given params (``walker-diagnose-params``,
        1200-1204).  With per-walker aux data (a batched fit),
        ``aux_index`` picks whose aux (which dataset) to probe with; without
        aux it is unused."""
        vec = self.spec.flatten(params, dtype=self.dtype, device=self.device)
        if self.aux is not None:
            return float(self._custom_log_post(vec, _aux_take(self.aux, aux_index),
                                               self._posterior_data()))
        return float(self._log_post(vec[None])[0])

    def summary(self, take: int | None = None) -> str:
        """Human-readable fit report (``diagnostics.summary``)."""
        from .diagnostics import summary

        return summary(self, take)

    def metrics(self, take: int | None = None,
                elapsed_seconds: float | None = None) -> dict:
        """Structured metrics snapshot (``diagnostics.metrics``)."""
        from .diagnostics import metrics

        return metrics(self, take, elapsed_seconds)

    def convergence(self, take: int | None = None, **kwargs) -> dict:
        """Vehtari-2021 convergence verdict (``diagnostics.convergence``)."""
        from .diagnostics import convergence

        return convergence(self, take, **kwargs)

    def best_params_vector(self):
        """Flat (d,) vector of the global best step's parameters."""
        return self.state.best_position[int(torch.argmax(self.state.best_logprob))]

    def most_likely_step(self):
        """Global best step over all walkers (``:most-likely-step``, 503)."""
        w = int(torch.argmax(self.state.best_logprob))
        return (float(self.state.best_logprob[w]),
                self.spec.make(_host(self.state.best_position[w]).tolist()))

    def most_likely_params(self) -> dict[str, float]:
        """``:most-likely-params`` (511-515)."""
        return self.most_likely_step()[1]

    def median_params_vector(self, take: int | None = None):
        """Flat (d,) per-parameter medians over the retained history."""
        pos, _ = self._history(take)
        return np.median(pos.reshape(-1, self.ndim), axis=0)

    def median_params(self, take: int | None = None) -> dict[str, float]:
        """Posterior median over retained history (``:median-params``, 516-523)."""
        return self.spec.make(self.median_params_vector(take).tolist())

    def mean_params(self, take: int | None = None) -> dict[str, float]:
        """Posterior mean of each parameter over retained history."""
        pos, _ = self._history(take)
        return self.spec.make(np.mean(pos.reshape(-1, self.ndim), axis=0).tolist())

    def acceptance(self, take: int | None = None) -> float:
        """Exact pooled acceptance rate over recent chunks (``:acceptance``, 506)."""
        if not self._accept_log:
            return 0.0
        k = max(1, (take or 1000) // self.config.chunk_size)
        return float(torch.stack(self._accept_log[-k:]).mean())

    def log_likelihoods(self, take: int | None = None, walker: int | None = None):
        """Logprob trace (``:log-liklihoods``, 540): (T, W) or (T,) for one walker."""
        _, lp = self._history(take)
        return lp if walker is None else lp[:, walker]

    def param_trace(self, name: str, take: int | None = None, walker: int = 0):
        """One parameter's trace for one walker (``:param``, 509)."""
        pos, _ = self._history(take)
        return pos[:, walker, self.spec.index(name)]

    def covariance_matrix(self, take: int | None = None):
        """Covariance of retained unique samples (``:covariance-matrix``, 541).

        Consecutive equal-prob steps are dropped per walker; the
        population normalisation /N of the reference (643).
        """
        pos, lp = self._history(take)                   # (T, W, d), (T, W)
        keep = np.ones(lp.shape, dtype=bool)
        keep[1:] = lp[1:] != lp[:-1]
        samples = pos[keep]                             # (K, d)
        centered = samples - samples.mean(axis=0, keepdims=True)
        return centered.T @ centered / max(1, samples.shape[0])

    def l_matrix_estimate(self, take: int | None = None):
        """Cholesky of the covariance of the forward steps' differences
        (``:l-matrix``, 543), clamped as the adaptation's refresh is."""
        pos, lp = self._history(take)
        fwd = np.zeros(lp.shape, dtype=bool)
        fwd[1:] = lp[1:] > lp[:-1]
        fwd[0] = True
        diffs = []
        for w in range(pos.shape[1]):
            f = pos[fwd[:, w], w]
            if len(f) > 1:
                diffs.append(np.diff(f, axis=0))
        if not diffs:
            return np.zeros((self.ndim, self.ndim))
        diffs = np.concatenate(diffs, axis=0)
        centered = diffs - diffs.mean(axis=0, keepdims=True)
        cov = centered.T @ centered / max(1, diffs.shape[0])
        chol, _ = cholesky_clamped(torch.as_tensor(cov))
        return chol.numpy()

    def stddev_params(self, take: int | None = None) -> dict[str, float]:
        """Per-parameter stddevs = diag of the history's L
        (``:stddev-params``, 525-539); zeros below 10 retained steps, as
        the reference (527-528)."""
        if len(self) < 10:
            return self.spec.make([0.0] * self.ndim)
        return self.spec.make(np.diag(self.l_matrix_estimate(take)).tolist())

    def with_expression(self, expr: str, take: int | None = 1000):
        """Derived quantity at the most-likely params (``walker-with-exp``)."""
        from .expressions import walker_with_expression

        return walker_with_expression(self, expr, take)

    # ---------------------------------------------------------- mutation verbs

    def reset(self):
        """Drop history, keep current position (``:reset``, 570-573)."""
        self._hist_positions.clear()
        self._hist_logprobs.clear()
        self._accept_log.clear()
        self._lpmax_trace.clear()
        self._lpmean_trace.clear()

    def reset_to_most_likely(self):
        """Restart every walker at the global best (``:reset-to-most-likely``, 574-578)."""
        w = int(torch.argmax(self.state.best_logprob))
        W = self.n_walkers
        self.state = dataclasses.replace(
            self.state,
            position=self.state.best_position[w].expand(W, self.ndim).clone(),
            logprob=self.state.best_logprob[w].expand(W).clone())
        self.reset()

    def add_steps(self, positions, logprobs):
        """Append outside history (``:add-walks``, 556-565): ``(T, W, d)``
        positions and ``(T, W)`` logprobs, or one walker's ``(T, d)`` and
        ``(T,)`` given to every walker.  Each walker's best point is
        refreshed from its own column's maximum, never a global one."""
        positions = np.asarray(positions)
        logprobs = np.asarray(logprobs)
        if positions.ndim == 2:
            positions = np.repeat(positions[:, None], self.n_walkers, axis=1)
            logprobs = np.repeat(logprobs[:, None], self.n_walkers, axis=1)
        self._hist_positions.append(positions)
        self._hist_logprobs.append(logprobs)
        st = self.state
        col_arg = logprobs.argmax(axis=0)
        kw = dict(dtype=self.dtype, device=self.device)
        col_best = torch.as_tensor(logprobs.max(axis=0), **kw)
        cand = torch.as_tensor(positions[col_arg, np.arange(positions.shape[1])], **kw)
        better = col_best > st.best_logprob
        self.state = dataclasses.replace(
            st, best_position=torch.where(better[:, None], cand, st.best_position),
            best_logprob=torch.where(better, col_best, st.best_logprob))

    def delete(self):
        """Free everything (``:delete``, 579-580)."""
        self.reset()
        self.terms = []
        self._runner_cache.clear()

    def burn_steps(self, burn_number: int):
        """Drop the oldest ``burn_number`` steps (``:burn-walks``, 566-567)."""
        if not self._hist_positions:
            return
        k = burn_number // self._thin
        pos, lp = self._history()
        pos, lp = pos[k:], lp[k:]
        self._hist_positions = [pos] if pos.size else []
        self._hist_logprobs = [lp] if lp.size else []

    def keep_steps(self, keep_number: int):
        """Keep only the newest ``keep_number`` steps (``:keep-walks``, 568-569)."""
        if not self._hist_positions:
            return
        k = max(1, keep_number // self._thin)
        pos, lp = self._history()
        self._hist_positions = [pos[-k:]]
        self._hist_logprobs = [lp[-k:]]


def respace_ladder(betas, pair_rates, floor: float = 0.05) -> np.ndarray:
    """Equalize the measured communication barrier over a tempering ladder
    (JAX ``fit.respace_ladder``, fit.py:1576-1606).

    Each adjacent pair's swap rejection ``1 - rate`` (at least ``floor``;
    a NaN rate counts as ``1 - floor``) is the barrier in its interval;
    the interior rungs move to equal barrier increments, interpolated in
    log-beta, with the endpoints fixed and the descent kept strict.
    """
    betas = np.asarray(betas, np.float64)
    rates = np.nan_to_num(np.asarray(pair_rates, np.float64), nan=1.0 - floor)
    if rates.shape != (betas.size - 1,):
        raise ValueError(f"respace_ladder: need {betas.size - 1} pair rates, "
                         f"got {rates.shape}")
    barrier = np.maximum(1.0 - rates, floor)
    lam = np.concatenate([[0.0], np.cumsum(barrier)])
    targets = np.linspace(0.0, lam[-1], betas.size)
    out = np.exp(np.interp(targets, lam, np.log(betas)))
    out[0], out[-1] = betas[0], betas[-1]
    for i in range(1, out.size):               # strict descent guard
        out[i] = min(out[i], out[i - 1] * (1.0 - 1e-9))
    return out


# ------------------------------------------------------------------ factories


def unit_cube_view(walker, prior_spec, seed: int = 0) -> Walker:
    """A u-space view of a fit, on which the declared prior is the unit
    cube (JAX ``fit.unit_cube_view``, fit.py:1608-1683).

    Every parameter is reparameterised through its prior's inverse CDF,
    ``theta = F^-1(u)``, so the declared prior is the Lebesgue measure on
    ``(0, 1)^d``.  The view's posterior is batched, built from the base
    walker's plain batched posterior (no vmap):

        ``logpost_u(u) = logpost(F^-1(u)) - installed(F^-1(u)) + wall(u)``

    ``installed`` the density term the prior adds (so ``exp(logpost_u) du
    = L(theta) pi(theta) dtheta`` inside the cube), ``wall`` the unit-rate
    exterior penalty (``priors.unit_cube_wall``).  The u-ensemble starts
    at the CDF image of the walker's ensemble, clamped off the faces by
    the type's eps.  The view shares the walker's datasets, config (on
    the plain path, as every custom posterior), dtype, device, groups and
    per-walker aux (JAX fit.py:1647-1673): it takes any batch where the
    walker's posterior does, needs the whole ensemble where the walker's
    does, and evaluates a subset of slots with their own aux where the
    walker's reads aux.  Stepping it never touches the walker.  It carries
    ``_unit_cube_spec`` and ``_theta_of_u`` (``(W, d)`` u to theta).
    """
    spec = as_prior_spec(prior_spec)
    keys = walker.spec.keys
    missing = [k for k in keys if k not in spec]
    if missing:
        raise ValueError(f"unit_cube_view: prior spec missing {missing}")
    base = walker._log_post

    def theta_of_u(u):
        return spec.transform(u, keys)

    def shift(u, th):
        return -spec.installed_vec(th, keys) + unit_cube_wall(u)

    def batched_u(u, data=None):
        th = theta_of_u(u)
        return base(th) + shift(u, th)

    eps = 1e-12 if walker.dtype == torch.float64 else 1e-6
    u0 = np.clip(_host(spec.inverse(walker.state.position, keys)).astype(np.float64),
                 eps, 1.0 - eps)
    uw = Walker([], walker.spec, u0, seed=seed,
                config=dataclasses.replace(walker.config, posterior_impl="plain"),
                dtype=walker.dtype, device=walker.device, group_ids=walker.group_ids,
                n_groups=walker.n_groups, batched_log_posterior=batched_u,
                posterior_data=walker._posterior_data())
    uw.aux = walker.aux
    uw._whole_batch = walker._whole_batch
    base_rows = walker._rows_post
    if base_rows is not None:
        def rows_u(u, rows):
            th = theta_of_u(u)
            return base_rows(th, rows) + shift(u, th)
        uw._rows_post = rows_u
    uw._unit_cube_spec = spec
    uw._theta_of_u = theta_of_u
    return uw



def walker_create(*, function, data, params, data_error=None, log_likelihood=None,
                  log_prior=None, n_walkers: int = 1, seed: int = 0,
                  walker_jitter: float = 0.0, config: FitConfig | None = None,
                  dtype=None, device=None) -> Walker:
    """Create a fit (``walker-create``, mcmc-fitting.lisp:1132-1163).

    ``function``: model ``f(x, params)`` or a list of models for global
    multi-dataset fits.  ``data``: ``(x, y)`` or a list of such pairs.
    ``data_error``: scalar, per-dataset scalars, or per-point arrays.
    ``log_likelihood`` / ``log_prior``: callables or per-dataset lists;
    data-dependent factories are resolved once (837-845).  A
    ``priors.PriorSpec`` or ``MVGaussian`` is taken anywhere a prior is,
    as its ``as_log_prior()``.  ``dtype`` defaults to float32;
    ``device=None`` means the GPU.
    """
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    functions = _force_list(function)
    cleaned = clean_data(data, len(functions))
    errors = clean_data_error(data_error, cleaned)
    if isinstance(log_likelihood, (list, tuple)):
        likelihoods = [ll or log_likelihood_normal for ll in log_likelihood]
    else:
        likelihoods = [log_likelihood or log_likelihood_normal] * len(functions)
    def coerce(lp):
        return lp.as_log_prior() if hasattr(lp, "as_log_prior") else lp

    if isinstance(log_prior, (list, tuple)):
        priors = [coerce(lp) or log_prior_flat for lp in log_prior]
    else:
        priors = [coerce(log_prior) or log_prior_flat] * len(functions)
    if not (len(functions) == len(cleaned) == len(likelihoods) == len(priors)):
        raise ValueError("walker_create: function/data/likelihood/prior counts must match")

    spec, vec = normalize_params(params, dtype=dtype, device=device)
    params_dict = spec.unflatten(vec)
    terms = []
    for fn, (x, y), err, ll, lp in zip(functions, cleaned, errors, likelihoods, priors):
        ds = Dataset.create(x, y, err, dtype=dtype, device=device)
        ll = resolve_likelihood(ll, fn, params_dict, ds)
        lp = resolve_prior(lp, params_dict, ds)
        terms.append(_Term(fn=fn, dataset=ds, likelihood=ll, prior=lp))
    return Walker(terms, spec, _host(vec), n_walkers=n_walkers, seed=seed,
                  walker_jitter=walker_jitter, config=config, dtype=dtype,
                  device=device)


def mcmc_fit(*, function, data, params, data_error=None, log_likelihood=None,
             log_prior=None, n_steps: int | None = None, n_walkers: int = 1,
             seed: int = 0, walker_jitter: float = 0.0,
             config: FitConfig | None = None, dtype=None, device=None) -> Walker:
    """Create a walker and run adaptive steps (``mcmc-fit``, 1165-1176)."""
    walker = walker_create(
        function=function, data=data, params=params, data_error=data_error,
        log_likelihood=log_likelihood, log_prior=log_prior,
        n_walkers=n_walkers, seed=seed, walker_jitter=walker_jitter,
        config=config, dtype=dtype, device=device)
    walker.adaptive_steps(n_steps)
    return walker
