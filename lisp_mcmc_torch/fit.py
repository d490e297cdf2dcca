"""High-level fitting API: Walker facade, adaptive loop, mcmc_fit.

Port of the main path of ``lisp_mcmc_tpu/fit.py``, the reference's L4
layer (mcmc-fitting.lisp):
  - ``walker-create`` (1132-1163): normalize fn/data/error/likelihood/prior
    to parallel lists, resolve data-dependent closures, evaluate the first
    step;
  - ``walker-adaptive-steps[-full]`` (862-947): the adaptive loop, split
    at the host/device boundary: each 200-step chunk is enqueued on the
    device (``kernel.py``), and the host loop handles auto-stop, estop,
    history capture and the cold finish between chunks;
  - ``walker-many-steps`` (849-853): fixed-L stepping;
  - ``walker-get`` / ``walker-modify`` (487-580): query and mutation verbs;
  - ``mcmc-fit`` (1165-1176): create + adaptive steps.

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
from .kernel import (FitConfig, _neg_floor, build_chunk_runner, init_state,
                     resolve_accept_band)
from .likelihoods import log_likelihood_normal, resolve_likelihood
from .ops.chunk_kernel import build_chunk_kernel
from .ops.loglik_kernel import build_fused_posterior, kernel_coverage
from .params import ParamSpec, normalize_params
from .priors import log_prior_flat, resolve_prior

__all__ = ["Walker", "walker_create", "mcmc_fit"]


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
    ``most_likely_step``, ``most_likely_params``, ``acceptance``,
    ``steps``.  Mutation verbs (``walker-modify``, 547-580): ``reset``,
    ``burn_steps``, ``keep_steps``.
    """

    def __init__(self, terms: list[_Term], spec: ParamSpec, initial_vector, *,
                 n_walkers: int = 1, seed: int = 0, walker_jitter: float = 0.0,
                 config: FitConfig | None = None, dtype=None, device=None,
                 aux=None, group_ids=None, n_groups: int = 1):
        if aux is not None or group_ids is not None or n_groups != 1:
            raise NotImplementedError(
                "per-walker aux data and adaptation groups are not ported yet")
        self.device = resolve_device(device)
        self.terms = terms
        self.spec = spec
        self.config = config or FitConfig()
        self.dtype = dtype or torch.float32
        self.n_walkers = int(n_walkers)
        self._runner_cache: dict[Any, Any] = {}
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
        if walker_jitter > 0:
            noise = torch.randn(position.shape, generator=self.generator, **kw)
            position = position * (1.0 + walker_jitter * noise)

        self._log_post = self._build_log_posterior()
        logprob = self._eval_batch(position)
        l0 = self._initial_l_matrix(vec)
        self.state = init_state(position, logprob, l0)

        # Host-side thinned history (the walker's "walk", 471).
        self._hist_positions: list[np.ndarray] = []  # each (K, W', d)
        self._hist_logprobs: list[np.ndarray] = []   # each (K, W')
        # Chunk logs hold DEVICE values, converted when read, so recording
        # a chunk never waits for the device.
        self._accept_log: list = []
        self._lpmax_trace: list = []
        self._lpmean_trace: list = []

    # ------------------------------------------------------------------ build

    def _build_log_posterior(self):
        """Batched posterior ``positions (W, d) -> (W,)``, plain PyTorch.

        Likelihoods see ``(W, 1)`` parameter columns (so the model gives
        ``(W, P)``); priors see ``(W,)`` columns.
        """
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
        """The per-step posterior: the fused kernel or the plain version.

        ``"auto"`` takes the kernel on CUDA when the fit is inside its
        coverage (``ops.loglik_kernel.kernel_coverage``) and the plain path
        otherwise; ``"kernel"`` and ``"chunk_kernel"`` require the
        coverage and raise outside it.  A kernel that fails to build or
        launch raises.
        """
        impl = self.config.posterior_impl
        if impl == "plain":
            return self._log_post
        reason = kernel_coverage(self.terms, self.spec)
        if impl == "auto" and (reason is not None or self.device.type != "cuda"):
            return self._log_post
        if reason is not None:
            raise ValueError(f"posterior_impl={impl!r}: the fit is outside "
                             f"the fused kernel's coverage: {reason}")
        return self._fused_posterior_probed(impl)

    def _fused_posterior_probed(self, impl_name: str):
        """Build the fused posterior, verified against the plain one.

        The equivalence probe at the current ensemble catches a kernel
        that computes another posterior than the plain path (relative
        1e-4); it raises rather than run the wrong kernel.
        """
        fused = self._runner_cache.get("_fused")
        if fused is not None:
            return fused
        fused = build_fused_posterior(self.terms, self.spec, self.dtype)
        if fused is None:
            raise ValueError(f"posterior_impl={impl_name!r}: the fit is "
                             "outside the fused kernel's coverage")
        ref = _host(self._eval_batch(self.state.position)).astype(np.float64)
        got = _host(fused(self.state.position)).astype(np.float64)
        finite = np.isfinite(ref) & np.isfinite(got)
        scale = np.maximum(np.abs(ref[finite]), 1.0)
        if finite.any() and np.max(np.abs(ref[finite] - got[finite]) / scale) > 1e-4:
            raise ValueError(
                f"posterior_impl={impl_name!r}: the fused kernel disagrees "
                "with the plain posterior at the current ensemble")
        self._runner_cache["_fused"] = fused
        return fused

    def _runner(self, greedy: bool = False, with_history: bool = True):
        cfg = dataclasses.replace(self.config, greedy=greedy)
        cache_key = (cfg, with_history)
        if cache_key not in self._runner_cache:
            chunk = None
            if cfg.posterior_impl == "chunk_kernel" and not with_history:
                # Non-history chunks run as one kernel launch each; history
                # chunks keep the per-step path.  The probe gates it too.
                self._fused_posterior_probed("chunk_kernel")
                chunk = build_chunk_kernel(self.terms, self.spec, cfg,
                                           self.n_walkers, self.dtype)
                if chunk is None:
                    raise ValueError(
                        "posterior_impl='chunk_kernel' needs a float32 rwm fit "
                        "with d <= 8 and a walker count that is a multiple of "
                        f"128 (got {self.dtype}, d={self.ndim}, "
                        f"W={self.n_walkers})")
            run, run_hist = build_chunk_runner(
                self._batched_posterior(), self.spec.ndim, cfg,
                chunk_kernel=chunk)
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
        # Each adaptive run gets a fresh annealing clock (919-921).
        self.state = dataclasses.replace(self.state, anneal_step=0)
        settle = cfg.steps_to_settle(self.ndim)
        chunk = cfg.chunk_size
        n_chunks = max(1, math.ceil(cfg.n_steps / chunk))
        shutdown_chunks = max(1, math.ceil(max(2000, settle) / chunk))
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
        # Only the last few settle windows are ever read.
        max_trace_chunks = max(
            1, 4 * max(self.config.steps_to_settle(self.ndim), 2500)
            // self.config.chunk_size)
        if len(self._lpmax_trace) > 2 * max_trace_chunks:
            del self._lpmax_trace[:-max_trace_chunks]
            del self._lpmean_trace[:-max_trace_chunks]
            del self._accept_log[:-max_trace_chunks]
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
            l = l[None]
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

    def acceptance(self, take: int | None = None) -> float:
        """Exact pooled acceptance rate over recent chunks (``:acceptance``, 506)."""
        if not self._accept_log:
            return 0.0
        k = max(1, (take or 1000) // self.config.chunk_size)
        return float(torch.stack(self._accept_log[-k:]).mean())

    # ---------------------------------------------------------- mutation verbs

    def reset(self):
        """Drop history, keep current position (``:reset``, 570-573)."""
        self._hist_positions.clear()
        self._hist_logprobs.clear()
        self._accept_log.clear()
        self._lpmax_trace.clear()
        self._lpmean_trace.clear()

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


# ------------------------------------------------------------------ factories


def walker_create(*, function, data, params, data_error=None, log_likelihood=None,
                  log_prior=None, n_walkers: int = 1, seed: int = 0,
                  walker_jitter: float = 0.0, config: FitConfig | None = None,
                  dtype=None, device=None) -> Walker:
    """Create a fit (``walker-create``, mcmc-fitting.lisp:1132-1163).

    ``function``: model ``f(x, params)`` or a list of models for global
    multi-dataset fits.  ``data``: ``(x, y)`` or a list of such pairs.
    ``data_error``: scalar, per-dataset scalars, or per-point arrays.
    ``log_likelihood`` / ``log_prior``: callables or per-dataset lists;
    data-dependent factories are resolved once (837-845).  ``dtype``
    defaults to float32; ``device=None`` means the GPU.
    """
    device = resolve_device(device)
    dtype = dtype or torch.float32
    functions = _force_list(function)
    cleaned = clean_data(data, len(functions))
    errors = clean_data_error(data_error, cleaned)
    if isinstance(log_likelihood, (list, tuple)):
        likelihoods = [ll or log_likelihood_normal for ll in log_likelihood]
    else:
        likelihoods = [log_likelihood or log_likelihood_normal] * len(functions)
    if isinstance(log_prior, (list, tuple)):
        priors = [lp or log_prior_flat for lp in log_prior]
    else:
        priors = [log_prior or log_prior_flat] * len(functions)
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
