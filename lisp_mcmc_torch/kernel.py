"""The adaptive Metropolis-Hastings kernel: chunks of rwm steps + adaptation.

Port of the rwm slice of ``lisp_mcmc_tpu/kernel.py``, the reference's hot
loop (mcmc-fitting.lisp):
  - ``walker-take-step`` (1072-1095): propose ``x + L z``, accept iff
    ``prob1 > prob0`` or ``(prob1-prob0)/T > log U(0,1)`` (1091-1092);
  - ``walker-pretend-take-step`` (1097-1122): the greedy variant;
  - ``walker-adaptive-steps-full`` (862-942): cosine-oscillating annealing
    (877-878), L adaptation every 200 steps with the 0.2-0.4 band and
    x0.1 / x1.9 rescales, covariance refresh with the Haario ``2.38^2/d``
    factor applied to L (888-895).

The ensemble is a ``(W, d)`` batch; a chunk is a Python loop over
``chunk_size`` steps of tensor operations (where the JAX package scans),
or one launch of the whole-chunk kernel (``ops/chunk_kernel.py``).
Adaptation happens at the chunk boundary.  Nothing in a chunk waits for
the device: the temperature and the step counters are host numbers, the
flags are Python booleans and every data-dependent choice is a ``where``.

This slice covers ``kernel="rwm"`` with one adaptation group, no
tempering and no blocked proposals; those raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from .ops.chunk_kernel import chunk_rwm
from .ops.linalg import cholesky_clamped, haario_scale, moments_covariance

__all__ = ["FitConfig", "WalkerState", "init_state", "temperature_schedule",
           "build_chunk_runner", "resolve_accept_band", "POSTERIOR_IMPLS"]

# "plain" is the JAX package's "xla", "kernel" its "pallas" and
# "chunk_kernel" its "pallas_chunk".
POSTERIOR_IMPLS = ("auto", "plain", "kernel", "chunk_kernel")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """All adaptation knobs, with the reference's exact defaults.

    The fields are the JAX package's ``FitConfig``; see its comments for
    each.  This slice runs ``kernel="rwm"`` ungrouped; other samplers,
    tempering and blocked proposals raise ``NotImplementedError`` when a
    chunk runner is built.  ``prng_impl`` is kept for config parity and
    not read: the port draws from a ``torch.Generator``.
    """

    n_steps: int = 30000                 # walker-adaptive-steps default (946)
    temperature: float = 10.0            # wrapper default (947)
    chunk_size: int = 200                # adaptation cadence (929-931)
    accept_low: float = 0.2              # acceptance band (934)
    accept_high: float = 0.4
    scale_down: float = 0.1              # L rescale factors (940-942)
    scale_up: float = 1.9
    refresh_damping: float = 1.0         # g in (0, 1]: refresh blends (1-g) L + g cand,
                                         # rescales become scale^g; 1.0 = the reference
    temp_period: int = 5000              # annealing divisor (878)
    settle_multiplier: int = 10          # steps-to-settle = 10*max(50, d) (873)
    settle_floor: int = 50
    kernel: str = "rwm"
    stretch_a: float = 2.0
    demc_gamma: float = 0.0
    demc_jitter: float = 0.1
    demc_jump_prob: float = 0.1
    slice_mu: float = 1.0
    slice_max_expand: int = 4
    slice_max_shrink: int = 32
    hmc_leapfrog: int = 8
    hmc_jitter: bool = True
    chees_max_leapfrog: int = 64
    chees_lr: float = 0.025
    rescue: bool = True
    tempering_rungs: int = 0
    tempering_betas: tuple = ()
    auto: str | None = "prob-settle"     # prob-settle | slope-settle | rhat | rank-rhat | None
    sampling_optimization: str = "covariance"  # "covariance" | "best-value" (888-895)
    refresh_every: int = 0               # in-band refresh cadence in steps; 0 = every chunk
    max_history: int = 30000             # max-walker-length analogue (923-927)
    max_history_bytes: int = 2 << 30     # byte cap on host history
    history_walkers: int = 4096          # host history keeps this many walkers
                                         # (evenly spaced, sliced on the device); 0 = all
    thin: int = 10                       # history thinning
    greedy: bool = False                 # pretend-take-step accept rule (1117)
    pooled_covariance: bool = True
    covariance_source: str = "moves"     # "moves" (reference policy)
    jitter: float = 0.0                  # optional diagonal jitter on refresh
    posterior_impl: str = "auto"         # "auto" | "plain" | "kernel" (fused posterior,
                                         # ops/loglik_kernel.py) | "chunk_kernel" (whole-chunk
                                         # stepper, ops/chunk_kernel.py, for non-history
                                         # chunks of f32 fits)
    prng_impl: str = "rbg"
    block_hyper: int = 0
    block_local: int = 0
    block_count: int = 0

    def __post_init__(self):
        if not isinstance(self.tempering_betas, tuple):
            object.__setattr__(self, "tempering_betas",
                               tuple(self.tempering_betas))
        if self.kernel not in ("rwm", "stretch", "demc", "mala", "hmc",
                               "slice", "chees"):
            raise ValueError(
                f"kernel must be one of rwm/stretch/demc/mala/hmc/slice/"
                f"chees, got {self.kernel!r}")
        if self.posterior_impl not in POSTERIOR_IMPLS:
            raise ValueError(
                f"posterior_impl must be one of {POSTERIOR_IMPLS} (the JAX "
                f"names xla/pallas/pallas_chunk are plain/kernel/"
                f"chunk_kernel here), got {self.posterior_impl!r}")

    def steps_to_settle(self, ndim: int) -> int:
        return self.settle_multiplier * max(self.settle_floor, ndim)

    def temp_steps(self, ndim: int) -> int:
        # temp-steps = max(n, 10*steps-to-settle) (875)
        return max(self.n_steps, 10 * self.steps_to_settle(ndim))


@dataclasses.dataclass
class WalkerState:
    """Ensemble chain state (the reference's ``walker`` struct, 467-479).

    ``W`` walkers, ``d`` parameters, ``G`` adaptation groups (1 here).
    The step counters are host integers; the random stream is the
    ``torch.Generator`` the caller passes to the runner.
    """

    position: Any          # (W, d) current params
    logprob: Any           # (W,) current log-posterior
    best_position: Any     # (W, d) per-walker most-likely params (503-505)
    best_logprob: Any      # (W,)
    l_matrix: Any          # (G, d, d) per-group proposal factor
    m_sum: Any             # (G, d)  accepted-move moment sums
    m_outer: Any           # (G, d, d)
    m_count: Any           # (G,)   accepted moves per group
    age: int = 0           # lifetime steps (walker-age, 473)
    anneal_step: int = 0   # per-run annealing index (reference's i, 919)


def init_state(position, logprob, l_matrix, n_groups: int = 1) -> WalkerState:
    """Build the initial ensemble state (``walker-create``'s first step).

    ``l_matrix`` may be (d, d) (broadcast to all groups) or (G, d, d).
    """
    W, d = position.shape
    kw = dict(dtype=position.dtype, device=position.device)
    l_matrix = torch.as_tensor(l_matrix, **kw)
    if l_matrix.ndim == 2:
        l_matrix = l_matrix.expand(n_groups, d, d).clone()
    return WalkerState(
        position=position,
        logprob=logprob,
        best_position=position,
        best_logprob=logprob,
        l_matrix=l_matrix,
        m_sum=torch.zeros((n_groups, d), **kw),
        m_outer=torch.zeros((n_groups, d, d), **kw),
        m_count=torch.zeros((n_groups,), **kw),
    )


def temperature_schedule(i, ndim: int, config: FitConfig):
    """The cosine-oscillating annealing temperature (mcmc-fitting.lisp:878).

    ``temps[i] = max(1, cos(i * pi * (1 + 2*floor(TS/5000)) / (2*TS)) * T)``
    for ``i < TS`` (TS = temp-steps); 1 afterwards.  ``i``: int or tensor
    of step indices; returns float64.
    """
    i = torch.as_tensor(i, dtype=torch.float64)
    ts = config.temp_steps(ndim)
    mult = 1 + 2 * (ts // config.temp_period)
    phase = i * math.pi * mult / (2.0 * ts)
    t = torch.clamp_min(torch.cos(phase) * config.temperature, 1.0)
    return torch.where(i < ts, t, 1.0)


def _neg_floor(dtype) -> float:
    """Large-negative stand-in for -inf that keeps (lp1-lp0)/T finite."""
    return torch.finfo(dtype).min / 4


def resolve_accept_band(config: FitConfig) -> tuple[float, float]:
    """The adaptation acceptance band for the configured kernel
    (kernel.py:330-346 of the JAX package; rwm keeps 0.2-0.4)."""
    low, high = config.accept_low, config.accept_high
    if not config.greedy and (low, high) == (0.2, 0.4):
        if config.kernel == "mala":
            return 0.45, 0.7
        if config.kernel in ("hmc", "chees"):
            return 0.55, 0.85
    return low, high


def _check_scope(config: FitConfig) -> None:
    if config.kernel != "rwm":
        raise NotImplementedError(
            f"kernel={config.kernel!r}: this port runs the rwm sampler only")
    if config.tempering_rungs > 1:
        raise NotImplementedError("parallel tempering is not ported yet")
    if config.block_count > 0:
        raise NotImplementedError("blocked proposals are not ported yet")
    if config.covariance_source != "moves":
        raise NotImplementedError(
            f"covariance_source={config.covariance_source!r}: only 'moves' "
            "is ported")
    if config.sampling_optimization not in ("covariance", "best-value"):
        raise ValueError(f"unknown sampling_optimization "
                         f"{config.sampling_optimization!r}")


def build_chunk_runner(eval_lp: Callable, ndim: int, config: FitConfig,
                       chunk_kernel=None):
    """The chunk runners for a batched posterior ``eval_lp((W, d)) -> (W,)``.

    Returns ``(run, run_with_history)``; each maps ``(state, adapt_enabled,
    allow_refresh, force_cold=False, *, generator=None, noise=None)`` to
    ``(state, out)``.  ``force_cold`` True pins T=1 (the cold finish); a
    float > 0 pins that temperature.  Draws come from ``generator``, or
    from ``noise = (z (chunk, W, d), u (chunk, W))`` when given (the
    injected-draw path the parity tests use).  ``chunk_kernel``: a built
    ``ops.chunk_kernel.ChunkKernel`` that ``run`` uses for the whole chunk.
    """
    _check_scope(config)
    chunk = config.chunk_size
    thin = max(1, min(config.thin, chunk))
    accept_low, accept_high = resolve_accept_band(config)

    def _apply_step(state, proposal, lp_prop, step_vec, accept):
        """Accept/update tail: position, moment sums, best tracking."""
        dtype = state.position.dtype
        acc = accept[:, None]
        accf = accept.to(dtype)
        new_position = torch.where(acc, proposal, state.position)
        new_logprob = torch.where(accept, lp_prop, state.logprob)
        # Accepted-move moments for covariance adaptation (one group).
        delta = step_vec * acc.to(dtype)
        m_sum = state.m_sum + delta.sum(dim=0)[None]
        m_outer = state.m_outer + torch.einsum("wi,wj->ij", delta, delta)[None]
        m_count = state.m_count + accf.sum()[None]
        # Most-likely-step tracking (553-555), per walker.
        better = new_logprob > state.best_logprob
        best_position = torch.where(better[:, None], new_position,
                                    state.best_position)
        best_logprob = torch.where(better, new_logprob, state.best_logprob)
        new_state = WalkerState(
            position=new_position, logprob=new_logprob,
            best_position=best_position, best_logprob=best_logprob,
            l_matrix=state.l_matrix, m_sum=m_sum, m_outer=m_outer,
            m_count=m_count, age=state.age + 1,
            anneal_step=state.anneal_step + 1)
        trace = torch.stack([new_logprob.max(), new_logprob.mean(),
                             new_logprob.min()])
        return new_state, accf, trace

    def resolve_temp(force_cold, state):
        """``force_cold`` True (== 1.0) pins T=1, a float > 0 pins that
        temperature, False follows the annealing schedule indexed by the
        per-run counter (mcmc-fitting.lisp:902, 919-921)."""
        tover = float(force_cold)
        if tover > 0:
            return tover
        return float(temperature_schedule(state.anneal_step, ndim, config))

    def one_step(state, i, force_cold, generator, noise):
        W, d = state.position.shape
        kw = dict(dtype=state.position.dtype, device=state.position.device)
        temp = resolve_temp(force_cold, state)
        if noise is None:
            z = torch.randn((W, d), generator=generator, **kw)
            u = torch.rand((W,), generator=generator, **kw)
        else:
            z, u = noise[0][i], noise[1][i]
        step_vec = z @ state.l_matrix[0].T
        proposal = state.position + step_vec
        lp_prop = eval_lp(proposal)
        # NaN/Inf guard (the walker-check-for-complex-walks analogue, 483):
        # a non-finite posterior is a hard reject.
        lp_prop = torch.where(torch.isfinite(lp_prop), lp_prop,
                              _neg_floor(lp_prop.dtype))
        log_u = torch.log(u)
        if config.greedy:
            accept = lp_prop > state.logprob               # (1117-1119)
        else:
            accept = ((lp_prop > state.logprob)            # (1091-1092)
                      | ((lp_prop - state.logprob) / temp > log_u))
        return _apply_step(state, proposal, lp_prop, step_vec, accept)

    def adapt(state: WalkerState, group_accept, allow_refresh: bool):
        """Chunk-boundary L update (mcmc-fitting.lisp:929-942), batched over
        adaptation groups with ``where`` masks."""
        dtype = state.position.dtype
        d = ndim
        g = float(config.refresh_damping)
        in_band = (accept_low < group_accept) & (group_accept < accept_high)
        too_low = group_accept <= accept_low
        l_rescaled = torch.where(too_low[:, None, None],
                                 (config.scale_down ** g) * state.l_matrix,
                                 (config.scale_up ** g) * state.l_matrix)
        if config.sampling_optimization == "best-value":
            # 1e-5 x diag of the global best parameters' magnitudes (888-895).
            w = torch.argmax(state.best_logprob)
            mags = torch.abs(state.best_position[w])
            mags = torch.where(mags > 0, mags, 1e-3)
            candidate = (1e-5 * torch.diag(mags))[None].to(dtype)
            blended = (1.0 - g) * state.l_matrix + g * candidate if g < 1.0 else candidate
            l_refreshed = blended if allow_refresh else state.l_matrix
            new_l = torch.where(in_band[:, None, None], l_refreshed, l_rescaled)
            return dataclasses.replace(state, l_matrix=new_l.to(dtype))

        cov = moments_covariance(state.m_sum, state.m_outer, state.m_count)
        enough = state.m_count > d
        if config.jitter > 0:
            cov = cov + config.jitter * torch.eye(d, dtype=dtype, device=cov.device)
        chol, ok = cholesky_clamped(cov)                            # (G,d,d), (G,)
        # The reference scales the L-matrix by 2.38^2/d (890).
        candidate = haario_scale(d) * chol
        refresh_ok = ok & enough & allow_refresh                    # (G,)
        blended = (1.0 - g) * state.l_matrix + g * candidate if g < 1.0 else candidate
        l_refreshed = torch.where(refresh_ok[:, None, None], blended, state.l_matrix)
        new_l = torch.where(in_band[:, None, None], l_refreshed, l_rescaled)
        # Reset move moments after a refresh so the window stays recent.
        reset = refresh_ok & in_band
        return dataclasses.replace(
            state,
            l_matrix=new_l.to(dtype),
            m_sum=torch.where(reset[:, None], 0.0, state.m_sum),
            m_outer=torch.where(reset[:, None, None], 0.0, state.m_outer),
            m_count=torch.where(reset, 0.0, state.m_count),
        )

    def _finish(state, accept_counts, trace, adapt_enabled, allow_refresh):
        W = accept_counts.shape[0]
        group_accept = accept_counts.sum()[None] / max(W * chunk, 1)   # (G,)
        if adapt_enabled:
            state = adapt(state, group_accept, bool(allow_refresh))
        else:
            # Adaptation off (many_steps): zero the move moments so fixed-L
            # displacements never poison a later refresh.
            state = dataclasses.replace(
                state, m_sum=torch.zeros_like(state.m_sum),
                m_outer=torch.zeros_like(state.m_outer),
                m_count=torch.zeros_like(state.m_count))
        out = {
            "logprob_max": trace[:, 0],          # (chunk,)
            "logprob_mean": trace[:, 1],
            "logprob_min": trace[:, 2],
            "accept_rate": accept_counts.mean() / chunk,    # () pooled
            "group_accept": group_accept,                   # (G,)
        }
        return state, out

    def _seed(state, generator):
        """A fresh per-chunk key for the chunk kernel, drawn on the device."""
        return torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int32, device=state.position.device)

    def run(state: WalkerState, adapt_enabled=True, allow_refresh=True,
            force_cold=False, *, generator=None, noise=None):
        """One chunk: ``chunk_size`` MH steps + one adaptation update."""
        if chunk_kernel is not None and noise is None:
            dtype = state.position.dtype
            res = chunk_rwm(chunk_kernel, state.position, state.logprob,
                            state.best_position, state.best_logprob,
                            state.l_matrix[0], state.anneal_step,
                            float(force_cold), _seed(state, generator))
            state = WalkerState(
                position=res["position"].to(dtype),
                logprob=res["logprob"].to(dtype),
                best_position=res["best_position"].to(dtype),
                best_logprob=res["best_logprob"].to(dtype),
                l_matrix=state.l_matrix,
                m_sum=state.m_sum + res["m_sum"][None].to(dtype),
                m_outer=state.m_outer + res["m_outer"][None].to(dtype),
                m_count=state.m_count + res["m_count"][None].to(dtype),
                age=state.age + chunk,
                anneal_step=state.anneal_step + chunk)
            trace = torch.stack([res["trace_max"], res["trace_mean"],
                                 res["trace_min"]], dim=1).to(dtype)
            return _finish(state, res["accept_counts"].to(dtype), trace,
                           adapt_enabled, allow_refresh)
        accept_counts = torch.zeros_like(state.logprob)
        traces = []
        for i in range(chunk):
            state, accf, tr = one_step(state, i, force_cold, generator, noise)
            accept_counts = accept_counts + accf
            traces.append(tr)
        return _finish(state, accept_counts, torch.stack(traces),
                       adapt_enabled, allow_refresh)

    def run_with_history(state: WalkerState, adapt_enabled=True,
                         allow_refresh=True, force_cold=False, *,
                         generator=None, noise=None):
        """``run`` that also returns the positions and logprobs after every
        ``thin``-th step: ``(chunk//thin, W, d)`` and ``(chunk//thin, W)``."""
        accept_counts = torch.zeros_like(state.logprob)
        traces, positions, logprobs = [], [], []
        for i in range(chunk):
            state, accf, tr = one_step(state, i, force_cold, generator, noise)
            accept_counts = accept_counts + accf
            traces.append(tr)
            if (i + 1) % thin == 0:
                positions.append(state.position)
                logprobs.append(state.logprob)
        state, out = _finish(state, accept_counts, torch.stack(traces),
                             adapt_enabled, allow_refresh)
        out["positions"] = torch.stack(positions)
        out["logprobs"] = torch.stack(logprobs)
        return state, out

    return run, run_with_history
