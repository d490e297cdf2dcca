"""The adaptive sampler kernels: chunks of steps + adaptation.

Port of the gradient-free part of ``lisp_mcmc_tpu/kernel.py``, the
reference's hot loop (mcmc-fitting.lisp):
  - ``walker-take-step`` (1072-1095): propose ``x + L z``, accept iff
    ``prob1 > prob0`` or ``(prob1-prob0)/T > log U(0,1)`` (1091-1092);
  - ``walker-pretend-take-step`` (1097-1122): the greedy variant;
  - ``walker-adaptive-steps-full`` (862-942): cosine-oscillating annealing
    (877-878), L adaptation every 200 steps with the 0.2-0.4 band and
    x0.1 / x1.9 rescales, covariance refresh with the Haario ``2.38^2/d``
    factor applied to L (888-895);
and the JAX package's own additions: adaptation groups (each with its L,
moments and acceptance window; contiguous equal blocks as reshapes,
irregular ``group_ids`` by ``index_add_`` and gathers), the
``covariance_source="ensemble"`` refresh, parallel tempering (a rung per
group, replica swaps at chunk ends), the three red-black ensemble
samplers ``stretch``, ``demc`` and ``slice``, whose half-ensembles go
through the walker's batched posterior (the fused kernel on the GPU),
the gradient samplers ``mala``, ``hmc`` and ``chees`` with their
typical-set refresh, step-size steering and independence rescue, and
block-diagonal proposals (``block_*``).

The gradient samplers take their values and gradients from autograd
through the plain posterior (:func:`make_eval_vg`), as the JAX package
takes them from ``vmap(value_and_grad)`` of its plain posterior: the
fused kernel has no backward.  Their value-only evaluations (the
rescue's half-ensembles) go through the batched posterior the runner
is given, which is the fused kernel on the GPU.

The ensemble is a ``(W, d)`` batch; a chunk is a Python loop over
``chunk_size`` steps of tensor operations (where the JAX package scans),
or one launch of the whole-chunk kernel (``ops/chunk_kernel.py``).
Adaptation happens at the chunk boundary.  Nothing in a chunk waits for
the device: the temperature and the step counters are host numbers (the
tempering ladder a tensor built once), the flags are Python booleans and
every data-dependent choice is a ``where``; only the slice sampler's
loops read "every walker done" back, every :data:`SLICE_POLL` iterations,
and a chees step reads its longest trajectory's leapfrog count (one
device sync a step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from .ops.chunk_kernel import chunk_rwm
from .ops.linalg import cholesky_clamped, haario_scale, moments_covariance

__all__ = ["FitConfig", "WalkerState", "init_state", "temperature_schedule",
           "build_chunk_runner", "resolve_accept_band", "rung_betas",
           "make_eval_vg", "POSTERIOR_IMPLS", "SLICE_POLL"]

# "plain" is the JAX package's "xla", "kernel" its "pallas" and
# "chunk_kernel" its "pallas_chunk".
POSTERIOR_IMPLS = ("auto", "plain", "kernel", "chunk_kernel")

# The slice sampler's expansion and shrinkage loops end when every walker
# is done.  They read that flag back to the host every SLICE_POLL
# iterations; 0 runs each loop's whole budget under masks and reads
# nothing.  Every choice gives the same chains: an iteration after a
# walker is done leaves it unchanged.
SLICE_POLL = 1

ENSEMBLE_KERNELS = ("stretch", "demc", "slice")
GRADIENT_KERNELS = ("mala", "hmc", "chees")
# The injected draws of one chunk's steps, per gradient sampler; the
# rescue's come after them (build_chunk_runner's docstring).
N_STEP_DRAWS = {"mala": 2, "hmc": 3, "chees": 3}
# The rescue proposal's Student-t degrees of freedom: heavy tails, and a
# chi^2_2 draw that is -2 log U (kernel.py:1644-1664).
RESCUE_NU = 2.0


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """All adaptation knobs, with the reference's exact defaults.

    The fields are the JAX package's ``FitConfig``; see its comments for
    each.  ``prng_impl`` is kept for config parity and not read: the port
    draws from a ``torch.Generator``.
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
    kernel: str = "rwm"                  # rwm | stretch | demc | slice | mala | hmc | chees
    stretch_a: float = 2.0               # stretch scale a: z ~ 1/sqrt(z) on [1/a, a]
    demc_gamma: float = 0.0              # demc scale; 0 = 2.38/sqrt(2d)
    demc_jitter: float = 0.1             # gamma (1 + U(-b, b))
    demc_jump_prob: float = 0.1          # share of gamma = 1 mode jumps
    slice_mu: float = 1.0                # slice direction eta = mu (x_a - x_b)
    slice_max_expand: int = 4            # stepping-out budget m (Neal 2003)
    slice_max_shrink: int = 32           # shrinkage iterations before a walker stays put
    hmc_leapfrog: int = 8
    hmc_jitter: bool = True
    chees_max_leapfrog: int = 64
    chees_lr: float = 0.025
    rescue: bool = True
    tempering_rungs: int = 0             # > 1: a temperature ladder, a rung per group
    tempering_betas: tuple = ()          # explicit ladder, descending from 1.0
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
    covariance_source: str = "moves"     # "moves" (reference policy) | "ensemble"
    jitter: float = 0.0                  # optional diagonal jitter on refresh
    posterior_impl: str = "auto"         # "auto" | "plain" | "kernel" (fused posterior,
                                         # ops/loglik_kernel.py) | "chunk_kernel" (whole-chunk
                                         # stepper, ops/chunk_kernel.py, for non-history
                                         # chunks of ungrouped f32 rwm fits)
    prng_impl: str = "rbg"
    # Block-diagonal proposals: one block_hyper-dim block, then block_count
    # blocks of block_local (d = block_hyper + block_count * block_local).
    # rwm/mala/hmc/chees apply L per block and refresh it with the
    # cross-block covariance masked; stretch/demc/slice ignore them.
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

    ``W`` walkers, ``d`` parameters, ``G`` adaptation groups.  The step
    counters are host integers; the random stream is the
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
    chees: Any = None      # (G, 4) ChEES state per group: [log(t / hmc_leapfrog),
                           # adam_m, adam_v, adam_step]; zeros = t at hmc_leapfrog


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
        chees=torch.zeros((n_groups, 4), **kw),
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


def rung_betas(config: FitConfig) -> np.ndarray:
    """The tempering ladder's inverse temperatures, cold rung first
    (kernel.py:447-463 of the JAX package): ``tempering_betas`` when set
    (checked: one per rung, strictly descending from 1.0 to > 0), else
    the geometric ``T_k = temperature^(k/(K-1))``."""
    K = config.tempering_rungs
    if config.tempering_betas:
        betas = np.asarray(config.tempering_betas, np.float64)
        if betas.shape != (K,):
            raise ValueError(f"tempering_betas must have one entry per rung "
                             f"({K}), got {betas.shape}")
        if betas[0] != 1.0 or betas[-1] <= 0.0 or np.any(np.diff(betas) >= 0.0):
            raise ValueError("tempering_betas must strictly descend from 1.0 to > 0")
        return betas
    return 1.0 / np.asarray([config.temperature ** (k / (K - 1)) for k in range(K)],
                            np.float64)


def _neg_floor(dtype) -> float:
    """Large-negative stand-in for -inf that keeps (lp1-lp0)/T finite."""
    return torch.finfo(dtype).min / 4


def _finite(lp):
    """A non-finite posterior is a hard reject (the
    walker-check-for-complex-walks analogue, 483)."""
    return torch.where(torch.isfinite(lp), lp, _neg_floor(lp.dtype))


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
    if config.sampling_optimization not in ("covariance", "best-value"):
        raise ValueError(f"unknown sampling_optimization "
                         f"{config.sampling_optimization!r}")
    if (config.sampling_optimization == "best-value" and not config.greedy
            and config.kernel in GRADIENT_KERNELS):
        raise ValueError(
            "sampling_optimization='best-value' is the random-walk "
            "diagonal-refresh policy (mcmc-fitting.lisp:888-895); the "
            "gradient kernels adapt by continuous step-size steering "
            "and an absolute-scale refresh was measured to limit-cycle "
            "them — use the default 'covariance' with kernel='mala'/'hmc'")


def make_eval_vg(eval_plain: Callable) -> Callable:
    """Per-walker value and gradient of a batched posterior, by autograd.

    ``eval_plain((W, d)) -> (W,)`` is the plain PyTorch posterior.  The
    returned ``eval_vg(positions) -> (lp (W,), g (W, d), bad (W,))``
    differentiates ``lp.sum()`` on a leaf copy of the positions, under
    ``torch.enable_grad()`` (so a caller under ``no_grad`` gets the same
    result): the walkers are independent, so the gradient of the sum is
    each walker's own gradient, what ``vmap(value_and_grad)`` computes in
    the JAX package.  The outputs are detached (no graph outlives the
    call); a non-finite value is floored to the kernels' large negative
    stand-in and a non-finite gradient entry zeroed, and ``bad`` marks the
    walkers where either was non-finite (HMC rejects those trajectories).

    The fused kernel has no backward, so this always runs the plain
    posterior, whatever ``posterior_impl`` says.  A state's ``logprob``
    may therefore come from here or from the fused kernel (the rescue);
    the two sum the same terms in another order and differ only by
    rounding, which the Metropolis ratios absorb.
    """
    def eval_vg(positions):
        with torch.enable_grad():
            x = positions.detach().requires_grad_(True)
            lp = eval_plain(x)
            if lp.requires_grad:
                (g,) = torch.autograd.grad(lp.sum(), x, allow_unused=True)
            else:
                g = None
        lp = lp.detach()
        g = torch.zeros_like(positions) if g is None else g
        lp_ok = torch.isfinite(lp)
        g_ok = torch.isfinite(g)
        bad = ~lp_ok | ~g_ok.all(dim=1)
        return (torch.where(lp_ok, lp, _neg_floor(lp.dtype)),
                torch.where(g_ok, g, 0.0), bad)

    return eval_vg


def _contiguous_block(group_ids, n_groups: int) -> int | None:
    """B when ``group_ids`` is ``repeat(arange(G), B)``, else None
    (kernel.py:404-417 of the JAX package)."""
    gi = np.asarray(group_ids)
    if gi.shape[0] % n_groups:
        return None
    B = gi.shape[0] // n_groups
    return B if (gi == np.repeat(np.arange(n_groups), B)).all() else None


def build_chunk_runner(eval_lp: Callable, ndim: int, config: FitConfig,
                       chunk_kernel=None, group_ids=None, n_groups: int = 1,
                       eval_plain: Callable | None = None, whole_batch: bool = False,
                       eval_rows: Callable | None = None):
    """The chunk runners for a batched posterior ``eval_lp((W, d)) -> (W,)``.

    Returns ``(run, run_with_history)``; each maps ``(state, adapt_enabled,
    allow_refresh, force_cold=False, *, generator=None, noise=None)`` to
    ``(state, out)``.  ``force_cold`` True pins T=1 (the cold finish); a
    float > 0 pins that temperature.  ``group_ids``: (W,) walker ->
    adaptation group (None: one group).  ``chunk_kernel``: a built
    ``ops.chunk_kernel.ChunkKernel`` that ``run`` uses for the whole chunk
    (ungrouped, untempered rwm only).  ``eval_plain``: the plain posterior
    the gradient samplers differentiate (:func:`make_eval_vg`; default
    ``eval_lp``).  ``out["posterior_evals"]`` counts the value-only calls
    of ``eval_lp`` in the chunk, ``out["gradient_evals"]`` the
    value-and-gradient evaluations.

    The red-black halves and the rescue's half-rounds evaluate a subset
    of walker slots.  ``whole_batch``: ``eval_lp`` takes only the whole
    ensemble, so they evaluate a full ensemble with their proposals in
    the active slots and keep those values (JAX kernel.py:1748-1760).
    ``eval_rows(positions (n, d), rows (n,))``: the posterior of
    proposals at walker slots ``rows`` (per-walker aux data, sliced to
    the active slots in the group block layout, JAX kernel.py:515-547).
    Neither: ``eval_lp`` takes the subset as a batch.

    Draws come from ``generator``, or from ``noise`` (the injected-draw
    path the parity tests use), laid out per step ``i`` of the chunk and,
    for the red-black samplers, per half ``h`` (0: the low half, updated
    first) on the ``(G, Bh)`` half-ensemble (``G = 1, Bh = W/2`` ungrouped):

    - rwm: ``(z (chunk, W, d), u (chunk, W))``, with a third entry
      ``swap (K-1, B)`` under tempering: the chunk end's swap uniforms;
    - stretch: ``{"j"`` partner index in [0, Bh), ``"z"`` the uniform
      that draws z, ``"u"`` the accept uniform``}``, each (chunk, 2, G, Bh);
    - demc: ``"j"`` (chunk, 2, G, Bh, 2), the donor draws in [0, Bh) and
      [0, Bh-1); ``"g"`` the jitter factor in [1-b, 1+b); ``"jump"`` the
      uniform that picks a mode jump; ``"u"`` the accept uniform;
    - slice: ``"j"`` as demc; ``"e"`` the level's uniform; ``"i"`` the
      interval offset's uniform; ``"k"`` the left budget in [0, m);
      ``"shrink"`` (chunk, 2, slice_max_shrink, G, Bh) the shrink uniforms;
    - mala: ``(z (chunk, W, d), u (chunk, W))``, the proposal's normal and
      the accept uniform;
    - hmc: ``(p (chunk, W, d), u (chunk, W), n_leap (chunk,))``, the
      momentum, the accept uniform and the leapfrog count (with
      ``hmc_jitter`` off every entry is ``hmc_leapfrog``);
    - chees: ``(p, u, u_g (chunk, G))``, ``u_g`` the group's length jitter;
    - and, when the independence rescue runs (the gradient samplers, with
      ``rescue`` on and regular groups), one more entry, the chunk end's
      draws: ``{"z" (2, G, Bh, d), "v" (2, G, Bh), "u" (2, G, Bh)}`` per
      half-round (the Student-t's normal, the uniform of its chi^2_2 draw,
      in [tiny, 1), and the accept uniform), or ``{"z" (W, d), "v" (W,),
      "u" (W,)}`` when a group's walker count is odd;
    - the chunk kernel: ``{"seed": (1,) int32}``, the chunk's key (else
      ``noise`` runs the per-step path).
    """
    _check_scope(config)
    chunk = config.chunk_size
    thin = max(1, min(config.thin, chunk))
    accept_low, accept_high = resolve_accept_band(config)
    grouped = group_ids is not None and n_groups > 1
    group_block = _contiguous_block(group_ids, n_groups) if grouped else None
    gid = torch.as_tensor(np.asarray(group_ids), dtype=torch.int64) if grouped else None
    sampler = "rwm" if config.greedy else config.kernel
    ensemble = sampler in ENSEMBLE_KERNELS
    gradk = sampler in GRADIENT_KERNELS
    tempered = config.tempering_rungs > 1 and not config.greedy
    if tempered:
        if sampler != "rwm":
            raise ValueError("parallel tempering is a search phase; use kernel='rwm' "
                             "(sample afterwards with sampling_steps)")
        if group_block is None or n_groups != config.tempering_rungs:
            raise ValueError("tempering requires contiguous equal walker blocks, one "
                             "adaptation group per rung (use Walker.tempered_steps)")
        betas = rung_betas(config)
        rung_temps = 1.0 / betas
        dbeta_np = betas[:-1] - betas[1:]
    if ensemble and grouped and group_block is None:
        raise ValueError(f"{sampler} kernel needs contiguous equal-size walker blocks "
                         "per adaptation group (complementary halves must stay "
                         "within a group)")
    if chunk_kernel is not None and (grouped or tempered or sampler != "rwm"):
        raise ValueError("the chunk kernel runs ungrouped, untempered rwm chunks")
    # Blocks structure L, so the L-free samplers ignore them
    # (kernel.py:601-612 of the JAX package).
    blocked = config.block_count > 0 and config.kernel in ("rwm",) + GRADIENT_KERNELS
    if blocked:
        b_h, b_l, n_b = config.block_hyper, config.block_local, config.block_count
        if b_h + n_b * b_l != ndim:
            raise ValueError(f"block layout {b_h} + {n_b}*{b_l} != ndim={ndim}")
        if grouped and group_block is None:
            raise ValueError("blocked proposals need contiguous equal-size walker "
                             "groups (or a single group)")
        mask_np = np.zeros((ndim, ndim))
        mask_np[:b_h, :b_h] = 1.0
        for s in range(n_b):
            i0 = b_h + s * b_l
            mask_np[i0:i0 + b_l, i0:i0 + b_l] = 1.0
        block_mask = torch.as_tensor(mask_np)
    # Irregular groupings have no (G, B) layout for the per-group top-K
    # and the half-ensembles, so they keep the plain ensemble covariance
    # and no rescue (kernel.py:1426-1428, 1641).
    regular = not grouped or group_block is not None
    rescue_on = config.rescue and gradk and regular
    eval_vg = make_eval_vg(eval_plain if eval_plain is not None else eval_lp)
    cache: dict[Any, torch.Tensor] = {}

    def eval_slots(x, frame, a0, bh):
        """The posterior of proposals ``x`` (G, bh, d) for slots ``a0 ..
        a0 + bh`` of each group block of ``frame`` (G, B, d): (G * bh,)."""
        G, B = frame.shape[:2]
        if whole_batch:
            full = frame.clone()
            full[:, a0:a0 + bh] = x
            lp = eval_lp(full.reshape(G * B, ndim))
            return lp.reshape(G, B)[:, a0:a0 + bh].reshape(-1)
        flat = x.reshape(-1, ndim).contiguous()
        if eval_rows is None:
            return eval_lp(flat)
        key = ("rows", G, B, a0, bh, x.device)
        if key not in cache:
            cache[key] = (torch.arange(G, device=x.device)[:, None] * B + a0
                          + torch.arange(bh, device=x.device)).reshape(-1)
        return eval_rows(flat, cache[key])

    def on(t, ref):
        """``t`` (built on the CPU once) on ``ref``'s device."""
        key = (id(t), ref.device)
        if key not in cache:
            cache[key] = t.to(ref.device)
        return cache[key]

    def seg_sum(x):
        """Sum per adaptation group: (W, ...) -> (G, ...)."""
        if group_block is not None:
            return x.reshape((n_groups, group_block) + x.shape[1:]).sum(dim=1)
        if grouped:
            out = torch.zeros((n_groups,) + x.shape[1:], dtype=x.dtype, device=x.device)
            return out.index_add_(0, on(gid, x), x)
        return x.sum(dim=0)[None]

    def seg_outer(v):
        """Per-group sum of outer products: (W, d) -> (G, d, d)."""
        if group_block is not None:
            vg = v.reshape(n_groups, group_block, ndim)
            return torch.bmm(vg.transpose(1, 2), vg)
        if grouped:
            return seg_sum(v[:, :, None] * v[:, None, :])
        return torch.einsum("wi,wj->ij", v, v)[None]

    def per_walker(g, W):
        """A per-group (G, ...) tensor at each of the W walkers: (W, ...)."""
        if group_block is not None:
            return g.repeat_interleave(group_block, dim=0)
        if grouped:
            return g[on(gid, g)]
        return g[0].expand((W,) + g.shape[1:])

    def mul_l(l_matrix, z):
        """L z per walker, each with its group's L."""
        if group_block is not None:
            zg = z.reshape(n_groups, group_block, ndim)
            return torch.bmm(zg, l_matrix.transpose(1, 2)).reshape(z.shape)
        if grouped:
            return torch.einsum("wij,wj->wi", l_matrix[on(gid, z)], z)
        return z @ l_matrix[0].T

    def mul_lt(l_matrix, v):
        """L^T v per walker, each with its group's L."""
        if group_block is not None:
            vg = v.reshape(n_groups, group_block, ndim)
            return torch.bmm(vg, l_matrix).reshape(v.shape)
        if grouped:
            return torch.einsum("wji,wj->wi", l_matrix[on(gid, v)], v)
        return v @ l_matrix[0]

    def blocked_apply(l_matrix, v, trans: bool):
        """L v (or L^T v) of a dense block-diagonal L, block by block
        (kernel.py:630-669): the hyper block, then the local blocks as one
        batched product, without the zero off-blocks."""
        G = l_matrix.shape[0]
        l_h = l_matrix[:, :b_h, :b_h]
        # (G, S, bl, S, bl) -> its S diagonal blocks (G, S, bl, bl)
        l_loc = torch.diagonal(
            l_matrix[:, b_h:, b_h:].reshape(G, n_b, b_l, n_b, b_l),
            dim1=1, dim2=3).permute(0, 3, 1, 2)
        if not trans:
            l_h, l_loc = l_h.transpose(-1, -2), l_loc.transpose(-1, -2)
        # Row form: (L v)^T = v^T L^T, (L^T v)^T = v^T L.
        if group_block is not None:
            vg = v.reshape(G, group_block, ndim)
            loc = vg[..., b_h:].reshape(G, group_block, n_b, b_l)
            e_l = torch.einsum("gbsj,gsji->gbsi", loc, l_loc)
            parts = [torch.bmm(vg[..., :b_h], l_h)] if b_h else []
            parts.append(e_l.reshape(G, group_block, n_b * b_l))
            return torch.cat(parts, dim=-1).reshape(v.shape)
        W = v.shape[0]
        e_l = torch.einsum("wsj,sji->wsi", v[:, b_h:].reshape(W, n_b, b_l), l_loc[0])
        parts = [v[:, :b_h] @ l_h[0]] if b_h else []
        parts.append(e_l.reshape(W, n_b * b_l))
        return torch.cat(parts, dim=-1)

    if blocked:
        # The JAX package picks the blocked apply on every backend but the
        # TPU; the CPU and the GPU both get it here.
        def mul_L(l_matrix, v):
            return blocked_apply(l_matrix, v, False)

        def mul_Lt(l_matrix, v):
            return blocked_apply(l_matrix, v, True)
    else:
        mul_L, mul_Lt = mul_l, mul_lt

    def _apply_step(state, proposal, lp_prop, step_vec, accept):
        """Accept/update tail: position, moment sums, best tracking.
        ``step_vec`` None: an L-free sampler, no moments."""
        dtype = state.position.dtype
        acc = accept[:, None]
        accf = accept.to(dtype)
        new_position = torch.where(acc, proposal, state.position)
        new_logprob = torch.where(accept, lp_prop, state.logprob)
        m_sum, m_outer, m_count = state.m_sum, state.m_outer, state.m_count
        if step_vec is not None:
            # Accepted-move moments for covariance adaptation, per group.
            delta = step_vec * acc.to(dtype)
            m_sum = m_sum + seg_sum(delta)
            m_outer = m_outer + seg_outer(delta)
            m_count = m_count + seg_sum(accf)
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
            anneal_step=state.anneal_step + 1, chees=state.chees)
        trace = torch.stack([new_logprob.max(), new_logprob.mean(),
                             new_logprob.min()])
        return new_state, accf, trace

    def resolve_temp(force_cold, state):
        """``force_cold`` True (== 1.0) pins T=1, a float > 0 pins that
        temperature, False follows the annealing schedule indexed by the
        per-run counter (mcmc-fitting.lisp:902, 919-921); under tempering
        it is each walker's rung temperature, a (W,) tensor."""
        tover = float(force_cold)
        if tover > 0:
            return tover
        if tempered:
            key = ("ladder", state.position.dtype, state.position.device)
            if key not in cache:
                cache[key] = torch.as_tensor(
                    rung_temps, dtype=state.position.dtype,
                    device=state.position.device).repeat_interleave(group_block)
            return cache[key]
        return float(temperature_schedule(state.anneal_step, ndim, config))

    def one_step(state, i, force_cold, generator, noise, evals):
        W, d = state.position.shape
        kw = dict(dtype=state.position.dtype, device=state.position.device)
        temp = resolve_temp(force_cold, state)
        if noise is None:
            z = torch.randn((W, d), generator=generator, **kw)
            u = torch.rand((W,), generator=generator, **kw)
        else:
            z, u = noise[0][i], noise[1][i]
        step_vec = mul_L(state.l_matrix, z)
        proposal = state.position + step_vec
        lp_prop = _finite(eval_lp(proposal))
        evals[0] += 1
        log_u = torch.log(u)
        if config.greedy:
            accept = lp_prop > state.logprob               # (1117-1119)
        else:
            accept = ((lp_prop > state.logprob)            # (1091-1092)
                      | ((lp_prop - state.logprob) / temp > log_u))
        # Blocked rwm refreshes from the ensemble, so it keeps no moments.
        return _apply_step(state, proposal, lp_prop, None if blocked else step_vec,
                           accept)

    # ---- the red-black ensemble samplers (kernel.py:804-1142) ----

    def halves_layout(W):
        """(G, B) of the red-black halves, checked (kernel.py:489-513,
        825-829, 913-923 of the JAX package)."""
        G, B = (n_groups, group_block) if group_block is not None else (1, W)
        if B % 2:
            raise ValueError(f"{sampler} kernel needs an even number of walkers "
                             "per group")
        if B - 1 < ndim:
            # B points span at most a (B-1)-dim affine subspace: the fit
            # would sample a slice of the posterior.
            raise ValueError(
                f"{sampler} kernel: {B} walkers per group span at most a "
                f"{B - 1}-dim affine subspace of the {ndim}-dim posterior — "
                f"the fit would silently sample a slice. Use > {ndim} "
                f"(recommended >= {2 * ndim}) walkers per group, or the rwm "
                "kernel")
        if sampler != "stretch" and B // 2 < 2:
            raise ValueError(f"{sampler} kernel needs >= 4 walkers per group (two "
                             "distinct complementary donors per proposal)")
        return G, B

    def draw(step_noise, name, h, make):
        return make() if step_noise is None else step_noise[name][h]

    def gather(comp, j):
        """comp[g, j[g, b]] for a (G, Bh, d) half and (G, Bh) indices."""
        return torch.gather(comp, 1, j[..., None].expand(-1, -1, ndim))

    def donors(comp, j):
        """Two distinct donors (kernel.py:931-937): j2 = (j1 + 1 + U[0, Bh-2]) mod Bh."""
        Bh = comp.shape[1]
        j1 = j[..., 0]
        j2 = (j1 + 1 + j[..., 1]) % Bh
        return gather(comp, j1), gather(comp, j2)

    def donor_draws(comp, generator, step_noise, h):
        G, Bh = comp.shape[:2]

        def make():
            dev = comp.device
            return torch.stack([
                torch.randint(0, Bh, (G, Bh), generator=generator, device=dev),
                torch.randint(0, Bh - 1, (G, Bh), generator=generator, device=dev)],
                dim=-1)
        return draw(step_noise, "j", h, make)

    def half_stretch(h, xk, lpk, comp, temp, generator, step_noise, eval_half):
        G, Bh = lpk.shape
        kw = dict(dtype=lpk.dtype, device=lpk.device)
        a = config.stretch_a
        j = draw(step_noise, "j", h, lambda: torch.randint(
            0, Bh, (G, Bh), generator=generator, device=lpk.device))
        xj = gather(comp, j)
        u = draw(step_noise, "z", h, lambda: torch.rand((G, Bh), generator=generator, **kw))
        # Inverse-CDF draw of g(z) ∝ 1/sqrt(z) on [1/a, a].
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        prop = xj + z[..., None] * (xk - xj)
        lp_prop = eval_half(prop)
        log_alpha = (ndim - 1.0) * torch.log(z) + (lp_prop - lpk) / temp
        ua = draw(step_noise, "u", h, lambda: torch.rand((G, Bh), generator=generator, **kw))
        return prop, lp_prop, torch.log(ua) < log_alpha

    def half_demc(h, xk, lpk, comp, temp, generator, step_noise, eval_half):
        G, Bh = lpk.shape
        kw = dict(dtype=lpk.dtype, device=lpk.device)
        gamma0 = config.demc_gamma if config.demc_gamma > 0.0 else 2.38 / math.sqrt(2.0 * ndim)
        b = config.demc_jitter
        xa, xb = donors(comp, donor_draws(comp, generator, step_noise, h))
        u = draw(step_noise, "g", h, lambda: (1.0 - b) + 2.0 * b * torch.rand(
            (G, Bh), generator=generator, **kw))
        jump = draw(step_noise, "jump", h, lambda: torch.rand(
            (G, Bh), generator=generator, **kw)) < config.demc_jump_prob
        gamma = torch.where(jump, 1.0, gamma0 * u)
        prop = xk + gamma[..., None] * (xa - xb)
        lp_prop = eval_half(prop)
        ua = draw(step_noise, "u", h, lambda: torch.rand((G, Bh), generator=generator, **kw))
        return prop, lp_prop, torch.log(ua) < (lp_prop - lpk) / temp

    def half_slice(h, xk, lpk, comp, temp, generator, step_noise, eval_half):
        """Ensemble slice sampling along a donor-pair difference
        (kernel.py:1030-1128): level, Neal's budgeted stepping-out,
        shrinkage; a walker that does not land stays put."""
        G, Bh = lpk.shape
        kw = dict(dtype=lpk.dtype, device=lpk.device)
        m_exp, m_shr = int(config.slice_max_expand), int(config.slice_max_shrink)
        xa, xb = donors(comp, donor_draws(comp, generator, step_noise, h))
        raw = xa - xb
        # Outlier-donor clamp to 3x the group's median norm.  The median of
        # an even count is the mean of the two middle values, as jnp.median
        # takes it (torch.median would take the lower one).
        nrm = torch.sqrt(torch.sum(raw * raw, dim=-1))               # (G, Bh)
        srt = torch.sort(nrm, dim=1).values
        med = (srt[:, (Bh - 1) // 2] + srt[:, Bh // 2])[:, None] * 0.5
        floor = torch.finfo(lpk.dtype).tiny
        clip = torch.clamp_max(3.0 * med / torch.clamp_min(nrm, floor), 1.0)
        eta = config.slice_mu * raw * clip[..., None]

        def eval_at(t):
            return eval_half(xk + t[..., None] * eta)

        e = -torch.log(draw(step_noise, "e", h, lambda: torch.rand(
            (G, Bh), generator=generator, **kw)))
        log_y = lpk / temp - e
        lo = -draw(step_noise, "i", h, lambda: torch.rand((G, Bh), generator=generator, **kw))
        hi = lo + 1.0
        poll = SLICE_POLL
        if m_exp > 1:
            jb = draw(step_noise, "k", h, lambda: torch.randint(
                0, m_exp, (G, Bh), generator=generator, device=lpk.device))
            kb = (m_exp - 1) - jb
            for it in range(m_exp - 1):
                if poll and it and it % poll == 0 and not bool(((jb > 0) | (kb > 0)).any()):
                    break
                grow_l = (jb > 0) & (eval_at(lo) / temp > log_y)
                grow_r = (kb > 0) & (eval_at(hi) / temp > log_y)
                lo = torch.where(grow_l, lo - 1.0, lo)
                hi = torch.where(grow_r, hi + 1.0, hi)
                # The budget zeroes on the first non-grow (Neal's while loop).
                jb = torch.where(grow_l, jb - 1, 0)
                kb = torch.where(grow_r, kb - 1, 0)
        # Shrinkage from t = 0 (stay at x): a walker that never lands is a
        # rejected step.
        t_sel = torch.zeros_like(lpk)
        lp_sel = lpk
        done = torch.zeros(lpk.shape, dtype=torch.bool, device=lpk.device)
        for it in range(m_shr):
            if poll and it and it % poll == 0 and bool(done.all()):
                break
            u = (torch.rand((G, Bh), generator=generator, **kw) if step_noise is None
                 else step_noise["shrink"][h][it])
            t = lo + u * (hi - lo)
            lpc = eval_at(t)
            ok = lpc / temp > log_y
            newly = ok & ~done
            t_sel = torch.where(newly, t, t_sel)
            lp_sel = torch.where(newly, lpc, lp_sel)
            still = ~(done | ok)
            lo = torch.where(still & (t < 0.0), t, lo)
            hi = torch.where(still & (t >= 0.0), t, hi)
            done = done | ok
        return xk + t_sel[..., None] * eta, lp_sel, done

    HALF_STEPS = {"stretch": half_stretch, "demc": half_demc, "slice": half_slice}

    def one_step_ensemble(state, i, force_cold, generator, noise, evals):
        """One red-black step: the low half against the high half, then the
        high half against the UPDATED low half (kernel.py:858-870)."""
        W, d = state.position.shape
        temp = resolve_temp(force_cold, state)
        G, B = halves_layout(W)
        Bh = B // 2
        pos = state.position.reshape(G, B, d)
        lp = state.logprob.reshape(G, B)
        step_noise = None if noise is None else {k: v[i] for k, v in noise.items()}

        def eval_half(h, frame):
            # A grouped half is a strided view; the kernel takes a
            # contiguous (G * Bh, d) batch (eval_slots).
            def ev(x):
                evals[0] += 1
                return _finite(eval_slots(x, frame, h * Bh, Bh)).reshape(G, Bh)
            return ev

        half = HALF_STEPS[sampler]
        x_lo, l_lo = pos[:, :Bh], lp[:, :Bh]
        x_hi, l_hi = pos[:, Bh:], lp[:, Bh:]
        p_lo, lp_lo, a_lo = half(0, x_lo, l_lo, x_hi, temp, generator, step_noise,
                                 eval_half(0, pos))
        x_lo_new = torch.where(a_lo[..., None], p_lo, x_lo)
        p_hi, lp_hi, a_hi = half(1, x_hi, l_hi, x_lo_new, temp, generator, step_noise,
                                 eval_half(1, torch.cat([x_lo_new, x_hi], dim=1)))
        # Walkers come back in (group, half, index) order.
        proposal = torch.cat([p_lo, p_hi], dim=1).reshape(W, d)
        lp_prop = torch.cat([lp_lo, lp_hi], dim=1).reshape(W)
        accept = torch.cat([a_lo, a_hi], dim=1).reshape(W)
        return _apply_step(state, proposal, lp_prop, None, accept)

    step_fn = one_step_ensemble if ensemble else one_step

    # ---- the gradient samplers (kernel.py:1144-1424) ----

    def vg(x, evals):
        evals[1] += 1
        return eval_vg(x)

    def step_draws(noise, i, W, kw, generator):
        """The step's momentum (or proposal normal) and accept uniform."""
        if noise is None:
            return (torch.randn((W, ndim), generator=generator, **kw),
                    torch.rand((W,), generator=generator, **kw))
        return noise[0][i], noise[1][i]

    def one_step_mala(state, g, i, force_cold, generator, noise, evals, adapt_on):
        """Preconditioned MALA (kernel.py:1144-1191): with M = L L^T and the
        target pi^(1/T), propose ``x + (1/2T) M g + L z``.  In whitened
        coordinates the reverse draw is ``-(z + (u + u')/(2T))`` with
        ``u = L^T g``, so the Hastings correction needs no triangular
        solve.  The drift is off while T > 1.001 (then the step is the
        random walk's)."""
        W = state.position.shape[0]
        kw = dict(dtype=state.position.dtype, device=state.position.device)
        temp = resolve_temp(force_cold, state)
        inv_t = 1.0 / temp
        lam = 0.0 if temp > 1.001 else 1.0
        L = state.l_matrix
        u = lam * mul_Lt(L, g)
        z, u_acc = step_draws(noise, i, W, kw, generator)
        step_vec = mul_L(L, z + 0.5 * inv_t * u)
        proposal = state.position + step_vec
        lp_prop, g_prop, _ = vg(proposal, evals)
        u_prop = lam * mul_Lt(L, g_prop)
        rev = z + 0.5 * inv_t * (u + u_prop)
        log_q_diff = 0.5 * (torch.sum(z * z, dim=1) - torch.sum(rev * rev, dim=1))
        log_alpha = (lp_prop - state.logprob) * inv_t + log_q_diff
        accept = log_alpha > torch.log(u_acc)
        new_state, accf, trace = _apply_step(state, proposal, lp_prop, None, accept)
        return new_state, accf, trace, torch.where(accept[:, None], g_prop, g)

    def leapfrog(L, x, p, lp, g, bad, inv_t, evals):
        """One drift-and-kick of the leapfrog in L-whitened coordinates."""
        x_n = x + mul_L(L, p)
        lp_n, g_n, bad_n = vg(x_n, evals)
        return x_n, p + inv_t * mul_Lt(L, g_n), lp_n, g_n, bad | bad_n

    def hmc_accept(state, p0, x1, p1, lp1, bad, inv_t, u_acc):
        """Delta H in whitened space; a divergent trajectory is rejected."""
        log_alpha = (lp1 - state.logprob) * inv_t + 0.5 * (
            torch.sum(p0 * p0, dim=1) - torch.sum(p1 * p1, dim=1))
        log_alpha = torch.where(bad, -math.inf, log_alpha)
        return log_alpha, log_alpha > torch.log(u_acc)

    def one_step_hmc(state, g, i, force_cold, generator, noise, evals, adapt_on):
        """HMC in L-whitened coordinates (kernel.py:1193-1267): half kick,
        ``hmc_leapfrog`` drift-and-kick iterations, the closing un-kick.
        With ``hmc_jitter`` the length is one draw in
        [ceil(L/2), L] per step, applied as a mask over a loop of fixed
        length, as the JAX package's static scan does: no host sync, and
        the same evaluations."""
        W = state.position.shape[0]
        kw = dict(dtype=state.position.dtype, device=state.position.device)
        temp = resolve_temp(force_cold, state)
        inv_t = 1.0 / temp
        L = state.l_matrix
        p0, u_acc = step_draws(noise, i, W, kw, generator)
        n_steps = max(1, config.hmc_leapfrog)
        jitter = config.hmc_jitter and n_steps > 1
        if not jitter:
            n_leap = None
        elif noise is None:
            n_leap = torch.randint((n_steps + 1) // 2, n_steps + 1, (), generator=generator,
                                   device=kw["device"])
        else:
            n_leap = noise[2][i]
        x, lp = state.position, state.logprob
        p = p0 + 0.5 * inv_t * mul_Lt(L, g)
        g1 = g
        bad = torch.zeros(lp.shape, dtype=torch.bool, device=lp.device)
        for k in range(n_steps):
            new = leapfrog(L, x, p, lp, g1, bad, inv_t, evals)
            if n_leap is None:
                x, p, lp, g1, bad = new
            else:
                active = k < n_leap
                x, p, lp, g1, bad = (torch.where(active, n, o)
                                     for n, o in zip(new, (x, p, lp, g1, bad)))
        p = p - 0.5 * inv_t * mul_Lt(L, g1)
        _, accept = hmc_accept(state, p0, x, p, lp, bad, inv_t, u_acc)
        new_state, accf, trace = _apply_step(state, x, lp, None, accept)
        return new_state, accf, trace, torch.where(accept[:, None], g1, g)

    def one_step_chees(state, g, i, force_cold, generator, noise, evals, adapt_on):
        """ChEES-HMC (kernel.py:1269-1416): HMC whose trajectory time t
        per group follows Adam on log t up the ChEES criterion, with the
        alpha-weighted endpoint statistics of the whole group.  A group
        draws one jitter u_g and integrates ``ceil(u_g t)`` steps (1 to
        ``chees_max_leapfrog``).  The JAX package's while loop runs to the
        longest group's count; here that count is read to the host once a
        step and the loop runs that long, walkers masked past their own
        group's count.  ``adapt_on`` gates the write to ``state.chees``."""
        W = state.position.shape[0]
        dtype = state.position.dtype
        kw = dict(dtype=dtype, device=state.position.device)
        temp = resolve_temp(force_cold, state)
        inv_t = 1.0 / temp
        L = state.l_matrix
        t_init = float(max(1, config.hmc_leapfrog))
        budget = int(max(1, config.chees_max_leapfrog))
        off_lo, off_hi = math.log(1.0 / t_init), math.log(budget / t_init)
        offset = torch.clamp(state.chees[:, 0], off_lo, off_hi)       # (G,)
        t_g = t_init * torch.exp(offset)
        if noise is None:
            u_g = torch.rand((state.chees.shape[0],), generator=generator, **kw)
        else:
            u_g = noise[2][i]
        n_leap_g = torch.clamp(torch.ceil(u_g * t_g).to(torch.int64), 1, budget)
        n_leap_w = per_walker(n_leap_g, W)
        u_w = per_walker(u_g, W)
        n_max = int(n_leap_g.max())           # the step's one device sync
        p0, u_acc = step_draws(noise, i, W, kw, generator)
        x, lp, g1 = state.position, state.logprob, g
        p = p0 + 0.5 * inv_t * mul_Lt(L, g)
        bad = torch.zeros((W,), dtype=torch.bool, device=lp.device)
        for k in range(n_max):
            act = k < n_leap_w
            new = leapfrog(L, x, p, lp, g1, bad, inv_t, evals)
            x, p, g1 = (torch.where(act[:, None], n, o)
                        for n, o in zip(new[:2] + new[3:4], (x, p, g1)))
            lp = torch.where(act, new[2], lp)
            bad = torch.where(act, new[4], bad)
        p = p - 0.5 * inv_t * mul_Lt(L, g1)
        log_alpha, accept = hmc_accept(state, p0, x, p, lp, bad, inv_t, u_acc)

        # The ChEES gradient on log t, per group, from every proposed
        # endpoint weighted by its acceptance probability.
        alpha = torch.where(bad, 0.0, torch.exp(torch.clamp_max(log_alpha, 0.0)))
        count_g = torch.clamp_min(seg_sum(torch.ones((W,), **kw)), 1.0)
        a_sum = torch.clamp_min(seg_sum(alpha), 1e-12)
        xbar = seg_sum(state.position) / count_g[:, None]
        xbar_p = seg_sum(alpha[:, None] * x) / a_sum[:, None]
        dx1 = x - per_walker(xbar_p, W)
        dx0 = state.position - per_walker(xbar, W)
        delta = torch.sum(dx1 * dx1, dim=1) - torch.sum(dx0 * dx0, dim=1)
        v1 = mul_L(L, p)                                              # endpoint velocity
        per_w = alpha * delta * torch.sum(dx1 * v1, dim=1) * u_w
        grad_log_t = (seg_sum(per_w) / a_sum) * t_g
        grad_log_t = torch.where(torch.isfinite(grad_log_t), grad_log_t, 0.0)
        b1, b2 = 0.9, 0.999
        m = b1 * state.chees[:, 1] + (1.0 - b1) * grad_log_t
        v = b2 * state.chees[:, 2] + (1.0 - b2) * grad_log_t ** 2
        cnt = state.chees[:, 3] + 1.0
        mhat = m / (1.0 - torch.pow(b1, cnt))
        vhat = v / (1.0 - torch.pow(b2, cnt))
        new_off = torch.clamp(offset + config.chees_lr * mhat / (torch.sqrt(vhat) + 1e-8),
                              off_lo, off_hi)
        new_state, accf, trace = _apply_step(state, x, lp, None, accept)
        if adapt_on:
            new_state = dataclasses.replace(
                new_state, chees=torch.stack([new_off, m, v, cnt], dim=1).to(dtype))
        return new_state, accf, trace, torch.where(accept[:, None], g1, g)

    GRAD_STEPS = {"mala": one_step_mala, "hmc": one_step_hmc, "chees": one_step_chees}

    def typical_weights(logprob):
        """Each group's chi^2-typical set (kernel.py:1430-1465): within
        d/2 + 4 sqrt(d/2) + 2 log-units of the group's best, floored at
        the top K = max(2d + 4, 32) walkers.  Returns ``(wgt (W,),
        counts (G,))``."""
        cut = 0.5 * ndim + 4.0 * math.sqrt(0.5 * ndim) + 2.0
        if group_block is not None:
            k = min(group_block, max(2 * ndim + 4, 32))
            lp_g = logprob.reshape(n_groups, group_block)
            top = lp_g.amax(dim=1)
            kth = torch.sort(lp_g, dim=1).values[:, group_block - k]
            thresh = torch.minimum(top - cut, kth)
            keep = (lp_g >= thresh[:, None]).reshape(-1)
        else:
            n = logprob.shape[0]
            k = min(n, max(2 * ndim + 4, 32))
            kth = torch.sort(logprob).values[n - k]
            thresh = torch.minimum(logprob.max() - cut, kth)
            keep = logprob >= thresh
        wgt = keep.to(logprob.dtype)
        return wgt, torch.clamp_min(seg_sum(wgt), 1.0)

    def adapt(state: WalkerState, group_accept, allow_refresh: bool):
        """Chunk-boundary L update (mcmc-fitting.lisp:929-942), batched over
        adaptation groups with ``where`` masks."""
        dtype = state.position.dtype
        W, d = state.position.shape
        g = float(config.refresh_damping)
        in_band = (accept_low < group_accept) & (group_accept < accept_high)
        too_low = group_accept <= accept_low
        l_rescaled = torch.where(too_low[:, None, None],
                                 (config.scale_down ** g) * state.l_matrix,
                                 (config.scale_up ** g) * state.l_matrix)
        if config.sampling_optimization == "best-value":
            # 1e-5 x diag of each group's best parameters' magnitudes
            # (888-895); irregular groups take the global best.
            if group_block is not None:
                idx = torch.argmax(state.best_logprob.reshape(n_groups, group_block), dim=1)
                best = state.best_position.reshape(n_groups, group_block, d)[
                    torch.arange(n_groups, device=idx.device), idx]
            else:
                w = torch.argmax(state.best_logprob)
                best = state.best_position[w].expand(n_groups, d)
            mags = torch.abs(best)
            mags = torch.where(mags > 0, mags, 1e-3)
            candidate = (1e-5 * torch.diag_embed(mags)).to(dtype)
            blended = (1.0 - g) * state.l_matrix + g * candidate if g < 1.0 else candidate
            l_refreshed = blended if allow_refresh else state.l_matrix
            new_l = torch.where(in_band[:, None, None], l_refreshed, l_rescaled)
            return dataclasses.replace(state, l_matrix=new_l.to(dtype))

        # Enough walkers for a covariance: per block under blocking.
        need = max(config.block_hyper, config.block_local) if blocked else d
        if gradk and regular:
            # The gradient samplers precondition with the target's
            # covariance, trimmed to each group's typical set
            # (kernel.py:1516-1536): the straggler tail would inflate it.
            wgt, counts = typical_weights(state.logprob)
            mean = seg_sum(state.position * wgt[:, None]) / counts[:, None]
            centered = (state.position - per_walker(mean, W)) * wgt[:, None]
            cov = seg_outer(centered) / counts[:, None, None]
            enough = counts > need
        elif config.covariance_source == "ensemble" or gradk or blocked:
            # The ensemble's own spread per group (kernel.py:1537-1547).
            ones = torch.ones_like(state.logprob)
            counts = torch.clamp_min(seg_sum(ones), 1.0)                 # (G,)
            mean = seg_sum(state.position) / counts[:, None]
            centered = state.position - per_walker(mean, W)
            cov = seg_outer(centered) / counts[:, None, None]
            enough = counts > need
        else:
            cov = moments_covariance(state.m_sum, state.m_outer, state.m_count)
            enough = state.m_count > d
        if blocked:
            # Zero the cross-block entries: the Cholesky of a
            # block-diagonal matrix is block-diagonal (kernel.py:1551-1557).
            cov = cov * on(block_mask, cov).to(dtype)
        if config.jitter > 0:
            cov = cov + config.jitter * torch.eye(d, dtype=dtype, device=cov.device)
        chol, ok = cholesky_clamped(cov)                            # (G,d,d), (G,)
        # The reference scales the L-matrix by 2.38^2/d (890).
        candidate = haario_scale(d) * chol
        refresh_ok = ok & enough & allow_refresh                    # (G,)
        if gradk:
            # Continuous step-size steering toward the sampler's optimum,
            # and a refresh of the shape only, at in-band acceptance, with
            # the current scale carried over (kernel.py:1568-1610).
            target = 0.65 if sampler in ("hmc", "chees") else 0.574
            corr = torch.where(group_accept >= target,
                               torch.exp(0.5 * (group_accept - target)),
                               torch.exp(group_accept - target)).to(dtype)  # (G,)
            tiny = torch.finfo(dtype).tiny
            diag_l = torch.abs(torch.diagonal(state.l_matrix, dim1=1, dim2=2))
            diag_c = torch.abs(torch.diagonal(chol, dim1=1, dim2=2))
            log_s = torch.clamp(
                torch.mean(torch.log(torch.clamp_min(diag_l, tiny)), dim=1)
                - torch.mean(torch.log(torch.clamp_min(diag_c, tiny)), dim=1),
                -20.0, 20.0)
            cand_shape = (torch.exp(log_s) * corr)[:, None, None] * chol
            new_l = torch.where((refresh_ok & in_band)[:, None, None], cand_shape,
                                corr[:, None, None] * state.l_matrix)
            return dataclasses.replace(state, l_matrix=new_l.to(dtype))
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

    def replica_swap(state: WalkerState, force_cold, generator, noise):
        """One replica-exchange round between adjacent rungs
        (kernel.py:1878-1929): pairs (k, k+1) of the chunk's parity; walker
        b of rung k swaps with walker b of rung k+1 with probability
        ``min(1, exp((beta_k - beta_{k+1}) (logpi_{k+1} - logpi_k)))``.
        Returns the state and each pair's swap rate (NaN when off parity)."""
        dtype, dev = state.position.dtype, state.position.device
        K, B = n_groups, group_block
        pos = state.position.reshape(K, B, ndim)
        lp = state.logprob.reshape(K, B)
        parity = (state.age // chunk) % 2
        # Every override makes the rungs equal-temperature, where dbeta = 0
        # is the only valid swap.
        dbeta = torch.as_tensor(dbeta_np, dtype=dtype, device=dev)
        if float(force_cold) > 0:
            dbeta = torch.zeros_like(dbeta)
        log_alpha = dbeta[:, None] * (lp[1:] - lp[:-1])                   # (K-1, B)
        u = (torch.rand((K - 1, B), generator=generator, dtype=dtype, device=dev)
             if noise is None else noise[2])
        pair_on = (torch.arange(K - 1, device=dev) % 2) == parity         # (K-1,)
        do_swap = (torch.log(u) < log_alpha) & pair_on[:, None]
        # Alternating parity makes the active pairs disjoint: one where-pass
        # with rolled neighbours applies every swap.
        no = torch.zeros((1, B), dtype=torch.bool, device=dev)
        take_next = torch.cat([do_swap, no])
        take_prev = torch.cat([no, do_swap])
        new_pos = torch.where(take_next[:, :, None], torch.roll(pos, -1, 0),
                              torch.where(take_prev[:, :, None], torch.roll(pos, 1, 0), pos))
        new_lp = torch.where(take_next, torch.roll(lp, -1, 0),
                             torch.where(take_prev, torch.roll(lp, 1, 0), lp))
        swap_rate = torch.where(pair_on, do_swap.to(dtype).mean(dim=1), math.nan)
        return dataclasses.replace(state, position=new_pos.reshape(state.position.shape),
                                   logprob=new_lp.reshape(state.logprob.shape)), swap_rate

    # ---- the independence rescue (kernel.py:1637-1876) ----

    def rescue_log_q_t(z):
        """Log multivariate-t density (nu = 2) up to its constant and det."""
        return -0.5 * (RESCUE_NU + ndim) * torch.log1p(torch.sum(z * z, dim=-1) / RESCUE_NU)

    def rescue_t_draw(shape, kw, generator, draws):
        """Multivariate t (nu = 2): a normal times sqrt(nu / V), V ~ chi^2_2
        = -2 log U with U in [tiny, 1), one V per walker."""
        tiny = torch.finfo(kw["dtype"]).tiny
        if draws is None:
            z_n = torch.randn(shape, generator=generator, **kw)
            u = torch.clamp_min(torch.rand(shape[:-1], generator=generator, **kw), tiny)
        else:
            z_n, u = draws["z"], draws["v"]
        v_chi2 = -2.0 * torch.log(u)
        return z_n * torch.sqrt(RESCUE_NU / torch.clamp_min(v_chi2, 1e-12))[..., None]

    def rescue_uniform(shape, kw, generator, draws):
        return torch.rand(shape, generator=generator, **kw) if draws is None else draws["u"]

    def whiten(chol, diff):
        """``chol^-1 diff`` per group for (G, d, d) and (G, n, d), with the
        kernels' tiny diagonal guard; non-finite entries read 1e6."""
        eye = torch.eye(ndim, dtype=chol.dtype, device=chol.device)
        chol_safe = chol + torch.finfo(chol.dtype).tiny * eye
        z = torch.linalg.solve_triangular(chol_safe, diff.transpose(1, 2),
                                          upper=False).transpose(1, 2)
        return torch.where(torch.isfinite(z), z, 1e6)

    def rescue_fit_q(fit_pos, fit_lp):
        """The t-proposal fitted on a (G, Bf, d) block's typical set (the
        policy of :func:`typical_weights`), 1.3x overdispersed.  Returns
        ``(mean (G, d), chol (G, d, d), ok (G,))``."""
        bf = fit_lp.shape[1]
        cut = 0.5 * ndim + 4.0 * math.sqrt(0.5 * ndim) + 2.0
        k = min(bf, max(2 * ndim + 4, 32))
        top = fit_lp.amax(dim=1)
        kth = torch.sort(fit_lp, dim=1).values[:, bf - k]
        thresh = torch.minimum(top - cut, kth)
        wgt = (fit_lp >= thresh[:, None]).to(fit_lp.dtype)               # (G, Bf)
        counts = torch.clamp_min(wgt.sum(dim=1), 1.0)
        mean = torch.sum(fit_pos * wgt[..., None], dim=1) / counts[:, None]
        centered = (fit_pos - mean[:, None, :]) * wgt[..., None]
        cov = torch.bmm(centered.transpose(1, 2), centered) / counts[:, None, None]
        chol, ok = cholesky_clamped(1.69 * cov)
        return mean, chol, ok & (counts > ndim)

    def independence_rescue(state, force_cold, generator, draws, evals):
        """One independence-MH regeneration round at the chunk end
        (kernel.py:1693-1819): each group's two halves in turn propose
        ``y ~ q``, a Student-t (nu = 2) fitted on the complementary half's
        typical set, accepted with the independence ratio
        ``beta (lp(y) - lp(x)) + log q(z_x) - log q(z_y)``.  Given the
        fitting half the move is a plain independence step, so the pair of
        half-rounds leaves pi^(1/T) invariant.  Walkers frozen on a plateau
        by their huge gradients teleport back to the typical set.  Each
        half-round evaluates the (G * Bh, d) proposals value-only through
        ``eval_slots`` (the fused kernel at W/2 on the GPU).  An odd group
        size takes :func:`rescue_adaptive_full`."""
        W = state.position.shape[0]
        G = n_groups if grouped else 1
        B = group_block if group_block is not None else W
        if B % 2:
            return rescue_adaptive_full(state, force_cold, generator, draws, evals)
        kw = dict(dtype=state.position.dtype, device=state.position.device)
        inv_t = 1.0 / resolve_temp(force_cold, state)
        bh = B // 2
        pos_g = state.position.reshape(G, B, ndim).clone()
        lp_g = state.logprob.reshape(G, B).clone()
        for s in (0, 1):
            a0, c0 = s * bh, (1 - s) * bh
            half = None if draws is None else {k: v[s] for k, v in draws.items()}
            mean, chol, ok = rescue_fit_q(pos_g[:, c0:c0 + bh], lp_g[:, c0:c0 + bh])
            act_pos, act_lp = pos_g[:, a0:a0 + bh], lp_g[:, a0:a0 + bh]
            z_y = rescue_t_draw((G, bh, ndim), kw, generator, half)
            prop = mean[:, None, :] + torch.bmm(z_y, chol.transpose(1, 2))
            evals[0] += 1
            lp_prop = _finite(eval_slots(prop, pos_g, a0, bh)).reshape(G, bh)
            z_x = whiten(chol, act_pos - mean[:, None, :])
            log_alpha = ((lp_prop - act_lp) * inv_t
                         + rescue_log_q_t(z_x) - rescue_log_q_t(z_y))
            u = rescue_uniform((G, bh), kw, generator, half)
            accept = ok[:, None] & (torch.log(u) < log_alpha)
            pos_g[:, a0:a0 + bh] = torch.where(accept[..., None], prop, act_pos)
            lp_g[:, a0:a0 + bh] = torch.where(accept, lp_prop, act_lp)
        return _rescued(state, pos_g.reshape(W, ndim), lp_g.reshape(W))

    def rescue_adaptive_full(state, force_cold, generator, draws, evals):
        """The rescue for odd group sizes (kernel.py:1821-1876): q fitted on
        the whole group's typical set, all walkers at once (adaptive, with
        an O(1/W) invariance error)."""
        W = state.position.shape[0]
        kw = dict(dtype=state.position.dtype, device=state.position.device)
        inv_t = 1.0 / resolve_temp(force_cold, state)
        wgt, counts = typical_weights(state.logprob)
        mean = seg_sum(state.position * wgt[:, None]) / counts[:, None]
        mean_w = per_walker(mean, W)
        centered = (state.position - mean_w) * wgt[:, None]
        cov = seg_outer(centered) / counts[:, None, None]
        chol, ok = cholesky_clamped(1.69 * cov)
        ok = ok & (counts > ndim)
        z_y = rescue_t_draw((W, ndim), kw, generator, draws)
        prop = mean_w + mul_l(chol, z_y)
        evals[0] += 1
        lp_prop = _finite(eval_lp(prop))
        G = chol.shape[0]
        z_x = whiten(chol, (state.position - mean_w).reshape(G, -1, ndim)).reshape(W, ndim)
        log_alpha = ((lp_prop - state.logprob) * inv_t
                     + rescue_log_q_t(z_x) - rescue_log_q_t(z_y))
        u = rescue_uniform((W,), kw, generator, draws)
        accept = per_walker(ok, W) & (torch.log(u) < log_alpha)
        return _rescued(state, torch.where(accept[:, None], prop, state.position),
                        torch.where(accept, lp_prop, state.logprob))

    def _rescued(state, position, logprob):
        better = logprob > state.best_logprob
        return dataclasses.replace(
            state, position=position, logprob=logprob,
            best_position=torch.where(better[:, None], position, state.best_position),
            best_logprob=torch.where(better, logprob, state.best_logprob))

    def _finish(state, accept_counts, trace, adapt_enabled, allow_refresh,
                force_cold, generator, noise, evals):
        ones = torch.ones_like(accept_counts)
        group_total = torch.clamp_min(seg_sum(ones) * chunk, 1.0)    # (G,)
        group_accept = seg_sum(accept_counts) / group_total          # (G,)
        if adapt_enabled and not ensemble:
            state = adapt(state, group_accept, bool(allow_refresh))
        else:
            # Adaptation off (many_steps), or an L-free sampler: zero the
            # move moments so stale displacements never poison a later
            # refresh.
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
        if tempered:
            state, out["swap_rate"] = replica_swap(state, force_cold, generator, noise)
        if rescue_on:
            draws = None
            if noise is not None:
                if len(noise) <= N_STEP_DRAWS[sampler]:
                    raise ValueError("noise= lacks the rescue's draws (its last entry)")
                draws = noise[N_STEP_DRAWS[sampler]]
            state = independence_rescue(state, force_cold, generator, draws, evals)
        out["posterior_evals"] = evals[0]
        out["gradient_evals"] = evals[1]
        return state, out

    def _seed(state, generator):
        """A fresh per-chunk key for the chunk kernel, drawn on the device."""
        return torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int32, device=state.position.device)

    def _chunk_kernel_run(state, adapt_enabled, allow_refresh, force_cold, generator,
                          seed):
        dtype = state.position.dtype
        res = chunk_rwm(chunk_kernel, state.position, state.logprob,
                        state.best_position, state.best_logprob,
                        state.l_matrix[0], state.anneal_step,
                        float(force_cold), _seed(state, generator) if seed is None else seed)
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
            anneal_step=state.anneal_step + chunk,
            chees=state.chees)
        trace = torch.stack([res["trace_max"], res["trace_mean"],
                             res["trace_min"]], dim=1).to(dtype)
        return _finish(state, res["accept_counts"].to(dtype), trace,
                       adapt_enabled, allow_refresh, force_cold, generator,
                       None, [0, 0])

    def _run_steps(state, adapt_enabled, allow_refresh, force_cold, generator, noise,
                   history: bool):
        accept_counts = torch.zeros_like(state.logprob)
        traces, positions, logprobs, evals = [], [], [], [0, 0]
        if gradk:
            # One value-and-gradient evaluation starts every chunk
            # (kernel.py:1418-1424); the gradient then rides the steps.
            grad_step = GRAD_STEPS[sampler]
            _, g, _ = vg(state.position, evals)
        for i in range(chunk):
            if gradk:
                state, accf, tr, g = grad_step(state, g, i, force_cold, generator, noise,
                                               evals, bool(adapt_enabled))
            else:
                state, accf, tr = step_fn(state, i, force_cold, generator, noise, evals)
            accept_counts = accept_counts + accf
            traces.append(tr)
            if history and (i + 1) % thin == 0:
                positions.append(state.position)
                logprobs.append(state.logprob)
        state, out = _finish(state, accept_counts, torch.stack(traces), adapt_enabled,
                             allow_refresh, force_cold, generator, noise, evals)
        if history:
            out["positions"] = torch.stack(positions)
            out["logprobs"] = torch.stack(logprobs)
        return state, out

    def run(state: WalkerState, adapt_enabled=True, allow_refresh=True,
            force_cold=False, *, generator=None, noise=None):
        """One chunk: ``chunk_size`` steps + one adaptation update (+ the
        rescue round)."""
        if chunk_kernel is not None and (noise is None or (isinstance(noise, dict)
                                                           and "seed" in noise)):
            return _chunk_kernel_run(state, adapt_enabled, allow_refresh, force_cold,
                                     generator, None if noise is None else noise["seed"])
        return _run_steps(state, adapt_enabled, allow_refresh, force_cold, generator,
                          noise, False)

    def run_with_history(state: WalkerState, adapt_enabled=True,
                         allow_refresh=True, force_cold=False, *,
                         generator=None, noise=None):
        """``run`` that also returns the positions and logprobs after every
        ``thin``-th step: ``(chunk//thin, W, d)`` and ``(chunk//thin, W)``."""
        return _run_steps(state, adapt_enabled, allow_refresh, force_cold, generator,
                          noise, True)

    return run, run_with_history
