"""Batched nested sampling: the evidence and the posterior from one run.

Port of ``lisp_mcmc_tpu/nested.py`` (Skilling 2006, batched): the live set
is a fixed ``(n_live, d)`` tensor; each round deletes the worst
``k_batch`` points at once and refills them by cloning random survivors
and walking each clone ``n_repeat`` hard-constrained differential-evolution
moves (ter Braak pair differences of the survivors) above the batch's
highest deleted likelihood.  Dead points are accounted in likelihood
order with the exact order-statistic shrinkage, so the batching changes
the schedule of the work, not the statistics.  The rounds are a host loop;
the error ``sqrt(H / n_live)`` is information-theoretic.

Every move evaluates its ``(k_batch, d)`` proposals with the walker's
value-only posterior, ``Walker._batched_posterior()``: kernel 1 at W =
``k_batch`` on the GPU for a fit in its coverage (the initial live set is
one evaluation at W = ``n_live``), the plain posterior elsewhere.  The
JAX package reaches the same function through a vmap of one walker's.
``nested_per_dataset`` runs S live sets of a batched fit as one stacked
``(S, n_live, d)`` state on the batch's plain posterior (neither kernel
reads a per-dataset block).

Convention as ``evidence.log_evidence`` and ``smc_sample``: the
log posterior plays the likelihood, the uniform-in-bounds prior the
measure (or, for a named prior, the unit cube of its inverse-CDF map), and
``log_z`` is comparable across the four estimators.

Draws: the initial live set is numpy's (``default_rng(seed)``, as in the
JAX package); each round's clone picks, pair indices and step factors come
from a ``torch.Generator`` seeded from ``seed`` through :func:`_draws`,
which tests replace to replay the JAX package's stream.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .diagnostics import _host64
from .kernel import _neg_floor

__all__ = ["NestedResult", "nested_sample", "nested_per_dataset"]


@dataclasses.dataclass(frozen=True)
class NestedResult:
    """A nested-sampling run: ``log_z`` and its error ``sqrt(H / n_live)``,
    ``h`` the information (nats), the dead points ``samples`` (physical
    parameters) with their log posterior weights and ``logl``, the Kish
    ``ess``, ``n_iter`` rounds, ``logl_max``, and ``insertion_p`` (the KS
    uniformity p of the refills' insertion ranks, Fowlie et al. 2020: low
    means directionally biased refills; blind to clone correlation)."""

    log_z: float
    log_z_err: float
    h: float
    samples: np.ndarray
    log_weights: np.ndarray
    logl: np.ndarray
    ess: float
    n_iter: int
    logl_max: float
    insertion_p: float

    def posterior_draws(self, n: int = 1000, seed: int = 0) -> np.ndarray:
        """Equal-weight posterior draws by weighted resampling (numpy)."""
        w = np.exp(self.log_weights - self.log_weights.max())
        w = w / w.sum()
        idx = np.random.default_rng(seed).choice(len(w), size=n, replace=True, p=w)
        return self.samples[idx]

    def __repr__(self):
        return (f"NestedResult(log_z={self.log_z:.4f} +- {self.log_z_err:.4f}, "
                f"h={self.h:.2f} nats, n_iter={self.n_iter}, ess={self.ess:.0f}, "
                f"insertion_p={self.insertion_p:.3g})")


def _logsumexp(a):
    m = np.max(a)
    if not np.isfinite(m):
        return m
    return float(m + np.log(np.sum(np.exp(a - m))))


def _nested_budget(n_live, k_batch, n_repeat, d, caller="nested_sample"):
    """Checks and defaults of the deletion/refill budget: ``k_batch =
    n_live // 4``, ``n_repeat = 8 d + 16`` (the JAX package's measured
    decorrelation budget, nested.py:118-126)."""
    if k_batch is None:
        k_batch = max(1, n_live // 4)
    if not 1 <= k_batch <= n_live // 2:
        raise ValueError(f"{caller}: need 1 <= k_batch <= n_live/2 "
                         "(refills draw donors from survivors)")
    if n_live - k_batch <= d + 1:
        raise ValueError(
            f"{caller}: {n_live - k_batch} surviving donors span at most a "
            f"{n_live - k_batch - 1}-dim affine subspace of the {d}-dim prior — "
            "raise n_live or lower k_batch")
    if n_repeat is None:
        n_repeat = 8 * d + 16
    return k_batch, n_repeat


def _accumulate_round(log_z, h, log_x_cur, dead_lp_np, delta):
    """One round of Skilling's recurrences with the exact order-statistic
    shrinkage; ``dead_lp_np`` ascending.  Returns ``(log_z, h, log_x_cur,
    logw)``."""
    log_x_hi = log_x_cur - delta[:-1]
    log_x_lo = log_x_cur - delta[1:]
    log_dx = log_x_hi + np.log1p(-np.exp(log_x_lo - log_x_hi))
    logw = log_dx + dead_lp_np
    log_z_new = _logsumexp([log_z, _logsumexp(logw)])
    if np.isfinite(log_z_new) and log_z_new > -1e290:
        terms = np.exp(logw - log_z_new) * dead_lp_np
        h = (math.exp(log_z - log_z_new) * (h + log_z) + float(terms.sum())) - log_z_new \
            if np.isfinite(log_z) else float(terms.sum()) - log_z_new
    return log_z_new, h, log_x_cur - float(delta[-1]), logw


def _close_live(log_z, h, log_x_cur, live_lp_np, n_live):
    """Fold the surviving live set in, each survivor ``X_final / n_live``.
    Returns ``(log_z, h, logw_live)``."""
    logw_live = log_x_cur - math.log(n_live) + live_lp_np
    log_z_new = _logsumexp([log_z, _logsumexp(logw_live)])
    terms = np.exp(logw_live - log_z_new) * live_lp_np
    h = (math.exp(log_z - log_z_new) * (h + log_z) + float(terms.sum())) - log_z_new
    return log_z_new, max(h, 0.0), logw_live


def _insertion_pvalue(ins, n_live, k_batch):
    """KS uniformity p of the insertion ranks on {0..n_live-k_batch}."""
    from scipy.stats import kstest

    ins = np.asarray(ins, np.float64)
    if ins.size < 20:
        return float("nan")
    return float(kstest((ins + 0.5) / (n_live - k_batch + 1.0), "uniform").pvalue)


def _adapt_scale(scale, acc, lo=0.15, hi=0.7, cap=10.0):
    """Steer the DE step scale towards ~50 % constrained acceptance."""
    if acc < lo:
        return scale * 0.7
    if acc > hi:
        return min(scale * 1.3, cap)
    return scale


def _draws(generator, lead, n_live, k_batch, n_repeat, dtype, device):
    """One round's draws for ``lead`` (``(1,)`` or ``(S,)``) live sets:
    ``{"clone": (*lead, k), "j": (n_repeat, *lead, k, 2), "u": (n_repeat,
    *lead, k)}``: the survivor each clone copies (in ``[0, n - k)``), each
    move's two donor draws (``[0, n - k)`` and ``[0, n - k - 1)``, the JAX
    package's per-column maxima) and its step factor in ``[0.5, 1.5)``."""
    kw = dict(generator=generator, device=device)
    m = n_live - k_batch
    shape = (n_repeat, *lead, k_batch)
    return {"clone": torch.randint(0, m, (*lead, k_batch), **kw),
            "j": torch.stack([torch.randint(0, m, shape, **kw),
                              torch.randint(0, m - 1, shape, **kw)], dim=-1),
            "u": 0.5 + torch.rand(shape, dtype=dtype, **kw)}


def _insertion_ranks(surv_lp, lp):
    """How many survivors lie strictly below each refill: ``sum(surv_lp <
    lp)`` (JAX nested.py:350), by a binary search of the ascending
    survivors, O(k log n) instead of a (k, n - k) comparison."""
    return torch.searchsorted(surv_lp.contiguous(), lp.contiguous(), side="left")


def _refill(live, live_lp, loglike, draws, scale, gamma0, k_batch, n_repeat, floor):
    """Delete the ``k_batch`` worst of each live set, refill them by
    constrained DE walks (JAX nested.py:288-351, batched over a leading
    axis of live sets).  ``live`` (B, n, d), ``live_lp`` (B, n),
    ``loglike((B, k, d)) -> (B, k)``, ``scale`` (B,).  Returns ``(live,
    live_lp, dead_pos, dead_lp, acceptance (B,), insertion ranks (B, k))``,
    the dead points ascending in likelihood (a stable sort, so ties keep
    the JAX package's order)."""
    n_sets, n, d = live.shape
    order = torch.argsort(live_lp, dim=1, stable=True)
    dead_idx, surv_idx = order[:, :k_batch], order[:, k_batch:]
    rows = torch.arange(n_sets, device=live.device)[:, None]
    dead_pos, dead_lp = live[rows, dead_idx], live_lp[rows, dead_idx]
    # the constraint: the highest deleted likelihood (JAX nested.py:298-304)
    lmin = live_lp[rows[:, 0], order[:, k_batch - 1]][:, None]
    live_surv, surv_lp = live[rows, surv_idx], live_lp[rows, surv_idx]
    pos, lp = live_surv[rows, draws["clone"]], surv_lp[rows, draws["clone"]]
    step = (scale * gamma0)[:, None, None]
    acc = torch.zeros(n_sets, dtype=live.dtype, device=live.device)
    for r in range(n_repeat):
        j = draws["j"][r]
        j1 = j[..., 0]
        j2 = (j1 + 1 + j[..., 1]) % (n - k_batch)
        diff = live_surv[rows, j1] - live_surv[rows, j2]
        # one fused multiply-add, as XLA contracts the JAX package's
        # expression: the walks amplify a rounding apart ~3x a round
        prop = torch.addcmul(pos, step * draws["u"][r][..., None], diff)
        lp_prop = loglike(prop)
        lp_prop = torch.where(torch.isfinite(lp_prop), lp_prop, floor)
        ok = lp_prop > lmin
        pos = torch.where(ok[..., None], prop, pos)
        lp = torch.where(ok, lp_prop, lp)
        acc = acc + ok.to(live.dtype).mean(dim=1)
    new_live, new_lp = live.clone(), live_lp.clone()
    new_live[rows, dead_idx] = pos
    new_lp[rows, dead_idx] = lp
    return (new_live, new_lp, dead_pos, dead_lp, acc / n_repeat,
            _insertion_ranks(surv_lp, lp))


def _setup(walker, prior, bounds, caller):
    """The resolved prior's sampling box and, for a named prior, the
    u-space map: ``(lo, hi, to_u_posterior, to_theta)``."""
    from .priors import resolve_prior_spec, unit_cube_wall

    spec = resolve_prior_spec(walker, prior, bounds)
    if spec is None:
        raise ValueError(f"{caller}: pass bounds= or prior= (no prior recipe found on the "
                         "fitted terms)")
    keys = walker.spec.keys
    missing = [k for k in keys if k not in spec]
    if missing:
        raise ValueError(f"{caller}: prior/bounds missing {missing}")
    d = len(keys)
    if spec.is_uniform:
        box = spec.bounds
        return (np.asarray([box[k][0] for k in keys], np.float64),
                np.asarray([box[k][1] for k in keys], np.float64), None, None)

    # The named prior's u-space posterior: logpost(F^-1(u)) - installed +
    # wall, the pure likelihood against the prior (JAX nested.py:256-268).
    def in_u(base):
        def post(u):
            th = spec.transform(u, keys)
            return base(th) - spec.installed_vec(th, keys) + unit_cube_wall(u)
        return post

    return np.zeros(d), np.ones(d), in_u, lambda u: spec.transform(u, keys)


def _finish(dead_pos, dead_lp, logw, live, live_lp, log_z, h, log_x_cur, n_live,
            k_batch, insertion, n_iter, to_theta, dtype, device):
    """Close a run with its live set and build its :class:`NestedResult`."""
    log_z, h, logw_live = _close_live(log_z, h, log_x_cur, live_lp, n_live)
    order = np.argsort(live_lp)
    samples = np.concatenate(dead_pos + [live[order]])
    if to_theta is not None:
        samples = to_theta(torch.as_tensor(samples, dtype=dtype, device=device))
        samples = samples.detach().cpu().numpy().astype(np.float64)
    logl = np.concatenate(dead_lp + [live_lp[order]])
    logw = np.concatenate(logw + [logw_live[order]])
    wn = np.exp(logw - logw.max())
    return NestedResult(
        log_z=float(log_z), log_z_err=float(math.sqrt(h / n_live)), h=float(h),
        samples=samples, log_weights=logw, logl=logl,
        ess=float(wn.sum() ** 2 / np.sum(wn ** 2)), n_iter=int(n_iter),
        logl_max=float(np.max(logl)),
        insertion_p=_insertion_pvalue(np.concatenate(insertion), n_live, k_batch))


def _shrinkage(n_live, k_batch):
    """``delta[j] = E[-ln(X_(j) / X_round_start)]``, the harmonic-number
    difference ``H_n - H_{n-j}`` (the linear ``j / n`` under-shrinks by
    ~0.038 nats a round at k = n/4; JAX nested.py:358-370)."""
    harmonic = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, n_live + 1))])
    return harmonic[n_live] - harmonic[n_live - np.arange(k_batch + 1)]


def nested_sample(walker, bounds=None, n_live: int = 1024, k_batch: int | None = None,
                  n_repeat: int | None = None, stop_frac: float = 1e-4,
                  max_iter: int = 10_000, seed: int = 0, prior=None,
                  on_round=None) -> NestedResult:
    """Batched nested sampling on the walker's posterior (JAX
    ``nested_sample``, nested.py:184-438).

    ``bounds`` is the box prior, ``prior`` a named ``PriorSpec`` (the run
    then lives in its unit cube, ``theta = F^-1(u)``; ``samples`` are
    physical); either may come from the fitted terms.  ``k_batch`` points
    (default ``n_live // 4``) are deleted and refilled a round, each refill
    by ``n_repeat`` constrained DE moves (default ``8 d + 16``).  The run
    stops when ``max L_live X`` falls below ``stop_frac`` of the
    accumulated evidence.  ``on_round(info)`` sees ``{"round", "log_x",
    "log_z_partial", "acceptance", "scale", "logl_max_live"}`` each round;
    True closes the run early with its live set.  The walker's ensemble is
    untouched."""
    if getattr(walker, "aux", None) is not None:
        raise ValueError("nested_sample: batched/grouped fits run one live set per "
                         "dataset — use nested_per_dataset")
    lo, hi, in_u, to_theta = _setup(walker, prior, bounds, "nested_sample")
    d = walker.spec.ndim
    k_batch, n_repeat = _nested_budget(n_live, k_batch, n_repeat, d)
    dtype, device = walker.dtype, walker.device
    base = walker._batched_posterior()
    post = base if in_u is None else in_u(base)
    floor = _neg_floor(dtype)

    def loglike(pos):                                 # (1, k, d) -> (1, k)
        return post(pos[0])[None]

    rng = np.random.default_rng(seed)
    live = torch.as_tensor(rng.uniform(lo, hi, size=(n_live, d)), dtype=dtype,
                           device=device)[None]
    live_lp = post(live[0])[None]
    live_lp = torch.where(torch.isfinite(live_lp), live_lp, floor)
    gamma0 = 2.38 / math.sqrt(2.0 * d)
    delta = _shrinkage(n_live, k_batch)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))

    dead_pos_all, dead_lp_all, logw_all, insertion_all = [], [], [], []
    log_z, h, log_x_cur, scale = -np.inf, 0.0, 0.0, 1.0
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        draws = _draws(generator, (1,), n_live, k_batch, n_repeat, dtype, device)
        live, live_lp, dead_pos, dead_lp, acc, ins = _refill(
            live, live_lp, loglike, draws,
            torch.full((1,), scale, dtype=dtype, device=device), gamma0, k_batch,
            n_repeat, floor)
        insertion_all.append(ins[0].cpu().numpy().astype(np.int64))
        dead_lp_np = _host64(dead_lp[0])
        log_z, h, log_x_cur, logw = _accumulate_round(log_z, h, log_x_cur, dead_lp_np,
                                                      delta)
        dead_pos_all.append(_host64(dead_pos[0]))
        dead_lp_all.append(dead_lp_np)
        logw_all.append(logw)
        acc_f = float(acc[0])
        scale = _adapt_scale(scale, acc_f)
        logl_max_live = float(live_lp.max())
        if on_round is not None and on_round({
                "round": n_iter, "log_x": log_x_cur, "log_z_partial": float(log_z),
                "acceptance": acc_f, "scale": scale, "logl_max_live": logl_max_live}):
            break
        if logl_max_live + log_x_cur < log_z + math.log(stop_frac):
            break
    return _finish(dead_pos_all, dead_lp_all, logw_all, _host64(live[0]),
                   _host64(live_lp[0]), log_z, h, log_x_cur, n_live, k_batch,
                   insertion_all, n_iter, to_theta, dtype, device)


def nested_per_dataset(fit, bounds=None, n_live: int = 512, k_batch: int | None = None,
                       n_repeat: int | None = None, stop_frac: float = 1e-4,
                       max_iter: int = 10_000, seed: int = 0, prior=None,
                       on_round=None) -> list[NestedResult]:
    """S nested-sampling runs of a batched fit at once (JAX
    ``nested_per_dataset``, nested.py:441-684): one ``(n_live, d)`` live set
    a dataset, stacked ``(S, n_live, d)``; each round's refills of all S
    datasets are one ``(S, k_batch, d)`` evaluation a move, on the batch's
    plain posterior.  Each dataset closes on its own ``stop_frac`` with
    that round's live set, while the stacked state keeps moving.  One
    prior for the batch.  ``on_round(info)`` sees ``(S,)`` arrays
    (``log_z_partial``, ``acceptance``, ``done``); True closes every
    unfinished run.  Returns S :class:`NestedResult`."""
    if getattr(fit, "aux", None) is None or getattr(fit, "n_groups", 1) in (None, 1):
        raise ValueError("nested_per_dataset: needs a grouped/batched fit "
                         "(plain fits use nested_sample)")
    S = int(fit.n_groups)
    lo, hi, in_u, to_theta = _setup(fit, prior, bounds, "nested_per_dataset")
    d = fit.spec.ndim
    k_batch, n_repeat = _nested_budget(n_live, k_batch, n_repeat, d,
                                       caller="nested_per_dataset")
    dtype, device = fit.dtype, fit.device
    # (S, m, d) -> (S, m): each dataset's posterior at its own m points
    base = getattr(fit, "_dataset_posterior", None)
    if base is None:
        raise ValueError("nested_per_dataset: needs a batched fit (BatchedFit), whose "
                         "posterior evaluates each dataset at any number of points")
    loglike = base if in_u is None else in_u(base)
    floor = _neg_floor(dtype)

    rng = np.random.default_rng(seed)
    live = torch.as_tensor(rng.uniform(lo, hi, size=(S, n_live, d)), dtype=dtype,
                           device=device)
    live_lp = loglike(live)
    live_lp = torch.where(torch.isfinite(live_lp), live_lp, floor)
    gamma0 = 2.38 / math.sqrt(2.0 * d)
    delta = _shrinkage(n_live, k_batch)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))

    dead_pos_all = [[] for _ in range(S)]
    dead_lp_all = [[] for _ in range(S)]
    logw_all = [[] for _ in range(S)]
    insertion_all = [[] for _ in range(S)]
    log_z = np.full(S, -np.inf)
    h = np.zeros(S)
    log_x_cur = np.zeros(S)
    scale = np.ones(S)
    done = np.zeros(S, bool)
    n_iter_s = np.zeros(S, np.int64)
    live_final: list = [None] * S
    live_lp_final: list = [None] * S
    for n_iter in range(1, max_iter + 1):
        draws = _draws(generator, (S,), n_live, k_batch, n_repeat, dtype, device)
        live, live_lp, dead_pos, dead_lp, acc, ins = _refill(
            live, live_lp, loglike, draws, torch.as_tensor(scale, dtype=dtype,
                                                           device=device),
            gamma0, k_batch, n_repeat, floor)
        dead_lp_np, dead_pos_np = _host64(dead_lp), _host64(dead_pos)
        acc_np = _host64(acc)
        ins_np = ins.cpu().numpy().astype(np.int64)
        live_lp_np = _host64(live_lp)
        for s in range(S):
            if done[s]:
                continue
            insertion_all[s].append(ins_np[s])
            log_z[s], h[s], log_x_cur[s], logw = _accumulate_round(
                log_z[s], h[s], log_x_cur[s], dead_lp_np[s], delta)
            dead_pos_all[s].append(dead_pos_np[s])
            dead_lp_all[s].append(dead_lp_np[s])
            logw_all[s].append(logw)
            n_iter_s[s] = n_iter
            scale[s] = _adapt_scale(scale[s], float(acc_np[s]))
            if live_lp_np[s].max() + log_x_cur[s] < log_z[s] + math.log(stop_frac):
                # closed with this round's live set; later moves of the
                # stacked state belong to a deeper shell than its estimate
                done[s] = True
                live_final[s] = _host64(live[s])
                live_lp_final[s] = live_lp_np[s].copy()
        stop_all = on_round is not None and bool(on_round({
            "round": n_iter, "log_x": log_x_cur.copy(), "log_z_partial": log_z.copy(),
            "acceptance": acc_np, "scale": scale.copy(), "done": done.copy()}))
        if done.all() or stop_all:
            break
    live_np, live_lp_np = _host64(live), _host64(live_lp)
    results = []
    for s in range(S):
        if live_final[s] is None:
            live_final[s], live_lp_final[s] = live_np[s], live_lp_np[s]
        results.append(_finish(dead_pos_all[s], dead_lp_all[s], logw_all[s],
                               live_final[s], live_lp_final[s], log_z[s], h[s],
                               log_x_cur[s], n_live, k_batch, insertion_all[s],
                               n_iter_s[s], to_theta, dtype, device))
    return results
