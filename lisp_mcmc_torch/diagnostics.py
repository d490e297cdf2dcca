"""Convergence numbers, model criticism and refit cross-validation.

Port of ``lisp_mcmc_tpu/diagnostics.py``:

- per parameter (``:33-417``): ESS, split R-hat, rank-normalised R-hat,
  tail ESS and the MCSE of the mean, the Vehtari-2021 convergence verdict
  (``convergence``, ``convergence_per_dataset``), the metrics snapshot and
  the printed report, and ``trace_profile`` (``torch.profiler``).  A
  grouped fit holds one population per adaptation group; each is reduced
  on its own and the worst case reported.  The reductions run where the
  history lies; only ``d`` scalars reach the host;
- pointwise comparison (``:420-891``, ``:1663-1767``): ``waic``, PSIS
  ``loo`` with Pareto k, ``loo_pit``, the paired comparisons,
  ``model_weights`` (stacking, pseudo-BMA+) and ``evidence_weights``;
- report cards (``:893-1226``): ``audit`` and power-scaling
  ``prior_sensitivity``;
- refit cross-validation (``:280-334``, ``:1227-1661``):
  ``grouped_refit_health``, ``reloo`` and ``kfold``, whose K leave-out
  posteriors run as the adaptation groups of one grouped walker.

The (S, N) pointwise log-likelihood matrix is one batched torch call per
term over the S history rows, on the walker's device; the reductions over
it (PSIS, the KS test, the CJS distances, the stacking ascent) are numpy
on the host, copies of the JAX package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import warnings
from typing import Any

import numpy as np
import torch

from .ops.reductions import (effective_sample_size, mcse_mean, rank_normalized_rhat,
                             split_rhat, tail_ess)

__all__ = ["metrics", "ess_per_param", "ess_from_history", "rhat_per_param",
           "rhat_from_history", "rank_rhat_per_param", "tail_ess_per_param",
           "mcse_per_param", "merge_worst_verdict", "convergence",
           "convergence_per_dataset", "summary", "trace_profile",
           "WAICResult", "waic", "waic_compare", "LOOResult", "loo", "loo_compare",
           "LOOPITResult", "loo_pit", "AuditResult", "audit", "PriorSensitivityResult",
           "prior_sensitivity", "grouped_refit_health", "reloo", "KFoldResult", "kfold",
           "model_weights", "evidence_weights"]


@contextlib.contextmanager
def trace_profile(log_dir: str | None = None):
    """Context manager: a ``torch.profiler`` trace of what runs inside it,
    CPU and (where there is one) CUDA activity, written as a Chrome trace
    ``trace.json`` under ``log_dir`` (default: ``lisp_mcmc_torch_trace``
    in the temporary directory).  View it with Perfetto::

        with trace_profile("fit_trace"):
            walker.adaptive_steps(30000)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lisp_mcmc_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _history_blocks(walker, take):
    """One ``(T, B, d)`` history tensor per population (adaptation group):
    walkers of different groups target different posteriors."""
    from .fit import history_block_columns

    pos, _ = walker._history(take)
    pos = torch.as_tensor(pos)
    cols = history_block_columns(walker, pos.shape[1])
    if len(cols) == 1:
        yield pos
        return
    for c in cols:
        yield pos[:, torch.as_tensor(c, device=pos.device), :]


def ess_from_history(positions, keys) -> dict[str, float]:
    """ESS per parameter from a ``(T, W, d)`` history."""
    positions = torch.as_tensor(positions)
    return {k: float(effective_sample_size(positions[:, :, i]))
            for i, k in enumerate(keys)}


def rhat_from_history(positions, keys) -> dict[str, float]:
    """Split R-hat per parameter from a ``(T, W, d)`` history."""
    positions = torch.as_tensor(positions)
    return {k: float(split_rhat(positions[:, :, i])) for i, k in enumerate(keys)}


def ess_per_param(walker, take: int | None = None) -> dict[str, float]:
    """ESS per parameter (the worst group's)."""
    out = None
    for block in _history_blocks(walker, take):
        e = ess_from_history(block, walker.spec.keys)
        out = e if out is None else {k: min(out[k], e[k]) for k in e}
    return out or {}


def rhat_per_param(walker, take: int | None = None) -> dict[str, float]:
    """Split R-hat per parameter (the worst group's)."""
    out = None
    for block in _history_blocks(walker, take):
        r = rhat_from_history(block, walker.spec.keys)
        out = r if out is None else {k: max(out[k], r[k]) for k in r}
    return out or {}


def rank_rhat_per_param(walker, take: int | None = None) -> dict[str, tuple[float, float]]:
    """(bulk, tail) rank-normalised split R-hat per parameter (the worst
    group's); pass when ``max(bulk, tail) < 1.01``."""
    out = None
    for pos in _history_blocks(walker, take):
        r = {k: tuple(float(v) for v in rank_normalized_rhat(pos[:, :, i]))
             for i, k in enumerate(walker.spec.keys)}
        out = r if out is None else {
            k: (max(out[k][0], r[k][0]), max(out[k][1], r[k][1])) for k in r}
    return out or {}


def tail_ess_per_param(walker, take: int | None = None) -> dict[str, float]:
    """Tail (5 %/95 % exceedance) ESS per parameter (the worst group's)."""
    out = None
    for pos in _history_blocks(walker, take):
        t = {k: float(tail_ess(pos[:, :, i])) for i, k in enumerate(walker.spec.keys)}
        out = t if out is None else {k: min(out[k], t[k]) for k in t}
    return out or {}


def mcse_per_param(walker, take: int | None = None) -> dict[str, float]:
    """MCSE of each parameter's posterior mean (the worst group's)."""
    out = None
    for pos in _history_blocks(walker, take):
        m = {k: float(mcse_mean(pos[:, :, i])) for i, k in enumerate(walker.spec.keys)}
        out = m if out is None else {k: max(out[k], m[k]) for k in m}
    return out or {}


def merge_worst_verdict(out: dict[str, Any], v: dict[str, Any], keys) -> None:
    """Fold verdict ``v`` into ``out`` in place, keeping the worst case per
    key: the larger rank R-hats, the smaller tail ESS, the larger MCSE."""
    for k in keys:
        if k in out["rank_rhat"]:
            b0, t0 = out["rank_rhat"][k]
            b1, t1 = v["rank_rhat"][k]
            out["rank_rhat"][k] = (max(b0, b1), max(t0, t1))
            out["tail_ess"][k] = min(out["tail_ess"][k], v["tail_ess"][k])
            out["mcse"][k] = max(out["mcse"][k], v["mcse"][k])
        else:
            out["rank_rhat"][k] = v["rank_rhat"][k]
            out["tail_ess"][k] = v["tail_ess"][k]
            out["mcse"][k] = v["mcse"][k]


def _verdict_failures(out, keys, rhat_tol: float, min_tail_ess: float) -> list[str]:
    failures = []
    for k in keys:
        bulk, tail = out["rank_rhat"][k]
        if max(bulk, tail) >= rhat_tol:
            failures.append(f"{k}: rank R-hat {max(bulk, tail):.4f} >= {rhat_tol}")
        if out["tail_ess"][k] < min_tail_ess:
            failures.append(f"{k}: tail ESS {out['tail_ess'][k]:.0f} < {min_tail_ess:.0f}")
    return failures


def _block_verdict(pos, keys, rhat_tol: float, min_tail_ess: float) -> dict[str, Any]:
    """The verdict of one ``(T, B, d)`` block."""
    out: dict[str, Any] = {"rank_rhat": {}, "tail_ess": {}, "mcse": {}}
    for i, k in enumerate(keys):
        x = pos[:, :, i]
        bulk, tail = (float(v) for v in rank_normalized_rhat(x))
        out["rank_rhat"][k] = (bulk, tail)
        out["tail_ess"][k] = float(tail_ess(x))
        out["mcse"][k] = float(mcse_mean(x))
    failures = _verdict_failures(out, keys, rhat_tol, min_tail_ess)
    out["ok"] = not failures
    out["failures"] = failures
    return out


def convergence(walker, take: int | None = None, rhat_tol: float = 1.01,
                min_tail_ess: float = 100.0) -> dict[str, Any]:
    """The Vehtari et al. (2021) verdict per parameter: bulk and tail rank
    R-hat below ``rhat_tol`` and tail ESS at least ``min_tail_ess``;
    ``{"ok", "failures", "rank_rhat", "tail_ess", "mcse"}``, the worst
    group's for a grouped fit."""
    keys = walker.spec.keys
    out: dict[str, Any] = {"rank_rhat": {}, "tail_ess": {}, "mcse": {}}
    for pos in _history_blocks(walker, take):
        merge_worst_verdict(out, _block_verdict(pos, keys, rhat_tol, min_tail_ess), keys)
    failures = _verdict_failures(out, keys, rhat_tol, min_tail_ess)
    out["ok"] = not failures
    out["failures"] = failures
    return out


def convergence_per_dataset(walker, take: int | None = None, rhat_tol: float = 1.01,
                            min_tail_ess: float = 100.0) -> list[dict[str, Any]]:
    """One :func:`convergence`-shaped verdict per group (one for a plain fit)."""
    keys = walker.spec.keys
    return [_block_verdict(pos, keys, rhat_tol, min_tail_ess)
            for pos in _history_blocks(walker, take)]


def metrics(walker, take: int | None = None,
            elapsed_seconds: float | None = None) -> dict[str, Any]:
    """A metrics snapshot: age, walkers, acceptance, the best point, the
    logprob quantiles, ESS, R-hat and MCSE per parameter (the worst
    group's), and the throughput when ``elapsed_seconds`` is given."""
    from .fit import history_block_columns

    lp_best, best = walker.most_likely_step()
    pos, lp = walker._history(take)
    pos = torch.as_tensor(pos)
    keys = walker.spec.keys
    ess, rhat, mcse = None, None, None
    for cols in history_block_columns(walker, pos.shape[1]):
        blk = pos[:, torch.as_tensor(cols, device=pos.device), :]
        e = ess_from_history(blk, keys)
        r = rhat_from_history(blk, keys)
        m = {k: float(torch.sqrt(torch.var(blk[:, :, i], correction=1) / max(e[k], 1.0)))
             for i, k in enumerate(keys)}
        ess = e if ess is None else {k: min(ess[k], e[k]) for k in e}
        rhat = r if rhat is None else {k: max(rhat[k], r[k]) for k in r}
        mcse = m if mcse is None else {k: max(mcse[k], m[k]) for k in m}
    ess, rhat, mcse = ess or {}, rhat or {}, mcse or {}
    lp = np.asarray(lp)
    out = {
        "age": walker.age,
        "n_walkers": walker.n_walkers,
        "acceptance": walker.acceptance(take),
        "best_logprob": lp_best,
        "best_params": best,
        "logprob_quantiles": {
            "p05": float(np.quantile(lp, 0.05)),
            "p50": float(np.quantile(lp, 0.50)),
            "p95": float(np.quantile(lp, 0.95)),
        },
        "ess": ess,
        "min_ess": min(ess.values()) if ess else 0.0,
        "rhat": rhat,
        "mcse": mcse,
    }
    if elapsed_seconds:
        out["chain_steps_per_sec"] = walker.age * walker.n_walkers / elapsed_seconds
        out["ess_per_sec"] = out["min_ess"] / elapsed_seconds
    return out


def summary(walker, take: int | None = None) -> str:
    """The printed fit report (the walker-step printout, test.lisp:26-30)."""
    m = metrics(walker, take)
    lines = [
        f"walker ensemble: {m['n_walkers']} walkers x {m['age']} steps, "
        f"acceptance {m['acceptance']:.3f}",
        f"best log-posterior: {m['best_logprob']:.6f}",
        "params (best | MCSE | R-hat | ESS):",
    ]
    for k in walker.spec.keys:
        lines.append(
            f"  {k:>12s} = {m['best_params'][k]: .8g} "
            f"+- {m['mcse'][k]:.2g}   "
            f"R-hat {m['rhat'][k]:.3f}   ESS {m['ess'][k]:.0f}")
    if (getattr(walker, "config", None) is not None and walker.config.kernel == "chees"
            and hasattr(walker, "chees_trajectory")):
        tr = walker.chees_trajectory()
        cap = " AT CAP — raise chees_max_leapfrog" if tr["at_cap"] else ""
        t = ", ".join(f"{v:.1f}" for v in np.atleast_1d(tr["leapfrog"]))
        lines.append(f"chees trajectory: {t} leapfrog steps (budget {tr['budget']}{cap})")
    return "\n".join(lines)


# ------------------------------------------------------ refit collapse gate

# The collapse gate of a grouped refit (JAX diagnostics.py:250-277): tail
# ESS per coordinate and the share of walker-rows that moved between
# retained rows.  It catches blocks whose "exact" elpd would be silently
# wrong (chains frozen, or too few effective draws), not convergence.
REFIT_GATE_MIN_ESS = 20.0
REFIT_GATE_MIN_MOVE = 0.05


def grouped_refit_health(fit, name: str, min_tail_ess: float = REFIT_GATE_MIN_ESS,
                         min_move_frac: float = REFIT_GATE_MIN_MOVE,
                         warn: bool = True) -> np.ndarray:
    """Per-block collapse gate of a grouped refit ensemble (JAX
    ``grouped_refit_health``, diagnostics.py:280-332): a ``(K,)`` boolean
    array, block j True when its retained history has tail ESS >=
    ``min_tail_ess`` on every coordinate and a walker-row move fraction >=
    ``min_move_frac``; warns on failures.  A block with at most one
    retained row sampled nothing and fails.  The tail ESS of every
    coordinate comes from one call over the coordinate axis."""
    ok_list, why = [], []
    for j, pos in enumerate(_history_blocks(fit, None)):
        if pos.shape[0] <= 1:
            ok_list.append(False)
            why.append(f"block {j}: <= 1 retained history row")
            continue
        worst = float(tail_ess(pos).min())
        moved = float(torch.any(torch.diff(pos, dim=0) != 0.0, dim=-1)
                      .to(torch.float64).mean())
        block_ok = worst >= min_tail_ess and moved >= min_move_frac
        ok_list.append(block_ok)
        if not block_ok:
            why.append(f"block {j}: min tail ESS {worst:.0f}, move fraction {moved:.3f}")
    ok = np.asarray(ok_list, dtype=bool)
    if warn and not ok.all():
        warnings.warn(
            f"{name}: {int((~ok).sum())}/{ok.size} refit blocks failed the collapse "
            f"gate (tail ESS >= {min_tail_ess} and move fraction >= {min_move_frac}): "
            f"{'; '.join(why)} — their values are marked unreliable in the result; "
            "raise n_steps / walkers_per_dataset or simplify the held-out geometry",
            stacklevel=3)
    return ok


# ------------------------------------------------------------------ WAIC


@dataclasses.dataclass(frozen=True)
class WAICResult:
    """WAIC of one fit: ``elpd`` (higher is better), ``p_waic`` the
    effective parameter count, ``lppd``, ``se`` over the points, and the
    per-point ``pointwise`` elpd of the real points; ``waic = -2 elpd``."""

    elpd: float
    p_waic: float
    lppd: float
    se: float
    n_points: int
    n_samples: int
    pointwise: np.ndarray

    @property
    def waic(self) -> float:
        return -2.0 * self.elpd

    def __repr__(self):
        return (f"WAICResult(elpd={self.elpd:.3f} +- {self.se:.3f}, "
                f"p_waic={self.p_waic:.2f}, n_points={self.n_points}, "
                f"n_samples={self.n_samples})")


def _host64(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)).astype(
        np.float64)


def _history_samples(walker, name: str, take: int | None, max_samples: int):
    """At most ``max_samples`` evenly spaced rows of ``walker.steps(take)``
    (``np.linspace`` over the flattened history, as the JAX package thins
    it), as an ``(S, d)`` tensor on the walker's device."""
    pos, _ = walker.steps(take)
    if pos.shape[0] == 0:
        raise ValueError(f"{name}: no collected history (run adaptive_steps "
                         "with collect_history=True first)")
    n_avail = pos.shape[0]
    idx = np.unique(np.linspace(0, n_avail - 1, min(max_samples, n_avail)).astype(int))
    return torch.as_tensor(np.asarray(pos)[idx], dtype=walker.dtype, device=walker.device)


def _term_matrix(walker, samples, per_point) -> np.ndarray:
    """``per_point(likelihood, fn, columns, dataset)`` of every term at the
    ``(S, d)`` samples, one batched call a term (the parameters as ``(S,
    1)`` columns), concatenated term-major over the real points."""
    cols = walker.spec.unflatten(samples)
    pts = {k: v[:, None] for k, v in cols.items()}
    blocks, masks = [], []
    for t in walker.terms:
        blocks.append(_host64(per_point(t.likelihood, t.fn, pts, t.dataset)))
        masks.append(_host64(t.dataset.mask))
    return np.concatenate(blocks, axis=1)[:, np.concatenate(masks) > 0.0]


def _pointwise_ll_matrix(walker, name: str, take: int | None, max_samples: int):
    """``(ll (S, N), samples (S, d))``: the pointwise log-likelihood over
    history rows and real points (JAX diagnostics.py:448-504), the shared
    front end of :func:`waic`, :func:`loo`, :func:`loo_pit` and
    :func:`prior_sensitivity`.  Refuses grouped fits and custom posteriors;
    a walker with a ``_pointwise_ll(samples) -> (S, N)`` hook (a
    structured ensemble whose likelihood still decomposes) takes it."""
    if getattr(walker, "group_ids", None) is not None:
        raise ValueError(f"{name}: grouped/batched fits mix per-dataset "
                         "populations in one history; compute per "
                         "dataset (BatchedFit -> per-dataset walkers)")
    hook = getattr(walker, "_pointwise_ll", None)
    if hook is None and (getattr(walker, "_custom_log_post", None) is not None
                         or getattr(walker, "_custom_batched", None) is not None):
        raise ValueError(f"{name}: custom posteriors have no per-point "
                         "likelihood decomposition")
    from .likelihoods import pointwise_log_likelihood

    samples = _history_samples(walker, name, take, max_samples)
    if hook is not None:
        return _host64(hook(samples)), samples
    return _term_matrix(walker, samples, pointwise_log_likelihood), samples


def _lppd(ll: np.ndarray) -> np.ndarray:
    mx = ll.max(axis=0)
    return mx + np.log(np.mean(np.exp(ll - mx), axis=0))


def _se(pointwise: np.ndarray) -> float:
    n = pointwise.size
    return float(np.sqrt(n * pointwise.var(ddof=1))) if n > 1 else 0.0


def waic(walker, take: int | None = None, max_samples: int = 512) -> WAICResult:
    """WAIC from the walker's history (JAX ``waic``, diagnostics.py:507-553):

        lppd_i = log mean_s exp(ll[s, i]),  p_i = var_s ll[s, i]
        elpd = sum_i (lppd_i - p_i),  se = sqrt(n var_i(elpd_i))

    over at most ``max_samples`` evenly spaced history rows (of the last
    ``take`` steps).  The history must hold posterior draws: burn the
    anneal first.  Decomposable likelihoods only; per dataset on batches.
    """
    ll, _ = _pointwise_ll_matrix(walker, "waic", take, max_samples)
    s_count = ll.shape[0]
    lppd_i = _lppd(ll)
    p_i = ll.var(axis=0, ddof=1) if s_count > 1 else np.zeros_like(lppd_i)
    elpd_i = lppd_i - p_i
    return WAICResult(elpd=float(elpd_i.sum()), p_waic=float(p_i.sum()),
                      lppd=float(lppd_i.sum()), se=_se(elpd_i), n_points=int(elpd_i.size),
                      n_samples=int(s_count), pointwise=elpd_i)


def _paired_elpd_compare(a, b, name: str) -> dict[str, float]:
    if a.n_points != b.n_points:
        raise ValueError(f"{name}: models were scored on different data "
                         f"({a.n_points} vs {b.n_points} points)")
    d = a.pointwise - b.pointwise
    return {"elpd_diff": float(d.sum()), "se_diff": _se(d)}


def waic_compare(a: WAICResult, b: WAICResult) -> dict[str, float]:
    """Paired comparison of two fits to the same data: ``elpd_diff =
    elpd(a) - elpd(b)`` and its paired standard error."""
    return _paired_elpd_compare(a, b, "waic_compare")


# ------------------------------------------------------------- PSIS-LOO


@dataclasses.dataclass(frozen=True)
class LOOResult:
    """PSIS-LOO: ``elpd``, ``p_loo = lppd - elpd``, ``se``, the per-point
    ``pointwise`` elpd and ``pareto_k`` tail shapes (k > 0.7 unreliable,
    counted by ``n_bad_k``); ``refit_failed``: the points whose exact refit
    (``reloo``) failed the collapse gate and kept their PSIS value."""

    elpd: float
    p_loo: float
    lppd: float
    se: float
    n_points: int
    n_samples: int
    pointwise: np.ndarray
    pareto_k: np.ndarray
    refit_failed: tuple = ()

    @property
    def looic(self) -> float:
        return -2.0 * self.elpd

    @property
    def n_bad_k(self) -> int:
        return int(np.sum(self.pareto_k > 0.7))

    def __repr__(self):
        return (f"LOOResult(elpd={self.elpd:.3f} +- {self.se:.3f}, "
                f"p_loo={self.p_loo:.2f}, n_points={self.n_points}, "
                f"n_samples={self.n_samples}, max_k={self.pareto_k.max():.2f}, "
                f"n_bad_k={self.n_bad_k})")


def _gpd_fit(excess: np.ndarray) -> tuple[float, float]:
    """Generalized-Pareto (shape k, scale sigma) by Zhang & Stephens' (2009)
    profile-posterior estimator with the PSIS paper's weak prior on k
    (JAX ``_gpd_fit``, diagnostics.py:625-671).  ``excess``: the ascending
    positive exceedances; ``(nan, nan)`` where the fit degenerates."""
    x = np.asarray(excess, np.float64)
    n = x.size
    if n < 5 or not np.isfinite(x[-1]) or x[-1] <= 0.0:
        return float("nan"), float("nan")
    quart = x[max(int(n / 4.0 + 0.5) - 1, 0)]
    if quart <= 0.0:
        return float("nan"), float("nan")
    m = 30 + int(np.sqrt(n))
    j = np.arange(1.0, m + 1.0)
    theta = 1.0 / x[-1] + (1.0 - np.sqrt(m / (j - 0.5))) / (3.0 * quart)
    k_of_theta = np.mean(np.log1p(-theta[:, None] * x[None, :]), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        prof = n * (np.log(-theta / k_of_theta) - k_of_theta - 1.0)
    prof = np.where(np.isfinite(prof), prof, -np.inf)
    if not np.any(np.isfinite(prof)):
        return float("nan"), float("nan")
    w = np.exp(prof - prof.max())
    w_sum = w.sum()
    if not np.isfinite(w_sum) or w_sum <= 0.0:
        return float("nan"), float("nan")
    theta_hat = float(np.sum(theta * w) / w_sum)
    k_hat = float(np.mean(np.log1p(-theta_hat * x)))
    # sigma from the unregularized pair (sigma = -k/theta > 0 by
    # construction), then the prior's pull of k towards 0.5.
    sigma = -k_hat / theta_hat
    k_hat = (n * k_hat + 10.0 * 0.5) / (n + 10.0)
    if not np.isfinite(sigma) or sigma <= 0.0 or not np.isfinite(k_hat):
        return float("nan"), float("nan")
    return k_hat, sigma


def _gpd_quantile(p: np.ndarray, k: float, sigma: float) -> np.ndarray:
    """Inverse CDF of the generalized Pareto (:func:`_gpd_fit`'s convention)."""
    if abs(k) < 1e-12:
        return sigma * (-np.log1p(-p))
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def _psis_smooth(lw: np.ndarray) -> tuple[np.ndarray, float]:
    """Pareto-smooth one vector of log importance ratios (JAX
    ``_psis_smooth``, diagnostics.py:681-710): the largest ``M = min(S/5,
    3 sqrt(S))`` ratios become the fitted GPD's expected order statistics,
    truncated at the raw maximum.  Returns the max-shifted log-weights and
    the tail shape k (inf when no tail can be fitted)."""
    s = lw.size
    lw = lw - lw.max()
    m = int(min(0.2 * s, 3.0 * np.sqrt(s)))
    if m < 5:
        return lw, float("inf")
    order = np.argsort(lw)
    tail_ids = order[-m:]
    cutoff = np.exp(lw[order[-m - 1]])
    excess = np.exp(lw[tail_ids]) - cutoff
    if excess[-1] <= 0.0:
        return lw, float("inf")
    k, sigma = _gpd_fit(excess)
    if not np.isfinite(k):
        return lw, float("inf")
    probs = (np.arange(m) + 0.5) / m
    smoothed = np.log(cutoff + _gpd_quantile(probs, k, sigma))
    lw = lw.copy()
    lw[tail_ids] = np.minimum(smoothed, 0.0)
    return lw, k


def _logsumexp(a: np.ndarray) -> float:
    mx = a.max()
    return float(mx + np.log(np.sum(np.exp(a - mx))))


def loo(walker, take: int | None = None, max_samples: int = 512) -> LOOResult:
    """PSIS-LOO from the walker's history (JAX ``loo``, diagnostics.py:713-753):
    per point, the full-posterior draws reweighted by ``1/p(y_i|theta_s)``
    with Pareto-smoothed tails, ``elpd_i = log sum_s w_si p(y_i|theta_s)``.
    Same history and likelihood requirements as :func:`waic`."""
    ll, _ = _pointwise_ll_matrix(walker, "loo", take, max_samples)
    s_count, n = ll.shape
    lppd_i = _lppd(ll)
    elpd_i = np.empty(n)
    k_i = np.empty(n)
    for i in range(n):
        lw, k_i[i] = _psis_smooth(-ll[:, i])
        lw = lw - _logsumexp(lw)
        elpd_i[i] = _logsumexp(lw + ll[:, i])
    return LOOResult(elpd=float(elpd_i.sum()), p_loo=float((lppd_i - elpd_i).sum()),
                     lppd=float(lppd_i.sum()), se=_se(elpd_i), n_points=int(n),
                     n_samples=int(s_count), pointwise=elpd_i, pareto_k=k_i)


def loo_compare(a: LOOResult, b: LOOResult) -> dict[str, float]:
    """Paired LOO comparison, as :func:`waic_compare`."""
    return _paired_elpd_compare(a, b, "loo_compare")


# --------------------------------------------------------------- LOO-PIT


@dataclasses.dataclass(frozen=True)
class LOOPITResult:
    """LOO-PIT calibration: ``pit[i]`` the leave-one-out predictive
    ``P(y_rep <= y_i)``, uniform for a calibrated model; the KS statistic
    and its asymptotic p (``ok`` above ``threshold``), and the PSIS
    ``pareto_k`` per point."""

    pit: np.ndarray
    ks_stat: float
    p_value: float
    n_points: int
    n_samples: int
    pareto_k: np.ndarray
    threshold: float = 0.05

    @property
    def ok(self) -> bool:
        return bool(self.p_value > self.threshold)

    @property
    def n_bad_k(self) -> int:
        return int(np.sum(self.pareto_k > 0.7))

    def __repr__(self):
        return (f"LOOPITResult(ok={self.ok}, ks={self.ks_stat:.3f}, "
                f"p={self.p_value:.3g}, n_points={self.n_points}, "
                f"n_bad_k={self.n_bad_k})")


def _ks_uniform(pit: np.ndarray) -> tuple[float, float]:
    """One-sample KS statistic against Uniform(0, 1) and the Kolmogorov
    series p with Stephens' small-n correction."""
    n = pit.size
    s = np.sort(pit)
    i = np.arange(1, n + 1, dtype=np.float64)
    d = float(max(np.max(i / n - s), np.max(s - (i - 1.0) / n)))
    lam = (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)) * d
    k = np.arange(1, 101, dtype=np.float64)
    p = 2.0 * np.sum((-1.0) ** (k - 1.0) * np.exp(-2.0 * (k * lam) ** 2))
    return d, float(min(max(p, 0.0), 1.0))


def loo_pit(walker, take: int | None = None, max_samples: int = 512) -> LOOPITResult:
    """LOO-PIT (JAX ``loo_pit``, diagnostics.py:822-873): ``pit_i = sum_s
    w_si F(y_i | theta_s)`` with the PSIS weights of :func:`loo` and ``F``
    the per-point predictive CDF (``likelihoods.pointwise_cdf``, one
    batched call a term), then a KS test of uniformity.  A walker with a
    ``_pointwise_cdf(samples)`` hook takes it."""
    from .likelihoods import pointwise_cdf

    ll, samples = _pointwise_ll_matrix(walker, "loo_pit", take, max_samples)
    cdf_hook = getattr(walker, "_pointwise_cdf", None)
    if cdf_hook is not None:
        return _loo_pit_from(ll, _host64(cdf_hook(samples)))
    return _loo_pit_from(ll, _term_matrix(walker, samples, pointwise_cdf))


def _loo_pit_from(ll: np.ndarray, cdf: np.ndarray) -> LOOPITResult:
    """PSIS-weighted PIT and the KS verdict from matched (S, N) matrices."""
    s_count, n = ll.shape
    pit = np.empty(n)
    k_i = np.empty(n)
    for i in range(n):
        lw, k_i[i] = _psis_smooth(-ll[:, i])
        w = np.exp(lw - _logsumexp(lw))
        pit[i] = float(np.sum(w * cdf[:, i]))
    d, p = _ks_uniform(pit)
    return LOOPITResult(pit=pit, ks_stat=d, p_value=p, n_points=int(n),
                        n_samples=int(s_count), pareto_k=k_i)


# ----------------------------------------------------------------- audit


@dataclasses.dataclass(frozen=True)
class AuditResult:
    """The report card of :func:`audit`: ``ok`` when every check that ran
    passed; ``skipped`` maps the checks that could not run to the reason;
    ``advice`` reads the failures, worst first."""

    ok: bool
    convergence: dict
    loo_pit: LOOPITResult | None
    prior_sensitivity: "PriorSensitivityResult | None"
    advice: list[str]
    skipped: dict[str, str]

    def __repr__(self):
        ran = [n for n, v in (("convergence", self.convergence), ("loo_pit", self.loo_pit),
                              ("prior_sensitivity", self.prior_sensitivity))
               if v is not None]
        return (f"AuditResult(ok={self.ok}, ran={ran}, "
                f"skipped={list(self.skipped) or 'none'}, "
                f"advice={len(self.advice)} item(s))")


def audit(walker, take: int | None = None, prior=None, max_samples: int = 512,
          rhat_tol: float = 1.01, min_tail_ess: float = 100.0) -> AuditResult:
    """The cheapest-first calibration ladder in one call (JAX ``audit``,
    diagnostics.py:920-999): :func:`convergence`, :func:`loo_pit`,
    :func:`prior_sensitivity`, each failure read into ``advice``; a check
    that cannot run on this fit is recorded in ``skipped`` with its
    error, never passed."""
    advice: list[str] = []
    skipped: dict[str, str] = {}
    conv = convergence(walker, take, rhat_tol=rhat_tol, min_tail_ess=min_tail_ess)
    if not conv["ok"]:
        advice.append("not converged (" + "; ".join(conv["failures"][:3])
                      + (" …" if len(conv["failures"]) > 3 else "")
                      + ") — sample further (auto='rank-rhat') before trusting "
                      "anything below")
    pit = None
    try:
        pit = loo_pit(walker, take, max_samples)
    except ValueError as e:
        skipped["loo_pit"] = str(e)
    if pit is not None:
        if pit.n_bad_k > max(2, pit.n_points // 20):
            advice.append(f"loo_pit: {pit.n_bad_k}/{pit.n_points} importance tails "
                          "unreliable (pareto_k > 0.7) — warm history rows (burn "
                          "the anneal phase) or pervasive misspecification")
        if not pit.ok:
            extremes = float(np.mean(pit.pit < 0.1) + np.mean(pit.pit > 0.9))
            center = float(np.mean((pit.pit > 0.4) & (pit.pit < 0.6)))
            if extremes > 0.35:
                advice.append("loo_pit: over-confident (PIT piles at 0/1) — "
                              "observation errors understated; consider "
                              "make_noise_scale_likelihood and refit")
            elif center > 0.35:
                advice.append("loo_pit: under-confident (PIT humps at 0.5) — "
                              "observation errors overstated")
            else:
                advice.append(f"loo_pit: miscalibrated (KS p={pit.p_value:.2g}, "
                              f"mean PIT {pit.pit.mean():.2f}) — a sloped/one-sided "
                              "profile usually means a biased mean model")
    sens = None
    try:
        sens = prior_sensitivity(walker, prior=prior, take=take, max_samples=max_samples)
    except ValueError as e:
        skipped["prior_sensitivity"] = str(e)
    if sens is not None and not sens.ok:
        for k, d in sens.diagnosis.items():
            if d != "robust":
                advice.append(f"prior_sensitivity: {k}: {d} (prior {sens.prior[k]:.3f} / "
                              f"likelihood {sens.likelihood[k]:.3f})")
    ok = bool(conv["ok"] and (pit is None or pit.ok) and (sens is None or sens.ok))
    return AuditResult(ok=ok, convergence=conv, loo_pit=pit, prior_sensitivity=sens,
                       advice=advice, skipped=skipped)


# ------------------------------------------------- power-scaling sensitivity


@dataclasses.dataclass(frozen=True)
class PriorSensitivityResult:
    """Power-scaling sensitivity per parameter (and expression):
    ``prior[k]`` / ``likelihood[k]`` the CJS distance per unit log2 power,
    ``diagnosis[k]`` Kallioinen et al.'s reading at ``threshold`` ("prior-data
    conflict", "strong prior / weak likelihood" or "robust"), ``pareto_k``
    the worst tail shape per scaling direction (NaN: weights too uniform to
    fit a tail)."""

    prior: dict[str, float]
    likelihood: dict[str, float]
    diagnosis: dict[str, str]
    pareto_k: dict[str, float]
    threshold: float
    alpha: float
    n_samples: int

    @property
    def ok(self) -> bool:
        """True when every diagnosis is "robust"."""
        return all(d == "robust" for d in self.diagnosis.values())

    def __repr__(self):
        flagged = {k: d for k, d in self.diagnosis.items() if d != "robust"}
        worst = max(self.prior, key=lambda k: self.prior[k])
        return (f"PriorSensitivityResult(ok={self.ok}, "
                f"max_prior_sens={self.prior[worst]:.3f} ({worst}), "
                f"flagged={flagged or 'none'}, n_samples={self.n_samples})")


def _cjs_distance(x: np.ndarray, w: np.ndarray) -> float:
    """Normalized cumulative Jensen-Shannon distance between the empirical
    CDF of ``x`` and its ``w``-reweighted one (Nguyen & Vreeken 2015; JAX
    ``_cjs_distance``, diagnostics.py:1048-1080), in [0, 1]."""
    order = np.argsort(x)
    xs = x[order]
    bins = np.diff(xs)
    if not np.any(bins > 0.0):
        return 0.0
    s = xs.size
    p = np.arange(1.0, s) / s
    q = np.minimum(np.cumsum(w[order])[:-1], 1.0)
    pq = p + q
    safe = np.where(pq > 0.0, pq, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        tp = np.where(p > 0.0, p * np.log2(np.where(p > 0.0, 2.0 * p, 1.0) / safe), 0.0)
        tq = np.where(q > 0.0, q * np.log2(np.where(q > 0.0, 2.0 * q, 1.0) / safe), 0.0)
    total = float(np.sum(bins * (tp + tq)))
    bound = float(np.sum(bins * pq))
    if bound <= 0.0:
        return 0.0
    return float(np.sqrt(max(total, 0.0) / bound))


def prior_sensitivity(walker, prior=None, take: int | None = None, max_samples: int = 1024,
                      alpha: float = 1.01, threshold: float = 0.05,
                      expressions=None) -> PriorSensitivityResult:
    """Power-scaling sensitivity (Kallioinen et al. 2023; JAX
    ``prior_sensitivity``, diagnostics.py:1083-1224): the history's draws
    reweighted to ``prior^a likelihood`` and ``prior likelihood^a`` for
    ``a = 1/alpha, alpha`` (Pareto-smoothed), and per parameter

        sens = mean_a CJS(theta_k, w_a) / |log2 a|.

    The prior is ``prior=`` (a ``PriorSpec``, ``MVGaussian`` or bounds,
    resolved by ``priors.resolve_prior_spec``) if given, else the
    installed prior terms of the fit.  A flat prior's sensitivity is
    exactly 0.  ``expressions`` adds derived quantities (s-expressions or
    Python strings over the parameters) to the audit."""
    if not 1.0 < alpha < 2.0:
        raise ValueError(f"prior_sensitivity: alpha must be in (1, 2), got {alpha} "
                         "(it is a perturbation around 1)")
    unsupported = getattr(walker, "_prior_sensitivity_unsupported", None)
    if unsupported:
        raise ValueError(f"prior_sensitivity: {unsupported}")
    from .priors import resolve_prior_spec

    ll, samples = _pointwise_ll_matrix(walker, "prior_sensitivity", take, max_samples)
    loglik = ll.sum(axis=1)
    cols = walker.spec.unflatten(samples)
    if prior is not None:
        spec = resolve_prior_spec(walker, prior=prior)
        logprior = spec.log_pdf(cols, None)
    else:
        # What the posterior contains: every term's installed prior (a
        # shared prior on a T-term fit is installed T times).
        logprior = 0.0
        for t in walker.terms:
            logprior = logprior + t.prior(cols, t.dataset)
    logprior = np.broadcast_to(_host64(logprior), loglik.shape)
    if not np.all(np.isfinite(logprior)):
        raise ValueError("prior_sensitivity: some posterior draws have non-finite prior "
                         "density — the history predates the prior (or crosses a "
                         "truncation wall); refit with log_prior=spec or burn the "
                         "offending phase")
    theta = _host64(samples)
    columns = {k: theta[:, i] for i, k in enumerate(walker.spec.keys)}
    if expressions:
        from .expressions import _evaluate

        for expr in expressions:
            columns[expr] = np.asarray(_evaluate(expr, dict(columns)), np.float64)
    alphas = (1.0 / alpha, alpha)
    denom = abs(np.log2(alpha))
    out: dict[str, dict[str, float]] = {}
    k_worst: dict[str, float] = {}
    for name, logterm in (("prior", logprior), ("likelihood", loglik)):
        if np.ptp(logterm) == 0.0:
            # a constant density is exactly invariant under power-scaling
            out[name] = {k: 0.0 for k in columns}
            k_worst[name] = float("nan")
            continue
        per_col = {k: 0.0 for k in columns}
        k_max = -np.inf
        for a in alphas:
            lw, k_hat = _psis_smooth((a - 1.0) * logterm)
            if np.isfinite(k_hat):
                k_max = max(k_max, k_hat)
            w = np.exp(lw - _logsumexp(lw))
            for k, col in columns.items():
                per_col[k] += _cjs_distance(col, w) / denom
        out[name] = {k: float(v / len(alphas)) for k, v in per_col.items()}
        k_worst[name] = float(k_max) if np.isfinite(k_max) else float("nan")
    diagnosis = {}
    for k in columns:
        ps, ls = out["prior"][k], out["likelihood"][k]
        if ps >= threshold and ls >= threshold:
            diagnosis[k] = "prior-data conflict"
        elif ps >= threshold:
            diagnosis[k] = "strong prior / weak likelihood"
        else:
            diagnosis[k] = "robust"
    return PriorSensitivityResult(prior=out["prior"], likelihood=out["likelihood"],
                                  diagnosis=diagnosis, pareto_k=k_worst,
                                  threshold=threshold, alpha=alpha,
                                  n_samples=int(theta.shape[0]))


# ------------------------------------------------- refit cross-validation


def _require_per_point(name: str, likelihood):
    """Refits and their scoring need a per-point form; refuse otherwise."""
    from .likelihoods import LIBRARY_POINTWISE

    if likelihood not in LIBRARY_POINTWISE and not hasattr(likelihood, "_pointwise"):
        raise ValueError(
            f"{name}: refits need a likelihood with a per-point form (a library "
            "reduction or a create_log_likelihood_function/factory likelihood "
            "shipping _pointwise); this fit uses "
            f"{getattr(likelihood, '__name__', likelihood)!r} — refit without the "
            "held-out points by hand")


def _run_refit(fit, n_steps: int, temperature: float, burn_fraction: float):
    """The refits' recipe: the anneal, then a cold mala phase whose first
    ``burn_fraction`` is burnt (scoring warm anneal rows would bias every
    "exact" elpd low)."""
    fit.adaptive_steps(n_steps, temperature=temperature, auto=None)
    fit.reset()
    fit.sampling_steps(max(2000, n_steps // 2), kernel="mala")
    fit.burn_steps(int(len(fit) * burn_fraction))


def _global_batched_refit(walker, name: str, holdouts, n_steps: int, temperature: float,
                          walkers_per_dataset: int, burn_fraction: float,
                          max_samples: int, seed: int):
    """Leave-out refits of a fit of T terms as the adaptation groups of one
    grouped walker (JAX ``_global_batched_refit``, diagnostics.py:1241-1407).

    ``holdouts``: one boolean keep-mask a block over the term-major real
    points.  Held-out points leave by mask, so each block keeps the
    datasets' shape and every cached constant is exact for its points; the
    priors read the unreduced datasets.  Block j's posterior is the full
    T-term sum over its ``(P,)`` datasets, ``torch.func.vmap``-ed over the
    K blocks of ``walkers_per_dataset`` walkers.  The fit is custom and
    has per-walker aux (the block index), so it runs the plain batched
    posterior: neither kernel reads a per-block dataset.  Returns ``(fit,
    score_block)``, ``score_block(j) -> (S, N)`` the pointwise
    log-likelihood of the original real points under block j's draws.
    """
    from .data import Dataset
    from .fit import Walker, _host, history_block_columns
    from .likelihoods import pointwise_log_likelihood

    unsupported = getattr(walker, "_refit_unsupported", None)
    if unsupported:
        raise ValueError(f"{name}: {unsupported}")
    if getattr(walker, "_custom_log_post", None) is not None or \
            getattr(walker, "_custom_batched", None) is not None:
        raise ValueError(f"{name}: refit-CV rebuilds the posterior from the fit's terms; "
                         "custom-posterior fits are not reconstructible — use waic/loo "
                         "(pointwise) instead")
    terms = list(walker.terms)
    for t in terms:
        _require_per_point(name, t.likelihood)
    K, B, spec = len(holdouts), int(walkers_per_dataset), walker.spec
    real_pos = [np.nonzero(_host64(t.dataset.mask) > 0.0)[0] for t in terms]
    offsets = np.concatenate([[0], np.cumsum([p.size for p in real_pos])])
    fields = ("x", "y", "sigma", "mask", "inv_sigma", "log_norm_const",
              "log_norm_const_point", "log_fact_y")
    blocks = []
    for ti, term in enumerate(terms):
        ds = term.dataset
        per_block = []
        for keep in holdouts:
            mask = _host64(ds.mask).copy()
            mask[real_pos[ti]] *= np.asarray(keep[offsets[ti]:offsets[ti + 1]], np.float64)
            per_block.append(Dataset(x=ds.x, y=ds.y, sigma=ds.sigma, n=ds.n,
                                     mask=torch.as_tensor(mask, dtype=ds.mask.dtype,
                                                          device=ds.mask.device)))
        blocks.append({f: torch.stack([getattr(b, f) for b in per_block]) for f in fields})
    origs = tuple(t.dataset for t in terms)
    ns = tuple(int(t.dataset.n) for t in terms)
    data = {"blocks": tuple(blocks), "orig": origs}

    def _terms_lp(params, prior_cols, datasets):
        total = 0.0
        for term, ds_t, ods in zip(terms, datasets, origs):
            total = total + term.likelihood(term.fn, params, ds_t)
            total = total + term.prior(prior_cols, ods)
        return total

    def log_post(theta, block_idx, data):
        """One walker's posterior (diagnostics): its block's datasets."""
        p = spec.unflatten(theta)
        ds_k = tuple(Dataset(n=n, **{f: torch.index_select(v, 0, block_idx.reshape(1))[0]
                                     for f, v in st.items()})
                     for st, n in zip(data["blocks"], ns))
        return _terms_lp(p, p, ds_k)

    def per_block(theta_block, block_fields):
        cols = spec.unflatten(theta_block)
        pts = {k: v[:, None] for k, v in cols.items()}
        return _terms_lp(pts, cols, tuple(Dataset(n=n, **f)
                                          for f, n in zip(block_fields, ns)))

    over_blocks = torch.func.vmap(per_block)

    def batched_log_post(positions, data):
        """The hot path: (K, B, d) blocks against the stacked datasets."""
        return over_blocks(positions.reshape(K, B, -1), data["blocks"]).reshape(
            positions.shape[0])

    group_ids = np.repeat(np.arange(K), B)
    start = _host(spec.flatten(walker.most_likely_params(), dtype=walker.dtype))
    fit = Walker(terms, spec, start, n_walkers=K * B, seed=seed, walker_jitter=0.02,
                 dtype=walker.dtype, device=getattr(walker, "device", None),
                 aux=torch.as_tensor(group_ids), group_ids=group_ids, n_groups=K,
                 log_posterior=log_post, posterior_data=data,
                 batched_log_posterior=batched_log_post)
    if fit.config.history_walkers and fit.config.history_walkers < K * B:
        # scoring needs every block's walkers; a subsample would cross blocks
        fit.config = dataclasses.replace(fit.config, history_walkers=0)
    _run_refit(fit, n_steps, temperature, burn_fraction)
    real = np.concatenate([_host64(t.dataset.mask) for t in terms]) > 0.0
    cache: dict = {}

    def score_block(j):
        if "pos" not in cache:
            pos, _ = fit._history(None)
            cache["pos"] = np.asarray(pos)
            cache["cols"] = history_block_columns(fit, cache["pos"].shape[1])
        block = cache["pos"][:, cache["cols"][j], :].reshape(-1, spec.ndim)
        idx = np.unique(np.linspace(0, block.shape[0] - 1,
                                    min(max_samples, block.shape[0])).astype(int))
        samples = torch.as_tensor(block[idx], dtype=walker.dtype, device=fit.device)
        pts = {k: v[:, None] for k, v in spec.unflatten(samples).items()}
        ll = np.concatenate([_host64(pointwise_log_likelihood(t.likelihood, t.fn, pts,
                                                              t.dataset))
                             for t in terms], axis=1)
        return ll[:, real]

    return fit, score_block


def _batched_refit(walker, name: str, holdouts, n_steps: int, temperature: float,
                   walkers_per_dataset: int, burn_fraction: float, max_samples: int,
                   seed: int):
    """The refit scaffolding of :func:`reloo` and :func:`kfold` (JAX
    ``_batched_refit``, diagnostics.py:1410-1451): a walker with a
    ``_refit_cv`` hook of this signature refits itself (a structured
    ensemble); every other fit takes :func:`_global_batched_refit`."""
    hook = getattr(walker, "_refit_cv", None)
    if hook is not None:
        return hook(name, holdouts, n_steps, temperature, walkers_per_dataset,
                    burn_fraction, max_samples, seed)
    return _global_batched_refit(walker, name, holdouts, n_steps, temperature,
                                 walkers_per_dataset, burn_fraction, max_samples, seed)


def _refit_n_points(walker) -> int:
    """Length of the real-point axis the holdouts index (``_n_real_points``
    where a structured ensemble declares it)."""
    n = getattr(walker, "_n_real_points", None)
    if n is not None:
        return int(n)
    return int(sum(int(np.sum(_host64(t.dataset.mask) > 0.0)) for t in walker.terms))


def reloo(walker, result: LOOResult | None = None, k_threshold: float = 0.7,
          max_refits: int = 32, n_steps: int = 8000, temperature: float = 4.0,
          walkers_per_dataset: int = 64, burn_fraction: float = 0.33,
          max_samples: int = 512, seed: int = 0) -> LOOResult:
    """Exact leave-one-out refits of every point whose Pareto k exceeds
    ``k_threshold`` (JAX ``reloo``, diagnostics.py:1469-1555), all as the
    blocks of one grouped refit: those points' elpd become ``log mean_s
    p(y_i | theta_s^(-i))`` with k = 0; a block that fails the collapse
    gate keeps its PSIS value and flag (``refit_failed``).  More than
    ``max_refits`` flags means a misspecified model, and raises."""
    if result is None:
        result = loo(walker, max_samples=max_samples)
    flagged = np.where(result.pareto_k > k_threshold)[0]
    if flagged.size == 0:
        return result
    if flagged.size > max_refits:
        raise ValueError(f"reloo: {flagged.size} points flagged (> max_refits="
                         f"{max_refits}) — that many influential points means the model "
                         "is misspecified; fix the likelihood instead of refitting "
                         "around it")
    n = _refit_n_points(walker)
    refit, score_block = _batched_refit(
        walker, "reloo", [np.arange(n) != i for i in flagged], n_steps, temperature,
        walkers_per_dataset, burn_fraction, max_samples, seed)
    block_ok = grouped_refit_health(refit, "reloo")
    new_pointwise = result.pointwise.copy()
    new_k = result.pareto_k.copy()
    refit_failed = []
    for j, i in enumerate(flagged):
        if not block_ok[j]:
            refit_failed.append(int(i))
            continue
        ll_i = score_block(j)[:, i]
        new_pointwise[i] = _logsumexp(ll_i) - np.log(ll_i.size)
        new_k[i] = 0.0
    return LOOResult(elpd=float(new_pointwise.sum()),
                     p_loo=float(result.lppd - new_pointwise.sum()), lppd=result.lppd,
                     se=_se(new_pointwise), n_points=result.n_points,
                     n_samples=result.n_samples, pointwise=new_pointwise, pareto_k=new_k,
                     refit_failed=tuple(refit_failed))


@dataclasses.dataclass(frozen=True)
class KFoldResult:
    """Exact K-fold elpd: ``pointwise``/``n_points`` as the WAIC and LOO
    results carry them; ``fold_ok`` each fold's collapse-gate verdict."""

    elpd: float
    se: float
    n_points: int
    n_samples: int
    k: int
    pointwise: np.ndarray
    folds: np.ndarray
    fold_ok: np.ndarray | None = None

    def __repr__(self):
        return (f"KFoldResult(elpd={self.elpd:.3f} +- {self.se:.3f}, k={self.k}, "
                f"n_points={self.n_points}, n_samples={self.n_samples})")


def kfold(walker, k: int = 10, folds=None, n_steps: int = 8000, temperature: float = 4.0,
          walkers_per_dataset: int = 64, burn_fraction: float = 0.33,
          max_samples: int = 512, seed: int = 0) -> KFoldResult:
    """Exact K-fold cross-validation, the K refits as one grouped walker
    (JAX ``kfold``, diagnostics.py:1586-1660): each held-out point scored
    against the posterior that never saw it, ``elpd_i = log mean_s p(y_i |
    theta_s^(-fold(i)))``.  ``folds``: explicit fold ids (length n, 0..k-1)
    in place of the seeded round-robin over a permutation."""
    n = _refit_n_points(walker)
    if folds is not None:
        folds = np.asarray(folds, np.int64)
        if folds.shape != (n,):
            raise ValueError(f"kfold: folds must have shape ({n},), got {folds.shape}")
        k = int(folds.max()) + 1
        if set(np.unique(folds)) != set(range(k)):
            raise ValueError("kfold: fold ids must cover 0..k-1")
    else:
        if not 2 <= k <= n // 2:
            raise ValueError(f"kfold: need 2 <= k <= n/2 = {n // 2}, got {k}")
        folds = np.empty(n, np.int64)
        folds[np.random.default_rng(seed).permutation(n)] = np.arange(n) % k
    holdouts = []
    for j in range(k):
        keep = folds != j
        if not np.any(keep) or np.all(keep):
            raise ValueError(f"kfold: fold {j} is empty or everything")
        holdouts.append(keep)
    refit, score_block = _batched_refit(walker, "kfold", holdouts, n_steps, temperature,
                                        walkers_per_dataset, burn_fraction, max_samples,
                                        seed)
    fold_ok = grouped_refit_health(refit, "kfold")
    pointwise = np.empty(n)
    s_used = 0
    for j in range(k):
        ll = score_block(j)
        s_used = max(s_used, ll.shape[0])
        held = np.where(folds == j)[0]
        pointwise[held] = _lppd(ll[:, held])
    return KFoldResult(elpd=float(pointwise.sum()), se=_se(pointwise), n_points=int(n),
                       n_samples=int(s_used), k=int(k), pointwise=pointwise, folds=folds,
                       fold_ok=fold_ok)


# ------------------------------------------------------------ model weights


def model_weights(results, method: str = "stacking", seed: int = 0,
                  n_boot: int = 1000) -> np.ndarray:
    """Model-averaging weights from WAIC/LOO/K-fold results on the same data
    (Yao et al. 2018; JAX ``model_weights``, diagnostics.py:1663-1722):
    ``"stacking"`` maximizes the pooled log score ``sum_i log sum_k w_k
    exp(elpd_ik)`` on the simplex (projected ascent through a softmax);
    ``"pseudo-bma+"`` averages exp(elpd) weights over a seeded Bayesian
    bootstrap (numpy Dirichlet) of the points."""
    if len(results) < 2:
        raise ValueError("model_weights: need >= 2 models")
    n = results[0].n_points
    if any(r.n_points != n for r in results):
        raise ValueError("model_weights: models were scored on different data "
                         f"({[r.n_points for r in results]} points)")
    elpd = np.stack([np.asarray(r.pointwise, np.float64) for r in results])
    if method == "pseudo-bma+":
        rng = np.random.default_rng(seed)
        alpha = rng.dirichlet(np.ones(n), size=n_boot)
        totals = alpha @ elpd.T * n
        z = totals - totals.max(axis=1, keepdims=True)
        w = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
        return w.mean(axis=0)
    if method != "stacking":
        raise ValueError(f"model_weights: unknown method {method!r}")
    mx = elpd.max(axis=0)
    p = np.exp(elpd - mx)
    theta = np.zeros(elpd.shape[0])
    lr = 1.0
    for _ in range(2000):
        w = np.exp(theta - theta.max())
        w = w / w.sum()
        mix = w @ p
        grad_w = (p / mix).mean(axis=1)
        grad_theta = w * (grad_w - float(w @ grad_w))
        theta_new = theta + lr * grad_theta
        theta = theta_new - theta_new.max()
    w = np.exp(theta)
    return w / w.sum()


def evidence_weights(results, log_prior_odds=None) -> np.ndarray:
    """Posterior model probabilities ``P(M_k | data) ~ Z_k P(M_k)`` from log
    evidences (floats, or results carrying ``.log_z``: ``EvidenceResult``,
    ``LaplaceResult``, ``NestedResult``, ``SMCResult``); ``log_prior_odds``
    per model, equal by default (JAX ``evidence_weights``,
    diagnostics.py:1725-1767)."""
    if len(results) < 2:
        raise ValueError("evidence_weights: need >= 2 models")
    vals = []
    for i, r in enumerate(results):
        try:
            vals.append(float(getattr(r, "log_z", r)))
        except (TypeError, ValueError):
            raise ValueError(
                f"evidence_weights: results[{i}] = {r!r} carries no log_z and is not a "
                "float — pass evidence results (Evidence/Laplace/Nested/SMC) or raw "
                "log Z floats; WAIC/LOO results belong in model_weights") from None
    lz = np.asarray(vals, np.float64)
    if not np.all(np.isfinite(lz)):
        raise ValueError(f"evidence_weights: non-finite log_z in {lz}")
    if log_prior_odds is not None:
        lpo = np.asarray(log_prior_odds, np.float64)
        if lpo.shape != lz.shape:
            raise ValueError("evidence_weights: log_prior_odds must match results "
                             f"({lpo.shape} vs {lz.shape})")
        lz = lz + lpo
    z = lz - lz.max()
    w = np.exp(z)
    return w / w.sum()
