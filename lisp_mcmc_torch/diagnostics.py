"""Per-parameter convergence numbers and the fit's metrics and report.

Port of the per-parameter part of ``lisp_mcmc_tpu/diagnostics.py``
(``:33-417``): ESS, split R-hat, rank-normalised R-hat, tail ESS and the
MCSE of the mean per parameter, the Vehtari-2021 convergence verdict
(``convergence``, ``convergence_per_dataset``), the metrics snapshot and
the printed report, and ``trace_profile`` (``torch.profiler``).  A grouped
fit holds one population per adaptation group; each is reduced on its own
and the worst case reported.  The reductions run where the history lies
(a CUDA tensor on the GPU, the host history on the CPU); only ``d``
scalars reach the host.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any

import numpy as np
import torch

from .ops.reductions import (effective_sample_size, mcse_mean, rank_normalized_rhat,
                             split_rhat, tail_ess)

__all__ = ["metrics", "ess_per_param", "ess_from_history", "rhat_per_param",
           "rhat_from_history", "rank_rhat_per_param", "tail_ess_per_param",
           "mcse_per_param", "merge_worst_verdict", "convergence",
           "convergence_per_dataset", "summary", "trace_profile"]


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
