"""Visualization and diagnostics plots (reference C15, mcmc-fitting.lisp:1207-1373).

Port of ``lisp_mcmc_tpu/plotting.py``: matplotlib rebuilds of the
reference's gnuplot layer.
  - data + fit + posterior envelope (``walker-plot-data-and-fit``, 1257):
    the best-fit curve on a 1000-point grid and a min/max band from the
    top 66 % of retained steps by probability (1250-1253); the envelope's
    ``(keep, grid)`` model evaluations run as one batched call on the
    walker's device, and only the per-x min and max come to the host.
  - residuals (``walker-plot-residuals``, 1271)
  - caterpillar per-parameter trace multiplot (1294, saved to file like
    the reference's temp.png)
  - likelihood trace (``walker-liklihood-plot``, 1313)
  - the autocorrelation of the retained history, reduced on the device
  - pairwise corner scatter, single and full grid (1322/1333)
  - parameter histogram with auto-binning (1361 + make-histo 1542)
  - forest, SBC rank, LOO-PIT and prior-sensitivity plots of the
    criticism results
  - heatmap for walker-set derived quantities (nv-specific.lisp:98-105)
  - ``show`` (1371): open the last saved figure with an image viewer.

Everything but the envelope and the autocorrelation is numpy and
matplotlib; tensors are converted once, at the top of each function.
The figures need matplotlib; the module imports without it (a machine
with a GPU may have none), and its device reductions (``_fit_envelope``,
``_autocorrelation_curves``) run there, while drawing raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import torch

try:
    import matplotlib
except ImportError:
    matplotlib = None


def _is_headless() -> bool:
    """Force Agg only when there is genuinely no display to draw on.

    The reference's primary workflow pops live gnuplot qt windows
    (mcmc-fitting.lisp:1259-1268); a user with a working GUI backend must
    keep it.  Respect an explicit MPLBACKEND, and any X/Wayland display.
    """
    if os.environ.get("MPLBACKEND"):
        return False
    if os.name == "nt" or os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"):
        return False
    return True


if matplotlib is not None:
    if _is_headless():
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # noqa: E402
else:
    plt = None

from .stats import make_histogram  # noqa: E402

__all__ = [
    "plot_data_and_fit",
    "plot_residuals",
    "ppc_plot",
    "caterpillar_plots",
    "likelihood_plot",
    "autocorrelation_plot",
    "corner_plot",
    "all_corner_plots",
    "param_histogram",
    "plot_set_param",
    "forest_plot",
    "sbc_rank_plot",
    "loo_pit_plot",
    "prior_sensitivity_plot",
    "plot_file",
    "heatmap",
    "show",
]

_LAST_FIGURE_PATH: list[str] = []


def _subplots(*args, **kwargs):
    """``plt.subplots``, or an ImportError naming the missing matplotlib."""
    if plt is None:
        raise ImportError("plotting: drawing a figure needs matplotlib, which is not "
                          "installed")
    return plt.subplots(*args, **kwargs)


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _subsample_walkers(data, max_lines: int = 64):
    """At most ``max_lines`` walker columns per trace plot: matplotlib
    builds one Line2D per column, and 65k of them hang the host for
    minutes -- the line COUNT, not the alpha, is what blows up."""
    if data.shape[1] <= max_lines:
        return data
    idx = np.linspace(0, data.shape[1] - 1, max_lines).astype(int)
    return data[:, idx]


def _save(fig, filename, close: bool | None = None):
    """Save (when ``filename`` given) and maybe close.

    ``close=None`` closes only on non-interactive backends: pyplot
    registers every figure globally, so batch loops (heatmap scans,
    per-fit residual plots) leak one multi-MB figure per call -- but on a
    GUI backend the caller may still want to ``fig.show()`` or annotate,
    so the figure is returned open there.
    """
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        _LAST_FIGURE_PATH.append(filename)
        if close is None:
            backend = matplotlib.get_backend().lower()
            interactive_backends = ("qt", "gtk", "tk", "wx", "macosx", "nbagg",
                                    "webagg", "ipympl")
            close = not matplotlib.is_interactive() and not any(
                b in backend for b in interactive_backends)
        if close:
            plt.close(fig)
    return fig


def _best_vector(walker):
    """The global best step as a (d,) tensor on the walker's device."""
    return walker.spec.flatten(walker.most_likely_params(), dtype=walker.dtype,
                               device=walker.device)


def _fit_envelope(walker, term_index: int, take: int | None, grid_points: int,
                  envelope_fraction: float):
    """Device-side envelope: evaluate the model over the fit grid for the
    top ``envelope_fraction`` of steps by probability, as one batched
    ``(keep, grid)`` call on the walker's device, and reduce to per-x min
    and max before the host copy (mcmc-fitting.lisp:1250-1253).  Returns
    ``(grid, y_best, y_lo, y_hi)`` as host arrays."""
    term = walker.terms[term_index]
    x = _np(term.dataset.x)[: term.dataset.n]
    kw = dict(dtype=walker.dtype, device=walker.device)
    grid = torch.linspace(float(x.min()), float(x.max()), grid_points, **kw)

    pos, lp = walker._history(take)
    flat_pos = np.asarray(pos).reshape(-1, walker.ndim)
    flat_lp = np.asarray(lp).reshape(-1)
    # Cap the evaluated sample count: `take` counts STEPS, so T*W samples
    # at ensemble scale would make a (keep, grid) array of hundreds of GB.
    # 20k top samples bound it to tens of MB and stay far denser than the
    # reference's.
    keep = min(max(1, int(len(flat_lp) * envelope_fraction)), 20_000)
    top = np.argsort(flat_lp)[-keep:]
    top_params = torch.as_tensor(flat_pos[top], **kw)

    cols = {k: v[:, None] for k, v in walker.spec.unflatten(top_params).items()}
    ys = torch.broadcast_to(term.fn(grid, cols), (keep, grid_points))   # (keep, grid)
    y_lo = _np(ys.amin(dim=0))
    y_hi = _np(ys.amax(dim=0))
    y_best = torch.broadcast_to(term.fn(grid, walker.spec.unflatten(_best_vector(walker))),
                                (grid_points,))
    return _np(grid), _np(y_best), y_lo, y_hi


def plot_data_and_fit(walker, term_index: int = 0, take: int | None = 1000,
                      grid_points: int = 1000, envelope_fraction: float = 0.66,
                      filename: str | None = None):
    """Data + best fit + posterior envelope (``walker-plot-data-and-fit``).

    ``term_index`` selects the dataset/function pair for global fits (the
    reference's ``:fn-number`` kwarg, README.md:59).
    """
    term = walker.terms[term_index]
    n = term.dataset.n
    x = _np(term.dataset.x)[:n]
    y = _np(term.dataset.y)[:n]
    grid, y_best, y_lo, y_hi = _fit_envelope(
        walker, term_index, take, grid_points, envelope_fraction
    )

    fig, ax = _subplots(figsize=(8, 5))
    ax.fill_between(grid, y_lo, y_hi, color="green", alpha=0.3,
                    label=f"top {envelope_fraction:.0%} envelope")
    ax.plot(grid, y_best, "r-", lw=1.5, label="most likely fit")
    ax.plot(x, y, "k.", ms=3, label="data")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.legend()
    ax.set_title(f"data and fit (term {term_index})")
    return _save(fig, filename)


def plot_residuals(walker, term_index: int = 0, filename: str | None = None):
    """Residuals with error bars (``walker-plot-residuals``, 1271-1292)."""
    term = walker.terms[term_index]
    n = term.dataset.n
    x = _np(term.dataset.x)[:n]
    y = _np(term.dataset.y)[:n]
    sigma = _np(term.dataset.sigma)[:n]
    x_dev = torch.as_tensor(x, dtype=walker.dtype, device=walker.device)
    model = _np(torch.broadcast_to(
        term.fn(x_dev, walker.spec.unflatten(_best_vector(walker))), (n,)))

    fig, ax = _subplots(figsize=(8, 4))
    ax.errorbar(x, y - model, yerr=sigma, fmt="k.", ms=3, elinewidth=0.5)
    ax.axhline(0.0, color="r", lw=1)
    ax.set_xlabel("x")
    ax.set_ylabel("residual")
    ax.set_title(f"residuals (term {term_index})")
    return _save(fig, filename)


def ppc_plot(walker, term_index: int | None = 0, take: int | None = None,
             max_samples: int = 256, seed: int = 0,
             lo: float = 0.05, hi: float = 0.95,
             filename: str | None = None):
    """Posterior predictive check plot: data vs the replicate band.

    Unlike :func:`plot_data_and_fit`'s envelope (mcmc-fitting.lisp:
    1250-1257 -- spread of the *mean curve* only), the band here is the
    (lo, hi) quantile of full replicated observations y_rep, so the
    observation noise is in the band: a calibrated fit covers ~90% of
    its points at the default band, and the title reports the actual
    coverage next to that target.

    ``term_index=None`` on a global multi-term fit (test.lisp:58-70)
    panels EVERY term's check in one figure from one replicate pass.
    """
    from .predictive import posterior_predictive

    draws = posterior_predictive(walker, take=take, max_samples=max_samples,
                                 seed=seed)
    draws = draws if term_index is None else [draws[term_index]]

    fig, axes = _subplots(len(draws), 1,
                             figsize=(8, 4.2 * len(draws)), squeeze=False)
    for ax, d in zip(axes[:, 0], draws):
        x = d.x if d.x.ndim == 1 else d.x[:, 0]
        order = np.argsort(x)
        b_lo, b_hi = d.band(lo, hi)
        med = np.quantile(d.y_rep, 0.5, axis=0)
        ax.fill_between(x[order], b_lo[order], b_hi[order], color="tab:blue",
                        alpha=0.25,
                        label=f"{lo:.0%}-{hi:.0%} predictive band")
        ax.plot(x[order], med[order], "b-", lw=1, label="predictive median")
        ax.plot(x, d.y_obs, "k.", ms=3, label="data")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.legend()
        ax.set_title(f"posterior predictive check (term {d.term_index}): "
                     f"coverage {d.coverage(lo, hi):.1%} "
                     f"vs {hi - lo:.0%} target")
    fig.tight_layout()
    return _save(fig, filename)


def caterpillar_plots(walker, take: int | None = None, walker_index: int | None = None,
                      filename: str | None = "temp.png"):
    """Per-parameter trace multiplot (``walker-catepillar-plots``, 1294-1310).

    By default overlays all walkers' traces; ``walker_index`` selects one.
    Saves to ``temp.png`` like the reference.
    """
    pos, _ = walker._history(take)  # (T, W, d)
    pos = np.asarray(pos)
    d = walker.ndim
    ncols = 2
    nrows = (d + 1) // 2
    fig, axes = _subplots(nrows, ncols, figsize=(10, 2.2 * nrows), squeeze=False)
    for i, key in enumerate(walker.spec.keys):
        ax = axes[i // ncols][i % ncols]
        data = pos[:, :, i] if walker_index is None else pos[:, [walker_index], i]
        data = _subsample_walkers(data)
        ax.plot(data, lw=0.4, alpha=min(1.0, 4.0 / data.shape[1]))
        ax.set_ylabel(key)
    for j in range(d, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.suptitle("parameter traces")
    return _save(fig, filename)


def likelihood_plot(walker, take: int | None = None, filename: str | None = None):
    """Log-likelihood trace (``walker-liklihood-plot``, 1313-1320)."""
    _, lp = walker._history(take)
    lp = np.asarray(lp)
    fig, ax = _subplots(figsize=(8, 4))
    lp_drawn = _subsample_walkers(lp)
    # alpha from the DRAWN column count, not the full W -- with large
    # ensembles the 64 subsampled traces would get alpha 4/W and vanish.
    ax.plot(lp_drawn, lw=0.4, alpha=min(1.0, 4.0 / lp_drawn.shape[1]))
    ax.plot(lp.max(axis=1), "k-", lw=1.2, label="max over walkers")
    ax.set_xlabel("retained step")
    ax.set_ylabel("log posterior")
    ax.legend()
    return _save(fig, filename)


def autocorrelation_plot(walker, name: str | None = None,
                         take: int | None = None, max_lag: int | None = None,
                         filename: str | None = None):
    """Per-parameter autocorrelation of the retained history.

    New diagnostic (no reference analogue -- the single chain had only the
    likelihood trace, 1313): mean normalized autocorrelation across the
    ensemble per lag, one curve per parameter (or just ``name``), with
    the ESS each curve implies in the legend.  Lags are in retained
    history rows (``thin`` kernel steps apart).  The (T, W) history of a
    parameter goes to the walker's device, where
    ``ops.reductions.autocorrelation`` and ``effective_sample_size`` run;
    only the (L,) curve and the ESS come back.
    """
    curves = _autocorrelation_curves(walker, name, take, max_lag)
    fig, ax = _subplots(figsize=(8, 4))
    for k, rho, ess in curves:
        ax.plot(rho, lw=1.0, label=f"{k} (ESS {ess:.0f})")
    ax.axhline(0.0, color="k", lw=0.5)
    ax.set_xlabel("lag (retained rows)")
    ax.set_ylabel("autocorrelation")
    ax.legend(fontsize=8)
    return _save(fig, filename)


def _autocorrelation_curves(walker, name: str | None, take: int | None,
                            max_lag: int | None):
    """``[(key, rho (L,), ess)]`` of :func:`autocorrelation_plot`: each
    parameter's (T, W) history on the walker's device, reduced there."""
    from .ops.reductions import autocorrelation, effective_sample_size

    pos, _ = walker._history(take)
    pos = np.asarray(pos)
    keys = [name] if name is not None else list(walker.spec.keys)
    out = []
    for k in keys:
        chain = torch.as_tensor(np.ascontiguousarray(pos[:, :, walker.spec.index(k)]),
                                device=walker.device)                     # (T, W)
        out.append((k, _np(autocorrelation(chain, max_lag).mean(dim=1)),
                    float(effective_sample_size(chain))))
    return out


def corner_plot(walker, key_x: str, key_y: str, take: int | None = 1000,
                filename: str | None = None):
    """Pairwise posterior scatter (``walker-2d-plot``, 1322-1331)."""
    pos, _ = walker._history(take)
    pos = np.asarray(pos)
    ix, iy = walker.spec.index(key_x), walker.spec.index(key_y)
    fig, ax = _subplots(figsize=(5, 5))
    ax.plot(pos[:, :, ix].ravel(), pos[:, :, iy].ravel(), "k.", ms=1, alpha=0.3)
    ax.set_xlabel(key_x)
    ax.set_ylabel(key_y)
    return _save(fig, filename)


def all_corner_plots(walker, take: int | None = 1000, filename: str | None = "temp.png"):
    """Full corner grid (``walker-all-2d-plots``, 1333-1359; test.lisp:77)."""
    pos, _ = walker._history(take)
    flat = np.asarray(pos).reshape(-1, walker.ndim)
    d = walker.ndim
    fig, axes = _subplots(d, d, figsize=(2.2 * d, 2.2 * d), squeeze=False)
    for i in range(d):
        for j in range(d):
            ax = axes[i][j]
            if i == j:
                counts, centers = make_histogram(flat[:, i])
                ax.step(centers, counts, "k-", lw=0.8)
            elif i > j:
                ax.plot(flat[:, j], flat[:, i], "k.", ms=1, alpha=0.2)
            else:
                ax.axis("off")
            if i == d - 1:
                ax.set_xlabel(walker.spec.keys[j], fontsize=8)
            if j == 0:
                ax.set_ylabel(walker.spec.keys[i], fontsize=8)
    fig.suptitle("corner plots")
    return _save(fig, filename)


def param_histogram(walker, key: str, take: int | None = None, bins: int | None = None,
                    filename: str | None = None):
    """Posterior histogram of one parameter (``walker-param-histo``, 1361-1369)."""
    pos, _ = walker._history(take)
    samples = np.asarray(pos)[:, :, walker.spec.index(key)].ravel()
    counts, centers = make_histogram(samples, bins)
    fig, ax = _subplots(figsize=(6, 4))
    ax.bar(centers, counts, width=(centers[1] - centers[0]) if len(centers) > 1 else 1.0,
           color="steelblue", edgecolor="none")
    ax.set_xlabel(key)
    ax.set_ylabel("count")
    return _save(fig, filename)


def plot_set_param(walker_set, key: str, filename: str | None = None):
    """One fitted parameter across a set of fits
    (``walker-set-plot-param``, mcmc-fitting.lisp:1035-1036)."""
    from .params import _norm_key

    key = _norm_key(key)
    values = [w.most_likely_params()[key] for w in walker_set]
    fig, ax = _subplots(figsize=(7, 4))
    ax.plot(values, "ko-", ms=4, lw=0.8)
    ax.set_xlabel("fit index")
    ax.set_ylabel(key)
    ax.set_title(f"{key} across {len(values)} fits")
    return _save(fig, filename)


def forest_plot(fit, key: str, take: int | None = None, ci: float = 0.9,
                filename: str | None = None):
    """Per-dataset posterior intervals of one parameter (forest plot).

    The scan-grid summary view: one row per dataset with the ``ci``
    credible interval and median of ``key``.  Accepts a
    :class:`~lisp_mcmc_torch.BatchedFit` (independent marginals per block)
    or a :class:`~lisp_mcmc_torch.HierarchicalFit` (decoded natural
    marginals); for a POOLED hierarchical parameter the population is
    drawn behind the rows -- the ``mu`` interval as a vertical band and
    ``median(mu) +- median(tau)`` as dashed lines -- making the
    shrinkage visible at a glance.  No reference analogue (the closest
    is ``walker-set-plot-param``, mcmc-fitting.lisp:1035, point
    estimates only).
    """
    from .params import _norm_key

    key = _norm_key(key)
    if not 0.0 < ci < 1.0:
        raise ValueError(f"forest_plot: ci must be in (0, 1), got {ci}")
    lo_q, hi_q = (1.0 - ci) / 2.0, 1.0 - (1.0 - ci) / 2.0
    rows, band = [], None
    if hasattr(fit, "local_spec") and hasattr(fit, "pooled"):
        pos, _ = fit._history(take)
        pos = np.asarray(pos)
        j = fit.local_spec.index(key)
        for s in range(fit.n_datasets):
            col = fit._decode_np_one(pos, s)[..., j].reshape(-1)
            rows.append(np.quantile(col, [lo_q, 0.5, hi_q]))
        if key in fit.pooled:
            k = list(fit.pooled).index(key)
            dp = len(fit.pooled)
            mu = pos[..., k].reshape(-1)
            tau = pos[..., dp + k].reshape(-1)
            band = (np.quantile(mu, [lo_q, 0.5, hi_q]),
                    float(np.median(tau)))
    elif hasattr(fit, "dataset_view"):
        i = fit.spec.index(key)
        for s in range(fit.n_datasets):
            col, _ = fit.dataset_view(s).steps(take)
            rows.append(np.quantile(np.asarray(col)[:, i], [lo_q, 0.5, hi_q]))
    else:
        raise ValueError(
            "forest_plot: needs a BatchedFit or HierarchicalFit (a "
            "single fit has one marginal — use param_histogram)")

    rows = np.asarray(rows)                      # (S, 3) lo/med/hi
    S = rows.shape[0]
    fig, ax = _subplots(figsize=(7, 0.45 * S + 1.8))
    y = np.arange(S)[::-1]
    if band is not None:
        (mu_lo, mu_med, mu_hi), tau_med = band
        ax.axvspan(mu_lo, mu_hi, color="0.85", zorder=0,
                   label=f"population mu ({int(ci * 100)}% CI)")
        ax.axvline(mu_med, color="0.5", lw=1.0, zorder=1)
        for edge in (mu_med - tau_med, mu_med + tau_med):
            ax.axvline(edge, color="0.5", lw=0.8, ls="--", zorder=1)
    ax.errorbar(rows[:, 1], y,
                xerr=[rows[:, 1] - rows[:, 0], rows[:, 2] - rows[:, 1]],
                fmt="ko", ms=4, lw=1.2, capsize=2)
    ax.set_yticks(y)
    ax.set_yticklabels([f"dataset {s}" for s in range(S)])
    ax.set_xlabel(key)
    ax.set_title(f"{key}: {int(ci * 100)}% intervals per dataset"
                 + (" + population" if band is not None else ""))
    if band is not None:
        ax.legend(loc="best", fontsize=8)
    return _save(fig, filename)


def sbc_rank_plot(result, filename: str | None = None):
    """Per-parameter SBC rank histograms with the uniform band.

    Read the shapes: a cup = posterior too narrow, a cap = too wide, a
    slope = biased; the gray band is the central 99% envelope a calibrated
    pipeline's bin counts should stay inside (binomial).
    """
    from scipy.stats import binom

    from .sbc import _bin_masses

    keys = result.keys
    ranks = _np(result.ranks)
    d = len(keys)
    ncols = min(d, 3)
    nrows = (d + ncols - 1) // ncols
    fig, axes = _subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows),
                             squeeze=False)
    # Per-bin EXACT rank mass: equal-width bins over the discrete ranks
    # hold unequal mass unless n_bins divides n_draws+1, and a band
    # drawn from the naive 1/n_bins reads calibrated histograms as
    # miscalibrated (see sbc._bin_masses).
    edges, mass = _bin_masses(result.n_draws, result.n_bins)
    n = result.n_sims
    band_lo = binom.ppf(0.005, n, mass)
    band_hi = binom.ppf(0.995, n, mass)
    for j, k in enumerate(keys):
        ax = axes[j // ncols][j % ncols]
        ax.stairs(band_hi, edges, baseline=band_lo, fill=True,
                  color="0.85", zorder=0)
        ax.stairs(n * mass, edges, color="0.5", lw=1, ls="--", zorder=1)
        ax.hist(ranks[:, j] + 0.5, bins=edges, color="tab:blue",
                alpha=0.8, zorder=2)
        ax.set_title(f"{k}  (p={result.p_values[k]:.3g})", fontsize=10)
        ax.set_xlabel("rank of truth")
    for j in range(d, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.suptitle(f"SBC ranks: {result.n_sims} sims x {result.n_draws} draws",
                 y=1.0)
    fig.tight_layout()
    return _save(fig, filename)


def loo_pit_plot(result, filename: str | None = None):
    """LOO-PIT calibration plot: PIT ECDF against the uniform diagonal.

    Read the shapes like :func:`sbc_rank_plot`: an S-curve crossing the
    diagonal at 0.5 = over-confident predictions (PIT piles at 0/1),
    the mirrored S = under-confident, a one-sided bow = biased mean
    model.  The gray band is the 99% Kolmogorov-Smirnov envelope a
    calibrated model's ECDF stays inside.
    """
    pit = np.sort(_np(result.pit).astype(np.float64))
    n = pit.size
    fig, ax = _subplots(figsize=(5, 4))
    # 99% two-sided KS acceptance band around the diagonal
    # (c(0.01) = 1.628 from the asymptotic Kolmogorov quantile).
    eps = 1.628 / np.sqrt(n)
    grid = np.linspace(0.0, 1.0, 201)
    ax.fill_between(grid, np.clip(grid - eps, 0, 1),
                    np.clip(grid + eps, 0, 1), color="0.88", zorder=0)
    ax.plot([0, 1], [0, 1], "--", color="0.5", lw=1, zorder=1)
    ax.step(np.concatenate([[0.0], pit, [1.0]]),
            np.concatenate([[0.0], np.arange(1, n + 1) / n, [1.0]]),
            where="post", color="tab:blue", lw=1.5, zorder=2)
    ax.set_xlabel("LOO-PIT value")
    ax.set_ylabel("empirical CDF")
    ax.set_title(f"LOO-PIT calibration (KS p={result.p_value:.3g}, "
                 f"{'ok' if result.ok else 'MISCALIBRATED'})", fontsize=10)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    fig.tight_layout()
    return _save(fig, filename)


def prior_sensitivity_plot(result, filename: str | None = None):
    """Power-scaling sensitivity map: prior vs likelihood per parameter.

    The Kallioinen et al. (2023) reading by quadrant: high prior + high
    likelihood sensitivity = prior-data conflict (upper right), high
    prior + low likelihood = the prior is doing the work (lower right),
    low prior = robust (left half, any likelihood sensitivity).  The
    dashed lines mark the decision threshold.
    """
    keys = list(result.prior)
    ps = np.asarray([float(result.prior[k]) for k in keys])
    ls = np.asarray([float(result.likelihood[k]) for k in keys])
    colors = {"robust": "tab:blue", "prior-data conflict": "tab:red",
              "strong prior / weak likelihood": "tab:orange"}
    fig, ax = _subplots(figsize=(5.5, 4.5))
    thr = result.threshold
    ax.axvline(thr, ls="--", color="0.6", lw=1)
    ax.axhline(thr, ls="--", color="0.6", lw=1)
    for k, p, l in zip(keys, ps, ls):
        c = colors[result.diagnosis[k]]
        ax.plot([p], [l], "o", color=c, ms=7)
        ax.annotate(k, (p, l), textcoords="offset points", xytext=(6, 4),
                    fontsize=9)
    lim = max(thr * 2.0, ps.max() * 1.3, ls.max() * 1.3, 1e-3)
    ax.set_xlim(-0.02 * lim, lim)
    ax.set_ylim(-0.02 * lim, lim)
    ax.set_xlabel("prior power-scaling sensitivity")
    ax.set_ylabel("likelihood power-scaling sensitivity")
    ax.set_title(f"prior sensitivity (ok={result.ok})", fontsize=10)
    fig.tight_layout()
    return _save(fig, filename)


def plot_file(path: str, x_column: int = 0, y_column: int = 1, delim=None,
              filename: str | None = None):
    """Quick-plot two columns of a data file (the ``plot-file`` helpers,
    mcmc-fitting.lisp:1480-1488)."""
    from .io import read_file_data

    table = read_file_data(path, delim=delim)
    fig, ax = _subplots(figsize=(8, 5))
    ax.plot(_np(table[x_column]), _np(table[y_column]), "k.-", ms=3, lw=0.5)
    ax.set_xlabel(f"column {x_column}")
    ax.set_ylabel(f"column {y_column}")
    ax.set_title(os.path.basename(path))
    return _save(fig, filename)


def heatmap(values, row_length: int, filename: str | None = None,
            cbar_range=(0, None), z_label: str = "Field Offset (Oe)"):
    """2-D heatmap of a derived quantity over a scan grid
    (``nv-pretty-heatmap``, nv-specific.lisp:98-105)."""
    values = _np(values).astype(np.float64).ravel()
    nrows = int(np.ceil(len(values) / row_length))
    grid = np.full(nrows * row_length, np.nan)
    grid[: len(values)] = values
    grid = grid.reshape(nrows, row_length)
    fig, ax = _subplots(figsize=(6, 5))
    im = ax.imshow(grid, origin="lower", aspect="auto",
                   vmin=cbar_range[0], vmax=cbar_range[1], cmap="viridis")
    ax.set_xlabel("X Pos")
    ax.set_ylabel("Y Pos")
    fig.colorbar(im, ax=ax, label=z_label)
    return _save(fig, filename)


def show(filename: str | None = None):
    """Open the last saved figure (``show`` = ``feh temp.png``, 1371-1373).

    Uses ``feh`` when present like the reference, otherwise whatever
    ``xdg-open`` resolves; headless environments just get the path back.
    """
    path = filename or (_LAST_FIGURE_PATH[-1] if _LAST_FIGURE_PATH else None)
    if path is None:
        return None
    for viewer in ("feh", "xdg-open"):
        exe = shutil.which(viewer)
        if exe and os.environ.get("DISPLAY"):
            subprocess.Popen([exe, path])
            return path
    return path
