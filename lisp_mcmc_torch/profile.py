"""Profile-likelihood confidence intervals.

Port of ``lisp_mcmc_tpu/profile.py``.  The profile of parameter ``k`` at
value ``g`` is the log posterior maximized over the other parameters with
``k`` pinned at ``g``; the likelihood-ratio interval is where it stays
within ``chi2_1(level) / 2`` of its maximum.  Every (grid value x start)
row runs in one batched Adam ensemble, :func:`fit.make_adam_sgdr_runner`
with the pinned coordinate's whitening scale zeroed: values and gradients
by autograd through the plain posterior (``kernel.make_eval_vg``), as
``Walker.optimize`` takes them; the rows' value-only evaluations through
``Walker._batched_posterior()`` (kernel 1 on the GPU for a fit in its
coverage, at W = ``n_grid * multistart``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ProfileResult", "profile_likelihood"]


@dataclasses.dataclass(frozen=True)
class ProfileResult:
    """One parameter's profile: ``grid`` values and their ``profile_lp``
    maxima.  ``ci(level)`` interpolates the likelihood-ratio interval; an
    end that never crossed inside the grid comes back as the grid's end
    with its ``bounded`` flag False."""

    name: str
    grid: np.ndarray
    profile_lp: np.ndarray
    lp_max: float
    at_max: float

    def ci(self, level: float = 0.95) -> tuple[float, float, bool, bool]:
        from scipy.stats import chi2

        thr = self.lp_max - 0.5 * float(chi2.ppf(level, 1))
        above = self.profile_lp >= thr
        if not above.any():
            return float(self.grid[0]), float(self.grid[-1]), False, False
        i_lo = int(np.argmax(above))
        i_hi = len(above) - 1 - int(np.argmax(above[::-1]))

        def cross(i_out, i_in):
            x0, x1 = self.grid[i_out], self.grid[i_in]
            y0, y1 = self.profile_lp[i_out], self.profile_lp[i_in]
            if not np.isfinite(y0) or y1 == y0:
                # a floored outer neighbour: the crossing lies just outside
                # the inner point, which is returned (conservatively)
                return float(x1)
            return float(x0 + (thr - y0) * (x1 - x0) / (y1 - y0))

        lo_bounded = i_lo > 0
        hi_bounded = i_hi < len(above) - 1
        lo = cross(i_lo - 1, i_lo) if lo_bounded else float(self.grid[0])
        hi = cross(i_hi + 1, i_hi) if hi_bounded else float(self.grid[-1])
        return lo, hi, lo_bounded, hi_bounded

    def __repr__(self):
        lo, hi, bl, bh = self.ci()
        mark = "" if (bl and bh) else " (grid-limited!)"
        return (f"ProfileResult({self.name}: max at {self.at_max:.6g}, "
                f"95% CI [{lo:.6g}, {hi:.6g}]{mark})")


def profile_likelihood(walker, name: str, grid=None, n_grid: int = 21, span: float = 4.0,
                       n_steps: int = 400, learning_rate: float = 0.05, rounds: int = 2,
                       multistart: int = 8, jitter: float = 0.05,
                       seed: int = 0) -> ProfileResult:
    """Profile the log posterior over one parameter (JAX
    ``profile_likelihood``, profile.py:80-167).

    ``grid`` defaults to ``MAP +- span * sd``, ``sd`` from the last 2000
    retained steps (10 % of the MAP's magnitude where that is 0 or not
    finite).  Each grid value gets ``multistart`` starts jittered
    (relative ``jitter``, numpy, seeded from ``seed``) around the best
    step, one of them clean; ``rounds`` refits the whitening scales
    between passes.  A row moves only where its finite endpoint improved
    it.  The walker's state is untouched."""
    from .fit import _host, _nonzero_scales, make_adam_sgdr_runner
    from .kernel import make_eval_vg

    if getattr(walker, "aux", None) is not None:
        raise ValueError("profile_likelihood: grouped/aux ensembles — profile "
                         "per-dataset walkers")
    keys = walker.spec.keys
    if name not in keys:
        raise ValueError(f"profile_likelihood: unknown parameter {name!r} "
                         f"(have {list(keys)})")
    k = keys.index(name)
    d = len(keys)
    _, mode = walker.most_likely_step()
    theta0 = _host(walker.spec.flatten(mode)).astype(np.float64)
    if grid is None:
        pos, _ = walker.steps(2000)
        sd = float(np.std(np.asarray(pos)[:, k]))
        if not np.isfinite(sd) or sd == 0.0:
            sd = abs(theta0[k]) * 0.1 or 1e-3
        grid = np.linspace(theta0[k] - span * sd, theta0[k] + span * sd, n_grid)
    grid = np.asarray(grid, np.float64)
    g_count = grid.size
    rows = g_count * multistart

    rng = np.random.default_rng(seed)
    starts = np.tile(theta0, (rows, 1))
    noise = 1.0 + jitter * rng.standard_normal(starts.shape)
    noise[::multistart] = 1.0
    starts *= noise
    starts[:, k] = np.repeat(grid, multistart)
    mask = np.ones(d)
    mask[k] = 0.0

    kw = dict(dtype=walker.dtype, device=walker.device)
    eval_vg = make_eval_vg(walker._log_post)
    run = make_adam_sgdr_runner(lambda pos, data: eval_vg(pos)[:2], n_steps)
    lp_eval = walker._batched_posterior()

    def finite(lp):
        # A NaN start (a default grid outside a parameter's domain) would
        # otherwise never be replaced: 'lp > nan' is never true.
        return torch.where(torch.isfinite(lp), lp, -torch.inf)

    best_pos = torch.as_tensor(starts, **kw)
    best_lp = finite(lp_eval(best_pos))
    data = walker._posterior_data()
    for _ in range(max(1, rounds)):
        s = torch.as_tensor(_nonzero_scales(np.median(np.abs(_host(best_pos)), axis=0))
                            * mask, **kw)
        pos = run(best_pos, s, float(learning_rate), data)
        lp = finite(lp_eval(pos))
        better = lp > best_lp
        best_pos = torch.where(better[:, None], pos, best_pos)
        best_lp = torch.where(better, lp, best_lp)

    profile_lp = _host(best_lp).astype(np.float64).reshape(g_count, multistart).max(axis=1)
    i_best = int(np.argmax(profile_lp))
    return ProfileResult(name=name, grid=grid, profile_lp=profile_lp,
                         lp_max=float(profile_lp.max()), at_max=float(grid[i_best]))
