"""Tempered Sequential Monte Carlo over the walker ensemble.

Port of ``lisp_mcmc_tpu/smc.py`` (Del Moral, Doucet & Jasra 2006): the
walkers are the particles, reweighting is a (W,) operation, resampling a
cumulative sum and a search, and the moves are the walker's own chunk
runner held at each stage's temperature ``1/beta`` through the runner's
temperature override (``force_cold`` a number: kernel 1 once a step on
the default path, or kernel 2 once a chunk under
``posterior_impl="chunk_kernel"``).  Each ``dbeta`` is picked by
bisection so the weights' relative effective sample size stays at
``target_ress``, and ``log Z = sum_stages (log mean exp(dbeta lp))``
under the uniform-in-bounds ``beta = 0`` measure of ``evidence.py``.  A
grouped fit (a :class:`batched.BatchedFit`) runs one population per
walker block, each with its own evidence, on a shared ladder.

Draws: the box draws and the resampling uniforms come from the walker's
``torch.Generator`` (through :func:`_uniform`), the moves' from the
runner's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import control
from .kernel import _neg_floor

__all__ = ["SMCResult", "smc_sample", "seed_prior_box"]


def _uniform(walker, shape, dtype):
    """``shape`` uniforms in [0, 1) of ``dtype`` from the walker's
    generator, on its device."""
    return torch.rand(shape, generator=walker.generator, dtype=dtype, device=walker.device)


def seed_prior_box(walker, bounds):
    """Re-draw the ensemble uniform in the ``bounds`` box (JAX
    ``seed_prior_box``, smc.py:48-84), the beta = 0 start of
    :func:`smc_sample` and of a prior-seeded ``log_evidence``.

    Checks the box (every parameter, ``high > low``), replaces the
    positions, drops the history and restarts the best points at the new
    draws, whose log posteriors come from the walker's value-only
    posterior (kernel 1 on the GPU for a fit in its coverage).  The draws
    are the walker generator's (the JAX package's take a ``seed``).
    Returns ``(lows, highs)``.
    """
    keys = list(walker.spec.keys)
    missing = [k for k in keys if k not in bounds]
    if missing:
        raise ValueError(f"bounds required for every parameter; missing {missing}")
    kw = dict(dtype=walker.dtype, device=walker.device)
    lows = torch.as_tensor([float(bounds[k][0]) for k in keys], **kw)
    highs = torch.as_tensor([float(bounds[k][1]) for k in keys], **kw)
    if not bool(torch.all(highs > lows)):
        raise ValueError("every bound must have high > low")
    pos = lows + (highs - lows) * _uniform(walker, (walker.n_walkers, walker.ndim),
                                           walker.dtype)
    walker.state = dataclasses.replace(walker.state, position=pos)
    lp = walker._batched_posterior()(pos)
    lp = torch.where(torch.isfinite(lp), lp, _neg_floor(lp.dtype))
    # The old history and best points describe another run.
    walker.reset()
    walker.state = dataclasses.replace(walker.state, logprob=lp, best_position=pos,
                                       best_logprob=lp)
    return lows, highs


@dataclasses.dataclass(frozen=True)
class SMCResult:
    """A realized SMC run: ``log_z``, the ladder ``betas`` (0 -> 1), the
    move acceptance per stage, the stage count and, for a grouped fit,
    ``log_z_per_group`` (``log_z`` is their sum, the joint evidence)."""

    log_z: float
    betas: np.ndarray
    acceptance: np.ndarray
    n_stages: int
    log_z_per_group: np.ndarray | None = None

    def __repr__(self):
        return (f"SMCResult(log_z={self.log_z:.4f}, n_stages={self.n_stages}, "
                f"final_acceptance={self.acceptance[-1]:.3f})")


def _next_beta(lp: np.ndarray, beta: float, target_ress: float) -> float:
    """The largest ``beta' <= 1`` whose incremental weights keep the
    relative ESS at ``target_ress`` or above, by bisection on ``dbeta``."""

    def ress(dbeta: float) -> float:
        w = dbeta * (lp - lp.max())
        w = np.exp(w - w.max())
        return float(w.sum() ** 2 / (len(w) * (w * w).sum()))

    if ress(1.0 - beta) >= target_ress:
        return 1.0
    lo, hi = 0.0, 1.0 - beta
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        if ress(mid) >= target_ress:
            lo = mid
        else:
            hi = mid
    return beta + max(lo, 1e-9)


def smc_sample(walker, bounds=None, n_move: int = 200, target_ress: float = 0.5,
               max_stages: int = 200, seed: int = 0, prior=None,
               target_moves: float | None = 120.0, on_stage=None) -> SMCResult:
    """Tempered SMC from the prior to the posterior (JAX ``smc_sample``,
    smc.py:122-304); the ensemble ends posterior-distributed.

    ``bounds`` (every parameter) is the beta = 0 uniform reference, or
    ``prior`` a named ``PriorSpec``, run on :func:`fit.unit_cube_view`
    (seeded with ``seed``) whose unit cube is that measure; one is
    needed, or a spec recoverable from the fitted terms.  Each stage
    reweights, resamples each population systematically, then moves the
    particles ``n_move`` steps (whole chunks) of the walker's runner at T
    = 1/beta with adaptation on; with ``target_moves`` it keeps stepping
    until the expected accepted moves per particle reach that count
    (capped at 10x the floor).  ``on_stage(info)`` sees ``{"stage",
    "beta", "dbeta", "acceptance", "moved", "chunks", "log_z_partial"}``
    at each stage's end; True requests a stop, which raises (a partial
    ladder is no evidence).  Raises if beta = 1 is not reached in
    ``max_stages``.
    """
    if not 0.0 < target_ress < 1.0:
        raise ValueError(f"target_ress must be in (0, 1), got {target_ress}")
    from .priors import resolve_prior_spec

    spec = resolve_prior_spec(walker, prior, bounds)
    if spec is None:
        raise ValueError("smc_sample: pass bounds= or prior= (no prior "
                         "recipe found on the fitted terms)")
    if not spec.is_uniform:
        from .fit import unit_cube_view

        uw = unit_cube_view(walker, spec, seed=seed)
        result = smc_sample(uw, {k: (0.0, 1.0) for k in walker.spec.keys}, n_move=n_move,
                            target_ress=target_ress, max_stages=max_stages, seed=seed,
                            target_moves=target_moves, on_stage=on_stage)
        # The original ensemble ends posterior-distributed, with the reset
        # of seed_prior_box.
        theta = uw._theta_of_u(uw.state.position).to(walker.dtype)
        lp = walker._eval_batch(theta)
        walker.reset()
        walker.state = dataclasses.replace(walker.state, position=theta, logprob=lp,
                                           best_position=theta, best_logprob=lp)
        return result

    W = walker.n_walkers
    G = getattr(walker, "n_groups", 1) or 1
    if G > 1:
        gids = np.asarray(walker.group_ids)
        B = W // G
        if not np.array_equal(gids, np.repeat(np.arange(G), B)):
            raise ValueError("smc_sample: grouped fits need contiguous "
                             "equal-size walker blocks per group")
    else:
        B = W

    seed_prior_box(walker, spec.bounds)
    runner = walker._runner(with_history=False)
    chunk = walker.config.chunk_size
    n_chunks = max(1, -(-n_move // chunk))

    beta = 0.0
    log_z = np.zeros(G)
    betas, accs = [0.0], []
    for _ in range(max_stages):
        if control.stop_requested():
            raise RuntimeError(f"smc_sample: emergency stop at beta={beta:.4f}; "
                               "partial evidence discarded")
        lp_g = walker.state.logprob.detach().cpu().numpy().astype(np.float64).reshape(G, B)
        # A shared ladder: the most conservative population's dbeta.
        new_beta = min(_next_beta(lp_g[g], beta, target_ress) for g in range(G))
        dbeta = new_beta - beta

        # Per-population evidence increments and systematic resampling.
        u = _uniform(walker, (G,), torch.float64).cpu().numpy()
        idx = np.empty((G, B), np.int64)
        for g in range(G):
            w = np.exp(dbeta * (lp_g[g] - lp_g[g].max()))
            log_z[g] += math.log(w.mean()) + dbeta * lp_g[g].max()
            w /= w.sum()
            local = np.searchsorted(np.cumsum(w), (u[g] + np.arange(B)) / B)
            idx[g] = np.minimum(local, B - 1) + g * B
        idx = torch.as_tensor(idx.reshape(-1), device=walker.device)
        st = walker.state
        walker.state = dataclasses.replace(st, position=st.position[idx],
                                           logprob=st.logprob[idx])

        # Moves at T = 1/beta, past the n_move floor until the particles
        # have moved target_moves times each (one host read a decision).
        temp = 1.0 / new_beta
        acc_parts = []
        chunks_done = 0
        while True:
            walker.state, out = runner(walker.state, True, True, temp,
                                       generator=walker.generator)
            walker.posterior_evals += out["posterior_evals"]
            chunks_done += 1
            acc_parts.append(out["accept_rate"])
            if chunks_done < n_chunks:
                continue
            if target_moves is None or chunks_done >= 10 * n_chunks:
                break
            if float(sum(acc_parts)) * chunk >= target_moves:
                break
        moved = float(sum(acc_parts)) * chunk
        beta = new_beta
        betas.append(beta)
        accs.append(float(out["accept_rate"]))
        if on_stage is not None and on_stage({
                "stage": len(accs), "beta": beta, "dbeta": dbeta, "acceptance": accs[-1],
                "moved": moved, "chunks": chunks_done, "log_z_partial": float(log_z.sum())}):
            raise RuntimeError(f"smc_sample: on_stage requested stop at beta={beta:.4f}; "
                               "partial evidence discarded")
        if beta >= 1.0:
            break
    else:
        raise RuntimeError(f"smc_sample: beta reached only {beta:.4f} in {max_stages} "
                           "stages; raise max_stages or target_ress")
    return SMCResult(log_z=float(log_z.sum()), betas=np.asarray(betas),
                     acceptance=np.asarray(accs), n_stages=len(accs),
                     log_z_per_group=log_z.copy() if G > 1 else None)
