"""Model evidence (marginal likelihood) off the parallel-tempering ladder.

Port of ``lisp_mcmc_tpu/evidence.py``.  :meth:`Walker.tempered_steps`
samples every power posterior ``pi^beta`` of a geometric ladder; two
estimators read its history:

- **stepping stones** (Xie et al. 2011): ``Z_1 / Z_0 = prod_k
  E_{beta_{k+1}}[exp((beta_k - beta_{k+1}) logpi)]``, each factor a
  log-mean-exp over the hotter rung's samples; the estimate to use;
- **thermodynamic integration** (Gelman & Meng 1998): ``log(Z_1 / Z_0) =
  int_0^1 E_beta[logpi] dbeta`` by the trapezoid rule on the ladder, a
  cross-check (a gap between the two says the ladder is too coarse or
  too cold).

``Z_0`` is the prior box's volume: with the reference's flat-in-bounds
priors (mcmc-fitting.lisp:346-369) ``pi^beta -> 1`` inside the box as
beta -> 0, so the evidence is that of the implied uniform prior; every
parameter must be bounded.  The ladder stops at ``beta_min = 1/t_max``;
the ``[0, beta_min]`` segment is closed by one more stepping stone over
``n_prior`` draws from the box itself (its error folded into ``error``),
and only a fit with no box falls back to the linear closure
``beta_min E_{beta_min}[logpi]``.  The history is reduced in float64 on
the host.  The ladder's posterior evaluations are the walker's
value-only posterior: kernel 1 once a step on the GPU for a fit in its
coverage.

``laplace_approx`` is the closed-form Gaussian at the best point, one
``torch.func.hessian`` of the plain posterior.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["EvidenceResult", "log_evidence", "log_bayes_factor",
           "LaplaceResult", "laplace_approx"]

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _logmeanexp(x: np.ndarray) -> float:
    m = float(np.max(x))
    return m + math.log(float(np.mean(np.exp(x - m))))


@dataclasses.dataclass(frozen=True)
class EvidenceResult:
    """An evidence estimate with its ladder's diagnostics.

    ``log_z`` is the stepping-stone estimate, ``log_z_ti`` the
    thermodynamic-integration cross-check, ``error`` a batch-means
    Monte-Carlo standard error of ``log_z``, ``betas`` / ``mean_logpi`` the
    ladder and its measured integrand, ``tail`` the ``[0, beta_min]``
    closure both include (measured by prior Monte Carlo where a box is
    known).
    """

    log_z: float
    log_z_ti: float
    error: float
    betas: np.ndarray
    mean_logpi: np.ndarray
    tail: float

    def __repr__(self):
        return (f"EvidenceResult(log_z={self.log_z:.4f}, "
                f"log_z_ti={self.log_z_ti:.4f}, error={self.error:.4f}, "
                f"rungs={len(self.betas)}, tail={self.tail:.4f})")


@dataclasses.dataclass(frozen=True)
class LaplaceResult:
    """The Gaussian (Laplace) approximation at the best point: ``cov`` the
    inverse negative Hessian, ``sd`` its per-parameter root diagonal,
    ``log_z`` the Laplace evidence under :func:`log_evidence`'s
    uniform-in-bounds convention (None without a box), ``n_clamped`` the
    Hessian eigenvalues at or below the floor (a flat or saddle direction,
    where the picture is wrong)."""

    mode: dict
    lp_map: float
    cov: np.ndarray
    sd: dict
    log_z: float | None
    n_clamped: int

    def __repr__(self):
        z = "None" if self.log_z is None else f"{self.log_z:.3f}"
        return (f"LaplaceResult(lp_map={self.lp_map:.4f}, log_z={z}, "
                f"n_clamped={self.n_clamped})")


def laplace_approx(walker, bounds=None, prior=None, eig_floor: float = 1e-12):
    """Curvature covariance and the Laplace evidence from one Hessian
    (JAX ``laplace_approx``, evidence.py:113-162):

        log Z ~= lp(MAP) + (d/2) log 2pi + (1/2) log|H^-1| - log V

    ``torch.func.hessian`` of the walker's plain posterior at its best
    step (run ``optimize`` first for a true MAP).  The box resolves like
    :func:`log_evidence`'s.  Eigenvalues are clamped at ``eig_floor`` x
    the largest.  A grouped or aux fit has no single posterior surface:
    a batch of several datasets takes ``laplace_per_dataset``.
    """
    if getattr(walker, "aux", None) is not None and \
            not hasattr(walker, "laplace_per_dataset"):
        raise ValueError("laplace_approx: grouped/aux ensembles have no "
                         "single posterior surface; use per-dataset walkers "
                         "(BatchedFit has laplace_per_dataset)")
    if hasattr(walker, "laplace_per_dataset") and getattr(walker, "n_datasets", 1) > 1:
        raise ValueError("laplace_approx: this is a batched fit — use "
                         "laplace_per_dataset()")
    from .priors import resolve_prior_spec

    lp_map, mode = walker.most_likely_step()
    theta = walker.spec.flatten(mode, dtype=walker.dtype, device=walker.device)
    data = walker._posterior_data()
    if walker.aux is not None:
        # A one-dataset batch: its posterior takes the dataset index.
        zero = torch.zeros((), dtype=torch.int64, device=walker.device)
        neg_hess = -torch.func.hessian(
            lambda v: walker._custom_log_post(v, zero, data))(theta)
    else:
        neg_hess = -torch.func.hessian(lambda v: walker._log_post(v[None])[0])(theta)
    spec = resolve_prior_spec(walker, prior, bounds)
    return _laplace_from_hessian(float(lp_map), mode, neg_hess.detach().cpu().numpy(),
                                 walker.spec.keys, spec, eig_floor, "laplace_approx")


def _laplace_from_hessian(lp_map: float, mode: dict, neg_hess: np.ndarray, keys, spec,
                          eig_floor: float, name: str) -> LaplaceResult:
    """The shared Laplace core: the clamped eigendecomposition to ``cov``,
    ``sd`` and ``log_z``.  ``spec``: a resolved ``PriorSpec``, or None for
    no evidence; each Uniform component takes ``-log(width)``, a named
    one's normalised density being inside the posterior already."""
    h = np.asarray(neg_hess, np.float64)
    h = 0.5 * (h + h.T)
    evals, evecs = np.linalg.eigh(h)
    floor = eig_floor * max(float(evals.max()), 1e-300)
    n_clamped = int(np.sum(evals <= floor))
    evals = np.maximum(evals, floor)
    cov = (evecs / evals) @ evecs.T
    sd = {k: float(np.sqrt(cov[i, i])) for i, k in enumerate(keys)}
    log_z = None
    if spec is not None:
        from .priors import Uniform, as_prior_spec

        spec = as_prior_spec(spec)
        missing = [k for k in keys if k not in spec]
        if missing:
            raise ValueError(f"{name}: prior/bounds missing {missing}")
        log_v = float(sum(math.log(spec[k].high - spec[k].low)
                          for k in keys if isinstance(spec[k], Uniform)))
        d = len(keys)
        log_z = (lp_map + 0.5 * d * math.log(2.0 * math.pi)
                 - 0.5 * float(np.sum(np.log(evals))) - log_v)
    return LaplaceResult(mode=mode, lp_map=lp_map, cov=cov, sd=sd, log_z=log_z,
                         n_clamped=n_clamped)


def _ladder_estimates(lp: np.ndarray, rung: np.ndarray, betas: np.ndarray,
                      n_error_batches: int):
    """Stepping stones over a float64 ``(T, C)`` ladder history whose
    column ``c`` holds a walker of rung ``rung[c]`` (rung 0 cold):
    ``(log Z(1)/Z(beta_min), its batch-means error, mean_logpi (K,))``."""
    K = betas.size
    by_rung = [lp[:, rung == k] for k in range(K)]

    def stepping_stone(a, b):
        total = 0.0
        for k in range(K - 1):
            total += _logmeanexp((betas[k] - betas[k + 1]) * by_rung[k + 1][a:b].ravel())
        return total

    T = lp.shape[0]
    ss = stepping_stone(0, T)
    nb = max(2, min(n_error_batches, T))
    edges = np.linspace(0, T, nb + 1, dtype=int)
    per_batch = [stepping_stone(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]
    err = float(np.std(per_batch, ddof=1) / math.sqrt(len(per_batch)))
    return ss, err, np.asarray([r.mean() for r in by_rung])


def _prior_closure(lp0: np.ndarray, bmin: float) -> tuple[float, float]:
    """``log E_prior[exp(beta_min logpi)]`` over prior draws' float64 log
    posteriors, and its error from 8 batches."""
    lp0 = np.where(np.isfinite(lp0), lp0, -1e300)
    tail = _logmeanexp(bmin * lp0)
    seg = [_logmeanexp(bmin * b) for b in np.array_split(lp0, 8) if b.size]
    return tail, float(np.std(seg, ddof=1) / math.sqrt(len(seg)))


def log_evidence(walker, n_steps: int = 20000, rungs: int = 16, t_max: float = 1e5,
                 burn: float = 0.5, n_error_batches: int = 8, bounds=None, prior=None,
                 seed: int = 0, auto_ladder: bool = False, n_prior: int = 4096,
                 _closure_box=None) -> EvidenceResult:
    """Estimate ``log Z`` of the walker's posterior (JAX ``log_evidence``,
    evidence.py:205-381; see the module's notes).  Where the history keeps
    a subsample of the walkers (W above ``config.history_walkers``), each
    rung's samples are its retained walkers' (the JAX package reshapes the
    columns into rungs and so needs every walker kept).

    Runs :meth:`Walker.tempered_steps` with history (the ensemble ends
    spread over the ladder: re-anneal or ``reset_to_most_likely`` before
    sampling), then reduces the last ``n_steps`` of log-posterior history
    per rung after dropping the leading ``burn`` fraction.  ``prior``: a
    named ``PriorSpec`` (or recovered from a ``log_prior=spec`` fit) runs
    the same ladder on :func:`fit.unit_cube_view`, where the prior is the
    unit cube, and leaves this ensemble untouched.  ``bounds`` (every
    parameter) re-draws the start uniform in the box
    (:func:`smc.seed_prior_box`).  ``seed`` seeds the view and the closure's
    ``n_prior`` box draws (numpy, as the JAX package draws them).
    """
    if not 2 <= rungs <= walker.n_walkers:
        raise ValueError(f"rungs must be in [2, n_walkers], got {rungs}")
    if not 0.0 <= burn < 1.0:
        raise ValueError(f"burn must be in [0, 1), got {burn}")
    from .priors import resolve_prior_spec

    spec = resolve_prior_spec(walker, prior, bounds)
    if spec is not None and not spec.is_uniform:
        from .fit import unit_cube_view

        uw = unit_cube_view(walker, spec, seed=seed)
        ubox = ({k: (0.0, 1.0) for k in walker.spec.keys}
                if (prior is not None or bounds is not None) else None)
        result = log_evidence(uw, n_steps=n_steps, rungs=rungs, t_max=t_max, burn=burn,
                              n_error_batches=n_error_batches, bounds=ubox, seed=seed,
                              auto_ladder=auto_ladder, n_prior=n_prior,
                              _closure_box={k: (0.0, 1.0) for k in walker.spec.keys})
        walker._swap_trace = uw._swap_trace
        walker._swap_betas = uw._swap_betas
        return result
    if prior is not None or bounds is not None:
        from .smc import seed_prior_box

        try:
            seed_prior_box(walker, spec.bounds)
        except ValueError as e:
            raise ValueError(f"log_evidence: {e}") from None

    walker.tempered_steps(n_steps, rungs=rungs, t_max=float(t_max), collect_history=True,
                          auto_ladder=auto_ladder)
    _, lp = walker._history(None)
    lp = np.asarray(lp, np.float64)
    # Only this run's trailing rows are ladder samples.
    lp = lp[-min(max(1, n_steps // walker._thin), lp.shape[0]):]
    lp = lp[int(lp.shape[0] * burn):]
    if lp.shape[0] < 2:
        raise ValueError("history too short after burn; raise n_steps")
    # Rung k is walker block k; the history may hold an evenly spaced
    # subsample of the walkers (config.history_walkers), each column then
    # read as its walker's rung.
    cols = walker._history_walker_idx()
    cols = np.arange(walker.n_walkers) if cols is None else cols.cpu().numpy()
    if cols.size != lp.shape[1]:
        raise ValueError(f"log_evidence: {lp.shape[1]} history columns for "
                         f"{cols.size} retained walkers")
    betas = np.asarray(walker._swap_betas, np.float64)
    ss, ss_err, mean_logpi = _ladder_estimates(lp, cols // (walker.n_walkers // rungs),
                                               betas, n_error_batches)

    box = spec.bounds if spec is not None else None
    box = box if box is not None else _closure_box
    tail_err = 0.0
    if box is not None:
        keys = list(walker.spec.keys)
        lo = np.asarray([box[k][0] for k in keys], np.float64)
        hi = np.asarray([box[k][1] for k in keys], np.float64)
        u = np.random.default_rng(seed + 987654321).random((int(n_prior), len(keys)))
        pos = torch.as_tensor(lo + u * (hi - lo), dtype=walker.dtype, device=walker.device)
        lp0 = walker._batched_posterior()(pos).detach().cpu().numpy().astype(np.float64)
        tail, tail_err = _prior_closure(lp0, float(betas[-1]))
        ti = float(_trapezoid(mean_logpi[::-1], betas[::-1])) + tail
    else:
        tail = float(betas[-1] * mean_logpi[-1])
        ti = float(_trapezoid(mean_logpi[::-1], betas[::-1])) + tail
    return EvidenceResult(log_z=ss + tail, log_z_ti=ti, error=float(math.hypot(ss_err, tail_err)),
                          betas=betas, mean_logpi=mean_logpi, tail=tail)


def log_bayes_factor(result_a: EvidenceResult, result_b: EvidenceResult) -> tuple[float, float]:
    """``log10 B_ab`` of model a over model b and its standard error
    (positive favours a; Jeffreys' scale: > 2 is decisive)."""
    diff = (result_a.log_z - result_b.log_z) / math.log(10.0)
    err = math.hypot(result_a.error, result_b.error) / math.log(10.0)
    return diff, err
