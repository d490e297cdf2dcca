"""Simulation-based calibration: validate the whole fitting pipeline.

Port of ``lisp_mcmc_tpu/sbc.py``: ``sbc_check`` and the partial-pooling
study ``sbc_check_hierarchical``.  SBC (Talts et al. 2018) draws
parameters from the prior, simulates a dataset from each, fits every
dataset, and ranks each truth among its posterior draws: a calibrated
pipeline gives uniform ranks, and any defect (a biased kernel, an unburnt
anneal, a mis-scaled noise model, a prior/simulator mismatch) shows as
non-uniform ranks.  All simulated datasets fit as one
:class:`~lisp_mcmc_torch.BatchedFit` ensemble on the GPU, and all simulated
hierarchical grids as the groups of one grouped joint walker (the plain
batched posterior both: neither CUDA kernel has a per-walker dataset).  The truths,
datasets and starting guesses come from one numpy Generator in the JAX
package's order, so both packages simulate the same study from a seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

__all__ = ["SBCResult", "sbc_check", "sbc_check_hierarchical"]


@dataclasses.dataclass(frozen=True)
class SBCResult:
    """Rank statistics from one SBC run (JAX ``SBCResult``).

    ``ranks[i, j]``: rank of simulation i's true parameter j among its
    ``n_draws`` posterior draws (0..n_draws, uniform when calibrated).
    ``p_values``: per-parameter chi-square uniformity p-value over
    ``n_bins`` rank bins; ``ok`` applies alpha = 0.01 jointly (Bonferroni
    across parameters).  ``sim_ok``: each simulation's convergence gate
    (``diagnostics.grouped_refit_health``); a False row is unreliable.
    """

    ranks: np.ndarray
    n_draws: int
    n_bins: int
    keys: tuple
    p_values: dict
    true_params: np.ndarray
    sim_ok: np.ndarray | None = None

    @property
    def n_sims(self) -> int:
        return self.ranks.shape[0]

    def ok(self, alpha: float = 0.01) -> bool:
        return all(p > alpha / len(self.keys) for p in self.p_values.values())

    def __repr__(self):
        worst = min(self.p_values, key=self.p_values.get)
        return (f"SBCResult(n_sims={self.n_sims}, n_draws={self.n_draws}, "
                f"ok={self.ok()}, worst p: {worst}="
                f"{self.p_values[worst]:.3g})")


def _bin_masses(n_draws: int, n_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """(edges, per-bin probability mass) over the n_draws + 1 integer ranks:
    equal-width bins over a discrete support hold unequal mass unless
    ``n_bins`` divides ``n_draws + 1``, so the test uses each bin's own."""
    edges = np.linspace(0.0, n_draws + 1.0, n_bins + 1)
    per_rank, _ = np.histogram(np.arange(n_draws + 1) + 0.5, bins=edges)
    return edges, per_rank / float(n_draws + 1)


def _uniformity_pvalue(ranks_j: np.ndarray, n_draws: int, n_bins: int) -> float:
    """Exact-mass chi-square test of rank uniformity."""
    from scipy.stats import chi2

    edges, mass = _bin_masses(n_draws, n_bins)
    counts, _ = np.histogram(ranks_j + 0.5, bins=edges)
    expected = ranks_j.size * mass
    stat = float(np.sum((counts - expected) ** 2 / expected))
    return float(chi2.sf(stat, n_bins - 1))


def _observation_model(simulate, log_likelihood, data_error, x,
                       caller: str = "sbc_check"):
    """The generative twin of the fit's likelihood (JAX
    ``_observation_model``): ``draw(rng, mu, p_true) -> y`` on the host.
    An explicit ``simulate(rng, mu)`` wins; the Gaussian (and its cutoff
    form, whose clamp simulated-from-truth data never reach) simulates
    ``mu + sigma N(0, 1)``, the Poisson ``poisson(max(mu, 0))``, a factory
    likelihood its ``_sbc_simulator``; anything else is refused, since a
    simulator/likelihood mismatch is what SBC detects."""
    from .likelihoods import (log_likelihood_normal, log_likelihood_normal_cutoff,
                              log_likelihood_poisson)

    if callable(simulate):
        return lambda rng, mu, p: simulate(rng, mu)

    def _sigma():
        if data_error is None:
            raise ValueError(
                f"{caller}: this observation model needs data_error "
                "(the per-point noise scale)")
        return np.broadcast_to(np.asarray(data_error, np.float64),
                               x.shape[:1]).astype(np.float64)

    if log_likelihood is None or log_likelihood in (
            log_likelihood_normal, log_likelihood_normal_cutoff):
        sigma = _sigma()
        return lambda rng, mu, p: mu + sigma * rng.standard_normal(mu.shape)
    if log_likelihood is log_likelihood_poisson:
        return lambda rng, mu, p: rng.poisson(np.clip(mu, 0.0, None)).astype(np.float64)
    sim = getattr(log_likelihood, "_sbc_simulator", None)
    if sim is not None:
        sigma = _sigma()
        return lambda rng, mu, p: sim(rng, mu, sigma, p)
    raise ValueError(
        f"{caller}: no generative twin for likelihood "
        f"{getattr(log_likelihood, '__name__', log_likelihood)!r} — pass "
        "simulate=(rng, mu) -> y matching it (SBC cannot guess the "
        "observation model; a mismatch is what it detects)")


def _rank_study(fit, n_sims: int, B: int, truths, keys, n_draws: int,
                n_bins: int, caller: str) -> SBCResult:
    """Rank each truth among ``n_draws`` evenly spaced draws of its block's
    retained history (columns by ``fit.history_block_columns``), test each
    parameter's ranks for uniformity, and gate each simulation's
    convergence (JAX ``_rank_study``)."""
    from .diagnostics import grouped_refit_health
    from .fit import history_block_columns

    pos, _ = fit._history(None)                       # (T, W, d)
    pos = np.asarray(pos)
    cols = history_block_columns(fit, pos.shape[1])
    t_rows = pos.shape[0]
    if t_rows * B < n_draws:
        raise ValueError(
            f"{caller}: only {t_rows * B} retained draws per "
            f"simulation (need n_draws={n_draws}) — raise n_steps or "
            "lower burn_fraction")
    truths = np.asarray(truths, np.float64)
    d = len(keys)
    ranks = np.empty((n_sims, d), np.int64)
    for i in range(n_sims):
        block = pos[:, cols[i], :].reshape(-1, d)
        idx = np.linspace(0, block.shape[0] - 1, n_draws).astype(int)
        ranks[i] = np.sum(block[idx] < truths[i][None, :], axis=0)
    p_values = {k: _uniformity_pvalue(ranks[:, j], n_draws, n_bins)
                for j, k in enumerate(keys)}
    sim_ok = grouped_refit_health(fit, caller)
    return SBCResult(ranks=ranks, n_draws=n_draws, n_bins=n_bins, keys=keys,
                     p_values=p_values, true_params=truths, sim_ok=sim_ok)


def _simulated_mean(function, x, params: Mapping) -> np.ndarray:
    """``function(x, params)`` in float64 on the host, as a (P,) array."""
    x_t = torch.as_tensor(x, dtype=torch.float64)
    with torch.no_grad():
        mu = function(x_t, {k: torch.tensor(float(v), dtype=torch.float64)
                            for k, v in params.items()})
    return np.broadcast_to(np.asarray(mu.numpy(), np.float64), x.shape[:1]).copy()


def sbc_check(
    function: Callable,
    bounds: Mapping,
    x,
    data_error=None,
    *,
    n_sims: int = 64,
    walkers_per_dataset: int = 64,
    n_steps: int = 4000,
    temperature: float = 2.0,
    burn_fraction: float = 0.5,
    n_draws: int = 63,
    n_bins: int | None = None,
    seed: int = 0,
    config=None,
    dtype=None,
    device=None,
    simulate: Callable | None = None,
    log_likelihood: Callable | None = None,
    fit=None,
    sampling_steps: int = 0,
    sampling_kernel: str = "mala",
) -> SBCResult:
    """Run an SBC study of the fitting pipeline for one model (JAX
    ``sbc_check``, sbc.py:193-320).

    ``n_sims`` truths are drawn from ``bounds`` (a box table or any
    ``PriorSpec``, also the fit's prior), datasets simulated on the shared
    grid ``x`` by the likelihood's generative twin (``simulate(rng, mu)``
    overrides it), each started from an independent prior draw, and all
    fitted as one :class:`BatchedFit` (``walkers_per_dataset`` each,
    ``history_walkers`` zeroed so every block is retained) on ``device``
    (None: the GPU; without one it raises unless ``device="cpu"``).
    ``n_steps`` adaptive steps at ``temperature``; with ``sampling_steps``
    a cold ``sampling_kernel`` phase follows and is ranked alone; the
    first ``burn_fraction`` of the ranked history is dropped.  ``fit``: a
    constructed, unstepped BatchedFit over the simulated datasets in place
    of the default one.  ``dtype`` is a torch dtype (default float32).
    ∪-shaped ranks: a posterior too narrow; ∩: too wide; sloped: biased.
    """
    from .batched import BatchedFit
    from .priors import as_prior_spec

    if n_bins is None:
        # >= 5 expected counts a bin keeps the chi-square honest
        n_bins = int(max(2, min(20, n_sims // 5)))
    spec = as_prior_spec(bounds)
    keys = tuple(spec.keys())
    rng = np.random.default_rng(seed)
    truths = spec.sample(rng, n_sims, keys)

    x = np.asarray(x, np.float64)
    draw_y = _observation_model(simulate, log_likelihood, data_error, x)

    datasets, guesses = [], []
    for i in range(n_sims):
        p_true = dict(zip(keys, truths[i]))
        datasets.append((x, draw_y(rng, _simulated_mean(function, x, p_true), p_true)))
        # an independent prior draw as the start: starting at the truth
        # would mask burn-in defects, which SBC audits
        guesses.append(dict(zip(keys, spec.sample(rng, 1, keys)[0])))

    if fit is None:
        fit = BatchedFit(
            function, datasets, guesses, data_error=data_error,
            log_prior=spec.as_log_prior(), log_likelihood=log_likelihood,
            walkers_per_dataset=walkers_per_dataset, seed=seed,
            walker_jitter=0.0, config=config, dtype=dtype, device=device)
        if fit.config.history_walkers and fit.config.history_walkers < fit.n_walkers:
            # ranks need every block in the host history
            fit.config = dataclasses.replace(fit.config, history_walkers=0)
    B = fit.walkers_per_dataset

    fit.adaptive_steps(n_steps, temperature=temperature, auto=None)
    if sampling_steps > 0:
        # rank a cold gradient-kernel phase only
        fit.reset()
        fit.sampling_steps(sampling_steps, kernel=sampling_kernel)
    fit.burn_steps(int(len(fit) * burn_fraction))

    return _rank_study(fit, n_sims, B, truths, keys, n_draws, n_bins, "sbc_check")


def sbc_check_hierarchical(
    function: Callable,
    x,
    params: Mapping,
    n_datasets: int,
    data_error=None,
    *,
    hyper: Mapping,
    pooled=None,
    local_priors: Mapping | None = None,
    n_sims: int = 40,
    walkers_per_sim: int = 32,
    n_steps: int = 4000,
    temperature: float = 2.0,
    burn_fraction: float = 0.5,
    n_draws: int = 63,
    n_bins: int | None = None,
    seed: int = 0,
    config=None,
    dtype=None,
    device=None,
    simulate: Callable | None = None,
    log_likelihood: Callable | None = None,
    sampling_steps: int = 0,
    sampling_kernel: str = "mala",
    correlation: str = "diag",
    corr_prior=None,
) -> SBCResult:
    """SBC of the partial-pooling pipeline (JAX ``sbc_check_hierarchical``,
    sbc.py:323-477): :class:`~lisp_mcmc_torch.HierarchicalFit` calibrated
    end to end over its walk-space prior, a product of 1-D distributions.

    A template fit on placeholder data (``n_datasets`` datasets on the
    grid ``x``, ``params`` its guess, ``hyper`` naming every pooled
    parameter, ``local_priors`` every non-pooled one) gives the walk space.
    Per simulation: a walk-space truth from ``template.prior_spec``,
    decoded to each dataset's parameters, and ``n_datasets`` datasets
    simulated by the likelihood's generative twin (``simulate(rng, mu)``
    overrides it; one observation model a dataset, so per-dataset errors
    stay per dataset).  All ``n_sims`` joint posteriors run as the groups
    of one walker (``HierarchicalFit._grouped_joint_walker``) from
    independent prior draws, ``walkers_per_sim`` each; with
    ``sampling_steps`` a cold ``sampling_kernel`` phase follows and is
    ranked alone.  The truths, the simulated data and the starts come from
    ``np.random.default_rng(seed)`` in JAX's order.  Returns an
    :class:`SBCResult` over the walk-space names (``{p}__mu``,
    ``{p}__tau``, ``{p}__z{s}``, ``{k}__{s}``) with the walk-space truths.
    ``device=None`` means the GPU."""
    from .batched import BatchedFit
    from .data import Dataset
    from .hierarchical import HierarchicalFit

    S = int(n_datasets)
    x = np.asarray(x, np.float64)
    if n_bins is None:
        n_bins = int(max(2, min(20, n_sims // 5)))
    template = HierarchicalFit(
        function, [(x, np.zeros_like(x)) for _ in range(S)], dict(params),
        data_error=data_error, pooled=pooled, hyper=dict(hyper), local_priors=local_priors,
        log_likelihood=log_likelihood, n_walkers=2, seed=seed, dtype=dtype, config=config,
        correlation=correlation, corr_prior=corr_prior, device=device)
    if template.prior_spec is None:
        raise ValueError(
            "sbc_check_hierarchical: the prior is incomplete — declare "
            "local_priors for every non-pooled parameter (SBC draws "
            "truths from the full declared prior)")
    keys = template.spec.keys
    rng = np.random.default_rng(seed)
    truths = template.prior_spec.sample(rng, n_sims, keys)           # walk space
    nat = template._decode_np(np.asarray(truths, np.float64))       # (n, S, dl)

    local_keys = template.local_spec.keys
    if data_error is None:
        errors = [None] * S
        draw_ys = [_observation_model(simulate, log_likelihood, None, x,
                                      caller="sbc_check_hierarchical")] * S
    else:
        errors = BatchedFit._normalize_errors(data_error, [(x, np.zeros_like(x))] * S)
        draw_ys = [_observation_model(simulate, log_likelihood, errors[s], x,
                                      caller="sbc_check_hierarchical")
                   for s in range(S)]
    blocks = []
    for i in range(n_sims):
        dsets = []
        for s in range(S):
            p_true = dict(zip(local_keys, nat[i, s]))
            y = draw_ys[s](rng, _simulated_mean(function, x, p_true), p_true)
            dsets.append(Dataset.create(x, y, errors[s], dtype=template.dtype,
                                        device=template.device, min_len=len(x)))
        blocks.append(dsets)

    B = walkers_per_sim
    pos0 = template.prior_spec.sample(rng, n_sims * B, keys)
    fit = template._grouped_joint_walker(template._joint_blocks(blocks), n_sims, B, seed,
                                         np.asarray(pos0), config=config)
    fit.adaptive_steps(n_steps, temperature=temperature, auto=None)
    if sampling_steps > 0:
        fit.reset()
        fit.sampling_steps(sampling_steps, kernel=sampling_kernel)
    fit.burn_steps(int(len(fit) * burn_fraction))
    return _rank_study(fit, n_sims, B, truths, keys, n_draws, n_bins,
                       "sbc_check_hierarchical")
