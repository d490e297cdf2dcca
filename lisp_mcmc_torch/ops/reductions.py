"""Convergence reductions on the device: autocorrelation, ESS, split R-hat.

Port of ``lisp_mcmc_tpu/ops/reductions.py`` on ``torch.fft``: the
reductions run on the ``(T, W)`` history where it lives, and only
scalars go to the host.
"""

from __future__ import annotations

import torch

__all__ = ["autocorrelation", "effective_sample_size", "split_rhat"]


def autocorrelation(chains, max_lag: int | None = None):
    """Normalized autocorrelation per chain via FFT.

    ``chains``: (T, W) samples.  Returns (L, W) autocorrelations for lags
    0..L-1 where L = ``max_lag`` or T.
    """
    chains = torch.as_tensor(chains)
    T = chains.shape[0]
    L = max_lag or T
    x = chains - chains.mean(dim=0, keepdim=True)
    # Zero-pad to >= 2T for linear (non-circular) autocorrelation.
    n = 1 << (2 * T - 1).bit_length()
    f = torch.fft.rfft(x, n=n, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=n, dim=0)[:T]
    lags = torch.arange(T, 0, -1, dtype=acov.dtype, device=acov.device)
    acov = acov / lags[:, None]                      # unbiased normalization
    var0 = torch.where(acov[0] > 0, acov[0], 1.0)
    return (acov / var0)[:L]


def effective_sample_size(chains):
    """ESS with Geyer's initial positive sequence truncation.

    ``chains``: (T, W).  Returns the total ESS over all W chains (0-d).
    Pairs consecutive-lag autocorrelations and truncates at the first
    non-positive pair sum.
    """
    chains = torch.as_tensor(chains)
    T, W = chains.shape
    rho = autocorrelation(chains)
    n_pairs = (T - 1) // 2
    pair = rho[1:1 + 2 * n_pairs].reshape(n_pairs, 2, W).sum(dim=1)   # (P, W)
    # Monotone mask: True until the first non-positive pair.
    keep = torch.cumprod((pair > 0).to(torch.int32), dim=0).bool()
    tau = 1.0 + 2.0 * torch.where(keep, pair, 0.0).sum(dim=0)        # (W,)
    tau = torch.clamp_min(tau, 1.0)
    # A frozen chain (zero variance) carries one sample of information,
    # not T independent ones (lisp_mcmc_tpu/ops/reductions.py:57-63).
    moving = chains.var(dim=0, correction=0) > 0
    return torch.where(moving, T / tau, 1.0).sum()


def split_rhat(chains):
    """Split-chain Gelman-Rubin R-hat over the walker ensemble.

    ``chains``: (T, W) samples of one quantity across W walkers.  A frozen
    ensemble (within-chain variance below 1e-12 of the pooled variance)
    reads as not converged: inf.
    """
    chains = torch.as_tensor(chains)
    T = chains.shape[0] // 2 * 2
    halves = torch.cat([chains[:T // 2], chains[T // 2:T]], dim=1)   # (T/2, 2W)
    n = halves.shape[0]
    chain_means = halves.mean(dim=0)
    chain_vars = halves.var(dim=0, correction=1)
    w = chain_vars.mean()
    b = n * chain_means.var(correction=1)
    var_plus = (n - 1) / n * w + b / n
    ok = w > 1e-12 * var_plus
    return torch.where(ok, torch.sqrt(var_plus / torch.where(ok, w, 1.0)),
                       torch.inf)
