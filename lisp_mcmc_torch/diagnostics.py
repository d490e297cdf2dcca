"""Per-parameter convergence numbers from a walker history.

The main path's subset of ``lisp_mcmc_tpu/diagnostics.py``: ESS and
split R-hat per parameter, reduced where the history lies (a CUDA tensor
is reduced on the GPU, an array on the CPU); only ``d`` scalars reach the
host.
"""

from __future__ import annotations

import torch

from .ops.reductions import effective_sample_size, split_rhat

__all__ = ["ess_from_history", "rhat_from_history"]


def ess_from_history(positions, keys) -> dict[str, float]:
    """ESS per parameter from a ``(T, W, d)`` history."""
    positions = torch.as_tensor(positions)
    return {k: float(effective_sample_size(positions[:, :, i]))
            for i, k in enumerate(keys)}


def rhat_from_history(positions, keys) -> dict[str, float]:
    """Split R-hat per parameter from a ``(T, W, d)`` history."""
    positions = torch.as_tensor(positions)
    return {k: float(split_rhat(positions[:, :, i])) for i, k in enumerate(keys)}
