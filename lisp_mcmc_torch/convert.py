"""Carry datasets and walker states in from numpy arrays.

The port keeps the JAX package's layouts at its public functions, so a
state exported as numpy arrays by either package can be installed in the
other and both then compute the same thing (the parity tests do this).
The random streams differ by design: a state's PRNG key becomes the seed
of a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .data import Dataset
from .device import resolve_device
from .kernel import WalkerState

__all__ = ["dataset_from_numpy", "state_from_numpy", "walker_from_numpy"]

_DATASET_CACHES = ("inv_sigma", "log_norm_const", "log_norm_const_point",
                   "log_fact_y")
_STATE_ARRAYS = ("position", "logprob", "best_position", "best_logprob",
                 "l_matrix", "m_sum", "m_outer", "m_count")


def dataset_from_numpy(fields: Mapping, dtype=torch.float64, device=None) -> Dataset:
    """A :class:`Dataset` from arrays ``x, y, sigma, mask`` and count ``n``.

    Cached terms present in ``fields`` are taken as given; missing ones
    are computed.
    """
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    caches = {k: t(fields[k]) for k in _DATASET_CACHES
              if fields.get(k) is not None}
    return Dataset(x=t(fields["x"]), y=t(fields["y"]), sigma=t(fields["sigma"]),
                   mask=t(fields["mask"]), n=int(fields["n"]), **caches)


def _seed_from_key(key) -> int:
    """A generator seed from a PRNG key's raw words (or an int)."""
    if key is None:
        return 0
    words = np.asarray(key, dtype=np.uint64).ravel()
    seed = 0
    for w in words:
        seed = (seed * 0x9E3779B97F4A7C15 + int(w)) % (1 << 63)
    return seed


def state_from_numpy(arrays: Mapping, dtype=torch.float64,
                     device=None) -> tuple[WalkerState, int]:
    """``(WalkerState, generator seed)`` from a state's arrays.

    ``arrays`` holds ``position, logprob, best_position, best_logprob,
    l_matrix, m_sum, m_outer, m_count`` (the JAX ``WalkerState`` layout,
    one group), optionally ``age``, ``anneal_step`` and ``key`` (the raw
    key words, e.g. ``jax.random.key_data(state.key)``).
    """
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    t = {k: torch.as_tensor(np.array(arrays[k]), **kw) for k in _STATE_ARRAYS}
    if t["l_matrix"].ndim == 2:
        t["l_matrix"] = t["l_matrix"][None]
    state = WalkerState(**t, age=int(arrays.get("age", 0)),
                        anneal_step=int(arrays.get("anneal_step", 0)))
    return state, _seed_from_key(arrays.get("key"))


def walker_from_numpy(arrays: Mapping, **create_kwargs):
    """A port :class:`~lisp_mcmc_torch.fit.Walker` holding a given state.

    ``create_kwargs`` go to :func:`~lisp_mcmc_torch.fit.walker_create`
    (model, data, params, errors, config, dtype, device); the walker count
    comes from ``arrays["position"]``.  The state and the generator seed
    come from :func:`state_from_numpy`.
    """
    from .fit import walker_create

    n_walkers = np.asarray(arrays["position"]).shape[0]
    w = walker_create(n_walkers=n_walkers, **create_kwargs)
    w.state, seed = state_from_numpy(arrays, dtype=w.dtype, device=w.device)
    w.generator.manual_seed(seed)
    return w
