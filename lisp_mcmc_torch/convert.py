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

__all__ = ["dataset_from_numpy", "state_from_numpy", "walker_from_numpy",
           "batched_from_numpy", "hierarchical_from_numpy", "flow_params_from_numpy"]

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
    l_matrix, m_sum, m_outer, m_count`` (the JAX ``WalkerState`` layout:
    G adaptation groups, G read from ``l_matrix`` (G, d, d); a (d, d) L
    is one group), optionally ``chees`` ((G, 4), the ChEES trajectory
    state; absent reads as zeros), ``age``, ``anneal_step`` and ``key``
    (the raw key words, e.g. ``jax.random.key_data(state.key)``).  The state
    does not depend on the fit's terms: a global fit's carries across as
    a one-term fit's does.
    """
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    t = {k: torch.as_tensor(np.array(arrays[k]), **kw) for k in _STATE_ARRAYS}
    if t["l_matrix"].ndim == 2:
        t["l_matrix"] = t["l_matrix"][None]
    W, d = t["position"].shape
    G = t["l_matrix"].shape[0]
    chees = arrays.get("chees")
    t["chees"] = (torch.zeros((G, 4), **kw) if chees is None
                  else torch.as_tensor(np.array(chees), **kw))
    shapes = {"logprob": (W,), "best_position": (W, d), "best_logprob": (W,),
              "l_matrix": (G, d, d), "m_sum": (G, d), "m_outer": (G, d, d),
              "m_count": (G,), "chees": (G, 4)}
    bad = {k: tuple(t[k].shape) for k, s in shapes.items() if tuple(t[k].shape) != s}
    if bad:
        raise ValueError(f"state_from_numpy: with position ({W}, {d}) and {G} "
                         f"adaptation group(s), these arrays are misshapen: {bad}")
    state = WalkerState(**t, age=int(arrays.get("age", 0)),
                        anneal_step=int(arrays.get("anneal_step", 0)))
    return state, _seed_from_key(arrays.get("key"))


def walker_from_numpy(arrays: Mapping, datasets=None, **create_kwargs):
    """A port :class:`~lisp_mcmc_torch.fit.Walker` holding a given state.

    ``create_kwargs`` go to :func:`~lisp_mcmc_torch.fit.walker_create`
    (models, data, params, errors, priors, config, dtype, device); the
    walker count comes from ``arrays["position"]``.  The state and the
    generator seed come from :func:`state_from_numpy`.  For a global fit
    the models and data are lists, one per term; a JAX wrapper that renames
    a zoo model's parameters is given here as ``models.renamed``.

    ``datasets`` (optional): one :func:`dataset_from_numpy` field mapping
    per term, the datasets the state was made on (a JAX walker's, padded
    and masked), installed in place of those built from ``data``.
    ``arrays["keys"]`` (optional): the parameter order of the state's
    columns, which must be the walker's.  ``arrays["group_ids"]``
    (optional, (W,)): the walkers' adaptation groups, as many as the
    state's L has; without it a grouped state (G > 1) is refused.
    """
    from .fit import walker_create

    n_walkers = np.asarray(arrays["position"]).shape[0]
    w = walker_create(n_walkers=n_walkers, **create_kwargs)
    keys = arrays.get("keys")
    if keys is not None and tuple(keys) != w.spec.keys:
        raise ValueError(f"walker_from_numpy: the state's columns are "
                         f"{tuple(keys)}, the walker's {w.spec.keys}")
    if datasets is not None:
        if len(datasets) != len(w.terms):
            raise ValueError(f"walker_from_numpy: {len(datasets)} datasets for "
                             f"{len(w.terms)} terms")
        for term, fields in zip(w.terms, datasets):
            term.dataset = dataset_from_numpy(fields, dtype=w.dtype, device=w.device)
        w._runner_cache.clear()
    w.state, seed = state_from_numpy(arrays, dtype=w.dtype, device=w.device)
    n_groups = w.state.l_matrix.shape[0]
    group_ids = arrays.get("group_ids")
    if group_ids is not None:
        group_ids = np.asarray(group_ids, np.int64)
        if group_ids.shape != (n_walkers,) or group_ids.min() < 0 \
                or group_ids.max() >= n_groups:
            raise ValueError(f"walker_from_numpy: group_ids must be ({n_walkers},) "
                             f"in [0, {n_groups})")
    elif n_groups > 1:
        raise ValueError(f"walker_from_numpy: the state has {n_groups} adaptation "
                         "groups but no group_ids")
    w.group_ids, w.n_groups = group_ids, n_groups
    w.generator.manual_seed(seed)
    return w


def batched_from_numpy(fit, arrays: Mapping, datasets=None):
    """Install a batch's state in a port :class:`~lisp_mcmc_torch.BatchedFit`
    (or ``BatchedNVFit``) built on the same data, and return it.

    ``arrays``: :func:`state_from_numpy`'s arrays with one L per dataset,
    ``group_ids`` (each walker's dataset, in contiguous blocks) and
    optionally ``aux`` (the JAX batch's per-walker dataset index) and
    ``keys``; each must match the port batch's.  ``datasets``: optionally
    one :func:`dataset_from_numpy` field mapping per dataset (a JAX
    batch's, padded to its lane-aligned length), installed in place of the
    port's (``BatchedFit._set_datasets``).  The random streams differ by
    design: the state's key seeds the walker's generator.
    """
    keys = arrays.get("keys")
    if keys is not None and tuple(keys) != fit.spec.keys:
        raise ValueError(f"batched_from_numpy: the state's columns are {tuple(keys)}, "
                         f"the batch's {fit.spec.keys}")
    gids = np.asarray(arrays["group_ids"], np.int64)
    if not np.array_equal(gids, fit.group_ids):
        raise ValueError("batched_from_numpy: group_ids differ from the batch's "
                         f"({fit.n_datasets} blocks of {fit.walkers_per_dataset})")
    aux = arrays.get("aux")
    if aux is not None and not np.array_equal(np.asarray(aux), gids):
        raise ValueError("batched_from_numpy: aux is not each walker's dataset index")
    state, seed = state_from_numpy(arrays, dtype=fit.dtype, device=fit.device)
    if state.l_matrix.shape[0] != fit.n_datasets:
        raise ValueError(f"batched_from_numpy: {state.l_matrix.shape[0]} adaptation "
                         f"groups for {fit.n_datasets} datasets")
    if datasets is not None:
        fit._set_datasets([dataset_from_numpy(f, dtype=fit.dtype, device=fit.device)
                          for f in datasets])
    fit.state = state
    fit.generator.manual_seed(seed)
    return fit


def hierarchical_from_numpy(fit, arrays: Mapping):
    """Install a hierarchical fit's state in a port
    :class:`~lisp_mcmc_torch.hierarchical.HierarchicalFit` built on the same
    inputs, and return it.

    ``arrays``: :func:`state_from_numpy`'s arrays (one adaptation group;
    absent ``chees``, ``age`` and ``anneal_step`` read as zeros, ``key``
    seeds the generator through :func:`_seed_from_key`), optionally
    ``keys`` (the walk-space columns, which must be the fit's) and the
    history as ``history_positions`` (T, W', d) and ``history_logprobs``
    (T, W'), e.g. a JAX fit's ``_history()``.
    """
    keys = arrays.get("keys")
    if keys is not None and tuple(keys) != fit.spec.keys:
        raise ValueError(f"hierarchical_from_numpy: the state's columns are "
                         f"{tuple(keys)}, the fit's {fit.spec.keys}")
    state, seed = state_from_numpy(arrays, dtype=fit.dtype, device=fit.device)
    if state.l_matrix.shape[0] != 1 or state.position.shape[1] != fit.spec.ndim:
        raise ValueError(f"hierarchical_from_numpy: want one adaptation group over "
                         f"d = {fit.spec.ndim}, got L {tuple(state.l_matrix.shape)}")
    fit.state = state
    fit.n_walkers = int(state.position.shape[0])
    fit.generator.manual_seed(seed)
    hist = arrays.get("history_positions")
    fit.reset()
    if hist is not None:
        np_dtype = torch.empty((), dtype=fit.dtype).numpy().dtype
        pos = np.array(hist, np_dtype)
        lp = np.array(arrays["history_logprobs"], np_dtype)
        if pos.ndim != 3 or pos.shape[2] != fit.spec.ndim or lp.shape != pos.shape[:2]:
            raise ValueError(f"hierarchical_from_numpy: history of {pos.shape} positions "
                             f"and {lp.shape} logprobs")
        fit._hist_positions, fit._hist_logprobs = [pos], [lp]
    return fit


def flow_params_from_numpy(params: Mapping, dtype=torch.float64, device=None) -> dict:
    """A RealNVP flow's parameters as the port's forward pass takes them
    (``variational._flow_forward_fn``): ``{"mu", "raw", "layers": [{"w1",
    "b1", "w2", "b2", "w3", "b3"}, ...]}`` of tensors, from the JAX
    package's ``FlowVIResult._params`` (the same nesting of arrays) or from
    a checkpoint's flat arrays (``mu``, ``raw``, ``layer{k}_{name}``)."""
    from .variational import _LAYER_LEAVES, _torch_params

    if "layers" not in params:
        n_layers = len({k.split("_", 1)[0] for k in params if k.startswith("layer")})
        params = {"mu": params["mu"], "raw": params["raw"],
                  "layers": [{n: params[f"layer{k}_{n}"] for n in _LAYER_LEAVES}
                             for k in range(n_layers)]}
    return _torch_params(params, dtype, resolve_device(device))
