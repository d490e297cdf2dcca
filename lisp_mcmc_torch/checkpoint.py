"""Checkpoint and resume: save and load a fit's whole state (reference C18).

Port of ``lisp_mcmc_tpu/checkpoint.py``, in its file format, so a file
written by either package loads in the other.  The reference designed but
disabled this (``walker-save``/``walker-load`` exist only as comments,
mcmc-fitting.lisp:980-1027): a fit's data, errors and walk, with its
functions saved by *name*.  Here a fit saves to one ``.npz``: every chain
array, the datasets, the thinned history and a JSON ``header`` (parameter
keys, config, the names of model, likelihood and prior, or a prior's
recipe; ``format_version`` 2).  Closures are never saved: loading resolves
the names against the registries (``models.MODEL_REGISTRY``, the
likelihood and prior tables here) or takes the callables from the caller,
and prints recommendations and returns None when it cannot.

The random streams are the packages' own.  The header's ``prng_impl`` and
the ``key`` words are JAX's (``threefry2x32``, two uint32 words that
``jax.random.wrap_key_data`` accepts): the port writes words hashed from
its generator's state, so a JAX resume of a port file continues from a
key of its own.  The port also writes its ``torch.Generator`` state
(``torch_generator_state``, with the generator's device type in the
header), which the JAX loader ignores: a port file loaded back into the
port on a generator of the same device type resumes bit for bit.  A file
without it (a JAX file, or one from the other device type, whose generator
is another algorithm) seeds the generator from the key words through
``convert._seed_from_key``.  ``posterior_impl`` travels under JAX's names
(``xla``, ``pallas``, ``pallas_chunk`` for the port's ``plain``,
``kernel``, ``chunk_kernel``).  Every array lands on the fit's device
(``device=None``: the GPU); an absent array (``chees``, ``anneal_step``)
reads as zeros.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Sequence

import numpy as np
import torch

from .convert import state_from_numpy
from .data import Dataset
from .device import resolve_device
from .fit import _host
from .kernel import FitConfig
from .likelihoods import (log_likelihood_normal, log_likelihood_normal_cutoff,
                          log_likelihood_poisson)
from .priors import log_prior_flat

__all__ = ["walker_save", "walker_load", "walker_set_save", "walker_set_load",
           "batched_save", "batched_load", "hierarchical_save", "hierarchical_load"]

# v2: FitConfig's refresh_damping / max_history_bytes / history_walkers,
# the "custom" kind and "subclass"; v1 files load (missing config keys take
# the defaults).
FORMAT_VERSION = 2
PRNG_IMPL = "threefry2x32"

LIKELIHOOD_REGISTRY: dict[str, Callable] = {
    "log_likelihood_normal": log_likelihood_normal,
    "log_likelihood_normal_weighted": log_likelihood_normal,
    "log_likelihood_normal_cutoff": log_likelihood_normal_cutoff,
    "log_likelihood_poisson": log_likelihood_poisson,
}

PRIOR_REGISTRY: dict[str, Callable] = {
    "log_prior_flat": log_prior_flat,
}

# the named ``extra=`` hooks of make_bounds_prior, for rebuilding bounds
# priors from their saved recipe
PRIOR_EXTRA_REGISTRY: dict[str, Callable] = {}

# posterior_impl as the file carries it (JAX's names) and as the port does
_IMPL_TO_FILE = {"plain": "xla", "kernel": "pallas", "chunk_kernel": "pallas_chunk"}
_IMPL_FROM_FILE = {v: k for k, v in _IMPL_TO_FILE.items()}


def _register_domain_priors():
    """The NV prior and its constraints, registered late (nv imports this
    package's fits)."""
    from . import nv

    PRIOR_REGISTRY.setdefault("log_prior_nv", nv.log_prior_nv)
    PRIOR_EXTRA_REGISTRY.setdefault("_nv_constraints", nv._nv_constraints)


def _fn_name(fn) -> str:
    return getattr(fn, "__name__", fn.__class__.__name__)


def _prior_meta(prior) -> dict:
    """A prior's saved recipe: a named spec in full, a bounds table with its
    extra hook's name, anything else its name (a pure-uniform spec saves as
    its bounds table, which behaves the same)."""
    spec = getattr(prior, "_prior_spec", None)
    if spec is not None and not spec.is_uniform:
        return {"prior": "prior_spec", "prior_spec": spec.to_meta()}
    bounds = getattr(prior, "_bounds", None)
    if bounds is not None:
        extra = getattr(prior, "_extra", None)
        return {"prior": "bounds_prior",
                "prior_bounds": {k: [float(v[0]), float(v[1])] for k, v in bounds.items()},
                "prior_extra": _fn_name(extra) if extra is not None else None}
    return {"prior": _fn_name(prior)}


def _resolve_prior(meta: dict, supplied, quiet: bool):
    """The prior of a ``_prior_meta`` recipe: given > recipe > registry."""
    if supplied is not None:
        return supplied
    if meta.get("prior") == "prior_spec" and "prior_spec" in meta:
        from .priors import PriorSpec

        return PriorSpec.from_meta(meta["prior_spec"]).as_log_prior()
    if meta.get("prior") == "bounds_prior" and "prior_bounds" in meta:
        from .priors import make_bounds_prior

        bounds = {k: tuple(v) for k, v in meta["prior_bounds"].items()}
        extra_name = meta.get("prior_extra")
        if extra_name is None:
            return make_bounds_prior(bounds)
        extra = PRIOR_EXTRA_REGISTRY.get(extra_name)
        if extra is not None:
            return make_bounds_prior(bounds, extra=extra)
        if not quiet:
            print(f"walker_load: cannot resolve bounds-prior extra hook "
                  f"{extra_name!r}; pass the prior explicitly via log_prior")
        return None
    fn = PRIOR_REGISTRY.get(meta["prior"])
    if fn is None and not quiet:
        print(f"walker_load: cannot resolve log_prior {meta['prior']!r}; "
              f"pass it explicitly via the log_prior argument")
    return fn


def _resolve(names, supplied, registry, kind, quiet):
    """Saved names to callables: given > registry > None."""
    if supplied is not None:
        supplied = supplied if isinstance(supplied, (list, tuple)) else [supplied] * len(names)
        if len(supplied) != len(names):
            raise ValueError(f"{kind}: {len(supplied)} callables supplied for "
                             f"{len(names)} saved terms")
        return list(supplied)
    resolved = []
    for name in names:
        fn = registry.get(name)
        if fn is None:
            if not quiet:
                print(f"walker_load: cannot resolve {kind} {name!r}; "
                      f"pass it explicitly via the {kind} argument")
            return None
        resolved.append(fn)
    return resolved


# ------------------------------------------------------------ the arrays


def _np_dtype(dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _torch_dtype(name: str):
    return getattr(torch, np.dtype(name).name)


def _config_meta(config: FitConfig) -> dict:
    meta = dataclasses.asdict(config)
    meta["posterior_impl"] = _IMPL_TO_FILE.get(meta["posterior_impl"], meta["posterior_impl"])
    return meta


def _config_from_meta(meta: dict) -> FitConfig:
    meta = dict(meta)
    impl = meta.get("posterior_impl")
    meta["posterior_impl"] = _IMPL_FROM_FILE.get(impl, impl)
    return FitConfig(**meta)


def _key_words(state_bytes: np.ndarray) -> np.ndarray:
    """Two uint32 words (a threefry2x32 key's data) from the generator's
    state: a JAX resume of a port file continues from a key of its own."""
    digest = hashlib.blake2b(state_bytes.tobytes(), digest_size=8).digest()
    return np.frombuffer(digest, dtype=np.uint32).copy()


def _header_common(walker) -> dict:
    return {"format_version": FORMAT_VERSION, "param_keys": list(walker.spec.keys),
            "n_walkers": int(walker.n_walkers), "prng_impl": PRNG_IMPL,
            "dtype": _np_dtype(walker.dtype).name, "config": _config_meta(walker.config),
            "torch_generator_device": walker.generator.device.type}


def _dump_state(walker, take) -> dict:
    """Every chain array and the histories (JAX checkpoint.py:299-331), with
    the generator's state and key words hashed from it."""
    st = walker.state
    gen_state = walker.generator.get_state().numpy().copy()
    arrays = {
        "key": _key_words(gen_state),
        "torch_generator_state": gen_state,
        "position": _host(st.position), "logprob": _host(st.logprob),
        "best_position": _host(st.best_position), "best_logprob": _host(st.best_logprob),
        "l_matrix": _host(st.l_matrix), "m_sum": _host(st.m_sum),
        "m_outer": _host(st.m_outer), "m_count": _host(st.m_count),
        "age": np.asarray(st.age, np.int32), "anneal_step": np.asarray(st.anneal_step, np.int32),
        "chees": _host(st.chees),
    }
    hist_pos, hist_lp = walker._history(take)
    arrays["history_positions"] = np.asarray(hist_pos)
    arrays["history_logprobs"] = np.asarray(hist_lp)
    arrays["accept_log"] = np.asarray([float(a) for a in walker._accept_log], np.float64)
    # the auto-stop traces travel with the fit, so a resumed run can settle
    # at once instead of regenerating its trace
    for name, trace in (("lpmax_trace", walker._lpmax_trace),
                        ("lpmean_trace", walker._lpmean_trace)):
        arrays[name] = (np.concatenate([_host(t) for t in trace]) if trace
                        else np.empty(0))
    return arrays


def _restore_state(walker, arrays, header):
    """Install saved chain arrays, histories and the random stream on a
    constructed fit (JAX checkpoint.py:334-375)."""
    dtype, device = walker.dtype, walker.device
    walker.state, seed = state_from_numpy(arrays, dtype=dtype, device=device)
    gen = arrays.get("torch_generator_state")
    if gen is not None and header.get("torch_generator_device") == walker.generator.device.type:
        walker.generator.set_state(torch.as_tensor(np.asarray(gen, np.uint8)))
    else:
        walker.generator.manual_seed(seed)
    np_dtype = _np_dtype(dtype)
    pos = np.asarray(arrays["history_positions"], np_dtype)
    lp = np.asarray(arrays["history_logprobs"], np_dtype)
    walker._hist_positions = [pos] if pos.size else []
    walker._hist_logprobs = [lp] if lp.size else []
    walker._accept_log = [torch.tensor(float(a), dtype=dtype, device=device)
                          for a in arrays["accept_log"]]
    for name in ("lpmax_trace", "lpmean_trace"):
        trace = np.asarray(arrays.get(name, np.empty(0)))
        setattr(walker, f"_{name}",
                [torch.as_tensor(trace, dtype=dtype, device=device)] if trace.size else [])
    # run-scoped ladder diagnostics do not travel
    walker._swap_trace = []
    walker._swap_betas = None
    walker._runner_cache.clear()
    return walker


def _write(path: str, arrays: dict, header: dict) -> None:
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _read(path: str):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays.pop("header")).decode())
    if header["format_version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint format {header['format_version']} is newer than supported")
    return arrays, header


# ------------------------------------------------------------ single fits


def walker_save(walker, path: str, take: int | None = None) -> None:
    """Save a fit to ``path`` (``walker-save``, mcmc-fitting.lisp:980-985;
    JAX checkpoint.py:130-183); ``take`` caps the saved history (test.lisp:
    40).  A batched or hierarchical fit is refused with the verb it takes;
    a custom-posterior, aux or grouped walker saves through the custom
    format, whose callables :func:`walker_load` asks back."""
    if hasattr(walker, "walkers_per_dataset"):
        raise ValueError(
            "walker_save: this is a BatchedFit/BatchedNVFit — use "
            "batched_save, which captures the stacked datasets and block "
            "layout this format does not.")
    if hasattr(walker, "pooled") and hasattr(walker, "local_spec"):
        raise ValueError(
            "walker_save: this is a HierarchicalFit — use "
            "hierarchical_save, which serializes the pooling structure "
            "as distribution recipes this format does not.")
    if (walker._custom_log_post is not None or walker._custom_batched is not None
            or walker.aux is not None or walker.group_ids is not None):
        return _custom_save(walker, path, take)

    arrays = _dump_state(walker, take)
    for i, t in enumerate(walker.terms):
        for f in ("x", "y", "sigma", "mask"):
            arrays[f"term{i}_{f}"] = _host(getattr(t.dataset, f))
    header = {**_header_common(walker),
              "terms": [{"function": _fn_name(t.fn), "likelihood": _fn_name(t.likelihood),
                         "n": int(t.dataset.n), **_prior_meta(t.prior)}
                        for t in walker.terms]}
    _write(path, arrays, header)


def _custom_save(walker, path: str, take) -> None:
    """The names-and-arrays format of a custom-posterior walker (JAX
    checkpoint.py:186-239): the chain arrays, keys, config, ``group_ids``,
    and ``aux`` and ``posterior_data`` where they are tensors (a dict of
    them for the data); the posterior itself is never saved."""
    arrays = _dump_state(walker, take)
    pdata = walker._custom_data
    pdata_saved = False
    if isinstance(pdata, dict) and pdata and all(
            isinstance(k, str) and torch.is_tensor(v) for k, v in pdata.items()):
        arrays.update({f"pdata_{k}": _host(v) for k, v in pdata.items()})
        pdata_saved = True
    aux_saved = torch.is_tensor(walker.aux)
    if aux_saved:
        arrays["aux"] = _host(walker.aux)
    if walker.group_ids is not None:
        arrays["group_ids"] = np.asarray(walker.group_ids)
    header = {
        **_header_common(walker), "kind": "custom", "n_groups": int(walker.n_groups),
        "log_posterior": (_fn_name(walker._custom_log_post)
                          if walker._custom_log_post is not None else None),
        "batched_log_posterior": (_fn_name(walker._custom_batched)
                                  if walker._custom_batched is not None else None),
        "posterior_data_saved": pdata_saved, "had_posterior_data": pdata is not None,
        "aux_saved": aux_saved, "had_aux": walker.aux is not None}
    _write(path, arrays, header)


def _custom_load(arrays, header, *, log_posterior=None, batched_log_posterior=None,
                 posterior_data=None, aux=None, quiet=False, device=None):
    """Load a ``kind=custom`` file; the callables must come back (JAX
    checkpoint.py:242-296)."""
    from .fit import Walker
    from .params import ParamSpec

    need_batched = header.get("batched_log_posterior") is not None
    have_fn = log_posterior is not None or (need_batched and batched_log_posterior is not None)
    need_pdata = (header.get("had_posterior_data") and not header.get("posterior_data_saved")
                  and posterior_data is None)
    need_aux = header.get("had_aux") and not header.get("aux_saved") and aux is None
    if not have_fn or need_aux or need_pdata:
        if not quiet:
            print("*Recommendations*")
            print(f"log_posterior: {header.get('log_posterior')}")
            if need_batched:
                print(f"batched_log_posterior: {header.get('batched_log_posterior')}")
            if need_pdata:
                print("posterior_data: (not serializable; re-supply the dataset pytree)")
            if need_aux:
                print("aux: (not serializable; re-supply the aux pytree)")
        return None
    device = resolve_device(device)
    if posterior_data is None:
        pdata = {k[len("pdata_"):]: torch.as_tensor(v, device=device)
                 for k, v in arrays.items() if k.startswith("pdata_")}
        posterior_data = pdata or None
    if aux is None and header.get("aux_saved"):
        aux = arrays["aux"]
    walker = Walker(
        [], ParamSpec(tuple(header["param_keys"])), arrays["position"],
        n_walkers=int(header["n_walkers"]), config=_config_from_meta(header["config"]),
        dtype=_torch_dtype(header["dtype"]), device=device,
        # aux is read by the per-walker posterior only
        aux=aux if log_posterior is not None else None,
        group_ids=arrays.get("group_ids"), n_groups=int(header.get("n_groups", 1)),
        log_posterior=log_posterior, posterior_data=posterior_data,
        batched_log_posterior=batched_log_posterior)
    return _restore_state(walker, arrays, header)


def walker_load(path: str, *, function=None, log_likelihood=None, log_prior=None,
                log_posterior=None, batched_log_posterior=None, posterior_data=None,
                aux=None, quiet: bool = False, device=None):
    """Load a fit (``walker-load``, mcmc-fitting.lisp:987-1001; JAX
    checkpoint.py:686-758), resumable.  Names resolve against the
    registries unless the callables are given; an unresolvable name prints
    the recommendations and returns None (the reference's contract, 997).
    A custom-posterior file asks its callables back.  ``device=None``
    means the GPU."""
    from .fit import Walker, _Term
    from .models import MODEL_REGISTRY
    from .params import ParamSpec

    arrays, header = _read(path)
    if header.get("kind") == "custom":
        return _custom_load(arrays, header, log_posterior=log_posterior,
                            batched_log_posterior=batched_log_posterior,
                            posterior_data=posterior_data, aux=aux, quiet=quiet, device=device)
    if header.get("kind") in ("batched", "hierarchical"):
        raise ValueError(f"walker_load: a {header['kind']} checkpoint; use "
                         f"{header['kind']}_load")

    term_meta = header["terms"]
    fn_names = [t["function"] for t in term_meta]
    ll_names = [t["likelihood"] for t in term_meta]
    lp_names = [t["prior"] for t in term_meta]
    _register_domain_priors()
    functions = _resolve(fn_names, function, MODEL_REGISTRY, "function", quiet)
    likelihoods = _resolve(ll_names, log_likelihood, LIKELIHOOD_REGISTRY, "log_likelihood",
                           quiet)
    supplied = (log_prior if isinstance(log_prior, (list, tuple))
                else [log_prior] * len(term_meta))
    if len(supplied) != len(term_meta):
        raise ValueError(f"log_prior: {len(supplied)} callables supplied for "
                         f"{len(term_meta)} saved terms")
    priors = [_resolve_prior(t, s, quiet) for t, s in zip(term_meta, supplied)]
    if any(p is None for p in priors):
        priors = None
    if functions is None or likelihoods is None or priors is None:
        if not quiet:
            print("*Recommendations*")
            print(f"function: {fn_names}")
            print(f"log_likelihood: {ll_names}")
            print(f"log_prior: {lp_names}")
        return None

    device = resolve_device(device)
    dtype = _torch_dtype(header["dtype"])
    kw = dict(dtype=dtype, device=device)
    terms = []
    for i, (meta, fn, ll, lp) in enumerate(zip(term_meta, functions, likelihoods, priors)):
        ds = Dataset(**{f: torch.as_tensor(arrays[f"term{i}_{f}"], **kw)
                        for f in ("x", "y", "sigma", "mask")}, n=int(meta["n"]))
        terms.append(_Term(fn=fn, dataset=ds, likelihood=ll, prior=lp))
    walker = Walker(terms, ParamSpec(tuple(header["param_keys"])), arrays["position"],
                    n_walkers=int(header["n_walkers"]),
                    config=_config_from_meta(header["config"]), dtype=dtype, device=device,
                    n_groups=int(np.asarray(arrays["l_matrix"]).shape[0]))
    return _restore_state(walker, arrays, header)


# ----------------------------------------------------- batched and pooled


def _stack_batch_arrays(fit, take) -> dict:
    """The chain arrays and the stacked datasets (JAX checkpoint.py:
    378-398): sigma saved directly (1/inv_sigma drifts an ulp), zero on
    the pad lanes, which a load slices off before ``Dataset.create``."""
    arrays = _dump_state(fit, take)
    arrays["batch_x"] = np.stack([_host(ds.x).astype(np.float64) for ds in fit._datasets])
    arrays["batch_y"] = np.stack([_host(ds.y).astype(np.float64) for ds in fit._datasets])
    arrays["batch_err"] = np.stack([_host(ds.sigma).astype(np.float64)
                                    * _host(ds.mask).astype(np.float64)
                                    for ds in fit._datasets])
    return arrays


def _batch_header_fields(fit) -> dict:
    term = fit.terms[0]
    return {**_header_common(fit), "n_datasets": int(fit.n_datasets),
            "n_points_per_dataset": [int(ds.n) for ds in fit._datasets],
            "function": _fn_name(term.fn), "likelihood": _fn_name(term.likelihood)}


def batched_save(fit, path: str, take: int | None = None) -> None:
    """Save a :class:`~lisp_mcmc_torch.BatchedFit` (JAX checkpoint.py:
    415-445): its registry model's name, the stacked datasets, the block
    layout and every chain array."""
    if fit._custom_data is None or not hasattr(fit, "walkers_per_dataset"):
        raise ValueError("batched_save: not a BatchedFit; use walker_save")
    arrays = _stack_batch_arrays(fit, take)
    header = {**_batch_header_fields(fit), "kind": "batched",
              "subclass": type(fit).__name__, "n_points": int(fit.terms[0].dataset.n),
              "walkers_per_dataset": int(fit.walkers_per_dataset),
              **_prior_meta(fit.terms[0].prior)}
    _write(path, arrays, header)


def batched_load(path: str, *, function=None, log_likelihood=None, log_prior=None,
                 quiet: bool = False, device=None):
    """Load a :func:`batched_save` file into a resumable BatchedFit (or
    BatchedNVFit) (JAX checkpoint.py:448-520); names resolve as in
    :func:`walker_load`, a factory likelihood comes back through
    ``log_likelihood``.  ``device=None`` means the GPU."""
    from .batched import BatchedFit
    from .models import MODEL_REGISTRY

    arrays, header = _read(path)
    if header.get("kind") != "batched":
        raise ValueError("batched_load: not a batched checkpoint; use walker_load")
    _register_domain_priors()
    fns = _resolve([header["function"]], function, MODEL_REGISTRY, "function", quiet)
    prior = _resolve_prior(header, log_prior, quiet)
    ll_name = header.get("likelihood", "log_likelihood_normal")
    lls = _resolve([ll_name], log_likelihood, LIKELIHOOD_REGISTRY, "log_likelihood", quiet)
    if fns is None or prior is None or lls is None:
        if not quiet:
            print("*Recommendations*")
            print(f"function: {header['function']}")
            print(f"log_likelihood: {ll_name}")
            print(f"log_prior: {header['prior']}")
        return None
    keys = header["param_keys"]
    S, B = header["n_datasets"], header["walkers_per_dataset"]
    ns = header.get("n_points_per_dataset") or [header["n_points"]] * S
    x, y, err = arrays["batch_x"], arrays["batch_y"], arrays["batch_err"]
    # any valid guess will do (the saved state replaces it): each block's best
    best_lp = arrays["best_logprob"].reshape(S, B)
    best_pos = arrays["best_position"].reshape(S, B, -1)
    guesses = [dict(zip(keys, best_pos[g, int(np.argmax(best_lp[g]))].tolist()))
               for g in range(S)]
    fit = BatchedFit(
        fns[0], [(x[g, :ns[g]], y[g, :ns[g]]) for g in range(S)], guesses,
        data_error=[err[g, :ns[g]] for g in range(S)],
        log_prior=None if header["prior"] == "log_prior_flat" else prior,
        log_likelihood=lls[0], walkers_per_dataset=B, dtype=_torch_dtype(header["dtype"]),
        config=_config_from_meta(header["config"]), device=device)
    if header.get("subclass") == "BatchedNVFit":
        # BatchedNVFit holds no state of its own, only derived properties
        from .nv import BatchedNVFit

        fit.__class__ = BatchedNVFit
    return _restore_state(fit, arrays, header)


def hierarchical_save(fit, path: str, take: int | None = None) -> None:
    """Save a :class:`~lisp_mcmc_torch.HierarchicalFit` (JAX checkpoint.py:
    523-563): the batched format plus the pooling structure as
    distribution recipes (``to_meta``), the per-term function names of a
    multi-term fit, and the decoded per-dataset best as the guesses."""
    from .hierarchical import HierarchicalFit

    if not isinstance(fit, HierarchicalFit):
        raise ValueError("hierarchical_save: not a HierarchicalFit; "
                         "use walker_save / batched_save")
    arrays = _stack_batch_arrays(fit, take)
    fn = fit.terms[0].fn
    header = {
        **_batch_header_fields(fit), "kind": "hierarchical",
        "local_keys": list(fit.local_spec.keys), "pooled": list(fit.pooled),
        "hyper": {p: {"mu": mu.to_meta(), "tau": tau.to_meta()}
                  for p, (mu, tau) in fit._hyper.items()},
        "local_priors": {k: d.to_meta() for k, d in fit._local_dists.items()},
        "correlation": fit.correlation,
        "corr_prior": fit._corr_dist.to_meta() if fit._corr_dist is not None else None,
        "term_functions": [getattr(f, "__name__", "f")
                           for f in getattr(fn, "_term_fns", ())] or None,
        "term_one_col": getattr(fn, "_term_one_col", None),
        "guesses": [{k: float(v) for k, v in g.items()}
                    for g in fit.params_per_dataset("best")]}
    _write(path, arrays, header)


def hierarchical_load(path: str, *, function=None, log_likelihood=None,
                      quiet: bool = False, device=None):
    """Load a :func:`hierarchical_save` file, resumable (JAX checkpoint.py:
    566-650).  The model resolves by name or ``function=`` (a multi-term
    fit takes the list of term functions and rebuilds its branching
    model); the hyper and local priors rebuild from their recipes.  A
    ``HierarchicalNVFit`` file loads as the ``HierarchicalFit`` it
    describes, as in JAX.  ``device=None`` means the GPU."""
    from .hierarchical import HierarchicalFit, _term_branch_model
    from .models import MODEL_REGISTRY
    from .priors import _dist_from_meta

    arrays, header = _read(path)
    if header.get("kind") != "hierarchical":
        raise ValueError("hierarchical_load: not a hierarchical checkpoint; "
                         "use walker_load / batched_load")
    term_names = header.get("term_functions")
    if term_names:
        # a single callable would be broadcast to every term and wrapped
        # in the branch model again: a wrong posterior, so refuse it
        if function is not None and not isinstance(function, (list, tuple)):
            raise ValueError(
                "hierarchical_load: this checkpoint holds a multi-term "
                f"fit of {len(term_names)} terms ({term_names}); pass "
                "function= as the LIST of per-term callables, not a "
                "single function")
        tfns = _resolve(term_names, function, MODEL_REGISTRY, "function", quiet)
        fns = None if tfns is None else [_term_branch_model(list(tfns),
                                                            bool(header["term_one_col"]))]
    else:
        fns = _resolve([header["function"]], function, MODEL_REGISTRY, "function", quiet)
    lls = _resolve([header["likelihood"]], log_likelihood, LIKELIHOOD_REGISTRY,
                   "log_likelihood", quiet)
    if fns is None or lls is None:
        if not quiet:
            print("*Recommendations*")
            print(f"function: {header.get('term_functions') or header['function']}")
            print(f"log_likelihood: {header['likelihood']}")
        return None
    S, ns = header["n_datasets"], header["n_points_per_dataset"]
    x, y, err = arrays["batch_x"], arrays["batch_y"], arrays["batch_err"]
    corr_meta = header.get("corr_prior")
    fit = HierarchicalFit(
        fns[0], [(x[g, :ns[g]], y[g, :ns[g]]) for g in range(S)],
        [{k: g[k] for k in header["local_keys"]} for g in header["guesses"]],
        data_error=[err[g, :ns[g]] for g in range(S)], pooled=header["pooled"],
        hyper={p: (_dist_from_meta(m["mu"]), _dist_from_meta(m["tau"]))
               for p, m in header["hyper"].items()},
        local_priors={k: _dist_from_meta(m) for k, m in header["local_priors"].items()}
        or None,
        log_likelihood=lls[0], n_walkers=header["n_walkers"],
        dtype=_torch_dtype(header["dtype"]), config=_config_from_meta(header["config"]),
        correlation=header.get("correlation", "diag"),
        corr_prior=_dist_from_meta(corr_meta) if corr_meta else None, device=device)
    return _restore_state(fit, arrays, header)


# ------------------------------------------------------------ walker sets


def walker_set_save(walker_set: Sequence, path_prefix: str, take: int | None = None) -> None:
    """Save a set of fits, one file each (``walker-set-save``,
    mcmc-fitting.lisp:1005-1011)."""
    for i, w in enumerate(walker_set):
        walker_save(w, f"{path_prefix}{i:04d}.npz", take)


def walker_set_load(paths: Sequence[str], **kwargs):
    """Load a set of fits (``walker-set-load``, mcmc-fitting.lisp:1013-1027);
    None, after the recommendations, if any member does not resolve."""
    from .walker_set import WalkerSet

    loaded = [walker_load(p, **kwargs) for p in paths]
    if any(w is None for w in loaded):
        return None
    return WalkerSet(loaded)
