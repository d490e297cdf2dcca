"""The port's checkpoints against the JAX package's, float64 on the CPU.

``lisp_mcmc_torch.checkpoint`` writes and reads JAX's ``.npz`` format, so
every save kind crosses between the packages in both directions:

- a plain walker (flat, bounds with the NV constraints' extra hook, a named
  ``PriorSpec``), a custom-posterior grouped walker, a ``BatchedFit``
  (ragged, and a ``BatchedNVFit``), a ``HierarchicalFit`` (single model,
  multi-term, and a ``HierarchicalNVFit``) and a walker set: a JAX file
  loads in the port and a port file in JAX, field for field (every state
  array, the history, the acceptance log and traces, the config, the
  datasets), and the reloaded posterior equals the original's at the
  live ensemble;
- a port file loaded back into the port resumes bit for bit: positions,
  logprobs, the whole state and the history equal an uninterrupted run;
- a file without ``chees`` loads with zeros; the redirect errors and the
  recommendations match JAX's.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_torch.models  # noqa: F401  (tfit.models)
import lisp_mcmc_tpu as jfit
import lisp_mcmc_tpu.models  # noqa: F401  (jfit.models)
from lisp_mcmc_torch import checkpoint as tck
from lisp_mcmc_torch import nv as tnv
from lisp_mcmc_torch import synthetic
from lisp_mcmc_tpu import checkpoint as jck
from lisp_mcmc_tpu import nv as jnv

STATE = ("position", "logprob", "best_position", "best_logprob", "l_matrix", "m_sum",
         "m_outer", "m_count", "chees")
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def line_data(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 10.0, n)
    return x, 2.0 * x + 1.0 + rng.normal(0, 0.3, n)


def nv_spectra(rows, cols):
    x, ys, _ = synthetic.nv_scan_grid(rows, cols)
    return [(x, y) for y in ys]


def same_fit(a, b):
    """Two fits (either package) hold the same saved fields."""
    assert tuple(a.spec.keys) == tuple(b.spec.keys)
    assert int(a.n_walkers) == int(b.n_walkers)
    for k in STATE:
        np.testing.assert_array_equal(host(getattr(a.state, k)), host(getattr(b.state, k)),
                                      err_msg=k)
    assert int(a.state.age) == int(b.state.age)
    assert int(a.state.anneal_step) == int(b.state.anneal_step)
    pa, la = a._history()
    pb, lb = b._history()
    np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    np.testing.assert_array_equal([float(v) for v in a._accept_log],
                                  [float(v) for v in b._accept_log])
    for t in ("_lpmax_trace", "_lpmean_trace"):
        ta, tb = getattr(a, t), getattr(b, t)
        cat = [np.concatenate([host(v) for v in tr]) if tr else np.empty(0) for tr in (ta, tb)]
        np.testing.assert_array_equal(*cat)
    ca, cb = a.config, b.config
    impl = {"xla": "plain", "pallas": "kernel", "pallas_chunk": "chunk_kernel"}
    for f in ca.__dataclass_fields__:
        va, vb = getattr(ca, f), getattr(cb, f)
        if f == "posterior_impl":
            va, vb = impl.get(va, va), impl.get(vb, vb)
        assert va == vb, f
    # the real points (JAX pads a batch's datasets to its lane width)
    for ta, tb in zip(a.terms, b.terms):
        ra, rb = (host(t.dataset.mask) > 0 for t in (ta, tb))
        for f in ("x", "y", "sigma"):
            np.testing.assert_array_equal(host(getattr(ta.dataset, f))[ra],
                                          host(getattr(tb.dataset, f))[rb])


def same_posterior(j, t, rtol=1e-12):
    """The JAX and the port fit's posteriors at the port's live ensemble."""
    pos = host(t.state.position)
    got = host(t._log_post(torch.as_tensor(pos)))
    want = np.asarray(jax.vmap(lambda th: j._log_post_one(th, j._posterior_data()))(
        jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, rtol=rtol)


def pair_walkers(n_walkers=16, steps=400, **extra):
    x, y = line_data()
    kw = dict(data=(x, y), params={"m": 1.5, "b": 0.5}, data_error=0.3,
              n_walkers=n_walkers, seed=0, walker_jitter=0.05)
    j = jfit.walker_create(function=jfit.models.line, **kw,
                           **{k: v[0] for k, v in extra.items()})
    t = tfit.walker_create(function=tfit.models.line, **kw, **F64,
                           **{k: v[1] for k, v in extra.items()})
    j.adaptive_steps(steps, auto=None)
    t.adaptive_steps(steps, auto=None)
    return j, t


PRIORS = {
    "flat": {},
    "bounds": {"log_prior": (jfit.make_bounds_prior({"m": (0.0, 5.0), "b": (-3.0, 3.0)}),
                             tfit.make_bounds_prior({"m": (0.0, 5.0), "b": (-3.0, 3.0)}))},
    "spec": {"log_prior": (jfit.PriorSpec({"m": jfit.Gaussian(2.0, 1.0),
                                           "b": jfit.LogNormal(0.0, 1.0)}),
                           tfit.PriorSpec({"m": tfit.Gaussian(2.0, 1.0),
                                           "b": tfit.LogNormal(0.0, 1.0)}))},
}


@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_walker_files_cross_both_ways(tmp_path, prior):
    j, t = pair_walkers(**PRIORS[prior])
    jck.walker_save(j, str(tmp_path / "j.npz"))
    tck.walker_save(t, str(tmp_path / "t.npz"))
    t_from_j = tck.walker_load(str(tmp_path / "j.npz"), device="cpu")
    same_fit(t_from_j, j)
    same_posterior(j, t_from_j)
    j_from_t = jck.walker_load(str(tmp_path / "t.npz"))
    same_fit(j_from_t, t)
    same_posterior(j_from_t, t)
    # the port's key words are a threefry2x32 key JAX continues from
    assert str(jax.random.key_impl(j_from_t.state.key)) == "threefry2x32"
    j_from_t.adaptive_steps(200, auto=None)
    assert np.all(np.isfinite(np.asarray(j_from_t.state.logprob)))


def test_nv_walker_prior_recipe_crosses(tmp_path):
    """A bounds prior with the NV constraints' extra hook resolves by name in
    both packages."""
    x, y = nv_spectra(1, 1)[0]
    j = jnv.nv_walker((x, y), n_walkers=16, seed=0)
    t = tnv.nv_walker((x, y), n_walkers=16, seed=0, **F64)
    jck.walker_save(j, str(tmp_path / "j.npz"))
    tck.walker_save(t, str(tmp_path / "t.npz"))
    t_from_j = tck.walker_load(str(tmp_path / "j.npz"), device="cpu")
    same_fit(t_from_j, j)
    assert t_from_j.terms[0].prior._extra is tnv._nv_constraints
    same_posterior(j, t_from_j)
    j_from_t = jck.walker_load(str(tmp_path / "t.npz"))
    same_fit(j_from_t, t)
    same_posterior(j_from_t, t)


def resume_pair(make, save, load, tmp_path, run):
    """``make()`` twice from one seed: one runs on, the other is saved,
    reloaded and run the same way; every state array and the history must
    be equal."""
    a = make()
    path = str(tmp_path / "mid.npz")
    save(a, path)
    run(a)
    b = load(path)
    run(b)
    same_fit(a, b)
    return a, b


def test_port_resume_is_bit_identical(tmp_path):
    def make():
        w = tfit.walker_create(function=tfit.models.line, data=line_data(),
                               params={"m": 1.5, "b": 0.5}, data_error=0.3, n_walkers=16,
                               seed=3, walker_jitter=0.05, **F64)
        w.adaptive_steps(200, auto=None)
        w.sampling_steps(20, kernel="chees")
        return w

    def run(w):
        w.adaptive_steps(200, auto=None)
        w.sampling_steps(20, kernel="chees")

    a, b = resume_pair(make, tck.walker_save,
                       lambda p: tck.walker_load(p, device="cpu"), tmp_path, run)
    assert torch.any(a.state.chees != 0)          # the chees state travelled


def test_file_without_chees_loads_zeros(tmp_path):
    j, _ = pair_walkers()
    path = str(tmp_path / "j.npz")
    jck.walker_save(j, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "chees"}
    np.savez_compressed(path, **arrays)
    t = tck.walker_load(path, device="cpu")
    assert torch.equal(t.state.chees, torch.zeros((1, 4), dtype=torch.float64))


def offset_post(theta, block, data):
    """One walker's Gaussian posterior about its block's centre."""
    return -0.5 * torch.sum((theta - data["centre"][block]) ** 2)


def offset_post_jax(theta, block, data):
    return -0.5 * jnp.sum((theta - data["centre"][block]) ** 2)


def test_custom_grouped_walker_crosses(tmp_path):
    centre = np.array([[0.0, 1.0], [2.0, -1.0]])
    gids = np.repeat(np.arange(2), 8)
    spec_kw = dict(n_walkers=16, seed=0, walker_jitter=0.1, n_groups=2)
    j = jfit.Walker([], jfit.params.ParamSpec(("a", "b")), np.ones(2), **spec_kw,
                    aux=jnp.asarray(gids), group_ids=gids, log_posterior=offset_post_jax,
                    posterior_data={"centre": jnp.asarray(centre)})
    t = tfit.Walker([], tfit.ParamSpec(("a", "b")), np.ones(2), **spec_kw, **F64,
                    aux=torch.as_tensor(gids), group_ids=gids, log_posterior=offset_post,
                    posterior_data={"centre": torch.as_tensor(centre)})
    j.adaptive_steps(400, auto=None)
    t.adaptive_steps(400, auto=None)
    jck.walker_save(j, str(tmp_path / "j.npz"))
    tck.walker_save(t, str(tmp_path / "t.npz"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tck.walker_load(str(tmp_path / "j.npz"), device="cpu") is None
    assert "*Recommendations*" in out.getvalue() and "offset_post_jax" in out.getvalue()
    t_from_j = tck.walker_load(str(tmp_path / "j.npz"), log_posterior=offset_post,
                               device="cpu")
    same_fit(t_from_j, j)
    np.testing.assert_array_equal(t_from_j.group_ids, gids)
    assert t_from_j.n_groups == 2
    np.testing.assert_array_equal(host(t_from_j._custom_data["centre"]), centre)
    j_from_t = jck.walker_load(str(tmp_path / "t.npz"), log_posterior=offset_post_jax)
    same_fit(j_from_t, t)
    # and the grouped port walker resumes bit for bit
    resume_pair(lambda: tck.walker_load(str(tmp_path / "t.npz"), log_posterior=offset_post,
                                        device="cpu"),
                tck.walker_save,
                lambda p: tck.walker_load(p, log_posterior=offset_post, device="cpu"),
                tmp_path, lambda w: w.adaptive_steps(200, auto=None))


def batch_pair(ragged, steps=400):
    rng = np.random.default_rng(1)
    lens = (20, 28, 24) if ragged else (24, 24, 24)
    data = []
    for s, n in enumerate(lens):
        x = np.linspace(0.0, 10.0, n)
        data.append((x, (1.5 + 0.2 * s) * x + 1.0 + rng.normal(0, 0.3, n)))
    kw = dict(data_error=0.3, walkers_per_dataset=8, seed=0)
    j = jfit.BatchedFit(jfit.models.line, data, {"m": 1.5, "b": 0.5}, **kw)
    t = tfit.BatchedFit(tfit.models.line, data, {"m": 1.5, "b": 0.5}, **kw, **F64)
    for f in (j, t):
        f.adaptive_steps(steps, auto=None)
    return j, t


def batched_same(j, t):
    same_fit(t, j)
    for dj, dt in zip(j._datasets, t._datasets):
        np.testing.assert_array_equal(np.asarray(dj.y)[np.asarray(dj.mask) > 0],
                                      host(dt.y)[host(dt.mask) > 0])
    pos = host(t.state.position)
    np.testing.assert_allclose(
        host(t._log_post(torch.as_tensor(pos))),
        np.asarray(j._custom_batched(jnp.asarray(pos), j._posterior_data())), rtol=1e-12)


@pytest.mark.parametrize("ragged", [False, True], ids=["even", "ragged"])
def test_batched_files_cross_both_ways(tmp_path, ragged):
    j, t = batch_pair(ragged)
    jck.batched_save(j, str(tmp_path / "j.npz"))
    tck.batched_save(t, str(tmp_path / "t.npz"))
    t_from_j = tck.batched_load(str(tmp_path / "j.npz"), device="cpu")
    batched_same(j, t_from_j)
    j_from_t = jck.batched_load(str(tmp_path / "t.npz"))
    batched_same(j_from_t, t)
    resume_pair(lambda: tck.batched_load(str(tmp_path / "t.npz"), device="cpu"),
                tck.batched_save, lambda p: tck.batched_load(p, device="cpu"),
                tmp_path, lambda w: w.adaptive_steps(200, auto=None))


def test_batched_nv_file_keeps_its_class(tmp_path):
    j = jnv.BatchedNVFit(nv_spectra(1, 2), walkers_per_spectrum=8, seed=0)
    jck.batched_save(j, str(tmp_path / "j.npz"))
    t = tck.batched_load(str(tmp_path / "j.npz"), device="cpu")
    assert type(t) is tnv.BatchedNVFit and t.n_spectra == 2
    batched_same(j, t)
    tck.batched_save(t, str(tmp_path / "t.npz"))
    assert type(jck.batched_load(str(tmp_path / "t.npz"))) is jnv.BatchedNVFit


def hier_pair(multi=False, nv=False, steps=200):
    if nv:
        spectra = nv_spectra(1, 3)
        j = jnv.HierarchicalNVFit(spectra, n_walkers=16, seed=0)
        t = tnv.HierarchicalNVFit(spectra, n_walkers=16, seed=0, **F64)
    else:
        rng = np.random.default_rng(2)
        x = np.linspace(0.0, 1.0, 10)
        data = [(x, (1.0 + 0.2 * s) * x + 0.3 * s + 0.1 * rng.standard_normal(10))
                for s in range(3)]
        fn = (jfit.models.line, tfit.models.line)
        if multi:
            data = [[(x, y), (x, 0.5 * y)] for x, y in data]
            fn = ([jfit.models.line] * 2, [tfit.models.line] * 2)

        def hyper(M):
            return {"m": (M.Gaussian(1.0, 2.0), M.LogNormal(np.log(0.3), 0.5)),
                    "b": (M.Gaussian(0.0, 2.0), M.LogNormal(np.log(0.3), 0.7))}

        kw = dict(data_error=0.1, n_walkers=16, seed=0, correlation="full")
        j = jfit.HierarchicalFit(fn[0], data, {"m": 1.0, "b": 0.2}, hyper=hyper(jfit), **kw)
        t = tfit.HierarchicalFit(fn[1], data, {"m": 1.0, "b": 0.2}, hyper=hyper(tfit), **kw,
                                 **F64)
    for f in (j, t):
        f.adaptive_steps(steps, auto=None)
    return j, t


@pytest.mark.parametrize("kind", ["single", "multi_term", "nv"])
def test_hierarchical_files_cross_both_ways(tmp_path, kind):
    j, t = hier_pair(multi=kind == "multi_term", nv=kind == "nv")
    jck.hierarchical_save(j, str(tmp_path / "j.npz"))
    tck.hierarchical_save(t, str(tmp_path / "t.npz"))
    t_from_j = tck.hierarchical_load(str(tmp_path / "j.npz"), device="cpu")
    same_fit(t_from_j, j)
    assert t_from_j.pooled == j.pooled and t_from_j.correlation == j.correlation
    same_posterior(j, t_from_j, rtol=1e-10)
    j_from_t = jck.hierarchical_load(str(tmp_path / "t.npz"))
    same_fit(j_from_t, t)
    same_posterior(j_from_t, t, rtol=1e-10)
    if kind == "multi_term":
        with pytest.raises(ValueError, match="LIST of per-term callables") as e:
            tck.hierarchical_load(str(tmp_path / "j.npz"), function=tfit.models.line,
                                  device="cpu")
        with pytest.raises(ValueError) as f:
            jck.hierarchical_load(str(tmp_path / "t.npz"), function=jfit.models.line)
        assert str(e.value) == str(f.value)
    resume_pair(lambda: tck.hierarchical_load(str(tmp_path / "t.npz"), device="cpu"),
                tck.hierarchical_save, lambda p: tck.hierarchical_load(p, device="cpu"),
                tmp_path, lambda w: w.adaptive_steps(200, auto=None))


def test_walker_sets_cross(tmp_path):
    j, t = pair_walkers()
    j2, t2 = pair_walkers(steps=200)
    jck.walker_set_save([j, j2], str(tmp_path / "j"))
    tck.walker_set_save(tfit.WalkerSet([t, t2]), str(tmp_path / "t"))
    ts = tck.walker_set_load([str(tmp_path / f"j{i:04d}.npz") for i in range(2)],
                             device="cpu")
    assert isinstance(ts, tfit.WalkerSet) and len(ts) == 2
    for a, b in zip(ts, (j, j2)):
        same_fit(a, b)
    js = jck.walker_set_load([str(tmp_path / f"t{i:04d}.npz") for i in range(2)])
    for a, b in zip(js, (t, t2)):
        same_fit(a, b)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tck.walker_set_load([str(tmp_path / "j0000.npz")], function=None,
                                   log_prior=None, device="cpu") is not None


def test_redirect_errors_and_recommendations_match_jax(tmp_path):
    jb, tb = batch_pair(False, steps=0)
    jh, th = hier_pair(steps=0)
    for jfit_, tfit_ in ((jb, tb), (jh, th)):
        with pytest.raises(ValueError) as je:
            jck.walker_save(jfit_, str(tmp_path / "x.npz"))
        with pytest.raises(ValueError) as te:
            tck.walker_save(tfit_, str(tmp_path / "x.npz"))
        assert str(je.value) == str(te.value)
    plain = pair_walkers(n_walkers=4, steps=0)
    for verb in ("batched_save", "hierarchical_save"):
        with pytest.raises(ValueError) as je:
            getattr(jck, verb)(plain[0], str(tmp_path / "x.npz"))
        with pytest.raises(ValueError) as te:
            getattr(tck, verb)(plain[1], str(tmp_path / "x.npz"))
        assert str(je.value) == str(te.value)

    def unnamed(x, p):
        return p["m"] * x + p["b"]

    x, y = line_data()
    kw = dict(data=(x, y), params={"m": 1.5, "b": 0.5}, data_error=0.3, n_walkers=4)
    jck.walker_save(jfit.walker_create(function=unnamed, **kw), str(tmp_path / "u.npz"))
    outs = []
    for load in (jck.walker_load, lambda p: tck.walker_load(p, device="cpu")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert load(str(tmp_path / "u.npz")) is None
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and "*Recommendations*" in outs[0]
