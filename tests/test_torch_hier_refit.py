"""Refit cross-validation of the port's hierarchical fit against the JAX
package's (JAX tests/test_hier_refit.py), float64 on the CPU, S = 3 lines
of 16 points:

- the grouped joint walker: block j's one-walker posterior and the batched
  posterior against JAX's at the same walk vectors (1e-10), Gaussian and
  Student-t; a masked holdout against a fit on the sliced data (1e-9);
- the holdout axis: ``_n_real_points`` and each holdout's masks on a
  ragged grid, and a plain walker's interior masked point, as in JAX;
- ``_refit_cv``'s starts equal JAX's bit for bit (the same resample of the
  same live ensemble);
- ``score_block``, ``kfold``'s elpd and ``logo``'s per-group elpd against
  JAX's at 1e-8 with JAX's refit history installed in the port's refit
  (``diagnostics._run_refit``), the z redraws from the same numpy seed;
- ``reloo``/``kfold`` reach the fit's own ``_refit_cv`` (a short kfold on
  the port's own draws), a view still refuses, ``logo`` refuses an
  incomplete prior as JAX does;
- ``grouped_refit_health``, its tail ESS one call over the coordinates,
  equals JAX's verdicts and the per-coordinate loop (1e-12) on an injected
  history with a frozen block.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_torch.models  # noqa: F401  (tfit.models)
import lisp_mcmc_tpu as jfit
import lisp_mcmc_tpu.models  # noqa: F401  (jfit.models)
from lisp_mcmc_torch import diagnostics as td
from lisp_mcmc_torch import hierarchical as th
from lisp_mcmc_torch.convert import hierarchical_from_numpy
from lisp_mcmc_torch.ops.reductions import tail_ess
from lisp_mcmc_tpu import diagnostics as jd
from lisp_mcmc_tpu import hierarchical as jh

REFIT = dict(n_steps=200, temperature=2.0, walkers_per_dataset=8, burn_fraction=0.3,
             max_samples=16, seed=0)
STATE = ("position", "logprob", "best_position", "best_logprob", "l_matrix", "m_sum",
         "m_outer", "m_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def hier_data(S=3, n=16, lens=None, seed=0):
    rng = np.random.default_rng(seed)
    ms = rng.normal(2.0, 0.3, S)
    out = []
    for s, m in enumerate(ms):
        x = np.linspace(0.0, 10.0, n if lens is None else lens[s])
        out.append((x, m * x + 1.0 + rng.normal(0, 0.3, x.size)))
    return out


def hyper(M):
    return {"m": (M.Gaussian(2.0, 1.0), M.LogNormal(np.log(0.3), 0.5)),
            "b": (M.Gaussian(1.0, 1.0), M.LogNormal(np.log(0.3), 0.5))}


def student(M):
    return M.make_student_t_likelihood(4.0)


def make(M, data, ll=None, n_walkers=32, **kw):
    cls = jh.HierarchicalFit if M is jfit else th.HierarchicalFit
    extra = {} if M is jfit else dict(dtype=torch.float64, device="cpu")
    return cls(M.models.line, data, {"m": 1.5, "b": 0.5}, data_error=0.3, hyper=hyper(M),
               log_likelihood=None if ll is None else ll(M), n_walkers=n_walkers, seed=0,
               **kw, **extra)


def carry(j, t):
    """The JAX fit's state and history into the port's."""
    a = {k: np.asarray(getattr(j.state, k)) for k in STATE}
    pos, lp = j._history()
    a.update(keys=j.spec.keys, history_positions=np.asarray(pos),
             history_logprobs=np.asarray(lp), age=int(j.state.age))
    return hierarchical_from_numpy(t, a)


@pytest.fixture(scope="module", params=["normal", "student_t"])
def pair(request):
    ll = None if request.param == "normal" else student
    data = hier_data()
    j = make(jfit, data, ll)
    j.adaptive_steps(400, auto=None)
    return j, carry(j, make(tfit, data, ll)), data, ll


class _Stop(Exception):
    pass


def grouped(fit_cls, monkeypatch, store):
    """Wrap ``_grouped_joint_walker`` to keep its starts and walker and stop
    ``_refit_cv`` before it samples."""
    orig = fit_cls._grouped_joint_walker

    def wrapped(self, refit_data, K, B, seed, pos0, config=None):
        store["pos0"] = np.array(pos0)
        store["fit"] = orig(self, refit_data, K, B, seed, pos0, config)
        raise _Stop

    monkeypatch.setattr(fit_cls, "_grouped_joint_walker", wrapped)


def refit_walkers(j, t, holdouts, monkeypatch):
    js, ts = {}, {}
    grouped(jh.HierarchicalFit, monkeypatch, js)
    grouped(th.HierarchicalFit, monkeypatch, ts)
    for f in (j, t):
        with pytest.raises(_Stop):
            f._refit_cv("test", holdouts, **REFIT)
    monkeypatch.undo()
    return js, ts


def test_grouped_joint_posterior_and_starts_match_jax(pair, monkeypatch):
    j, t, _, _ = pair
    assert t._n_real_points == j._n_real_points == 48
    holdouts = [np.arange(48) != i for i in (5, 20, 41)]
    js, ts = refit_walkers(j, t, holdouts, monkeypatch)
    np.testing.assert_array_equal(ts["pos0"], js["pos0"])
    jf, tf = js["fit"], ts["fit"]
    assert tf.n_groups == 3 and dataclasses.asdict(tf.config) == dataclasses.asdict(jf.config)
    np.testing.assert_array_equal(tf.state.l_matrix[0].numpy(),
                                  np.asarray(j.state.l_matrix)[0])
    pos = np.asarray(jf.state.position)
    got = tf._custom_batched(torch.as_tensor(pos), tf._posterior_data()).numpy()
    want = np.asarray(jf._custom_batched(jnp.asarray(pos), jf._posterior_data()))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    theta = np.asarray(j._best_vector())
    for b in range(3):
        got = float(tf._custom_log_post(torch.as_tensor(theta), torch.tensor(b),
                                        tf._posterior_data()))
        want = float(jf._custom_log_post(jnp.asarray(theta), b, jf._posterior_data()))
        assert got == pytest.approx(want, rel=1e-10)


def test_masked_holdout_matches_sliced_data(pair, monkeypatch):
    """Block j's joint posterior, one point of dataset 0 masked out, equals
    a hierarchical fit built on the sliced data (JAX test_hier_refit.py:
    60-80)."""
    _, t, data, ll = pair
    _, ts = refit_walkers(t, t, [np.arange(48) != 5], monkeypatch)
    keep = np.arange(16) != 5
    ref = make(tfit, [(data[0][0][keep], data[0][1][keep])] + data[1:], ll, n_walkers=2)
    theta = torch.as_tensor(np.asarray(t._best_vector()))
    got = float(ts["fit"]._custom_log_post(theta, torch.tensor(0),
                                           ts["fit"]._posterior_data()))
    assert got == pytest.approx(float(ref._log_post(theta[None])[0]), abs=1e-9)


def test_holdout_axis_is_the_real_point_axis(monkeypatch):
    data = hier_data(lens=(12, 16, 9))
    j, t = make(jfit, data), make(tfit, data)
    assert t._n_real_points == j._n_real_points == 37
    holdouts = [np.arange(37) != i for i in (11, 12, 30)]
    # JAX cannot stack the ragged grid's blocks (its Dataset's n is static
    # pytree data; ROADMAP Queue 3): the port refits it
    with pytest.raises(ValueError, match="Mismatch custom dataclass node data"):
        j._refit_cv("test", holdouts, **REFIT)
    store = {}
    grouped(th.HierarchicalFit, monkeypatch, store)
    with pytest.raises(_Stop):
        t._refit_cv("test", holdouts, **REFIT)
    # each block's kept points (the (K, S, 16) inv_sigma): the real points
    # but the held-out one, which is dataset 0's point 11, dataset 1's
    # point 0 and dataset 2's point 2
    got = store["fit"]._posterior_data()["inv_sigma"].numpy() > 0
    real = np.stack([d.mask.numpy() > 0 for d in t._datasets])
    for k, (s, p) in enumerate([(0, 11), (1, 0), (2, 2)]):
        want = real.copy()
        want[s, p] = False
        np.testing.assert_array_equal(got[k], want)
    monkeypatch.undo()
    # a plain walker with an interior masked point (JAX test_hier_refit.py:
    # 124-170): real point 3 is padded position 4
    x, y = data[1]
    walkers = []
    for M, kw in ((jfit, {}), (tfit, dict(dtype=torch.float64, device="cpu"))):
        w = M.walker_create(function=M.models.line, data=(x, y), params={"m": 1.5, "b": 0.5},
                            data_error=0.3, n_walkers=8, seed=0, **kw)
        ds = w.terms[0].dataset
        mask = np.array(ds.mask, np.float64)
        mask[3] = 0.0
        w.terms[0].dataset = type(ds)(x=ds.x, y=ds.y, sigma=ds.sigma, n=ds.n,
                                      mask=(jnp.asarray(mask) if M is jfit
                                            else torch.as_tensor(mask)))
        w._runner_cache.clear()
        walkers.append(w)
    assert td._refit_n_points(walkers[1]) == jd._refit_n_points(walkers[0]) == 15
    monkeypatch.setattr(td, "_run_refit", lambda *a: None)
    tfr, _ = td._batched_refit(walkers[1], "test", [np.arange(15) != 3], **REFIT)
    blk = tfr._posterior_data()["blocks"][0]["mask"][0].numpy()
    assert blk[3] == 0.0 and blk[4] == 0.0 and blk.sum() == 14


def install(monkeypatch, jfit_refit):
    """``diagnostics._run_refit`` installing the JAX refit's history."""
    pos, lp = jfit_refit._history()

    def run(fit, n_steps, temperature, burn_fraction):
        fit._hist_positions, fit._hist_logprobs = [np.array(pos)], [np.array(lp)]

    monkeypatch.setattr(td, "_run_refit", run)


def jax_refit(monkeypatch, store):
    """Keep the JAX ``_refit_cv``'s refit walker and scorer as it runs."""
    orig = jh.HierarchicalFit._refit_cv

    def kept(self, *a, **k):
        store["fit"], store["score"] = orig(self, *a, **k)
        return store["fit"], store["score"]

    monkeypatch.setattr(jh.HierarchicalFit, "_refit_cv", kept)


def test_kfold_and_score_block_match_jax(pair, monkeypatch):
    j, t, _, _ = pair
    store = {}
    jax_refit(monkeypatch, store)
    jk = jd.kfold(j, k=3, **REFIT)
    install(monkeypatch, store["fit"])

    def never(*a, **k):
        raise AssertionError("a hierarchical fit reached _global_batched_refit")

    monkeypatch.setattr(td, "_global_batched_refit", never)
    tk = td.kfold(t, k=3, **REFIT)
    np.testing.assert_array_equal(tk.folds, jk.folds)
    np.testing.assert_array_equal(tk.fold_ok, jk.fold_ok)
    np.testing.assert_allclose(tk.pointwise, jk.pointwise, rtol=1e-8)
    assert tk.elpd == pytest.approx(jk.elpd, rel=1e-8)
    assert tk.n_points == 48 and tk.n_samples == jk.n_samples
    _, tscore = t._refit_cv("kfold", [tk.folds != f for f in range(3)], **REFIT)
    for b in range(3):
        np.testing.assert_allclose(tscore(b), np.asarray(store["score"](b)), rtol=1e-8)


def test_logo_matches_jax(pair, monkeypatch):
    j, t, _, _ = pair
    store = {}
    jax_refit(monkeypatch, store)
    jl = j.logo(n_z=4, **REFIT)
    install(monkeypatch, store["fit"])
    tl = t.logo(n_z=4, **REFIT)
    np.testing.assert_allclose(tl.elpd_per_dataset, jl.elpd_per_dataset, rtol=1e-8)
    assert tl.elpd == pytest.approx(jl.elpd, rel=1e-8)
    assert tl.se == pytest.approx(jl.se, rel=1e-6)
    np.testing.assert_array_equal(tl.refit_ok, jl.refit_ok)
    assert isinstance(tl, tfit.LOGOResult) and repr(tl).startswith("LOGOResult(elpd=")


def test_short_kfold_runs_on_the_joint_refit():
    t = make(tfit, hier_data(), n_walkers=32)
    t.adaptive_steps(400, auto=None)
    r = td.kfold(t, k=2, n_steps=200, walkers_per_dataset=8, max_samples=32)
    assert r.n_points == 48 and np.all(np.isfinite(r.pointwise))
    assert r.fold_ok.shape == (2,)


def test_refusals_match_jax():
    data = hier_data()
    j, t = make(jfit, data, n_walkers=8), make(tfit, data, n_walkers=8)
    # a view would refit another model (no population prior)
    with pytest.raises(ValueError, match="population prior"):
        td.kfold(t.dataset_view(0), k=4, n_steps=100)
    with pytest.raises(ValueError, match="cannot be refit"):
        td._global_batched_refit(t.dataset_view(0), "kfold", [], 1, 1.0, 1, 0.5, 1, 0)
    # logo needs every non-pooled local's prior
    x = np.linspace(0, 1, 5)
    rng = np.random.default_rng(0)
    ds = [(x, 0.5 * x + rng.standard_normal(5)) for _ in range(3)]
    msgs = []
    for M, cls, kw in ((jfit, jh.HierarchicalFit, {}),
                       (tfit, th.HierarchicalFit, dict(dtype=torch.float64, device="cpu"))):
        f = cls(M.models.line, ds, {"m": 0.5, "b": 0.0}, data_error=1.0, pooled=["m"],
                n_walkers=8, **kw)
        with pytest.raises(ValueError) as e:
            f.logo(n_steps=10)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "local_priors" in msgs[0]


def test_grouped_refit_health_matches_jax_on_a_frozen_block(pair, monkeypatch):
    j, t, _, _ = pair
    js, ts = refit_walkers(j, t, [np.arange(48) != i for i in (0, 1, 2)], monkeypatch)
    rng = np.random.default_rng(4)
    T, W, d = 60, 24, t.spec.ndim
    hist = np.cumsum(rng.standard_normal((T, W, d)), axis=0) * 0.05
    hist[:, 8:16] = hist[:1, 8:16]                          # block 1 frozen
    lp = rng.standard_normal((T, W))
    js["fit"]._hist_positions, js["fit"]._hist_logprobs = [hist], [lp]
    ts["fit"]._hist_positions, ts["fit"]._hist_logprobs = [hist.copy()], [lp.copy()]
    with pytest.warns(UserWarning, match="collapse gate"):
        ok_t = td.grouped_refit_health(ts["fit"], "t")
    ok_j = jd.grouped_refit_health(js["fit"], "t", warn=False)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert not ok_t[1]
    for b in range(3):
        block = torch.as_tensor(hist[:, 8 * b:8 * (b + 1)])
        loop = torch.stack([tail_ess(block[:, :, i]) for i in range(d)])
        np.testing.assert_allclose(tail_ess(block).numpy(), loop.numpy(), rtol=1e-12)
