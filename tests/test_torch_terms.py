"""Posteriors of several terms in the port's kernels, against the JAX package.

- The fused plain version (what the CUDA kernel computes, and is held
  against on the card) against ``build_fused_posterior(..., interpret=True)``
  of the JAX package, float64, rtol 1e-9 (its own tests' tolerance), on
  three fits: the ``[gaussian_peak, line]`` fit with a per-term bounds prior
  of tests/test_pallas.py:59-77, test.lisp's 9-parameter global pair (the
  second model a JAX closure there, ``models.renamed`` here) and an NV fit
  under ``make_nv_prior(y)``, whose declared constraints the port
  evaluates in the kernel after the bounds table.
- The chunk plain version against ``build_chunk_pallas(..., interpret=True)``
  at d = 9 with two terms and a dense L, float32: at least 99 % of walkers
  agree in accept count and position (rtol 1e-4), tests/test_torch_chunk.py's
  rule, and the moments within 5e-3 of sqrt(m_ii m_jj).
- The two-term ``run_with_history`` with injected draws against the JAX
  runner for two chunks, float64, rtol 1e-9.
- A JAX global fit's state carried across with ``convert.walker_from_numpy``.
- Which fits both kernels take (``kernel_coverage``, ``chunk_coverage``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import models, nv, synthetic
from lisp_mcmc_torch.convert import walker_from_numpy
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_tpu import kernel as jkernel
from lisp_mcmc_tpu import nv as jnv
from lisp_mcmc_tpu.models import zoo as jzoo
from lisp_mcmc_tpu.ops.chunk_pallas import build_chunk_pallas
from lisp_mcmc_tpu.ops.loglik_pallas import build_fused_posterior
from lisp_mcmc_torch import kernel as tkernel

W = 128
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")
DATASET_FIELDS = ("x", "y", "sigma", "mask", "inv_sigma", "log_norm_const",
                  "log_norm_const_point", "log_fact_y")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def j_lorder2(x, p):
    """test.lisp:54-55's wrapper, as examples/reference_journey.py writes it."""
    return jzoo.lorder_mixed_bg(x, {
        "scale": p["scale2"], "linewidth": p["linewidth"], "x0": p["x0"],
        "mix": p["mix"], "bg0": p["bg02"], "bg1": p["bg12"]})


T_LORDER2 = models.renamed(models.lorder_mixed_bg,
                           {"scale": "scale2", "bg0": "bg02", "bg1": "bg12"})


def _case(name):
    """(JAX walker_create kwargs, port kwargs, spread of the positions)."""
    if name == "gaussian_line":
        rng = np.random.default_rng(2)
        x = np.linspace(-5.0, 5.0, 40)
        data = [(x, np.exp(-0.5 * x ** 2) + 0.01 * rng.standard_normal(40)),
                (x, 3.0 * x - 0.5 + 0.05 * rng.standard_normal(40))]
        bounds = {"scale": (0.1, 10.0), "sigma": (0.1, 5.0)}
        common = dict(data=data, params={"scale": 1.0, "x0": 0.0, "sigma": 1.0,
                                         "m": 3.0, "b": -0.5},
                      data_error=[0.01, 0.05], walker_jitter=0.3)
        return (dict(function=[jzoo.gaussian_peak, jzoo.line],
                     log_prior=[jfit.make_bounds_prior(bounds), None], **common),
                dict(function=[models.gaussian_peak, models.line],
                     log_prior=[tfit.make_bounds_prior(bounds), None], **common), 0.5)
    if name == "global":
        g = synthetic.global_fit(2)
        common = dict(data=g["data"], params=g["truth"], data_error=1e-7,
                      walker_jitter=0.01)
        return (dict(function=[jzoo.lorder_mixed_bg, j_lorder2], **common),
                dict(function=[models.lorder_mixed_bg, T_LORDER2], **common), 0.01)
    x, ys = synthetic.nv_spectra()
    y = ys[0]
    common = dict(data=(x, y), params=nv.guess_nv_params(y),
                  data_error=nv.nv_data_std_dev(y), walker_jitter=0.002)
    return (dict(function=jzoo.double_lorentzian_bg, log_prior=jnv.make_nv_prior(y), **common),
            dict(function=models.double_lorentzian_bg, log_prior=nv.make_nv_prior(y),
                 **common), 0.005)


def _arrays(jw, keys=True):
    out = {k: np.asarray(getattr(jw.state, k)) for k in STATE_KEYS}
    if keys:
        out["keys"] = jw.spec.keys
    return out


def _datasets(jw):
    fields = []
    for t in jw.terms:
        f = {k: np.asarray(getattr(t.dataset, k)) for k in DATASET_FIELDS}
        fields.append({**f, "n": t.dataset.n})
    return fields


def _pair(name, dtype, n_walkers=W, seed=2):
    jkw, tkw, spread = _case(name)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jw = jfit.walker_create(n_walkers=n_walkers, seed=seed, dtype=jdtype, **jkw)
    tkw = {k: v for k, v in tkw.items() if k != "walker_jitter"}
    tw = walker_from_numpy(_arrays(jw), datasets=_datasets(jw), dtype=dtype,
                           device="cpu", **tkw)
    return jw, tw, spread


@pytest.mark.parametrize("name", ["gaussian_line", "global", "nv"])
def test_plain_fused_matches_jax_interpret(name):
    jw, tw, spread = _pair(name, torch.float64)
    j_fused = build_fused_posterior(jw.terms, jw.spec, jnp.float64, W,
                                    block_walkers=128, interpret=True)
    post = tlk.prepare_fused_terms(tw.terms, tw.spec, torch.float64)
    assert j_fused is not None and post is not None
    assert len(post.terms) == len(jw.terms)
    base = np.asarray(jw.state.position)
    pos = base * (1.0 + spread * np.random.default_rng(10).standard_normal(base.shape))
    want = np.asarray(j_fused(jnp.asarray(pos)))
    got = tlk.fused_posterior(torch.as_tensor(pos), post).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               err_msg=f"{name}: plain fused vs JAX interpret, rtol 1e-9")
    j_plain = np.asarray(jax.vmap(jw._log_post_one, in_axes=(0, None))(
        jnp.asarray(pos), jw._posterior_data()))
    np.testing.assert_allclose(got, j_plain, rtol=1e-9)
    if name != "global":
        assert (got < -1e3).any(), "some walkers must break the bounds or constraints"
    if name == "nv":
        assert post.rest == () and len(post.constraints) == 3 and (got < -1e8).any()


@pytest.fixture
def f32():
    """The chunk kernel is f32-only; flip JAX's x64 off for one test."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_plain_chunk_matches_jax_chunk_two_terms_d9(f32):
    jkw, tkw, _ = _case("global")
    jkw["walker_jitter"] = 1e-3
    jw = jfit.walker_create(n_walkers=256, seed=4, dtype=jnp.float32, **jkw)
    tkw = {k: v for k, v in tkw.items() if k != "walker_jitter"}
    tw = walker_from_numpy(_arrays(jw), datasets=_datasets(jw), dtype=torch.float32,
                           device="cpu", **tkw)
    j_run = build_chunk_pallas(jw.terms, jw.spec, jfit.FitConfig(), 256, jnp.float32,
                               block_walkers=128, interpret=True)
    ck = tck.build_chunk_kernel(tw.terms, tw.spec, tfit.FitConfig(), 256,
                                torch.float32, block_walkers=128)
    assert j_run is not None and ck is not None and ck.d == 9 and len(ck.post.terms) == 2
    # dense: a transposed L, or a misplaced moment entry, shows
    L = synthetic.dense_l(3e-3 * np.asarray(list(jkw["params"].values()))).numpy()
    start = [np.asarray(a, np.float32) for a in
             (jw.state.position, jw.state.logprob, jw.state.best_position,
              jw.state.best_logprob)]
    jo = j_run(*[jnp.asarray(a) for a in start], jnp.asarray(L), 1000, 0.0, 20240607)
    to = tck.chunk_rwm(ck, *[torch.as_tensor(a) for a in start], torch.as_tensor(L),
                       1000, 0.0, torch.tensor([20240607], dtype=torch.int32))
    j_acc, t_acc = np.asarray(jo["accept_counts"]), to["accept_counts"].numpy()
    assert 0.05 < j_acc.mean() / ck.chunk < 0.95, "uninformative acceptance"
    same = j_acc == t_acc
    assert same.mean() >= 0.99, f"accept counts agree for {same.mean():.4f} (need >= 0.99)"
    np.testing.assert_allclose(to["position"].numpy()[same], np.asarray(jo["position"])[same],
                               rtol=1e-4, err_msg="positions of agreeing walkers, rtol 1e-4")
    assert float(to["m_count"]) == float(t_acc.sum())
    # moments within 5e-3 of sqrt(m_ii m_jj), off-diagonal ones 10x that
    j_mo, t_mo = np.asarray(jo["m_outer"], np.float64), to["m_outer"].double().numpy()
    scale = np.sqrt(np.outer(np.diag(j_mo), np.diag(j_mo)))
    assert np.median(np.abs(j_mo / scale)[~np.eye(9, dtype=bool)]) >= 5e-2
    assert np.all(np.abs(t_mo - j_mo) <= 5e-3 * scale), (np.abs(t_mo - j_mo) / scale).max()


@pytest.mark.parametrize("kind", ["normal", "normal_cutoff"])
def test_posterior_rel_err_measures_against_the_misfit(kind):
    """The scale is max(|ref|, |ref - C|, 1) with C the whole
    log-normalisation: the scalar constant, or the cutoff kind's per-point
    constants, which the kernel sums with the misfit (exact, float64)."""
    x = np.linspace(0.5, 3.0, 40)
    y = 2.0 * x + 1.0 + 0.01 * np.random.default_rng(3).standard_normal(40)
    lik = {"normal": tfit.log_likelihood_normal,
           "normal_cutoff": tfit.log_likelihood_normal_cutoff}[kind]
    w = tfit.walker_create(function=models.line, data=(x, y), params={"m": 2.0, "b": 1.0},
                           data_error=0.01, log_likelihood=lik, n_walkers=8,
                           walker_jitter=0.01, dtype=torch.float64, device="cpu")
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float64)
    ref = tlk.fused_posterior_plain(w.state.position, post)
    ds = w.terms[0].dataset
    norm = (ds.log_norm_const if kind == "normal"
            else torch.sum(ds.log_norm_const_point * ds.mask))
    assert (ref - norm).abs().min() > 1.0        # the misfit, not the constant
    scale = torch.maximum(torch.maximum(ref.abs(), (ref - norm).abs()), torch.ones(8))
    want = float((1e-3 / scale).max())
    assert tlk.posterior_rel_err(ref + 1e-3, ref, post) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("n_datasets,n_points,resident",
                         [(2, 334, True), (5, 334, True), (6, 334, False), (2, 1500, False)])
def test_chunk_data_resident(n_datasets, n_points, resident):
    """The chunk kernel keeps the data in shared memory when every term
    fits one 512-point tile and all, at the tile's stride (3 columns x
    512 per normal term), fit 8192 floats: five terms do, six do not."""
    g = synthetic.global_fit(n_datasets, n_points=n_points)
    w = tfit.walker_create(function=g["functions"], data=g["data"], params=g["truth"],
                           data_error=1e-7, n_walkers=128, device="cpu")
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float32)
    assert tck.data_resident(post) is resident


def test_dense_l_is_a_dense_cholesky_factor():
    """The chunk checks' L: lower-triangular, standard deviations |scales|
    (rtol 1e-6, float32), correlations of a median size >= 0.1."""
    s = np.array([1e-12, -3e-3, 2.0, 8.0, 1e-6, 0.5])
    L = synthetic.dense_l(s).double().numpy()
    assert L.shape == (6, 6) and not np.triu(L, 1).any()
    cov = L @ L.T
    np.testing.assert_allclose(np.sqrt(np.diag(cov)), np.abs(s), rtol=1e-6)
    corr = np.abs(cov / np.outer(np.abs(s), np.abs(s)))[~np.eye(6, dtype=bool)]
    assert np.median(corr) >= 0.1


def test_two_term_run_with_history_matches_jax_injected_draws():
    jw, tw, _ = _pair("global", torch.float64, n_walkers=W, seed=1)
    d = tw.ndim
    l0 = 1e-2 * np.diag(np.abs(np.asarray(list(synthetic.global_fit(2)["truth"].values()))))
    j_state = dataclasses.replace(jw.state, l_matrix=jnp.asarray(l0)[None])
    tw._set_l_matrix(l0)
    t_state = tw.state
    _, j_hist = jkernel.build_chunk_runner(jw._log_post_one, d, jw.config, takes_data=True)
    _, t_hist = tkernel.build_chunk_runner(tw._log_post, d, tkernel.FitConfig())
    j_hist = jax.jit(j_hist)

    @jax.jit
    def draws(key):
        def body(k, _):
            k, k_prop, k_accept = jax.random.split(k, 3)
            return k, (jax.random.normal(k_prop, (W, d), jnp.float64),
                       jax.random.uniform(k_accept, (W,), jnp.float64))
        return lax.scan(body, key, None, length=200)

    for chunk in range(2):
        _, (z, u) = draws(j_state.key)
        j_state, j_out = j_hist(j_state, True, True, False, jw._posterior_data())
        t_state, t_out = t_hist(t_state, True, True, False,
                                noise=(torch.as_tensor(np.array(z)), torch.as_tensor(np.array(u))))
        for k in STATE_KEYS:
            np.testing.assert_allclose(getattr(t_state, k).numpy(), np.asarray(getattr(j_state, k)),
                                       rtol=1e-9, atol=0, err_msg=f"chunk {chunk}: {k}, rtol 1e-9")
        for k in ("positions", "logprobs", "logprob_max", "accept_rate"):
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), rtol=1e-9,
                                       atol=0, err_msg=f"chunk {chunk}: out[{k}], rtol 1e-9")
    assert 0.0 < float(t_out["accept_rate"]) < 1.0


def test_global_state_carries_across():
    """A JAX global fit (a closure for dataset 2) installed in the port
    (``models.renamed``) with its padded datasets: the same posterior at
    the same positions, rtol 1e-12."""
    jw, tw, _ = _pair("global", torch.float64)
    assert tw.spec.keys == jw.spec.keys and len(tw.terms) == 2
    for k in STATE_KEYS:
        np.testing.assert_array_equal(getattr(tw.state, k).numpy(),
                                      np.asarray(getattr(jw.state, k)))
    assert tw.terms[1].dataset.y.shape[0] == np.asarray(jw.terms[1].dataset.y).shape[0]
    pos = np.asarray(jw.state.position) * (1 + 1e-3 * np.random.default_rng(1).standard_normal((W, 9)))
    np.testing.assert_allclose(tw._eval_batch(torch.as_tensor(pos)).numpy(),
                               np.asarray(jw._eval_batch(jnp.asarray(pos))), rtol=1e-12)
    _, tkw, _ = _case("global")
    tkw.pop("walker_jitter")
    arrays = _arrays(jw)
    with pytest.raises(ValueError, match="columns"):
        walker_from_numpy({**arrays, "keys": tuple(reversed(jw.spec.keys))},
                          device="cpu", dtype=torch.float64, **tkw)
    with pytest.raises(ValueError, match="2 terms"):
        walker_from_numpy(arrays, datasets=_datasets(jw)[:1], device="cpu",
                          dtype=torch.float64, **tkw)
    with pytest.raises(ValueError, match="misshapen"):
        walker_from_numpy({**arrays, "m_sum": np.zeros((1, 8))}, device="cpu",
                          dtype=torch.float64, **tkw)


def _walker(name, **kw):
    _, tkw, _ = _case(name)
    return tfit.walker_create(n_walkers=W, device="cpu", **{**tkw, **kw})


def test_coverage_of_the_multi_term_and_prior_fits():
    for name in ("gaussian_line", "global"):
        w = _walker(name)
        assert tlk.kernel_coverage(w.terms, w.spec) is None, name
        assert tck.chunk_coverage(w.terms, w.spec, w.config, W, torch.float32) is None, name
    w = _walker("nv")
    assert tlk.kernel_coverage(w.terms, w.spec) is None
    assert tck.chunk_coverage(w.terms, w.spec, w.config, W, torch.float32) is None
    # the wide fits: d = 18 runs, d > 64 is named
    g = synthetic.global_fit(5)
    w5 = tfit.walker_create(function=g["functions"], data=g["data"], params=g["truth"],
                            data_error=1e-7, n_walkers=W, device="cpu")
    assert w5.ndim == 18
    assert tck.chunk_coverage(w5.terms, w5.spec, w5.config, W, torch.float32) is None
    coeffs = {f"c{k}": 0.1 for k in range(16)}
    x = np.linspace(0.0, 1.0, 8)
    wide = tfit.walker_create(function=[models.polynomial] * 5, data=[(x, x)] * 5,
                              params={**coeffs, **{f"p{k}": 1.0 for k in range(50)}},
                              n_walkers=W, device="cpu")
    assert "above the chunk kernel's 64" in tck.chunk_coverage(
        wide.terms, wide.spec, wide.config, W, torch.float32)


def test_a_prior_that_is_no_table_runs_beside_the_fused_kernel():
    """Any prior callable: its whole value is the remainder that torch
    evaluates; the chunk kernel refuses it and says why."""
    def gauss_prior(p, ds):
        return -0.5 * ((p["m"] - 2.0) / 0.1) ** 2

    x = np.linspace(0.0, 10.0, 50)
    w = tfit.walker_create(function=models.line, data=(x, 2.0 * x + 1.0),
                           params={"m": 2.0, "b": 1.0}, data_error=0.5,
                           log_prior=gauss_prior, n_walkers=W, walker_jitter=0.1,
                           dtype=torch.float64, device="cpu")
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float64)
    assert post.bounds == () and len(post.rest) == 1
    torch.testing.assert_close(tlk.fused_posterior(w.state.position, post),
                               w._log_post(w.state.position), rtol=1e-12, atol=0)
    reason = tck.chunk_coverage(w.terms, w.spec, w.config, W, torch.float32)
    assert "gauss_prior" in reason
    w32 = tfit.walker_create(function=models.line, data=(x, 2.0 * x + 1.0),
                             params={"m": 2.0, "b": 1.0}, log_prior=gauss_prior,
                             n_walkers=W, device="cpu",
                             config=tfit.FitConfig(posterior_impl="chunk_kernel"))
    with pytest.raises(ValueError, match="bounds table alone"):
        w32.adaptive_steps(400, auto=None, collect_history=False)
