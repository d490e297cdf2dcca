"""The port's host modules of this slice against the JAX package.

- ``stats``: every function on the same (W, T) samples, float64, rtol
  1e-12 (the same linear-interpolation percentiles and population
  moments; ``hdi`` and ``make_histogram`` are the same numpy code).
- ``expressions`` and the ``fit`` query and mutation verbs
  (``median_params``, ``mean_params``, ``stddev_params``,
  ``covariance_matrix``, ``l_matrix_estimate``, ``log_likelihoods``,
  ``param_trace``, ``with_expression``, ``reset_to_most_likely``,
  ``delete``), and ``WalkerSet``: a port walker carrying a JAX walker's
  state, with the same history installed in both, rtol 1e-12 (1e-10 for
  the clamped Cholesky).
- The NV helpers on the synthetic spectra (the priors at rtol 1e-9), and
  ``fit_nv_file`` / ``fit_nv_dir`` end to end on a ';'-delimited file at
  W = 64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import nv, stats, synthetic
from lisp_mcmc_torch.convert import walker_from_numpy
from lisp_mcmc_tpu import expressions as jexpr
from lisp_mcmc_tpu import nv as jnv
from lisp_mcmc_tpu import stats as jstats
from lisp_mcmc_tpu.models import zoo as jzoo
from lisp_mcmc_tpu.walker_set import WalkerSet as JWalkerSet

STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("T", [40, 41])  # an even and an odd count
def test_stats_match_jax(T):
    x = np.random.default_rng(1).standard_t(3, size=(6, T))
    tx = torch.as_tensor(x)
    for name in ("median", "mean", "variance", "standard_deviation", "iqr",
                 "std_from_84th_percentile"):
        np.testing.assert_allclose(getattr(stats, name)(tx).numpy(),
                                   np.asarray(getattr(jstats, name)(x)), rtol=1e-12,
                                   err_msg=f"stats.{name}, rtol 1e-12")
    for n in (2.5, 50, 84.1, np.array([10.0, 90.0])):
        np.testing.assert_allclose(stats.nth_percentile(x, n).numpy(),
                                   np.asarray(jstats.nth_percentile(x, n)), rtol=1e-12)
    np.testing.assert_allclose(stats.nth_percentile(x, 30, axis=0).numpy(),
                               np.asarray(jstats.nth_percentile(x, 30, axis=0)), rtol=1e-12)
    for a, b in zip(stats.credible_interval_95(x), jstats.credible_interval_95(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    assert stats.hdi(x, 0.9) == jstats.hdi(x, 0.9)
    for got, want in zip(stats.make_histogram(x), jstats.make_histogram(x)):
        np.testing.assert_array_equal(got, want)
    draw = stats.multivariate_gaussian_random(
        torch.Generator().manual_seed(0), torch.full((20000,), 3.0, dtype=torch.float64))
    assert abs(float(draw.std()) - 3.0) < 0.1 and abs(float(draw.mean())) < 0.1


def _line_pair(seed=0, W=32):
    """A JAX line fit and a port walker carrying its state, with the same
    random history (T = 30 rows, every 10th step) installed in both."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.5 * rng.standard_normal(50)
    kw = dict(data=(x, y), params={"m": 2.0, "b": 1.0}, data_error=0.5)
    jw = jfit.walker_create(function=jzoo.line, n_walkers=W, seed=seed,
                            walker_jitter=0.1, **kw)
    arrays = {k: np.asarray(getattr(jw.state, k)) for k in STATE_KEYS}
    tw = walker_from_numpy(arrays, function=tfit.models.line, dtype=torch.float64,
                           device="cpu", **kw)
    pos = np.array([2.0, 1.0]) + 0.05 * np.cumsum(rng.standard_normal((30, W, 2)), axis=0)
    lp = -np.sum((pos - [2.0, 1.0]) ** 2, axis=-1)
    lp[5:8] = lp[4]  # repeated steps: dropped by covariance_matrix
    for w in (jw, tw):
        w._hist_positions = [pos.copy()]
        w._hist_logprobs = [lp.copy()]
    return jw, tw


def test_query_verbs_match_jax():
    jw, tw = _line_pair()
    for verb in ("median_params", "mean_params", "stddev_params"):
        for take in (None, 150):
            got, want = getattr(tw, verb)(take), getattr(jw, verb)(take)
            assert got.keys() == want.keys()
            np.testing.assert_allclose(list(got.values()), list(want.values()),
                                       rtol=1e-10, err_msg=f"{verb}({take})")
    np.testing.assert_allclose(tw.covariance_matrix(), jw.covariance_matrix(), rtol=1e-12)
    np.testing.assert_allclose(tw.l_matrix_estimate(100), jw.l_matrix_estimate(100),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_array_equal(tw.log_likelihoods(), jw.log_likelihoods())
    np.testing.assert_array_equal(tw.log_likelihoods(100, walker=3),
                                  jw.log_likelihoods(100, walker=3))
    np.testing.assert_array_equal(tw.param_trace("b", walker=5), jw.param_trace("b", walker=5))
    assert tw.with_expression("(/ :m :b)") == pytest.approx(
        jw.with_expression("(/ :m :b)"), rel=1e-12)
    short = tfit.walker_create(function=tfit.models.line, data=(np.arange(3.0),) * 2,
                               params={"m": 1.0, "b": 0.0}, device="cpu")
    assert short.stddev_params() == {"m": 0.0, "b": 0.0}


def test_mutation_verbs_match_jax():
    jw, tw = _line_pair(seed=3)
    jw.reset_to_most_likely()
    tw.reset_to_most_likely()
    for k in ("position", "logprob"):
        np.testing.assert_array_equal(getattr(tw.state, k).numpy(),
                                      np.asarray(getattr(jw.state, k)))
    assert len(tw) == len(jw) == 0
    tw.delete()
    assert tw.terms == [] and not tw._runner_cache and len(tw) == 0


def test_expressions_match_jax():
    jw, tw = _line_pair(seed=4)
    params = {"m": 2.5, "b": -0.5, "mu1": 2860.0, "mu2": 2877.0}
    for expr in ("(/ (- :mu2 :mu1) 2 2.8)", "(expt :m 2)", "(log :mu1 10)",
                 "(max :m :b 1d0)", ":m / :b + sqrt(abs(:b))", "min(:m, :b, 0.1) ** 2",
                 ":m > :b"):
        assert tfit.eval_expression(expr, params) == pytest.approx(
            jexpr.eval_expression(expr, params), rel=1e-12), expr
    for bad in ("(/ :nope :m)", "().__class__"):
        with pytest.raises((KeyError, ValueError)):
            tfit.eval_expression(bad, params)
    np.testing.assert_allclose(tfit.expression_samples(tw, "(* :m :b)", 200),
                               jexpr.expression_samples(jw, "(* :m :b)", 200), rtol=1e-12)
    for fn in ("expression_credible_interval", "expression_hdi"):
        np.testing.assert_allclose(getattr(tfit, fn)(tw, ":m - :b"),
                                   getattr(jexpr, fn)(jw, ":m - :b"), rtol=1e-12)
    assert tfit.walker_with_expression(tw, "(/ :m :b)") == pytest.approx(
        jexpr.walker_with_expression(jw, "(/ :m :b)"), rel=1e-12)


def test_walker_set_verbs_match_jax():
    pairs = [_line_pair(seed=s) for s in (5, 6)]
    js = JWalkerSet(jw for jw, _ in pairs)
    ts = tfit.WalkerSet(tw for _, tw in pairs)
    for got, want in zip(ts.median_params(100), js.median_params(100)):
        np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-12)
    for got, want in zip(ts.get("mean_params"), js.get("mean_params")):
        np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-12)
    np.testing.assert_allclose(ts.get_expression("(* 2 :m)"), js.get_expression("(* 2 :m)"),
                               rtol=1e-12)
    ts.adaptive_steps(200, auto=None)
    assert all(w.age == 200 for w in ts)
    ts.delete()
    assert len(ts) == 0


def test_nv_helpers_match_jax(tmp_path):
    path = synthetic.write_nv_file(tmp_path / "spectra.txt")
    table = tfit.read_file_data(str(path), delim=";")
    assert len(table) == 4
    for (tx, ty), (jx, jy) in zip(nv.nv_data_separated(table), jnv.nv_data_separated(table)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for (tx, ty), (jx, jy) in zip(nv.nv_dir_data(str(tmp_path)), jnv.nv_dir_data(str(tmp_path))):
        np.testing.assert_array_equal(ty, jy)
    x, ys = synthetic.nv_spectra()
    rng = np.random.default_rng(7)
    for y, truth in zip(ys, synthetic.NV_SPECTRA):
        assert nv.nv_data_std_dev(y) == jnv.nv_data_std_dev(y)
        assert nv.guess_nv_params(y) == jnv.guess_nv_params(y)
        assert nv._nv_boxes(y) == jnv._nv_boxes(y)
        # priors on (W,) columns around the truth: some walkers break the
        # boxes or the constraints.  rtol 1e-9: the penalty's
        # exp(1e-5 dist) - 1 cancels digits, and torch's exp and XLA's differ
        # in the last bit
        cols = {k: v * (1 + 0.004 * rng.standard_normal(64)) for k, v in truth.items()}
        for t_prior, j_prior in ((nv.make_nv_prior(y), jnv.make_nv_prior(y)),
                                 (nv.log_prior_nv, jnv.log_prior_nv)):
            got = t_prior({k: torch.as_tensor(v) for k, v in cols.items()}).numpy()
            want = np.asarray(j_prior({k: jnp.asarray(v) for k, v in cols.items()}))
            np.testing.assert_allclose(got, want, rtol=1e-9)
        assert (got < -1e8).any()
    values = np.random.default_rng(8).standard_normal(12)
    a = nv.export_scan_grid(values, 4, str(tmp_path / "t.txt"))
    b = jnv.export_scan_grid(values, 4, str(tmp_path / "j.txt"))
    assert open(a).read() == open(b).read()
    jw, tw = _nv_pair(ys[0])
    assert nv.walker_field_offset(tw) == pytest.approx(jnv.walker_field_offset(jw), rel=1e-12)


def _nv_pair(y):
    x = np.linspace(2840.0, 2900.0, 401)
    jw = jnv.nv_walker((x, y), n_walkers=16)
    arrays = {k: np.asarray(getattr(jw.state, k)) for k in STATE_KEYS}
    tw = walker_from_numpy(arrays, function=tfit.models.double_lorentzian_bg,
                           data=(x, y), params=nv.guess_nv_params(y),
                           data_error=nv.nv_data_std_dev(y), log_prior=nv.make_nv_prior(y),
                           dtype=torch.float64, device="cpu")
    return jw, tw


def test_fit_nv_file_and_dir_on_the_cpu(tmp_path):
    path = synthetic.write_nv_file(tmp_path / "nv-scan.txt")
    walkers = nv.fit_nv_file(str(path), n_steps=400, n_walkers=64, device="cpu")
    assert isinstance(walkers, tfit.WalkerSet) and len(walkers) == 3
    for w in walkers:
        assert w.age == 400 and w.spec.keys == ("scale1", "scale2", "mu1", "mu2",
                                                 "sigma", "bg0")
        assert 0.0 < w.acceptance() < 1.0
        lp, best = w.most_likely_step()
        assert np.isfinite(lp) and 2850.0 < best["mu1"] < best["mu2"] < 2890.0
        assert np.isfinite(nv.walker_field_offset(w))
    offsets = walkers.get_expression(nv.FIELD_OFFSET_EXPRESSION)
    assert len(offsets) == 3
    walkers = nv.fit_nv_dir(str(tmp_path), n_steps=200, n_walkers=64, device="cpu")
    assert len(walkers) == 3 and all(w.age == 200 for w in walkers)
