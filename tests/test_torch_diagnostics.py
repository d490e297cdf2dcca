"""The per-parameter diagnostics substrate against the JAX package.

The same numpy inputs, made from a seed, through ``lisp_mcmc_tpu`` (x64,
CPU) and the port (float64, CPU):

- ``likelihoods``: ``log_normal``, ``log_factorial``, ``log_poisson``;
  the Student-t, noise-scale and errors-in-x likelihoods, each reduced
  and per point, and ``create_log_likelihood_function``; the library
  reductions' ``pointwise_log_likelihood`` and every ``pointwise_cdf``
  (the Poisson's mid-p, the Student-t's incomplete beta): the port's
  ``(W, 1)`` parameter columns give ``(W,)`` and ``(W, P)``, the JAX
  walker's one row each, at rtol 1e-12 (atol 1e-15 for the CDFs, values
  of order 1); the host simulators bit for bit from one numpy
  ``Generator``;
- ``params``: ``map_params``, ``scale_params``, ``reduce_params``;
  ``ops.linalg``: ``diagonal_covariance``, and ``covariant_sample`` against
  the JAX formula ``mean + L z`` on the draws of its ``torch.Generator``;
- ``ops.reductions``: ``rank_normalized_rhat``, ``tail_ess`` and
  ``mcse_mean`` on seeded chains, ties and a frozen chain among them;
- ``utils``: every function on the same inputs, exactly;
- ``diagnostics``: per-parameter ESS, R-hat, rank R-hat, tail ESS, MCSE,
  the convergence verdicts (one population, and two adaptation groups
  reduced apart), ``metrics`` and ``summary`` on one seeded ``(T, W, d)``
  history given to a JAX walker and a port walker alike, at rtol 1e-12;
  ``trace_profile`` writes a trace.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import diagnostics as tdiag, likelihoods as tll, models, utils as tutils
from lisp_mcmc_torch import params as tparams
from lisp_mcmc_torch.convert import walker_from_numpy
from lisp_mcmc_torch.data import Dataset as TDataset
from lisp_mcmc_torch.ops import linalg as tlin, reductions as tred
from lisp_mcmc_tpu import diagnostics as jdiag, likelihoods as jll, utils as jutils
from lisp_mcmc_tpu import params as jparams
from lisp_mcmc_tpu.data import Dataset as JDataset
from lisp_mcmc_tpu.models import zoo as jzoo
from lisp_mcmc_tpu.ops import linalg as jlin, reductions as jred

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_primitives_match_jax():
    x = np.linspace(-3.0, 5.0, 41)
    np.testing.assert_allclose(tll.log_normal(torch.as_tensor(x), 0.5, 1.7).numpy(),
                               jll.log_normal(jnp.asarray(x), 0.5, 1.7), rtol=RTOL)
    k = np.arange(0.0, 30.0)
    np.testing.assert_allclose(tll.log_factorial(torch.as_tensor(k)).numpy(),
                               jll.log_factorial(jnp.asarray(k)), rtol=RTOL, atol=1e-13)
    lam = np.linspace(0.3, 12.0, 30)
    np.testing.assert_allclose(tll.log_poisson(torch.as_tensor(lam), torch.as_tensor(k)).numpy(),
                               jll.log_poisson(jnp.asarray(lam), jnp.asarray(k)), rtol=RTOL)


def _data(kind):
    rng = np.random.default_rng(3)
    x = np.linspace(0.5, 4.0, 37)
    if kind == "poisson":
        y = rng.poisson(2.0 + 1.5 * x).astype(np.float64)
        sigma = 1.0
    else:
        y = 1.5 * x + 0.7 + 0.1 * rng.standard_normal(37)
        y[5] += 2.0                                   # an outlier
        sigma = 0.1 + 0.02 * rng.uniform(size=37)
    return (x, y, sigma, JDataset.create(x, y, sigma, dtype=jnp.float64),
            TDataset.create(x, y, sigma, dtype=torch.float64, device="cpu"))


def _params(extra=None, W=9):
    rng = np.random.default_rng(4)
    p = {"m": 1.5 + 0.1 * rng.standard_normal(W), "b": 0.7 + 0.2 * rng.standard_normal(W)}
    if extra:
        p[extra] = rng.uniform(0.5, 2.0, W)
    return p


def _both(fn_pair, p):
    """(port value over (W, 1) columns, JAX value per walker stacked); a
    per-point JAX value is cut to the points (the JAX dataset pads to 128
    lanes, the port's does not)."""
    jf, tf = fn_pair
    W = len(next(iter(p.values())))
    t = tf({k: torch.as_tensor(v)[:, None] for k, v in p.items()}).numpy()
    j = np.stack([np.asarray(jf({k: jnp.asarray(v[i]) for k, v in p.items()}))
                  for i in range(W)])
    return t, j[..., :t.shape[-1]] if j.ndim == 2 else j


LIKELIHOODS = {
    "student_t": (lambda: jll.make_student_t_likelihood(3.0),
                  lambda: tll.make_student_t_likelihood(3.0), None),
    "noise_scale": (lambda: jll.make_noise_scale_likelihood(),
                    lambda: tll.make_noise_scale_likelihood(), "noise_scale"),
    "x_error": (lambda: jll.make_x_error_likelihood(0.05),
                lambda: tll.make_x_error_likelihood(0.05), None),
    "x_error_per_point": (lambda: jll.make_x_error_likelihood(np.linspace(0.01, 0.1, 37)),
                          lambda: tll.make_x_error_likelihood(np.linspace(0.01, 0.1, 37)),
                          None),
    "point_fn": (lambda: jll.create_log_likelihood_function(
                     lambda y, mu, s: -jnp.abs(y - mu) / s),
                 lambda: tll.create_log_likelihood_function(
                     lambda y, mu, s: -torch.abs(y - mu) / s), None),
}


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_likelihood_factories_match_jax(name):
    jmake, tmake, extra = LIKELIHOODS[name]
    jl, tl = jmake(), tmake()
    _, _, _, jds, tds = _data("normal")
    p = _params(extra)
    got, want = _both((lambda q: jl(jzoo.line, q, jds), lambda q: tl(models.line, q, tds)), p)
    assert got.shape == want.shape == (9,)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    got, want = _both((lambda q: jll.pointwise_log_likelihood(jl, jzoo.line, q, jds),
                       lambda q: tll.pointwise_log_likelihood(tl, models.line, q, tds)), p)
    assert got.shape == want.shape == (9, 37)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(got.sum(axis=1), _both(
        (lambda q: jl(jzoo.line, q, jds), lambda q: tl(models.line, q, tds)), p)[0], rtol=1e-12)
    if hasattr(jl, "_pointwise_cdf"):
        got, want = _both((lambda q: jll.pointwise_cdf(jl, jzoo.line, q, jds),
                           lambda q: tll.pointwise_cdf(tl, models.line, q, tds)), p)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)
    if hasattr(jl, "_sbc_simulator"):
        mu, sig = np.linspace(0.0, 1.0, 37), np.full(37, 0.1)
        q = {"noise_scale": 1.3}
        np.testing.assert_array_equal(
            tl._sbc_simulator(np.random.default_rng(5), mu, sig, q),
            jl._sbc_simulator(np.random.default_rng(5), mu, sig, q))
    assert tl.__name__ == jl.__name__


@pytest.mark.parametrize("kind", ["normal", "normal_cutoff", "poisson"])
def test_library_pointwise_forms_match_jax(kind):
    lik = {"normal": "log_likelihood_normal", "normal_cutoff": "log_likelihood_normal_cutoff",
           "poisson": "log_likelihood_poisson"}[kind]
    jl, tl = getattr(jll, lik), getattr(tll, lik)
    _, _, _, jds, tds = _data("poisson" if kind == "poisson" else "normal")
    p = _params()
    if kind == "poisson":
        p = {"m": 1.5 + 0.0 * p["m"], "b": 2.0 + np.abs(p["b"])}
    for jf, tf in ((jll.pointwise_log_likelihood, tll.pointwise_log_likelihood),
                   (jll.pointwise_cdf, tll.pointwise_cdf)):
        got, want = _both((lambda q: jf(jl, jzoo.line, q, jds),
                           lambda q: tf(tl, models.line, q, tds)), p)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)
    assert tll.LIBRARY_POINTWISE == (tll.log_likelihood_normal,
                                     tll.log_likelihood_normal_cutoff,
                                     tll.log_likelihood_poisson)
    with pytest.raises(ValueError, match="unrecognized"):
        tll.pointwise_log_likelihood(lambda f, q, d: 0.0, models.line, {}, tds)
    with pytest.raises(ValueError, match="no per-point predictive CDF"):
        tll.pointwise_cdf(lambda f, q, d: 0.0, models.line, {}, tds)


def test_params_and_linalg_match_jax():
    p1, p2 = {"a": 1.5, "b": -2.0}, {"a": 0.25, "b": 4.0}
    assert tparams.map_params(abs, p1) == jparams.map_params(abs, p1)
    assert tparams.scale_params(3.0, p1) == jparams.scale_params(3.0, p1)
    assert tparams.reduce_params(max, p1, p2) == jparams.reduce_params(max, p1, p2)
    v = np.random.default_rng(1).standard_normal((3, 4))
    np.testing.assert_array_equal(tlin.diagonal_covariance(torch.as_tensor(v)).numpy(),
                                  jlin.diagonal_covariance(jnp.asarray(v)))
    mean = np.random.default_rng(2).standard_normal((5, 3))
    L = np.tril(np.random.default_rng(3).standard_normal((3, 3)))
    for l_mat in (L, np.stack([L, 2 * L, 3 * L, L, L])):
        g = torch.Generator().manual_seed(9)
        got = tlin.covariant_sample(g, torch.as_tensor(mean), torch.as_tensor(l_mat)).numpy()
        z = torch.randn((5, 3), generator=torch.Generator().manual_seed(9),
                        dtype=torch.float64).numpy()
        eq = "ij,...j->...i" if l_mat.ndim == 2 else "...ij,...j->...i"
        want = np.asarray(jnp.asarray(mean) + jnp.einsum(eq, jnp.asarray(l_mat), jnp.asarray(z)))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def _chains(T=120, W=16, seed=0):
    rng = np.random.default_rng(seed)
    ar = np.zeros((T, W))
    for t in range(1, T):
        ar[t] = 0.8 * ar[t - 1] + rng.standard_normal(W)
    ar[:, 3] = 2.0                                    # a frozen chain
    ar[40:50, 5] = ar[40, 5]                          # ties
    return ar


@pytest.mark.parametrize("seed", [0, 1])
def test_reductions_match_jax(seed):
    c = _chains(seed=seed)
    tb, tt = tred.rank_normalized_rhat(torch.as_tensor(c))
    jb, jt = jred.rank_normalized_rhat(jnp.asarray(c))
    assert float(tb) == pytest.approx(float(jb), rel=RTOL)
    assert float(tt) == pytest.approx(float(jt), rel=RTOL)
    assert float(tred.tail_ess(torch.as_tensor(c))) == pytest.approx(
        float(jred.tail_ess(jnp.asarray(c))), rel=RTOL)
    assert float(tred.mcse_mean(torch.as_tensor(c))) == pytest.approx(
        float(jred.mcse_mean(jnp.asarray(c))), rel=RTOL)
    frozen = np.full((40, 8), 1.5)
    assert float(tred.rank_normalized_rhat(torch.as_tensor(frozen))[0]) == float("inf")


def test_utils_match_jax():
    tree = [1, (2, [3, "s"]), [[4.0]]]
    cases = [
        ("range_list", (2, 7, 1.5)), ("range_list", (5,)), ("thin", (list(range(10)), 3)),
        ("slice_seq", (list(range(10)), 2, 8, 2)), ("map_tree", (str, tree)),
        ("plist_keys", ({"a": 1, "b": 2},)), ("plist_values", ({"a": 1, "b": 2},)),
        ("make_plist", (["a", "b"], [1, 2])), ("array_to_plist", (["a", "b"], np.array([1, 2]))),
        ("diff_matrix", ([[1, 2], [4, 8], [9, 9]],)), ("diff_params", ({"a": 3}, {"a": 1})),
        ("partition", (list(range(7)), 3)), ("transpose", ([[1, 2, 3], [4, 5, 6]],)),
        ("flatten", (tree,)), ("split_string", ("a  b c ",)), ("repeat", ("x", 3)),
    ]
    for name, args in cases:
        a, b = getattr(tutils, name)(*args), getattr(jutils, name)(*args)
        np.testing.assert_array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object),
                                      err_msg=name)
    assert tutils.mapcar_enum(lambda e, i: e * i, [3, 4]) == [0, 4]
    for kw in (dict(num=5), dict(step=0.25), dict(num=4, dtype=int)):
        np.testing.assert_array_equal(tutils.linspace(0, 1, **kw), jutils.linspace(0, 1, **kw))
    assert tutils.__all__ == jutils.__all__


def _walkers(groups):
    """A JAX walker and a port walker holding one seeded (T, W, d) history."""
    x = np.linspace(0.0, 1.0, 20)
    y = 2.0 * x + 1.0
    W, T = 24, 90
    kw = dict(function=None, data=(x, y), params={"m": 2.0, "b": 1.0}, data_error=0.1,
              n_walkers=W, walker_jitter=0.1)
    jw = jfit.walker_create(**{**kw, "function": jzoo.line}, dtype=jnp.float64)
    arrays = {k: np.asarray(getattr(jw.state, k)) for k in (
        "position", "logprob", "best_position", "best_logprob", "l_matrix", "m_sum",
        "m_outer", "m_count")}
    kw.pop("n_walkers")
    kw.pop("walker_jitter")
    tw = walker_from_numpy(arrays, **{**kw, "function": models.line}, dtype=torch.float64,
                           device="cpu")
    if groups:
        gids = np.repeat(np.arange(2), W // 2)
        jw.group_ids, jw.n_groups = jnp.asarray(gids, jnp.int32), 2
        tw.group_ids, tw.n_groups = gids, 2
    rng = np.random.default_rng(7)
    pos = np.zeros((T, W, 2))
    for t in range(1, T):
        pos[t] = 0.7 * pos[t - 1] + rng.standard_normal((W, 2))
    pos[:, :, 1] *= 3.0
    pos[:, W // 2:, 0] += 0.5                         # group 2 sits elsewhere
    lp = -0.5 * (pos ** 2).sum(axis=2)
    for w in (jw, tw):
        w.add_steps(pos, lp)
    return jw, tw


@pytest.mark.parametrize("groups", [False, True])
def test_per_parameter_diagnostics_match_jax(groups):
    jw, tw = _walkers(groups)
    for fn in ("ess_per_param", "rhat_per_param", "tail_ess_per_param", "mcse_per_param"):
        a, b = getattr(tdiag, fn)(tw), getattr(jdiag, fn)(jw)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=RTOL), (fn, k)
    a, b = tdiag.rank_rhat_per_param(tw), jdiag.rank_rhat_per_param(jw)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL)
    for take in (None, 60):
        ca, cb = tw.convergence(take), jdiag.convergence(jw, take)
        assert ca["ok"] == cb["ok"] and ca["failures"] == cb["failures"]
        for k in tw.spec.keys:
            np.testing.assert_allclose(ca["rank_rhat"][k], cb["rank_rhat"][k], rtol=RTOL)
            assert ca["tail_ess"][k] == pytest.approx(cb["tail_ess"][k], rel=RTOL)
            assert ca["mcse"][k] == pytest.approx(cb["mcse"][k], rel=RTOL)
    per_a, per_b = tdiag.convergence_per_dataset(tw), jdiag.convergence_per_dataset(jw)
    assert len(per_a) == len(per_b) == (2 if groups else 1)
    for va, vb in zip(per_a, per_b):
        assert va["failures"] == vb["failures"]
    ma, mb = tw.metrics(elapsed_seconds=2.0), jdiag.metrics(jw, elapsed_seconds=2.0)
    assert ma.keys() == mb.keys()
    for key in ("age", "n_walkers", "acceptance", "best_logprob", "min_ess",
                "chain_steps_per_sec", "ess_per_sec"):
        assert ma[key] == pytest.approx(mb[key], rel=RTOL), key
    for key in ("ess", "rhat", "mcse", "logprob_quantiles", "best_params"):
        for k in ma[key]:
            assert ma[key][k] == pytest.approx(mb[key][k], rel=RTOL), (key, k)
    assert tw.summary() == jdiag.summary(jw)


def test_merge_worst_verdict_keeps_the_worst():
    out = {"rank_rhat": {}, "tail_ess": {}, "mcse": {}}
    keys = ("a",)
    v1 = {"rank_rhat": {"a": (1.0, 1.2)}, "tail_ess": {"a": 300.0}, "mcse": {"a": 0.1}}
    v2 = {"rank_rhat": {"a": (1.1, 1.0)}, "tail_ess": {"a": 200.0}, "mcse": {"a": 0.05}}
    for v in (v1, v2):
        tdiag.merge_worst_verdict(out, v, keys)
    assert out == {"rank_rhat": {"a": (1.1, 1.2)}, "tail_ess": {"a": 200.0}, "mcse": {"a": 0.1}}


def test_trace_profile_writes_a_trace(tmp_path):
    with tdiag.trace_profile(str(tmp_path)):
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
