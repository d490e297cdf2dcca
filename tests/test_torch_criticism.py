"""Model criticism of the PyTorch port against the JAX package.

``lisp_mcmc_torch.diagnostics`` (pointwise comparison and report cards),
``predictive`` and ``profile`` against ``lisp_mcmc_tpu``'s, in float64 on
the CPU, on the JAX walker's own state and history carried across
(``convert.walker_from_numpy`` and the history rows):

- ``_pointwise_ll_matrix`` at rtol 1e-12 on a line, a Student-t line and
  a two-term global fit; ``waic``, ``loo``, ``loo_pit``, ``audit`` and
  the paired comparisons, every result field at 1e-10; ``_gpd_fit`` and
  ``_psis_smooth`` at 1e-12 on given tails; ``_ks_uniform``;
- ``prior_sensitivity`` on a named-prior fit (the installed prior, an
  explicit spec, an expression) and a flat one at 1e-10;
  ``model_weights`` (stacking, seeded pseudo-BMA+) and
  ``evidence_weights`` at 1e-10;
- ``posterior_predictive`` with JAX's normal and Poisson draws injected
  through ``predictive._normal`` / ``_poisson``, ``prior_predictive``,
  ``predict`` with and without noise, ``ppc_pvalue``, at 1e-12;
- ``profile_likelihood`` on a line and on the flagship at 1e-10;
- the refusals: grouped fits, custom posteriors, a likelihood without a
  noise model, a prior without a recipe, the argument guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import diagnostics as td
from lisp_mcmc_torch import models
from lisp_mcmc_torch import predictive as tpred
from lisp_mcmc_torch.convert import walker_from_numpy
from lisp_mcmc_torch.roofline import FLAGSHIP, synthetic_flagship
from lisp_mcmc_tpu import diagnostics as jd
from lisp_mcmc_tpu.models import zoo as jzoo

RTOL = 1e-10
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")
BOUNDS = {"m": (0.0, 4.0), "b": (-5.0, 5.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def line_data(seed=0, n=40, noise=0.3):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 10.0, n)
    return x, 2.0 * x + 1.0 + rng.normal(0.0, noise, n)


def carried(jw, **create):
    """The port's twin of JAX walker ``jw``: its state and whole history."""
    tw = walker_from_numpy({k: np.asarray(getattr(jw.state, k)) for k in STATE_KEYS},
                           dtype=torch.float64, device="cpu", **create)
    pos, lp = jw._history()
    tw._hist_positions, tw._hist_logprobs = [np.array(pos)], [np.array(lp)]
    return tw


def fitted(kind="normal", steps=3000, W=32, prior=None):
    """A JAX fit of a line (or a two-term global line fit) with history,
    burnt to its cold half, and its port twin."""
    jkw, tkw = {}, {}
    if kind == "student_t":
        jkw["log_likelihood"] = jfit.make_student_t_likelihood(4.0)
        tkw["log_likelihood"] = tfit.make_student_t_likelihood(4.0)
    if prior is not None:
        jkw["log_prior"], tkw["log_prior"] = prior
    if kind == "global":
        data = [line_data(0), line_data(1, n=30)]
        jfn, tfn, err = [jzoo.line, jzoo.line], [models.line, models.line], [0.3, 0.3]
    else:
        data, jfn, tfn, err = line_data(), jzoo.line, models.line, 0.3
    common = dict(data=data, params={"m": 1.5, "b": 0.5}, data_error=err)
    jw = jfit.walker_create(function=jfn, n_walkers=W, seed=0, walker_jitter=0.05,
                            **common, **jkw)
    jw.adaptive_steps(steps, auto=None)
    jw.burn_steps(steps // 2)
    return jw, carried(jw, function=tfn, **common, **tkw)


@pytest.fixture(scope="module")
def line_pair():
    return fitted()


def same(t, j, msg="", rtol=RTOL):
    np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                               rtol=rtol, atol=1e-13, err_msg=msg)


def same_result(t, j, fields):
    for f in fields:
        same(getattr(t, f), getattr(j, f), f)


# ------------------------------------------------ pointwise comparison


@pytest.mark.parametrize("kind", ["normal", "student_t", "global"])
def test_pointwise_ll_matrix_and_waic_loo_match_jax(kind, line_pair):
    jw, tw = line_pair if kind == "normal" else fitted(kind, steps=1600)
    for take, ms in ((None, 512), (600, 64)):
        jl, js = jd._pointwise_ll_matrix(jw, "x", take, ms)
        tl, ts = td._pointwise_ll_matrix(tw, "x", take, ms)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        same(tl, jl, "ll", rtol=1e-12)
        kw = {"take": take, "max_samples": ms}
        same_result(td.waic(tw, **kw), jd.waic(jw, **kw),
                    ("elpd", "p_waic", "lppd", "se", "n_points", "n_samples", "pointwise",
                     "waic"))
        tlo, jlo = td.loo(tw, **kw), jd.loo(jw, **kw)
        same_result(tlo, jlo, ("elpd", "p_loo", "lppd", "se", "n_points", "n_samples",
                               "pointwise", "pareto_k", "looic", "n_bad_k"))
        tp, jp = td.loo_pit(tw, **kw), jd.loo_pit(jw, **kw)
        same_result(tp, jp, ("pit", "ks_stat", "p_value", "n_points", "n_samples",
                             "pareto_k"))
        assert tp.ok == jp.ok


def test_paired_comparisons_and_weights_match_jax(line_pair):
    jw, tw = line_pair
    jw2, tw2 = fitted("student_t", steps=1600)
    ja, jb, ta, tb = jd.loo(jw), jd.loo(jw2), td.loo(tw), td.loo(tw2)
    for name in ("waic_compare", "loo_compare"):
        j = getattr(jd, name)(ja, jb)
        t = getattr(td, name)(ta, tb)
        assert t == pytest.approx(j, rel=RTOL)
    for method, kw in (("stacking", {}), ("pseudo-bma+", {"seed": 3, "n_boot": 200})):
        same(td.model_weights([ta, tb, td.waic(tw)], method, **kw),
             jd.model_weights([ja, jb, jd.waic(jw)], method, **kw), method)
    same(td.evidence_weights([-3.0, -1.5, -2.0], [0.0, 0.1, 0.2]),
         jd.evidence_weights([-3.0, -1.5, -2.0], [0.0, 0.1, 0.2]))
    with pytest.raises(ValueError, match="different data"):
        td.loo_compare(ta, td.loo(fitted("global", steps=400)[1]))
    with pytest.raises(ValueError, match=">= 2"):
        td.model_weights([ta])
    with pytest.raises(ValueError, match="unknown method"):
        td.model_weights([ta, tb], "bma")
    with pytest.raises(ValueError, match="non-finite"):
        td.evidence_weights([0.0, float("nan")])
    with pytest.raises(ValueError, match="carries no log_z"):
        td.evidence_weights([ta, tb])


def test_gpd_psis_and_ks_match_jax():
    rng = np.random.default_rng(4)
    for shape in (0.2, 0.6, 1.1):
        excess = np.sort(rng.pareto(1.0 / shape, 60) * 0.7)
        same(td._gpd_fit(excess), jd._gpd_fit(excess), f"gpd {shape}", rtol=1e-12)
    for s in (20, 400, 3000):
        lw = rng.standard_t(3.0, s) * 2.0
        tl, tk = td._psis_smooth(lw)
        jl, jk = jd._psis_smooth(lw)
        same(tl, jl, f"psis {s}", rtol=1e-12)
        assert tk == pytest.approx(jk, rel=1e-12)
    assert np.isnan(td._gpd_fit(np.ones(3))[0])
    pit = rng.uniform(size=200)
    assert td._ks_uniform(pit) == pytest.approx(jd._ks_uniform(pit), rel=1e-12)


# ------------------------------------------------------ report cards


def named_prior_specs():
    jspec = jfit.PriorSpec({"m": jfit.Gaussian(1.8, 0.05), "b": jfit.Uniform(-5.0, 5.0)})
    tspec = tfit.PriorSpec({"m": tfit.Gaussian(1.8, 0.05), "b": tfit.Uniform(-5.0, 5.0)})
    return jspec, tspec


@pytest.fixture(scope="module")
def prior_pair():
    return fitted(prior=named_prior_specs(), steps=1600)


def test_prior_sensitivity_matches_jax(line_pair, prior_pair):
    jspec, tspec = named_prior_specs()
    jw, tw = prior_pair
    cases = [({}, {}), ({"prior": jspec}, {"prior": tspec}),
             ({"expressions": ["(* :m 2)", ":b + :m"], "alpha": 1.05, "threshold": 0.02},
              {"expressions": ["(* :m 2)", ":b + :m"], "alpha": 1.05, "threshold": 0.02})]
    for jkw, tkw in cases:
        j, t = jd.prior_sensitivity(jw, **jkw), td.prior_sensitivity(tw, **tkw)
        assert t.diagnosis == j.diagnosis and t.ok == j.ok
        for f in ("prior", "likelihood", "pareto_k"):
            assert set(getattr(t, f)) == set(getattr(j, f))
            for k in getattr(j, f):
                same(getattr(t, f)[k], getattr(j, f)[k], f"{f}[{k}]")
        assert (t.alpha, t.threshold, t.n_samples) == (j.alpha, j.threshold, j.n_samples)
    assert max(t.prior.values()) > 0.0
    # a flat prior is exactly invariant
    flat = td.prior_sensitivity(line_pair[1])
    assert set(flat.prior.values()) == {0.0} and flat.ok
    with pytest.raises(ValueError, match="alpha"):
        td.prior_sensitivity(tw, alpha=2.0)


def test_audit_matches_jax(line_pair, prior_pair):
    for jw, tw in (line_pair, prior_pair):
        j, t = jd.audit(jw), td.audit(tw)
        assert (t.ok, t.advice, t.skipped) == (j.ok, j.advice, j.skipped)
        assert t.convergence["ok"] == j.convergence["ok"]
        same(t.loo_pit.pit, j.loo_pit.pit)
        for k in j.prior_sensitivity.prior:
            same(t.prior_sensitivity.prior[k], j.prior_sensitivity.prior[k])
    # a custom posterior skips both history checks, naming why
    tc = custom_walker()
    tc.adaptive_steps(400, auto=None)
    a = td.audit(tc)
    assert set(a.skipped) == {"loo_pit", "prior_sensitivity"} and a.loo_pit is None


# ----------------------------------------------------------- predictive


def jax_stream(monkeypatch, seed, jw):
    """``predictive._normal`` / ``_poisson`` drawing what the JAX package's
    ``_replicate`` draws from ``PRNGKey(seed)``: one split a term, at the
    JAX dataset's padded width (its stream's shape), cut to the port's."""
    box = {"key": jax.random.PRNGKey(seed), "term": 0}
    widths = [int(t.dataset.x.shape[0]) for t in jw.terms]

    def sub(shape):
        box["key"], k = jax.random.split(box["key"])
        width = widths[box["term"] % len(widths)]
        box["term"] += 1
        return k, (shape[0], width), shape[1]

    def normal(generator, shape, dtype, device):
        k, full, n = sub(tuple(shape))
        return torch.as_tensor(np.array(jax.random.normal(k, full, jnp.float64))[:, :n],
                               dtype=dtype)

    def poisson(generator, rates):
        k, full, n = sub(tuple(rates.shape))
        # the rejection sampler's draws depend on every lane's rate: the
        # padded lanes repeat the last point, so their rates the last rate
        lam = np.repeat(rates.numpy()[:, -1:], full[1], axis=1)
        lam[:, :n] = rates.numpy()
        draw = jax.random.poisson(k, jnp.asarray(lam), full).astype(jnp.float64)
        return torch.as_tensor(np.array(draw)[:, :n])

    monkeypatch.setattr(tpred, "_normal", normal)
    monkeypatch.setattr(tpred, "_poisson", poisson)


def same_draws(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a.term_index == b.term_index
        for f in ("x", "y_obs", "mu", "y_rep"):
            same(getattr(a, f), getattr(b, f), f, rtol=1e-12)
        assert a.coverage() == b.coverage()


def test_posterior_and_prior_predictive_match_jax(monkeypatch):
    jw, tw = fitted("global", steps=1600)
    for kw in ({}, {"take": 400, "max_samples": 50, "seed": 3}):
        jax_stream(monkeypatch, kw.get("seed", 0), jw)
        same_draws(tpred.posterior_predictive(tw, **kw), jfit.posterior_predictive(jw, **kw))
    jax_stream(monkeypatch, 5, jw)
    same_draws(tw.prior_predictive(bounds=BOUNDS, n_samples=40, seed=5),
               jw.prior_predictive(bounds=BOUNDS, n_samples=40, seed=5))
    jax_stream(monkeypatch, 0, jw)
    t, j = tw.ppc_pvalue(stat=np.ptp), jw.ppc_pvalue(stat=np.ptp)
    assert t["p"] == j["p"] and t["per_term"] == j["per_term"]
    same([t["stat_obs"], t["stat_rep_mean"]], [j["stat_obs"], j["stat_rep_mean"]])
    # a user sampler gets the generator, the curves and the dataset
    seen = []

    def sampler(generator, mu, dataset):
        seen.append(isinstance(generator, torch.Generator))
        return mu + 0.0
    d = tw.posterior_predictive(sampler=sampler)
    assert all(seen) and len(seen) == 2
    same(d[0].y_rep, d[0].mu)


def test_poisson_replicates_and_predict_match_jax(monkeypatch):
    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 4.0, 30)
    y = rng.poisson(2.0 + 1.5 * x).astype(np.float64)
    common = dict(data=(x, y), params={"m": 1.2, "b": 1.5})
    jw = jfit.walker_create(function=jzoo.line, log_likelihood=jfit.log_likelihood_poisson,
                            n_walkers=16, seed=0, walker_jitter=0.05, **common)
    jw.adaptive_steps(1000, auto=None)
    tw = carried(jw, function=models.line, log_likelihood=tfit.log_likelihood_poisson,
                 **common)
    jax_stream(monkeypatch, 2, jw)
    same_draws(tw.posterior_predictive(seed=2, max_samples=64),
               jw.posterior_predictive(seed=2, max_samples=64))
    grid = np.linspace(-1.0, 6.0, 25)
    for kw in ({}, {"noise": 0.5, "seed": 4}, {"noise": np.linspace(0.1, 1.0, 25),
                                                "max_samples": 10}):
        t, j = tw.predict(grid, **kw), jw.predict(grid, **kw)
        same(t.mu, j.mu, rtol=1e-12)
        assert (t.y_rep is None) == (j.y_rep is None)
        if t.y_rep is not None:
            same(t.y_rep, j.y_rep, rtol=1e-12)
        same(t.band(), j.band(), rtol=1e-12)
        same(t.mean(), j.mean(), rtol=1e-12)
    jg, tg = fitted("global", steps=400)
    for a, b in zip(tpred.predict(tg, grid, term_index=None),
                    jfit.predict(jg, grid, term_index=None)):
        same(a.mu, b.mu, rtol=1e-12)


# ------------------------------------------------------------- profile


@pytest.mark.parametrize("fit", ["line", "flagship"])
def test_profile_likelihood_matches_jax(fit, line_pair):
    if fit == "line":
        jw, tw = line_pair
        name, kw = "m", {}
    else:
        x, y = synthetic_flagship()
        common = dict(data=(x, y), params=FLAGSHIP, data_error=1e-7)
        jw = jfit.walker_create(function=jzoo.lorder_mixed_bg, n_walkers=16, seed=1,
                                walker_jitter=1e-3, **common)
        jw.adaptive_steps(600, auto=None)
        tw = carried(jw, function=models.lorder_mixed_bg, **common)
        name, kw = "x0", {"n_grid": 5, "multistart": 4, "n_steps": 120, "seed": 2}
    before = tw.state.position.clone()
    j, t = jfit.profile_likelihood(jw, name, **kw), tw.profile_likelihood(name, **kw)
    same(t.grid, j.grid, "grid", rtol=1e-12)
    same(t.profile_lp, j.profile_lp, "profile_lp")
    assert (t.lp_max, t.at_max) == pytest.approx((j.lp_max, j.at_max), rel=RTOL)
    same(t.ci(), j.ci())
    same(t.ci(0.68), j.ci(0.68))
    assert torch.equal(tw.state.position, before)
    if fit == "line":
        lo, hi, bl, bh = t.ci()
        assert bl and bh and lo < t.at_max < hi
        with pytest.raises(ValueError, match="unknown parameter"):
            tw.profile_likelihood("nope")


# ------------------------------------------------------------- refusals


def custom_walker():
    def one(theta, data):
        return -0.5 * torch.sum(theta * theta)
    return tfit.Walker([], tfit.ParamSpec(("a", "b")), np.zeros(2), n_walkers=8,
                       walker_jitter=0.1, log_posterior=one, dtype=torch.float64,
                       device="cpu")


def test_refusals(line_pair):
    tc = custom_walker()
    for fn in (td.waic, td.loo, td.loo_pit, td.prior_sensitivity):
        with pytest.raises(ValueError, match="custom posteriors"):
            fn(tc)
    for fn in (tpred.posterior_predictive, tpred.predict):
        args = (tc, [0.0]) if fn is tpred.predict else (tc,)
        with pytest.raises(ValueError, match="custom posteriors"):
            fn(*args)
    with pytest.raises(ValueError, match="refit-CV"):
        td._batched_refit(tc, "kfold", [np.ones(1, bool)], 10, 1.0, 4, 0.3, 16, 0)
    x, y = line_data()
    tb = tfit.BatchedFit(models.line, [(x, y), (x, y + 0.1)], {"m": 1.5, "b": 0.5},
                         data_error=0.3, walkers_per_dataset=8, dtype=torch.float64,
                         device="cpu")
    for fn in (td.waic, td.loo, td.loo_pit):
        with pytest.raises(ValueError, match="grouped/batched"):
            fn(tb)
    with pytest.raises(ValueError, match="grouped/batched"):
        tpred.posterior_predictive(tb)
    with pytest.raises(ValueError, match="grouped/aux"):
        tb.profile_likelihood("m")
    _, tw = line_pair
    with pytest.raises(ValueError, match="pass bounds= or prior="):
        tw.prior_predictive()
    with pytest.raises(ValueError, match="missing"):
        tw.prior_predictive(bounds={"m": (0.0, 1.0)})

    def ll(fn, params, dataset):
        return -0.5 * torch.sum((dataset.y - fn(dataset.x, params)) ** 2, dim=-1)
    tn = tfit.walker_create(function=models.line, data=(x, y), params={"m": 1.5, "b": 0.5},
                            log_likelihood=ll, n_walkers=8, walker_jitter=0.1,
                            dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="no noise model"):
        tn.posterior_predictive()
    with pytest.raises(ValueError, match="unrecognized likelihood"):
        td.waic(tn)
    with pytest.raises(ValueError, match="per-point form"):
        td.kfold(tn, k=2)
    with pytest.raises(ValueError, match="2 <= k"):
        td.kfold(tw, k=1)
    with pytest.raises(ValueError, match="shape"):
        td.kfold(tw, folds=[0, 1])


def test_audit_without_history_raises_in_both():
    """A history of one row (the live-state fallback) divides by zero in
    the split R-hat of both packages; the port copies the reference."""
    from lisp_mcmc_tpu.params import ParamSpec as JSpec

    def one(theta, data):
        return -0.5 * jnp.sum(theta * theta)

    jc = jfit.Walker([], JSpec(("a", "b")), np.zeros(2), n_walkers=8, walker_jitter=0.1,
                     log_posterior=one)
    for walker, audit in ((jc, jd.audit), (custom_walker(), td.audit)):
        with pytest.raises(ZeroDivisionError):
            audit(walker)
