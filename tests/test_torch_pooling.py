"""The port's ``compare_pooling`` on the regimes of tests/test_pooling.py.

The three planted truths of the JAX test run on the port at that file's
sizes (6 x 12, 4 x 12 and 16 x 4 points; 4000 anneal steps, 128 walkers,
32 a dataset, 192 LOO draws, seed 0) with its gates unchanged: identical
truths, pooling wins; heterogeneous truths beyond the declared
population, independence wins; the eight-schools grid, partial pooling
wins.  The port draws its own chains (a ``torch.Generator``), so the
verdicts, not the numbers, are JAX's.  ``_combined_loo`` is held against
JAX's on a JAX batch's state and history carried over (rtol 1e-8), and
the validation matches JAX's.
"""

import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import pooling as tpool
from lisp_mcmc_torch.convert import batched_from_numpy
from lisp_mcmc_torch.priors import Gaussian, LogNormal
from lisp_mcmc_tpu import pooling as jpool

STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def const_model(x, p):
    return p["c"] + 0.0 * x


X12 = np.linspace(0.0, 1.0, 12)


def _grids(cs, sigma, n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n)
    return [(x, c + sigma * rng.standard_normal(n)) for c in cs]


WIDE_HYPER = {"c": (Gaussian(1.0, 2.0), LogNormal(np.log(0.5), 0.7))}


def _run(datasets, sigma, hyper=WIDE_HYPER, **kw):
    return tfit.compare_pooling(
        const_model, datasets, {"c": 1.0}, data_error=sigma,
        hyper=hyper, n_steps=4000, n_walkers=128,
        walkers_per_dataset=32, max_samples=192, seed=0,
        dtype=torch.float64, device="cpu", **kw)


def test_identical_truth_pooling_wins():
    ds = _grids([1.0] * 6, sigma=0.3, n=12, seed=1)
    r = _run(ds, 0.3)
    assert r.elpd["pooled"] > r.elpd["independent"]
    assert r.best in ("pooled", "partial")
    assert r.weights["independent"] < 0.6
    assert {k: v.n_points for k, v in r.results.items()} == \
        {"pooled": 72, "partial": 72, "independent": 72}
    assert sum(r.weights.values()) == pytest.approx(1.0, abs=1e-6)
    # the fits come back fitted, each the class its regime names
    assert isinstance(r.fits["partial"], tfit.HierarchicalFit)
    assert isinstance(r.fits["independent"], tfit.BatchedFit)
    assert len(r.fits["pooled"].terms) == 6
    assert set(r.pairwise) == {"pooled_vs_partial", "pooled_vs_independent",
                               "partial_vs_independent"}
    assert repr(r).startswith("PoolingComparison(best=")
    # the port's addition: each model's seconds from its build to its score
    assert set(r.seconds) == set(r.elpd) and all(v > 0.0 for v in r.seconds.values())


def test_heterogeneous_truth_independent_wins():
    tight = {"c": (Gaussian(0.0, 5.0), LogNormal(np.log(0.2), 0.2))}
    ds = _grids([-4.0, -1.0, 2.0, 5.0], sigma=0.3, n=12, seed=2)
    r = _run(ds, 0.3, hyper=tight)
    assert r.best == "independent"
    assert r.elpd["pooled"] < r.elpd["independent"] - 10.0
    assert r.elpd["partial"] < r.elpd["independent"]


def test_eight_schools_partial_wins():
    rng = np.random.default_rng(11)
    cs = 1.0 + 1.0 * rng.standard_normal(16)
    x = np.linspace(0.0, 1.0, 4)
    ds = [(x, c + 1.0 * rng.standard_normal(4)) for c in cs]
    r = _run(ds, 1.0,
             hyper={"c": (Gaussian(1.0, 2.0), LogNormal(np.log(0.7), 0.7))})
    assert r.best == "partial"
    assert r.elpd["partial"] > r.elpd["pooled"] + 2.0
    assert r.elpd["partial"] >= r.elpd["independent"]


def test_validation():
    for mod, kw in ((jfit, {}), (tfit, {"device": "cpu"})):
        with pytest.raises(ValueError, match=">= 2 datasets"):
            mod.compare_pooling(const_model, [(X12, X12)], {"c": 1.0}, data_error=0.3,
                                **kw)


def test_combined_loo_matches_jax():
    """A JAX batch annealed and sampled cold, its state and history carried
    into the port's batch: the dataset-major LOO equals JAX's."""
    ds = _grids([0.5, 1.0, 1.5], sigma=0.3, n=12, seed=4)
    kw = dict(data_error=0.3, walkers_per_dataset=16, seed=0)
    jb = jfit.BatchedFit(const_model, ds, {"c": 1.0}, **kw)
    tb = tfit.BatchedFit(const_model, ds, {"c": 1.0}, dtype=torch.float64, device="cpu",
                         **kw)
    jpool._anneal_then_cold_sample(jb, 1000, 0.5)
    a = {k: np.asarray(getattr(jb.state, k)) for k in STATE_KEYS}
    a["group_ids"] = np.asarray(jb.group_ids)
    batched_from_numpy(tb, a)
    pos, lp = jb._history()
    tb._hist_positions, tb._hist_logprobs = [np.array(pos)], [np.array(lp)]
    t, j = tpool._combined_loo(tb, 96), jpool._combined_loo(jb, 96)
    for f in ("elpd", "p_loo", "lppd", "se", "pointwise", "pareto_k"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-8, atol=1e-12,
                                   err_msg=f)
    assert (t.n_points, t.n_samples) == (j.n_points, j.n_samples) == (36, 96)
