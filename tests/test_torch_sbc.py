"""Simulation-based calibration of the PyTorch port against the JAX package.

``lisp_mcmc_torch.sbc`` against ``lisp_mcmc_tpu.sbc`` on the CPU:

- ``_bin_masses`` and ``_uniformity_pvalue`` equal to JAX's;
- ``_observation_model`` gives the same ``y`` for the Gaussian, Poisson,
  Student-t and noise-scale twins from the same numpy seed, and refuses a
  custom likelihood without a simulator, and a Gaussian without
  ``data_error``, with JAX's messages;
- ``sbc_check`` simulates the same study as JAX's from a seed: the truths,
  datasets and starting guesses it hands ``BatchedFit``;
- ``_rank_study`` on a JAX ``BatchedFit``'s state and history carried into
  the port (``convert.batched_from_numpy``): identical ranks, p-values and
  per-simulation gates;
- the port's own ``sbc_check``: a calibrated line study passes ``ok()``,
  an understated-noise control fails it, and too few retained draws raise.
"""

import warnings

import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import sbc as tsbc
from lisp_mcmc_torch.models import line as t_line
from lisp_mcmc_tpu import sbc as jsbc
from lisp_mcmc_tpu.models import line as j_line

from test_torch_batched import carry

X = np.linspace(0.0, 10.0, 40)
BOUNDS = {"m": (0.5, 3.0), "b": (-2.0, 2.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_bin_masses_and_uniformity_pvalue_match_jax():
    rng = np.random.default_rng(0)
    for n_draws, n_bins in ((63, 8), (63, 12), (99, 20), (10, 2)):
        te, tm = tsbc._bin_masses(n_draws, n_bins)
        je, jm = jsbc._bin_masses(n_draws, n_bins)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tm, jm)
        for ranks in (rng.integers(0, n_draws + 1, 200),
                      np.tile(np.arange(n_draws + 1), 5),
                      np.minimum(rng.integers(0, 3, 80), n_draws)):
            assert tsbc._uniformity_pvalue(ranks, n_draws, n_bins) == \
                jsbc._uniformity_pvalue(ranks, n_draws, n_bins)


TWINS = {
    "normal": ((None, None), 0.3),
    "cutoff": ((jfit.log_likelihood_normal_cutoff, tfit.log_likelihood_normal_cutoff), 0.3),
    "poisson": ((jfit.log_likelihood_poisson, tfit.log_likelihood_poisson), None),
    "student_t": ((jfit.make_student_t_likelihood(4.0), tfit.make_student_t_likelihood(4.0)),
                  0.5),
    "noise_scale": ((jfit.make_noise_scale_likelihood(), tfit.make_noise_scale_likelihood()),
                    0.5),
}


@pytest.mark.parametrize("kind", list(TWINS))
def test_observation_model_draws_the_same_y(kind):
    (jll, tll), err = TWINS[kind]
    mu = 3.0 + 0.5 * X
    p = {"m": 0.5, "b": 3.0, "noise_scale": 1.7}
    tdraw = tsbc._observation_model(None, tll, err, X)
    jdraw = jsbc._observation_model(None, jll, err, X)
    np.testing.assert_array_equal(tdraw(np.random.default_rng(3), mu, p),
                                  jdraw(np.random.default_rng(3), mu, p))


def test_observation_model_refusals_match_jax():
    def weird(fn, params, ds):
        return 0.0

    for args in ((None, weird, 0.5, X), (None, None, None, X)):
        with pytest.raises(ValueError) as te:
            tsbc._observation_model(*args)
        with pytest.raises(ValueError) as je:
            jsbc._observation_model(*args)
        assert str(te.value).replace("weird", "?") == str(je.value).replace("weird", "?")
    sim = tsbc._observation_model(lambda rng, mu: mu + 1.0, weird, None, X)
    np.testing.assert_array_equal(sim(None, X, {}), X + 1.0)


class _Captured(Exception):
    pass


def captured_study(monkeypatch, module, **kw):
    """The (datasets, guesses) ``sbc_check`` of ``module`` hands BatchedFit."""
    got = {}

    def record(function, datasets, params, *args, **kwargs):
        got["datasets"], got["guesses"] = datasets, params
        raise _Captured

    monkeypatch.setattr(module.batched, "BatchedFit", record)
    fn = t_line if module is tfit else j_line
    with pytest.raises(_Captured):
        module.sbc_check(fn, BOUNDS, X, 0.3, n_sims=5, seed=7, **kw)
    return got


def test_sbc_check_simulates_the_jax_study(monkeypatch):
    t = captured_study(monkeypatch, tfit, device="cpu")
    j = captured_study(monkeypatch, jfit)
    for (tx, ty), (jx, jy) in zip(t["datasets"], j["datasets"]):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_allclose(ty, np.asarray(jy), rtol=1e-15, atol=1e-15)
    assert t["guesses"] == j["guesses"]


def test_rank_study_matches_jax_on_the_jax_history():
    n_sims, B = 6, 16
    rng = np.random.default_rng(1)
    truths = np.column_stack([rng.uniform(0.5, 3.0, n_sims), rng.uniform(-2.0, 2.0, n_sims)])
    data = [(X, t_[1] + t_[0] * X + 0.3 * rng.standard_normal(X.size)) for t_ in truths]
    guesses = [{"m": 1.5, "b": 0.0}] * n_sims
    common = dict(data_error=0.3, walkers_per_dataset=B, seed=0, walker_jitter=0.05)
    jb = jfit.BatchedFit(j_line, data, guesses, log_prior=jfit.make_bounds_prior(BOUNDS),
                         **common)
    tb = tfit.BatchedFit(t_line, data, guesses, log_prior=tfit.make_bounds_prior(BOUNDS),
                         dtype=torch.float64, device="cpu", **common)
    jb.adaptive_steps(1200, temperature=2.0, auto=None)
    jb.burn_steps(600)
    carry(jb, tb)
    pos, lp = jb._history()
    tb._hist_positions, tb._hist_logprobs = [np.array(pos)], [np.array(lp)]
    keys = ("m", "b")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the per-simulation gate may warn
        t = tsbc._rank_study(tb, n_sims, B, truths, keys, 31, 4, "sbc_check")
        j = jsbc._rank_study(jb, n_sims, B, truths, keys, 31, 4, "sbc_check")
    np.testing.assert_array_equal(t.ranks, j.ranks)
    assert t.p_values == j.p_values
    np.testing.assert_array_equal(t.sim_ok, j.sim_ok)
    assert (t.n_draws, t.n_bins, t.keys, t.ok()) == (j.n_draws, j.n_bins, j.keys, j.ok())


def test_calibrated_study_passes_and_understated_noise_fails():
    kw = dict(n_sims=20, walkers_per_dataset=32, n_steps=1500, device="cpu")
    res = tfit.sbc_check(t_line, BOUNDS, X, 0.3, seed=0, **kw)
    assert res.ranks.shape == (20, 2) and res.n_bins == 4
    assert res.ranks.min() >= 0 and res.ranks.max() <= res.n_draws
    assert res.ok(), res.p_values
    lo = np.array([BOUNDS[k][0] for k in res.keys])
    hi = np.array([BOUNDS[k][1] for k in res.keys])
    assert np.all(res.true_params >= lo) and np.all(res.true_params <= hi)

    def sim(rng, mu):
        return mu + 0.3 * rng.standard_normal(mu.shape[0])

    bad = tfit.sbc_check(t_line, BOUNDS, X, 0.1, seed=1, simulate=sim, **kw)
    assert not bad.ok(), bad.p_values
    with pytest.raises(ValueError, match="n_draws"):
        tfit.sbc_check(t_line, BOUNDS, X, 0.3, n_sims=4, walkers_per_dataset=4,
                       n_steps=400, n_draws=100_000, seed=0, device="cpu")
