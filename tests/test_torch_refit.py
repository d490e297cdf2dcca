"""Refit cross-validation and the batched per-dataset verbs of the PyTorch
port against the JAX package, float64 on the CPU.

- ``_global_batched_refit``: the K leave-out blocks' batched posterior
  and one walker's (the per-walker aux form) on the JAX refit's own
  positions, at rtol 1e-12, on a line and on a two-term global fit; its
  ``score_block`` on the JAX refit's history (installed through
  ``diagnostics._run_refit``) at 1e-12; ``grouped_refit_health``'s
  verdicts, and a frozen block failing it;
- ``kfold``'s and ``reloo``'s elpd arithmetic on the JAX refit's history
  at 1e-10;
- a short ``kfold`` end to end on the port's own draws, within 2 x
  max(se, 1) of the JAX kfold (JAX tests/test_kfold.py:38), its refits
  on the plain posterior (no kernel coverage: per-walker aux);
- ``BatchedFit``'s per-dataset verbs (``waic_``, ``loo_``, ``loo_pit_``,
  ``prior_sensitivity_``, ``audit_``, ``posterior_predictive_per_dataset``
  with the JAX draws injected) against ``lisp_mcmc_tpu.BatchedFit``'s on
  the JAX batch's state and history, at 1e-10 (the sensitivity indices,
  distances in [0, 1] whose formula cancels to second order near uniform
  weights, at 1e-10 absolute).
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
from lisp_mcmc_torch.ops.loglik_kernel import kernel_coverage
from lisp_mcmc_tpu import diagnostics as jd
from lisp_mcmc_tpu.models import zoo as jzoo

from test_torch_batched import carry
from test_torch_criticism import fitted, line_data, same

RTOL = 1e-10
REFIT = dict(n_steps=400, temperature=4.0, walkers_per_dataset=16, burn_fraction=0.33,
             max_samples=64, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def kfold_holdouts(n, k, seed=0):
    """kfold's seeded round-robin folds and their keep-masks."""
    folds = np.empty(n, np.int64)
    folds[np.random.default_rng(seed).permutation(n)] = np.arange(n) % k
    return folds, [folds != j for j in range(k)]


def install(monkeypatch, jrefit):
    """``diagnostics._run_refit`` installing the JAX refit's history."""
    pos, lp = jrefit._history()

    def run(fit, n_steps, temperature, burn_fraction):
        fit._hist_positions, fit._hist_logprobs = [np.array(pos)], [np.array(lp)]

    monkeypatch.setattr(td, "_run_refit", run)


@pytest.fixture(scope="module", params=["normal", "global"])
def refit_pair(request):
    """A JAX fit and its port twin, and the JAX 3-fold refit of it."""
    jw, tw = fitted(request.param, steps=1600)
    n = td._refit_n_points(tw)
    folds, holdouts = kfold_holdouts(n, 3)
    jref, jscore = jd._batched_refit(jw, "kfold", holdouts, **REFIT)
    return jw, tw, folds, holdouts, jref, jscore


def test_global_batched_refit_blocks_and_scores_match_jax(refit_pair):
    jw, tw, folds, holdouts, jref, jscore = refit_pair
    mp = pytest.MonkeyPatch()
    try:
        install(mp, jref)
        tref, tscore = td._batched_refit(tw, "kfold", holdouts, **REFIT)
    finally:
        mp.undo()
    pos, _ = jref._history()
    rows = np.concatenate([pos[0], pos[-1]])                    # (2 K B, d)
    for r in (rows[: len(rows) // 2], rows[len(rows) // 2:]):
        got = tref._custom_batched(torch.as_tensor(r), tref._posterior_data())
        want = jref._custom_batched(jnp.asarray(r), jref._posterior_data())
        same(got.numpy(), np.asarray(want), "block posteriors", rtol=1e-12)
    for w in (0, 17, 47):
        got = tref._custom_log_post(torch.as_tensor(rows[w]), torch.tensor(w // 16),
                                    tref._posterior_data())
        want = jref._custom_log_post(jnp.asarray(rows[w]), w // 16, jref._posterior_data())
        assert float(got) == pytest.approx(float(want), rel=1e-12)
    for j in range(3):
        same(tscore(j), jscore(j), f"score_block({j})", rtol=1e-12)
    np.testing.assert_array_equal(td.grouped_refit_health(tref, "t", warn=False),
                                  jd.grouped_refit_health(jref, "t", warn=False))
    assert tref.n_groups == 3 and tref.config.history_walkers == 4096
    assert "aux" in kernel_coverage(tref.terms, tref.spec, tref.aux)
    with pytest.raises(ValueError, match="aux"):
        tref._refuse_custom("kernel")
    # a frozen block fails the collapse gate
    frozen = np.array(pos)
    frozen[:, :16] = frozen[:1, :16]
    tref._hist_positions = [frozen]
    with pytest.warns(UserWarning, match="collapse gate"):
        ok = td.grouped_refit_health(tref, "frozen")
    assert not ok[0]


def test_kfold_and_reloo_arithmetic_match_jax(refit_pair, monkeypatch):
    jw, tw, folds, holdouts, jref, jscore = refit_pair
    monkeypatch.setattr(jd, "_batched_refit", lambda *a, **k: (jref, jscore))
    kw = {k: v for k, v in REFIT.items()}
    j = jd.kfold(jw, k=3, **kw)
    install(monkeypatch, jref)
    t = td.kfold(tw, k=3, **kw)
    np.testing.assert_array_equal(t.folds, j.folds)
    np.testing.assert_array_equal(t.fold_ok, j.fold_ok)
    for f in ("elpd", "se", "pointwise", "n_points", "n_samples", "k"):
        same(getattr(t, f), getattr(j, f), f)
    # reloo on the refit's history: the first points of each fold flagged,
    # their exact scores from blocks of the same kind
    loo_t, loo_j = td.loo(tw), jd.loo(jw)
    flagged = [int(np.flatnonzero(folds == f)[0]) for f in range(3)]
    k_hi = np.zeros(loo_t.n_points)
    k_hi[flagged] = 1.0
    res_t = td.LOOResult(**{**loo_t.__dict__, "pareto_k": k_hi})
    res_j = jd.LOOResult(**{**loo_j.__dict__, "pareto_k": k_hi})
    monkeypatch.setattr(jd, "_batched_refit", lambda *a, **k: (jref, jscore))
    j = jd.reloo(jw, res_j, **kw)
    t = td.reloo(tw, res_t, **kw)
    for f in ("elpd", "p_loo", "lppd", "se", "pointwise", "pareto_k"):
        same(getattr(t, f), getattr(j, f), f)
    assert t.refit_failed == j.refit_failed
    with pytest.raises(ValueError, match="max_refits"):
        td.reloo(tw, res_t, max_refits=2)
    assert td.reloo(tw, loo_t, k_threshold=1e9) is loo_t


def test_short_kfold_end_to_end_agrees_with_jax(refit_pair):
    jw, tw, *_ = refit_pair
    kw = dict(REFIT, max_samples=256)
    j = jd.kfold(jw, k=3, **kw)
    t = td.kfold(tw, k=3, **kw)
    assert np.isfinite(t.pointwise).all() and t.fold_ok.shape == (3,)
    assert abs(t.elpd - j.elpd) <= 2.0 * max(j.se, 1.0)


# ------------------------------------------------ batched per-dataset verbs


@pytest.fixture(scope="module")
def batch_pair():
    x, y = line_data(0, n=40)
    data = [(x, y), (x, line_data(1, n=40)[1] + 0.5)]
    kw = dict(data_error=[0.3, 0.4], walkers_per_dataset=16, seed=0, walker_jitter=0.05)
    spec = {"m": (1.8, 0.3), "b": (1.0, 2.0)}
    jb = jfit.BatchedFit(jzoo.line, data, {"m": 1.8, "b": 0.8},
                         log_prior=jfit.PriorSpec({k: jfit.Gaussian(*v)
                                                   for k, v in spec.items()}), **kw)
    tb = tfit.BatchedFit(models.line, data, {"m": 1.8, "b": 0.8},
                         log_prior=tfit.PriorSpec({k: tfit.Gaussian(*v)
                                                   for k, v in spec.items()}),
                         dtype=torch.float64, device="cpu", **kw)
    jb.adaptive_steps(2000, auto=None)
    jb.burn_steps(1000)
    carry(jb, tb)
    pos, lp = jb._history()
    tb._hist_positions, tb._hist_logprobs = [np.array(pos)], [np.array(lp)]
    return jb, tb


def test_batched_per_dataset_verbs_match_jax(batch_pair, monkeypatch):
    jb, tb = batch_pair
    for name, fields in (("waic", ("elpd", "p_waic", "se", "pointwise")),
                         ("loo", ("elpd", "p_loo", "se", "pointwise", "pareto_k")),
                         ("loo_pit", ("pit", "ks_stat", "p_value", "pareto_k"))):
        jr = getattr(jb, f"{name}_per_dataset")(max_samples=128)
        tr = getattr(tb, f"{name}_per_dataset")(max_samples=128)
        assert len(tr) == len(jr) == 2
        for a, b in zip(tr, jr):
            for f in fields:
                same(getattr(a, f), getattr(b, f), f"{name}.{f}")
    for a, b in zip(tb.prior_sensitivity_per_dataset(max_samples=256),
                    jb.prior_sensitivity_per_dataset(max_samples=256)):
        assert a.diagnosis == b.diagnosis
        for k in b.prior:
            # distances in [0, 1] whose formula cancels to second order
            # where the weights are nearly uniform: held at 1e-10 absolute
            np.testing.assert_allclose([a.prior[k], a.likelihood[k]],
                                       [b.prior[k], b.likelihood[k]], rtol=0, atol=1e-10)
    for a, b in zip(tb.audit_per_dataset(max_samples=128),
                    jb.audit_per_dataset(max_samples=128)):
        assert (a.ok, a.advice, a.skipped) == (b.ok, b.advice, b.skipped)
    widths = [int(d.x.shape[0]) for d in jb._datasets]
    calls = []

    def normal(generator, shape, dtype, device):
        # each dataset's view starts the JAX stream from PRNGKey(seed)
        _, k = jax.random.split(jax.random.PRNGKey(4))
        full = (shape[0], widths[len(calls)])
        calls.append(shape)
        return torch.as_tensor(np.array(jax.random.normal(k, full, jnp.float64))[:, :shape[1]],
                               dtype=dtype)

    monkeypatch.setattr(tpred, "_normal", normal)
    jd_ = jb.posterior_predictive_per_dataset(seed=4, max_samples=64)
    td_ = tb.posterior_predictive_per_dataset(seed=4, max_samples=64)
    for a, b in zip(td_, jd_):
        for f in ("y_obs", "mu", "y_rep"):
            same(getattr(a, f), getattr(b, f), f, rtol=1e-12)
    # the view: each dataset's own walker block, through the retained subsample
    v = tb.dataset_view(1)
    assert v.device == tb.device and v.group_ids is None
    same(v.steps()[0], jb.dataset_view(1).steps()[0])
