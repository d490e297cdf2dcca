"""``sbc_check_hierarchical`` of the port against the JAX package's (JAX
tests/test_sbc_hierarchical.py), float64 on the CPU, at small sizes:

- from one seed both packages draw the same walk-space truths (bit for
  bit), decode them alike (1e-12), simulate the same data (the model's
  rounding: 1e-12) and draw the same starts (bit for bit), for a pooled
  constant, a non-pooled local with per-dataset errors, and a correlated
  population; the grouped walker's posterior equals JAX's at the starts;
- an incomplete prior is refused with JAX's message;
- ``_rank_study`` on one injected history gives JAX's ranks, p-values and
  per-simulation gate;
- a short study runs end to end through the port's grouped joint walker.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import hierarchical as th
from lisp_mcmc_torch import sbc as tsbc
from lisp_mcmc_tpu import hierarchical as jh
from lisp_mcmc_tpu import sbc as jsbc

X = np.linspace(0.0, 1.0, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def const_model(x, p):
    return p["c"] + 0.0 * x


def line2(x, p):
    return p["c"] + p["b"] * x


def case(name, M):
    """(function, params, n_datasets, kwargs) of study ``name`` in package M."""
    hyper_c = (M.Gaussian(0.0, 1.0), M.LogNormal(np.log(0.5), 0.4))
    if name == "const":
        return const_model, {"c": 0.0}, 4, dict(data_error=0.5, hyper={"c": hyper_c})
    if name == "local":
        return line2, {"c": 0.0, "b": 1.0}, 3, dict(
            data_error=[0.5, 0.4, 0.3], hyper={"c": hyper_c}, pooled=["c"],
            local_priors={"b": M.Gaussian(1.0, 0.5)})
    return line2, {"c": 0.0, "b": 1.0}, 3, dict(
        data_error=0.5, correlation="full",
        hyper={"c": hyper_c, "b": (M.Gaussian(1.0, 1.0), M.LogNormal(np.log(0.3), 0.4))})


class _Stop(Exception):
    pass


def capture(monkeypatch, cls, store):
    """Keep the grouped walker's data and starts, then stop the study."""
    orig = cls._grouped_joint_walker

    def wrapped(self, refit_data, K, B, seed, pos0, config=None):
        store.update(template=self, data=refit_data, pos0=np.array(pos0),
                     fit=orig(self, refit_data, K, B, seed, pos0, config))
        raise _Stop

    monkeypatch.setattr(cls, "_grouped_joint_walker", wrapped)


def studies(name, monkeypatch, n_sims=10, B=4, seed=3):
    js, ts = {}, {}
    capture(monkeypatch, jh.HierarchicalFit, js)
    capture(monkeypatch, th.HierarchicalFit, ts)
    for M, run, store, extra in (
            (jfit, jsbc.sbc_check_hierarchical, js, {}),
            (tfit, tsbc.sbc_check_hierarchical, ts,
             dict(dtype=torch.float64, device="cpu"))):
        fn, params, S, kw = case(name, M)
        with pytest.raises(_Stop):
            run(fn, X, params, S, n_sims=n_sims, walkers_per_sim=B, seed=seed, **kw,
                **extra)
    monkeypatch.undo()
    return js, ts


@pytest.mark.parametrize("name", ["const", "local", "full"])
def test_simulated_study_matches_jax(name, monkeypatch):
    js, ts = studies(name, monkeypatch)
    jt, tt = js["template"], ts["template"]
    keys = tt.spec.keys
    assert keys == jt.spec.keys
    truths_t = tt.prior_spec.sample(np.random.default_rng(3), 10, keys)
    truths_j = jt.prior_spec.sample(np.random.default_rng(3), 10, keys)
    np.testing.assert_array_equal(np.asarray(truths_t), np.asarray(truths_j))
    np.testing.assert_allclose(tt._decode_np(np.asarray(truths_t, np.float64)),
                               jt._decode_np(np.asarray(truths_j, np.float64)), rtol=1e-12)
    y_j = np.asarray(js["data"]["ds"].y)                    # (n_sims, S, N)
    y_t = ts["data"]["ds"]["y"].numpy()
    np.testing.assert_allclose(y_t, y_j[..., :y_t.shape[-1]], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ts["pos0"], js["pos0"])
    sig_j = np.asarray(js["data"]["ds"].sigma)[..., :y_t.shape[-1]]
    np.testing.assert_array_equal(ts["data"]["ds"]["sigma"].numpy(), sig_j)
    jf, tf = js["fit"], ts["fit"]
    assert tf.n_groups == 10 and tf.n_walkers == 40
    pos = ts["pos0"]
    np.testing.assert_allclose(
        tf._custom_batched(torch.as_tensor(pos), tf._posterior_data()).numpy(),
        np.asarray(jf._custom_batched(jnp.asarray(pos), jf._posterior_data())), rtol=1e-10)


def test_incomplete_prior_is_refused_as_in_jax():
    msgs = []
    for M, run, extra in ((jfit, jsbc.sbc_check_hierarchical, {}),
                          (tfit, tsbc.sbc_check_hierarchical,
                           dict(dtype=torch.float64, device="cpu"))):
        with pytest.raises(ValueError) as e:
            run(line2, X, {"c": 0.0, "b": 1.0}, 3, data_error=0.5,
                hyper={"c": (M.Gaussian(0.0, 1.0), M.LogNormal(np.log(0.5), 0.4))},
                pooled=["c"], n_sims=10, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "local_priors" in msgs[0]


def test_rank_study_on_an_injected_history(monkeypatch):
    js, ts = studies("const", monkeypatch)
    keys = ts["template"].spec.keys
    truths = ts["template"].prior_spec.sample(np.random.default_rng(3), 10, keys)
    rng = np.random.default_rng(7)
    hist = rng.standard_normal((40, 40, len(keys))) * 0.5
    hist[:, 4:8] = hist[:1, 4:8]                    # simulation 1 frozen
    lp = rng.standard_normal((40, 40))
    for f in (js["fit"], ts["fit"]):
        f._hist_positions, f._hist_logprobs = [hist.copy()], [lp.copy()]
    with pytest.warns(UserWarning, match="collapse gate"):
        rt = tsbc._rank_study(ts["fit"], 10, 4, truths, keys, 63, 2, "t")
    with pytest.warns(UserWarning, match="collapse gate"):
        rj = jsbc._rank_study(js["fit"], 10, 4, truths, keys, 63, 2, "t")
    np.testing.assert_array_equal(rt.ranks, rj.ranks)
    np.testing.assert_array_equal(rt.sim_ok, rj.sim_ok)
    assert not rt.sim_ok[1]
    for k in keys:
        assert rt.p_values[k] == pytest.approx(rj.p_values[k], rel=1e-12)
    with pytest.raises(ValueError, match="retained draws"):
        tsbc._rank_study(ts["fit"], 10, 1, truths, keys, 63, 2, "t")


def test_short_study_runs_end_to_end():
    fn, params, S, kw = case("const", tfit)
    r = tsbc.sbc_check_hierarchical(fn, X, params, S, n_sims=6, walkers_per_sim=8,
                                    n_steps=400, n_draws=15, seed=0, dtype=torch.float64,
                                    device="cpu", **kw)
    assert r.ranks.shape == (6, 6) and set(r.keys) == {
        "c__mu", "c__tau", "c__z0", "c__z1", "c__z2", "c__z3"}
    assert r.ranks.min() >= 0 and r.ranks.max() <= 15
    assert isinstance(r, tfit.SBCResult) and r.sim_ok.shape == (6,)
    assert dataclasses.is_dataclass(r)
