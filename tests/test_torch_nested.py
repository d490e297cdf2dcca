"""Nested sampling of the PyTorch port against the JAX package.

``lisp_mcmc_torch.nested`` against ``lisp_mcmc_tpu.nested``, float64 on
the CPU:

- ``nested_sample`` round for round with the JAX package's draws (each
  round's clone picks, donor pairs and step factors from its key stream)
  replayed through ``nested._draws``: the dead points, ``logl``,
  ``log_z``, ``h``, the weights, ``ess``, ``n_iter`` and ``insertion_p``
  at rtol 1e-10, on a box prior and on a named prior (the unit-cube
  route);
- ``nested_per_dataset`` the same way on a batch of 3 lines;
- the insertion ranks by ``torch.searchsorted`` equal to the JAX
  package's ``sum(surv_lp < lp)``, ties included (integers, the
  non-finite floor, float32);
- the port's own draws: the analytic Gaussian evidence (JAX
  tests/test_nested.py:61-69's 4-sigma form), a conjugate named prior,
  ``synthetic.line_evidence_batch``'s closed forms within max(0.25, 4
  sigma);
- the guards and ``on_round``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import models, synthetic
from lisp_mcmc_torch import nested as tn
from lisp_mcmc_torch.kernel import _neg_floor
from lisp_mcmc_tpu.models import zoo as jzoo

from test_torch_evidence import gaussian_pair

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def replay(monkeypatch, seed, n_sets=None):
    """``nested._draws`` returning the JAX package's draws of each round
    from ``PRNGKey(seed)`` (JAX nested.py:306-325 and 379; per dataset,
    :614-616's ``split(sub, S)``)."""
    box = {"key": jax.random.PRNGKey(seed)}

    def one_set(sub, n_live, k, n_repeat):
        k_clone, k_scan = jax.random.split(sub)
        clone = jax.random.randint(k_clone, (k,), 0, n_live - k)
        js, us = [], []
        for kk in jax.random.split(k_scan, n_repeat):
            kj, kg, _ = jax.random.split(kk, 3)
            js.append(jax.random.randint(kj, (k, 2), 0,
                                         jnp.asarray([n_live - k, n_live - k - 1])))
            us.append(jax.random.uniform(kg, (k,), jnp.float64, 0.5, 1.5))
        return np.array(clone), np.stack(js), np.stack(us)

    def draws(generator, lead, n_live, k_batch, n_repeat, dtype, device):
        box["key"], sub = jax.random.split(box["key"])
        subs = [sub] if n_sets is None else list(jax.random.split(sub, n_sets))
        assert tuple(lead) == (len(subs),)
        parts = [one_set(s, n_live, k_batch, n_repeat) for s in subs]
        return {"clone": torch.as_tensor(np.stack([p[0] for p in parts])),
                "j": torch.as_tensor(np.stack([p[1] for p in parts], axis=1)),
                "u": torch.as_tensor(np.stack([p[2] for p in parts], axis=1), dtype=dtype)}

    monkeypatch.setattr(tn, "_draws", draws)


def same_run(t, j):
    assert t.n_iter == j.n_iter
    for f in ("samples", "logl", "log_weights"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=RTOL, atol=1e-12,
                                   err_msg=f)
    for f in ("log_z", "log_z_err", "h", "ess", "logl_max", "insertion_p"):
        assert getattr(t, f) == pytest.approx(getattr(j, f), rel=RTOL, abs=1e-12), f
    np.testing.assert_allclose(t.posterior_draws(200, seed=1), j.posterior_draws(200, seed=1),
                               rtol=RTOL)


def test_nested_sample_matches_jax_round_for_round(monkeypatch):
    jw, tw, bounds = gaussian_pair(2, 0.5, 4.0, n_walkers=16)
    kw = dict(n_live=256, seed=3)
    rounds = []
    j = jfit.nested_sample(jw, bounds, **kw)
    replay(monkeypatch, 3)
    t = tw.nested_sample(bounds, on_round=lambda info: rounds.append(info) and False, **kw)
    same_run(t, j)
    assert len(rounds) == t.n_iter and rounds[-1]["round"] == t.n_iter
    assert t.log_z == pytest.approx(-2.0 * math.log(8.0), abs=4 * t.log_z_err)


PRIOR = {"p0": (0.3, 0.6), "p1": (-0.2, 0.8)}    # (mu, tau) of each Gaussian


def test_nested_sample_named_prior_matches_jax(monkeypatch):
    """The unit-cube route on a fit whose prior is a ``PriorSpec``: theta =
    F^-1(u), the posterior less the installed prior plus the cube's wall;
    samples in theta."""
    jspec = jfit.PriorSpec({k: jfit.Gaussian(*v) for k, v in PRIOR.items()})
    tspec = tfit.PriorSpec({k: tfit.Gaussian(*v) for k, v in PRIOR.items()})
    const = -math.log(2.0 * math.pi * 0.25)

    def j_ll(fn, params, dataset):
        return -2.0 * (params["p0"] ** 2 + params["p1"] ** 2) + const

    def t_ll(fn, params, dataset):
        return (-2.0 * (params["p0"] ** 2 + params["p1"] ** 2) + const).reshape(-1)

    kw = dict(data=([0.0, 1.0], [0.0, 0.0]), params={"p0": 0.1, "p1": 0.1}, n_walkers=16,
              walker_jitter=0.3)
    jw = jfit.walker_create(function=lambda x, p: jnp.zeros_like(x), log_likelihood=j_ll,
                            log_prior=jspec, **kw)
    tw = tfit.walker_create(function=lambda x, p: torch.zeros_like(x), log_likelihood=t_ll,
                            log_prior=tspec, dtype=torch.float64, device="cpu", **kw)
    run = dict(n_live=200, k_batch=40, n_repeat=20, seed=1)
    j = jfit.nested_sample(jw, **run)
    replay(monkeypatch, 1)
    t = tn.nested_sample(tw, **run)
    same_run(t, j)
    # the likelihood N(0, 0.25 I) against the prior: the conjugate
    # evidence, a product of N(0; mu, 0.25 + tau^2)
    exact = sum(-0.5 * math.log(2 * math.pi * (0.25 + tau ** 2)) - 0.5 * mu ** 2
                / (0.25 + tau ** 2) for mu, tau in PRIOR.values())
    assert t.log_z == pytest.approx(exact, abs=max(0.25, 4 * t.log_z_err))


def batch_pair(n_sets=3, n=60):
    case = synthetic.line_evidence_batch(n_sets, n=n)
    kw = dict(data_error=case["sigma"], walkers_per_dataset=8, seed=0, walker_jitter=0.05)
    jb = jfit.BatchedFit(jzoo.line, case["datasets"], case["truth"],
                         log_prior=jfit.make_bounds_prior(case["bounds"]), **kw)
    tb = tfit.BatchedFit(models.line, case["datasets"], case["truth"],
                         log_prior=tfit.make_bounds_prior(case["bounds"]),
                         dtype=torch.float64, device="cpu", **kw)
    return jb, tb, case


def test_nested_per_dataset_matches_jax(monkeypatch):
    jb, tb, case = batch_pair()
    kw = dict(n_live=256, seed=2)
    j = jfit.nested_per_dataset(jb, **kw)
    replay(monkeypatch, 2, n_sets=3)
    seen = []
    t = tb.nested_per_dataset(on_round=lambda info: seen.append(info["done"].copy()) and False,
                              **kw)
    assert len(t) == 3
    for a, b, exact in zip(t, j, case["log_z"]):
        same_run(a, b)
        assert a.log_z == pytest.approx(exact, abs=max(0.25, 4 * a.log_z_err))
    assert seen[-1].all() and len(seen) == max(r.n_iter for r in t)
    # each dataset closed on its own criterion
    assert [r.n_iter for r in t] == [int(np.argmax([d[s] for d in seen])) + 1
                                     for s in range(3)]


def test_nested_per_dataset_own_draws_closed_form():
    _, tb, case = batch_pair(n_sets=4, n=334)
    res = tb.nested_per_dataset(n_live=512)
    for r, exact in zip(res, case["log_z"]):
        assert r.log_z_err < 0.2
        assert r.log_z == pytest.approx(exact, abs=max(0.25, 4 * r.log_z_err))
        assert np.isfinite(r.samples).all() and r.samples.shape[1] == 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_insertion_ranks_match_the_jax_comparison(dtype):
    rng = np.random.default_rng(0)
    floor = float(_neg_floor(dtype))
    for lo, hi, n_surv, k in ((0, 20, 300, 100), (0, 3, 50, 40), (-1e3, 1e3, 999, 333)):
        surv = np.sort(rng.integers(lo, hi, n_surv).astype(np.float64))
        surv[: n_surv // 10] = floor
        lp = rng.integers(lo - 2, hi + 2, k).astype(np.float64)
        lp[:5] = floor
        lp[5:10] = surv[-5:]
        sj, lj = jnp.asarray(surv, jnp.float64), jnp.asarray(lp, jnp.float64)
        ref = np.asarray(jnp.sum(sj[None, :] < lj[:, None], axis=1))
        got = tn._insertion_ranks(torch.as_tensor(surv, dtype=dtype)[None],
                                  torch.as_tensor(lp, dtype=dtype)[None])[0]
        np.testing.assert_array_equal(got.numpy(), ref)


def test_nested_guards():
    jw, tw, bounds = gaussian_pair(2, 0.5, 4.0, n_walkers=16)
    with pytest.raises(ValueError, match="k_batch"):
        tw.nested_sample(bounds, n_live=64, k_batch=40)
    with pytest.raises(ValueError, match="donors"):
        tw.nested_sample(bounds, n_live=6, k_batch=3)
    with pytest.raises(ValueError, match="missing"):
        tw.nested_sample({"p0": (0.0, 1.0)})
    with pytest.raises(ValueError, match="pass bounds= or prior="):
        tfit.walker_create(function=models.line, data=([0.0, 1.0], [0.0, 1.0]),
                           params={"m": 1.0, "b": 0.0}, device="cpu").nested_sample()
    _, tb, _ = batch_pair()
    with pytest.raises(ValueError, match="nested_per_dataset"):
        tb.nested_sample()
    with pytest.raises(ValueError, match="grouped/batched"):
        tn.nested_per_dataset(tw, bounds)
    # an early close from on_round is a valid, less converged estimate
    r = tw.nested_sample(bounds, n_live=128, on_round=lambda info: info["round"] >= 3)
    assert r.n_iter == 3 and np.isfinite(r.log_z) and len(r.logl) == 3 * 32 + 128
