"""``nv.HierarchicalNVFit`` of the port against the JAX package's (JAX
tests/test_nv_pipeline.py:215-260), float64 on the CPU: the two-spectra
and shared-grid guards (JAX's messages), the overrides merging onto the
physics boxes key by key, ``pooled=None``, ``correlation="full"``, the
block proposal from walk dimension 96, and construction and the log
posterior against JAX at the same walk vectors (the start within 2 ulp,
ROADMAP Queue 3 item 9; the posterior at 1e-10), with the per-spectrum
accessors on one carried state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lisp_mcmc_torch import nv as tnv
from lisp_mcmc_torch import priors as tpriors
from lisp_mcmc_torch import synthetic
from lisp_mcmc_torch.convert import hierarchical_from_numpy
from lisp_mcmc_tpu import nv as jnv
from lisp_mcmc_tpu import priors as jpriors

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flat_spectra(S=3, seed=0):
    x = np.linspace(2840.0, 2900.0, 64)
    rng = np.random.default_rng(seed)
    return [(x, 1e-4 + 1e-6 * rng.standard_normal(64)) for _ in range(S)]


def grid_spectra(rows, cols):
    x, ys, _ = synthetic.nv_scan_grid(rows, cols)
    return [(x, y) for y in ys]


def test_guards_match_jax():
    x = np.linspace(2840.0, 2900.0, 32)
    x2 = np.linspace(2840.0, 2900.0, 16)
    for bad, match in (([(x, np.ones(32))], "2 spectra"),
                       ([(x, np.ones(32)), (x2, np.ones(16))], "shared frequency grid")):
        msgs = []
        for cls, kw in ((jnv.HierarchicalNVFit, {}), (tnv.HierarchicalNVFit, F64)):
            with pytest.raises(ValueError, match=match) as e:
                cls(bad, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def within_ulps(a, b, n=2):
    """|a - b| within n ulp of the larger magnitude, elementwise."""
    a, b = np.asarray(a), np.asarray(b)
    assert np.all(np.abs(a - b) <= n * np.spacing(np.maximum(np.abs(a), np.abs(b))))


def dist_meta(spec):
    return {k: spec[k].to_meta() for k in spec}


@pytest.mark.parametrize("kw", [
    dict(local_priors={"mu1": "u"}),
    dict(hyper={"sigma": ("u", "ln")}),
    dict(pooled=None),
    dict(correlation="full"),
], ids=["local_override", "hyper_override", "pool_all", "full"])
def test_construction_and_overrides_match_jax(kw):
    """The overrides merge onto the boxes per key, so the prior stays
    complete; every distribution equals JAX's; the start and the posterior
    agree."""
    def resolve(M, kw):
        out = dict(kw)
        if "local_priors" in kw:
            out["local_priors"] = {"mu1": M.Uniform(2855.0, 2865.0)}
        if "hyper" in kw:
            out["hyper"] = {"sigma": (M.Uniform(9.5, 12.0), M.LogNormal(0.0, 0.5))}
        return out

    spectra = flat_spectra()
    j = jnv.HierarchicalNVFit(spectra, n_walkers=16, seed=2, **resolve(jpriors, kw))
    t = tnv.HierarchicalNVFit(spectra, n_walkers=16, seed=2, **resolve(tpriors, kw), **F64)
    assert t.spec.keys == j.spec.keys and t.pooled == j.pooled
    assert t.prior_spec is not None and j.prior_spec is not None
    assert dist_meta(t.prior_spec) == dist_meta(j.prior_spec)
    assert t.n_spectra == j.n_spectra == 3
    if kw.get("pooled", ()) is None:
        assert set(t.pooled) == {"scale1", "scale2", "mu1", "mu2", "sigma", "bg0"}
    if "correlation" in kw:
        assert t.n_corr == j.n_corr == 1 and "bg0__c_sigma" in t.prior_spec
    # every column within 2 ulp but the slants: their jitter scale is a
    # difference of two ndtri values, and the jitter's product rounds it
    # twice more (4 ulp)
    nh = t._n_hyper
    tp, jp = t.state.position.numpy(), np.asarray(j.state.position)
    cols = np.r_[0:2 * len(t.pooled), nh:t.spec.ndim]
    within_ulps(tp[:, cols], jp[:, cols])
    within_ulps(tp[:, 2 * len(t.pooled):nh], jp[:, 2 * len(t.pooled):nh], n=4)
    pos = np.asarray(j.state.position)
    want = np.asarray(jax.vmap(lambda th: j._log_post_one(th, j._posterior_data()))(
        jnp.asarray(pos)))
    np.testing.assert_allclose(t._log_post(torch.as_tensor(pos)).numpy(), want, rtol=1e-10)


def test_block_proposal_and_accessors_on_a_grid():
    """A 4 x 4 grid: d = 4 + 16 x 6 = 100 takes block proposals in both; on
    a carried JAX state the per-pixel best, the field offsets and the
    population agree."""
    spectra = grid_spectra(4, 4)
    j = jnv.HierarchicalNVFit(spectra, n_walkers=32, seed=0)
    t = tnv.HierarchicalNVFit(spectra, n_walkers=32, seed=0, **F64)
    assert t.spec.ndim == j.spec.ndim == 100
    for f in ("block_hyper", "block_local", "block_count"):
        assert getattr(t.config, f) == getattr(j.config, f)
    assert (t.config.block_hyper, t.config.block_count) == (4, 16)
    j.adaptive_steps(200, auto=None)
    a = {k: np.asarray(getattr(j.state, k)) for k in (
        "position", "logprob", "best_position", "best_logprob", "l_matrix", "m_sum",
        "m_outer", "m_count")}
    pos, lp = j._history()
    a.update(history_positions=np.asarray(pos), history_logprobs=np.asarray(lp))
    hierarchical_from_numpy(t, a)
    for pt, pj in zip(t.best_params_per_spectrum(), j.best_params_per_spectrum()):
        for k in pj:
            assert pt[k] == pytest.approx(pj[k], rel=1e-12)
    np.testing.assert_allclose(t.field_offsets(), j.field_offsets(), rtol=1e-12)
    ht, hj = t.hyper_params("median"), j.hyper_params("median")
    for part in ("mu", "tau"):
        assert ht[part] == pytest.approx(hj[part], rel=1e-12)
