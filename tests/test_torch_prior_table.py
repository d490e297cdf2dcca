"""Named priors as the kernels' declared tables, against the JAX package.

- ``split_prior``'s fourth part, the density table, for each kind: a
  Uniform is a bounds entry only; an untruncated Gaussian or LogNormal a
  density entry only; a truncated one both, an infinite edge kept
  infinite; an ``MVGaussian`` one quadratic-form entry whose M is the
  inverse of its covariance's Cholesky factor (rtol 1e-12); a spec that
  names a parameter the fit lacks is refused like a bounds table.
- The port's plain kernel-1 version (what the CUDA kernel computes and
  is held against on the card) with the flagship's named prior
  (``synthetic.flagship_prior_spec``, walkers past every wall and at the
  LogNormal's x <= 0), against the JAX package's
  ``build_fused_posterior(..., interpret=True)``, float64, rtol 1e-9 (the
  JAX package's own tests' tolerance; the kernels sum the walls, then the
  densities, where the JAX prior sums each distribution's density and
  wall in turn, and multiply by 1/sigma where it divides).  With an
  ``MVGaussian`` the JAX kernel refuses the fit (its prior stacks the
  parameter rows, which the kernel's trace cannot take, and it returns
  None), so the port's kernel, which declares it, is held against the
  JAX walker's own posterior at the same tolerance.
- One 200-step chunk of the plain chunk stepper, float32, with the named
  prior, against the JAX ``build_chunk_pallas(..., interpret=True)``:
  at least 99 % of walkers agree in accept count and position (rtol
  1e-4), tests/test_torch_chunk.py's rule.
- Coverage: both kernels take a named prior and leave nothing for torch;
  the chunk kernel still refuses an undeclared closure (a
  ``combine_priors`` of a spec and anything) by name; the op census
  counts the table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import models, priors as tp, synthetic
from lisp_mcmc_torch.convert import walker_from_numpy
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_torch.roofline import FLAGSHIP, synthetic_flagship
from lisp_mcmc_tpu import priors as jp
from lisp_mcmc_tpu.models import zoo as jzoo
from lisp_mcmc_tpu.ops.chunk_pallas import build_chunk_pallas
from lisp_mcmc_tpu.ops.loglik_pallas import build_fused_posterior

KEYS = tuple(FLAGSHIP)
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")
DATASET_FIELDS = ("x", "y", "sigma", "mask", "inv_sigma", "log_norm_const",
                  "log_norm_const_point", "log_fact_y")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mv_pair():
    keys = ("linewidth", "x0", "mix")
    a = np.random.default_rng(3).standard_normal((3, 3))
    c = a @ a.T + np.eye(3)
    c = c / np.sqrt(np.outer(np.diag(c), np.diag(c)))
    s = np.array([5.0, 2.0, 0.05])
    mean = {k: FLAGSHIP[k] for k in keys}
    return jp.MVGaussian(mean, c * np.outer(s, s)), tp.MVGaussian(mean, c * np.outer(s, s))


def _priors(which):
    if which == "spec":
        t = synthetic.flagship_prior_spec()
        return jp.PriorSpec.from_meta(t.to_meta()), t
    return _mv_pair()


def test_split_prior_declares_each_kind():
    keys = ("a", "b", "c", "d", "e", "f", "g")
    spec = tp.PriorSpec({
        "a": (0.0, 1.0),
        "b": tp.Gaussian(1.0, 2.0),
        "c": tp.Gaussian(1.0, 2.0, low=0.0),
        "d": tp.Gaussian(1.0, 2.0, low=-1.0, high=4.0),
        "e": tp.LogNormal(0.5, 0.25),
        "f": tp.LogNormal(0.5, 0.25, high=9.0),
        "g": tp.LogNormal(0.5, 0.25, low=0.2, high=9.0),
    })
    bounds, rest, cons, dens = tlk.split_prior(spec.as_log_prior(), keys)
    assert rest is None and cons == ()
    inf = float("inf")
    assert bounds == ((0, 0.0, 1.0), (2, 0.0, inf), (3, -1.0, 4.0), (5, 0.0, 9.0),
                      (6, 0.2, 9.0))
    assert [(k, c) for k, c, _ in dens] == [("gauss", (1,)), ("gauss", (2,)),
                                          ("gauss", (3,)), ("logn", (4,)), ("logn", (5,)),
                                          ("logn", (6,))]
    for (kind, (col,), (mu, inv_s, c)) in dens:
        dist = spec[keys[col]]
        assert (mu, inv_s) == (dist.mu, 1.0 / dist.sigma)
        # c makes the entry the JAX package's installed density
        jd = jp.PriorSpec.from_meta({"x": dist.to_meta()})["x"]
        x = 0.7
        z = ((np.log(x) if kind == "logn" else x) - mu) * inv_s
        want = float(jd.installed_log_pdf(jnp.asarray(x)))
        got = -0.5 * z * z + c - (np.log(x) if kind == "logn" else 0.0)
        assert got == pytest.approx(want, rel=1e-12)
    # the fit's order, not the spec's; a missing parameter is refused
    assert tlk.split_prior(spec.as_log_prior(), keys[::-1])[0][0] == (6, 0.0, 1.0)
    assert tlk.split_prior(spec.as_log_prior(), keys[:-1]) is None


def test_split_prior_declares_the_mv_gaussian():
    jm, tm = _mv_pair()
    keys = KEYS
    bounds, rest, cons, dens = tlk.split_prior(tm.as_log_prior(), keys)
    assert bounds == () and rest is None and cons == () and len(dens) == 1
    kind, cols, vals = dens[0]
    assert kind == "quad" and cols == tuple(keys.index(k) for k in ("linewidth", "x0", "mix"))
    k = 3
    m = np.zeros((k, k))
    m[np.tril_indices(k)] = vals[k:-1]
    np.testing.assert_allclose(m @ np.linalg.cholesky(tm._cov), np.eye(k), atol=1e-12)
    assert vals[:k] == tuple(tm.mean) and vals[-1] == tm.log_norm
    assert tlk.split_prior(tm.as_log_prior(), ("x0", "mix")) is None


def _walker_pair(which, dtype, n_walkers, seed=2, jitter=0.05):
    jprior, tprior = _priors(which)
    x, y = synthetic_flagship()
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jw = jfit.walker_create(function=jzoo.lorder_mixed_bg, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, log_prior=jprior, n_walkers=n_walkers,
                            seed=seed, walker_jitter=jitter, dtype=jdtype)
    arrays = {k: np.asarray(getattr(jw.state, k)) for k in STATE_KEYS}
    arrays["keys"] = jw.spec.keys
    ds = [{**{k: np.asarray(getattr(t.dataset, k)) for k in DATASET_FIELDS},
           "n": t.dataset.n} for t in jw.terms]
    tw = walker_from_numpy(arrays, datasets=ds, dtype=dtype, device="cpu",
                           function=models.lorder_mixed_bg, data=(x, y), params=FLAGSHIP,
                           data_error=1e-7, log_prior=tprior)
    return jw, tw


@pytest.mark.parametrize("which", ["spec", "mv_gaussian"])
def test_plain_fused_with_a_named_prior_matches_jax_interpret(which):
    jw, tw = _walker_pair(which, torch.float64, 128)
    j_fused = build_fused_posterior(jw.terms, jw.spec, jnp.float64, 128, block_walkers=128,
                                    interpret=True)
    post = tlk.prepare_fused_terms(tw.terms, tw.spec, torch.float64)
    assert post is not None and post.rest == ()
    pos = synthetic.prior_edge_walkers(tw.state.position, tw.spec.keys)
    if which == "spec":
        assert j_fused is not None
        want = np.asarray(j_fused(jnp.asarray(pos.numpy())))
    else:
        assert j_fused is None, "the JAX kernel takes no MVGaussian"
        want = np.asarray(jax.vmap(jw._log_post_one, in_axes=(0, None))(
            jnp.asarray(pos.numpy()), jw._posterior_data()))
    got = tlk.fused_posterior(pos, post)
    assert tlk.posterior_rel_err(got, torch.as_tensor(want), post) <= 1e-9
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    assert np.isfinite(want).all()
    if which == "spec":
        assert (want < -1e4).sum() >= 4 * 128 // 8, "the walkers past a wall"
    # and the walker's own plain posterior, the JAX order and formulas
    np.testing.assert_allclose(tw._log_post(pos).numpy(), want, rtol=1e-9)


@pytest.fixture
def f32():
    """The chunk kernel is float32; JAX's x64 is off for this test."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_plain_chunk_with_a_named_prior_matches_jax_chunk(f32):
    W = 256
    jw, tw = _walker_pair("spec", torch.float32, W, seed=4, jitter=1e-3)
    j_run = build_chunk_pallas(jw.terms, jw.spec, jfit.FitConfig(), W, jnp.float32,
                               block_walkers=128, interpret=True)
    ck = tck.build_chunk_kernel(tw.terms, tw.spec, tfit.FitConfig(), W, torch.float32,
                                block_walkers=128)
    assert j_run is not None and ck is not None and len(ck.post.densities) == 3
    L = synthetic.dense_l(3e-3 * np.asarray(list(FLAGSHIP.values()))).numpy()
    pos = synthetic.prior_edge_walkers(tw.state.position, KEYS).numpy()
    lp = np.asarray(jax.vmap(jw._log_post_one, in_axes=(0, None))(
        jnp.asarray(pos), jw._posterior_data()), np.float32)
    start = [pos, lp, pos, lp]
    jo = j_run(*[jnp.asarray(a) for a in start], jnp.asarray(L), 1000, 0.0, 20240607)
    to = tck.chunk_rwm(ck, *[torch.as_tensor(a) for a in start], torch.as_tensor(L),
                       1000, 0.0, torch.tensor([20240607], dtype=torch.int32))
    j_acc, t_acc = np.asarray(jo["accept_counts"]), to["accept_counts"].numpy()
    assert 0.05 < j_acc.mean() / ck.chunk < 0.95, "uninformative acceptance"
    same = j_acc == t_acc
    assert same.mean() >= 0.99, f"accept counts agree for {same.mean():.4f} (need >= 0.99)"
    np.testing.assert_allclose(to["position"].numpy()[same], np.asarray(jo["position"])[same],
                               rtol=1e-4, err_msg="positions of agreeing walkers, rtol 1e-4")
    np.testing.assert_allclose(to["logprob"].numpy()[same], np.asarray(jo["logprob"])[same],
                               rtol=1e-4)


def test_coverage_of_named_priors_and_closures():
    x, y = synthetic_flagship()
    spec = synthetic.flagship_prior_spec()
    jm, tm = _mv_pair()
    cfg = tfit.FitConfig()
    for prior in (spec, tm, [spec, tm]):
        many = isinstance(prior, list)
        w = tfit.walker_create(function=[models.lorder_mixed_bg] * (2 if many else 1),
                               data=[(x, y)] * 2 if many else (x, y), params=FLAGSHIP,
                               data_error=1e-7, log_prior=prior, n_walkers=256, device="cpu")
        assert tlk.kernel_coverage(w.terms, w.spec) is None
        assert tck.chunk_coverage(w.terms, w.spec, cfg, 256, torch.float32) is None
        post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float32)
        assert post.rest == () and len(post.densities) == (4 if many else
                                                           1 if prior is tm else 3)
    # a closure that wraps a spec is undeclared: kernel 1 evaluates it in
    # torch beside the kernel, the chunk kernel refuses it by name
    mixed = tfit.combine_priors(spec.as_log_prior(), tfit.log_prior_flat)
    mixed.__name__ = "spec_plus_flat"
    w = tfit.walker_create(function=models.lorder_mixed_bg, data=(x, y), params=FLAGSHIP,
                           data_error=1e-7, log_prior=mixed, n_walkers=256, device="cpu")
    assert tlk.kernel_coverage(w.terms, w.spec) is None
    assert tlk.prepare_fused_terms(w.terms, w.spec, torch.float32).rest != ()
    reason = tck.chunk_coverage(w.terms, w.spec, cfg, 256, torch.float32)
    assert reason is not None and "spec_plus_flat" in reason and "declared table" in reason
    # a spec over a parameter the fit lacks: neither kernel
    bad = tp.PriorSpec({"nope": tp.Gaussian(0.0, 1.0)})
    w = tfit.walker_create(function=models.lorder_mixed_bg, data=(x, y), params=FLAGSHIP,
                           data_error=1e-7, log_prior=lambda p, d=None: 0.0, n_walkers=256,
                           device="cpu")
    w.terms[0].prior = bad.as_log_prior()
    assert "named prior" in tlk.kernel_coverage(w.terms, w.spec)


def test_census_counts_the_density_table():
    """Per walker: 6 flops a Gaussian, 7 and a log a LogNormal, 3 k(k+1)/2
    + 2k + 3 a k-parameter quadratic form, one add of their total; the
    walls as bounds entries (6 flops and an exp each)."""
    assert tlk.density_census("gauss") == {"flops": 6}
    assert tlk.density_census("logn") == {"flops": 7, "log": 1}
    assert tlk.density_census("quad", 3) == {"flops": 3 * 6 + 6 + 3}
    x, y = synthetic_flagship()
    flat = tfit.walker_create(function=models.lorder_mixed_bg, data=(x, y), params=FLAGSHIP,
                              data_error=1e-7, n_walkers=128, device="cpu")
    named = tfit.walker_create(function=models.lorder_mixed_bg, data=(x, y), params=FLAGSHIP,
                               data_error=1e-7, n_walkers=128, device="cpu",
                               log_prior=synthetic.flagship_prior_spec())
    cf = tlk.posterior_census(tlk.prepare_fused_terms(flat.terms, flat.spec, torch.float32))
    cn = tlk.posterior_census(tlk.prepare_fused_terms(named.terms, named.spec, torch.float32))
    assert cn["per_point"] == cf["per_point"]
    # 5 walls (3 boxes, x0's two-sided and mix's one-sided truncation),
    # two Gaussians, one LogNormal, the total's add
    extra = {c: cn["per_walker"][c] - cf["per_walker"][c] for c in tlk.OP_CLASSES}
    assert extra == {"flops": 5 * 6 + 2 * 6 + 7 + 1, "div": 0, "sqrt": 0, "log": 1,
                     "exp": 5, "cos": 0}
    ck = tck.chunk_census(cn, 6)
    assert ck["per_walker"] == cn["per_walker"]
