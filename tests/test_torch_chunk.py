"""Whole-chunk rwm stepper of the PyTorch port against the JAX chunk kernel.

The port's plain chunk (``lisp_mcmc_torch.ops.chunk_kernel``, what the
CUDA kernel is held against on the card) reproduces the JAX kernel's
keyed-hash random stream bit for bit in its uniforms; the normals then
differ by the rounding of log/cos/sqrt, which can flip a near-tie
accept.  So one chunk from the same state, L, seed and anneal step must
agree walker by walker for at least 99 % of walkers.  The JAX kernel runs
in Pallas interpret mode on the CPU, as its own tests run it; both sides
are float32 (the chunk kernel's only type).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch.convert import dataset_from_numpy
from lisp_mcmc_torch.fit import _Term
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_tpu.models import line as j_line
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_tpu.ops.chunk_pallas import (_hash_bits, _uniform_from_bits,
                                            build_chunk_pallas)
from lisp_mcmc_torch.models import line as t_line
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder

# The printed reference parameters (tests/test_flagship_regression.py) with
# scale x10: at the printed scale the whole resonance is worth 1.5
# log-units under sigma = 1e-7, so x0 is not identified; x10 makes it 155.
FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers, and
    torch's spinning thread pool would oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flagship_data(seed=0):
    x = np.linspace(2000.0, 3600.0, 334)
    y = np.asarray(j_lorder(x, FLAGSHIP), np.float64)
    return x, y + 1e-7 * np.random.default_rng(seed).standard_normal(334)


@pytest.fixture(scope="module")
def f32():
    """The chunk kernel is f32-only; flip JAX's x64 off for this module."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_hash_uniforms_bit_identical(f32):
    """Port uniforms == JAX kernel uniforms, bit for bit, for several keys."""
    d, wb = 6, 1024
    r = np.arange(d)[:, None]
    c = np.arange(wb)[None, :]
    idx = torch.as_tensor(r * wb + c, dtype=torch.int64)
    for key1, key2 in [(0, 0), (12345, 0x68E31DA4), (0xFFFFFFFF, 0xD1C63B48),
                       (0x9E3779B9 * 7 % 2**32, 0xB5297A4D * 199 % 2**32)]:
        ju = np.asarray(_uniform_from_bits(
            _hash_bits((d, wb), jnp.uint32(key1), jnp.uint32(key2))))
        tu = tck._uniform_from_bits(tck._hash_bits(idx, key1, key2)).numpy()
        assert ju.dtype == tu.dtype == np.float32
        np.testing.assert_array_equal(ju.view(np.uint32), tu.view(np.uint32),
                                      err_msg="hash uniforms must be bit-identical")


def _chunk_pair(j_fn, t_fn, x, y, sigma, params, l_scale, jitter, seed):
    """Build both chunk steppers on the same data and start state."""
    cfg = jfit.FitConfig()
    jw = jfit.walker_create(function=j_fn, data=(x, y), params=params,
                            data_error=sigma, n_walkers=256, seed=seed,
                            walker_jitter=jitter, dtype=jnp.float32)
    j_run = build_chunk_pallas(jw.terms, jw.spec, cfg, 256, jnp.float32,
                               block_walkers=128, interpret=True)
    ds = jw.terms[0].dataset
    fields = {k: np.asarray(getattr(ds, k)) for k in
              ("x", "y", "sigma", "mask", "inv_sigma", "log_norm_const",
               "log_norm_const_point", "log_fact_y")}
    fields["n"] = ds.n
    t_ds = dataset_from_numpy(fields, dtype=torch.float32, device="cpu")
    terms = [_Term(fn=t_fn, dataset=t_ds,
                   likelihood=tfit.log_likelihood_normal,
                   prior=tfit.log_prior_flat)]
    spec = tfit.ParamSpec(jw.spec.keys)
    t_ck = tck.build_chunk_kernel(terms, spec, tfit.FitConfig(), 256,
                                  torch.float32, block_walkers=128)
    assert j_run is not None and t_ck is not None
    st = jw.state
    L = l_scale * np.diag(np.abs(np.asarray(params_vec(jw))))
    start = [np.asarray(a, np.float32) for a in
             (st.position, st.logprob, st.best_position, st.best_logprob)]
    return j_run, t_ck, start, L.astype(np.float32)


def params_vec(jw):
    return np.asarray(jw.state.position)[0]


@pytest.mark.parametrize("model", ["line", "lorder_mixed_bg"])
def test_plain_chunk_matches_jax_chunk(f32, model):
    if model == "line":
        x = np.linspace(0.0, 10.0, 50)
        y = 2.0 * x + 1.0 + 0.5 * np.random.default_rng(1).standard_normal(50)
        args = (j_line, t_line, x, y, 0.5, {"m": 2.0, "b": 1.0}, 0.02, 0.05, 3)
    else:
        x, y = flagship_data()
        args = (j_lorder, t_lorder, x, y, 1e-7, FLAGSHIP, 3e-3, 1e-3, 4)
    j_run, t_ck, start, L = _chunk_pair(*args)
    anneal_step, seed = 1000, 20240607
    jo = j_run(*[jnp.asarray(a) for a in start], jnp.asarray(L),
               anneal_step, 0.0, seed)
    to = tck.chunk_rwm(t_ck, *[torch.as_tensor(np.array(a)) for a in start],
                       torch.as_tensor(L), anneal_step, 0.0,
                       torch.tensor([seed], dtype=torch.int32))
    j_acc = np.asarray(jo["accept_counts"])
    t_acc = to["accept_counts"].numpy()
    rate = j_acc.mean() / t_ck.chunk
    assert 0.05 < rate < 0.95, f"uninformative acceptance {rate}"
    same = j_acc == t_acc
    assert same.mean() >= 0.99, (
        f"accept counts agree for {same.mean():.4f} of walkers (need >= 0.99)")
    np.testing.assert_allclose(
        to["position"].numpy()[same], np.asarray(jo["position"])[same],
        rtol=1e-4, err_msg="positions of agreeing walkers, rtol 1e-4")
    assert float(to["m_count"]) == float(t_acc.sum()), "m_count == sum(accepts)"


def _line_walker_t(n_walkers=256, seed=0, config=None):
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0
    return tfit.walker_create(
        function=t_line, data=(x, y), params={"m": 2.0, "b": 1.0},
        data_error=0.5, n_walkers=n_walkers, seed=seed, walker_jitter=0.1,
        config=config, device="cpu")


def test_plain_chunk_samples_same_posterior_as_per_step():
    """Both paths sample the conjugate-Gaussian line posterior alike
    (tests/test_chunk_pallas.py's check, on the port)."""
    w = _line_walker_t(n_walkers=512)
    w.adaptive_steps(4000, auto=None, temperature=1.0)
    ref_pos = w.state.position.numpy()
    l_tuned = w.state.l_matrix[0]
    w2 = _line_walker_t(n_walkers=512)
    ck = tck.build_chunk_kernel(w2.terms, w2.spec, w2.config, 512, torch.float32)
    st = w2.state
    pos, lp, best, best_lp = st.position, st.logprob, st.best_position, st.best_logprob
    acc_total = 0.0
    for c in range(20):
        out = tck.chunk_rwm(ck, pos, lp, best, best_lp, l_tuned, 0, 1.0, 1000 + c)
        pos, lp = out["position"], out["logprob"]
        best, best_lp = out["best_position"], out["best_logprob"]
        acc_total += float(out["accept_counts"].mean())
    acc_rate = acc_total / (20 * ck.chunk)
    assert 0.05 < acc_rate < 0.95, acc_rate
    p_pos = pos.numpy()
    np.testing.assert_allclose(p_pos.mean(0), ref_pos.mean(0), atol=0.05)
    sx, sp = ref_pos.std(0), p_pos.std(0)
    assert np.all(sp < 2.0 * sx + 1e-3) and np.all(sp > 0.5 * sx - 1e-3), (sp, sx)
    assert float(best_lp.max()) >= float(lp.max()) - 1e-5
    assert float(out["m_count"]) == pytest.approx(float(out["accept_counts"].sum()),
                                                  rel=1e-6)


def test_plain_chunk_trace_order_and_logprob_consistency():
    w = _line_walker_t(seed=3)
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 256, torch.float32)
    st = w.state
    out = tck.chunk_rwm(ck, st.position, st.logprob, st.best_position,
                        st.best_logprob, st.l_matrix[0], 0, 0.0, 7)
    assert out["trace_max"].shape == (ck.chunk,)
    assert torch.all(out["trace_max"] >= out["trace_mean"] - 1e-4)
    assert torch.all(out["trace_mean"] >= out["trace_min"] - 1e-4)
    lp_re = w._eval_batch(out["position"]).numpy()
    np.testing.assert_allclose(lp_re, out["logprob"].numpy(), rtol=1e-4, atol=1e-3)


def test_chunk_kernel_path_through_adaptive_steps():
    """``posterior_impl="chunk_kernel"`` rides adaptive_steps for
    non-history chunks (the plain chunk on the CPU) and converges; history
    chunks keep the per-step path."""
    w = _line_walker_t(seed=1, config=tfit.FitConfig(posterior_impl="chunk_kernel"))
    w.adaptive_steps(2000, auto=None, temperature=1.0, collect_history=False)
    best = w.most_likely_params()
    assert best["m"] == pytest.approx(2.0, abs=0.1)
    assert best["b"] == pytest.approx(1.0, abs=0.4)
    assert 0.0 < w.acceptance() < 1.0
    w.adaptive_steps(400, auto=None, temperature=1.0)
    assert len(w) > 0


def test_chunk_kernel_scope():
    w = _line_walker_t()
    assert tck.build_chunk_kernel(
        w.terms, w.spec, dataclasses.replace(w.config, tempering_rungs=4),
        256, torch.float32) is None
    assert tck.build_chunk_kernel(w.terms, w.spec, w.config, 256,
                                  torch.float64) is None
    assert tck.build_chunk_kernel(w.terms, w.spec, w.config, 100,
                                  torch.float32) is None
    w64 = tfit.walker_create(
        function=t_line, data=(np.arange(5.0), np.arange(5.0)),
        params={"m": 1.0, "b": 0.5}, n_walkers=256, dtype=torch.float64,
        config=tfit.FitConfig(posterior_impl="chunk_kernel"), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        w64.adaptive_steps(400, auto=None, collect_history=False)
