"""The port's fused posterior against the JAX Pallas kernel.

``lisp_mcmc_torch.ops.loglik_kernel.fused_posterior_plain`` is the
function the CUDA kernel computes (and what it is held against on the
card); here it meets ``lisp_mcmc_tpu.ops.loglik_pallas.build_fused_posterior``
in Pallas interpret mode at W = 256, float64, rtol 1e-9 (the JAX
package's own tolerance, tests/test_pallas.py).  Both sides evaluate the
same positions on the same dataset arrays.  The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py (on a GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch.convert import dataset_from_numpy
from lisp_mcmc_torch.fit import _Term
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_tpu import likelihoods as jlik
from lisp_mcmc_tpu.models import line as j_line
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_tpu.ops.loglik_pallas import build_fused_posterior
from lisp_mcmc_tpu.priors import make_bounds_prior as j_bounds
from lisp_mcmc_torch import likelihoods as tlik
from lisp_mcmc_torch.models import line as t_line
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder

# The printed reference parameters with scale x10 (see test_torch_fit.py).
FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
FLAGSHIP_BOUNDS = {"linewidth": (1.0, 500.0), "x0": (2700.0, 2900.0),
                   "mix": (0.0, 6.3)}
W = 256


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


def _pair(case):
    """(JAX walker, port terms, spec) for one likelihood/prior case."""
    rng = np.random.default_rng(8)
    if case.startswith("poisson"):
        x = np.linspace(0.0, 4.0, 30)
        y = rng.poisson(lam=5.0 + 2.0 * x).astype(float)
        kw = dict(function=j_line, data=(x, y), params={"m": 2.0, "b": 5.0},
                  data_error=None, walker_jitter=0.05)
        t_fn, jl, tl = t_line, jlik.log_likelihood_poisson, tlik.log_likelihood_poisson
        bounds = {"m": (1.9, 2.1)}
    else:
        x, y = flagship_data()
        kw = dict(function=j_lorder, data=(x, y), params=FLAGSHIP,
                  data_error=1e-7, walker_jitter=0.02)
        t_fn, bounds = t_lorder, FLAGSHIP_BOUNDS
        if case.startswith("cutoff"):
            jl, tl = jlik.log_likelihood_normal_cutoff, tlik.log_likelihood_normal_cutoff
        else:
            jl, tl = jlik.log_likelihood_normal, tlik.log_likelihood_normal
    with_bounds = case.endswith("bounds")
    jw = jfit.walker_create(log_likelihood=jl, n_walkers=W, seed=9,
                            log_prior=j_bounds(bounds) if with_bounds else None,
                            **kw)
    ds = jw.terms[0].dataset
    fields = {k: np.asarray(getattr(ds, k)) for k in
              ("x", "y", "sigma", "mask", "inv_sigma", "log_norm_const",
               "log_norm_const_point", "log_fact_y")}
    fields["n"] = ds.n
    prior = tfit.make_bounds_prior(bounds) if with_bounds else tfit.log_prior_flat
    terms = [_Term(fn=t_fn, dataset=dataset_from_numpy(fields, device="cpu"),
                   likelihood=tl, prior=prior)]
    return jw, terms, tfit.ParamSpec(jw.spec.keys)


@pytest.mark.parametrize("case", ["normal_flat", "normal_bounds", "cutoff_flat",
                                  "cutoff_bounds", "poisson_flat", "poisson_bounds"])
def test_plain_fused_matches_jax_interpret(case):
    jw, terms, spec = _pair(case)
    j_fused = build_fused_posterior(jw.terms, jw.spec, jnp.float64, W,
                                    block_walkers=128, interpret=True)
    term = tlk.prepare_fused_terms(terms, spec, torch.float64)
    assert j_fused is not None and term is not None
    rng = np.random.default_rng(10)
    base = np.asarray(jw.state.position)
    pos = base * (1.0 + 0.05 * rng.standard_normal(base.shape))  # some out of bounds
    want = np.asarray(j_fused(jnp.asarray(pos)))
    got = tlk.fused_posterior(torch.as_tensor(pos), term).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               err_msg=f"{case}: plain fused vs JAX interpret, rtol 1e-9")
    # ... and both equal the unfused posterior of each package
    j_plain = np.asarray(jax.vmap(jw._log_post_one, in_axes=(0, None))(
        jnp.asarray(pos), jw._posterior_data()))
    np.testing.assert_allclose(got, j_plain, rtol=1e-9)
    if case.endswith("bounds"):
        assert (got < -1e3).any(), "some walkers must sit outside the bounds"


def test_pick_block():
    assert tlk.pick_block(65536) == 2048
    assert tlk.pick_block(256) == 256
    assert tlk.pick_block(384) == 128
    assert tlk.pick_block(100) is None
    assert tlk.pick_block(131072, 1024) == 1024


def _line_walker(**kw):
    x = np.linspace(0.0, 1.0, 16)
    return tfit.walker_create(function=t_line, data=(x, x),
                              params={"m": 1.0, "b": 0.5}, n_walkers=128,
                              seed=5, walker_jitter=0.1, device="cpu", **kw)


def test_declines_outside_coverage():
    def custom(fn, params, dataset):
        mu = fn(dataset.x, params)
        return -torch.sum(torch.abs(dataset.y - mu) * dataset.mask, dim=-1)

    w = _line_walker(log_likelihood=custom)
    assert tlk.build_fused_posterior(w.terms, w.spec, w.dtype) is None
    assert "custom likelihood" in tlk.kernel_coverage(w.terms, w.spec)

    def quadratic(x, p):
        return p["a"] * x * x

    x = np.linspace(0.0, 1.0, 16)
    wq = tfit.walker_create(function=quadratic, data=(x, x), params={"a": 1.0},
                            n_walkers=128, device="cpu")
    assert "no CUDA twin" in tlk.kernel_coverage(wq.terms, wq.spec)
    wp = _line_walker(log_prior=tfit.make_bounds_prior(
        {"m": (0.0, 2.0)}, extra=lambda p, pen, ds: 0.0))
    assert "prior" in tlk.kernel_coverage(wp.terms, wp.spec)
    w2 = tfit.walker_create(function=[t_line, t_line], data=[(x, x), (x, 2 * x)],
                            params={"m": 1.0, "b": 0.5}, n_walkers=128, device="cpu")
    assert "2 posterior terms" in tlk.kernel_coverage(w2.terms, w2.spec)


def test_forced_kernel_outside_coverage_raises():
    def custom(fn, params, dataset):
        return -torch.sum((dataset.y - fn(dataset.x, params)) ** 2, dim=-1)

    for impl in ("kernel", "chunk_kernel"):
        w = _line_walker(log_likelihood=custom,
                         config=tfit.FitConfig(posterior_impl=impl))
        with pytest.raises(ValueError, match="coverage"):
            w.adaptive_steps(200, auto=None, collect_history=False)
    # "auto" takes the plain path there instead, and on the CPU always
    w = _line_walker(log_likelihood=custom)
    assert w._batched_posterior() is w._log_post
    w0 = _line_walker()
    assert w0._batched_posterior() is w0._log_post


def test_forced_kernel_runs_on_the_cpu_through_the_plain_version():
    w = _line_walker(config=tfit.FitConfig(posterior_impl="kernel"))
    fused = w._batched_posterior()
    assert fused is not w._log_post
    pos = w.state.position
    torch.testing.assert_close(fused(pos), w._log_post(pos), rtol=1e-6, atol=1e-4)
    w.adaptive_steps(600, auto=None)
    assert 0.0 < w.acceptance() < 1.0
