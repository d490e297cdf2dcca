"""The port's model zoo against the JAX package's, and the twins' reach.

- Every zoo model, the port's plain torch function against the JAX one
  over a walker batch, float64, rtol 1e-12 (atol 1e-12 of the model's peak,
  for outputs that cross zero), with and without the optional parameters,
  and over x <= 0 for ``power_law`` and ``stretched_exponential``.
- ``models.renamed`` computes the wrapper it declares, and ``device_model``
  resolves it to the base twin's columns.
- Every zoo fit, with and without its optional parameters, is inside the
  fused kernel's coverage and, in float32, the chunk kernel's; the fused
  plain version of each equals the plain posterior (rtol 1e-12), so each
  twin's column map is the model's.  The CUDA twins themselves are held
  against these plain versions in tests/test_torch_cuda.py (on a GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import models, synthetic
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_tpu.models import zoo as jzoo

MODELS = sorted(models.DEVICE_MODELS, key=lambda f: f.__name__)
W = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(model, optional, rng):
    """(W,) arrays of each parameter, scattered 5 % around TWIN_PARAMS."""
    twin = models.DEVICE_MODELS[model]
    base = {k: v for k, v in synthetic.TWIN_PARAMS[model.__name__].items()
            if optional or k not in twin.optional}
    return {k: v * (1 + 0.05 * rng.standard_normal(W)) for k, v in base.items()}


@pytest.mark.parametrize("optional", [True, False], ids=["all", "required"])
@pytest.mark.parametrize("model", MODELS, ids=lambda f: f.__name__)
def test_models_match_jax(model, optional):
    rng = np.random.default_rng(3)
    masked = model.__name__ in ("power_law", "stretched_exponential")
    x = np.linspace(-1.0, 3.0, 61) if masked else np.linspace(0.5, 3.0, 60)
    p = _params(model, optional, rng)
    got = model(torch.as_tensor(x), {k: torch.as_tensor(v)[:, None] for k, v in p.items()})
    want = np.asarray(jax.vmap(lambda q: getattr(jzoo, model.__name__)(jnp.asarray(x), q))(
        {k: jnp.asarray(v) for k, v in p.items()}))
    assert got.shape == want.shape == (W, x.size)
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max(),
                               err_msg=f"{model.__name__}: port vs JAX, rtol 1e-12")
    if masked:
        # x <= 0 gives bg0 (power_law) or scale + bg0 (stretched_exponential)
        bg0 = p.get("bg0", np.zeros(W))[:, None]
        low = (p["scale"][:, None] if model is models.stretched_exponential else 0.0) + bg0
        np.testing.assert_allclose(got.numpy()[:, x <= 0], np.broadcast_to(low, (W, 16)),
                                   rtol=1e-12)


GLOBAL_KEYS = ("scale", "linewidth", "x0", "mix", "bg0", "bg1", "scale2", "bg02", "bg12")


def test_renamed_model_is_the_wrapper_and_resolves_to_the_base_twin():
    lorder2 = models.renamed(models.lorder_mixed_bg,
                             {"scale": "scale2", "bg0": "bg02", "bg1": "bg12"})

    def explicit(x, p):  # test.lisp:54-55, as examples/reference_journey.py writes it
        return models.lorder_mixed_bg(x, {
            "scale": p["scale2"], "linewidth": p["linewidth"], "x0": p["x0"],
            "mix": p["mix"], "bg0": p["bg02"], "bg1": p["bg12"]})

    g = synthetic.global_fit(2)
    x = torch.as_tensor(g["data"][1][0])
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in g["truth"].items()}
    torch.testing.assert_close(lorder2(x, p), explicit(x, p), rtol=0, atol=0)
    assert models.device_model(lorder2, GLOBAL_KEYS)[:3] == (
        0, ("scale", "linewidth", "x0", "mix", "bg0", "bg1"), (6, 1, 2, 3, 7, 8))
    assert models.device_model(models.lorder_mixed_bg, GLOBAL_KEYS)[2] == (0, 1, 2, 3, 4, 5)
    # a renamed optional parameter the fit lacks reads 0, never the base name's value
    peak_b = models.renamed(models.gaussian_peak, {"scale": "scale_b", "bg0": "bg0_b"})
    keys = ("scale", "x0", "sigma", "bg0", "scale_b")
    assert models.device_model(peak_b, keys)[2] == (4, 1, 2, -1, -1)
    q = {"scale": torch.tensor(1.0), "x0": torch.tensor(0.0), "sigma": torch.tensor(1.0),
         "bg0": torch.tensor(5.0), "scale_b": torch.tensor(2.0)}
    assert float(peak_b(torch.tensor(0.0), q)) == 2.0


def test_model_coverage_names_the_reason():
    assert models.model_coverage(models.lorder_mixed_bg, GLOBAL_KEYS) is None
    assert "needs parameters ['mix']" in models.model_coverage(
        models.lorder_mixed_bg, ("scale", "linewidth", "x0"))
    coeffs = tuple(f"c{k}" for k in range(17))
    assert "17 polynomial coefficients" in models.model_coverage(models.polynomial, coeffs)
    assert models.model_coverage(models.polynomial, coeffs[:16]) is None

    def wrapper(x, p):  # an undeclared closure stays outside, as before
        return models.line(x, p)

    assert "no CUDA twin" in models.model_coverage(wrapper, ("b", "m"))


@pytest.mark.parametrize("optional", [True, False], ids=["all", "required"])
@pytest.mark.parametrize("model", MODELS, ids=lambda f: f.__name__)
def test_every_zoo_fit_is_inside_both_kernels(model, optional):
    x, y, params, _ = synthetic.twin_case(model, optional, n_points=40)
    for dtype in (torch.float32, torch.float64):
        w = tfit.walker_create(function=model, data=(x, y), params=params,
                               data_error=0.05 * np.abs(y).max(), n_walkers=128,
                               walker_jitter=0.05, dtype=dtype, device="cpu")
        assert tlk.kernel_coverage(w.terms, w.spec) is None
        if dtype == torch.float32:
            assert tck.chunk_coverage(w.terms, w.spec, w.config, 128, dtype) is None
        post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
        twin = models.DEVICE_MODELS[model]
        absent = [n for n, i in zip(post.terms[0].names, post.terms[0].pidx_host) if i < 0]
        assert absent == ([] if optional else [n for n in twin.names or ()
                                               if n in twin.optional])
        if dtype == torch.float64:
            torch.testing.assert_close(tlk.fused_posterior(w.state.position, post),
                                       w._log_post(w.state.position), rtol=1e-12, atol=0)
