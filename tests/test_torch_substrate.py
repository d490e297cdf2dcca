"""The PyTorch port's substrate against the JAX package, on the same inputs.

File reading, datasets and their cached terms, parameter specs, the two
models with CUDA twins, the three library likelihoods, the priors and the
proposal linear algebra.  Inputs come from numpy with a seed; both sides
run in float64 on the CPU.  Tolerance: rtol 1e-12, or 1e-10 where a log
or an exp sits between input and output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_tpu import likelihoods as jlik
from lisp_mcmc_tpu import params as jparams
from lisp_mcmc_tpu import priors as jpri
from lisp_mcmc_tpu.data import Dataset as JDataset
from lisp_mcmc_tpu.io import files as jfiles
from lisp_mcmc_tpu.models import line as j_line
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_tpu.ops import linalg as jlin
from lisp_mcmc_torch import likelihoods as tlik
from lisp_mcmc_torch import priors as tpri
from lisp_mcmc_torch.convert import dataset_from_numpy
from lisp_mcmc_torch.data import Dataset as TDataset
from lisp_mcmc_torch.io import files as tfiles
from lisp_mcmc_torch.models import line as t_line
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder
from lisp_mcmc_torch.ops import linalg as tlin

FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
W = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers, and
    torch's spinning thread pool would oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _walker_params(base, rng, spread):
    """{name: (W,)} arrays scattered around ``base``."""
    return {k: v * (1 + spread * rng.standard_normal(W)) for k, v in base.items()}


def _jax_batch(fn, params, *args):
    """vmap a per-walker JAX function over (W,) parameter arrays."""
    return np.asarray(jax.vmap(lambda p: fn(*args[:1], p, *args[1:]))(
        {k: jnp.asarray(v) for k, v in params.items()}))


def _cols(params):
    return {k: torch.as_tensor(v)[:, None] for k, v in params.items()}


def test_read_file_data_matches(tmp_path):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((40, 5))
    path = tmp_path / "spectrum-example.xls"
    lines = ["field\tcol1\tcol2\tcol3\tcol4"]
    lines += ["\t".join(f"{v:.10g}" for v in row) for row in table[:20]]
    lines += [""]  # a second page after a blank line
    lines += ["\t".join(f"{v:.6e}".replace("e", "d") for v in row) for row in table[20:]]
    path.write_text("\r\n".join(lines) + "\n")
    assert tfiles.file_specs(str(path)) == jfiles.file_specs(str(path))
    assert tfiles.get_filename(str(tmp_path), include=["example"]) == \
        jfiles.get_filename(str(tmp_path), include=["example"])
    t_cols = tfit.read_file_data(str(path))
    j_cols = jfit.read_file_data(str(path))
    assert len(t_cols) == len(j_cols) == 5
    for a, b in zip(t_cols, j_cols):
        np.testing.assert_array_equal(a, b)
    pages = tfit.read_file_data(str(path), pages=True)
    assert len(pages) == 2 and pages[1][0].shape == (20,)
    x, y = tfit.create_walker_data(t_cols, 1, 4)
    jx, jy = jfit.create_walker_data(j_cols, 1, 4)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_clean_data_and_errors_match():
    x = np.arange(5.0)
    data = [(x, 2 * x), (x, x + 1)]
    for err in (0.5, [0.1, np.full(5, 0.2)], [np.arange(1.0, 6.0)]):
        t = tfit.clean_data_error(err, tfit.clean_data(data, 2))
        j = jfit.clean_data_error(err, jfit.clean_data(data, 2))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="insufficient number"):
        tfit.clean_data(data, 3)


@pytest.mark.parametrize("source", ["create", "from_padded_jax"])
def test_dataset_cached_fields_match(source):
    """The port does not pad; a JAX dataset (padded to 128) carried across
    keeps its mask, so both layouts give the JAX cached fields."""
    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 5.0, 50)
    y = rng.poisson(4.0, 50).astype(float)
    sigma = 0.1 + rng.random(50)
    j = JDataset.create(x, y, sigma, dtype=jnp.float64)
    if source == "create":
        t = TDataset.create(x, y, sigma, dtype=torch.float64, device="cpu")
    else:
        fields = {k: np.asarray(getattr(j, k)) for k in ("x", "y", "sigma", "mask")}
        t = dataset_from_numpy({**fields, "n": j.n}, device="cpu")
    n = t.y.shape[0]
    assert t.n == j.n == 50 and n == (50 if source == "create" else 128)
    for k, rtol in (("x", 1e-12), ("y", 1e-12), ("sigma", 1e-12), ("mask", 1e-12),
                    ("inv_sigma", 1e-12), ("log_norm_const_point", 1e-10),
                    ("log_fact_y", 1e-10)):
        np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k))[:n],
                                   rtol=rtol, err_msg=f"Dataset.{k}, rtol {rtol}")
    np.testing.assert_allclose(float(t.log_norm_const), float(j.log_norm_const),
                               rtol=1e-10)
    with pytest.raises(ValueError, match="positive"):
        TDataset.create(x, y, np.zeros(50), device="cpu")


def test_param_spec_roundtrip():
    params = {":scale": 1e-5, "x0": 2200.0, "mix": 0.9}
    t_spec, t_vec = tfit.normalize_params(params)
    j_spec, j_vec = jparams.normalize_params(params)
    assert t_spec.keys == j_spec.keys == ("scale", "x0", "mix")
    np.testing.assert_array_equal(t_vec.numpy(), np.asarray(j_vec))
    batch = torch.as_tensor(np.random.default_rng(2).standard_normal((7, 3)))
    cols = t_spec.unflatten(batch)
    assert set(cols) == set(t_spec.keys) and cols["x0"].shape == (7,)
    np.testing.assert_array_equal(cols["mix"].numpy(), batch[:, 2].numpy())
    assert t_spec.make([1.0, 2.0, 3.0]) == {"scale": 1.0, "x0": 2.0, "mix": 3.0}
    assert t_spec.index(":x0") == 1
    np.testing.assert_array_equal(t_spec.flatten({"mix": 3.0, "x0": 2.0, "scale": 1.0}).numpy(),
                                  [1.0, 2.0, 3.0])


@pytest.mark.parametrize("model", ["lorder_mixed_bg", "line"])
def test_models_match(model):
    rng = np.random.default_rng(3)
    if model == "line":
        jf, tf, base, x = j_line, t_line, {"m": 2.0, "b": -1.0}, np.linspace(-3, 3, 40)
    else:
        jf, tf, base, x = j_lorder, t_lorder, FLAGSHIP, np.linspace(2000, 3600, 334)
    p = _walker_params(base, rng, 0.05)
    got = tf(torch.as_tensor(x), _cols(p)).numpy()
    want = _jax_batch(jf, p, jnp.asarray(x))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                               err_msg=f"{model} over a walker batch, rtol 1e-12")


@pytest.mark.parametrize("kind", ["normal", "normal_cutoff", "poisson"])
def test_likelihoods_match(kind):
    rng = np.random.default_rng(4)
    x = np.linspace(0.0, 10.0, 60)
    if kind == "poisson":
        y = rng.poisson(5.0 + 2.0 * x).astype(float)
        base, sigma = {"m": 2.0, "b": 5.0}, None
    else:
        y = 2.0 * x + 1.0 + 0.1 * rng.standard_normal(60)
        base, sigma = {"m": 2.0, "b": 1.0}, 1e-3 if kind == "normal_cutoff" else 0.1
    jl = {"normal": jlik.log_likelihood_normal,
          "normal_cutoff": jlik.log_likelihood_normal_cutoff,
          "poisson": jlik.log_likelihood_poisson}[kind]
    tl = {"normal": tlik.log_likelihood_normal,
          "normal_cutoff": tlik.log_likelihood_normal_cutoff,
          "poisson": tlik.log_likelihood_poisson}[kind]
    p = _walker_params(base, rng, 0.05)
    jds = JDataset.create(x, y, sigma, dtype=jnp.float64)
    tds = TDataset.create(x, y, sigma, dtype=torch.float64, device="cpu")
    want = np.asarray(jax.vmap(lambda q: jl(j_line, q, jds))(
        {k: jnp.asarray(v) for k, v in p.items()}))
    got = tl(t_line, _cols(p), tds).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               err_msg=f"{kind} likelihood, rtol 1e-10")
    assert tlik.log_likelihood_normal_weighted is tlik.log_likelihood_normal
    assert tlik.resolve_likelihood(tl, t_line, base, tds) is tl


def test_priors_match_with_walkers_out_of_bounds():
    rng = np.random.default_rng(5)
    base = {"scale": 1.0, "x0": 0.0, "sigma": 1.0}
    p = _walker_params(base, rng, 0.0)
    p["x0"] = rng.uniform(-6.0, 6.0, W)           # many outside (-3, 3)
    p["sigma"] = rng.uniform(-1.0, 4.0, W)        # some below 0.3
    bounds = {"x0": (-3.0, 3.0), ":sigma": (0.3, 5.0)}
    jp = jpri.make_bounds_prior(bounds)
    tp = tpri.make_bounds_prior(bounds)
    want = np.asarray(jax.vmap(lambda q: jp(q, None))(
        {k: jnp.asarray(v) for k, v in p.items()}))
    got = tp({k: torch.as_tensor(v) for k, v in p.items()}).numpy()
    assert (want < 0).sum() > W // 4, "the test must push walkers out of bounds"
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               err_msg="bounds prior, rtol 1e-10")
    assert tp._bounds == bounds and tp._extra is None
    assert tpri.log_prior_flat(p) == 0.0
    pen = tpri.prior_bounds({k: torch.as_tensor(v) for k, v in p.items()}, bounds)
    np.testing.assert_allclose(pen["x0_bound"].numpy(), np.asarray(
        jpri.bound_penalty(jnp.asarray(p["x0"]), -3.0, 3.0)), rtol=1e-10)
    c = tpri.constraint_penalty(torch.as_tensor(p["x0"]) > 0)
    np.testing.assert_array_equal(c.numpy(), np.where(p["x0"] > 0, 0.0, -1e9))
    both = tpri.combine_priors(tp, lambda q, ds=None: 1.0)
    np.testing.assert_allclose(both({k: torch.as_tensor(v) for k, v in p.items()}).numpy(),
                               want + 1.0, rtol=1e-10)


def test_cholesky_clamped_spd_and_singular():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((3, 6, 6))
    spd = a @ np.swapaxes(a, 1, 2) + 0.1 * np.eye(6)
    # Exactly singular (pivot 2 is 1 - 1 = 0) and indefinite (pivot 4 is
    # -1): both clamped to 0, in arithmetic that is exact on both sides.
    singular = np.zeros((1, 6, 6))
    singular[0, :2, :2] = [[4.0, 2.0], [2.0, 1.0]]
    singular[0, 2:, 2:] = np.diag([9.0, -1.0, 16.0, 1.0])
    singular[0, 5, 2] = singular[0, 2, 5] = 1.5
    nan = np.full((1, 6, 6), np.nan)
    for m in (spd, singular, nan):
        tl, tok = tlin.cholesky_clamped(torch.as_tensor(m))
        jl, jok = jlin.cholesky_clamped(jnp.asarray(m))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12, atol=1e-12,
                                   err_msg="cholesky_clamped, rtol 1e-12")
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tlin.cholesky_clamped(torch.as_tensor(spd))[1].all()
    assert not tlin.cholesky_clamped(torch.as_tensor(singular))[1].any()


def test_covariances_and_haario_match():
    rng = np.random.default_rng(7)
    s = rng.standard_normal((500, 4)) @ rng.standard_normal((4, 4))
    w = (rng.random(500) > 0.3).astype(float)
    np.testing.assert_allclose(tlin.sample_covariance(torch.as_tensor(s)).numpy(),
                               np.asarray(jlin.sample_covariance(jnp.asarray(s))),
                               rtol=1e-12)
    np.testing.assert_allclose(
        tlin.sample_covariance(torch.as_tensor(s), torch.as_tensor(w)).numpy(),
        np.asarray(jlin.sample_covariance(jnp.asarray(s), jnp.asarray(w))), rtol=1e-12)
    m_sum, m_outer, m_count = s.sum(0), s.T @ s, float(len(s))
    got = tlin.moments_covariance(torch.as_tensor(m_sum)[None],
                                  torch.as_tensor(m_outer)[None],
                                  torch.as_tensor([m_count]))[0].numpy()
    want = np.asarray(jlin.moments_covariance(jnp.asarray(m_sum), jnp.asarray(m_outer),
                                              m_count))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert tlin.haario_scale(6) == jlin.haario_scale(6)
