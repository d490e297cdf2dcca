"""Named priors (``lisp_mcmc_torch.priors``) against the JAX package.

The same numpy inputs go through ``lisp_mcmc_tpu.priors`` (x64, CPU) and
the port (float64, CPU):

- every distribution's ``log_pdf``, ``installed_log_pdf``, ``wall``,
  ``cdf``, ``icdf`` and mass, at rtol 1e-12 (an infinite value equal),
  on grids that cross each edge: the support's, a truncation's, x <= 0
  for the LogNormal, and u at 0 and 1; ``to_meta``/``from_meta`` equal;
- ``sample`` bit for bit from the same numpy ``Generator``;
- ``PriorSpec`` and ``MVGaussian``: ``log_pdf``, ``installed_vec``,
  ``transform``, ``inverse``, ``as_log_prior`` at 1e-12, the Mapping
  protocol, ``as_prior_spec``, ``resolve_prior_spec``, ``unit_cube_wall``;
- the JAX package's traps: the LogNormal clamp in float32 (finite at x
  <= 0), a half-open truncation's wall, ``Uniform`` refusing infinite
  bounds, ``MVGaussian.__getitem__`` raising ``KeyError``, and a
  pure-Uniform spec carrying ``_bounds`` and ``_extra = None``, which
  runs the bounds table bit for bit;
- ``walker_create(log_prior=spec)`` (and an ``MVGaussian``, and a list
  per term) against the JAX walker's logprob at 1e-12.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import models, priors as tp
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_tpu import priors as jp
from lisp_mcmc_tpu.models import zoo as jzoo

RTOL = 1e-12

DISTS = [
    ("uniform", dict(low=-1.0, high=3.0)),
    ("gaussian", dict(mu=1.0, sigma=2.0)),
    ("gaussian", dict(mu=1.0, sigma=2.0, low=0.0)),
    ("gaussian", dict(mu=1.0, sigma=2.0, high=2.5)),
    ("gaussian", dict(mu=-0.5, sigma=0.7, low=-1.0, high=3.0)),
    ("lognormal", dict(mu=0.0, sigma=1.0)),
    ("lognormal", dict(mu=0.5, sigma=0.3, low=0.5)),
    ("lognormal", dict(mu=0.0, sigma=1.0, low=0.0, high=5.0)),
    ("lognormal", dict(mu=-1.0, sigma=0.5, low=0.05, high=3.0)),
]
IDS = [f"{k}-{'-'.join(f'{a}{v:g}' for a, v in kw.items())}" for k, kw in DISTS]
CLASSES = {"uniform": "Uniform", "gaussian": "Gaussian", "lognormal": "LogNormal"}


def _pair(kind, kw):
    name = CLASSES[kind]
    return getattr(jp, name)(**kw), getattr(tp, name)(**kw)


def _close(got, want, msg, atol=1e-300):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    inf = ~np.isfinite(want)
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=msg)
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=RTOL, atol=atol, err_msg=msg)


# The CDF maps' values are of order 1 (u) or of the parameter's scale
# (theta), and cancel at a truncation point (z - z_low, or mu + sigma
# ndtri(z_low)) to one ulp of the scale, where two ndtr/ndtri
# implementations may differ: they are held at rtol 1e-12 with atol 1e-15.
MAP_ATOL = 1e-15


X = np.concatenate([np.linspace(-4.0, 8.0, 241), [-1.0, 0.0, 0.05, 0.5, 2.5, 3.0, 5.0,
                                                   1e-300, -1e-300, 1e3]])
U = np.concatenate([np.linspace(0.0, 1.0, 101), [1e-12, 1 - 1e-12]])


@pytest.mark.parametrize("kind,kw", DISTS, ids=IDS)
def test_distribution_matches_jax(kind, kw):
    jd, td = _pair(kind, kw)
    x = torch.as_tensor(X)
    for fn in ("log_pdf", "installed_log_pdf", "wall"):
        _close(getattr(td, fn)(x).numpy(), getattr(jd, fn)(jnp.asarray(X)),
               f"{kind} {kw} {fn}")
    _close(td.cdf(x).numpy(), jd.cdf(jnp.asarray(X)), f"{kind} cdf", MAP_ATOL)
    _close(td.icdf(torch.as_tensor(U)).numpy(), jd.icdf(jnp.asarray(U)), f"{kind} icdf",
           MAP_ATOL)
    assert td.support == jd.support
    assert td.to_meta() == jd.to_meta()
    assert tp._dist_from_meta(td.to_meta()) == td
    if kind != "uniform":
        assert td._log_mass == pytest.approx(jd._log_mass, rel=RTOL, abs=1e-300)
        assert td.truncated == (not bool(np.all(np.asarray(jd.wall(jnp.asarray(X))) == 0)))
    # a Python number in, a float64 0-d value out
    assert td.log_pdf(1.5).dtype == torch.float64 and td.log_pdf(1.5).ndim == 0


@pytest.mark.parametrize("kind,kw", DISTS, ids=IDS)
def test_sample_is_bit_identical(kind, kw):
    jd, td = _pair(kind, kw)
    a = jd.sample(np.random.default_rng(11), 257)
    b = td.sample(np.random.default_rng(11), 257)
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_lognormal_clamp_is_the_columns_tiny_in_float32():
    """``log(max(x, tiny))`` with the column type's tiny: in float32 a
    literal 1e-300 is 0 and the value would be NaN at x <= 0."""
    d = tp.LogNormal(0.0, 1.0)
    x = torch.tensor([-2.0, 0.0, 1e-30, 1.0], dtype=torch.float32)
    v = d.installed_log_pdf(x)
    assert v.dtype == torch.float32 and bool(torch.isfinite(v).all())
    jd = jp.LogNormal(0.0, 1.0)
    want = np.asarray(jd.installed_log_pdf(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(v.numpy(), want, rtol=1e-6)
    lx = math.log(np.finfo(np.float32).tiny)
    assert v[0].item() == pytest.approx(-lx - 0.5 * lx * lx - 0.5 * math.log(2 * math.pi),
                                        rel=1e-6)


def test_half_open_truncation_wall():
    """The infinite edge goes into bound_penalty as it is: no wall on the
    open side, the reference's penalty past the finite one."""
    for jd, td in (_pair("gaussian", dict(mu=0.0, sigma=1.0, low=-1.0)),
                   _pair("gaussian", dict(mu=0.0, sigma=1.0, high=2.0)),
                   _pair("lognormal", dict(mu=0.0, sigma=1.0, low=0.5))):
        x = np.array([-1e6, -3.0, -1.0, 0.0, 0.5, 2.0, 3.0, 1e6])
        w = td.wall(torch.as_tensor(x)).numpy()
        _close(w, jd.wall(jnp.asarray(x)), f"{td} wall")
        lo, hi = td.support
        inside = (x > lo) & (x < hi)
        assert np.all(w[inside] == 0.0) and np.all(w[~inside] <= 0.0)
        assert np.all(np.isfinite(w))


def test_constructors_refuse_as_jax_does():
    with pytest.raises(ValueError, match="finite"):
        tp.Uniform(0.0, math.inf)
    with pytest.raises(ValueError, match="finite"):
        tp.Uniform(-math.inf, 0.0)
    with pytest.raises(ValueError, match="high > low"):
        tp.Uniform(1.0, 1.0)
    with pytest.raises(ValueError, match="sigma > 0"):
        tp.Gaussian(0.0, 0.0)
    with pytest.raises(ValueError, match="no mass"):
        tp.Gaussian(0.0, 1.0, low=60.0, high=61.0)
    with pytest.raises(ValueError, match="0 <= low"):
        tp.LogNormal(0.0, 1.0, low=-1.0)
    with pytest.raises(ValueError, match="distribution or"):
        tp.PriorSpec({"a": 3.0})


KEYS = ("m", "b", "c")


def _specs():
    dists = {"m": ("gaussian", dict(mu=1.0, sigma=2.0, low=0.0)),
             "b": ("lognormal", dict(mu=0.0, sigma=0.5)),
             "c": ("uniform", dict(low=-1.0, high=2.0))}
    j = jp.PriorSpec({k: _pair(*v)[0] for k, v in dists.items()})
    t = tp.PriorSpec({k: _pair(*v)[1] for k, v in dists.items()})
    return j, t


def _mv():
    a = np.random.default_rng(5).standard_normal((3, 3))
    cov = a @ a.T + 0.5 * np.eye(3)
    mean = {"b": 0.5, "m": 1.0, "c": -0.25}            # not the fit's order
    return jp.MVGaussian(mean, cov), tp.MVGaussian(mean, cov)


@pytest.mark.parametrize("which", ["spec", "mv_gaussian"])
def test_spec_maps_match_jax(which):
    js, ts = _specs() if which == "spec" else _mv()
    rng = np.random.default_rng(3)
    theta = np.column_stack([rng.uniform(0.05, 3.0, 64), rng.uniform(0.1, 3.0, 64),
                             rng.uniform(-0.9, 1.9, 64)])
    u = rng.uniform(0.0, 1.0, (64, 3))
    u[0] = [0.0, 1.0, 0.5]
    for i in range(64):
        _close(ts.installed_vec(torch.as_tensor(theta[i]), KEYS).numpy(),
               js.installed_vec(jnp.asarray(theta[i]), KEYS), f"{which} installed_vec")
        _close(ts.transform(torch.as_tensor(u[i]), KEYS).numpy(),
               js.transform(jnp.asarray(u[i]), KEYS), f"{which} transform", MAP_ATOL)
    # batched: (W, d) at once gives the rows
    np.testing.assert_allclose(ts.installed_vec(torch.as_tensor(theta), KEYS).numpy(),
                               [float(js.installed_vec(jnp.asarray(t), KEYS)) for t in theta],
                               rtol=RTOL)
    _close(ts.inverse(torch.as_tensor(theta), KEYS).numpy(),
           np.stack([js.inverse(jnp.asarray(t), KEYS) for t in theta]), f"{which} inverse",
           MAP_ATOL)
    params = dict(zip(KEYS, theta.T))
    want = [float(js.log_pdf({k: jnp.asarray(v[i]) for k, v in params.items()}))
            for i in range(64)]
    got = ts.log_pdf({k: torch.as_tensor(v) for k, v in params.items()}).numpy()
    _close(got, want, f"{which} log_pdf")
    jprior, tprior = js.as_log_prior(), ts.as_log_prior()
    want = [float(jprior({k: jnp.asarray(v[i]) for k, v in params.items()})) for i in range(64)]
    _close(tprior({k: torch.as_tensor(v) for k, v in params.items()}).numpy(), want,
           f"{which} as_log_prior")
    assert tprior._prior_spec is ts
    assert ts.to_meta() == js.to_meta()
    assert tp.PriorSpec.from_meta(ts.to_meta()) == ts
    a = js.sample(np.random.default_rng(4), 100, KEYS)
    b = ts.sample(np.random.default_rng(4), 100, KEYS)
    np.testing.assert_array_equal(b, a)


def test_mapping_protocol_and_resolution():
    js, ts = _specs()
    jm, tm = _mv()
    assert list(ts) == list(js) and len(ts) == 3 and ts["m"] == tp.Gaussian(1.0, 2.0, low=0.0)
    assert ts.bounds is None and not ts.is_uniform
    box = tp.PriorSpec({"a": (0.0, 1.0), ":b": tp.Uniform(-1.0, 1.0)})
    assert box.is_uniform and box.bounds == {"a": (0.0, 1.0), "b": (-1.0, 1.0)}
    assert tm["m"] == tp.Gaussian(*(float(v) for v in (jm["m"].mu, jm["m"].sigma)))
    with pytest.raises(KeyError):
        tm["nope"]
    assert "nope" not in tm and "m" in tm
    assert tp.as_prior_spec(tm) is tm and tp.as_prior_spec(ts) is ts
    assert tp.as_prior_spec({"a": (0.0, 1.0)}) == box.__class__({"a": (0.0, 1.0)})
    with pytest.raises(ValueError, match="expected a PriorSpec"):
        tp.as_prior_spec(3.0)
    with pytest.raises(ValueError, match="missing"):
        ts.transform(torch.zeros(2), ("m", "zz"))
    with pytest.raises(ValueError, match="jointly"):
        tm.transform(torch.zeros(2), ("m", "b"))

    class Laplace:
        mode, cov, n_clamped = {"m": 1.0, "b": 2.0}, np.diag([1.0, 4.0]), 0

    mv = tp.MVGaussian.from_laplace(Laplace, inflate=2.0)
    np.testing.assert_allclose(mv._cov, np.diag([4.0, 16.0]))
    Laplace.n_clamped = 1
    with pytest.raises(ValueError, match="clamped"):
        tp.MVGaussian.from_laplace(Laplace)

    class W:
        terms = [type("T", (), {"prior": tp.make_bounds_prior({"a": (0.0, 2.0)})})()]

    assert tp.resolve_prior_spec(W) == tp.PriorSpec({"a": (0.0, 2.0)})
    W.terms[0].prior = ts.as_log_prior()
    assert tp.resolve_prior_spec(W) is ts
    assert tp.resolve_prior_spec(W, bounds={"a": (0.0, 1.0)}) == tp.PriorSpec({"a": (0.0, 1.0)})
    assert tp.resolve_prior_spec(W, prior=tm) is tm


def test_unit_cube_wall_matches_jax():
    u = np.random.default_rng(8).uniform(-0.2, 1.2, (50, 4))
    u[0] = [0.5, 0.5, 0.5, 0.5]
    got = tp.unit_cube_wall(torch.as_tensor(u)).numpy()
    want = [float(jp.unit_cube_wall(jnp.asarray(r))) for r in u]
    _close(got, want, "unit_cube_wall")
    assert got[0] == 0.0


def test_pure_uniform_spec_runs_the_bounds_table_exactly():
    """A spec of boxes carries ``_bounds`` and ``_extra = None``: the
    kernels' split takes it as the bounds table, the plain kernel version
    gives the same bits as ``make_bounds_prior``'s, and so does the
    prior itself."""
    box = {"m": (0.5, 4.0), "b": (-1.0, 3.0)}
    spec = tp.PriorSpec(box)
    prior = spec.as_log_prior()
    assert prior._bounds == box and prior._extra is None and prior._prior_spec is spec
    keys = ("m", "b")
    assert tlk.split_prior(prior, keys) == tlk.split_prior(tp.make_bounds_prior(box), keys)
    x = np.linspace(0.0, 1.0, 30)
    y = 2.0 * x + 1.0
    kw = dict(function=models.line, data=(x, y), params={"m": 2.0, "b": 1.0},
              data_error=0.1, n_walkers=64, walker_jitter=1.5, dtype=torch.float32,
              device="cpu", seed=3)
    a = tfit.walker_create(log_prior=spec, **kw)
    b = tfit.walker_create(log_prior=tfit.make_bounds_prior(box), **kw)
    assert torch.equal(a.state.logprob, b.state.logprob)
    assert (a.state.logprob < -1e3).any(), "some walkers must be outside the boxes"
    pa = tlk.prepare_fused_terms(a.terms, a.spec, torch.float32)
    pb = tlk.prepare_fused_terms(b.terms, b.spec, torch.float32)
    assert pa.densities == () and pa.bounds == pb.bounds
    assert torch.equal(tlk.fused_posterior(a.state.position, pa),
                       tlk.fused_posterior(b.state.position, pb))


def _line_data():
    rng = np.random.default_rng(2)
    x = np.linspace(-1.0, 2.0, 50)
    return x, 1.5 * x + 0.7 + 0.05 * rng.standard_normal(50)


@pytest.mark.parametrize("which", ["spec", "mv_gaussian", "per_term"])
def test_walker_create_with_a_named_prior_matches_jax(which):
    x, y = _line_data()
    params = {"m": 1.5, "b": 0.7}
    if which == "mv_gaussian":
        cov = [[0.04, 0.01], [0.01, 0.09]]
        jprior = jp.MVGaussian({"b": 0.5, "m": 1.4}, cov)
        tprior = tp.MVGaussian({"b": 0.5, "m": 1.4}, cov)
    else:
        jprior = jp.PriorSpec({"m": jp.Gaussian(1.4, 0.3, low=0.0), "b": jp.LogNormal(0.0, 1.0)})
        tprior = tp.PriorSpec({"m": tp.Gaussian(1.4, 0.3, low=0.0), "b": tp.LogNormal(0.0, 1.0)})
    common = dict(params=params, data_error=0.05, n_walkers=64, walker_jitter=0.8, seed=1)
    if which == "per_term":
        jw = jfit.walker_create(function=[jzoo.line, jzoo.line], data=[(x, y), (x, y)],
                                log_prior=[jprior, None], dtype=jnp.float64, **common)
        tw = tfit.walker_create(function=[models.line, models.line], data=[(x, y), (x, y)],
                                log_prior=[tprior, None], dtype=torch.float64, device="cpu",
                                **common)
    else:
        jw = jfit.walker_create(function=jzoo.line, data=(x, y), log_prior=jprior,
                                dtype=jnp.float64, **common)
        tw = tfit.walker_create(function=models.line, data=(x, y), log_prior=tprior,
                                dtype=torch.float64, device="cpu", **common)
    assert tw.terms[0].prior._prior_spec is tprior
    pos = np.array(jw.state.position)
    pos[::5, 1] = -0.5                          # the LogNormal's x <= 0
    want = np.asarray([float(jw._log_post_one(jnp.asarray(p), jw._posterior_data()))
                       for p in pos])
    got = tw._log_post(torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    post = tlk.prepare_fused_terms(tw.terms, tw.spec, torch.float64)
    assert post.rest == ()
    assert tlk.posterior_rel_err(tlk.fused_posterior(torch.as_tensor(pos), post),
                                 torch.as_tensor(want), post) <= 1e-12
