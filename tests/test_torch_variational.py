"""ADVI of the PyTorch port against the JAX package.

``lisp_mcmc_torch.variational`` against ``lisp_mcmc_tpu.variational``, in
float64 on the CPU (the port's value-only posterior is kernel 1's plain
version here):

- the optimizer (``_ClippedAdam``) against optax's ``chain(
  clip_by_global_norm(10), adam(cosine_decay_schedule))`` on a fixed
  gradient sequence with non-finite entries and gradients above the clip
  norm, past the decay's end, one row and two independent rows, at 1e-13;
- the z-space log posterior and its gradient against
  ``jax.value_and_grad`` of JAX's ``_z_space_setup`` at 1e-10 on a box
  prior, a named ``PriorSpec``, an ``MVGaussian`` (the ``slogdet`` path;
  JAX's ``MVGaussian.inverse`` refuses a batch, so it is mapped over the
  walkers) and a custom prior (the whitened path), points past the
  sigmoid's range (floored to -1e12, their gradients NaN in both)
  included;
- ``advi`` draw for draw, both ranks, on the box and the whitened
  z-spaces, with JAX's draws (its per-step ``split`` stream from
  ``PRNGKey(seed)`` and the evaluation at ``PRNGKey(seed + 1)``)
  replayed through ``_draws``: the
  ELBO trace, q's averaged ``mu`` and Cholesky factor, the moments and the
  evidence fields at 1e-9; ``to_mvgaussian``; ``seed_walker``'s positions
  and logprobs;
- ``advi_per_dataset`` the same way on a 3-dataset ``BatchedFit`` (the
  JAX batch's state and datasets carried across), with and without a spec;
- the port's own draws: the exactly Gaussian line posterior recovered;
- the refusals, with the JAX package's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import variational as tv
from lisp_mcmc_torch.models import line as t_line
from lisp_mcmc_tpu import variational as jv
from lisp_mcmc_tpu.models import line as j_line

from test_torch_batched import carry

RTOL = 1e-9
SIGMA = 0.05
BOUNDS = {"b": (-3.0, 5.0), "m": (-2.0, 4.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same(t, j, msg="", rtol=RTOL):
    np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                               rtol=rtol, atol=1e-12, err_msg=msg)


def line_data(seed=0, n=40, slope=0.5):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 2.0, n)
    return x, 1.0 + slope * x + SIGMA * rng.standard_normal(n)


def custom_prior(params, dataset=None):
    return -0.5 * (params["b"] / 10.0) ** 2 - 0.5 * (params["m"] / 10.0) ** 2


MV_COV = [[0.25, 0.05], [0.05, 0.16]]


def priors(kind):
    """(JAX prior, port prior) of each z-space kind."""
    if kind == "box":
        return jfit.make_bounds_prior(BOUNDS), tfit.make_bounds_prior(BOUNDS)
    if kind == "named":
        return (jfit.PriorSpec({"b": jfit.Gaussian(1.0, 0.5), "m": jfit.Gaussian(0.5, 0.5)}),
                tfit.PriorSpec({"b": tfit.Gaussian(1.0, 0.5), "m": tfit.Gaussian(0.5, 0.5)}))
    if kind == "mv":
        return (jfit.MVGaussian({"b": 1.0, "m": 0.5}, MV_COV),
                tfit.MVGaussian({"b": 1.0, "m": 0.5}, MV_COV))
    return custom_prior, custom_prior


def walker_pair(kind="box", W=64, seed=0):
    """A JAX line walker and the port's, both holding one seeded ensemble
    near the posterior (VI reads only the positions)."""
    x, y = line_data()
    jp, tp = priors(kind)
    common = dict(function=None, data=(x, y), params={"b": 1.0, "m": 0.5},
                  data_error=SIGMA, n_walkers=W, seed=seed)
    pos = np.array([1.0, 0.5]) + np.array([0.03, 0.025]) * \
        np.random.default_rng(seed + 11).standard_normal((W, 2))
    if kind == "mv":
        # JAX's MVGaussian.inverse refuses a (W, d) batch (its
        # solve_triangular wants matching batch dimensions; the port's
        # takes any leading axes): map it over the walkers instead.
        jp.inverse = jax.vmap(jp.inverse, in_axes=(0, None))
    jw = jfit.walker_create(**{**common, "function": j_line}, log_prior=jp)
    jw.state = dataclasses.replace(jw.state, position=jnp.asarray(pos))
    tw = tfit.walker_create(**{**common, "function": t_line}, log_prior=tp,
                            dtype=torch.float64, device="cpu")
    tw.state = dataclasses.replace(tw.state, position=torch.as_tensor(pos))
    return jw, tw


class Replay:
    """``variational._draws`` returning a given list of arrays in order,
    each checked against the shape asked for."""

    def __init__(self, monkeypatch, arrays):
        self.arrays = list(arrays)
        monkeypatch.setattr(tv, "_draws", self)

    def __call__(self, generator, shape, dtype, device):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def jax_step_draws(key, n_steps, shape):
    """The JAX optimizer loop's eps: ``k, sub = split(k)`` each step."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float64)))
    return out


def jax_advi_draws(seed, n_steps, n_mc, d, n_eval):
    return (jax_step_draws(jax.random.PRNGKey(seed), n_steps, (n_mc, d))
            + [np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (n_eval, d),
                                            jnp.float64))])


def jax_per_dataset_draws(seed, S, n_steps, n_mc, d, n_eval):
    """Per dataset ``PRNGKey(seed + s)``'s step stream, stacked over s, then
    each dataset's evaluation at ``fold_in(key, 1)``."""
    keys = [jax.random.PRNGKey(seed + s) for s in range(S)]
    per = [jax_step_draws(k, n_steps, (n_mc, d)) for k in keys]
    steps = [np.stack([per[s][i] for s in range(S)]) for i in range(n_steps)]
    ev = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, 1), (n_eval, d),
                                                jnp.float64)) for k in keys])
    return steps + [ev]


# ------------------------------------------------------------- optimizer


def test_optimizer_matches_optax():
    import optax

    rng = np.random.default_rng(0)
    n_steps, lr, alpha = 10, 0.05, 0.05
    grads = [rng.standard_normal((2, 7)) for _ in range(14)]
    grads[3][0, 1] = np.nan
    grads[5][1, 4] = np.inf
    grads[7] *= 100.0                      # above the clip norm in both rows
    grads[9][1] *= 50.0                    # above it in one row
    p0 = rng.standard_normal((2, 7))
    opt = optax.chain(optax.clip_by_global_norm(10.0),
                      optax.adam(optax.cosine_decay_schedule(lr, n_steps, alpha=alpha)))

    @jax.jit
    def update(g, st, p):
        g = jax.tree_util.tree_map(lambda t: jnp.where(jnp.isfinite(t), t, 0.0), g)
        upd, st = opt.update(g, st, p)
        return optax.apply_updates(p, upd), st

    def jax_run(row):
        p = {"a": jnp.asarray(p0[row, :3]), "b": jnp.asarray(p0[row, 3:].reshape(2, 2))}
        st = opt.init(p)
        out = []
        for g in grads:
            g = {"a": jnp.asarray(g[row, :3]), "b": jnp.asarray(g[row, 3:].reshape(2, 2))}
            p, st = update(g, st, p)
            out.append(np.concatenate([np.asarray(p["a"]), np.asarray(p["b"]).ravel()]))
        return out

    ref = [jax_run(0), jax_run(1)]
    for rows in ([0], [0, 1]):
        flat = torch.as_tensor(p0[rows])
        topt = tv._ClippedAdam(flat, lr, n_steps, alpha)
        sched = torch.as_tensor(topt.schedule(len(grads)))
        for i, g in enumerate(grads):
            topt.step(flat, torch.as_tensor(g[rows]), sched[i])
            for r, row in enumerate(rows):
                np.testing.assert_allclose(flat[r].numpy(), ref[row][i], rtol=1e-13,
                                           atol=1e-15, err_msg=f"step {i} row {row}")


# ------------------------------------------------------------- z-space


@pytest.mark.parametrize("kind", ["box", "named", "mv", "custom"])
def test_z_space_log_posterior_and_gradient_match_jax(kind):
    jw, tw = walker_pair(kind)
    keys, d, data, spec, theta_of_z, z0, log_v, logp_z, scales = jv._z_space_setup(
        jw, None, None)
    zs = tv._walker_z_space(tw, None, None, "advi")
    same(zs.z0, z0, "z0", rtol=1e-12)
    assert zs.log_v == pytest.approx(log_v, rel=1e-14)
    assert (zs.spec is None) == (spec is None) and zs.keys == list(keys)
    if scales is not None:
        same(zs.scales, scales, "scales", rtol=0)
    rng = np.random.default_rng(3)
    z = z0.mean(axis=0) + 3.0 * z0.std(axis=0) * rng.standard_normal((12, d))
    if spec is not None:
        z[-2:, 0] = [40.0, -45.0]           # past the sigmoid's range: floored
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(logp_z), in_axes=(0, None)))(
        jnp.asarray(z), data)
    zt = torch.as_tensor(z).requires_grad_(True)
    tl = tv._logp_z_fn(zs, tw._log_post)(zt)
    (tg,) = torch.autograd.grad(tl.sum(), zt)
    same(tl.detach(), jl, "logp_z", rtol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10,
                               equal_nan=True, err_msg="gradient")
    if spec is not None:
        # floored in both, their gradients NaN in both (the NaN of log's
        # 0/0 reaches z through the clip's 0/1 factor)
        assert np.all(np.asarray(jl)[-2:] == -1e12) and np.all(np.asarray(jl)[:-2] > -1e12)
        assert np.isnan(tg.numpy()[-2:]).any()
    same(zs.theta_of_z(torch.as_tensor(z)).numpy(),
         jax.jit(jax.vmap(theta_of_z))(jnp.asarray(z)), "theta", rtol=1e-12)


# ------------------------------------------------------------- advi


def compare_vi(t, j, rtol=RTOL):
    same(t.elbo_trace, j.elbo_trace, "elbo_trace", rtol)
    same(t._mu, j._mu, "mu", rtol)
    same(t._chol, j._chol, "chol", rtol)
    same(t.cov, j.cov, "cov", rtol)
    for k in j.keys:
        assert t.mean[k] == pytest.approx(j.mean[k], rel=rtol), k
        assert t.sd[k] == pytest.approx(j.sd[k], rel=rtol), k
    for f in ("elbo", "log_z", "log_z_error"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a == pytest.approx(b, rel=rtol), f
    np.testing.assert_allclose(t.pareto_k, j.pareto_k, rtol=1e-6, atol=1e-9,
                               equal_nan=True)
    assert (t.rank, t.n_steps, t.keys) == (j.rank, j.n_steps, j.keys)


@pytest.mark.parametrize("kind,rank", [("box", "full"), ("box", "meanfield"),
                                       ("custom", "full")])
def test_advi_matches_jax_draw_for_draw(monkeypatch, kind, rank):
    jw, tw = walker_pair(kind)
    kw = dict(rank=rank, n_steps=30, n_samples=8, n_eval=128, seed=3)
    j = jv.advi(jw, **kw)
    Replay(monkeypatch, jax_advi_draws(3, 30, 8, 2, 128))
    t = tw.advi(**kw)
    compare_vi(t, j)
    if kind != "box" or rank != "full":
        return
    mt, mj = t.to_mvgaussian(inflate=1.5), j.to_mvgaussian(inflate=1.5)
    same(mt.mean, mj._mean, "mv mean", 1e-9)
    same(mt._cov, mj._cov, "mv cov", 1e-9)
    # seed_walker from q's draws at PRNGKey(2)
    Replay(monkeypatch, [np.asarray(jax.random.normal(jax.random.PRNGKey(2), (64, 2),
                                                      jnp.float64))])
    j.seed_walker(jw, seed=2)
    assert t.seed_walker(tw, seed=2) is tw
    same(tw.state.position.numpy(), jw.state.position, "seeded positions")
    same(tw.state.logprob.numpy(), jw.state.logprob, "seeded logprobs")
    same(tw.state.best_position.numpy(), tw.state.position.numpy(), "best", 0)
    assert tw.steps()[0].shape == (64, 2)        # history dropped: the live ensemble


@pytest.mark.parametrize("spec", [True, False])
def test_advi_per_dataset_matches_jax_draw_for_draw(monkeypatch, spec):
    data = [line_data(s, slope=m) for s, m in enumerate((0.5, -1.2, 0.8))]
    jkw = {"log_prior": jfit.make_bounds_prior(BOUNDS)} if spec else {}
    tkw = {"log_prior": tfit.make_bounds_prior(BOUNDS)} if spec else {}
    common = dict(data_error=SIGMA, walkers_per_dataset=32, seed=0, walker_jitter=0.05)
    jb = jfit.BatchedFit(j_line, data, {"b": 1.0, "m": 0.2}, **common, **jkw)
    tb = tfit.BatchedFit(t_line, data, {"b": 1.0, "m": 0.2}, dtype=torch.float64,
                         device="cpu", **common, **tkw)
    carry(jb, tb)
    kw = dict(n_steps=30, n_samples=8, n_eval=128, seed=5)
    jr = jv.advi_per_dataset(jb, **kw)
    Replay(monkeypatch, jax_per_dataset_draws(5, 3, 30, 8, 2, 128))
    tr = tb.advi_per_dataset(**kw)
    assert len(tr) == 3
    for s, (t, j) in enumerate(zip(tr, jr)):
        compare_vi(t, j)
    # each result's own z-map: dataset 2's sample at PRNGKey(1)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (16, 2), jnp.float64))
    Replay(monkeypatch, [eps])
    same(tr[2].sample(16, seed=1), jr[2].sample(16, seed=1), "dataset 2 sample")


def test_advi_recovers_the_exact_gaussian_posterior():
    """The port's own draws (JAX tests/test_vi.py:44's gates): full rank
    recovers the line's analytic mean and sds; its IS evidence is within
    0.1 of the least-squares Laplace closed form; the trace improves."""
    x, y = line_data()
    w = tfit.walker_create(function=t_line, data=(x, y), params={"b": 1.0, "m": 0.5},
                           data_error=SIGMA, log_prior=tfit.make_bounds_prior(BOUNDS),
                           n_walkers=128, seed=0, walker_jitter=0.1, dtype=torch.float64,
                           device="cpu")
    vi = w.advi(n_steps=400, n_samples=8, seed=3)
    A = np.stack([np.ones_like(x), x], axis=1)
    cov = np.linalg.inv(A.T @ A / SIGMA ** 2)
    mean = cov @ (A.T @ y / SIGMA ** 2)
    assert abs(vi.mean["b"] - mean[0]) < 4e-2 and abs(vi.mean["m"] - mean[1]) < 4e-2
    assert vi.sd["b"] == pytest.approx(np.sqrt(cov[0, 0]), rel=0.15)
    assert vi.sd["m"] == pytest.approx(np.sqrt(cov[1, 1]), rel=0.15)
    r = y - A @ mean
    log_l = float(np.sum(-0.5 * np.log(2 * np.pi * SIGMA ** 2) - 0.5 * (r / SIGMA) ** 2))
    log_z = log_l + np.log(2 * np.pi) + 0.5 * np.log(np.linalg.det(cov)) - np.log(48.0)
    assert vi.log_z == pytest.approx(log_z, abs=0.1)
    assert vi.converged_evidence and vi.elbo <= vi.log_z + 1e-6
    assert np.mean(vi.elbo_trace[-50:]) > np.mean(vi.elbo_trace[:20])


def test_refusals_match_jax():
    data = [line_data(s) for s in range(2)]
    kw = dict(data_error=SIGMA, walkers_per_dataset=8, seed=0)
    jb = jfit.BatchedFit(j_line, data, {"b": 1.0, "m": 0.5}, **kw)
    tb = tfit.BatchedFit(t_line, data, {"b": 1.0, "m": 0.5}, dtype=torch.float64,
                         device="cpu", **kw)
    jw, tw = walker_pair("box", W=16)

    def message(fn, *args, **kwargs):
        with pytest.raises(ValueError) as e:
            fn(*args, **kwargs)
        return str(e.value)

    cases = [((jv.advi, tv.advi), (jb, tb), {}),
             ((jv.flow_advi, tv.flow_advi), (jb, tb), {}),
             ((jv.advi, tv.advi), (jw, tw), {"rank": "banana"}),
             ((jv.advi, tv.advi), (jw, tw), {"n_steps": 0}),
             ((jv.flow_advi, tv.flow_advi), (jw, tw), {"n_layers": 0}),
             ((jv.advi_per_dataset, tv.advi_per_dataset), (jw, tw), {}),
             ((jv.flow_advi_per_dataset, tv.flow_advi_per_dataset), (jw, tw), {}),
             ((jv.advi, tv.advi), (jw, tw), {"bounds": {"b": (0.0, 2.0)}})]
    for (jf, tf), (ja, ta), kwargs in cases:
        assert message(tf, ta, **kwargs) == message(jf, ja, **kwargs), (tf, kwargs)
    assert "advi_per_dataset" in message(tb.advi)
