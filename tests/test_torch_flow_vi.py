"""RealNVP flow VI, NeuTra and flow checkpoints of the PyTorch port against
the JAX package.

``lisp_mcmc_torch.variational``'s flows against ``lisp_mcmc_tpu``'s, in
float64 on the CPU:

- the forward pass and its log-determinant from the same parameters
  (carried by ``convert.flow_params_from_numpy``) at 1e-12, one flow and
  two stacked;
- ``flow_advi`` and ``flow_advi_per_dataset`` (2 datasets) draw for draw,
  JAX's draws replayed through ``_draws`` (``test_torch_variational``'s
  key schedules): the ELBO trace, every averaged parameter, the moments
  and the evidence fields at 1e-9;
- checkpoints across both packages: a JAX ``save`` loaded by the port's
  ``load_flow`` and a port ``save`` by JAX's map the same eps to the same
  theta at 1e-12, summaries intact; a checkpoint reloaded against a fit
  that resolves the other z-space raises in both;
- NeuTra's latent target (``log p(T(eps)) + log|det|``) at seeded eps
  equal to JAX's at 1e-10, through the flow's surface and through the
  port's latent walker; the port's own short ``neutra_sample`` (mala, 400
  steps, 64 walkers) recovers the posterior mean within 5 sd (JAX
  tests/test_flow_vi.py:300's gate) and leaves the caller's walker as it
  was.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import variational as tv
from lisp_mcmc_torch.convert import flow_params_from_numpy
from lisp_mcmc_torch.models import line as t_line
from lisp_mcmc_tpu import variational as jv
from lisp_mcmc_tpu.models import line as j_line

from test_torch_batched import carry
from test_torch_variational import (BOUNDS, SIGMA, Replay, custom_prior, jax_advi_draws,
                                    jax_per_dataset_draws, line_data, same, walker_pair)

RTOL = 1e-9
FLOW = dict(n_layers=2, hidden=8, n_steps=24, n_samples=16, n_eval=128, seed=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_params(rng, lead, d, hidden, n_layers):
    """Flow parameters with every leaf non-zero (a trained-looking flow)."""
    def r(*shape, s=0.3):
        return s * rng.standard_normal((*lead, *shape))

    return {"mu": r(d), "raw": r(d, s=0.2),
            "layers": [{"w1": r(d, hidden), "b1": r(hidden), "w2": r(hidden, hidden),
                        "b2": r(hidden), "w3": r(hidden, 2 * d), "b3": r(2 * d)}
                       for _ in range(n_layers)]}


def test_flow_forward_matches_jax():
    rng = np.random.default_rng(0)
    d, hidden, n_layers, cap = 3, 6, 3, 3.0
    eps = rng.standard_normal((50, d))
    p = random_params(rng, (), d, hidden, n_layers)
    jz, jld = jax.jit(jv._flow_forward_fn(d, n_layers, cap, jnp.float64))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(eps))
    fwd = tv._flow_forward_fn(d, n_layers, cap, torch.float64, "cpu")
    tz, tld = fwd(flow_params_from_numpy(p, device="cpu"), torch.as_tensor(eps))
    same(tz.numpy(), jz, "z", 1e-12)
    same(tld.numpy(), jld, "logdet", 1e-12)
    # two flows stacked on a leading axis against JAX's vmap
    p2 = random_params(rng, (2,), d, hidden, n_layers)
    eps2 = rng.standard_normal((2, 20, d))
    jz2, jld2 = jax.jit(jax.vmap(jv._flow_forward_fn(d, n_layers, cap, jnp.float64)))(
        jax.tree_util.tree_map(jnp.asarray, p2), jnp.asarray(eps2))
    tz2, tld2 = fwd(flow_params_from_numpy(p2, device="cpu"), torch.as_tensor(eps2))
    same(tz2.numpy(), jz2, "stacked z", 1e-12)
    same(tld2.numpy(), jld2, "stacked logdet", 1e-12)
    # the checkpoint's flat names give the same parameters
    flat = {"mu": p["mu"], "raw": p["raw"],
            **{f"layer{k}_{n}": a for k, lay in enumerate(p["layers"]) for n, a in lay.items()}}
    tz3, _ = fwd(flow_params_from_numpy(flat, device="cpu"), torch.as_tensor(eps))
    assert torch.equal(tz3, tz)


def params_same(tp, jp, rtol=RTOL):
    same(tp["mu"], jp["mu"], "mu", rtol)
    same(tp["raw"], jp["raw"], "raw", rtol)
    for k, (a, b) in enumerate(zip(tp["layers"], jp["layers"])):
        for n in b:
            same(a[n], b[n], f"layer {k} {n}", rtol)


def compare_flow(t, j, rtol=RTOL):
    same(t.elbo_trace, j.elbo_trace, "elbo_trace", rtol)
    params_same(t._params, j._params, rtol)
    same(t._mu, j._mu, "flow mu", rtol)
    same(t._chol, j._chol, "flow chol", rtol)
    same(t.cov, j.cov, "cov", rtol)
    for k in j.keys:
        assert t.mean[k] == pytest.approx(j.mean[k], rel=rtol), k
        assert t.sd[k] == pytest.approx(j.sd[k], rel=rtol), k
    for f in ("elbo", "log_z", "log_z_error"):
        assert getattr(t, f) == pytest.approx(getattr(j, f), rel=rtol), f
    np.testing.assert_allclose(t.pareto_k, j.pareto_k, rtol=1e-6, atol=1e-9,
                               equal_nan=True)
    assert (t.rank, t.n_layers, t._hidden) == (j.rank, j.n_layers, j._hidden)


@pytest.fixture(scope="module")
def flow_pair():
    """One line fit's flow in both packages, the port's on JAX's draws."""
    mp = pytest.MonkeyPatch()
    jw, tw = walker_pair("box")
    j = jv.flow_advi(jw, **FLOW)
    Replay(mp, jax_advi_draws(FLOW["seed"], FLOW["n_steps"], FLOW["n_samples"], 2,
                              FLOW["n_eval"]))
    t = tw.flow_advi(**FLOW)
    mp.undo()
    return jw, tw, j, t


def test_flow_advi_matches_jax_draw_for_draw(flow_pair):
    _, _, j, t = flow_pair
    assert isinstance(t, tfit.FlowVIResult)
    compare_flow(t, j)


def test_flow_advi_per_dataset_matches_jax_draw_for_draw(monkeypatch):
    data = [line_data(s, slope=m) for s, m in enumerate((0.5, -1.2))]
    common = dict(data_error=SIGMA, walkers_per_dataset=32, seed=0, walker_jitter=0.05)
    jb = jfit.BatchedFit(j_line, data, {"b": 1.0, "m": 0.2},
                         log_prior=jfit.make_bounds_prior(BOUNDS), **common)
    tb = tfit.BatchedFit(t_line, data, {"b": 1.0, "m": 0.2},
                         log_prior=tfit.make_bounds_prior(BOUNDS), dtype=torch.float64,
                         device="cpu", **common)
    carry(jb, tb)
    kw = {**FLOW, "n_steps": 16}
    jr = jv.flow_advi_per_dataset(jb, **kw)
    Replay(monkeypatch, jax_per_dataset_draws(kw["seed"], 2, 16, kw["n_samples"], 2,
                                              kw["n_eval"]))
    tr = tb.flow_advi_per_dataset(**kw)
    for t, j in zip(tr, jr):
        compare_flow(t, j)
    # dataset 1's flow maps eps as JAX's does
    eps = np.random.default_rng(4).standard_normal((32, 2))
    same(tr[1]._theta_of_z(tr[1]._z_of_eps(torch.as_tensor(eps))).numpy(),
         jr[1]._theta_of_z(jr[1]._z_of_eps(jnp.asarray(eps))), "dataset 1 map", 1e-9)


def theta_of_eps(res, eps, jax_side):
    if jax_side:
        return np.asarray(res._theta_of_z(res._z_of_eps(jnp.asarray(eps))))
    return res._theta_of_z(res._z_of_eps(torch.as_tensor(eps))).numpy()


def test_checkpoints_load_across_both_packages(flow_pair, tmp_path):
    jw, tw, j, t = flow_pair
    eps = np.random.default_rng(5).standard_normal((64, 2))
    # JAX -> port
    jpath = str(tmp_path / "jax_flow.npz")
    j.save(jpath)
    tl = tfit.load_flow(jpath, tw)
    same(theta_of_eps(tl, eps, False), theta_of_eps(j, eps, True), "JAX -> port", 1e-12)
    assert (tl.log_z, tl.pareto_k, tl.keys, tl.n_layers) == \
        (j.log_z, j.pareto_k, j.keys, j.n_layers)
    same(tl.elbo_trace, j.elbo_trace, "trace", 0)
    # port -> JAX
    tpath = str(tmp_path / "port_flow.npz")
    t.save(tpath)
    with np.load(tpath) as z:
        header = json.loads(str(z["__flow_header__"][()]))
        assert header["dtype"] == "float64" and header["kind"] == "flow_advi"
        assert {f"layer{k}_{n}" for k in range(2) for n in ("w1", "b1", "w2", "b2", "w3",
                                                            "b3")} <= set(z.files)
    jl = jv.load_flow(tpath, jw)
    same(theta_of_eps(jl, eps, True), theta_of_eps(t, eps, False), "port -> JAX", 1e-12)
    assert jl.log_z == t.log_z and jl.mean == t.mean
    # a no-spec fit resolves another z-space: refused by both
    x, y = line_data()
    common = dict(data=(x, y), params={"b": 1.0, "m": 0.5}, data_error=SIGMA,
                  log_prior=custom_prior, n_walkers=16, seed=0, walker_jitter=0.1)
    jw2 = jfit.walker_create(function=j_line, **common)
    tw2 = tfit.walker_create(function=t_line, dtype=torch.float64, device="cpu", **common)
    with pytest.raises(ValueError, match="z-space maps") as te:
        tfit.load_flow(jpath, tw2)
    with pytest.raises(ValueError, match="z-space maps") as je:
        jv.load_flow(jpath, jw2)
    assert str(te.value) == str(je.value)


def test_neutra_latent_target_matches_jax(flow_pair, tmp_path):
    jw, tw, j, _ = flow_pair
    path = str(tmp_path / "flow.npz")
    j.save(path)
    tl = tfit.load_flow(path, tw)
    eps = np.random.default_rng(6).standard_normal((40, 2))
    jz, jld = j._fwd(jnp.asarray(eps))
    want = np.asarray(jax.jit(jax.vmap(j._logp_z, in_axes=(0, None)))(
        jz, jw._posterior_data()) + jld)
    tz, tld = tl._fwd(torch.as_tensor(eps))
    same((tl._logp_z(tz) + tld).detach().numpy(), want, "latent target", 1e-10)
    before = tw.state.position.clone()
    res = tl.neutra_sample(tw, n_steps=40, kernel="mala", n_walkers=16, seed=1)
    # the latent walker's posterior is the same target
    same(res.latent._log_post(torch.as_tensor(eps)).detach().numpy(), want,
         "latent walker", 1e-10)
    assert torch.equal(tw.state.position, before) and tw.n_walkers == 64
    assert res.samples.shape == (res.samples_by_step.shape[0] * 16, 2)


def test_neutra_sample_recovers_the_posterior():
    """The port's own draws: a short flow on the line walker, then NeuTra
    with mala (JAX tests/test_flow_vi.py:294-301's recipe and gate)."""
    x, y = line_data()
    w = tfit.walker_create(function=t_line, data=(x, y), params={"b": 1.0, "m": 0.5},
                           data_error=SIGMA, log_prior=tfit.make_bounds_prior(BOUNDS),
                           n_walkers=128, seed=0, walker_jitter=0.1, dtype=torch.float64,
                           device="cpu")
    fv = w.flow_advi(n_steps=300, n_samples=64, seed=5)
    before = w.state.position.clone()
    res = fv.neutra_sample(w, n_steps=400, kernel="mala", n_walkers=64, seed=1)
    for i, k in enumerate(fv.keys):
        assert abs(res.samples[:, i].mean() - fv.mean[k]) < 5 * fv.sd[k], k
    assert torch.equal(w.state.position, before) and w.n_walkers == 128
    assert 0.0 < res.acceptance < 1.0 and np.isfinite(res.min_ess())
