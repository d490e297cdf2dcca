"""The evidence layer of the PyTorch port against the JAX package.

``lisp_mcmc_torch.evidence`` and ``smc`` against ``lisp_mcmc_tpu``'s, in
float64 on the CPU:

- ``laplace_approx`` and ``BatchedFit.laplace_per_dataset`` on a JAX
  fit's state carried across, at rtol 1e-8, and the line fit's Laplace
  covariance against least squares (JAX tests/test_laplace.py:136);
- ``log_evidence``'s reductions on the JAX ladder's own ``(T, W)``
  history and betas (the port's ``tempered_steps`` replaced by one that
  installs them), at 1e-10, with the prior-MC closure on the same numpy
  draws; ``log_bayes_factor``; ``_next_beta`` at 1e-12;
- ``seed_prior_box`` and ``smc_sample`` stage for stage on JAX's draws:
  the box draws and each stage's resampling uniforms injected through
  ``smc._uniform``, each move chunk's draws replayed from the JAX
  walker's key (``test_torch_blocked.rwm_draws``); ungrouped, and the
  two-spectrum batch of JAX tests/test_smc.py:71;
- the port's own ``log_evidence`` against the analytic Gaussian evidence
  (JAX tests/test_evidence.py:39's gates), a named prior on the
  unit-cube view, and ``synthetic.line_evidence_case``'s closed form
  against its own Laplace evidence;
- the chunk stepper (the plain version of the CUDA chunk kernel) at a
  stage temperature given as a number against the JAX chunk kernel;
- the argument guards.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import smc as tsmc
from lisp_mcmc_torch import synthetic
from lisp_mcmc_torch.convert import walker_from_numpy
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_tpu import smc as jsmc
from lisp_mcmc_tpu.models import gaussian_peak as j_gp
from lisp_mcmc_tpu.models import line as j_line
from lisp_mcmc_torch.models import gaussian_peak as t_gp
from lisp_mcmc_torch.models import line as t_line

from test_torch_batched import arrays, carry
from test_torch_blocked import rwm_draws
from test_torch_chunk import FLAGSHIP, _chunk_pair, f32, flagship_data  # noqa: F401

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _zeros(x, p):
    return jnp.zeros_like(x)


def _t_zeros(x, p):
    return torch.zeros_like(x)


def gaussian_pair(d, sigma, half_width, n_walkers=64, seed=0, chunk=None):
    """A JAX walker whose likelihood is N(theta; 0, sigma^2 I) under a box
    prior (JAX tests/test_evidence.py:19-36) and the port's twin."""
    keys = [f"p{i}" for i in range(d)]
    bounds = {k: (-half_width, half_width) for k in keys}
    const = -0.5 * d * math.log(2.0 * math.pi * sigma ** 2)

    def j_ll(fn, params, dataset):
        v = jnp.stack([params[k] for k in keys])
        return -0.5 * jnp.sum(v * v) / sigma ** 2 + const

    def t_ll(fn, params, dataset):
        v = torch.stack([torch.as_tensor(params[k]).reshape(-1) for k in keys], -1)
        return -0.5 * torch.sum(v * v, -1) / sigma ** 2 + const

    cfg = {} if chunk is None else {"chunk_size": chunk}
    kw = dict(data=([0.0, 1.0], [0.0, 0.0]), params={k: 0.1 for k in keys},
              n_walkers=n_walkers, seed=seed, walker_jitter=0.3)
    jw = jfit.walker_create(function=_zeros, log_likelihood=j_ll,
                            log_prior=jfit.make_bounds_prior(bounds),
                            config=jfit.FitConfig(**cfg), **kw)
    tw = tfit.walker_create(function=_t_zeros, log_likelihood=t_ll,
                            log_prior=tfit.make_bounds_prior(bounds),
                            config=tfit.FitConfig(**cfg), dtype=torch.float64,
                            device="cpu", **kw)
    return jw, tw, bounds


# ------------------------------------------------------------ Laplace


@pytest.fixture(scope="module")
def line_fit():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 60)
    y = 2.0 * x + 1.0 + rng.normal(0, 0.2, 60)
    jw = jfit.walker_create(function=j_line, data=(x, y), params={"m": 1.5, "b": 0.5},
                            data_error=0.2, n_walkers=64, seed=0, walker_jitter=0.05)
    jw.adaptive_steps(6000, auto=None)
    jw.optimize(300)
    tw = walker_from_numpy(arrays(jw.state), function=t_line, data=(x, y),
                           params={"m": 1.5, "b": 0.5}, data_error=0.2,
                           dtype=torch.float64, device="cpu")
    return jw, tw, x


def test_laplace_approx_matches_jax_and_least_squares(line_fit):
    jw, tw, x = line_fit
    bounds = {"m": (0.0, 4.0), "b": (-5.0, 5.0)}
    for kw in ({}, {"bounds": bounds}):
        j, t = jw.laplace_approx(**kw), tw.laplace_approx(**kw)
        assert t.lp_map == pytest.approx(j.lp_map, rel=1e-8)
        np.testing.assert_allclose(t.cov, j.cov, rtol=1e-8)
        assert t.sd == pytest.approx(j.sd, rel=1e-8) and t.n_clamped == j.n_clamped == 0
        assert (t.log_z is None) == (j.log_z is None) == (not kw)
        if kw:
            assert t.log_z == pytest.approx(j.log_z, rel=1e-8)
    X = np.column_stack([x, np.ones_like(x)])
    exact = 0.2 ** 2 * np.linalg.inv(X.T @ X)
    assert t.sd["m"] == pytest.approx(math.sqrt(exact[0, 0]), rel=1e-3)
    assert t.sd["b"] == pytest.approx(math.sqrt(exact[1, 1]), rel=1e-3)
    with pytest.raises(ValueError, match="missing"):
        tw.laplace_approx(bounds={"m": (0.0, 4.0)})


def test_laplace_per_dataset_matches_jax():
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    noises = [0.1, 0.4, 0.2]
    data = [(x, 2.0 * x + 1.0 + rng.normal(0, s, 50)) for s in noises]
    bounds = {"m": (0.0, 4.0), "b": (-5.0, 5.0)}
    kw = dict(data_error=noises, walkers_per_dataset=16, seed=0, walker_jitter=0.02)
    jb = jfit.BatchedFit(j_line, data, {"m": 1.8, "b": 0.8},
                         log_prior=jfit.make_bounds_prior(bounds), **kw)
    tb = tfit.BatchedFit(t_line, data, {"m": 1.8, "b": 0.8},
                         log_prior=tfit.make_bounds_prior(bounds), dtype=torch.float64,
                         device="cpu", **kw)
    jb.adaptive_steps(2000, auto=None)
    carry(jb, tb)
    jr, tr = jb.laplace_per_dataset(), tb.laplace_per_dataset()
    X = np.column_stack([x, np.ones_like(x)])
    for s, (j, t) in enumerate(zip(jr, tr)):
        np.testing.assert_allclose(t.cov, j.cov, rtol=1e-8, err_msg=f"dataset {s}")
        assert t.log_z == pytest.approx(j.log_z, rel=1e-8)
        assert t.lp_map == pytest.approx(j.lp_map, rel=1e-8) and t.n_clamped == 0
        exact = noises[s] ** 2 * np.linalg.inv(X.T @ X)
        assert t.sd["m"] == pytest.approx(math.sqrt(exact[0, 0]), rel=1e-2)


# ------------------------------------------------------------ the ladder


def test_evidence_reductions_match_jax(monkeypatch):
    """log_evidence's stepping stones, TI, batch-means error and the
    prior-MC closure on the JAX ladder's own history, against JAX."""
    jw, tw, bounds = gaussian_pair(2, 0.5, 4.0, n_walkers=64)
    for kw in ({"rungs": 8, "t_max": 1e4}, {"rungs": 4, "t_max": 30.0, "burn": 0.25,
                                             "n_error_batches": 5, "n_prior": 1000,
                                             "seed": 3}):
        j = jw.log_evidence(n_steps=2000, **kw)
        pos, lp = jw._history()

        def installed(n, rungs, t_max, collect_history, auto_ladder):
            tw._hist_positions, tw._hist_logprobs = [np.array(pos)], [np.array(lp)]
            tw._swap_betas = np.array(jw._swap_betas)

        monkeypatch.setattr(tw, "tempered_steps", installed)
        t = tw.log_evidence(n_steps=2000, **kw)
        for k in ("log_z", "log_z_ti", "error", "tail"):
            assert getattr(t, k) == pytest.approx(getattr(j, k), rel=RTOL, abs=1e-12), k
        np.testing.assert_allclose(t.mean_logpi, j.mean_logpi, rtol=RTOL)
        np.testing.assert_array_equal(t.betas, j.betas)
    ba, bb = jfit.log_bayes_factor(j, j.__class__(**{**j.__dict__, "log_z": j.log_z - 2.0}))
    ta, tb_ = tfit.log_bayes_factor(t, t.__class__(**{**t.__dict__, "log_z": t.log_z - 2.0}))
    assert (ta, tb_) == pytest.approx((ba, bb), rel=RTOL)
    assert ta == pytest.approx(2.0 / math.log(10.0), rel=1e-6)


def test_log_evidence_reads_a_retained_subsample(monkeypatch):
    """W above history_walkers: each rung's samples are its retained
    walkers' (the JAX package would need every walker kept)."""
    _, tw, _ = gaussian_pair(1, 0.5, 2.0, n_walkers=64)
    tw.config = tw.config.__class__(history_walkers=20)
    res = tw.log_evidence(n_steps=4000, rungs=4, t_max=1e4)
    assert np.isfinite(res.log_z) and res.mean_logpi.shape == (4,)
    assert res.log_z == pytest.approx(-math.log(4.0), abs=0.5)


def test_next_beta_matches_jax():
    rng = np.random.default_rng(2)
    for scale in (1.0, 30.0, 3000.0):
        lp = scale * rng.standard_normal(500)
        for beta in (0.0, 0.3, 0.999):
            for ress in (0.3, 0.5, 0.9):
                assert tsmc._next_beta(lp, beta, ress) == pytest.approx(
                    jsmc._next_beta(lp, beta, ress), rel=1e-12, abs=1e-15)


# ------------------------------------------------------------ SMC


def inject(monkeypatch, seed, W, d):
    """``smc._uniform`` returning the JAX package's draws: the box draws of
    ``PRNGKey(seed)``, then one (G,) draw a stage from ``PRNGKey(seed + 1)``."""
    box = {"key": jax.random.PRNGKey(seed + 1), "first": True}

    def uniform(walker, shape, dtype):
        if box.pop("first", False):
            assert tuple(shape) == (W, d)
            u = jax.random.uniform(jax.random.PRNGKey(seed), (W, d), jnp.float64)
        else:
            box["key"], k_u = jax.random.split(box["key"])
            u = jax.random.uniform(k_u, tuple(shape))
        return torch.as_tensor(np.array(u), dtype=dtype)

    monkeypatch.setattr(tsmc, "_uniform", uniform)


def replay_moves(tw, key, W, d, chunk):
    """``tw``'s runners draw what the JAX walker's would from ``key``."""
    box = [key]
    real = tw._runner
    draws = rwm_draws(W, d, chunk)

    def runner(greedy=False, with_history=True):
        run = real(greedy, with_history)

        def wrapped(state, adapt, refresh, cold, *, generator=None, noise=None):
            box[0], nz = draws(box[0])
            return run(state, adapt, refresh, cold, noise=nz)
        return wrapped

    tw._runner = runner
    return box


def test_seed_prior_box_matches_jax(monkeypatch):
    jw, tw, bounds = gaussian_pair(2, 0.5, 4.0, n_walkers=64)
    tw.adaptive_steps(200, auto=None)
    inject(monkeypatch, 5, 64, 2)
    jl, jh = jsmc.seed_prior_box(jw, bounds, seed=5)
    tl, th = tsmc.seed_prior_box(tw, bounds)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for k in ("position", "logprob", "best_position", "best_logprob"):
        np.testing.assert_allclose(getattr(tw.state, k).numpy(),
                                   np.asarray(getattr(jw.state, k)), rtol=RTOL, err_msg=k)
    assert len(tw) == 0 and tw.acceptance() == 0.0
    with pytest.raises(ValueError, match="missing"):
        tsmc.seed_prior_box(tw, {"p0": (0.0, 1.0)})
    with pytest.raises(ValueError, match="high > low"):
        tsmc.seed_prior_box(tw, {"p0": (0.0, 1.0), "p1": (1.0, 1.0)})


def compare_smc(j, t, jw, tw):
    assert t.n_stages == j.n_stages
    np.testing.assert_allclose(t.betas, j.betas, rtol=RTOL)
    np.testing.assert_allclose(t.acceptance, j.acceptance, rtol=RTOL)
    assert t.log_z == pytest.approx(j.log_z, rel=1e-9)
    for k in ("position", "logprob"):
        np.testing.assert_allclose(getattr(tw.state, k).numpy(),
                                   np.asarray(getattr(jw.state, k)), rtol=1e-9, err_msg=k)


def test_smc_sample_matches_jax_stage_for_stage(monkeypatch):
    jw, tw, bounds = gaussian_pair(2, 0.5, 4.0, n_walkers=64, chunk=50)
    inject(monkeypatch, 3, 64, 2)
    replay_moves(tw, jw.state.key, 64, 2, 50)
    stages = []
    j = jw.smc_sample(bounds, n_move=50, seed=3, target_moves=None)
    t = tw.smc_sample(bounds, n_move=50, seed=3, target_moves=None,
                      on_stage=lambda info: stages.append(info) and False)
    compare_smc(j, t, jw, tw)
    assert t.log_z_per_group is None and j.n_stages >= 3
    assert [s["stage"] for s in stages] == list(range(1, t.n_stages + 1))
    assert all(s["chunks"] == 1 for s in stages)
    assert t.log_z == pytest.approx(-2 * math.log(8.0), abs=0.5)


def test_grouped_smc_matches_jax_per_group():
    """The two-spectrum batch of JAX tests/test_smc.py:71: one population
    per dataset block, each with its own evidence, on one ladder."""
    rng = np.random.default_rng(0)
    x = np.linspace(-4.0, 4.0, 64)

    def spec(scale):
        y = np.asarray(j_gp(x, {"scale": scale, "x0": 0.4, "sigma": 1.0, "bg0": 0.1}))
        return x, y + 0.02 * rng.standard_normal(64)

    data = [spec(2.0), spec(1.0)]
    bounds = {"scale": (0.1, 4.0), "x0": (-3.0, 3.0), "sigma": (0.3, 3.0),
              "bg0": (-1.0, 1.0)}
    guess = {"scale": 1.0, "x0": 0.3, "sigma": 1.0, "bg0": 0.1}
    kw = dict(data_error=0.02, walkers_per_dataset=32, seed=0)
    jb = jfit.BatchedFit(j_gp, data, guess, log_prior=jfit.make_bounds_prior(bounds),
                         config=jfit.FitConfig(chunk_size=100), **kw)
    tb = tfit.BatchedFit(t_gp, data, guess, log_prior=tfit.make_bounds_prior(bounds),
                         config=tfit.FitConfig(chunk_size=100), dtype=torch.float64,
                         device="cpu", **kw)
    carry(jb, tb)
    mp = pytest.MonkeyPatch()
    try:
        inject(mp, 2, 64, 4)
        replay_moves(tb, jb.state.key, 64, 4, 100)
        j = jb.smc_sample(bounds, n_move=100, seed=2, target_moves=None)
        t = tb.smc_sample(bounds, n_move=100, seed=2, target_moves=None)
    finally:
        mp.undo()
    compare_smc(j, t, jb, tb)
    np.testing.assert_allclose(t.log_z_per_group, j.log_z_per_group, rtol=1e-9)
    assert t.log_z == pytest.approx(t.log_z_per_group.sum())
    best = tb.best_params_per_dataset()
    assert best[0]["scale"] == pytest.approx(2.0, abs=0.1)
    assert best[1]["scale"] == pytest.approx(1.0, abs=0.1)


def test_smc_guards():
    _, tw, bounds = gaussian_pair(1, 0.5, 2.0, n_walkers=32)
    with pytest.raises(ValueError, match="missing"):
        tw.smc_sample({})
    with pytest.raises(ValueError, match="target_ress"):
        tw.smc_sample(bounds, target_ress=1.5)
    with pytest.raises(ValueError, match="high > low"):
        tw.smc_sample({"p0": (1.0, 1.0)})
    with pytest.raises(RuntimeError, match="on_stage requested stop"):
        tw.smc_sample(bounds, n_move=200, on_stage=lambda info: True)
    w = tfit.walker_create(function=t_line, data=([0.0, 1.0], [0.0, 1.0]),
                           params={"m": 1.0, "b": 0.0}, n_walkers=8, device="cpu")
    with pytest.raises(ValueError, match="pass bounds= or prior="):
        w.smc_sample()


# ------------------------------------------------------------ the port's own


def test_log_evidence_matches_the_analytic_gaussian():
    """JAX tests/test_evidence.py:39's case and gates, on the port."""
    _, tw, _ = gaussian_pair(2, 0.5, 4.0, n_walkers=256)
    res = tw.log_evidence(n_steps=16000, rungs=16, t_max=1e4)
    assert res.log_z == pytest.approx(-2 * math.log(8.0), abs=0.25), res
    assert res.log_z_ti == pytest.approx(res.log_z, abs=0.35), res
    assert abs(res.tail) < 0.1 and res.error < 0.2
    assert res.betas[0] == pytest.approx(1.0) and np.all(np.diff(res.betas) < 0)
    assert tw.swap_rates()["pair_rates"].shape == (15,)


def test_log_evidence_with_a_named_prior():
    """A fit of the likelihood N(theta; 0, 0.5^2) under the named prior
    Gaussian(0, 1): Z = N(0; 0, 1 + 0.25), the spec recovered from the
    fitted term and the ladder run on the unit-cube view."""
    spec = tfit.PriorSpec({"p0": tfit.Gaussian(0.0, 1.0)})

    def t_ll(fn, params, dataset):
        v = torch.as_tensor(params["p0"]).reshape(-1)
        return -0.5 * v * v / 0.25 - 0.5 * math.log(2.0 * math.pi * 0.25)

    tw = tfit.walker_create(function=_t_zeros, data=([0.0, 1.0], [0.0, 0.0]),
                            params={"p0": 0.1}, log_likelihood=t_ll, log_prior=spec,
                            n_walkers=256, walker_jitter=0.3, dtype=torch.float64,
                            device="cpu")
    pos0 = tw.state.position.clone()
    res = tw.log_evidence(n_steps=8000, rungs=8, t_max=1e4)
    assert res.log_z == pytest.approx(-0.5 * math.log(2 * math.pi * 1.25), abs=0.25), res
    assert torch.equal(tw.state.position, pos0), "the named-prior path runs on a view"
    assert tw.swap_rates()["betas"].shape == (8,)


def test_line_evidence_case_closed_form():
    """The chip smoke's evidence case: shapes, truths, and the closed form
    against the port's own Laplace evidence at the least-squares point
    (exact for a linear-Gaussian model)."""
    c = synthetic.line_evidence_case()
    assert c["x"].shape == c["y"].shape == (334,) and c["sigma"] == 2.0
    sd = np.sqrt(np.diag(c["cov"]))
    for i, k in enumerate(("m", "b")):
        lo, hi = c["bounds"][k]
        assert min(c["beta_hat"][k] - lo, hi - c["beta_hat"][k]) > 14 * sd[i]
        assert abs(c["beta_hat"][k] - c["truth"][k]) < 3 * sd[i]
    w = tfit.walker_create(function=t_line, data=(c["x"], c["y"]), params=c["beta_hat"],
                           data_error=c["sigma"], n_walkers=2,
                           log_prior=tfit.make_bounds_prior(c["bounds"]),
                           dtype=torch.float64, device="cpu")
    lap = w.laplace_approx()
    assert lap.log_z == pytest.approx(c["log_z"], abs=1e-9)
    np.testing.assert_allclose(lap.cov, c["cov"], rtol=1e-9)


def test_nv_scan_grid():
    x, ys, truths = synthetic.nv_scan_grid(3, 4, seed=1)
    assert x.shape == (401,) and ys.shape == (12, 401) and len(truths) == 12
    mu1 = np.array([t["mu1"] for t in truths])
    mu2 = np.array([t["mu2"] for t in truths])
    assert mu1.min() >= 2850 and mu1.max() <= 2870 and mu2.min() >= 2870 and mu2.max() <= 2890
    assert np.all(mu2 - mu1 >= 14.0 - 1e-9) and np.ptp(mu2 - mu1) > 4.0
    # smooth: neighbours in a row differ by under a MHz
    assert np.abs(np.diff(mu1.reshape(3, 4), axis=1)).max() < 2.0
    clean = np.stack([tfit.models.double_lorentzian_bg(
        torch.tensor(x), {k: torch.tensor(v) for k, v in t.items()}).numpy() for t in truths])
    assert np.std(ys - clean) == pytest.approx(synthetic.NV_NOISE, rel=0.05)


def test_chunk_stepper_at_a_stage_temperature_matches_jax(f32):
    """The plain chunk at T = 3.7 given as a number (an SMC stage's
    temperature) against the JAX chunk kernel with the same override."""
    from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
    from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder

    x, y = flagship_data()
    j_run, t_ck, start, L = _chunk_pair(j_lorder, t_lorder, x, y, 1e-7, FLAGSHIP, 3e-3,
                                        1e-3, 4)
    seed = 20240607
    outs = {}
    for temp in (1.0, 3.7):
        jo = j_run(*[jnp.asarray(a) for a in start], jnp.asarray(L), 1000, temp, seed)
        to = tck.chunk_rwm(t_ck, *[torch.as_tensor(np.array(a)) for a in start],
                           torch.as_tensor(L), 1000, temp,
                           torch.tensor([seed], dtype=torch.int32))
        same = np.asarray(jo["accept_counts"]) == to["accept_counts"].numpy()
        assert same.mean() >= 0.99, (temp, same.mean())
        np.testing.assert_allclose(to["position"].numpy()[same],
                                   np.asarray(jo["position"])[same], rtol=1e-4)
        outs[temp] = float(to["accept_counts"].float().mean())
    assert outs[3.7] > outs[1.0] + 1.0, f"the temperature did not act: {outs}"


# ------------------------------------------------------------ guards


def test_evidence_guards():
    _, tw, _ = gaussian_pair(1, 0.5, 2.0, n_walkers=32)
    with pytest.raises(ValueError, match="rungs"):
        tw.log_evidence(rungs=1)
    with pytest.raises(ValueError, match="burn"):
        tw.log_evidence(burn=1.0)
    with pytest.raises(ValueError, match="missing"):
        tw.log_evidence(rungs=8, bounds={})
    with pytest.raises(ValueError, match="history too short"):
        tw.log_evidence(n_steps=10, rungs=4, burn=0.9)
