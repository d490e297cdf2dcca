"""The port's gradient samplers (mala, hmc, chees) against the JAX
package's, draw for draw.

The JAX steps split their key per step (mala ``split(key, 3)``: the
proposal's normal and the accept uniform; hmc ``split(key, 4)``: the
momentum, the accept uniform and the jittered leapfrog count; chees
``split(key, 4)``: the momentum, the accept uniform and each group's
length jitter) and, with the rescue on, once more at the chunk end
(``split(key, 7)``: per half-round the Student-t's normal, its chi^2_2
uniform and the accept uniform; ``split(key, 4)`` for an odd group).
These tests replay that stream into the port runner's ``noise=`` (its
layout is in ``lisp_mcmc_torch.kernel.build_chunk_runner``), start both
from the same state and compare every state array (``chees`` too) and
every ``out`` key after each of two chunks, the first annealing (T = 10
at its start: mala's drift off) and the second cold, in float64 at
rtol 1e-9.

The state is the flagship fit (``lorder_mixed_bg``, sigma = 1e-7) with
walkers drawn from its Laplace approximation and L = 0.5 x its Cholesky
factor, so every sampler accepts an informative share.  The leapfrog
chains could amplify the 1e-16 rounding differences of the two
packages' gradients; measured on this state (cold steps, the rescue off),
the largest relative position gap after 1, 10 and 50 steps is mala
2e-16 / 6e-16 / 1e-15, hmc 2e-15 / 4e-15 / 4e-15, chees 1e-15 / 4e-15 /
3e-15, far inside rtol 1e-9.  The chunks are mala 50, hmc and chees 20
steps, for the tests' time (hmc makes 8 gradient evaluations a step).

``make_eval_vg`` is held against ``jax.vmap(jax.value_and_grad)`` at
rtol 1e-12 on the flagship twin, test.lisp's global pair and the NV
prior with its declared constraints, inside and outside the bounds.
``sampling_steps`` is held against the JAX verb with the walker's runners
drawing what the JAX walker's would.  ``chees_trajectory``, the chees
state's carriage (``convert``, ``tempered_steps``) and the guards follow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import models, nv, synthetic
from lisp_mcmc_torch.convert import state_from_numpy, walker_from_numpy
from lisp_mcmc_tpu import kernel as jkernel
from lisp_mcmc_tpu import nv as jnv
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_tpu.models import zoo as jzoo
from lisp_mcmc_torch import kernel as tkernel
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder

FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
D = 6
RTOL = 1e-9
CHUNKS = {"mala": 50, "hmc": 20, "chees": 20}
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count", "chees")
OUT_KEYS = ("logprob_max", "logprob_mean", "logprob_min", "accept_rate",
            "group_accept")
GRADIENT = ("mala", "hmc", "chees")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flagship_data(seed=0):
    x = np.linspace(2000.0, 3600.0, 334)
    y = np.asarray(j_lorder(x, FLAGSHIP), np.float64)
    return x, y + 1e-7 * np.random.default_rng(seed).standard_normal(334)


def arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}


def laplace_factor(jw):
    """Cholesky factor of the flagship posterior's Laplace covariance at
    the generating parameters, by Gauss-Newton (``sigma^2 (J^T J)^-1``,
    J the model's Jacobian, in units of the parameters' magnitudes so it
    inverts in float64)."""
    theta = np.asarray(jw.state.position)[0]
    scale = np.abs(theta)
    x, _ = flagship_data()
    jac = np.asarray(jax.jacfwd(lambda u: j_lorder(x, dict(zip(FLAGSHIP, u * scale))))(
        jnp.ones(D)))
    cov = np.linalg.inv(jac.T @ jac / 1e-14)
    return np.linalg.cholesky(cov) * scale[:, None]


_START = {}


def start_pair(n_walkers, G=1, seed=4, stragglers=0):
    """A JAX walker, its state from the Laplace draw, and the port walker
    on the same data.  ``stragglers`` walkers sit 30 sigma out."""
    tag = (n_walkers, G, seed, stragglers)
    x, y = flagship_data()
    jw = jfit.walker_create(function=j_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=n_walkers, seed=seed)
    tw = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=n_walkers, dtype=torch.float64,
                            device="cpu")
    if tag not in _START:
        c = laplace_factor(jw)
        rng = np.random.default_rng(seed)
        pos = np.asarray(jw.state.position) + rng.standard_normal((n_walkers, D)) @ c.T
        pos[:stragglers] += 30.0 * rng.standard_normal((stragglers, D)) @ c.T
        lp = np.asarray(jax.vmap(jw._log_post_one, in_axes=(0, None))(
            jnp.asarray(pos), jw._posterior_data()))
        _START[tag] = (pos, lp, c)
    pos, lp, c = _START[tag]
    st = jkernel.init_state(jw.state.key, jnp.asarray(pos), jnp.asarray(lp),
                            jnp.asarray(0.5 * c), G)
    # moments carried in from an earlier rwm phase: the gradient samplers
    # keep them as they are
    rng = np.random.default_rng(1)
    st = dataclasses.replace(st, m_sum=jnp.asarray(rng.standard_normal((G, D))),
                             m_count=jnp.full((G,), 7.0))
    return jw, tw, st


_REPLAYS = {}


def gradient_draws(kind, cfg, W, G, chunk, rescue=None, d=D):
    """A jitted ``key -> (key, noise)`` drawing one chunk of ``kind`` steps
    as the JAX kernel does, in the port's ``noise=`` layout.  ``rescue``:
    None, ``("even", Bh)`` or ``"odd"``, the chunk end's rescue draws."""
    n = max(1, cfg.hmc_leapfrog)
    tag = (kind, W, G, chunk, rescue, n, cfg.hmc_jitter, d)
    if tag in _REPLAYS:
        return _REPLAYS[tag]
    f64 = jnp.float64
    tiny = jnp.finfo(f64).tiny

    def step(k, _):
        if kind == "mala":
            k, kp, ka = jax.random.split(k, 3)
            return k, (jax.random.normal(kp, (W, d), f64), jax.random.uniform(ka, (W,), f64))
        k, km, ka, kx = jax.random.split(k, 4)
        p = jax.random.normal(km, (W, d), f64)
        u = jax.random.uniform(ka, (W,), f64)
        if kind == "chees":
            return k, (p, u, jax.random.uniform(kx, (G,), f64))
        if cfg.hmc_jitter and n > 1:
            n_leap = jax.random.randint(kx, (), (n + 1) // 2, n + 1)
        else:
            n_leap = jnp.asarray(n, jnp.int32)
        return k, (p, u, n_leap)

    def rescue_draws(key):
        if rescue == "odd":
            key, kz, kv, ku = jax.random.split(key, 4)
            return key, {"z": jax.random.normal(kz, (W, d), f64),
                         "v": jax.random.uniform(kv, (W,), f64, minval=tiny),
                         "u": jax.random.uniform(ku, (W,), f64)}
        bh = rescue[1]
        keys = jax.random.split(key, 7)
        halves = [{"z": jax.random.normal(keys[1 + 3 * s], (G, bh, d), f64),
                   "v": jax.random.uniform(keys[2 + 3 * s], (G, bh), f64, minval=tiny),
                   "u": jax.random.uniform(keys[3 + 3 * s], (G, bh), f64)} for s in (0, 1)]
        return keys[0], {k: jnp.stack([h[k] for h in halves]) for k in halves[0]}

    @jax.jit
    def draws(key):
        key, steps = lax.scan(step, key, None, length=chunk)
        if rescue is None:
            return key, steps
        key, resc = rescue_draws(key)
        return key, steps + (resc,)

    def replay(key):
        key, noise = draws(key)
        noise = tuple({k: torch.as_tensor(np.array(v)) for k, v in a.items()}
                      if isinstance(a, dict) else torch.as_tensor(np.array(a))
                      for a in noise)
        return key, noise

    _REPLAYS[tag] = replay
    return replay


def run_pair(jw, tw, j_state, kind, G, chunk, chunks=(False, True), adapt=True,
             history=False, **fields):
    """Run the JAX and the port runner side by side from ``j_state`` over
    the given chunks (each flag: the cold finish) and compare after each.
    Returns the last ``(j_state, t_state, j_out, t_out)``."""
    W = j_state.position.shape[0]
    gids = np.repeat(np.arange(G), W // G) if G > 1 else None
    jcfg = jfit.FitConfig(kernel=kind, chunk_size=chunk, **fields)
    tcfg = tkernel.FitConfig(kernel=kind, chunk_size=chunk, **fields)
    j_run, j_hist = jkernel.build_chunk_runner(jw._log_post_one, D, jcfg, group_ids=gids,
                                               n_groups=G, takes_data=True)
    t_run, t_hist = tkernel.build_chunk_runner(tw._log_post, D, tcfg, group_ids=gids,
                                               n_groups=G)
    B = W // G
    rescue = None
    if tcfg.rescue and kind in GRADIENT:
        rescue = ("even", B // 2) if B % 2 == 0 else "odd"
    replay = gradient_draws(kind, tcfg, W, G, chunk, rescue)
    t_state, _ = state_from_numpy(arrays(j_state), dtype=torch.float64, device="cpu")
    j_fn = jax.jit(j_hist if history else j_run)
    t_fn = t_hist if history else t_run
    key = j_state.key
    for i, cold in enumerate(chunks):
        key, noise = replay(key)
        j_state, j_out = j_fn(j_state, adapt, True, cold, jw._posterior_data())
        t_state, t_out = t_fn(t_state, adapt, True, cold, noise=noise)
        what = f"{kind} G={G} {fields} chunk {i}"
        compare(j_state, t_state, what)
        for k in OUT_KEYS + (("positions", "logprobs") if history else ()):
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), rtol=RTOL,
                                       atol=0, err_msg=f"{what}: {k}")
        np.testing.assert_array_equal(jax.random.key_data(j_state.key),
                                      jax.random.key_data(key))
        assert t_state.age == int(j_state.age)
    return j_state, t_state, j_out, t_out


def compare(j_state, t_state, what):
    for k, ja in arrays(j_state).items():
        np.testing.assert_allclose(getattr(t_state, k).numpy(), ja, rtol=RTOL, atol=0,
                                   err_msg=f"{what}: {k}")


LAYOUTS = [(256, 1), (256, 2)]


@pytest.mark.parametrize("kind", GRADIENT)
@pytest.mark.parametrize("n_walkers,G", LAYOUTS, ids=["ungrouped", "G2"])
def test_gradient_step_matches_jax(kind, n_walkers, G):
    """Two chunks (annealing, then cold) with the rescue, draw for draw;
    the evaluations counted per chunk."""
    jw, tw, st = start_pair(n_walkers, G)
    chunk = CHUNKS[kind]
    _, t_state, _, t_out = run_pair(jw, tw, st, kind, G, chunk, history=kind == "mala")
    acc = float(t_out["accept_rate"])
    assert 0.05 < acc < 0.98, f"{kind}: uninformative acceptance {acc}"
    assert t_out["posterior_evals"] == 2                  # the rescue's half-rounds
    n_vg = t_out["gradient_evals"]
    if kind == "mala":
        assert n_vg == chunk + 1
    elif kind == "hmc":
        assert n_vg == chunk * 8 + 1
    else:
        assert chunk + 1 <= n_vg <= chunk * 64 + 1
    if kind == "chees":
        assert torch.all(t_state.chees[:, 3] == 2 * chunk)


@pytest.mark.parametrize("kind", GRADIENT)
def test_rescue_off_matches_jax(kind):
    jw, tw, st = start_pair(256, 2)
    _, _, _, t_out = run_pair(jw, tw, st, kind, 2, CHUNKS[kind], chunks=(True,),
                              rescue=False)
    assert t_out["posterior_evals"] == 0


def test_hmc_without_jitter_matches_jax():
    jw, tw, st = start_pair(256)
    _, _, _, t_out = run_pair(jw, tw, st, "hmc", 1, 10, hmc_jitter=False, hmc_leapfrog=5)
    assert t_out["gradient_evals"] == 10 * 5 + 1


def test_chees_frozen_without_adaptation():
    """``adapt_enabled`` False: the chees state and L stay as they were
    (tests/test_chees.py:78's switch), in both packages."""
    jw, tw, st = start_pair(256, 2)
    st = dataclasses.replace(st, chees=jnp.asarray([[0.3, 0.1, 0.2, 5.0],
                                                    [-0.2, 0.0, 0.1, 5.0]]))
    j_state, t_state, _, _ = run_pair(jw, tw, st, "chees", 2, 10, chunks=(True,),
                                      adapt=False)
    np.testing.assert_array_equal(t_state.chees.numpy(), np.asarray(st.chees))
    np.testing.assert_array_equal(t_state.l_matrix.numpy(), np.asarray(st.l_matrix))
    assert float(t_state.m_count.sum()) == 0.0          # frozen runs clear moments


def test_state_defaults_and_chees_trajectory():
    """A fresh state holds zeros, which read as t = hmc_leapfrog; after
    chees steps ``chees_trajectory`` reads what the JAX verb reads."""
    x, y = flagship_data()
    tw = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=64, dtype=torch.float64,
                            device="cpu", config=tfit.FitConfig(kernel="chees"))
    assert tw.state.chees.shape == (1, 4) and float(tw.state.chees.abs().sum()) == 0.0
    t0 = tw.chees_trajectory()
    assert t0["leapfrog"].shape == (1,) and t0["leapfrog"][0] == 8.0
    assert t0["budget"] == 64 and not t0["at_cap"]
    jw, tw, st = start_pair(256, 2)
    j_state, t_state, _, _ = run_pair(jw, tw, st, "chees", 2, 10, chunks=(True,),
                                      chees_max_leapfrog=16)
    jw.state, tw.state = j_state, t_state
    jw.config = jfit.FitConfig(kernel="chees", chees_max_leapfrog=16)
    tw.config = tfit.FitConfig(kernel="chees", chees_max_leapfrog=16)
    jt, tt = jw.chees_trajectory(), tw.chees_trajectory()
    np.testing.assert_allclose(tt["leapfrog"], jt["leapfrog"], rtol=RTOL)
    assert tt["leapfrog"][0] != 8.0
    assert (tt["budget"], tt["at_cap"]) == (jt["budget"], jt["at_cap"])


def test_hmc_divergence_rejected_not_propagated():
    """A posterior that is -inf outside |a| < 3 (tests/test_hmc.py:133):
    divergent trajectories are rejected in both packages, draw for draw,
    and every position stays finite and inside the support."""
    def j_loglik(fn, params, dataset):
        a = params["a"]
        return jnp.where(jnp.abs(a) < 3.0, -0.5 * a ** 2, -jnp.inf)

    def t_lp(p):
        a = p[:, 0]
        return torch.where(a.abs() < 3.0, -0.5 * a ** 2, -torch.inf)

    W, chunk = 64, 20
    jw = jfit.walker_create(function=lambda x, p: jnp.zeros_like(x), data=([0.0], [0.0]),
                            params={"a": 0.5}, data_error=1.0, log_likelihood=j_loglik,
                            n_walkers=W, seed=0, walker_jitter=0.5)
    pos = np.linspace(-2.9, 2.9, W)[:, None]
    st = jkernel.init_state(jw.state.key, jnp.asarray(pos),
                            jnp.asarray(-0.5 * pos[:, 0] ** 2), jnp.asarray([[2.0]]))
    jcfg = jfit.FitConfig(kernel="hmc", chunk_size=chunk, rescue=False)
    tcfg = tkernel.FitConfig(kernel="hmc", chunk_size=chunk, rescue=False)
    j_run, _ = jkernel.build_chunk_runner(jw._log_post_one, 1, jcfg, takes_data=True)
    t_run, _ = tkernel.build_chunk_runner(t_lp, 1, tcfg)
    t_state, _ = state_from_numpy(arrays(st), dtype=torch.float64, device="cpu")

    replay = gradient_draws("hmc", tcfg, W, 1, chunk, d=1)
    key = st.key
    for _ in range(2):
        key, noise = replay(key)
        st, j_out = jax.jit(j_run)(st, False, False, True, jw._posterior_data())
        t_state, t_out = t_run(t_state, False, False, True, noise=noise)
        compare(st, t_state, "hmc divergence")
    pos = t_state.position.numpy()
    assert np.isfinite(pos).all() and (np.abs(pos) < 3.0).all()
    assert np.isfinite(t_state.logprob.numpy()).all()
    assert 0.0 < float(t_out["accept_rate"]) < 1.0


# ---------------------------------------------------------------- eval_vg


def _eval_vg_case(name):
    """(JAX walker, port walker, positions) with a share of the positions
    outside the prior's bounds where it has any, and two non-finite."""
    if name == "flagship":
        x, y = flagship_data()
        jkw = dict(function=j_lorder, data=(x, y), params=FLAGSHIP, data_error=1e-7)
        tkw = dict(function=t_lorder, data=(x, y), params=FLAGSHIP, data_error=1e-7)
        spread = 1e-3
    elif name == "global":
        g = synthetic.global_fit(2)

        def j_lorder2(x, p):
            return jzoo.lorder_mixed_bg(x, {
                "scale": p["scale2"], "linewidth": p["linewidth"], "x0": p["x0"],
                "mix": p["mix"], "bg0": p["bg02"], "bg1": p["bg12"]})

        common = dict(data=g["data"], params=g["truth"], data_error=1e-7)
        jkw = dict(function=[jzoo.lorder_mixed_bg, j_lorder2], **common)
        tkw = dict(function=[models.lorder_mixed_bg, models.renamed(
            models.lorder_mixed_bg, {"scale": "scale2", "bg0": "bg02", "bg1": "bg12"})],
            **common)
        spread = 1e-3
    else:
        x, ys = synthetic.nv_spectra()
        y = ys[0]
        common = dict(data=(x, y), params=nv.guess_nv_params(y),
                      data_error=nv.nv_data_std_dev(y))
        jkw = dict(function=jzoo.double_lorentzian_bg, log_prior=jnv.make_nv_prior(y),
                   **common)
        tkw = dict(function=models.double_lorentzian_bg, log_prior=nv.make_nv_prior(y),
                   **common)
        spread = 0.003        # a share of walkers leaves the boxes
    jw = jfit.walker_create(n_walkers=64, seed=3, **jkw)
    tw = tfit.walker_create(n_walkers=64, dtype=torch.float64, device="cpu", **tkw)
    assert tw.spec.keys == jw.spec.keys
    base = np.asarray(jw.state.position)
    pos = base * (1.0 + spread * np.random.default_rng(11).standard_normal(base.shape))
    # two walkers where the posterior is not finite
    pos[-2:, -1] = [np.inf, np.nan]
    return jw, tw, pos


@pytest.mark.parametrize("name", ["flagship", "global", "nv"])
def test_eval_vg_matches_jax_value_and_grad(name):
    jw, tw, pos = _eval_vg_case(name)
    j_lp, j_g = jax.vmap(jax.value_and_grad(jw._log_post_one), in_axes=(0, None))(
        jnp.asarray(pos), jw._posterior_data())
    j_lp, j_g = np.asarray(j_lp), np.asarray(j_g)
    eval_vg = tkernel.make_eval_vg(tw._log_post)
    with torch.no_grad():                       # the caller's grad mode does not matter
        lp, g, bad = eval_vg(torch.as_tensor(pos))
    assert not lp.requires_grad and not g.requires_grad
    finite = np.isfinite(j_lp)
    assert (~finite).sum() == 2
    if name == "nv":
        outside = finite & (j_lp < -1e8)            # the boxes' penalties
        assert 0 < outside.sum() < len(finite) // 2, "want walkers outside the bounds"
    np.testing.assert_allclose(lp.numpy()[finite], j_lp[finite], rtol=1e-12, atol=0)
    assert (lp.numpy()[~finite] == tkernel._neg_floor(torch.float64)).all()
    g_ok = np.isfinite(j_g)
    want_g = np.where(g_ok, j_g, 0.0)
    # rtol 1e-12 relative to each walker's gradient scale
    scale = np.abs(want_g).max(axis=1, keepdims=True)
    np.testing.assert_allclose(g.numpy() / np.where(scale > 0, scale, 1.0),
                               want_g / np.where(scale > 0, scale, 1.0), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(bad.numpy(), ~finite | ~g_ok.all(axis=1))


def test_eval_vg_of_a_constant_posterior_is_zero():
    eval_vg = tkernel.make_eval_vg(lambda p: torch.zeros(p.shape[0], dtype=p.dtype))
    lp, g, bad = eval_vg(torch.ones((4, 3), dtype=torch.float64))
    assert float(lp.abs().sum()) == 0.0 and float(g.abs().sum()) == 0.0
    assert not bad.any()


# ---------------------------------------------------------------- verbs


def patch_draws(tw, key, rescue_on=True):
    """Make ``tw``'s chunk runners draw what the JAX walker's would from
    ``key`` (the JAX walker's key before the verb)."""
    box = [key]
    real = tw._runner

    def runner(greedy=False, with_history=True):
        run = real(greedy, with_history)
        cfg = tw.config

        def wrapped(state, adapt, refresh, cold, *, generator=None, noise=None):
            W = state.position.shape[0]
            rescue = ("even", W // 2) if rescue_on and W % 2 == 0 else None
            box[0], nz = gradient_draws(cfg.kernel, cfg, W, 1, cfg.chunk_size,
                                        rescue)(box[0])
            return run(state, adapt, refresh, cold, noise=nz)
        return wrapped

    tw._runner = runner
    return box


@pytest.mark.parametrize("kind", GRADIENT)
def test_sampling_steps_matches_jax(kind):
    """``Walker.sampling_steps`` against the JAX verb: T = 1, history kept,
    the rescue at each chunk end, the same chains."""
    chunk = CHUNKS[kind]
    jw, tw, st = start_pair(256, 1, seed=6, stragglers=8)
    jw.config = jfit.FitConfig(chunk_size=chunk)
    tw.config = tkernel.FitConfig(chunk_size=chunk)
    jw.state = st
    tw.state, _ = state_from_numpy(arrays(st), dtype=torch.float64, device="cpu")
    box = patch_draws(tw, st.key)
    jw.sampling_steps(2 * chunk, kernel=kind)
    tw.sampling_steps(2 * chunk, kernel=kind)
    np.testing.assert_array_equal(jax.random.key_data(jw.state.key),
                                  jax.random.key_data(box[0]))
    compare(jw.state, tw.state, f"sampling_steps {kind}")
    j_pos, j_lp = jw._history()
    t_pos, t_lp = tw._history()
    np.testing.assert_allclose(t_pos, j_pos, rtol=RTOL, atol=0)
    np.testing.assert_allclose(t_lp, j_lp, rtol=RTOL, atol=0)
    assert tw.acceptance() == pytest.approx(jw.acceptance(), rel=RTOL)
    assert tw.config.kernel == "rwm" and tw.age == int(jw.state.age)
    assert tw.posterior_evals == 2 * 2 and tw.gradient_evals >= 2 * (chunk + 1)
    # the stragglers were brought in
    assert float(tw.state.logprob[:8].min()) > float(st.logprob[:8].max())


def test_tempered_steps_restores_chees():
    """A tempered rwm search keeps the chees state it found (the JAX
    package restores it, fit.py:833-900), on one group again."""
    jw, tw, st = start_pair(256)
    cz = np.asarray([[0.4, 0.1, 0.2, 30.0]])
    jw.state = dataclasses.replace(st, chees=jnp.asarray(cz))
    tw.state, _ = state_from_numpy(arrays(jw.state), dtype=torch.float64, device="cpu")
    tw.tempered_steps(400, rungs=4)
    jw.tempered_steps(400, rungs=4)
    np.testing.assert_array_equal(tw.state.chees.numpy(), cz)
    np.testing.assert_array_equal(np.asarray(jw.state.chees), cz)
    assert tw.state.l_matrix.shape == (1, D, D)


def test_convert_carries_chees():
    jw, tw, st = start_pair(256, 2)
    cz = np.arange(8.0).reshape(2, 4) / 10.0
    a = arrays(dataclasses.replace(st, chees=jnp.asarray(cz)))
    t_state, _ = state_from_numpy(a, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(t_state.chees.numpy(), cz)
    a.pop("chees")
    t_state, _ = state_from_numpy(a, dtype=torch.float64, device="cpu")
    assert t_state.chees.shape == (2, 4) and float(t_state.chees.abs().sum()) == 0.0
    a["chees"] = np.zeros((3, 4))
    with pytest.raises(ValueError, match="chees"):
        state_from_numpy(a, dtype=torch.float64, device="cpu")
    x, y = flagship_data()
    a = arrays(dataclasses.replace(st, chees=jnp.asarray(cz)))
    a["group_ids"] = np.repeat(np.arange(2), 128)
    w = walker_from_numpy(a, function=t_lorder, data=(x, y), params=FLAGSHIP,
                          data_error=1e-7, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(w.state.chees.numpy(), cz)


def test_gradient_guards_raise_as_in_jax():
    """hmc and chees refuse tempering and best-value; chees's name is
    checked; the JAX package raises the same."""
    lp = lambda p: -(p ** 2).sum(1)
    for kind in ("hmc", "chees", "mala"):
        with pytest.raises(ValueError, match="rwm"):
            tkernel.build_chunk_runner(lp, 2, tkernel.FitConfig(kernel=kind,
                                                                 tempering_rungs=4),
                                       group_ids=np.repeat(np.arange(4), 4), n_groups=4)
        with pytest.raises(ValueError, match="rwm"):
            jkernel.build_chunk_runner(lambda t: -(t ** 2).sum(), 2, jfit.FitConfig(
                kernel=kind, tempering_rungs=4), group_ids=np.repeat(np.arange(4), 4),
                n_groups=4)
        with pytest.raises(ValueError, match="best-value"):
            tkernel.build_chunk_runner(lp, 2, tkernel.FitConfig(
                kernel=kind, sampling_optimization="best-value"))
    for cfg in (tkernel.FitConfig, jfit.FitConfig):
        assert cfg(kernel="chees").kernel == "chees"
        with pytest.raises(ValueError, match="chees"):
            cfg(kernel="nuts")
    x, y = flagship_data()
    w = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                           data_error=1e-7, n_walkers=16, dtype=torch.float64,
                           device="cpu", config=tfit.FitConfig(kernel="hmc",
                                                               tempering_rungs=4))
    with pytest.raises(ValueError, match="rwm"):
        w.adaptive_steps(400, auto=None)


def test_auto_stop_gates_on_the_shifted_band():
    """As tests/test_mala.py:130: a converged mala fit stops on its own
    band (0.45-0.7), not rwm's."""
    from lisp_mcmc_torch.models import line

    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0 + 0.05 * rng.standard_normal(50)
    w = tfit.walker_create(function=line, data=(x, y), params={"m": 2.0, "b": 1.0},
                           data_error=0.05, n_walkers=64, seed=0, walker_jitter=0.02,
                           dtype=torch.float64, device="cpu",
                           config=tfit.FitConfig(kernel="mala", temperature=2.0))
    w.adaptive_steps(40000, auto="rhat")
    assert w.age < 40000
    assert 0.45 < w.acceptance() < 0.8
