"""The port's stretch, demc and slice samplers against the JAX package's,
draw for draw.

The red-black ensemble steps (kernel.py:804-1142 of the JAX package)
split their keys per step (``key, k_lo, k_hi = split(key, 3)``) and per
half (stretch ``split(k, 3)``, demc ``split(k, 4)``, slice ``split(k, 5)``
and a split per shrink iteration).  These tests replay that stream in a
scan of their own, inject it through the port runner's ``noise=`` (its
layout is in ``lisp_mcmc_torch.kernel.build_chunk_runner``), start both
from the same state and compare every state array after each of two
chunks (the first annealing, the second cold), in float64 at rtol 1e-9
(slice: chunks of 20 steps; its chains amplify the 1e-16 rounding
differences of the posterior sums about tenfold every five steps, to
4e-12 after 50 steps and 1e-8 after 100):
ungrouped (W = 256, half-ensembles of Bh = 128: the slice sampler's
median of an even count) and with two contiguous groups (B = 54,
Bh = 27).  ``sampling_steps`` is held against the JAX verb the same way,
its walker's runners drawing from the JAX walker's key.  The guards
(span, odd blocks, Bh < 2, irregular groups, a collapsed ensemble) raise
as in the JAX package, and a collapsed ensemble does not stop the
gradient samplers.
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
from lisp_mcmc_torch.convert import state_from_numpy
from lisp_mcmc_tpu import kernel as jkernel
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_torch import kernel as tkernel
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder

FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
D = 6
CHUNKS = {"stretch": 50, "demc": 50, "slice": 20}
RTOL = 1e-9
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")
OUT_KEYS = ("logprob_max", "logprob_mean", "logprob_min", "accept_rate",
            "group_accept")
SAMPLERS = ("stretch", "demc", "slice")


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


def _walkers(n_walkers, seed=4, jitter=1e-4, config=None):
    x, y = flagship_data()
    jw = jfit.walker_create(function=j_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=n_walkers, seed=seed,
                            walker_jitter=jitter, config=config)
    tw = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=n_walkers, dtype=torch.float64,
                            device="cpu")
    return jw, tw


def _arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}


_REPLAYS = {}


def ensemble_draws(kind, cfg, G, Bh, chunk):
    """A jitted ``key -> (key, noise)`` that draws one chunk of ``kind``
    steps as the JAX kernel does, in the port's ``noise=`` layout."""
    tag = (kind, G, Bh, chunk, cfg.slice_max_expand, cfg.slice_max_shrink,
           cfg.demc_jitter)
    if tag in _REPLAYS:
        return _REPLAYS[tag]
    f64, shape = jnp.float64, (G, Bh)
    b, m_exp, m_shr = cfg.demc_jitter, cfg.slice_max_expand, cfg.slice_max_shrink
    uni = lambda k: jax.random.uniform(k, shape, f64)

    def donors(k):
        return jax.random.randint(k, shape + (2,), 0, jnp.asarray([Bh, Bh - 1]))

    def half(k):
        if kind == "stretch":
            kj, kz, ka = jax.random.split(k, 3)
            return {"j": jax.random.randint(kj, shape, 0, Bh), "z": uni(kz), "u": uni(ka)}
        if kind == "demc":
            kj, kg, kjump, ka = jax.random.split(k, 4)
            return {"j": donors(kj), "g": jax.random.uniform(kg, shape, f64, 1.0 - b, 1.0 + b),
                    "jump": uni(kjump), "u": uni(ka)}
        kj, ke, ki, kjk, kshr = jax.random.split(k, 5)
        shrink = []
        for _ in range(m_shr):
            kshr, k1 = jax.random.split(kshr)
            shrink.append(uni(k1))
        return {"j": donors(kj), "e": uni(ke), "i": uni(ki),
                "k": jax.random.randint(kjk, shape, 0, m_exp), "shrink": jnp.stack(shrink)}

    @jax.jit
    def draws(key):
        def body(k, _):
            k, k_lo, k_hi = jax.random.split(k, 3)
            return k, jax.tree.map(lambda a, c: jnp.stack([a, c]), half(k_lo), half(k_hi))
        return lax.scan(body, key, None, length=chunk)

    def replay(key):
        key, noise = draws(key)
        return key, {k: torch.as_tensor(np.array(v)) for k, v in noise.items()}

    _REPLAYS[tag] = replay
    return replay


# (walkers, groups): ungrouped Bh = 128 (even), two groups of 54 (Bh = 27)
LAYOUTS = [(256, 1), (108, 2)]


@pytest.mark.parametrize("kind", SAMPLERS)
@pytest.mark.parametrize("n_walkers,G", LAYOUTS, ids=["ungrouped", "G2"])
def test_ensemble_step_matches_jax(kind, n_walkers, G):
    jw, tw = _walkers(n_walkers)
    gids = np.repeat(np.arange(G), n_walkers // G) if G > 1 else None
    CHUNK = CHUNKS[kind]
    jcfg = jfit.FitConfig(kernel=kind, chunk_size=CHUNK)
    tcfg = tkernel.FitConfig(kernel=kind, chunk_size=CHUNK)
    j_run, j_hist = jkernel.build_chunk_runner(jw._log_post_one, D, jcfg, group_ids=gids,
                                               n_groups=G, takes_data=True)
    t_run, t_hist = tkernel.build_chunk_runner(tw._log_post, D, tcfg, group_ids=gids,
                                               n_groups=G)
    l0 = np.broadcast_to(np.asarray(jw.state.l_matrix[0]), (G, D, D))
    rng = np.random.default_rng(1)
    j_state = dataclasses.replace(
        jw.state, l_matrix=jnp.asarray(l0),
        # moments carried in from an earlier phase, which the step clears
        m_sum=jnp.asarray(rng.standard_normal((G, D))), m_outer=jnp.zeros((G, D, D)),
        m_count=jnp.full((G,), 7.0))
    t_state, _ = state_from_numpy(_arrays(j_state), dtype=torch.float64, device="cpu")
    replay = ensemble_draws(kind, tcfg, G, n_walkers // G // 2, CHUNK)
    key = j_state.key
    hist = kind == "slice"    # the thinned history runner, on the slowest step
    j_fn = jax.jit(j_hist if hist else j_run)
    t_fn = t_hist if hist else t_run
    for chunk in range(2):
        cold = chunk == 1
        key, noise = replay(key)
        j_state, j_out = j_fn(j_state, True, True, cold, jw._posterior_data())
        t_state, t_out = t_fn(t_state, True, True, cold, noise=noise)
        for k, ja in _arrays(j_state).items():
            np.testing.assert_allclose(getattr(t_state, k).numpy(), ja, rtol=RTOL, atol=0,
                                       err_msg=f"{kind} G={G} chunk {chunk}: {k}")
        for k in OUT_KEYS + (("positions", "logprobs") if hist else ()):
            np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), rtol=RTOL,
                                       atol=0, err_msg=f"{kind} G={G} chunk {chunk}: {k}")
        assert t_state.age == int(j_state.age)
        np.testing.assert_array_equal(jax.random.key_data(j_state.key),
                                      jax.random.key_data(key))
        assert float(t_state.m_count.sum()) == 0.0
        acc = float(t_out["accept_rate"])
        if kind == "slice":
            assert acc > 0.9, f"slice: landed share {acc}"
            assert 2 * 3 * CHUNK <= t_out["posterior_evals"] <= 2 * 38 * CHUNK
        else:
            assert 0.05 < acc < 0.95, f"{kind}: uninformative acceptance {acc}"
            assert t_out["posterior_evals"] == 2 * CHUNK


def test_slice_polling_changes_nothing(monkeypatch):
    """Every SLICE_POLL gives the same chains bit for bit (an iteration
    after a walker is done leaves it unchanged), and polling runs fewer
    posterior evaluations than the whole budget."""
    jw, tw = _walkers(256)
    cfg = tkernel.FitConfig(kernel="slice", chunk_size=20)
    state, _ = state_from_numpy(_arrays(jw.state), dtype=torch.float64, device="cpu")
    key, noise = ensemble_draws("slice", cfg, 1, 128, 20)(jw.state.key)
    results = {}
    for poll in (0, 1, 3):
        monkeypatch.setattr(tkernel, "SLICE_POLL", poll)
        run, _ = tkernel.build_chunk_runner(tw._log_post, D, cfg)
        results[poll] = run(state, True, True, True, noise=noise)
    for poll in (1, 3):
        for k in STATE_KEYS:
            assert torch.equal(getattr(results[poll][0], k), getattr(results[0][0], k)), k
    evals = {p: r[1]["posterior_evals"] for p, r in results.items()}
    assert evals[0] == 2 * 20 * (2 * 3 + 32)
    assert evals[1] <= evals[3] < evals[0]


def _patch_draws(tw, key):
    """Make ``tw``'s chunk runners draw what the JAX walker's would from
    ``key`` (the JAX walker's key before the verb)."""
    box = [key]
    real = tw._runner

    def runner(greedy=False, with_history=True):
        run = real(greedy, with_history)
        cfg = tw.config

        def wrapped(state, adapt, refresh, cold, *, generator=None, noise=None):
            W = state.position.shape[0]
            box[0], nz = ensemble_draws(cfg.kernel, cfg, 1, W // 2, cfg.chunk_size)(box[0])
            return run(state, adapt, refresh, cold, noise=nz)
        return wrapped

    tw._runner = runner
    return box


@pytest.mark.parametrize("kind", SAMPLERS)
def test_sampling_steps_matches_jax(kind):
    """``Walker.sampling_steps`` against the JAX verb: the anneal's L kept,
    T = 1, history kept, the same chains."""
    CHUNK = CHUNKS[kind]
    jw, tw = _walkers(256, seed=6, config=jfit.FitConfig(chunk_size=CHUNK))
    tw.config = tkernel.FitConfig(chunk_size=CHUNK)
    tw.state, _ = state_from_numpy(_arrays(jw.state), dtype=torch.float64, device="cpu")
    box = _patch_draws(tw, jw.state.key)
    jw.sampling_steps(2 * CHUNK, kernel=kind)
    tw.sampling_steps(2 * CHUNK, kernel=kind)
    np.testing.assert_array_equal(jax.random.key_data(jw.state.key),
                                  jax.random.key_data(box[0]))
    for k, ja in _arrays(jw.state).items():
        np.testing.assert_allclose(getattr(tw.state, k).numpy(), ja, rtol=RTOL, atol=0,
                                   err_msg=f"sampling_steps {kind}: {k}")
    j_pos, j_lp = jw._history()
    t_pos, t_lp = tw._history()
    np.testing.assert_allclose(t_pos, j_pos, rtol=RTOL, atol=0)
    np.testing.assert_allclose(t_lp, j_lp, rtol=RTOL, atol=0)
    assert tw.acceptance() == pytest.approx(jw.acceptance(), rel=RTOL)
    assert tw.config.kernel == "rwm" and tw.age == int(jw.state.age)
    assert tw.posterior_evals >= 2 * 2 * CHUNK


def test_guards_raise_as_in_jax():
    """Span, odd blocks, Bh < 2, irregular groups, tempering with an
    ensemble kernel: the port raises where the JAX package does."""
    lp1 = lambda p: -(p ** 2).sum(1)

    def both(kind, W, d, G=1, gids=None, **fields):
        gids = (np.repeat(np.arange(G), W // G) if G > 1 else None) if gids is None else gids
        pos = np.linspace(0.5, 1.5, W * d).reshape(W, d)
        jcfg = jfit.FitConfig(kernel=kind, chunk_size=2, **fields)
        tcfg = tkernel.FitConfig(kernel=kind, chunk_size=2, **fields)
        errors = []
        try:
            run, _ = jkernel.build_chunk_runner(lambda th: -(th ** 2).sum(), d, jcfg,
                                                group_ids=gids, n_groups=G)
            st = jkernel.init_state(jax.random.key(0), jnp.asarray(pos),
                                    -(jnp.asarray(pos) ** 2).sum(1), np.eye(d), G)
            run(st, True, True, True)
        except ValueError as e:
            errors.append(str(e))
        with pytest.raises(ValueError) as t_err:
            run, _ = tkernel.build_chunk_runner(lp1, d, tcfg, group_ids=gids, n_groups=G)
            tpos = torch.as_tensor(pos)
            run(tkernel.init_state(tpos, lp1(tpos), torch.eye(d, dtype=tpos.dtype), G),
                True, True, True, generator=torch.Generator().manual_seed(0))
        assert errors, f"{kind}: the JAX package did not raise"
        return errors[0], str(t_err.value)

    for kind in SAMPLERS:
        j, t = both(kind, 6, 6)                       # 6 walkers span 5 dims
        assert "affine subspace" in j and "affine subspace" in t
        j, t = both(kind, 2 * 9, 8, G=2)              # B = 9 is odd
        assert "even number" in j and "even number" in t
        j, t = both(kind, 16, 2, gids=np.arange(16) % 2, G=2)
        assert "contiguous" in j and "contiguous" in t
        j, t = both(kind, 8, 2, G=2, tempering_rungs=2)
        assert "search phase" in j and "search phase" in t
    for kind in ("demc", "slice"):
        j, t = both(kind, 2, 1)                       # Bh = 1: no two donors
        assert ">= 4 walkers" in j and ">= 4 walkers" in t


def test_collapsed_ensemble_and_gradient_samplers_raise():
    x, y = flagship_data()
    w = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                           data_error=1e-7, n_walkers=64, dtype=torch.float64,
                           device="cpu")                     # walker_jitter = 0
    for kind in SAMPLERS:
        with pytest.raises(ValueError, match="zero spread"):
            w.sampling_steps(200, kernel=kind)
    # per group: one collapsed group of two is enough
    w2 = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=64, dtype=torch.float64,
                            walker_jitter=1e-3, device="cpu")
    w2.state.position[32:] = w2.state.position[32]
    w2.group_ids, w2.n_groups = np.repeat(np.arange(2), 32), 2
    with pytest.raises(ValueError, match="zero spread"):
        w2.sampling_steps(200, kernel="demc")
    # The gradient samplers move along L, so a collapsed ensemble does not
    # stop them (the JAX package checks only the ensemble samplers).
    for kind in ("mala", "hmc", "chees"):
        w.sampling_steps(200, kernel=kind)
    w.sampling_steps(200)                                   # the default, mala
    assert w.config.kernel == "rwm" and w2.config.kernel == "rwm"
    # mala twice (201 a chunk: the chunk's start and a step each), hmc
    # 8 a step, chees at least one a step
    assert w.gradient_evals >= 2 * 201 + (8 * 200 + 1) + 201
    assert np.isfinite(w.state.logprob.numpy()).all()
