"""Block-diagonal proposals in the port against the JAX package's.

With ``block_hyper``/``block_local``/``block_count`` set, rwm, mala, hmc
and chees apply L block by block and refresh it from a covariance whose
cross-block entries are masked to zero (kernel.py:601-695 and 1551-1557
of the JAX package; rwm then refreshes from the ensemble, not from the
moves).  The JAX package takes the blocked apply on every backend but the
TPU, so both packages run the same operators here.  Cases, after
tests/test_block_proposal.py:

- each of the four samplers on a block-diagonal Gaussian (d = 3 + 4 x 2,
  W = 64), ungrouped and in two groups, draw for draw over two chunks
  (rwm and mala 50 steps, hmc and chees 20) in float64 at rtol 1e-9, with
  the refreshed L's cross blocks exactly zero;
- the blocked apply equals the dense one on a generic block-diagonal L
  (one step, rtol 1e-12);
- the blocked refresh fires at W < d (24 walkers, d = 36), where the
  dense one cannot, draw for draw;
- stretch, demc and slice ignore the block fields; a bad layout raises;
- blocked rwm on the chunk kernel (its plain version here) against the
  JAX package's ``pallas_chunk`` in interpret mode, float32: the chunk
  by tests/test_torch_chunk.py's rule (>= 99 % of walkers agree, their
  positions within rtol 1e-4) and the refreshed L
  masked outside the blocks in both, its entries within 5e-3 of
  sqrt(L_ii L_jj) of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import kernel as tkernel
from lisp_mcmc_torch.convert import state_from_numpy
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_tpu import kernel as jkernel
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_tpu.ops.chunk_pallas import build_chunk_pallas
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder

from test_torch_gradient import (FLAGSHIP, GRADIENT, STATE_KEYS, arrays, compare,
                                 flagship_data, gradient_draws)

RTOL = 1e-9
BH, BL, NB = 3, 2, 4
CHUNKS = {"rwm": 50, "mala": 50, "hmc": 20, "chees": 20}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def block_mask(bh, bl, nb):
    d = bh + nb * bl
    m = np.zeros((d, d), bool)
    m[:bh, :bh] = True
    for s in range(nb):
        i0 = bh + s * bl
        m[i0:i0 + bl, i0:i0 + bl] = True
    return m


def gaussian(bh, bl, nb, seed=0):
    """A Gaussian with block-diagonal covariance: (mean, cov, JAX lp of
    one walker, port lp of a batch)."""
    rng = np.random.default_rng(seed)
    d = bh + nb * bl
    a = rng.standard_normal((d, d))
    cov = np.where(block_mask(bh, bl, nb), a @ a.T / d + 0.3 * np.eye(d), 0.0)
    cov *= np.outer(np.exp(rng.uniform(-2, 2, d)), np.exp(rng.uniform(-2, 2, d))) ** 0.5
    mean = rng.standard_normal(d)
    prec = np.linalg.inv(cov)
    jm, jp = jnp.asarray(mean), jnp.asarray(prec)
    tm, tp = torch.as_tensor(mean), torch.as_tensor(prec)

    def j_lp(th):
        r = th - jm
        return -0.5 * r @ jp @ r

    def t_lp(x):
        r = x - tm
        return -0.5 * torch.sum((r @ tp) * r, dim=1)

    return mean, cov, j_lp, t_lp


def start(W, bh=BH, bl=BL, nb=NB, G=1, l_scale=None, seed=0):
    mean, cov, j_lp, t_lp = gaussian(bh, bl, nb, seed)
    d = mean.size
    rng = np.random.default_rng(seed + 1)
    c = np.linalg.cholesky(cov)
    pos = mean + rng.standard_normal((W, d)) @ c.T
    # a diagonal start, which the refresh turns block-diagonal
    l0 = (l_scale or 2.38 / np.sqrt(d)) * np.diag(np.sqrt(np.diag(cov)))
    st = jkernel.init_state(jax.random.key(seed, impl="rbg"), jnp.asarray(pos),
                            jax.vmap(j_lp)(jnp.asarray(pos)), jnp.asarray(l0), G)
    return st, j_lp, t_lp, d


def blocked_fields(bh=BH, bl=BL, nb=NB):
    return dict(block_hyper=bh, block_local=bl, block_count=nb)


def rwm_draws(W, d, chunk):
    @jax.jit
    def draws(key):
        def step(k, _):
            k, kp, ka = jax.random.split(k, 3)
            return k, (jax.random.normal(kp, (W, d), jnp.float64),
                       jax.random.uniform(ka, (W,), jnp.float64))
        return lax.scan(step, key, None, length=chunk)

    def replay(key):
        key, (z, u) = draws(key)
        return key, (torch.as_tensor(np.array(z)), torch.as_tensor(np.array(u)))
    return replay


def run_both(kind, st, j_lp, t_lp, d, G=1, chunks=(False, True), adapt=True,
             chunk=None, **fields):
    W = st.position.shape[0]
    chunk = chunk or CHUNKS[kind]
    gids = np.repeat(np.arange(G), W // G) if G > 1 else None
    jcfg = jfit.FitConfig(kernel=kind, chunk_size=chunk, **fields)
    tcfg = tkernel.FitConfig(kernel=kind, chunk_size=chunk, **fields)
    j_run, _ = jkernel.build_chunk_runner(j_lp, d, jcfg, group_ids=gids, n_groups=G)
    t_run, _ = tkernel.build_chunk_runner(t_lp, d, tcfg, group_ids=gids, n_groups=G)
    if kind in GRADIENT:
        B = W // G
        rescue = (("even", B // 2) if B % 2 == 0 else "odd") if tcfg.rescue else None
        replay = gradient_draws(kind, tcfg, W, G, chunk, rescue, d=d)
    else:
        replay = rwm_draws(W, d, chunk)
    t_state, _ = state_from_numpy(arrays(st), dtype=torch.float64, device="cpu")
    j_fn = jax.jit(j_run)
    key = st.key
    for i, cold in enumerate(chunks):
        key, noise = replay(key)
        st, j_out = j_fn(st, adapt, True, cold)
        t_state, t_out = t_run(t_state, adapt, True, cold, noise=noise)
        compare(st, t_state, f"blocked {kind} G={G} chunk {i}")
        np.testing.assert_allclose(float(t_out["accept_rate"]), float(j_out["accept_rate"]),
                                   rtol=RTOL)
    return st, t_state, t_out


def assert_block_diagonal(l_matrix, bh, bl, nb):
    off = ~block_mask(bh, bl, nb)
    for g in range(l_matrix.shape[0]):
        assert np.all(l_matrix[g][off] == 0.0), "cross-block entries must stay 0"


@pytest.mark.parametrize("kind", ("rwm",) + GRADIENT)
@pytest.mark.parametrize("G", [1, 2], ids=["ungrouped", "G2"])
def test_blocked_sampler_matches_jax(kind, G):
    st, j_lp, t_lp, d = start(64, G=G, l_scale=1.0 if kind != "rwm" else 0.4)
    _, t_state, t_out = run_both(kind, st, j_lp, t_lp, d, G=G, **blocked_fields())
    L = t_state.l_matrix.numpy()
    assert_block_diagonal(L, BH, BL, NB)
    # every group took an in-band refresh, which the mask shaped
    assert np.all(np.abs(np.tril(L, k=-1)).sum(axis=(1, 2)) > 0.0), L
    acc = float(t_out["accept_rate"])
    assert 0.05 < acc < 0.98, f"{kind}: uninformative acceptance {acc}"
    if kind == "rwm":
        # blocked rwm keeps no moments (it refreshes from the ensemble)
        assert float(t_state.m_count.abs().sum()) == 0.0


@pytest.mark.parametrize("kind", ["rwm", "mala"])
def test_blocked_apply_equals_dense_on_blockdiag_l(kind):
    rng = np.random.default_rng(3)
    d = BH + NB * BL
    L = np.zeros((d, d))
    a = rng.standard_normal((BH, BH))
    L[:BH, :BH] = np.tril(a @ a.T + 2 * np.eye(BH))
    for s in range(NB):
        i0 = BH + s * BL
        b = rng.standard_normal((BL, BL))
        L[i0:i0 + BL, i0:i0 + BL] = np.tril(b @ b.T + 2 * np.eye(BL))
    L = 0.1 * L

    def lp(x):
        return -0.5 * torch.sum(x * x, dim=1)

    pos = torch.as_tensor(rng.standard_normal((16, d)))
    z = torch.as_tensor(rng.standard_normal((1, 16, d)))
    u = torch.as_tensor(rng.uniform(size=(1, 16)))
    states = []
    for fields in ({}, blocked_fields()):
        cfg = tkernel.FitConfig(kernel=kind, chunk_size=1, rescue=False, **fields)
        run, _ = tkernel.build_chunk_runner(lp, d, cfg)
        st = tkernel.init_state(pos, lp(pos), torch.as_tensor(L))
        states.append(run(st, False, False, True, noise=(z, u))[0])
    np.testing.assert_allclose(states[1].position.numpy(), states[0].position.numpy(),
                               rtol=1e-12, atol=1e-14)
    assert not torch.equal(states[1].position, pos)


def test_blocked_refresh_fires_at_w_below_d():
    """W = 24 < d = 36: the dense ensemble refresh is vetoed (counts > d
    fails) and L stays diagonal; the blocked one needs only counts > 4 and
    grows in-block off-diagonals with exact-zero cross blocks (the JAX
    package's test_blocked_refresh_fires_at_w_below_d), draw for draw."""
    bh, bl, nb = 4, 2, 16
    st, j_lp, t_lp, d = start(24, bh, bl, nb, seed=5)
    wide = dict(accept_low=0.001, accept_high=0.999, covariance_source="ensemble")
    _, t_b, _ = run_both("rwm", st, j_lp, t_lp, d, chunk=20, chunks=(False, False),
                         **wide, **blocked_fields(bh, bl, nb))
    L_b = t_b.l_matrix.numpy()[0]
    assert np.abs(np.tril(L_b[:bh, :bh], k=-1)).sum() > 0.0
    assert_block_diagonal(L_b[None], bh, bl, nb)
    _, t_d, _ = run_both("rwm", st, j_lp, t_lp, d, chunk=20, chunks=(False, False),
                         **wide)
    assert np.abs(np.tril(t_d.l_matrix.numpy()[0], k=-1)).sum() == 0.0


def test_l_free_samplers_ignore_blocks_and_bad_layouts_raise():
    st, _, t_lp, d = start(64)
    t_state, _ = state_from_numpy(arrays(st), dtype=torch.float64, device="cpu")
    for kind in ("stretch", "demc", "slice"):
        out = []
        for fields in ({}, blocked_fields()):
            run, _ = tkernel.build_chunk_runner(
                t_lp, d, tkernel.FitConfig(kernel=kind, chunk_size=5, **fields))
            out.append(run(t_state, True, True, True,
                           generator=torch.Generator().manual_seed(2))[0])
        for k in STATE_KEYS:
            assert torch.equal(getattr(out[0], k), getattr(out[1], k)), (kind, k)
    bad = dict(block_hyper=3, block_local=2, block_count=4)      # 11 != 10
    with pytest.raises(ValueError, match="block layout"):
        tkernel.build_chunk_runner(t_lp, 10, tkernel.FitConfig(**bad))
    with pytest.raises(ValueError, match="block layout"):
        jkernel.build_chunk_runner(lambda t: -(t ** 2).sum(), 10, jfit.FitConfig(**bad))
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.build_chunk_runner(t_lp, d, tkernel.FitConfig(**blocked_fields()),
                                   group_ids=np.arange(64) % 2, n_groups=2)


@pytest.fixture
def f32():
    """The chunk kernel is float32; JAX's x64 is off for this test."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_blocked_rwm_on_the_chunk_kernel_matches_jax(f32):
    """Blocked rwm on ``posterior_impl="chunk_kernel"``: the kernel takes
    the dense L with zero off-blocks (the same proposal) and ``adapt``
    masks the refresh outside it, in both packages."""
    fields = dict(block_hyper=2, block_local=2, block_count=2)
    chunk, W = 50, 256
    x, y = flagship_data()
    jcfg = jfit.FitConfig(chunk_size=chunk, **fields)
    tcfg = tfit.FitConfig(chunk_size=chunk, posterior_impl="chunk_kernel", **fields)
    jw = jfit.walker_create(function=j_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, seed=4, dtype=jnp.float32)
    tw = tfit.walker_create(function=t_lorder, data=(x, y), params=FLAGSHIP,
                            data_error=1e-7, n_walkers=W, device="cpu", config=tcfg)
    assert tck.chunk_coverage(tw.terms, tw.spec, tcfg, W, torch.float32) is None
    # Walkers from the Laplace draw; L its block-masked Cholesky factor.
    scale = np.abs(np.asarray(list(FLAGSHIP.values())))
    jac = np.asarray(jax.jacfwd(lambda u: j_lorder(x, dict(zip(FLAGSHIP, u * scale))))(
        jnp.ones(6, jnp.float32)), np.float64)
    cov = np.linalg.inv(jac.T @ jac / 1e-14) * np.outer(scale, scale)
    mask = block_mask(2, 2, 2)
    rng = np.random.default_rng(9)
    pos = (np.asarray(list(FLAGSHIP.values()))
           + rng.standard_normal((W, 6)) @ np.linalg.cholesky(cov).T).astype(np.float32)
    lp = np.asarray(jax.vmap(jw._log_post_one, in_axes=(0, None))(
        jnp.asarray(pos), jw._posterior_data()))
    L = (0.9 * np.linalg.cholesky(np.where(mask, cov, 0.0))).astype(np.float32)
    st = jkernel.init_state(jw.state.key, jnp.asarray(pos), jnp.asarray(lp),
                            jnp.asarray(L))
    pc = build_chunk_pallas(jw.terms, jw.spec, jcfg, W, jnp.float32, block_walkers=128,
                            interpret=True)
    j_run, _ = jkernel.build_chunk_runner(jw._log_post_one, 6, jcfg, takes_data=True,
                                          pallas_chunk=pc)
    ck = tck.build_chunk_kernel(tw.terms, tw.spec, tcfg, W, torch.float32,
                                block_walkers=128)
    t_run, _ = tkernel.build_chunk_runner(tw._log_post, 6, tcfg, chunk_kernel=ck)
    t_state, _ = state_from_numpy(arrays(st), dtype=torch.float32, device="cpu")
    _, sub = jax.random.split(st.key)
    seed = int(np.asarray(jax.random.key_data(sub)).reshape(-1)[-1].astype(np.int32))
    j_state, j_out = j_run(st, True, True, True, jw._posterior_data())
    t_state, t_out = t_run(t_state, True, True, True,
                           noise={"seed": torch.tensor([seed], dtype=torch.int32)})
    acc = float(j_out["accept_rate"])
    assert 0.2 < acc < 0.4, f"want an in-band chunk (a refresh), got {acc}"
    j_pos, t_pos = np.asarray(j_state.position), t_state.position.numpy()
    same = np.isclose(t_pos, j_pos, rtol=1e-4, atol=0).all(axis=1)
    assert same.mean() >= 0.99, f"positions agree for {same.mean():.4f} of walkers"
    jl, tl = np.asarray(j_state.l_matrix)[0], t_state.l_matrix.numpy()[0]
    assert_block_diagonal(jl[None], 2, 2, 2)
    assert_block_diagonal(tl[None], 2, 2, 2)
    assert np.abs(np.tril(tl, k=-1)).sum() > 0.0 and not np.array_equal(tl, L), \
        "the chunk was in band: L must have been refreshed"
    ref = np.sqrt(np.outer(np.abs(np.diag(jl)), np.abs(np.diag(jl))))
    assert np.all(np.abs(tl - jl) <= 5e-3 * ref), np.max(np.abs(tl - jl) / ref)
