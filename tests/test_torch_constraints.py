"""Declared constraints (``priors.declared_constraints``) against the JAX package.

The NV physics prior's three hard constraints (nv-specific.lisp:31-34)
are declared as data in the port, so that both CUDA kernels evaluate
them; the JAX package's ``nv._nv_constraints`` is a closure that Pallas
traced.  Held here, exactly (the penalties are -1e9 multiples, exact in
both types):

- the declared form against ``lisp_mcmc_tpu.nv._nv_constraints`` on
  seeded points and on the ties (``mu1 == mu2``, ``mu2 - mu1 == 6``,
  ratios of exactly 0.9 and 1.1 in the fit's type), ``scale2 = 0`` and
  negative scales, in float32 and float64;
- against the closure the port had before (its torch value, dtype and
  all);
- ``split_prior``'s columns for the NV prior, with nothing left for torch,
  and the plain kernel version's constraint sum;
- the census of the table, the chunk kernel's coverage of declared and
  undeclared extras, and the NV fit on ``posterior_impl="chunk_kernel"``
  through a ``WalkerSet`` (the plain chunk on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import nv, priors, synthetic
from lisp_mcmc_torch.models import line
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_torch.walker_set import WalkerSet
from lisp_mcmc_tpu import nv as jnv

KEYS = ("scale1", "scale2", "mu1", "mu2", "sigma", "bg0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _points(np_dtype):
    """Seeded points about the constraints' edges, then the ties and the
    degenerate scales, as ``{name: (n,) array}`` of ``np_dtype``."""
    rng = np.random.default_rng(7)
    n = 200
    mu1 = rng.uniform(2855.0, 2875.0, n)
    mu2 = mu1 + rng.uniform(-4.0, 12.0, n)
    scale2 = rng.uniform(0.01, 0.03, n)
    scale1 = scale2 * rng.uniform(0.8, 1.2, n)
    one = np.dtype(np_dtype).type
    ties = [  # (scale1, scale2, mu1, mu2)
        (1.0, 1.0, 2860.0, 2860.0),          # mu1 == mu2
        (1.0, 1.0, 2860.0, 2866.0),          # mu2 - mu1 == 6, exact in both types
        (1.0, 1.0, 2860.5, 2866.5),
        (one(0.9), 1.0, 2860.0, 2870.0),     # ratio == 0.9 in the type
        (one(1.1), 1.0, 2860.0, 2870.0),     # ratio == 1.1 in the type
        (9.0, 10.0, 2860.0, 2870.0),         # 9 / 10 rounds to the type's 0.9
        (11.0, 10.0, 2860.0, 2870.0),        # 11 / 10 rounds to the type's 1.1
        (1.0, 0.0, 2860.0, 2870.0),          # ratio inf
        (0.0, 0.0, 2860.0, 2870.0),          # ratio NaN
        (-1.0, -1.0, 2860.0, 2870.0),        # negative scales, ratio 1
        (-1.0, 1.0, 2860.0, 2870.0),         # ratio -1
        (1.0, -1.0, 2866.0, 2860.0),         # everything fails
    ]
    cols = [np.concatenate([c, np.array(t, dtype=np.float64)])
            for c, t in zip((scale1, scale2, mu1, mu2), zip(*ties))]
    m = cols[0].shape[0]
    out = dict(zip(("scale1", "scale2", "mu1", "mu2"), cols))
    out.update(sigma=np.full(m, 10.0), bg0=np.full(m, 1.0))
    return {k: v.astype(np_dtype) for k, v in out.items()}


def _old_closure(p, pens, ds):
    """The port's NV constraints before they were declared (nv.py)."""
    c = priors.constraint_penalty
    return (c(p["mu1"] <= p["mu2"]) + c(p["mu2"] - p["mu1"] >= 6.0)
            + c((0.9 < p["scale1"] / p["scale2"]) & (p["scale1"] / p["scale2"] < 1.1)))


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_declared_nv_constraints_match_jax(np_dtype):
    pts = _points(np_dtype)
    got = nv._nv_constraints({k: torch.as_tensor(v) for k, v in pts.items()}, None, None)
    want = np.asarray(jnv._nv_constraints({k: jnp.asarray(v) for k, v in pts.items()},
                                          None, None), dtype=np.float64)
    np.testing.assert_array_equal(got.double().numpy(), want)
    # every tie falls as the comparison says, and each outcome occurs
    tail = got.numpy()[-12:]
    np.testing.assert_array_equal(
        tail, [-1e9, 0.0, 0.0, -1e9, -1e9, -1e9, -1e9, -1e9, -1e9, 0.0, -1e9, -3e9])
    assert {0.0, -1e9, -2e9} <= set(got.numpy()[:-12].tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_declared_nv_constraints_keep_the_closures_value(dtype):
    pts = {k: torch.as_tensor(v, dtype=dtype) for k, v in _points(np.float64).items()}
    got = nv._nv_constraints(pts, None, None)
    want = _old_closure(pts, None, None)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert nv._nv_constraints._constraints == (
        priors.le("mu1", "mu2"), priors.diff_ge("mu2", "mu1", 6.0),
        priors.ratio_in("scale1", "scale2", 0.9, 1.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_prior_resolves_the_nv_constraints(dtype):
    x, ys = synthetic.nv_spectra()
    prior = nv.make_nv_prior(ys[0])
    keys = ("mu2", "mu1", "scale2", "scale1", "bg0", "sigma")  # not the twin's order
    bounds, rest, cons, dens = tlk.split_prior(prior, keys)
    assert dens == ()
    assert rest is None
    assert [b[0] for b in bounds] == [keys.index(k) for k in KEYS]
    assert [(c.kind, a, b) for c, a, b in cons] == [
        ("le", 1, 0), ("diff_ge", 1, 0), ("ratio_in", 3, 2)]
    assert [(c.lo, c.hi) for c, _, _ in cons] == [(0.0, 0.0), (6.0, 0.0), (0.9, 1.1)]
    # the plain version's sum, column by column, equals the closure's
    pts = _points(np.float64)
    pos = torch.stack([torch.as_tensor(pts[k], dtype=dtype) for k in keys], dim=1)
    assert torch.equal(tlk.constraints_plain(pos, cons),
                       nv._nv_constraints({k: pos[:, i] for i, k in enumerate(keys)},
                                          None, None))
    # a constraint naming a parameter the fit lacks is refused like a bound
    assert tlk.split_prior(prior, tuple(k for k in keys if k != "mu2")) is None


def test_fused_table_and_census_of_the_nv_prior():
    x, ys = synthetic.nv_spectra()
    w = nv.nv_walker((x, ys[0]), n_walkers=128, device="cpu", dtype=torch.float64)
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float64)
    assert post.rest == () and len(post.constraints) == 3
    i = w.spec.index
    assert post.cidx.tolist() == [[0, i("mu1"), i("mu2")], [1, i("mu1"), i("mu2")],
                                  [2, i("scale1"), i("scale2")]]
    assert post.cval.dtype == torch.float64
    assert post.cval.tolist() == [[0.0, 0.0], [6.0, 0.0], [0.9, 1.1]]
    post32 = tlk.prepare_fused_terms(w.terms, w.spec, torch.float32)
    assert post32.cval.dtype == torch.float32  # rounded as torch compares in float32
    # per walker: 6 bounds entries, then le (1 add), diff_ge (a difference
    # and an add), ratio_in (a division and an add) and prior += total
    census = tlk.posterior_census(post)["per_walker"]
    single = tlk.fused_census(6, "normal", n_bounded=6)["per_walker"]
    assert census == {**single, "flops": single["flops"] + 5, "div": single["div"] + 1}
    # the fused plain version equals the fit's own posterior, constraints and all
    pos = w.state.position.clone()
    pos[::3, [i("mu1"), i("mu2")]] = pos[::3, [i("mu2"), i("mu1")]]
    pos[1::3, i("scale2")] = 0.0
    got = tlk.fused_posterior(pos, post)
    torch.testing.assert_close(got, w._log_post(pos), rtol=1e-12, atol=0)
    assert bool((got < -5e8).any()) and bool((got > -5e8).any())


def test_chunk_coverage_of_declared_and_undeclared_extras():
    x = np.linspace(0.0, 10.0, 50)

    def no_steep_line(p, pens, ds):
        return priors.constraint_penalty(p["m"] < 5.0)

    fits = {
        "declared": priors.declared_constraints(priors.le("b", "m")),
        "undeclared": no_steep_line,
    }
    for name, extra in fits.items():
        w = tfit.walker_create(function=line, data=(x, 2.0 * x + 1.0),
                               params={"m": 2.0, "b": 1.0}, data_error=0.5,
                               log_prior=tfit.make_bounds_prior({"m": (0.0, 4.0)}, extra),
                               n_walkers=128, device="cpu")
        reason = tck.chunk_coverage(w.terms, w.spec, w.config, 128, torch.float32)
        if name == "declared":
            assert reason is None
        else:
            assert "no_steep_line" in reason and "declared constraints" in reason


def test_nv_fit_on_the_chunk_kernel_path():
    """The NV fit as a WalkerSet on ``posterior_impl="chunk_kernel"``
    (the plain chunk stepper on the CPU): it runs, nothing is left for
    torch beside the kernels, and the walkers keep to the constraints."""
    x, ys = synthetic.nv_spectra()
    cfg = tfit.FitConfig(posterior_impl="chunk_kernel", auto=None)
    ws = WalkerSet(nv.nv_walker((x, y), n_walkers=128, device="cpu", config=cfg)
                   for y in ys[:2])
    ws.adaptive_steps(1200, collect_history=False)
    for w, truth in zip(ws, synthetic.NV_SPECTRA):
        assert w.age == 1200 and 0.1 < w.acceptance() < 0.5
        ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 128, torch.float32)
        assert ck is not None and ck.post.rest == () and len(ck.post.constraints) == 3
        best = w.most_likely_params()
        assert best["mu1"] <= best["mu2"] - 6.0
        assert 0.9 < best["scale1"] / best["scale2"] < 1.1
        assert abs(best["mu1"] - truth["mu1"]) < 1.5 and abs(best["mu2"] - truth["mu2"]) < 1.5
