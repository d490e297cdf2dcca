"""The port's partial-pooling model against the JAX package's.

``lisp_mcmc_torch.HierarchicalFit`` and ``lisp_mcmc_tpu.HierarchicalFit``
built on the same numpy inputs (float64, the CPU; 3-4 datasets of 8-12
points, W <= 64):

- construction: the walk-space keys, the start (numpy draws both: bit for
  bit where the prior medians are exact arithmetic; within 2 ulp where
  they go through exp or ndtri, which XLA and PyTorch round apart in
  ~15 % and ~70 % of float64 arguments), the L seed at 1e-12, each
  PriorSpec distribution's log_pdf at 32 points at 1e-12, and the
  validation errors of both packages, message for message;
- the posterior at 16 positions around the start and 4 past a tau wall,
  normal and Student-t, diagonal and correlated: the port's batched
  posterior against ``jax.vmap(_log_post_one)`` at rtol 1e-10, one walker
  against the batch at 1e-12;
- multi-term blocks: the stacked x, y and sigma of ``_build_term_id_blocks``
  equal JAX's, the first-class term list equals the hand-written recipe
  bit for bit, and a list of T scalar sigmas over T points, which JAX
  reads per term, is refused;
- chains draw for draw: a 200-step rwm chunk (diagonal and correlated) and
  a 50-step mala chunk with the rescue, JAX's key stream replayed into the
  port's runner: every state array at 1e-9, the acceptances equal;
- one history, carried over by ``convert.hierarchical_from_numpy``: the
  natural-space accessors at 1e-10; the per-dataset waic, loo, loo_pit
  and audit, and loo / loo_pit on the joint pointwise axis (elpd and
  Pareto k at 1e-8);
- ``prior_predictive`` and ``predict_new`` from one seed (the decoded
  draws' curves at 1e-12; replicates with JAX's normal stream injected);
- ``laplace_approx`` on a conjugate normal-normal hierarchy through the
  fit's ``prior_spec`` (1e-8, as the evidence tests).

The refit cross-validation of the fit (``kfold``, ``reloo``, ``logo``) is
held against JAX in ``test_torch_hier_refit.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import diagnostics as td
from lisp_mcmc_torch import hierarchical as th
from lisp_mcmc_torch import kernel as tkernel
from lisp_mcmc_torch import predictive as tpred
from lisp_mcmc_torch.convert import hierarchical_from_numpy
from lisp_mcmc_tpu import diagnostics as jd
from lisp_mcmc_tpu import hierarchical as jh
from lisp_mcmc_tpu import kernel as jkernel

from test_torch_blocked import rwm_draws
from test_torch_gradient import gradient_draws

RTOL = 1e-10
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def line(x, p):
    return p["a"] * x + p["b"]


def const_model(x, p):
    return p["c"] + 0.0 * x


def grid(S=4, lens=None, seed=0, noise=0.1):
    """S lines whose slope and offset drift with s; ``lens`` ragged."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(S):
        n = 10 if lens is None else lens[s]
        x = np.linspace(0.0, 1.0, n)
        out.append((x, (1.0 + 0.2 * s) * x + 0.3 * s + noise * rng.standard_normal(n)))
    return out


def hyper(M, exact=False):
    """Hyperpriors of ``a`` (and ``b``) in package ``M``; ``exact``: medians
    that are exact arithmetic in both packages (no exp, no ndtri)."""
    tau_mu = 0.0 if exact else np.log(0.3)
    return {"a": (M.Gaussian(1.0, 2.0), M.LogNormal(tau_mu, 0.5)),
            "b": ((-3.0, 3.0), M.LogNormal(tau_mu, 0.7))}


# name -> (datasets, guess, kwargs common to both, per-package kwargs)
CASES = {
    "diag_complete": (grid(), {"a": 1.0, "b": 0.2},
                      dict(pooled=["a"], data_error=0.1),
                      lambda M: dict(hyper={"a": hyper(M)["a"]},
                                     local_priors={"b": M.Gaussian(0.0, 3.0)})),
    "full": (grid(), {"a": 1.0, "b": 0.2}, dict(correlation="full", data_error=0.1),
             lambda M: dict(hyper=hyper(M))),
    "partial_prior": (grid(3), {"a": 1.0, "b": 0.2, "k": 0.5},
                      dict(pooled=["a", "b"], data_error=[0.1, 0.2, 0.15]),
                      lambda M: dict()),
    "ragged": (grid(3, lens=(8, 12, 10)), [{"a": 1.0, "b": 0.0}, {"a": 1.2, "b": 0.3},
                                           {"a": 1.4, "b": 0.6}],
               dict(data_error=0.1), lambda M: dict(hyper=hyper(M))),
    "default_hyper": (grid(), {"a": 1.0, "b": 0.2}, dict(data_error=0.1),
                      lambda M: dict()),
}


def quad_line(x, p):
    return p["a"] * x + p["b"] + p.get("k", 0.0) * x * x


def build(name, W=32, seed=3):
    """The JAX fit and the port's (float64, CPU) of case ``name``."""
    data, guess, common, per = CASES[name]
    fn = quad_line if name == "partial_prior" else line
    kw = dict(n_walkers=W, seed=seed, **common)
    j = jh.HierarchicalFit(fn, data, guess, **kw, **per(jfit))
    t = th.HierarchicalFit(fn, data, guess, dtype=torch.float64, device="cpu", **kw,
                           **per(tfit))
    return j, t


def state_arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}


def carry(j, t):
    """The JAX fit's state and history into the port's."""
    a = state_arrays(j.state)
    pos, lp = j._history()
    a.update(keys=j.spec.keys, history_positions=np.asarray(pos),
             history_logprobs=np.asarray(lp), age=int(j.state.age),
             anneal_step=int(j.state.anneal_step))
    return hierarchical_from_numpy(t, a)


def j_posterior(j, pos):
    f = jax.vmap(j._log_post_one, in_axes=(0, None))
    return np.asarray(f(jnp.asarray(pos), j._posterior_data()))


# -------------------------------------------------------- construction


@pytest.mark.parametrize("name", list(CASES))
def test_construction_matches_jax(name):
    j, t = build(name)
    assert t.spec.keys == j.spec.keys
    assert (t.pooled, t.n_corr, t.n_datasets) == (j.pooled, j.n_corr, j.n_datasets)
    jp, tp = np.asarray(j.state.position), t.state.position.numpy()
    # numpy draws both; the prior medians' exp/ndtri may round 1 ulp apart
    np.testing.assert_allclose(tp, jp, rtol=4.5e-16, atol=0)
    np.testing.assert_allclose(t.state.l_matrix.numpy(), np.asarray(j.state.l_matrix),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(t.state.logprob.numpy(), np.asarray(j.state.logprob),
                               rtol=RTOL)
    assert (t.prior_spec is None) == (j.prior_spec is None) == (name == "partial_prior")
    dists = t.prior_spec if t.prior_spec is not None else {}
    pts = np.random.default_rng(1).uniform(-2.0, 3.0, 32)
    pts[:4] = [0.05, 1.0, 2.5, -0.5]
    for k in dists:
        jv = np.asarray(j.prior_spec[k].log_pdf(jnp.asarray(pts)))
        tv = t.prior_spec[k].log_pdf(torch.as_tensor(pts)).numpy()
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0, err_msg=k)
    for k, (jm, jt) in j._hyper.items():
        assert t._hyper[k] == (type(t._hyper[k][0])(**dataclasses.asdict(jm)),
                               type(t._hyper[k][1])(**dataclasses.asdict(jt)))


@pytest.mark.parametrize("correlation", ["diag", "full"])
def test_start_is_bit_identical_where_the_medians_are_exact(correlation):
    """Gaussian mu priors (median mu), LogNormal(0, s) tau priors (median
    exp(0) = 1) and a Uniform slant prior: every column of the start, the
    per-dataset guesses' z included, equals JAX's bit for bit."""
    data = grid()
    guesses = [{"a": 1.0 + 0.1 * s, "b": 0.1 * s} for s in range(4)]
    kw = dict(n_walkers=64, seed=11, correlation=correlation, data_error=0.1)
    if correlation == "full":
        kw_j, kw_t = dict(corr_prior=(-1.0, 1.0)), dict(corr_prior=(-1.0, 1.0))
    else:
        kw_j, kw_t = {}, {}
    j = jh.HierarchicalFit(line, data, guesses, hyper=hyper(jfit, exact=True), **kw, **kw_j)
    t = th.HierarchicalFit(line, data, guesses, hyper=hyper(tfit, exact=True),
                           dtype=torch.float64, device="cpu", **kw, **kw_t)
    np.testing.assert_array_equal(t.state.position.numpy(), np.asarray(j.state.position))
    np.testing.assert_array_equal(np.diag(t.state.l_matrix.numpy()[0]),
                                  np.diag(np.asarray(j.state.l_matrix)[0]))


X4 = np.linspace(0.0, 1.0, 4)
TWO = [(X4, X4), (X4, X4)]


def _refusals(M):
    G, L = M.Gaussian, M.LogNormal
    good = {"a": (G(0.0, 1.0), L(0.0, 1.0)), "b": (G(0.0, 1.0), L(0.0, 1.0))}
    return {
        "proposal": ((line, TWO, {"a": 1.0, "b": 0.0}), dict(proposal="x")),
        "correlation": ((line, TWO, {"a": 1.0, "b": 0.0}), dict(correlation="x")),
        "one_dataset": ((line, TWO[:1], {"a": 1.0, "b": 0.0}), {}),
        "guess_count": ((line, TWO, [{"a": 1.0, "b": 0.0}] * 3), {}),
        "unknown_pooled": ((line, TWO, {"a": 1.0, "b": 0.0}), dict(pooled=["q"])),
        "nothing_pooled": ((line, TWO, {"a": 1.0, "b": 0.0}), dict(pooled=[])),
        "tau_support": ((line, TWO, {"a": 1.0, "b": 0.0}),
                        dict(pooled=["a"], hyper={"a": (G(0.0, 1.0), G(0.0, 1.0))})),
        "hyper_not_pooled": ((line, TWO, {"a": 1.0, "b": 0.0}),
                             dict(pooled=["a"], hyper=good)),
        "bad_dist": ((line, TWO, {"a": 1.0, "b": 0.0}),
                     dict(hyper={"a": ("x",), "b": good["b"]})),
        "local_prior_pooled": ((line, TWO, {"a": 1.0, "b": 0.0}),
                               dict(pooled=["a"], local_priors={"a": G(0.0, 1.0)})),
        "full_one_pooled": ((line, TWO, {"a": 1.0, "b": 0.0}),
                            dict(pooled=["a"], correlation="full")),
        "corr_prior_diag": ((line, TWO, {"a": 1.0, "b": 0.0}),
                            dict(corr_prior=G(0.0, 1.0))),
        "block_l_free": ((line, TWO, {"a": 1.0, "b": 0.0}),
                         dict(proposal="block", config=M.FitConfig(kernel="stretch"))),
        "term_structure": (([line, line], TWO, {"a": 1.0, "b": 0.0}), {}),
        "term_errors": (([line, line], [[TWO[0], TWO[1]]] * 2, {"a": 1.0, "b": 0.0}),
                        dict(data_error=[0.1, 0.1, 0.1])),
    }


@pytest.mark.parametrize("case", list(_refusals(tfit)))
def test_validation_errors_match_jax(case):
    (fn, data, guess), kw = _refusals(jfit)[case]
    with pytest.raises(ValueError) as je:
        jh.HierarchicalFit(fn, data, guess, n_walkers=8, **kw)
    (fn, data, guess), kw = _refusals(tfit)[case]
    with pytest.raises(ValueError) as te:
        th.HierarchicalFit(fn, data, guess, n_walkers=8, dtype=torch.float64,
                           device="cpu", **kw)
    assert str(te.value) == str(je.value)


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.HierarchicalFit(line, grid(), {"a": 1.0, "b": 0.2}, n_walkers=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.compare_pooling(line, grid(), {"a": 1.0, "b": 0.2})
    assert tfit.fit.default_dtype() is torch.float32
    t = th.HierarchicalFit(line, grid(), {"a": 1.0, "b": 0.2}, n_walkers=8, device="cpu")
    assert t.dtype is torch.float32 and t.state.position.dtype is torch.float32
    ds = t._datasets[0].astype(torch.float64)
    assert ds.y.dtype is torch.float64 and float(ds.log_norm_const) == pytest.approx(
        float(t._datasets[0].log_norm_const), rel=1e-6)


# --------------------------------------------------------- the posterior


def probe_positions(j, n=16, n_wall=4, seed=5):
    rng = np.random.default_rng(seed)
    start = np.asarray(j.state.position)
    pos = start[rng.integers(0, start.shape[0], n + n_wall)].copy()
    pos += 0.05 * rng.standard_normal(pos.shape) * np.abs(pos).clip(0.1)
    dp = len(j.pooled)
    pos[n:, dp:2 * dp] = -np.abs(pos[n:, dp:2 * dp]) - 0.2     # past the tau wall
    return pos


@pytest.mark.parametrize("name,likelihood", [
    ("diag_complete", None), ("full", None), ("partial_prior", None), ("ragged", None),
    ("diag_complete", "student_t"), ("full", "poisson")])
def test_posterior_matches_jax(name, likelihood):
    if likelihood == "student_t":
        lls = (jfit.make_student_t_likelihood(4.0), tfit.make_student_t_likelihood(4.0))
    elif likelihood == "poisson":
        lls = (jfit.log_likelihood_poisson, tfit.log_likelihood_poisson)
    else:
        lls = (None, None)
    data, guess, common, per = CASES[name]
    fn = quad_line if name == "partial_prior" else line
    if likelihood == "poisson":
        rng = np.random.default_rng(2)
        data = [(x, rng.poisson(5.0 + 3.0 * x).astype(float)) for x, _ in data]
        guess = {"a": 3.0, "b": 5.0}
    kw = dict(n_walkers=16, seed=3, **common)
    j = jh.HierarchicalFit(fn, data, guess, log_likelihood=lls[0], **kw, **per(jfit))
    t = th.HierarchicalFit(fn, data, guess, log_likelihood=lls[1], dtype=torch.float64,
                           device="cpu", **kw, **per(tfit))
    pos = probe_positions(j)
    want = j_posterior(j, pos)
    got = t._log_post(torch.as_tensor(pos)).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=0)
    one = np.asarray([float(t._custom_log_post(torch.as_tensor(p), t._posterior_data()))
                      for p in pos])
    np.testing.assert_allclose(one, got, rtol=1e-12, atol=0)
    # the prior term alone: the kind-by-kind evaluation against JAX's spec
    cols = t.spec.unflatten(torch.as_tensor(pos))
    np.testing.assert_allclose(t.terms[0].prior(cols).numpy(),
                               np.asarray(jax.vmap(lambda v: j.terms[0].prior(
                                   j.spec.unflatten(v), None))(jnp.asarray(pos))),
                               rtol=1e-12, atol=1e-12)
    assert float(t.diagnose_params(t.spec.make(pos[0].tolist()))) == pytest.approx(
        float(j.diagnose_params(j.spec.make(pos[0].tolist()))), rel=RTOL)


# ---------------------------------------------------- multi-term blocks


def quad_term(x, p):
    return 0.5 * p["a"] * x ** 2 + p["b"]


def term_grid(S=3, seed=0):
    rng = np.random.default_rng(seed)
    x1, x2 = np.linspace(0.0, 10.0, 12), np.linspace(0.0, 3.0, 10)
    out = []
    for s in range(S):
        m = 2.0 + 0.1 * s
        out.append([(x1, m * x1 + 1.0 + rng.normal(0, 0.2, 12)),
                    (x2, 0.5 * m * x2 ** 2 + 1.0 + rng.normal(0, 0.1, 10))])
    return out


def test_term_id_blocks_match_jax_and_the_recipe():
    data = term_grid()
    for err in (0.2, [[0.2, 0.1]] * 3,
                [[np.full(12, 0.2), np.full(10, 0.1)]] * 3,
                [np.linspace(0.1, 0.3, 22)] * 3):
        jm, jsets, jerr = jh._build_term_id_blocks([line, quad_term], data, err)
        tm, tsets, terr = th._build_term_id_blocks([line, quad_term], data, err)
        for (jx, jy), (tx, ty) in zip(jsets, tsets):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        if np.isscalar(err):
            assert terr == jerr
        else:
            for a, b in zip(terr, jerr):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert tm.__name__ == jm.__name__
    # the first-class list is the hand-written recipe, bit for bit
    hyp = {"a": (tfit.Gaussian(2.0, 1.0), tfit.LogNormal(np.log(0.2), 0.5)),
           "b": (tfit.Gaussian(1.0, 1.0), tfit.LogNormal(np.log(0.2), 0.5))}
    recipe_data, errs = [], []
    for (x1, y1), (x2, y2) in data:
        X = np.concatenate([np.stack([x1, np.zeros_like(x1)], -1),
                            np.stack([x2, np.ones_like(x2)], -1)])
        recipe_data.append((X, np.concatenate([y1, y2])))
        errs.append(np.concatenate([np.full(12, 0.2), np.full(10, 0.1)]))

    def recipe(x, p):
        x0, tid = x[..., 0], x[..., 1]
        return torch.where(tid < 0.5, line(x0, p), quad_term(x0, p))

    kw = dict(hyper=hyp, n_walkers=16, seed=0, dtype=torch.float64, device="cpu")
    new = th.HierarchicalFit([line, quad_term], data, {"a": 1.5, "b": 0.5},
                             data_error=[[0.2, 0.1]] * 3, **kw)
    old = th.HierarchicalFit(recipe, recipe_data, {"a": 1.5, "b": 0.5}, data_error=errs,
                             **kw)
    assert new.spec.keys == old.spec.keys
    for f in ("x", "y", "sigma", "mask"):
        assert torch.equal(getattr(new._stacked, f), getattr(old._stacked, f))
    vecs = np.random.default_rng(7).standard_normal((5, new.spec.ndim))
    vecs[:, 2:4] = np.abs(vecs[:, 2:4]) + 0.1
    v = torch.as_tensor(vecs)
    assert torch.equal(new._log_post(v), old._log_post(v))
    # and against the JAX first-class fit
    jhyp = {k: (jfit.Gaussian(d[0].mu, d[0].sigma), jfit.LogNormal(d[1].mu, d[1].sigma))
            for k, d in hyp.items()}
    j = jh.HierarchicalFit([line, quad_term], data, {"a": 1.5, "b": 0.5},
                           data_error=[[0.2, 0.1]] * 3, hyper=jhyp, n_walkers=16, seed=0)
    np.testing.assert_allclose(new._log_post(v).numpy(), j_posterior(j, vecs), rtol=RTOL)


def test_ambiguous_term_sigmas_are_refused():
    """Two terms of one point each, sigmas given as a list of two scalars:
    JAX reads per term (hierarchical.py:188); the port refuses the list,
    and takes the same sigmas as a numpy array, per point."""
    one = [[(np.array([1.0]), np.array([2.0])), (np.array([2.0]), np.array([3.0]))]] * 2
    err = [[0.1, 0.2], [0.1, 0.2]]
    _, _, jerr = jh._build_term_id_blocks([line, quad_term], one, err)
    np.testing.assert_array_equal(jerr[0], [0.1, 0.2])
    with pytest.raises(ValueError, match="per-term or per-point"):
        th._build_term_id_blocks([line, quad_term], one, err)
    _, _, terr = th._build_term_id_blocks([line, quad_term], one,
                                          [np.array([0.1, 0.2])] * 2)
    np.testing.assert_array_equal(terr[0], jerr[0])


# ------------------------------------------------ chains, draw for draw


@pytest.mark.parametrize("name,kind,chunk", [("diag_complete", "rwm", 200),
                                             ("full", "rwm", 200),
                                             ("diag_complete", "mala", 50)])
def test_chunks_match_jax_draw_for_draw(name, kind, chunk):
    W = 32
    j, t = build(name, W=W, seed=4)
    D = t.spec.ndim
    jcfg = jfit.FitConfig(kernel=kind, chunk_size=chunk)
    tcfg = tkernel.FitConfig(kernel=kind, chunk_size=chunk)
    j_run, _ = jkernel.build_chunk_runner(j._log_post_one, D, jcfg, takes_data=True)
    t_run, _ = tkernel.build_chunk_runner(t._log_post, D, tcfg)
    if kind == "mala":
        replay = gradient_draws("mala", tcfg, W, 1, chunk, ("even", W // 2), d=D)
        st = j.state
        # L from the walk-space seed, scaled for an informative mala step
        st = dataclasses.replace(st, l_matrix=0.3 * st.l_matrix)
    else:
        replay = rwm_draws(W, D, chunk)
        st = j.state
    t_state = carry(j, t).state
    t_state = dataclasses.replace(t_state, l_matrix=torch.as_tensor(
        np.array(st.l_matrix)))
    j_fn = jax.jit(j_run)
    key = st.key
    for i, cold in enumerate((False, True)):
        key, noise = replay(key)
        st, j_out = j_fn(st, True, True, cold, j._posterior_data())
        t_state, t_out = t_run(t_state, True, True, cold, noise=noise)
        for k, ja in state_arrays(st).items():
            np.testing.assert_allclose(getattr(t_state, k).numpy(), ja, rtol=1e-9,
                                       atol=0, err_msg=f"{name} {kind} chunk {i}: {k}")
        # the same accepted moves (the rate's mean rounds apart in its last bit)
        n_moves = W * chunk
        assert round(float(t_out["accept_rate"]) * n_moves) == \
            round(float(j_out["accept_rate"]) * n_moves)
        accepted = round(float(t_out["accept_rate"]) * n_moves)
        assert 50 < accepted < n_moves - 50, f"{kind}: uninformative, {accepted} accepted"


# ------------------------------------------- accessors and the verbs


@pytest.fixture(scope="module")
def fitted_pair():
    out = {}
    for name in ("diag_complete", "full"):
        j, t = build(name, W=32, seed=1)
        j.adaptive_steps(2400, auto=None)
        j.reset_to_most_likely()
        j.sampling_steps(1200, kernel="rwm")
        j.burn_steps(400)
        out[name] = (j, carry(j, t))
    return out


def same(a, b, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=1e-13, err_msg=msg)


@pytest.mark.parametrize("name", ["diag_complete", "full"])
def test_accessors_match_jax(fitted_pair, name):
    j, t = fitted_pair[name]
    for kind in ("best", "median"):
        for a, b in zip(t.params_per_dataset(kind), j.params_per_dataset(kind)):
            assert a.keys() == b.keys()
            same(list(a.values()), list(b.values()), msg=kind)
        ta, ja = t.hyper_params(kind), j.hyper_params(kind)
        assert ta.keys() == ja.keys()
        for part in ta:
            same(list(ta[part].values()), list(ja[part].values()), msg=part)
        same(t.population_covariance(kind), j.population_covariance(kind))
    same(t.population_covariance("draws"), j.population_covariance("draws"))
    expr = "(+ (* :a 2) :b)"
    same(t.expressions_per_dataset(expr), j.expressions_per_dataset(expr))
    pos = np.asarray(j.state.position)
    same(t.decode_params(pos), j.decode_params(pos))
    for s in range(t.n_datasets):
        same(t.dataset_view(s).steps()[0], j.dataset_view(s).steps()[0])
    with pytest.raises(IndexError):
        t.dataset_view(t.n_datasets)


@pytest.mark.parametrize("name", ["diag_complete", "full"])
def test_criticism_verbs_match_jax(fitted_pair, name):
    j, t = fitted_pair[name]
    kw = {"max_samples": 96}
    for tr, jr in zip(t.waic_per_dataset(**kw), j.waic_per_dataset(**kw)):
        same([tr.elpd, tr.p_waic, tr.se], [jr.elpd, jr.p_waic, jr.se], rtol=1e-8)
    for tr, jr in zip(t.loo_per_dataset(**kw), j.loo_per_dataset(**kw)):
        same(tr.pointwise, jr.pointwise, rtol=1e-8)
        same(tr.pareto_k, jr.pareto_k, rtol=1e-8)
    for tr, jr in zip(t.loo_pit_per_dataset(**kw), j.loo_pit_per_dataset(**kw)):
        same(tr.pit, jr.pit, rtol=1e-8)
        assert tr.ok == jr.ok
    for tr, jr in zip(t.audit_per_dataset(**kw), j.audit_per_dataset(**kw)):
        assert (tr.ok, tr.advice) == (jr.ok, jr.advice)
        assert tr.skipped.keys() == jr.skipped.keys() == {"prior_sensitivity"}
        assert tr.convergence["ok"] == jr.convergence["ok"]
    # the joint pointwise axis: every dataset's real points, dataset-major
    tl, jl = td.loo(t, **kw), jd.loo(j, **kw)
    assert tl.n_points == jl.n_points == 40
    same([tl.elpd, tl.se, tl.p_loo], [jl.elpd, jl.se, jl.p_loo], rtol=1e-8)
    same(tl.pareto_k, jl.pareto_k, rtol=1e-8)
    same(td.loo_pit(t, **kw).pit, jd.loo_pit(j, **kw).pit, rtol=1e-8)
    same(td.waic(t, **kw).elpd, jd.waic(j, **kw).elpd, rtol=1e-8)
    ps_t = td.prior_sensitivity(t, max_samples=96)
    ps_j = jd.prior_sensitivity(j, max_samples=96)
    same([ps_t.prior[k] for k in ps_j.prior], list(ps_j.prior.values()), rtol=1e-8)
    with pytest.raises(ValueError, match="flat stand-in prior"):
        td.prior_sensitivity(t.dataset_view(0))


def test_predictive_verbs_match_jax(fitted_pair, monkeypatch):
    j, t = fitted_pair["diag_complete"]
    for s in (0, 7):
        got, want = t.prior_predictive(n_samples=24, seed=s), j.prior_predictive(
            n_samples=24, seed=s)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            same(a.mu, b.mu, rtol=1e-12)
            same(a.x, b.x, rtol=0)
    # the replicates of each dataset, JAX's stream injected dataset by dataset
    widths = iter(int(j._datasets[s].x.shape[0]) for s in range(4))
    keys = iter(jax.random.PRNGKey(3 + s) for s in range(4))

    def normal(generator, shape, dtype, device):
        k = next(keys)
        k, sub = jax.random.split(k)
        draw = jax.random.normal(sub, (shape[0], next(widths)), jnp.float64)
        return torch.as_tensor(np.array(draw)[:, :shape[1]], dtype=dtype)

    monkeypatch.setattr(tpred, "_normal", normal)
    got, want = t.prior_predictive(n_samples=24, seed=3), j.prior_predictive(
        n_samples=24, seed=3)
    for a, b in zip(got, want):
        same(a.y_rep, b.y_rep, rtol=1e-12)
    xg = np.linspace(-0.5, 1.5, 7)
    for kw in ({}, {"noise": 0.2, "seed": 4}, {"population_mean": True, "max_samples": 9}):
        a, b = t.predict_new(xg, **kw), j.predict_new(xg, **kw)
        same(a.mu, b.mu, rtol=1e-12)
        if "noise" in kw:
            same(a.y_rep, b.y_rep, rtol=1e-12)
    jf, tf = fitted_pair["full"]
    same(tf.predict_new(xg, seed=2).mu, jf.predict_new(xg, seed=2).mu, rtol=1e-12)
    jp, tp = build("partial_prior")
    for fit in (jp, tp):
        with pytest.raises(ValueError, match="incomplete"):
            fit.prior_predictive()
        with pytest.raises(ValueError, match="no population to draw from"):
            fit.predict_new(xg)
    same(tp.predict_new(xg, fixed={"k": 0.0}, seed=1).mu,
         jp.predict_new(xg, fixed={"k": 0.0}, seed=1).mu, rtol=1e-12)


# ------------------------------------------- an estimator on the fit


def test_laplace_on_a_conjugate_hierarchy_matches_jax():
    """y_si ~ N(theta_s, 0.4^2), theta_s ~ N(mu, tau^2), mu ~ N(1, 2^2),
    tau near-pinned: ``laplace_approx`` resolves the fit's complete
    ``prior_spec`` in both packages."""
    rng = np.random.default_rng(7)
    x = np.linspace(0.0, 1.0, 8)
    data = [(x, m + 0.4 * rng.standard_normal(8)) for m in (0.2, 1.1, 2.4, -0.6)]

    def make(M, mod, **kw):
        return mod.HierarchicalFit(
            const_model, data, {"c": 0.5}, data_error=0.4,
            hyper={"c": (M.Gaussian(1.0, 2.0), M.LogNormal(np.log(0.8), 0.01))},
            n_walkers=32, seed=0, **kw)

    j = make(jfit, jh)
    t = make(tfit, th, dtype=torch.float64, device="cpu")
    j.adaptive_steps(3000, auto=None)
    carry(j, t)
    assert tfit.resolve_prior_spec(t) is t.prior_spec
    jr, tr = j.laplace_approx(), t.laplace_approx()
    assert tr.lp_map == pytest.approx(jr.lp_map, rel=1e-8)
    np.testing.assert_allclose(tr.cov, jr.cov, rtol=1e-8, atol=1e-14)
    assert tr.log_z == pytest.approx(jr.log_z, rel=1e-8)
