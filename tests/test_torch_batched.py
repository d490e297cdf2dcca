"""Batched walker sets and per-walker aux of the PyTorch port against the
JAX package, chunk for chunk.

``lisp_mcmc_torch.BatchedFit`` against ``lisp_mcmc_tpu.BatchedFit`` on the
same S = 3 datasets (float64, the CPU): the JAX batch's state and its
padded datasets are carried into the port batch by
``convert.batched_from_numpy``, and each chunk draws what the JAX runner
draws from its key (the replays of ``test_torch_blocked``,
``test_torch_samplers`` and ``test_torch_gradient``); every state array
is compared after each chunk at rtol 1e-10.  The cases: the Gaussian
z-sum path, the stacked-dataset path under Student-t and Poisson
likelihoods, a ragged batch, a shared per-point error array; the samplers
on a batch (a whole-batch posterior: the red-black halves and the rescue
evaluate a full ensemble) and on a walker with per-walker aux and no
batched posterior (the halves and the rescue take their own walkers'
aux); the queries (per-block best points and reset, the dataset views'
history columns, the per-dataset convergence verdict, ``diagnose_params``
with ``aux_index``, ``optimize``, ``unit_cube_view``); the NV batch; and
the refusals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import nv as tnv
from lisp_mcmc_torch import synthetic
from lisp_mcmc_torch.convert import batched_from_numpy
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_tpu import nv as jnv
from lisp_mcmc_tpu.models import gaussian_peak as j_gp
from lisp_mcmc_torch.models import gaussian_peak as t_gp

from test_torch_blocked import rwm_draws
from test_torch_gradient import gradient_draws
from test_torch_samplers import ensemble_draws

RTOL = 1e-10
S, B, D = 3, 16, 4
W = S * B
STATE_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "l_matrix", "m_sum", "m_outer", "m_count")
DATASET_FIELDS = ("x", "y", "sigma", "mask", "inv_sigma", "log_norm_const",
                  "log_norm_const_point", "log_fact_y")
TRUTHS = [{"scale": 2.0, "x0": 0.3, "sigma": 1.0, "bg0": 0.4},
          {"scale": 1.0, "x0": -0.5, "sigma": 0.7, "bg0": 0.5},
          {"scale": 1.5, "x0": 0.0, "sigma": 1.3, "bg0": 0.3}]
GUESS = {"scale": 1.2, "x0": 0.1, "sigma": 1.0, "bg0": 0.4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def spectra(kind="normal", lens=(40, 40, 40), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for t, n in zip(TRUTHS, lens):
        x = np.linspace(-4.0, 4.0, n)
        mu = np.asarray(j_gp(x, t))
        y = (rng.poisson(20.0 * mu) / 20.0 if kind == "poisson"
             else mu + 0.05 * rng.standard_normal(n))
        out.append((x, y))
    return out


LIKELIHOODS = {
    "normal": (None, None),
    "student_t": (jfit.make_student_t_likelihood(4.0), tfit.make_student_t_likelihood(4.0)),
    "poisson": (jfit.log_likelihood_poisson, tfit.log_likelihood_poisson),
}


def arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}


def dataset_fields(jb):
    return [{**{k: np.asarray(getattr(d, k)) for k in DATASET_FIELDS}, "n": d.n}
            for d in jb._datasets]


def carry(jb, tb, state=None):
    """The JAX batch's state (or ``state``) and datasets into the port's."""
    st = state if state is not None else jb.state
    a = arrays(st)
    a["group_ids"], a["aux"] = np.asarray(jb.group_ids), np.asarray(jb.aux)
    a["age"], a["anneal_step"] = int(st.age), int(st.anneal_step)
    return batched_from_numpy(tb, a, dataset_fields(jb))


def pair(kind="normal", lens=(40, 40, 40), data_error=0.05, config=None, **kw):
    data = spectra(kind, lens)
    j_ll, t_ll = LIKELIHOODS[kind]
    cfg = config or {}
    jb = jfit.BatchedFit(j_gp, data, GUESS, data_error=data_error, log_likelihood=j_ll,
                         walkers_per_dataset=B, seed=1, walker_jitter=0.05,
                         config=jfit.FitConfig(**cfg), **kw)
    tb = tfit.BatchedFit(t_gp, data, GUESS, data_error=data_error, log_likelihood=t_ll,
                         walkers_per_dataset=B, seed=1, walker_jitter=0.05,
                         dtype=torch.float64, device="cpu",
                         config=tfit.FitConfig(**cfg), **kw)
    return jb, tb


def compare(j_state, t_state, what, rtol=RTOL):
    for k, ja in arrays(j_state).items():
        np.testing.assert_allclose(getattr(t_state, k).numpy(), ja, rtol=rtol, atol=0,
                                   err_msg=f"{what}: {k}")


def run_chunks(jb, tb, replay, chunks=(False, False, True), state=None):
    """Chunks of both batches' runners from the same state and draws."""
    j_run, t_run = jb._runner(with_history=False), tb._runner(with_history=False)
    j_state = state if state is not None else jb.state
    t_state = carry(jb, tb, j_state).state
    key = j_state.key
    for i, cold in enumerate(chunks):
        key, noise = replay(key)
        j_state, j_out = j_run(j_state, True, True, cold, jb._posterior_data())
        t_state, t_out = t_run(t_state, True, True, cold, noise=noise)
        compare(j_state, t_state, f"chunk {i}")
        np.testing.assert_allclose(t_out["group_accept"].numpy(),
                                   np.asarray(j_out["group_accept"]), rtol=RTOL)
    return j_state, t_state, t_out


# ------------------------------------------------------------ the posterior

CASES = [("normal", (40, 40, 40), 0.05), ("student_t", (40, 40, 40), 0.05),
         ("poisson", (40, 40, 40), None), ("ragged", (40, 31, 52), 0.05),
         ("shared_errors", (40, 40, 40), "per_point")]


@pytest.mark.parametrize("name,lens,err", CASES, ids=[c[0] for c in CASES])
def test_batched_rwm_chunks_match_jax(name, lens, err):
    kind = name if name in LIKELIHOODS else "normal"
    if err == "per_point":
        err = 0.04 + 0.02 * np.linspace(0.0, 1.0, lens[0])
    jb, tb = pair(kind, lens, err, config={"chunk_size": 50})
    assert tb._gaussian == (kind == "normal") and tb.n_datasets == S
    # the posterior of the JAX batch's start, both paths of the port
    pos = torch.as_tensor(np.array(jb.state.position))
    carry(jb, tb)
    np.testing.assert_allclose(tb._eval_batch(pos).numpy(), np.asarray(jb.state.logprob),
                               rtol=RTOL)
    data = tb._posterior_data()
    one = torch.stack([tb._custom_log_post(pos[w], torch.tensor(w // B), data)
                       for w in range(0, W, 5)])
    np.testing.assert_allclose(one.numpy(), np.asarray(jb.state.logprob)[::5], rtol=RTOL)
    _, t_state, t_out = run_chunks(jb, tb, rwm_draws(W, D, 50))
    # each dataset its own adaptation group
    assert t_out["group_accept"].shape == (S,)
    assert len(set(t_out["group_accept"].tolist())) > 1


def test_ragged_datasets_pad_exactly():
    """``Dataset.create(min_len=)`` pads with mask 0: the reductions of a
    padded dataset are the unpadded one's, and the JAX dataset's."""
    x, y = spectra(lens=(31, 31, 31))[0]
    short = tfit.Dataset.create(x, y, 0.05, device="cpu")
    padded = tfit.Dataset.create(x, y, 0.05, device="cpu", min_len=52)
    jd = jfit.Dataset.create(x, y, 0.05, min_len=52)
    assert padded.x.shape == (52,) and padded.n == short.n == 31
    assert float(padded.mask.sum()) == 31.0 and float(padded.x[-1]) == x[-1]
    for k in ("log_norm_const", "log_fact_y"):
        np.testing.assert_allclose(float(getattr(padded, k).sum()),
                                   float(getattr(short, k).sum()), rtol=1e-14)
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in TRUTHS[0].items()}
    for ll in (tfit.log_likelihood_normal, tfit.log_likelihood_poisson):
        assert float(ll(t_gp, p, padded)) == pytest.approx(float(ll(t_gp, p, short)),
                                                           rel=1e-14)
    np.testing.assert_allclose(float(padded.log_norm_const), float(jd.log_norm_const),
                               rtol=1e-14)


def test_normalize_errors():
    """One shared per-point array, per-dataset entries, and the refusals
    (the ambiguity of n == S points, a count or a length that is off)."""
    data = spectra(lens=(40, 40, 40))
    norm = tfit.BatchedFit._normalize_errors
    shared = np.linspace(0.01, 0.02, 40)
    for got in (norm(shared, data), norm([shared] * 3, data)):
        assert len(got) == 3 and all(np.array_equal(g, shared) for g in got)
    got = norm([0.1, 0.2, shared], data)
    assert got[0].shape == (40,) and got[1][0] == 0.2 and np.array_equal(got[2], shared)
    for bad, match in (([0.1, 0.2], "2 errors for 3"),
                       ([0.1, 0.2, np.ones(39)], "length 39 != 40")):
        with pytest.raises(ValueError, match=match):
            norm(bad, data)
    three = spectra(lens=(3, 3, 3))
    with pytest.raises(ValueError, match="ambiguous"):
        norm(np.ones(3), three)
    with pytest.raises(ValueError, match="ambiguous"):
        jfit.BatchedFit._normalize_errors(np.ones(3), three)


# ------------------------------------------------------------ the queries


@pytest.fixture(scope="module")
def annealed():
    """A JAX batch after a short anneal (each block near its optimum) and
    the port batch holding its state."""
    jb, tb = pair(config={"chunk_size": 50})
    jb.adaptive_steps(1000, auto=None)
    carry(jb, tb)
    return jb, tb


def test_per_dataset_queries_match_jax(annealed):
    jb, tb = annealed
    for s, (jp, tp) in enumerate(zip(jb.best_params_per_dataset(),
                                     tb.best_params_per_dataset())):
        for k in jp:
            assert tp[k] == pytest.approx(jp[k], rel=RTOL), (s, k)
        assert tp["x0"] == pytest.approx(TRUTHS[s]["x0"], abs=0.1)
    np.testing.assert_allclose(tb.best_logprob_per_dataset(), jb.best_logprob_per_dataset(),
                               rtol=RTOL)
    np.testing.assert_allclose(tb.expressions_per_dataset("(* :scale :sigma)"),
                               jb.expressions_per_dataset("(* :scale :sigma)"), rtol=RTOL)
    for s in range(S):
        p = jb.best_params_per_dataset()[s]
        assert tb.diagnose_params(p, aux_index=s * B) == pytest.approx(
            jb.diagnose_params(p, aux_index=s * B), rel=RTOL)
    # the dataset index reaches the posterior: another block's data differ
    assert tb.diagnose_params(p, aux_index=0) != pytest.approx(tb.diagnose_params(p, aux_index=2 * B))


def test_reset_to_most_likely_per_block(annealed):
    jb, _ = annealed
    _, tb = pair()
    carry(jb, tb)
    best = tb.best_params_per_dataset()
    tb.reset_to_most_likely()
    pos = tb.state.position.numpy().reshape(S, B, D)
    for s in range(S):
        np.testing.assert_array_equal(pos[s], np.broadcast_to(
            np.asarray([best[s][k] for k in tb.spec.keys]), (B, D)))
    np.testing.assert_array_equal(tb.state.logprob.numpy().reshape(S, B),
                                  np.repeat(tb.best_logprob_per_dataset(), B).reshape(S, B))
    assert len(tb._hist_positions) == 0


def test_dataset_view_history_columns(annealed):
    """Each view reads its own block: the live ensemble before any
    history (JAX tests/test_batched_fit.py:157), the whole ensemble, and
    the retained subsample when W is above ``history_walkers``."""
    jb, _ = annealed
    _, tb = pair()
    carry(jb, tb)
    pos0 = tb.state.position.numpy()
    for s in range(S):
        p, lp = tb.dataset_view(s)._history()
        np.testing.assert_array_equal(p[0], pos0[s * B:(s + 1) * B])
        assert tb.dataset_view(s).most_likely_params() == tb.best_params_per_dataset()[s]
    tb.adaptive_steps(200, auto=None)
    pos, _ = tb._history()
    steps, lps = tb.dataset_view(1).steps()
    np.testing.assert_array_equal(steps, pos[:, B:2 * B].reshape(-1, D))
    assert lps.shape == (pos.shape[0] * B,)
    with pytest.raises(IndexError):
        tb.dataset_view(S)
    # retained subsample: 12 evenly spaced walkers, 4 of each block
    tb.config = dataclasses.replace(tb.config, history_walkers=12)
    tb.reset()
    tb.adaptive_steps(200, auto=None)
    idx = tb._history_walker_idx().numpy()
    pos, _ = tb._history()
    for s in range(S):
        p, _ = tb.dataset_view(s)._history()
        np.testing.assert_array_equal(p, pos[:, idx // B == s])


def test_convergence_per_dataset_matches_jax(annealed):
    jb, tb = annealed
    jb2 = jfit.BatchedFit(j_gp, spectra(), GUESS, data_error=0.05, walkers_per_dataset=B)
    jb2.state = jb.state
    rng = np.random.default_rng(3)
    hist = rng.standard_normal((60, W, D)) * np.repeat([1.0, 2.0, 0.5], B)[None, :, None]
    hist[:, :B, 0] += np.linspace(0.0, 3.0, 60)[:, None]       # block 0 drifts
    lps = rng.standard_normal((60, W))
    jb2._hist_positions, jb2._hist_logprobs = [hist], [lps]
    tb._hist_positions, tb._hist_logprobs = [hist.copy()], [lps.copy()]
    jv, tv = jb2.convergence(), tb.convergence()
    assert tv["ok"] == jv["ok"] is False
    assert tv["failures"] == jv["failures"] and tv["failures"][0].startswith("dataset 0")
    assert len(tv["per_dataset"]) == S
    for key in ("tail_ess", "mcse"):
        for k in tb.spec.keys:
            assert tv[key][k] == pytest.approx(jv[key][k], rel=1e-9)
    for k in tb.spec.keys:
        np.testing.assert_allclose(tv["rank_rhat"][k], jv["rank_rhat"][k], rtol=1e-9)
    tb.reset()


def test_optimize_on_a_batch_matches_jax(annealed):
    jb0, _ = annealed
    jb, tb = pair()
    jb.state = jb0.state
    carry(jb, tb)
    jb.optimize(40)
    tb.optimize(40)
    compare(jb.state, tb.state, "optimize", rtol=1e-9)


def test_unit_cube_view_of_a_batch_matches_jax(annealed):
    jb, tb = annealed
    box = {"scale": (0.1, 4.0), "x0": (-3.0, 3.0), "sigma": (0.3, 3.0), "bg0": (-1.0, 1.0)}
    spec_j = jfit.PriorSpec({**box, "x0": jfit.Gaussian(0.0, 1.0)})
    spec_t = tfit.PriorSpec({**box, "x0": tfit.Gaussian(0.0, 1.0)})
    jv = jfit.unit_cube_view(jb, spec_j)
    tv = tfit.unit_cube_view(tb, spec_t)
    assert tv.aux is tb.aux and tv._whole_batch and tv.n_groups == S
    np.testing.assert_allclose(tv.state.position.numpy(), np.asarray(jv.state.position),
                               rtol=1e-12)
    np.testing.assert_allclose(tv.state.logprob.numpy(), np.asarray(jv.state.logprob),
                               rtol=1e-9)


# ------------------------------------------------------------ the samplers


def aux_walker_pair(jb, tb, config):
    """Walkers with per-walker aux (each walker's dataset index) and the
    batch's per-walker posterior, no batched one."""
    gids = np.asarray(jb.group_ids)
    jw = jfit.fit.Walker([], jb.spec, np.asarray(jb.state.position), seed=0,
                         config=jfit.FitConfig(**config), aux=jnp.asarray(gids),
                         group_ids=gids, n_groups=S, log_posterior=jb._custom_log_post,
                         posterior_data=jb._posterior_data())
    tw = tfit.Walker([], tb.spec, tb.state.position.numpy(), seed=0,
                     config=tfit.FitConfig(**config), dtype=torch.float64, device="cpu",
                     aux=torch.as_tensor(gids), group_ids=gids, n_groups=S,
                     log_posterior=tb._custom_log_post, posterior_data=tb._posterior_data())
    assert tw._rows_post is not None and not tw._whole_batch
    return jw, tw


ENSEMBLE_CHUNK = {"stretch": 30, "demc": 30, "slice": 10}


@pytest.mark.parametrize("layout", ["batch", "aux"])
@pytest.mark.parametrize("kind", ["stretch", "demc", "slice"])
def test_ensemble_samplers_on_aux_walkers_match_jax(annealed, kind, layout):
    jb0, tb0 = annealed
    chunk = ENSEMBLE_CHUNK[kind]
    cfg = {"kernel": kind, "chunk_size": chunk}
    jb, tb = pair(config=cfg)
    if layout == "aux":
        jb, tb = aux_walker_pair(jb0, tb0, cfg)
    else:
        assert tb._whole_batch and tb._rows_post is None
    j_run, t_run = jb._runner(with_history=False), tb._runner(with_history=False)
    j_state = jb0.state
    t_state = carry(jb0, tb0, j_state).state if layout == "batch" else tb0.state
    if layout == "batch":
        tb.state = t_state
    replay = ensemble_draws(kind, tb.config, S, B // 2, chunk)
    key = j_state.key
    for i, cold in enumerate((False, True)):
        key, noise = replay(key)
        j_state, j_out = j_run(j_state, True, True, cold, jb._posterior_data())
        t_state, t_out = t_run(t_state, True, True, cold, noise=noise)
        compare(j_state, t_state, f"{kind} {layout} chunk {i}")
        acc = float(t_out["accept_rate"])
        assert acc > (0.5 if kind == "slice" else 0.02), f"{kind}: acceptance {acc}"


@pytest.mark.parametrize("layout", ["batch", "aux"])
@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_gradient_samplers_with_the_rescue_on_aux_walkers_match_jax(annealed, kind, layout):
    jb0, tb0 = annealed
    chunk = {"mala": 20, "hmc": 10}[kind]
    cfg = {"kernel": kind, "chunk_size": chunk}
    jb, tb = pair(config=cfg)
    if layout == "aux":
        jb, tb = aux_walker_pair(jb0, tb0, cfg)
    assert tb.config.rescue
    j_run, t_run = jb._runner(with_history=False), tb._runner(with_history=False)
    j_state = jb0.state
    t_state = carry(jb0, tb0, j_state).state
    replay = gradient_draws(kind, tb.config, W, S, chunk, ("even", B // 2), d=D)
    key = j_state.key
    acc = []
    for i in range(3):
        key, noise = replay(key)
        j_state, j_out = j_run(j_state, True, True, True, jb._posterior_data())
        t_state, t_out = t_run(t_state, True, True, True, noise=noise)
        compare(j_state, t_state, f"{kind} {layout} chunk {i}", rtol=1e-9)
        assert t_out["posterior_evals"] == 2, "the rescue's two half-rounds"
        acc.append(float(t_out["accept_rate"]))
    assert max(acc) > 0.1, f"uninformative acceptance {acc}"


# ------------------------------------------------------------ refusals


def test_refusals_name_the_reason(annealed):
    _, tb = annealed
    with pytest.raises(ValueError, match="batched/grouped"):
        tb.tempered_steps(200, rungs=3)
    aux = torch.zeros(W, dtype=torch.int64)
    assert "aux" in tlk.kernel_coverage(tb.terms, tb.spec, aux)
    assert "aux" in tck.chunk_coverage(tb.terms, tb.spec, tb.config, 128, torch.float32,
                                       aux=aux)
    for impl in ("kernel", "chunk_kernel"):
        _, t2 = pair(config={"posterior_impl": impl})
        with pytest.raises(ValueError, match="per-walker aux data"):
            t2.adaptive_steps(200, auto=None)
    with pytest.raises(ValueError, match="custom log_posterior"):
        tfit.Walker([], tb.spec, np.ones(D), n_walkers=4, aux=torch.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="leading axis of 4"):
        tfit.Walker([], tb.spec, np.ones(D), n_walkers=4, aux=torch.zeros(3),
                    log_posterior=lambda t, a, d: t.sum(), device="cpu")
    with pytest.raises(ValueError, match="laplace_per_dataset"):
        tb.laplace_approx()


def test_convert_of_a_jax_batch(annealed):
    jb, _ = annealed
    _, tb = pair()
    carry(jb, tb)
    compare(jb.state, tb.state, "convert", rtol=0)
    assert tb._datasets[0].x.shape == jb._datasets[0].x.shape       # the JAX padding
    assert torch.equal(tb.aux, torch.as_tensor(np.asarray(jb.aux)))
    a = arrays(jb.state)
    with pytest.raises(ValueError, match="group_ids differ"):
        batched_from_numpy(tb, {**a, "group_ids": np.zeros(W, np.int64)})
    with pytest.raises(ValueError, match="aux is not"):
        batched_from_numpy(tb, {**a, "group_ids": np.asarray(jb.group_ids),
                                "aux": np.zeros(W)})


# ------------------------------------------------------------ the NV batch


def test_batched_nv_fit_matches_jax():
    x, ys = synthetic.nv_spectra()
    data = [(x, y) for y in ys]
    jb = jnv.BatchedNVFit(data, walkers_per_spectrum=16, seed=2)
    tb = tnv.BatchedNVFit(data, walkers_per_spectrum=16, seed=2, dtype=torch.float64,
                          device="cpu", config=tfit.FitConfig(chunk_size=50))
    jb.config = jfit.FitConfig(chunk_size=50)
    assert tb.n_spectra == jb.n_spectra == 3 and tb.walkers_per_spectrum == 16
    carry(jb, tb)
    np.testing.assert_allclose(tb._eval_batch(tb.state.position).numpy(),
                               np.asarray(jb.state.logprob), rtol=RTOL)
    # the constraints act per walker: mu1 > mu2 is refused in either batch
    pos = np.asarray(jb.state.position).copy()
    mu1, mu2 = tb.spec.index("mu1"), tb.spec.index("mu2")
    pos[::2, [mu1, mu2]] = pos[::2, [mu2, mu1]]
    np.testing.assert_allclose(tb._eval_batch(torch.as_tensor(pos)).numpy(),
                               np.asarray(jb._eval_batch(jnp.asarray(pos))), rtol=RTOL)
    j_state, t_state, _ = run_chunks(jb, tb, rwm_draws(48, 6, 50), chunks=(False, True))
    np.testing.assert_allclose(tb.field_offsets(), jb.field_offsets(), rtol=RTOL)
    for jp, tp in zip(jb.best_params_per_spectrum(), tb.best_params_per_spectrum()):
        for k in jp:
            assert tp[k] == pytest.approx(jp[k], rel=RTOL)
    with pytest.raises(ValueError, match="shared frequency grid"):
        tnv.BatchedNVFit([(x, ys[0]), (x[:-1], ys[1][:-1])], device="cpu")


def test_fit_nv_spectra_batched_is_the_batch_and_its_anneal():
    x, ys = synthetic.nv_spectra()
    data = [(x, y) for y in ys]
    kw = dict(walkers_per_spectrum=16, seed=4, dtype=torch.float64, device="cpu",
              config=tfit.FitConfig(chunk_size=50, auto=None))
    fit = tnv.fit_nv_spectra_batched(data, n_steps=400, **kw)
    ref = tnv.BatchedNVFit(data, **kw)
    ref.adaptive_steps(400)
    assert isinstance(fit, tnv.BatchedNVFit) and fit.age == 400
    for k in ("position", "logprob", "l_matrix"):
        assert torch.equal(getattr(fit.state, k), getattr(ref.state, k)), k
