"""Chain-axis sharding of the port (``lisp_mcmc_torch.parallel``) on
``torch.distributed``, against the unsharded port and the JAX package.

One module-scoped job starts two processes (``tests/torch_dist_worker.py``)
that form one gloo group on localhost; each runs every case sharded over
the group and unsharded in-process from one seed, and rank 0 writes a
JSON report that the parametrised tests below read.  The JAX package's
draws and single-device chunk (``lisp_mcmc_tpu.kernel``) are made here
and the sharded chunk on those draws is held against it.  The
single-process tests run a world of one in this process: the
``initialize_distributed`` policy first, before any group exists.
"""

import dataclasses
import json
import logging
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_tpu import kernel as jkernel
from lisp_mcmc_tpu.models import line as j_line
from lisp_mcmc_torch.kernel import build_chunk_runner
from lisp_mcmc_torch.models import line as t_line

JOB_TIMEOUT = 120.0
W_JAX = 64


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _line_xy():
    x = np.linspace(0.0, 10.0, 50)
    return x, 2.0 * x + 1.0


def _jax_chunk():
    """JAX's single-device rwm chunk on the line and the draws it made
    (the ``split(key, 3)`` stream of its kernel.py:770-791)."""
    x, y = _line_xy()
    jw = jfit.walker_create(function=j_line, data=(x, y), params={"m": 1.5, "b": 0.5},
                            data_error=0.1, n_walkers=W_JAX, seed=0, walker_jitter=0.05)
    j_run, _ = jkernel.build_chunk_runner(jw._log_post_one, jw.ndim, jw.config,
                                          takes_data=True)
    chunk, d = jw.config.chunk_size, jw.ndim

    def body(k, _):
        k, k_prop, k_accept = jax.random.split(k, 3)
        return k, (jax.random.normal(k_prop, (W_JAX, d), jnp.float64),
                   jax.random.uniform(k_accept, (W_JAX,), jnp.float64))

    _, (z, u) = lax.scan(body, jw.state.key, None, length=chunk)
    arrays = {k: np.asarray(getattr(jw.state, k)) for k in (
        "position", "logprob", "best_position", "best_logprob", "l_matrix", "m_sum",
        "m_outer", "m_count")}
    state, out = jax.jit(j_run)(jw.state, True, True, False, jw._posterior_data())
    return arrays, np.asarray(z), np.asarray(u), state, out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 2-process gloo job: its report and the JAX chunk it is held to."""
    outdir = tmp_path_factory.mktemp("torch_dist")
    arrays, z, u, j_state, j_out = _jax_chunk()
    np.savez(outdir / "jax_in.npz", z=z, u=u, **arrays)
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    logs = [open(outdir / f"worker{r}.log", "w+") for r in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", str(port), str(outdir)],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- worker {r} (rc {procs[r].returncode}) ---\n{f.read()[-3000:]}")
        f.close()
    if any(p.returncode != 0 for p in procs):
        pytest.fail("the 2-process job failed or passed its "
                    f"{JOB_TIMEOUT:.0f} s limit:\n" + "\n".join(text))
    with open(outdir / "result.json") as f:
        report = json.load(f)
    return {"report": report, "jax_state": j_state, "jax_out": j_out,
            "port": dict(np.load(outdir / "jax_rwm.npz"))}


BIT_FOR_BIT = ["rwm", "mala_rescue", "hmc", "chees", "stretch", "blocked_rwm",
               "blocked_mala"]


@pytest.mark.parametrize("case", BIT_FOR_BIT)
def test_sharded_chunk_matches_unsharded(job, case):
    """Two ranks step one chunk of the 64-walker line the unsharded run
    steps: every walker's position, logprob and best point bit for bit,
    the pooled fields (moments, L, ChEES state, the trace) to 1e-12."""
    r = job["report"]["cases"][case]
    for k in ("position", "logprob", "best_position", "best_logprob"):
        assert r[k + "_equal"], f"{case}: {k} differs by {r[k]}"
    for k in ("l_matrix", "m_sum", "m_outer", "m_count", "chees", "out_accept_rate",
              "out_logprob_max", "out_logprob_mean", "out_logprob_min", "out_group_accept"):
        assert r[k] <= 1e-12, f"{case}: {k} {r[k]}"
    assert r["age_equal"] and r["finite"]


@pytest.mark.parametrize("case", ["demc", "slice"])
def test_sharded_ensemble_statistical_contract(job, case):
    """demc and slice: the statistical contract of JAX
    tests/test_parallel.py:129-180 (under GSPMD they agree only
    statistically; the port's whole-ensemble chunk is also exact)."""
    r = job["report"]["cases"][case]
    assert r["finite"]
    assert abs(r["accept_got"] - r["accept_rate"]) <= 0.05
    np.testing.assert_allclose(r["mean_got"], r["mean_ref"], atol=0.05)
    np.testing.assert_allclose(r["std_got"], r["std_ref"], rtol=0.5)
    if case == "slice":
        assert r["accept_got"] > 0.9
    assert r["position_equal"] and r["logprob_equal"]


@pytest.mark.parametrize("case,expected", [
    ("rwm", lambda c: 1),                         # the chunk-end all-reduce
    ("blocked_rwm", lambda c: 1),                 # ... gathering the walkers too
    ("mala_rescue", lambda c: 3),                 # + one per rescue half-round
    ("blocked_mala", lambda c: 3),
    ("hmc", lambda c: 3),
    ("chees", lambda c: 3 + 2 * c),               # + two group sums a step
    ("stretch", lambda c: 1 + 2 * c),             # gather + one per half-step
    ("demc", lambda c: 1 + 2 * c),
])
def test_collectives_per_chunk(job, case, expected):
    r = job["report"]["cases"][case]
    assert r["collectives"] == expected(r["chunk"])


def test_sharded_adaptive_fit(job):
    """A full sharded fit converges (JAX tests/test_parallel.py:183-191);
    the state stays sharded and the history holds every walker."""
    r = job["report"]["cases"]["adaptive_fit"]
    assert r["m"] == pytest.approx(2.0, abs=0.05)
    assert r["b"] == pytest.approx(1.0, abs=0.2)
    assert r["local_walkers"] == 32 and r["history_walkers"] == 64
    assert 0.15 < r["acceptance"] < 0.5


def test_grouped_batched_nv_fit_shards(job):
    """Per-spectrum groups compose with sharding (JAX
    tests/test_parallel.py:207-230): each rank holds one spectrum."""
    r = job["report"]["cases"]["batched_nv"]
    assert r["local_walkers"] == 32
    offs = np.asarray(r["offsets"])
    assert np.isfinite(offs).all()
    assert offs[0] > offs[1]


@pytest.mark.parametrize("verb", ["tempered_steps", "walker_save", "advi", "smc_sample"])
def test_whole_ensemble_verbs_refuse_a_shard(job, verb):
    msg = job["report"]["refused"][verb]
    assert msg.startswith(verb) and "sharded over 2 processes" in msg


@pytest.mark.parametrize("field", ["position", "logprob", "best_position",
                                   "best_logprob", "l_matrix", "m_sum", "m_outer",
                                   "m_count", "accept_rate"])
def test_rwm_chunk_on_jax_draws_matches_jax(job, field):
    """The 2-rank chunk on JAX's own draws against JAX's single-device
    chunk from the same state, at 1e-12."""
    got = job["port"][field]
    want = np.asarray(job["jax_out"]["accept_rate"] if field == "accept_rate"
                      else getattr(job["jax_state"], field))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


# ------------------------------------------------- single-process world

def test_configured_coordinator_that_fails_raises():
    """A launch that names a coordinator and cannot reach it raises
    (JAX mesh.py:40-70); no group is left behind."""
    import torch.distributed as dist

    from lisp_mcmc_torch.parallel import initialize_distributed

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="refusing silent single-process fallback"):
        initialize_distributed(init_method=f"tcp://127.0.0.1:{_free_port()}", rank=1,
                               world_size=2, device="cpu", timeout=1)
    assert not dist.is_initialized()


def test_bare_launch_runs_single_process(caplog):
    from lisp_mcmc_torch.parallel import initialize_distributed

    with caplog.at_level(logging.INFO, logger="lisp_mcmc_torch.parallel.mesh"):
        assert initialize_distributed(device="cpu") == 1
    assert "running single-process" in caplog.text
    assert initialize_distributed(device="cpu") == 1      # idempotent


def _walker(n=64, seed=0):
    x, y = _line_xy()
    return tfit.walker_create(function=t_line, data=(x, y), params={"m": 1.5, "b": 0.5},
                              data_error=0.1, n_walkers=n, seed=seed, walker_jitter=0.05,
                              dtype=torch.float64, device="cpu")


def test_mesh_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    from lisp_mcmc_torch.parallel import CHAIN_AXIS, make_mesh, state_shardings

    mesh = make_mesh()
    assert mesh.mesh_dim_names == (CHAIN_AXIS,) and mesh.size() == 1
    sh = state_shardings(mesh)
    assert sh.position == (Shard(0),) and sh.best_logprob == (Shard(0),)
    assert sh.l_matrix == (Replicate(),) and sh.m_outer == (Replicate(),)


def test_make_mesh_refuses_too_many_devices():
    from lisp_mcmc_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        make_mesh(2)


def test_shard_requires_divisible_walkers():
    """JAX's message on a mesh that does not divide W; a fake two-rank
    communicator stands in for the mesh (the check needs no group)."""
    from lisp_mcmc_torch.parallel import ChainComm, make_mesh, shard_state

    comm = ChainComm.__new__(ChainComm)
    comm.rank, comm.size = 0, 2
    with pytest.raises(ValueError, match="n_walkers=63 must be divisible by mesh size 2"):
        shard_state(_walker(63).state, comm)
    assert shard_state(_walker(64).state, make_mesh()).position.shape == (64, 2)


@pytest.mark.parametrize("kernel", ["rwm", "mala", "chees", "stretch", "slice"])
def test_world_of_one_is_a_noop_bit_for_bit(kernel):
    """A one-rank mesh runs every collective site and changes nothing."""
    from lisp_mcmc_torch.parallel import make_mesh, shard_state

    w = _walker()
    w.adaptive_steps(400, auto=None, collect_history=False)
    cfg = dataclasses.replace(w.config, kernel=kernel, chunk_size=40)
    run, _ = build_chunk_runner(w._log_post, w.ndim, cfg)
    run_m, _ = build_chunk_runner(w._log_post, w.ndim, cfg, mesh=make_mesh())
    gradient = kernel in ("mala", "chees")
    s1, o1 = run(w.state, True, True, gradient, generator=torch.Generator().manual_seed(3))
    s2, o2 = run_m(shard_state(w.state, make_mesh()), True, True, gradient,
                   generator=torch.Generator().manual_seed(3))
    for f in ("position", "logprob", "best_position", "best_logprob", "l_matrix",
              "m_sum", "m_outer", "m_count", "chees"):
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    for k in ("accept_rate", "group_accept", "logprob_max", "logprob_mean", "logprob_min"):
        assert torch.equal(o1[k], o2[k]), k
    assert o2["collectives"] >= 1


def test_walker_shard_of_one_matches_the_walker():
    """``Walker.shard`` on a one-rank mesh: the adaptive fit, its history
    and the best-point verbs equal the unsharded walker's bit for bit;
    ``unit_cube_view`` shards its view."""
    from lisp_mcmc_torch.priors import PriorSpec, Uniform

    a, b = _walker(), _walker().shard()
    assert b.mesh is not None
    for w in (a, b):
        w.adaptive_steps(1200, auto=None)
    assert a.most_likely_step() == b.most_likely_step()
    for x, y in zip(a._history(), b._history()):
        np.testing.assert_array_equal(x, y)
    a.reset_to_most_likely()
    b.reset_to_most_likely()
    assert torch.equal(a.state.position, b.state.position)
    spec = PriorSpec({"m": Uniform(0.0, 4.0), "b": Uniform(-2.0, 4.0)})
    va, vb = tfit.unit_cube_view(a, spec), tfit.unit_cube_view(b, spec)
    assert vb.mesh is b.mesh and torch.equal(va.state.position, vb.state.position)
    with pytest.raises(ValueError, match="sharded already"):
        b.shard()
