"""The port's examples (examples_torch/) against the JAX package's (examples/):
the device knob, the test.lisp journey and the five BASELINE configurations.

- ``_common.setup_device``: CUDA unless ``LISP_MCMC_PLATFORM=cpu``; it
  raises without a GPU and on any other value, and so does every
  example's ``main`` before it does anything.
- The journey's data file (``write_journey_data``) holds
  ``synthetic.global_fit(2)`` in the columns test.lisp reads, bit for
  bit through both packages' readers; ``find_data`` raises without a file
  in both.  On that file the JAX ``ingest_and_fit`` and the port's build
  the same data, and the port's single-dataset and global posteriors
  equal JAX's at the JAX walkers' positions (float64, 1e-10); the JAX
  global fit (its ``lorder_mixed_bg2`` a closure) is captured from its
  ``main``, the port's is ``models.renamed`` and inside kernel 1's
  coverage.  The derived quantities of a carried JAX walker match at
  1e-10; the phase functions run at a tiny budget, figures into tmp_path.
- BASELINE: the data the JAX ``main`` passes to its five fits (captured:
  its constructors recorded, its verbs doing nothing), with and without
  its data file, equal ``make_data``'s; each fit's posterior equals JAX's
  at the JAX fit's positions; configs 1-4 lie inside kernel 1's coverage;
  ``main`` at a tiny budget.
"""

import os
import sys

import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch.ops.loglik_kernel import kernel_coverage
from lisp_mcmc_tpu import nv as jnv

from torch_examples_util import (Capture, Fake, FakeWalker, Stop, carried, jax_example,
                                 port_example, same, same_data, same_posterior)

tcommon = port_example("_common")
trj = port_example("reference_journey")
tbc = port_example("baseline_configs")
W = 16
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def journey_file(tmp_path_factory):
    return trj.write_journey_data(str(tmp_path_factory.mktemp("journey") / "example-data.xls"))


# ------------------------------------------------------------ the knob


def test_setup_device_runs_on_the_gpu_unless_told(monkeypatch):
    monkeypatch.delenv("LISP_MCMC_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcommon.setup_device()
    for main in (trj.main, tbc.main, port_example("modern_workflow").main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()
    monkeypatch.setenv("LISP_MCMC_PLATFORM", "cpu")
    assert tcommon.setup_device() == torch.device("cpu")


@pytest.mark.parametrize("value", ["tpu", "gpu", "CPU", "cuda:0"])
def test_setup_device_refuses_other_values(monkeypatch, value):
    monkeypatch.setenv("LISP_MCMC_PLATFORM", value)
    with pytest.raises(ValueError, match="LISP_MCMC_PLATFORM"):
        tcommon.setup_device()


# ------------------------------------------------------------ the journey


def test_journey_file_holds_the_global_fit(journey_file):
    g = tfit.synthetic.global_fit(n_datasets=2)
    for read in (jfit.read_file_data, tfit.read_file_data):
        table = read(journey_file)
        assert len(table) == 9 and len(table[1]) == 334
        for col, (x, y) in zip((4, 5), g["data"]):
            xs, ys = (np.asarray(c) for c in jfit.create_walker_data(table, 1, col))
            np.testing.assert_array_equal(xs, x)
            np.testing.assert_array_equal(ys, y)


def test_find_data_raises_without_a_file(monkeypatch):
    jrj = jax_example("reference_journey")
    monkeypatch.setattr(sys, "argv", ["reference_journey.py"])
    monkeypatch.setattr(os.path, "isdir", lambda p: False)
    for mod in (jrj, trj):
        with pytest.raises(SystemExit, match="no example data"):
            mod.find_data()


@pytest.fixture(scope="module")
def journey_pair(journey_file):
    jrj = jax_example("reference_journey")
    jt, jx, jy, jw = jrj.ingest_and_fit(n_steps=200, n_walkers=W, path=journey_file)
    tt, tx, ty, tw = trj.ingest_and_fit(n_steps=200, n_walkers=W, path=journey_file,
                                        device="cpu", dtype=F64)
    return jrj, (jt, jx, jy, jw), (tt, tx, ty, tw)


def test_journey_single_fit_matches_jax(journey_pair):
    _, (jt, jx, jy, jw), (tt, tx, ty, tw) = journey_pair
    np.testing.assert_array_equal(tx, np.asarray(jx))
    np.testing.assert_array_equal(ty, np.asarray(jy))
    assert len(tt) == len(jt)
    same_posterior(tw, jw, "journey single fit")
    assert kernel_coverage(tw.terms, tw.spec) is None
    assert np.isfinite(tw.most_likely_step()[0])


def test_journey_global_fit_matches_jax(journey_pair, monkeypatch, tmp_path):
    jrj, (jt, jx, jy, _), (tt, tx, ty, _) = journey_pair
    grab = Capture(stop_at=1)
    monkeypatch.setattr(jrj, "ingest_and_fit",
                        lambda n_steps, n_walkers: (jt, jx, jy, FakeWalker()))
    monkeypatch.setattr(jrj, "plotting", Fake())
    monkeypatch.setattr(jrj, "walker_save", lambda *a: None)
    monkeypatch.setattr(jrj, "walker_load", lambda *a: FakeWalker())
    monkeypatch.setattr(jrj.tempfile, "mkdtemp", lambda prefix: str(tmp_path))
    monkeypatch.setattr(jfit, "walker_with_expression", lambda *a: 0.0)
    monkeypatch.setattr(jfit, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jfit, "mcmc_fit", grab)
    with pytest.raises(Stop):
        jrj.main(n_steps=200, n_walkers=W)
    kw = grab.calls[0][1]
    assert kw["params"] == trj.GLOBAL_START and kw["data_error"] == [1e-7, 1e-7]
    x2, y2 = tfit.create_walker_data(tt, 1, 5)
    for (jx_, jy_), (tx_, ty_) in zip(kw["data"], [(tx, ty), (x2, y2)]):
        np.testing.assert_array_equal(tx_, np.asarray(jx_))
        np.testing.assert_array_equal(ty_, np.asarray(jy_))
    jw = jfit.walker_create(function=kw["function"], data=kw["data"], params=kw["params"],
                            data_error=kw["data_error"], n_walkers=W, seed=0,
                            walker_jitter=0.05)
    tw = trj.global_fit(tt, tx, ty, n_steps=200, n_walkers=W, optimize_rounds=1,
                        device="cpu", dtype=F64)
    assert kernel_coverage(tw.terms, tw.spec) is None      # lorder_mixed_bg2 is declared
    same_posterior(tw, jw, "journey global fit")
    assert np.isfinite(tw.most_likely_step()[0])


def test_journey_phases_at_a_tiny_budget(journey_pair, tmp_path):
    *_, (tt, tx, ty, tw) = journey_pair
    q = trj.plots_and_expression(tw, figures=str(tmp_path))
    assert np.isfinite(q)
    for f in ("fit.png", "residuals.png", "traces.png", "trace_lp.png", "corner.png"):
        assert (tmp_path / f).stat().st_size > 0
    reloaded = trj.save_load_round_trip(tw, 200, str(tmp_path), device="cpu")
    assert reloaded.age == tw.age + 200 and np.isfinite(reloaded.most_likely_step()[0])


def test_journey_main_draws_no_figure_unless_asked(journey_file, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = trj.main(n_steps=200, n_walkers=W, path=journey_file, device="cpu",
                   optimize_rounds=1)
    assert set(out) == {"single", "reloaded", "global", "q_factor"}
    assert list(tmp_path.iterdir()) == []


def test_journey_derived_quantities_of_a_carried_walker(journey_pair):
    _, (jt, jx, jy, jw), _ = journey_pair
    tw = carried(jw, function=trj.lorder_mixed_bg, data=(np.asarray(jx), np.asarray(jy)),
                 params=trj.SINGLE_START, data_error=1e-7)
    same(tfit.walker_with_expression(tw, "(/ :linewidth :x0)"),
         jfit.walker_with_expression(jw, "(/ :linewidth :x0)"))
    same(tfit.expression_credible_interval(tw, "(/ :linewidth :x0)"),
         jfit.expression_credible_interval(jw, "(/ :linewidth :x0)"))


# ------------------------------------------------------------ BASELINE


def _jax_baseline(monkeypatch, data_file=None):
    """The five fits JAX's baseline_configs.main builds: (walker_create
    calls, BatchedNVFit calls); with ``data_file``, its data file exists
    and reads as that file."""
    jbc = jax_example("baseline_configs")
    walkers, nv_fits = Capture(), Capture()
    monkeypatch.setattr(jfit, "walker_create", walkers)
    monkeypatch.setattr(jnv, "BatchedNVFit",
                        lambda spectra, **kw: nv_fits(spectra, **kw))
    monkeypatch.setattr(jfit, "enable_compilation_cache", lambda: None)
    real_exists, real_read = os.path.exists, jfit.read_file_data
    monkeypatch.setattr(os.path, "exists", lambda p: (
        data_file is not None if str(p).endswith("example-data.xls") else real_exists(p)))
    monkeypatch.setattr(jfit, "read_file_data", lambda p: real_read(data_file))
    jbc.main()
    monkeypatch.undo()
    return [kw for _, kw in walkers.calls], nv_fits.calls


@pytest.mark.parametrize("with_file", [False, True])
def test_baseline_data_equal_jax(monkeypatch, journey_file, with_file):
    walkers, nv_fits = _jax_baseline(monkeypatch, journey_file if with_file else None)
    data = tbc.make_data(journey_file if with_file else None)
    assert len(walkers) == 4 and len(nv_fits) == 1
    for k, kw in zip((1, 2, 3), walkers):
        same_data(data[k][0], kw["data"][0], f"config {k} x")
        same_data(data[k][1], kw["data"][1], f"config {k} y")
    for (tx, ty), (jx, jy) in zip(data[4], walkers[3]["data"]):
        same_data(tx, jx, "config 4")
        same_data(ty, jy, "config 4")
    (spectra,), kw5 = nv_fits[0]
    assert kw5 == {"walkers_per_spectrum": 64, "seed": 4}
    for (tx, ty), (jx, jy) in zip(data[5], spectra):
        same_data(tx, jx, "config 5")
        same_data(ty, jy, "config 5")
    if with_file:
        g = tfit.synthetic.global_fit(n_datasets=2)
        np.testing.assert_array_equal(data[1][1], g["data"][0][1])


def test_baseline_posteriors_equal_jax(monkeypatch):
    walkers, nv_fits = _jax_baseline(monkeypatch)
    data = tbc.make_data(None)
    builders = (tbc.walker_1, tbc.walker_2, tbc.walker_3, tbc.walker_4)
    for k, (kw, build) in enumerate(zip(walkers, builders), start=1):
        jw = jfit.walker_create(**{**kw, "n_walkers": W})
        tw = build(data, W, "cpu", F64)
        assert kernel_coverage(tw.terms, tw.spec) is None, f"config {k}"
        same_posterior(tw, jw, f"config {k}")
    (spectra,), _ = nv_fits[0]
    jf = jnv.BatchedNVFit(spectra, walkers_per_spectrum=4, seed=4)
    tf = tbc.fit_5(data, 4, "cpu", F64)
    same_posterior(tf, jf, "config 5")


def test_baseline_main_at_a_tiny_budget(capsys):
    out = tbc.main(device="cpu", steps={k: 200 for k in tbc.STEPS})
    assert sorted(out) == [1, 2, 3, 4, 5]
    assert out[1].n_walkers == 256 and out[5].n_walkers == 4 * 64
    for k, w in out.items():
        assert w.age == 200 and np.isfinite(w.most_likely_step()[0]), k
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 6 and '"params_ok"' in lines[1] and '"field_offsets"' in lines[5]


def test_run_all_reads_the_phase_lines(tmp_path, monkeypatch):
    run_all = port_example("run_all")
    script = tmp_path / "fake_example.py"
    script.write_text("print('[    0.0s] << 1. fit done (1.5s)')\n"
                      "print('[    1.5s] << 2. check FAILED (0.2s)')\n")
    monkeypatch.setattr(run_all, "HERE", str(tmp_path))
    r = run_all.run("fake_example", str(tmp_path))
    assert r["rc"] == 0 and r["phases"] == [
        {"phase": "1. fit", "status": "done", "seconds": 1.5},
        {"phase": "2. check", "status": "FAILED", "seconds": 0.2}]
