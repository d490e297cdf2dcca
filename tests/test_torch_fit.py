"""The PyTorch port's main path as a whole, against the JAX package.

Both packages fit the synthetic flagship (the lorder_mixed_bg model on 334
points with sigma = 1e-7) with W = 256 walkers on the CPU in float64; the
port starts from the JAX walker's initial state, carried across with
``lisp_mcmc_torch.convert``.  Also: the port's device rule (the GPU by
default, never a quiet CPU fallback) and its independence from JAX.
"""

import ast
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
import lisp_mcmc_torch as tfit
from lisp_mcmc_torch.convert import walker_from_numpy
from lisp_mcmc_tpu.models import lorder_mixed_bg as j_lorder
from lisp_mcmc_torch.models import lorder_mixed_bg as t_lorder

ROOT = pathlib.Path(__file__).resolve().parent.parent

# The printed reference parameters (tests/test_flagship_regression.py) with
# scale x10: at the printed scale the whole resonance is worth 1.5
# log-units under sigma = 1e-7, so x0 is not identified; x10 makes it 155.
FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
START = {"scale": 1e-5, "linewidth": 7.0, "x0": 2200.0, "mix": 0.9,
         "bg0": 1e-7, "bg1": 1e-9}
# The smallest multiple of 200 (up to the 12000 of the flagship regression
# test) at which the JAX package meets the bounds below with seed 0:
# 5400 steps reach best lp 4898.6 (< lp_gen - 5), 5600 reach 4903.0.
# Measured on this CPU configuration: ~2 s for JAX, ~10 s for the port.
N_STEPS = 5600


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers, and
    torch's spinning thread pool would oversubscribe the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def flagship_data(seed=0):
    x = np.linspace(2000.0, 3600.0, 334)
    y = np.asarray(j_lorder(x, FLAGSHIP), np.float64)
    return x, y + 1e-7 * np.random.default_rng(seed).standard_normal(334)


def _jax_state_arrays(w):
    st = w.state
    out = {k: np.asarray(getattr(st, k)) for k in
           ("position", "logprob", "best_position", "best_logprob", "l_matrix",
            "m_sum", "m_outer", "m_count", "age", "anneal_step")}
    out["key"] = np.asarray(jax.random.key_data(st.key))
    return out


@pytest.fixture(scope="module")
def pair():
    x, y = flagship_data()
    kw = dict(function=j_lorder, data=(x, y), params=START, data_error=1e-7)
    jw = jfit.walker_create(n_walkers=256, seed=0, walker_jitter=0.05, **kw)
    tw = walker_from_numpy(_jax_state_arrays(jw), function=t_lorder,
                           data=(x, y), params=START, data_error=1e-7,
                           dtype=torch.float64, device="cpu")
    lp_gen = float(jfit.walker_create(
        function=j_lorder, data=(x, y), params=FLAGSHIP,
        data_error=1e-7).state.logprob[0])
    return jw, tw, lp_gen


def test_posteriors_agree_at_same_positions(pair):
    jw, tw, _ = pair
    rng = np.random.default_rng(5)
    pos = np.asarray(jw.state.position) * (1 + 0.01 * rng.standard_normal((256, 6)))
    j_lp = np.asarray(jw._eval_batch(jax.numpy.asarray(pos)))
    t_lp = tw._eval_batch(torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(t_lp, j_lp, rtol=1e-12,
                               err_msg="posterior at the same positions, rtol 1e-12")
    np.testing.assert_array_equal(tw.state.position.numpy(),
                                  np.asarray(jw.state.position))


def test_adaptive_fit_reaches_the_generating_peak(pair):
    jw, tw, lp_gen = pair
    t0 = time.perf_counter()
    jw.adaptive_steps(N_STEPS, temperature=10.0, auto=None)
    j_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    tw.adaptive_steps(N_STEPS, temperature=10.0, auto=None)
    t_secs = time.perf_counter() - t0
    for name, w in (("jax", jw), ("torch", tw)):
        lp, best = w.most_likely_step()
        assert lp >= lp_gen - 5.0, (
            f"{name}: best lp {lp:.3f} < lp(generating) {lp_gen:.3f} - 5 "
            f"after {N_STEPS} steps (jax {j_secs:.1f} s, torch {t_secs:.1f} s)")
        assert abs(best["x0"] - FLAGSHIP["x0"]) <= 0.01 * FLAGSHIP["x0"], (
            f"{name}: x0 {best['x0']:.2f} not within 1% of {FLAGSHIP['x0']:.2f}")
    acc = tw.acceptance()
    assert 0.2 <= acc <= 0.4, f"torch acceptance {acc:.3f} outside 0.2-0.4"
    pos, lp = tw._history()
    assert pos.shape[1:] == (256, 6) and lp.shape[1:] == (256,)
    ess = tfit.ess_from_history(pos, tw.spec.keys)
    assert all(np.isfinite(v) and v >= 1.0 for v in ess.values()), ess
    # the history verbs keep the thin invariant
    n_rows = pos.shape[0]
    tw.burn_steps(10 * tw._thin)
    assert tw._history()[0].shape[0] == n_rows - 10
    tw.keep_steps(5 * tw._thin)
    assert tw._history()[0].shape[0] == 5 and len(tw) == 5 * tw._thin
    assert tw.steps()[0].shape == (5 * 256, 6)
    tw.reset()
    assert len(tw) == 0 and tw.acceptance() == 0.0


def test_many_steps_and_mcmc_fit_on_cpu():
    x = np.linspace(0.0, 10.0, 50)
    y = 2.0 * x + 1.0
    w = tfit.mcmc_fit(function=tfit.models.line, data=(x, y),
                      params={"m": 2.0, "b": 1.0}, data_error=0.5,
                      n_steps=1000, n_walkers=64, seed=2, walker_jitter=0.1,
                      config=tfit.FitConfig(auto=None), device="cpu")
    assert w.age == 1000  # five chunks, the cold finish among them
    w.many_steps(400)
    assert len(w) > 0 and w.state.m_count.item() == 0.0


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.linspace(0.0, 1.0, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.walker_create(function=tfit.models.line, data=(x, x),
                           params={"m": 1.0, "b": 0.0})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.mcmc_fit(function=tfit.models.line, data=(x, x),
                      params={"m": 1.0, "b": 0.0}, n_steps=200)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [*(ROOT / "lisp_mcmc_torch").rglob("*.py"), ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "lisp_mcmc_tpu")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_loads_no_jax_in_a_fresh_process():
    code = ("import sys, lisp_mcmc_torch, lisp_mcmc_torch.fit, "
            "lisp_mcmc_torch.convert, lisp_mcmc_torch.ops.chunk_kernel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lisp_mcmc_tpu', 'triton')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
