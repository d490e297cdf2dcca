"""The port's roofline: the chain probe, the op census and the report.

- ``lisp_mcmc_torch.ops.microbench.chain_probe_plain`` (what the CUDA
  probe is held against on the card) against the JAX probe kernel's body
  (``benchmarks/roofline.py:72-85`` with the ops of ``:100-104``), rebuilt
  here with ``jax.numpy`` and ``lax.fori_loop`` on the CPU: float64,
  rtol 1e-12, because both sides apply the same IEEE operations in the
  same order and differ only where cos, exp and log round differently in
  the last bit.
- The op census of ``ops/loglik_kernel.py`` and ``ops/chunk_kernel.py``
  against hand counts, and against a count of the operations the plain
  models and the plain chunk stepper dispatch.
- ``opmix_bound_ms`` against DESIGN.md's worked example, and
  ``class_rates``.
- ``roofline.main(device="cpu")``: the whole report, rehearsed with the
  kernels' plain versions.

The CUDA probe itself is held against its plain version in
tests/test_torch_cuda.py (on a GPU).
"""

import collections
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import roofline
from lisp_mcmc_torch.models import line, lorder_mixed_bg
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_torch.ops import microbench as tmb

# The probe ops of benchmarks/roofline.py:100-104, and the port's add.
JAX_OPS = {
    "fma": lambda x: x * 1.0000001 + 1e-7,
    "div": lambda x: 1.0001 / (x + 1e-6),
    "cos": lambda x: jnp.cos(x),
    "exp": lambda x: jnp.exp(x * 1e-6),
    "log": lambda x: jnp.log(x + 1.0),
    "add": lambda x: x + 1e-6,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_probe(x, op, K, P=4, U=8):
    """The body of the JAX probe kernel (benchmarks/roofline.py:72-85)."""
    xs = [x + jnp.asarray(i * 1e-6, x.dtype) for i in range(P)]

    def body(_, xs):
        for _ in range(U):
            xs = [op(xi) for xi in xs]
        return tuple(xs)

    xs = jax.lax.fori_loop(0, K, body, tuple(xs))
    out = xs[0]
    for xi in xs[1:]:
        out = out + xi
    return out


@pytest.mark.parametrize("op", sorted(tmb.OPS))
def test_plain_probe_matches_jax_kernel_body(op):
    x = np.random.default_rng(3).uniform(0.5, 2.0, 8 * 128)
    want = np.asarray(_jax_probe(jnp.asarray(x), JAX_OPS[op], 3, U=tmb.UNROLL[op]))
    got = tmb.chain_probe_plain(torch.as_tensor(x), op, 3).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               err_msg=f"{op}: plain probe vs JAX body, rtol 1e-12")


def test_probe_wrapper_on_cpu_runs_the_plain_version():
    x = torch.linspace(0.5, 2.0, 300, dtype=torch.float32)
    before = tmb.chain_probe.launches
    got = tmb.chain_probe(x, "div", 2)
    assert tmb.chain_probe.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, tmb.chain_probe_plain(x, "div", 2), rtol=0, atol=0)
    # K = 0: the four chain starts, summed
    torch.testing.assert_close(tmb.chain_probe(x, "cos", 0),
                               4 * x + 6e-6, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="clock"):
        tmb.chain_probe(x, "fma", 1, clock=torch.zeros(2, dtype=torch.int64))


def test_plain_fma_rounds_once_in_float32():
    """The kernel's FFMA rounds x * a + b once; so does the plain version
    (checked against the exact value rounded to the nearest float32), where
    a float32 multiply and add round twice."""
    x = np.random.default_rng(5).uniform(0.5, 4.0, 2000).astype(np.float32)
    a32, b32 = np.float32(1.0000001), np.float32(1e-7)
    got = tmb._PLAIN_OPS["fma"](torch.from_numpy(x)).numpy()
    for xi, gi in zip(x, got):
        exact = Fraction(float(xi)) * Fraction(float(a32)) + Fraction(float(b32))
        near = np.float32(float(exact))
        cands = (np.nextafter(near, np.float32(0)), near,
                 np.nextafter(near, np.float32(8)))
        assert gi == min(cands, key=lambda c: abs(Fraction(float(c)) - exact))
    assert np.any(got != x * a32 + b32)


@pytest.mark.parametrize("x,op,K,match", [
    (torch.ones(8), "tan", 1, "unknown op"),
    (torch.ones(8), "fma", -1, "K must be"),
    (torch.ones(8), "fma", 1.5, "K must be"),
    (torch.ones(2, 4), "fma", 1, "1-D"),
    (torch.ones(8, dtype=torch.int32), "fma", 1, "no kernel"),
])
def test_probe_rejects_bad_input(x, op, K, match):
    with pytest.raises(ValueError, match=match):
        tmb.chain_probe(x, op, K)


def _zeros(**counts):
    return {**dict.fromkeys(tlk.OP_CLASSES, 0), **counts}


def test_fused_census_lorder_normal_hand_count():
    c = tlk.fused_census(0, "normal")
    # per point, models.cuh: u = x - x0, u*u, u2 + lw2, lw2 - u2, c2 * (.),
    # c1*u + (.) (FMA, 2), s*s, + bg0, bg1*x + (.) (FMA, 2) = 11 flops and
    # num / (s*s); the normal reduction (y - mu) * is, acc + z*z (FMA) = 4
    assert c["per_point"] == _zeros(flops=15, div=1)
    # per walker: setup lw*lw, 3 multiplies for c1, 2 for c2, cos and sin;
    # -0.5 * acc; total + prior
    assert c["per_walker"] == _zeros(flops=8, cos=2)
    assert c["per_step"] == _zeros()


def test_fused_census_other_kinds_models_and_bounds():
    assert tlk.fused_census(0, "normal_cutoff")["per_point"] == _zeros(flops=18, div=1)
    assert tlk.fused_census(0, "poisson")["per_point"] == _zeros(flops=15, div=1, log=1)
    assert tlk.fused_census(1, "normal")["per_point"] == _zeros(flops=6)
    flat = tlk.fused_census(0, "normal")["per_walker"]
    three = tlk.fused_census(0, "normal", n_bounded=3)["per_walker"]
    assert three == {**flat, "flops": flat["flops"] + 18, "exp": 3}


class _OpCount(TorchDispatchMode):
    """Floating-point output elements of each dispatched op, by census
    class (integer hashing is not counted)."""

    CLASSES = {"add": "flops", "sub": "flops", "rsub": "flops", "mul": "flops",
               "neg": "flops", "div": "div", "cos": "cos", "sin": "cos",
               "sqrt": "sqrt", "log": "log", "exp": "exp"}

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        cls = self.CLASSES.get(func.overloadpacket.__name__)
        if cls is not None and out.is_floating_point():
            self.n[cls] += out.numel()
        return out


def _count(model, names, W, N):
    x = torch.linspace(1.0, 2.0, N, dtype=torch.float64)
    p = {k: torch.full((W, 1), 0.5 + i, dtype=torch.float64)
         for i, k in enumerate(names)}
    with _OpCount() as mode:
        model(x, p)
    return mode.n


@pytest.mark.parametrize("model", [lorder_mixed_bg, line])
def test_model_census_matches_the_plain_models_operations(model):
    """The plain models compute the twins' factored form, one separate
    multiply or add per flop, so their dispatched elements per (walker,
    point) and per walker equal the twin's census."""
    from lisp_mcmc_torch.models.zoo import DEVICE_MODELS

    model_id, names = DEVICE_MODELS[model]
    c = tlk.fused_census(model_id, "normal")
    kind_point, kind_walker = tlk._KIND_CENSUS["normal"]
    W, n1, n2 = 3, 5, 9
    a, b = _count(model, names, W, n1), _count(model, names, W, n2)
    for cls in tlk.OP_CLASSES:
        per_point = (b[cls] - a[cls]) / (W * (n2 - n1))
        per_walker = a[cls] / W - n1 * per_point
        assert per_point == c["per_point"][cls] - kind_point.get(cls, 0), cls
        # the census's per-walker row also holds the finish and total + prior
        assert per_walker == (c["per_walker"][cls] - kind_walker.get(cls, 0)
                              - (cls == "flops")), cls


@pytest.mark.parametrize("d", [1, 2, 6, 8])
def test_chunk_census_scales_with_d(d):
    c = tck.chunk_census(0, "normal", d)
    assert c["per_point"] == tlk.fused_census(0, "normal")["per_point"]
    assert c["per_walker"] == tlk.fused_census(0, "normal")["per_walker"]
    totals = tlk.census_totals(c, 10, 334, steps=200)
    assert totals["sqrt"] == 200 * 10 * d
    assert totals["div"] == 200 * 10 * (334 + 1)
    # one more parameter adds a Box-Muller draw (a log, a cos, a square
    # root) and a row of L z and of the moments: flops grow with d^2
    more = tck.chunk_census(0, "normal", d + 1)["per_step"]
    assert {k: more[k] - c["per_step"][k] for k in ("log", "cos", "sqrt", "div")} \
        == {"log": 1, "cos": 1, "sqrt": 1, "div": 0}
    assert more["flops"] - c["per_step"]["flops"] == 4 * d + 11


def _chunk_walker(model):
    if model is line:
        x = np.linspace(0.0, 10.0, 50)
        kw = {"data": (x, 2.0 * x + 1.0), "params": {"m": 2.0, "b": 1.0},
              "data_error": 0.5}
    else:
        kw = {"data": roofline.synthetic_flagship(), "params": roofline.START,
              "data_error": 1e-7}
    return tfit.walker_create(function=model, n_walkers=256, seed=0,
                              walker_jitter=0.05, device="cpu", **kw)


@pytest.mark.parametrize("model", [line, lorder_mixed_bg])
def test_chunk_census_matches_the_plain_chunks_operations(model):
    """The chunk kernel's per-walker-step census against the operations the
    plain chunk stepper dispatches per walker and step (a mixed difference
    over two walker counts and two chunk lengths, less its posterior).
    Where the two differ by design the test names it: the kernel takes the
    temperature per walker (2 flops, 1 cos) where the plain version takes
    it once on the host; the kernel warp-sums the trace (5 adds) where the
    plain version's ``sum`` is no add; the kernel adds the lower triangle of
    the accepted-move outer product (d(d+1)/2 FMAs, d^2 + d flops) where
    the plain version multiplies and adds all of it (2 d^2)."""
    w = _chunk_walker(model)
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 256, torch.float32)
    d, st = ck.d, w.state
    L = 0.01 * torch.eye(d)

    def ops(fn):
        with _OpCount() as mode:
            fn()
        return mode.n

    def chunk_ops(W, steps):
        run = dataclasses.replace(ck, chunk=steps)
        return ops(lambda: tck.chunk_rwm_plain(
            run, st.position[:W], st.logprob[:W], st.best_position[:W],
            st.best_logprob[:W], L, 0, 0.0, 7))

    def post_ops(W):
        return ops(lambda: tlk.posterior_raw_plain(st.position[:W], ck.term))

    c = {(W, n): chunk_ops(W, n) for W in (128, 256) for n in (1, 3)}
    p = {W: post_ops(W) for W in (128, 256)}
    want = tck.chunk_census(ck.term.model_id, ck.term.kind, d)["per_step"]
    by_design = {"flops": 2 + 5 - (d * d - d), "cos": 1}
    for cls in tlk.OP_CLASSES:
        step = (c[256, 3][cls] - c[128, 3][cls] - c[256, 1][cls] + c[128, 1][cls]) / (128 * 2)
        post = (p[256][cls] - p[128][cls]) / 128
        assert step - post + by_design.get(cls, 0) == want[cls], cls


def test_probe_census_counts_one_application():
    n, apps = 1000, 4 * 32 * 4
    assert tlk.census_totals(tmb.probe_census("fma"), n, apps) == _zeros(flops=2 * n * apps)
    assert tlk.census_totals(tmb.probe_census("div"), n, apps) \
        == _zeros(flops=n * apps, div=n * apps)
    assert roofline.peak_bound(tmb.probe_census("fma"), n, apps, 1, 8 * n, torch.float32) \
        == {"bound_ms": pytest.approx(1e3 * 2 * n * apps / 67e12), "bound_by": "operations"}


def test_opmix_bound_reproduces_design_example():
    """DESIGN.md:147-153: 2.137e11 flops of which 1.0e10 reciprocals per
    chunk, at 3.01e12 flop/s and 3.31e11 reciprocals/s.  The formula on
    those rounded inputs gives 67.67 + 30.21 = 97.89 ms; DESIGN.md prints
    67.9 + 30.3 = 98.2 ms, from its unrounded counts (0.3 % apart)."""
    census = tlk.op_census(per_point={"flops": 2.137e11 - 1.0e10, "div": 1.0e10})
    ms = tlk.opmix_bound_ms(census, 1, 1, 1, {"flops": 3.01e12, "div": 3.31e11})
    assert ms == pytest.approx(2.037e11 / 3.01e12 * 1e3 + 1.0e10 / 3.31e11 * 1e3,
                               rel=1e-12)
    assert ms == pytest.approx(98.2, rel=5e-3)


def test_opmix_bound_takes_every_class_at_its_rate():
    census = tlk.op_census(per_point=_zeros(flops=4, div=1, sqrt=1, log=1, exp=1, cos=1),
                           per_walker={"flops": 2}, per_step={"cos": 1})
    rates = {"flops": 1e3, "div": 1e2, "sqrt": 25.0, "log": 10.0, "exp": 20.0,
             "cos": 50.0}
    W, N, steps = 2, 3, 5
    want = steps * W * ((N * 4 + 2) / 1e3 + N / 1e2 + N / 25.0 + N / 10.0
                        + N / 20.0 + (N + 1) / 50.0)
    assert tlk.opmix_bound_ms(census, W, N, steps, rates) == pytest.approx(1e3 * want)


def test_class_rates_take_the_add_out_of_div_exp_and_log():
    ceilings = {"fma_flops_per_sec": 60.0, "add_per_sec": 20.0, "div_per_sec": 4.0,
                "cos_per_sec": 2.0, "exp_per_sec": 10.0, "log_per_sec": 5.0,
                "hbm_bytes_per_sec": 1.0}
    r = tlk.class_rates(ceilings)
    assert r == pytest.approx({"flops": 60.0, "div": 1 / (1 / 4 - 1 / 20),
                               "sqrt": 1 / (1 / 4 - 1 / 20), "cos": 2.0,
                               "exp": 1 / (1 / 10 - 1 / 20), "log": 1 / (1 / 5 - 1 / 20)})
    with pytest.raises(ValueError, match="add probe"):
        tlk.class_rates({**ceilings, "exp_per_sec": 20.0})
    assert tlk.class_rates(ceilings, take_out_add=False) == {
        "flops": 60.0, "div": 4.0, "sqrt": 4.0, "cos": 2.0, "exp": 10.0, "log": 5.0}


def test_peak_bound_counts_every_operation_and_picks_the_larger():
    census = tlk.fused_census(0, "normal")
    W, N = 131072, 334
    ops = sum(tlk.census_totals(census, W, N).values())
    b = roofline.peak_bound(census, W, N, 1, 1000, torch.float32)
    assert b == {"bound_ms": pytest.approx(1e3 * ops / 67e12), "bound_by": "operations"}
    assert roofline.peak_bound(census, W, N, 1, 1000, torch.float64)["bound_ms"] \
        == pytest.approx(1e3 * ops / 34e12)
    assert roofline.peak_bound(census, W, N, 1, 10 ** 12, torch.float32) \
        == {"bound_ms": pytest.approx(1e3 / 3.35), "bound_by": "bytes"}


CEILING_KEYS = {"fma_flops_per_sec", "div_per_sec", "cos_per_sec", "exp_per_sec",
                "log_per_sec", "add_per_sec", "hbm_bytes_per_sec"}


def _check_report(report, walkers):
    assert report["device"] == "cpu" and report["card"] is None
    assert report["walkers"] == walkers and report["points"] == roofline.N_POINTS
    assert CEILING_KEYS <= set(report["ceilings"])
    assert all(report["ceilings"][k] > 0 for k in CEILING_KEYS)
    assert set(report["ceilings"]["probes"]) == set(tmb.OPS)
    for op, p in report["ceilings"]["probes"].items():
        assert 1 <= p["k1"] < p["k2"] and "sm_mhz" not in p, op
    # on the CPU the raw probe rates, nothing taken out
    assert report["class_rates"] == tlk.class_rates(report["ceilings"], take_out_add=False)
    for key in ("chunk_seconds", "steps_per_sec", "chunk_kernel_chunk_seconds",
                "chunk_kernel_steps_per_sec", "likelihood_eval_seconds",
                "likelihood_share_of_step", "census_flops_per_step",
                "census_flops_per_chunk", "census_bytes_per_chunk",
                "achieved_flops_per_sec", "pct_of_fma_ceiling"):
        assert np.isfinite(report[key]) and report[key] > 0, key
    assert report["census_flops_per_chunk"] == 200 * report["census_flops_per_step"]
    assert report["census_per_walker_step"]["flops"] == 334 * 15 + 8 + 136
    assert set(report["kernels"]) == {"fused_posterior", "chunk_rwm"}
    for row in report["kernels"].values():
        assert row["opmix_bound_ms"] > row["peak_bound_ms"] > 0
        assert row["opmix_share"] == pytest.approx(row["opmix_bound_ms"] / row["ms"])


def test_roofline_main_rehearses_on_the_cpu():
    """W = 128, not 64: the chunk kernel's random stream needs a walker
    count with a 128-multiple block."""
    report = roofline.main(walkers=128, device="cpu")
    _check_report(report, 128)
    assert report["data"] == "synthetic flagship (seed 0)"
    assert report["dtype"] == "float32"


def test_roofline_main_reads_a_data_file(tmp_path):
    x, y = roofline.synthetic_flagship()
    rows = ["a\tb\tc\td\te"] + [f"0\t{xi:.17g}\t0\t0\t{yi:.17g}" for xi, yi in zip(x, y)]
    path = tmp_path / "spectrum.txt"
    path.write_text("\n".join(rows) + "\n")
    report = roofline.main(data=str(path), walkers=128, device="cpu")
    _check_report(report, 128)
    assert report["data"] == str(path)


def test_microbench_ceilings_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.microbench_ceilings(torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.main()
