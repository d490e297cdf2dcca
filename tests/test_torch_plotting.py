"""The port's plots (``lisp_mcmc_torch.plotting``) against the JAX package's.

Every public plotting function gets the same input in both packages --
the JAX fit's state and history carried into the port's twin
(``convert.walker_from_numpy``, ``batched_from_numpy``,
``hierarchical_from_numpy``), the same result objects, the same files --
and the returned figures' artists are compared at 1e-10: line data,
fill, collection and patch paths and offsets (bars, stairs, spans),
images, titles, labels, tick labels, legend and annotation texts, and
the axis limits.  ``ppc_plot`` draws JAX's replicates, injected through
``predictive._normal``.  Also: the envelope as arrays (and on CUDA in
tests/test_torch_cuda.py), the helpers (``_is_headless``,
``_subsample_walkers``, closing on Agg, ``show``), the nine ``Walker``
delegates, ``WalkerSet.plot_param``, the refusals, and the JAX plotting
tests' checks (tests/test_persistence_observability.py:208-250,
test_hierarchical.py:412-430, test_sbc.py:109, test_loo_pit.py:106,
test_prior_sensitivity.py:137, test_global_predictive.py:86,
test_round2_fixes.py:247-252).
"""

import os

import matplotlib
import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import diagnostics as td
from lisp_mcmc_torch import plotting as tplot
from lisp_mcmc_torch.models import line as t_line
from lisp_mcmc_tpu import diagnostics as jd
from lisp_mcmc_tpu import plotting as jplot
from lisp_mcmc_tpu.models import line as j_line

from test_torch_batched import carry as carry_batched
from test_torch_criticism import fitted, jax_stream, named_prior_specs
from test_torch_hierarchical import build as build_hier
from test_torch_hierarchical import carry as carry_hier

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _close_figures():
    import matplotlib.pyplot as plt

    yield
    plt.close("all")


# ----------------------------------------------------- figure contents


def _patch_xy(p):
    return p.get_patch_transform().transform(p.get_path().vertices)


def figure_data(fig) -> dict:
    """Everything a figure draws, as numbers and strings."""
    sup = fig._suptitle.get_text() if fig._suptitle is not None else ""
    out = {"suptitle": sup, "axes": []}
    for ax in fig.axes:
        legend = ax.get_legend()
        out["axes"].append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "xlim": np.asarray(ax.get_xlim()), "ylim": np.asarray(ax.get_ylim()),
            "yticks": np.asarray(ax.get_yticks()),
            "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
            "legend": [t.get_text() for t in legend.get_texts()] if legend else [],
            "texts": [(t.get_text(), np.asarray(getattr(t, "xy", t.get_position()), float))
                      for t in ax.texts],
            "lines": [np.asarray(ln.get_xydata(), float) for ln in ax.get_lines()],
            "collections": [([np.asarray(p.vertices, float) for p in c.get_paths()],
                             np.asarray(c.get_offsets(), float)) for c in ax.collections],
            "patches": [np.asarray(_patch_xy(p), float) for p in ax.patches],
            "images": [np.asarray(im.get_array(), float) for im in ax.get_images()],
        })
    return out


def assert_same(t, j, where="figure"):
    if isinstance(j, dict):
        assert set(t) == set(j), where
        for k in j:
            assert_same(t[k], j[k], f"{where}.{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), f"{where}: {len(t)} vs {len(j)}"
        for i, (a, b) in enumerate(zip(t, j)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(j, np.ndarray):
        np.testing.assert_allclose(np.ma.filled(t, np.nan), np.ma.filled(j, np.nan),
                                   rtol=RTOL, atol=1e-300, err_msg=where)
    else:
        assert t == j, f"{where}: {t!r} vs {j!r}"


def same_figure(tfig, jfig):
    td_, jd_ = figure_data(tfig), figure_data(jfig)
    assert any(a["lines"] or a["collections"] or a["patches"] or a["images"]
               for a in jd_["axes"]), "the JAX figure draws nothing"
    assert_same(td_, jd_)


# ------------------------------------------------------------- fits


@pytest.fixture(scope="module")
def line_pair():
    return fitted(steps=2000)


@pytest.fixture(scope="module")
def global_pair():
    return fitted("global", steps=1600)


@pytest.fixture(scope="module")
def batched_pair():
    rng = np.random.default_rng(2)
    x = np.linspace(0.0, 10.0, 40)
    data = [(x, (1.5 + 0.3 * s) * x + 0.5 * s + 0.3 * rng.standard_normal(40))
            for s in range(3)]
    common = dict(data_error=0.3, walkers_per_dataset=16, seed=0, walker_jitter=0.05)
    jb = jfit.BatchedFit(j_line, data, {"m": 1.5, "b": 0.0}, **common)
    tb = tfit.BatchedFit(t_line, data, {"m": 1.5, "b": 0.0}, dtype=torch.float64,
                         device="cpu", **common)
    jb.adaptive_steps(1200, auto=None)
    jb.burn_steps(600)
    carry_batched(jb, tb)
    pos, lp = jb._history()
    tb._hist_positions, tb._hist_logprobs = [np.array(pos)], [np.array(lp)]
    return jb, tb


@pytest.fixture(scope="module")
def hier_pair():
    j, t = build_hier("diag_complete", W=32, seed=1)
    j.adaptive_steps(1200, auto=None)
    j.burn_steps(400)
    return j, carry_hier(j, t)


# ------------------------------------------------------- walker plots

WALKER_PLOTS = {
    "plot_data_and_fit": lambda m, w: m.plot_data_and_fit(w),
    "plot_data_and_fit_take": lambda m, w: m.plot_data_and_fit(
        w, take=400, grid_points=57, envelope_fraction=0.3),
    "plot_residuals": lambda m, w: m.plot_residuals(w),
    "caterpillar_plots": lambda m, w: m.caterpillar_plots(w, filename=None),
    "caterpillar_one": lambda m, w: m.caterpillar_plots(w, take=500, walker_index=3,
                                                        filename=None),
    "likelihood_plot": lambda m, w: m.likelihood_plot(w),
    "autocorrelation_plot": lambda m, w: m.autocorrelation_plot(w),
    "autocorrelation_one": lambda m, w: m.autocorrelation_plot(w, name="b", max_lag=12),
    "corner_plot": lambda m, w: m.corner_plot(w, "m", "b"),
    "all_corner_plots": lambda m, w: m.all_corner_plots(w, filename=None),
    "param_histogram": lambda m, w: m.param_histogram(w, "m"),
    "param_histogram_bins": lambda m, w: m.param_histogram(w, ":b", take=600, bins=7),
}


@pytest.mark.parametrize("name", list(WALKER_PLOTS))
def test_walker_plots_match_jax(line_pair, name):
    jw, tw = line_pair
    same_figure(WALKER_PLOTS[name](tplot, tw), WALKER_PLOTS[name](jplot, jw))


@pytest.mark.parametrize("term", [0, 1])
def test_global_fit_plots_match_jax(global_pair, term):
    jw, tw = global_pair
    same_figure(tplot.plot_data_and_fit(tw, term_index=term),
                jplot.plot_data_and_fit(jw, term_index=term))
    same_figure(tplot.plot_residuals(tw, term_index=term),
                jplot.plot_residuals(jw, term_index=term))


@pytest.mark.parametrize("take", [1000, None])
def test_fit_envelope_matches_jax(line_pair, take):
    jw, tw = line_pair
    got = tplot._fit_envelope(tw, 0, take, 200, 0.66)
    want = jplot._fit_envelope(jw, 0, take, 200, 0.66)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w_), rtol=RTOL, atol=1e-300)
    grid, y_best, y_lo, y_hi = got
    assert (y_lo <= y_best + 1e-9).all() and (y_best <= y_hi + 1e-9).all()


@pytest.mark.parametrize("term_index", [0, None])
def test_ppc_plot_matches_jax(global_pair, monkeypatch, term_index):
    jw, tw = global_pair
    jfig = jplot.ppc_plot(jw, term_index=term_index, max_samples=64, seed=3)
    jax_stream(monkeypatch, 3, jw)
    same_figure(tplot.ppc_plot(tw, term_index=term_index, max_samples=64, seed=3), jfig)


def test_ppc_plot_all_terms_writes(global_pair, tmp_path):
    """JAX tests/test_global_predictive.py:86: every term in one figure,
    and a single term."""
    _, tw = global_pair
    out = str(tmp_path / "ppc_all.png")
    fig = tw.ppc_plot(term_index=None, filename=out)
    assert os.path.exists(out) and len(fig.axes) == 2
    out1 = str(tmp_path / "ppc_one.png")
    tw.ppc_plot(term_index=1, filename=out1)
    assert os.path.exists(out1)


# ------------------------------------------------- set and fit plots


def test_plot_set_param_matches_jax(line_pair, global_pair, tmp_path):
    jset = jfit.WalkerSet([line_pair[0], global_pair[0]])
    tset = tfit.WalkerSet([line_pair[1], global_pair[1]])
    same_figure(tplot.plot_set_param(tset, ":m"), jplot.plot_set_param(jset, ":m"))
    out = str(tmp_path / "set.png")
    same_figure(tset.plot_param("m", filename=out), jset.plot_param("m"))
    assert os.path.exists(out)


@pytest.mark.parametrize("key,ci,take", [("m", 0.9, None), ("b", 0.5, 400)])
def test_forest_plot_of_a_batch_matches_jax(batched_pair, key, ci, take):
    jb, tb = batched_pair
    same_figure(tplot.forest_plot(tb, key, take=take, ci=ci),
                jplot.forest_plot(jb, key, take=take, ci=ci))


@pytest.mark.parametrize("key", ["a", "b"])
def test_forest_plot_of_a_hierarchy_matches_jax(hier_pair, key):
    """A pooled parameter draws the population band; a local one does not."""
    j, t = hier_pair
    same_figure(tplot.forest_plot(t, key), jplot.forest_plot(j, key))
    assert ("+ population" in tplot.forest_plot(t, key).axes[0].get_title()) == (key == "a")


def test_forest_plot_refusals_match_jax(hier_pair, line_pair, tmp_path):
    """JAX tests/test_hierarchical.py:412-430."""
    j, t = hier_pair
    p1 = tmp_path / "forest.png"
    tplot.forest_plot(t, "a", filename=str(p1))
    assert p1.exists() and p1.stat().st_size > 0
    for args in ((t, "a"), (j, "a")):
        mod = tplot if args[0] is t else jplot
        with pytest.raises(ValueError, match="ci must be in"):
            mod.forest_plot(*args, ci=0.0)
    with pytest.raises(ValueError) as te:
        tplot.forest_plot(line_pair[1], "m")
    with pytest.raises(ValueError) as je:
        jplot.forest_plot(line_pair[0], "m")
    assert str(te.value) == str(je.value)


def _sbc_results():
    rng = np.random.default_rng(4)
    n_sims, n_draws = 60, 31
    ranks = rng.integers(0, n_draws + 1, (n_sims, 2))
    common = dict(ranks=ranks, n_draws=n_draws, n_bins=8, keys=("m", "b"),
                  p_values={"m": 0.42, "b": 0.031}, true_params=rng.normal(size=(n_sims, 2)))
    from lisp_mcmc_torch.sbc import SBCResult as TR
    from lisp_mcmc_tpu.sbc import SBCResult as JR

    return TR(**common), JR(**common)


def test_sbc_rank_plot_matches_jax(tmp_path):
    """And JAX tests/test_sbc.py:109: the figure is written."""
    t, j = _sbc_results()
    same_figure(tplot.sbc_rank_plot(t), jplot.sbc_rank_plot(j))
    path = str(tmp_path / "ranks.png")
    tplot.sbc_rank_plot(t, filename=path)
    assert os.path.exists(path) and os.path.getsize(path) > 0


def test_loo_pit_plot_matches_jax(line_pair, tmp_path):
    """The LOO-PIT results of both packages on one history; and JAX
    tests/test_loo_pit.py:106."""
    jw, tw = line_pair
    j, t = jd.loo_pit(jw), td.loo_pit(tw)
    same_figure(tplot.loo_pit_plot(t), jplot.loo_pit_plot(j))
    path = str(tmp_path / "pit.png")
    tplot.loo_pit_plot(t, filename=path)
    assert os.path.exists(path)


def test_prior_sensitivity_plot_matches_jax(line_pair, tmp_path):
    """Both packages' sensitivities under one named prior; and JAX
    tests/test_prior_sensitivity.py:137."""
    jw, tw = line_pair
    jspec, tspec = named_prior_specs()
    j, t = jd.prior_sensitivity(jw, prior=jspec), td.prior_sensitivity(tw, prior=tspec)
    same_figure(tplot.prior_sensitivity_plot(t), jplot.prior_sensitivity_plot(j))
    path = str(tmp_path / "sens.png")
    tplot.prior_sensitivity_plot(t, filename=path)
    assert os.path.exists(path)


def test_plot_file_matches_jax(tmp_path):
    path = tmp_path / "scan.dat"
    rng = np.random.default_rng(0)
    rows = np.column_stack([np.arange(20.0), rng.normal(size=20), rng.normal(size=20)])
    np.savetxt(path, rows, delimiter="\t")
    for cols in ((0, 1), (0, 2)):
        same_figure(tplot.plot_file(str(path), *cols), jplot.plot_file(str(path), *cols))


@pytest.mark.parametrize("values,row,cbar", [
    ([1.0, 2.0, 3.0, 4.0], 2, (0, None)),
    (list(np.linspace(-1.0, 3.0, 11)), 4, (-1.0, 2.5)),
])
def test_heatmap_matches_jax(values, row, cbar):
    same_figure(tplot.heatmap(values, row, cbar_range=cbar, z_label="z"),
                jplot.heatmap(values, row, cbar_range=cbar, z_label="z"))
    same_figure(tplot.heatmap(torch.as_tensor(values), row, cbar_range=cbar),
                jplot.heatmap(values, row, cbar_range=cbar))


# -------------------------------------------------- helpers, delegates


DELEGATES = [("plot_data_and_fit", ()), ("plot_residuals", ()),
             ("caterpillar_plots", ()), ("likelihood_plot", ()),
             ("autocorrelation_plot", ()), ("corner_plot", ("m", "b")),
             ("all_corner_plots", ()), ("param_histogram", ("b",)), ("ppc_plot", ())]


@pytest.mark.parametrize("verb,args", DELEGATES, ids=[d[0] for d in DELEGATES])
def test_walker_plot_verbs_delegate(line_pair, tmp_path, verb, args):
    """``w.<verb>(...)`` is ``plotting.<verb>(w, ...)``, and writes its file."""
    _, tw = line_pair
    out = str(tmp_path / f"{verb}.png")
    fig = getattr(tw, verb)(*args, filename=out)
    assert os.path.exists(out)
    kw = {"filename": None} if verb in ("caterpillar_plots", "all_corner_plots") else {}
    assert_same(figure_data(fig), figure_data(getattr(tplot, verb)(tw, *args, **kw)))


def test_headless_policy(monkeypatch):
    """JAX tests/test_round2_fixes.py:247-252, in both packages."""
    for mod in (tplot, jplot):
        monkeypatch.delenv("MPLBACKEND", raising=False)
        monkeypatch.delenv("DISPLAY", raising=False)
        monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
        assert mod._is_headless()
        monkeypatch.setenv("DISPLAY", ":0")
        assert not mod._is_headless()
        monkeypatch.delenv("DISPLAY", raising=False)
        monkeypatch.setenv("WAYLAND_DISPLAY", "wayland-0")
        assert not mod._is_headless()
        monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
        monkeypatch.setenv("MPLBACKEND", "QtAgg")
        assert not mod._is_headless()


def test_subsample_and_close_on_agg(line_pair, tmp_path):
    """JAX tests/test_persistence_observability.py:238-250: saved figures do
    not accumulate on a non-interactive backend; trace plots cap their
    lines."""
    import matplotlib.pyplot as plt

    _, tw = line_pair
    assert matplotlib.get_backend().lower() == "agg"
    before = len(plt.get_fignums())
    for i in range(5):
        tplot.likelihood_plot(tw, filename=str(tmp_path / f"lp{i}.png"))
    assert len(plt.get_fignums()) == before
    data = np.arange(10 * 500.0).reshape(10, 500)
    np.testing.assert_array_equal(tplot._subsample_walkers(data),
                                  jplot._subsample_walkers(data))
    assert tplot._subsample_walkers(data).shape[1] == 64
    assert tplot._subsample_walkers(data[:, :40]).shape[1] == 40
    fig = tplot.likelihood_plot(tw)                       # no file: stays open
    assert fig.number in plt.get_fignums()
    tplot._save(fig, str(tmp_path / "kept.png"), close=False)
    assert fig.number in plt.get_fignums()


def test_all_plots_render_and_show(line_pair, tmp_path, monkeypatch):
    """JAX tests/test_persistence_observability.py:208-226."""
    _, w = line_pair
    files = {
        "fit": tplot.plot_data_and_fit(w, filename=str(tmp_path / "fit.png")),
        "res": tplot.plot_residuals(w, filename=str(tmp_path / "res.png")),
        "cat": tplot.caterpillar_plots(w, filename=str(tmp_path / "cat.png")),
        "lik": tplot.likelihood_plot(w, filename=str(tmp_path / "lik.png")),
        "corner": tplot.corner_plot(w, "m", "b", filename=str(tmp_path / "c.png")),
        "grid": tplot.all_corner_plots(w, filename=str(tmp_path / "grid.png")),
        "hist": tplot.param_histogram(w, "m", filename=str(tmp_path / "h.png")),
        "heat": tplot.heatmap([1.0, 2.0, 3.0, 4.0], 2, filename=str(tmp_path / "heat.png")),
        "acf": w.autocorrelation_plot(filename=str(tmp_path / "acf.png")),
    }
    for name in ("fit", "res", "cat", "lik", "c", "grid", "h", "heat", "acf"):
        assert any(p.startswith(name) for p in os.listdir(tmp_path)), name
    assert len(files) == 9
    monkeypatch.delenv("DISPLAY", raising=False)
    assert tplot.show(str(tmp_path / "fit.png")) == str(tmp_path / "fit.png")
    assert tplot.show() == tplot._LAST_FIGURE_PATH[-1] == str(tmp_path / "acf.png")
    monkeypatch.setattr(tplot, "_LAST_FIGURE_PATH", [])
    assert tplot.show() is None


def test_plotting_imports_neither_jax_nor_cuda():
    import subprocess
    import sys

    code = ("import sys, lisp_mcmc_torch.plotting, lisp_mcmc_torch.parallel; "
            "bad = [m for m in ('jax', 'lisp_mcmc_tpu', 'triton') if m in sys.modules]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


def test_without_matplotlib_the_device_reductions_run_and_drawing_raises():
    """The card's machine has no matplotlib: the module imports, the
    envelope and the autocorrelation curves compute, and a figure raises."""
    import subprocess
    import sys

    code = """
import sys
sys.modules["matplotlib"] = None
import numpy as np, torch
import lisp_mcmc_torch as mfit
from lisp_mcmc_torch import plotting
from lisp_mcmc_torch.models import line
assert plotting.plt is None and plotting.matplotlib is None
x = np.linspace(0.0, 10.0, 30)
w = mfit.walker_create(function=line, data=(x, 2 * x + 1), params={"m": 1.5, "b": 0.5},
                       data_error=0.3, n_walkers=16, walker_jitter=0.05,
                       dtype=torch.float64, device="cpu")
w.adaptive_steps(400, auto=None)
grid, best, lo, hi = plotting._fit_envelope(w, 0, None, 50, 0.66)
assert grid.shape == (50,) and (lo <= best + 1e-9).all() and (best <= hi + 1e-9).all()
curves = plotting._autocorrelation_curves(w, None, None, 10)
assert [c[0] for c in curves] == ["m", "b"] and curves[0][1].shape == (10,)
try:
    w.plot_residuals()
    raise SystemExit("drew without matplotlib")
except ImportError as e:
    assert "matplotlib" in str(e)
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
