"""The reference's demo script (test.lisp), end to end, on PyTorch.

The counterpart of ``examples/reference_journey.py``.  Every step of the
reference's test.lisp has a working equivalent here: file discovery
(test.lisp:10), ingestion (12), single-dataset fit + plots + derived
quantity (14-31), save/load round trip (38-49, which the reference only
documents in comments), and the two-dataset global fit with shared
parameters (52-78).

Run: ``python examples_torch/reference_journey.py [data-file [figure-dir]]``
(the data file defaults to the first ``*example*.xls`` under ``data/``
at the root of the checkout; without one it stops and asks for a path).
:func:`write_journey_data` writes such a file from
``lisp_mcmc_torch.synthetic.global_fit``.  Figures are drawn only when a
figure directory is given.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples_torch._common import phase, setup_device  # noqa: E402

import numpy as np  # noqa: E402

import lisp_mcmc_torch as mfit  # noqa: E402
from lisp_mcmc_torch import diagnostics, models, synthetic  # noqa: E402
from lisp_mcmc_torch.checkpoint import walker_load, walker_save  # noqa: E402
from lisp_mcmc_torch.models import lorder_mixed_bg  # noqa: E402

# test.lisp:54-55's lorder-mixed-bg2: the second dataset's own amplitude
# and background under the shared lineshape.  A declared renaming, so the
# global fit stays inside the fused CUDA kernel.
lorder_mixed_bg2 = models.renamed(lorder_mixed_bg,
                                  {"scale": "scale2", "bg0": "bg02", "bg1": "bg12"},
                                  name="lorder_mixed_bg2")

# test.lisp's depth and width: annealing steps of each fit, walkers.
N_STEPS, N_WALKERS = 30000, 1024
SINGLE_START = {"scale": 1e-5, "linewidth": 7, "x0": 2200, "mix": 0.9,
                "bg0": 1e-7, "bg1": 1e-9}
GLOBAL_START = {"scale": 1e-6, "linewidth": 100, "x0": 2700, "mix": 0.1,
                "bg0": 1e-7, "bg1": 1e-10,                   # dataset 1 own
                "scale2": 1e-8, "bg02": 1e-7, "bg12": 1e-10}  # dataset 2 own
# The columns of the reference's example-data.xls (one tab-separated
# header line); the journey reads x from column 1 and y from 4 and 5.
COLUMNS = ("Set Field", "Probe field", "FMR", "Phase", "X", "Y",
           "FMR frequency", "FMR Power", "Integrated X")


def write_journey_data(path: str, seed: int = 0) -> str:
    """Write the journey's data file: ``synthetic.global_fit(n_datasets=2)``
    in the reference file's layout (tab-separated, one header line, nine
    columns), its x in columns 0 and 1, dataset 1's y in column 4 and
    dataset 2's in column 5, the other columns 0."""
    g = synthetic.global_fit(n_datasets=2, seed=seed)
    (x, y1), (_, y2) = g["data"]
    zero = np.zeros_like(x)
    cols = (x, x, zero, zero, y1, y2, zero, zero, zero)
    with open(path, "w") as f:
        f.write("\t".join(COLUMNS) + "\n")
        for i in range(x.shape[0]):
            f.write("\t".join(repr(float(c[i])) for c in cols) + "\n")
    return path


def find_data() -> str:
    # argv only counts when it points at a real file (under pytest the
    # first argument is the test path, not a dataset).
    if len(sys.argv) > 1 and os.path.isfile(sys.argv[1]):
        return sys.argv[1]
    root = os.path.join(os.path.dirname(__file__), "..", "data")
    hits = mfit.get_filename(root, include=["example", ".xls"]) if os.path.isdir(root) else []
    if hits:
        return hits[0]
    raise SystemExit("no example data found; pass a path")


def single_walker(x, y, n_walkers: int = N_WALKERS, device=None, dtype=None):
    """test.lisp:14-22's single-dataset walker."""
    return mfit.walker_create(
        function=lorder_mixed_bg,
        data=(x, y),
        params=SINGLE_START,
        data_error=1e-7,
        n_walkers=n_walkers,
        walker_jitter=0.05,
        dtype=dtype,
        device=device,
    )


def ingest_and_fit(n_steps: int = N_STEPS, n_walkers: int = N_WALKERS,
                   path: str | None = None, device=None, dtype=None):
    """Phase 1 (test.lisp:10-25): ingestion + the single-dataset fit.

    Exposed as a function so tests and ``chip_smoke.py`` can drive it;
    returns (table, x, y, walker).
    """
    with phase("ingest example data (test.lisp:10-12)"):
        path = path or find_data()
        table = mfit.read_file_data(path)
        x, y = mfit.create_walker_data(table, 1, 4)
        print(f"loaded {path}: {len(table)} columns x {len(x)} rows")

    with phase(f"single-dataset fit, {n_steps} steps (test.lisp:14-25)"):
        walker = single_walker(x, y, n_walkers, device, dtype)
        walker.adaptive_steps(n_steps, temperature=10.0)
        print(diagnostics.summary(walker))
        # expected most-likely log-posterior ~4646.756+ (test.lisp:26-30)
    return table, x, y, walker


def plots_and_expression(walker, figures: str | None = None):
    """test.lisp:25-31: the plots (into ``figures`` when given) and the
    derived quantity; returns linewidth/x0 at the best point."""
    with phase("plots + derived quantity (test.lisp:25-31)"):
        if figures is not None:
            from lisp_mcmc_torch import plotting

            plotting.plot_data_and_fit(walker, filename=os.path.join(figures, "fit.png"))
            plotting.plot_residuals(walker, filename=os.path.join(figures, "residuals.png"))
            plotting.caterpillar_plots(walker, filename=os.path.join(figures, "traces.png"))
            plotting.likelihood_plot(walker, filename=os.path.join(figures, "trace_lp.png"))
            plotting.all_corner_plots(walker, filename=os.path.join(figures, "corner.png"))
        q_factor = mfit.walker_with_expression(walker, "(/ :linewidth :x0)")
        print(f"linewidth/x0 = {q_factor:.6g}  (walker-with-exp, test.lisp:31)")
    return q_factor


def save_load_round_trip(walker, n_steps: int, workdir: str, device=None):
    """test.lisp:38-49: save, reload (JAX's file format) and resume."""
    with phase("save/load round trip (test.lisp:38-49)"):
        ckpt = os.path.join(workdir, "walker.npz")
        walker_save(walker, ckpt)
        reloaded = walker_load(ckpt, device=device)
        reloaded.adaptive_steps(min(2000, n_steps), auto=None)  # resumable mid-run
        print(f"reloaded fit best lp: {reloaded.most_likely_step()[0]:.3f}")
    return reloaded


def global_fit(table, x, y, n_steps: int = N_STEPS, n_walkers: int = N_WALKERS,
               optimize_rounds: int = 4, device=None, dtype=None):
    """test.lisp:52-78: the two-dataset global fit with shared parameters,
    then the multi-start Adam polish; returns the fit."""
    # The reference shares linewidth/x0/mix between the two columns and
    # gives the second dataset its OWN amplitude/background (scale2,
    # bg02, bg12 via the lorder-mixed-bg2 wrapper, test.lisp:54-55).
    with phase("global two-dataset fit (test.lisp:52-78)"):
        x2, y2 = mfit.create_walker_data(table, 1, 5)
        global_walker = mfit.mcmc_fit(
            function=[lorder_mixed_bg, lorder_mixed_bg2],
            data=[(x, y), (x2, y2)],
            params=GLOBAL_START,
            data_error=[1e-7, 1e-7],
            n_steps=n_steps,
            n_walkers=n_walkers,
            dtype=dtype,
            device=device,
        )
        print(f"global fit after anneal: lp = {global_walker.most_likely_step()[0]:.1f}")

    with phase("multi-start Adam polish"):
        # The 9-parameter joint posterior anneals into the right basin but
        # needs gradient polish to reach the optimum (the reference ran
        # 100k steps here; multi-start Adam gets there in a fraction).
        global_walker.optimize(400, rounds=optimize_rounds)
        best = global_walker.most_likely_params()
        print("global fit shared params:",
              {k: round(float(best[k]), 4) for k in ("linewidth", "x0", "mix")})
        # (The lorder lineshape is sign-symmetric in linewidth with a
        # compensating mix flip, so mirror labelings are equivalent fits.)
        print(f"global fit after polish: lp = {global_walker.most_likely_step()[0]:.1f}")
    return global_walker


def main(n_steps: int = N_STEPS, n_walkers: int = N_WALKERS, path: str | None = None,
         figures: str | None = None, device=None, optimize_rounds: int = 4):
    """The whole journey; returns ``{"single", "reloaded", "global",
    "q_factor"}``."""
    device = setup_device() if device is None else device
    table, x, y, walker = ingest_and_fit(n_steps, n_walkers, path, device)
    q_factor = plots_and_expression(walker, figures)
    with tempfile.TemporaryDirectory(prefix="mfit_") as work:
        reloaded = save_load_round_trip(walker, n_steps, work, device)
    global_walker = global_fit(table, x, y, n_steps, n_walkers, optimize_rounds, device)
    if figures is not None:
        print(f"figures in {figures}")
    return {"single": walker, "reloaded": reloaded, "global": global_walker,
            "q_factor": q_factor}


if __name__ == "__main__":
    main(figures=sys.argv[2] if len(sys.argv) > 2 else None)
