"""Time the posterior kernels in several checkouts, on one GPU.

    python -m lisp_mcmc_torch.kernel_ab TREE [TREE ...]
    python -m lisp_mcmc_torch.kernel_ab --plans

Each TREE is the root of a checkout: ``.`` for this one, an earlier one
unpacked with ``git archive <commit> | tar -x -C build/<name>``.  Each is
timed in a process of its own that imports that tree's
``lisp_mcmc_torch`` and calls its own wrappers, through the calls every
tree has kept since the slice that ported the global fit:
``walker_create``, ``synthetic.global_fit``, ``synthetic.nv_spectra``,
``synthetic.twin_case``, ``nv.nv_walker``,
``ops.loglik_kernel.prepare_fused_terms`` + ``fused_posterior`` and
``ops.chunk_kernel.build_chunk_kernel`` + ``chunk_rwm``.  Each tree
builds its own kernels with its own flags (``build/`` inside the tree).

The shapes (:data:`FUSED_SHAPES`, :data:`SHAPES`), float32 unless named:
the fused kernel on the flagship (W = 131072, d = 6, N = 334; half the
walkers near the peak and half at test.lisp's start), the same in
float64, its low half (W/2 = 65536, the red-black samplers' launch),
test.lisp's global pair (2 x 334 points, d = 9), the NV fit (401 points,
its bounds and declared constraints), the line and the 4-coefficient
polynomial twins (N = 334); the chunk kernel for one 200-step chunk from
the generating parameters with a dense L (``synthetic.dense_l``, made
here and handed to every tree) on the flagship (d = 6), the global pair
(d = 9), five datasets (d = 18) and the global pair on 1500 points a
dataset (d = 9, staged tile by tile).  The trees run in turns, forward
then backward (A B B A), so a drift of the card's clock falls on all
alike.

Prints one JSON object: the card line (``nvidia-smi`` name and power
limit); each tree's times by turn: the fused wrapper's mean ms (CUDA
events around back-to-back calls) and the fused kernel's own device ms
(``torch.profiler``: the kernels named ``fused_posterior``, which leaves
out the host dispatch and, in trees before the constant moved into the
kernel, the separate torch add), and the chunk kernel's mean ms; each
tree's kernel-1 plan at each fused shape (where it has ``fused_plan``),
its chunk kernel's registers and spills and its ``chunk_plan``; which of
each tree's outputs equal the first tree's bit for bit, and the fused
outputs' largest difference from the first tree's, relative to
max(|first|, 1) (R and S reorder the float32 sums); each shape's
op-mix bound (at float32 ceilings this process measures with
``roofline.microbench_ceilings``) and, for the chunk shapes, the
published-peak bound, with each tree's share of them.

``--plans`` times this tree's kernel 1 at every forced plan (block size
64, 128 or 256, R and S in 1, 2, 4) at each fused shape, by the
kernel's own device time, beside the plan ``fused_plan`` picks.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import tempfile

from .device import kernel_time_ms, ptxas_table

W = 131072
# chunk shape -> (datasets of the global fit, points each; None: the
# flagship), chunk launches timed per turn
SHAPES = {"chunk_d6": (None, 20), "chunk_d9": ((2, 334), 20),
          "chunk_d18": ((5, 334), 10), "chunk_d9_tiled": ((2, 1500), 5)}
# fused shape -> (fit, walkers, float64?)
FUSED_SHAPES = {"flagship": ("flagship", W, False), "flagship_f64": ("flagship", W, True),
                "half": ("flagship", W // 2, False), "global": ("global", W, False),
                "nv": ("nv", W, False), "line": ("line", W, False),
                "polynomial4": ("polynomial", W, False)}
FUSED_REPS = 300
CHUNK_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "accept_counts", "m_outer")


def _walker(shape, n, jitter, start=False, dtype=None):
    """The fit of one shape at its generating parameters (or test.lisp's
    start), on the current tree's package."""
    from lisp_mcmc_torch import roofline, synthetic, walker_create
    from lisp_mcmc_torch.models import lorder_mixed_bg

    if shape is None:
        return walker_create(function=lorder_mixed_bg, data=roofline.synthetic_flagship(),
                             params=roofline.START if start else roofline.FLAGSHIP,
                             data_error=1e-7, n_walkers=n, seed=0, walker_jitter=jitter,
                             dtype=dtype)
    g = synthetic.global_fit(shape[0], n_points=shape[1])
    return walker_create(function=g["functions"], data=g["data"],
                         params=g["start"] if start else g["truth"], data_error=1e-7,
                         n_walkers=n, seed=0, walker_jitter=jitter, dtype=dtype)


def _fused_case(fit, n, f64):
    """``(positions, FusedPosterior)`` of one fused shape, on the current
    tree's package."""
    import numpy as np
    import torch

    from lisp_mcmc_torch import models, nv, synthetic, walker_create
    from lisp_mcmc_torch.ops.loglik_kernel import prepare_fused_terms

    dtype = torch.float64 if f64 else torch.float32
    if fit == "flagship":
        near = _walker(None, W // 2, 0.02, dtype=dtype)
        far = _walker(None, W // 2, 0.05, start=True, dtype=dtype)
        pos = torch.cat([near.state.position, far.state.position])
        return pos[:n].contiguous(), prepare_fused_terms(near.terms, near.spec, dtype)
    if fit == "global":
        w = _walker((2, 334), n, 0.02)
    elif fit == "nv":
        xs, ys = synthetic.nv_spectra()
        w = nv.nv_walker((xs, ys[1]), n_walkers=n, walker_jitter=0.005)
    else:
        model = models.line if fit == "line" else models.polynomial
        x, y, params, _ = synthetic.twin_case(model, True, 334)
        w = walker_create(function=model, data=(x, y), params=params,
                          data_error=0.01 * np.abs(y).max(), n_walkers=n, seed=0,
                          walker_jitter=0.02)
    return w.state.position, prepare_fused_terms(w.terms, w.spec, dtype)


def _measure(l_path: str, out_path: str) -> None:
    """Run in a tree's own process, with the tree's root as the working
    directory (first on ``sys.path`` under ``python -c``): time its
    kernels, save their outputs, times, plans and ptxas table."""
    import torch

    from lisp_mcmc_torch.device import _target
    from lisp_mcmc_torch.ops import chunk_kernel, loglik_kernel

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    ls = torch.load(l_path)
    res = {"fused": {}, "fused_ms": {}, "fused_kernel_ms": {}, "fused_plan": {},
           "chunk": {}, "chunk_ms": {}, "plan": {}}
    for name, case in FUSED_SHAPES.items():
        pos, post = _fused_case(*case)

        def call():
            return loglik_kernel.fused_posterior(pos, post)

        res["fused"][name] = call().cpu()
        res["fused_ms"][name] = timed(call, FUSED_REPS)
        res["fused_kernel_ms"][name] = kernel_time_ms(call, 100, "fused_posterior")
        if hasattr(loglik_kernel, "fused_plan"):
            res["fused_plan"][name] = loglik_kernel.fused_plan(post, pos.shape[0])
    seed = torch.tensor([20240607], dtype=torch.int32, device="cuda")
    for name, (shape, reps) in SHAPES.items():
        wc = _walker(shape, W, 1e-3)
        ck = chunk_kernel.build_chunk_kernel(wc.terms, wc.spec, wc.config, W, torch.float32)
        st = wc.state
        args = (st.position, st.logprob, st.best_position, st.best_logprob,
                ls[name].to("cuda"), 1000, 0.0, seed)
        out = chunk_kernel.chunk_rwm(ck, *args)
        res["chunk"][name] = {k: out[k].cpu() for k in CHUNK_KEYS}
        res["chunk_ms"][name] = timed(lambda: chunk_kernel.chunk_rwm(ck, *args), reps)
        if hasattr(chunk_kernel, "chunk_plan"):
            res["plan"][name] = chunk_kernel.chunk_plan(ck, W)
    res["ptxas"] = ptxas_table(_target("chunk_rwm").with_suffix(".log").read_text())
    torch.save(res, out_path)


def _bounds(ceilings: dict) -> dict:
    """Each chunk shape's published-peak and op-mix bounds in ms, from
    this tree's census of one chunk at W walkers, and each fused shape's
    op-mix bound (the float32 rates, so the float64 shape's bound is the
    float32 one)."""
    import torch

    from .ops.chunk_kernel import build_chunk_kernel, chunk_bytes, chunk_census
    from .ops.loglik_kernel import class_rates, opmix_bound_ms, posterior_census
    from .roofline import peak_bound

    rates = class_rates(ceilings)
    out = {}
    for name, case in FUSED_SHAPES.items():
        pos, post = _fused_case(*case)
        out[name] = {"W": pos.shape[0], "d": post.d,
                     "opmix_bound_ms": opmix_bound_ms(posterior_census(post),
                                                      pos.shape[0], 1, 1, rates)}
    for name, (shape, _) in SHAPES.items():
        w = _walker(shape, W, 1e-3)
        ck = build_chunk_kernel(w.terms, w.spec, w.config, W, torch.float32)
        census = chunk_census(posterior_census(ck.post), ck.d)
        peak = peak_bound(census, W, 1, ck.chunk, chunk_bytes(ck.post, W, ck.chunk),
                          torch.float32)
        out[name] = {"d": ck.d, "peak_bound_ms": peak["bound_ms"],
                     "peak_bound_by": peak["bound_by"],
                     "opmix_bound_ms": opmix_bound_ms(census, W, 1, ck.chunk, rates)}
    return out


def main(trees: list[str]) -> dict:
    import numpy as np
    import torch

    from .roofline import FLAGSHIP, microbench_ceilings
    from .synthetic import dense_l, global_fit

    roots = [os.path.abspath(t) for t in trees]
    code = ("import sys\nimport torch\n" + f"W = {W}\nSHAPES = {SHAPES!r}\nCHUNK_KEYS = {CHUNK_KEYS!r}\n"
            + f"FUSED_SHAPES = {FUSED_SHAPES!r}\nFUSED_REPS = {FUSED_REPS}\n"
            + "".join(inspect.getsource(f) for f in (ptxas_table, kernel_time_ms, _walker,
                                                      _fused_case, _measure))
            + "\n_measure(sys.argv[1], sys.argv[2])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    times = {t: {**{f"fused_ms.{k}": [] for k in FUSED_SHAPES},
                 **{f"fused_kernel_ms.{k}": [] for k in FUSED_SHAPES},
                 **{k: [] for k in SHAPES}} for t in trees}
    outputs = {}
    ls = {name: dense_l(3e-3 * np.asarray(list(
        (FLAGSHIP if shape is None else global_fit(shape[0], n_points=shape[1])["truth"])
        .values()))) for name, (shape, _) in SHAPES.items()}
    with tempfile.TemporaryDirectory() as tmp:
        l_path = os.path.join(tmp, "L.pt")
        torch.save(ls, l_path)
        for turn, i in enumerate([*range(len(trees)), *reversed(range(len(trees)))]):
            out = os.path.join(tmp, f"turn{turn}.pt")
            subprocess.run([sys.executable, "-c", code, l_path, out],
                           cwd=roots[i], env=env, check=True)
            res = torch.load(out)
            for k in FUSED_SHAPES:
                times[trees[i]][f"fused_ms.{k}"].append(res["fused_ms"][k])
                times[trees[i]][f"fused_kernel_ms.{k}"].append(res["fused_kernel_ms"][k])
            for k in SHAPES:
                times[trees[i]][k].append(res["chunk_ms"][k])
            outputs.setdefault(trees[i], res)
    first = outputs[trees[0]]
    same = {t: {**{f"fused.{s}": bool(torch.equal(o["fused"][s], first["fused"][s]))
                   for s in FUSED_SHAPES},
                **{f"{s}.{k}": bool(torch.equal(o["chunk"][s][k], first["chunk"][s][k]))
                   for s in SHAPES for k in CHUNK_KEYS}}
            for t, o in outputs.items()}
    fused_err = {t: {s: _rel_err(o["fused"][s], first["fused"][s]) for s in FUSED_SHAPES}
                 for t, o in outputs.items()}
    bounds = _bounds(microbench_ceilings(torch.float32, "cuda"))

    def mean(v):
        return sum(v) / len(v) if None not in v else None

    for name, b in bounds.items():
        if name in SHAPES:
            b["share"] = {t: {"opmix": b["opmix_bound_ms"] / mean(v[name]),
                              "peak": b["peak_bound_ms"] / mean(v[name])}
                          for t, v in times.items()}
        else:
            b["share"] = {t: {"wrapper": b["opmix_bound_ms"] / mean(v[f"fused_ms.{name}"]),
                              "kernel": (b["opmix_bound_ms"] / mean(v[f"fused_kernel_ms.{name}"])
                                         if mean(v[f"fused_kernel_ms.{name}"]) else None)}
                          for t, v in times.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    return {"card": card, "W": W, "times": times, "same_output_as_first": same,
            "fused_rel_err_vs_first": fused_err,
            "fused_plans": {t: o["fused_plan"] for t, o in outputs.items()},
            "plans": {t: o["plan"] for t, o in outputs.items()},
            "ptxas": {t: o["ptxas"] for t, o in outputs.items()}, "bounds": bounds}


def _rel_err(got, ref) -> float:
    """``max |got - ref| / max(|ref|, 1)`` over the finite pairs."""
    got, ref = got.double(), ref.double()
    ok = got.isfinite() & ref.isfinite()
    return float(((got - ref).abs() / ref.abs().clamp_min(1.0))[ok].max()) if ok.any() else 0.0


def plans() -> dict:
    """This tree's kernel 1 at every forced plan at each fused shape: the
    kernel's own ms (``torch.profiler``), its blocks per SM and waves,
    its largest error against the chosen plan's output; and the chosen
    plan with its ms."""
    import torch

    from .ops.loglik_kernel import fused_plan, fused_posterior, posterior_rel_err

    out = {}
    for name, case in FUSED_SHAPES.items():
        pos, post = _fused_case(*case)
        n = pos.shape[0]
        ref = fused_posterior(pos, post)
        row = {"chosen": fused_plan(post, n),
               "chosen_ms": kernel_time_ms(lambda: fused_posterior(pos, post), 100,
                                           "fused_posterior"), "forced": {}}
        for threads in (64, 128, 256):
            for r in (1, 2, 4):
                for s in (1, 2, 4):
                    force = (threads, r, s)
                    try:
                        p = fused_plan(post, n, force)
                    except RuntimeError:
                        continue
                    got = fused_posterior(pos, post, force)
                    ms = kernel_time_ms(lambda: fused_posterior(pos, post, force), 100,
                                        "fused_posterior")
                    row["forced"][f"{threads},{r},{s}"] = {
                        "ms": ms, "blocks_per_sm": p["blocks_per_sm"], "waves": p["waves"],
                        "rel_err": posterior_rel_err(got, ref, post)}
        out[name] = row
    return out


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    if sys.argv[1] == "--plans":
        print(json.dumps(plans()))
    else:
        print(json.dumps(main(sys.argv[1:])))
