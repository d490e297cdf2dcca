"""Time the posterior kernels in several checkouts, on one GPU.

    python -m lisp_mcmc_torch.kernel_ab TREE [TREE ...]

Each TREE is the root of a checkout: ``.`` for this one, an earlier one
unpacked with ``git archive <commit> | tar -x -C build/<name>``.  Each is
timed in a process of its own that imports that tree's
``lisp_mcmc_torch`` and calls its own wrappers, through the calls every
tree has kept since the slice that ported the global fit:
``walker_create``, ``synthetic.global_fit``,
``ops.loglik_kernel.prepare_fused_terms`` + ``fused_posterior`` and
``ops.chunk_kernel.build_chunk_kernel`` + ``chunk_rwm``.  Each tree
builds its own kernels with its own flags (``build/`` inside the tree).

The shapes, all float32 at W = 131072 walkers (:data:`SHAPES`): the fused
kernel on the flagship (d = 6, N = 334; half the walkers near the peak
and half at test.lisp's start), and the chunk kernel for one 200-step
chunk from the generating parameters with a dense L
(``synthetic.dense_l``, made here and handed to every tree) on the
flagship (d = 6), test.lisp's global pair (d = 9), five datasets (d = 18)
and the global pair on 1500 points a dataset (d = 9, staged tile by
tile).  The trees run in turns, forward then backward (A B B A), so a
drift of the card's clock falls on all alike.

Prints one JSON object: the card line (``nvidia-smi`` name and power
limit); each tree's times by turn (mean ms of 1000 fused launches and of
a few chunk launches), its chunk kernel's registers and spills (its
``-Xptxas=-v`` log) and, where the tree has ``chunk_plan``, its block
size, blocks per SM and waves at each shape; which of each tree's
outputs equal the first tree's bit for bit; and each chunk shape's
bounds (published peak and op-mix, the op-mix one at float32 ceilings
this process measures with ``roofline.microbench_ceilings``), with each
tree's share of both.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import tempfile

from .device import ptxas_table

W = 131072
# chunk shape -> (datasets of the global fit, points each; None: the
# flagship), chunk launches timed per turn
SHAPES = {"chunk_d6": (None, 20), "chunk_d9": ((2, 334), 20),
          "chunk_d18": ((5, 334), 10), "chunk_d9_tiled": ((2, 1500), 5)}
CHUNK_KEYS = ("position", "logprob", "best_position", "best_logprob",
              "accept_counts", "m_outer")


def _walker(shape, n, jitter, start=False):
    """The fit of one shape at its generating parameters (or test.lisp's
    start), on the current tree's package."""
    from lisp_mcmc_torch import roofline, synthetic, walker_create
    from lisp_mcmc_torch.models import lorder_mixed_bg

    if shape is None:
        return walker_create(function=lorder_mixed_bg, data=roofline.synthetic_flagship(),
                             params=roofline.START if start else roofline.FLAGSHIP,
                             data_error=1e-7, n_walkers=n, seed=0, walker_jitter=jitter)
    g = synthetic.global_fit(shape[0], n_points=shape[1])
    return walker_create(function=g["functions"], data=g["data"],
                         params=g["start"] if start else g["truth"], data_error=1e-7,
                         n_walkers=n, seed=0, walker_jitter=jitter)


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
    near = _walker(None, W // 2, 0.02)
    pos = torch.cat([near.state.position,
                     _walker(None, W // 2, 0.05, start=True).state.position]).contiguous()
    post = loglik_kernel.prepare_fused_terms(near.terms, near.spec, torch.float32)
    res = {"fused": loglik_kernel.fused_posterior(pos, post).cpu(),
           "fused_ms": timed(lambda: loglik_kernel.fused_posterior(pos, post), 1000),
           "chunk": {}, "chunk_ms": {}, "plan": {}}
    seed = torch.tensor([20240607], dtype=torch.int32, device=pos.device)
    for name, (shape, reps) in SHAPES.items():
        wc = _walker(shape, W, 1e-3)
        ck = chunk_kernel.build_chunk_kernel(wc.terms, wc.spec, wc.config, W, torch.float32)
        st = wc.state
        args = (st.position, st.logprob, st.best_position, st.best_logprob,
                ls[name].to(pos.device), 1000, 0.0, seed)
        out = chunk_kernel.chunk_rwm(ck, *args)
        res["chunk"][name] = {k: out[k].cpu() for k in CHUNK_KEYS}
        res["chunk_ms"][name] = timed(lambda: chunk_kernel.chunk_rwm(ck, *args), reps)
        if hasattr(chunk_kernel, "chunk_plan"):
            res["plan"][name] = chunk_kernel.chunk_plan(ck, W)
    res["ptxas"] = ptxas_table(_target("chunk_rwm").with_suffix(".log").read_text())
    torch.save(res, out_path)


def _bounds(ceilings: dict) -> dict:
    """Each chunk shape's published-peak and op-mix bounds in ms, from
    this tree's census of one chunk at W walkers."""
    import torch

    from .ops.chunk_kernel import build_chunk_kernel, chunk_bytes, chunk_census
    from .ops.loglik_kernel import class_rates, opmix_bound_ms, posterior_census
    from .roofline import peak_bound

    rates = class_rates(ceilings)
    out = {}
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
    code = ("import sys\n" + f"W = {W}\nSHAPES = {SHAPES!r}\nCHUNK_KEYS = {CHUNK_KEYS!r}\n"
            + "".join(inspect.getsource(f) for f in (ptxas_table, _walker, _measure))
            + "\n_measure(sys.argv[1], sys.argv[2])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    times = {t: {"fused_ms": [], **{k: [] for k in SHAPES}} for t in trees}
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
            times[trees[i]]["fused_ms"].append(res["fused_ms"])
            for k in SHAPES:
                times[trees[i]][k].append(res["chunk_ms"][k])
            outputs.setdefault(trees[i], res)
    first = outputs[trees[0]]
    same = {t: {"fused": bool(torch.equal(o["fused"], first["fused"])),
                **{f"{s}.{k}": bool(torch.equal(o["chunk"][s][k], first["chunk"][s][k]))
                   for s in SHAPES for k in CHUNK_KEYS}}
            for t, o in outputs.items()}
    bounds = _bounds(microbench_ceilings(torch.float32, "cuda"))
    for name, b in bounds.items():
        b["share"] = {t: {"opmix": b["opmix_bound_ms"] / (sum(v[name]) / len(v[name])),
                          "peak": b["peak_bound_ms"] / (sum(v[name]) / len(v[name]))}
                      for t, v in times.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    return {"card": card, "W": W, "times": times, "same_output_as_first": same,
            "plans": {t: o["plan"] for t, o in outputs.items()},
            "ptxas": {t: o["ptxas"] for t, o in outputs.items()}, "bounds": bounds}


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(json.dumps(main(sys.argv[1:])))
