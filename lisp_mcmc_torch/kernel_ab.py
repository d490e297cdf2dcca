"""Time the flagship's two posterior kernels in several checkouts, on one GPU.

    python -m lisp_mcmc_torch.kernel_ab TREE [TREE ...]

Each TREE is the root of a checkout: ``.`` for this one, an earlier one
unpacked with ``git archive <commit> | tar -x -C build/<name>``.  Each is
timed in a process of its own that imports that tree's
``lisp_mcmc_torch`` and calls its own wrappers, through the calls every
tree has kept since the port's first slice: ``walker_create``,
``ops.loglik_kernel.prepare_fused_terms`` + ``fused_posterior`` and
``ops.chunk_kernel.build_chunk_kernel`` + ``chunk_rwm``.  Each tree builds
its own kernels with its own flags (``build/`` inside the tree).

The inputs are the flagship's (``roofline.synthetic_flagship``: W = 131072
walkers, d = 6, N = 334 points, float32): the fused kernel on half the
walkers near the peak and half at test.lisp's start, the chunk kernel for
one 200-step chunk from the peak with a dense L (``synthetic.dense_l``,
made here and handed to every tree).  The trees run in turns, forward
then backward (A B B A), so a drift of the card's clock falls on all
alike.  Prints one JSON object: the card line (``nvidia-smi`` name and
power limit), each tree's times by turn (mean ms of 1000 fused and 20
chunk launches), and which of each tree's outputs equal the first tree's
bit for bit.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import tempfile

W = 131072


def _measure(l_path: str, out_path: str) -> None:
    """Run in a tree's own process, with the tree's root as the working
    directory (first on ``sys.path`` under ``python -c``): time its
    kernels, save their outputs and times."""
    import torch

    from lisp_mcmc_torch import roofline, walker_create
    from lisp_mcmc_torch.models import lorder_mixed_bg
    from lisp_mcmc_torch.ops import chunk_kernel, loglik_kernel

    x, y = roofline.synthetic_flagship()

    def walker(params, n, jitter):
        return walker_create(function=lorder_mixed_bg, data=(x, y), params=params,
                             data_error=1e-7, n_walkers=n, seed=0, walker_jitter=jitter)

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

    w_half = W // 2
    near = walker(roofline.FLAGSHIP, w_half, 0.02)
    pos = torch.cat([near.state.position,
                     walker(roofline.START, w_half, 0.05).state.position]).contiguous()
    post = loglik_kernel.prepare_fused_terms(near.terms, near.spec, torch.float32)
    wc = walker(roofline.FLAGSHIP, W, 1e-3)
    ck = chunk_kernel.build_chunk_kernel(wc.terms, wc.spec, wc.config, W, torch.float32)
    st = wc.state
    args = (st.position, st.logprob, st.best_position, st.best_logprob,
            torch.load(l_path).to(pos.device), 1000, 0.0,
            torch.tensor([20240607], dtype=torch.int32, device=pos.device))
    fused = loglik_kernel.fused_posterior(pos, post)
    chunk = chunk_kernel.chunk_rwm(ck, *args)
    torch.save({"fused": fused.cpu(),
                "chunk": {k: chunk[k].cpu() for k in
                          ("position", "logprob", "accept_counts", "m_outer")},
                "fused_ms": timed(lambda: loglik_kernel.fused_posterior(pos, post), 1000),
                "chunk_ms": timed(lambda: chunk_kernel.chunk_rwm(ck, *args), 20)},
               out_path)


def main(trees: list[str]) -> dict:
    import numpy as np
    import torch

    from .roofline import FLAGSHIP
    from .synthetic import dense_l

    roots = [os.path.abspath(t) for t in trees]
    code = (f"import sys\nW = {W}\n" + inspect.getsource(_measure)
            + "\n_measure(sys.argv[1], sys.argv[2])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    times = {t: {"fused_ms": [], "chunk_ms": []} for t in trees}
    outputs = {}
    with tempfile.TemporaryDirectory() as tmp:
        l_path = os.path.join(tmp, "L.pt")
        torch.save(dense_l(3e-3 * np.asarray(list(FLAGSHIP.values()))), l_path)
        for turn, i in enumerate([*range(len(trees)), *reversed(range(len(trees)))]):
            out = os.path.join(tmp, f"turn{turn}.pt")
            subprocess.run([sys.executable, "-c", code, l_path, out],
                           cwd=roots[i], env=env, check=True)
            res = torch.load(out)
            for k in ("fused_ms", "chunk_ms"):
                times[trees[i]][k].append(res[k])
            outputs.setdefault(trees[i], res)
    first = outputs[trees[0]]
    same = {t: {"fused": bool(torch.equal(o["fused"], first["fused"])),
                **{k: bool(torch.equal(o["chunk"][k], first["chunk"][k]))
                   for k in first["chunk"]}}
            for t, o in outputs.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    return {"card": card, "W": W, "N": 334, "d": 6, "times": times,
            "same_output_as_first": same}


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(json.dumps(main(sys.argv[1:])))
