"""Worker of the 2-process ``torch.distributed`` tests (tests/test_torch_parallel.py).

Each process joins one gloo group on localhost, builds the SAME
deterministic fits, and runs every case twice: sharded over the group
(``lisp_mcmc_torch.parallel``) and unsharded in this process, from one
seed.  The sharded results are gathered to every rank; rank 0 writes one
JSON report (and ``jax_rwm.npz``, the chunk run on the JAX draws the
parent test left in ``<outdir>/jax_in.npz``).  This script imports
neither JAX nor the JAX package.

Usage: python torch_dist_worker.py <rank> <world_size> <port> <outdir>
"""

import dataclasses
import json
import os
import sys
import time


def main():
    rank, world, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.convert import state_from_numpy
    from lisp_mcmc_torch.kernel import build_chunk_runner
    from lisp_mcmc_torch.models import double_lorentzian_bg, line
    from lisp_mcmc_torch.parallel import initialize_distributed, make_mesh, shard_state

    n = initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                               world_size=world, device="cpu", timeout=60)
    assert n == world, (n, world)
    mesh = make_mesh()
    f64 = torch.float64
    report = {"world_size": n, "cases": {}}

    def line_walker(n_walkers=64, seed=0):
        x = np.linspace(0.0, 10.0, 50)
        y = 2.0 * x + 1.0
        return mfit.walker_create(function=line, data=(x, y), params={"m": 1.5, "b": 0.5},
                                  data_error=0.1, n_walkers=n_walkers, seed=seed,
                                  walker_jitter=0.05, dtype=f64, device="cpu")

    def whole(state, comm_mesh):
        """The gathered walker-axis fields of a sharded state."""
        from lisp_mcmc_torch.parallel import chain_comm

        comm = chain_comm(comm_mesh)
        wl = state.position.shape[0]
        rows = torch.cat([state.position, state.logprob[:, None], state.best_position,
                          state.best_logprob[:, None]], dim=1)
        _, full = comm.exchange(None, rows, comm.rank * wl, wl * comm.size)
        d = state.position.shape[1]
        return {"position": full[:, :d], "logprob": full[:, d],
                "best_position": full[:, d + 1:2 * d + 1], "best_logprob": full[:, 2 * d + 1]}

    def compare(ref, got_state, got_walkers, ref_out, got_out):
        """Max |difference| relative to max(1, |ref|) per field, and
        whether the walker fields are equal bit for bit."""
        res = {}
        for k in ("position", "logprob", "best_position", "best_logprob"):
            a, b = getattr(ref, k), got_walkers[k]
            res[k] = float(((a - b).abs() / a.abs().clamp_min(1.0)).max())
            res[k + "_equal"] = bool(torch.equal(a, b))
        for k in ("l_matrix", "m_sum", "m_outer", "m_count", "chees"):
            a, b = getattr(ref, k), getattr(got_state, k)
            res[k] = float(((a - b).abs() / a.abs().clamp_min(1.0)).max()) if a.numel() else 0.0
        for k in ("accept_rate", "logprob_max", "logprob_mean", "logprob_min", "group_accept"):
            a, b = ref_out[k], got_out[k]
            res["out_" + k] = float(((a - b).abs() / a.abs().clamp_min(1.0)).max())
        res["collectives"] = int(got_out["collectives"])
        res["accept_rate"] = float(ref_out["accept_rate"])
        res["age_equal"] = ref.age == got_state.age
        return res

    # A warmed line ensemble, the same in every process: 600 rwm steps,
    # then 400 mala steps (the gradient samplers start from their tuned L).
    warm = line_walker()
    warm.adaptive_steps(600, auto=None, collect_history=False)
    rwm_start = warm.state
    warm.sampling_steps(400, kernel="mala", collect_history=False)
    grad_start = warm.state

    def chunk_case(kernel, flags, chunk, **blocks):
        start = grad_start if kernel in ("mala", "hmc", "chees") else rwm_start
        cfg = dataclasses.replace(warm.config, kernel=kernel, chunk_size=chunk, **blocks)
        run, _ = build_chunk_runner(warm._log_post, warm.ndim, cfg)
        run_m, _ = build_chunk_runner(warm._log_post, warm.ndim, cfg, mesh=mesh)
        t0 = time.perf_counter()
        ref, ref_out = run(start, *flags, generator=torch.Generator().manual_seed(7))
        got, got_out = run_m(shard_state(start, mesh), *flags,
                             generator=torch.Generator().manual_seed(7))
        res = compare(ref, got, whole(got, mesh), ref_out, got_out)
        res["seconds"] = time.perf_counter() - t0
        res["mean_ref"] = ref.position.mean(dim=0).tolist()
        res["std_ref"] = ref.position.std(dim=0).tolist()
        w = whole(got, mesh)["position"]
        res["mean_got"] = w.mean(dim=0).tolist()
        res["std_got"] = w.std(dim=0).tolist()
        res["finite"] = bool(torch.isfinite(w).all())
        res["accept_got"] = float(got_out["accept_rate"])
        return res

    for name, kernel, flags, chunk in [("rwm", "rwm", (True, True, False), 200),
                                       ("mala_rescue", "mala", (True, True, True), 200),
                                       ("hmc", "hmc", (True, True, True), 40),
                                       ("chees", "chees", (True, True, True), 40),
                                       ("stretch", "stretch", (True, True, False), 40),
                                       ("demc", "demc", (True, True, False), 40),
                                       ("slice", "slice", (True, True, False), 20)]:
        report["cases"][name] = chunk_case(kernel, flags, chunk)
        report["cases"][name]["chunk"] = chunk
    # block-diagonal proposals (two blocks of one): the ensemble refresh
    for name, kernel, flags in [("blocked_rwm", "rwm", (True, True, False)),
                                ("blocked_mala", "mala", (True, True, True))]:
        report["cases"][name] = chunk_case(kernel, flags, 40, block_hyper=0,
                                           block_local=1, block_count=2)
        report["cases"][name]["chunk"] = 40

    # Verbs that read the whole ensemble in one process refuse a shard.
    refused = {}
    sw = line_walker().shard(mesh)
    for verb, call in [("tempered_steps", lambda: sw.tempered_steps(400, rungs=4)),
                       ("walker_save", lambda: mfit.walker_save(sw, os.devnull)),
                       ("advi", lambda: sw.advi()),
                       ("smc_sample", lambda: sw.smc_sample({"m": (0, 4), "b": (-2, 4)}))]:
        try:
            call()
            refused[verb] = ""
        except ValueError as e:
            refused[verb] = str(e)
    report["refused"] = refused

    # JAX's draws injected: the rwm chunk from JAX's start state.
    jax_in = os.path.join(outdir, "jax_in.npz")
    if os.path.exists(jax_in):
        arrays = dict(np.load(jax_in))
        st, _ = state_from_numpy(arrays, dtype=f64, device="cpu")
        w = line_walker(n_walkers=arrays["position"].shape[0])
        run_m, _ = build_chunk_runner(w._log_post, w.ndim, w.config, mesh=mesh)
        got, out = run_m(shard_state(st, mesh), True, True, False,
                         noise=(torch.as_tensor(arrays["z"]), torch.as_tensor(arrays["u"])))
        full = whole(got, mesh)
        if rank == 0:
            np.savez(os.path.join(outdir, "jax_rwm.npz"),
                     **{k: v.numpy() for k, v in full.items()},
                     l_matrix=got.l_matrix.numpy(), m_sum=got.m_sum.numpy(),
                     m_outer=got.m_outer.numpy(), m_count=got.m_count.numpy(),
                     accept_rate=out["accept_rate"].numpy())

    # A sharded adaptive fit (JAX tests/test_parallel.py:183-191).
    t0 = time.perf_counter()
    w = line_walker().shard(mesh)
    w.adaptive_steps(3000, auto=None)
    best = w.most_likely_params()
    report["cases"]["adaptive_fit"] = {
        "m": best["m"], "b": best["b"], "seconds": time.perf_counter() - t0,
        "local_walkers": int(w.state.position.shape[0]),
        "history_walkers": int(w._history()[0].shape[1]),
        "acceptance": w.acceptance()}

    # A grouped BatchedNVFit that shards (JAX tests/test_parallel.py:207-230).
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    freqs = np.linspace(2840.0, 2900.0, 128)

    def spec(d1, d2):
        c = double_lorentzian_bg(torch.as_tensor(freqs), {
            "scale1": 1e-5, "scale2": 1e-5, "mu1": d1, "mu2": d2, "sigma": 10.0,
            "bg0": 1e-4})
        return freqs, np.asarray(c) + 2e-7 * rng.standard_normal(128)

    fit = mfit.nv.BatchedNVFit([spec(2858, 2876), spec(2862, 2874)],
                               walkers_per_spectrum=32, seed=0, dtype=f64, device="cpu")
    fit.shard(mesh)
    fit.adaptive_steps(1200, auto=None)
    offs = [float(v) for v in fit.field_offsets()]
    report["cases"]["batched_nv"] = {
        "offsets": offs, "local_walkers": int(fit.state.position.shape[0]),
        "seconds": time.perf_counter() - t0}

    if rank == 0:
        with open(os.path.join(outdir, "result.json"), "w") as f:
            json.dump(report, f)
    torch.distributed.barrier()
    sys.stdout.flush()
    # Leave without the group's teardown: a rank that tears down after its
    # peer (rank 0 hosts the store) has exited can abort in it.
    os._exit(0)


if __name__ == "__main__":
    main()
