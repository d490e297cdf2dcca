"""The port's independence rescue against the JAX package's, draw for draw.

At each chunk end of a gradient sampler (kernel.py:1637-1876 of the JAX
package) each group's two halves in turn propose from a Student-t fitted
on the other half's typical set; an odd group size takes the
whole-ensemble fallback.  These tests start from the flagship Laplace
draw with 16 stragglers 30 sigma out, replay the JAX key stream (the
steps', then ``split(key, 7)`` or ``split(key, 4)`` at the chunk end)
through ``noise=`` and compare every state array after each of two mala
chunks of 10 steps, in float64 at rtol 1e-9: even halves ungrouped
(W = 256) and in two groups (B = 128), the odd path ungrouped (W = 255)
and in two groups (B = 127).  They also check what the rescue evaluates
(value-only, through the runner's batched posterior, on contiguous
(G * Bh, d) halves), that it brings the stragglers in, and that
irregular groups run without it, as in the JAX package.
"""

import jax
import numpy as np
import pytest
import torch

import lisp_mcmc_tpu as jfit
from lisp_mcmc_torch import kernel as tkernel
from lisp_mcmc_torch.convert import state_from_numpy
from lisp_mcmc_tpu import kernel as jkernel

from test_torch_gradient import D, arrays, compare, gradient_draws, run_pair, start_pair

CHUNK = 10
STRAGGLERS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# (walkers, groups): even halves, then the odd fallback
LAYOUTS = [(256, 1), (256, 2), (255, 1), (254, 2)]


@pytest.mark.parametrize("n_walkers,G", LAYOUTS,
                         ids=["even-ungrouped", "even-G2", "odd-ungrouped", "odd-G2"])
def test_rescue_matches_jax(n_walkers, G):
    jw, tw, st = start_pair(n_walkers, G, seed=7, stragglers=STRAGGLERS)
    lp0 = np.asarray(st.logprob)
    _, t_state, _, t_out = run_pair(jw, tw, st, "mala", G, CHUNK)
    odd = (n_walkers // G) % 2
    assert t_out["posterior_evals"] == (1 if odd else 2)
    # The stragglers cannot move under mala's huge gradients; the rescue
    # brings most of them into the typical set.
    lp = t_state.logprob.numpy()
    typical = np.median(lp0[STRAGGLERS:]) - 50.0
    assert (lp[:STRAGGLERS] > typical).mean() >= 0.5, lp[:STRAGGLERS]
    assert (lp0[:STRAGGLERS] < typical).all()


@pytest.mark.parametrize("n_walkers,G", [(256, 1), (256, 2), (255, 1)])
def test_rescue_evaluates_value_only_halves(n_walkers, G):
    """The rescue's evaluations go through ``eval_lp`` (the fused kernel
    on the GPU): two contiguous (G * Bh, d) batches a chunk, or one
    (W, d) batch for an odd group; the steps' through ``eval_plain``."""
    jw, tw, st = start_pair(n_walkers, G, seed=7, stragglers=STRAGGLERS)
    calls = []

    def eval_lp(x):
        calls.append((tuple(x.shape), x.is_contiguous(), x.requires_grad))
        return tw._log_post(x)

    plain = []

    def eval_plain(x):
        plain.append(torch.is_grad_enabled() and x.requires_grad)
        return tw._log_post(x)

    gids = np.repeat(np.arange(G), n_walkers // G) if G > 1 else None
    cfg = tkernel.FitConfig(kernel="mala", chunk_size=CHUNK)
    run, _ = tkernel.build_chunk_runner(eval_lp, D, cfg, group_ids=gids, n_groups=G,
                                        eval_plain=eval_plain)
    t_state, _ = state_from_numpy(arrays(st), dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        _, out = run(t_state, True, True, True, generator=gen)
    if n_walkers % 2:
        assert calls == [((n_walkers, D), True, False)]
    else:
        assert calls == [((n_walkers // 2, D), True, False)] * 2
    assert out["posterior_evals"] == len(calls)
    assert len(plain) == CHUNK + 1 and all(plain)
    assert out["gradient_evals"] == CHUNK + 1


def test_irregular_groups_run_without_rescue():
    """Irregular groups have no halves: no rescue, and the refresh takes
    the whole-group ensemble covariance (kernel.py:1537), as in JAX."""
    jw, tw, st = start_pair(256, 2, seed=7)
    gids = np.arange(256) % 2
    cfg_j = jfit.FitConfig(kernel="mala", chunk_size=CHUNK)
    cfg_t = tkernel.FitConfig(kernel="mala", chunk_size=CHUNK)
    j_run, _ = jkernel.build_chunk_runner(jw._log_post_one, D, cfg_j, group_ids=gids,
                                          n_groups=2, takes_data=True)
    t_run, _ = tkernel.build_chunk_runner(tw._log_post, D, cfg_t, group_ids=gids,
                                          n_groups=2)
    replay = gradient_draws("mala", cfg_t, 256, 2, CHUNK)
    t_state, _ = state_from_numpy(arrays(st), dtype=torch.float64, device="cpu")
    key = st.key
    for cold in (False, True):
        key, noise = replay(key)
        st, _ = jax.jit(j_run)(st, True, True, cold, jw._posterior_data())
        t_state, out = t_run(t_state, True, True, cold, noise=noise)
        compare(st, t_state, f"irregular mala cold={cold}")
        assert out["posterior_evals"] == 0


def test_rescue_needs_its_draws():
    jw, tw, st = start_pair(256, 1, seed=7)
    cfg = tkernel.FitConfig(kernel="mala", chunk_size=CHUNK)
    run, _ = tkernel.build_chunk_runner(tw._log_post, D, cfg)
    _, noise = gradient_draws("mala", cfg, 256, 1, CHUNK)(st.key)   # no rescue entry
    t_state, _ = state_from_numpy(arrays(st), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="rescue"):
        run(t_state, True, True, True, noise=noise)
