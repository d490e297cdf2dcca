"""The port's CUDA kernels against their plain PyTorch versions (GPU only).

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels
are built with nvcc at first use) and skips without one.  The module
imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed; run it on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the fused posterior float32 at rtol 1e-4 (the fit's
equivalence probe), float64 at 1e-9; the chunk kernel at >= 99 % of
walkers agreeing in accept count and position (rtol 1e-4), because a
1-ulp difference of logf/cosf can flip a near-tie accept; the chain
probe at rtol 1e-6 in float32 (the plain version rounds as the kernel
does, fma included) and 1e-12 in float64 (the kernel's DFMA rounds once
where the plain version rounds twice), with a check that the chains move
far enough for those tolerances to see a missing iteration.
"""

import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
from lisp_mcmc_torch.models import lorder_mixed_bg
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_torch.ops import microbench as tmb

# The printed reference parameters with scale x10 (see test_torch_fit.py).
FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
BOUNDS = {"linewidth": (1.0, 500.0), "x0": (2700.0, 2900.0), "mix": (0.0, 6.3)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the CUDA kernels with "
                    "their plain versions")
    return torch.device("cuda")


def _walker(device, n_walkers, dtype, jitter, **kw):
    x = np.linspace(2000.0, 3600.0, 334)
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in FLAGSHIP.items()}
    y = lorder_mixed_bg(torch.tensor(x), p).numpy()
    y = y + 1e-7 * np.random.default_rng(0).standard_normal(334)
    return tfit.walker_create(function=lorder_mixed_bg, data=(x, y),
                              params=FLAGSHIP, data_error=1e-7,
                              n_walkers=n_walkers, walker_jitter=jitter,
                              dtype=dtype, device=device, **kw)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
@pytest.mark.parametrize("bounded", [False, True])
def test_fused_kernel_matches_plain(cuda, dtype, rtol, bounded):
    prior = tfit.make_bounds_prior(BOUNDS) if bounded else None
    w = _walker(cuda, 1000, dtype, 0.05, log_prior=prior)  # 1000: a ragged tail
    term = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    pos = w.state.position
    before = tlk.fused_posterior.launches
    got = tlk.fused_posterior(pos, term)
    assert tlk.fused_posterior.launches == before + 1
    want = tlk.fused_posterior_plain(pos, term)
    rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert rel <= rtol, f"fused kernel vs plain, {dtype}: {rel} > {rtol}"


def test_chunk_kernel_matches_plain(cuda):
    w = _walker(cuda, 4096, torch.float32, 1e-3)
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 4096, torch.float32)
    st = w.state
    L = torch.diag(3e-3 * torch.tensor(list(FLAGSHIP.values())).abs()).to(cuda)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    args = (st.position, st.logprob, st.best_position, st.best_logprob, L,
            1000, 0.0, seed)
    before = tck.chunk_rwm.launches
    got = tck.chunk_rwm(ck, *args)
    assert tck.chunk_rwm.launches == before + 1
    ref = tck.chunk_rwm_plain(ck, *args)
    rel = ((got["position"] - ref["position"]).abs()
           / ref["position"].abs().clamp_min(1e-30)).amax(dim=1)
    agree = (got["accept_counts"] == ref["accept_counts"]) & (rel <= 1e-4)
    assert agree.float().mean().item() >= 0.99
    assert got["m_count"].item() == got["accept_counts"].sum().item()
    assert torch.all(got["trace_max"] >= got["trace_mean"] - 1e-3)
    assert torch.all(got["trace_mean"] >= got["trace_min"] - 1e-3)


def test_auto_takes_the_kernel_on_cuda(cuda):
    w = _walker(None, 1024, torch.float32, 0.05)
    before = tlk.fused_posterior.launches
    w.adaptive_steps(400, auto=None)
    assert tlk.fused_posterior.launches - before >= 400


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
def test_chain_probe_matches_plain(cuda, dtype, rtol):
    x = torch.linspace(0.5, 2.0, 1000, dtype=dtype, device=cuda)  # a ragged block

    def rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    for op in tmb.OPS:
        before = tmb.chain_probe.launches
        got = tmb.chain_probe(x, op, 4)
        assert tmb.chain_probe.launches == before + 1
        want = tmb.chain_probe_plain(x, op, 4)
        assert rel(got, want) <= rtol, f"chain probe {op} {dtype}: {rel(got, want)} > {rtol}"
        # the tolerance sees the work: the chains moved 10x it from their
        # start, and (but for exp, at its fixed point after one application)
        # more than it in the last iteration
        assert rel(tmb.chain_probe_plain(x, op, 0), want) > 10 * rtol, op
        if op != "exp":
            assert rel(tmb.chain_probe_plain(x, op, 3), want) > rtol, op


def test_chain_probe_reads_the_sm_clock(cuda):
    """Cycles over nanoseconds of the first thread: an H100's SM clock lies
    between its idle and boost clocks."""
    x = torch.ones(4096, device=cuda)
    before = tmb.chain_probe.launches
    mhz = tmb.sm_clock_mhz(x, "fma", 64)
    assert tmb.chain_probe.launches == before + 1
    assert 300 < mhz < 2500
