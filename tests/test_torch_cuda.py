"""The port's CUDA kernels against their plain PyTorch versions (GPU only).

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels
are built with nvcc at first use) and skips without one.  The module
imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed; run it on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the fused posterior float32 at rtol 1e-4 (the fit's
equivalence probe), float64 at 1e-9, for every twin, every likelihood
kind and posteriors of several terms (``posterior_rel_err``); the chunk
kernel, with a dense L, at >= 99 % of walkers agreeing in accept count
and position (rtol 1e-4), because a 1-ulp difference of logf/cosf can
flip a near-tie accept, and its moments within 5e-3 of sqrt(m_ii m_jj)
(chip_smoke.MOMENT_RTOL); the chain
probe at rtol 1e-6 in float32 (the plain version rounds as the kernel
does, fma included) and 1e-12 in float64 (the kernel's DFMA rounds once
where the plain version rounds twice), with a check that the chains move
far enough for those tolerances to see a missing iteration.
"""

import numpy as np
import pytest
import torch

import lisp_mcmc_torch as tfit
from lisp_mcmc_torch import models, nv, synthetic
from lisp_mcmc_torch.models import lorder_mixed_bg
from lisp_mcmc_torch.ops import chunk_kernel as tck
from lisp_mcmc_torch.ops import loglik_kernel as tlk
from lisp_mcmc_torch.ops import microbench as tmb

# The printed reference parameters with scale x10 (see test_torch_fit.py).
FLAGSHIP = {"scale": -4.788638538682475e-5, "linewidth": 121.09571484294366,
            "x0": 2784.6836516658504, "mix": 3.141546812249173,
            "bg0": -1.0629009389997092e-6, "bg1": 2.8207485034278606e-10}
BOUNDS = {"linewidth": (1.0, 500.0), "x0": (2700.0, 2900.0), "mix": (0.0, 6.3)}
MOMENT_RTOL = 5e-3  # chip_smoke.MOMENT_RTOL

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
    post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    pos = w.state.position
    before = tlk.fused_posterior.launches
    got = tlk.fused_posterior(pos, post)
    assert tlk.fused_posterior.launches == before + 1
    want = tlk.fused_posterior_plain(pos, post)
    rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert rel <= rtol, f"fused kernel vs plain, {dtype}: {rel} > {rtol}"


def test_chunk_kernel_matches_plain(cuda):
    w = _walker(cuda, 4096, torch.float32, 1e-3)
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 4096, torch.float32)
    st = w.state
    L = synthetic.dense_l(3e-3 * np.asarray(list(FLAGSHIP.values()))).to(cuda)
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
    _moments_agree(got, ref)
    assert got["m_count"].item() == got["accept_counts"].sum().item()
    assert torch.all(got["trace_max"] >= got["trace_mean"] - 1e-3)
    assert torch.all(got["trace_mean"] >= got["trace_min"] - 1e-3)


def _agree(got, ref):
    """Share of walkers whose accept count and final position (rtol 1e-4)
    match."""
    rel = ((got["position"] - ref["position"]).abs()
           / ref["position"].abs().clamp_min(1e-30)).amax(dim=1)
    return ((got["accept_counts"] == ref["accept_counts"]) & (rel <= 1e-4)).float().mean().item()


def _moments_agree(got, ref):
    """The moments entry by entry within MOMENT_RTOL of sqrt(m_ii m_jj):
    the <= 1 % of walkers that disagree take other steps.  With a dense L
    the off-diagonal entries are of a median size above 10 MOMENT_RTOL, so
    a misplaced or dropped entry fails."""
    diag = ref["m_outer"].diagonal()
    scale = (diag[:, None] * diag[None, :]).sqrt()
    off = ~torch.eye(diag.shape[0], dtype=torch.bool, device=diag.device)
    assert (ref["m_outer"].abs() / scale)[off].median().item() >= 10 * MOMENT_RTOL
    assert bool(((got["m_outer"] - ref["m_outer"]).abs() <= MOMENT_RTOL * scale).all())
    torch.testing.assert_close(got["m_outer"], got["m_outer"].T)


@pytest.mark.parametrize("n_datasets,n_points", [(2, 334), (5, 334), (2, 1500)])
def test_chunk_kernel_several_terms_matches_plain(cuda, n_datasets, n_points):
    """The global fit: d = 9 runs the d <= 16 register variant, d = 18 the
    runtime-d one; 1500 points are more than one tile, and are staged tile
    by tile every step."""
    g = synthetic.global_fit(n_datasets, n_points=n_points)
    w = tfit.walker_create(function=g["functions"], data=g["data"], params=g["truth"],
                           data_error=1e-7, n_walkers=4096, walker_jitter=1e-3,
                           device=cuda)
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 4096, torch.float32)
    assert tck.data_resident(ck.post) == (n_points <= tck.TILE)
    st = w.state
    L = synthetic.dense_l(3e-3 * np.asarray(list(g["truth"].values()))).to(cuda)
    args = (st.position, st.logprob, st.best_position, st.best_logprob, L,
            1000, 0.0, torch.tensor([7], dtype=torch.int32, device=cuda))
    got = tck.chunk_rwm(ck, *args)
    ref = tck.chunk_rwm_plain(ck, *args)
    assert _agree(got, ref) >= 0.99
    assert 0.05 < got["accept_counts"].mean().item() / ck.chunk < 0.95
    _moments_agree(got, ref)


_LIKELIHOODS = {"normal": tfit.log_likelihood_normal,
                "normal_cutoff": tfit.log_likelihood_normal_cutoff,
                "poisson": tfit.log_likelihood_poisson}


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
@pytest.mark.parametrize("optional", [True, False])
@pytest.mark.parametrize("model", sorted(models.DEVICE_MODELS, key=lambda f: f.__name__),
                         ids=lambda f: f.__name__)
def test_every_twin_matches_plain(cuda, model, optional, dtype, rtol):
    """Every kind the model takes, Poisson on counts; ``posterior_rel_err``
    is not fooled by a log-normalisation that cancels the misfit."""
    for kind in synthetic.twin_case(model, optional)[3]:
        x, y, params, _ = synthetic.twin_case(model, optional)
        if kind == "poisson":
            y = np.round(np.abs(y))
        w = tfit.walker_create(function=model, data=(x, y), params=params,
                               data_error=0.01 * np.abs(y).max(),
                               log_likelihood=_LIKELIHOODS[kind], n_walkers=1000,
                               walker_jitter=0.02, dtype=dtype, device=cuda)
        post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
        assert post is not None
        got = tlk.fused_posterior(w.state.position, post)
        want = tlk.fused_posterior_plain(w.state.position, post)
        rel = tlk.posterior_rel_err(got, want, post)
        assert rel <= rtol, f"{model.__name__} {kind} {dtype}: {rel} > {rtol}"


def test_fused_kernel_several_terms_and_priors_match_plain(cuda):
    """[gaussian_peak, line] with per-term bounds, the global pair and an NV
    fit, whose constraints run in torch beside the kernel; some walkers
    sit outside the bounds or break the constraints."""
    rng = np.random.default_rng(2)
    x = np.linspace(-5.0, 5.0, 40)
    fits = [dict(function=[models.gaussian_peak, models.line],
                 data=[(x, np.exp(-0.5 * x ** 2) + 0.01 * rng.standard_normal(40)),
                       (x, 3.0 * x - 0.5 + 0.05 * rng.standard_normal(40))],
                 params={"scale": 1.0, "x0": 0.0, "sigma": 1.0, "m": 3.0, "b": -0.5},
                 data_error=[0.01, 0.05], walker_jitter=1.0,
                 log_prior=[tfit.make_bounds_prior({"scale": (0.1, 10.0),
                                                   "sigma": (0.1, 5.0)}), None])]
    g = synthetic.global_fit(2)
    fits.append(dict(function=g["functions"], data=g["data"], params=g["truth"],
                     data_error=1e-7, walker_jitter=0.01))
    xs, ys = synthetic.nv_spectra()
    fits.append(dict(function=models.double_lorentzian_bg, data=(xs, ys[0]),
                     params=nv.guess_nv_params(ys[0]), data_error=nv.nv_data_std_dev(ys[0]),
                     log_prior=nv.make_nv_prior(ys[0]), walker_jitter=0.005))
    for kw in fits:
        for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
            w = tfit.walker_create(n_walkers=1000, dtype=dtype, device=cuda, **kw)
            post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
            got = tlk.fused_posterior(w.state.position, post)
            want = w._log_post(w.state.position)
            rel = tlk.posterior_rel_err(got, want, post)
            assert rel <= rtol, (kw["function"], dtype, rel)
            assert "log_prior" not in kw or bool((want < -1e4).any())


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
