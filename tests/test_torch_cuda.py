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
flip a near-tie accept, their logprob and best logprob at 1e-4 and their
best points for 99 % of them, every best point at its best logprob,
its moments within 5e-3 of sqrt(m_ii m_jj) (chip_smoke.MOMENT_RTOL) and
its trace within 1e-4 (``chunk_kernel.chunk_diff``), at every d from 1
to 64 and on tiled data; the
NV prior's declared constraints in both kernels, -1e9 exactly where the
plain version puts it; a named prior (``synthetic.flagship_prior_spec``,
and an ``MVGaussian`` over three parameters) as declared walls and
densities in both kernels, with walkers past every wall and at a
LogNormal's x <= 0, at the same tolerances; the chain
probe at rtol 1e-6 in float32 (the plain version rounds as the kernel
does, fma included) and 1e-12 in float64 (the kernel's DFMA rounds once
where the plain version rounds twice), with a check that the chains move
far enough for those tolerances to see a missing iteration; nested
sampling's refills on kernel 1 (its launches, a float64 run against the
plain posterior's within 0.05 in log Z), kernel 1 at the profile's W =
168 and the full-width refills' W = 32768, and no kernel launch inside
the refit cross-validation and ``nested_per_dataset``; ADVI's evaluation
draws on kernel 1 (W = 2048) against the plain posterior, and a float64
``flow_advi`` on the card against the same run on the CPU on the same
draws (rtol 1e-8 on the ELBO trace); the hierarchical posterior of the
pooling phase's shape (8 spectra x 334 points, d = 54) in float32 on the
card against float64 on the CPU (1e-4 of max(|lp|, 1)), launching
neither kernel, and kernel 1 at ``compare_pooling``'s pooled 8-term shape
(W = 8192) against its plain version; ``HierarchicalFit.logo`` on the
card (float64) against the closed-form new-group predictive of a
conjugate hierarchy (JAX tests/test_hierarchical.py:488-519, its
tolerances); a checkpoint of a flagship walker saved on the card mid-run
resuming bit for bit on kernel 1 and on the chunk kernel; the plots'
envelope (``plotting._fit_envelope``, one batched model evaluation on the
card) against its float64 CPU evaluation; a one-rank NCCL group's sharded
rwm chunk bit for bit equal to the unsharded one.
"""

import dataclasses

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
# Of the agreeing walkers, the share whose best point matches: a near tie
# of a new logprob with the best flips the best-tracking test; at W = 4096
# and d = 1 that took 0.12 % of them on an H100 (chip_smoke holds 131072
# walkers to 0.999).  A stale or misplaced best point fails
# best_self_rel_err instead.
BEST_AGREEMENT = 0.99
TRACE_RTOL = 1e-4  # chip_smoke.TRACE_RTOL
TRACE_LAST_RTOL = 1e-5  # chip_smoke.TRACE_LAST_RTOL

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
    _agree(got, ref, ck.post)
    assert torch.all(got["trace_max"] >= got["trace_mean"] - 1e-3)
    assert torch.all(got["trace_mean"] >= got["trace_min"] - 1e-3)


def _agree(got, ref, post):
    """chip_smoke._chunk_check's gates but the acceptance's
    (``chunk_kernel.chunk_diff``): >= 99 % of walkers agree in accept
    count and final position (rtol 1e-4); on those, logprob and best
    logprob within 1e-4 (``posterior_rel_err``) and the best point for
    BEST_AGREEMENT of them; every best point gives its best logprob, no
    lower than the logprob; the moments within MOMENT_RTOL; the trace
    within TRACE_RTOL and its last step TRACE_LAST_RTOL from the final
    logprob's.  With a dense L the off-diagonal moments are of a median
    size above 10 MOMENT_RTOL, so a misplaced or dropped entry fails."""
    diff = tck.chunk_diff(got, ref, post)
    assert diff["walker_agreement"] >= 0.99, diff
    for k in ("logprob_rel_err", "best_logprob_rel_err", "best_self_rel_err"):
        assert diff[k] <= 1e-4, (k, diff)
    assert diff["best_below"] == 0, diff
    assert diff["best_agreement"] >= BEST_AGREEMENT, diff
    if diff["moments_offdiag_median"] is not None:
        assert diff["moments_offdiag_median"] >= 10 * MOMENT_RTOL, diff
    assert diff["msum_err"] <= MOMENT_RTOL and diff["mouter_err"] <= MOMENT_RTOL, diff
    torch.testing.assert_close(got["m_outer"], got["m_outer"].T)
    assert got["m_count"].item() == got["accept_counts"].sum().item()
    assert diff["trace_rel_err"] <= TRACE_RTOL, diff
    assert diff["trace_last_err"] <= TRACE_LAST_RTOL, diff


@pytest.mark.parametrize("n_datasets,n_points", [(2, 334), (5, 334), (2, 1500)])
def test_chunk_kernel_several_terms_matches_plain(cuda, n_datasets, n_points):
    """The global fit at d = 9 and d = 18; 1500 points are more than one
    tile, and are staged tile by tile every step."""
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
    _agree(got, ref, ck.post)
    assert 0.05 < got["accept_counts"].mean().item() / ck.chunk < 0.95


def _poly_fit(d, n_points=60, seed=0):
    """A fit of d polynomial coefficients: terms of up to 16 coefficients
    each (the later ones ``models.renamed``), on x in [-1, 1], sigma 0.05.
    The coefficients are 1-2 / (j + 1) in size, of either sign, so no
    walker's position nears 0, where the check's relative tolerance would
    see nothing but the size of the number."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, n_points)
    sizes = [16] * (d // 16) + ([d % 16] if d % 16 else [])
    fns, data, params = [], [], {}
    for k, m in enumerate(sizes):
        names = {f"c{j}": (f"c{j}" if k == 0 else f"t{k}c{j}") for j in range(m)}
        coef = rng.choice([-1.0, 1.0], m) * (1.0 + rng.uniform(size=m)) / (1.0 + np.arange(m))
        y = np.polynomial.polynomial.polyval(x, coef) + 0.05 * rng.standard_normal(n_points)
        fns.append(models.polynomial if k == 0 else models.renamed(models.polynomial, names))
        data.append((x, y))
        params.update({names[f"c{j}"]: float(coef[j]) for j in range(m)})
    return fns, data, params


@pytest.mark.parametrize("d", [1, 6, 8, 9, 16, 17, 18, 64])
def test_chunk_kernel_every_d_matches_plain(cuda, d):
    """One kernel for every d <= 64 (the block size follows from d:
    ``chunk_plan``), against the plain stepper on polynomial fits."""
    fns, data, params = _poly_fit(d)
    w = tfit.walker_create(function=fns, data=data, params=params, data_error=0.05,
                           n_walkers=4096, walker_jitter=1e-3, device=cuda)
    assert w.ndim == d
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 4096, torch.float32)
    plan = tck.chunk_plan(ck, 4096)
    assert plan["threads"] in (128, 256) and plan["blocks_per_sm"] >= 1
    assert plan["blocks"] * plan["threads"] >= 4096
    st = w.state
    L = synthetic.dense_l(5e-3 * np.abs(np.asarray(list(params.values())))).to(cuda)
    args = (st.position, st.logprob, st.best_position, st.best_logprob, L,
            1000, 0.0, torch.tensor([7], dtype=torch.int32, device=cuda))
    got = tck.chunk_rwm(ck, *args)
    ref = tck.chunk_rwm_plain(ck, *args)
    _agree(got, ref, ck.post)
    assert 0.05 < got["accept_counts"].mean().item() / ck.chunk < 0.95
    assert ck.plans[4096] == plan  # the launch took the kept plan


def _nv_walker(device, n_walkers, dtype, jitter):
    xs, ys = synthetic.nv_spectra()
    return nv.nv_walker((xs, ys[1]), n_walkers=n_walkers, walker_jitter=jitter,
                        dtype=dtype, device=device)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
def test_fused_kernel_nv_constraints_match_plain(cuda, dtype, rtol):
    """Walkers with mu1 and mu2 swapped, scale2 near 0 or exactly 0: the
    kernel's -1e9 penalties fall exactly where the plain version's do."""
    w = _nv_walker(cuda, 1000, dtype, 0.01)
    post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    assert post.rest == () and len(post.constraints) == 3
    i = w.spec.index
    pos = w.state.position.clone()
    pos[::4, [i("mu1"), i("mu2")]] = pos[::4, [i("mu2"), i("mu1")]]
    pos[1::4, i("scale2")] = 1e-30
    pos[2::8, i("scale2")] = 0.0
    pos[6::8, [i("scale1"), i("scale2")]] = 0.0
    got = tlk.fused_posterior(pos, post)
    want = tlk.fused_posterior_plain(pos, post)
    assert tlk.posterior_rel_err(got, want, post) <= rtol
    broken = want < -5e8
    assert bool(torch.equal(got < -5e8, broken)) and 0.5 < broken.float().mean().item() < 1
    # the penalties alone: -1e9 per failed entry, whatever the likelihood
    cons = tlk.constraints_plain(pos, post.constraints)
    assert bool(torch.equal(((got - want).abs() < 1e4) & broken, broken))
    assert set(cons.unique().tolist()) >= {0.0, -1e9, -2e9}


def test_chunk_kernel_nv_constraints_match_plain(cuda):
    """The NV fit's chunk (d = 6, 401 points, its bounds and constraints)
    against the plain stepper, from spectrum 2's parameters with scale1 /
    scale2 = 1.08: proposals cross the 0.9-1.1 window and must be refused."""
    xs, ys = synthetic.nv_spectra()
    start = {**synthetic.NV_SPECTRA[1], "scale1": 1.08 * synthetic.NV_SPECTRA[1]["scale2"]}
    w = tfit.walker_create(function=models.double_lorentzian_bg, data=(xs, ys[1]),
                           params=start, data_error=nv.nv_data_std_dev(ys[1]),
                           log_prior=nv.make_nv_prior(ys[1]), n_walkers=4096,
                           walker_jitter=2e-4, device=cuda)
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 4096, torch.float32)
    assert ck is not None and len(ck.post.constraints) == 3
    st = w.state
    # about one posterior standard deviation of scale1, scale2, mu1, mu2,
    # sigma and bg0 each
    L = synthetic.dense_l([1.3e-4, 1.3e-4, 0.1, 0.1, 0.1, 5e-5]).to(cuda)
    args = (st.position, st.logprob, st.best_position, st.best_logprob, L,
            1000, 0.0, torch.tensor([7], dtype=torch.int32, device=cuda))
    got = tck.chunk_rwm(ck, *args)
    ref = tck.chunk_rwm_plain(ck, *args)
    _agree(got, ref, ck.post)
    assert 0.05 < got["accept_counts"].mean().item() / ck.chunk < 0.95
    cols = {k: got["position"][:, j] for j, k in enumerate(w.spec.keys)}
    assert bool((nv._nv_constraints(cols, None, None) == 0).all())
    ratio = cols["scale1"] / cols["scale2"]
    assert ratio.max().item() > 1.095, "the walkers never neared the ratio's edge"


def _mv_gaussian():
    """An MVGaussian over (linewidth, x0, mix) about the flagship's values
    with correlations (seeded), as a fit's covariance would give it."""
    keys = ("linewidth", "x0", "mix")
    a = np.random.default_rng(3).standard_normal((3, 3))
    c = a @ a.T + np.eye(3)
    c = c / np.sqrt(np.outer(np.diag(c), np.diag(c)))
    s = np.array([5.0, 2.0, 0.05])
    return tfit.MVGaussian({k: FLAGSHIP[k] for k in keys}, c * np.outer(s, s))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
@pytest.mark.parametrize("prior", ["spec", "mv_gaussian"])
def test_fused_kernel_named_prior_matches_plain(cuda, prior, dtype, rtol):
    """The named prior as kernel 1's declared table: one launch, nothing
    left for torch, the walls and densities where the plain version puts
    them, at walkers past every wall and at a LogNormal's x <= 0."""
    spec = synthetic.flagship_prior_spec() if prior == "spec" else _mv_gaussian()
    w = _walker(cuda, 1000, dtype, 0.05, log_prior=spec)
    post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    assert post.rest == () and len(post.densities) == (3 if prior == "spec" else 1)
    pos = synthetic.prior_edge_walkers(w.state.position, w.spec.keys)
    before = tlk.fused_posterior.launches
    got = tlk.fused_posterior(pos, post)
    assert tlk.fused_posterior.launches == before + 1
    want = tlk.fused_posterior_plain(pos, post)
    assert tlk.posterior_rel_err(got, want, post) <= rtol
    assert bool(torch.isfinite(got).all())
    # the walkers past a wall are where the plain version puts them
    assert bool(torch.equal(got < -1e4, want < -1e4))


@pytest.mark.parametrize("prior", ["spec", "mv_gaussian"])
def test_chunk_kernel_named_prior_matches_plain(cuda, prior):
    """A 200-step chunk with the named prior's table against the plain
    stepper (chunk_diff's gates), from the generating parameters as the
    other chunk checks start.  Walkers past a wall or at the LogNormal's
    x <= 0 are held by kernel 1's check, at fixed points: in a chunk they
    move where the posterior is so steep that float32 rounding apart
    (expf against torch's exp in the reference's wall ``-1e10 (exp(1e-5
    d) - 1)``, good to ~1e-3 of itself just past an edge; the sums' order)
    reaches 1.6e-4 to 2.7e-4 of it on an H100."""
    spec = synthetic.flagship_prior_spec() if prior == "spec" else _mv_gaussian()
    w = _walker(cuda, 4096, torch.float32, 1e-3, log_prior=spec)
    assert tck.chunk_coverage(w.terms, w.spec, w.config, 4096, torch.float32) is None
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 4096, torch.float32)
    st = w.state
    L = synthetic.dense_l(3e-3 * np.asarray(list(FLAGSHIP.values()))).to(cuda)
    args = (st.position, st.logprob, st.best_position, st.best_logprob, L, 1000, 0.0,
            torch.tensor([7], dtype=torch.int32, device=cuda))
    got = tck.chunk_rwm(ck, *args)
    ref = tck.chunk_rwm_plain(ck, *args)
    _agree(got, ref, ck.post)


def test_swap_data_rebuilds_kernel_1_on_the_new_data(cuda):
    """The walker keeps kernel 1's closure (its data packed); swap_data
    drops it, and the next evaluation launches kernel 1 on the new data."""
    from lisp_mcmc_torch.data import Dataset

    w = _walker(cuda, 1024, torch.float32, 0.02,
                config=tfit.FitConfig(posterior_impl="kernel"))
    old = w._batched_posterior()
    x = np.linspace(2000.0, 3600.0, 334)
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in FLAGSHIP.items()}
    p["x0"] = p["x0"] + 40.0
    y = lorder_mixed_bg(torch.tensor(x), p).numpy()
    w.swap_data([Dataset.create(x, y, 1e-7, dtype=torch.float32, device=cuda)])
    new = w._batched_posterior()
    assert new is not old
    pos = w.state.position
    before = tlk.fused_posterior.launches
    got = new(pos)
    assert tlk.fused_posterior.launches == before + 1
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float32)
    assert tlk.posterior_rel_err(got, w._eval_batch(pos), post) <= 1e-4
    assert tlk.posterior_rel_err(old(pos), w._eval_batch(pos), post) > 1e-2


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
    fit, whose declared constraints run in the kernel; some walkers sit
    outside the bounds or break the constraints."""
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


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
@pytest.mark.parametrize("layout", ["half", "grouped_half"])
def test_fused_kernel_on_half_ensembles_matches_plain(cuda, layout, dtype, rtol):
    """Kernel 1 on what the red-black samplers give it: the low half of
    the ensemble (a contiguous slice) and the low halves of 8 groups,
    flattened (a copy)."""
    w = _walker(cuda, 4096, dtype, 0.05)
    post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    pos = w.state.position
    x = pos[:2048] if layout == "half" else pos.reshape(8, 512, 6)[:, :256].reshape(-1, 6)
    assert x.shape == (2048, 6) and x.is_contiguous()
    got = tlk.fused_posterior(x, post)
    rel = tlk.posterior_rel_err(got, tlk.fused_posterior_plain(x, post), post)
    assert bool(torch.isfinite(got).all()) and rel <= rtol, rel


def test_new_paths_take_the_kernel_on_cuda(cuda):
    """stretch, demc, slice and tempering launch kernel 1 once per
    posterior evaluation of their runners (plus the fit's probe)."""
    w = _walker(None, 1024, torch.float32, 1e-3)
    before = tlk.fused_posterior.launches
    for kind in ("stretch", "demc", "slice"):
        w.sampling_steps(200, kernel=kind)
    w.tempered_steps(400, rungs=4)
    assert w.posterior_evals >= 2 * 600 + 400
    assert tlk.fused_posterior.launches - before == w.posterior_evals + 1


def test_gradient_path_is_plain_and_the_rescue_runs_kernel_1(cuda):
    """Under ``"auto"`` on CUDA a mala fit differentiates the plain
    posterior (no kernel-1 launch inside a gradient evaluation, as the JAX
    package keeps its gradient samplers off Pallas) and its rescue's two
    half-rounds a chunk launch kernel 1 at W/2."""
    w = _walker(None, 1024, torch.float32, 1e-3)
    real, inside, calls = w._log_post, [0], [0]

    def watched(x):
        before = tlk.fused_posterior.launches
        out = real(x)
        inside[0] += tlk.fused_posterior.launches - before
        calls[0] += x.requires_grad        # a gradient evaluation (not the probe)
        return out

    w._log_post = watched
    before = tlk.fused_posterior.launches
    w.sampling_steps(400, kernel="mala")
    assert calls[0] == w.gradient_evals == 2 * 201 and inside[0] == 0
    assert w.posterior_evals == 2 * 2                   # two half-rounds a chunk
    assert tlk.fused_posterior.launches - before == w.posterior_evals + 1   # + the probe
    assert torch.isfinite(w.state.logprob).all()


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


# ---- kernel 1's launch plans: every (R, S) at two block sizes

PLAN_THREADS = (128, 256)
PLAN_RS = ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4), (4, 1), (4, 2), (4, 4))


def _plan_fit(name, device, dtype, n_walkers):
    """The fits the plans are held on: the flagship (one term), the global
    fit of three datasets under the cutoff likelihood (one twin, three
    terms), a Poisson line and the NV fit (bounds and declared
    constraints in the kernel); some walkers far out."""
    if name == "one_term":
        return _walker(device, n_walkers, dtype, 0.05,
                       log_prior=tfit.make_bounds_prior(BOUNDS))
    if name == "three_term_cutoff":
        g = synthetic.global_fit(3)
        return tfit.walker_create(function=g["functions"], data=g["data"],
                                  params=g["truth"], data_error=1e-7,
                                  log_likelihood=tfit.log_likelihood_normal_cutoff,
                                  n_walkers=n_walkers, walker_jitter=0.02, dtype=dtype,
                                  device=device)
    if name == "poisson":
        x = np.linspace(0.0, 4.0, 90)
        y = np.random.default_rng(4).poisson(lam=5.0 + 2.0 * x).astype(float)
        return tfit.walker_create(function=models.line, data=(x, y),
                                  params={"m": 2.0, "b": 5.0},
                                  log_likelihood=tfit.log_likelihood_poisson,
                                  n_walkers=n_walkers, walker_jitter=0.05, dtype=dtype,
                                  device=device)
    return _nv_walker(device, n_walkers, dtype, 0.01)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
@pytest.mark.parametrize("W", [1, 255, 4097, 65536])
@pytest.mark.parametrize("fit", ["one_term", "three_term_cutoff", "poisson", "nv"])
def test_fused_kernel_every_plan_matches_plain(cuda, fit, W, dtype, rtol):
    """Kernel 1 at every forced (threads, R, S) against its plain version:
    a ragged last block (W = 255, 4097), a single walker, the red-black
    half width."""
    w = _plan_fit(fit, cuda, dtype, W)
    post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    assert post is not None and post.rest == ()
    pos = w.state.position
    want = tlk.fused_posterior_plain(pos, post)
    for threads in PLAN_THREADS:
        for R, S in PLAN_RS:
            plan = tlk.fused_plan(post, W, force=(threads, R, S))
            assert (plan["threads"], plan["R"], plan["S"]) == (threads, R, S)
            assert plan["blocks"] * threads // S * R >= W
            got = tlk.fused_posterior(pos, post, force=(threads, R, S))
            assert got.shape == (W,) and bool(torch.isfinite(got).all())
            rel = tlk.posterior_rel_err(got, want, post)
            assert rel <= rtol, f"{fit} W={W} {dtype} plan {plan}: {rel} > {rtol}"


def test_fused_kernel_mixed_twins_run_one_at_a_time(cuda):
    """A launch whose terms mix twins runs the kernel that picks each
    term's twin at run time: R = 1 at every S; R = 2 has no plan."""
    rng = np.random.default_rng(2)
    x = np.linspace(-5.0, 5.0, 700)  # the gaussian term staged in two tiles in float64
    w = tfit.walker_create(
        function=[models.gaussian_peak, models.line],
        data=[(x, np.exp(-0.5 * x ** 2) + 0.01 * rng.standard_normal(700)),
              (x, 3.0 * x - 0.5 + 0.05 * rng.standard_normal(700))],
        params={"scale": 1.0, "x0": 0.0, "sigma": 1.0, "m": 3.0, "b": -0.5},
        data_error=[0.01, 0.05], walker_jitter=0.1, n_walkers=4097,
        dtype=torch.float64, device=cuda)
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float64)
    want = tlk.fused_posterior_plain(w.state.position, post)
    assert tlk.fused_plan(post, 4097)["twin_class"] == 15
    for S in (1, 2, 4):
        got = tlk.fused_posterior(w.state.position, post, force=(128, 1, S))
        assert tlk.posterior_rel_err(got, want, post) <= 1e-9
    with pytest.raises(RuntimeError, match="fused_plan"):
        tlk.fused_plan(post, 4097, force=(128, 2, 1))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
@pytest.mark.parametrize("n_coef", [1, 4, 5, 8, 9, 16])
def test_polynomial_classes_match_plain(cuda, n_coef, dtype, rtol):
    """The polynomial held in 4, 8 or 16 coefficient registers, at each
    class's edges, every R."""
    fns, data, params = _poly_fit(n_coef)
    w = tfit.walker_create(function=fns, data=data, params=params, data_error=0.05,
                           n_walkers=4097, walker_jitter=1e-3, dtype=dtype, device=cuda)
    post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    want_class = 13 if n_coef <= 4 else 14 if n_coef <= 8 else 3
    want = tlk.fused_posterior_plain(w.state.position, post)
    for R in (1, 2, 4):
        plan = tlk.fused_plan(post, 4097, force=(None, R, None))
        assert plan["twin_class"] == want_class
        got = tlk.fused_posterior(w.state.position, post, force=(None, R, None))
        assert tlk.posterior_rel_err(got, want, post) <= rtol, (n_coef, R)


@pytest.mark.parametrize("force", [None, (256, 4, 4), (128, 2, 2)])
def test_fused_kernel_is_bit_identical_run_to_run(cuda, force):
    w = _walker(cuda, 65536, torch.float32, 0.05)
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float32)
    a = tlk.fused_posterior(w.state.position, post, force=force)
    b = tlk.fused_posterior(w.state.position, post, force=force)
    assert torch.equal(a, b)


def test_fused_posterior_is_one_launch_with_the_constant(cuda):
    """The scalar constant is added in the kernel: one CUDA kernel a call
    (counted by torch.profiler), and the result is the plain version's,
    constant included."""
    from torch.profiler import ProfilerActivity, profile

    w = _walker(cuda, 4096, torch.float32, 0.05, log_prior=tfit.make_bounds_prior(BOUNDS))
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float32)
    assert post.rest == () and float(post.scalar_const) != 0.0
    pos = w.state.position
    tlk.fused_posterior(pos, post)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tlk.fused_posterior(pos, post)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "fused_posterior" in kernels[0].name, \
        [e.name for e in kernels]
    want = tlk.fused_posterior_plain(pos, post)
    assert tlk.posterior_rel_err(got, want, post) <= 1e-4


@pytest.mark.parametrize("W", [65536, 131072])
def test_fused_plan_fills_a_wave(cuda, W):
    """The flagship's plan at the red-black half width and the full one:
    a wave of blocks on every SM at 32 resident warps or more.  A wave
    here is within one block an SM of full (65536 walkers in blocks of
    128 give 512 blocks for the 528 the H100's SMs hold at 4 each)."""
    w = _walker(cuda, 1024, torch.float32, 0.05)
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float32)
    plan = tlk.fused_plan(post, W)
    per_sm = -(-plan["blocks"] // plan["sms"])
    assert plan["blocks"] >= plan["sms"] * (plan["blocks_per_sm"] - 1), plan
    assert min(per_sm, plan["blocks_per_sm"]) * plan["threads"] // 32 >= 32, plan
    assert plan["blocks"] * plan["threads"] // plan["S"] * plan["R"] >= W
    assert tlk.fused_plan(post, W) == plan and (W, None, None, None) in post.plans


def _line_walker(device, n_walkers, **kw):
    """``synthetic.line_evidence_case`` (a line under a box prior) as a fit."""
    c = synthetic.line_evidence_case()
    w = tfit.walker_create(function=models.line, data=(c["x"], c["y"]),
                           params=c["truth"], data_error=c["sigma"],
                           log_prior=tfit.make_bounds_prior(c["bounds"]),
                           n_walkers=n_walkers, walker_jitter=0.05, device=device, **kw)
    return w, c


def test_evidence_paths_take_kernel_1(cuda):
    """``log_evidence`` launches kernel 1 once a ladder step, once for the
    fit's probe and once for the prior-MC closure; ``smc_sample`` once for
    its box draws and once a move step; kernel 1 agrees with its plain
    version on the ladder's ensemble, on the closure's box draws and on
    the SMC particles."""
    w, c = _line_walker(cuda, 4096)
    before = tlk.fused_posterior.launches
    res = w.log_evidence(n_steps=2000, rungs=8, t_max=1e4)
    assert w.posterior_evals == 2000
    assert tlk.fused_posterior.launches - before == 2000 + 2
    assert abs(res.log_z - c["log_z"]) < 1.0, (res, c["log_z"])
    post = tlk.prepare_fused_terms(w.terms, w.spec, torch.float32)
    box = torch.rand((4096, 2), device=cuda) * torch.tensor([12.0, 8.0], device=cuda) \
        + torch.tensor([-4.0, -3.0], device=cuda)
    for pos in (w.state.position, box):
        got = tlk.fused_posterior(pos, post)
        assert tlk.posterior_rel_err(got, tlk.fused_posterior_plain(pos, post), post) <= 1e-4
    before, evals = tlk.fused_posterior.launches, w.posterior_evals
    out = w.smc_sample(c["bounds"], n_move=200, target_moves=None)
    assert tlk.fused_posterior.launches - before == 1 + (w.posterior_evals - evals)
    assert w.posterior_evals - evals == 200 * out.n_stages
    assert abs(out.log_z - c["log_z"]) < 1.0, (out, c["log_z"])
    pos = w.state.position
    got = tlk.fused_posterior(pos, post)
    assert tlk.posterior_rel_err(got, tlk.fused_posterior_plain(pos, post), post) <= 1e-4


def test_chunk_kernel_at_a_stage_temperature_matches_plain(cuda):
    """Kernel 2 with the temperature override a number (an SMC stage's
    T = 1/beta) against its plain version through ``chunk_diff``, and the
    SMC moves on ``posterior_impl="chunk_kernel"``: one kernel-2 launch a
    chunk."""
    w, c = _line_walker(cuda, 4096, config=tfit.FitConfig(posterior_impl="chunk_kernel"))
    ck = tck.build_chunk_kernel(w.terms, w.spec, w.config, 4096, torch.float32)
    st = w.state
    # a dense L with a correlation of -0.6 (the posterior's is -0.86), so the
    # off-diagonal moments are signal (their median 0.6-0.7 of sqrt(m_ii m_jj))
    L = torch.linalg.cholesky(torch.tensor([[0.09, -0.036], [-0.036, 0.04]])).to(cuda)
    for temp in (1.0, 37.5):
        args = (st.position, st.logprob, st.best_position, st.best_logprob, L, 1000, temp,
                torch.tensor([7], dtype=torch.int32, device=cuda))
        _agree(tck.chunk_rwm(ck, *args), tck.chunk_rwm_plain(ck, *args), ck.post)
    chunks = []
    before = tck.chunk_rwm.launches
    out = w.smc_sample(c["bounds"], n_move=400, target_moves=None,
                       on_stage=lambda info: chunks.append(info["chunks"]) and False)
    assert tck.chunk_rwm.launches - before == sum(chunks) == 2 * out.n_stages
    assert abs(out.log_z - c["log_z"]) < 1.0, (out, c["log_z"])


def test_nested_sample_refills_run_kernel_1(cuda):
    """``nested_sample`` on the line case at n_live = 4096: kernel 1 once
    for the initial live set and once a refill move (W = k_batch = 1024),
    plus the fit's probe; the same run on ``posterior_impl="plain"`` with
    the same draws (float64, where kernel 1 agrees with the plain version
    to ~1e-15, so the constraint decisions and the runs match) within 0.05
    in log Z; kernel 1 against its plain version at W = k_batch in float32
    and float64."""
    runs = {}
    for impl in ("auto", "plain"):
        w, c = _line_walker(cuda, 1024, dtype=torch.float64,
                            config=tfit.FitConfig(posterior_impl=impl))
        before = tlk.fused_posterior.launches
        res = w.nested_sample(c["bounds"], n_live=4096, seed=5)
        runs[impl] = (res, tlk.fused_posterior.launches - before)
        assert abs(res.log_z - c["log_z"]) <= max(0.25, 4 * res.log_z_err), (res, c["log_z"])
    (a, la), (p, lp) = runs["auto"], runs["plain"]
    assert la == 1 + 1 + a.n_iter * (8 * 2 + 16) and lp == 0
    assert abs(a.log_z - p.log_z) < 0.05
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
        w, c = _line_walker(cuda, 1024, dtype=dtype)
        post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
        pos = torch.as_tensor(a.samples[-1024:], dtype=dtype, device=cuda)
        got = tlk.fused_posterior(pos, post)
        assert tlk.posterior_rel_err(got, tlk.fused_posterior_plain(pos, post), post) <= rtol


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
@pytest.mark.parametrize("W", [168, 32768])
def test_fused_kernel_at_profile_and_refill_widths(cuda, W, dtype, rtol):
    """Kernel 1 at the profile likelihood's W = 21 x 8 = 168 rows and the
    full-width nested refills' W = 32768, on the flagship and the line."""
    for w in (_walker(cuda, W, dtype, 0.02), _line_walker(cuda, W, dtype=dtype)[0]):
        post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
        pos = w.state.position
        got = tlk.fused_posterior(pos, post)
        assert got.shape == (W,)
        assert tlk.posterior_rel_err(got, tlk.fused_posterior_plain(pos, post), post) <= rtol


def test_profile_runs_kernel_1_and_refits_run_none(cuda):
    """``profile_likelihood``'s value-only rows launch kernel 1 (1 + rounds
    calls at W = 168; the fit's probe ran on its steps); ``kfold``'s refits and
    ``nested_per_dataset`` launch no kernel (per-walker aux: plain)."""
    w, c = _line_walker(cuda, 1024)
    w.adaptive_steps(2000, auto=None)
    before = tlk.fused_posterior.launches
    prof = w.profile_likelihood("m")
    assert tlk.fused_posterior.launches - before == 1 + 2
    assert prof.grid[0] < prof.at_max < prof.grid[-1]
    before = (tlk.fused_posterior.launches, tck.chunk_rwm.launches)
    kf = tfit.kfold(w, k=3, n_steps=400, walkers_per_dataset=16)
    batch = synthetic.line_evidence_batch(3)
    bf = tfit.BatchedFit(models.line, batch["datasets"], batch["truth"],
                         data_error=batch["sigma"],
                         log_prior=tfit.make_bounds_prior(batch["bounds"]),
                         walkers_per_dataset=8, device=cuda)
    res = bf.nested_per_dataset(n_live=512)
    assert (tlk.fused_posterior.launches, tck.chunk_rwm.launches) == before
    assert np.isfinite(kf.pointwise).all()
    for r, z in zip(res, batch["log_z"]):
        assert abs(r.log_z - z) <= max(0.25, 4 * r.log_z_err)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
def test_advi_evaluation_draws_run_kernel_1(cuda, dtype, rtol):
    """``advi``'s value-only evaluation draws launch kernel 1 once, at W =
    n_eval = 2048, and agree with the plain posterior on them; the same run
    on the plain posterior (one generator stream) gives the same q and an
    evidence within the kernel's rounding."""
    from lisp_mcmc_torch import variational as tv

    w, c = _line_walker(cuda, 4096, dtype=dtype)
    w.adaptive_steps(1000, temperature=1.0, auto=None)
    fused, seen = w._runner_cache["_fused"], []
    w._runner_cache["_fused"] = lambda pos: (seen.append(pos), fused(pos))[1]
    before = tlk.fused_posterior.launches
    vi = w.advi(n_steps=300)
    assert tlk.fused_posterior.launches - before == 1
    assert [tuple(p.shape) for p in seen] == [(2048, 2)]
    post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    got = tlk.fused_posterior(seen[0], post)
    assert tlk.posterior_rel_err(got, tlk.fused_posterior_plain(seen[0], post), post) <= rtol
    w._runner_cache["_fused"] = fused
    w.config = tfit.FitConfig(posterior_impl="plain")
    plain = tv.advi(w, n_steps=300)
    np.testing.assert_array_equal(plain._mu, vi._mu)
    assert plain.log_z == pytest.approx(vi.log_z, abs=rtol * 1e3)
    assert abs(vi.log_z - c["log_z"]) < 0.2


def test_flow_advi_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """50 flow steps on the card and on the CPU, float64, from the same
    ensemble and the same draws (replayed through ``variational._draws``):
    the same ELBO trace and flow parameters."""
    from lisp_mcmc_torch import variational as tv

    rng = np.random.default_rng(0)
    draws = [rng.standard_normal((64, 2)) for _ in range(50)] + [rng.standard_normal((256, 2))]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        w, _ = _line_walker(dev, 512, dtype=torch.float64)
        pos = torch.as_tensor(np.random.default_rng(1).normal([2.0, 1.0], [0.4, 0.2],
                                                              (512, 2)), device=dev)
        w.state = dataclasses.replace(w.state, position=pos)
        queue = list(draws)
        monkeypatch.setattr(tv, "_draws", lambda g, shape, dtype, device:
                            torch.as_tensor(queue.pop(0), dtype=dtype, device=device))
        out[dev.type] = w.flow_advi(n_steps=50, n_samples=64, n_eval=256, n_layers=2,
                                    hidden=16, seed=3)
    g, c = out["cuda"], out["cpu"]
    np.testing.assert_allclose(g.elbo_trace, c.elbo_trace, rtol=1e-8)
    np.testing.assert_allclose(g._params["mu"], c._params["mu"], rtol=1e-8, atol=1e-12)
    for a, b in zip(g._params["layers"], c._params["layers"]):
        for n in a:
            np.testing.assert_allclose(a[n], b[n], rtol=1e-6, atol=1e-10)
    assert g.log_z == pytest.approx(c.log_z, rel=1e-8)


def _pooling_grid():
    """chip_smoke's pooling phase input: 8 flagship-lineshape spectra of 334
    points, the flagship model for each, test.lisp's start as the guess."""
    g = synthetic.global_fit(8)
    guess = {k: synthetic._GLOBAL_START[k] for k in FLAGSHIP}
    return g["data"], guess


def test_hierarchical_posterior_on_the_card_matches_float64(cuda):
    """The batched hierarchical posterior (d = 2*3 + 8*6 = 54 over W x 8 x
    334) in float32 on the card against float64 on the CPU at the same
    positions: relative 1e-4 of max(|lp|, 1)."""
    data, guess = _pooling_grid()
    kw = dict(data_error=1e-7, pooled=["linewidth", "x0", "mix"], n_walkers=8192, seed=0)
    g32 = tfit.HierarchicalFit(lorder_mixed_bg, data, guess, dtype=torch.float32,
                               device=cuda, **kw)
    c64 = tfit.HierarchicalFit(lorder_mixed_bg, data, guess, dtype=torch.float64,
                               device="cpu", **{**kw, "n_walkers": 16})
    assert g32.spec.ndim == 54 and g32._log_post is not None
    pos = g32.state.position[::128].double().cpu()
    got = g32._log_post(pos.to(device=cuda, dtype=torch.float32)).double().cpu()
    want = c64._log_post(pos)
    rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert rel <= 1e-4, rel
    before = (tlk.fused_posterior.launches, tck.chunk_rwm.launches)
    g32.adaptive_steps(200, auto=None)
    assert (tlk.fused_posterior.launches, tck.chunk_rwm.launches) == before


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
def test_fused_kernel_pooled_eight_terms_matches_plain(cuda, dtype, rtol):
    """compare_pooling's complete-pooling fit: the flagship model over 8
    spectra as 8 terms sharing d = 6, W = 8192, on kernel 1."""
    data, guess = _pooling_grid()
    w = tfit.walker_create(function=[lorder_mixed_bg] * 8, data=data, params=guess,
                           data_error=1e-7, n_walkers=8192, walker_jitter=0.05,
                           dtype=dtype, device=cuda)
    post = tlk.prepare_fused_terms(w.terms, w.spec, dtype)
    assert post is not None and len(post.terms) == 8
    pos = w.state.position
    before = tlk.fused_posterior.launches
    got = tlk.fused_posterior(pos, post)
    assert tlk.fused_posterior.launches == before + 1
    assert tlk.posterior_rel_err(got, tlk.fused_posterior_plain(pos, post), post) <= rtol


# the conjugate hierarchy of JAX tests/test_hierarchical.py:38-99
SIGMA, TAU, M0, S0, N_PTS = 0.4, 0.8, 1.0, 2.0, 8
YBAR = np.asarray([0.2, 1.1, 2.4, -0.6])


def _conjugate_datasets():
    """Each dataset's sample mean exactly YBAR[s]."""
    x = np.linspace(0.0, 1.0, N_PTS)
    rng = np.random.default_rng(7)
    out = []
    for ybar in YBAR:
        e = rng.standard_normal(N_PTS) * SIGMA
        out.append((x, ybar + e - e.mean()))
    return out


def _exact_logo():
    """log p(y_s | y_-s) of the tau-pinned hierarchy in closed form."""
    from scipy.stats import multivariate_normal

    v_t = TAU ** 2 + SIGMA ** 2 / N_PTS
    out = []
    for s, (_, y) in enumerate(_conjugate_datasets()):
        rest = [t for t in range(len(YBAR)) if t != s]
        prec = 1.0 / S0 ** 2 + len(rest) / v_t
        mean = (M0 / S0 ** 2 + sum(YBAR[t] for t in rest) / v_t) / prec
        cov = SIGMA ** 2 * np.eye(N_PTS) + (1.0 / prec + TAU ** 2) * np.ones((N_PTS, N_PTS))
        out.append(multivariate_normal(mean * np.ones(N_PTS), cov).logpdf(y))
    return np.asarray(out)


def test_logo_closed_form_on_the_card(cuda):
    """Leave-one-group-out CV on the card lands on the conjugate
    hierarchy's exact new-group predictive density, per dataset (JAX
    tests/test_hierarchical.py:505-519: 0.6 a group, 1.2 in all)."""
    def const_model(x, p):
        return p["c"] + 0.0 * x

    # the parent fit by rwm (JAX's by chees): it only seeds the refits'
    # starts and L, and 6000 chees steps of 96 walkers are host-paced on a card
    fit = tfit.HierarchicalFit(
        const_model, _conjugate_datasets(), {"c": 0.5}, data_error=SIGMA,
        hyper={"c": (tfit.Gaussian(M0, S0), tfit.LogNormal(float(np.log(TAU)), 0.01))},
        n_walkers=96, seed=0, dtype=torch.float64, device=cuda)
    fit.adaptive_steps(6000, auto=None)
    fit.burn_steps(4000)
    res = fit.logo(n_steps=4000, walkers_per_dataset=64, max_samples=128, n_z=64, seed=0)
    exact = _exact_logo()
    assert res.elpd_per_dataset.shape == (4,)
    np.testing.assert_allclose(res.elpd_per_dataset, exact, atol=0.6)
    assert res.elpd == pytest.approx(float(exact.sum()), abs=1.2)
    assert res.se > 0.0 and "elpd" in repr(res)


def test_checkpoint_resumes_bit_for_bit_on_the_card(cuda, tmp_path):
    """A flagship walker saved on the card mid-run, loaded and run on (200
    steps on kernel 1, then one chunk on the chunk kernel) ends where the
    uninterrupted walker does, bit for bit."""
    from lisp_mcmc_torch import checkpoint
    from lisp_mcmc_torch.roofline import synthetic_flagship

    x, y = synthetic_flagship()

    def run(w):
        w.adaptive_steps(200, auto=None)
        w.config = dataclasses.replace(w.config, posterior_impl="chunk_kernel")
        w.adaptive_steps(200, auto=None, collect_history=False)
        w.config = dataclasses.replace(w.config, posterior_impl="auto")

    w = tfit.walker_create(function=lorder_mixed_bg, data=(x, y), params=FLAGSHIP,
                           data_error=1e-7, n_walkers=4096, walker_jitter=0.05, seed=1,
                           dtype=torch.float32, device=cuda)
    w.adaptive_steps(400, auto=None)
    path = str(tmp_path / "mid.npz")
    checkpoint.walker_save(w, path)
    launches = (tlk.fused_posterior.launches, tck.chunk_rwm.launches)
    run(w)
    assert tlk.fused_posterior.launches > launches[0] and tck.chunk_rwm.launches > launches[1]
    r = checkpoint.walker_load(path, device=cuda)
    assert r.generator.device.type == "cuda"
    run(r)
    for k in ("position", "logprob", "best_position", "best_logprob", "l_matrix"):
        assert torch.equal(getattr(r.state, k), getattr(w.state, k)), k
    np.testing.assert_array_equal(r._history()[0], w._history()[0])


def test_fit_envelope_on_the_card_matches_float64(cuda):
    """``plotting._fit_envelope`` on the card (one batched (keep, grid)
    evaluation of the float32 model) against the same top samples
    evaluated in float64 on the CPU, within chip_smoke.PLOT_ENVELOPE_TOL of
    max |y| (its CPU rehearsal: 1.08e-4, the float32 model's rounding)."""
    import sys

    from lisp_mcmc_torch import plotting

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    import chip_smoke

    w = _walker(cuda, 4096, torch.float32, 0.05)
    w.adaptive_steps(2000, temperature=10.0, auto=None)
    got = plotting._fit_envelope(w, 0, 1000, 1000, 0.66)
    ref = chip_smoke.envelope_reference(w, 0, 1000, 1000, 0.66)
    scale = max(float(np.abs(r).max()) for r in ref[1:])
    err = max(float(np.abs(np.asarray(g, np.float64) - r).max())
              for g, r in zip(got[1:], ref[1:])) / scale
    assert err <= chip_smoke.PLOT_ENVELOPE_TOL
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)


def test_world_of_one_nccl_rwm_chunk_is_bit_for_bit(cuda):
    """A one-rank NCCL group runs the sharded rwm chunk's collective on the
    card and changes nothing: the chunk equals the unsharded one bit for
    bit, with one all-reduce."""
    import socket

    import torch.distributed as dist

    from lisp_mcmc_torch.kernel import build_chunk_runner
    from lisp_mcmc_torch.parallel import initialize_distributed, make_mesh, shard_state

    if not dist.is_initialized():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
                               backend="nccl", device=cuda, timeout=120)
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        pytest.skip("another process group is initialized in this process")
    mesh = make_mesh()
    w = _walker(cuda, 4096, torch.float32, 0.05)
    post = w._batched_posterior()
    run, _ = build_chunk_runner(post, w.ndim, w.config)
    run_m, _ = build_chunk_runner(post, w.ndim, w.config, mesh=mesh)
    s1, o1 = run(w.state, True, True, False,
                 generator=torch.Generator(device=cuda).manual_seed(5))
    s2, o2 = run_m(shard_state(w.state, mesh), True, True, False,
                   generator=torch.Generator(device=cuda).manual_seed(5))
    for k in ("position", "logprob", "best_position", "best_logprob", "l_matrix",
              "m_sum", "m_outer", "m_count"):
        assert torch.equal(getattr(s1, k), getattr(s2, k)), k
    assert torch.equal(o1["accept_rate"], o2["accept_rate"]) and o2["collectives"] == 1
