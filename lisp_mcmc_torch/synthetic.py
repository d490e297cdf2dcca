"""Synthetic data for the journeys past the flagship, made from a seed.

The reference's data files are not in the repository, so the global fit
of test.lisp:52-78 and the NV pipeline of nv-specific.lisp fit data
generated here with numpy (the flagship's own is
``roofline.synthetic_flagship``):

- :func:`global_fit`: test.lisp's global fit of several 334-point
  datasets that share ``linewidth``, ``x0`` and ``mix``; dataset 1 is the
  flagship's (model ``lorder_mixed_bg``, its printed parameters with scale
  x10), dataset k > 1 comes from ``lorder_mixed_bg`` renamed to read
  ``scale{k}``, ``bg0{k}`` and ``bg1{k}`` (test.lisp's
  ``lorder-mixed-bg2``), all with sigma = 1e-7 noise.  Dataset 2's own
  parameters stand to test.lisp's start for them (scale2 1e-8, bg02 1e-7,
  bg12 1e-10) as dataset 1's printed ones stand to its start (scale 1e-6,
  bg0 1e-7, bg1 1e-10), scale x10 as in the flagship: its resonance is a
  hundredth of dataset 1's, on the same background;
- :func:`nv_spectra`: ODMR spectra of ``double_lorentzian_bg`` on a
  401-point grid over 2840-2900 MHz, with dips 20x the noise;
  :func:`nv_scan_grid`: a rows x cols scan grid of such spectra whose
  dips move smoothly across the grid, as a field map's do;
- :func:`line_evidence_case`: a straight-line fit under a box prior whose
  evidence has a closed form;
- :func:`twin_case`: a fit of each zoo model, for holding its CUDA twin
  against the plain model;
- :func:`dense_l`: a dense proposal factor for holding the chunk kernel
  against its plain version;
- :func:`flagship_prior_spec`: a named prior on the flagship fit that
  uses every kind the kernels declare, and :func:`prior_edge_walkers`,
  which puts walkers outside its walls and at a LogNormal's x <= 0.
"""

from __future__ import annotations

import numpy as np
import torch

import math

from .models import DEVICE_MODELS, double_lorentzian_bg, lorder_mixed_bg, renamed
from .priors import Gaussian, LogNormal, PriorSpec
from .roofline import FLAGSHIP, N_POINTS

__all__ = ["dense_l", "global_fit", "nv_spectra", "NV_SPECTRA", "TWIN_PARAMS",
           "twin_case", "write_nv_file", "nv_scan_grid", "line_evidence_case",
           "line_evidence_batch"]

# test.lisp:58-70's starting point; datasets past the second start as it.
_GLOBAL_START = {"scale": 1e-6, "linewidth": 100.0, "x0": 2700.0, "mix": 0.1,
                 "bg0": 1e-7, "bg1": 1e-10}
_OWN_START = {"scale": 1e-8, "bg0": 1e-7, "bg1": 1e-10}
# each further dataset's own scale and background, relative to dataset 1's
_OWN_FACTORS = ((0.01, 1.0, 1.0), (0.75, -2.0, 0.5), (1.25, 0.5, 2.0),
                (0.5, -1.0, -0.5), (0.6, 2.5, 1.5), (1.1, -0.3, -2.0),
                (0.9, 1.2, 0.8))


def _own(name: str, k: int) -> str:
    return name if k == 1 else f"{name}{k}"


def global_fit(n_datasets: int = 2, seed: int = 0, n_points: int = N_POINTS) -> dict:
    """test.lisp's global fit over ``n_datasets`` (2 to 8) synthetic datasets.

    Returns ``{"functions", "data", "truth", "start"}``: the models (the
    flagship's, then renamed ones), ``[(x, y_k)]``, the generating
    parameters and test.lisp's starting point (d = 3 + 3 n_datasets).
    At the default ``n_points``, dataset 1 equals
    ``roofline.synthetic_flagship(seed)``.
    """
    if not 2 <= n_datasets <= 1 + len(_OWN_FACTORS):
        raise ValueError(f"global_fit: 2 to {1 + len(_OWN_FACTORS)} datasets, "
                         f"got {n_datasets}")
    x = np.linspace(2000.0, 3600.0, n_points)
    rng = np.random.default_rng(seed)
    functions, data = [], []
    truth, start = dict(FLAGSHIP), dict(_GLOBAL_START)
    for k in range(1, n_datasets + 1):
        if k == 1:
            fn = lorder_mixed_bg
        else:
            fs, fb0, fb1 = _OWN_FACTORS[k - 2]
            truth.update({_own("scale", k): FLAGSHIP["scale"] * fs,
                          _own("bg0", k): FLAGSHIP["bg0"] * fb0,
                          _own("bg1", k): FLAGSHIP["bg1"] * fb1})
            start.update({_own(n, k): v for n, v in _OWN_START.items()})
            fn = renamed(lorder_mixed_bg, {n: _own(n, k) for n in ("scale", "bg0", "bg1")},
                         name=f"lorder_mixed_bg{k}")
        p = {n: torch.tensor(v, dtype=torch.float64) for n, v in truth.items()}
        y = fn(torch.tensor(x), p).numpy()
        functions.append(fn)
        data.append((x, y + 1e-7 * rng.standard_normal(n_points)))
    return {"functions": functions, "data": data, "truth": truth, "start": start}


# Three spectra's generating parameters: dips in make_nv_prior's boxes
# (mu1 in 2850-2870, mu2 in 2870-2890 MHz, sigma in 9-20), 14-20 MHz
# apart, scale ratios inside 0.9-1.1, depth 0.02 on a background of 1.
NV_SPECTRA = (
    {"scale1": 0.020, "scale2": 0.020, "mu1": 2857.0, "mu2": 2877.0, "sigma": 10.0, "bg0": 1.0},
    {"scale1": 0.021, "scale2": 0.020, "mu1": 2860.0, "mu2": 2874.0, "sigma": 10.0, "bg0": 1.0},
    {"scale1": 0.020, "scale2": 0.019, "mu1": 2862.5, "mu2": 2881.0, "sigma": 10.0, "bg0": 1.0},
)
NV_NOISE = 0.001   # the dips are 20x the noise


def nv_spectra(seed: int = 0):
    """``(x, [y_1, y_2, y_3])``: :data:`NV_SPECTRA` on 401 points over
    2840-2900 MHz plus Gaussian noise of :data:`NV_NOISE`."""
    x = np.linspace(2840.0, 2900.0, 401)
    rng = np.random.default_rng(seed)
    ys = []
    for truth in NV_SPECTRA:
        p = {n: torch.tensor(v, dtype=torch.float64) for n, v in truth.items()}
        y = double_lorentzian_bg(torch.tensor(x), p).numpy()
        ys.append(y + NV_NOISE * rng.standard_normal(x.shape[0]))
    return x, ys


def nv_scan_grid(rows: int, cols: int, seed: int = 0):
    """``(x, ys (rows * cols, 401), truths)``: a scan grid of NV spectra on
    :func:`nv_spectra`'s grid and noise, pixels in row-major order.

    Across the grid the dips' centre moves by 4 MHz and their splitting
    by 6 MHz (14-20 MHz: field offsets 2.5-3.6 Oe), smoothly, as a field
    map's do; mu1 stays in 2856-2863 and mu2 in 2873-2880 MHz (inside
    ``make_nv_prior``'s boxes), the scale ratio in 0.98-1.02, sigma 10,
    depth 0.02 on a background of 1.
    """
    u = np.repeat(np.linspace(0.0, 1.0, rows), cols)
    v = np.tile(np.linspace(0.0, 1.0, cols), rows)
    centre = 2868.0 + 2.0 * (v - 0.5) + np.cos(np.pi * u)
    split = 14.0 + 3.0 * u + 3.0 * np.sin(np.pi * v)
    truths = [{"scale1": 0.020, "scale2": float(0.020 * (1.0 + 0.04 * (a - 0.5))),
               "mu1": float(c - 0.5 * s), "mu2": float(c + 0.5 * s), "sigma": 10.0,
               "bg0": 1.0} for a, c, s in zip(u, centre, split)]
    x = np.linspace(2840.0, 2900.0, 401)
    p = {n: torch.tensor([t[n] for t in truths], dtype=torch.float64)[:, None]
         for n in truths[0]}
    y = double_lorentzian_bg(torch.tensor(x), p).numpy()
    rng = np.random.default_rng(seed)
    return x, y + NV_NOISE * rng.standard_normal(y.shape), truths


def line_evidence_case(n: int = 334, sigma: float = 2.0, seed: int = 0) -> dict:
    """A line ``y = 1 + 2 x + N(0, sigma^2)`` on ``x = linspace(0, 1, n)``
    under the box ``m in (-4, 8)``, ``b in (-3, 5)`` (at the defaults at
    least 14 posterior standard deviations from the estimate on every
    side), with its evidence in closed form, in float64: the likelihood is
    Gaussian in (m, b), so

        log Z = log L(beta_hat) + log 2pi + 1/2 log det(sigma^2 (X^T X)^-1) - log V.

    Returns ``{"x", "y", "sigma", "truth", "bounds", "beta_hat", "cov",
    "log_z"}`` (``beta_hat`` the least-squares ``{"m", "b"}``, ``cov`` its
    covariance)."""
    x = np.linspace(0.0, 1.0, n)
    y = 1.0 + 2.0 * x + sigma * np.random.default_rng(seed).standard_normal(n)
    X = np.column_stack([x, np.ones(n)])
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    cov = sigma ** 2 * np.linalg.inv(X.T @ X)
    r = y - X @ beta
    log_l = float(np.sum(-0.5 * math.log(2.0 * math.pi * sigma ** 2) - 0.5 * (r / sigma) ** 2))
    bounds = {"m": (-4.0, 8.0), "b": (-3.0, 5.0)}
    log_v = sum(math.log(hi - lo) for lo, hi in bounds.values())
    log_z = log_l + math.log(2.0 * math.pi) + 0.5 * math.log(np.linalg.det(cov)) - log_v
    return {"x": x, "y": y, "sigma": sigma, "truth": {"m": 2.0, "b": 1.0},
            "bounds": bounds, "beta_hat": {"m": float(beta[0]), "b": float(beta[1])},
            "cov": cov, "log_z": log_z}


def line_evidence_batch(n_datasets: int = 16, n: int = 334, sigma: float = 2.0) -> dict:
    """``n_datasets`` lines of :func:`line_evidence_case`'s recipe at seeds
    0 .. n_datasets - 1 on one x grid, one box prior, each with its
    closed-form log Z: ``{"x", "datasets" [(x, y), ...], "sigma", "truth",
    "bounds", "log_z" (n_datasets,)}`` (a ``BatchedFit``'s inputs and
    ``nested_per_dataset``'s answers)."""
    cases = [line_evidence_case(n, sigma, seed) for seed in range(n_datasets)]
    return {"x": cases[0]["x"], "datasets": [(c["x"], c["y"]) for c in cases],
            "sigma": sigma, "truth": cases[0]["truth"], "bounds": cases[0]["bounds"],
            "log_z": np.asarray([c["log_z"] for c in cases])}


def write_nv_file(path, seed: int = 0, n_spectra: int | None = None):
    """Write :func:`nv_spectra` (the first ``n_spectra`` of them, default
    all) as a ';'-delimited file (frequency, then one column per spectrum),
    the layout ``nv.fit_nv_file`` reads."""
    x, ys = nv_spectra(seed)
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            f.write(";".join(repr(float(c[i])) for c in (x, *ys[:n_spectra])) + "\n")
    return path


# Parameters of each zoo model on x in 0.5-3: every feature (peaks, dips,
# decays, a few oscillations) inside the grid.
TWIN_PARAMS = {
    "line": {"b": 1.0, "m": 2.0},
    "example_line": {"b": 30.0, "m": 2.0},
    "polynomial": {"c0": 5.0, "c1": 1.0, "c2": -0.5, "c3": 0.2},
    "gaussian_peak": {"scale": 4.0, "x0": 1.5, "sigma": 0.4, "bg0": 1.0, "bg1": 0.2},
    "lorentzian_bg": {"scale": 4.0, "linewidth": 0.3, "x0": 1.6, "bg0": 1.0, "bg1": 0.2},
    "lorder_mixed_bg": {"scale": 2.0, "linewidth": 0.4, "x0": 1.7, "mix": 0.7,
                        "bg0": 3.0, "bg1": 0.1},
    "double_lorentzian_bg": {"scale1": 1.0, "scale2": 1.2, "mu1": 1.2, "mu2": 2.2,
                             "sigma": 0.2, "bg0": 3.0},
    "exponential_decay": {"scale": 5.0, "tau": 1.1, "bg0": 0.5},
    "sinusoid": {"scale": 2.0, "freq": 1.3, "phase": 0.4, "bg0": 3.0},
    "damped_sinusoid": {"scale": 2.0, "tau": 1.5, "freq": 1.3, "phase": 0.4, "bg0": 3.0},
    "stretched_exponential": {"scale": 4.0, "tau": 1.2, "beta": 0.7, "bg0": 0.5},
    "power_law": {"scale": 2.0, "exponent": 1.5, "bg0": 0.5},
    "pseudo_voigt": {"scale": 4.0, "x0": 1.5, "w": 0.3, "eta": 0.4, "bg0": 1.0, "bg1": 0.2},
}


def twin_case(model, optional: bool = True, n_points: int = 120, seed: int = 0):
    """A fit of one zoo model: ``(x, y, params, kinds)``.

    ``params`` are :data:`TWIN_PARAMS` (without the twin's optional ones
    when ``optional`` is False); y is the model plus noise of 1 % of its
    peak; ``kinds`` the likelihoods it takes: normal and normal_cutoff,
    and poisson where the model's mean is positive (y then rounded to
    counts by the caller).
    """
    x = np.linspace(0.5, 3.0, n_points)
    twin = DEVICE_MODELS[model]
    params = {k: v for k, v in TWIN_PARAMS[model.__name__].items()
              if optional or k not in twin.optional}
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    mu = model(torch.tensor(x), p).numpy()
    y = mu + 0.01 * np.abs(mu).max() * np.random.default_rng(seed).standard_normal(n_points)
    kinds = ["normal", "normal_cutoff"] + (["poisson"] if mu.min() > 0 else [])
    return x, y, params, kinds


def dense_l(scales, seed: int = 0) -> torch.Tensor:
    """A dense lower-triangular proposal factor, float32: the Cholesky
    factor of a covariance whose standard deviations are ``|scales|`` and
    whose correlations are random (seeded; a median size of 0.15 to 0.25
    at d = 6 to 18).  Its accepted steps' outer products have off-diagonal sums of the
    size of ``sqrt(m_ii m_jj)``, so a kernel that reads L transposed,
    misplaces an entry of the moments or drops their off-diagonal is off
    by that much; a diagonal L hides all three.
    """
    s = np.abs(np.asarray(scales, dtype=np.float64))
    a = np.random.default_rng(seed).standard_normal((s.shape[0], s.shape[0]))
    c = a @ a.T + np.eye(s.shape[0])
    c = c / np.sqrt(np.outer(np.diag(c), np.diag(c)))
    return torch.tensor(np.linalg.cholesky(c * np.outer(s, s)), dtype=torch.float32)


def flagship_prior_spec() -> PriorSpec:
    """A named prior on the flagship fit (``roofline.FLAGSHIP``, from
    ``roofline.START``) with every kind: a weak Gaussian on x0 truncated to
    the data's range, an untruncated LogNormal on the linewidth, a
    Gaussian on mix truncated on one side, and Uniform boxes on the
    scale and the background, wide around both the start and the truth."""
    return PriorSpec({
        "scale": (-1e-3, 1e-3),
        "linewidth": LogNormal(math.log(100.0), 1.0),
        "x0": Gaussian(2780.0, 200.0, low=2000.0, high=3600.0),
        "mix": Gaussian(3.0, 2.0, low=0.0),
        "bg0": (-1e-4, 1e-4),
        "bg1": (-1e-8, 1e-8),
    })


def prior_edge_walkers(position, keys) -> torch.Tensor:
    """``position`` with one walker in eight moved past a wall of
    :func:`flagship_prior_spec`: x0 below and above its truncation, mix
    below its one-sided one, the linewidth below 0 (the LogNormal's
    clamped log; not at 0, where the model is 0/0 at a data point that
    equals x0), and the scale outside its box."""
    pos = position.clone()
    i = keys.index
    pos[0::8, i("x0")] = 1990.0
    pos[1::8, i("x0")] = 3610.0
    pos[2::8, i("mix")] = -0.5
    pos[3::8, i("linewidth")] = -0.5
    pos[4::8, i("linewidth")] = -3.0
    pos[5::8, i("scale")] = 2e-3
    return pos
