"""NV-center magnetometry pipeline (nv-specific.lisp).

Port of ``lisp_mcmc_tpu/nv.py``:
  - data loaders: per-column spectrum separation (``nv-data->separated``,
    nv-specific.lisp:5-6) and directory ingestion with ';' delimiters
    (``nv-dir->data``, 8-10);
  - the physics prior (21-34): box bounds on scales/mus/sigma/bg plus the
    hard constraints mu1 < mu2, mu2 - mu1 >= 6 MHz, 0.9 < scale1/scale2 <
    1.1, each at -1e9, declared as data (``priors.declared_constraints``)
    so that both CUDA kernels evaluate the boxes and the constraints
    (``ops/loglik_kernel.split_prior``);
  - the noise estimate from the quieter of the first/last deciles (36-41);
  - the parameter auto-guess (43-48);
  - the per-spectrum walker factory and the sequential drivers (50-66);
  - the field offset (68-69): (mu2 - mu1) / 2 / 2.8 Oe;
  - the scan-grid export (76-95);
  - a scan grid of spectra on one frequency grid fitted as one ensemble
    (:class:`BatchedNVFit`, :func:`fit_nv_spectra_batched`), the batched
    walker set of ``batched.py`` with the pipeline's defaults;
  - the scan grid with partial pooling (:class:`HierarchicalNVFit`), the
    hierarchical fit of ``hierarchical.py`` with the physics boxes as its
    default population and local priors.
"""

from __future__ import annotations

import numpy as np

from .batched import BatchedFit
from .expressions import walker_with_expression
from .fit import Walker, walker_create
from .hierarchical import HierarchicalFit
from .io import get_filename, read_file_data
from .likelihoods import log_likelihood_normal
from .models import double_lorentzian_bg
from .priors import declared_constraints, diff_ge, le, make_bounds_prior, ratio_in
from .walker_set import WalkerSet

__all__ = [
    "nv_data_separated",
    "nv_dir_data",
    "log_prior_nv",
    "make_nv_prior",
    "nv_data_std_dev",
    "guess_nv_params",
    "nv_walker",
    "fit_nv_file",
    "fit_nv_dir",
    "walker_field_offset",
    "export_scan_grid",
    "BatchedNVFit",
    "HierarchicalNVFit",
    "fit_nv_spectra_batched",
]

FIELD_OFFSET_EXPRESSION = "(/ (- :mu2 :mu1) 2 2.8)"  # nv-specific.lisp:68-69


def nv_data_separated(table):
    """Split a multi-column table into (x, y_i) spectra
    (``nv-data->separated``, nv-specific.lisp:5-6)."""
    x = np.asarray(table[0], dtype=np.float64)
    return [(x, np.asarray(y, dtype=np.float64)) for y in table[1:]]


def nv_dir_data(directory: str):
    """All spectra from every file in a directory, ';'-delimited
    (``nv-dir->data``, nv-specific.lisp:8-10)."""
    spectra = []
    for path in get_filename(directory):
        spectra.extend(nv_data_separated(read_file_data(path, delim=";")))
    return spectra


# Hard physics constraints (nv-specific.lisp:31-34): mu1 <= mu2,
# mu2 - mu1 >= 6 MHz, 0.9 < scale1 / scale2 < 1.1.
_nv_constraints = declared_constraints(
    le("mu1", "mu2"),
    diff_ge("mu2", "mu1", 6.0),
    ratio_in("scale1", "scale2", 0.9, 1.1),
)
_nv_constraints.__name__ = "_nv_constraints"


# Physics prior (nv-specific.lisp:21-34): the reference's exact boxes and
# constraints.  These amplitude boxes assume the reference lab's y units
# (backgrounds below 1e-5); the pipeline factories below default to
# make_nv_prior(y), which rescales them to the actual spectrum.
log_prior_nv = make_bounds_prior(
    {
        "scale1": (1e-5, 1e1),
        "scale2": (1e-5, 1e1),
        "mu1": (2850, 2870),
        "mu2": (2870, 2890),
        "sigma": (9, 20),
        "bg0": (0, 1e-5),
    },
    extra=_nv_constraints,
)
log_prior_nv.__name__ = "log_prior_nv"


def _nv_boxes(y) -> dict:
    """The reference physics boxes (nv-specific.lisp:21-34), amplitude
    entries rescaled to the spectrum's y units."""
    y = np.asarray(y, dtype=np.float64)
    contrast = max(float(y.max() - y.min()), 1e-300)
    spread = 5.0 * contrast
    return {
        "scale1": (1e-3 * contrast, 1e3 * contrast),
        "scale2": (1e-3 * contrast, 1e3 * contrast),
        "mu1": (2850.0, 2870.0),
        "mu2": (2870.0, 2890.0),
        "sigma": (9.0, 20.0),
        "bg0": (float(y.min()) - spread, float(y.max()) + spread),
    }


def _require_shared_grid(spectra, who: str):
    """Refuse spectra on different frequency grids (JAX nv.py:125-133)."""
    x0 = np.asarray(spectra[0][0], dtype=np.float64)
    for x, _ in spectra:
        if len(x) != len(x0) or not np.allclose(x, x0):
            raise ValueError(
                f"{who} requires a shared frequency grid (its scan-grid "
                "exports/heatmaps assume one); for ragged spectra use "
                "fit_nv_file per file, or a plain BatchedFit (which "
                "pads ragged batches)")


def make_nv_prior(y=None):
    """NV prior with amplitude boxes scaled to the spectrum's units.

    The mu/sigma boxes are physical (MHz) and stay fixed; scale1/scale2/
    bg0 are in y units, so with ``y`` the boxes span generous multiples of
    the observed contrast/background; without ``y`` this is exactly
    :data:`log_prior_nv`.
    """
    if y is None:
        return log_prior_nv
    return make_bounds_prior(_nv_boxes(y), extra=_nv_constraints)


def nv_data_std_dev(y) -> float:
    """Noise estimate: the quieter of the first/last deciles of the trace
    (``nv-data-std-dev``, nv-specific.lisp:36-41), floored at a tiny
    fraction of the signal where a decile is constant."""
    y = np.asarray(y, dtype=np.float64)
    k = max(1, len(y) // 10)
    sd = float(min(np.std(y[:k]), np.std(y[-k:])))
    if sd > 0.0:
        return sd
    contrast = float(y.max() - y.min())
    return 1e-6 * contrast if contrast > 0.0 else 1e-12


def guess_nv_params(y) -> dict:
    """Initial parameter guess (``guess-nv-params``, nv-specific.lisp:43-48);
    ``double_lorentzian_bg`` takes its scales in y units, so the scale
    guess is the contrast itself."""
    y = np.asarray(y, dtype=np.float64)
    contrast = float(y.max() - y.min())
    return {
        "scale1": contrast,
        "scale2": contrast,
        "mu1": 2863.0,
        "mu2": 2873.0,
        "sigma": 10.0,
        "bg0": float(y.max()),
    }


def nv_walker(data, n_walkers: int = 256, seed: int = 0, **kwargs) -> Walker:
    """Single-spectrum walker factory (``nv-walker``, nv-specific.lisp:50-56).

    The prior defaults to :func:`make_nv_prior` scaled to this spectrum's
    y units; pass ``log_prior=...`` to override.  Other keywords
    (``config``, ``dtype``, ``device``) go to ``walker_create``.
    """
    x, y = data
    return walker_create(
        function=double_lorentzian_bg,
        data=(x, y),
        params=guess_nv_params(y),
        data_error=nv_data_std_dev(y),
        log_likelihood=log_likelihood_normal,
        log_prior=kwargs.pop("log_prior", None) or make_nv_prior(y),
        n_walkers=n_walkers,
        seed=seed,
        walker_jitter=kwargs.pop("walker_jitter", 0.02),
        **kwargs,
    )


def fit_nv_file(filename: str, n_steps: int | None = None, **kwargs) -> WalkerSet:
    """Sequential per-spectrum fits of one file (``file->nv-walkers``,
    nv-specific.lisp:63-66)."""
    walkers = WalkerSet(nv_walker(d, **kwargs) for d in
                        nv_data_separated(read_file_data(filename, delim=";")))
    walkers.adaptive_steps(n_steps)
    return walkers


def fit_nv_dir(directory: str, n_steps: int | None = None, **kwargs) -> WalkerSet:
    """Sequential fits of every spectrum in a directory
    (``dir->nv-walkers``, nv-specific.lisp:58-61)."""
    walkers = WalkerSet(nv_walker(d, **kwargs) for d in nv_dir_data(directory))
    walkers.adaptive_steps(n_steps)
    return walkers


class BatchedNVFit(BatchedFit):
    """S spectra fitted as one ensemble (JAX ``BatchedNVFit``,
    nv.py:225-273): :class:`batched.BatchedFit` with the pipeline's
    defaults, a shared frequency grid, each spectrum's noise estimate
    (``nv-data-std-dev``) and guess, and the physics prior with its
    amplitude boxes scaled to the pooled y range.  One fit replaces the
    reference's k sequential fits (nv-specific.lisp:60)."""

    def __init__(self, spectra, walkers_per_spectrum: int = 128, seed: int = 0,
                 model=double_lorentzian_bg, prior=None, dtype=None, config=None,
                 walker_jitter: float = 0.02, log_likelihood=None, device=None):
        if len(spectra) == 0:
            raise ValueError("no spectra provided")
        _require_shared_grid(spectra, "BatchedNVFit")
        if prior is None:
            prior = make_nv_prior(np.concatenate([np.asarray(y, np.float64)
                                                  for _, y in spectra]))
        super().__init__(
            model, spectra, [guess_nv_params(y) for _, y in spectra],
            [np.full(len(y), nv_data_std_dev(y)) for _, y in spectra],
            log_prior=prior, log_likelihood=log_likelihood,
            walkers_per_dataset=walkers_per_spectrum, seed=seed,
            walker_jitter=walker_jitter, dtype=dtype, config=config, device=device)

    @property
    def n_spectra(self) -> int:
        return self.n_datasets

    @property
    def walkers_per_spectrum(self) -> int:
        return self.walkers_per_dataset

    def best_params_per_spectrum(self):
        """Each spectrum's most-likely params: the argmax within its block."""
        return self.best_params_per_dataset()

    def field_offsets(self):
        """Each spectrum's field offset in Oe (``walker-field-offset``,
        nv-specific.lisp:68-69): (mu2 - mu1) / 2 / 2.8."""
        return self.expressions_per_dataset(FIELD_OFFSET_EXPRESSION)


class HierarchicalNVFit(HierarchicalFit):
    """A scan grid with partial pooling (JAX ``HierarchicalNVFit``,
    nv.py:276-365): :class:`hierarchical.HierarchicalFit` with the
    pipeline's defaults.  The reference fits every spectrum on its own
    (``dir->nv-walkers``, nv-specific.lisp:58-66); here the linewidth and
    background, properties of the one device, pool through a population by
    default (``pooled=("sigma", "bg0")``; ``None`` pools everything) and
    the resonances and amplitudes stay per pixel.

    Defaults from the physics boxes scaled to the pooled y range
    (``_nv_boxes``): a pooled parameter's ``mu ~ Uniform(box)``, ``tau ~
    LogNormal(log(span / 8), 1)``; a non-pooled local its box as a
    Uniform, so the prior is complete.  ``hyper`` and ``local_priors``
    merge onto these per key.  The cross-parameter constraints (mu2 - mu1
    >= 6 MHz, the scale ratio) are no product of 1-D distributions and
    stay out of the pooled prior; a pooled parameter's box bounds its
    population mean only.  ``proposal="auto"`` takes block proposals from
    walk dimension 96.  ``device=None`` means the GPU."""

    def __init__(self, spectra, n_walkers: int = 256, seed: int = 0,
                 model=double_lorentzian_bg, pooled=("sigma", "bg0"), hyper=None,
                 local_priors=None, dtype=None, config=None, log_likelihood=None,
                 proposal: str = "auto", correlation: str = "diag", corr_prior=None,
                 device=None):
        from .priors import LogNormal, Uniform

        if len(spectra) < 2:
            raise ValueError("HierarchicalNVFit: need >= 2 spectra to "
                             "pool (one spectrum has no population)")
        _require_shared_grid(spectra, "HierarchicalNVFit")
        boxes = _nv_boxes(np.concatenate([np.asarray(y, np.float64) for _, y in spectra]))
        pooled = list(boxes) if pooled is None else list(pooled)
        # both override maps merge onto the box defaults, key by key
        hyper = dict(hyper or {})
        for p in pooled:
            if p not in hyper and p in boxes:
                lo, hi = boxes[p]
                hyper[p] = (Uniform(lo, hi), LogNormal(float(np.log((hi - lo) / 8.0)), 1.0))
        local_priors = dict(local_priors or {})
        for k in boxes:
            if k not in pooled and k not in local_priors:
                local_priors[k] = Uniform(*boxes[k])
        super().__init__(
            model, spectra, [guess_nv_params(y) for _, y in spectra],
            data_error=[np.full(len(y), nv_data_std_dev(y)) for _, y in spectra],
            pooled=pooled, hyper=hyper, local_priors=local_priors,
            log_likelihood=log_likelihood, n_walkers=n_walkers, seed=seed, dtype=dtype,
            config=config, proposal=proposal, correlation=correlation,
            corr_prior=corr_prior, device=device)

    @property
    def n_spectra(self) -> int:
        return self.n_datasets

    def best_params_per_spectrum(self):
        return self.params_per_dataset("best")

    def field_offsets(self):
        """Each pixel's field offset in Oe (``walker-field-offset``,
        nv-specific.lisp:68-69) at the decoded per-pixel best."""
        return self.expressions_per_dataset(FIELD_OFFSET_EXPRESSION)


def fit_nv_spectra_batched(spectra, n_steps: int | None = None,
                           walkers_per_spectrum: int = 128, **kwargs) -> BatchedNVFit:
    """Fit S spectra as one ensemble and return the batch (JAX
    nv.py:368-373)."""
    fit = BatchedNVFit(spectra, walkers_per_spectrum=walkers_per_spectrum, **kwargs)
    fit.adaptive_steps(n_steps)
    return fit


def walker_field_offset(walker, take: int | None = 1000) -> float:
    """``walker-field-offset`` (nv-specific.lisp:68-69) for a single fit."""
    return walker_with_expression(walker, FIELD_OFFSET_EXPRESSION, take)


def export_scan_grid(values, row_length: int, filename: str = "./3d-temp-file.txt"):
    """Write (x, y, value) triples in gnuplot scan-grid format
    (``walker-set-make-file-3d-plot-exp``, nv-specific.lisp:76-95):
    row-major positions with a blank line at the end of each row."""
    values = list(values)
    with open(filename, "w") as out:
        for i, v in enumerate(values):
            x = i % row_length
            y = i // row_length
            out.write(f"{float(x)} {float(y)} {float(v)}\n")
            if x == row_length - 1:
                out.write("\n")
    return filename
