"""lisp_mcmc_torch: the adaptive-MCMC curve fitter on PyTorch and CUDA.

The port of ``lisp_mcmc_tpu`` (JAX on a TPU) to one NVIDIA H100.  Plain
tensor code is PyTorch; the two TPU kernels of the main path (every zoo
model, any number of terms), and the roofline's ceiling probe
(``roofline.py``), are CUDA C++ written for Hopper (``csrc/``), built
with ``nvcc`` at first use.  A named prior (``PriorSpec``,
``MVGaussian``) runs inside both kernels as a declared table.  Batched
walker sets (``BatchedFit``, ``BatchedNVFit``), partial pooling
(``HierarchicalFit``, ``compare_pooling``), the evidence layer
(``log_evidence``, ``smc_sample``, ``laplace_approx``, ``nested_sample``)
and model criticism (predictive checks, WAIC, PSIS-LOO, LOO-PIT, the
audit, prior sensitivity, refit cross-validation, model weights, the
profile likelihood), simulation-based calibration (``sbc_check``,
``sbc_check_hierarchical``), variational inference (``advi``, RealNVP
``flow_advi``, NeuTra, flow checkpoints) and checkpoints of every fit
kind (``walker_save``/``walker_load`` and the batched, hierarchical and
walker-set forms, in the JAX package's file format), the plots
(``plotting``, the ``Walker`` plot verbs) and chain-axis sharding over
processes (``parallel``, ``Walker.shard``) are ported too.
Importing the package needs neither a GPU nor the CUDA toolkit; the
entry points run on the GPU unless ``device="cpu"`` is passed.

    import lisp_mcmc_torch as mfit
    from lisp_mcmc_torch.models import lorder_mixed_bg
    w = mfit.walker_create(function=lorder_mixed_bg, data=(x, y),
                           params={...}, data_error=1e-7, n_walkers=131072,
                           walker_jitter=0.05)
    w.adaptive_steps(30000, temperature=10.0, auto=None)
    lp, best = w.most_likely_step()
"""

from . import control, diagnostics, models, nv, stats, utils
from .batched import BatchedFit
from .checkpoint import (batched_load, batched_save, hierarchical_load, hierarchical_save,
                         walker_load, walker_save, walker_set_load, walker_set_save)
from .control import clear_stop, estop, request_stop, stop_requested
from .data import Dataset, clean_data, clean_data_error, create_walker_data
from .device import resolve_device
from .evidence import (EvidenceResult, LaplaceResult, laplace_approx, log_bayes_factor,
                       log_evidence)
from .diagnostics import (AuditResult, KFoldResult, LOOPITResult, LOOResult,
                          PriorSensitivityResult, WAICResult, audit, convergence,
                          convergence_per_dataset, ess_from_history, ess_per_param,
                          evidence_weights, grouped_refit_health, kfold, loo, loo_compare,
                          loo_pit, mcse_per_param, metrics, model_weights,
                          prior_sensitivity, rank_rhat_per_param, reloo, rhat_from_history,
                          rhat_per_param, summary, tail_ess_per_param, trace_profile, waic,
                          waic_compare)
from .expressions import (eval_expression, expression_credible_interval,
                          expression_hdi, expression_samples,
                          walker_with_expression)
from .fit import Walker, make_adam_sgdr_runner, mcmc_fit, unit_cube_view, walker_create
from .io import file_specs, get_filename, read_file_data
from .kernel import FitConfig, WalkerState, init_state, temperature_schedule
from .hierarchical import HierarchicalFit, LOGOResult
from .nv import BatchedNVFit, HierarchicalNVFit, fit_nv_spectra_batched
from .likelihoods import (create_log_likelihood_function, log_factorial,
                          log_likelihood_normal, log_likelihood_normal_cutoff,
                          log_likelihood_normal_weighted, log_likelihood_poisson, log_normal,
                          log_poisson, make_noise_scale_likelihood,
                          make_student_t_likelihood, make_x_error_likelihood, pointwise_cdf,
                          pointwise_log_likelihood)
from .nested import NestedResult, nested_per_dataset, nested_sample
from .params import ParamSpec, map_params, normalize_params, reduce_params, scale_params
from .pooling import PoolingComparison, compare_pooling
from .priors import (Gaussian, LogNormal, MVGaussian, PriorSpec, Uniform, as_prior_spec,
                     bound_penalty, combine_priors, constraint_penalty, log_prior_flat,
                     make_bounds_prior, prior_bounds, resolve_prior_spec, unit_cube_wall)
from .predictive import (Prediction, PredictiveDraws, posterior_predictive, ppc_pvalue,
                         predict, prior_predictive)
from .profile import ProfileResult, profile_likelihood
from .sbc import SBCResult, sbc_check, sbc_check_hierarchical
from .smc import SMCResult, seed_prior_box, smc_sample
from .variational import (FlowVIResult, NeutraResult, VIResult, advi, advi_per_dataset,
                          flow_advi, flow_advi_per_dataset, load_flow)
from .walker_set import WalkerSet

__all__ = [
    "control", "diagnostics", "models", "nv", "stats", "utils", "plotting", "parallel",
    "clear_stop", "estop", "request_stop", "stop_requested",
    "Dataset", "clean_data", "clean_data_error", "create_walker_data",
    "resolve_device", "ess_from_history", "rhat_from_history", "convergence",
    "convergence_per_dataset", "ess_per_param", "mcse_per_param", "metrics",
    "rank_rhat_per_param", "rhat_per_param", "summary", "tail_ess_per_param",
    "trace_profile",
    "eval_expression", "expression_credible_interval", "expression_hdi",
    "expression_samples", "walker_with_expression",
    "Walker", "mcmc_fit", "walker_create", "unit_cube_view", "make_adam_sgdr_runner",
    "file_specs", "get_filename", "read_file_data",
    "FitConfig", "WalkerState", "init_state", "temperature_schedule",
    "log_likelihood_normal", "log_likelihood_normal_cutoff",
    "log_likelihood_normal_weighted", "log_likelihood_poisson", "log_normal",
    "log_poisson", "log_factorial", "make_student_t_likelihood",
    "make_noise_scale_likelihood", "make_x_error_likelihood",
    "create_log_likelihood_function", "pointwise_log_likelihood", "pointwise_cdf",
    "ParamSpec", "normalize_params", "map_params", "scale_params", "reduce_params",
    "bound_penalty", "combine_priors", "constraint_penalty", "log_prior_flat",
    "make_bounds_prior", "prior_bounds", "Uniform", "Gaussian", "LogNormal",
    "MVGaussian", "PriorSpec", "as_prior_spec", "resolve_prior_spec",
    "unit_cube_wall", "WalkerSet",
    "BatchedFit", "BatchedNVFit", "fit_nv_spectra_batched", "HierarchicalFit",
    "HierarchicalNVFit", "LOGOResult",
    "PoolingComparison", "compare_pooling",
    "EvidenceResult", "LaplaceResult", "laplace_approx", "log_bayes_factor",
    "log_evidence", "SMCResult", "seed_prior_box", "smc_sample",
    "WAICResult", "waic", "waic_compare", "LOOResult", "loo", "loo_compare",
    "LOOPITResult", "loo_pit", "AuditResult", "audit", "PriorSensitivityResult",
    "prior_sensitivity", "grouped_refit_health", "reloo", "KFoldResult", "kfold",
    "model_weights", "evidence_weights", "NestedResult", "nested_sample",
    "nested_per_dataset", "PredictiveDraws", "Prediction", "posterior_predictive",
    "prior_predictive", "predict", "ppc_pvalue", "ProfileResult", "profile_likelihood",
    "SBCResult", "sbc_check", "sbc_check_hierarchical", "VIResult", "FlowVIResult",
    "NeutraResult", "advi", "flow_advi", "advi_per_dataset", "flow_advi_per_dataset",
    "load_flow", "walker_save", "walker_load", "walker_set_save", "walker_set_load",
    "batched_save", "batched_load", "hierarchical_save", "hierarchical_load",
]


def __getattr__(name):
    # ``plotting`` (matplotlib) and ``parallel`` (torch.distributed) load
    # on first use, so importing the package stays light.
    if name in ("plotting", "parallel"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
