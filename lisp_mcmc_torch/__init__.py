"""lisp_mcmc_torch: the adaptive-MCMC curve fitter on PyTorch and CUDA.

The port of ``lisp_mcmc_tpu`` (JAX on a TPU) to one NVIDIA H100.  Plain
tensor code is PyTorch; the two TPU kernels of the main path (every zoo
model, any number of terms), and the roofline's ceiling probe
(``roofline.py``), are CUDA C++ written for Hopper (``csrc/``), built
with ``nvcc`` at first use.
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

from . import control, diagnostics, models, nv, stats
from .control import clear_stop, estop, request_stop, stop_requested
from .data import Dataset, clean_data, clean_data_error, create_walker_data
from .device import resolve_device
from .diagnostics import ess_from_history, rhat_from_history
from .expressions import (eval_expression, expression_credible_interval,
                          expression_hdi, expression_samples,
                          walker_with_expression)
from .fit import Walker, mcmc_fit, walker_create
from .io import file_specs, get_filename, read_file_data
from .kernel import FitConfig, WalkerState, init_state, temperature_schedule
from .likelihoods import (log_likelihood_normal, log_likelihood_normal_cutoff,
                          log_likelihood_normal_weighted, log_likelihood_poisson)
from .params import ParamSpec, normalize_params
from .priors import (bound_penalty, combine_priors, constraint_penalty,
                     log_prior_flat, make_bounds_prior, prior_bounds)
from .walker_set import WalkerSet

__all__ = [
    "control", "diagnostics", "models", "nv", "stats",
    "clear_stop", "estop", "request_stop", "stop_requested",
    "Dataset", "clean_data", "clean_data_error", "create_walker_data",
    "resolve_device", "ess_from_history", "rhat_from_history",
    "eval_expression", "expression_credible_interval", "expression_hdi",
    "expression_samples", "walker_with_expression",
    "Walker", "mcmc_fit", "walker_create",
    "file_specs", "get_filename", "read_file_data",
    "FitConfig", "WalkerState", "init_state", "temperature_schedule",
    "log_likelihood_normal", "log_likelihood_normal_cutoff",
    "log_likelihood_normal_weighted", "log_likelihood_poisson",
    "ParamSpec", "normalize_params",
    "bound_penalty", "combine_priors", "constraint_penalty", "log_prior_flat",
    "make_bounds_prior", "prior_bounds", "WalkerSet",
]
