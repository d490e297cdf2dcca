from .zoo import (DEVICE_MODELS, MAX_POLY, MODEL_REGISTRY, Twin, damped_sinusoid,
                  device_model, double_lorentzian_bg, example_line,
                  exponential_decay, gaussian_peak, get_model, line,
                  lorder_mixed_bg, lorentzian_bg, model_coverage, polynomial,
                  power_law, pseudo_voigt, register_model, renamed, sinusoid,
                  stretched_exponential)

__all__ = ["DEVICE_MODELS", "MAX_POLY", "MODEL_REGISTRY", "Twin",
           "damped_sinusoid", "device_model", "double_lorentzian_bg",
           "example_line", "exponential_decay", "gaussian_peak", "get_model",
           "line", "lorder_mixed_bg", "lorentzian_bg", "model_coverage",
           "polynomial", "power_law", "pseudo_voigt", "register_model",
           "renamed", "sinusoid", "stretched_exponential"]
