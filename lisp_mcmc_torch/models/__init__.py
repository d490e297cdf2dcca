from .zoo import (DEVICE_MODELS, MODEL_REGISTRY, device_model, get_model,
                  line, lorder_mixed_bg, register_model)

__all__ = ["DEVICE_MODELS", "MODEL_REGISTRY", "device_model", "get_model",
           "line", "lorder_mixed_bg", "register_model"]
