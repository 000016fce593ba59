"""Filter-backend subplugins and their registry."""
from . import (custom, custom_c, llm, onnx_backend,  # noqa: F401
               simlink, tf_backend, tflite_backend, torch_backend,
               torch_cuda_backend)  # (register built-in backends)
from .base import (Accelerator, FilterEvent, FilterFramework,
                   FilterProperties, InvokeDrop)
from .custom import register_custom_easy, unregister_custom_easy
from .registry import (all_filters, detect_framework, find_filter,
                       register_filter, shared_model_get,
                       shared_model_insert, shared_model_release)

__all__ = [
    "FilterFramework", "FilterProperties", "FilterEvent", "Accelerator",
    "InvokeDrop",
    "register_filter", "find_filter", "all_filters",
    "detect_framework", "register_custom_easy", "unregister_custom_easy",
    "shared_model_get", "shared_model_insert", "shared_model_release",
]
