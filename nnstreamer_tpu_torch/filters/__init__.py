"""Filter-backend subplugins and their registry."""
from . import simlink  # noqa: F401  (registers simlink)
from . import torch_cuda_backend  # noqa: F401  (registers torch-cuda)
from .base import (Accelerator, FilterFramework, FilterProperties,
                   InvokeDrop)
from .registry import (all_filters, detect_framework, find_filter,
                       register_filter)

__all__ = [
    "FilterFramework", "FilterProperties", "Accelerator", "InvokeDrop",
    "register_filter", "find_filter", "all_filters",
    "detect_framework",
]
