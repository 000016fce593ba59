"""onnxruntime backend: .onnx models on the card.

Port of ``nnstreamer_tpu/filters/onnx_backend.py`` (≙ ext/nnstreamer/
tensor_filter/tensor_filter_onnxruntime.cc, around the ORT C++ session).
The model is imported once (interop/onnx.py) into a torch module that
runs through the same capture machinery as the torch-cuda backend. The
alias ``onnx`` lives in the configuration's default aliases
(utils/conf.py).
"""
from __future__ import annotations

from .interop_base import ImportedModelFilter
from .registry import register_filter


def _import(path: str):
    from ..interop import onnx
    return onnx.load(path)


@register_filter
class ONNXFilter(ImportedModelFilter):
    NAME = "onnxruntime"
    EXTENSIONS = (".onnx",)
    _import = staticmethod(_import)
