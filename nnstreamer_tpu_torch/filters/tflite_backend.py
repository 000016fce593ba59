"""tensorflow-lite backend: .tflite models on the card.

Port of ``nnstreamer_tpu/filters/tflite_backend.py`` (≙ ext/nnstreamer/
tensor_filter/tensor_filter_tensorflow_lite.cc, the reference's
benchmark-baseline backend around the TFLite interpreter and its
delegates). The model is imported once (interop/tflite.py) into a torch
module that runs through the same capture machinery as the torch-cuda
backend.

Framework names: ``tensorflow-lite`` (canonical); the aliases
``tensorflow2-lite`` and ``tflite`` match the reference's property
values and live in the configuration's default aliases (utils/conf.py).
"""
from __future__ import annotations

from .interop_base import ImportedModelFilter
from .registry import register_filter


def _import(path: str):
    from ..interop import tflite
    return tflite.load(path)


@register_filter
class TFLiteFilter(ImportedModelFilter):
    NAME = "tensorflow-lite"
    EXTENSIONS = (".tflite",)
    _import = staticmethod(_import)
