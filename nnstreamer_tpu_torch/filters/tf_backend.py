"""tensorflow backend: frozen GraphDef (.pb) models on the card.

Port of ``nnstreamer_tpu/filters/tf_backend.py`` (≙ ext/nnstreamer/
tensor_filter/tensor_filter_tensorflow.cc, a TF C API session). The
graph imports once (interop/tf_graphdef.py) into a torch module: no
tensorflow dependency, the same engine as every other backend.
"""
from __future__ import annotations

from .interop_base import ImportedModelFilter
from .registry import register_filter


def _import(path: str):
    from ..interop import tf_graphdef
    return tf_graphdef.load(path)


@register_filter
class TFGraphFilter(ImportedModelFilter):
    NAME = "tensorflow"
    EXTENSIONS = (".pb",)
    _import = staticmethod(_import)
