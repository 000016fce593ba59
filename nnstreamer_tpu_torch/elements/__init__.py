"""Tensor pipeline elements — importing this package registers every
ported element with the factory (≙ registerer/nnstreamer.c
GST_PLUGIN_DEFINE)."""
from . import decoder  # noqa: F401  (tensor_decoder)
from . import filter  # noqa: F401  (tensor_filter)

__all__: list = []
