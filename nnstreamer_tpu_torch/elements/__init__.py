"""Tensor pipeline elements — importing this package registers every
ported element with the factory (≙ registerer/nnstreamer.c
GST_PLUGIN_DEFINE)."""
from . import filter  # noqa: F401  (tensor_filter)
from . import media  # noqa: F401  (videotestsrc/audiotestsrc/file IO)
from . import converter  # noqa: F401  (tensor_converter)
from . import transform  # noqa: F401  (tensor_transform)
from . import decoder  # noqa: F401  (tensor_decoder)
from . import sinks  # noqa: F401  (tensor_sink/tensor_debug)

__all__: list = []
