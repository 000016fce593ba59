"""Tensor pipeline elements — importing this package registers every
ported element with the factory (≙ registerer/nnstreamer.c
GST_PLUGIN_DEFINE)."""
from . import filter  # noqa: F401  (tensor_filter)
from . import media  # noqa: F401  (videotestsrc/audiotestsrc/file IO)
from . import converter  # noqa: F401  (tensor_converter)
from . import transform  # noqa: F401  (tensor_transform)
from . import decoder  # noqa: F401  (tensor_decoder)
from . import sinks  # noqa: F401  (tensor_sink/tensor_debug)
from . import combiner  # noqa: F401  (tensor_mux/tensor_merge/join)
from . import splitter  # noqa: F401  (tensor_demux/tensor_split)
from . import aggregator  # noqa: F401  (tensor_aggregator)
from . import crop  # noqa: F401  (tensor_crop)
from . import flowctl  # noqa: F401  (tensor_if/tensor_rate)
from . import query  # noqa: F401  (tensor_query_*)
from . import edge  # noqa: F401  (edgesrc/edgesink)
from ..fault import element as fault  # noqa: F401  (tensor_fault)

__all__: list = []
