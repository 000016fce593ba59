"""nnstreamer_tpu_torch — the PyTorch/CUDA port of nnstreamer_tpu.

The same element names, ``parse_launch`` grammar, caps and ``zoo://``
models as the JAX package, running on PyTorch with hand-written CUDA
kernels for Hopper (``csrc/``). The JAX package stays the reference the
port is held against; this package imports nothing from it.

Entry points run on the card (``cuda``) unless the caller asks for the
CPU, as the tests do (``accelerator=true:cpu`` on ``tensor_filter``).
"""

__version__ = "0.1.0"

from .tensors import (Buffer, Caps, Chunk, TensorFormat, TensorInfo,
                      TensorsConfig, TensorsInfo, TensorType)
from .pipeline import (NotPortedError, Pipeline, make_element,
                       parse_launch, register_element)
from . import elements  # noqa: F401  (registers tensor_* elements)
from . import decoders  # noqa: F401  (registers decoder modes)
from . import filters  # noqa: F401  (registers filter backends)
from . import models  # noqa: F401  (registers zoo models)
from . import fleet  # noqa: F401  (registers tensor_autoscaler)
from .single import SingleShot

__all__ = [
    "Buffer", "Chunk", "Caps", "TensorInfo", "TensorsInfo", "TensorsConfig",
    "TensorType", "TensorFormat", "Pipeline", "parse_launch", "make_element",
    "register_element", "NotPortedError", "SingleShot", "__version__",
]
