"""Tensor type system: dtypes, shapes, caps, frames, meta headers."""
from .buffer import Buffer, BufferFlags, Chunk, is_device_tensor
from .caps import AltSet, Caps, CapsStructure, FractionRange, IntRange
from .info import (TensorInfo, TensorsConfig, TensorsInfo, parse_dimension,
                   serialize_dimension)
from .meta import HEADER_SIZE, TensorMetaInfo
from .types import (MIMETYPE_TENSORS, RANK_LIMIT, TENSOR_COUNT_LIMIT,
                    MediaType, TensorFormat, TensorLayout, TensorType)

__all__ = [
    "Buffer", "BufferFlags", "Chunk", "is_device_tensor", "Caps",
    "CapsStructure", "AltSet", "IntRange", "FractionRange", "TensorInfo",
    "TensorsInfo", "TensorsConfig", "parse_dimension", "serialize_dimension",
    "TensorMetaInfo", "HEADER_SIZE", "TensorType", "TensorFormat",
    "TensorLayout", "MediaType", "MIMETYPE_TENSORS", "RANK_LIMIT",
    "TENSOR_COUNT_LIMIT",
]
