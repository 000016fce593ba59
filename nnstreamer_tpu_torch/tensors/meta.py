"""Per-memory self-describing tensor header for flexible/sparse streams.

Semantic equivalent of GstTensorMetaInfo and its (de)serialization
(ref: gst/nnstreamer/tensor_meta.c — gst_tensor_meta_info_parse_header /
update_header / append_header; struct at include/tensor_typedef.h:310-326).

Binary layout (little-endian, fixed 128 bytes):
    magic     u32   0x54504e4e ("NNPT")
    version   u32   1
    type      i32   TensorType value (-1 = unknown)
    format    i32   TensorFormat value
    media     i32   MediaType value
    rank      u32   number of valid dims
    dims      u32 x 16  innermost-first, 1-padded (reference dim order)
    nnz       u64   sparse: number of non-zero elements (0 otherwise)
    reserved        zero padding to 128 bytes
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

from .info import TensorInfo
from .types import RANK_LIMIT, MediaType, TensorFormat, TensorType

HEADER_MAGIC = 0x54504E4E
HEADER_VERSION = 1
HEADER_SIZE = 128

_FIXED = struct.Struct("<IIiiiI16IQ")  # 24 + 64 + 8 = 96 bytes, zero-pad to 128


@dataclass
class TensorMetaInfo:
    """Self-describing header prepended to each flexible/sparse chunk."""

    type: Optional[TensorType] = None
    format: TensorFormat = TensorFormat.FLEXIBLE
    media_type: MediaType = MediaType.TENSOR
    shape: Tuple[int, ...] = ()   # NumPy order, like TensorInfo
    nnz: int = 0                  # sparse only

    @classmethod
    def from_info(cls, info: TensorInfo,
                  format: TensorFormat = TensorFormat.FLEXIBLE,
                  media_type: MediaType = MediaType.TENSOR,
                  nnz: int = 0) -> "TensorMetaInfo":
        return cls(info.type, format, media_type, tuple(info.shape), nnz)

    def to_info(self) -> TensorInfo:
        return TensorInfo(type=self.type, shape=tuple(self.shape))

    @property
    def data_size_bytes(self) -> int:
        """Payload size for a dense chunk with this header."""
        if self.type is None:
            return 0
        return math.prod(self.shape or (0,)) * self.type.element_size

    def pack(self) -> bytes:
        if len(self.shape) > RANK_LIMIT:
            raise ValueError(
                f"rank {len(self.shape)} exceeds limit {RANK_LIMIT}")
        dims = list(reversed(self.shape))
        rank = len(dims)
        dims += [1] * (RANK_LIMIT - len(dims))
        body = _FIXED.pack(
            HEADER_MAGIC, HEADER_VERSION,
            int(self.type) if self.type is not None else -1,
            int(self.format), int(self.media_type), rank, *dims, self.nnz)
        return body + b"\x00" * (HEADER_SIZE - len(body))

    @classmethod
    def unpack(cls, data: bytes) -> "TensorMetaInfo":
        if len(data) < HEADER_SIZE:
            raise ValueError(f"header too short: {len(data)} < {HEADER_SIZE}")
        vals = _FIXED.unpack(bytes(data[:_FIXED.size]))
        magic, version, ttype, tformat, media, rank = vals[:6]
        dims, nnz = vals[6:6 + RANK_LIMIT], vals[6 + RANK_LIMIT]
        if magic != HEADER_MAGIC:
            raise ValueError(f"bad meta magic 0x{magic:08x}")
        if version != HEADER_VERSION:
            raise ValueError(f"unsupported meta version {version}")
        shape = tuple(reversed(dims[:rank]))
        return cls(
            TensorType(ttype) if ttype >= 0 else None,
            TensorFormat(tformat), MediaType(media), shape, nnz)
