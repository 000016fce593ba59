"""Tensor element types, stream formats, and layouts.

Port of ``nnstreamer_tpu/tensors/types.py``: the same enums with the same
integer values (ref: gst/nnstreamer/include/tensor_typedef.h:138-226), so
caps strings and serialized streams stay interchangeable between the two
packages.

What differs: every type maps to a ``torch.dtype`` as well as a numpy
dtype, and ``BFLOAT16`` has no numpy dtype at all. numpy has no bf16 and
the port does not borrow one from JAX or ``ml_dtypes``: bf16 host data
stays a CPU ``torch.Tensor``, or is widened explicitly by the caller.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

# Rank limit matches the reference (tensor_typedef.h:34).
RANK_LIMIT = 16
# Max tensors per frame (tensor_typedef.h:42); a soft cap for caps
# validation only -- buffers are plain lists.
TENSOR_COUNT_LIMIT = 256


class TensorType(enum.IntEnum):
    """Element dtype of one tensor (ref: tensor_typedef.h:141-153).

    Integer values match the reference enum; BFLOAT16 is appended after
    the reference's last value, as in the JAX package.
    """

    INT32 = 0
    UINT32 = 1
    INT16 = 2
    UINT16 = 3
    INT8 = 4
    UINT8 = 5
    FLOAT64 = 6
    FLOAT32 = 7
    INT64 = 8
    UINT64 = 9
    FLOAT16 = 10
    BFLOAT16 = 11

    @property
    def np_dtype(self) -> np.dtype:
        if self is TensorType.BFLOAT16:
            raise TypeError("bfloat16 has no numpy dtype; keep it as a "
                            "torch.Tensor (TensorType.torch_dtype) or widen "
                            "it to float32 explicitly")
        return np.dtype(_TYPE_NAMES[self])

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self]

    @property
    def element_size(self) -> int:
        return _ELEMENT_SIZES[self]

    def __str__(self) -> str:  # caps-string form
        return _TYPE_NAMES[self]

    @classmethod
    def from_string(cls, name: str) -> "TensorType":
        try:
            return _TYPE_BY_NAME[name.strip().lower()]
        except KeyError:
            raise ValueError(f"unknown tensor type {name!r}") from None

    @classmethod
    def from_dtype(cls, dtype) -> "TensorType":
        """From a ``torch.dtype``, a numpy dtype (or anything
        ``np.dtype`` takes), or a type name."""
        if isinstance(dtype, torch.dtype):
            try:
                return _TYPE_BY_TORCH[dtype]
            except KeyError:
                raise ValueError(f"unsupported dtype {dtype!r}") from None
        if str(dtype) == "bfloat16":
            return cls.BFLOAT16
        try:
            return _TYPE_BY_NAME[np.dtype(dtype).name]
        except (KeyError, TypeError):
            raise ValueError(f"unsupported dtype {dtype!r}") from None


_TYPE_NAMES = {
    TensorType.INT32: "int32",
    TensorType.UINT32: "uint32",
    TensorType.INT16: "int16",
    TensorType.UINT16: "uint16",
    TensorType.INT8: "int8",
    TensorType.UINT8: "uint8",
    TensorType.FLOAT64: "float64",
    TensorType.FLOAT32: "float32",
    TensorType.INT64: "int64",
    TensorType.UINT64: "uint64",
    TensorType.FLOAT16: "float16",
    TensorType.BFLOAT16: "bfloat16",
}
_TYPE_BY_NAME = {v: k for k, v in _TYPE_NAMES.items()}

_TORCH_DTYPES = {
    TensorType.INT32: torch.int32,
    TensorType.UINT32: torch.uint32,
    TensorType.INT16: torch.int16,
    TensorType.UINT16: torch.uint16,
    TensorType.INT8: torch.int8,
    TensorType.UINT8: torch.uint8,
    TensorType.FLOAT64: torch.float64,
    TensorType.FLOAT32: torch.float32,
    TensorType.INT64: torch.int64,
    TensorType.UINT64: torch.uint64,
    TensorType.FLOAT16: torch.float16,
    TensorType.BFLOAT16: torch.bfloat16,
}
_TYPE_BY_TORCH = {v: k for k, v in _TORCH_DTYPES.items()}

_ELEMENT_SIZES = {t: torch.empty((), dtype=d).element_size()
                  for t, d in _TORCH_DTYPES.items()}


class TensorFormat(enum.IntEnum):
    """Stream data format (ref: tensor_typedef.h:193-200)."""

    STATIC = 0
    FLEXIBLE = 1
    SPARSE = 2

    def __str__(self) -> str:
        return self.name.lower()

    @classmethod
    def from_string(cls, name: str) -> "TensorFormat":
        try:
            return cls[name.strip().upper()]
        except KeyError:
            raise ValueError(f"unknown tensor format {name!r}") from None


class TensorLayout(enum.IntEnum):
    """Memory layout hint (ref: tensor_typedef.h:220-226)."""

    ANY = 0
    NHWC = 1
    NCHW = 2
    NONE = 3


class MediaType(enum.IntEnum):
    """Input media types for conversion (ref: tensor_typedef.h:176-187)."""

    INVALID = -1
    VIDEO = 0
    AUDIO = 1
    TEXT = 2
    OCTET = 3
    TENSOR = 4
    ANY = 0x1000


# Mimetype string for caps (ref: tensor_typedef.h:97).
MIMETYPE_TENSORS = "other/tensors"
