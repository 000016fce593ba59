"""TensorInfo / TensorsInfo / TensorsConfig.

Semantic equivalent of GstTensorInfo/GstTensorsInfo/GstTensorsConfig and the
dimension-string grammar of the reference
(ref: gst/nnstreamer/nnstreamer_plugin_api_util_impl.c — parse/compare/copy
dimension helpers; tensor_typedef.h:273-289 struct layout).

Dimension strings are reference-compatible: ``"3:224:224"`` is
innermost-first (channel:width:height for NHWC video). Internally we keep
NumPy/PyTorch order (outermost-first), i.e. that string parses to shape
``(224, 224, 3)``. Trailing ``:1`` padding is accepted and **stripped** on
parse (the reference pads ranks with 1s, so ``"3:224:224:1"`` equals
``"3:224:224"`` and also parses to ``(224, 224, 3)``);
``dim_string()`` emits the minimal form.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence, Tuple

from .types import RANK_LIMIT, TENSOR_COUNT_LIMIT, TensorFormat, TensorType


def parse_dimension(dim_str: str) -> Tuple[int, ...]:
    """Parse a reference-style dimension string into a NumPy-order shape.

    ``"3:224:224:2"`` -> ``(2, 224, 224, 3)``; trailing 1s are rank padding
    and are stripped, so ``"3:224:224:1"`` -> ``(224, 224, 3)`` (the
    reference pads ranks with 1s, nnstreamer_plugin_api_util_impl.c
    dimension parsing). ``0`` terminates the dimension (unspecified
    remainder), matching the reference.
    """
    dim_str = dim_str.strip()
    if not dim_str:
        return ()
    parts = dim_str.split(":")
    if len(parts) > RANK_LIMIT:
        raise ValueError(f"rank {len(parts)} exceeds limit {RANK_LIMIT}")
    dims = []
    for p in parts:
        v = int(p)
        if v == 0:
            break  # 0 terminates: remainder unspecified
        if v < 0:
            raise ValueError(f"negative dimension in {dim_str!r}")
        dims.append(v)
    # strip trailing 1-padding (innermost-first order: padding is at the end)
    while len(dims) > 1 and dims[-1] == 1:
        dims.pop()
    return tuple(reversed(dims))


def serialize_dimension(shape: Sequence[int], rank: Optional[int] = None) -> str:
    """NumPy-order shape -> reference-style innermost-first string.

    ``(1, 224, 224, 3)`` -> ``"3:224:224:1"``. If ``rank`` is given, pad
    with 1s up to that rank.
    """
    dims = list(reversed([int(d) for d in shape]))
    if not dims:
        dims = [1]
    if rank is not None:
        if rank < len(dims):
            raise ValueError(f"rank {rank} < len(shape) {len(dims)}")
        dims += [1] * (rank - len(dims))
    return ":".join(str(d) for d in dims)


@dataclasses.dataclass
class TensorInfo:
    """One tensor's name, element type, and shape (ref: GstTensorInfo)."""

    name: Optional[str] = None
    type: Optional[TensorType] = None
    shape: Tuple[int, ...] = ()

    @classmethod
    def make(cls, type: "TensorType | str", dim: "str | Sequence[int]",
             name: Optional[str] = None) -> "TensorInfo":
        if isinstance(type, str):
            type = TensorType.from_string(type)
        shape = parse_dimension(dim) if isinstance(dim, str) else tuple(int(d) for d in dim)
        return cls(name=name, type=type, shape=shape)

    @property
    def num_elements(self) -> int:
        return math.prod(self.shape) if self.shape else 0

    @property
    def size_bytes(self) -> int:
        if self.type is None:
            return 0
        return self.num_elements * self.type.element_size

    def is_valid(self) -> bool:
        return (
            self.type is not None
            and len(self.shape) >= 1
            and all(d > 0 for d in self.shape)
        )

    def dim_string(self, rank: Optional[int] = None) -> str:
        return serialize_dimension(self.shape, rank)

    def is_equal(self, other: "TensorInfo") -> bool:
        """Type+shape equality, ignoring names and size-1 padding dims
        (ref: gst_tensor_info_is_equal — dims compare padded with 1s to
        rank 16; in numpy order the padding 1s are leading)."""

        def norm(shape: Tuple[int, ...]) -> Tuple[int, ...]:
            s = tuple(shape)
            while len(s) > 1 and s[0] == 1:
                s = s[1:]
            return s

        return self.type == other.type and \
            norm(self.shape) == norm(other.shape)

    def copy(self) -> "TensorInfo":
        return TensorInfo(self.name, self.type, tuple(self.shape))

    def __str__(self) -> str:
        t = str(self.type) if self.type is not None else "?"
        return f"{self.name or ''}[{t}:{self.dim_string()}]"


class TensorsInfo:
    """Ordered collection of TensorInfo (ref: GstTensorsInfo)."""

    def __init__(self, infos: Iterable[TensorInfo] = ()):  # noqa: D107
        self._infos = list(infos)
        if len(self._infos) > TENSOR_COUNT_LIMIT:
            raise ValueError(
                f"{len(self._infos)} tensors exceeds limit {TENSOR_COUNT_LIMIT}")

    @classmethod
    def make(cls, types: "str | Sequence", dims: "str | Sequence",
             names: Optional[Sequence[Optional[str]]] = None) -> "TensorsInfo":
        """Build from property-style strings: types="uint8,float32",
        dims="3:224:224,10:1" (ref: property parsing in tensor_filter_common.c).
        """
        if isinstance(types, str):
            types = [t for t in types.split(",") if t.strip()]
        if isinstance(dims, str):
            dims = [d for d in dims.split(",") if d.strip()]
        if len(types) != len(dims):
            raise ValueError("types/dims count mismatch")
        names = names or [None] * len(types)
        return cls(
            TensorInfo.make(t, d, n) for t, d, n in zip(types, dims, names))

    def __len__(self) -> int:
        return len(self._infos)

    def __getitem__(self, i: int) -> TensorInfo:
        return self._infos[i]

    def __iter__(self):
        return iter(self._infos)

    def append(self, info: TensorInfo) -> None:
        if len(self._infos) >= TENSOR_COUNT_LIMIT:
            raise ValueError("tensor count limit exceeded")
        self._infos.append(info)

    def is_valid(self) -> bool:
        return len(self._infos) > 0 and all(i.is_valid() for i in self._infos)

    def is_equal(self, other: "TensorsInfo") -> bool:
        return len(self) == len(other) and all(
            a.is_equal(b) for a, b in zip(self, other))

    def total_size_bytes(self) -> int:
        return sum(i.size_bytes for i in self._infos)

    def copy(self) -> "TensorsInfo":
        return TensorsInfo(i.copy() for i in self._infos)

    def types_string(self) -> str:
        return ",".join(str(i.type) for i in self._infos)

    def dims_string(self, rank: Optional[int] = None) -> str:
        return ",".join(i.dim_string(rank) for i in self._infos)

    def names_string(self) -> str:
        return ",".join(i.name or "" for i in self._infos)

    def __repr__(self) -> str:
        return f"TensorsInfo({', '.join(str(i) for i in self._infos)})"


@dataclasses.dataclass
class TensorsConfig:
    """Stream configuration: infos + format + framerate
    (ref: GstTensorsConfig, tensor_typedef.h:284-289)."""

    info: TensorsInfo = dataclasses.field(default_factory=TensorsInfo)
    format: TensorFormat = TensorFormat.STATIC
    rate_n: int = 0   # framerate numerator; 0/1 = unknown-rate stream
    rate_d: int = 1

    def is_valid(self) -> bool:
        if self.rate_d <= 0 or self.rate_n < 0:
            return False
        if self.format == TensorFormat.STATIC:
            return self.info.is_valid()
        return True  # flexible/sparse: per-buffer meta carries shape

    def is_equal(self, other: "TensorsConfig") -> bool:
        if self.format != other.format:
            return False
        if (self.rate_n * other.rate_d) != (other.rate_n * self.rate_d):
            return False
        if self.format == TensorFormat.STATIC:
            return self.info.is_equal(other.info)
        return True

    def copy(self) -> "TensorsConfig":
        return TensorsConfig(self.info.copy(), self.format, self.rate_n, self.rate_d)

    @property
    def framerate(self) -> float:
        return self.rate_n / self.rate_d if self.rate_d else 0.0

    def frame_duration_ns(self) -> Optional[int]:
        if self.rate_n <= 0:
            return None
        return int(round(1e9 * self.rate_d / self.rate_n))
