"""Tensor frames flowing through the pipeline.

Port of ``nnstreamer_tpu/tensors/buffer.py`` (the analog of a GstBuffer
carrying N tensor memories, ref: gst/nnstreamer/nnstreamer_plugin_api_impl.c).

A chunk holds a host ``np.ndarray`` (or raw bytes), a CPU
``torch.Tensor``, or a CUDA ``torch.Tensor``. Only the last is
device-resident: chained device-side elements hand CUDA tensors to each
other, and only decoder/sink boundaries call :meth:`Chunk.host`.

Not ported yet: ``PendingHost`` chunks (the prefetch-host D2H fetch
service, ``tensors/fetch.py`` and ``tensors/transfer.py``).
"""
from __future__ import annotations

import enum
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from .info import TensorInfo, TensorsInfo
from .meta import TensorMetaInfo
from .types import TensorType

_RAW = (bytes, bytearray, memoryview)


def is_device_tensor(x) -> bool:
    """True for a tensor that lives on the card."""
    return isinstance(x, torch.Tensor) and x.device.type == "cuda"


class BufferFlags(enum.IntFlag):
    NONE = 0
    DISCONT = 1     # stream discontinuity
    GAP = 2         # filler frame
    DROPPABLE = 4   # QoS may drop


class Chunk:
    """One tensor memory.

    ``meta`` is present on flexible/sparse streams (self-describing header,
    ref: GstTensorMetaInfo); static streams rely on negotiated caps.
    """

    __slots__ = ("_data", "meta")

    def __init__(self, data: Any, meta: Optional[TensorMetaInfo] = None):
        self._data = data
        self.meta = meta

    # -- residency --------------------------------------------------------
    @property
    def is_device(self) -> bool:
        return is_device_tensor(self._data)

    @property
    def raw(self) -> Any:
        """The underlying array, wherever it lives."""
        return self._data

    def host(self) -> Union[np.ndarray, torch.Tensor]:
        """Materialize on the host (D2H copy if device-resident).

        Returns an ``np.ndarray``, except for bfloat16 data: numpy has no
        bf16, so that comes back as a CPU ``torch.Tensor``."""
        d = self._data
        if isinstance(d, np.ndarray):
            return d
        if isinstance(d, _RAW):
            return np.frombuffer(d, dtype=np.uint8)
        if isinstance(d, torch.Tensor):
            d = d.detach().cpu()
            return d if d.dtype == torch.bfloat16 else d.numpy()
        return np.asarray(d)

    def device(self, device: Union[str, torch.device] = "cuda",
               non_blocking: bool = False) -> torch.Tensor:
        """Materialize as a tensor on ``device`` (H2D copy if needed)."""
        d = self._data
        if isinstance(d, _RAW):
            d = self.host()
        if isinstance(d, np.ndarray):
            d = torch.from_numpy(np.ascontiguousarray(d))
        return d.to(device, non_blocking=non_blocking)

    # -- shape/dtype ------------------------------------------------------
    @property
    def shape(self):
        d = self._data
        if isinstance(d, _RAW):
            return (len(d),)
        return tuple(d.shape)

    @property
    def dtype(self):
        """numpy dtype for host arrays, ``torch.dtype`` for tensors."""
        d = self._data
        if isinstance(d, _RAW):
            return np.dtype(np.uint8)
        if isinstance(d, torch.Tensor):
            return d.dtype
        return np.dtype(d.dtype)

    @property
    def type(self) -> TensorType:
        return TensorType.from_dtype(self.dtype)

    @property
    def nbytes(self) -> int:
        d = self._data
        if isinstance(d, _RAW):
            return len(d)
        return int(np.prod(self.shape)) * self.type.element_size

    def to_info(self, name: Optional[str] = None) -> TensorInfo:
        return TensorInfo(name=name, type=self.type, shape=self.shape)

    def __repr__(self) -> str:
        loc = "dev" if self.is_device else "host"
        return f"Chunk<{loc}:{self.type}:{self.shape}>"


class Buffer:
    """One frame: ordered chunks + timing metadata.

    Timing fields are nanoseconds, mirroring GstBuffer pts/dts/duration.
    """

    __slots__ = ("chunks", "pts", "dts", "duration", "flags", "extras")

    def __init__(self, chunks: Sequence[Chunk] = (), pts: Optional[int] = None,
                 dts: Optional[int] = None, duration: Optional[int] = None,
                 flags: BufferFlags = BufferFlags.NONE):
        self.chunks: List[Chunk] = list(chunks)
        self.pts = pts
        self.dts = dts
        self.duration = duration
        self.flags = flags
        self.extras: dict = {}  # side-band metadata (e.g. decoded label)

    @classmethod
    def from_arrays(cls, arrays: Sequence[Any], **kw) -> "Buffer":
        return cls([a if isinstance(a, Chunk) else Chunk(a) for a in arrays], **kw)

    def __len__(self) -> int:
        return len(self.chunks)

    def __getitem__(self, i: int) -> Chunk:
        return self.chunks[i]

    def __iter__(self):
        return iter(self.chunks)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    def to_infos(self) -> TensorsInfo:
        return TensorsInfo(c.to_info() for c in self.chunks)

    def with_chunks(self, chunks: Sequence[Chunk]) -> "Buffer":
        """New buffer reusing this one's timing metadata."""
        b = Buffer(chunks, self.pts, self.dts, self.duration, self.flags)
        b.extras = dict(self.extras)
        return b

    def copy_meta_from(self, other: "Buffer") -> "Buffer":
        self.pts, self.dts = other.pts, other.dts
        self.duration, self.flags = other.duration, other.flags
        self.extras = dict(other.extras)
        return self

    def __repr__(self) -> str:
        return f"Buffer(pts={self.pts}, chunks={self.chunks!r})"
