"""Minimal FlatBuffers reader — enough to walk a .tflite model.

A copy of ``nnstreamer_tpu/interop/flatbuf.py`` (plain Python and numpy).

No generated code, no `flatbuffers` dependency: just the wire format
(https://flatbuffers.dev/internals): a root uoffset, tables with signed
vtable offsets, vtables of uint16 field offsets, vectors/strings with a
uint32 length prefix. Field ids follow the schema declaration order.

Used by interop/tflite.py; the reference links the real FlatBuffers C++
runtime instead (ext/nnstreamer/tensor_filter/tensor_filter_tensorflow_lite.cc
and tensor_decoder/tensordec-flatbuf.cc).
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np


class FlatBuf:
    """Random-access reader over one FlatBuffers blob."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)

    # -- scalars -----------------------------------------------------------
    def u8(self, pos: int) -> int:
        return self.buf[pos]

    def i8(self, pos: int) -> int:
        return struct.unpack_from("<b", self.buf, pos)[0]

    def u16(self, pos: int) -> int:
        return struct.unpack_from("<H", self.buf, pos)[0]

    def i16(self, pos: int) -> int:
        return struct.unpack_from("<h", self.buf, pos)[0]

    def u32(self, pos: int) -> int:
        return struct.unpack_from("<I", self.buf, pos)[0]

    def i32(self, pos: int) -> int:
        return struct.unpack_from("<i", self.buf, pos)[0]

    def i64(self, pos: int) -> int:
        return struct.unpack_from("<q", self.buf, pos)[0]

    def f32(self, pos: int) -> float:
        return struct.unpack_from("<f", self.buf, pos)[0]

    def f64(self, pos: int) -> float:
        return struct.unpack_from("<d", self.buf, pos)[0]

    # -- structure ---------------------------------------------------------
    def root(self) -> int:
        """Position of the root table."""
        return self.u32(0)

    def field(self, table: int, fid: int) -> Optional[int]:
        """Absolute position of field `fid`'s data in `table`, or None if
        absent (deserializers must then use the schema default)."""
        vtable = table - self.i32(table)
        vtsize = self.u16(vtable)
        entry = 4 + fid * 2
        if entry >= vtsize:
            return None
        voff = self.u16(vtable + entry)
        if voff == 0:
            return None
        return table + voff

    def indirect(self, pos: int) -> int:
        """Follow a uoffset at `pos` (table/vector/string fields)."""
        return pos + self.u32(pos)

    # -- field convenience -------------------------------------------------
    def field_scalar(self, table: int, fid: int, kind: str, default=0):
        pos = self.field(table, fid)
        if pos is None:
            return default
        return getattr(self, kind)(pos)

    def field_table(self, table: int, fid: int) -> Optional[int]:
        pos = self.field(table, fid)
        return None if pos is None else self.indirect(pos)

    def field_string(self, table: int, fid: int,
                     default: str = "") -> str:
        pos = self.field(table, fid)
        if pos is None:
            return default
        spos = self.indirect(pos)
        n = self.u32(spos)
        return bytes(self.buf[spos + 4:spos + 4 + n]).decode("utf-8")

    # -- vectors -----------------------------------------------------------
    def vector_len(self, vpos: int) -> int:
        return self.u32(vpos)

    def field_vector(self, table: int, fid: int) -> Optional[int]:
        """Position of the length prefix of a vector field, or None."""
        pos = self.field(table, fid)
        return None if pos is None else self.indirect(pos)

    def vector_tables(self, vpos: int):
        """Iterate table positions in a [Table] vector."""
        n = self.u32(vpos)
        for i in range(n):
            yield self.indirect(vpos + 4 + i * 4)

    def field_np(self, table: int, fid: int, dtype) -> Optional[np.ndarray]:
        """A scalar vector field as a numpy array (zero-copy view)."""
        vpos = self.field_vector(table, fid)
        if vpos is None:
            return None
        n = self.u32(vpos)
        dt = np.dtype(dtype).newbyteorder("<")
        return np.frombuffer(self.buf, dtype=dt, count=n,
                             offset=vpos + 4)
