"""Minimal FlatBuffers *builder* (serialization side).

A copy of ``nnstreamer_tpu/interop/flatbuild.py`` (plain Python).

Counterpart of the schema-less reader in interop/flatbuf.py — that one
was written to parse TFLite files; this one emits buffers for the
nnstreamer tensor schema (ref: ext/nnstreamer/include/nnstreamer.fbs).
Implemented from the FlatBuffers wire-format rules (little-endian,
buffers grow downward, tables point back at vtables); reader and writer
being independent implementations makes round-trip tests a real format
check, not self-confirmation.

Supported: scalar/struct/offset table fields, u8/u32/offset vectors,
strings. That covers the Tensors schema and similar message schemas.

Coordinates: the buffer is built back-to-front; every returned position
is a byte distance from the END of the final buffer to the START of the
object (the conventional uoffset space).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple


class Builder:
    def __init__(self):
        # bytes stored in reverse: final buffer = reversed(self._rev)
        self._rev = bytearray()
        self._minalign = 4
        self._vtables: Dict[Tuple, int] = {}
        self._fields: Optional[List[Tuple[int, int]]] = None
        self._table_mark = 0

    # -- low-level ----------------------------------------------------------
    @property
    def offset(self) -> int:
        """Bytes written so far = end-offset of the last written byte."""
        return len(self._rev)

    def _write(self, data: bytes) -> None:
        """Write toward the front of the final buffer."""
        self._rev.extend(reversed(data))

    def _align(self, size: int, extra: int = 0) -> None:
        self._minalign = max(self._minalign, size)
        while (len(self._rev) + extra) % size != 0:
            self._rev.append(0)

    def _scalar(self, fmt: str, value) -> None:
        self._write(struct.pack("<" + fmt, value))

    def _uoffset(self, target: int) -> None:
        """u32 relative offset: value = slot_pos - target_pos."""
        self._align(4, extra=4)
        slot = self.offset + 4
        assert target <= self.offset, "forward reference"
        self._scalar("I", slot - target)

    # -- strings / vectors ---------------------------------------------------
    def create_string(self, s: str) -> int:
        data = s.encode("utf-8")
        # align FIRST: writing back-to-front, padding emitted here lands
        # at higher addresses than the payload, i.e. after the NUL —
        # padding between length and chars would corrupt the string
        self._align(4, extra=len(data) + 1 + 4)
        self._write(b"\0")          # NUL sits after the chars
        self._write(data)
        self._scalar("I", len(data))
        return self.offset

    def create_vector_u8(self, data: bytes) -> int:
        self._align(4, extra=len(data) + 4)
        self._write(bytes(data))
        self._scalar("I", len(data))
        return self.offset

    def create_vector_u32(self, values) -> int:
        vals = [int(v) for v in values]
        self._align(4)
        for v in reversed(vals):
            self._scalar("I", v)
        self._scalar("I", len(vals))
        return self.offset

    def create_vector_offsets(self, offsets: List[int]) -> int:
        self._align(4)
        for off in reversed(offsets):
            self._uoffset(off)
        self._scalar("I", len(offsets))
        return self.offset

    # -- tables --------------------------------------------------------------
    _SCALAR_SIZE = {"b": 1, "B": 1, "h": 2, "H": 2, "i": 4, "I": 4,
                    "q": 8, "Q": 8, "f": 4, "d": 8}

    def start_table(self) -> None:
        assert self._fields is None, "nested start_table"
        self._fields = []
        self._table_mark = self.offset

    def add_scalar(self, fid: int, fmt: str, value, default=0) -> None:
        if value == default:
            return
        size = self._SCALAR_SIZE[fmt]
        self._align(size)
        self._scalar(fmt, value)
        self._fields.append((fid, self.offset))

    def add_offset(self, fid: int, target: Optional[int]) -> None:
        if not target:
            return
        self._uoffset(target)
        self._fields.append((fid, self.offset))

    def add_struct(self, fid: int, data: bytes, align: int = 4) -> None:
        """Structs are stored inline in the table."""
        self._align(align)
        self._write(data)
        self._fields.append((fid, self.offset))

    def end_table(self) -> int:
        fields, self._fields = self._fields, None
        self._align(4, extra=4)
        table_pos = self.offset + 4      # start once the soffset is written
        nfields = (max(f[0] for f in fields) + 1) if fields else 0
        # vtable slots: distance from table start back to each field
        slots = [0] * nfields
        for fid, off in fields:
            slots[fid] = table_pos - off
        table_size = table_pos - self._table_mark
        vt_key = (table_size, tuple(slots))
        existing = self._vtables.get(vt_key)
        if existing is not None:
            # shared vtable written earlier: negative signed distance
            self._scalar("i", existing - table_pos)
            return self.offset
        # fresh vtable placed immediately before the table in address
        # space, so soffset = vtable_pos - table_pos = +vt_bytes exactly
        vt_bytes = 4 + 2 * nfields
        self._scalar("i", vt_bytes)
        self._write(struct.pack("<HH", vt_bytes, table_size)
                    + b"".join(struct.pack("<H", s) for s in slots))
        self._vtables[vt_key] = self.offset  # vtable position
        return table_pos

    def finish(self, root: int) -> bytes:
        self._align(self._minalign, extra=4)
        self._uoffset(root)
        return bytes(reversed(self._rev))
