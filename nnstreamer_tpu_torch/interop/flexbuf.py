"""FlexBuffers (schema-less FlatBuffers) writer + reader subset.

A copy of ``nnstreamer_tpu/interop/flexbuf.py`` (plain Python).

≙ the flexbuffers library the reference links for its flexbuf codec
subplugins (ext/nnstreamer/tensor_decoder/tensordec-flexbuf.cc,
tensor_converter/tensor_converter_flexbuf.cc). Implements the wire
format from its published rules: values are inline scalars or backward
relative offsets, type bytes are ``(type << 2) | width_code``, maps are
a values-vector plus a sorted keys-vector, and the root value + type +
width live in the last bytes of the buffer.

Subset: maps with string keys, untyped vectors, signed/unsigned ints,
floats, strings, keys, and blobs — what the tensor codec needs. The
writer always uses 32-bit slots (valid, just not minimal-width); the
reader honors per-object byte widths, so minimal-width buffers from
other producers parse too.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Union

# type ids (flexbuffers.h)
NULL, INT, UINT, FLOAT, KEY, STRING = 0, 1, 2, 3, 4, 5
MAP, VECTOR = 9, 10
VECTOR_KEY = 14
BLOB, BOOL = 25, 26

_W = 4          # slot/length byte width used by the writer
_WCODE = 2      # width code for 4 bytes


class Writer:
    def __init__(self):
        self._buf = bytearray()

    # -- leaf values ---------------------------------------------------------
    def _align(self, n: int) -> None:
        while len(self._buf) % n:
            self._buf.append(0)

    def write_key(self, s: str) -> int:
        pos = len(self._buf)
        self._buf += s.encode("utf-8") + b"\0"
        return pos

    def write_string(self, s: str) -> int:
        data = s.encode("utf-8")
        self._align(_W)
        self._buf += struct.pack("<I", len(data))
        pos = len(self._buf)
        self._buf += data + b"\0"
        return pos

    def write_blob(self, data: bytes) -> int:
        self._align(_W)
        self._buf += struct.pack("<I", len(data))
        pos = len(self._buf)
        self._buf += bytes(data)
        return pos

    # -- composites ----------------------------------------------------------
    def _write_offset_slot(self, target: int) -> None:
        slot = len(self._buf)
        self._buf += struct.pack("<I", slot - target)

    def _write_value_slot(self, v: "_Val") -> None:
        if v.inline:
            self._buf += struct.pack("<i" if v.type == INT else "<I"
                                     if v.type in (UINT, BOOL) else "<f",
                                     v.value)
        else:
            self._write_offset_slot(v.value)

    def write_vector(self, items: List["_Val"]) -> "_Val":
        self._align(_W)
        self._buf += struct.pack("<I", len(items))
        pos = len(self._buf)
        for v in items:
            self._write_value_slot(v)
        for v in items:
            self._buf.append((v.type << 2) | _WCODE)
        return _Val(VECTOR, pos, inline=False)

    def write_map(self, entries: Dict[str, "_Val"]) -> "_Val":
        # keys must be stored sorted (lookup contract of the format)
        names = sorted(entries)
        key_pos = [self.write_key(k) for k in names]
        # keys vector: typed VECTOR_KEY (length + offset slots, no types)
        self._align(_W)
        self._buf += struct.pack("<I", len(names))
        keys_vec = len(self._buf)
        for kp in key_pos:
            self._write_offset_slot(kp)
        # map: [keys_offset][keys_width][length][value slots][type bytes]
        self._align(_W)
        self._write_offset_slot(keys_vec)
        self._buf += struct.pack("<I", _W)
        self._buf += struct.pack("<I", len(names))
        pos = len(self._buf)
        for k in names:
            self._write_value_slot(entries[k])
        for k in names:
            v = entries[k]
            self._buf.append((v.type << 2) | _WCODE)
        return _Val(MAP, pos, inline=False)

    def finish(self, root: "_Val") -> bytes:
        self._align(_W)
        if root.inline:
            self._buf += struct.pack("<i" if root.type == INT else "<I",
                                     root.value)
        else:
            self._write_offset_slot(root.value)
        self._buf.append((root.type << 2) | _WCODE)
        self._buf.append(_W)
        return bytes(self._buf)


class _Val:
    """A value to be placed in a slot: inline scalar or offset."""

    __slots__ = ("type", "value", "inline")

    def __init__(self, type_: int, value, inline: bool):
        self.type, self.value, self.inline = type_, value, inline


def val_int(v: int) -> _Val:
    return _Val(INT, int(v), True)


def val_uint(v: int) -> _Val:
    return _Val(UINT, int(v), True)


# -- reader -------------------------------------------------------------------

class Ref:
    """A decoded reference into a flexbuffer.

    Two widths matter, per the format: ``slot_width`` (the parent's
    element width — how to read THIS value slot, inline scalar or
    offset) and ``byte_width`` from the packed type byte (the width of
    the referenced object's internal scalars: length prefixes, vector
    element slots).
    """

    def __init__(self, buf: bytes, pos: int, type_: int,
                 slot_width: int, byte_width: int):
        self._buf = buf
        self._pos = pos        # position of the value slot
        self._type = type_
        self._sw = slot_width
        self._bw = byte_width

    # scalar readers keyed by width
    def _read_scalar(self, pos: int, width: int, signed: bool) -> int:
        raw = self._buf[pos:pos + width]
        return int.from_bytes(raw, "little", signed=signed)

    def _indirect(self) -> int:
        return self._pos - self._read_scalar(self._pos, self._sw,
                                             signed=False)

    @property
    def type(self) -> int:
        return self._type

    def as_int(self) -> int:
        return self._read_scalar(self._pos, self._sw,
                                 signed=self._type == INT)

    def as_float(self) -> float:
        fmt = "<f" if self._sw == 4 else "<d"
        return struct.unpack_from(fmt, self._buf, self._pos)[0]

    def as_str(self) -> str:
        tgt = self._indirect()
        if self._type == KEY:
            end = self._buf.index(b"\0", tgt)
            return self._buf[tgt:end].decode("utf-8")
        n = self._read_scalar(tgt - self._bw, self._bw, signed=False)
        return self._buf[tgt:tgt + n].decode("utf-8")

    def as_blob(self) -> bytes:
        tgt = self._indirect()
        n = self._read_scalar(tgt - self._bw, self._bw, signed=False)
        return self._buf[tgt:tgt + n]

    def as_vector(self) -> List["Ref"]:
        pos = self._indirect()
        w = self._bw
        n = self._read_scalar(pos - w, w, signed=False)
        types_at = pos + n * w
        out = []
        for i in range(n):
            tb = self._buf[types_at + i]
            out.append(Ref(self._buf, pos + i * w, tb >> 2, w,
                           1 << (tb & 3)))
        return out

    def as_map(self) -> Dict[str, "Ref"]:
        pos = self._indirect()
        w = self._bw
        n = self._read_scalar(pos - w, w, signed=False)
        types_at = pos + n * w
        keys_slot = pos - 3 * w
        keys_vec = keys_slot - self._read_scalar(keys_slot, w, signed=False)
        key_w = self._read_scalar(pos - 2 * w, w, signed=False)
        out = {}
        for i in range(n):
            kslot = keys_vec + i * key_w
            ktgt = kslot - self._read_scalar(kslot, key_w, signed=False)
            kend = self._buf.index(b"\0", ktgt)
            key = self._buf[ktgt:kend].decode("utf-8")
            tb = self._buf[types_at + i]
            out[key] = Ref(self._buf, pos + i * w, tb >> 2, w,
                           1 << (tb & 3))
        return out


def root(buf: bytes) -> Ref:
    slot_width = buf[-1]
    tb = buf[-2]
    return Ref(buf, len(buf) - 2 - slot_width, tb >> 2, slot_width,
               1 << (tb & 3))
