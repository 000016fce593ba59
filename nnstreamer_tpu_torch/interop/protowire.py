"""Minimal protobuf wire-format codec — no schema compiler, no deps.

A copy of ``nnstreamer_tpu/interop/protowire.py`` (plain Python: the
port keeps its own rather than import the JAX package).

Decodes a message into ``{field_number: [values]}`` where values are ints
(varint/fixed), floats (when asked), or bytes (length-delimited; nested
messages decode by calling :func:`decode` again on the bytes). Encoding
helpers build messages field-by-field. Enough for walking ONNX models
(interop/onnx.py) and for the protobuf tensor codec
(≙ ext/nnstreamer/extra/nnstreamer_protobuf.cc, which links libprotobuf).
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

Value = Union[int, bytes]


def read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, Value]]:
    """Yield (field_number, wire_type, value). Length-delimited values are
    bytes; varint/fixed values are ints (reinterpret as needed)."""
    buf = memoryview(data)
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = read_varint(buf, pos)
            yield field, wt, v
        elif wt == 1:
            yield field, wt, struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            n, pos = read_varint(buf, pos)
            yield field, wt, bytes(buf[pos:pos + n])
            pos += n
        elif wt == 5:
            yield field, wt, struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def decode(data: bytes) -> Dict[int, List[Value]]:
    out: Dict[int, List[Value]] = {}
    for field, _, v in iter_fields(data):
        out.setdefault(field, []).append(v)
    return out


# -- typed readers ---------------------------------------------------------

def as_f32(v: int) -> float:
    return struct.unpack("<f", struct.pack("<I", v & 0xFFFFFFFF))[0]


def as_f64(v: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", v))[0]


def as_sint(v: int) -> int:
    """Two's-complement reinterpretation of a varint read as unsigned
    (proto int64/int32 negative values)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def packed_varints(data: bytes) -> List[int]:
    buf = memoryview(data)
    pos, out = 0, []
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(v)
    return out


# -- encoding --------------------------------------------------------------

def enc_varint(value: int) -> bytes:
    out = bytearray()
    if value < 0:
        value += 1 << 64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def enc_tag(field: int, wire_type: int) -> bytes:
    return enc_varint((field << 3) | wire_type)


def enc_int(field: int, value: int) -> bytes:
    return enc_tag(field, 0) + enc_varint(value)


def enc_bytes(field: int, value: bytes) -> bytes:
    return enc_tag(field, 2) + enc_varint(len(value)) + value


def enc_str(field: int, value: str) -> bytes:
    return enc_bytes(field, value.encode("utf-8"))


def enc_f32(field: int, value: float) -> bytes:
    return enc_tag(field, 5) + struct.pack("<f", value)


def enc_f64(field: int, value: float) -> bytes:
    return enc_tag(field, 1) + struct.pack("<d", value)
