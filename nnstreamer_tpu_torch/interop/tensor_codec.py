"""Tensor-stream wire codecs: flatbuf / protobuf / flexbuf / octet.

Port of ``nnstreamer_tpu/interop/tensor_codec.py``: the same bytes for
the same frame, so either package reads what the other writes.
Serializes a tensor frame (list of arrays + stream config) to the
reference's interchange formats and back:

  * flatbuf  — the ``nnstreamer.flatbuf.Tensors`` schema
               (ref: ext/nnstreamer/include/nnstreamer.fbs)
  * protobuf — the ``nnstreamer.protobuf.Tensors`` message
               (ref: ext/nnstreamer/include/nnstreamer.proto)
  * flexbuf  — the schema-less map layout documented in
               ref: ext/nnstreamer/tensor_decoder/tensordec-flexbuf.cc:26-35
  * octet    — raw concatenated tensor bytes

Dimensions are serialized in the reference's innermost-first order,
zero-padded to rank 16 (≙ NNS_TENSOR_RANK_LIMIT).

What differs: a frame's arrays are numpy arrays or CPU torch tensors.
numpy has no bfloat16, so a bf16 tensor packs from its uint16 bit
patterns and unpacks to a CPU ``torch.bfloat16`` tensor (the JAX package
unpacks the same bytes to an ``ml_dtypes`` bf16 array).
"""
from __future__ import annotations

import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..tensors.types import TensorType
from . import flexbuf
from .flatbuild import Builder
from .flatbuf import FlatBuf
from .protowire import (decode, enc_bytes, enc_int, enc_str, enc_varint,
                        packed_varints)

RANK_LIMIT = 16


class Frame:
    """One decoded tensor frame."""

    def __init__(self, arrays: List[Any],
                 names: Optional[List[str]] = None,
                 rate_n: int = 0, rate_d: int = 1, fmt: int = 0):
        self.arrays = arrays
        self.names = names or [""] * len(arrays)
        self.rate_n, self.rate_d, self.fmt = rate_n, rate_d, fmt


def _ref_dims(arr) -> List[int]:
    dims = [int(d) for d in reversed(tuple(arr.shape))] or [1]
    return dims + [0] * (RANK_LIMIT - len(dims))


def _shape_from_ref_dims(dims: List[int]) -> Tuple[int, ...]:
    trimmed = [d for d in dims if d > 0]
    return tuple(reversed(trimmed)) if trimmed else (1,)


def _type_of(arr) -> int:
    return int(TensorType.from_dtype(arr.dtype))


def _bytes_of(arr) -> bytes:
    """An array's bytes, C order; a torch tensor must be on the CPU."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(arr).tobytes()


def _array_from(raw: bytes, nns_type: int, shape: Tuple[int, ...]):
    ttype = TensorType(nns_type)
    if ttype is TensorType.BFLOAT16:
        bits = np.frombuffer(raw, dtype=np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=ttype.np_dtype).reshape(shape)


# -- flatbuf -------------------------------------------------------------------

def pack_flatbuf(frame: Frame) -> bytes:
    b = Builder()
    tensor_offs = []
    for name, arr in zip(frame.names, frame.arrays):
        name_off = b.create_string(name or "")
        data_off = b.create_vector_u8(_bytes_of(arr))
        dim_off = b.create_vector_u32(_ref_dims(arr))
        b.start_table()
        b.add_offset(0, name_off)                     # name
        b.add_scalar(1, "i", _type_of(arr), default=11)  # type (default NNS_END)
        b.add_offset(2, dim_off)                      # dimension
        b.add_offset(3, data_off)                     # data
        tensor_offs.append(b.end_table())
    vec_off = b.create_vector_offsets(tensor_offs)
    b.start_table()
    b.add_scalar(0, "i", len(frame.arrays))           # num_tensor
    b.add_struct(1, struct.pack("<ii", frame.rate_n, frame.rate_d))  # fr
    b.add_offset(2, vec_off)                          # tensor
    b.add_scalar(3, "i", frame.fmt)                   # format
    return b.finish(b.end_table())


def unpack_flatbuf(data: bytes) -> Frame:
    fb = FlatBuf(data)
    root = fb.root()
    fr_pos = fb.field(root, 1)
    rate_n = fb.i32(fr_pos) if fr_pos is not None else 0
    rate_d = fb.i32(fr_pos + 4) if fr_pos is not None else 1
    fmt = fb.field_scalar(root, 3, "i32", 0)
    arrays, names = [], []
    vec = fb.field_vector(root, 2)
    if vec is not None:
        for t in fb.vector_tables(vec):
            names.append(fb.field_string(t, 0))
            ttype = fb.field_scalar(t, 1, "i32", 11)
            dims = fb.field_np(t, 2, np.uint32)
            raw = fb.field_np(t, 3, np.uint8)
            shape = _shape_from_ref_dims(list(dims) if dims is not None
                                         else [])
            arrays.append(_array_from(
                raw.tobytes() if raw is not None else b"", ttype, shape))
    return Frame(arrays, names, rate_n, rate_d, fmt)


# -- protobuf ------------------------------------------------------------------

def pack_protobuf(frame: Frame) -> bytes:
    out = bytearray()
    out += enc_int(1, len(frame.arrays))                       # num_tensor
    fr = enc_int(1, frame.rate_n) + enc_int(2, frame.rate_d)
    out += enc_bytes(2, fr)                                    # fr message
    for name, arr in zip(frame.names, frame.arrays):
        t = bytearray()
        if name:
            t += enc_str(1, name)
        t += enc_int(2, _type_of(arr))
        dims = b"".join(enc_varint(d) for d in _ref_dims(arr))
        t += enc_bytes(3, dims)                                # packed dims
        t += enc_bytes(4, _bytes_of(arr))
        out += enc_bytes(3, bytes(t))                          # Tensor
    out += enc_int(4, frame.fmt)                               # format
    return bytes(out)


def unpack_protobuf(data: bytes) -> Frame:
    top = decode(data)
    fr = decode(top.get(2, [b""])[0]) if 2 in top else {}
    rate_n = int(fr.get(1, [0])[0])
    rate_d = int(fr.get(2, [1])[0])
    fmt = int(top.get(4, [0])[0])
    arrays, names = [], []
    for tbytes in top.get(3, []):
        t = decode(tbytes)
        name = t.get(1, [b""])[0]
        names.append(name.decode() if isinstance(name, bytes) else "")
        ttype = int(t.get(2, [0])[0])
        dims = packed_varints(t.get(3, [b""])[0])
        raw = t.get(4, [b""])[0]
        arrays.append(_array_from(raw, ttype, _shape_from_ref_dims(dims)))
    return Frame(arrays, names, rate_n, rate_d, fmt)


# -- flexbuf -------------------------------------------------------------------

def pack_flexbuf(frame: Frame) -> bytes:
    w = flexbuf.Writer()
    entries = {}
    for i, (name, arr) in enumerate(zip(frame.names, frame.arrays)):
        name_off = w.write_string(name or "")
        dims = w.write_vector([flexbuf.val_uint(d) for d in _ref_dims(arr)])
        blob = w.write_blob(_bytes_of(arr))
        vec = w.write_vector([
            flexbuf._Val(flexbuf.STRING, name_off, inline=False),
            flexbuf.val_int(_type_of(arr)),
            dims,
            flexbuf._Val(flexbuf.BLOB, blob, inline=False),
        ])
        entries[f"tensor_{i}"] = vec
    entries["num_tensors"] = flexbuf.val_uint(len(frame.arrays))
    entries["rate_n"] = flexbuf.val_int(frame.rate_n)
    entries["rate_d"] = flexbuf.val_int(frame.rate_d)
    entries["format"] = flexbuf.val_int(frame.fmt)
    return w.finish(w.write_map(entries))


def unpack_flexbuf(data: bytes) -> Frame:
    m = flexbuf.root(data).as_map()
    n = m["num_tensors"].as_int()
    rate_n = m["rate_n"].as_int()
    rate_d = m["rate_d"].as_int()
    fmt = m["format"].as_int() if "format" in m else 0
    arrays, names = [], []
    for i in range(n):
        item = m[f"tensor_{i}"].as_vector()
        names.append(item[0].as_str())
        ttype = item[1].as_int()
        dims = [r.as_int() for r in item[2].as_vector()]
        raw = item[3].as_blob()
        arrays.append(_array_from(bytes(raw), ttype,
                                  _shape_from_ref_dims(dims)))
    return Frame(arrays, names, rate_n, rate_d, fmt)


# -- octet ---------------------------------------------------------------------

def pack_octet(frame: Frame) -> bytes:
    return b"".join(_bytes_of(a) for a in frame.arrays)
