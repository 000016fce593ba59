"""tensor_sparse_enc / tensor_sparse_dec — static<->sparse codec.

Port of ``nnstreamer_tpu/elements/sparse.py`` (≙ gst/nnstreamer/elements/
gsttensor_sparse{_enc,_dec,_util}.c): non-zero elements encoded as
(index, value) pairs behind a self-describing TensorMetaInfo header
(GstSparseTensorInfo.nnz, tensor_typedef.h:294-297). The bytes are the
JAX package's, byte for byte.

Wire layout per chunk: 128-byte meta header | uint32 indices[nnz] |
values[nnz] (element dtype).

bfloat16 has no numpy dtype: a bf16 chunk (a CPU ``torch.bfloat16`` on
the host) is encoded and decoded on its uint16 bit patterns, under the
header type ``bfloat16``, as ``edge/wire.py`` carries bf16.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..edge.protocol import host_array, host_value, resolve_dtype
from ..pipeline.element import TransformElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig, TensorsInfo
from ..tensors.meta import HEADER_SIZE, TensorMetaInfo
from ..tensors.types import TensorFormat, TensorType


def _bits(value) -> Tuple[np.ndarray, str]:
    """A host value -> (flat contiguous ndarray of its bytes' dtype,
    dtype name): bf16 as uint16 bits."""
    arr, name = host_array(value)
    return np.ascontiguousarray(arr), name


def encode_bits(arr: np.ndarray, name: str,
                ref: Optional[np.ndarray] = None) -> bytes:
    """:func:`sparse_encode` on an array of the bytes' dtype (uint16 bits
    for ``name == "bfloat16"``); ``ref`` likewise."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    if ref is None:
        if name == "bfloat16":
            # non-zero as a value: every bit pattern but +0.0 and -0.0
            idx = np.flatnonzero(flat & np.uint16(0x7FFF)).astype(np.uint32)
        else:
            idx = np.flatnonzero(flat).astype(np.uint32)
    else:
        rflat = np.ascontiguousarray(ref).reshape(-1)
        if rflat.shape != flat.shape or rflat.dtype != flat.dtype:
            raise ValueError(
                f"sparse diff reference mismatch: {name}{flat.shape} "
                f"vs {rflat.dtype}{rflat.shape}")
        itemsize = flat.dtype.itemsize
        if itemsize == 1:
            changed = flat.view(np.uint8) != rflat.view(np.uint8)
        else:
            changed = (flat.view(np.uint8).reshape(-1, itemsize) !=
                       rflat.view(np.uint8).reshape(-1, itemsize)).any(axis=1)
        idx = np.flatnonzero(changed).astype(np.uint32)
    vals = flat[idx]
    meta = TensorMetaInfo(
        type=TensorType.from_dtype(name), format=TensorFormat.SPARSE,
        shape=tuple(arr.shape), nnz=len(idx))
    return meta.pack() + idx.tobytes() + vals.tobytes()


def sparse_encode(arr, ref=None) -> bytes:
    """Dense -> sparse wire bytes. ``arr`` is a host value (an ndarray,
    or a CPU bf16 tensor). Absolute mode (``ref=None``) encodes the
    non-zero elements; diff mode encodes the elements that differ from
    ``ref``, compared bitwise, so NaN payloads and -0.0/+0.0 flips survive
    the round trip exactly. Decode diff-mode bytes with the same ``ref``
    (the delta wire codec keys it to the link's reference epoch)."""
    bits, name = _bits(arr)
    rbits = None
    if ref is not None:
        rbits, rname = _bits(ref)
        if rname != name:
            raise ValueError(
                f"sparse diff reference mismatch: {name}{bits.shape} "
                f"vs {rname}{rbits.shape}")
    return encode_bits(bits, name, rbits)


def _parse_sparse(data: bytes):
    """Wire -> (meta, uint32 indices, values as their bytes' dtype); the
    one reader of the layout, shared by the host and device decodes."""
    meta = TensorMetaInfo.unpack(data[:HEADER_SIZE])
    if meta.format != TensorFormat.SPARSE:
        raise ValueError("chunk is not sparse-encoded")
    nnz = meta.nnz
    off = HEADER_SIZE
    idx = np.frombuffer(data[off:off + 4 * nnz], np.uint32)
    off += 4 * nnz
    dt = resolve_dtype(str(meta.type))
    vals = np.frombuffer(data[off:off + nnz * dt.itemsize], dt)
    return meta, idx, vals


def decode_bits(data: bytes, ref: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, str]:
    """:func:`sparse_decode` on the bytes' dtype -> (array, dtype name);
    ``ref`` is an array of the bytes' dtype too."""
    meta, idx, vals = _parse_sparse(data)
    size = math.prod(meta.shape)
    if ref is None:
        out = np.zeros(size, vals.dtype)
    else:
        rflat = np.ascontiguousarray(ref).reshape(-1)
        if rflat.size != size or rflat.dtype != vals.dtype:
            raise ValueError(
                f"sparse diff reference mismatch: {vals.dtype}[{size}] "
                f"vs {rflat.dtype}[{rflat.size}]")
        out = rflat.copy()
    out[idx] = vals
    return out.reshape(meta.shape), str(meta.type)


def sparse_decode(data: bytes, ref=None):
    """Inverse of :func:`sparse_encode` -> a host value (ndarray, or a CPU
    bf16 tensor). With ``ref`` the output starts from a copy of the
    reference (diff mode) instead of zeros; it never aliases ``ref``."""
    rbits = None if ref is None else _bits(ref)[0]
    out, name = decode_bits(data, rbits)
    return host_value(out, name)


@register_element("tensor_sparse_enc")
class TensorSparseEnc(TransformElement):
    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    # density < 1.0 turns on the DEVICE pack path for chunks on the card:
    # non-zeros are packed in device memory (ops/sparse.py) and only
    # ceil(size*density) (index, value) pairs cross to the host, not the
    # dense tensor. A frame whose nnz overflows the capacity takes the
    # host path, which has no limit: never truncated.
    PROPS = {"density": 1.0}

    def transform_caps(self, incaps: Caps) -> Optional[Caps]:
        cfg = incaps.to_config()
        return Caps.from_config(TensorsConfig(
            TensorsInfo(), TensorFormat.SPARSE, cfg.rate_n, cfg.rate_d))

    def _encode_device(self, c: Chunk) -> Optional[bytes]:
        """Pack on the card; None -> the caller takes the host path."""
        from ..ops.sparse import fetch_packed, pack

        size = math.prod(c.shape)
        capacity = max(1, min(size, math.ceil(size * float(self.density))))
        idx, vals, nnz = fetch_packed(*pack(c.raw.reshape(-1), capacity))
        if nnz > capacity:
            return None  # denser than promised: the host path has no limit
        meta = TensorMetaInfo(
            type=c.type, format=TensorFormat.SPARSE,
            shape=tuple(c.shape), nnz=nnz)
        return meta.pack() + idx[:nnz].tobytes() + vals[:nnz].tobytes()

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        chunks = []
        for c in buf.chunks:
            wire = None
            if float(self.density) < 1.0 and c.is_device:
                wire = self._encode_device(c)
            if wire is None:
                wire = sparse_encode(c.host())
            data = np.frombuffer(wire, np.uint8)
            meta = TensorMetaInfo.unpack(data[:HEADER_SIZE].tobytes())
            chunks.append(Chunk(data, meta=meta))
        return buf.with_chunks(chunks)


def decode_device() -> torch.device:
    """Where ``tensor_sparse_dec device=true`` unpacks: the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("tensor_sparse_dec device=true needs a CUDA "
                           "device")
    return torch.device("cuda", 0)


@register_element("tensor_sparse_dec")
class TensorSparseDec(TransformElement):
    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    # device=true scatters (idx, vals) to a dense tensor ON THE CARD
    # (ops/sparse.py unpack): the small pair is what crosses H2D, and a
    # downstream tensor_filter finds its input already on the card.
    PROPS = {"device": False}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._out_cfg: Optional[TensorsConfig] = None

    def _decode_device(self, data: bytes) -> Chunk:
        from ..ops.sparse import unpack

        meta, idx, vals = _parse_sparse(data)
        size = math.prod(meta.shape)
        # pad to a power-of-two bucket, as the JAX package pads to bound
        # its jit cache; pads are (idx 0, val 0), which unpack masks out
        cap = 1
        while cap < max(len(vals), 1):
            cap *= 2
        cap = min(cap, max(size, 1))
        pad = cap - len(vals)
        if pad > 0:
            idx = np.concatenate([idx, np.zeros(pad, np.uint32)])
            vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
        v = host_value(np.ascontiguousarray(vals), str(meta.type))
        dense = unpack(idx, v, size, decode_device())
        return Chunk(dense.reshape(meta.shape))

    def transform_caps(self, incaps: Caps) -> Optional[Caps]:
        cfg = incaps.to_config()
        # dims are locked from the first decoded buffer (sparse streams
        # are self-describing); until then advertise flexible
        self._rate = (cfg.rate_n, cfg.rate_d)
        return Caps.from_config(TensorsConfig(
            TensorsInfo(), TensorFormat.FLEXIBLE, cfg.rate_n, cfg.rate_d))

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        if self.device:
            chunks = [self._decode_device(c.host().tobytes())
                      for c in buf.chunks]
        else:
            chunks = [Chunk(sparse_decode(c.host().tobytes()))
                      for c in buf.chunks]
        out = buf.with_chunks(chunks)
        if self._out_cfg is None:
            self._out_cfg = TensorsConfig(out.to_infos(), TensorFormat.STATIC,
                                          *self._rate)
            self.set_src_caps(Caps.from_config(self._out_cfg))
        return out
