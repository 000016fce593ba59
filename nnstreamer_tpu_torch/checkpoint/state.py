"""Picklable state helpers shared by element snapshot hooks.

Port of ``nnstreamer_tpu/checkpoint/state.py``. A
:class:`~..tensors.buffer.Buffer` may hold CUDA tensors and in-flight
D2H fetches (:class:`~..tensors.transfer.PendingHost`), neither of which
belongs in a snapshot: :func:`dump_buffer` materializes every chunk on
the host (an ``np.ndarray``, or a CPU ``torch.Tensor`` for bfloat16,
which numpy lacks) and keeps only the picklable frame metadata;
:func:`load_buffer` rebuilds an equivalent host-resident buffer (a
restored frame re-enters the pipeline like any converter output and
moves to the card on first use).
"""
from __future__ import annotations

from typing import Dict, List

from ..tensors.buffer import Buffer, BufferFlags, Chunk


def dump_buffer(buf: Buffer) -> Dict:
    return {"arrays": [c.host() for c in buf.chunks],
            "pts": buf.pts, "dts": buf.dts, "duration": buf.duration,
            "flags": int(buf.flags), "extras": dict(buf.extras)}


def load_buffer(d: Dict) -> Buffer:
    buf = Buffer([Chunk(a) for a in d["arrays"]], pts=d.get("pts"),
                 dts=d.get("dts"), duration=d.get("duration"),
                 flags=BufferFlags(int(d.get("flags", 0))))
    buf.extras = dict(d.get("extras") or {})
    return buf


def dump_buffers(bufs) -> List[Dict]:
    return [dump_buffer(b) for b in bufs]


def load_buffers(dumps) -> List[Buffer]:
    return [load_buffer(d) for d in dumps]


# -- content addressing ------------------------------------------------

def token_sha(tokens) -> str:
    """Canonical sha256 hex digest of a token sequence: int32
    little-endian token ids, hashed in order — the JAX package's
    convention (its llm snapshot re-adoption and the paged KV prefix
    cache's block chain), so a digest computed by either package
    matches the other's."""
    import hashlib

    import numpy as np

    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32).ravel())
    if arr.dtype.byteorder == ">":  # big-endian host: normalize
        arr = arr.astype("<i4")
    return hashlib.sha256(arr.tobytes()).hexdigest()
