"""Length-prefixed tensor message framing over TCP.

Port of ``nnstreamer_tpu/edge/protocol.py`` (≙ nnstreamer-edge's
nns_edge_data_* wire format, SURVEY.md §5 distributed backend). The
framing is the JAX package's, byte for byte, so the two packages talk
to each other. A message is::

    magic   u32  0x4E4E5445 ("NNTE")
    kind    u8   MsgKind
    meta    u32 len + utf-8 JSON (caps/client_id/pts/shapes/dtypes)
    n       u32  payload count
    n x (u64 len + bytes)

Tensor payloads ride as raw bytes; dtypes/shapes live in the JSON meta so
flexible streams need no renegotiation.

The framing above is wire v1 and is what every message still looks like
on the outside. Underneath (wire v2, see ``wire.py``):

* **send** is vectored: ``send_msg`` accepts ndarrays / memoryviews and
  hands the header + payload views to ``socket.sendmsg`` scatter-gather,
  so tensor bytes go from the array to the kernel without ``tobytes()``
  or a ``b"".join`` staging copy.
* **recv** is zero-copy: ``recv_msg`` preallocates the destination —
  the exact ndarray described by ``meta["tensors"]`` when the payload is
  raw, a ``bytearray`` otherwise — and fills it with ``recv_into``.
  Either way the payload memory is writable and lands once.

bfloat16: numpy has no bf16 and the port borrows none (no ``ml_dtypes``).
A bf16 tensor travels as its 2-byte bit patterns under the dtype name
``"bfloat16"``, exactly as the JAX peer sends it; on the host side of
this module those bits sit in a ``uint16`` ndarray (:func:`host_array`)
and reach the pipeline as a CPU ``torch.bfloat16`` tensor
(:func:`host_value`), as ``Chunk.host()`` returns bf16 data.

Everything here runs on the host: a network thread never touches the
card. A chunk still on the card is copied to the host by
``Chunk.host()`` on the thread that packs it.
"""
from __future__ import annotations

import enum
import json
import socket
import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MAGIC = 0x4E4E5445
_HDR = struct.Struct("<IBI")
_PLEN = struct.Struct("<Q")

# Guards on attacker/corruption-controlled lengths: reject before
# allocating. 4 GB per tensor payload (the u64 length path must not let
# a flipped bit demand an exabyte), 64 MB of JSON meta.
MAX_PAYLOAD = 1 << 32
MAX_META = 1 << 26

# sendmsg scatter-gather is POSIX; cap the iovec count per call well
# under any realistic IOV_MAX (Linux: 1024).
_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")
_IOV_BATCH = 64

Payload = Union[bytes, bytearray, memoryview, np.ndarray]


class MsgKind(enum.IntEnum):
    CAPS = 1        # caps string exchange at connect
    CAPS_ACK = 2
    DATA = 3        # client -> server frame
    RESULT = 4      # server -> client frame
    EOS = 5
    ERROR = 6
    SUBSCRIBE = 7   # edgesrc -> edgesink hello
    REGISTER = 8    # server -> broker: advertise topic at host:port
    QUERY = 9       # client -> broker: who serves this topic?
    QUERY_ACK = 10  # broker -> client: endpoint list
    PUBLISH = 11    # publisher -> message broker: topic payload
    SHED = 12       # server -> client: request dropped (admission or
                    # deadline); meta carries retry_after_ms + seq
    DATA_BATCH = 13  # N coalesced DATA frames in one message (wire v2
                     # only: meta template + per-frame binary header)
    # session layer (edge/session.py) — only ever sent on links that
    # negotiated a session at CAPS/SUBSCRIBE; a v1 peer never sees them
    ACK = 14        # receiver -> sender: cumulative delivery watermark
    RESUME = 15     # reconnecting receiver: {sid, last delivered seq}
    RESUME_ACK = 16  # sender's answer: {resumed, frames_lost, base}
    PING = 17       # liveness probe across an idle link
    PONG = 18       # echo of the PING's timestamp
    DRAIN = 19      # graceful teardown: admission is closing; in-flight
                    # frames flush + settle before the peer goes away
    KV_XFER = 20    # prefill -> decode replica: a stream's prompt KV
                    # blocks + last logits (edge/kv.py; wire-v2
                    # precision negotiated at CAPS like any tensor link)
    KV_ACK = 21     # decode replica's admission receipt ({sid, adopted})


BF16 = "bfloat16"


def resolve_dtype(name: str) -> np.dtype:
    """The numpy dtype whose bytes carry a tensor of dtype ``name`` on
    the wire: ``uint16`` bit patterns for bfloat16, else ``np.dtype``."""
    if name == BF16:
        return np.dtype(np.uint16)
    return np.dtype(name)


def host_array(x) -> Tuple[np.ndarray, str]:
    """A host value (ndarray, or CPU tensor as ``Chunk.host()`` returns
    bfloat16) -> (ndarray of its wire bytes, dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            bits = x.contiguous().view(torch.int16).numpy().view(np.uint16)
            return bits, BF16
        x = x.numpy()
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def host_value(arr: np.ndarray, name: str):
    """Inverse of :func:`host_array`: bf16 bit patterns become a CPU
    ``torch.bfloat16`` tensor sharing ``arr``'s memory; any other dtype
    stays the ndarray."""
    if name == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def byte_view(arr: np.ndarray) -> Optional[memoryview]:
    """A flat writable-agnostic byte view of ``arr``, or None when the
    dtype defeats the buffer protocol and the caller must fall back to
    a copy."""
    try:
        return memoryview(arr).cast("B")
    except (TypeError, ValueError, NotImplementedError):
        try:
            return memoryview(arr.view(np.uint8).reshape(-1))
        except (TypeError, ValueError):
            return None


def as_payload_view(p: Payload) -> Union[bytes, memoryview]:
    """Normalize one payload to something len()-able and sendable."""
    if isinstance(p, np.ndarray):
        if p.size and not p.flags.c_contiguous:
            p = np.ascontiguousarray(p)
        v = byte_view(p)
        return v if v is not None else p.tobytes()
    if isinstance(p, (bytearray, memoryview)):
        return memoryview(p).cast("B")
    return p


def sever_socket(sock: Optional[socket.socket]) -> None:
    """Force-close a live socket so BOTH ends notice immediately.
    shutdown() must precede close(): a thread blocked in recv() on this
    socket holds a kernel reference, so a bare close() would neither
    wake it nor send FIN — the peer's select() would wait forever on a
    connection that is dead only in name."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("peer closed")
        got += r


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    # one allocation, filled in place (the old version grew a bytearray
    # through repeated recv()+extend copies)
    buf = bytearray(n)
    if n:
        _recv_exact_into(sock, memoryview(buf))
    return buf


def _sendmsg_all(sock: socket.socket, parts: List[Union[bytes, memoryview]]
                 ) -> None:
    """sendall() semantics over a scatter-gather list, resuming cleanly
    after partial sends; falls back to join+sendall without sendmsg."""
    if not _HAS_SENDMSG:
        sock.sendall(b"".join(parts))
        return
    pending = [memoryview(p) for p in parts if len(p)]
    while pending:
        sent = sock.sendmsg(pending[:_IOV_BATCH])
        while sent:
            if sent >= len(pending[0]):
                sent -= len(pending.pop(0))
            else:
                pending[0] = pending[0][sent:]
                sent = 0


def send_msg(sock: socket.socket, kind: MsgKind, meta: Dict,
             payloads: Sequence[Payload] = (), stats=None) -> int:
    """Frame + send one message; returns bytes put on the wire.

    Payloads may be bytes, bytearray, memoryview, or ndarray — ndarrays
    are sent straight from their backing memory (made contiguous only
    when they are not).
    """
    mb = json.dumps(meta).encode()
    parts: List[Union[bytes, memoryview]] = [
        _HDR.pack(MAGIC, int(kind), len(mb)), mb,
        struct.pack("<I", len(payloads))]
    total = _HDR.size + len(mb) + 4
    for p in payloads:
        v = as_payload_view(p)
        parts.append(_PLEN.pack(len(v)))
        total += _PLEN.size + len(v)
        if len(v):
            parts.append(v)
    _sendmsg_all(sock, parts)
    if stats is not None:
        stats.add(wire_bytes_out=total, wire_msgs_out=1)
    return total


def _preallocate(meta: Dict, n: int) -> Optional[List[Optional[np.ndarray]]]:
    """Per-payload destination ndarrays when meta fully describes raw
    tensors, else None (caller falls back to bytearray — still writable,
    still filled by recv_into)."""
    tensors = meta.get("tensors")
    if not isinstance(tensors, list) or len(tensors) != n:
        return None
    out: List[Optional[np.ndarray]] = []
    for t in tensors:
        if not isinstance(t, dict) or "codec" in t or "wire_dtype" in t:
            out.append(None)
            continue
        try:
            out.append(np.empty(tuple(t["shape"]), resolve_dtype(t["dtype"])))
        except Exception:
            out.append(None)
    return out


def recv_msg(sock: socket.socket, stats=None
             ) -> Tuple[MsgKind, Dict, List[Payload]]:
    """Receive one message. Raw tensor payloads land directly in freshly
    allocated ndarrays (writable, zero extra copies); anything else
    (control frames, encoded payloads) comes back as a bytearray."""
    magic, kind, mlen = _HDR.unpack(_read_exact(sock, _HDR.size))
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if mlen > MAX_META:
        raise ValueError(f"meta length {mlen} exceeds {MAX_META} guard")
    meta = json.loads(bytes(_read_exact(sock, mlen))) if mlen else {}
    (n,) = struct.unpack("<I", _read_exact(sock, 4))
    dests = _preallocate(meta, n) if n else None
    total = _HDR.size + mlen + 4
    payloads: List[Payload] = []
    for i in range(n):
        (plen,) = _PLEN.unpack(_read_exact(sock, _PLEN.size))
        if plen > MAX_PAYLOAD:
            raise ValueError(
                f"payload {i} length {plen} exceeds {MAX_PAYLOAD} guard")
        total += _PLEN.size + plen
        arr = dests[i] if dests is not None else None
        view = byte_view(arr) if arr is not None else None
        if view is not None and len(view) == plen:
            _recv_exact_into(sock, view)
            payloads.append(arr)
        else:
            payloads.append(_read_exact(sock, plen))
    if stats is not None:
        stats.add(wire_bytes_in=total, wire_msgs_in=1)
    return MsgKind(kind), meta, payloads


def buffer_to_wire(buf) -> Tuple[Dict, List[Payload]]:
    """Buffer -> (meta, payloads); dtype/shape per chunk in meta.

    Payloads are the chunks' host arrays (no copy for a host chunk);
    ``send_msg`` sends them as-is. This is the plain/v1 path —
    negotiated codecs live in ``wire.py``.
    """
    tensors = []
    payloads: List[Payload] = []
    for c in buf.chunks:
        arr, name = host_array(c.host())
        if arr.size and not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        tensors.append({"dtype": name, "shape": list(arr.shape)})
        payloads.append(arr)
    meta = {"pts": buf.pts, "duration": buf.duration, "tensors": tensors}
    return meta, payloads


def wire_to_buffer(meta: Dict, payloads: Sequence[Payload]):
    """(meta, payloads) -> Buffer with WRITABLE chunk arrays.

    ``recv_msg`` already delivers shaped ndarrays for raw tensors (zero
    copy); bytearray payloads wrap writably in place; a read-only
    ``bytes`` payload (v1 peers, tests) is copied once — downstream
    in-place transforms must never trip on a read-only chunk.
    """
    from ..tensors.buffer import Buffer, Chunk
    chunks = []
    for t, p in zip(meta.get("tensors", []), payloads):
        dtype = resolve_dtype(t["dtype"])
        shape = tuple(t["shape"])
        if isinstance(p, np.ndarray) and p.dtype == dtype and \
                p.shape == shape and p.flags.writeable:
            arr = p
        else:
            raw = p.tobytes() if isinstance(p, np.ndarray) else p
            arr = np.frombuffer(raw, dtype).reshape(shape)
            if not arr.flags.writeable:
                arr = arr.copy()
        chunks.append(Chunk(host_value(arr, t["dtype"])))
    return Buffer(chunks, pts=meta.get("pts"), duration=meta.get("duration"))
