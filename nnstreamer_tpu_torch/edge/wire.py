"""Wire v2: negotiated codecs, dtype downcast, and frame coalescing.

Port of ``nnstreamer_tpu/edge/wire.py``. Every message this module packs
is byte for byte what the JAX package packs for the same frame under the
same link config, and each package unpacks the other's: a JAX client
uses a port server, a port subscriber reads a JAX publisher.

This module layers optional compaction on top of the v1 framing in
``protocol.py``; the outer message format never changes, so a v1 peer
sees byte-identical traffic. The extras are negotiated per link at the
CAPS/SUBSCRIBE handshake:

* the connecting side sends ``{"wire": advertise(...)}`` inside its
  handshake meta;
* the accepting side folds that into its own requested config with
  :func:`negotiate` and echoes the chosen block in the CAPS_ACK meta;
* the connecting side adopts the echoed choice with :func:`accept`.

A peer that never mentions ``wire`` (any pre-v2 build) gets ``None`` out
of both :func:`negotiate` and :func:`accept`, which every call below
treats as "plain v1": no codec, no downcast, no DATA_BATCH.

Codecs (all lossless):

* ``raw`` — payloads as-is (the zero-copy vectored path).
* ``zlib`` — per-tensor zlib at a throughput-oriented level.
* ``shuffle-zlib`` — byte-shuffle (group same-significance bytes across
  elements, a ``blosc``-style filter) before zlib; float tensors whose
  exponents dominate compress far better shuffled.

Per-tensor, a codec is only kept when it actually shrinks the payload
(otherwise the tensor ships raw with no marker), and a link that keeps
failing to compress stops trying for a while (adaptive skip) so
incompressible streams pay ~zero codec overhead.

* ``delta`` — temporal keyframe+diff transport: the sender keeps the
  last frame shipped on the link as the reference and sends sparse
  bitwise diffs (the ``elements/sparse.py`` (index, value) format,
  zlib'd when that pays) between keyframes. Keyframes go out on a fresh
  link, every ``delta_k`` frames, on any layout change, and whenever a
  diff would not beat the dense frame (promotion). Each frame carries
  the reference epoch it was encoded against, so a receiver can never
  silently patch the wrong baseline: a mismatch raises, the link
  reconnects, and the fresh link starts with a keyframe. Lossless and
  deterministic: decode output is byte-identical to the delta-off path.

Delta is the one codec with per-link *state* on both ends, so it is
only ever chosen by the accepting side's own request (an edgesink's
``wire-codec=delta``), never adopted from a peer's wish. References
live in the wire dtype on both ends (bf16 as its uint16 bits), each
link's under its own lock.

``wire-precision`` (opt-in, lossy): float32 tensors are downcast to
bfloat16/float16 on the wire and upcast back to float32 on receive; the
original dtype always rides in meta. The bf16 downcast rounds to
nearest even with NaN kept quiet and its sign kept, on the bits
(:func:`f32_to_bf16_bits`): the rounding ``ml_dtypes`` applies on the
JAX side, computed the same way on every host CPU.
"""
from __future__ import annotations

import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import context as _obs_ctx
from ..obs import spans as _obs_spans
from ..tensors.buffer import Buffer, BufferFlags, Chunk
from . import protocol
from .protocol import (BF16, Payload, as_payload_view, host_array, host_value,
                       resolve_dtype)

WIRE_VERSION = 2

CODEC_RAW = "raw"
CODEC_ZLIB = "zlib"
CODEC_SHUFFLE = "shuffle-zlib"
CODEC_DELTA = "delta"
CODECS = (CODEC_RAW, CODEC_ZLIB, CODEC_SHUFFLE, CODEC_DELTA)

# default keyframe cadence for wire-codec=delta: a keyframe every K
# frames bounds both the blast radius of a corrupted reference and the
# time a joining observer waits for a decodable frame. 0 = never rekey
# on schedule (pipelint flags that as delta-no-keyframe-interval).
DELTA_KEYFRAME_INTERVAL = 32

PREC_NONE = "none"
PREC_BF16 = "bf16"
PREC_FP16 = "fp16"
PRECISIONS = (PREC_NONE, PREC_BF16, PREC_FP16)
_PREC_DTYPE = {PREC_BF16: BF16, PREC_FP16: "float16"}

# numeric codec codes for the compact per-payload ``enc`` list on
# DATA_BATCH messages (single DATA frames use the per-tensor "codec"
# meta key instead); _CODE_DELTA(_Z) mark sparse-diff payloads (plain /
# zlib'd) and only ever appear on links that negotiated delta
_CODE_RAW, _CODE_ZLIB, _CODE_SHUFFLE = 0, 1, 2
_CODE_DELTA, _CODE_DELTA_Z = 3, 4
_CODE_NAME = {_CODE_ZLIB: CODEC_ZLIB, _CODE_SHUFFLE: CODEC_SHUFFLE}

# don't bother compressing tiny tensors; keep zlib at a
# throughput-oriented level — the wire win must not cost more pack time
# than it saves in send time
MIN_COMPRESS = 512
COMPRESS_LEVEL = 1
# a codec result must beat raw by at least this factor to be kept
KEEP_RATIO = 0.9
# adaptive skip: after this many consecutive "compression didn't help"
# tensors, send raw without trying for SKIP_FRAMES tensors, then reprobe
POOR_LIMIT = 3
SKIP_FRAMES = 256
# early abort (the ZFS-compress trick): before compressing a large
# tensor, deflate just this prefix — if even the sample won't shrink,
# the tensor ships raw for ~1/10 the cost of a full failed attempt
PROBE_BYTES = 16384

# per-frame binary header inside a DATA_BATCH payload[0]:
# seq i64 (-1 = none), pts f64 (NaN = none), duration f64 (NaN = none),
# flags u32 — replaces per-frame JSON meta
_FHDR = struct.Struct("<qddI")
# the trace-extended header (negotiated: both peers advertised
# ``trace``; marked ``fhdr=2`` in the batch meta): the v1 fields +
# trace_id u64, span_id u64 (0/0 = untraced frame), then the context's
# birth stamp and queue/compute/wire attribution accumulators (i64 ns)
_FHDR_T = struct.Struct("<qddIQQqqqq")


class WireConfig:
    """The negotiated per-link wire feature set (+ adaptive codec
    state). One instance per connection; the skip counters are touched
    from whatever thread packs for that link, under a leaf lock."""

    __slots__ = ("version", "codec", "precision", "trace", "delta_k",
                 "_lock", "_poor", "_skip", "_dlock", "_dtx", "_drx")

    def __init__(self, codec: str = CODEC_RAW, precision: str = PREC_NONE,
                 version: int = WIRE_VERSION, trace: bool = False,
                 delta_k: int = DELTA_KEYFRAME_INTERVAL):
        self.version = version
        self.codec = codec if codec in CODECS else CODEC_RAW
        self.precision = precision if precision in PRECISIONS else PREC_NONE
        # negotiated frame-trace propagation (obs/): DATA meta gains a
        # "trace" field and DATA_BATCH the fhdr=2 extended header —
        # only when BOTH peers advertised it (old peers: byte-identical)
        self.trace = bool(trace)
        self._lock = threading.Lock()
        self._poor = 0
        self._skip = 0
        # delta codec: keyframe cadence + per-direction reference state.
        # A WireConfig is minted fresh per connection (negotiate/accept),
        # so a reconnect or session RESUME always restarts from a
        # keyframe. _dtx/_drx are guarded by _dlock (never _lock: the
        # keyframe zlib attempt must not re-enter the adaptive-skip lock).
        self.delta_k = int(delta_k)
        self._dlock = threading.Lock()
        self._dtx: Optional[Dict] = None
        self._drx: Optional[Dict] = None

    def to_meta(self) -> Dict:
        out = {"v": self.version, "codec": self.codec,
               "precision": self.precision, "codecs": list(CODECS),
               "precisions": list(PRECISIONS)}
        if self.codec == CODEC_DELTA:
            out["delta_k"] = self.delta_k
        if self.trace:
            out["trace"] = True
        return out

    # -- adaptive skip (incompressible streams stop paying for zlib) ---
    def _try_compress(self) -> bool:
        with self._lock:
            if self._skip > 0:
                self._skip -= 1
                return False
            return True

    def _note(self, helped: bool) -> None:
        with self._lock:
            if helped:
                self._poor = 0
            else:
                self._poor += 1
                if self._poor >= POOR_LIMIT:
                    self._poor = 0
                    self._skip = SKIP_FRAMES

    def __repr__(self) -> str:
        return (f"WireConfig(v{self.version}, codec={self.codec}, "
                f"precision={self.precision})")


# -- negotiation -------------------------------------------------------


def advertise(codec: str = CODEC_RAW, precision: str = PREC_NONE) -> Dict:
    """The ``wire`` block a connecting peer puts in its handshake meta:
    what it supports, plus what it would like for this link."""
    out = {"v": WIRE_VERSION, "codec": codec, "precision": precision,
           "codecs": list(CODECS), "precisions": list(PRECISIONS)}
    if _obs_spans.ENABLED:
        # frame-trace propagation support (an old peer just ignores the
        # key; it only takes effect when both ends advertise it)
        out["trace"] = True
    return out


def negotiate(peer: Optional[Dict], codec: str = CODEC_RAW,
              precision: str = PREC_NONE,
              delta_k: Optional[int] = None) -> Optional[WireConfig]:
    """Accepting side: fold the peer's advertisement into our own
    request. Returns None — meaning "speak plain v1" — when the peer
    did not advertise v2. A non-default local request wins over the
    peer's wish; either way the result is clamped to what both ends
    support, falling back to raw/none rather than erroring. Delta is
    the exception to wish-adoption: it needs per-link reference state
    on the accepting side, so it is only chosen when *our own* request
    asks for it (and the peer's codec list shows it can decode deltas);
    a peer wishing for delta against a non-delta acceptor gets raw."""
    if not isinstance(peer, dict):
        return None
    try:
        if int(peer.get("v", 1)) < WIRE_VERSION:
            return None
    except (TypeError, ValueError):
        return None
    peer_codecs = set(peer.get("codecs") or (CODEC_RAW,))
    want = codec if codec != CODEC_RAW else str(peer.get("codec") or CODEC_RAW)
    if want == CODEC_DELTA and codec != CODEC_DELTA:
        want = CODEC_RAW
    chosen = want if want in CODECS and want in peer_codecs else CODEC_RAW
    peer_precs = set(peer.get("precisions") or (PREC_NONE,))
    wantp = precision if precision != PREC_NONE \
        else str(peer.get("precision") or PREC_NONE)
    chosenp = wantp if wantp in PRECISIONS and wantp in peer_precs \
        else PREC_NONE
    dk = DELTA_KEYFRAME_INTERVAL if delta_k is None else int(delta_k)
    return WireConfig(chosen, chosenp, delta_k=dk,
                      trace=bool(peer.get("trace")) and _obs_spans.ENABLED)


def accept(reply: Optional[Dict]) -> Optional[WireConfig]:
    """Connecting side: adopt the config the accepting side chose (the
    ``wire`` block echoed in CAPS_ACK). None — plain v1 — when the peer
    didn't echo one (any pre-v2 build)."""
    if not isinstance(reply, dict):
        return None
    try:
        if int(reply.get("v", 1)) < WIRE_VERSION:
            return None
    except (TypeError, ValueError):
        return None
    try:
        dk = int(reply.get("delta_k", DELTA_KEYFRAME_INTERVAL))
    except (TypeError, ValueError):
        dk = DELTA_KEYFRAME_INTERVAL
    return WireConfig(str(reply.get("codec") or CODEC_RAW),
                      str(reply.get("precision") or PREC_NONE),
                      delta_k=dk,
                      trace=bool(reply.get("trace")) and _obs_spans.ENABLED)


def tune_socket(sock, bufsize: int = 1 << 20) -> None:
    """Latency/throughput socket defaults for tensor links: NODELAY
    (frames are whole messages; never wait on Nagle) and roomy kernel
    buffers so a burst of coalesced frames doesn't stall the sender."""
    import socket as _socket
    try:
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    except OSError:
        pass  # AF_UNIX etc.
    for opt in (_socket.SO_SNDBUF, _socket.SO_RCVBUF):
        try:
            sock.setsockopt(_socket.SOL_SOCKET, opt, bufsize)
        except OSError:
            pass


# -- bf16 on the bits --------------------------------------------------


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), round to nearest even;
    a NaN becomes the quiet NaN of its sign (0x7FC0/0xFFC0). Subnormals
    round like any other value (no flush to zero)."""
    u = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    out = ((u + bias) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(arr)
    if nan.any():
        out[nan] = np.where(np.signbit(arr[nan]), 0xFFC0, 0x7FC0)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


# -- per-tensor encode/decode ------------------------------------------


def _byte_shuffle(view, itemsize: int) -> bytes:
    """blosc-style shuffle: byte k of every element becomes contiguous."""
    u8 = np.frombuffer(view, np.uint8)
    return u8.reshape(-1, itemsize).T.tobytes()


def _byte_unshuffle(data: bytes, itemsize: int) -> np.ndarray:
    u8 = np.frombuffer(data, np.uint8)
    # transpose().copy() restores element order AND yields writable memory
    return u8.reshape(itemsize, -1).transpose().copy().reshape(-1)


def _wire_arr(value, precision: str) -> Tuple[np.ndarray, Dict]:
    """One host value -> (contiguous array of its wire bytes, base tensor
    meta): bf16 as uint16 bits, a float32 downcast under
    ``wire-precision``. The delta codec's references are these arrays,
    so precision composes *under* delta and diffs are exact in the wire
    domain."""
    arr, name = host_array(value)
    if arr.size and not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    t = {"dtype": name, "shape": list(arr.shape)}
    if precision != PREC_NONE and name == "float32":
        wname = _PREC_DTYPE[precision]
        arr = (f32_to_bf16_bits(arr) if wname == BF16
               else np.ascontiguousarray(arr.astype(np.float16)))
        t["wire_dtype"] = wname
    return arr, t


def _encode_tensor(value, cfg: Optional[WireConfig]
                   ) -> Tuple[Payload, Dict, int, int]:
    """One host value (ndarray, or a CPU bf16 tensor) -> (payload,
    tensor-meta, raw_nbytes, codec_code)."""
    arr, t = _wire_arr(value, PREC_NONE if cfg is None else cfg.precision)
    raw = as_payload_view(arr)
    nraw = len(raw)
    if cfg is None or cfg.codec == CODEC_RAW or nraw < MIN_COMPRESS or \
            not cfg._try_compress():
        return raw, t, nraw, _CODE_RAW
    itemsize = arr.dtype.itemsize
    if cfg.codec == CODEC_SHUFFLE and itemsize > 1:
        data = _byte_shuffle(raw, itemsize)
        code = _CODE_SHUFFLE
    else:
        data = raw
        code = _CODE_ZLIB
    if nraw > 4 * PROBE_BYTES and \
            len(zlib.compress(data[:PROBE_BYTES], COMPRESS_LEVEL)) >= \
            KEEP_RATIO * PROBE_BYTES:
        # even the sample won't shrink: incompressible, don't pay for
        # the full attempt (counts toward the adaptive skip like one)
        cfg._note(False)
        return raw, t, nraw, _CODE_RAW
    comp = zlib.compress(data, COMPRESS_LEVEL)
    if len(comp) < KEEP_RATIO * nraw:
        cfg._note(True)
        return comp, t, nraw, code
    cfg._note(False)
    return raw, t, nraw, _CODE_RAW


def _decode_tensor(t: Dict, p: Payload, code: Optional[int] = None,
                   upcast: bool = True):
    """One payload -> a writable host value per its tensor-meta (+
    optional numeric codec code from a batch's ``enc`` list): an
    ndarray, or a CPU bf16 tensor for dtype bfloat16. ``upcast=False``
    returns the wire bytes' array as it stands (the delta decoder keeps
    references in the wire dtype, exactly like the sender's)."""
    codec = _CODE_NAME.get(code) if code is not None else t.get("codec")
    wname = t.get("wire_dtype")
    dtype = resolve_dtype(wname or t["dtype"])
    shape = tuple(t["shape"])
    if codec == CODEC_SHUFFLE:
        arr = _byte_unshuffle(zlib.decompress(p), dtype.itemsize) \
            .view(dtype).reshape(shape)
    elif codec == CODEC_ZLIB:
        arr = np.frombuffer(bytearray(zlib.decompress(p)), dtype) \
            .reshape(shape)
    elif isinstance(p, np.ndarray) and p.dtype == dtype and \
            p.shape == shape and p.flags.writeable:
        arr = p  # recv_msg preallocated it: already in place, writable
    else:
        raw = p.tobytes() if isinstance(p, np.ndarray) else p
        arr = np.frombuffer(raw, dtype).reshape(shape)
        if not arr.flags.writeable:
            arr = arr.copy()
    if not upcast:
        return arr
    return _deliver(arr, t)


def _deliver(arr: np.ndarray, t: Dict):
    """Wire-dtype array -> the host value the app sees (upcast under
    ``wire-precision``; bf16 bits as a CPU bf16 tensor)."""
    wname = t.get("wire_dtype")
    if wname:
        arr = (bf16_bits_to_f32(arr) if wname == BF16
               else arr.astype(resolve_dtype(t["dtype"])))
    return host_value(arr, t["dtype"])


# -- delta codec (temporal keyframe + sparse diff) ---------------------


def _delta_layout_ok(st: Dict, arrs: List[np.ndarray],
                     names: List[str]) -> bool:
    return st["names"] == names and all(
        r.shape == a.shape and r.dtype == a.dtype
        for r, a in zip(st["refs"], arrs))


def _zlib_maybe(data: bytes) -> Tuple[bytes, bool]:
    """zlib when it pays (same MIN/KEEP thresholds as the codec path,
    no adaptive skip: delta decisions must be deterministic so the
    delta-on/off parity is exact)."""
    if len(data) < MIN_COMPRESS:
        return data, False
    comp = zlib.compress(data, COMPRESS_LEVEL)
    if len(comp) < KEEP_RATIO * len(data):
        return comp, True
    return data, False


def _delta_encode(buf: Buffer, cfg: WireConfig
                  ) -> Tuple[bool, int, List[Dict], List[Payload],
                             List[int], int, int, bool]:
    """One frame under the link's sender delta state (caller holds
    cfg._dlock) -> (keyframe?, epoch, tensor metas, payloads, numeric
    codes, raw bytes, enc bytes, promoted?). Keyframe triggers: fresh
    link, layout change, K-th frame, or a diff that would not beat the
    dense frame."""
    from ..elements.sparse import encode_bits
    pairs = [_wire_arr(c.host(), cfg.precision) for c in buf.chunks]
    arrs = [a for a, _t in pairs]
    # the dtype name of each tensor's wire bytes: its sparse header type
    names = [t.get("wire_dtype") or t["dtype"] for _a, t in pairs]
    nraw = sum(a.nbytes for a in arrs)
    st = cfg._dtx
    promoted = False
    key = False
    if st is None or not _delta_layout_ok(st, arrs, names):
        key = True
        promoted = st is not None  # caps/layout change mid-stream
    elif cfg.delta_k > 0 and st["n"] + 1 >= cfg.delta_k:
        key = True
    diffs: List[Tuple[bytes, bool]] = []
    if not key:
        total = 0
        for a, name, ref in zip(arrs, names, st["refs"]):
            payload, z = _zlib_maybe(encode_bits(a, name, ref))
            diffs.append((payload, z))
            total += len(payload)
        if total >= KEEP_RATIO * max(nraw, 1):
            key = True       # the diff does not pay: promote to keyframe
            promoted = True
    tensors: List[Dict] = []
    payloads: List[Payload] = []
    codes: List[int] = []
    nenc = 0
    if key:
        epoch = 1 if st is None else st["e"] + 1
        for a, t in pairs:
            payload, z = _zlib_maybe(as_payload_view(a))
            codes.append(_CODE_ZLIB if z else _CODE_RAW)
            payloads.append(payload)
            tensors.append(dict(t))
            nenc += len(payload)
        cfg._dtx = {"refs": [a.copy() for a in arrs], "names": names,
                    "e": epoch, "n": 0}
        return True, epoch, tensors, payloads, codes, nraw, nenc, promoted
    epoch = st["e"]
    for (a, t), (payload, z) in zip(pairs, diffs):
        tensors.append(dict(t))
        codes.append(_CODE_DELTA_Z if z else _CODE_DELTA)
        payloads.append(payload)
        nenc += len(payload)
    st["refs"] = [a.copy() for a in arrs]
    st["n"] += 1
    return False, epoch, tensors, payloads, codes, nraw, nenc, False


def _delta_decode(tensors: Sequence[Dict], payloads: Sequence[Payload],
                  key: bool, epoch: int, cfg: WireConfig,
                  codes: Optional[Sequence[int]] = None) -> List:
    """One frame's payloads -> delivered host values, advancing the
    receiver reference state (caller holds cfg._dlock). A diff whose
    epoch does not match the held reference raises: the link layer
    treats that as a dead link and reconnects, which restarts from a
    keyframe. Delivered values never alias a reference (downstream
    transforms mutate in place)."""
    st = cfg._drx
    out: List = []
    if key:
        refs = []
        for j, (t, p) in enumerate(zip(tensors, payloads)):
            code = codes[j] if codes is not None else None
            arr = _decode_tensor(t, p, code, upcast=False)
            refs.append(arr.copy())
            out.append(_deliver(arr, t))
        cfg._drx = {"refs": refs, "e": epoch}
        return out
    if st is None or st.get("e") != epoch:
        raise ValueError(
            "delta diff against a missing/stale reference (held epoch "
            f"{None if st is None else st['e']}, frame wants {epoch})")
    from ..elements.sparse import decode_bits
    refs = st["refs"]
    if len(refs) != len(tensors):
        raise ValueError("delta diff tensor count mismatch")
    for j, (t, p) in enumerate(zip(tensors, payloads)):
        code = codes[j] if codes is not None else None
        z = (code == _CODE_DELTA_Z) if code is not None \
            else bool(t.get("dz"))
        data = p.tobytes() if isinstance(p, np.ndarray) else bytes(p)
        if z:
            data = zlib.decompress(data)
        arr, _name = decode_bits(data, ref=refs[j])
        refs[j] = arr
        out.append(_deliver(arr if t.get("wire_dtype") else arr.copy(), t))
    return out


def _delta_out_stats(stats, key: bool, promoted: bool,
                     nraw: int, nenc: int) -> None:
    stats.add(wire_delta_keyframes=int(key), wire_delta_diffs=int(not key),
              wire_delta_promotions=int(promoted),
              wire_delta_bytes_saved=max(0, nraw - nenc))


# -- frame pack/unpack -------------------------------------------------


def pack_buffer(buf: Buffer, cfg: Optional[WireConfig] = None, stats=None
                ) -> Tuple[Dict, List[Payload]]:
    """Buffer -> one DATA/RESULT message body under the link config.
    With ``cfg=None`` the meta is exactly v1 ``buffer_to_wire`` output
    (no codec/wire_dtype keys ever appear), so it is always safe for a
    v1 peer. A chunk on the card is copied to the host here (a
    prefetched chunk's copy is already in flight and is waited for)."""
    if cfg is not None and cfg.codec == CODEC_DELTA:
        return _pack_buffer_delta(buf, cfg, stats)
    t0 = time.perf_counter_ns()
    tensors: List[Dict] = []
    payloads: List[Payload] = []
    nraw = nenc = 0
    for c in buf.chunks:
        payload, t, raw_b, code = _encode_tensor(c.host(), cfg)
        if code != _CODE_RAW:
            t["codec"] = _CODE_NAME[code]
        tensors.append(t)
        payloads.append(payload)
        nraw += raw_b
        nenc += len(payload)
    meta = {"pts": buf.pts, "duration": buf.duration, "tensors": tensors}
    if cfg is not None and cfg.trace:
        ctx = buf.extras.get(_obs_ctx.CTX_KEY)
        if ctx is not None:
            meta["trace"] = _obs_ctx.to_wire(ctx)
    if stats is not None:
        stats.add(wire_frames_out=1, wire_raw_bytes_out=nraw,
                  wire_enc_bytes_out=nenc,
                  wire_pack_ns=time.perf_counter_ns() - t0)
    return meta, payloads


def _pack_buffer_delta(buf: Buffer, cfg: WireConfig, stats=None
                       ) -> Tuple[Dict, List[Payload]]:
    """pack_buffer for a delta link: frame-level meta carries the
    reference epoch (+ ``k`` on keyframes); diff tensors are marked
    ``codec=delta`` (``dz=1`` when the sparse bytes are zlib'd)."""
    t0 = time.perf_counter_ns()
    with cfg._dlock:
        key, epoch, tensors, payloads, codes, nraw, nenc, promoted = \
            _delta_encode(buf, cfg)
    for t, code in zip(tensors, codes):
        if code == _CODE_ZLIB:
            t["codec"] = CODEC_ZLIB
        elif code in (_CODE_DELTA, _CODE_DELTA_Z):
            t["codec"] = CODEC_DELTA
            if code == _CODE_DELTA_Z:
                t["dz"] = 1
    meta = {"pts": buf.pts, "duration": buf.duration, "tensors": tensors,
            "delta": {"e": epoch, "k": 1} if key else {"e": epoch}}
    if cfg.trace:
        ctx = buf.extras.get(_obs_ctx.CTX_KEY)
        if ctx is not None:
            meta["trace"] = _obs_ctx.to_wire(ctx)
    if stats is not None:
        stats.add(wire_frames_out=1, wire_raw_bytes_out=nraw,
                  wire_enc_bytes_out=nenc,
                  wire_pack_ns=time.perf_counter_ns() - t0)
        _delta_out_stats(stats, key, promoted, nraw, nenc)
    return meta, payloads


def unpack_buffer(meta: Dict, payloads: Sequence[Payload], stats=None,
                  cfg: Optional[WireConfig] = None) -> Buffer:
    """Inverse of :func:`pack_buffer`; handles plain-v1 and every v2
    codec/precision marker. Chunk arrays are always writable. ``cfg``
    is only needed on links that negotiated the delta codec (the
    receiver keeps reference state in it)."""
    if meta.get("delta") is not None:
        return _unpack_buffer_delta(meta, payloads, stats, cfg)
    if stats is not None:
        stats.inc("wire_frames_in")
    tensors = meta.get("tensors", [])
    if not any("codec" in t or "wire_dtype" in t for t in tensors):
        buf = protocol.wire_to_buffer(meta, payloads)
    else:
        chunks = [Chunk(_decode_tensor(t, p))
                  for t, p in zip(tensors, payloads)]
        buf = Buffer(chunks, pts=meta.get("pts"),
                     duration=meta.get("duration"))
    trace = meta.get("trace")
    if trace is not None and _obs_spans.ENABLED:
        _adopt_trace(buf, trace)
    return buf


def _unpack_buffer_delta(meta: Dict, payloads: Sequence[Payload],
                         stats=None, cfg: Optional[WireConfig] = None
                         ) -> Buffer:
    if cfg is None or cfg.codec != CODEC_DELTA:
        raise ValueError(
            "delta frame on a link that did not negotiate wire-codec="
            "delta (no receiver reference state)")
    d = meta["delta"]
    key = bool(d.get("k"))
    with cfg._dlock:
        values = _delta_decode(meta.get("tensors", []), payloads, key,
                               int(d.get("e", 0)), cfg)
    buf = Buffer([Chunk(v) for v in values], pts=meta.get("pts"),
                 duration=meta.get("duration"))
    if stats is not None:
        stats.add(wire_frames_in=1, wire_delta_keyframes_in=int(key),
                  wire_delta_diffs_in=int(not key))
    trace = meta.get("trace")
    if trace is not None and _obs_spans.ENABLED:
        _adopt_trace(buf, trace)
    return buf


def _adopt_trace(buf: Buffer, field) -> None:
    """Receiver side of a traced DATA frame: rebuild the context, record
    the wire-hop span (parented on the sender's last span — the ids are
    fleet-unique, so the merged dump re-links across processes), and
    attribute the transit time."""
    got = _obs_ctx.from_wire(field)
    if got is None:
        return
    ctx, t_send = got
    now = time.time_ns()
    dur = max(0, now - t_send)
    _obs_spans.record_span("wire", "wire", t_send, dur, ctx)
    ctx.w_ns += dur
    _obs_ctx.attach(buf, ctx)


def batch_compatible(a: Buffer, b: Buffer) -> bool:
    """Frames can share one DATA_BATCH template iff chunk layouts match
    (read from the chunks' metadata: nothing is copied to the host)."""
    if len(a.chunks) != len(b.chunks):
        return False
    return all(ca.type == cb.type and tuple(ca.shape) == tuple(cb.shape)
               for ca, cb in zip(a.chunks, b.chunks))


def _stamp_fhdr(hdr: bytearray, i: int, buf: Buffer, seq: int,
                trace: bool) -> None:
    """Stamp frame i's binary header record (v1 or trace-extended)."""
    pts = float("nan") if buf.pts is None else float(buf.pts)
    dur = float("nan") if buf.duration is None else float(buf.duration)
    if trace:
        ctx = buf.extras.get(_obs_ctx.CTX_KEY)
        if ctx is None:
            _FHDR_T.pack_into(hdr, i * _FHDR_T.size, int(seq), pts,
                              dur, int(buf.flags), 0, 0, 0, 0, 0, 0)
        else:
            _FHDR_T.pack_into(hdr, i * _FHDR_T.size, int(seq), pts,
                              dur, int(buf.flags), ctx.trace_id,
                              ctx.span_id, ctx.t0_ns, ctx.q_ns,
                              ctx.c_ns, ctx.w_ns)
    else:
        _FHDR.pack_into(hdr, i * _FHDR.size, int(seq), pts, dur,
                        int(buf.flags))


def pack_batch(bufs: Sequence[Buffer], cfg: Optional[WireConfig] = None,
               stats=None, seqs: Optional[Sequence[int]] = None
               ) -> Tuple[Dict, List[Payload]]:
    """N layout-identical frames -> one DATA_BATCH message body: a meta
    template (shapes/dtypes once), payload[0] a compact binary per-frame
    header (seq/pts/duration/flags), then frames×tensors payloads with a
    numeric ``enc`` codec list. Only ever sent on links that negotiated
    v2 (a v1 peer cannot parse DATA_BATCH)."""
    if cfg is not None and cfg.codec == CODEC_DELTA:
        return _pack_batch_delta(bufs, cfg, stats, seqs)
    t0 = time.perf_counter_ns()
    trace = cfg is not None and cfg.trace and _obs_spans.ENABLED
    fhdr = _FHDR_T if trace else _FHDR
    hdr = bytearray(fhdr.size * len(bufs))
    template: List[Dict] = []
    enc: List[int] = []
    payloads: List[Payload] = [hdr]
    nraw = nenc = 0
    for i, buf in enumerate(bufs):
        seq = seqs[i] if seqs is not None and seqs[i] is not None else -1
        _stamp_fhdr(hdr, i, buf, seq, trace)
        for c in buf.chunks:
            payload, t, raw_b, code = _encode_tensor(c.host(), cfg)
            if i == 0:
                template.append(t)
            enc.append(code)
            payloads.append(payload)
            nraw += raw_b
            nenc += len(payload)
    meta = {"wire_batch": 1, "frames": len(bufs), "tensors": template,
            "enc": enc}
    if trace:
        meta["fhdr"] = 2
        meta["ts"] = time.time_ns()   # one send stamp for the batch
    if stats is not None:
        stats.add(wire_frames_out=len(bufs), wire_raw_bytes_out=nraw,
                  wire_enc_bytes_out=nenc,
                  wire_pack_ns=time.perf_counter_ns() - t0)
    return meta, payloads


def _pack_batch_delta(bufs: Sequence[Buffer], cfg: WireConfig,
                      stats=None, seqs: Optional[Sequence[int]] = None
                      ) -> Tuple[Dict, List[Payload]]:
    """pack_batch for a delta link: frames are delta-encoded in order
    against the evolving link reference (a coalesced batch can hold a
    mid-batch keyframe: K rollover or promotion); per-frame epochs and
    keyframe flags ride in the ``delta`` meta block, per-payload codecs
    in the numeric ``enc`` list."""
    t0 = time.perf_counter_ns()
    trace = cfg.trace and _obs_spans.ENABLED
    fhdr = _FHDR_T if trace else _FHDR
    hdr = bytearray(fhdr.size * len(bufs))
    template: List[Dict] = []
    enc: List[int] = []
    es: List[int] = []
    ks: List[int] = []
    payloads: List[Payload] = [hdr]
    nraw = nenc = 0
    with cfg._dlock:
        for i, buf in enumerate(bufs):
            seq = seqs[i] if seqs is not None and seqs[i] is not None else -1
            _stamp_fhdr(hdr, i, buf, seq, trace)
            key, epoch, tensors, pls, codes, r, e, promoted = \
                _delta_encode(buf, cfg)
            if i == 0:
                template = tensors
            es.append(epoch)
            ks.append(int(key))
            enc.extend(codes)
            payloads.extend(pls)
            nraw += r
            nenc += e
            if stats is not None:
                _delta_out_stats(stats, key, promoted, r, e)
    meta = {"wire_batch": 1, "frames": len(bufs), "tensors": template,
            "enc": enc, "delta": {"es": es, "ks": ks}}
    if trace:
        meta["fhdr"] = 2
        meta["ts"] = time.time_ns()
    if stats is not None:
        stats.add(wire_frames_out=len(bufs), wire_raw_bytes_out=nraw,
                  wire_enc_bytes_out=nenc,
                  wire_pack_ns=time.perf_counter_ns() - t0)
    return meta, payloads


def unpack_batch(meta: Dict, payloads: Sequence[Payload], stats=None,
                 cfg: Optional[WireConfig] = None) -> List[Buffer]:
    """Inverse of :func:`pack_batch` -> the original frames, in order,
    with pts/duration/flags restored and seq (when present) in
    ``extras["seq"]``. ``cfg`` is only needed on delta links (receiver
    reference state)."""
    if meta.get("delta") is not None:
        return _unpack_batch_delta(meta, payloads, stats, cfg)
    frames = int(meta.get("frames", 0))
    template = meta.get("tensors", [])
    enc = meta.get("enc")
    ntens = len(template)
    hdr = payloads[0]
    traced = int(meta.get("fhdr", 1)) >= 2
    fhdr = _FHDR_T if traced else _FHDR
    t_send = int(meta.get("ts", 0))
    if stats is not None:
        stats.add(wire_frames_in=frames)
    out: List[Buffer] = []
    idx = 1
    for i in range(frames):
        rec = fhdr.unpack_from(hdr, i * fhdr.size)
        seq, pts, dur, flags = rec[:4]
        chunks = []
        for j, t in enumerate(template):
            code = enc[i * ntens + j] if enc else _CODE_RAW
            chunks.append(Chunk(_decode_tensor(t, payloads[idx], code)))
            idx += 1
        buf = Buffer(chunks,
                     pts=None if pts != pts else pts,
                     duration=None if dur != dur else dur,
                     flags=BufferFlags(flags))
        if seq >= 0:
            buf.extras["seq"] = seq
        if traced and _obs_spans.ENABLED and rec[4]:
            _adopt_trace(buf, (rec[4], rec[5], t_send,
                               rec[6], rec[7], rec[8], rec[9]))
        out.append(buf)
    return out


def _unpack_batch_delta(meta: Dict, payloads: Sequence[Payload],
                        stats=None, cfg: Optional[WireConfig] = None
                        ) -> List[Buffer]:
    if cfg is None or cfg.codec != CODEC_DELTA:
        raise ValueError(
            "delta batch on a link that did not negotiate wire-codec="
            "delta (no receiver reference state)")
    frames = int(meta.get("frames", 0))
    template = meta.get("tensors", [])
    enc = meta.get("enc") or []
    d = meta["delta"]
    es, ks = d.get("es") or [], d.get("ks") or []
    ntens = len(template)
    hdr = payloads[0]
    traced = int(meta.get("fhdr", 1)) >= 2
    fhdr = _FHDR_T if traced else _FHDR
    t_send = int(meta.get("ts", 0))
    out: List[Buffer] = []
    idx = 1
    with cfg._dlock:
        for i in range(frames):
            rec = fhdr.unpack_from(hdr, i * fhdr.size)
            seq, pts, dur, flags = rec[:4]
            key = bool(ks[i]) if i < len(ks) else False
            epoch = int(es[i]) if i < len(es) else 0
            codes = enc[i * ntens:(i + 1) * ntens]
            values = _delta_decode(template, payloads[idx:idx + ntens],
                                   key, epoch, cfg, codes)
            idx += ntens
            if stats is not None:
                stats.add(wire_frames_in=1,
                          wire_delta_keyframes_in=int(key),
                          wire_delta_diffs_in=int(not key))
            buf = Buffer([Chunk(v) for v in values],
                         pts=None if pts != pts else pts,
                         duration=None if dur != dur else dur,
                         flags=BufferFlags(flags))
            if seq >= 0:
                buf.extras["seq"] = seq
            if traced and _obs_spans.ENABLED and rec[4]:
                _adopt_trace(buf, (rec[4], rec[5], t_send,
                                   rec[6], rec[7], rec[8], rec[9]))
            out.append(buf)
    return out
