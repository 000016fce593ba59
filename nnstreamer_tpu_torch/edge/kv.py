"""KV-block handoff between disaggregated LLM replicas (KV_XFER/KV_ACK).

Port of ``nnstreamer_tpu/edge/kv.py``, which is framework neutral: the
same framing, negotiation and acks, byte for byte, so either package's
prefill replica ships to either package's decode replica. The payloads
go through the port's ``wire._encode_tensor``/``_decode_tensor``: a
bfloat16 K/V is a CPU ``torch.bfloat16`` tensor on the host (its uint16
bit patterns on the wire, under the dtype name ``"bfloat16"``), any
other dtype an ndarray. Everything here runs on the host; the ``llm``
filter moves the K/V off and onto the card around it.

A prefill-role replica runs only the prompt pass; the resulting KV
prefix ([L, T, H, Dh] per tensor, plus the last-position logits the
decode loop samples first) must land inside a decode-role replica's
continuous-batching pool. This module is that link:

* **framing** — one KV_XFER message per stream: JSON meta (stream id =
  the prompt's ``token_sha`` digest, the prompt itself for
  prefix-cache commit and snapshot re-adoption, remaining budget,
  sampling seed, any already-emitted tokens when re-shipping after a
  crash) + the K/V/logits payloads encoded through the SAME
  ``_encode_tensor`` path as DATA frames, so the wire-v2 precision
  downcast (bf16/fp16) and adaptive compression apply unchanged;
* **negotiation** — the sender opens with CAPS carrying a standard
  ``wire.advertise`` block and adopts the receiver's CAPS_ACK echo,
  exactly like the trace field: an old peer that never learned
  KV_XFER simply never negotiates one of these links, and nothing on
  existing links changes byte-wise;
* **tracing** — when both ends advertised tracing, meta carries the
  frame-trace context and the receiver records a ``kv-handoff`` span
  parented on the sender's prefill span, so the span rings
  (``obs/spans.py``) hold prefill -> handoff -> decode as one connected
  tree per conversation.

The transport is deliberately dumb (one request, one ack, blocking):
handoffs are per-conversation control traffic, not the per-frame hot
path, and the ack doubles as admission backpressure — a decode
replica that cannot allocate pool blocks answers ``adopted=False``
and the prefill side can retry elsewhere.
"""
from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs import context as _obs_ctx
from ..obs import spans as _obs_spans
from . import wire
from .listener import TcpListener
from .protocol import MsgKind, recv_msg, send_msg

logger = logging.getLogger(__name__)


def pack_kv(sid: str, prompt, k, v, logits, *, remaining: int, seed: int,
            emitted=(), cfg: Optional[wire.WireConfig] = None,
            ctx=None):
    """-> (meta, payloads) for one KV_XFER message. ``k``, ``v`` and
    ``logits`` are host values: ndarrays, or CPU bf16 tensors."""
    metas: List[Dict] = []
    payloads: List = []
    codes: List[int] = []
    for arr in (k, v, logits):
        p, t, _, code = wire._encode_tensor(arr, cfg)
        metas.append(t)
        payloads.append(p)
        codes.append(code)
    meta = {"sid": str(sid),
            "prompt": [int(t) for t in np.asarray(prompt).ravel()],
            "emitted": [int(t) for t in emitted],
            "remaining": int(remaining), "seed": int(seed),
            "tensors": metas, "enc": codes}
    if cfg is not None and cfg.trace and ctx is not None:
        meta["trace"] = _obs_ctx.to_wire(ctx)
    return meta, payloads


def unpack_kv(meta: Dict, payloads) -> Dict:
    """KV_XFER meta+payloads -> handoff dict (k/v/logits as host values,
    upcast back to their declared dtype when the link downcast them;
    bfloat16 as a CPU tensor). The receiver records the wire-hop span here so the
    trace tree connects across the replica hop."""
    codes = meta.get("enc") or [None] * len(payloads)
    arrs = [wire._decode_tensor(t, p, c) for t, p, c in
            zip(meta["tensors"], payloads, codes)]
    out = {"sid": str(meta.get("sid", "")),
           "prompt": np.asarray(meta.get("prompt", ()), np.int32),
           "emitted": [int(t) for t in meta.get("emitted", ())],
           "remaining": int(meta.get("remaining", 0)),
           "seed": int(meta.get("seed", 0)),
           "k": arrs[0], "v": arrs[1], "logits": arrs[2], "ctx": None}
    got = _obs_ctx.from_wire(meta.get("trace"))
    if got is not None:
        ctx, t_send = got
        now = time.time_ns()
        dur = max(0, now - t_send)
        _obs_spans.record_span("kv-handoff", "wire", t_send, dur, ctx)
        ctx.w_ns += dur
        out["ctx"] = ctx
    return out


class KvSender:
    """Prefill side: one persistent negotiated link to a decode
    replica's KvReceiver. ``send`` blocks for the KV_ACK (handoffs are
    control-plane, and the ack is the admission signal)."""

    def __init__(self, host: str, port: int, *, codec: str = "raw",
                 precision: str = "none", timeout: float = 10.0,
                 stats=None):
        self.host, self.port = host, int(port)
        self.codec, self.precision = codec, precision
        self.timeout = timeout
        self.stats = stats
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.cfg: Optional[wire.WireConfig] = None

    def _connect_locked(self) -> None:
        if self._sock is not None:
            return
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        wire.tune_socket(sock)
        send_msg(sock, MsgKind.CAPS,
                 {"kv": 1,
                  "wire": wire.advertise(self.codec, self.precision)},
                 stats=self.stats)
        kind, meta, _ = recv_msg(sock, stats=self.stats)
        if kind != MsgKind.CAPS_ACK:
            sock.close()
            raise ConnectionError(f"kv handshake got {kind!r}")
        self.cfg = wire.accept(meta.get("wire"))
        self._sock = sock

    def send(self, sid: str, prompt, k, v, logits, *, remaining: int,
             seed: int, emitted=(), ctx=None) -> Dict:
        """Ship one stream; returns the KV_ACK meta ({"sid", "adopted"}).
        A transport error tears the link down (next send reconnects)
        and re-raises for the caller's failover accounting."""
        with self._lock:
            self._connect_locked()
            try:
                meta, payloads = pack_kv(
                    sid, prompt, k, v, logits, remaining=remaining,
                    seed=seed, emitted=emitted, cfg=self.cfg, ctx=ctx)
                send_msg(self._sock, MsgKind.KV_XFER, meta, payloads,
                         stats=self.stats)
                # racecheck: ok(deliberate: _lock is a LEAF serializing the one link; the blocking ack IS the admission signal, bounded by the socket timeout)
                kind, ack, _ = recv_msg(self._sock, stats=self.stats)
            except (ConnectionError, OSError, ValueError):
                self.close_locked()
                raise
            if kind != MsgKind.KV_ACK:
                self.close_locked()
                raise ConnectionError(f"kv xfer got {kind!r}")
            return ack

    def close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self.cfg = None

    def close(self) -> None:
        with self._lock:
            self.close_locked()


class KvReceiver:
    """Decode side: accept KV_XFER streams and hand each decoded
    handoff dict to ``on_kv`` (called on the per-connection listener
    thread; it returns truthy iff the stream was admitted, which
    becomes the ack's ``adopted`` flag)."""

    def __init__(self, host: str, port: int,
                 on_kv: Callable[[Dict], bool], *, codec: str = "raw",
                 precision: str = "none", name: str = "kv-rx",
                 stats=None):
        self._on_kv = on_kv
        self.codec, self.precision = codec, precision
        self.stats = stats
        self._listener = TcpListener(host, port, self._conn_loop,
                                     name=name)

    @property
    def bound_port(self) -> int:
        return self._listener.bound_port

    def start(self) -> "KvReceiver":
        self._listener.start()
        return self

    def stop(self) -> None:
        self._listener.stop()

    def _conn_loop(self, conn: socket.socket) -> None:
        wire.tune_socket(conn)
        try:
            while not self._listener.stop_evt.is_set():
                kind, meta, payloads = recv_msg(conn, stats=self.stats)
                if kind == MsgKind.CAPS:
                    cfg = wire.negotiate(meta.get("wire"), self.codec,
                                         self.precision)
                    ack: Dict = {"kv": 1}
                    if cfg is not None:
                        ack["wire"] = cfg.to_meta()
                    send_msg(conn, MsgKind.CAPS_ACK, ack,
                             stats=self.stats)
                elif kind == MsgKind.KV_XFER:
                    d = unpack_kv(meta, payloads)
                    try:
                        adopted = bool(self._on_kv(d))
                    except Exception:  # noqa: BLE001 — a bad stream must not kill the link
                        logger.exception("kv-rx: on_kv failed for %s",
                                         d.get("sid"))
                        adopted = False
                    send_msg(conn, MsgKind.KV_ACK,
                             {"sid": d["sid"], "adopted": adopted},
                             stats=self.stats)
                elif kind == MsgKind.EOS:
                    break
        except (ConnectionError, OSError, ValueError) as exc:
            logger.info("kv-rx: connection ended: %r", exc)
        finally:
            try:
                conn.close()
            except OSError:
                pass
