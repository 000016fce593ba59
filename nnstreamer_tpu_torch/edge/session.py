"""Stream-integrity sessions: acknowledged delivery over reliable links.

A copy of ``nnstreamer_tpu/edge/session.py``, which is framework
neutral, without ``ReplayRing.dump``/``load`` (the checkpoint layer
that calls them is not ported).

Wire v1 framing (protocol.py) and wire v2 compaction (wire.py) restore a
dropped *socket*; this module restores the *stream*. Every link that
negotiates a session gets:

* a **session id** minted by the connecting peer, surviving reconnects;
* **per-frame monotonic sequence numbers** stamped by the sender;
* a **bytes-budgeted replay ring** of sent-but-unacknowledged frames on
  the sender (:class:`ReplayRing`);
* **cumulative ACKs** from the receiver (:class:`SessionReceiver`
  decides when one is due — every ``ack_every`` frames or ``ack_ms``
  of silence, whichever first);
* a **RESUME handshake** on reconnect: the receiver presents
  ``(session id, last delivered seq)`` and the sender replays exactly
  the gap while the receiver dedups by seq. If the ring already evicted
  frames the gap needed, the loss is *declared* — an exact
  ``frames_lost`` count in the RESUME_ACK, never a silent hole;
* **PING/PONG heartbeats** (:class:`Heartbeat`) for dead-peer detection
  feeding the existing circuit breaker (fault/breaker.py).

Negotiation mirrors wire v2 exactly (see wire.py): the connecting side
puts ``{"session": advertise(...)}`` in its handshake meta, the
accepting side folds it with :func:`negotiate` and echoes the chosen
block in the CAPS_ACK, the connecting side adopts it with
:func:`accept`. A peer that never mentions ``session`` gets ``None``
out of both — strict v1, byte-identical traffic, no acks, no new
message kinds on the wire.
"""
from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

SESSION_VERSION = 1

# sender-side replay budget: how many bytes of unacknowledged frames are
# retained for resumption before the oldest are evicted (and their loss
# declared, never silent)
DEFAULT_RING_BYTES = 8 << 20
# receiver ack cadence: cumulative ACK after this many delivered frames…
DEFAULT_ACK_EVERY = 8
# …or after this much silence with undelivered acks, whichever first
DEFAULT_ACK_MS = 50.0


def new_session_id() -> str:
    return uuid.uuid4().hex


class SessionConfig:
    """The negotiated per-link session parameters (one per connection;
    immutable after negotiation)."""

    __slots__ = ("version", "sid", "ack_every", "ack_ms", "ring_bytes")

    def __init__(self, sid: str, ack_every: int = DEFAULT_ACK_EVERY,
                 ack_ms: float = DEFAULT_ACK_MS,
                 ring_bytes: int = DEFAULT_RING_BYTES,
                 version: int = SESSION_VERSION):
        self.version = version
        self.sid = str(sid)
        self.ack_every = max(1, int(ack_every))
        self.ack_ms = max(1.0, float(ack_ms))
        self.ring_bytes = max(0, int(ring_bytes))

    def to_meta(self) -> Dict:
        return {"v": self.version, "sid": self.sid,
                "ack_every": self.ack_every, "ack_ms": self.ack_ms,
                "ring_bytes": self.ring_bytes}

    def __repr__(self) -> str:
        return (f"SessionConfig(sid={self.sid[:8]}…, "
                f"ack_every={self.ack_every}, ack_ms={self.ack_ms})")


def advertise(sid: str, ack_every: int = DEFAULT_ACK_EVERY,
              ack_ms: float = DEFAULT_ACK_MS) -> Dict:
    """The ``session`` block a connecting peer puts in its handshake
    meta: the session id it minted plus its preferred ack cadence."""
    return {"v": SESSION_VERSION, "sid": str(sid),
            "ack_every": int(ack_every), "ack_ms": float(ack_ms)}


def negotiate(peer: Optional[Dict],
              ring_bytes: int = DEFAULT_RING_BYTES) -> Optional[SessionConfig]:
    """Accepting side: fold the peer's session advertisement. Returns
    None — speak strict v1, no session frames ever — when the peer did
    not advertise one (any pre-session build), exactly like
    wire.negotiate. The peer's ack cadence wish is honored; our replay
    budget is echoed for observability."""
    if not isinstance(peer, dict) or not peer.get("sid"):
        return None
    try:
        if int(peer.get("v", 0)) < SESSION_VERSION:
            return None
    except (TypeError, ValueError):
        return None
    try:
        return SessionConfig(str(peer["sid"]),
                             int(peer.get("ack_every", DEFAULT_ACK_EVERY)),
                             float(peer.get("ack_ms", DEFAULT_ACK_MS)),
                             int(ring_bytes))
    except (TypeError, ValueError):
        return None


def accept(reply: Optional[Dict]) -> Optional[SessionConfig]:
    """Connecting side: adopt the session block echoed in CAPS_ACK.
    None — no session on this link — when the peer didn't echo one."""
    return negotiate(reply, ring_bytes=(reply or {}).get(
        "ring_bytes", DEFAULT_RING_BYTES) if isinstance(reply, dict)
        else DEFAULT_RING_BYTES)


class ReplayRing:
    """Bytes-budgeted retention of sent-but-unacknowledged frames,
    keyed by seq. Appends evict the OLDEST frames once the budget is
    exceeded (the newest frame is always kept, even alone over budget);
    every eviction is remembered in ``evicted_through`` so a later
    resume can *declare* exactly how many frames are unrecoverable.

    Thread-safe: the sender's chain thread appends while per-link
    reader threads release on ACK and replay on RESUME.
    """

    def __init__(self, budget_bytes: int = DEFAULT_RING_BYTES):
        self.budget = max(0, int(budget_bytes))
        self._lock = threading.Lock()
        self._frames: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        # highest seq no longer retrievable (evicted or released): a
        # resume from at-or-below this point has a declared gap
        self.evicted_through = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._frames)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def append(self, seq: int, buf) -> None:
        nb = int(getattr(buf, "nbytes", 0))
        with self._lock:
            self._frames[seq] = (buf, nb)
            self._bytes += nb
            while self._bytes > self.budget and len(self._frames) > 1:
                old_seq, (_b, old_nb) = self._frames.popitem(last=False)
                self._bytes -= old_nb
                if old_seq > self.evicted_through:
                    self.evicted_through = old_seq

    def release(self, upto: int) -> None:
        """Acknowledged through ``upto``: those frames will never be
        replayed again, drop them. (Released ≠ evicted: a release moves
        the resume floor without declaring loss — the receiver HAS the
        frames, it said so.)"""
        with self._lock:
            while self._frames:
                seq = next(iter(self._frames))
                if seq > upto:
                    break
                _b, nb = self._frames.pop(seq)
                self._bytes -= nb

    def replay_from(self, frm: int) -> Tuple[List[Tuple[int, object]], int]:
        """Frames with ``seq >= frm`` still retained, in order, plus the
        count of frames in the requested range already evicted by budget
        pressure — the *declared* loss. 0 lost means the gap replays
        exactly."""
        with self._lock:
            lost = max(0, self.evicted_through - frm + 1)
            return ([(s, b) for s, (b, _nb) in self._frames.items()
                     if s >= frm], lost)


class SessionReceiver:
    """Receiver-side session state: a cumulative delivery watermark,
    seq dedup, and the ack-due policy. Single-threaded use (the source
    loop owns it); counters the caller surfaces live in the element's
    stats."""

    __slots__ = ("cfg", "last_delivered", "dup_drops",
                 "_acked", "_ack_t")

    def __init__(self, cfg: SessionConfig):
        self.cfg = cfg
        self.last_delivered = 0
        self.dup_drops = 0
        self._acked = 0          # highest seq we have ACKed
        self._ack_t = time.monotonic()

    def admit(self, seq: Optional[int]) -> bool:
        """True = deliver this frame; False = duplicate (a replay of a
        frame that survived the outage), drop it. Frames without a seq
        (pre-session traffic on a mixed link) always pass. A forward
        jump is fine — it is either a declared loss (already counted
        from the RESUME_ACK) or a fresh attach."""
        if seq is None:
            return True
        if seq <= self.last_delivered:
            self.dup_drops += 1
            return False
        self.last_delivered = seq
        return True

    def ack_due(self, now: Optional[float] = None) -> Optional[int]:
        """The cumulative seq to ACK now, or None. Due after
        ``ack_every`` unacked deliveries, or ``ack_ms`` of sitting on
        any unacked delivery — frequent enough to keep the sender's
        ring small, rare enough to stay off the hot path."""
        if self.last_delivered <= self._acked:
            return None
        now = time.monotonic() if now is None else now
        if (self.last_delivered - self._acked >= self.cfg.ack_every
                or (now - self._ack_t) * 1e3 >= self.cfg.ack_ms):
            return self.last_delivered
        return None

    def mark_acked(self, seq: int) -> None:
        self._acked = max(self._acked, seq)
        self._ack_t = time.monotonic()

    def reset(self, base: int) -> None:
        """Adopt a fresh sender seq space (publisher restarted and could
        not resume): dedup restarts at ``base`` so the new stream is not
        mistaken for duplicates."""
        self.last_delivered = base
        self._acked = base
        self._ack_t = time.monotonic()


class Heartbeat:
    """PING/PONG bookkeeping for dead-peer detection: the link owner
    calls :meth:`due` from its recv loop (idle gaps), :meth:`sent` per
    PING, :meth:`pong` per reply. ``miss_limit`` unanswered pings =
    declare the peer dead (close + reconnect) instead of trusting a
    half-open TCP socket forever. RTT aggregates feed the trace session
    block; outcomes feed the circuit breaker at the call site."""

    __slots__ = ("interval_s", "miss_limit", "outstanding",
                 "last_sent", "last_heard", "rtt_ns", "pongs", "_lock")

    def __init__(self, interval_s: float, miss_limit: int = 3):
        self.interval_s = max(0.01, float(interval_s))
        self.miss_limit = max(1, int(miss_limit))
        # leaf lock: heartbeats run only on idle gaps, so the cost is
        # nil, and observers (stats/trace reads) may race the recv loop
        self._lock = threading.Lock()
        self.outstanding = 0
        now = time.monotonic()
        self.last_sent = now
        self.last_heard = now
        self.rtt_ns = 0
        self.pongs = 0

    def due(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            return now - self.last_sent >= self.interval_s

    def sent(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self.last_sent = now
            self.outstanding += 1

    def pong(self, t_sent: float, now: Optional[float] = None) -> float:
        """Record a reply to the PING stamped ``t_sent`` (the echo of
        our own monotonic stamp); returns the RTT in seconds."""
        now = time.monotonic() if now is None else now
        rtt = max(0.0, now - float(t_sent))
        with self._lock:
            self.last_heard = now
            self.outstanding = 0
            self.rtt_ns += int(rtt * 1e9)
            self.pongs += 1
        return rtt

    def heard(self) -> None:
        """Any traffic from the peer proves liveness (data counts as a
        heartbeat; PINGs only fill idle gaps)."""
        now = time.monotonic()
        with self._lock:
            self.last_heard = now
            self.outstanding = 0

    @property
    def peer_dead(self) -> bool:
        with self._lock:
            return self.outstanding >= self.miss_limit
