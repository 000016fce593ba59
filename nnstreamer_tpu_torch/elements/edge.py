"""edgesink / edgesrc — tensor stream pub/sub between pipelines/hosts.

Port of ``nnstreamer_tpu/elements/edge.py`` (≙ gst/edge/edge_sink.c +
edge_src.c, thin publisher/subscriber over nnstreamer-edge): edgesink
accepts N subscribers and broadcasts every buffer; edgesrc connects and
replays the feed into its pipeline. Topic filtering mirrors the
MQTT-hybrid topic semantics: a subscriber passes ``topic`` at SUBSCRIBE
and only receives matching streams. The wire is the JAX package's, byte
for byte, so either side may be the JAX package's element.

Delivery guarantees (edge/session.py, negotiated per link at SUBSCRIBE
exactly like wire v2 — a subscriber that doesn't advertise a session
gets byte-identical v1 traffic):

* the publisher stamps every broadcast frame with one monotonic seq and
  retains unacknowledged frames in a bytes-budgeted replay ring;
* each session subscriber returns cumulative ACKs and, after a
  reconnect, presents RESUME(sid, last-delivered); the publisher
  replays exactly the gap while the subscriber dedups by seq;
* if the ring evicted frames the gap needed, the loss is *declared* —
  an exact frames_lost count in the RESUME_ACK plus a structured bus
  warning on both ends, never a silent hole;
* PING/PONG heartbeats detect half-open links, feeding the per-link
  circuit breaker (fault/breaker.py) that paces re-dials.

The publisher packs on the thread that renders (a chunk still on the
card is copied to the host there, or its in-flight prefetch waited
for); the accept, flush and per-subscriber reader threads and the
subscriber's loop touch host data only.

Not ported: ``wire-codec=delta`` (edgesink refuses it at start,
ROADMAP.md queue A item 7; a JAX publisher asking for it falls back to
raw toward a port subscriber), the graceful drain, and the
checkpoint/restore hooks (the port has neither).
"""
from __future__ import annotations

import collections
import select
import socket
import threading
import time
from typing import Dict, List, Optional

from ..edge import session as sess_mod
from ..edge import wire
from ..edge.protocol import MsgKind, recv_msg, send_msg, sever_socket as _sever
from ..obs import events as _obs_events
from ..pipeline.element import SinkElement, SrcElement
from ..pipeline.pad import Pad
from ..pipeline.registry import refuse_element, register_element
from ..tensors.buffer import Buffer
from ..tensors.caps import Caps
from ..utils.log import logger


# the other among-device elements of the JAX package, still to port
for _kind in ("mqttsrc", "mqttsink", "tensor_src_grpc", "tensor_sink_grpc"):
    refuse_element(_kind, "the MQTT and gRPC transports are still to port "
                          "(ROADMAP.md queue A, item 8)")


class _Sub:
    """One attached subscriber: socket, negotiated wire config, a send
    lock (broadcast bytes and the reader thread's PONGs must not
    interleave on the socket), and the session id (None = v1/sessionless
    link: no seqs, no reader thread)."""

    __slots__ = ("sock", "cfg", "lock", "sid")

    def __init__(self, sock, cfg, sid=None):
        self.sock = sock
        self.cfg = cfg
        self.lock = threading.Lock()
        self.sid = sid


@register_element("edgesink")
class EdgeSink(SinkElement):
    PROPS = {"host": "localhost", "port": 3000, "topic": "",
             "connect-type": "TCP",
             # wire v2 link request, applied per subscriber that
             # advertises support (v1 subscribers keep plain framing):
             # lossless payload codec + opt-in lossy fp32 downcast
             # (wire-codec=delta is refused at start: not ported)
             "wire-codec": "raw", "wire-precision": "none",
             # frame coalescing: broadcast up to N frames per message
             # (DATA_BATCH, v2 subscribers only), flushing a partial
             # batch once its oldest frame has waited coalesce-ms
             "coalesce-frames": 1, "coalesce-ms": 5.0,
             # session layer: accept subscriber sessions (acked
             # delivery + resume); the replay ring retains this many KB
             # of unacknowledged frames for gap replay before evicting
             # (evictions become *declared* loss, never silent)
             "session": True, "session-ring-kb": 8192}
    # the delta codec's keyframe cadence: only its default is accepted
    NOT_PORTED = {"wire-delta-k": wire.DELTA_KEYFRAME_INTERVAL}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._listener: Optional[socket.socket] = None
        self._subs: List[_Sub] = []
        self._subs_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._caps_str = ""
        # seeded so sent == acked + ring + declared_lost is readable
        # from any snapshot (same discipline as EdgeSrc/query client)
        self.stats.update({"session_sent": 0, "session_replayed": 0,
                           "session_declared_lost": 0})
        # coalesce state: the chain thread appends + size-flushes, the
        # flush worker age-flushes. _co_lock is held across the whole
        # take-and-send so the two flushers can neither interleave bytes
        # on a subscriber socket nor reorder batches; it also serializes
        # broadcast against RESUME replay, which is what makes "replayed
        # frames always precede newer live frames" true.
        self._co_lock = threading.Lock()
        self._co_pending: List[Buffer] = []
        self._co_t0 = 0.0
        self._flush_thread: Optional[threading.Thread] = None
        # session-layer publisher state: one global seq space + one
        # bytes-budgeted ring shared by all sessions (frames are packed
        # once per config, so seqs must be identical across links);
        # per-session acked watermarks decide what the ring may drop
        self._next_seq = 0  # written under _co_lock
        self._ring = sess_mod.ReplayRing(
            int(self.session_ring_kb) * 1024)
        self._sessions: Dict[str, Dict] = {}
        self._sess_lock = threading.Lock()

    @property
    def bound_port(self) -> int:
        return self._listener.getsockname()[1] if self._listener else self.port

    def start(self) -> None:
        if str(self.wire_codec) == wire.CODEC_DELTA:
            from ..pipeline.element import NotPortedError
            raise NotPortedError(
                f"{self.name}: wire-codec=delta is not ported yet: it "
                f"encodes through tensor_sparse_* (ROADMAP.md queue A, "
                f"item 7)")
        super().start()
        self._stop_evt.clear()
        # parse_launch sets properties after construction, so the ring
        # budget is only final here
        self._ring.budget = max(0, int(self.session_ring_kb) * 1024)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(16)
        threading.Thread(target=self._accept_loop,
                         name=f"edgesink-accept:{self.name}",
                         daemon=True).start()
        if int(self.coalesce_frames) > 1:
            self._flush_thread = threading.Thread(
                target=self._flush_loop,
                name=f"edgesink-flush:{self.name}", daemon=True)
            self._flush_thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._subs_lock:
            for sub in self._subs:
                _sever(sub.sock)
            self._subs.clear()
        super().stop()

    def kill_link(self) -> int:
        """Chaos hook (tensor_fault mode=kill-link): force-close every
        live subscriber socket, exactly like a network partition mid
        stream. Session state and the replay ring survive, so resumed
        subscribers replay the gap."""
        with self._subs_lock:
            victims = list(self._subs)
            self._subs.clear()
        for sub in victims:
            _sever(sub.sock)
        self.stats.inc("link_kills", len(victims))
        return len(victims)

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self._caps_str = str(caps)

    def handle_event(self, pad, event) -> None:
        from ..pipeline.events import CapsEvent
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            self.on_sink_caps(pad, event.caps)
            return
        super().handle_event(pad, event)

    def _accept_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                kind, meta, _ = recv_msg(conn)
                want = meta.get("topic", "")
                if kind != MsgKind.SUBSCRIBE or \
                        (self.topic and want and want != self.topic):
                    send_msg(conn, MsgKind.ERROR, {"reason": "topic mismatch"})
                    conn.close()
                    continue
                # wire v2: fold the subscriber's advertisement into OUR
                # requested codec/precision; a v1 subscriber (no "wire"
                # block) gets plain framing and never sees DATA_BATCH
                cfg = wire.negotiate(meta.get("wire"),
                                     codec=str(self.wire_codec),
                                     precision=str(self.wire_precision))
                # session fold, same shape: no "session" block in the
                # SUBSCRIBE = no session = strict v1 on this link
                scfg = None
                if self.session:
                    scfg = sess_mod.negotiate(
                        meta.get("session"),
                        ring_bytes=int(self.session_ring_kb) * 1024)
                ack = {"caps": self._caps_str, "topic": self.topic}
                if cfg is not None:
                    ack["wire"] = cfg.to_meta()
                if scfg is not None:
                    ack["session"] = scfg.to_meta()
                wire.tune_socket(conn)
                if scfg is None:
                    # the ack and the link's entry into the broadcast set
                    # are one step under _co_lock: a frame rendered once
                    # the subscriber holds its ack reaches it (the
                    # reference appends after the ack, and a frame
                    # broadcast in between is lost to this link)
                    with self._co_lock:
                        send_msg(conn, MsgKind.CAPS_ACK, ack)
                        with self._subs_lock:
                            self._subs.append(_Sub(conn, cfg))
                    continue
                send_msg(conn, MsgKind.CAPS_ACK, ack)
                # a session subscriber ALWAYS follows with RESUME
                # (last=0 on first attach); it is handled — and the
                # gap replayed — before the link joins the broadcast
                # set, so replays can never arrive after newer
                # live frames
                conn.settimeout(5.0)
                kind, rmeta, _ = recv_msg(conn)
                conn.settimeout(None)
                if kind != MsgKind.RESUME:
                    raise ConnectionError(f"expected RESUME, got {kind}")
                self._attach_session(conn, cfg, scfg,
                                     int(rmeta.get("last", 0)))
            except (ConnectionError, OSError, ValueError):
                try:
                    conn.close()
                except OSError:
                    pass

    def _attach_session(self, conn, cfg, scfg, last: int) -> None:
        """RESUME handling: register/resume the session, replay exactly
        the gap (or declare what the ring already evicted), then attach.
        Runs under _co_lock so no broadcast interleaves: every replayed
        seq is on the wire before any newer live frame."""
        sub = _Sub(conn, cfg, sid=scfg.sid)
        with self._co_lock:
            with self._sess_lock:
                state = self._sessions.get(scfg.sid)
                if state is None:
                    # fresh attach: only frames broadcast from now on
                    # are owed to this session
                    resumed = False
                    base = self._next_seq
                    self._sessions[scfg.sid] = {"acked": base, "resumes": 0}
                    replay, lost = [], 0
                else:
                    resumed = True
                    base = last
                    state["acked"] = max(state["acked"], last)
                    state["resumes"] += 1
                    replay, lost = self._ring.replay_from(last + 1)
            # count BEFORE anything reaches the wire: the subscriber
            # learns the loss from the RESUME_ACK, so any observer it
            # tips off must already see the counters updated — never a
            # window where the peer knows about declared loss that the
            # publisher's own stats have not recorded yet
            if replay:
                self.stats.inc("session_replayed", len(replay))
            if lost:
                # the ring could not cover the whole gap: the loss is
                # exact and DECLARED — counted here, counted by the
                # subscriber from the RESUME_ACK, and posted to the bus
                self.stats.inc("session_declared_lost", lost)
                self.post_message(
                    "warning", session=scfg.sid[:8], frames_lost=lost,
                    detail="replay ring evicted part of the resume gap")
            if resumed:
                self.stats.inc("session_resumes")
                _obs_events.emit("resume", source=self.name, element=self,
                                 session=scfg.sid[:8],
                                 replayed=len(replay), lost=lost)
            with sub.lock:
                send_msg(conn, MsgKind.RESUME_ACK,
                         {"sid": scfg.sid, "resumed": resumed,
                          "lost": lost, "base": base}, stats=self.stats)
                for seq, frame in replay:
                    meta, payloads = wire.pack_buffer(frame, cfg,
                                                      stats=self.stats)
                    meta["seq"] = seq
                    if self.topic:
                        meta["topic"] = self.topic
                    send_msg(conn, MsgKind.DATA, meta, payloads,
                             stats=self.stats)
            with self._subs_lock:
                self._subs.append(sub)
        threading.Thread(target=self._sub_reader, args=(sub,),
                         name=f"edgesink-ack:{self.name}",
                         daemon=True).start()

    def _sub_reader(self, sub: _Sub) -> None:
        """Per-session-subscriber reader: consumes ACKs (release the
        ring), PINGs (answer PONG under the send lock) and EOS. Ends
        with the socket."""
        while not self._stop_evt.is_set():
            try:
                kind, meta, _ = recv_msg(sub.sock)
            except (ConnectionError, OSError, ValueError):
                return
            if kind == MsgKind.ACK:
                self._on_ack(sub.sid, int(meta.get("seq", 0)))
            elif kind == MsgKind.PING:
                try:
                    with sub.lock:
                        send_msg(sub.sock, MsgKind.PONG,
                                 {"t": meta.get("t", 0.0)})
                except (ConnectionError, OSError):
                    return
            elif kind == MsgKind.EOS:
                return

    def _on_ack(self, sid: str, seq: int) -> None:
        with self._sess_lock:
            state = self._sessions.get(sid)
            if state is None:
                return
            state["acked"] = max(state["acked"], seq)
            floor = min(s["acked"] for s in self._sessions.values())
        # release only what EVERY session has acknowledged; a detached
        # (reconnecting) session keeps its gap replayable until the
        # bytes budget forces eviction — which is then declared
        self._ring.release(floor)
        self.stats.inc("session_acks_in")

    def render(self, buf: Buffer) -> None:
        if int(self.coalesce_frames) <= 1:
            with self._co_lock:
                self._broadcast([buf])
            return
        with self._co_lock:
            if self._co_pending and \
                    not wire.batch_compatible(self._co_pending[0], buf):
                # layout change: ship what we have, open a new batch
                self._broadcast(self._co_pending)
                self._co_pending = []
            if not self._co_pending:
                self._co_t0 = time.monotonic()
            self._co_pending.append(buf)
            if len(self._co_pending) >= int(self.coalesce_frames):
                take, self._co_pending = self._co_pending, []
                self._broadcast(take)

    def _flush_loop(self) -> None:
        """Age flush: a partial batch never waits longer than
        coalesce-ms for stragglers (mirrors the serve batcher's
        max-wait discipline)."""
        max_age = max(1e-3, float(self.coalesce_ms) / 1e3)
        while not self._stop_evt.is_set():
            self._stop_evt.wait(max_age / 2)
            with self._co_lock:
                if self._co_pending and \
                        time.monotonic() - self._co_t0 >= max_age:
                    take, self._co_pending = self._co_pending, []
                    self._broadcast(take)

    def _broadcast(self, frames: List[Buffer]) -> None:
        """Fan one or more frames out to every subscriber: v2 links get
        one DATA_BATCH per flush (or codec'd DATA for a single frame),
        v1 links always get per-frame plain DATA. Messages are packed
        once per distinct (config, session-ness), not once per
        subscriber — session links carry seqs, v1 links stay
        byte-identical to pre-session builds. Callers hold _co_lock, so
        flushes can neither interleave bytes nor reorder batches, and
        seq stamping is strictly monotonic in send order."""
        with self._subs_lock:
            subs = list(self._subs)
        # stamp + retain while ANY session is registered (attached or
        # resuming): a detached subscriber's gap accrues in the ring
        with self._sess_lock:
            stamp = bool(self._sessions)
        seqs: Optional[List[int]] = None
        if stamp:
            seqs = []
            for f in frames:
                self._next_seq += 1
                self._ring.append(self._next_seq, f)
                seqs.append(self._next_seq)
            self.stats.inc("session_sent", len(frames))
        dead = []
        packed: dict = {}
        for sub in subs:
            cfg = sub.cfg
            with_seq = sub.sid is not None and seqs is not None
            key = (None if cfg is None
                   else (cfg.codec, cfg.precision, cfg.trace,
                         len(frames) > 1),
                   with_seq)
            msgs = packed.get(key)
            if msgs is None:
                if cfg is not None and len(frames) > 1:
                    msgs = [(MsgKind.DATA_BATCH,
                             wire.pack_batch(frames, cfg, stats=self.stats,
                                             seqs=seqs if with_seq
                                             else None))]
                else:
                    msgs = [(MsgKind.DATA,
                             wire.pack_buffer(f, cfg, stats=self.stats))
                            for f in frames]
                    if with_seq:
                        for i, (_k, (meta, _p)) in enumerate(msgs):
                            meta["seq"] = seqs[i]
                if self.topic:
                    for _, (meta, _pls) in msgs:
                        meta["topic"] = self.topic
                packed[key] = msgs
            try:
                with sub.lock:
                    for kind, (meta, payloads) in msgs:
                        send_msg(sub.sock, kind, meta, payloads,
                                 stats=self.stats)
            except (ConnectionError, OSError):
                dead.append(sub)
        if dead:
            # the socket died but the SESSION did not: its acked
            # watermark stays registered, the gap accrues in the ring,
            # and a RESUME replays it (or declares what was evicted)
            self.stats.inc("link_errors", len(dead))
            with self._subs_lock:
                self._subs = [s for s in self._subs if s not in dead]

    def session_info(self) -> Dict:
        """Live (non-counter) session gauges for the trace report."""
        with self._sess_lock:
            n = len(self._sessions)
        if not n:
            return {}
        return {"sessions": n, "ring_frames": len(self._ring),
                "ring_bytes": self._ring.nbytes}

    def on_eos(self) -> None:
        # ship any coalesced frames still waiting before the EOS marker
        with self._co_lock:
            take, self._co_pending = self._co_pending, []
            if take:
                self._broadcast(take)
        with self._subs_lock:
            subs = list(self._subs)
        for sub in subs:
            try:
                with sub.lock:
                    send_msg(sub.sock, MsgKind.EOS, {})
            except (ConnectionError, OSError):
                pass
        super().on_eos()


@register_element("edgesrc")
class EdgeSrc(SrcElement):
    # reconnect=true: a dropped publisher link is re-dialed with
    # exponential backoff + jitter inside the timeout window instead of
    # ending the stream as EOS (set false to keep the old die-on-drop
    # behavior — e.g. when a supervisor owns restarts)
    PROPS = {"dest-host": "localhost", "dest-port": 3000, "topic": "",
             "connect-type": "TCP", "timeout": 10.0, "reconnect": True,
             # session=true: negotiate acked delivery + resume (the
             # publisher replays reconnect gaps; what it cannot replay
             # is declared, never silent). ack cadence: a cumulative
             # ACK every ack-every frames or ack-ms of silence.
             "session": False, "ack-every": 8, "ack-ms": 50.0,
             # heartbeat-ms>0: PING an idle publisher link this often;
             # heartbeat-miss unanswered PINGs declare the peer dead
             # (close + reconnect) and feed the link circuit breaker
             "heartbeat-ms": 0.0, "heartbeat-miss": 3}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._sock: Optional[socket.socket] = None
        # the wire config adopted from the publisher's CAPS_ACK echo,
        # minted fresh at every (re)subscribe (frames are self-describing:
        # unpacking reads their meta, this records what the link chose)
        self._wire_cfg: Optional[wire.WireConfig] = None
        # frames from an unpacked DATA_BATCH beyond the first, drained
        # before the next recv (only the source loop touches this)
        self._rxq: "collections.deque" = collections.deque()
        # session counters seeded at zero so the accounting identity
        # (delivered + declared_lost vs the publisher's sent) is always
        # readable from a snapshot, not only after the first increment
        self.stats.update({"reconnects": 0, "link_errors": 0,
                           "session_delivered": 0, "session_dup_drops": 0,
                           "session_declared_lost": 0})
        # session id minted HERE (the connecting peer) and stable across
        # reconnects: it is the resume key
        self._sid = sess_mod.new_session_id()
        self._sess: Optional[sess_mod.SessionReceiver] = None
        self._hb: Optional[sess_mod.Heartbeat] = None
        # link circuit breaker: consecutive link failures / dead-peer
        # declarations open it, pacing re-dials; a successful
        # resubscribe (or pong) closes it. Transitions go to the bus.
        from ..fault.breaker import CircuitBreaker
        self._breaker = CircuitBreaker(
            threshold=max(1, int(self.heartbeat_miss)), reset_s=1.0,
            name=f"{self.name}-link", on_transition=self._breaker_moved)

    def start(self) -> None:
        # parse_launch sets properties after construction: the breaker
        # threshold is only final here
        self._breaker.threshold = max(1, int(self.heartbeat_miss))
        super().start()

    def _breaker_moved(self, old: str, new: str) -> None:
        self.post_message("warning", breaker=new,
                          detail=f"publisher link breaker {old} -> {new}")

    def _subscribe(self) -> Caps:
        """Connect + SUBSCRIBE handshake (the one dial site: first
        connect and every reconnect share it), backed off with jitter
        inside the timeout budget. With session=true the handshake
        continues RESUME -> RESUME_ACK: the publisher replays the gap
        since our last delivered frame before any live traffic."""
        from ..fault.backoff import Backoff
        deadline = time.monotonic() + self.timeout
        backoff = Backoff(base=0.05, multiplier=2.0, max_s=1.0)
        last_err = None
        sock = None
        while time.monotonic() < deadline and not self._stop_evt.is_set():
            if not self._breaker.allow():
                # breaker OPEN: the peer kept failing; wait out the
                # reset window instead of hammering a dead endpoint
                backoff.sleep(self._stop_evt)
                continue
            try:
                sock = socket.create_connection(
                    (self.dest_host, int(self.dest_port)),
                    timeout=self.timeout)
                break
            except OSError as e:
                last_err = e
                self._breaker.record_failure()
                backoff.sleep(self._stop_evt)
        if sock is None:
            raise ConnectionError(
                f"{self.name}: cannot reach edgesink at "
                f"{self.dest_host}:{self.dest_port}: {last_err}")
        wire.tune_socket(sock)
        # advertise v2 support; the publisher's wire-codec/precision
        # props decide what this link actually uses (echoed in the ack)
        sub_meta = {"topic": self.topic, "wire": wire.advertise()}
        if self.session:
            sub_meta["session"] = sess_mod.advertise(
                self._sid, int(self.ack_every), float(self.ack_ms))
        send_msg(sock, MsgKind.SUBSCRIBE, sub_meta)
        kind, meta, _ = recv_msg(sock)
        if kind != MsgKind.CAPS_ACK:
            raise ConnectionError(f"{self.name}: subscribe rejected ({kind})")
        # adopt the publisher's choice
        self._wire_cfg = wire.accept(meta.get("wire"))
        scfg = sess_mod.accept(meta.get("session")) if self.session else None
        if scfg is not None:
            self._resume(sock, scfg)
        else:
            self._sess = None
            self._hb = None
        # a per-op timeout so a peer dying mid-frame cannot wedge the
        # recv loop forever; idle waits use select (see create), so this
        # never fires between messages on a healthy link
        sock.settimeout(max(0.1, float(self.timeout)))
        # published only now: a concurrent stop() severs either the old
        # socket (handshake fails cleanly) or this one, never a half
        # handshake on a nulled attribute
        self._sock = sock
        if self._stop_evt.is_set():
            _sever(sock)
            raise ConnectionError(f"{self.name}: stopped during subscribe")
        self._breaker.record_success()
        caps_str = meta.get("caps") or "other/tensors,format=flexible"
        return Caps(caps_str)

    def _resume(self, sock, scfg: sess_mod.SessionConfig) -> None:
        """RESUME handshake on a fresh socket: present (sid, last
        delivered), adopt the publisher's answer, account the declared
        gap exactly."""
        last = self._sess.last_delivered if self._sess is not None else 0
        send_msg(sock, MsgKind.RESUME,
                 {"sid": self._sid, "last": last})
        kind, meta, _ = recv_msg(sock)
        if kind != MsgKind.RESUME_ACK:
            raise ConnectionError(f"{self.name}: expected RESUME_ACK, "
                                  f"got {kind}")
        if self._sess is None:
            self._sess = sess_mod.SessionReceiver(scfg)
            self._sess.reset(int(meta.get("base", 0)))
        elif not meta.get("resumed", False):
            # the publisher no longer knows us (restarted: ring and seq
            # space gone). The in-flight gap is unresolvable — declare
            # the reset loudly and adopt the new seq space.
            self.stats.inc("session_resets")
            self.post_message(
                "warning", session=self._sid[:8],
                detail="publisher lost our session (restart?); "
                       "in-flight frames from the old session are gone")
            self._sess.reset(int(meta.get("base", 0)))
        lost = int(meta.get("lost", 0))
        if lost:
            # exact declared loss: the publisher's ring evicted this
            # many frames of our gap. Counted, posted, never silent.
            self.stats.inc("session_declared_lost", lost)
            self.post_message("warning", session=self._sid[:8],
                              frames_lost=lost,
                              detail="publisher replay ring evicted part "
                                     "of our reconnect gap")
        hb_ms = float(self.heartbeat_ms)
        if hb_ms > 0 and self._hb is None:
            self._hb = sess_mod.Heartbeat(hb_ms / 1e3,
                                          int(self.heartbeat_miss))

    def negotiate_src_caps(self) -> Optional[Caps]:
        return self._subscribe()

    def _reconnect(self) -> bool:
        """Re-dial after a dropped link; True when resubscribed (and,
        with a session, resumed: the gap is already replayed or
        declared by the time this returns)."""
        sock, self._sock = self._sock, None
        _sever(sock)
        try:
            self._subscribe()
        except (ConnectionError, OSError) as exc:
            logger.warning("%s: reconnect failed: %s", self.name, exc)
            return False
        self.stats.inc("reconnects")
        self.post_message("warning", reconnects=self.stats["reconnects"],
                          detail="publisher link re-established")
        return True

    # -- session housekeeping (source loop only: single socket writer) --
    def _maybe_ack(self) -> None:
        sock = self._sock
        if self._sess is None or sock is None:
            return
        due = self._sess.ack_due()
        if due is not None:
            # advisory: a failed ACK is not a link error here — the
            # next recv on the dead socket reports it exactly once
            try:
                send_msg(sock, MsgKind.ACK,
                         {"sid": self._sid, "seq": due}, stats=self.stats)
            except (ConnectionError, OSError):
                return
            self._sess.mark_acked(due)
            self.stats.inc("session_acks_out")

    def _final_ack(self) -> None:
        """Best-effort cumulative ACK of everything delivered (at EOS):
        lets the publisher's accounting settle to sent == acked."""
        sock = self._sock
        if self._sess is None or sock is None:
            return
        try:
            send_msg(sock, MsgKind.ACK,
                     {"sid": self._sid, "seq": self._sess.last_delivered})
            self._sess.mark_acked(self._sess.last_delivered)
            self.stats.inc("session_acks_out")
        except (ConnectionError, OSError):
            pass

    def _idle_tick(self, sock) -> None:
        """Between messages: flush a due ACK; run the heartbeat (PING
        an idle link, declare a peer dead after heartbeat-miss
        unanswered PINGs — feeding the circuit breaker)."""
        self._maybe_ack()
        hb = self._hb
        if hb is None:
            return
        if hb.peer_dead:
            self._breaker.record_failure()
            raise ConnectionError(
                f"{self.name}: publisher missed {hb.outstanding} "
                f"heartbeats — declaring the link dead")
        if hb.due():
            send_msg(sock, MsgKind.PING, {"t": time.monotonic()},
                     stats=self.stats)
            hb.sent()
            self.stats.inc("session_pings")

    def _idle_wait(self, sock) -> bool:
        """Wait for readable data, bounded so ACK/heartbeat cadence is
        honored on an idle link. True = data is waiting."""
        tmo = 0.5
        if self._sess is not None:
            tmo = min(tmo, max(0.01, float(self.ack_ms) / 1e3))
        if self._hb is not None:
            tmo = min(tmo, self._hb.interval_s / 2)
        r, _w, _x = select.select([sock], [], [], tmo)
        return bool(r)

    def create(self) -> Optional[Buffer]:
        if self._rxq:
            return self._rxq.popleft()
        while not self._stop_evt.is_set():
            # snapshot: stop()/kill_link() may null/close _sock from
            # another thread mid-iteration
            sock = self._sock
            try:
                if sock is None:
                    raise ConnectionError(f"{self.name}: link closed")
                if not self._idle_wait(sock):
                    self._idle_tick(sock)
                    continue
                kind, meta, payloads = recv_msg(sock, stats=self.stats)
            except (ConnectionError, OSError, ValueError) as exc:
                if self._stop_evt.is_set():
                    return None
                self.stats.inc("link_errors")
                self._breaker.record_failure()
                logger.info("%s: publisher link lost (%r)", self.name, exc)
                if self.reconnect and self._reconnect():
                    continue
                return None
            if self._hb is not None:
                self._hb.heard()
            if kind == MsgKind.DATA:
                try:
                    buf = wire.unpack_buffer(meta, payloads,
                                             stats=self.stats)
                except ValueError as exc:
                    if self._decode_failed(exc):
                        continue
                    return None
                if self._sess is not None:
                    if not self._sess.admit(meta.get("seq")):
                        # a replayed frame we already delivered before
                        # the outage: drop the duplicate, count it
                        self.stats.inc("session_dup_drops")
                        self._maybe_ack()
                        continue
                    self.stats.inc("session_delivered")
                    self._maybe_ack()
                return buf
            if kind == MsgKind.DATA_BATCH:
                try:
                    frames = wire.unpack_batch(meta, payloads,
                                               stats=self.stats)
                except ValueError as exc:
                    if self._decode_failed(exc):
                        continue
                    return None
                if self._sess is not None:
                    kept = []
                    for f in frames:
                        if self._sess.admit(f.extras.get("seq")):
                            kept.append(f)
                        else:
                            self.stats.inc("session_dup_drops")
                    self.stats.inc("session_delivered", len(kept))
                    frames = kept
                    self._maybe_ack()
                if not frames:
                    continue
                self._rxq.extend(frames[1:])
                return frames[0]
            if kind == MsgKind.PONG:
                if self._hb is not None:
                    rtt = self._hb.pong(meta.get("t", 0.0))
                    self.stats.add(session_pongs=1,
                                   session_rtt_ns=int(rtt * 1e9))
                self._breaker.record_success()
                continue
            if kind == MsgKind.DRAIN:
                # publisher is draining: it will flush + EOS shortly;
                # nothing to do but note it (we keep receiving the tail)
                self.stats.inc("peer_drains")
                continue
            if kind == MsgKind.EOS:
                self._final_ack()
                return None
        return None

    def _decode_failed(self, exc: ValueError) -> bool:
        """An undecodable frame (a torn payload, a delta frame this side
        never negotiated) is a link fault: tear the connection down and
        re-handshake; a session resume replays the gap. True =
        reconnected."""
        if self._stop_evt.is_set():
            return False
        self.stats.inc("link_errors")
        self._breaker.record_failure()
        logger.warning("%s: undecodable frame (%s); re-subscribing",
                       self.name, exc)
        return bool(self.reconnect and self._reconnect())

    def kill_link(self) -> int:
        """Chaos hook (tensor_fault mode=kill-link): force-close the
        live publisher socket mid-stream. The source loop sees the
        failure, reconnects, and resumes the session."""
        sock = self._sock
        if sock is None:
            return 0
        _sever(sock)
        self.stats.inc("link_kills")
        return 1

    def session_info(self) -> Dict:
        if self._sess is None:
            return {}
        return {"sid": self._sid[:8],
                "last_delivered": self._sess.last_delivered}

    def stop(self) -> None:
        # order matters: the stop flag first, so a create() loop that
        # sees its socket die does not dial one more reconnect
        self._stop_evt.set()
        if self._sock is not None:
            _sever(self._sock)
            self._sock = None
        super().stop()
