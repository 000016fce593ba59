"""Fleet router: one front-end, N replica serve pipelines.

Port of ``nnstreamer_tpu/serve/router.py``, host code over the port's
edge layer (edge/wire, listener, protocol, session, broker) and
fault/breaker.py; it hashes with ``hashlib`` as the reference does, so a
session key maps to the same replica in both packages, and either
package's router fronts either package's ``tensor_serve_src``.

``tensor_serve_router`` accepts client streams on the exact query/serve
wire (CAPS/CAPS_ACK, DATA/DATA_BATCH -> RESULT/SHED/DRAIN) and fans each
request out to one of N replica ``tensor_serve_src`` pipelines, so the
single-pipeline serving stack stops being a single point of
failure. Robustness is the headline, composed from the existing layers:

* **consistent-hash session affinity** with a **least-loaded tiebreak**:
  a session's frames stick to one replica (its scheduler keeps the
  stream's arrival order and captured graphs warm); sessionless traffic
  and displaced sessions go to the replica with the smallest
  in-flight + reported-queue-depth load, fed by the occupancy reports
  replicas piggyback on PONG heartbeats and broker REGISTER metadata;
* a **per-replica health state machine** — connecting / healthy /
  suspect / down / draining — driven by PING/PONG heartbeats
  (edge/session.Heartbeat) and a per-link circuit breaker
  (fault/breaker.CircuitBreaker) that paces re-dials of a dead replica;
* **zero-loss failover**: every dispatched request sits in a pending
  table keyed by a router-minted seq until the replica answers. When a
  replica link dies, its unsettled requests are re-dispatched to a
  survivor (the session layer's replay/seq-dedup discipline: each
  settles exactly once — a late duplicate answer is counted in ``router_dup_drops``,
  never forwarded), and when no survivor exists they are SHED to the
  client with a retry-after, never silently dropped;
* **live membership** over the :class:`~..edge.broker.DiscoveryBroker`:
  replicas REGISTER with occupancy metadata, the router re-queries on a
  cadence and immediately after any replica death;
* **administrative drain**: :meth:`FleetRouter.drain_replica` (or a
  DRAIN the replica itself sends while its pipeline drains) marks one
  replica draining — its in-flight requests settle normally via the
  DRAIN/retry-after path while the ring steers its affinity sessions to
  the survivors.

The accounting identity clients rely on holds at any quiescent point::

    router_requests == router_delivered + router_shed + router_orphaned

(``router_orphaned`` counts answers owed to a client that disconnected
first — settled toward a peer that no longer exists).
"""
from __future__ import annotations

import bisect
import hashlib
import socket
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..edge import wire
from ..edge.listener import TcpListener
from ..edge.protocol import MsgKind, recv_msg, send_msg, sever_socket as _sever
from ..edge.session import Heartbeat
from ..fault.breaker import CircuitBreaker
from ..obs import events as _obs_events
from ..pipeline.element import Element
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer
from ..tensors.caps import Caps
from ..utils.atomic import Counters
from ..utils.log import logger

_FLEX_CAPS = "other/tensors,format=flexible"

# replica health states (report() vocabulary)
CONNECTING = "connecting"
HEALTHY = "healthy"
SUSPECT = "suspect"
DOWN = "down"
DRAINING = "draining"


def _hval(key: str) -> int:
    """Stable 64-bit hash (sha1 prefix): identical placement across
    processes and runs, unlike the salted builtin hash()."""
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over replica keys with virtual nodes: a
    session key maps to the first vnode clockwise, so membership changes
    remap only the sessions of the replicas that actually joined/left
    (~1/N of sessions per event, not a full reshuffle)."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = max(1, int(vnodes))
        self._ring: List[Tuple[int, str]] = []

    def rebuild(self, keys) -> None:
        ring = [(_hval(f"{k}#{i}"), k)
                for k in keys for i in range(self.vnodes)]
        ring.sort()
        self._ring = ring

    def lookup(self, session_key: str) -> Optional[str]:
        if not self._ring:
            return None
        i = bisect.bisect_right(self._ring, (_hval(session_key), ""))
        return self._ring[i % len(self._ring)][1]


class _Replica:
    """One replica link: socket + negotiated wire config + heartbeat +
    breaker. The socket/config/generation triple is published under the
    router's replica lock; the send lock keeps wire frames atomic
    between the dispatching client threads and the heartbeat timer."""

    __slots__ = ("key", "host", "port", "origin", "sock", "slock", "cfg",
                 "gen", "hb", "breaker", "draining", "load", "instance",
                 "restored_ad")

    def __init__(self, key: str, host: str, port: int, origin: str,
                 heartbeat_s: float, heartbeat_miss: int,
                 breaker_threshold: int, breaker_reset_s: float):
        self.key, self.host, self.port = key, host, int(port)
        self.origin = origin  # "static" (replicas= prop) or "broker"
        self.sock: Optional[socket.socket] = None
        self.slock = threading.Lock()
        self.cfg: Optional[wire.WireConfig] = None
        self.gen = 0
        self.hb = Heartbeat(heartbeat_s, heartbeat_miss)
        self.breaker = CircuitBreaker(threshold=breaker_threshold,
                                      reset_s=breaker_reset_s,
                                      name=f"replica:{key}")
        self.draining = False
        self.load: Dict = {}
        # the serve src's per-incarnation token (CAPS_ACK): a re-dial
        # that lands on the SAME process is a reconnect, not a rejoin —
        # it must not clear an administrative drain ("" = pre-token peer)
        self.instance = ""
        # whether the broker advert last seen for this endpoint carried
        # restored_sessions: resurrection counting is edge-triggered on
        # this, so a same-endpoint resurrect counts exactly once
        self.restored_ad = False

    @property
    def llm_role(self) -> str:
        """The replica's advertised LLM phase ("prefill" | "decode" |
        "both"; "" = not an LLM replica), carried by REGISTER metadata
        and refreshed by every PONG load report."""
        return str((self.load or {}).get("llm_role") or "")

    def state(self) -> str:
        if self.draining:
            return DRAINING
        if self.sock is None:
            return DOWN if self.gen else CONNECTING
        return SUSPECT if self.hb.outstanding > 0 else HEALTHY


def parse_replicas(spec: str) -> List[Tuple[str, int]]:
    """``host:port`` endpoints, comma or semicolon separated."""
    out = []
    for tok in str(spec or "").replace(";", ",").split(","):
        tok = tok.strip()
        if not tok:
            continue
        host, _, port = tok.rpartition(":")
        out.append((host or "localhost", int(port)))
    return out


class FleetRouter:
    """The embeddable core (the element below wraps it): accepts client
    streams, dispatches to replicas, fails over, drains."""

    def __init__(self, *, host: str = "localhost", port: int = 0,
                 replicas: str = "", topic: str = "",
                 broker_host: str = "localhost", broker_port: int = 0,
                 timeout: float = 10.0, affinity: bool = True,
                 session: bool = True, heartbeat_s: float = 0.25,
                 heartbeat_miss: int = 3, breaker_threshold: int = 3,
                 breaker_reset_s: float = 1.0, retry_after_ms: float = 50.0,
                 requery_s: float = 0.5, max_redispatch: int = 3,
                 name: str = "router", stats: Optional[Counters] = None):
        self.name = name
        self.timeout = max(0.1, float(timeout))
        self.affinity = bool(affinity)
        self.session = bool(session)
        self.heartbeat_s = max(0.01, float(heartbeat_s))
        self.heartbeat_miss = max(1, int(heartbeat_miss))
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_reset_s = max(0.01, float(breaker_reset_s))
        self.retry_after_ms = float(retry_after_ms)
        self.requery_s = max(0.05, float(requery_s))
        self.max_redispatch = max(0, int(max_redispatch))
        self.topic = str(topic or "")
        self.broker_host = broker_host or "localhost"
        self.broker_port = int(broker_port)
        self.stats = Counters()
        if stats is not None:
            self.stats = stats  # share the owning element's counters
        self.stats.update({
            "router_requests": 0, "router_delivered": 0, "router_shed": 0,
            "router_redispatched": 0, "router_dup_drops": 0,
            "router_orphaned": 0, "router_orphan_drops": 0,
            "router_replica_deaths": 0,
            "router_replica_connects": 0, "router_replica_drains": 0,
            # pre-seeded (not lazily minted on first event) so report()
            # and /metrics expose them as 0 from the first scrape — a
            # dashboard watching for the first rejoin/resurrection must
            # not have to special-case a missing series
            "router_replica_rejoins": 0,
            "router_replica_resurrections": 0,
            "link_errors": 0})
        self._listener = TcpListener(host, port, self._client_conn,
                                     name=f"router-accept:{name}")
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._draining = False
        # cid -> [conn, send lock, wire cfg, session key]
        self._clients: Dict[int, list] = {}
        self._next_cid = 0
        self._clock = threading.Lock()
        # replica key -> _Replica, plus the affinity ring over the keys
        # currently eligible for NEW dispatches (live, not draining)
        self._replicas: Dict[str, _Replica] = {}
        self._ring = HashRing()
        # decode-home ring for disaggregated LLM fleets: consistent
        # hashing over the DECODE-capable replicas only, so a stream's
        # decode home survives prefill membership churn (and vice
        # versa). Mirrors _ring while no replica advertises an llm_role.
        self._dring = HashRing()
        self._rlock = threading.Lock()
        # rseq -> [cid, client seq, buffer, replica key, attempts,
        # llm phase]: every dispatched-but-unsettled request; the
        # failover unit
        self._pending: Dict[int, list] = {}
        # rseqs retired by _drop_client (their client died first): a late
        # replica answer for one is an orphan answer, not a failover
        # duplicate — the two causes are counted apart. Bounded FIFO;
        # guarded by _plock like the pending table it shadows.
        self._orphan_rseqs: "OrderedDict[int, bool]" = OrderedDict()
        self._rseq = 0
        self._plock = threading.Lock()
        self._maint_thread: Optional[threading.Thread] = None
        for h, p in parse_replicas(replicas):
            key = f"{h}:{p}"
            self._replicas[key] = _Replica(
                key, h, p, "static", self.heartbeat_s, self.heartbeat_miss,
                self.breaker_threshold, self.breaker_reset_s)

    # -- lifecycle ---------------------------------------------------------
    @property
    def bound_port(self) -> int:
        return self._listener.bound_port

    def start(self) -> "FleetRouter":
        self._stop_evt.clear()
        self._draining = False
        if self.topic and self.broker_port:
            self._requery_broker()  # initial membership, best-effort
        with self._rlock:
            # broker-discovered members were dialed by the requery; only
            # the static list (and any requery stragglers) remain down
            down = [r for r in self._replicas.values() if r.sock is None]
        for rep in down:
            self._connect_replica(rep)
        self._listener.start()
        self._maint_thread = threading.Thread(
            target=self._maintain, name=f"router-maint:{self.name}",
            daemon=True)
        self._maint_thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        self._wake.set()
        self._listener.stop()
        with self._clock:
            clients = list(self._clients.values())
            self._clients.clear()
        for ent in clients:
            _sever(ent[0])
        with self._rlock:
            socks = [r.sock for r in self._replicas.values()
                     if r.sock is not None]
            for r in self._replicas.values():
                r.sock = None
                r.cfg = None
        for s in socks:
            _sever(s)

    # -- client side -------------------------------------------------------
    def _client_conn(self, conn: socket.socket) -> None:
        # per-op timeout: a half-open client must not hold its recv
        # thread forever; a live-but-idle one just times out and loops
        conn.settimeout(max(0.1, self.timeout))
        cid: Optional[int] = None
        skey: Optional[str] = None
        try:
            while not self._stop_evt.is_set():
                try:
                    kind, meta, payloads = recv_msg(conn, stats=self.stats)
                except TimeoutError:
                    continue
                if kind == MsgKind.CAPS:
                    cfg = wire.negotiate(meta.get("wire"))
                    if cid is None:
                        with self._clock:
                            cid = self._next_cid
                            self._next_cid += 1
                            # affinity key: the client's session id when
                            # it advertises one (survives its reconnects)
                            # else this connection's identity
                            if self.session:
                                sess = meta.get("session") or {}
                                skey = str(sess.get("sid") or f"c{cid}")
                            self._clients[cid] = [conn, threading.Lock(),
                                                  cfg, skey]
                    else:
                        with self._clock:
                            ent = self._clients.get(cid)
                            if ent is not None:
                                ent[2] = cfg
                    ack = {"caps": _FLEX_CAPS, "client_id": cid}
                    if cfg is not None:
                        ack["wire"] = cfg.to_meta()
                    send_msg(conn, MsgKind.CAPS_ACK, ack)
                elif kind == MsgKind.DATA:
                    if cid is None:
                        continue  # no handshake, no route
                    buf = wire.unpack_buffer(meta, payloads,
                                             stats=self.stats)
                    self._dispatch(cid, buf, meta.get("seq"), skey,
                                   phase=meta.get("llm_phase"))
                elif kind == MsgKind.DATA_BATCH:
                    if cid is None:
                        continue
                    for b in wire.unpack_batch(meta, payloads,
                                               stats=self.stats):
                        self._dispatch(cid, b, b.extras.get("seq"), skey)
                elif kind == MsgKind.PING:
                    self._send_client(cid, MsgKind.PONG,
                                      {"t": meta.get("t")})
                elif kind == MsgKind.EOS:
                    break
        except (ConnectionError, OSError, ValueError) as exc:
            self.stats.inc("link_errors")
            logger.info("%s: client %s connection ended: %r",
                        self.name, cid, exc)
        finally:
            if cid is not None:
                self._drop_client(cid)
            try:
                conn.close()
            except OSError:
                pass

    def _drop_client(self, cid: int) -> None:
        with self._clock:
            self._clients.pop(cid, None)
        # answers owed to a dead client are unroutable: retire their
        # pending entries VISIBLY so the accounting identity closes
        with self._plock:
            orphans = [r for r, e in self._pending.items() if e[0] == cid]
            for r in orphans:
                del self._pending[r]
                self._orphan_rseqs[r] = True
            while len(self._orphan_rseqs) > 4096:
                self._orphan_rseqs.popitem(last=False)
        if orphans:
            self.stats.inc("router_orphaned", len(orphans))

    def _skey_of(self, cid: int) -> Optional[str]:
        with self._clock:
            ent = self._clients.get(cid)
        return ent[3] if ent is not None else None

    def _send_client(self, cid, kind, meta, payloads=()) -> bool:
        with self._clock:
            ent = self._clients.get(cid)
        if ent is None:
            return False
        conn, lock = ent[0], ent[1]
        try:
            with lock:
                send_msg(conn, kind, meta, payloads, stats=self.stats)
            return True
        except (ConnectionError, OSError):
            self._drop_client(cid)
            return False

    def _client_cfg(self, cid) -> Optional[wire.WireConfig]:
        with self._clock:
            ent = self._clients.get(cid)
        return ent[2] if ent is not None else None

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, cid: int, buf: Buffer, cseq, skey: Optional[str],
                  attempts: int = 0, phase: Optional[str] = None) -> None:
        if attempts == 0:
            self.stats.inc("router_requests")
        if self._draining:
            self._shed_to_client(cid, cseq, buf)
            return
        tried: set = set()
        while True:
            # phase is only forwarded when present: _pick's 2-arg form
            # stays a stable seam (tests stub it for race injection)
            snap = (self._pick(skey, tried, phase) if phase
                    else self._pick(skey, tried))
            if snap is None or attempts > self.max_redispatch:
                # no dispatchable replica (or the request already
                # ping-ponged through max_redispatch deaths): settle it
                # as SHED with a retry-after — RESULT xor SHED, never
                # silence
                self._shed_to_client(cid, cseq, buf)
                return
            key, sock, slock, cfg = snap
            with self._plock:
                self._rseq += 1
                rseq = self._rseq
                self._pending[rseq] = [cid, cseq, buf, key, attempts,
                                       phase]
            meta, payloads = wire.pack_buffer(buf, cfg, stats=self.stats)
            meta["seq"] = rseq
            if phase:
                meta["llm_phase"] = phase
                if phase == "prompt" and skey is not None:
                    # pin the stream's decode home so the prefill
                    # replica ships its KV where every later frame of
                    # this session will also land
                    home = self.decode_home(skey)
                    if home is not None:
                        meta["decode_home"] = home
            try:
                with slock:
                    send_msg(sock, MsgKind.DATA, meta, payloads,
                             stats=self.stats)
                return
            except (ConnectionError, OSError):
                # the pending entry is reclaimed BEFORE the down-handler
                # runs so the failover sweep cannot double-dispatch it;
                # a miss means a concurrent _replica_down (which severed
                # this socket, making our send raise) swept the entry
                # first and already re-dispatched it — that path owns
                # the retry, looping here would mint a second pending
                # entry (duplicate settles) for one client request
                with self._plock:
                    owned = self._pending.pop(rseq, None) is not None
                self._replica_down(key, sock)
                if not owned:
                    return
                tried.add(key)
                attempts += 1

    def _pick(self, skey: Optional[str], exclude: set,
              phase: Optional[str] = None
              ) -> Optional[Tuple[str, socket.socket, threading.Lock,
                                  Optional[wire.WireConfig]]]:
        """Choose a replica: ring affinity first, least-loaded among the
        live ones otherwise. Returns a snapshot (key, sock, send lock,
        wire cfg) taken under the replica lock; None = nobody can serve.

        Disaggregated LLM fleets add a phase filter: ``phase="prompt"``
        frames go to prefill capacity (dedicated ``prefill`` replicas
        first, ``both`` as spillover) and skip the affinity ring —
        prompts are stateless, least-loaded wins; ``phase="decode"``
        frames pin to the stream's decode home on the decode ring. A
        fleet where nobody advertises a role ignores the phase."""
        with self._rlock:
            live = [r for r in self._replicas.values()
                    if r.sock is not None and not r.draining
                    and r.key not in exclude]
            if phase and any(r.llm_role for r in live):
                if phase == "prompt":
                    pref = [r for r in live if r.llm_role == "prefill"]
                    live = pref or [r for r in live
                                    if r.llm_role in ("prefill", "both")]
                elif phase == "decode":
                    live = [r for r in live
                            if r.llm_role in ("decode", "both")]
                    want = (self._dring.lookup(skey)
                            if skey is not None else None)
                    for r in live:
                        if r.key == want:
                            return (r.key, r.sock, r.slock, r.cfg)
            if not live:
                return None
            if self.affinity and skey is not None and phase != "prompt":
                want = self._ring.lookup(skey)
                for r in live:
                    if r.key == want:
                        return (r.key, r.sock, r.slock, r.cfg)
            cands = [(r.key, r.sock, r.slock, r.cfg,
                      int((r.load or {}).get("depth", 0))) for r in live]
        # least-loaded tiebreak: our own unsettled count per replica
        # (exact) plus the replica's last self-reported queue depth
        # (PONG/REGISTER occupancy metadata; possibly a beat stale)
        with self._plock:
            inflight: Dict[str, int] = {}
            for ent in self._pending.values():
                inflight[ent[3]] = inflight.get(ent[3], 0) + 1
        best = min(cands, key=lambda c: inflight.get(c[0], 0) + c[4])
        return best[:4]

    def _shed_to_client(self, cid: int, cseq, buf: Buffer) -> None:
        self.stats.inc("router_shed")
        _obs_events.emit("shed", source=self.name, element=self,
                         reason="no-replica", client=cid)
        self._send_client(cid, MsgKind.SHED,
                          {"seq": cseq, "pts": buf.pts, "client_id": cid,
                           "retry_after_ms": float(self.retry_after_ms)})

    def _settle(self, rseq) -> Optional[list]:
        """Pop one pending entry exactly once; None = already settled.
        A miss is classified before counting: an answer owed to a
        client that disconnected first (entry retired by _drop_client)
        is ``router_orphan_drops``; anything else is a duplicate after
        failover re-dispatch, ``router_dup_drops``. Either way it is
        dropped and counted, never forwarded twice."""
        with self._plock:
            ent = self._pending.pop(rseq, None)
            orphan = (ent is None
                      and self._orphan_rseqs.pop(rseq, False))
        if ent is None:
            self.stats.inc("router_orphan_drops" if orphan
                           else "router_dup_drops")
        return ent

    # -- replica side ------------------------------------------------------
    def _connect_replica(self, rep: _Replica) -> bool:
        """Dial + CAPS handshake one replica; on success publish the
        link and spawn its recv loop. Breaker outcomes are the caller's
        job (start() dials unconditionally, the maintainer is gated)."""
        try:
            sock = socket.create_connection((rep.host, rep.port),
                                            timeout=self.timeout)
        except OSError:
            return False
        wire.tune_socket(sock)
        try:
            sock.settimeout(self.timeout)
            send_msg(sock, MsgKind.CAPS,
                     {"caps": "", "wire": wire.advertise("raw", "none")})
            kind, meta, _ = recv_msg(sock)
            if kind != MsgKind.CAPS_ACK:
                raise ConnectionError(f"bad handshake {kind}")
            cfg = wire.accept(meta.get("wire"))
            # keep the per-op timeout for the link's lifetime: a wedged
            # replica whose TCP send buffer fills must make the blocked
            # send (PING under the send lock, or a dispatch) raise into
            # _replica_down, not hold the fleet-wide maintenance thread
            # hostage. Recv timeouts never fire on a healthy link —
            # PONGs arrive every heartbeat_s << timeout — so hitting
            # one means the heartbeat machinery itself is wedged and
            # declaring the link dead is the right backstop.
            sock.settimeout(self.timeout)
        except (ConnectionError, OSError, ValueError):
            try:
                sock.close()
            except OSError:
                pass
            return False
        rejoined = False
        inst = str(meta.get("instance") or "")
        with self._rlock:
            # the serve src mints a fresh instance token per start(): a
            # matching token means this re-dial reached the SAME process
            # life — a TCP blip, not a membership event
            same_proc = bool(inst) and inst == rep.instance
            rep.instance = inst
            rep.sock = sock
            rep.slock = threading.Lock()
            rep.cfg = cfg
            rep.gen += 1
            rep.hb = Heartbeat(self.heartbeat_s, self.heartbeat_miss)
            # a fresh link to a NEW process is a fresh replica: one
            # resurrected at the same host:port must not inherit the
            # corpse's DRAINING flag (it would be routable never again).
            # A reconnect to the same still-draining process keeps the
            # flag — clearing it would undo an administrative drain and
            # double-count the rejoin (the mid-drain counter drift this
            # guard exists for).
            if rep.draining and not same_proc:
                rep.draining = False
                rejoined = True
            self._rebuild_ring_locked()
        if rejoined:
            self.stats.inc("router_replica_rejoins")
            logger.info("%s: replica %s rejoined (draining flag cleared)",
                        self.name, rep.key)
        threading.Thread(target=self._replica_loop, args=(rep, sock),
                         name=f"router-replica:{rep.key}",
                         daemon=True).start()
        self.stats.inc("router_replica_connects")
        logger.info("%s: replica %s connected", self.name, rep.key)
        return True

    def _rebuild_ring_locked(self) -> None:
        live = [r for r in self._replicas.values()
                if r.sock is not None and not r.draining]
        self._ring.rebuild(sorted(r.key for r in live))
        # the decode ring only narrows once someone actually advertises
        # a phase; a role-free fleet keeps decode_home == assignment
        roled = [r for r in live if r.llm_role]
        decode = [r.key for r in roled
                  if r.llm_role in ("decode", "both")]
        self._dring.rebuild(sorted(decode) if roled
                            else sorted(r.key for r in live))

    def _replica_loop(self, rep: _Replica, sock: socket.socket) -> None:
        try:
            while not self._stop_evt.is_set():
                kind, meta, payloads = recv_msg(sock, stats=self.stats)
                if kind == MsgKind.RESULT:
                    rep.hb.heard()
                    ent = self._settle(meta.get("seq"))
                    if ent is None:
                        continue
                    buf = wire.unpack_buffer(meta, payloads,
                                             stats=self.stats)
                    out_meta, out_payloads = wire.pack_buffer(
                        buf, self._client_cfg(ent[0]), stats=self.stats)
                    out_meta["client_id"] = ent[0]
                    out_meta["seq"] = ent[1]
                    if self._send_client(ent[0], MsgKind.RESULT, out_meta,
                                         out_payloads):
                        self.stats.inc("router_delivered")
                    else:
                        self.stats.inc("router_orphaned")
                elif kind == MsgKind.SHED:
                    rep.hb.heard()
                    ent = self._settle(meta.get("seq"))
                    if ent is None:
                        continue
                    self.stats.inc("router_shed")
                    self._send_client(
                        ent[0], MsgKind.SHED,
                        {"seq": ent[1], "client_id": ent[0],
                         "retry_after_ms": float(meta.get(
                             "retry_after_ms", self.retry_after_ms))})
                elif kind == MsgKind.PONG:
                    rep.hb.pong(float(meta.get("t", 0.0)))
                    load = meta.get("load")
                    if isinstance(load, dict):
                        with self._rlock:
                            rechain = (str(load.get("llm_role") or "")
                                       != rep.llm_role)
                            rep.load = load
                            if rechain:
                                # a phase (dis)appeared: the decode-home
                                # ring membership just changed
                                self._rebuild_ring_locked()
                elif kind == MsgKind.DRAIN:
                    # the replica's pipeline is draining: it will settle
                    # what it admitted and shed the rest — steer new
                    # dispatches (and its affinity sessions) elsewhere
                    self._mark_draining(rep)
                elif kind == MsgKind.EOS:
                    break
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            if not self._stop_evt.is_set():
                self._replica_down(rep.key, sock)

    def _mark_draining(self, rep: _Replica) -> None:
        with self._rlock:
            fresh = not rep.draining
            rep.draining = True
            if fresh:
                self._rebuild_ring_locked()
        if fresh:
            self.stats.inc("router_replica_drains")
            logger.info("%s: replica %s draining; affinity sessions "
                        "steered to survivors", self.name, rep.key)

    def drain_replica(self, key: str) -> bool:
        """Administrative drain: quiesce one replica — new dispatches
        (and its affinity sessions) steer elsewhere, its in-flight
        requests settle normally. Pair with the replica pipeline's own
        ``drain()`` to flush and stop it."""
        with self._rlock:
            rep = self._replicas.get(key)
        if rep is None:
            return False
        self._mark_draining(rep)
        return True

    def _replica_down(self, key: str, sock: Optional[socket.socket]) -> None:
        """One replica link died: retire the socket (idempotent via
        identity), pace re-dials through its breaker, and fail its
        unsettled requests over to the survivors."""
        with self._rlock:
            rep = self._replicas.get(key)
            if rep is None or sock is None or rep.sock is not sock:
                return  # stale report: a newer link is already up
            rep.sock = None
            rep.cfg = None
            rep.gen += 1
            self._rebuild_ring_locked()
        rep.breaker.record_failure()
        self.stats.inc("router_replica_deaths")
        _sever(sock)
        logger.warning("%s: replica %s died; failing over", self.name, key)
        _obs_events.emit("failover", source=self.name, element=self,
                         replica=key)
        self._failover(key)
        self._wake.set()  # immediate re-dial attempt + membership requery

    def _failover(self, key: str) -> None:
        """Re-dispatch every unsettled request of a dead replica to a
        survivor. The dead link can no longer answer, so each entry
        settles exactly once on its new home (a wrongly-declared-dead
        replica's late answers hit the seq dedup in :meth:`_settle`)."""
        with self._plock:
            victims = [(r, e) for r, e in self._pending.items()
                       if e[3] == key]
            for r, _ in victims:
                del self._pending[r]
        for _, ent in victims:
            self.stats.inc("router_redispatched")
            self._dispatch(ent[0], ent[2], ent[1], self._skey_of(ent[0]),
                           attempts=ent[4] + 1,
                           phase=ent[5] if len(ent) > 5 else None)

    # -- maintenance: heartbeats, re-dials, membership ---------------------
    def _maintain(self) -> None:
        tick = min(self.heartbeat_s / 2.0, 0.1)
        next_query = 0.0
        while not self._stop_evt.is_set():
            # racecheck: ok(deliberate: the maintenance timer sleeps on its own wake event with no shared lock held)
            self._wake.wait(tick)
            self._wake.clear()
            if self._stop_evt.is_set():
                return
            now = time.monotonic()
            with self._rlock:
                live = [(r.key, r.sock, r.slock, r.hb)
                        for r in self._replicas.values()
                        if r.sock is not None]
                down = [r for r in self._replicas.values()
                        if r.sock is None]
            for key, sock, slock, hb in live:
                if hb.peer_dead:
                    # miss_limit unanswered pings: a half-open TCP link
                    # is declared dead instead of trusted forever
                    self._replica_down(key, sock)
                    continue
                if hb.due(now):
                    try:
                        with slock:
                            send_msg(sock, MsgKind.PING,
                                     {"t": time.monotonic()})
                        hb.sent()
                    except (ConnectionError, OSError):
                        self._replica_down(key, sock)
            for rep in down:
                # breaker-paced re-dial: CLOSED dials freely, OPEN
                # waits out reset_s, HALF_OPEN admits one probe
                if rep.breaker.allow():
                    if self._connect_replica(rep):
                        rep.breaker.record_success()
                    else:
                        rep.breaker.record_failure()
            if self.topic and self.broker_port and now >= next_query:
                next_query = now + self.requery_s
                self._requery_broker()

    def _requery_broker(self) -> None:
        from ..edge.broker import discover_meta
        try:
            eps = discover_meta(self.broker_host, self.broker_port,
                                self.topic, timeout=min(2.0, self.timeout))
        except (ConnectionError, OSError, ValueError):
            self.stats.inc("link_errors")
            return
        fresh: List[_Replica] = []
        seen = set()
        with self._rlock:
            for (host, port), info in eps:
                key = f"{host}:{port}"
                seen.add(key)
                rep = self._replicas.get(key)
                if rep is None:
                    rep = _Replica(key, host, port, "broker",
                                   self.heartbeat_s, self.heartbeat_miss,
                                   self.breaker_threshold,
                                   self.breaker_reset_s)
                    self._replicas[key] = rep
                    fresh.append(rep)
                if isinstance(info, dict) and (not rep.load
                                               or rep.sock is None):
                    # REGISTER occupancy seeds the load; a down replica's
                    # stale PONG load is replaced by the fresh advert
                    rep.load = info
                has_rs = (isinstance(info, dict)
                          and bool(info.get("restored_sessions")))
                if has_rs and not rep.restored_ad:
                    # the replica came back from a preemption snapshot
                    # carrying restored session ids. Edge-triggered on
                    # the advert (a registration's advert dies with its
                    # broker connection), so a resurrection counts once
                    # whether the process came back at a brand-new
                    # endpoint or at the SAME host:port — the latter
                    # was previously never counted
                    self.stats.inc("router_replica_resurrections")
                    logger.info("%s: replica %s resurrected with %d "
                                "restored session(s)", self.name, key,
                                len(info["restored_sessions"]))
                rep.restored_ad = has_rs
            for k, r in self._replicas.items():
                if k not in seen:
                    # its advert died with its registration connection;
                    # the next advert carrying restored_sessions is a
                    # fresh resurrection edge
                    r.restored_ad = False
            # a replica the broker no longer advertises AND whose link is
            # gone has left the fleet; a live link outranks a flapping
            # broker, so connected members are never evicted here
            gone = [k for k, r in self._replicas.items()
                    if r.origin == "broker" and k not in seen
                    and r.sock is None]
            for k in gone:
                del self._replicas[k]
            if gone:
                self._rebuild_ring_locked()
        for rep in fresh:
            self._connect_replica(rep)

    # -- drain / observability / chaos -------------------------------------
    def drain(self) -> None:
        """Router-wide quiesce: stop admitting (late DATA sheds with
        retry-after) and tell every client DRAIN; in-flight requests
        still settle through their replicas."""
        self._draining = True
        with self._clock:
            ents = list(self._clients.items())
        for cid, ent in ents:
            try:
                with ent[1]:
                    send_msg(ent[0], MsgKind.DRAIN,
                             {"client_id": cid,
                              "retry_after_ms": float(self.retry_after_ms)})
            except (ConnectionError, OSError):
                pass

    def pending(self) -> int:
        with self._plock:
            return len(self._pending)

    def assignment(self, skey: str) -> Optional[str]:
        """The replica a session's NEXT frame would go to (affinity
        view; observability + tests)."""
        with self._rlock:
            return self._ring.lookup(skey)

    def decode_home(self, skey: str) -> Optional[str]:
        """The decode-capable replica this session is pinned to
        (consistent hash over the decode ring) — where prompt-phase
        dispatches tell the prefill replica to ship its KV."""
        with self._rlock:
            return self._dring.lookup(skey)

    def replica_keys(self) -> List[str]:
        with self._rlock:
            return sorted(self._replicas)

    def report(self) -> Dict[str, Dict]:
        with self._plock:
            inflight: Dict[str, int] = {}
            for ent in self._pending.values():
                inflight[ent[3]] = inflight.get(ent[3], 0) + 1
        out: Dict[str, Dict] = {}
        with self._rlock:
            reps = list(self._replicas.values())
        for r in reps:
            hb = r.hb
            out[r.key] = {
                "state": r.state(),
                "origin": r.origin,
                "llm_role": r.llm_role,
                "in_flight": inflight.get(r.key, 0),
                "load": dict(r.load or {}),
                "breaker": r.breaker.state,
                "pongs": hb.pongs,
                "rtt_us_avg": (hb.rtt_ns / hb.pongs / 1e3
                               if hb.pongs else 0.0),
            }
        return out

    def kill_links(self) -> int:
        """Chaos hook: sever every live replica link (the client side of
        a partition between router and fleet); heartbeats/recv loops
        detect it and the failover path re-dispatches."""
        with self._rlock:
            socks = [(r.key, r.sock) for r in self._replicas.values()
                     if r.sock is not None]
        for _key, s in socks:
            _sever(s)
        return len(socks)


@register_element("tensor_serve_router")
class TensorServeRouter(Element):
    """Fleet front-end element: clients connect to it exactly as they
    would to a single ``tensor_serve_src``; it spreads their requests
    over the replica fleet with affinity, health-checked failover, and
    zero-loss re-dispatch (see :class:`FleetRouter`).

    Replicas come from the static ``replicas`` list (``host:port,...``)
    and/or the discovery broker at ``dest-host:dest-port`` under
    ``topic`` (replicas REGISTER there with occupancy metadata; the
    router re-queries every ``requery-ms`` and on any replica death).
    A router with neither is unroutable — the ``router-no-replicas``
    lint rule rejects it before launch."""

    PROPS = {"host": "localhost", "port": 3002, "timeout": 10.0,
             # static fleet membership: host:port, comma/semicolon list
             "replicas": "",
             # broker membership: topic + broker endpoint (HYBRID slot)
             "topic": "", "dest-host": "localhost", "dest-port": 0,
             # consistent-hash session affinity (least-loaded when off);
             # session=false disables per-connection session keys, so
             # affinity has nothing to key on (lint warns)
             "affinity": True, "session": True,
             # replica health: PING cadence + unanswered-ping budget
             "heartbeat-ms": 250.0, "heartbeat-miss": 3,
             # per-replica-link breaker pacing re-dials of a dead replica
             "breaker-threshold": 3, "breaker-reset-ms": 1000.0,
             # the retry-after hint on router-minted SHEDs
             "retry-after-ms": 50.0,
             # broker membership re-query cadence
             "requery-ms": 500.0,
             # failover budget per request before it sheds
             "max-redispatch": 3}

    # conservation identity flowcheck proves statically and
    # check_identities() asserts over live stats snapshots
    SETTLEMENT_IDENTITY = ("router-settlement",)

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.router: Optional[FleetRouter] = None

    @property
    def bound_port(self) -> int:
        return self.router.bound_port if self.router else int(self.port)

    def negotiate_src_caps(self) -> Optional[Caps]:
        return Caps(_FLEX_CAPS)

    def start(self) -> None:
        self.router = FleetRouter(
            host=self.host, port=int(self.port),
            replicas=str(self.replicas), topic=str(self.topic),
            broker_host=str(self.dest_host), broker_port=int(self.dest_port),
            timeout=float(self.timeout), affinity=bool(self.affinity),
            session=bool(self.session),
            heartbeat_s=float(self.heartbeat_ms) / 1e3,
            heartbeat_miss=int(self.heartbeat_miss),
            breaker_threshold=int(self.breaker_threshold),
            breaker_reset_s=float(self.breaker_reset_ms) / 1e3,
            retry_after_ms=float(self.retry_after_ms),
            requery_s=float(self.requery_ms) / 1e3,
            max_redispatch=int(self.max_redispatch),
            name=self.name, stats=self.stats)
        self.router.start()
        super().start()

    def stop(self) -> None:
        if self.router is not None:
            self.router.stop()
        super().stop()

    def drain(self) -> None:
        super().drain()
        if self.router is not None:
            self.router.drain()

    def drain_flushed(self) -> bool:
        return self.router is None or self.router.pending() == 0

    def drain_replica(self, key: str) -> bool:
        return self.router is not None and self.router.drain_replica(key)

    def kill_link(self) -> int:
        return self.router.kill_links() if self.router is not None else 0

    def session_info(self) -> Dict:
        n = self.router.pending() if self.router is not None else 0
        return {"in_flight": n} if n else {}

    def router_report(self) -> Dict:
        return self.router.report() if self.router is not None else {}
