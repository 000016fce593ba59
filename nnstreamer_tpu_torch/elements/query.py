"""tensor_query_client / tensor_query_serversrc / tensor_query_serversink
— remote-filter (RPC) stream offload.

Port of ``nnstreamer_tpu/elements/query.py`` (≙ gst/nnstreamer/
tensor_query/*: a client pipeline sends frames to a server pipeline and
receives results, tensor_query_client.c:676-712 send path, :428-510
receive path; server entry/exit pads pair up through a shared table
keyed by ``id`` so answers return to the asking client,
tensor_query_server.c). Transport is the edge protocol
(edge/protocol.py, edge/wire.py) over TCP, byte for byte the JAX
package's: a JAX client uses a port server and the other way round.

The network threads (accept loop, one reader per client, the client's
receiver) stay on the host: they unpack into host arrays and queue
them. Frames reach the card in the server's ``tensor_filter``, which
stages them into its static inputs on the pipeline's own thread, and
leave it as the filter's outputs: with ``prefetch-host=true`` their
copy to the host is already in flight, and the serversink waits for
that copy instead of starting a second one.

``batch=K`` micro-batches across clients: what is queued (up to K
frames of one layout) is stacked on a new leading dim and padded to K
rows by repeating the last frame, so the filter makes one executable (on
the card, one CUDA graph) for the whole run. ``batch_rows`` carries each
real row's reply route and ``batch_valid_rows`` their count; the
serversink answers the real rows only, so a padded row never reaches a
client.

``Pipeline.drain`` on a server closes admission (a frame arriving after
it is shed and counted in ``stats["shed"]``), sends DRAIN to every
client, which stops sending and settles, and flushes the queued frames
through the pipeline behind the EOS barrier, so every frame already
queued still gets its RESULT before the server closes.
"""
from __future__ import annotations

import collections
import socket
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..edge import wire
from ..edge.protocol import MsgKind, recv_msg, send_msg, sever_socket as _sever
from ..pipeline.element import Element, SinkElement, SrcElement
from ..pipeline.events import QosEvent
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..utils.log import logger


def _roi_meta(buf: Buffer) -> Optional[dict]:
    """The tensor_delta ROI side-band (which crops these are, cut from
    what) as a wire-meta block: buffer extras don't cross the link, so
    the client stamps this next to ``seq`` on DATA and the server
    echoes it on RESULT for the downstream tensor_delta_stitch."""
    rois = buf.extras.get("delta_rois")
    if rois is None:
        return None
    return {"rois": [list(r) for r in rois],
            "grid": list(buf.extras.get("delta_grid", ())),
            "tile": int(buf.extras.get("delta_tile", 0)),
            "shape": list(buf.extras.get("delta_shape", ()))}


def _roi_adopt(buf: Buffer, roi: Optional[dict]) -> Buffer:
    """Inverse of :func:`_roi_meta`: rebuild the stitch extras on a
    RESULT buffer from the echoed block."""
    if roi and roi.get("rois"):
        buf.extras["delta_rois"] = [tuple(r) for r in roi["rois"]]
        buf.extras["delta_grid"] = tuple(roi.get("grid", ()))
        buf.extras["delta_tile"] = int(roi.get("tile", 0))
        buf.extras["delta_shape"] = tuple(roi.get("shape", ()))
    return buf


def _stack(values):
    """Stack host values on a new leading dim: ndarrays, or CPU tensors
    (bfloat16 arrives as one)."""
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return np.stack(values)


def _row(value, i: int):
    """Row ``i`` of a stacked host value, contiguous."""
    if isinstance(value, torch.Tensor):
        return value[i].contiguous()
    return np.ascontiguousarray(value[i])


class _ServerTable:
    """Pairs serversrc/serversink by id and routes client connections
    (≙ GstTensorQueryServerInfo table, tensor_query_server.c)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conns: Dict[Tuple[int, int], socket.socket] = {}
        self._wire: Dict[Tuple[int, int], wire.WireConfig] = {}
        self._out_caps: Dict[int, str] = {}

    def add_conn(self, server_id: int, client_id: int,
                 sock: socket.socket) -> None:
        with self._lock:
            self._conns[(server_id, client_id)] = sock

    def remove_conn(self, server_id: int, client_id: int) -> None:
        with self._lock:
            self._conns.pop((server_id, client_id), None)
            self._wire.pop((server_id, client_id), None)

    def get_conn(self, server_id: int, client_id: int):
        with self._lock:
            return self._conns.get((server_id, client_id))

    def set_wire(self, server_id: int, client_id: int,
                 cfg: Optional[wire.WireConfig]) -> None:
        """Record the link config negotiated at the client's CAPS
        exchange; the serversink packs each RESULT under it."""
        with self._lock:
            if cfg is None:
                self._wire.pop((server_id, client_id), None)
            else:
                self._wire[(server_id, client_id)] = cfg

    def get_wire(self, server_id: int, client_id: int
                 ) -> Optional[wire.WireConfig]:
        with self._lock:
            return self._wire.get((server_id, client_id))

    def set_out_caps(self, server_id: int, caps: str) -> None:
        with self._lock:
            self._out_caps[server_id] = caps

    def get_out_caps(self, server_id: int) -> Optional[str]:
        with self._lock:
            return self._out_caps.get(server_id)

    def conns_of(self, server_id: int) -> list:
        """Live client sockets of one server (``kill_link``'s count)."""
        with self._lock:
            return [s for k, s in self._conns.items() if k[0] == server_id]

    def close_server(self, server_id: int) -> None:
        """Close every client connection of a stopping server so clients
        see the death immediately and can fail over."""
        with self._lock:
            victims = [(k, s) for k, s in self._conns.items()
                       if k[0] == server_id]
            for k, _ in victims:
                del self._conns[k]
                self._wire.pop(k, None)
        for _, s in victims:
            _sever(s)


SERVER_TABLE = _ServerTable()
_FLEX_CAPS = "other/tensors,format=flexible"


@register_element("tensor_query_serversrc")
class TensorQueryServerSrc(SrcElement):
    """Server entry: listens for clients, pushes received frames into the
    server pipeline with the client id stamped in buffer extras."""

    PROPS = {"host": "localhost", "port": 3001, "id": 0, "timeout": 10.0,
             # HYBRID: advertise (topic -> host:port) on the discovery
             # broker at dest-host:dest-port (≙ connect-type enum,
             # tensor_query_common.c:30-40)
             "connect-type": "TCP", "topic": "",
             "dest-host": "localhost", "dest-port": 0,
             # batch>1 = server-side micro-batching: stack up to `batch`
             # in-flight frames (across ALL clients) into one buffer with
             # a leading batch dim, padded to a fixed size so the filter
             # makes ONE executable (on the card one CUDA graph); the
             # serversink demuxes rows back to their clients. BASELINE
             # config 5's batched invoke: one graph replay and one D2H
             # serve every client in the stack.
             "batch": 0}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._listener: Optional[socket.socket] = None
        self._queue = []
        self._qlock = threading.Condition()
        self._next_client = [0]
        self._accept_thread: Optional[threading.Thread] = None
        self._broker_sock: Optional[socket.socket] = None
        self.stats["link_errors"] = 0

    @property
    def bound_port(self) -> int:
        return self._listener.getsockname()[1] if self._listener else self.port

    def negotiate_src_caps(self) -> Optional[Caps]:
        return Caps(_FLEX_CAPS)

    def static_src_caps(self) -> Optional[Caps]:
        """Flexible tensors (shapes arrive per request)."""
        return Caps(_FLEX_CAPS)

    def start(self) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(16)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"qsrc-accept:{self.name}",
            daemon=True)
        self._accept_thread.start()
        if self.connect_type.upper() == "HYBRID":
            # hold the registration connection open for our lifetime;
            # the broker drops the advertisement the moment it closes
            try:
                self._broker_sock = socket.create_connection(
                    (self.dest_host or "localhost", int(self.dest_port)),
                    timeout=self.timeout)
                send_msg(self._broker_sock, MsgKind.REGISTER,
                         {"topic": self.topic, "host": self.host,
                          "port": self.bound_port})
            except OSError:
                # don't leak a half-started server: closing the listener
                # also terminates the accept thread
                if self._broker_sock is not None:
                    try:
                        self._broker_sock.close()
                    except OSError:
                        pass
                    self._broker_sock = None
                try:
                    self._listener.close()
                except OSError:
                    pass
                self._listener = None
                raise
        super().start()

    def stop(self) -> None:
        super().stop()
        if self._broker_sock is not None:
            try:
                self._broker_sock.close()
            except OSError:
                pass
            self._broker_sock = None
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        # drop live client connections so clients detect the death at
        # once and fail over instead of timing out on a silent socket
        SERVER_TABLE.close_server(self.id)

    def _accept_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                conn, addr = self._listener.accept()
            except OSError:
                return
            try:
                wire.tune_socket(conn)
            except OSError:
                # peer died between accept and setsockopt: close the
                # fd instead of leaking it
                conn.close()
                continue
            cid = self._next_client[0]
            self._next_client[0] += 1
            SERVER_TABLE.add_conn(self.id, cid, conn)
            threading.Thread(target=self._client_loop, args=(conn, cid),
                             name=f"qsrc-client{cid}:{self.name}",
                             daemon=True).start()

    def _client_loop(self, conn: socket.socket, cid: int) -> None:
        # per-op timeout: a half-open peer (died without FIN) must not
        # hold its recv thread — and its queued frames — forever; a
        # live-but-idle client just times out between messages and loops
        conn.settimeout(max(0.1, float(self.timeout)))
        try:
            while not self._stop_evt.is_set():
                try:
                    kind, meta, payloads = recv_msg(conn, stats=self.stats)
                except TimeoutError:
                    continue
                if kind == MsgKind.CAPS:
                    # wire v2: fold the client's advertisement into this
                    # link's config and echo the choice in the ack; a
                    # client without a "wire" block stays plain v1
                    cfg = wire.negotiate(meta.get("wire"))
                    SERVER_TABLE.set_wire(self.id, cid, cfg)
                    out_caps = SERVER_TABLE.get_out_caps(self.id) or _FLEX_CAPS
                    ack = {"caps": out_caps, "client_id": cid}
                    if cfg is not None:
                        ack["wire"] = cfg.to_meta()
                    send_msg(conn, MsgKind.CAPS_ACK, ack)
                elif kind == MsgKind.DATA:
                    buf = wire.unpack_buffer(meta, payloads,
                                             stats=self.stats)
                    if meta.get("delta_roi"):
                        # the client's ROI side-band, echoed on RESULT
                        buf.extras["delta_roi"] = meta["delta_roi"]
                    self._enqueue(buf, cid)
                elif kind == MsgKind.DATA_BATCH:
                    for b in wire.unpack_batch(meta, payloads,
                                               stats=self.stats):
                        self._enqueue(b, cid)
                elif kind == MsgKind.EOS:
                    break
        except (ConnectionError, OSError, ValueError) as exc:
            # a dying client is routine, but never silent: the cause is
            # logged and counted so a flapping link is diagnosable from
            # stats() instead of invisible
            self.stats.inc("link_errors")
            logger.info("%s: client %d connection ended: %r",
                        self.name, cid, exc)
        finally:
            SERVER_TABLE.remove_conn(self.id, cid)
            # slot reclamation: frames this client queued but the
            # pipeline has not consumed would otherwise be invoked for a
            # dead peer (and their replies dropped at the sink)
            with self._qlock:
                self._queue = [b for b in self._queue
                               if b.extras.get("client_id") != cid]
            try:
                conn.close()
            except OSError:
                pass

    def drain(self) -> None:
        """Graceful teardown: stop admitting frames (late arrivals are
        shed + counted), tell every client DRAIN so it stops sending,
        and flush the queue through the pipeline behind the EOS barrier
        — every queued frame still gets its RESULT before close."""
        super().drain()
        for conn in SERVER_TABLE.conns_of(self.id):
            try:
                send_msg(conn, MsgKind.DRAIN, {"server_id": self.id})
            except (ConnectionError, OSError):
                pass
        with self._qlock:
            self._qlock.notify_all()

    def drain_flushed(self) -> bool:
        with self._qlock:
            return not self._queue

    def kill_link(self) -> int:
        """Chaos hook (tensor_fault mode=kill-link): force-close every
        live client connection mid-stream; clients reconnect and replay
        their unanswered frames."""
        victims = len(SERVER_TABLE.conns_of(self.id))
        SERVER_TABLE.close_server(self.id)
        self.stats.inc("link_kills", victims)
        return victims

    def _enqueue(self, buf: Buffer, cid: int) -> None:
        if self._drain_evt.is_set():
            # admission is closed: the frame is shed, visibly — the
            # client's pending entry settles via its own teardown path
            self.stats.inc("shed")
            return
        buf.extras["client_id"] = cid
        buf.extras["server_id"] = self.id
        with self._qlock:
            self._queue.append(buf)
            self._qlock.notify_all()

    def create(self) -> Optional[Buffer]:
        with self._qlock:
            while not self._queue:
                if self._stop_evt.is_set():
                    return None
                if self._drain_evt.is_set():
                    return None  # drained dry: the EOS barrier
                self._qlock.wait(timeout=0.1)
            k = int(self.batch)
            if k <= 1:
                return self._queue.pop(0)
            bufs = [self._queue.pop(0)]
            # stop at a shape mismatch: heterogeneous clients still work,
            # the mismatching frame just opens the next micro-batch
            while (self._queue and len(bufs) < k
                   and self._stackable(bufs[0], self._queue[0])):
                bufs.append(self._queue.pop(0))
        return self._stack(bufs, k)

    @staticmethod
    def _stackable(a: Buffer, b: Buffer) -> bool:
        return (len(a.chunks) == len(b.chunks)
                and all(x.shape == y.shape and x.dtype == y.dtype
                        for x, y in zip(a.chunks, b.chunks)))

    def _stack(self, bufs, k: int) -> Buffer:
        """Stack frames into one leading-dim-``k`` buffer (short batches
        pad by repeating the last frame, so every stack has one
        executable signature).
        ``batch_rows`` extras carry each real row's reply route."""
        rows = bufs + [bufs[-1]] * (k - len(bufs))
        chunks = []
        for j in range(len(bufs[0].chunks)):
            chunks.append(Chunk(_stack([b.chunks[j].host() for b in rows])))
        out = Buffer(chunks, pts=bufs[0].pts)
        out.extras["server_id"] = self.id
        out.extras["batch_rows"] = [
            (b.extras.get("client_id"), b.extras.get("server_id", self.id),
             b.pts) for b in bufs]
        rois = [b.extras.get("delta_roi") for b in bufs]
        if any(rois):
            out.extras["batch_rois"] = rois
        # tensor_filter trims the padded rows of its host outputs; its
        # card outputs ship padded (one copy of the stack) and the
        # serversink answers the real rows only
        out.extras["batch_valid_rows"] = len(bufs)
        return out


@register_element("tensor_query_serversink")
class TensorQueryServerSink(SinkElement):
    """Server exit: returns results to the client that asked."""

    PROPS = {"id": 0, "timeout": 10.0}

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        SERVER_TABLE.set_out_caps(self.id, str(caps))

    def handle_event(self, pad, event) -> None:
        from ..pipeline.events import CapsEvent
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            self.on_sink_caps(pad, event.caps)
            return
        super().handle_event(pad, event)

    def render(self, buf: Buffer) -> None:
        rows = buf.extras.get("batch_rows")
        if rows is not None:
            # micro-batched frame: one D2H of the stacked outputs (the
            # filter's prefetch when it is in flight), then row i goes
            # back to the client that sent frame i (padded rows have no
            # entry and are never sent)
            hosts = [c.host() for c in buf.chunks]
            rois = buf.extras.get("batch_rois") or [None] * len(rows)
            for i, ((cid, sid, pts), roi) in enumerate(zip(rows, rois)):
                row = Buffer([Chunk(_row(h, i)) for h in hosts], pts=pts)
                self._send_one(row, cid, sid, roi)
            return
        self._send_one(buf, buf.extras.get("client_id"),
                       buf.extras.get("server_id", self.id),
                       buf.extras.get("delta_roi"))

    def _send_one(self, buf: Buffer, cid, sid, roi=None) -> None:
        conn = SERVER_TABLE.get_conn(sid, cid) if cid is not None else None
        if conn is None:
            logger.warning("%s: no connection for client %s", self.name, cid)
            return
        # pack under whatever this client's link negotiated (None = v1)
        meta, payloads = wire.pack_buffer(
            buf, SERVER_TABLE.get_wire(sid, cid), stats=self.stats)
        meta["client_id"] = cid
        if roi:
            meta["delta_roi"] = roi
        try:
            send_msg(conn, MsgKind.RESULT, meta, payloads, stats=self.stats)
        except (ConnectionError, OSError):
            SERVER_TABLE.remove_conn(sid, cid)


@register_element("tensor_query_client")
class TensorQueryClient(Element):
    """Client: sink-pad frames go to the server; results come back on the
    src pad. ``timeout`` guards the round trip (≙ timeout property +
    CONNECTION_CLOSED handling).

    Resilience (≙ tensor_query/README.md:79-80): on connection loss the
    client reconnects with backoff; in ``connect-type=HYBRID`` it
    re-queries the discovery broker at dest-host:dest-port for the
    ``topic`` each attempt, so it fails over to an alternative server
    when the one it was using dies. Unanswered frames are replayed on
    the new connection (at-least-once: a frame whose *result* died with
    the connection is recomputed, so a duplicate is possible; the
    reference simply loses such frames)."""

    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    PROPS = {"host": "localhost", "port": 3001, "dest-host": "",
             "dest-port": 0, "timeout": 10.0, "max-request": 8,
             "connect-type": "TCP", "topic": "",
             # wire v2 link request: lossless payload codec
             # (raw|zlib|shuffle-zlib) and opt-in lossy fp32 downcast
             # (none|bf16|fp16); both silently fall back to raw/none
             # against a server that doesn't support them
             "wire-codec": "raw", "wire-precision": "none"}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._sock: Optional[socket.socket] = None
        self._recv_thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._inflight = threading.Semaphore(max(1, self.max_request))
        self._send_lock = threading.Lock()
        self._conn_lock = threading.Lock()
        self._connect_mutex = threading.Lock()  # one (re)connect at a time
        # unanswered requests, oldest first: replayed on reconnect so a
        # server death loses no frames (at-least-once; results map back
        # FIFO because the server pipeline preserves per-client order).
        # Each entry is [buffer, seq, sent_generation]; the BUFFER (not
        # serialized bytes) is held so a replay re-encodes under the NEW
        # connection's negotiated wire config — failing over from a
        # codec-speaking server to a v1 one must not replay stale-codec
        # payloads. Comparing the generation against _conn_gen under
        # _send_lock makes send and replay idempotent, so a frame is
        # sent at most once per connection no matter how sender and
        # reconnector interleave.
        self._pending: "collections.deque" = collections.deque()
        self._plock = threading.Lock()
        # guards _pending and _pushing over _plock; the code takes the
        # lock through this one name, so racecheck's lockset sees every
        # mutation of _pending under a common lock. Signalled whenever a
        # request settles: on_eos waits on it until nothing is owed
        # (``_pushing``: results settled but still on their way
        # downstream, which EOS must not overtake)
        self._settled = threading.Condition(self._plock)
        self._pushing = 0
        self._conn_gen = 0
        # the last connection whose replay has gone out (under
        # _send_lock): until then a new frame is left to that replay
        self._replayed_gen = 0
        # negotiated per-connection wire config (None = v1 peer);
        # published under _conn_lock together with the socket it belongs
        # to, so a sender always packs for the link it sends on
        self._wire_cfg: Optional[wire.WireConfig] = None
        self._last_caps: Optional[Caps] = None
        self._server_caps = _FLEX_CAPS
        # per-request wire correlation: serving servers (tensor_serve_*)
        # echo it back on RESULT/SHED so out-of-order sheds settle the
        # RIGHT pending entry; plain query servers ignore it and the
        # client falls back to FIFO pairing
        self._seq = 0
        # exact request accounting (the satellite fix for swallowed
        # frames): every admitted frame ends in exactly one bucket, so
        #   session_requests == session_delivered + shed
        #                       + session_declared_lost + in-flight
        # always balances — a frame that dies between socket-error
        # detection and re-dial is DECLARED, never silently swallowed
        self.stats.update({"reconnects": 0, "shed": 0, "link_errors": 0,
                           "session_requests": 0, "session_delivered": 0,
                           "session_replayed": 0, "session_dup_drops": 0,
                           "session_declared_lost": 0})

    def static_transfer(self, in_caps):
        """Unknown output: result caps come from the remote server."""
        return {"src": None}

    def _endpoints(self, timeout: float) -> list:
        """Candidate servers, most preferred first. An EMPTY broker
        answer raises ConnectionError so :meth:`_connect`'s Backoff loop
        re-queries (with ``link_errors`` accounting) until a server
        registers or the timeout budget runs out — a momentarily-bare
        topic (fleet rolling, server restarting) must not fail the
        stream fast."""
        if self.connect_type.upper() == "HYBRID":
            from ..edge.broker import discover
            eps = discover(self.dest_host or self.host,
                           int(self.dest_port) or int(self.port),
                           self.topic, timeout=timeout)
            if eps:
                return eps
            raise ConnectionError(
                f"{self.name}: no server for topic {self.topic!r}")
        return [(self.dest_host or self.host,
                 int(self.dest_port) or int(self.port))]

    def start(self) -> None:
        super().start()
        self._stop_evt.clear()

    def _connect(self, caps: Optional[Caps]) -> None:
        """(Re)connect: discovery + handshake + pending replay, retried
        with backoff until ``timeout``. Each retry re-discovers, so a
        replacement server registered after a death is found."""
        # both the chain thread (do_chain -> _connect) and the background
        # reconnect thread write this; _conn_lock keeps the read-modify-
        # write whole
        with self._conn_lock:
            self._last_caps = caps or self._last_caps
        with self._connect_mutex:
            if self._sock is not None:
                return  # lost the race: another thread reconnected
            deadline = time.monotonic() + self.timeout
            # shared backoff discipline (fault/backoff.py): exponential
            # with jitter, so N clients orphaned by one server death
            # don't hammer the replacement in lockstep
            from ..fault.backoff import Backoff
            backoff = Backoff(base=0.05, multiplier=2.0, max_s=1.0)
            last_err: Optional[Exception] = None
            while time.monotonic() < deadline and not self._stop_evt.is_set():
                # every blocking step below is budgeted out of the SAME
                # deadline so do_chain never stalls longer than ~timeout
                remaining = deadline - time.monotonic()
                try:
                    for host, port in self._endpoints(remaining):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        if self._try_endpoint(host, port, remaining):
                            return
                except (ConnectionError, OSError) as e:
                    # every failed round — unreachable broker, empty
                    # endpoint list, refused dial — is a counted link
                    # error, then the Backoff ladder re-queries
                    last_err = e
                    self.stats.inc("link_errors")
                # racecheck: ok(deliberate: reconnects are serialized under _connect_mutex, the sleep is stop-interruptible and deadline-budgeted)
                backoff.sleep(self._stop_evt)
            raise ConnectionError(
                f"{self.name}: cannot reach a query server: {last_err}")

    def _try_endpoint(self, host: str, port: int, timeout: float) -> bool:
        """One connect+handshake+replay attempt; False = try next."""
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
        except OSError:
            return False
        wire.tune_socket(sock)
        try:
            send_msg(sock, MsgKind.CAPS,
                     {"caps": str(self._last_caps or ""),
                      "wire": wire.advertise(str(self.wire_codec),
                                             str(self.wire_precision))})
            kind, meta, _ = recv_msg(sock)
            if kind != MsgKind.CAPS_ACK:
                raise ConnectionError(f"{self.name}: bad handshake {kind}")
            # handshake done: blocking mode for the long-lived recv loop
            # (a lingering per-op timeout would kill idle connections),
            # and caps published BEFORE the socket so a racing _connect
            # caller never reads half-initialized state
            sock.settimeout(None)
            self._server_caps = meta.get("caps", _FLEX_CAPS)
            cfg = wire.accept(meta.get("wire"))
            with self._conn_lock:
                self._sock = sock
                self._wire_cfg = cfg
                self._conn_gen += 1
                gen = self._conn_gen
                self._inflight = threading.Semaphore(
                    max(1, self.max_request))
            self._recv_thread = threading.Thread(
                target=self._recv_loop, args=(sock, self._inflight),
                name=f"qclient-recv:{self.name}", daemon=True)
            self._recv_thread.start()
            # replay unanswered frames in order on the new connection —
            # re-encoded under THIS connection's negotiated config; the
            # send lock is held across the whole replay so a new frame
            # from the streaming thread cannot interleave and break the
            # FIFO request->result pairing, and the streaming thread
            # sends nothing on this connection before the replay has
            # gone out (_replayed_gen); the generation mark skips
            # entries the streaming thread already sent on THIS connection
            with self._send_lock:
                with self._settled:
                    replay = list(self._pending)
                for entry in replay:
                    if entry[2] == gen:
                        continue
                    if not self._inflight.acquire(timeout=self.timeout):
                        raise ConnectionError(
                            f"{self.name}: replay stalled")
                    meta, payloads = wire.pack_buffer(entry[0], cfg,
                                                      stats=self.stats)
                    meta["seq"] = entry[1]
                    roi = _roi_meta(entry[0])
                    if roi is not None:
                        meta["delta_roi"] = roi
                    send_msg(sock, MsgKind.DATA, meta, payloads,
                             stats=self.stats)
                    entry[2] = gen
                    self.stats.inc("session_replayed")
                self._replayed_gen = gen
            return True
        except (ConnectionError, OSError):
            self._handle_disconnect(sock)
            try:
                sock.close()
            except OSError:
                pass
            return False

    def _handle_disconnect(self, sock: Optional[socket.socket]) -> None:
        """Tear down a failed connection (idempotent; ignores stale
        sockets already replaced by a reconnect)."""
        with self._conn_lock:
            if sock is not None and sock is not self._sock:
                return
            old, self._sock = self._sock, None
            self._wire_cfg = None
            # fresh permit pool: replies owed on the dead connection will
            # never come, and blocked senders must not burn the timeout
            dead_window = self._inflight
            self._inflight = threading.Semaphore(max(1, self.max_request))
        _sever(old)
        # a sender already blocked on the dead link's full window wakes
        # now (the reference leaves it waiting out the whole timeout, then
        # declares its frame lost): its send fails on the severed socket
        # or finds the frame replayed, and its retry goes out on the next
        # connection
        for _ in range(max(1, self.max_request)):
            dead_window.release()

    def stop(self) -> None:
        self._stop_evt.set()
        self._handle_disconnect(None)
        super().stop()

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        if self._sock is None:
            self._connect(caps)
        self.set_src_caps(Caps(self._server_caps))

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        seq = self._seq = self._seq + 1
        self.stats.inc("session_requests")
        with self._conn_lock:
            self._last_caps = pad.caps or self._last_caps
        # the entry holds the BUFFER: it is packed at send time, under
        # the config of the connection it actually goes out on
        entry = [buf, seq, -1]  # -1 = not yet sent on any connection
        with self._settled:
            self._pending.append(entry)
        for attempt in (1, 2):
            sock = None
            try:
                if self._sock is None:
                    self._connect(pad.caps)
                    self.stats.inc("reconnects")
                    self.set_src_caps(Caps(self._server_caps))
                with self._conn_lock:
                    sock, gen = self._sock, self._conn_gen
                    inflight = self._inflight
                    cfg = self._wire_cfg
                if entry[2] == gen:
                    # a reconnect replay already sent our frame; if that
                    # link died since, the frame is still pending and the
                    # next replay sends it again (the reference checks the
                    # socket first and declares such a frame lost)
                    return
                if sock is None:
                    raise ConnectionError(f"{self.name}: not connected")
                if not inflight.acquire(timeout=self.timeout):
                    raise TimeoutError(f"{self.name}: server not answering")
                with self._send_lock:
                    if entry[2] == gen:   # replay won the race meanwhile
                        inflight.release()
                    elif self._replayed_gen != gen:
                        # the connection is up but its replay has not
                        # gone out: our frame is pending, and that replay
                        # sends it after the older ones
                        inflight.release()
                    else:
                        meta, payloads = wire.pack_buffer(buf, cfg,
                                                          stats=self.stats)
                        meta["seq"] = seq
                        roi = _roi_meta(buf)
                        if roi is not None:
                            meta["delta_roi"] = roi
                        send_msg(sock, MsgKind.DATA, meta, payloads,
                                 stats=self.stats)
                        entry[2] = gen
                return
            except TimeoutError:
                # backpressure timeout, NOT a dead connection (it is an
                # OSError subclass, so re-raise before the handler below
                # tears down a healthy socket)
                self._declare_lost(entry)
                raise
            except (ConnectionError, OSError) as e:
                # tear down only the socket the failure happened on; a
                # racing reconnect may already have installed a fresh one
                if sock is not None:
                    self._handle_disconnect(sock)
                if attempt == 2:
                    self._declare_lost(entry)
                    raise ConnectionError(
                        f"{self.name}: send failed after reconnect: {e}") \
                        from e
                logger.warning("%s: connection lost, reconnecting (%s)",
                               self.name, e)

    def _declare_lost(self, entry) -> None:
        """Give up on one pending request and SAY SO: the frame is
        removed from the replay set and counted in
        ``session_declared_lost`` (plus a structured bus warning), so
        the accounting identity still balances — never a silent
        swallow between error detection and re-dial."""
        with self._settled:
            try:
                self._pending.remove(entry)
            except ValueError:
                return  # already settled/declared by another path
        self.stats.inc("session_declared_lost")
        self.post_message("warning", frames_lost=1, seq=entry[1],
                          detail="request abandoned after send/replay "
                                 "failure")

    def kill_link(self) -> int:
        """Chaos hook (tensor_fault mode=kill-link): force-close the
        live server connection mid-stream. The recv loop detects it,
        reconnects, and replays every unanswered frame."""
        with self._conn_lock:
            sock = self._sock
        if sock is None:
            return 0
        _sever(sock)
        self.stats.inc("link_kills")
        return 1

    def session_info(self) -> Dict:
        with self._settled:
            n = len(self._pending)
        return {"in_flight": n} if n else {}

    def _settle_pending(self, seq, pushing: bool = False) -> None:
        """Mark the request a reply answers as no longer owed. Serving
        servers echo our ``seq`` (sheds can overtake results, so FIFO
        would settle the wrong entry); plain query servers don't, and
        order-preserving FIFO remains correct there. ``pushing``: the
        result is about to go downstream; :meth:`_pushed` ends that."""
        with self._settled:
            self._pushing += int(pushing)
            self._settled.notify_all()
            if seq is not None:
                for i, entry in enumerate(self._pending):
                    if entry[1] == seq:
                        del self._pending[i]
                        return
            if self._pending:
                self._pending.popleft()

    def _pushed(self) -> None:
        with self._settled:
            self._pushing -= 1
            self._settled.notify_all()

    def _recv_loop(self, sock: socket.socket,
                   inflight: threading.Semaphore) -> None:
        try:
            while not self._stop_evt.is_set():
                kind, meta, payloads = recv_msg(sock, stats=self.stats)
                if kind == MsgKind.DRAIN:
                    # the server is draining: it will settle what it
                    # already admitted and shed the rest. Back off new
                    # sends via upstream QoS with its retry-after hint.
                    self.stats.inc("server_drains")
                    retry_ns = int(
                        float(meta.get("retry_after_ms", 0.0)) * 1e6)
                    self.send_upstream_event(QosEvent(
                        proportion=2.0, period_ns=retry_ns))
                    continue
                if kind in (MsgKind.RESULT, MsgKind.SHED):
                    with self._conn_lock:
                        stale = sock is not self._sock
                    if stale:
                        # our connection was replaced under us: the replay
                        # on the new connection recomputes this frame, so
                        # forwarding would duplicate it — and releasing
                        # would inflate the NEW semaphore's permit pool.
                        # Counted: this is exactly a session dup-drop.
                        self.stats.inc("session_dup_drops")
                        continue
                    if kind == MsgKind.SHED:
                        # the server dropped this request (admission or
                        # deadline): no result will come. Surface the
                        # overload upstream as QoS with the server's
                        # retry-after as the sustainable spacing hint.
                        self._settle_pending(meta.get("seq"))
                        self.stats.inc("shed")
                        retry_ns = int(
                            float(meta.get("retry_after_ms", 0.0)) * 1e6)
                        self.send_upstream_event(QosEvent(
                            proportion=2.0, period_ns=retry_ns))
                        inflight.release()
                        continue
                    # settled before the push (a replay racing the push
                    # must not resend an answered frame), counted as
                    # pushing until it is downstream: on_eos waits for
                    # both, so EOS never overtakes this result
                    self._settle_pending(meta.get("seq"), pushing=True)
                    try:
                        self.srcpad.push(_roi_adopt(
                            wire.unpack_buffer(meta, payloads,
                                               stats=self.stats),
                            meta.get("delta_roi")))
                    finally:
                        self._pushed()
                    self.stats.inc("session_delivered")
                    inflight.release()
                elif kind == MsgKind.EOS:
                    break
        except (ConnectionError, OSError):
            if not self._stop_evt.is_set():
                self.stats.inc("link_errors")
                logger.warning("%s: server connection closed", self.name)
                # unblock senders so the next frame triggers a reconnect
                self._handle_disconnect(sock)
                with self._settled:
                    owed = len(self._pending)
                if owed:
                    # answers are still owed: reconnect proactively so the
                    # replay happens even if no new frame ever arrives
                    threading.Thread(target=self._reconnect_bg,
                                     name=f"qclient-reconn:{self.name}",
                                     daemon=True).start()

    def _reconnect_bg(self) -> None:
        try:
            self._connect(self._last_caps)
            self.stats.inc("reconnects")
        except (ConnectionError, OSError) as e:
            logger.warning("%s: background reconnect failed: %s",
                           self.name, e)

    def on_eos(self) -> None:
        # drain in-flight requests before forwarding EOS: wait until no
        # request is owed and no settled result is still on its way
        # downstream, across reconnects (the reference waits on the
        # window of the connection open at EOS, so a link lost during
        # the drain costs it the whole timeout)
        deadline = time.monotonic() + self.timeout
        with self._settled:
            while (self._pending or self._pushing) \
                    and not self._stop_evt.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._settled.wait(min(left, 0.1))
            # anything still unanswered will never be: downstream is
            # about to see EOS. Declare the remainder so the accounting
            # identity (requests == delivered + shed + declared_lost)
            # closes.
            leftovers = len(self._pending)
            self._pending.clear()
        if leftovers:
            self.stats.inc("session_declared_lost", leftovers)
            self.post_message("warning", frames_lost=leftovers,
                              detail="requests still unanswered at EOS")
        if self._sock is not None:
            try:
                send_msg(self._sock, MsgKind.EOS, {})
            except (ConnectionError, OSError):
                pass
