"""tensor_serve_src / tensor_serve_sink — the serving-stack edge.

Port of ``nnstreamer_tpu/serve/elements.py``.
``tensor_serve_src ! tensor_filter ... ! tensor_serve_sink`` is the
server pipeline: the src accepts N concurrent clients speaking the same
wire protocol as ``tensor_query_client`` (the JAX package's too, byte
for byte), admits each frame through the ServeScheduler (bounded
per-stream queues), coalesces admitted requests into bucketed padded
batches, and the sink demuxes each batch row's result back to the client
that asked. Shed requests (admission or deadline) are answered
immediately with a SHED message carrying a retry-after hint, which the
query client surfaces as an upstream QosEvent.

Against the per-request ``tensor_query_serversrc`` path this is the
"serving stack": the filter sees at most ``len(buckets)`` input
signatures (on the card, one captured CUDA graph each), a lone request
flushes after ``max-wait-ms``, and a client that outruns the card is shed
instead of growing an unbounded backlog.

Each batch is stacked and padded on the host, so it reaches the card in
one copy a tensor, and the sink reads it back in one copy batch
(:meth:`~..tensors.buffer.Buffer.fetch_host`; with the filter's
``prefetch-host=true`` that copy is already in flight). The padded rows
are copied with the stack and never answered.

Every admitted request is answered exactly once, RESULT or SHED: the
scheduler's ``requests == completed + shed_deadline + cancelled +
shed_failed + pending`` and the ROI gate's ``serve_roi_requests ==
serve_roi_results + serve_roi_shed + pending`` (the reference's
``serve-settlement`` and ``roi-settlement`` identities).

Not ported: ``mesh=`` (ROADMAP item 12) and ``llm-role=`` (item 8, with
the KV handoff) raise :class:`~..pipeline.element.NotPortedError` at
start; the checkpoint hooks ``snapshot_state``, ``restore_state`` and
``preempt_inflight`` come with item 11.
"""
from __future__ import annotations

import socket
import threading
import uuid
from typing import Dict, Optional, Tuple

from ..edge import wire
from ..edge.protocol import MsgKind, recv_msg, send_msg, sever_socket as _sever
from ..obs import context as _obs_ctx
from ..obs import events as _obs_events
from ..pipeline.element import SinkElement, SrcElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..utils.log import logger
from .batcher import Request, row_of, stack_rows
from .scheduler import (ServeScheduler, get_scheduler, register_scheduler,
                        unregister_scheduler)

_FLEX_CAPS = "other/tensors,format=flexible"


@register_element("tensor_serve_src")
class TensorServeSrc(SrcElement):
    """Serving entry: N client connections -> one bucketed batch stream.

    Each created buffer is one padded batch: chunks carry the stacked
    request tensors, ``serve_rows`` extras carry the originating
    requests (the demux correlation), and ``batch_valid_rows`` tells the
    filter how many rows are real (the filter trims the padded rows of
    host outputs; card outputs ship padded, as on the query micro-batch
    path).
    """

    PROPS = {"host": "localhost", "port": 3001, "id": 0, "timeout": 10.0,
             # HYBRID: advertise (topic -> host:port) on the discovery
             # broker at dest-host:dest-port, with occupancy metadata so
             # a fleet router can seed its least-loaded dispatch
             "connect-type": "TCP", "topic": "",
             "dest-host": "localhost", "dest-port": 0,
             # bucketed batch sizes, ascending; one signature (one
             # captured graph on the card) each
             "buckets": "1,2,4,8",
             # a partial batch flushes when its oldest request has
             # waited this long (a lone request never stalls)
             "max-wait-ms": 5.0,
             # bounded per-stream queue: admission control / backpressure
             "max-queue": 16,
             # 0 = no deadline; else queued requests older than this are
             # shed with a retry-after instead of invoked
             "deadline-ms": 0.0,
             # the retry-after hint carried by SHED replies
             "retry-after-ms": 50.0,
             # model/config version tag, advertised on REGISTER and
             # every PONG load report: the fleet's blue/green rollout
             # verifies the whole ring converged on the new version
             # before retiring the old one ("" = unversioned)
             "version": ""}
    # mesh-aware serving (ROADMAP item 12) and the disaggregated LLM
    # replica's phase (item 8): only the per-card, role-free default
    NOT_PORTED = {"mesh": "", "llm-role": ""}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._next_client = [0]
        # cid -> (conn, send lock, negotiated wire config): replies come
        # from the sink's streaming thread, sheds from the batcher and
        # recv threads — the per-connection lock keeps wire frames
        # atomic; the config (None = plain v1 peer) is rebound under
        # _clock once the client's CAPS advertisement arrives
        self._conns: Dict[int, Tuple[socket.socket, threading.Lock,
                                     Optional[wire.WireConfig]]] = {}
        self._clock = threading.Lock()
        self.scheduler: Optional[ServeScheduler] = None
        self._broker_sock: Optional[socket.socket] = None
        # per-incarnation token (reminted by every start()), echoed in
        # CAPS_ACK so a fleet router can tell "reconnect to the same
        # process life" from "a new process at the same endpoint"
        self._instance = uuid.uuid4().hex[:12]
        self.stats["link_errors"] = 0
        self.stats.update({"serve_roi_requests": 0, "serve_roi_crops": 0,
                           "serve_roi_shed": 0, "serve_roi_results": 0})

    @property
    def bound_port(self) -> int:
        return self._listener.getsockname()[1] if self._listener else self.port

    def negotiate_src_caps(self) -> Optional[Caps]:
        return Caps(_FLEX_CAPS)

    def static_src_caps(self) -> Optional[Caps]:
        """Flexible tensors (bucketed padded batches, shapes per
        request); the filter sees at most len(buckets) signatures."""
        return Caps(_FLEX_CAPS)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.check_ported()
        self._instance = uuid.uuid4().hex[:12]
        self.scheduler = ServeScheduler(
            buckets=[int(b) for b in str(self.buckets).split(",") if b],
            max_wait_s=float(self.max_wait_ms) / 1e3,
            max_queue=int(self.max_queue),
            deadline_s=float(self.deadline_ms) / 1e3,
            name=self.name)
        register_scheduler(self.id, self.scheduler)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(64)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"serve-accept:{self.name}",
            daemon=True)
        self._accept_thread.start()
        if str(self.connect_type).upper() == "HYBRID":
            # hold the registration connection open for our lifetime
            # (the broker drops the advertisement the moment it closes);
            # the metadata seeds a fleet router's least-loaded dispatch
            try:
                self._broker_sock = socket.create_connection(
                    (self.dest_host or "localhost", int(self.dest_port)),
                    timeout=self.timeout)
                reg_meta = dict(self.scheduler.occupancy(), role="serve")
                if str(self.version):
                    reg_meta["version"] = str(self.version)
                send_msg(self._broker_sock, MsgKind.REGISTER,
                         {"topic": self.topic, "host": self.host,
                          "port": self.bound_port, "meta": reg_meta})
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
                unregister_scheduler(self.id)
                raise
        super().start()

    def stop(self) -> None:
        super().stop()
        unregister_scheduler(self.id)
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
        with self._clock:
            victims = list(self._conns.values())
            self._conns.clear()
        for conn, _, _ in victims:
            try:
                conn.close()
            except OSError:
                pass

    # -- client side -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                conn, _addr = self._listener.accept()
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
            with self._clock:
                self._conns[cid] = (conn, threading.Lock(), None)
            threading.Thread(target=self._client_loop, args=(conn, cid),
                             name=f"serve-client{cid}:{self.name}",
                             daemon=True).start()

    def _client_loop(self, conn: socket.socket, cid: int) -> None:
        # a per-op timeout detects half-open (silently dead) peers: a
        # live-but-idle client just times out between messages and loops
        conn.settimeout(max(0.1, float(self.timeout)))
        try:
            while not self._stop_evt.is_set():
                try:
                    kind, meta, payloads = recv_msg(conn, stats=self.stats)
                except TimeoutError:
                    continue  # idle keep-alive; re-check stop
                if kind == MsgKind.CAPS:
                    # wire v2 negotiation: fold the client's advertised
                    # codec/precision wish into the link config and echo
                    # the choice; a client without a "wire" block is a
                    # v1 peer and gets plain v1 replies
                    cfg = wire.negotiate(meta.get("wire"))
                    with self._clock:
                        entry = self._conns.get(cid)
                        if entry is not None:
                            self._conns[cid] = (entry[0], entry[1], cfg)
                    ack = {"caps": _FLEX_CAPS, "client_id": cid,
                           "instance": self._instance}
                    if cfg is not None:
                        ack["wire"] = cfg.to_meta()
                    send_msg(conn, MsgKind.CAPS_ACK, ack)
                elif kind == MsgKind.DATA:
                    self._admit(cid, meta, payloads)
                elif kind == MsgKind.DATA_BATCH:
                    for b in wire.unpack_batch(meta, payloads,
                                               stats=self.stats):
                        self._admit_buf(cid, b, b.extras.get("seq"))
                elif kind == MsgKind.PING:
                    # heartbeat reply doubles as a load report: the
                    # fleet router's least-loaded tiebreak reads the
                    # occupancy snapshot it carries (uses the per-conn
                    # send lock — a PONG must not interleave with a
                    # RESULT the sink thread is writing)
                    load = (self.scheduler.occupancy()
                            if self.scheduler is not None else {})
                    if str(self.version):
                        load = dict(load, version=str(self.version))
                    self._send(cid, MsgKind.PONG,
                               {"t": meta.get("t"), "load": load})
                elif kind == MsgKind.EOS:
                    break
        except (ConnectionError, OSError, ValueError) as exc:
            # routine client death, but logged + counted (never a bare
            # discard): flapping clients must show up in stats()
            self.stats.inc("link_errors")
            logger.info("%s: client %d connection ended: %r",
                        self.name, cid, exc)
        finally:
            # slot reclamation: a stream that dies mid-request must not
            # wedge the batcher or leak its queued slots
            self._drop_client(cid)
            try:
                conn.close()
            except OSError:
                pass

    def _admit(self, cid: int, meta, payloads) -> None:
        buf = wire.unpack_buffer(meta, payloads, stats=self.stats)
        roi = meta.get("delta_roi")
        if roi and roi.get("rois"):
            self._admit_roi(cid, buf, meta.get("seq"), roi)
            return
        self._admit_buf(cid, buf, meta.get("seq"))

    def _admit_buf(self, cid: int, buf: Buffer, seq) -> None:
        self.scheduler.submit(
            cid, [c.host() for c in buf.chunks],
            seq=seq, pts=buf.pts,
            on_result=self._on_result, on_shed=self._on_shed,
            ctx=_obs_ctx.ctx_of(buf))

    # -- ROI-gated admission (tensor_delta mode=roi upstream) --------------
    def _admit_roi(self, cid: int, buf: Buffer, seq, roi: dict) -> None:
        """One DATA frame carrying N changed-tile crops becomes N
        single-crop submissions through the bucketed batcher — the
        unchanged tiles were never shipped, and here they are never
        *inferred* either.  One RESULT goes back once every crop's row
        lands (the echoed ``delta_roi`` block lets the client-side
        tensor_delta_stitch scatter the rows over its cached canvas)."""
        crops = buf.chunks[0].host()
        n = int(crops.shape[0])
        self.stats.add(serve_roi_requests=1, serve_roi_crops=n)
        agg = {"rows": [None] * n, "left": n, "settled": False,
               "lock": threading.Lock(), "roi": roi, "pts": buf.pts,
               "seq": seq, "reqs": []}
        ctx = _obs_ctx.ctx_of(buf)
        for k in range(n):
            with agg["lock"]:
                if agg["settled"]:
                    # an earlier crop already shed the frame (admission
                    # shed runs its callback inline): stop feeding the
                    # batcher work whose results would be discarded
                    break
            req = self.scheduler.admit(
                cid, [row_of(crops, k)],
                seq=seq, pts=buf.pts,
                on_result=lambda req, row, k=k, agg=agg:
                    self._roi_part(cid, agg, k, row),
                on_shed=lambda req, agg=agg: self._roi_shed(cid, agg),
                ctx=ctx)
            if req is not None:
                with agg["lock"]:
                    agg["reqs"].append(req)
        # the shed may have landed between the final admit and here:
        # reclaim whatever siblings are still queued (idempotent)
        with agg["lock"]:
            siblings = list(agg["reqs"]) if agg["settled"] else []
        if siblings:
            self.scheduler.cancel_requests(siblings)

    def _roi_part(self, cid: int, agg: dict, k: int, row) -> None:
        with agg["lock"]:
            if agg["settled"]:
                return  # a sibling crop was shed; the SHED already went
            agg["rows"][k] = list(row)
            agg["left"] -= 1
            if agg["left"] > 0:
                return
            agg["settled"] = True
        # frame-level terminal: exactly one RESULT per ROI request
        # (roi-settlement identity: requests == results + shed + pending)
        self.stats.inc("serve_roi_results")
        rows = agg["rows"]
        stacked = [stack_rows([r[j] for r in rows])
                   for j in range(len(rows[0]))]
        with self._clock:
            entry = self._conns.get(cid)
        cfg = entry[2] if entry is not None else None
        reply = Buffer.from_arrays(stacked, pts=agg["pts"])
        meta, payloads = wire.pack_buffer(reply, cfg, stats=self.stats)
        meta["client_id"] = cid
        meta["seq"] = agg["seq"]
        meta["delta_roi"] = agg["roi"]
        self._send(cid, MsgKind.RESULT, meta, payloads)

    def _roi_shed(self, cid: int, agg: dict) -> None:
        """Any shed crop sheds the whole frame: a partial stitch would
        silently mix epochs. Exactly one SHED answers the request, and
        the frame's still-queued sibling crops are cancelled — leaving
        them would burn card batches on rows whose frame already died."""
        with agg["lock"]:
            if agg["settled"]:
                return
            agg["settled"] = True
            siblings = list(agg["reqs"])
        if siblings:
            self.scheduler.cancel_requests(siblings)
        self.stats.inc("serve_roi_shed")
        self._send(cid, MsgKind.SHED,
                   {"pts": agg["pts"], "seq": agg["seq"], "client_id": cid,
                    "retry_after_ms": float(self.retry_after_ms)})

    # -- reply side (called by the scheduler's demux) ----------------------
    def _on_result(self, req: Request, row) -> None:
        # encode under the client's negotiated link config (None = v1:
        # byte-identical to the old raw framing, minus the copies)
        with self._clock:
            entry = self._conns.get(req.stream_id)
        cfg = entry[2] if entry is not None else None
        reply = Buffer.from_arrays(list(row), pts=req.pts)
        if req.ctx is not None:
            # the reply carries the request's trace context home so the
            # client-side sink attributes the whole journey
            _obs_ctx.attach(reply, req.ctx)
        meta, payloads = wire.pack_buffer(reply, cfg, stats=self.stats)
        meta["client_id"] = req.stream_id
        meta["seq"] = req.seq
        self._send(req.stream_id, MsgKind.RESULT, meta, payloads)

    def _on_shed(self, req: Request) -> None:
        # backpressure on the wire: the client translates this into an
        # upstream QosEvent and a retry-after spacing hint
        self._send(req.stream_id, MsgKind.SHED,
                   {"pts": req.pts, "seq": req.seq,
                    "client_id": req.stream_id,
                    "retry_after_ms": float(self.retry_after_ms)})

    def _send(self, cid, kind, meta, payloads=()) -> None:
        with self._clock:
            entry = self._conns.get(cid)
        if entry is None:
            logger.warning("%s: no connection for client %s", self.name, cid)
            return
        conn, lock, _cfg = entry
        try:
            with lock:
                send_msg(conn, kind, meta, payloads, stats=self.stats)
        except (ConnectionError, OSError):
            self._drop_client(cid)

    def _drop_client(self, cid) -> None:
        with self._clock:
            self._conns.pop(cid, None)
        if self.scheduler is not None:
            n = self.scheduler.cancel_stream(cid)
            if n:
                logger.info("%s: client %s died, reclaimed %d queued "
                            "slot(s)", self.name, cid, n)

    # -- graceful teardown / chaos hooks -----------------------------------
    def drain(self) -> None:
        """Graceful teardown: close scheduler admission (late frames
        shed with retry-after), tell every client DRAIN so it stops
        sending and settles, and flush everything already admitted
        through the batcher -> filter -> sink demux behind the EOS
        barrier (next_batch returns None once the queue is dry). Every
        pending correlation is answered — RESULT or SHED — before the
        pipeline closes."""
        super().drain()
        _obs_events.emit("drain", source=self.name, element=self,
                         clients=len(self._conns))
        if self.scheduler is not None:
            self.scheduler.drain()
        with self._clock:
            entries = list(self._conns.items())
        for cid, (conn, lock, _cfg) in entries:
            try:
                with lock:
                    send_msg(conn, MsgKind.DRAIN,
                             {"client_id": cid,
                              "retry_after_ms": float(self.retry_after_ms)})
            except (ConnectionError, OSError):
                pass

    def drain_flushed(self) -> bool:
        # the streaming loop may only stop once everything admitted has
        # been batched out (create()'s next_batch -> None is the same
        # barrier; this keeps the loop-head check honest)
        return self.scheduler is None or self.scheduler.pending() == 0

    def kill_link(self) -> int:
        """Chaos hook (tensor_fault mode=kill-link): force-close every
        live client connection mid-stream, exactly like the server side
        of a network partition. Clients reconnect and replay their
        pending correlations."""
        with self._clock:
            victims = list(self._conns.values())
        for conn, _lock, _cfg in victims:
            _sever(conn)
        self.stats.inc("link_kills", len(victims))
        return len(victims)

    # -- the src loop ------------------------------------------------------
    def create(self) -> Optional[Buffer]:
        if self.scheduler.tracer is None:
            self.scheduler.tracer = getattr(self.pipeline, "tracer", None)
        nb = self.scheduler.next_batch(self._stop_evt)
        if nb is None:
            return None
        batch, _bucket, stacked = nb
        out = Buffer([Chunk(x) for x in stacked], pts=batch[0].pts)
        out.extras["serve_rows"] = batch
        out.extras["serve_id"] = self.id
        # the filter's failure paths (invoke error, breaker-open shed)
        # settle rows via on_shed but the scheduler never sees a demuxed
        # result for them — this handle lets the filter report them as
        # shed_failed so the settlement identity stays balanced
        out.extras["serve_sched"] = self.scheduler
        # the filter trims the padded rows of host outputs; card outputs
        # ship padded and the sink's demux answers the real rows only
        out.extras["batch_valid_rows"] = len(batch)
        if batch[0].ctx is not None:
            # batch adoption: the fused-segment spans downstream join the
            # first request's trace tree (the other rows stay connected
            # through their own queue_wait/batch spans)
            _obs_ctx.attach(out, batch[0].ctx.child())
        return out


@register_element("tensor_serve_sink")
class TensorServeSink(SinkElement):
    """Serving exit: reads each result batch on the host in one copy
    batch and hands it to the scheduler's demux, which routes row i to
    the stream that contributed input row i (correlation rides IN the
    buffer as the originating requests; padded rows have none)."""

    PROPS = {"id": 0}

    def handle_event(self, pad, event) -> None:
        from ..pipeline.events import CapsEvent
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            return
        super().handle_event(pad, event)

    def render(self, buf: Buffer) -> None:
        rows = buf.extras.get("serve_rows")
        if not rows:
            logger.warning("%s: buffer without serve_rows dropped", self.name)
            return
        sched = get_scheduler(buf.extras.get("serve_id", self.id))
        # one copy batch for the whole stack (waits on the filter's
        # prefetch when it is in flight), never a blocking copy a chunk
        hosts = buf.fetch_host()
        if sched is None:
            # server stopping: requests are orphaned, nothing to answer
            return
        sched.complete(rows, hosts)
