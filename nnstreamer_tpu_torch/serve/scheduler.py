"""ServeScheduler: admission -> bucketed batch -> invoke -> demux.

Port of ``nnstreamer_tpu/serve/scheduler.py``. The scheduler owns the
three moving parts of the serving stack: a
:class:`~.batcher.BucketBatcher` (coalescing + admission + deadlines), a
demux that routes each batch row's result back to its originating
request by correlation, and per-batch metrics (occupancy, queue delay,
batch latency, shed counts) kept in O(1)-memory reservoirs and — when a
pipeline tracer is attached — mirrored into its report.

Two embeddings:

* **Pipeline elements** (``tensor_serve_src``/``tensor_serve_sink``):
  the src loop calls :meth:`next_batch`, the filter invokes, the sink
  calls :meth:`complete`. The pair find each other in :data:`SERVE_TABLE`
  keyed by their ``id`` property.
* **Standalone** (tests, embedding without a pipeline): construct with
  ``invoke_fn`` and :meth:`start` a worker thread that drives
  batch -> invoke -> demux itself.

:meth:`complete` reads a batch's outputs on the host with one copy
batch: outputs still on the card join one coalesced fetch on the copy
stream (tensors/transfer.py ``fetch_host``), the counterpart of the
reference's one ``jax.device_get``; a fetch already in flight
(``prefetch-host``) is waited for. A padded row is fetched with its
batch (one copy of the stack) and never demuxed.

Not ported: the mesh placement (``mesh_spec``, ``place``; ROADMAP item
12) — batches stay where :func:`~.batcher.stack_requests` made them, on
the host, and the bucket snap is 1 — and the pending ledger a
checkpoint records (``pending_ledger``, ``record_recovered``; item 11).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..obs import events as _obs_events
from ..obs import spans as _obs_spans
from ..tensors.transfer import fetch_host
from ..utils.atomic import Counters
from ..utils.log import logger
from ..utils.trace import Reservoir, WindowReservoir
from .batcher import BucketBatcher, Request, row_of, stack_requests

# serve_src/serve_sink pairing by id (≙ the query elements' SERVER_TABLE)
SERVE_TABLE: Dict[int, "ServeScheduler"] = {}
_TABLE_LOCK = threading.Lock()


def register_scheduler(sid: int, sched: "ServeScheduler") -> None:
    with _TABLE_LOCK:
        SERVE_TABLE[sid] = sched


def unregister_scheduler(sid: int) -> None:
    with _TABLE_LOCK:
        SERVE_TABLE.pop(sid, None)


def get_scheduler(sid: int) -> Optional["ServeScheduler"]:
    with _TABLE_LOCK:
        return SERVE_TABLE.get(sid)


class ServeScheduler:
    def __init__(self, buckets: Sequence[int] = (1, 2, 4, 8),
                 max_wait_s: float = 0.005, max_queue: int = 16,
                 deadline_s: float = 0.0,
                 invoke_fn: Optional[Callable] = None,
                 name: str = "serve"):
        self.name = name
        self.batcher = BucketBatcher(buckets, max_wait_s, max_queue)
        self.deadline_s = max(0.0, float(deadline_s))
        self._invoke_fn = invoke_fn
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.tracer = None  # optional utils.trace.Tracer (observe() sink)
        self._mlock = threading.Lock()
        # queue delay is the fleet's load signal (PONG occupancy):
        # windowed, so a drained backlog stops reading as pressure
        # within seconds
        self._queue_delay = WindowReservoir(window_s=2.0)
        self._batch_latency = Reservoir()
        self.stats = Counters(completed=0, rows_padded=0, bucket_rows=0,
                              result_errors=0, invoke_errors=0,
                              shed_failed=0)

    # -- producers ---------------------------------------------------------
    def admit(self, stream_id: Any, arrays: Sequence[Any], *,
              seq: Optional[int] = None, pts: Optional[int] = None,
              on_result: Optional[Callable] = None,
              on_shed: Optional[Callable] = None,
              deadline_s: Optional[float] = None,
              ctx: Optional[Any] = None) -> Optional[Request]:
        """Admit one request and return its handle (None = shed at
        admission; ``on_shed`` has already been invoked). The handle is
        what :meth:`cancel_requests` cancels — callers that may shed a
        composite (e.g. every sibling crop of an ROI frame) keep it."""
        dl = self.deadline_s if deadline_s is None else deadline_s
        req = Request(stream_id, arrays, seq=seq, pts=pts,
                      deadline=(time.monotonic() + dl) if dl > 0 else None,
                      on_result=on_result, on_shed=on_shed, ctx=ctx)
        if self.batcher.submit(req):
            return req
        _obs_events.emit("shed", source=self.name, reason="admission",
                         stream=str(stream_id))
        if on_shed is not None:
            on_shed(req)
        return None

    def submit(self, stream_id: Any, arrays: Sequence[Any], *,
               seq: Optional[int] = None, pts: Optional[int] = None,
               on_result: Optional[Callable] = None,
               on_shed: Optional[Callable] = None,
               deadline_s: Optional[float] = None,
               ctx: Optional[Any] = None) -> bool:
        """Admit one request. False = shed at admission; the ``on_shed``
        callback has already been invoked (retry-after is the caller's
        wire-level answer)."""
        return self.admit(stream_id, arrays, seq=seq, pts=pts,
                          on_result=on_result, on_shed=on_shed,
                          deadline_s=deadline_s, ctx=ctx) is not None

    def cancel_stream(self, stream_id: Any) -> int:
        return self.batcher.cancel_stream(stream_id)

    def cancel_requests(self, reqs: Sequence[Request]) -> int:
        """Cancel specific still-queued requests (ROI sibling-crop
        cleanup on a shed frame). Returns how many were removed; each
        counts as ``cancelled`` in the settlement identity. Requests
        already batched are past cancellation and settle normally."""
        return self.batcher.cancel_requests(reqs)

    def record_shed_failed(self, n: int = 1) -> None:
        """Terminal accounting for batched-but-failed rows: an invoke
        failure sheds the whole batch via per-request ``on_shed``, and
        this counter is what keeps ``requests == completed +
        shed_deadline + cancelled + shed_failed + pending`` balanced.
        The pipeline embedding (tensor_filter) calls this from its
        invoke-failure and breaker-open paths."""
        if n > 0:
            with self._mlock:
                self.stats.inc("shed_failed", n)

    def drain(self) -> None:
        """Graceful teardown: close admission (late submits shed with
        retry-after), flush every queued request through the invoke
        path, and let :meth:`next_batch` return None once the queue is
        dry — the serving loop's EOS barrier. Pending correlations
        settle through :meth:`complete` as usual."""
        self.batcher.drain()

    @property
    def draining(self) -> bool:
        return self.batcher.draining

    def pending(self) -> int:
        """Requests admitted but not yet batched (the drain barrier
        watches this reach zero)."""
        return self.batcher.depth()

    # -- the batch side ----------------------------------------------------
    def next_batch(self, stop: Optional[threading.Event] = None):
        """Block for the next batch; returns (requests, bucket, stacked
        arrays) or None when ``stop`` fires. Queue-delay and occupancy
        metrics are recorded here (the batch is formed NOW)."""
        batch = self.batcher.next_batch(stop)
        if batch is None:
            return None
        bucket = self.batcher.bucket_for(len(batch))
        now = time.monotonic()
        with self._mlock:
            for r in batch:
                self._queue_delay.add((now - r.t_arrival) * 1e9)
            self.stats.add(bucket_rows=bucket, rows_padded=bucket - len(batch))
        if self.tracer is not None:
            for r in batch:
                self.tracer.observe(f"{self.name}:queue_delay",
                                    (now - r.t_arrival) * 1e9)
        if _obs_spans.ENABLED:
            t_wall = time.time_ns()
            for r in batch:
                if r.ctx is not None:
                    wait = int((now - r.t_arrival) * 1e9)
                    _obs_spans.record_span(f"{self.name}:queue_wait",
                                           "queue", t_wall - wait, wait,
                                           r.ctx)
                    r.ctx.q_ns += wait
        return batch, bucket, stack_requests(batch, bucket)

    def complete(self, batch: List[Request], outputs: Sequence[Any]) -> None:
        """Demux: row ``i`` of every output tensor goes back to the
        request that contributed input row ``i`` (padded rows have no
        request and are dropped). A failing per-row callback (its client
        died mid-reply) must not starve the other rows of the batch."""
        now = time.monotonic()
        # ONE batched D2H for every card output (host data passes
        # through) — a per-tensor .cpu() here would block once a tensor
        hosts = fetch_host(outputs)
        for i, req in enumerate(batch):
            row = [row_of(h, i) if h.ndim >= 1
                   and h.shape[0] >= len(batch) else h for h in hosts]
            if req.t_batched is not None:
                lat_ns = (now - req.t_batched) * 1e9
                with self._mlock:
                    self._batch_latency.add(lat_ns)
                if self.tracer is not None:
                    self.tracer.observe(f"{self.name}:batch_latency", lat_ns)
                if _obs_spans.ENABLED and req.ctx is not None:
                    dur = int(lat_ns)
                    _obs_spans.record_span(f"{self.name}:batch", "compute",
                                           time.time_ns() - dur, dur, req.ctx)
                    req.ctx.c_ns += dur
            if req.on_result is None:
                continue
            try:
                req.on_result(req, row)
            except Exception:  # noqa: BLE001 — one dead client, not a batch
                with self._mlock:
                    self.stats.inc("result_errors")
                logger.warning("%s: result callback failed for stream %s",
                               self.name, req.stream_id, exc_info=True)
        with self._mlock:
            self.stats.inc("completed", len(batch))

    # -- metrics -----------------------------------------------------------
    def occupancy(self) -> Dict[str, Any]:
        """O(1) load snapshot for fleet routing: queue depth + active
        streams (batcher), rolling bucket occupancy, and the queue-delay
        p50. Cheap enough to piggyback on every PONG heartbeat reply
        and on the broker REGISTER advertisement."""
        b = self.batcher.occupancy()
        with self._mlock:
            s = self.stats.snapshot()
            qd = self._queue_delay.percentiles()
        filled = s["bucket_rows"] - s["rows_padded"]
        return {"depth": b["depth"], "streams": b["streams"],
                "occupancy_avg": round(filled / s["bucket_rows"], 4)
                if s["bucket_rows"] else 0.0,
                "queue_delay_us_p50": round(qd["p50"] / 1e3, 1),
                # the tail the autoscaler's control law acts on (its
                # target is a p95, not a median)
                "queue_delay_us_p95": round(qd["p95"] / 1e3, 1)}

    def report(self) -> Dict[str, Any]:
        """Occupancy, queue delay and batch latency percentiles, shed
        counts — the per-batch observability the serving stack promises (also mirrored into an attached Tracer)."""
        b = self.batcher.stats.snapshot()
        with self._mlock:
            s = self.stats.snapshot()
            qd = self._queue_delay.percentiles()
            bl = self._batch_latency.percentiles()
        filled = s["bucket_rows"] - s["rows_padded"]
        return {
            "batches": b["batches"],
            "requests": b["submitted"],
            "completed": s["completed"],
            "shed_admission": b["shed_admission"],
            "shed_deadline": b["shed_deadline"],
            "cancelled": b["cancelled"],
            "shed_failed": s["shed_failed"],
            "result_errors": s["result_errors"],
            "invoke_errors": s["invoke_errors"],
            "occupancy_avg": (filled / s["bucket_rows"]
                              if s["bucket_rows"] else 0.0),
            "queue_delay_us": {k: v / 1e3 for k, v in qd.items()},
            "batch_latency_us": {k: v / 1e3 for k, v in bl.items()},
        }

    # -- standalone worker mode --------------------------------------------
    def start(self) -> None:
        """Spawn the worker loop (standalone embedding only: requires
        ``invoke_fn``). Pipeline elements drive next_batch/complete
        themselves and never call this."""
        if self._invoke_fn is None:
            raise ValueError(f"{self.name}: start() needs an invoke_fn")
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._worker,
                                        name=f"serve:{self.name}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
            self._thread = None

    def _worker(self) -> None:
        while not self._stop_evt.is_set():
            nb = self.next_batch(self._stop_evt)
            if nb is None:
                return
            batch, _bucket, stacked = nb
            try:
                outputs = self._invoke_fn(stacked)
            except Exception as exc:  # noqa: BLE001 — shed the batch, keep serving
                with self._mlock:
                    self.stats.inc("invoke_errors")
                    # the batch's rows left the queue but will never
                    # complete(): count their terminal event so the
                    # settlement identity balances
                    self.stats.inc("shed_failed", len(batch))
                logger.warning("%s: invoke failed (%r), batch of %d shed",
                               self.name, exc, len(batch), exc_info=True)
                _obs_events.emit("shed", source=self.name, reason="invoke",
                                 frames=len(batch))
                for r in batch:
                    if r.on_shed is not None:
                        r.on_shed(r)
                continue
            self.complete(batch, outputs)
