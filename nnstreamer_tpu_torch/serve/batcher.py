"""Dynamic-batching core: coalesce concurrent request streams into
bucketed batches for the card.

Port of ``nnstreamer_tpu/serve/batcher.py``: host arrays only, a close
copy without the checkpoint ledger (``ledger``; ROADMAP item 11). Host
arrays are numpy, but bfloat16, which numpy lacks, arrives from the
wire as a CPU tensor and is stacked as one. Three invariants drive the design:

* **Bucketed sizes.** A batch is always padded up to one of a small set
  of ``buckets`` (e.g. 1/2/4/8), so the downstream filter sees at most
  ``len(buckets)`` input signatures instead of one per occupancy — on
  the card each signature is one captured CUDA graph, and a padded row
  is cheap next to a capture.
* **Max-wait deadline.** A lone request never stalls waiting for
  companions: the oldest queued request bounds how long a partial batch
  may wait before it flushes at whatever occupancy it reached.
* **Bounded admission.** Each stream owns a bounded queue slot budget;
  a stream that outruns the card is shed at submit time (retry-after
  backpressure) instead of growing an unbounded backlog, and a request
  whose deadline expired before batching is shed rather than invoked.

:func:`stack_requests` pads on the host, so a batch reaches the card in
one host-to-device copy a tensor (the filter stages it into the graph's
static input).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import events as _obs_events
from ..utils.atomic import Counters


class Request:
    """One in-flight inference request with its reply route.

    The object itself is the correlation id inside the process (batch
    rows carry the ``Request``); ``stream_id``/``seq`` are the wire-level
    correlation echoed back to remote clients.
    """

    __slots__ = ("stream_id", "seq", "arrays", "pts", "deadline",
                 "on_result", "on_shed", "t_arrival", "t_batched", "ctx")

    def __init__(self, stream_id: Any, arrays: Sequence[Any], *,
                 seq: Optional[int] = None, pts: Optional[int] = None,
                 deadline: Optional[float] = None,
                 on_result: Optional[Callable] = None,
                 on_shed: Optional[Callable] = None,
                 ctx: Optional[Any] = None):
        self.stream_id = stream_id
        # host numpy; bfloat16 (numpy has none) stays a CPU tensor
        self.arrays = [a if isinstance(a, torch.Tensor) else np.asarray(a)
                       for a in arrays]
        self.seq = seq
        self.pts = pts
        self.deadline = deadline          # absolute monotonic, None = none
        self.on_result = on_result        # (request, [row arrays]) -> None
        self.on_shed = on_shed            # (request) -> None
        self.t_arrival = time.monotonic()
        self.t_batched: Optional[float] = None
        self.ctx = ctx                    # obs TraceContext riding the frame

    def signature(self):
        return tuple((tuple(a.shape), str(a.dtype)) for a in self.arrays)


def stack_rows(values: Sequence[Any]) -> Any:
    """Stack host values on a new leading dim: ndarrays, or CPU tensors
    (bfloat16)."""
    if isinstance(values[0], torch.Tensor):
        return torch.stack(list(values))
    return np.stack(values)


def row_of(value: Any, i: int) -> Any:
    """Row ``i`` of a stacked host value, contiguous."""
    if isinstance(value, torch.Tensor):
        return value[i].contiguous()
    return np.ascontiguousarray(value[i])


def stack_requests(requests: List[Request], bucket: int) -> List[Any]:
    """Stack request tensors into leading-dim-``bucket`` arrays, padding
    short batches by repeating the last row (one signature, hence one
    captured graph, per bucket)."""
    rows = requests + [requests[-1]] * (bucket - len(requests))
    return [stack_rows([r.arrays[j] for r in rows])
            for j in range(len(requests[0].arrays))]


class BucketBatcher:
    """Coalesces submitted requests into stackable, bucketed batches.

    Thread-safe: any number of producers call :meth:`submit`; one
    consumer (the serving loop) calls :meth:`next_batch`. Shed callbacks
    fire outside the lock.
    """

    def __init__(self, buckets: Sequence[int] = (1, 2, 4, 8),
                 max_wait_s: float = 0.005, max_queue: int = 16,
                 snap_multiple: int = 1):
        # every bucket snaps UP to a multiple of ``snap_multiple`` (the
        # reference's mesh data-parallel degree; the port's serve src
        # refuses a mesh, so it passes 1). Snapping can only merge
        # buckets (1,2,4,8 @ 4 -> 4,8); padded rows are accounted
        # exactly as before (bucket - len(batch)).
        snap = max(1, int(snap_multiple))
        buckets = sorted({-(-int(b) // snap) * snap
                          for b in buckets if int(b) > 0})
        if not buckets:
            raise ValueError("buckets must name at least one positive size")
        self.buckets = buckets
        self.snap_multiple = snap
        self.max_wait_s = max(0.0, float(max_wait_s))
        self.max_queue = max(1, int(max_queue))
        self._cond = threading.Condition()
        self._fifo: Deque[Request] = deque()
        self._per_stream: Dict[Any, int] = {}
        self._draining = False
        self.stats = Counters(submitted=0, batches=0, shed_admission=0,
                              shed_deadline=0, cancelled=0)

    # -- producers ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit a request; False = shed at admission (the stream's queue
        budget is exhausted — backpressure, the caller owes the client a
        retry-after). The shed callback is NOT invoked here so the caller
        can decide how to answer."""
        with self._cond:
            if self._draining:
                # admission is closed: everything already queued will
                # flush, but new work is shed (retry elsewhere/later)
                self.stats.inc("shed_admission")
                return False
            n = self._per_stream.get(req.stream_id, 0)
            if n >= self.max_queue:
                self.stats.inc("shed_admission")
                return False
            self._per_stream[req.stream_id] = n + 1
            self._fifo.append(req)
            self.stats.inc("submitted")
            self._cond.notify_all()
        return True

    def drain(self) -> None:
        """Enter drain: stop admitting, flush what is queued. From here
        :meth:`submit` sheds everything, partial batches flush without
        waiting out max-wait, and :meth:`next_batch` returns None once
        the FIFO is empty — the consumer's EOS barrier."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    def cancel_stream(self, stream_id: Any) -> int:
        """Reclaim every queued slot of a dead stream (client disconnect
        mid-request must not wedge the batcher or leak its slots)."""
        with self._cond:
            kept = [r for r in self._fifo if r.stream_id != stream_id]
            n = len(self._fifo) - len(kept)
            self._fifo = deque(kept)
            self._per_stream.pop(stream_id, None)
            self.stats.inc("cancelled", n)
        return n

    def cancel_requests(self, reqs: Sequence[Request]) -> int:
        """Remove specific still-queued requests (identity match — the
        Request object IS the in-process correlation id). Used by the
        ROI gate to reclaim a shed frame's sibling crops; each removal
        counts as ``cancelled`` so the frame's settlement stays exact.
        Requests already popped into a batch are not cancellable."""
        with self._cond:
            drop = {id(r) for r in reqs}
            removed = [r for r in self._fifo if id(r) in drop]
            if not removed:
                return 0
            self._fifo = deque(r for r in self._fifo
                               if id(r) not in drop)
            for r in removed:
                n = self._per_stream.get(r.stream_id, 1) - 1
                if n <= 0:
                    self._per_stream.pop(r.stream_id, None)
                else:
                    self._per_stream[r.stream_id] = n
            self.stats.inc("cancelled", len(removed))
        return len(removed)

    def depth(self, stream_id: Any = None) -> int:
        with self._cond:
            if stream_id is None:
                return len(self._fifo)
            return self._per_stream.get(stream_id, 0)

    def occupancy(self) -> Dict[str, int]:
        """One consistent (depth, active streams) snapshot — the
        batcher's half of the fleet router's load report (two depth()
        calls could tear across a batch pop)."""
        with self._cond:
            return {"depth": len(self._fifo),
                    "streams": len(self._per_stream)}

    # -- the consumer ------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the largest bucket caps a run)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def next_batch(self, stop: Optional[threading.Event] = None,
                   poll_s: float = 0.05) -> Optional[List[Request]]:
        """Block until a batch is ready: the largest bucket fills with
        stackable requests, or the oldest request's max-wait expires.
        Expired-deadline requests are shed here (callbacks fire after the
        lock drops). Returns None when ``stop`` is set."""
        shed: List[Request] = []
        try:
            with self._cond:
                while True:
                    if stop is not None and stop.is_set():
                        return None
                    now = time.monotonic()
                    self._shed_expired_locked(now, shed)
                    if not self._fifo:
                        if self._draining:
                            return None  # drained dry: the EOS barrier
                        self._cond.wait(timeout=poll_s)
                        continue
                    head = self._fifo[0]
                    run = self._stackable_run(self.buckets[-1])
                    flush_at = head.t_arrival + self.max_wait_s
                    if run >= self.buckets[-1] or now >= flush_at \
                            or self._draining:
                        batch = [self._fifo.popleft() for _ in range(run)]
                        for r in batch:
                            n = self._per_stream.get(r.stream_id, 1) - 1
                            if n <= 0:
                                self._per_stream.pop(r.stream_id, None)
                            else:
                                self._per_stream[r.stream_id] = n
                            r.t_batched = now
                        self.stats.inc("batches")
                        return batch
                    timeout = flush_at - now
                    nearest = min((r.deadline for r in self._fifo
                                   if r.deadline is not None), default=None)
                    if nearest is not None:
                        timeout = min(timeout, nearest - now)
                    self._cond.wait(timeout=max(0.0, min(timeout, poll_s)))
        finally:
            if shed:
                _obs_events.emit("shed", source="batcher",
                                 reason="deadline", frames=len(shed))
            for r in shed:
                if r.on_shed is not None:
                    r.on_shed(r)

    def _shed_expired_locked(self, now: float, out: List[Request]) -> None:
        if not any(r.deadline is not None and now >= r.deadline
                   for r in self._fifo):
            return
        kept: List[Request] = []
        for r in self._fifo:
            if r.deadline is not None and now >= r.deadline:
                out.append(r)
                n = self._per_stream.get(r.stream_id, 1) - 1
                if n <= 0:
                    self._per_stream.pop(r.stream_id, None)
                else:
                    self._per_stream[r.stream_id] = n
            else:
                kept.append(r)
        self._fifo = deque(kept)
        self.stats.inc("shed_deadline", len(out))

    def _stackable_run(self, cap: int) -> int:
        """Length of the stackable run at the head of the FIFO: requests
        with a different tensor signature stay queued and open the NEXT
        batch (heterogeneous clients work, they just don't share one)."""
        head_sig = self._fifo[0].signature()
        run = 1
        for r in itertools.islice(self._fifo, 1, None):
            if run >= cap or r.signature() != head_sig:
                break
            run += 1
        return run
