"""K-frame in-flight invoke window: dispatcher/completer split.

Port of ``nnstreamer_tpu/elements/overlap.py``, with its dispatch and
complete spans (host clocks). The synchronous chain path pays H2D +
invoke + D2H serially per frame; the backend's ``dispatch`` only
enqueues the frame's graph on the card and records an event, so the fix
is to stop blocking the chain thread on completion:

  * the **dispatcher** (the element's chain thread) acquires a slot in
    the per-link :class:`~..tensors.transfer.InFlightWindow` (blocking
    = backpressure into the upstream queue), dispatches the frame's
    device program, and hands the in-flight entry to the executor;
  * the **completer** (one daemon thread per element) materializes each
    frame's results in dispatch order, runs the element's completion
    callback (latency/breaker/watchdog accounting + downstream
    ``push``), and releases the window slot.

Ordering: the completer consumes the FIFO in dispatch order, so
completions are in-order by construction; the :class:`ReorderBuffer` it
feeds enforces the PTS contract anyway — it restores order if driven
out of order, advances past error gaps, and gives up on a missing frame
only after a bounded stall deadline (so one wedged completion cannot
dam the pipeline forever). PTS regressions at the release point are
counted, never silently passed through.

Error accounting under overlap: a frame that fails at completion is
settled by the element's error callback on the completer thread —
breaker failure, ``invoke_errors``, serve-row shedding — so the
zero-loss identity (frames in == pushed + dropped + shed) holds
per-frame even though the chain thread returned long ago.

Concurrency (racecheck: DISPATCHER submits, COMPLETER drains): every
mutable field is written only under ``_cv``; completion callbacks and
window release run outside it so the lock never covers a blocking
device wait.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import context as _obs_ctx
from ..obs import spans as _obs_spans
from ..tensors.transfer import InFlightWindow

log = logging.getLogger(__name__)

# sentinel for a sequence number that completed with no frame to emit
# (error path): the reorder buffer advances past it without releasing
_SKIP = object()


class _InFlight:
    """One dispatched frame awaiting completion."""

    __slots__ = ("seq", "buf", "payload", "t_dispatch_ns")

    def __init__(self, seq: int, buf, payload, t_dispatch_ns: int):
        self.seq = seq
        self.buf = buf
        self.payload = payload          # framework dispatch handle
        self.t_dispatch_ns = t_dispatch_ns


class ReorderBuffer:
    """Bounded PTS-order restorer with a stall deadline.

    Single-threaded by contract: only the completer touches it (the
    unit tests drive it directly, out of order, to pin the semantics).
    ``push``/``skip`` return the frames that became releasable, already
    in sequence order; ``poll`` handles the pathological case where a
    sequence number never arrives at all — after ``deadline_s`` of
    head-of-line blocking it abandons the missing frame (counted in
    ``stalls``) and releases what it holds.
    """

    def __init__(self, deadline_s: float = 1.0):
        self.deadline_s = max(0.0, float(deadline_s))
        self._next = 0                   # next seq eligible for release
        self._held: Dict[int, Tuple[Any, float]] = {}
        self._last_pts: Optional[int] = None
        self.released = 0
        self.skipped = 0
        self.stalls = 0
        self.pts_regressions = 0

    def __len__(self) -> int:
        return len(self._held)

    def push(self, seq: int, item: Any, now: Optional[float] = None
             ) -> List[Any]:
        self._held[seq] = (item, time.monotonic() if now is None else now)
        return self._drain()

    def skip(self, seq: int, now: Optional[float] = None) -> List[Any]:
        """Mark ``seq`` settled with nothing to emit (errored/dropped
        frame): later frames must not wait for it."""
        self._held[seq] = (_SKIP, time.monotonic() if now is None else now)
        return self._drain()

    def poll(self, now: Optional[float] = None) -> List[Any]:
        """Stall-deadline escape hatch: if the head-of-line seq is
        missing and the oldest held frame has waited past the deadline,
        abandon the gap and release from the oldest held seq on."""
        if not self._held or self._next in self._held:
            return self._drain()
        now = time.monotonic() if now is None else now
        oldest = min(self._held)
        if now - self._held[oldest][1] < self.deadline_s:
            return []
        self.stalls += 1
        log.warning("reorder stall: seq %d..%d never completed; "
                    "advancing past the gap", self._next, oldest - 1)
        self._next = oldest
        return self._drain()

    def flush(self) -> List[Any]:
        """Release everything held, in sequence order, gaps or not."""
        out: List[Any] = []
        for seq in sorted(self._held):
            if seq > self._next:
                self.stalls += 1
            item, _ = self._held.pop(seq)
            self._next = seq + 1
            if item is not _SKIP:
                out.append(self._release(item))
        return out

    def _drain(self) -> List[Any]:
        out: List[Any] = []
        while self._next in self._held:
            item, _ = self._held.pop(self._next)
            self._next += 1
            if item is _SKIP:
                self.skipped += 1
            else:
                out.append(self._release(item))
        return out

    def _release(self, item: Any) -> Any:
        pts = getattr(item, "pts", None)
        if pts is not None and self._last_pts is not None \
                and pts < self._last_pts:
            self.pts_regressions += 1
        if pts is not None:
            self._last_pts = pts
        self.released += 1
        return item


class OverlapExecutor:
    """The per-element dispatcher/completer pair around a window.

    ``submit`` runs on the element's chain thread (DISPATCHER role) and
    blocks only when the window is full; ``_complete_loop`` runs on a
    dedicated daemon thread (COMPLETER role), settles frames in FIFO
    order through ``complete_cb`` (success → buffer to push) or
    ``error_cb`` (frame accounted dropped), pushes releasable frames
    downstream via ``push_cb``, and frees the window slot.
    """

    def __init__(self, limit: int,
                 complete_cb: Callable[[_InFlight], Any],
                 error_cb: Callable[[_InFlight, BaseException], None],
                 push_cb: Callable[[Any], None],
                 name: str = "overlap",
                 reorder: bool = True,
                 reorder_deadline_s: float = 1.0,
                 devices: int = 1):
        # the window budget is per dispatch, not per card: one
        # dispatched frame occupies one slot however many cards its
        # program spans (``devices`` is reporting-only)
        self.window = InFlightWindow(limit, devices=devices)
        self._complete_cb = complete_cb
        self._error_cb = error_cb
        self._push_cb = push_cb
        self._name = name
        # completer-thread-only state: the FIFO entries move to the
        # reorder buffer under the completer role alone, so it needs no
        # lock of its own (pinned by the runtime lock validator test)
        self._reorder = ReorderBuffer(reorder_deadline_s) if reorder \
            else None
        self._cv = threading.Condition()
        self._q: "deque[_InFlight]" = deque()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._seq = 0
        self._completed = 0
        self._errors = 0
        self._push_errors = 0

    # ---- dispatcher side (chain thread) --------------------------------

    def submit(self, buf, payload, t_dispatch_ns: int) -> None:
        """Hand a dispatched frame to the completer. The caller must
        already hold a window slot (``window.acquire()``) — the element
        acquires BEFORE dispatching so backpressure lands before device
        work is queued, and passes the returned timestamp here."""
        if _obs_spans.ENABLED:
            # harness stubs may hand the executor bare objects; only
            # real Buffers carry the extras dict a context rides in
            extras = getattr(buf, "extras", None)
            ctx = extras.get(_obs_ctx.CTX_KEY) if extras is not None \
                else None
            if ctx is not None:
                _obs_spans.record_span(f"{self._name}:dispatch", "dispatch",
                                       time.time_ns(), 0, ctx)
        with self._cv:
            self._ensure_thread()
            entry = _InFlight(self._seq, buf, payload, t_dispatch_ns)
            self._seq += 1
            self._q.append(entry)
            self._cv.notify_all()

    def flush(self, timeout: float = 30.0) -> bool:
        """Barrier: wait until every submitted frame has been settled
        and pushed. Events and EOS must not overtake in-flight frames —
        the element calls this before forwarding any serialized event."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._q:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(min(left, 1.0)):
                    if deadline - time.monotonic() <= 0:
                        log.warning("%s: flush timed out with %d frames "
                                    "queued", self._name, len(self._q))
                        return False
        ok = self.window.wait_idle(max(0.0, deadline - time.monotonic()))
        if not ok:
            log.warning("%s: flush timed out waiting for window idle",
                        self._name)
        return ok

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=10.0)

    # ---- completer side ------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stopping = False
            self._thread = threading.Thread(
                target=self._complete_loop,
                name=f"nns-complete-{self._name}", daemon=True)
            self._thread.start()

    def _complete_loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopping:
                    self._cv.wait(0.25)
                if not self._q:
                    if self._stopping:
                        return
                    continue
                entry = self._q.popleft()  # flow: owns(window-slot)
            # settle the frame OUTSIDE the lock: completion is a device
            # wait (racecheck: blocking call must not run under _cv)
            n_err = 0
            n_push_err = 0
            try:
                outbuf: Any = None
                err: Optional[BaseException] = None
                t_wall = time.time_ns() if _obs_spans.ENABLED else 0
                try:
                    outbuf = self._complete_cb(entry)
                except BaseException as exc:  # noqa: BLE001 — accounted
                    err = exc
                if t_wall:
                    extras = getattr(entry.buf, "extras", None)
                    ctx = extras.get(_obs_ctx.CTX_KEY) \
                        if extras is not None else None
                    if ctx is not None:
                        dur = time.time_ns() - t_wall
                        _obs_spans.record_span(f"{self._name}:complete",
                                               "complete", t_wall, dur,
                                               ctx)
                        ctx.c_ns += dur
                if err is None:
                    ready = ([outbuf] if self._reorder is None
                             else self._reorder.push(entry.seq, outbuf))
                else:
                    try:
                        self._error_cb(entry, err)
                    except Exception:  # noqa: BLE001 — never kill loop
                        log.exception("%s: error callback failed",
                                      self._name)
                    ready = ([] if self._reorder is None
                             else self._reorder.skip(entry.seq))
                if self._reorder is not None:
                    ready.extend(self._reorder.poll())
                n_err = 1 if err is not None else 0
                for out in ready:
                    try:
                        self._push_cb(out)
                    except Exception:  # noqa: BLE001 — downstream
                        # failure must not wedge the window: count and
                        # keep going
                        n_push_err += 1
                        log.exception("%s: downstream push failed for a "
                                      "completed frame", self._name)
            finally:
                # release in a finally: if the reorder buffer or an
                # error callback raises, a skipped release would strand
                # the slot and permanently shrink the window (the next
                # submit restarts the thread, but the depth is gone)
                self.window.release(entry.t_dispatch_ns)
            with self._cv:
                self._completed += 1 - n_err
                self._errors += n_err
                self._push_errors += n_push_err
                self._cv.notify_all()

    # ---- reporting -----------------------------------------------------

    def report(self) -> Dict[str, Any]:
        out = self.window.report()
        with self._cv:
            out.update(completed=self._completed, errors=self._errors,
                       queued=len(self._q))
            if self._push_errors:
                out["push_errors"] = self._push_errors
        rb = self._reorder
        if rb is not None:
            out["reorder"] = {"released": rb.released,
                              "skipped": rb.skipped,
                              "stalls": rb.stalls,
                              "pts_regressions": rb.pts_regressions,
                              "held": len(rb)}
        return out
