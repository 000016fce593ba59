"""Pipeline container, bus, and state management.

Port of ``nnstreamer_tpu/pipeline/pipeline.py`` (the analog of GstPipeline
+ GstBus): owns elements, drives start/stop, aggregates sink EOS into a
pipeline-level EOS message, and carries error/latency messages
out-of-band.

``Pipeline.start`` runs the fusion planner first (``fuse``, default
True, as in the JAX package): maximal runs of device-capable elements
become one :class:`~..fusion.FusedSegment` each. ``fuse=false`` (a
leading launch-line property) or ``pipeline.fuse = False`` opts out.
``enable_tracing()`` attaches the tracer (utils/trace.py). Before that,
``Pipeline.start`` validates the graph (``validate_on_start``, default
True): pipelint's error findings raise
:class:`~..analysis.PipelineValidationError` before any element starts,
so no model is loaded and nothing is allocated on the card; warnings
are logged. ``Pipeline.drain`` is the graceful teardown: every element's
``drain`` hook, then EOS through the queues behind the sources' drain
barrier, then ``stop``. ``Pipeline.snapshot``/``restore``/``preempt``
are the checkpoint layer (checkpoint/): every element overriding
``snapshot_state`` is written into a crash-consistent snapshot, restored
before ``start``, and a preemption quiesces, drains what its grace
allows, snapshots and stops, declaring what it abandoned.

The telemetry plane (obs/): ``start`` registers the pipeline with
obs/metrics.py and ``stop`` unregisters it, so a scrape renders its
element counters; the first error of a run emits an ``abort`` event and
dumps the flight recorder (rate-limited), and ``preempt`` dumps it
unconditionally.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils.log import logger
from .element import Element, SinkElement, SrcElement
from .pad import PadDirection


@dataclass
class Message:
    kind: str                    # "eos" | "error" | "latency" | element-custom
    data: Dict[str, Any] = field(default_factory=dict)


class Bus:
    def __init__(self):
        self._q: _queue.Queue = _queue.Queue()

    def post(self, msg: Message) -> None:
        self._q.put(msg)

    def pop(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def drain(self) -> List[Message]:
        """Every message posted so far, without waiting."""
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except _queue.Empty:
                return out


class Pipeline:
    def __init__(self, name: str = "pipeline0"):
        self.name = name
        self.elements: Dict[str, Element] = {}
        self.bus = Bus()
        self._sinks_eos: set = set()
        self._eos_evt = threading.Event()
        self._error: Optional[Exception] = None
        self._lock = threading.Lock()
        self.running = False
        self.tracer = None  # set by enable_tracing()
        # pre-PLAYING static validation gate (pipelint); set False to
        # launch a pipeline the analyzer rejects (escape hatch)
        self.validate_on_start = True
        # fusion (fusion/): device-capable runs are collapsed into
        # FusedSegments at start. ``fuse=false`` as a pipeline-level
        # launch prop, or this attribute, opts out
        self.fuse = True
        self._fusion_plan = None

    def enable_tracing(self):
        """Attach a Tracer (≙ GstShark proctime/interlatency/framerate
        tracers); returns it for ``report()``."""
        from ..utils.trace import Tracer
        self.tracer = Tracer()
        return self.tracer

    # -- graph construction ----------------------------------------------
    def add(self, *elements: Element) -> "Pipeline":
        for e in elements:
            if e.name in self.elements:
                raise ValueError(f"duplicate element name {e.name!r}")
            self.elements[e.name] = e
            e.pipeline = self
        return self

    def link(self, *elements: Element) -> "Pipeline":
        """Link a chain of elements src->sink, requesting pads as needed."""
        for up, down in zip(elements, elements[1:]):
            srcpad = next(
                (p for p in up.src_pads.values() if not p.is_linked), None)
            if srcpad is None:
                srcpad = up.request_pad(PadDirection.SRC)
            sinkpad = next(
                (p for p in down.sink_pads.values() if not p.is_linked), None)
            if sinkpad is None:
                sinkpad = down.request_pad(PadDirection.SINK)
            srcpad.link(sinkpad)
        return self

    def __getitem__(self, name: str) -> Element:
        return self.elements[name]

    # -- messages ---------------------------------------------------------
    def post_message(self, kind: str, **data) -> None:
        if kind == "error":
            first = False
            with self._lock:
                if self._error is None:
                    self._error = data.get("error")
                    first = True
            self._eos_evt.set()  # unblock waiters
            if first:
                # black-box: any abort records the event and dumps the
                # last-N-seconds flight recording (rate-limited)
                from ..obs import events as _obs_events
                from ..obs.recorder import RECORDER
                _obs_events.emit("abort", source=self.name, level=10,
                                 error=repr(data.get("error")))
                RECORDER.dump_abort(f"{self.name}-abort")
        self.bus.post(Message(kind, data))

    def _sink_eos(self, sink: Element) -> None:
        with self._lock:
            self._sinks_eos.add(sink.name)
            sinks = [e for e in self.elements.values()
                     if isinstance(e, SinkElement)
                     and any(p.is_linked for p in e.sink_pads.values())]
            done = all(s.name in self._sinks_eos for s in sinks)
        if done:
            self.post_message("eos")
            self._eos_evt.set()

    # -- static analysis ---------------------------------------------------
    def validate(self):
        """Run pipelint (caps/shape inference + graph rules) over the
        unstarted graph; returns the :class:`analysis.Report`."""
        from ..analysis import analyze
        return analyze(self)

    # -- state ------------------------------------------------------------
    def start(self) -> "Pipeline":
        """READY->PLAYING: start non-sources first, then source threads.
        Every element checks its properties first, so a property the port
        does not implement raises before any thread starts; then the
        graph is validated (``validate_on_start``): error findings raise
        :class:`PipelineValidationError`, warnings are logged; then the
        fusion planner runs (once: the plan is sticky across restarts)."""
        for e in self.elements.values():
            e.check_ported()
        if self.validate_on_start:
            from ..analysis import PipelineValidationError
            report = self.validate()
            if report.errors:
                raise PipelineValidationError(report)
            for f in report.warnings:
                logger.warning("pipelint: %s", f)
        if self.fuse and self._fusion_plan is None:
            from ..fusion import fuse_pipeline
            try:
                self._fusion_plan = fuse_pipeline(self)
            except Exception:  # noqa: BLE001 -- never block launch on fusion
                logger.warning(
                    "fusion: planner failed; running unfused", exc_info=True)
        self._sinks_eos.clear()
        self._eos_evt.clear()
        self._error = None
        srcs = []
        for e in self.elements.values():
            if isinstance(e, SrcElement):
                srcs.append(e)
            else:
                e.start()
        for e in srcs:
            e.start()
        self.running = True
        from ..obs import metrics as _obs_metrics
        _obs_metrics.register_pipeline(self)
        return self

    def stop(self) -> "Pipeline":
        for e in self.elements.values():
            if isinstance(e, SrcElement):
                e.stop()
        for e in self.elements.values():
            if not isinstance(e, SrcElement):
                e.stop()
        for e in self.elements.values():
            e.teardown()
        self.running = False
        from ..obs import metrics as _obs_metrics
        _obs_metrics.unregister_pipeline(self)
        return self

    def drain(self, deadline: float = 10.0) -> bool:
        """Graceful teardown (vs ``stop()``'s hard cut): ask every
        element to stop admitting new work, flush everything already in
        flight through queues and the serve batcher behind the EOS
        barrier, settle pending client correlations, then stop. Returns
        True when EOS reached every sink inside ``deadline`` seconds —
        False means the flush timed out and stop() cut it short.

        Safe to call twice; a drain of a never-started pipeline just
        stops it."""
        t0 = time.monotonic()
        from ..obs import events as _obs_events
        _obs_events.emit("drain", source=self.name, level=20,
                         deadline_s=float(deadline))
        self.post_message("drain", deadline=deadline)
        for e in self.elements.values():
            try:
                e.drain()
            except Exception:  # noqa: BLE001 — drain is best-effort per element
                logger.warning("%s: drain hook failed", e.name,
                               exc_info=True)
        ok = False
        try:
            remaining = max(0.0, deadline - (time.monotonic() - t0))
            ok = bool(self._eos_evt.wait(remaining)) \
                and self._error is None
        finally:
            self.stop()
        return ok

    # -- checkpoint/restore (checkpoint/) ----------------------------------
    def checkpointables(self) -> List[Element]:
        """Elements overriding :meth:`Element.snapshot_state` — the set
        Pipeline.snapshot collects from and Pipeline.restore feeds."""
        return [e for e in self.elements.values()
                if type(e).snapshot_state is not Element.snapshot_state]

    def snapshot(self, directory: str, retain: int = 3,
                 meta: Optional[Dict] = None) -> str:
        """Write one crash-consistent snapshot of every checkpointable
        element into the retain-N store at ``directory`` and return the
        published snapshot path. The pipeline must be quiesced (drained
        or preempted) first — element snapshot hooks read live state.
        A hook that raises aborts the snapshot, and nothing is
        published.

        Layout and integrity rules: checkpoint/store.py."""
        import os
        import pickle
        from ..checkpoint.store import SnapshotStore

        def writer(tmp: str) -> None:
            edir = os.path.join(tmp, "elements")
            os.makedirs(edir)
            for e in self.checkpointables():
                sdir = os.path.join(edir, f"{e.name}.d")
                os.makedirs(sdir)
                state = e.snapshot_state(sdir)
                if not os.listdir(sdir):
                    os.rmdir(sdir)
                if state is None:
                    continue
                with open(os.path.join(edir, f"{e.name}.blob"), "wb") as f:
                    f.write(pickle.dumps(state, protocol=4))

        full_meta = dict(meta or {})
        full_meta.setdefault("pipeline", self.name)
        full_meta.setdefault("elements", {
            e.name: type(e).__name__ for e in self.checkpointables()})
        return SnapshotStore(directory, retain=retain).save(
            writer, meta=full_meta)

    def restore(self, directory: str) -> Dict:
        """Rebuild element state from a snapshot BEFORE ``start()``.
        ``directory`` is either a store root (latest snapshot wins) or
        one ``snap-*`` directory. The snapshot is verified first — a
        truncated blob or tampered manifest raises
        :class:`~..checkpoint.store.SnapshotError` naming the bad blob,
        and NO element state is touched (never a silent partial
        restore). Returns the snapshot's meta dict."""
        import os
        import pickle
        from ..checkpoint.store import (MANIFEST, SnapshotError,
                                        SnapshotStore)
        if self.running:
            raise RuntimeError(
                f"{self.name}: restore() must run before start()")
        snap = directory
        if not os.path.exists(os.path.join(snap, MANIFEST)):
            snap = SnapshotStore(directory).latest()
            if snap is None:
                raise SnapshotError(
                    f"no snapshot found under {directory!r}")
        manifest = SnapshotStore.verify(snap)
        edir = os.path.join(snap, "elements")
        for e in self.checkpointables():
            blob = os.path.join(edir, f"{e.name}.blob")
            if not os.path.exists(blob):
                continue  # element had no state at snapshot time
            with open(blob, "rb") as f:
                state = pickle.loads(f.read())  # noqa: S301 — verified snapshot this program wrote
            e.restore_state(state, os.path.join(edir, f"{e.name}.d"))
        logger.info("%s: restored from %s (seq %s)", self.name, snap,
                    manifest.get("seq"))
        return manifest.get("meta", {})

    def preempt(self, grace_s: float, directory: str,
                retain: int = 3) -> Dict:
        """Preemption sequence: quiesce → bounded drain → snapshot →
        stop, all inside ``grace_s`` seconds.

        Every element's :meth:`~Element.preempt` hook runs first (cheap,
        non-blocking: stop admission, pause the trainer). If the
        remaining grace — minus a reserve for writing the snapshot —
        allows, the pipeline waits for EOS to reach the sinks (a full
        drain). Otherwise it degrades: the snapshot is taken WITHOUT
        drain and every element's :meth:`~Element.preempt_inflight`
        count is recorded as explicitly abandoned — declared in the
        report, the snapshot meta, and each element's
        ``preempt_abandoned`` counter, never silent.

        Returns ``{"snapshot", "drained", "abandoned", "grace_s",
        "used_s"}``."""
        t0 = time.monotonic()
        from ..obs import events as _obs_events
        from ..obs.recorder import RECORDER
        _obs_events.emit("preempt", source=self.name,
                         grace_s=float(grace_s))
        # the black-box dump is deliberate here (force past the abort
        # rate limit): a preemption is the canonical "what was the
        # fleet doing in its last seconds" question
        RECORDER.dump_abort(f"{self.name}-preempt", force=True)
        self.post_message("preempt", grace_s=grace_s)
        for e in self.elements.values():
            try:
                e.preempt()
            except Exception:  # noqa: BLE001 — quiesce is best-effort per element
                logger.warning("%s: preempt hook failed", e.name,
                               exc_info=True)
        # reserve a slice of the grace budget for the snapshot itself;
        # a short grace (< ~1s) degrades straight to snapshot-no-drain
        reserve = min(1.0, grace_s * 0.5)
        budget = grace_s - reserve - (time.monotonic() - t0)
        drained = budget > 0 and bool(self._eos_evt.wait(budget)) \
            and self._error is None
        abandoned: Dict[str, int] = {}
        if not drained:
            for e in self.elements.values():
                try:
                    n = int(e.preempt_inflight())
                except Exception:  # noqa: BLE001 — a count is best-effort
                    n = 0
                if n > 0:
                    abandoned[e.name] = n
                    e.stats.inc("preempt_abandoned", n)
        snap = None
        try:
            snap = self.snapshot(
                directory, retain=retain,
                meta={"preempt": {"grace_s": float(grace_s),
                                  "drained": drained,
                                  "abandoned": abandoned}})
        finally:
            self.stop()
        report = {"snapshot": snap, "drained": drained,
                  "abandoned": abandoned, "grace_s": float(grace_s),
                  "used_s": time.monotonic() - t0}
        self.post_message("preempted", **report)
        return report

    def wait_eos(self, timeout: Optional[float] = None) -> bool:
        """Block until all sinks saw EOS or an error was posted.
        Returns True on clean EOS; raises on pipeline error."""
        ok = self._eos_evt.wait(timeout)
        if self._error is not None:
            raise self._error
        return ok

    def run(self, timeout: Optional[float] = None) -> "Pipeline":
        """start + wait_eos + stop (the gst-launch usage pattern)."""
        self.start()
        try:
            self.wait_eos(timeout)
        finally:
            self.stop()
        return self

    # -- introspection ----------------------------------------------------
    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-element counter snapshots."""
        return {name: e.stats.snapshot()
                for name, e in self.elements.items()}

    def __repr__(self) -> str:
        return f"<Pipeline {self.name!r} elements={list(self.elements)}>"
