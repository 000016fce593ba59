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
are logged. Not ported: drain and checkpoint/restore/preempt.
"""
from __future__ import annotations

import queue as _queue
import threading
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
            with self._lock:
                if self._error is None:
                    self._error = data.get("error")
            self._eos_evt.set()  # unblock waiters
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
        return self

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
