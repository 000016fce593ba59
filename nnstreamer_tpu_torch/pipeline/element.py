"""Element base classes: the dataflow node model.

Port of ``nnstreamer_tpu/pipeline/element.py`` (the analog of
GstElement/GstBaseTransform/GstBaseSrc/GstBaseSink, without GObject):
elements declare pad templates and string-typed properties, chain buffers
synchronously within a thread segment, and negotiate caps via in-band
CAPS events. Thread boundaries are explicit ``queue`` elements and source
loops. Per-element proctime statistics are built in.

The static hooks the fusion planner reads are ported:
:meth:`Element.static_transfer` (caps inference without running the
element), :meth:`Element.device_veto` and :meth:`Element.device_fn`.

Every element takes ``on-error`` (fault/policy.py): ``fail`` (the
default) posts the error and ends the stream, ``skip``, ``retry`` and
``restart`` consume or recover the failing buffer, and a source's
streaming loop runs under a fault.Supervisor applying the same policy.
``trace-export`` on a source declares intent only (pipelint's
trace-export rule reads it and ``STRIPS_META``); the port records no
spans.

:meth:`Element.drain` is the graceful-teardown hook
(``Pipeline.drain``): a source stops admitting and flushes what it
queued behind the EOS barrier (:meth:`SrcElement.drain_flushed`).

Trimmed in the port: the observability spans, per-element debug
categories, and checkpoint/preempt.

A property the port accepts but does not implement yet is declared in
``NOT_PORTED`` with the one value the port supports; :meth:`Element.start`
raises if it is set to anything else, so a launch line written for the
JAX package never loses a behaviour silently.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Union

from ..tensors.buffer import Buffer
from ..tensors.caps import Caps
from ..utils.atomic import Counters
from ..utils.log import logger
from .events import (CapsEvent, EosEvent, Event, QosEvent, SegmentEvent,
                     StreamStart)
from .pad import FlowError, Pad, PadDirection


class NotPortedError(NotImplementedError):
    """A property value or feature of the JAX package the port lacks."""


class TransferError(ValueError):
    """A declared caps transfer provably cannot succeed (static analog of
    a runtime negotiation failure). ``pad`` names the sink pad where the
    contradiction was detected, when known."""

    def __init__(self, message: str, pad: Optional[str] = None):
        super().__init__(message)
        self.pad = pad


def _coerce(value: str, default: Any) -> Any:
    """Coerce a launch-string property value to the default's type."""
    if not isinstance(value, str):
        return value
    if isinstance(default, bool):
        return value.strip().lower() in ("true", "1", "yes", "on")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


class Element:
    """Base dataflow element.

    Subclasses declare:
      * ``SINK_TEMPLATES`` / ``SRC_TEMPLATES``: dict of pad-name -> caps
        string (or None for ANY). Names ending in ``_%u`` are request-pad
        templates.
      * ``PROPS``: dict of property-name -> default value (types inferred).
      * ``NOT_PORTED``: dict of property-name -> the only value the port
        supports (the JAX package's default). Also accepted as properties.
    """

    SINK_TEMPLATES: Dict[str, Optional[str]] = {}
    SRC_TEMPLATES: Dict[str, Optional[str]] = {}
    # every element accepts on-error (fault/policy.py grammar):
    # fail | skip | retry[(n[,backoff_s[,jitter]])] |
    # restart[(budget[,window_s])]. The default aborts the pipeline on
    # any chain exception.
    PROPS: Dict[str, Any] = {"on-error": "fail"}
    NOT_PORTED: Dict[str, Any] = {}
    # elements opting into on_error=restart declare that stop()/start()
    # rebuilds them losslessly (pipelint errors on restart otherwise)
    RESTART_SAFE = False
    # elements that mint FRESH output buffers without copying the input
    # buffer's extras declare it: pipelint's trace-export rule warns when
    # such an element sits downstream of a trace-exporting source
    STRIPS_META = False

    _anon_counter = [0]

    def __init__(self, name: Optional[str] = None, **props):
        if name is None:
            Element._anon_counter[0] += 1
            name = f"{type(self).__name__.lower()}{Element._anon_counter[0]}"
        self.name = name
        self.pipeline = None  # set by Pipeline.add
        self.sink_pads: Dict[str, Pad] = {}
        self.src_pads: Dict[str, Pad] = {}
        self._eos_seen: set = set()
        self._started = False
        # atomic counter map: chain threads, the fault supervisor and the
        # filter's completer thread mutate these while Pipeline.stats()
        # and the tracer read them from the user thread
        self.stats = Counters({"buffers": 0, "bytes": 0, "proctime_ns": 0,
                               "events": 0,
                               # fault-policy accounting (fault/policy.py):
                               # buffers skipped/shed, retried, and how
                               # often on-error=restart bounced the element
                               "dropped": 0, "retries": 0, "restarts": 0})
        # merged property table from the full class hierarchy
        self._prop_defaults: Dict[str, Any] = {}
        self._not_ported: Dict[str, Any] = {}
        for klass in reversed(type(self).__mro__):
            self._prop_defaults.update(getattr(klass, "PROPS", {}))
            self._not_ported.update(getattr(klass, "NOT_PORTED", {}))
        self._prop_defaults.update(self._not_ported)
        for k, v in self._prop_defaults.items():
            setattr(self, k.replace("-", "_"), v)
        for k, v in props.items():
            self.set_property(k.replace("_", "-") if "-" not in k else k, v)
        for pname, caps_str in self.SINK_TEMPLATES.items():
            if not pname.endswith("%u"):
                self._make_pad(pname, PadDirection.SINK, caps_str)
        for pname, caps_str in self.SRC_TEMPLATES.items():
            if not pname.endswith("%u"):
                self._make_pad(pname, PadDirection.SRC, caps_str)

    # -- pads -------------------------------------------------------------
    def _make_pad(self, name: str, direction: PadDirection,
                  caps_str: Optional[str]) -> Pad:
        tmpl = Caps.ANY() if caps_str is None else Caps(caps_str)
        pad = Pad(self, name, direction, tmpl)
        (self.sink_pads if direction == PadDirection.SINK else self.src_pads)[name] = pad
        return pad

    def request_pad(self, direction: PadDirection) -> Pad:
        """Create a pad from a ``_%u`` request template (mux/demux style)."""
        templates = (self.SINK_TEMPLATES if direction == PadDirection.SINK
                     else self.SRC_TEMPLATES)
        pads = self.sink_pads if direction == PadDirection.SINK else self.src_pads
        for tname, caps_str in templates.items():
            if tname.endswith("%u"):
                base = tname[:-2]
                idx = 0
                while f"{base}{idx}" in pads:
                    idx += 1
                return self._make_pad(f"{base}{idx}", direction, caps_str)
        raise ValueError(f"{self.name}: no request-pad template for {direction}")

    @property
    def sinkpad(self) -> Pad:
        return next(iter(self.sink_pads.values()))

    @property
    def srcpad(self) -> Pad:
        return next(iter(self.src_pads.values()))

    def get_static_or_request_pad(self, name: str, direction: PadDirection) -> Pad:
        pads = self.sink_pads if direction == PadDirection.SINK else self.src_pads
        if name in pads:
            return pads[name]
        pad = self.request_pad(direction)
        if name != pad.name:
            pads[name] = pads.pop(pad.name)
            pad.name = name
        return pad

    # -- properties -------------------------------------------------------
    def set_property(self, key: str, value: Any) -> None:
        attr = key.replace("-", "_")
        dashed = key.replace("_", "-")
        if key in self._prop_defaults:
            setattr(self, attr, _coerce(value, self._prop_defaults[key]))
        elif attr in self._prop_defaults:
            setattr(self, attr, _coerce(value, self._prop_defaults[attr]))
        elif dashed in self._prop_defaults:
            # launch strings may spell a dashed property with underscores
            setattr(self, attr, _coerce(value, self._prop_defaults[dashed]))
        else:
            raise ValueError(f"{type(self).__name__} has no property {key!r}")

    # -- lifecycle --------------------------------------------------------
    def check_ported(self) -> None:
        """Raise :class:`NotPortedError` for a property set to a value the
        port does not implement."""
        for key, supported in self._not_ported.items():
            value = getattr(self, key.replace("-", "_"))
            if value != supported:
                raise NotPortedError(
                    f"{self.name}: {key}={value!r} is not ported yet "
                    f"(the port supports only {key}={supported!r})")

    def start(self) -> None:
        """Transition to running; override for resource setup."""
        self.check_ported()
        self._started = True

    def stop(self) -> None:
        self._started = False

    def teardown(self) -> None:
        """``Pipeline.stop``'s last step, after every element stopped:
        free what the element keeps across its own ``stop()``/``start()``
        (an on-error restart), such as a CUDA-graph pool. Default:
        nothing."""

    # -- static analysis --------------------------------------------------
    def static_src_caps(self) -> Optional[Caps]:
        """Declared output caps of a source element, computed WITHOUT
        starting it. Default: the fixated ``caps`` property when the
        element declares one; None (unknown) otherwise."""
        caps_str = getattr(self, "caps", None)
        if isinstance(caps_str, str) and caps_str:
            try:
                return Caps(caps_str).fixate()
            except ValueError as exc:
                raise TransferError(
                    f"{self.name}: bad caps property {caps_str!r}: {exc}")
        return None

    def static_transfer(
            self, in_caps: Dict[str, Optional[Caps]],
    ) -> Dict[str, Optional[Caps]]:
        """Declared caps transfer: map per-sink-pad input caps to per-src-
        pad output caps without executing the element. ``None`` marks an
        unknown (gradual typing). Raise :class:`TransferError` for a
        provable contradiction.

        Default declaration: sources answer :meth:`static_src_caps`,
        single-sink elements pass their input through to every src pad,
        and multi-sink elements are unknown (override to say more)."""
        if not self.sink_pads:
            caps = self.static_src_caps()
            return {p: caps for p in self.src_pads}
        if len(in_caps) == 1:
            caps = next(iter(in_caps.values()))
            return {p: caps for p in self.src_pads}
        return {p: None for p in self.src_pads}

    # -- device placement (fusion compiler) -------------------------------
    # one-line capability note: None means the element never provides a
    # device function; a string describes when it does (fusion/planner.py)
    DEVICE_FUSIBLE: Optional[str] = None
    # the name of the FusedSegment that runs this element's device
    # function in its place (set when the plan is applied; the plan is
    # sticky, so it stays set across restarts); None when unfused
    fused_in: Optional[str] = None

    def device_veto(self) -> Optional[str]:
        """Static reason this element can NOT provide a device function,
        or None when :meth:`device_fn` is expected to return a program.
        Must never open models or devices. The planner still calls
        :meth:`device_fn` afterwards (which may decline with None for
        config-specific reasons)."""
        if type(self).device_fn is Element.device_fn:
            return "no device function"
        return None

    def device_fn(self, ctx=None):
        """Pure device-side body of this element, or None.

        Returns a callable ``fn(tensors: List[Tensor]) -> List[Tensor]``
        mapping the chunks of one input buffer to the chunks of one
        output buffer, made of torch ops only (no Python side effects, no
        host round trips, no host syncs), so that the fusion planner can
        compose consecutive members' fns into one program that a fused
        segment captures as one CUDA graph (fusion/segment.py). ``ctx`` is
        a :class:`fusion.FusionCtx` carrying the statically planned input
        caps/config. It runs at plan time (before start) and MAY open the
        element's model; return None to decline, and the element keeps
        its per-buffer chain path."""
        return None

    # -- dataflow ---------------------------------------------------------
    def chain(self, pad: Pad, item: Union[Buffer, Event]) -> None:
        """Entry point for data arriving on a sink pad."""
        if isinstance(item, Event):
            self.stats.inc("events")
            self.handle_event(pad, item)
            return
        tracer = getattr(self.pipeline, "tracer", None)
        if tracer is not None:
            tracer.record(self, item)
        t0 = time.perf_counter_ns()
        try:
            self.do_chain(pad, item)
        except FlowError:
            raise
        except Exception as exc:  # noqa: BLE001 -- apply the element's on-error policy
            # fail (default) posts the error and raises FlowError;
            # skip/retry/restart may consume or recover the buffer
            # (fault/policy.py)
            from ..fault.policy import handle_chain_error
            if not handle_chain_error(self, pad, item, exc):
                return  # buffer consumed by the policy (skipped)
        dt = time.perf_counter_ns() - t0
        self.stats.add(buffers=1, bytes=item.nbytes, proctime_ns=dt)

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        raise NotImplementedError

    # -- events -----------------------------------------------------------
    def handle_event(self, pad: Pad, event: Event) -> None:
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            self.on_sink_caps(pad, event.caps)
        elif isinstance(event, EosEvent):
            self._eos_seen.add(pad.name)
            linked = [p for p in self.sink_pads.values() if p.is_linked]
            if all(p.name in self._eos_seen for p in linked):
                self.on_eos()
                self.forward_event(event)
        else:
            self.forward_event(event)

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        """Default single-in/single-out negotiation: compute src caps and
        forward. Multi-pad elements override."""
        out = self.transform_caps(caps)
        if out is None:
            raise ValueError(f"{self.name}: cannot negotiate caps {caps}")
        self.set_src_caps(out)

    def transform_caps(self, incaps: Caps) -> Optional[Caps]:
        """in caps -> out caps; identity by default (passthrough)."""
        return incaps

    def set_src_caps(self, caps: Caps, pad: Optional[Pad] = None) -> None:
        pads = [pad] if pad is not None else list(self.src_pads.values())
        for p in pads:
            p.set_caps(caps)
            p.push(CapsEvent(caps))

    def on_eos(self) -> None:
        """Hook before EOS is forwarded (flush pending data here)."""

    def forward_event(self, event: Event) -> None:
        for p in self.src_pads.values():
            if p.is_linked:
                p.push(event)

    # -- upstream events ---------------------------------------------------
    def send_upstream_event(self, event: Event) -> None:
        """Send an out-of-band event upstream (≙ gst_pad_push_event on a
        sink pad — the QoS path). Travels sink-pad → upstream element's
        ``handle_upstream_event`` directly, bypassing queues, like
        GStreamer's non-serialized upstream events."""
        for p in self.sink_pads.values():
            if p.is_linked:
                p.peer.element.handle_upstream_event(p.peer, event)

    def handle_upstream_event(self, pad: Pad, event: Event) -> None:
        """Default: keep propagating toward the source."""
        self.send_upstream_event(event)

    # -- push helpers -----------------------------------------------------
    def push(self, buf: Buffer, pad: Optional[Pad] = None) -> None:
        (pad or self.srcpad).push(buf)

    def post_error(self, exc: Exception) -> None:
        if self.pipeline is not None:
            self.pipeline.post_message("error", element=self.name, error=exc)

    def post_message(self, kind: str, **data) -> None:
        if self.pipeline is not None:
            self.pipeline.post_message(kind, element=self.name, **data)

    def drain(self) -> None:
        """Graceful-teardown hook (``Pipeline.drain``): stop admitting
        new work but finish what is already in flight — after every
        element drains, EOS reaches the sinks and the pipeline closes
        with nothing half-done. Base: nothing to do (pure per-buffer
        elements hold no work between chain calls)."""

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class TransformElement(Element):
    """1-in/1-out element (≙ GstBaseTransform)."""

    SINK_TEMPLATES = {"sink": None}
    SRC_TEMPLATES = {"src": None}
    # pure per-buffer transforms rebuild losslessly from stop()/start()
    RESTART_SAFE = True

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        out = self.transform(buf)
        if out is not None:
            self.push(out)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        raise NotImplementedError

    def static_transfer(self, in_caps):
        """Pure ``transform_caps`` on the declared input caps."""
        incaps = in_caps.get("sink")
        if incaps is None:
            return {p: None for p in self.src_pads}
        out = self.transform_caps(incaps)
        if out is None:
            raise TransferError(
                f"{self.name}: cannot negotiate caps {incaps}", pad="sink")
        return {p: out for p in self.src_pads}


class _StreamRestart(Exception):
    """Control flow: a supervised create() failure was decided RESTART
    inside _stream; _loop replays the preamble without re-handling."""

    def __init__(self, cause: Exception):
        super().__init__(str(cause))
        self.cause = cause


class _StreamEscalate(Exception):
    """Control flow: a supervised create() failure exhausted its policy
    inside _stream; _loop posts the pipeline error without re-handling."""

    def __init__(self, cause: Exception):
        super().__init__(str(cause))
        self.cause = cause


class SrcElement(Element):
    """Source with its own streaming thread (≙ GstBaseSrc).

    Subclasses implement ``negotiate_src_caps()`` (fixed caps for the
    stream) and ``create()`` returning a Buffer or None for EOS. The
    thread runs supervised: see :meth:`_loop` and fault/supervisor.py.
    """

    SRC_TEMPLATES = {"src": None}
    # trace-export declares INTENT that this source's frame traces
    # survive to the sinks (pipelint's trace-export rule checks that
    # nothing downstream strips the context); the port records no spans
    PROPS = {"num-buffers": -1, "trace-export": False}
    # restart for a source is a loop-level stream replay (on_restart
    # hook + preamble), which every source supports by construction
    RESTART_SAFE = True

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._drain_evt = threading.Event()
        self._pushed = 0

    def negotiate_src_caps(self) -> Optional[Caps]:
        return None

    def create(self) -> Optional[Buffer]:
        raise NotImplementedError

    def start(self) -> None:
        super().start()
        self._stop_evt.clear()
        self._drain_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"src:{self.name}", daemon=True)
        self._thread.start()

    def drain(self) -> None:
        """Ask the streaming loop to end the stream gracefully: no new
        admissions, flush what is queued (:meth:`drain_flushed`), then
        EOS. Subclasses that block in create() should also wake it."""
        self._drain_evt.set()

    def drain_flushed(self) -> bool:
        """True once everything this source already admitted has been
        pushed — the drain barrier for sources that queue internally
        (serversrc, serve src and edgesrc override)."""
        return True

    def stop(self) -> None:
        self._stop_evt.set()
        super().stop()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
            self._thread = None

    def on_restart(self) -> None:
        """Hook for supervised stream restarts (on-error=restart):
        re-acquire whatever resource the stream reads from. The preamble
        — StreamStart, caps, segment — is replayed by the loop itself."""

    def _loop(self) -> None:
        """Supervised streaming loop: failures escaping the stream body
        go through a fault.Supervisor applying the element's on-error
        policy (backoff + jitter, restart budget) before the
        escalate-to-pipeline-error path (fault/supervisor.py)."""
        from ..fault.supervisor import CONTINUE, RESTART, Supervisor
        try:
            sup = Supervisor(self)
        except Exception as exc:  # noqa: BLE001 — unparseable on-error spec
            logger.exception("%s: bad on-error policy", self.name)
            self.post_error(exc)
            return
        while not self._stop_evt.is_set():
            try:
                self._stream(sup)
                return
            except FlowError:
                return  # error already posted by the failing element
            except _StreamRestart:
                try:
                    self.on_restart()
                    continue  # replay preamble: caps re-negotiated
                except Exception as exc:  # noqa: BLE001
                    logger.exception("%s: restart hook failed", self.name)
                    self.post_error(exc)
                    return
            except Exception as exc:  # noqa: BLE001
                if isinstance(exc, _StreamEscalate):
                    exc = exc.cause
                else:
                    decision = sup.handle(exc, where="src-loop")
                    if decision == RESTART:
                        try:
                            self.on_restart()
                            continue
                        except Exception as exc2:  # noqa: BLE001
                            exc = exc2
                    elif decision == CONTINUE:
                        continue
                logger.exception("%s: error in src loop", self.name)
                self.post_error(exc)
                return

    def _stream(self, sup=None) -> None:
        """One full streaming pass: preamble, create() loop, EOS."""
        self.srcpad.push(StreamStart(stream_id=self.name))
        caps = self.negotiate_src_caps()
        if caps is not None:
            self.set_src_caps(caps)
        self.srcpad.push(SegmentEvent())
        while not self._stop_evt.is_set():
            if 0 <= self.num_buffers <= self._pushed:
                break
            if self._drain_evt.is_set() and self.drain_flushed():
                break  # drained: everything admitted has been pushed
            try:
                buf = self.create()
            except FlowError:
                raise
            except Exception as exc:  # noqa: BLE001 — per-frame policy site
                if sup is None:
                    raise
                from ..fault.supervisor import CONTINUE, RESTART
                decision = sup.handle(exc, where="create")
                if decision == CONTINUE:
                    continue  # frame skipped or retry backoff elapsed
                # the decision (budget slot, backoff, bus warning) is
                # already made — _loop must honor it, not re-handle
                if decision == RESTART:
                    raise _StreamRestart(exc) from exc
                raise _StreamEscalate(exc) from exc
            if sup is not None:
                sup.ok()
            if buf is None:
                break
            tracer = getattr(self.pipeline, "tracer", None)
            if tracer is not None:
                tracer.stamp(buf)
            self.srcpad.push(buf)
            self._pushed += 1
        self.srcpad.push(EosEvent())


class SinkElement(Element):
    """Terminal element (≙ GstBaseSink); notifies the pipeline on EOS.

    ``qos=true`` measures each render against the stream's frame
    duration and sends QoS events upstream when the sink falls behind
    (≙ GstBaseSink's "qos" property + gst_base_sink_send_qos): an
    upstream tensor_filter then drops frames before its invoke. Needs
    timestamped streams (a framerate, hence ``buf.duration``); untimed
    streams already self-limit through bounded-queue backpressure.
    Render time includes whatever the sink's render waits for, e.g. a
    CUDA chunk's copy to the host."""

    SINK_TEMPLATES = {"sink": None}
    PROPS = {"qos": False}

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self._qos_avg_ns = 0.0
        self._qos_throttling = False
        self._qos_sent_ns = 0.0

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        if not self.qos or not buf.duration:
            self.render(buf)
            return
        t0 = time.perf_counter_ns()
        self.render(buf)
        dt = time.perf_counter_ns() - t0
        # EWMA over ~8 frames: tolerant of a one-frame spike, fast
        # enough to catch a drifting render cost
        self._qos_avg_ns += (dt - self._qos_avg_ns) * 0.125
        proportion = self._qos_avg_ns / buf.duration
        if proportion > 1.0:
            # one event per throttle episode, re-sent only when the
            # sustainable period has drifted >25% — not one per slow frame
            drift = abs(self._qos_avg_ns - self._qos_sent_ns) \
                > 0.25 * self._qos_sent_ns
            if not self._qos_throttling or drift:
                self._qos_throttling = True
                self._qos_sent_ns = self._qos_avg_ns
                self.send_upstream_event(QosEvent(
                    proportion=proportion,
                    period_ns=int(self._qos_avg_ns), timestamp=buf.pts))
        elif self._qos_throttling and proportion < 0.8:
            # recovered (hysteresis): release the throttle
            self._qos_throttling = False
            self._qos_sent_ns = 0.0
            self.send_upstream_event(QosEvent(
                proportion=1.0, period_ns=0, timestamp=buf.pts))

    def render(self, buf: Buffer) -> None:
        raise NotImplementedError

    def on_eos(self) -> None:
        if self.pipeline is not None:
            self.pipeline._sink_eos(self)
