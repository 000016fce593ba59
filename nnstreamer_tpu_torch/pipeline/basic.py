"""Generic plumbing elements: queue, tee, capsfilter, identity, appsrc,
appsink, fakesink and tensortestsrc.

Port of the matching elements of ``nnstreamer_tpu/pipeline/basic.py``,
with their static caps transfer (the element base's declaration for the
queue, appsrc and the sinks; capsfilter's and tensortestsrc's below).
The queue is a Python ``queue.Queue`` or the native C++ ring
(``backend=native``, ``native/lib.py``). ``tee`` shares each
buffer among its branches (no copy), so CUDA chunks stay on the card
through it, as ``identity`` passes them.
"""
from __future__ import annotations

import queue as _pyqueue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..obs import context as _obs_ctx
from ..obs import spans as _obs_spans
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.types import TensorType
from ..utils.log import logger
from .element import (Element, SinkElement, SrcElement, TransferError,
                      TransformElement)
from .events import CapsEvent, Event
from .pad import FlowError, Pad
from .registry import register_element

_SENTINEL = object()


class _NativeQueueAdapter:
    """queue.Queue facade over the C++ MPMC ring (csrc/nns_ring.cc), the
    native thread boundary the reference gets from GStreamer's C queue.
    Waiting happens in native condition variables, off the interpreter
    lock. A put or get on a closed ring raises FlowError at once. Only
    non-leaky queues use it: both calls block."""

    def __init__(self, capacity: int):
        from ..native.lib import NativeRing
        self._ring = NativeRing(capacity)

    def put(self, item) -> None:
        if not self._ring.push(item):
            raise FlowError("queue stopped")

    def get(self):
        ok, item = self._ring.pop()
        if not ok:
            raise FlowError("queue stopped")
        return item

    def close(self) -> None:
        self._ring.close()

    def qsize(self) -> int:
        return len(self._ring)


@register_element("queue")
class Queue(Element):
    """Thread boundary with a bounded buffer queue.

    Backpressure: upstream ``chain`` blocks when the queue is full
    (matching gst queue defaults). GStreamer leaky semantics:
    ``leaky=upstream`` drops the incoming buffer when full;
    ``leaky=downstream`` evicts the oldest queued buffer to make room.

    ``backend=auto`` (default) uses the native C++ ring for the common
    non-leaky case when a fresh libnnstpu is already built (``make
    native``; auto never starts a build); ``python`` forces the Python queue, and ``native``
    the ring, building it at first use and raising, never falling back,
    when it cannot. Leaky modes always use the Python queue (eviction
    needs its internals).

    ``stop`` closes the ring (or, for the Python queue, marks the queue
    stopped and wakes the worker): a producer blocked in ``chain``
    returns with FlowError instead of waiting on a queue no worker
    drains, and ``start`` makes a fresh ring.
    """

    SINK_TEMPLATES = {"sink": None}
    SRC_TEMPLATES = {"src": None}
    PROPS = {"max-size-buffers": 16, "leaky": "none", "backend": "auto"}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._q = self._make_q()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._stopped = threading.Event()

    def _make_q(self):
        cap = max(1, self.max_size_buffers)
        if self.backend in ("auto", "native") and self.leaky == "none":
            from ..native.lib import load_native_lib
            # auto never starts `make native` from a pipeline parse: it
            # takes only a fresh library already on disk; native builds
            if load_native_lib(build=self.backend == "native") is not None:
                return _NativeQueueAdapter(cap)
            if self.backend == "native":
                raise RuntimeError(
                    f"{self.name}: backend=native but no fresh libnnstpu "
                    "could be built (run `make native`)")
        elif self.backend == "native":
            raise ValueError(
                f"{self.name}: leaky queues need backend=python")
        return _pyqueue.Queue(maxsize=cap)

    @property
    def is_native(self) -> bool:
        return isinstance(self._q, _NativeQueueAdapter)

    def set_property(self, key: str, value) -> None:
        super().set_property(key, value)
        if key.replace("_", "-") in ("max-size-buffers", "leaky", "backend"):
            # properties may be applied after __init__ (launch parser);
            # rebuild then, but never once the worker owns the queue.
            # During Element.__init__ (constructor kwargs) _q does not
            # exist yet: Queue.__init__ builds it exactly once.
            if "_q" not in self.__dict__:
                return
            if getattr(self, "_running", False):
                raise RuntimeError(
                    f"{self.name}: cannot reconfigure a running queue")
            self._q = self._make_q()

    def start(self) -> None:
        super().start()
        if self.is_native and self._stopped.is_set():
            # a closed ring stays closed: a restarted element gets a
            # live one (made here, not at stop, so a producer still
            # pushing after the stop meets the closed ring)
            self._q = self._make_q()
        self._stopped.clear()
        self._running = True
        self._thread = threading.Thread(
            target=self._worker, name=f"queue:{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._stopped.set()
        super().stop()
        if self.is_native:
            # the ring has a real shutdown: close() wakes the producers
            # blocked in push (FlowError) and the worker's pop
            self._q.close()
        else:
            try:
                self._q.put_nowait(_SENTINEL)
            except _pyqueue.Full:
                try:
                    self._q.get_nowait()
                    self._q.put_nowait(_SENTINEL)
                except (_pyqueue.Empty, _pyqueue.Full):
                    pass
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
            if not self._thread.is_alive() and not self.is_native:
                self._drop_sentinel()
            self._thread = None

    def _drop_sentinel(self) -> None:
        """Take back a stop sentinel the exited worker never popped: a
        worker that saw ``_running`` go false between two items leaves
        it queued, where it would read as a queued buffer and stop the
        restarted worker at its first pop."""
        with self._q.mutex:
            kept = [x for x in self._q.queue if x is not _SENTINEL]
            self._q.queue.clear()
            self._q.queue.extend(kept)
            self._q.not_full.notify_all()

    def _put(self, item) -> None:
        """Blocking put (backpressure) that gives up once the queue is
        stopped: no worker drains it then."""
        if self.is_native:
            self._q.put(item)
            return
        while True:
            if self._stopped.is_set():
                raise FlowError(f"{self.name}: queue stopped")
            try:
                self._q.put(item, timeout=0.05)
                return
            except _pyqueue.Full:
                continue

    def chain(self, pad: Pad, item) -> None:
        if isinstance(item, Event):
            self._put(item)  # events are serialized: never dropped
            return
        # the queue bypasses Element.chain (no do_chain), so the tracing
        # hook fires here (stats['buffers'] is counted by the worker on pop)
        tracer = getattr(self.pipeline, "tracer", None)
        if tracer is not None:
            tracer.record(self, item)
        if _obs_spans.ENABLED:
            # entry stamp: the worker's pop turns it into the
            # queue-wait span (+ queue attribution on the context)
            item.extras[_obs_ctx.QT_KEY] = time.time_ns()
        if self.leaky == "upstream":
            # GStreamer leaky=upstream: drop the incoming buffer when full
            try:
                self._q.put_nowait(item)
            except _pyqueue.Full:
                pass
        elif self.leaky == "downstream":
            # GStreamer leaky=downstream: evict the oldest queued BUFFER;
            # events keep their queue position (they are never dropped)
            while True:
                try:
                    self._q.put_nowait(item)
                    return
                except _pyqueue.Full:
                    dropped = False
                    with self._q.mutex:
                        for i, old in enumerate(self._q.queue):
                            if not isinstance(old, Event):
                                del self._q.queue[i]
                                dropped = True
                                # wake producers blocked in put(): mutex IS
                                # the not_full condition's lock
                                self._q.not_full.notify()
                                break
                    if not dropped:
                        # only events queued: block until the worker drains
                        self._put(item)
                        return
        else:
            self._put(item)  # blocking: backpressure

    def _worker(self) -> None:
        while self._running:
            try:
                item = self._q.get()
            except FlowError:
                break  # native ring closed and drained
            if item is _SENTINEL:
                break
            try:
                if isinstance(item, Event):
                    if isinstance(item, CapsEvent):
                        self.sinkpad.set_caps(item.caps)
                        self.set_src_caps(item.caps)
                    else:
                        self.forward_event(item)
                else:
                    self.stats.add(buffers=1, bytes=item.nbytes)
                    if _obs_spans.ENABLED:
                        qt = item.extras.pop(_obs_ctx.QT_KEY, None)
                        if qt is not None:
                            ctx = item.extras.get(_obs_ctx.CTX_KEY)
                            if ctx is not None:
                                wait = max(0, time.time_ns() - qt)
                                _obs_spans.record_span(self.name, "queue",
                                                       qt, wait, ctx)
                                ctx.q_ns += wait
                    self.srcpad.push(item)
            except FlowError:
                break
            except Exception as exc:  # noqa: BLE001
                logger.exception("%s: error in queue worker", self.name)
                self.post_error(exc)
                break


@register_element("tee")
class Tee(Element):
    """1-to-N fan-out. Buffers are shared, not copied: chunks are
    immutable by convention."""

    SINK_TEMPLATES = {"sink": None}
    SRC_TEMPLATES = {"src_%u": None}

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        for p in self.src_pads.values():
            if p.is_linked:
                p.push(buf)

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self.set_src_caps(caps)


@register_element("capsfilter")
class CapsFilter(TransformElement):
    """Pass-through that restricts negotiation to its ``caps`` property."""

    PROPS = {"caps": ""}

    def transform(self, buf: Buffer) -> Buffer:
        return buf

    def transform_caps(self, incaps: Caps) -> Optional[Caps]:
        if not self.caps:
            return incaps
        want = Caps(self.caps) if isinstance(self.caps, str) else self.caps
        out = incaps.intersect(want)
        if out.is_empty():
            raise ValueError(
                f"{self.name}: caps {incaps} do not satisfy filter {want}")
        return out.fixate() if not out.is_fixed() else out

    def static_transfer(self, in_caps):
        """Input ∩ ``caps`` property; a fixed caps property alone pins
        an otherwise-unknown upstream."""
        if in_caps.get("sink") is None and self.caps:
            want = Caps(self.caps) if isinstance(self.caps, str) else self.caps
            if want.is_fixed():
                return {"src": want}
            return {"src": None}
        return super().static_transfer(in_caps)


@register_element("identity")
class Identity(TransformElement):
    PROPS = {"silent": True}

    def transform(self, buf: Buffer) -> Buffer:
        if not self.silent:
            logger.info("%s: buffer pts=%s chunks=%d", self.name, buf.pts,
                        len(buf))
        return buf


@register_element("appsrc")
class AppSrc(SrcElement):
    """Application-driven source: the app thread calls ``push_buffer`` /
    ``end_stream``; the src loop relays into the pipeline."""

    PROPS = {"caps": "", "max-buffers": 64}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._q: _pyqueue.Queue = _pyqueue.Queue(maxsize=max(1, self.max_buffers))

    def push_buffer(self, buf: Buffer) -> None:
        self._q.put(buf)

    def end_stream(self) -> None:
        self._q.put(_SENTINEL)

    def negotiate_src_caps(self) -> Optional[Caps]:
        return Caps(self.caps) if self.caps else None

    def create(self) -> Optional[Buffer]:
        while not self._stop_evt.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except _pyqueue.Empty:
                continue
            return None if item is _SENTINEL else item
        return None


@register_element("appsink")
class AppSink(SinkElement):
    """Collecting sink with an optional new-data callback
    (≙ tensor_sink's ``new-data`` signal, ref: gsttensor_sink.c)."""

    PROPS = {"max-buffers": 0, "emit-signals": True}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.buffers: List[Buffer] = []
        self.callback: Optional[Callable[[Buffer], None]] = None
        self._lock = threading.Lock()

    def connect(self, callback: Callable[[Buffer], None]) -> None:
        self.callback = callback

    def render(self, buf: Buffer) -> None:
        with self._lock:
            self.buffers.append(buf)
            if self.max_buffers > 0 and len(self.buffers) > self.max_buffers:
                self.buffers.pop(0)
        if self.callback is not None:
            self.callback(buf)

    def pop_all(self) -> List[Buffer]:
        with self._lock:
            out, self.buffers = self.buffers, []
            return out


@register_element("tensortestsrc")
class TensorTestSrc(SrcElement):
    """Synthetic tensor source (≙ videotestsrc feeding tensor_converter in
    reference test pipelines). Generates frames matching its ``caps``
    property with a chosen fill pattern; PTS synthesized from framerate.

    The frames are the JAX package's, byte for byte: the same numpy
    ``default_rng(seed)`` calls in the same order. A bfloat16 tensor is
    drawn as the JAX package draws it (float64 from the generator) and
    rounded to bf16 by torch.

    ``device=true`` stages a pool of ``pool-size`` frames on the card and
    cycles them, so the stream is device-resident from the source on;
    ``unique=true`` adds the frame counter to each pooled frame on the
    card, so every emitted frame differs.
    """

    PROPS = {"caps": "", "pattern": "counter", "seed": 0, "is-live": False,
             "device": False, "pool-size": 4, "unique": False}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._config = None
        self._count = 0
        self._rng = None
        self._pool = None

    def static_src_caps(self) -> Optional[Caps]:
        """Fixated ``caps`` property (required for this source)."""
        if not self.caps:
            raise TransferError(f"{self.name}: 'caps' property is required")
        return super().static_src_caps()

    def negotiate_src_caps(self) -> Optional[Caps]:
        if not self.caps:
            raise ValueError(f"{self.name}: 'caps' property is required")
        caps = Caps(self.caps)
        if not caps.is_fixed():
            caps = caps.fixate()
        self._config = caps.to_config()
        return caps

    def _make_frame(self, count: int):
        arrays = []
        for info in self._config.info:
            if info.type is TensorType.BFLOAT16:
                arrays.append(self._make_bf16(info.shape, count))
                continue
            dt = info.type.np_dtype
            if self.pattern == "zeros":
                arr = np.zeros(info.shape, dtype=dt)
            elif self.pattern == "ones":
                arr = np.ones(info.shape, dtype=dt)
            elif self.pattern == "random":
                if np.issubdtype(np.dtype(dt), np.integer):
                    ii = np.iinfo(dt)
                    arr = self._rng.integers(ii.min, ii.max, info.shape,
                                             dtype=dt, endpoint=True)
                else:
                    arr = self._rng.random(info.shape).astype(dt)
            else:  # counter
                arr = np.full(info.shape, count).astype(dt)
            arrays.append(arr)
        return arrays

    def _make_bf16(self, shape, count: int) -> torch.Tensor:
        if self.pattern == "zeros":
            src = np.zeros(shape)
        elif self.pattern == "ones":
            src = np.ones(shape)
        elif self.pattern == "random":
            src = self._rng.random(shape)
        else:  # counter
            src = np.full(shape, count, dtype=np.float64)
        return torch.from_numpy(src).to(torch.bfloat16)

    def create(self) -> Optional[Buffer]:
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        if self.device:
            if self._pool is None:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        f"{self.name}: device=true needs a CUDA device")
                n = max(1, int(self.pool_size))
                self._pool = [
                    [Chunk(a).device("cuda") for a in self._make_frame(i)]
                    for i in range(n)]
            chunks = [Chunk(t) for t in
                      self._pool[self._count % len(self._pool)]]
            if self.unique:
                # a Python scalar rides in the kernel's arguments: a
                # tensor made from it would be a pageable host-to-device
                # copy, which waits for all the card's queued work
                chunks = [Chunk(c.raw + (self._count % 199 + 1))
                          for c in chunks]
        else:
            chunks = [Chunk(a) for a in self._make_frame(self._count)]
        cfg = self._config
        dur = cfg.frame_duration_ns()
        pts = self._count * dur if dur else self._count
        self._count += 1
        if self.is_live and dur:
            time.sleep(dur / 1e9)
        return Buffer(chunks, pts=pts, duration=dur)


@register_element("fakesink")
class FakeSink(SinkElement):
    PROPS = {"dump": False}

    def render(self, buf: Buffer) -> None:
        if self.dump:
            logger.info("%s: pts=%s %r", self.name, buf.pts, buf)
