"""tensor_filter — the inference element.

Port of ``nnstreamer_tpu/elements/filter.py`` (≙ gst/nnstreamer/
tensor_filter/tensor_filter.c + tensor_filter_common.c): property parsing,
framework auto-detection, model-vs-caps verification with batch-dim
tolerance, the invoke through the backend's per-signature executable (a
captured CUDA graph on the card), ``prefetch-host``, the K-frame
in-flight window (``in-flight``, ``reorder``, ``reorder-deadline-ms``:
elements/overlap.py over the backend's ``dispatch``/``complete``),
``warmup`` (the executable is made at caps negotiation), the fusion
hooks (``static_transfer``, ``device_veto``, ``plan_out_caps``,
``device_fn``), QoS throttling (a downstream ``QosEvent`` makes the
filter drop frames before their invoke, ``stats["qos_dropped"]``), the
padded rows of a micro-batched frame (``batch_valid_rows``, set by the
query serversrc's ``batch=K``: host outputs are trimmed, card outputs
ship padded), the circuit breaker (``breaker-threshold``, ``breaker-reset-ms``,
``breaker-retry-after-ms``: fault/breaker.py, fed by the chain thread
synchronously and by the completer thread under ``in-flight``) and
the rolling latency/throughput statistics. Chunks
handed to the backend may already live on the card; outputs stay there
until a host boundary, or, with ``prefetch-host=true``, leave as
:class:`~..tensors.transfer.PendingHost` handles whose D2H copy the
coalescing fetcher has already started.

Not ported yet, each refused at start when set (``NOT_PORTED``): input
donation, invoke-async/invoke-dynamic, suspend, the shared-model key
and input/output combination; a ``custom=mesh:`` option raises in the
torch-cuda backend. A breaker-open shed answers no serve rows (the
serve elements are not ported).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from ..fault.breaker import element_breaker, shed_frame
from ..filters.base import Accelerator, FilterProperties, InvokeDrop
from ..filters.executable import GraphPool
from ..filters.registry import detect_framework, find_filter
from ..pipeline.element import Element, TransferError
from ..pipeline.events import Event, FlushEvent, QosEvent, SegmentEvent
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensors.transfer import is_device_tensor, submit_fetch
from ..tensors.types import TensorFormat
from ..utils.log import logger

# rolling window for the latency property
# (≙ GST_TF_STAT_MAX_RECENT, tensor_filter.c)
_MAX_RECENT = 10

# latency re-report thresholds (≙ tensor_filter.c:106-118): re-post when
# the estimate grows past reported×(1+5%) or improves by more than 25%
_LATENCY_REPORT_HEADROOM = 1.05
_LATENCY_IMPROVE_THRESHOLD = 0.75


def infer_batch_dim(sel: TensorsInfo, model: TensorsInfo) -> Optional[int]:
    """The stream's uniform leading batch dim over the model input, or
    None when the stream is not model-plus-one-leading-dim."""
    if len(sel) != len(model):
        return None
    b = None
    for s, m in zip(sel, model):
        if s.type != m.type or len(s.shape) != len(m.shape) + 1 \
                or tuple(s.shape[1:]) != tuple(m.shape):
            return None
        if b is None:
            b = int(s.shape[0])
        elif int(s.shape[0]) != b:
            return None
    return b


@register_element("tensor_filter")
class TensorFilter(Element):
    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    PROPS = {
        "framework": "auto",
        "model": "",
        "input": "", "inputtype": "", "inputname": "",
        "output": "", "outputtype": "", "outputname": "",
        "accelerator": "",
        # k:v option string handed to the backend (simlink reads it)
        "custom": "",
        "latency": 0,            # 1 = enable latency property updates
        "throughput": 0,
        # start each frame's D2H copy right after the invoke, coalesced
        # across frames (tensors/transfer.py)
        "prefetch-host": False,
        # K-frame in-flight invoke window (elements/overlap.py): keep up
        # to K frames between dispatch and completion, completing each on
        # a dedicated completer thread instead of blocking the chain
        # thread. 1 = synchronous (default). Requires a backend with
        # async dispatch (SUPPORTS_DISPATCH); otherwise the filter logs
        # a notice and stays synchronous.
        "in-flight": 1,
        # restore PTS order before push() when in-flight > 1 (bounded
        # reorder buffer with a stall deadline)
        "reorder": True,
        # how long the reorder buffer dams the pipeline waiting for a
        # missing frame before abandoning the gap
        "reorder-deadline-ms": 1000.0,
        # run one zero-filled invoke at caps negotiation, so the
        # signature's executable (a CUDA-graph capture on the card) is
        # made before the first real frame instead of stalling it. Only
        # effective on STATIC caps.
        "warmup": False,
        # circuit breaker on the backend path (fault/breaker.py):
        # breaker-threshold consecutive invoke failures open it — frames
        # are then SHED (upstream throttled via QosEvent spaced by
        # breaker-retry-after-ms) instead of each paying a doomed
        # invoke; after breaker-reset-ms one probe half-opens it.
        # 0 = disabled (default).
        "breaker-threshold": 0,
        "breaker-reset-ms": 1000.0,
        "breaker-retry-after-ms": 50.0,
    }
    NOT_PORTED = {
        "invoke-dynamic": False,
        "invoke-async": False,
        "suspend": 0,
        "shared-tensor-filter-key": "",
        "input-combination": "",
        "output-combination": "",
        "donate-input": False,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.fw = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._recent_latency = collections.deque(maxlen=_MAX_RECENT)
        self._invoke_count = 0
        # dispatch-to-return timing, distinct from dispatch-to-completion
        # (_recent_latency): under an in-flight window the former is the
        # chain-thread cost, the latter the frame's real latency
        self._recent_dispatch = collections.deque(maxlen=_MAX_RECENT)
        # latency fields are written by the chain thread (sync path) AND
        # the completer thread (windowed path): one leaf lock covers them
        self._stats_lock = threading.Lock()
        self._overlap = None               # OverlapExecutor when K > 1
        self._start_time = None
        self._batch: Optional[int] = None  # batched-invoke leading dim
        self._reported_latency_us: Optional[float] = None
        self._throttle_period_ns = 0       # from downstream QoS events
        self._next_accept_ts: Optional[int] = None
        self._breaker = None
        # the graphs of every backend this element opens capture into it:
        # a restart recaptures into the same blocks; Pipeline.stop frees it
        self._graph_pool = GraphPool()
        self.stats.update({"invoke_errors": 0, "frames_dropped": 0,
                           "qos_dropped": 0, "shed": 0,
                           "breaker_opened": 0})

    # -- framework lifecycle ---------------------------------------------
    def _open_fw(self) -> None:
        if self.fw is not None:
            return
        models = tuple(m for m in self.model.split(",") if m) \
            if self.model else ()
        fw_name = self.framework
        if fw_name in ("auto", ""):
            fw_name = detect_framework(models)
        props = FilterProperties(
            framework=fw_name,
            model_files=models,
            # empty accelerator property = framework default (the card);
            # an explicit "false"/"true:cpu" opts out
            accelerators=(tuple(Accelerator.parse(self.accelerator))
                          if self.accelerator else (Accelerator.DEFAULT,)),
            custom_properties=self.custom,
            graph_pool=self._graph_pool,
        )
        if self.input and self.inputtype:
            props.input_info = TensorsInfo.make(self.inputtype, self.input)
        if self.output and self.outputtype:
            props.output_info = TensorsInfo.make(self.outputtype, self.output)
        fw = find_filter(fw_name)()
        fw.open(props)
        self.fw = fw
        mi_in, mi_out = fw.get_model_info()
        self._in_info = props.input_info or mi_in
        self._out_info = props.output_info or mi_out

    RESTART_SAFE = True  # stop/start re-opens the framework cleanly

    def start(self) -> None:
        super().start()
        self._open_fw()
        self._start_time = time.monotonic()
        self._breaker = element_breaker(
            self, lambda: {"invoke_errors": self.stats["invoke_errors"]})
        self._overlap = None
        window = int(self.in_flight)
        if window > 1:
            if not getattr(self.fw, "SUPPORTS_DISPATCH", False):
                logger.info("%s: in-flight=%d ignored — framework %s has "
                            "no async dispatch; staying synchronous",
                            self.name, window, self.fw.NAME)
            else:
                from .overlap import OverlapExecutor
                self._overlap = OverlapExecutor(
                    window,
                    complete_cb=self._complete_frame,
                    error_cb=self._complete_error,
                    push_cb=self.push,
                    name=self.name,
                    reorder=bool(self.reorder),
                    reorder_deadline_s=float(self.reorder_deadline_ms) / 1e3)

    def stop(self) -> None:
        super().stop()
        if self._overlap is not None:
            # settle every in-flight frame before the framework closes;
            # the (stopped) executor is kept so its report stays readable
            self._overlap.flush()
            self._overlap.stop()
        if self.fw is not None:
            self.fw.close()
            self.fw = None

    def teardown(self) -> None:
        """Free the graph pool the element kept across restarts."""
        self._graph_pool.release()

    # -- negotiation ------------------------------------------------------
    def _infer_batch(self, sel: TensorsInfo) -> Optional[int]:
        """If the stream is the model input plus one leading (outermost)
        batch dim on every tensor, return that batch size. Only backends
        declaring SUPPORTS_BATCH negotiate this."""
        if not getattr(self.fw, "SUPPORTS_BATCH", False):
            return None
        if self._in_info is None:
            return None
        return infer_batch_dim(sel, self._in_info)

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self._open_fw()
        cfg = caps.to_config()
        self._batch = None
        if self._in_info is not None and cfg.format == TensorFormat.STATIC:
            sel = cfg.info
            if len(sel) and not sel.is_equal(self._in_info):
                self._batch = self._infer_batch(sel)
                if self._batch is None:
                    raise ValueError(
                        f"{self.name}: model input {self._in_info!r} does not match "
                        f"negotiated stream caps {sel!r}. Check tensor_converter/"
                        "tensor_transform output dims, or set input/inputtype "
                        "properties explicitly.")
        elif self._in_info is None:
            # push-path: derive model info from caps (SET_INPUT_INFO analog)
            self._in_info = cfg.info
            out = self.fw.set_input_info(cfg.info)
            if out is not None:
                self._out_info = out
        if self._out_info is None:
            out_cfg = TensorsConfig(TensorsInfo(), TensorFormat.FLEXIBLE,
                                    cfg.rate_n, cfg.rate_d)
        else:
            out_info = self._out_info.copy()
            if self._batch is not None:
                out_info = TensorsInfo(
                    TensorInfo(i.name, i.type, (self._batch,) + tuple(i.shape))
                    for i in out_info)
            out_cfg = TensorsConfig(out_info, TensorFormat.STATIC,
                                    cfg.rate_n, cfg.rate_d)
        self.set_src_caps(Caps.from_config(out_cfg))
        if self.warmup:
            if cfg.format != TensorFormat.STATIC:
                # not silently inert: tell the user WHY nothing warmed
                logger.info("%s: warmup requested but skipped (non-static "
                            "stream format) — no fixed invoke signature "
                            "to warm", self.name)
            elif len(cfg.info):
                self._warmup_invoke(cfg.info)

    def static_transfer(self, in_caps):
        """Model I/O from declared properties only (the framework is
        never opened): input/inputtype are checked against the stream
        with batch-dim tolerance; output/outputtype give the out caps,
        otherwise the output is unknown."""
        incaps = in_caps.get("sink")
        cfg = None
        if incaps is not None and not incaps.any and incaps.structures \
                and incaps.is_fixed():
            try:
                cfg = incaps.to_config()
            except ValueError as exc:
                raise TransferError(f"{self.name}: {exc}", pad="sink")
        rate = (cfg.rate_n, cfg.rate_d) if cfg is not None else (0, 1)
        batch = None
        if self.input and self.inputtype and cfg is not None \
                and cfg.format == TensorFormat.STATIC and len(cfg.info):
            model_in = TensorsInfo.make(self.inputtype, self.input)
            sel = cfg.info
            if len(sel) and not sel.is_equal(model_in):
                # permissive on batching: SUPPORTS_BATCH is a backend
                # trait we cannot know without opening the framework
                batch = infer_batch_dim(sel, model_in)
                if batch is None:
                    raise TransferError(
                        f"{self.name}: model input {model_in!r} does not "
                        f"match stream caps {sel!r}. Check tensor_"
                        f"converter/tensor_transform output dims, or the "
                        f"input/inputtype properties.", pad="sink")
        if self.invoke_dynamic:
            out_cfg = TensorsConfig(TensorsInfo(), TensorFormat.FLEXIBLE,
                                    *rate)
        elif self.output and self.outputtype:
            out_info = TensorsInfo.make(self.outputtype, self.output)
            if batch is not None:
                out_info = TensorsInfo(
                    TensorInfo(i.name, i.type, (batch,) + tuple(i.shape))
                    for i in out_info)
            out_cfg = TensorsConfig(out_info, TensorFormat.STATIC, *rate)
        else:
            return {"src": None}  # model metadata needs the framework
        return {"src": Caps.from_config(out_cfg)}

    # -- device placement (fusion compiler) --------------------------------
    DEVICE_FUSIBLE = ("sync torch-cuda invokes on static caps "
                      "(no invoke-async/dynamic)")

    _TRACEABLE_FRAMEWORKS = ("torch-cuda",)

    def device_veto(self) -> Optional[str]:
        if self.invoke_async:
            return "invoke-async: output frames are decoupled from inputs"
        if self.invoke_dynamic:
            return "invoke-dynamic: per-frame output shapes (dynamic caps)"
        fw = (self.framework or "").lower()
        if fw in ("auto", ""):
            first = self.model.split(",")[0] if self.model else ""
            if not first.startswith("zoo://"):
                return (f"framework auto-detect on {first!r} cannot be "
                        f"proven to be the torch-cuda backend statically")
            return None  # zoo:// always resolves to the torch-cuda backend
        if fw not in self._TRACEABLE_FRAMEWORKS:
            return f"framework {fw!r} exposes no traceable invoke"
        return None

    def mesh_spec(self) -> str:
        """The declared ``mesh:`` custom option, "" when unsharded. The
        planner breaks runs at mesh-spec boundaries, as the JAX planner
        does; the port's backend refuses a mesh at open."""
        for part in str(self.custom or "").split(","):
            part = part.strip()
            if part.startswith("mesh:"):
                return part[len("mesh:"):].strip()
        return ""

    def plan_out_caps(self, incaps: Caps) -> Optional[Caps]:
        """Plan-time refinement of :meth:`static_transfer`: opens the
        framework (the fusion planner runs before start — the one caller
        allowed to) and answers the same caps :meth:`on_sink_caps` would
        negotiate, without its side effects."""
        self._open_fw()
        cfg = incaps.to_config()
        if cfg.format != TensorFormat.STATIC or self._out_info is None:
            return None
        sel = cfg.info
        batch = None
        if self._in_info is not None and len(sel) \
                and not sel.is_equal(self._in_info):
            batch = self._infer_batch(sel)
            if batch is None:
                return None
        out_info = self._out_info.copy()
        if batch is not None:
            out_info = TensorsInfo(
                TensorInfo(i.name, i.type, (batch,) + tuple(i.shape))
                for i in out_info)
        return Caps.from_config(TensorsConfig(
            out_info, TensorFormat.STATIC, cfg.rate_n, cfg.rate_d))

    def device_fn(self, ctx=None):
        """The backend's eager apply closure as a list -> list program.
        prefetch-host is ignored for MID-segment outputs (activations
        never leave the device, which is the point); the FusedSegment
        honors it for the segment's final outputs instead."""
        if self.device_veto() is not None:
            return None
        try:
            self._open_fw()
        except Exception:  # noqa: BLE001 -- decline, don't block launch
            logger.warning("%s: device_fn could not open the framework; "
                           "staying on the chain path", self.name,
                           exc_info=True)
            return None
        get = getattr(self.fw, "traceable_fn", None)
        tr = get() if callable(get) else None
        if tr is None:
            return None

        def fn(arrays):
            outs = tr(*arrays)
            return list(outs) if isinstance(outs, (list, tuple)) else [outs]

        return fn

    def _warmup_invoke(self, sel: TensorsInfo) -> None:
        """One zero-filled invoke with the NEGOTIATED stream shapes
        (incl. any batch dim), so the executable for the exact signature
        real frames will hit is made now (on the card: captured). A
        failure is not fatal here: real frames surface the same error
        through the normal path."""
        try:
            zeros = [np.zeros(tuple(i.shape), i.type.np_dtype)
                     for i in sel]
            self.fw.invoke(zeros)
            logger.info("%s: warmup invoke compiled %d input(s)",
                        self.name, len(zeros))
        except Exception as exc:  # noqa: BLE001
            logger.warning("%s: warmup invoke failed (ignored): %s",
                           self.name, exc)

    # -- hot path ---------------------------------------------------------
    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        if self._qos_should_drop(buf):
            # downstream can't keep up: skip the invoke (and the window
            # slot) entirely, so the card does no wasted work
            # (≙ throttling check, tensor_filter.c:532-584)
            self.stats.inc("qos_dropped")
            return
        if self._breaker is not None and not self._breaker.allow():
            # breaker OPEN: the backend is currently only producing
            # errors — shed without invoking (fail fast) and tell
            # upstream when to come back
            shed_frame(self, buf)
            return
        inputs = [c.raw for c in buf.chunks]
        if self._overlap is not None:
            self._dispatch_windowed(buf, inputs)
            return
        t0 = time.perf_counter_ns()
        c0 = getattr(self.fw, "compile_count", 0)
        try:
            outputs = self.fw.invoke(inputs)
        except InvokeDrop:
            # subplugin-signaled drop (≙ invoke result > 0): silent.
            # A deliberate drop is a WORKING backend for the breaker.
            if self._breaker is not None:
                self._breaker.record_success()
            self.stats.inc("frames_dropped")
            return
        except Exception as exc:  # noqa: BLE001
            self._account_invoke_error(exc)
            return
        if self._breaker is not None:
            self._breaker.record_success()
        self._note_recompiles(c0)
        # synchronous path: dispatch and completion are the same event
        dt = time.perf_counter_ns() - t0
        self._record_dispatch(dt)
        self._record_latency(dt)
        outputs = self._trim_padded_rows(buf, outputs)
        if self.prefetch_host:
            # the frame leaves carrying PendingHost handles; frames queued
            # while a copy batch is in flight share the next one
            outputs = submit_fetch(outputs)
        self.push(buf.with_chunks([Chunk(o) for o in outputs]))

    # -- in-flight window (overlapped execution) ---------------------------
    def _dispatch_windowed(self, buf: Buffer, inputs: List[Any]) -> None:
        """DISPATCHER side of the overlap split: take a window slot
        (blocking here IS the backpressure — it propagates into the
        upstream queue exactly like a slow synchronous invoke), enqueue
        the frame, and hand completion to the completer thread. The
        chain thread never waits on the device."""
        t_disp = self._overlap.window.acquire()
        t0 = time.perf_counter_ns()
        c0 = getattr(self.fw, "compile_count", 0)
        try:
            handle = self.fw.dispatch(inputs)
        except InvokeDrop:
            # release FIRST: the completer never sees this frame
            self._overlap.window.release(t_disp)
            if self._breaker is not None:
                self._breaker.record_success()
            self.stats.inc("frames_dropped")
            return
        except Exception as exc:  # noqa: BLE001
            self._overlap.window.release(t_disp)
            self._account_invoke_error(exc)
            return
        try:
            self._note_recompiles(c0)
            self._record_dispatch(time.perf_counter_ns() - t0)
            self._overlap.submit(buf, handle, t_disp)
        except BaseException:
            # a dispatch-side failure after acquire: the slot would
            # otherwise leak window depth permanently
            self._overlap.window.release(t_disp)
            raise

    def _complete_frame(self, entry) -> Buffer:
        """COMPLETER side: materialize one frame's results and run the
        per-frame accounting the sync path does inline. Raises on invoke
        failure — the executor routes that to :meth:`_complete_error`."""
        outputs = self.fw.complete(entry.payload)
        if self._breaker is not None:
            self._breaker.record_success()
        self._record_latency(time.perf_counter_ns() - entry.t_dispatch_ns)
        outputs = self._trim_padded_rows(entry.buf, outputs)
        if self.prefetch_host:
            outputs = submit_fetch(outputs)
        return entry.buf.with_chunks([Chunk(o) for o in outputs])

    def _complete_error(self, entry, exc: BaseException) -> None:
        """A frame that failed at completion: the same per-frame
        accounting as a sync invoke failure (invoke_errors /
        frames_dropped / breaker), though the chain thread returned long
        ago: the breaker records it from the completer thread."""
        self._account_invoke_error(exc)

    @staticmethod
    def _trim_padded_rows(buf: Buffer, outputs: List[Any]) -> List[Any]:
        """Drop the padded rows of a micro-batched frame's HOST outputs.

        An upstream that pads a stack to a fixed signature (query
        serversrc ``batch=K``) says how many rows are real in
        ``batch_valid_rows``. Host outputs (ndarrays, CPU tensors) whose
        leading dim is the padded batch lose the padding (a view); any
        other output (flat vectors, detection tables) passes through.
        Outputs on the card ship padded: slicing them costs a device op
        a frame, and the one copy of the stack to the host stays one
        copy; the consumer reads the real rows only."""
        nv = buf.extras.get("batch_valid_rows")
        if nv is None or not buf.chunks:
            return outputs
        pad = buf.chunks[0].shape[0] if buf.chunks[0].shape else None
        return [o[:nv] if not is_device_tensor(o)
                and isinstance(o, (np.ndarray, torch.Tensor))
                and o.ndim >= 1 and pad is not None
                and o.shape[0] == pad and pad > nv else o
                for o in outputs]

    def transfer_report(self) -> dict:
        """Window occupancy / overlap stats; {} when running
        synchronously."""
        return self._overlap.report() if self._overlap is not None else {}

    def handle_event(self, pad: Pad, event: Event) -> None:
        if self._overlap is not None:
            # serialized events (EOS, caps, segment) must not overtake
            # in-flight frames: barrier until the completer has settled
            # and pushed everything dispatched before this event
            self._overlap.flush()
        if isinstance(event, (SegmentEvent, FlushEvent)):
            # new segment / flush = PTS discontinuity: stale throttle state
            # would otherwise qos-drop every post-restart frame forever
            self._throttle_period_ns = 0
            self._next_accept_ts = None
        super().handle_event(pad, event)

    # -- QoS throttling ----------------------------------------------------
    def _qos_should_drop(self, buf: Buffer) -> bool:
        if self._throttle_period_ns <= 0 or buf.pts is None:
            return False
        if self._next_accept_ts is not None and buf.pts < self._next_accept_ts:
            return True
        self._next_accept_ts = buf.pts + self._throttle_period_ns
        return False

    def handle_upstream_event(self, pad: Pad, event: Event) -> None:
        if isinstance(event, QosEvent):
            # keep the larger of the downstream-requested spacing and our
            # own sustainable cadence: the invoke latency synchronously,
            # latency/K under a K-frame window (K completions in flight)
            window = self._overlap.window.limit \
                if self._overlap is not None else 1
            lat_ns = int(self.latency_average_us() * 1e3) // max(1, window)
            self._throttle_period_ns = max(event.period_ns, lat_ns) \
                if event.proportion > 1.0 else 0
            if self._throttle_period_ns == 0:
                self._next_accept_ts = None
            return  # consumed: the filter is the throttling point
        super().handle_upstream_event(pad, event)

    def _account_invoke_error(self, exc: BaseException) -> None:
        # invoke failure drops THIS frame but keeps the pipeline alive
        # (≙ tensor_filter.c:961-963); surfaced on the bus as a
        # rate-limited warning (1, 2, 4, 8, ... then every 64th)
        n = self.stats.inc("invoke_errors")
        self.stats.inc("frames_dropped")
        if self._breaker is not None:
            self._breaker.record_failure()
        logger.warning("%s: invoke failed (frame dropped, pipeline "
                       "kept): %s", self.name, exc)
        if n & (n - 1) == 0 or n % 64 == 0:
            self.post_message("warning", error=str(exc),
                              invoke_errors=n,
                              remedy="check the model's input "
                                     "dims/dtypes against the "
                                     "negotiated caps")

    # -- stats ------------------------------------------------------------
    def _note_recompiles(self, c0: int) -> None:
        """Frame-path compilations: the backend made an executable for a
        new signature DURING a frame's invoke/dispatch (warmup does not
        route through here, so it never counts). A warmed line holds
        ``jit_recompiles`` at zero."""
        d = getattr(self.fw, "compile_count", 0) - c0
        if d > 0:
            self.stats.add(jit_recompiles=d)

    def _record_dispatch(self, dt_ns: int) -> None:
        """Record one frame's dispatch-to-RETURN time (the chain-thread
        cost). Synchronously it equals the completion latency; under a
        window it is the enqueue alone."""
        with self._stats_lock:
            self._recent_dispatch.append(dt_ns)

    def dispatch_average_us(self) -> float:
        """Rolling dispatch-to-return average over the last 10 frames,
        µs — the chain-thread cost per frame under the window."""
        with self._stats_lock:
            if not self._recent_dispatch:
                return 0.0
            return (sum(self._recent_dispatch)
                    / len(self._recent_dispatch) / 1e3)

    def _record_latency(self, dt_ns: int) -> None:
        """Record one frame's dispatch-to-COMPLETION latency (chain
        thread synchronously, completer thread under a window); with
        ``latency=1`` keep the rolling estimate in ``latency_us`` and
        post it when it drifts."""
        report_us = None
        with self._stats_lock:
            self._invoke_count += 1
            self._recent_latency.append(dt_ns)
            if self.latency:
                est_us = (sum(self._recent_latency)
                          / len(self._recent_latency) / 1e3)
                self.latency_us = est_us
                rep = self._reported_latency_us
                if rep is None or est_us > rep * _LATENCY_REPORT_HEADROOM \
                        or est_us < rep * _LATENCY_IMPROVE_THRESHOLD:
                    self._reported_latency_us = est_us
                    report_us = est_us
        if report_us is not None:
            self.post_message("latency", latency_us=report_us)

    def latency_average_us(self) -> float:
        """Rolling invoke average over the last 10 frames, µs
        (≙ latency property, tensor_filter.c:408-448)."""
        with self._stats_lock:
            if not self._recent_latency:
                return 0.0
            return (sum(self._recent_latency)
                    / len(self._recent_latency) / 1e3)

    def throughput_fps(self) -> float:
        """Invokes/sec since start (≙ throughput prop, tensor_filter.c:452)."""
        if self._start_time is None or self._invoke_count == 0:
            return 0.0
        dt = time.monotonic() - self._start_time
        return self._invoke_count / dt if dt > 0 else 0.0
