"""tensor_filter — the inference element.

Port of ``nnstreamer_tpu/elements/filter.py`` (≙ gst/nnstreamer/
tensor_filter/tensor_filter.c + tensor_filter_common.c): property parsing,
framework auto-detection, model-vs-caps verification with batch-dim
tolerance, the synchronous invoke, and the rolling latency/throughput
statistics. Chunks handed to the backend may already live on the card;
outputs stay there until a host boundary.

Not ported yet, each refused at start when set (``NOT_PORTED``): the
in-flight window and its reorder/donation options, prefetch-host, the
circuit breaker, warmup, invoke-async/invoke-dynamic, suspend, the
shared-model key, input/output combination and custom properties. QoS
throttling is not ported either: the port's sinks send no QoS events.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from ..filters.base import Accelerator, FilterProperties, InvokeDrop
from ..filters.registry import detect_framework, find_filter
from ..pipeline.element import Element
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorInfo, TensorsConfig, TensorsInfo
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
        "latency": 0,            # 1 = enable latency property updates
        "throughput": 0,
    }
    NOT_PORTED = {
        "custom": "",
        "invoke-dynamic": False,
        "invoke-async": False,
        "suspend": 0,
        "shared-tensor-filter-key": "",
        "input-combination": "",
        "output-combination": "",
        "prefetch-host": False,
        "breaker-threshold": 0,
        "breaker-reset-ms": 1000.0,
        "breaker-retry-after-ms": 50.0,
        "in-flight": 1,
        "reorder": True,
        "reorder-deadline-ms": 1000.0,
        "donate-input": False,
        "warmup": False,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.fw = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._recent_latency = collections.deque(maxlen=_MAX_RECENT)
        self._invoke_count = 0
        self._stats_lock = threading.Lock()
        self._start_time = None
        self._batch: Optional[int] = None  # batched-invoke leading dim
        self._reported_latency_us: Optional[float] = None
        self.stats.update({"invoke_errors": 0, "frames_dropped": 0})

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

    def start(self) -> None:
        super().start()
        self._open_fw()
        self._start_time = time.monotonic()

    def stop(self) -> None:
        super().stop()
        if self.fw is not None:
            self.fw.close()
            self.fw = None

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

    # -- hot path ---------------------------------------------------------
    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        inputs = [c.raw for c in buf.chunks]
        t0 = time.perf_counter_ns()
        try:
            outputs = self.fw.invoke(inputs)
        except InvokeDrop:
            # subplugin-signaled drop (≙ invoke result > 0): silent
            self.stats.inc("frames_dropped")
            return
        except Exception as exc:  # noqa: BLE001
            self._account_invoke_error(exc)
            return
        self._record_latency(time.perf_counter_ns() - t0)
        self.push(buf.with_chunks([Chunk(o) for o in outputs]))

    def _account_invoke_error(self, exc: BaseException) -> None:
        # invoke failure drops THIS frame but keeps the pipeline alive
        # (≙ tensor_filter.c:961-963); surfaced on the bus as a
        # rate-limited warning (1, 2, 4, 8, ... then every 64th)
        n = self.stats.inc("invoke_errors")
        self.stats.inc("frames_dropped")
        logger.warning("%s: invoke failed (frame dropped, pipeline "
                       "kept): %s", self.name, exc)
        if n & (n - 1) == 0 or n % 64 == 0:
            self.post_message("warning", error=str(exc),
                              invoke_errors=n,
                              remedy="check the model's input "
                                     "dims/dtypes against the "
                                     "negotiated caps")

    # -- stats ------------------------------------------------------------
    def _record_latency(self, dt_ns: int) -> None:
        """Record one frame's invoke latency; with ``latency=1`` keep the
        rolling estimate in ``latency_us`` and post it when it drifts."""
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
