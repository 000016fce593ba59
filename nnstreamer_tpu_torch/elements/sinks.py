"""tensor_sink / tensor_debug — terminal & diagnostic elements.

Port of ``nnstreamer_tpu/elements/sinks.py``.

≙ gst/nnstreamer/elements/gsttensor_sink.c (appsink-like callback sink
emitting new-data signals) and gsttensor_debug.c (passthrough that logs
caps/metadata).
"""
from __future__ import annotations

from typing import Callable

from ..pipeline.basic import AppSink
from ..pipeline.element import TransformElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer
from ..utils.log import logger


@register_element("tensor_sink")
class TensorSink(AppSink):
    """new-data / stream-start / eos signal emission on tensor streams."""

    PROPS = {"emit-signal": True, "signal-rate": 0, "silent": True,
             "max-buffers": 0}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._signal_count = 0
        self._handlers = {"new-data": [], "eos": []}

    def connect_signal(self, signal: str,
                       handler: Callable) -> None:
        self._handlers[signal].append(handler)

    def render(self, buf: Buffer) -> None:
        with self._lock:
            self.buffers.append(buf)
            if self.max_buffers > 0 and len(self.buffers) > self.max_buffers:
                self.buffers.pop(0)
        # honor both spellings: "emit-signal" (reference tensor_sink) and
        # the inherited appsink "emit-signals"
        if not (self.emit_signal and self.emit_signals):
            return
        self._signal_count += 1
        if self.signal_rate > 0 and \
                (self._signal_count % max(1, self.signal_rate)) != 0:
            return
        if self.callback is not None:
            self.callback(buf)
        for h in self._handlers["new-data"]:
            h(buf)

    def on_eos(self) -> None:
        for h in self._handlers["eos"]:
            h()
        super().on_eos()


@register_element("tensor_debug")
class TensorDebug(TransformElement):
    """Passthrough logging caps/timing/shape metadata
    (output-type: none | console | cap | metadata)."""

    PROPS = {"output-type": "console", "capability": True, "metadata": True}

    def transform(self, buf: Buffer) -> Buffer:
        if self.output_type != "none":
            parts = [f"{self.name}: pts={buf.pts}"]
            if self.metadata:
                parts.append(f"chunks={[str(c) for c in buf.chunks]}")
            if self.capability and self.sinkpad.caps is not None:
                parts.append(f"caps={self.sinkpad.caps}")
            logger.info(" ".join(parts))
        return buf
