"""tensor_crop — crop a tensor stream using crop-info arriving on a
second *stream* (not properties).

Port of ``nnstreamer_tpu/elements/crop.py`` (≙ gst/nnstreamer/elements/
gsttensor_crop.c): the ``raw`` pad carries frames, the ``info`` pad
carries regions (e.g. from the tensor_region decoder); the output is a
flexible stream of cropped tensors (one chunk per region). Region
tensor: [N, 4] uint32 (x, y, w, h) in pixels of the raw frame.

The two pads pair buffers one to one, in arrival order, under a lock:
neither branch may drop frames, and the ``info`` branch wants a queue
of its own, or the lock serialises the two branches. Frame and regions
are read on the host, as in the reference, and the crops are host
arrays.
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, Optional

import numpy as np

from ..pipeline.element import Element
from ..pipeline.events import CapsEvent, EosEvent, Event
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig, TensorsInfo
from ..tensors.meta import TensorMetaInfo
from ..tensors.types import TensorFormat
from .combiner import host_contiguous


@register_element("tensor_crop")
class TensorCrop(Element):
    SINK_TEMPLATES = {"raw": "other/tensors", "info": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    PROPS = {"lateness": -1, "silent": True}

    # -- device placement (fusion compiler) --------------------------------
    # deliberately None: crop pairs TWO streams under a lock (stateful
    # cross-buffer queues) and emits a data-dependent number of
    # variable-shaped chunks — none of which one captured graph can
    # express. The planner also rejects it structurally (two sink pads).
    DEVICE_FUSIBLE = None

    def device_veto(self) -> Optional[str]:
        return ("stateful two-stream pairing with data-dependent "
                "output shapes")

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._raw_q: Deque[Buffer] = collections.deque()
        self._info_q: Deque[Buffer] = collections.deque()
        self._lock = threading.Lock()
        self._eos = {"raw": False, "info": False}
        self._sent_eos = False

    def handle_event(self, pad: Pad, event: Event) -> None:
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            if pad.name == "raw":
                cfg = event.caps.to_config()
                out = TensorsConfig(TensorsInfo(), TensorFormat.FLEXIBLE,
                                    cfg.rate_n, cfg.rate_d)
                self.set_src_caps(Caps.from_config(out))
            return
        if isinstance(event, EosEvent):
            fire = False
            with self._lock:
                self._eos[pad.name] = True
                if all(self._eos.values()) and not self._sent_eos:
                    self._sent_eos = True
                    fire = True
            if fire:
                self.forward_event(event)
            return
        if pad.name == "raw":
            self.forward_event(event)

    def static_transfer(self, in_caps):
        """Flexible output (per-region crops have data-dependent dims);
        the rate follows the raw pad."""
        raw = in_caps.get("raw")
        if raw is None or not raw.is_fixed():
            return {"src": None}
        cfg = raw.to_config()
        return {"src": Caps.from_config(TensorsConfig(
            TensorsInfo(), TensorFormat.FLEXIBLE, cfg.rate_n, cfg.rate_d))}

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        with self._lock:
            (self._raw_q if pad.name == "raw" else self._info_q).append(buf)
            ready = []
            while self._raw_q and self._info_q:
                ready.append((self._raw_q.popleft(), self._info_q.popleft()))
        for raw, info in ready:
            out = self._crop(raw, info)
            if out is not None:
                self.srcpad.push(out)

    def _crop(self, raw: Buffer, info: Buffer) -> Optional[Buffer]:
        frame = raw.chunks[0].host()
        regions = np.asarray(info.chunks[0].host()).reshape(-1, 4) \
            .astype(np.int64)
        chunks = []
        h, w = frame.shape[0], frame.shape[1]
        for x, y, cw, ch in regions:
            if cw <= 0 or ch <= 0:
                continue
            x0, y0 = max(0, int(x)), max(0, int(y))
            x1, y1 = min(w, x0 + int(cw)), min(h, y0 + int(ch))
            if x1 <= x0 or y1 <= y0:
                continue
            patch = host_contiguous(frame[y0:y1, x0:x1])
            meta = TensorMetaInfo.from_info(
                Buffer.from_arrays([patch]).to_infos()[0],
                format=TensorFormat.FLEXIBLE)
            chunks.append(Chunk(patch, meta=meta))
        if not chunks:
            return None
        return raw.with_chunks(chunks)
