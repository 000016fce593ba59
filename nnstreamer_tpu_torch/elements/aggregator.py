"""tensor_aggregator — temporal batching of tensor frames.

Port of ``nnstreamer_tpu/elements/aggregator.py`` (≙ gst/nnstreamer/
elements/gsttensor_aggregator.c): concatenate ``frames-out`` input
frames into one output (on ``frames-dim``), advance by ``frames-flush``
(sliding window when flush < out), adjust the framerate.
``concat=false`` stacks on a new outermost dim instead, which is how a
per-frame ``3:224:224`` stream becomes a batched ``3:224:224:32`` one
(with ``concat=true`` and ``frames-dim=3`` the frames are joined along
the height, since a trailing ``:1`` is not a dimension of the frame).
``frames-in > frames-out`` splits each input along ``frames-dim``.

The window is joined, and a split input sliced, on the host, as in the
reference; outputs are host arrays.

Not ported: ``snapshot_state``/``restore_state`` (the checkpoint layer
is not in the port).
"""
from __future__ import annotations

import collections
from typing import Deque, Optional

from ..pipeline.element import TransformElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorInfo, TensorsConfig, TensorsInfo
from .combiner import host_concat, host_contiguous, host_stack


@register_element("tensor_aggregator")
class TensorAggregator(TransformElement):
    PROPS = {"frames-in": 1, "frames-out": 1, "frames-flush": 0,
             "frames-dim": 3, "concat": True, "silent": True}
    RESTART_SAFE = False  # a restart would drop the aggregation window

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._window: Deque[Buffer] = collections.deque()

    def _np_axis(self, ndim: int) -> int:
        ref_dim = int(self.frames_dim)
        if ref_dim >= ndim:
            return 0
        return ndim - 1 - ref_dim

    def transform_caps(self, incaps: Caps) -> Optional[Caps]:
        cfg = incaps.to_config()
        if not len(cfg.info):
            return incaps
        out = TensorsInfo()
        if self.frames_in > self.frames_out:
            # splitting mode: one k-frame buffer -> k/out per-chunk buffers
            ratio = self.frames_in // max(1, self.frames_out)
            for info in cfg.info:
                shape = list(info.shape)
                axis = self._np_axis(len(shape))
                if shape[axis] % ratio:
                    raise ValueError(
                        f"{self.name}: dim {shape[axis]} not divisible by "
                        f"frames-in/frames-out ratio {ratio}")
                shape[axis] //= ratio
                out.append(TensorInfo(info.name, info.type, tuple(shape)))
            rate_n = cfg.rate_n * ratio if cfg.rate_n > 0 else cfg.rate_n
            return Caps.from_config(
                TensorsConfig(out, cfg.format, rate_n, cfg.rate_d))
        n = self.frames_out // max(1, self.frames_in)
        for info in cfg.info:
            shape = list(info.shape)
            if self.concat and shape:
                axis = self._np_axis(len(shape))
                shape[axis] *= n
            else:
                shape = [n] + shape
            out.append(TensorInfo(info.name, info.type, tuple(shape)))
        flush = self.frames_flush or self.frames_out
        rate_n, rate_d = cfg.rate_n, cfg.rate_d
        if cfg.rate_n > 0:
            rate_d = cfg.rate_d * max(1, flush)
        return Caps.from_config(TensorsConfig(out, cfg.format, rate_n, rate_d))

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        if self.frames_in > self.frames_out:
            return self._split(buf)
        n = self.frames_out // max(1, self.frames_in)
        if n <= 1:
            return buf
        self._window.append(buf)
        if len(self._window) < n:
            return None
        frames = list(self._window)
        flush = self.frames_flush or n
        for _ in range(min(flush, len(self._window))):
            self._window.popleft()
        chunks = []
        for i in range(len(frames[0].chunks)):
            arrs = [f.chunks[i].host() for f in frames]
            if self.concat:
                axis = self._np_axis(arrs[0].ndim)
                chunks.append(Chunk(host_concat(arrs, axis)))
            else:
                chunks.append(Chunk(host_stack(arrs)))
        out = Buffer(chunks, pts=frames[0].pts)
        if frames[0].pts is not None and frames[-1].pts is not None:
            out.duration = (frames[-1].pts - frames[0].pts +
                            (frames[-1].duration or 0))
        return out

    def _split(self, buf: Buffer) -> None:
        """Splitting mode: emit ratio buffers per input, slicing each chunk
        along frames-dim (≙ gsttensor_aggregator.c frames-in > frames-out)."""
        ratio = self.frames_in // max(1, self.frames_out)
        arrs = [c.host() for c in buf.chunks]
        step_ns = (buf.duration // ratio) if buf.duration else None
        for i in range(ratio):
            chunks = []
            for a in arrs:
                axis = self._np_axis(a.ndim)
                size = a.shape[axis] // ratio
                sl = [slice(None)] * a.ndim
                sl[axis] = slice(i * size, (i + 1) * size)
                chunks.append(Chunk(host_contiguous(a[tuple(sl)])))
            pts = (buf.pts + i * step_ns) if (buf.pts is not None and
                                             step_ns) else buf.pts
            self.push(Buffer(chunks, pts=pts, duration=step_ns))
        return None

    def on_eos(self) -> None:
        self._window.clear()
