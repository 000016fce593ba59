"""tensor_demux / tensor_split — 1-to-N stream splitters.

Port of ``nnstreamer_tpu/elements/splitter.py`` (≙ gst/nnstreamer/
elements/gsttensor_demux.c: split a multi-tensor stream into per-pad
streams, ``tensorpick`` selection/reordering; gsttensor_split.c: slice
ONE tensor along a dim by ``tensorseg``).

``tensor_demux`` passes chunk references along, so CUDA chunks stay on
the card; ``tensor_split`` slices on the host, as the reference does.
"""
from __future__ import annotations

from typing import List, Optional

from ..pipeline.element import Element
from ..pipeline.pad import Pad, PadDirection
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import (TensorInfo, TensorsConfig, TensorsInfo,
                            parse_dimension)
from .combiner import host_contiguous, pad_sort_key


def _ensure_pads(elem: Element, n: int) -> List[Pad]:
    """The element's src pads in natural order, requested up to ``n``."""
    while len(elem.src_pads) < n:
        elem.request_pad(PadDirection.SRC)
    return [p for _, p in sorted(elem.src_pads.items(),
                                 key=lambda kv: pad_sort_key(kv[0]))]


@register_element("tensor_demux")
class TensorDemux(Element):
    """Per-src-pad tensor selection. ``tensorpick`` picks/reorders, e.g.
    "0,1:2,2" gives pad0 tensor 0, pad1 tensors 1+2, pad2 tensor 2;
    default: one pad per tensor."""

    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src_%u": "other/tensors"}
    PROPS = {"tensorpick": ""}

    def _picks(self, num_tensors: int) -> List[List[int]]:
        if self.tensorpick:
            return [[int(i) for i in grp.split(":")]
                    for grp in self.tensorpick.split(",")]
        return [[i] for i in range(num_tensors)]

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        cfg = caps.to_config()
        picks = self._picks(len(cfg.info))
        pads = _ensure_pads(self, len(picks))
        for p, pick in zip(pads, picks):
            info = TensorsInfo(cfg.info[i].copy() for i in pick)
            out = TensorsConfig(info, cfg.format, cfg.rate_n, cfg.rate_d)
            if p.is_linked:
                self.set_src_caps(Caps.from_config(out), pad=p)

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        picks = self._picks(len(buf.chunks))
        pads = _ensure_pads(self, len(picks))
        for p, pick in zip(pads, picks):
            if p.is_linked:
                p.push(buf.with_chunks([buf.chunks[i] for i in pick]))

    def static_transfer(self, in_caps):
        """Per-src-pad pick of the input tensors (pads map to picks by
        their name index; no pads are created)."""
        caps = in_caps.get("sink")
        cfg = caps.to_config() \
            if caps is not None and caps.is_fixed() else None
        if cfg is None or not len(cfg.info):
            return {p: None for p in self.src_pads}
        picks = self._picks(len(cfg.info))
        out = {}
        for pname in self.src_pads:
            _, _, idx = pname.rpartition("_")
            if not idx.isdigit() or int(idx) >= len(picks):
                out[pname] = None
                continue
            info = TensorsInfo(cfg.info[i].copy() for i in picks[int(idx)])
            out[pname] = Caps.from_config(TensorsConfig(
                info, cfg.format, cfg.rate_n, cfg.rate_d))
        return out


@register_element("tensor_split")
class TensorSplit(Element):
    """Slice one tensor into N along a dim. ``tensorseg`` gives per-pad
    slice sizes in reference dim-string form (e.g. "1:100:100,2:100:100"
    splits channels 1+2); ``tensorpick`` optionally reorders pads. The
    tensor is read on the host, as in the reference."""

    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src_%u": "other/tensors"}
    PROPS = {"tensorseg": "", "tensorpick": ""}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._segs: Optional[List[tuple]] = None
        self._axis: Optional[int] = None

    def _parse_segs(self, shape) -> None:
        if not self.tensorseg:
            raise ValueError(f"{self.name}: 'tensorseg' property is required")
        segs = [parse_dimension(s) for s in self.tensorseg.split(",")]
        ndim = len(shape)
        segs = [tuple([1] * (ndim - len(s)) + list(s)) if len(s) < ndim
                else s for s in segs]
        # find the split axis: the one where sizes differ/accumulate
        axis = None
        for d in range(ndim):
            if sum(s[d] for s in segs) == shape[d] and \
                    any(s[d] != shape[d] for s in segs):
                axis = d
                break
        if axis is None:
            # all dims equal across segs: split on outermost
            axis = 0
        if sum(s[axis] for s in segs) != shape[axis]:
            raise ValueError(
                f"{self.name}: tensorseg {self.tensorseg!r} does not tile "
                f"shape {shape}")
        self._segs, self._axis = segs, axis

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        cfg = caps.to_config()
        info = cfg.info[0]
        self._parse_segs(info.shape)
        pads = _ensure_pads(self, len(self._segs))
        for p, seg in zip(pads, self._segs):
            shape = list(info.shape)
            shape[self._axis] = seg[self._axis]
            out = TensorsConfig(
                TensorsInfo([TensorInfo(info.name, info.type, tuple(shape))]),
                cfg.format, cfg.rate_n, cfg.rate_d)
            if p.is_linked:
                self.set_src_caps(Caps.from_config(out), pad=p)

    def static_transfer(self, in_caps):
        """Per-src-pad slice shapes from ``tensorseg`` (missing or
        non-tiling segs are provable errors)."""
        caps = in_caps.get("sink")
        cfg = caps.to_config() \
            if caps is not None and caps.is_fixed() else None
        if cfg is None or not len(cfg.info) or not cfg.info.is_valid():
            return {p: None for p in self.src_pads}
        info = cfg.info[0]
        self._parse_segs(info.shape)  # raises the runtime's ValueError
        out = {}
        for pname in self.src_pads:
            _, _, idx = pname.rpartition("_")
            if not idx.isdigit() or int(idx) >= len(self._segs):
                out[pname] = None
                continue
            shape = list(info.shape)
            shape[self._axis] = self._segs[int(idx)][self._axis]
            out[pname] = Caps.from_config(TensorsConfig(
                TensorsInfo([TensorInfo(info.name, info.type,
                                        tuple(shape))]),
                cfg.format, cfg.rate_n, cfg.rate_d))
        return out

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        arr = buf.chunks[0].host()
        if self._segs is None:
            self._parse_segs(tuple(arr.shape))
        pads = _ensure_pads(self, len(self._segs))
        off = 0
        for p, seg in zip(pads, self._segs):
            size = seg[self._axis]
            sl = [slice(None)] * arr.ndim
            sl[self._axis] = slice(off, off + size)
            off += size
            if p.is_linked:
                p.push(buf.with_chunks(
                    [Chunk(host_contiguous(arr[tuple(sl)]))]))
