"""tensor_delta / tensor_delta_stitch — ROI-gated compute skip.

Port of ``nnstreamer_tpu/elements/delta.py``. The wire half of the delta
transport (edge/wire.py ``wire-codec=delta``) stops re-shipping pixels
that did not change; this is the compute half: stop re-*inferring*
them. ``tensor_delta`` compares each frame to the previous one on a
``tile x tile`` grid and

- **mask** mode annotates the frame (``extras["delta_mask"]``) and
  passes it through; downstream ``tensor_if compared-value=CUSTOM
  compared-value-option=delta_changed`` gets frame-level gating (the
  custom condition is registered at import);
- **gate** mode drops unchanged frames outright (``transform() ->
  None``), so ``tensor_filter`` never sees them;
- **roi** mode replaces the frame with the stack of *changed* tile
  crops; only those crops reach inference, and ``tensor_delta_stitch``
  downstream scatters the per-crop results back over a cached canvas so
  skipped regions reuse their last output.

The detector state is one reference frame; Segment/Flush events and a
caps/layout change reset it, and ``hold=N`` forces a full (keyframe)
frame every N frames so a downstream joining mid-stream converges.

``device=true`` computes the tile energies with torch ops on the card
for a chunk on the card (``ops/delta.py``); the reference frame then
stays there too, and only the (H/t, W/t) grid crosses to the host. The
channel mean and the blocked mean reduce in another order than the
host path's numpy (and than XLA's), so energies agree within float32
rounding; gate decisions are equal wherever no tile energy sits within
that rounding of ``threshold``.

A bf16 chunk (a CPU ``torch.bfloat16`` on the host) is cropped and
stitched on its uint16 bit patterns.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..edge.protocol import host_array, host_value
from ..pipeline.element import TransformElement
from ..pipeline.events import FlushEvent, SegmentEvent
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from .flowctl import register_if_condition

# frame-level custom condition for tensor_if: frames that never passed
# through tensor_delta count as changed (fail open, never drop blind)
register_if_condition(
    "delta_changed", lambda buf: bool(buf.extras.get("delta_changed", True)))


def _spatial(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """First two dims are the spatial grid; 1-D tensors gate as (N, 1)."""
    if len(shape) == 1:
        return int(shape[0]), 1
    return int(shape[0]), int(shape[1])


def _collapse(value) -> np.ndarray:
    """A host value (ndarray, or CPU bf16 tensor) (H, W, ...) -> (H, W)
    float32, trailing axes (channels) averaged out: change in any
    channel raises the tile's energy."""
    a = (value.to(torch.float32).numpy() if isinstance(value, torch.Tensor)
         else value.astype(np.float32, copy=False))
    return a.reshape(_spatial(a.shape) + (-1,)).mean(axis=2)


def _collapse_device(raw: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return raw.to(torch.float32).reshape(h, w, -1).mean(dim=2)


def _tile_error_host(cur: np.ndarray, ref: np.ndarray,
                     tile: int) -> np.ndarray:
    """(gh, gw) mean-abs-diff per tile, zero-padding ragged edges (pads
    are identical in cur and ref so they contribute no energy)."""
    h, w = cur.shape
    gh, gw = math.ceil(h / tile), math.ceil(w / tile)
    d = np.zeros((gh * tile, gw * tile), np.float32)
    d[:h, :w] = np.abs(cur - ref)
    return d.reshape(gh, tile, gw, tile).mean(axis=(1, 3))


@register_element("tensor_delta")
class TensorDelta(TransformElement):
    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    RESTART_SAFE = True  # worst case after restart: one extra keyframe
    PROPS = {
        "mode": "gate",     # mask | gate | roi
        "tile": 32,         # change-grid tile edge (pixels)
        "threshold": 0.0,   # mean-abs-diff above which a tile is "changed"
        "hold": 0,          # force a full frame every N frames (0 = never)
        "device": False,    # tile energies on the card for card chunks
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if str(self.mode) not in ("mask", "gate", "roi"):
            raise ValueError(f"tensor_delta: unknown mode {self.mode!r}")
        self._ref = None            # previous frame, collapsed (host or card)
        self._ref_key = None        # (shape, type) the reference was cut from
        self._since_full = 0        # frames since the last full frame
        self.stats.update({"delta_frames_skipped": 0, "delta_tiles_total": 0,
                           "delta_tiles_skipped": 0, "delta_keyframes": 0})

    def handle_event(self, pad, event) -> None:
        if isinstance(event, (SegmentEvent, FlushEvent)):
            self._ref = None  # racecheck: ok(events and chain are serialized per element)
            self._ref_key = None
            self._since_full = 0
        super().handle_event(pad, event)

    # -- detection ---------------------------------------------------

    def _on_card(self, c: Chunk, h: int, w: int, tile: int) -> bool:
        return (bool(self.device) and c.is_device
                and h % tile == 0 and w % tile == 0)

    def _energy(self, c: Chunk) -> Optional[np.ndarray]:
        """(gh, gw) tile energies vs the reference, or None when this
        frame must go out full (first frame / layout change / hold)."""
        tile = max(1, int(self.tile))
        key = (tuple(c.shape), str(c.type))
        hold = int(self.hold)
        if (self._ref is None or key != self._ref_key
                or (hold > 0 and self._since_full + 1 >= hold)):
            self._ref = None
            self._ref_key = key
            return None
        h, w = _spatial(c.shape)
        if self._on_card(c, h, w, tile):
            from ..ops.delta import tile_error

            cur = _collapse_device(c.raw, h, w)
            ref = self._ref
            if not isinstance(ref, torch.Tensor):
                ref = torch.from_numpy(ref).to(cur.device)
            # the (gh, gw) energies cross the host boundary
            err = Chunk(tile_error(cur, ref.to(cur.device), tile)).host()
            self._ref = cur
            return err
        cur = _collapse(c.host())
        ref = self._ref
        if isinstance(ref, torch.Tensor):
            ref = ref.cpu().numpy()  # the previous frame's, kept on the card
        err = _tile_error_host(cur, ref, tile)
        self._ref = cur
        return err

    def _remember(self, c: Chunk) -> None:
        """Seed the reference from a frame that went out full."""
        tile = max(1, int(self.tile))
        h, w = _spatial(c.shape)
        if self._on_card(c, h, w, tile):
            self._ref = _collapse_device(c.raw, h, w)
        else:
            self._ref = _collapse(c.host())
        self._since_full = 0

    # -- transform ---------------------------------------------------

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        c = buf.chunks[0]
        err = self._energy(c)
        if err is None:  # full frame (keyframe-equivalent)
            self._remember(c)
            self.stats.inc("delta_keyframes")
            out = buf.with_chunks(buf.chunks)
            out.extras["delta_changed"] = True
            out.extras["delta_full"] = 1
            return out
        self._since_full += 1
        changed = err > float(self.threshold)
        gh, gw = changed.shape
        n_changed = int(changed.sum())
        self.stats.add(delta_tiles_total=gh * gw,
                       delta_tiles_skipped=gh * gw - n_changed)
        mode = str(self.mode)
        if mode == "mask":
            out = buf.with_chunks(buf.chunks)
            out.extras["delta_changed"] = n_changed > 0
            out.extras["delta_mask"] = changed
            out.extras["delta_grid"] = (gh, gw)
            return out
        if n_changed == 0:  # gate/roi: nothing moved, skip the frame
            self.stats.inc("delta_frames_skipped")
            return None
        if mode == "gate":
            out = buf.with_chunks(buf.chunks)
            out.extras["delta_changed"] = True
            out.extras["delta_mask"] = changed
            out.extras["delta_grid"] = (gh, gw)
            return out
        # roi: ship only the changed tile crops, zero-padded at ragged
        # edges so the stack is rectangular: (n, tile, tile, C)
        tile = max(1, int(self.tile))
        arr, name = host_array(c.host())
        h, w = _spatial(arr.shape)
        a3 = arr.reshape(h, w, -1)
        ch = a3.shape[2]
        rois = [(int(i), int(j)) for i, j in zip(*np.nonzero(changed))]
        crops = np.zeros((len(rois), tile, tile, ch), arr.dtype)
        for k, (i, j) in enumerate(rois):
            part = a3[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile, :]
            crops[k, :part.shape[0], :part.shape[1], :] = part
        out = buf.with_chunks([Chunk(host_value(crops, name))])
        out.extras["delta_changed"] = True
        out.extras["delta_rois"] = rois
        out.extras["delta_grid"] = (gh, gw)
        out.extras["delta_tile"] = tile
        out.extras["delta_shape"] = tuple(arr.shape)
        return out


@register_element("tensor_delta_stitch")
class TensorDeltaStitch(TransformElement):
    """Decoder-side result reuse for ``tensor_delta mode=roi``: full
    frames refresh a cached canvas; ROI frames scatter the per-crop
    results back over it, so regions the gate skipped keep their last
    output. Handles models that rescale the crop (e.g. a segmentation
    head emitting ``tile/2``-sized maps): the output tile edge is read
    from the crop stack and the canvas scales with it."""

    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    RESTART_SAFE = True  # canvas rebuilds at the next full frame
    PROPS = {}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._canvas: Optional[np.ndarray] = None   # the bytes' dtype
        self._name = ""                             # its dtype name
        self.stats.update({"delta_stitched": 0, "delta_stitch_dropped": 0})

    def handle_event(self, pad, event) -> None:
        if isinstance(event, (SegmentEvent, FlushEvent)):
            self._canvas = None  # racecheck: ok(events and chain are serialized per element)
        super().handle_event(pad, event)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        rois = buf.extras.get("delta_rois")
        if rois is None:  # full frame: refresh the canvas, pass through
            arr, self._name = host_array(buf.chunks[0].host())
            self._canvas = np.array(arr, copy=True)
            return buf
        crops, name = host_array(buf.chunks[0].host())
        gh, gw = buf.extras["delta_grid"]
        h, w = _spatial(buf.extras["delta_shape"])
        in_tile = int(buf.extras.get("delta_tile") or math.ceil(h / gh))
        out_tile = int(crops.shape[1])
        scale = out_tile / in_tile
        oh, ow = max(1, round(h * scale)), max(1, round(w * scale))
        ch = int(np.prod(crops.shape[3:], dtype=np.int64)) if crops.ndim > 3 \
            else 1
        c3 = crops.reshape(len(rois), out_tile, out_tile, ch)
        if self._canvas is None or self._canvas.shape != (oh, ow, ch) \
                or self._canvas.dtype != crops.dtype or self._name != name:
            if self._canvas is not None:
                self.stats.inc("delta_stitch_dropped")
            self._canvas = np.zeros((oh, ow, ch), crops.dtype)
            self._name = name
        for k, (i, j) in enumerate(rois):
            y, x = i * out_tile, j * out_tile
            ph, pw = min(out_tile, oh - y), min(out_tile, ow - x)
            if ph <= 0 or pw <= 0:
                continue
            self._canvas[y:y + ph, x:x + pw, :] = c3[k, :ph, :pw, :]
        self.stats.inc("delta_stitched")
        shape = (oh, ow) + tuple(crops.shape[3:]) if crops.ndim > 3 \
            else (oh, ow)
        out = buf.with_chunks([Chunk(host_value(
            self._canvas.copy().reshape(shape), name))])
        out.extras.pop("delta_rois", None)
        return out
