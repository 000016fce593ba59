"""image_segment decoder: per-pixel class map -> RGBA color overlay.

Port of ``nnstreamer_tpu/decoders/segment.py``: the host path in numpy
and the fused decode (``device_fn``) in torch.

≙ ext/nnstreamer/tensor_decoder/tensordec-imagesegment.c
(tflite-deeplab mode). Input [H, W, C] logits (argmax over C) or [H, W]
int class map. option1 = mode, option2 = alpha.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from .registry import DecoderPlugin, register_decoder

# 21-class PASCAL-VOC-ish palette, RGB
_COLORS = (np.array([
    [0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
    [128, 0, 128], [0, 128, 128], [128, 128, 128], [64, 0, 0], [192, 0, 0],
    [64, 128, 0], [192, 128, 0], [64, 0, 128], [192, 0, 128], [64, 128, 128],
    [192, 128, 128], [0, 64, 0], [128, 64, 0], [0, 192, 0], [128, 192, 0],
    [0, 64, 128]], np.uint8))


@register_decoder
class ImageSegment(DecoderPlugin):
    NAME = "image_segment"

    def set_options(self, options) -> None:
        super().set_options(options)
        self.alpha = int(float(self.option(2) or 0.6) * 255)

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        shape = config.info[0].shape
        h, w = shape[0], shape[1]
        self._hw = (h, w)
        rate = f"{config.rate_n}/{config.rate_d}"
        return Caps(f"video/x-raw,format=RGBA,width={w},height={h},"
                    f"framerate=(fraction){rate}")

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        arr = buf.chunks[0].host()
        if arr.ndim >= 3 and arr.shape[-1] > 1:
            classes = np.argmax(arr, axis=-1)
        else:
            classes = arr.reshape(arr.shape[0], arr.shape[1]).astype(np.int64)
        rgb = _COLORS[classes % len(_COLORS)]
        a = np.where(classes[..., None] > 0, self.alpha, 0).astype(np.uint8)
        out = np.concatenate([rgb, a], axis=-1)
        b = Buffer([Chunk(np.ascontiguousarray(out))])
        b.extras["class_map"] = classes
        return b

    def device_fn(self, config=None):
        """Fused decode: argmax + palette gather + alpha select, integer
        and gather ops only, byte-identical to the numpy path (argmax
        takes the first index on ties in torch as in numpy). The
        ``class_map`` extras entry is host-side bookkeeping and is not
        materialized on the fused path, as in the JAX package; consumers
        needing it opt out with fuse=false. The palette is copied to a
        tensor's device at its first call, which runs before any graph
        capture (the executable warms up eagerly first)."""
        if config is None or not len(config.info):
            return None
        shape = tuple(config.info[0].shape)
        if len(shape) < 2:
            return None
        heatmap = len(shape) >= 3 and shape[-1] > 1
        alpha, ncolors = self.alpha, len(_COLORS)
        palettes = {}

        def fn(arrays):
            arr = arrays[0]
            colors = palettes.get(arr.device)
            if colors is None:
                colors = palettes[arr.device] = torch.from_numpy(  # jitcheck: ok(capture_in_place runs fn eagerly before capture_begin, so the palette is copied there; the captured run only reads it)
                    _COLORS).to(arr.device)
            if heatmap:
                classes = torch.argmax(arr, dim=-1)
            else:
                classes = arr.reshape(arr.shape[0],
                                      arr.shape[1]).to(torch.int32)
            rgb = colors[(classes % ncolors).long()]
            a = torch.where(classes[..., None] > 0, alpha, 0).to(torch.uint8)
            return [torch.cat([rgb, a], dim=-1)]

        return fn
