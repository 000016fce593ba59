"""image_segment decoder: per-pixel class map -> RGBA color overlay.

Port of ``nnstreamer_tpu/decoders/segment.py``, its host path. The JAX
decoder's ``device_fn`` (the fused decode) comes with the fusion
planner, which the port does not have yet.

≙ ext/nnstreamer/tensor_decoder/tensordec-imagesegment.c
(tflite-deeplab mode). Input [H, W, C] logits (argmax over C) or [H, W]
int class map. option1 = mode, option2 = alpha.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

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
