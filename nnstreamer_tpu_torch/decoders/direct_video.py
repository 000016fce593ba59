"""direct_video decoder: uint8 tensors -> video/x-raw frames.

Port of ``nnstreamer_tpu/decoders/direct_video.py`` (≙ ext/nnstreamer/
tensor_decoder/tensordec-directvideo.c). Channel count picks the video
format (1->GRAY8, 3->RGB, 4->RGBA; option1 may force BGR). A chunk on
the card comes to the host through the buffer's coalesced fetch; a
non-uint8 tensor clips to [0, 255] and is cast, as in the JAX package
(bfloat16 widened to float32 first).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from .registry import DecoderPlugin, register_decoder

_FMT_BY_CHANNELS = {1: "GRAY8", 3: "RGB", 4: "RGBA"}


@register_decoder
class DirectVideo(DecoderPlugin):
    NAME = "direct_video"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        info = config.info[0]
        if len(info.shape) != 3:
            raise ValueError(
                f"direct_video needs HWC uint8 tensors, got {info!r}")
        h, w, c = info.shape
        fmt = self.option(1) or _FMT_BY_CHANNELS.get(c)
        if fmt is None:
            raise ValueError(f"direct_video: no video format for {c} channels")
        self._fmt = fmt
        rate = f"{config.rate_n}/{config.rate_d}"
        return Caps(f"video/x-raw,format={fmt},width={w},height={h},"
                    f"framerate=(fraction){rate}")

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        arr = buf.fetch_host()[0]
        if isinstance(arr, torch.Tensor):  # bfloat16: widen exactly
            arr = arr.float().numpy()
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        if self._fmt == "BGR":
            arr = arr[..., ::-1]
        return Buffer([Chunk(np.ascontiguousarray(arr))])
