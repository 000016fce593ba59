"""tensor_region decoder: detection tensors -> crop-region tensor.

Port of ``nnstreamer_tpu/decoders/tensor_region.py`` (≙ ext/nnstreamer/
tensor_decoder/tensordec-tensor_region.c): emits the top-N detected
regions as a uint32 [N, 4] (x, y, w, h pixel) tensor for tensor_crop's
``info`` pad. option1 = N, option2 = labels, option3 = image size "W:H".
The detections are parsed by the bounding_boxes decoder's
``mobilenet-ssd-postprocess`` code (the quad or the packed [6K+1]
layout), on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig, TensorsInfo
from .bounding_box import BoundingBoxes
from .registry import DecoderPlugin, register_decoder


@register_decoder
class TensorRegion(DecoderPlugin):
    NAME = "tensor_region"

    def set_options(self, options) -> None:
        super().set_options(options)
        self.num = int(self.option(1) or 1)
        # reuse the bounding-box tensor parsers; region mode is ssd-pp
        self._bb = BoundingBoxes()
        self._bb.set_options(["mobilenet-ssd-postprocess", self.option(2),
                              "", self.option(3), self.option(3),
                              "", "", "", ""])

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        info = TensorsInfo.make("uint32", f"4:{self.num}")
        return Caps.from_config(TensorsConfig(info, rate_n=config.rate_n,
                                              rate_d=config.rate_d))

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        boxes = self._bb._boxes_ssd_pp(buf)
        boxes = sorted(boxes, key=lambda b: -b.score)[:self.num]
        w, h = self._bb.out_w, self._bb.out_h
        out = np.zeros((self.num, 4), np.uint32)
        for i, b in enumerate(boxes):
            out[i] = [max(0, int(b.x * w)), max(0, int(b.y * h)),
                      int(b.w * w), int(b.h * h)]
        ob = Buffer([Chunk(out)])
        ob.extras["regions"] = out
        return ob
