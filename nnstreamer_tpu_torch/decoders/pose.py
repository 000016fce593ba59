"""pose_estimation decoder: heatmap keypoints -> RGBA skeleton overlay.

Port of ``nnstreamer_tpu/decoders/pose.py`` (host numpy).

≙ ext/nnstreamer/tensor_decoder/tensordec-pose.c. Input is a PoseNet-style
heatmap tensor [H', W', K] (argmax per keypoint channel) or an explicit
keypoint tensor [K, 2|3]. option1 = output size "W:H", option2 = input
size, option3 = optional label/skeleton file ("key" mode vs "heatmap").
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from .registry import DecoderPlugin, register_decoder

# COCO-17 skeleton edges (the reference's default pose topology)
_EDGES = [(0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8),
          (8, 10), (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14),
          (14, 16)]


def _draw_dot(canvas: np.ndarray, x: int, y: int, color, r: int = 3) -> None:
    h, w = canvas.shape[:2]
    canvas[max(0, y - r):min(h, y + r + 1),
           max(0, x - r):min(w, x + r + 1)] = color


def _draw_line(canvas: np.ndarray, p0, p1, color) -> None:
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n).astype(int)
    ys = np.linspace(p0[1], p1[1], n).astype(int)
    h, w = canvas.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = color


@register_decoder
class PoseEstimation(DecoderPlugin):
    NAME = "pose_estimation"

    def set_options(self, options) -> None:
        super().set_options(options)
        def wh(opt, dflt):
            if not opt:
                return dflt
            w, h = opt.split(":")
            return int(w), int(h)
        self.out_w, self.out_h = wh(self.option(1), (640, 480))
        self.in_w, self.in_h = wh(self.option(2), (257, 257))
        self.score_threshold = float(self.option(4) or 0.3)

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        rate = f"{config.rate_n}/{config.rate_d}"
        return Caps(f"video/x-raw,format=RGBA,width={self.out_w},"
                    f"height={self.out_h},framerate=(fraction){rate}")

    def _keypoints(self, buf: Buffer) -> List[Tuple[float, float, float]]:
        arr = buf.chunks[0].host()
        if arr.ndim >= 3:  # heatmap [H', W', K]
            hm = arr.reshape(arr.shape[-3], arr.shape[-2], arr.shape[-1])
            hp, wp, k = hm.shape
            flat = hm.reshape(-1, k)
            idx = np.argmax(flat, axis=0)
            ys, xs = np.unravel_index(idx, (hp, wp))
            # the heatmap value is used AS the score, matching the
            # reference's plain-heatmap mode (tensordec-pose.c:782 only
            # sigmoids in HEATMAP_OFFSET mode; its doc header calls
            # Tensor[0] "label sigmoid probability"). zoo://posenet
            # already emits sigmoided maps, so this keeps the heatmap
            # and decode=device paths on ONE score scale — the model's
            # output scale, which is what score_threshold is defined on.
            scores = flat[idx, np.arange(k)]
            return [(x / max(wp - 1, 1), y / max(hp - 1, 1), float(s))
                    for x, y, s in zip(xs, ys, scores)]
        pts = arr.reshape(-1, arr.shape[-1])  # [K, 2|3] normalized
        return [(float(p[0]), float(p[1]),
                 float(p[2]) if len(p) > 2 else 1.0) for p in pts]

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        kps = self._keypoints(buf)
        canvas = np.zeros((self.out_h, self.out_w, 4), np.uint8)
        pix = [(int(x * (self.out_w - 1)), int(y * (self.out_h - 1)), s)
               for x, y, s in kps]
        for a, b in _EDGES:
            if a < len(pix) and b < len(pix) and \
                    pix[a][2] >= self.score_threshold and \
                    pix[b][2] >= self.score_threshold:
                _draw_line(canvas, pix[a][:2], pix[b][:2],
                           (64, 255, 64, 255))
        for x, y, s in pix:
            if s >= self.score_threshold:
                _draw_dot(canvas, x, y, (255, 64, 64, 255))
        out = Buffer([Chunk(canvas)])
        out.extras["keypoints"] = kps
        return out
