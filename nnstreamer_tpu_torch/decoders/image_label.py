"""image_labeling decoder: classification logits -> text label.

Port of ``nnstreamer_tpu/decoders/image_label.py`` (≙ ext/nnstreamer/
tensor_decoder/tensordec-imagelabel.c + label-file loading in
tensordecutil.c). option1 = labels file (one label per line). Output is
text/x-raw; the label string rides as a uint8 tensor chunk.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from .registry import DecoderPlugin, register_decoder


def load_labels(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


@register_decoder
class ImageLabeling(DecoderPlugin):
    NAME = "image_labeling"

    def set_options(self, options) -> None:
        super().set_options(options)
        self._labels = load_labels(self.option(1)) if self.option(1) else None

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps("text/x-raw,format=utf8")

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        scores = buf.chunks[0].host()
        if isinstance(scores, torch.Tensor):  # bf16 logits: widen exactly
            scores = scores.float().numpy()
        idx = int(np.argmax(scores.reshape(-1)))
        label = self._labels[idx] if self._labels and idx < len(self._labels) \
            else str(idx)
        out = Buffer([Chunk(np.frombuffer(label.encode(), np.uint8))])
        out.extras["label_index"] = idx
        out.extras["label"] = label
        return out
