"""tensor_decoder — tensors -> media via decoder subplugins.

Port of ``nnstreamer_tpu/elements/decoder.py`` (≙ gst/nnstreamer/elements/
gsttensor_decoder.c + the GstTensorDecoderDef subplugin ABI,
include/nnstreamer_plugin_api_decoder.h:38-100).
"""
from __future__ import annotations

from typing import Optional

from ..decoders.registry import find_decoder
from ..pipeline.element import TransformElement
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer
from ..tensors.caps import Caps


@register_element("tensor_decoder")
class TensorDecoder(TransformElement):
    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": None}
    # mode + option1..option9, the reference's property surface
    PROPS = {"mode": "", **{f"option{i}": "" for i in range(1, 10)}}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._decoder = None

    def _open(self) -> None:
        if self._decoder is None:
            if not self.mode:
                raise ValueError(f"{self.name}: 'mode' property is required")
            self._decoder = find_decoder(self.mode)()
            self._decoder.set_options(
                [getattr(self, f"option{i}") for i in range(1, 10)])

    def start(self) -> None:
        super().start()
        self._open()

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self._open()
        out = self._decoder.get_out_caps(caps.to_config())
        self.set_src_caps(out)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        out = self._decoder.decode(buf)
        if out is None:
            return None
        extras = dict(out.extras)  # decoder results survive the meta copy
        out.copy_meta_from(buf)
        out.extras.update(extras)
        return out
