"""tensor_decoder — tensors -> media via decoder subplugins.

Port of ``nnstreamer_tpu/elements/decoder.py`` (≙ gst/nnstreamer/elements/
gsttensor_decoder.c + the GstTensorDecoderDef subplugin ABI,
include/nnstreamer_plugin_api_decoder.h:38-100), with its static caps
transfer and the fusion hooks: a mode whose subplugin declares
``device_fn`` (image_segment) fuses with the filter before it.
"""
from __future__ import annotations

from typing import Optional

from ..decoders.registry import DecoderPlugin, find_decoder
from ..pipeline.element import TransformElement
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer
from ..tensors.caps import Caps


@register_element("tensor_decoder")
class TensorDecoder(TransformElement):
    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": None}
    STRIPS_META = True  # decoded media buffers carry no tensor meta
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

    def static_transfer(self, in_caps):
        """The mode subplugin's get_out_caps on the declared config
        (subplugins declare out caps without touching data)."""
        if not self.mode:
            raise ValueError(f"{self.name}: 'mode' property is required")
        caps = in_caps.get("sink")
        if caps is None or not caps.is_fixed():
            return {"src": None}
        dec = find_decoder(self.mode)()
        dec.set_options(
            [getattr(self, f"option{i}") for i in range(1, 10)])
        return {"src": dec.get_out_caps(caps.to_config())}

    # -- device placement (fusion compiler) --------------------------------
    DEVICE_FUSIBLE = ("modes whose subplugin declares device_fn "
                      "(image_segment); others decode on the host")

    def device_veto(self) -> Optional[str]:
        if not self.mode:
            return "mode not set"
        try:
            dec_cls = find_decoder(self.mode)
        except ValueError:
            return f"unknown decoder mode {self.mode!r}"
        if dec_cls.device_fn is DecoderPlugin.device_fn:
            return f"decoder mode {self.mode!r} is host-only"
        return None

    def device_fn(self, ctx=None):
        if self.device_veto() is not None:
            return None
        try:
            self._open()
        except Exception:  # noqa: BLE001 -- decline, don't block launch
            return None
        cfg = getattr(ctx, "in_config", None) if ctx is not None else None
        return self._decoder.device_fn(cfg)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        out = self._decoder.decode(buf)
        if out is None:
            return None
        extras = dict(out.extras)  # decoder results survive the meta copy
        out.copy_meta_from(buf)
        out.extras.update(extras)
        return out
