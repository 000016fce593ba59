"""tensor_converter — media streams -> other/tensors.

Port of ``nnstreamer_tpu/elements/converter.py``: video, audio, text and
octet streams, other/tensor(s) flexible->static, ``frames-per-tensor``,
``input-dim`` / ``input-type``, the custom converters and the codec
media types (flatbuf, flexbuf, protobuf; converters/codecs.py), which
dispatch through the media-converter registry. ``static_transfer``
declares the out caps for the fusion planner's caps inference.

≙ gst/nnstreamer/elements/gsttensor_converter.c: video/x-raw, audio/x-raw,
text/x-raw, application/octet-stream, and flexible->static conversion,
with frames-per-tensor temporal batching and PTS synthesis, plus external
converter subplugins for arbitrary media (_NNS_MEDIA_ANY).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..converters.registry import find_converter
from ..pipeline.element import TransformElement
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig, TensorsInfo
from ..tensors.types import TensorFormat, TensorType
from .media import _VIDEO_CHANNELS


@register_element("tensor_converter")
class TensorConverter(TransformElement):
    SINK_TEMPLATES = {"sink": None}
    SRC_TEMPLATES = {"src": "other/tensors"}
    STRIPS_META = True  # mints fresh tensor buffers from media frames
    PROPS = {
        "frames-per-tensor": 1,
        "input-dim": "",     # required for octet / text streams
        "input-type": "",
        "mode": "",          # "custom-code:<name>" / "custom-script:<path>"
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._out_config: Optional[TensorsConfig] = None
        self._media: Optional[str] = None
        self._frame_shape = None
        self._accum = []
        self._custom = None

    # -- negotiation ------------------------------------------------------
    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        pad.set_caps(caps)
        self._media = caps.structures[0].name
        if self.mode:
            kind, _, arg = self.mode.partition(":")
            self._custom = find_converter(kind, arg)
            cfg = self._apply_frames(self._custom.get_out_config(caps))
        else:
            cfg = self._declared_out_config(caps)
        self._out_config = cfg
        self.set_src_caps(Caps.from_config(cfg))

    def static_transfer(self, in_caps):
        """Out config per declared media type (video/audio/text/octet/
        tensors); custom ``mode`` converters are unknown until runtime."""
        caps = in_caps.get("sink")
        if caps is None or caps.any or not caps.structures \
                or not caps.is_fixed() or self.mode:
            return {"src": None}
        cfg = self._declared_out_config(caps)
        if not len(cfg.info) or not cfg.info.is_valid():
            return {"src": None}  # dims lock from the first buffer
        return {"src": Caps.from_config(cfg)}

    def _declared_out_config(self, caps: Caps) -> TensorsConfig:
        """The out config for the stream's media type (custom ``mode``
        converters are handled separately)."""
        s = caps.structures[0]
        if s.name == "video/x-raw":
            cfg = self._video_config(caps)
        elif s.name == "audio/x-raw":
            cfg = self._audio_config(caps)
        elif s.name in ("text/x-raw", "application/octet-stream"):
            cfg = self._octet_config(caps)
        elif s.name == "other/tensors":
            cfg = self._flex_config(caps)
        elif s.name == "other/tensor":
            base = caps.to_config()
            cfg = TensorsConfig(base.info, TensorFormat.STATIC,
                                base.rate_n, base.rate_d)
        else:
            conv = find_converter("media", s.name, optional=True)
            if conv is None:
                raise ValueError(
                    f"{self.name}: unsupported media type {s.name!r}")
            self._custom = conv
            cfg = conv.get_out_config(caps)
        return self._apply_frames(cfg)

    def _apply_frames(self, cfg: TensorsConfig) -> TensorsConfig:
        n = self.frames_per_tensor
        if n > 1 and cfg.info.is_valid():
            for info in cfg.info:
                info.shape = (n, *info.shape)
            if cfg.rate_n > 0:
                cfg.rate_d *= n
        return cfg

    def _video_config(self, caps: Caps) -> TensorsConfig:
        s = caps.structures[0]
        fmt = str(s.fields.get("format", "RGB"))
        c = _VIDEO_CHANNELS.get(fmt)
        if c is None:
            raise ValueError(f"{self.name}: unsupported video format {fmt}")
        h, w = int(s.fields["height"]), int(s.fields["width"])
        self._frame_shape = (h, w, c)
        rate = s.fields.get("framerate")
        rn = getattr(rate, "numerator", 0)
        rd = getattr(rate, "denominator", 1)
        info = TensorsInfo.make("uint8", f"{c}:{w}:{h}")
        return TensorsConfig(info, TensorFormat.STATIC, rn, rd)

    def _audio_config(self, caps: Caps) -> TensorsConfig:
        s = caps.structures[0]
        fmt = str(s.fields.get("format", "S16LE"))
        ttype = {"S8": "int8", "U8": "uint8", "S16LE": "int16",
                 "U16LE": "uint16", "S32LE": "int32", "U32LE": "uint32",
                 "F32LE": "float32", "F64LE": "float64"}.get(fmt)
        if ttype is None:
            raise ValueError(f"{self.name}: unsupported audio format {fmt}")
        ch = int(s.fields.get("channels", 1))
        rate = int(s.fields.get("rate", 16000))
        # per-buffer frame count is data-dependent; negotiated per first buffer
        self._audio_meta = (ttype, ch, rate)
        info = TensorsInfo.make(ttype, f"{ch}:0")
        return TensorsConfig(info, TensorFormat.STATIC, rate, 1)

    def _octet_config(self, caps: Caps) -> TensorsConfig:
        if not self.input_dim or not self.input_type:
            raise ValueError(
                f"{self.name}: text/octet streams need explicit input-dim/"
                "input-type properties (ref: gsttensor_converter.c octet mode)")
        info = TensorsInfo.make(self.input_type, self.input_dim)
        rate = caps.structures[0].fields.get("framerate")
        return TensorsConfig(info, TensorFormat.STATIC,
                             getattr(rate, "numerator", 0),
                             getattr(rate, "denominator", 1))

    def _flex_config(self, caps: Caps) -> TensorsConfig:
        cfg = caps.to_config()
        if cfg.format == TensorFormat.STATIC:
            return cfg
        if self.input_dim and self.input_type:
            info = TensorsInfo.make(self.input_type, self.input_dim)
            return TensorsConfig(info, TensorFormat.STATIC,
                                 cfg.rate_n, cfg.rate_d)
        # flexible->static: dims locked from the first buffer's meta
        return TensorsConfig(TensorsInfo(), TensorFormat.STATIC,
                             cfg.rate_n, cfg.rate_d)

    # -- dataflow ---------------------------------------------------------
    def transform(self, buf: Buffer) -> Optional[Buffer]:
        if self._custom is not None:
            out = self._custom.convert(buf)
        elif self._media == "video/x-raw":
            out = self._convert_video(buf)
        elif self._media == "audio/x-raw":
            out = self._convert_audio(buf)
        elif self._media in ("text/x-raw", "application/octet-stream"):
            out = self._convert_octet(buf)
        elif self._media in ("other/tensors", "other/tensor"):
            out = self._convert_flex(buf)
        else:
            out = buf
        if out is None:
            return None
        n = self.frames_per_tensor
        if n <= 1:
            return out
        self._accum.append(out)
        if len(self._accum) < n:
            return None
        frames = self._accum
        self._accum = []
        chunks = []
        for i in range(len(frames[0].chunks)):
            arrs = [f.chunks[i].host() for f in frames]
            chunks.append(Chunk(np.stack(arrs)))
        return Buffer(chunks, pts=frames[0].pts,
                      duration=(frames[-1].pts - frames[0].pts +
                                (frames[-1].duration or 0))
                      if frames[0].pts is not None else None)

    def _convert_video(self, buf: Buffer) -> Buffer:
        arr = buf.chunks[0].host()
        if arr.ndim == 1:  # raw bytes from filesrc
            arr = arr.reshape(self._frame_shape)
        return buf.with_chunks([Chunk(np.ascontiguousarray(arr))])

    def _convert_audio(self, buf: Buffer) -> Buffer:
        arr = buf.chunks[0].host()
        ttype, ch, _ = self._audio_meta
        dt = TensorType.from_string(ttype).np_dtype
        if arr.ndim == 1 and arr.dtype == np.uint8 and dt != np.uint8:
            arr = arr.view(dt)
        if arr.ndim == 1:
            arr = arr.reshape(-1, ch)
        return buf.with_chunks([Chunk(arr.astype(dt, copy=False))])

    def _convert_octet(self, buf: Buffer) -> Buffer:
        info = self._out_config.info[0]
        dt = info.type.np_dtype
        raw = buf.chunks[0].host().tobytes()
        frame_bytes = info.size_bytes // max(1, self.frames_per_tensor) \
            if self.frames_per_tensor > 1 else info.size_bytes
        if info.num_elements and len(raw) < frame_bytes:
            raw = raw + b"\x00" * (frame_bytes - len(raw))  # text padding
        arr = np.frombuffer(raw[:frame_bytes], dtype=dt)
        shape = info.shape if self.frames_per_tensor <= 1 else info.shape[1:]
        return buf.with_chunks([Chunk(arr.reshape(shape))])

    def _convert_flex(self, buf: Buffer) -> Buffer:
        # strip per-chunk meta; shapes become the static negotiated dims
        if self._out_config is not None and not len(self._out_config.info):
            cfg = TensorsConfig(buf.to_infos(), TensorFormat.STATIC,
                                self._out_config.rate_n,
                                self._out_config.rate_d)
            self._out_config = cfg
            self.set_src_caps(Caps.from_config(cfg))
        out = buf.with_chunks([Chunk(c.raw) for c in buf.chunks])
        exp = self._out_config.info
        got = out.to_infos()
        if len(exp) and not got.is_equal(exp):
            raise ValueError(
                f"{self.name}: flexible frame {got!r} does not match locked "
                f"static dims {exp!r}")
        return out
