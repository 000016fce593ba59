"""Codec converter subplugins: serialized byte streams -> tensors.

Port of ``nnstreamer_tpu/converters/codecs.py`` (≙ ext/nnstreamer/
tensor_converter/tensor_converter_flatbuf.cc, -flexbuf.cc,
-protobuf.cc). Registered as media converters so tensor_converter
auto-dispatches on the codec mimetypes. The payload is self-describing
(dims/dtypes ride in the message), so the negotiated output is
``other/tensors,format=flexible`` of host arrays; a downstream
tensor_converter or the filter's push path pins static dims, and a
device filter stages them onto the card.
"""
from __future__ import annotations

from typing import Optional

from ..interop import tensor_codec as tc
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig, TensorsInfo
from ..tensors.types import TensorFormat
from .registry import ConverterPlugin, register_converter


class _CodecConverter(ConverterPlugin):
    UNPACK = None

    def get_out_config(self, incaps: Caps) -> TensorsConfig:
        rate = incaps.structures[0].fields.get("framerate")
        return TensorsConfig(TensorsInfo(), TensorFormat.FLEXIBLE,
                             getattr(rate, "numerator", 0),
                             getattr(rate, "denominator", 1))

    def convert(self, buf: Buffer) -> Optional[Buffer]:
        data = buf.chunks[0].host().tobytes()
        frame = type(self).UNPACK(data)
        out = Buffer([Chunk(a) for a in frame.arrays])
        out.copy_meta_from(buf)
        return out


class FlatbufConverter(_CodecConverter):
    UNPACK = staticmethod(tc.unpack_flatbuf)


class FlexbufConverter(_CodecConverter):
    UNPACK = staticmethod(tc.unpack_flexbuf)


class ProtobufConverter(_CodecConverter):
    UNPACK = staticmethod(tc.unpack_protobuf)


register_converter("flatbuf", FlatbufConverter(),
                   media_type="other/flatbuf-tensor")
register_converter("flexbuf", FlexbufConverter(),
                   media_type="other/flexbuf")
register_converter("protobuf", ProtobufConverter(),
                   media_type="other/protobuf-tensor")
