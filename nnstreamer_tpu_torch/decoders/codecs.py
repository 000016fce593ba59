"""Codec decoder subplugins: tensors -> serialized byte streams.

Port of ``nnstreamer_tpu/decoders/codecs.py`` (≙ ext/nnstreamer/
tensor_decoder/tensordec-flatbuf.cc, -flexbuf.cc, -protobuf.cc,
-octetstream.c). Each mode wraps the wire codecs in
interop/tensor_codec.py and emits a single byte-payload buffer with the
reference's mimetype (other/flatbuf-tensor, other/flexbuf,
other/protobuf-tensor, application/octet-stream). A frame on the card
comes to the host through the buffer's one coalesced fetch
(``Buffer.fetch_host``), which also waits for a ``prefetch-host`` copy
already in flight; the bytes equal the JAX package's for the same frame.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..interop import tensor_codec as tc
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from .registry import DecoderPlugin, register_decoder


class _CodecDecoder(DecoderPlugin):
    MIMETYPE = ""
    PACK = None

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        self._config = config
        return Caps(f"{self.MIMETYPE},framerate=(fraction)"
                    f"{config.rate_n}/{config.rate_d}")

    def _frame(self, buf: Buffer) -> tc.Frame:
        cfg = self._config
        names = [i.name or "" for i in cfg.info] if len(cfg.info) else None
        return tc.Frame(buf.fetch_host(), names,
                        cfg.rate_n, cfg.rate_d, int(cfg.format))

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        data = type(self).PACK(self._frame(buf))
        return Buffer([Chunk(np.frombuffer(data, np.uint8))])


@register_decoder
class FlatbufDecoder(_CodecDecoder):
    NAME = "flatbuf"
    MIMETYPE = "other/flatbuf-tensor"
    PACK = staticmethod(tc.pack_flatbuf)


@register_decoder
class FlexbufDecoder(_CodecDecoder):
    NAME = "flexbuf"
    MIMETYPE = "other/flexbuf"
    PACK = staticmethod(tc.pack_flexbuf)


@register_decoder
class ProtobufDecoder(_CodecDecoder):
    NAME = "protobuf"
    MIMETYPE = "other/protobuf-tensor"
    PACK = staticmethod(tc.pack_protobuf)


@register_decoder
class OctetDecoder(_CodecDecoder):
    NAME = "octet_stream"
    MIMETYPE = "application/octet-stream"
    PACK = staticmethod(tc.pack_octet)
