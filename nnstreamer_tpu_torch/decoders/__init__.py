"""Decoder subplugins: tensors -> media (≙ ext/nnstreamer/tensor_decoder/*).
Every decoder of the JAX package is ported: direct_video,
image_labeling, bounding_boxes, pose_estimation, image_segment,
tensor_region, python3, and the codecs (flatbuf, flexbuf, protobuf,
octet_stream)."""
from . import registry
from .registry import DecoderPlugin, find_decoder, register_decoder
from . import (bounding_box, codecs, direct_video, image_label,  # noqa: F401,E402
               pose, python3, segment, tensor_region)

__all__ = ["registry", "DecoderPlugin", "find_decoder", "register_decoder"]
