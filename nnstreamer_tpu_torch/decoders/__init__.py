"""Decoder subplugins: tensors -> media (≙ ext/nnstreamer/tensor_decoder/*).
Ported: image_labeling, bounding_boxes, pose_estimation, image_segment."""
from . import registry
from .registry import DecoderPlugin, find_decoder, register_decoder
from . import bounding_box, image_label, pose, segment  # noqa: F401,E402

__all__ = ["registry", "DecoderPlugin", "find_decoder", "register_decoder"]
