"""Decoder subplugins: tensors -> media (≙ ext/nnstreamer/tensor_decoder/*).
Ported: image_labeling, bounding_boxes, pose_estimation, image_segment,
tensor_region."""
from . import registry
from .registry import DecoderPlugin, find_decoder, register_decoder
from . import bounding_box, image_label, pose, segment  # noqa: F401,E402
from . import tensor_region  # noqa: F401,E402

__all__ = ["registry", "DecoderPlugin", "find_decoder", "register_decoder"]
