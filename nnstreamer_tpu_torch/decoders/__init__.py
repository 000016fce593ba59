"""Decoder subplugins: tensors -> media (≙ ext/nnstreamer/tensor_decoder/*).
Only image_labeling is ported yet."""
from . import registry
from .registry import DecoderPlugin, find_decoder, register_decoder
from . import image_label  # noqa: F401,E402

__all__ = ["registry", "DecoderPlugin", "find_decoder", "register_decoder"]
