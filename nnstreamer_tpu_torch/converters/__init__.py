"""Converter subplugins: arbitrary media -> tensors (≙ ext/nnstreamer/
tensor_converter/*: the flatbuf / flexbuf / protobuf codecs, and the
custom-code / custom-script hook of ``tensor_converter``)."""
from . import registry
from . import codecs  # noqa: F401  (register codec media converters)
from .registry import ConverterPlugin, find_converter, register_converter

__all__ = ["registry", "ConverterPlugin", "find_converter",
           "register_converter"]
