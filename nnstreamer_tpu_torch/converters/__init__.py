"""Converter subplugins: arbitrary media -> tensors (the custom-code /
custom-script hook of ``tensor_converter``; the codec converters are
not ported yet)."""
from . import registry
from .registry import ConverterPlugin, find_converter, register_converter

__all__ = ["registry", "ConverterPlugin", "find_converter",
           "register_converter"]
