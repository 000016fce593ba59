"""Decoder subplugin registry + base class.

Port of ``nnstreamer_tpu/decoders/registry.py`` (≙ GstTensorDecoderDef
registration, nnstreamer_plugin_api_decoder.h). Not ported yet: runtime
custom-decoder registration.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Type

from ..tensors.buffer import Buffer
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig

_lock = threading.Lock()
_decoders: Dict[str, Type["DecoderPlugin"]] = {}


class DecoderPlugin:
    """set_options(opts 1..9) -> get_out_caps(config) -> decode(buffer)."""

    NAME = ""

    def set_options(self, options: List[str]) -> None:
        self.options = options

    def option(self, i: int) -> str:
        """1-indexed option accessor (option1..option9)."""
        return self.options[i - 1] if i - 1 < len(self.options) else ""

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        raise NotImplementedError

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        raise NotImplementedError

    def device_fn(self, config: Optional[TensorsConfig] = None):
        """Optional device-side decode: a ``fn(tensors) -> tensors`` of
        torch ops equivalent to :meth:`decode` for the fusion compiler,
        specialized to the planned input *config* (shapes are static in a
        captured graph, so branch on config here, not on tensor values).
        Default None: the decode stays on the host."""
        return None


def register_decoder(cls: Type[DecoderPlugin]) -> Type[DecoderPlugin]:
    if not cls.NAME:
        raise ValueError("decoder subplugin needs a NAME")
    with _lock:
        _decoders[cls.NAME] = cls
    return cls


def find_decoder(name: str) -> Type[DecoderPlugin]:
    with _lock:
        if name not in _decoders:
            raise ValueError(
                f"unknown decoder mode {name!r}; known: {sorted(_decoders)}")
        return _decoders[name]
