"""Converter subplugin registry.

Port of ``nnstreamer_tpu/converters/registry.py``: the hook
``tensor_converter`` looks up for ``mode=custom-code:<name>``,
``mode=custom-script:<path>`` and media types it has no built-in path
for; the codec converters (converters/codecs.py) register their
media types here.

Kinds:
  * ``media``         — claims a media mimetype (auto-dispatch by caps name)
  * ``custom-code``   — in-process callable registered by name
                        (≙ NNS_custom_easy-style registration)
  * ``custom-script`` — a python file defining ``convert``/``get_out_config``
                        (≙ tensor_converter_python3.cc user scripts)
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

from ..tensors.buffer import Buffer
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig

_lock = threading.Lock()
_media: Dict[str, "ConverterPlugin"] = {}
_custom: Dict[str, "ConverterPlugin"] = {}


class ConverterPlugin:
    """get_out_config(caps) -> TensorsConfig; convert(buf) -> Buffer."""

    def get_out_config(self, incaps: Caps) -> TensorsConfig:
        raise NotImplementedError

    def convert(self, buf: Buffer) -> Optional[Buffer]:
        raise NotImplementedError


class _CallablePlugin(ConverterPlugin):
    def __init__(self, fn: Callable[[Buffer], Buffer],
                 out_config: "TensorsConfig | Callable[[Caps], TensorsConfig]"):
        self._fn = fn
        self._out = out_config

    def get_out_config(self, incaps: Caps) -> TensorsConfig:
        return self._out(incaps) if callable(self._out) else self._out

    def convert(self, buf: Buffer) -> Optional[Buffer]:
        return self._fn(buf)


def register_converter(name: str, plugin: "ConverterPlugin | Callable" = None,
                       media_type: Optional[str] = None,
                       out_config: Any = None):
    """Register a converter. With ``media_type``, it is auto-dispatched for
    that mimetype; otherwise it is a named custom-code converter."""
    def _store(p: ConverterPlugin):
        with _lock:
            if media_type:
                _media[media_type] = p
            _custom[name] = p
        return p

    if plugin is None:  # decorator form
        def deco(obj):
            p = obj() if isinstance(obj, type) else _CallablePlugin(obj, out_config)
            _store(p)
            return obj
        return deco
    p = plugin if isinstance(plugin, ConverterPlugin) else \
        _CallablePlugin(plugin, out_config)
    return _store(p)


def unregister_converter(name: str) -> None:
    with _lock:
        _custom.pop(name, None)


def _load_script(path: str) -> ConverterPlugin:
    ns: Dict[str, Any] = {}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), ns)  # noqa: S102 — user script
    if "convert" not in ns:
        raise ValueError(f"{path}: converter script must define convert()")
    return _CallablePlugin(ns["convert"], ns.get("get_out_config",
                                                 ns.get("out_config")))


def find_converter(kind: str, arg: str = "",
                   optional: bool = False) -> Optional[ConverterPlugin]:
    with _lock:
        if kind == "media":
            p = _media.get(arg)
        elif kind == "custom-code":
            p = _custom.get(arg)
        elif kind == "custom-script":
            p = _load_script(arg) if os.path.exists(arg) else None
        else:
            p = _custom.get(kind) or _media.get(kind)
    if p is None and not optional:
        raise ValueError(f"no converter for {kind}:{arg}")
    return p
