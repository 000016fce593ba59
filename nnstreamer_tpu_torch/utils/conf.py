"""Configuration: ini file + environment-variable tiers.

Port of the part of ``nnstreamer_tpu/utils/conf.py`` that the element and
filter registries read (≙ gst/nnstreamer/nnstreamer_conf.c): framework
auto-detect priority, filter aliases and element restriction. The ini
file and the variable names are the JAX package's, so one configuration
drives both packages.

Tiers, lowest to highest precedence:
  1. built-in defaults
  2. ini file — ``$NNS_TPU_CONF`` if set, else ``./nnstreamer_tpu.ini``,
     else ``/etc/nnstreamer_tpu.ini``
  3. env-var overrides — honored when ``[common] enable_envvar`` is true
     (the default): ``NNS_TPU_FRAMEWORK_PRIORITY``,
     ``NNS_TPU_FRAMEWORK_PRIORITY_<EXT>``, ``NNS_TPU_FILTER_ALIASES``
     ("alias=target,...") and ``NNS_TPU_RESTRICTED_ELEMENTS``.
"""
from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

_DEFAULT_PATHS = ("./nnstreamer_tpu.ini", "/etc/nnstreamer_tpu.ini")

# the JAX package's default order with its native backend ("jax") swapped
# for the port's, so a ``.py`` model resolves to torch-cuda where the JAX
# package picks jax (it also lists "flax", which the port does not have)
DEFAULT_PRIORITY = ["torch-cuda", "custom-easy", "python3",
                    "tensorflow-lite", "onnxruntime"]

# the aliases the JAX package registers at import (``torch`` for its
# TorchScript backend, ``llamacpp``/``llama2c`` for its LLM backend,
# ``tensorflow2-lite``/``tflite`` and ``onnx`` for its importers);
# [filter-aliases] and the variable override them
DEFAULT_ALIASES = {"torch": "pytorch", "llamacpp": "llm", "llama2c": "llm",
                   "tensorflow2-lite": "tensorflow-lite",
                   "tflite": "tensorflow-lite", "onnx": "onnxruntime"}


def _split(s: str) -> List[str]:
    return [t.strip() for t in (s or "").split(",") if t.strip()]


def _parse_pairs(s: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for tok in _split(s):
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip()
    return out


class Conf:
    """Loaded configuration snapshot; ``reload()`` re-reads all tiers."""

    def __init__(self, path: Optional[str] = None):
        self._lock = threading.Lock()
        self.reload(path)

    def reload(self, path: Optional[str] = None) -> None:
        with self._lock:
            self._ini = configparser.ConfigParser()
            self.conffile: Optional[str] = None
            candidates = ([path] if path else
                          ([os.environ["NNS_TPU_CONF"]]
                           if os.environ.get("NNS_TPU_CONF")
                           else list(_DEFAULT_PATHS)))
            for cand in candidates:
                if cand and os.path.isfile(cand):
                    self._ini.read(cand)
                    self.conffile = cand
                    break
            self.enable_envvar = self._getbool("common", "enable_envvar",
                                               default=True)

    def get(self, section: str, key: str, default: str = "") -> str:
        try:
            return self._ini.get(section, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return default

    def _getbool(self, section: str, key: str, default: bool) -> bool:
        v = self.get(section, key, "")
        if not v:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")

    def _env(self, name: str) -> Optional[str]:
        if not self.enable_envvar:
            return None
        return os.environ.get(name)

    def framework_priority(self, ext: str = "") -> List[str]:
        """Auto-detect priority list, most preferred first; per-extension
        config wins over the global list."""
        ext = ext.lstrip(".").lower()
        if ext:
            v = self._env(f"NNS_TPU_FRAMEWORK_PRIORITY_{ext.upper()}")
            if v:
                return _split(v)
            v = self.get("filter", f"framework_priority_{ext}")
            if v:
                return _split(v)
        v = self._env("NNS_TPU_FRAMEWORK_PRIORITY")
        if v:
            return _split(v)
        v = self.get("filter", "framework_priority")
        if v:
            return _split(v)
        return list(DEFAULT_PRIORITY)

    def filter_aliases(self) -> Dict[str, str]:
        """(≙ [filter-aliases] section)"""
        out: Dict[str, str] = dict(DEFAULT_ALIASES)
        if self._ini.has_section("filter-aliases"):
            out.update({k: v for k, v in self._ini.items("filter-aliases")})
        v = self._env("NNS_TPU_FILTER_ALIASES")
        if v:
            out.update(_parse_pairs(v))
        return out

    def element_allowed(self, name: str) -> bool:
        """Product allowlisting (≙ enable_element_restriction +
        restricted_elements). When restriction is on, only listed
        elements may be instantiated."""
        allow = self._env("NNS_TPU_RESTRICTED_ELEMENTS")
        if allow is None:
            if not self._getbool("elements", "enable_element_restriction",
                                 default=False):
                return True
            allow = self.get("elements", "restricted_elements")
        allowed = _split(allow)
        return not allowed or name in allowed


# module-level singleton, reloadable (tests call conf.reload())
conf = Conf()
