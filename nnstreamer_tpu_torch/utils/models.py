"""Model URI resolver: the ML-Agent bridge slot.

A copy of ``nnstreamer_tpu/utils/models.py``; the port's
``tensor_filter`` resolves its ``model`` property through it, as the JAX
filter does, and the ``[models]`` section of the shared ini file serves
both packages.

≙ gst/nnstreamer/ml_agent.c — the reference resolves
``mlagent://model/<name>/<version>`` URIs to file paths by asking the
Tizen mlops-agent D-Bus service, so pipelines name models instead of
hardcoding paths. Here the registry is in-process (register via API)
plus a config tier: ``[models]`` entries in the ini file
(``name = /path`` or ``name/2 = /path``).

``tensor_filter model=model://mobilenet`` resolves through this table;
unknown schemes/plain paths pass through untouched.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

_lock = threading.Lock()
# (name, version) -> path; version None = latest registered
_registry: Dict[Tuple[str, Optional[str]], str] = {}


def register_model(name: str, path: str,
                   version: Optional[str] = None) -> None:
    with _lock:
        _registry[(name, version)] = path
        _registry[(name, None)] = path  # newest registration wins "latest"


def unregister_model(name: str, version: Optional[str] = None) -> None:
    with _lock:
        if version is None:
            for key in [k for k in _registry if k[0] == name]:
                del _registry[key]
            return
        removed = _registry.pop((name, version), None)
        # keep the "latest" alias honest: repoint it at a surviving
        # version, or drop it with the last one
        if removed is not None and _registry.get((name, None)) == removed:
            def _vkey(v: str):
                # numeric-aware: version "10" outranks "9"
                return (0, int(v)) if v.isdigit() else (1, v)
            left = sorted((k[1] for k in _registry
                           if k[0] == name and k[1] is not None), key=_vkey)
            if left:
                _registry[(name, None)] = _registry[(name, left[-1])]
            else:
                _registry.pop((name, None), None)


def resolve(uri: str) -> str:
    """``model://name[/version]`` (or the reference's
    ``mlagent://model/name[/version]``) -> registered path; everything
    else passes through."""
    for prefix in ("model://", "mlagent://model/"):
        if uri.startswith(prefix):
            rest = uri[len(prefix):].strip("/")
            name, _, version = rest.partition("/")
            key = (name, version or None)
            with _lock:
                path = _registry.get(key)
            if path is None:
                path = _from_conf(name, version or None)
            if path is None:
                raise ValueError(
                    f"model URI {uri!r}: no model {name!r}"
                    f"{' v' + version if version else ''} registered")
            return path
    return uri


def _from_conf(name: str, version: Optional[str]) -> Optional[str]:
    from .conf import conf
    key = f"{name}/{version}" if version else name
    return conf.get("models", key) or None
