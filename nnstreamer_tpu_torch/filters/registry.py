"""Filter-backend registry: registration, lookup, auto-detection and the
shared-model table.

Port of ``nnstreamer_tpu/filters/registry.py`` (≙ the subplugin registry,
framework auto-detection and shared model registry, ref:
gst/nnstreamer/nnstreamer_subplugin.c:47-137; tensor_filter_common.c:
1127-1227; nnstreamer_plugin_api_filter.h:560-598). Backends register
with ``@register_filter`` at import time; aliases come from the
configuration (utils/conf.py); C custom filters load through ctypes
(filters/custom_c.py).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple, Type

from ..utils.conf import conf
from ..utils.log import logger
from .base import FilterFramework

_FRAMEWORKS: Dict[str, Type[FilterFramework]] = {}
_LOCK = threading.Lock()


def register_filter(cls: Type[FilterFramework]) -> Type[FilterFramework]:
    with _LOCK:
        _FRAMEWORKS[cls.NAME] = cls
    return cls


def find_filter(name: str) -> Type[FilterFramework]:
    # configured aliases (≙ [filter-aliases] section of nnstreamer.ini)
    name = conf.filter_aliases().get(name, name)
    with _LOCK:
        if name not in _FRAMEWORKS:
            raise ValueError(
                f"unknown filter framework {name!r}; known: {sorted(_FRAMEWORKS)}")
        cls = _FRAMEWORKS[name]
    if not cls.AVAILABLE:
        raise ValueError(f"filter framework {name!r} is not available "
                         "(missing optional dependency)")
    return cls


def all_filters() -> List[str]:
    with _LOCK:
        return sorted(_FRAMEWORKS)


def detect_framework(model_files: Tuple[str, ...]) -> str:
    """Pick a framework from the model URI or file extension
    (≙ gst_tensor_filter_detect_framework, tensor_filter_common.c:1174-1227).
    A ``zoo://`` model always resolves to the first framework of the
    priority list that claims ``zoo://``."""
    if not model_files:
        raise ValueError("cannot auto-detect framework without model files")
    first = model_files[0]
    key = "zoo://" if first.startswith("zoo://") else \
        os.path.splitext(first)[1].lower()
    with _LOCK:
        candidates = [
            (name, cls) for name, cls in _FRAMEWORKS.items()
            if key in cls.EXTENSIONS and cls.AVAILABLE]
    if not candidates:
        raise ValueError(f"no framework claims model {first!r}")
    priority = conf.framework_priority(key if key != "zoo://" else "")
    candidates.sort(key=lambda kv: priority.index(kv[0])
                    if kv[0] in priority else len(priority))
    name = candidates[0][0]
    logger.info("auto-detected framework %s for %s", name, first)
    return name


# -- shared model registry -------------------------------------------------
# (≙ nnstreamer_filter_shared_model_get/insert/remove,
#  nnstreamer_plugin_api_filter.h:560-598): instances with the same
#  shared-tensor-filter-key share one opened backend — one copy of the
#  weights on the card, and one executable per input signature.

_SHARED: Dict[str, Tuple[FilterFramework, int]] = {}
_SHARED_LOCK = threading.Lock()


def shared_model_get(key: str) -> Optional[FilterFramework]:
    """The backend under ``key`` with one more reference, or None."""
    with _SHARED_LOCK:
        entry = _SHARED.get(key)
        if entry is None:
            return None
        fw, refs = entry
        _SHARED[key] = (fw, refs + 1)
        return fw


def shared_model_insert(key: str, fw: FilterFramework) -> FilterFramework:
    """Register ``fw`` under ``key`` with one reference; when another
    instance won the race, take a reference on its backend instead and
    return that one (the caller closes its own)."""
    with _SHARED_LOCK:
        if key in _SHARED:
            existing, refs = _SHARED[key]
            _SHARED[key] = (existing, refs + 1)
            return existing
        _SHARED[key] = (fw, 1)
        return fw


def shared_model_release(key: str) -> bool:
    """Drop one ref; close and remove on last release. Returns True if the
    backend was closed."""
    with _SHARED_LOCK:
        if key not in _SHARED:
            return False
        fw, refs = _SHARED[key]
        if refs <= 1:
            del _SHARED[key]
            fw.close()
            return True
        _SHARED[key] = (fw, refs - 1)
        return False

