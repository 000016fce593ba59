"""ctypes bindings for the buffer ring of libnnstpu.so (csrc/nns_ring.cc).

Port of the ring half of ``nnstreamer_tpu/native/lib.py``: the port's
own copy of the bindings over the same C++ source, built by the same
``make native`` into ``build/native/``. The port binds only the ring
(``queue backend=native``); the library's other exports serve the JAX
package.

:func:`load_native_lib` runs ``make native`` at its first use (make's
dependency tracking makes that a no-op when the library is fresh, and
rebuilds it after a change to ``csrc/``). Either way it loads only a
library no older than the sources make builds it from: after a failed
rebuild a stale binary is refused with a warning, never loaded over
newer source. ``load_native_lib(build=False)`` is the same load without
``make``, for callers that must never start a build (``queue
backend=auto``); :func:`native_built` is the cheap probe that never
builds.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Any, Optional, Tuple

from ..utils.log import logger

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
_LIB_PATH = os.path.join(_REPO_ROOT, "build", "native", "libnnstpu.so")

# what the Makefile builds the library from
_SOURCES = tuple(os.path.join(_REPO_ROOT, "csrc", f)
                 for f in ("nns_util.cc", "nns_ring.cc", "nns_custom.h"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_tried = False

# nns_ring_push / nns_ring_pop: 0 ok, 1 timeout, 2 closed
_RING_OK = 0


def _try_build() -> bool:
    if not os.path.exists(os.path.join(_REPO_ROOT, "Makefile")):
        return False
    try:
        subprocess.run(["make", "-C", _REPO_ROOT, "native"], check=True,
                       capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.info("native build unavailable: %s", e)
        return False


def native_built() -> bool:
    """True when libnnstpu.so is already on disk: the probe for callers
    that must NOT trigger a build."""
    return os.path.exists(_LIB_PATH)


def _fresh() -> bool:
    """The library is on disk and no source it is built from is newer."""
    try:
        built = os.path.getmtime(_LIB_PATH)
    except OSError:
        return False
    return all(os.path.getmtime(src) <= built for src in _SOURCES
               if os.path.exists(src))


def load_native_lib(build: bool = True) -> Optional[ctypes.CDLL]:
    """The library with the ring's signatures bound; None when no fresh
    library can be had. ``build`` runs ``make native`` first (once a
    process); without it nothing is built."""
    global _lib, _build_tried
    with _lock:
        if _lib is not None:
            return _lib
        if build and not _build_tried:
            _build_tried = True
            _try_build()
        if not _fresh():
            if native_built():
                logger.warning("%s is older than its sources in csrc/ and "
                               "was not rebuilt: not loaded", _LIB_PATH)
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            logger.warning("cannot load %s: %s", _LIB_PATH, e)
            return None
        lib.nns_ring_new.argtypes = [ctypes.c_uint32]
        lib.nns_ring_new.restype = ctypes.c_void_p
        lib.nns_ring_free.argtypes = [ctypes.c_void_p]
        lib.nns_ring_close.argtypes = [ctypes.c_void_p]
        lib.nns_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64]
        lib.nns_ring_push.restype = ctypes.c_int
        lib.nns_ring_pop.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_int64]
        lib.nns_ring_pop.restype = ctypes.c_int
        lib.nns_ring_size.argtypes = [ctypes.c_void_p]
        lib.nns_ring_size.restype = ctypes.c_uint32
        _lib = lib
        return _lib


class NativeRing:
    """Bounded MPMC queue backed by the C++ ring; holds the Python
    objects alive while their ids transit it. Waits happen in the ring's
    condition variables, off the interpreter lock (ctypes releases it
    around each call)."""

    def __init__(self, capacity: int):
        lib = load_native_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._ring = lib.nns_ring_new(capacity)
        self._refs = {}
        self._refs_lock = threading.Lock()
        self._next_id = 1

    def push(self, item: Any) -> bool:
        """Wait for room and push; False when the ring is closed."""
        with self._refs_lock:
            key = self._next_id
            self._next_id += 1
            self._refs[key] = item
        rc = self._lib.nns_ring_push(self._ring, ctypes.c_void_p(key), -1)
        if rc != _RING_OK:
            with self._refs_lock:
                self._refs.pop(key, None)
        return rc == _RING_OK

    def pop(self) -> Tuple[bool, Any]:
        """Wait for an item: (True, item), or (False, None) once the ring
        is closed and drained."""
        out = ctypes.c_void_p()
        rc = self._lib.nns_ring_pop(self._ring, ctypes.byref(out), -1)
        if rc != _RING_OK:
            return False, None
        with self._refs_lock:
            return True, self._refs.pop(out.value)

    def close(self) -> None:
        """Wake every waiter: pushes fail from now on, pops drain and
        then fail."""
        self._lib.nns_ring_close(self._ring)

    def __len__(self) -> int:
        return self._lib.nns_ring_size(self._ring)

    def __del__(self):
        try:
            if self._ring:
                self._lib.nns_ring_free(self._ring)
                self._ring = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
