"""Persistent compile cache: kill the replica cold-start.

Port of ``nnstreamer_tpu/fleet/cache.py``. A replica's first frame of
each input signature normally pays an eager run and a CUDA-graph
capture (filters/executable.py) — the cost the autoscaler cannot afford
on a scale-up or a resurrection, since the fleet grows exactly when
latency is already over target. This module persists the *signature
registry* — which (shape, dtype) tuples each model and each fused
segment actually captured — through the crash-consistent
:class:`~..checkpoint.store.SnapshotStore`, so a fresh process captures
them at ``open()``/``start()`` time, before its serve src registers on
the broker, and serves its first frame from a replayed graph.

A CUDA graph does not survive its process, so the cache keeps what was
captured, not the graph: the replica pays the eager run and the capture
at open instead of on a frame. The JAX package's second layer,
``enable_xla_cache`` (XLA's persistent compilation cache), has no
counterpart: the port's compiled code is the hand kernels' nvcc
libraries in ``build/torch_kernels/``, which persist on disk already
(ops/_build.py).

The registry file is the JAX package's JSON, byte for byte: dtypes are
spelled by their NumPy names (``float32``, ``uint8``, ``bfloat16``), so
either package reads the other's registry.

Processes share one cache through the ``NNS_COMPILE_CACHE`` environment
variable — the autoscaler exports it to every replica it spawns, so the
whole fleet converges on one signature registry.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.store import SnapshotError, SnapshotStore
from ..utils.log import logger

ENV_VAR = "NNS_COMPILE_CACHE"
_SIGS_FILE = "signatures.json"

# one entry: ((shape tuple, dtype str), ...) per input, plus the
# 1-based donated-arg indices (the JAX package's executables key on
# donation; the port donates nothing and records ())
SigEntry = Tuple[Tuple[Tuple[Tuple[int, ...], str], ...], Tuple[int, ...]]


def canon_dtype(dtype) -> str:
    """Canonical dtype spelling, the NumPy name: ``torch.float32``,
    ``'torch.float32'``, ``'<f4'``, ``np.float32`` and ``'float32'`` are
    ONE signature, not five. Dtypes NumPy does not know (``bfloat16``)
    keep their name."""
    text = str(dtype)
    if isinstance(dtype, torch.dtype) or text.startswith("torch."):
        text = text[len("torch."):]
        dtype = text
    try:
        return np.dtype(dtype).name          # objects, np types, '<f4'
    except TypeError:
        try:
            return np.dtype(text).name        # dtype-like reprs
        except TypeError:
            return text


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a canonical name (``float32`` -> ``torch.float32``)."""
    dtype = getattr(torch, canon_dtype(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dtype


def _sig_to_json(sig) -> list:
    return [[list(shape), canon_dtype(dtype)] for shape, dtype in sig]


def _sig_from_json(data) -> Tuple:
    return tuple((tuple(int(d) for d in shape), canon_dtype(dtype))
                 for shape, dtype in data)


class CompileCache:
    """Retain-N persisted registry of captured signatures per model key.

    ``record()`` is called from the backend's capture-miss path;
    ``signatures()`` is replayed by a fresh process at open time. Both
    are cheap: the registry is a small JSON document, re-published
    atomically (tmp + fsync + rename via :class:`SnapshotStore`) only
    when a genuinely new signature appears.
    """

    def __init__(self, root: str, retain: int = 3):
        self.root = root
        self._store = SnapshotStore(root, retain=retain)
        self._lock = threading.Lock()
        # "kind:key" -> [{"sig": [...], "donate": [...]}, ...]
        self._sigs: Dict[str, List[dict]] = {}
        self._load()

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        snap = self._store.latest()
        if snap is None:
            return
        try:
            self._store.verify(snap)
            with open(os.path.join(snap, _SIGS_FILE),
                      encoding="utf-8") as f:
                data = json.load(f)
            if isinstance(data, dict):
                self._sigs = {str(k): list(v) for k, v in data.items()
                              if isinstance(v, list)}
        except (SnapshotError, OSError, ValueError) as exc:
            # a torn/corrupt registry only costs warmup, never
            # correctness: start empty and re-learn
            logger.warning("compile cache at %s unreadable (%s); "
                           "starting cold", self.root, exc)
            self._sigs = {}

    def _save_locked(self) -> None:
        blob = json.dumps(self._sigs, sort_keys=True)

        def writer(tmp: str) -> None:
            with open(os.path.join(tmp, _SIGS_FILE), "w",
                      encoding="utf-8") as f:
                f.write(blob)

        try:
            self._store.save(writer, meta={
                "models": len(self._sigs),
                "entries": sum(len(v) for v in self._sigs.values())})
        except OSError as exc:  # read-only disk etc: cache is optional
            logger.warning("compile cache save failed: %s", exc)

    # -- API ---------------------------------------------------------------
    def record(self, kind: str, key: str, sig,
               donate: Tuple[int, ...] = ()) -> bool:
        """Remember one captured signature; returns True when it was
        new (and the registry was re-published)."""
        ent = {"sig": _sig_to_json(sig), "donate": [int(i) for i in donate]}
        bucket_key = f"{kind}:{key}"
        with self._lock:
            bucket = self._sigs.setdefault(bucket_key, [])
            if ent in bucket:
                return False
            bucket.append(ent)
            self._save_locked()
        return True

    def signatures(self, kind: str, key: str) -> List[SigEntry]:
        """Recorded (sig, donate_idx) entries for one model key."""
        with self._lock:
            bucket = list(self._sigs.get(f"{kind}:{key}", []))
        out: List[SigEntry] = []
        for ent in bucket:
            try:
                out.append((_sig_from_json(ent["sig"]),
                            tuple(int(i) for i in ent.get("donate", []))))
            except (KeyError, TypeError, ValueError):
                continue  # one malformed entry must not spoil the rest
        return out

    def kinds(self) -> List[str]:
        """Distinct capture kinds ("torch-cuda", "fusion", ...) that
        recorded at least one signature."""
        with self._lock:
            return sorted({k.split(":", 1)[0] for k in self._sigs})

    def entry_count(self) -> int:
        """Total recorded signatures across all model keys."""
        with self._lock:
            return sum(len(v) for v in self._sigs.values())


# -- process-wide installation (inherited by spawned replicas) -------------
_active_lock = threading.Lock()
_active: Optional[CompileCache] = None
_env_checked = False


def install(root: str, retain: int = 3,
            export_env: bool = True) -> CompileCache:
    """Install a process-wide compile cache rooted at ``root``.
    ``export_env`` also sets :data:`ENV_VAR` so child processes (the
    autoscaler's replicas) inherit the same cache."""
    global _active, _env_checked
    with _active_lock:
        if _active is None or _active.root != root:
            _active = CompileCache(root, retain=retain)
        _env_checked = True
        if export_env:
            os.environ[ENV_VAR] = root
        return _active


def active() -> Optional[CompileCache]:
    """The installed cache, auto-installing from :data:`ENV_VAR` on
    first call (how a spawned replica picks up the fleet's cache
    without any code in between)."""
    global _active, _env_checked
    with _active_lock:
        if _active is None and not _env_checked:
            _env_checked = True
            root = os.environ.get(ENV_VAR, "")
            if root:
                try:
                    _active = CompileCache(root)
                except OSError as exc:
                    logger.warning("compile cache %s from $%s unusable: %s",
                                   root, ENV_VAR, exc)
        return _active


def prewarm(kind: str, key: str, run: Callable[[list], bool],
            owner: str) -> int:
    """Warm every signature recorded under ``kind:key`` in the active
    cache (a no-op without one): ``run`` gets zeros of the signature's
    shapes and dtypes, captures them, and returns False when they were
    already warm. Returns how many ``run`` warmed; a stale signature
    costs only itself."""
    cc = active()
    if cc is None or not key:
        return 0
    warmed = 0
    for sig, _donate in cc.signatures(kind, key):
        try:
            if run([torch.zeros(shape, dtype=torch_dtype(dt))
                    for shape, dt in sig]):
                warmed += 1
        except Exception as exc:  # noqa: BLE001 -- a stale signature costs only itself
            logger.info("%s: cached signature %s skipped: %s", owner, sig,
                        exc)
    return warmed


def record_quietly(kind: str, key: str, sig, owner: str) -> None:
    """Record a freshly captured signature in the active cache (a no-op
    without one) so the next incarnation warms it at open; cache IO
    never fails the caller."""
    cc = active()
    if cc is None or not key:
        return
    try:
        cc.record(kind, key, sig)
    except Exception as exc:  # noqa: BLE001 -- cache IO never fails serving
        logger.warning("%s: compile-cache record failed: %s", owner, exc)


def deactivate() -> None:
    """Forget the installed cache (tests; does not touch the env)."""
    global _active, _env_checked
    with _active_lock:
        _active = None
        _env_checked = False
