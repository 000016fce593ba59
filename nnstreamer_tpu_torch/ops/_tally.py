"""Launch counts of the hand kernels under CUDA-graph capture.

Each kernel wrapper (``ops/attention.py``, ``ops/normalize.py``) counts
its launches in a module-level ``launches``. A launch made while a CUDA
graph is being captured runs nothing: the kernel executes each time the
graph is replayed. So a wrapper that launches during a capture taken
under :func:`recording` adds the launch to the capture's tally instead
of its count, and the executable that owns the graph hands the tally to
:func:`replayed` after every replay. The counts then say how often each
kernel really ran, whether it ran eagerly or inside a graph. Every
count goes through one lock: several pipeline threads may launch or
replay the same kernel at once.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Counter, Iterator

import torch

_local = threading.local()
_count_lock = threading.Lock()


@contextlib.contextmanager
def recording() -> Iterator[Counter]:
    """Tally, on this thread, the launches made while a graph captures."""
    tally: Counter = collections.Counter()
    prev = getattr(_local, "tally", None)
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = prev


def launched(name: str) -> None:
    """Count one launch of the kernel ``name``: into this thread's
    capture tally while it captures a graph under :func:`recording` (the
    launch runs at each replay), else into the kernel module's
    ``launches`` now."""
    tally = getattr(_local, "tally", None)
    if tally is not None and torch.cuda.is_current_stream_capturing():
        tally[name] += 1
    else:
        _add(name, 1)


def replayed(tally: Counter) -> None:
    """Count one replay of a graph whose capture tallied ``tally``."""
    for name, n in tally.items():
        _add(name, n)


def _add(name: str, n: int) -> None:
    # pipeline threads replay graphs (and launch eagerly) concurrently;
    # ``launches += n`` is a read-modify-write, so it takes the lock
    from . import attention, normalize
    module = {"attention": attention, "normalize": normalize}[name]
    with _count_lock:
        module.launches += n
