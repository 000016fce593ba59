"""Launch counts of the hand kernels under CUDA-graph capture.

Each kernel wrapper (``ops/attention.py``, ``ops/normalize.py``) counts
its launches in a module-level ``launches``. A launch made while a CUDA
graph is being captured runs nothing: the kernel executes each time the
graph is replayed. So a wrapper that launches during a capture taken
under :func:`recording` adds the launch to the capture's tally instead
of its count, and the executable that owns the graph hands the tally to
:func:`replayed` after every replay. The counts then say how often each
kernel really ran, whether it ran eagerly or inside a graph.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Counter, Iterator

import torch

_local = threading.local()


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


def captured(name: str) -> bool:
    """True, and the launch tallied, when this thread is capturing a graph
    under :func:`recording`; False when the launch runs now and the
    wrapper counts it itself."""
    tally = getattr(_local, "tally", None)
    if tally is None or not torch.cuda.is_current_stream_capturing():
        return False
    tally[name] += 1
    return True


def replayed(tally: Counter) -> None:
    """Count one replay of a graph whose capture tallied ``tally``."""
    from . import attention, normalize
    for name, n in tally.items():
        module = {"attention": attention, "normalize": normalize}[name]
        module.launches += n
