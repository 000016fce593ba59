"""Counters — a lock-guarded counter map for cross-thread stats.

``Element.stats`` (and the scheduler/batcher/breaker stat tables) are
mutated from chain threads, supervised source loops, network reader
threads and timer callbacks, while ``Pipeline.stats()`` and
``trace.report()`` read them from the user thread. A plain dict makes
every ``stats[k] += 1`` a read-modify-write race; Counters gives each
mutation one lock round-trip and gives readers a single coherent
``snapshot()``.

The internal ``_lock`` is a LEAF of the lock hierarchy: no Counters
method calls out while holding it, so it is always safe to call in
while holding any other lock. racecheck's lock-order graph records
exactly those ``Owner._lock -> Counters._lock`` edges and proves they
can never close a cycle.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, Mapping, Optional


class Counters:
    """Mapping-like atomic counter table.

    * ``inc(key)`` / ``add(**deltas)`` are the hot-path mutators: one
      lock acquisition whether you bump one key or five.
    * ``c[k]`` / ``c.get(k)`` read single values; ``snapshot()`` is the
      one consistent multi-key read.
    * Iteration / ``keys`` / ``items`` operate on a snapshot, so
      ``dict(counters)`` is coherent and never sees a mid-update table.
    """

    __slots__ = ("_lock", "_values")

    def __init__(self, initial: Optional[Mapping] = None, **keys: Any):
        self._lock = threading.Lock()
        self._values: Dict[str, Any] = dict(initial or {})
        self._values.update(keys)

    # -- mutation ----------------------------------------------------------
    def inc(self, key: str, n: int = 1) -> int:
        """Atomically add ``n`` to ``key`` (missing keys start at 0) and
        return the new value — replaces ``d[k] += 1`` AND the
        ``n = d[k] = d[k] + 1`` idiom in one step."""
        with self._lock:
            value = self._values.get(key, 0) + n
            self._values[key] = value
            return value

    def add(self, **deltas: int) -> None:
        """Atomically apply several deltas under one lock acquisition —
        the per-buffer hot path bumps buffers/bytes/proctime together."""
        with self._lock:
            values = self._values
            for key, delta in deltas.items():
                values[key] = values.get(key, 0) + delta

    def __setitem__(self, key: str, value: Any) -> None:
        with self._lock:
            self._values[key] = value

    def update(self, other: Optional[Mapping] = None, **keys: Any) -> None:
        with self._lock:
            if other:
                self._values.update(other)
            self._values.update(keys)

    # -- reads -------------------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        with self._lock:
            return self._values[key]

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._values.get(key, default)

    def snapshot(self) -> Dict[str, Any]:
        """A point-in-time copy: the only way to read several keys that
        are guaranteed to come from the same instant."""
        with self._lock:
            return dict(self._values)

    # -- mapping protocol (snapshot-backed) --------------------------------
    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._values

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)

    def __iter__(self) -> Iterator[str]:
        return iter(self.snapshot())

    def keys(self):
        return self.snapshot().keys()

    def items(self):
        return self.snapshot().items()

    def values(self):
        return self.snapshot().values()

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Counters):
            return self.snapshot() == other.snapshot()
        if isinstance(other, Mapping) or isinstance(other, dict):
            return self.snapshot() == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"Counters({self.snapshot()!r})"
