"""Opt-in runtime lock instrumentation: the racecheck witness.

The static lock-order graph is an over-approximation; this module
records what actually happens. Wrap an object's locks with
``instrument_object(obj, monitor)`` and run the test suite: the
monitor records every acquisition edge (lock A held while taking
lock B, per thread) and, optionally via the Counters hook, the lock
names held at each counter mutation. Afterwards
``monitor.check_against_static(static_edges)`` asserts

* the RECORDED graph is acyclic (no run ever witnessed a deadlockable
  order), and
* every recorded edge is present in the static graph (the static pass
  did not miss an ordering the runtime exercised).

Wrappers keep lock semantics exact: ``TracedLock`` delegates to a real
``threading.Lock``; ``TracedCondition`` wraps a real Condition —
``wait()`` needs no stack surgery because a blocked thread performs no
acquisitions, so its held-stack stays truthful for the edges IT
creates.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple


class LockMonitor:
    """Collects acquisition-order edges from traced locks."""

    def __init__(self):
        self._tls = threading.local()
        self._mu = threading.Lock()
        self.edges: Dict[Tuple[str, str], int] = {}
        self.acquisitions: Dict[str, int] = {}

    # -- called by the wrappers -------------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquired(self, name: str) -> None:
        stack = self._stack()
        with self._mu:
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            for held in stack:
                if held != name:
                    key = (held, name)
                    self.edges[key] = self.edges.get(key, 0) + 1
        stack.append(name)

    def note_released(self, name: str) -> None:
        stack = self._stack()
        # out-of-order release is legal for plain locks: remove the
        # newest matching entry rather than assuming LIFO
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- verdicts ----------------------------------------------------------
    def edge_set(self) -> Set[Tuple[str, str]]:
        return set(self.edges)

    def find_cycles(self) -> List[Tuple[str, ...]]:
        from .passes import find_cycles
        return find_cycles(self.edge_set())

    def check_against_static(
            self, static_edges: Iterable[Tuple[str, str]]
    ) -> Tuple[List[Tuple[str, ...]], Set[Tuple[str, str]]]:
        """(cycles, edges the static graph missed) — both empty on a
        clean run."""
        cycles = self.find_cycles()
        missed = self.edge_set() - set(static_edges)
        return cycles, missed


class TracedLock:
    """A ``threading.Lock`` that reports acquisitions to a monitor."""

    def __init__(self, name: str, monitor: LockMonitor,
                 inner: Optional[object] = None):
        self.name = name
        self.monitor = monitor
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self.monitor.note_acquired(self.name)
        return got

    def release(self) -> None:
        self.monitor.note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TracedCondition:
    """A ``threading.Condition`` reporting its underlying-lock
    acquisitions. ``wait()`` keeps the name on the thread's stack: the
    blocked thread acquires nothing while waiting, and on wakeup it
    holds the lock again — exactly what the stack says."""

    def __init__(self, name: str, monitor: LockMonitor,
                 inner: Optional[threading.Condition] = None):
        self.name = name
        self.monitor = monitor
        self._inner = inner if inner is not None else threading.Condition()

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            self.monitor.note_acquired(self.name)
        return got

    def release(self) -> None:
        self.monitor.note_released(self.name)
        self._inner.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __enter__(self) -> "TracedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


_LOCK_TYPE = type(threading.Lock())
_RLOCK_TYPE = type(threading.RLock())


def instrument_object(obj, monitor: LockMonitor,
                      cls_name: Optional[str] = None) -> List[str]:
    """Replace every Lock/RLock/Condition attribute of ``obj`` with a
    traced wrapper named ``ClassName.attr`` — matching the static
    graph's node names, so recorded edges are directly comparable.
    Returns the wrapped names."""
    cls_name = cls_name or type(obj).__name__
    wrapped: List[str] = []
    for attr in list(vars(obj)):
        value = getattr(obj, attr)
        name = f"{cls_name}.{attr}"
        if isinstance(value, (TracedLock, TracedCondition)):
            continue
        if isinstance(value, threading.Condition):
            setattr(obj, attr, TracedCondition(name, monitor, value))
            wrapped.append(name)
        elif isinstance(value, (_LOCK_TYPE, _RLOCK_TYPE)):
            setattr(obj, attr, TracedLock(name, monitor, value))
            wrapped.append(name)
    return wrapped


def instrument_counters(counters, monitor: LockMonitor) -> str:
    """Trace a :class:`~...utils.atomic.Counters` leaf lock under the
    canonical ``Counters._lock`` node name."""
    name = "Counters._lock"
    inner = object.__getattribute__(counters, "_lock")
    if not isinstance(inner, TracedLock):
        object.__setattr__(counters, "_lock",
                           TracedLock(name, monitor, inner))
    return name
