"""Circuit breaker for the inference backend path.

A copy of ``nnstreamer_tpu/fault/breaker.py``, which is framework
neutral. It stays lock-protected: under ``in-flight`` the filter's
completer thread records the failures while the chain thread asks
``allow()``.

States (the classic three-state machine):

    CLOSED ──K consecutive failures──▶ OPEN
      ▲                                 │ reset timer elapses
      │ probe succeeds                  ▼
      └──────────────────────────── HALF_OPEN ──probe fails──▶ OPEN

While OPEN every ``allow()`` answers False — callers shed instead of
invoking a backend that is currently only producing errors (≙ TF-Serving
request shedding; fail-fast beats queueing behind a dead accelerator).
After ``reset_s`` the breaker half-opens and admits exactly ONE probe;
its outcome closes or re-opens the breaker.

Thread-safe; transitions invoke an optional callback (the filter posts
them to the bus) and are counted for ``stats()``.

:func:`element_breaker` and :func:`shed_frame` are the element side,
shared by ``tensor_filter`` and the fused segment (the reference writes
them out in both).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..obs import events as _obs_events
from ..pipeline.events import QosEvent
from ..utils.atomic import Counters
from ..utils.log import logger

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    def __init__(self, threshold: int = 5, reset_s: float = 1.0,
                 name: str = "breaker",
                 on_transition: Optional[Callable[[str, str], None]] = None):
        self.name = name
        self.threshold = max(1, int(threshold))
        self.reset_s = max(0.001, float(reset_s))
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.stats = Counters(opened=0, closed=0, rejected=0)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _transition_locked(self, new: str) -> None:
        old, self._state = self._state, new
        if new == OPEN:
            self.stats.inc("opened")
            self._opened_at = time.monotonic()
        elif new == CLOSED:
            self.stats.inc("closed")
        cb = self._on_transition
        if cb is not None and old != new:
            # called under the lock: transitions are strictly ordered and
            # callbacks (a bus post) are cheap/non-reentrant
            cb(old, new)

    def _maybe_half_open_locked(self) -> None:
        if self._state == OPEN \
                and time.monotonic() - self._opened_at >= self.reset_s:
            self._probe_inflight = False
            self._transition_locked(HALF_OPEN)

    def allow(self) -> bool:
        """May the caller invoke the backend now? False = shed. In
        HALF_OPEN exactly one caller gets True (the probe)."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            self.stats.inc("rejected")
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition_locked(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN:
                # the probe failed: back to OPEN, re-arm the timer
                self._probe_inflight = False
                self._transition_locked(OPEN)
            elif self._state == CLOSED \
                    and self._consecutive >= self.threshold:
                self._transition_locked(OPEN)


def element_breaker(element, message_extra: Optional[
        Callable[[], Dict[str, Any]]] = None) -> Optional[CircuitBreaker]:
    """The breaker of an element's ``breaker-threshold`` and
    ``breaker-reset-ms`` properties, or None when the threshold is 0. A
    transition counts ``breaker_opened`` on opening, logs, and posts a
    bus warning with the ``breaker-retry-after-ms`` hint and the keys of
    ``message_extra()``."""
    if int(element.breaker_threshold) <= 0:
        return None

    def on_transition(old: str, new: str) -> None:
        if new == OPEN:
            element.stats.inc("breaker_opened")
        logger.warning("%s: circuit breaker %s -> %s", element.name, old,
                       new)
        _obs_events.emit("breaker", source=element.name, element=element,
                         old=old, new=new)
        extra = message_extra() if message_extra is not None else {}
        element.post_message(
            "warning", breaker=new, breaker_from=old, **extra,
            retry_after_ms=float(element.breaker_retry_after_ms))

    return CircuitBreaker(threshold=int(element.breaker_threshold),
                          reset_s=float(element.breaker_reset_ms) / 1e3,
                          name=element.name, on_transition=on_transition)


def shed_frame(element, buf) -> None:
    """Answer a frame while the element's breaker is open: upstream gets
    a QosEvent spaced by the retry-after hint, so sources stop producing
    doomed frames. (The reference also answers serve-batch rows with
    their on_shed callback: the serve elements are not ported.)"""
    element.stats.inc("shed")
    element.stats.inc("dropped")
    _obs_events.emit("shed", source=element.name, element=element,
                     reason="breaker-open", pts=buf.pts)
    element.send_upstream_event(QosEvent(
        proportion=2.0,
        period_ns=int(float(element.breaker_retry_after_ms) * 1e6),
        timestamp=buf.pts))
