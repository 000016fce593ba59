"""Exponential backoff with jitter, and a rolling restart budget.

A copy of ``nnstreamer_tpu/fault/backoff.py``, which is framework
neutral: the same seeded ladder, so jittered sleeps match the JAX
package run for run.

The two primitives every retry/reconnect/supervise site shares, so the
delay discipline cannot drift between the query client, the MQTT sink's
qos1 flush, and the source-loop supervisor:

* :class:`Backoff` — exponential delay with multiplicative jitter
  (jitter breaks the thundering-herd synchronization of N clients all
  reconnecting on the same schedule after a broker restart).
* :class:`RestartBudget` — at most N events per rolling window; the
  supervisor's guard against a crash-looping element restarting forever.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Optional


class Backoff:
    """delay_k = min(max_s, base * multiplier**k), each draw scaled by a
    uniform factor in [1-jitter, 1]. Seeded, so chaos schedules replay
    identically."""

    def __init__(self, base: float = 0.05, multiplier: float = 2.0,
                 max_s: float = 2.0, jitter: float = 0.5,
                 seed: Optional[int] = None):
        self.base = max(0.0, float(base))
        self.multiplier = max(1.0, float(multiplier))
        self.max_s = max(self.base, float(max_s))
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self._rng = random.Random(seed)
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def reset(self) -> None:
        self._attempt = 0

    def next(self) -> float:
        """The next delay in seconds (advances the attempt counter)."""
        delay = min(self.max_s, self.base * self.multiplier ** self._attempt)
        self._attempt += 1
        if self.jitter:
            delay *= 1.0 - self.jitter * self._rng.random()
        return delay

    def sleep(self, stop_evt: Optional[threading.Event] = None) -> float:
        """Sleep the next delay; a ``stop_evt`` interrupts it (a stopping
        pipeline must not wait out a long backoff). Returns the delay."""
        delay = self.next()
        if delay <= 0:
            return 0.0
        if stop_evt is not None:
            stop_evt.wait(delay)
        else:
            time.sleep(delay)
        return delay


class RestartBudget:
    """Sliding-window rate limit: ``allow()`` consumes one slot and
    answers False once ``limit`` events landed inside ``window_s`` —
    the point where supervised restarting becomes crash-looping and the
    failure must escalate."""

    def __init__(self, limit: int = 3, window_s: float = 30.0):
        self.limit = max(1, int(limit))
        self.window_s = max(0.001, float(window_s))
        self._events: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def allow(self) -> bool:
        now = time.monotonic()
        with self._lock:
            while self._events and now - self._events[0] > self.window_s:
                self._events.popleft()
            if len(self._events) >= self.limit:
                return False
            self._events.append(now)
            return True

    @property
    def used(self) -> int:
        now = time.monotonic()
        with self._lock:
            while self._events and now - self._events[0] > self.window_s:
                self._events.popleft()
            return len(self._events)
