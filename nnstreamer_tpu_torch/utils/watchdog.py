"""Resettable watchdog timer.

A copy of ``nnstreamer_tpu/utils/watchdog.py`` (framework-neutral: no
device code), the timer behind ``tensor_filter``'s ``suspend``
(≙ nnstreamer_watchdog.c, armed per invoke at tensor_filter.c:1259-1266).
Its ``quiesce``/``resume`` are left out: only the filter's drain calls
them, and the port has no drain yet.

``feed()`` sits on the filter's hot path (called once per invoke), so it
must be cheap: one persistent thread sleeps against a monotonic deadline
and each feed just moves the deadline and notifies — no thread is ever
spawned per call (a ``threading.Timer`` per feed would create and tear
down an OS thread per frame).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .log import logger


class Watchdog:
    def __init__(self, timeout_s: float, callback: Callable[[], None]):
        self.timeout_s = timeout_s
        self.callback = callback
        self._cond = threading.Condition()
        self._deadline: Optional[float] = None   # monotonic; None = disarmed
        self._alive = True
        self._thread: Optional[threading.Thread] = None

    def feed(self) -> None:
        """(Re)arm: postpone firing by another timeout. O(1) — updates
        the deadline and wakes the (lazily created) watcher thread."""
        with self._cond:
            if not self._alive:
                return
            self._deadline = time.monotonic() + self.timeout_s
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="watchdog", daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def destroy(self) -> None:
        with self._cond:
            self._alive = False
            self._deadline = None
            self._cond.notify_all()
        # no join: the callback may destroy() from the watcher thread

    def _loop(self) -> None:
        while True:
            fire = False
            with self._cond:
                if not self._alive:
                    return
                if self._deadline is None:
                    self._cond.wait()
                    continue
                now = time.monotonic()
                if now >= self._deadline:
                    self._deadline = None   # fire once, disarm until fed
                    fire = True
                else:
                    self._cond.wait(self._deadline - now)
            if fire:
                try:
                    self.callback()
                except Exception:  # noqa: BLE001 — keep the watcher alive
                    logger.warning("watchdog callback failed", exc_info=True)
