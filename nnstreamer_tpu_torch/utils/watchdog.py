"""Resettable watchdog timer.

A copy of ``nnstreamer_tpu/utils/watchdog.py`` (framework-neutral: no
device code), the timer behind ``tensor_filter``'s ``suspend``
(≙ nnstreamer_watchdog.c, armed per invoke at tensor_filter.c:1259-1266).
``quiesce``/``resume`` hold it off while the filter drains
(``TensorFilter.drain``), so a model is not unloaded mid-flush.

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
        self._quiesced = 0                       # nestable quiesce depth
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

    def quiesce(self) -> None:
        """Suspend firing during a deliberate stall (drain/replay
        flush): the dog keeps its state but cannot bite, so a
        supervised loop is never restarted — or a model unloaded —
        mid-flush. Nestable; balance every call with :meth:`resume`."""
        with self._cond:
            self._quiesced += 1
            self._cond.notify_all()

    def resume(self) -> None:
        """End one quiesce. If the deadline lapsed while quiesced, the
        dog does NOT fire retroactively — it gets a fresh full timeout
        (a long drain must never look like a stall the moment it
        ends)."""
        with self._cond:
            if self._quiesced > 0:
                self._quiesced -= 1
            if self._quiesced == 0 and self._deadline is not None:
                self._deadline = max(self._deadline,
                                     time.monotonic() + self.timeout_s)
            self._cond.notify_all()

    @property
    def quiesced(self) -> bool:
        with self._cond:
            return self._quiesced > 0

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
                if self._deadline is None or self._quiesced:
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
