"""Preemption signal wiring: SIGTERM → drain-and-snapshot → exit.

Port of ``nnstreamer_tpu/fault/preempt.py``, which is framework
neutral. A preempted machine gets seconds of notice as SIGTERM.
:class:`PreemptGuard` turns that signal into a bounded
``Pipeline.preempt(grace_s, directory)`` — quiesce, drain what the
grace budget allows, snapshot the rest, declare what was abandoned —
so a restarted process can ``Pipeline.restore(directory)`` and resume
instead of starting cold.

The handler itself only sets a flag and spawns a worker thread: the
preempt sequence joins element threads and waits on drain events,
none of which belongs inside a signal handler frame.
"""
from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)


class PreemptGuard:
    """Installable SIGTERM handler driving one pipeline's preemption.

    Usage::

        guard = PreemptGuard(pipe, "/var/ckpt", grace_s=5.0)
        guard.install()            # from the main thread
        ...
        guard.done.wait()          # or let exit_code terminate us
        print(guard.report)

    ``exit_code`` non-None makes the guard call :func:`os._exit` once
    the snapshot is published — the clean-exit path a preempted
    replica wants (atexit hooks of a half-drained pipeline have
    nothing left to add).
    """

    def __init__(self, pipeline, directory: str, grace_s: float = 5.0,
                 retain: int = 3, exit_code: Optional[int] = None,
                 signum: int = signal.SIGTERM,
                 on_done: Optional[Callable[[Optional[Dict]], None]] = None):
        self.pipeline = pipeline
        self.directory = directory
        self.grace_s = float(grace_s)
        self.retain = int(retain)
        self.exit_code = exit_code
        self.signum = signum
        # last-words hook, called with the preempt report (None when the
        # preempt itself failed) after the snapshot publishes but BEFORE
        # os._exit — a fleet replica prints its settlement accounting
        # here so the parent can audit exact preempt_abandoned counts
        self.on_done = on_done
        self.done = threading.Event()
        self.report: Optional[Dict] = None
        self._fired = threading.Event()
        self._prev = None

    def install(self) -> "PreemptGuard":
        self._prev = signal.signal(self.signum, self._on_signal)
        return self

    def uninstall(self) -> None:
        if self._prev is not None:
            signal.signal(self.signum, self._prev)
            self._prev = None

    # -- internals ---------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        if self._fired.is_set():
            return  # repeated SIGTERM while already draining
        self._fired.set()
        threading.Thread(target=self._run, name="preempt-guard",
                         daemon=True).start()

    def _run(self) -> None:
        try:
            self.report = self.pipeline.preempt(
                self.grace_s, self.directory, retain=self.retain)
            logger.warning("preempted: %s", self.report)
        except Exception:  # noqa: BLE001 — thread boundary
            logger.exception("preempt failed; exiting without snapshot")
        finally:
            if self.on_done is not None:
                try:
                    self.on_done(self.report)
                except Exception:  # noqa: BLE001 — thread boundary
                    logger.exception("preempt on_done hook failed")
            self.done.set()
            if self.exit_code is not None:
                os._exit(self.exit_code)


def install_sigterm(pipeline, directory: str, grace_s: float = 5.0,
                    retain: int = 3, exit_code: Optional[int] = None,
                    on_done: Optional[Callable[[Optional[Dict]], None]]
                    = None) -> PreemptGuard:
    """Convenience wrapper: build + install a :class:`PreemptGuard`."""
    return PreemptGuard(pipeline, directory, grace_s=grace_s,
                        retain=retain, exit_code=exit_code,
                        on_done=on_done).install()
