"""The black-box flight recorder.

A copy of ``nnstreamer_tpu/obs/recorder.py``, which is framework
neutral: the dump has the reference's Chrome ``trace_event`` schema
field for field, and names its process ``nnstreamer_tpu_torch:<pid>``.
Spans use host clocks only: recording one never waits for the card.

Always on: the span rings (`spans.py`) plus a bounded structured-event
ring are this process's last-N-seconds of history, at the cost of ring
appends. A dump renders both into Chrome ``trace_event`` JSON
(chrome://tracing / Perfetto load it directly):

* spans -> ``"ph": "X"`` complete events, with the trace/span/parent
  ids hex-encoded in ``args`` so a span tree can be re-linked across
  the per-process dumps of a fleet;
* structured events -> ``"ph": "i"`` instant events.

Dump triggers: on demand (:meth:`FlightRecorder.dump`), on
``Pipeline.preempt()``, and on any abort (``Pipeline.post_message``
error path) — abort dumps are rate-limited so a crash-looping fleet
cannot fill a disk. Files land in ``$NNS_TPU_FLIGHT_DIR`` (default
``build/flight``); setting it empty disables the automatic dumps.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils.log import logger
from . import spans

# retention window rendered into a dump (seconds of history)
WINDOW_S = float(os.environ.get("NNS_TPU_OBS_WINDOW", "30"))
EVENT_RING = 2048
# at most one automatic abort dump per process per this many seconds
ABORT_DUMP_INTERVAL_S = 30.0


class FlightRecorder:
    """Per-process singleton (module-level :data:`RECORDER`)."""

    def __init__(self):
        self._events: deque = deque(maxlen=EVENT_RING)
        self._elock = threading.Lock()
        self._last_abort_dump = 0.0
        self._dumps = 0

    # -- event side (obs.events.emit lands here) -----------------------
    def add_event(self, kind: str, source: str, fields: Dict[str, Any]
                  ) -> None:
        if not spans.ENABLED:
            return
        with self._elock:
            self._events.append((time.time_ns(), kind, source, fields))

    def events(self, window_s: Optional[float] = None) -> List[tuple]:
        cutoff = time.time_ns() - int((window_s or WINDOW_S) * 1e9)
        with self._elock:
            return [e for e in self._events if e[0] >= cutoff]

    def event_counts(self) -> Dict[str, int]:
        with self._elock:
            evs = list(self._events)
        out: Dict[str, int] = {}
        for _ts, kind, _src, _f in evs:
            out[kind] = out.get(kind, 0) + 1
        return out

    def clear(self) -> None:
        with self._elock:
            self._events.clear()
        spans.clear()

    # -- dumping -------------------------------------------------------
    def dump(self, path: Optional[str] = None,
             window_s: Optional[float] = None,
             reason: str = "on-demand") -> Dict[str, Any]:
        """Render the last ``window_s`` seconds into a Chrome
        trace_event document; write it to ``path`` when given."""
        cutoff = time.time_ns() - int((window_s or WINDOW_S) * 1e9)
        pid = os.getpid()
        out: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"nnstreamer_tpu_torch:{pid}"}}]
        names = spans.thread_names()
        for tid, name in names.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": name}})
        for tid, s in spans.snapshot():
            name, cat, ts_ns, dur_ns, trace_id, span_id, parent = s
            if ts_ns < cutoff:
                continue
            out.append({
                "ph": "X", "name": name, "cat": cat, "pid": pid,
                "tid": tid, "ts": ts_ns / 1e3, "dur": dur_ns / 1e3,
                "args": {"trace": f"{trace_id:x}", "span": f"{span_id:x}",
                         "parent": f"{parent:x}"}})
        for ts_ns, kind, source, fields in self.events(window_s):
            out.append({
                "ph": "i", "name": kind, "cat": "event", "pid": pid,
                "tid": 0, "ts": ts_ns / 1e3, "s": "p",
                "args": dict(fields, source=source)})
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": {"reason": reason, "pid": pid,
                             "window_s": window_s or WINDOW_S}}
        if path:
            tmp = f"{path}.tmp.{pid}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        return doc

    def dump_abort(self, reason: str, force: bool = False
                   ) -> Optional[str]:
        """The abort/preempt trigger: write a dump into the flight dir,
        rate-limited (``force=True`` for preempt, which is deliberate
        and singular). Returns the path, or None when skipped."""
        flight_dir = os.environ.get("NNS_TPU_FLIGHT_DIR", "build/flight")
        if not flight_dir or not spans.ENABLED:
            return None
        now = time.monotonic()
        with self._elock:
            if not force and \
                    now - self._last_abort_dump < ABORT_DUMP_INTERVAL_S:
                return None
            self._last_abort_dump = now
            self._dumps += 1
            n = self._dumps
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:48]
        path = os.path.join(flight_dir,
                            f"flight-{os.getpid()}-{safe}-{n}.json")
        try:
            os.makedirs(flight_dir, exist_ok=True)
            self.dump(path, reason=reason)
        except OSError as exc:
            logger.warning("flight recorder: dump to %s failed: %s",
                           path, exc)
            return None
        logger.info("flight recorder: dumped %s (%s)", path, reason)
        return path


RECORDER = FlightRecorder()
