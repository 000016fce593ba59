"""Pipeline tracing: proctime / interlatency / framerate per element.

Port of ``nnstreamer_tpu/utils/trace.py`` (≙ the GstShark tracers the
reference leans on: proctime, interlatency, framerate, queue-level),
built in, since this runtime owns its scheduler. Enable per pipeline::

    tracer = pipeline.enable_tracing()
    pipeline.run()
    print(tracer.report(pipeline))

Semantics:
  * proctime      — host time spent inside each element's chain call
                    (accumulated in ``Element.stats``; surfaced here).
                    A chain call includes every element downstream of
                    it on the same thread, up to the next queue.
  * interlatency  — time from a buffer's FIRST entry into the pipeline
                    (stamped by the source) to its arrival at each
                    element; a fresh buffer built inside a chain call
                    inherits the birth of the buffer that caused it
  * framerate     — buffers/sec observed at each element
  * queue-level   — live fill of each queue element at report time
  * percentiles   — p50/p95/p99 of each series from a bounded
                    reservoir (O(1) per buffer, fixed memory)

On the card these are host times. A filter's ``proctime`` is the host
time of its dispatch — staging the inputs and ``cudaGraphLaunch`` —
not the device time of the model: the replay is enqueued and the chain
call returns before the device finishes. An element that reads a CUDA
chunk on the host (a decoder, ``tensor_if``, an aggregator, a sink's
``host()``) waits there for the device work queued before it, so the
device time shows up in that element's proctime and in the
interlatency of the elements after it; interlatency at a sink includes
device completion only where the sink materialises the frame.

A networked element (``tensor_query_*``, ``edgesink``/``edgesrc``)
adds a per-link ``wire`` block (bytes and messages each way, the codec's
compression ratio, pack time, frames per message) and a ``session``
block (sent/delivered, replays, duplicate drops, declared losses, acks,
heartbeat RTT and the element's live ring gauges).

Not ported: the serve router's block and the discovery broker's
counters; their modules are not in the port yet.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Sequence

# bounded per-series sample budget: 512 f64 samples = 4 KB per element,
# enough for +/- a few percent on p99 at streaming rates
_RESERVOIR_K = 512


def _wire_summary(st: Dict[str, Any]) -> Dict[str, Any]:
    """Condense an element's wire_* counters (edge/wire.py) into the
    per-link block report() exposes; {} when the element never touched
    a socket, so non-networked elements stay uncluttered."""
    out: Dict[str, Any] = {}
    for key in ("wire_bytes_out", "wire_bytes_in",
                "wire_msgs_out", "wire_msgs_in"):
        if st.get(key):
            out[key[5:]] = st[key]
    raw, enc = st.get("wire_raw_bytes_out", 0), st.get("wire_enc_bytes_out", 0)
    if raw and enc:
        out["compress_ratio"] = round(raw / enc, 3)
    frames_out = st.get("wire_frames_out", 0)
    if frames_out:
        out["frames_out"] = frames_out
        out["pack_us_avg"] = round(
            st.get("wire_pack_ns", 0) / frames_out / 1e3, 2)
        msgs = st.get("wire_msgs_out", 0)
        if msgs:
            out["frames_per_msg"] = round(frames_out / msgs, 2)
    if st.get("wire_frames_in"):
        out["frames_in"] = st["wire_frames_in"]
    return out


def _session_summary(st: Dict[str, Any], el=None) -> Dict[str, Any]:
    """Condense an element's session_* counters (edge/session.py) into
    the per-link delivery-guarantee block: sent/delivered, replays,
    dup-drops, DECLARED losses, ack traffic, heartbeat RTT. {} for
    sessionless elements so existing reports are unchanged. The numbers
    are exact by construction — the chaos harness asserts
    sent == delivered + declared_lost (+ in-flight) from this block."""
    out: Dict[str, Any] = {}
    for key, val in st.items():
        if key.startswith("session_") and val:
            out[key[8:]] = val
    pongs = st.get("session_pongs", 0)
    if pongs:
        out["rtt_us_avg"] = round(
            st.get("session_rtt_ns", 0) / pongs / 1e3, 1)
        out.pop("rtt_ns", None)
    # live (non-counter) gauges: ring fill, attached sessions, frames
    # awaiting a correlated result — whatever the element exposes
    info = getattr(el, "session_info", None)
    if callable(info):
        try:
            out.update(info() or {})
        except Exception:  # noqa: BLE001 — reporting must never raise
            pass
    return out


def _percentiles(samples, qs: Sequence[int]) -> Dict[str, float]:
    s = sorted(samples)
    out: Dict[str, float] = {}
    for q in qs:
        out[f"p{q}"] = (s[min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))]
                        if s else 0.0)
    return out


class Reservoir:
    """Algorithm-R bounded reservoir: O(1) cost per observation, fixed
    memory, uniformly representative of the whole stream. Seeded, so a
    rerun of the same stream reports the same numbers."""

    __slots__ = ("k", "n", "samples", "_rng")

    def __init__(self, k: int = _RESERVOIR_K, seed: int = 0):
        self.k = max(1, int(k))
        self.n = 0
        self.samples: list = []
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self.n += 1
        if len(self.samples) < self.k:
            self.samples.append(value)
        else:
            j = self._rng.randrange(self.n)
            if j < self.k:
                self.samples[j] = value

    def percentiles(self, qs: Sequence[int] = (50, 95, 99)) -> Dict[str, float]:
        return _percentiles(self.samples, qs)


class WindowReservoir:
    """Time-windowed percentiles: samples older than ``window_s`` fall
    out, so a control signal (an autoscaler reading p95) sees recovery
    after a burst. Bounded at ``k`` samples (newest win)."""

    __slots__ = ("window_s", "k", "n", "_buf")

    def __init__(self, window_s: float = 2.0, k: int = _RESERVOIR_K):
        self.window_s = max(1e-3, float(window_s))
        self.k = max(1, int(k))
        self.n = 0
        self._buf: deque = deque()  # (t_mono, value), oldest first

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        buf = self._buf
        while buf and (buf[0][0] < horizon or len(buf) > self.k):
            buf.popleft()

    def add(self, value: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.n += 1
        self._buf.append((now, value))
        self._prune(now)

    def samples(self, now: Optional[float] = None) -> list:
        self._prune(time.monotonic() if now is None else now)
        return [v for _, v in self._buf]

    def percentiles(self, qs: Sequence[int] = (50, 95, 99),
                    now: Optional[float] = None) -> Dict[str, float]:
        return _percentiles(self.samples(now), qs)


class _Agg:
    """O(1)-memory running aggregate (sum/max/count/first/last) plus a
    bounded reservoir for tail percentiles."""

    __slots__ = ("n", "total", "peak", "first_ts", "last_ts", "res")

    def __init__(self, now: float):
        self.n = 0
        self.total = 0
        self.peak = 0
        self.first_ts = now
        self.last_ts = now
        self.res = Reservoir()


class Tracer:
    BIRTH_KEY = "_trace_birth_ns"

    def __init__(self):
        # per-element aggregates; the lock keeps fan-in elements (mux
        # fed from several queue threads) from losing counts
        self._agg: Dict[str, _Agg] = {}
        self._lock = threading.Lock()
        # last-seen birth per streaming thread: elements that build a
        # FRESH Buffer (converter, mux, aggregator, decoders) drop the
        # extras, but their output is pushed synchronously inside the
        # chain of the buffer that caused it, so the thread's current
        # birth is the right inheritance. Sources stamp their buffers
        # explicitly (stamp()), so a root buffer never inherits a
        # predecessor's birth.
        self._tls = threading.local()

    def stamp(self, buf) -> None:
        """Mark a buffer's birth at the source."""
        buf.extras[self.BIRTH_KEY] = time.perf_counter_ns()

    # called from Element.chain for every buffer when tracing is on
    def record(self, element, buf) -> None:
        now_ns = time.perf_counter_ns()
        birth = buf.extras.get(self.BIRTH_KEY)
        if birth is None:
            birth = getattr(self._tls, "birth", None)
            if birth is None:
                birth = now_ns
            buf.extras[self.BIRTH_KEY] = birth
        self._tls.birth = birth
        self._observe(element.name, now_ns - birth, now_ns / 1e9)

    def observe(self, series: str, value_ns: float) -> None:
        """Feed a named scalar series (ns) from outside the buffer path,
        e.g. a fused segment's dispatch time. Reported alongside elements
        with the same field names (the ``interlatency_us_*`` columns
        carry the observed value)."""
        self._observe(series, value_ns, time.perf_counter_ns() / 1e9)

    def _observe(self, key: str, lat: float, now: float) -> None:
        with self._lock:
            agg = self._agg.get(key)
            if agg is None:
                agg = self._agg[key] = _Agg(now)
            agg.n += 1
            agg.total += lat
            if lat > agg.peak:
                agg.peak = lat
            agg.res.add(lat)
            agg.last_ts = now

    def report(self, pipeline=None) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            snap = {k: (a.n, a.total, a.peak, a.first_ts, a.last_ts,
                        a.res.percentiles())
                    for k, a in self._agg.items()}
        for name, (n, total, peak, first_ts, last_ts, pct) in snap.items():
            dt = last_ts - first_ts
            out[name] = {
                "buffers": n,
                "interlatency_us_avg": total / n / 1e3 if n else 0.0,
                "interlatency_us_max": peak / 1e3,
                "interlatency_us_p50": pct["p50"] / 1e3,
                "interlatency_us_p95": pct["p95"] / 1e3,
                "interlatency_us_p99": pct["p99"] / 1e3,
                "framerate_fps": (n - 1) / dt if n > 1 and dt > 0 else 0.0,
            }
        if pipeline is not None:
            for name, el in pipeline.elements.items():
                entry = out.setdefault(name, {})
                # one consistent point-in-time copy per element: a
                # mid-flight chain bump can't tear buffers/proctime
                st = el.stats.snapshot()
                if st.get("buffers"):
                    entry["proctime_us_avg"] = (st["proctime_ns"] /
                                                st["buffers"] / 1e3)
                # drop accounting: only shown when something happened
                for key in ("dropped", "retries", "restarts", "shed"):
                    if st.get(key):
                        entry[key] = st[key]
                w = _wire_summary(st)
                if w:
                    entry["wire"] = w
                s = _session_summary(st, el)
                if s:
                    entry["session"] = s
                q = getattr(el, "_q", None)
                if q is not None and hasattr(q, "qsize"):
                    entry["queue_level"] = q.qsize()
            fusion = self._fusion_block(pipeline, out)
            if fusion:
                out["fusion"] = fusion
            transfer = self._transfer_block(pipeline)
            if transfer:
                out["transfer"] = transfer
        return out

    @staticmethod
    def _fusion_block(pipeline, report: Dict[str, Dict[str, Any]]
                      ) -> Dict[str, Any]:
        """Aggregate fusion stats: one sub-entry per FusedSegment (member
        count, executable hits/misses, p50 of the host dispatch time
        observed as ``fusion/<name>``) plus pipeline totals. {} on
        unfused pipelines."""
        segments: Dict[str, Any] = {}
        for name, el in pipeline.elements.items():
            if not getattr(el, "IS_FUSED_SEGMENT", False):
                continue
            st = el.stats.snapshot()
            seg = {
                "elements": st.get("fused_elements", 0),
                "members": [m.name for m in getattr(el, "members", [])],
                "jit_hits": st.get("jit_hits", 0),
                "jit_misses": st.get("jit_misses", 0),
                # the port runs one segment on one card
                "devices": st.get("devices", 1) or 1,
            }
            # the dispatch-time series is internal plumbing; fold it
            # into the segment entry instead of a top-level row
            series = report.pop(f"fusion/{name}", None)
            if series is not None:
                seg["dispatch_us_p50"] = series["interlatency_us_p50"]
                seg["dispatch_us_p95"] = series["interlatency_us_p95"]
            segments[name] = seg
        if not segments:
            return {}
        return {
            "segments": len(segments),
            "fused_elements": sum(s["elements"] for s in segments.values()),
            "jit_hits": sum(s["jit_hits"] for s in segments.values()),
            "jit_misses": sum(s["jit_misses"] for s in segments.values()),
            "devices": max(s["devices"] for s in segments.values()),
            "per_segment": segments,
        }

    @staticmethod
    def _transfer_block(pipeline) -> Dict[str, Any]:
        """The overlapped-execution view: per-element in-flight window
        stats (from each element's ``transfer_report()``) plus the
        coalescing service's achieved depths (frames per copy batch).
        {} when nothing overlapped or coalesced."""
        out: Dict[str, Any] = {}
        windows: Dict[str, Any] = {}
        for name, el in pipeline.elements.items():
            rep = getattr(el, "transfer_report", None)
            if callable(rep):
                r = rep()
                if r:
                    windows[name] = r
        if windows:
            out["windows"] = windows
            ratios = [w["overlap_ratio"] for w in windows.values()
                      if w.get("overlap_ratio")]
            if ratios:
                out["overlap_ratio"] = round(max(ratios), 2)
            spans = [int(w.get("devices", 1) or 1)
                     for w in windows.values()]
            out["devices"] = max(spans) if spans else 1
        from ..tensors.transfer import transfer_stats
        for direction, st in transfer_stats().items():
            if st.get("rpcs"):
                out[direction] = {
                    "rpcs": st["rpcs"], "frames": st["frames"],
                    "arrays": st["arrays"],
                    "coalesce_avg": round(st["frames_per_rpc_avg"], 2),
                }
        return out
