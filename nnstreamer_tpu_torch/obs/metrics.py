"""Prometheus-style text exposition of the runtime's live state.

A copy of ``nnstreamer_tpu/obs/metrics.py`` with the JAX package's
series names: for the same state (histogram observations, element
counters, event counts) both packages render the same bytes, and
either package's :func:`parse` reads the other's scrape. Rendering
reads counters and host-side reservoirs only; a scrape never waits for
the card.

One scrape renders, in the standard ``name{labels} value`` text format:

* **end-to-end latency histograms** per (pipeline, sink) — fed by the
  span layer when a frame settles at a terminal element — plus the
  frame's queue/compute/wire attribution as monotonic seconds counters
  (``rate(nns_e2e_queue_seconds_total)`` / ``rate(..._count)`` = mean
  queue share, the autoscaler's signal);
* every per-element ``Counters`` snapshot of every registered pipeline;
* every ``ServeScheduler``'s occupancy gauges and queue-delay /
  batch-latency ``Reservoir`` percentiles (live, the series ROADMAP's
  autoscaler item polls);
* when a pipeline has a tracer attached, the full ``trace.report()``
  flattened leaf-by-leaf — every Counters/Reservoir the tracer already
  aggregates becomes a scrapeable series;
* flight-recorder structured-event counts by kind.

Pipelines register at ``start()`` and unregister at ``stop()``
(weakly — a dropped pipeline never pins itself here).
"""
from __future__ import annotations

import re
import threading
import weakref
from typing import Dict, List, Optional, Tuple

# log-ish bucket ladder (seconds) for end-to-end frame latency: sub-ms
# local pipelines through multi-second cold paths
E2E_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
               0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Fixed-bucket counting histogram (cumulative on render, plain
    per-bucket counts internally). One leaf lock; observe is O(len)."""

    def __init__(self, buckets: Tuple[float, ...] = E2E_BUCKETS):
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)   # +1: overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = 0
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """-> (cumulative counts per bucket + +Inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return cum, total, n


class _E2E:
    __slots__ = ("hist", "q_s", "c_s", "w_s", "frames")

    def __init__(self):
        self.hist = Histogram()
        self.q_s = 0.0
        self.c_s = 0.0
        self.w_s = 0.0
        self.frames = 0


_lock = threading.Lock()
_e2e: Dict[Tuple[str, str], _E2E] = {}
_pipelines: "weakref.WeakSet" = weakref.WeakSet()


def observe_e2e(element, ctx, now_ns: int) -> None:
    """A frame settled at a terminal element: feed its end-to-end
    latency and attribution (called from the span layer, once per frame
    — the registry lookup is cached on the element so the steady state
    pays one histogram lock and nothing else)."""
    try:
        ent = element._obs_e2e
    except AttributeError:
        pname = getattr(getattr(element, "pipeline", None),
                        "name", "") or ""
        with _lock:
            ent = _e2e.setdefault((pname, element.name), _E2E())
        element._obs_e2e = ent
    ent.hist.observe(max(0, now_ns - ctx.t0_ns) * 1e-9)
    # attribution counters are scrape-side aggregates; racing adds may
    # drop a sample's worth of precision, never corrupt (floats)
    ent.q_s += ctx.q_ns * 1e-9
    ent.c_s += ctx.c_ns * 1e-9
    ent.w_s += ctx.w_ns * 1e-9
    ent.frames += 1


def register_pipeline(pipeline) -> None:
    with _lock:
        _pipelines.add(pipeline)


def unregister_pipeline(pipeline) -> None:
    with _lock:
        _pipelines.discard(pipeline)


def reset() -> None:
    """Test hook; call between pipelines (elements of a still-running
    pipeline keep feeding their cached entry, not the fresh registry)."""
    with _lock:
        _e2e.clear()


# -- rendering ----------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _san(s: str) -> str:
    return _NAME_RE.sub("_", str(s))


def _esc(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _labels(**kv) -> str:
    inner = ",".join(f'{_san(k)}="{_esc(v)}"' for k, v in kv.items())
    return "{" + inner + "}" if inner else ""


def _num(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _flatten(prefix: str, obj, out: List[Tuple[str, float]]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}" if prefix else str(k), v, out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}/{i}", v, out)
    else:
        n = _num(obj)
        if n is not None:
            out.append((prefix, n))


def render() -> str:
    """The full exposition document (text/plain; version=0.0.4)."""
    lines: List[str] = []

    # 1) end-to-end latency histograms + attribution
    with _lock:
        e2e = dict(_e2e)
        pipelines = list(_pipelines)
    if e2e:
        lines.append("# HELP nns_e2e_latency_seconds end-to-end frame "
                     "latency, source stamp to terminal sink")
        lines.append("# TYPE nns_e2e_latency_seconds histogram")
        for (pname, sink), ent in sorted(e2e.items()):
            cum, total, n = ent.hist.snapshot()
            for edge, c in zip(ent.hist.buckets, cum):
                lines.append(
                    f"nns_e2e_latency_seconds_bucket"
                    f'{_labels(pipeline=pname, sink=sink, le=repr(edge))}'
                    f" {c}")
            lines.append(f"nns_e2e_latency_seconds_bucket"
                         f'{_labels(pipeline=pname, sink=sink, le="+Inf")}'
                         f" {cum[-1]}")
            lines.append(f"nns_e2e_latency_seconds_sum"
                         f"{_labels(pipeline=pname, sink=sink)} {total}")
            lines.append(f"nns_e2e_latency_seconds_count"
                         f"{_labels(pipeline=pname, sink=sink)} {n}")
        lines.append("# TYPE nns_e2e_queue_seconds_total counter")
        lines.append("# TYPE nns_e2e_compute_seconds_total counter")
        lines.append("# TYPE nns_e2e_wire_seconds_total counter")
        for (pname, sink), ent in sorted(e2e.items()):
            lab = _labels(pipeline=pname, sink=sink)
            lines.append(f"nns_e2e_queue_seconds_total{lab} {ent.q_s}")
            lines.append(f"nns_e2e_compute_seconds_total{lab} {ent.c_s}")
            lines.append(f"nns_e2e_wire_seconds_total{lab} {ent.w_s}")

    # 2) per-element counters of every registered pipeline
    emitted_counter_type = False
    emitted_jit_type = False
    for p in pipelines:
        pname = getattr(p, "name", "") or ""
        for e in getattr(p, "elements", {}).values():
            try:
                snap = e.stats.snapshot()
            except Exception:  # noqa: BLE001 — a scrape never takes the runtime down
                continue
            for k, v in sorted(snap.items()):
                n = _num(v)
                if n is None:
                    continue
                if not emitted_counter_type:
                    lines.append("# TYPE nns_element_counter_total counter")
                    emitted_counter_type = True
                lines.append(
                    f"nns_element_counter_total"
                    f"{_labels(pipeline=pname, element=e.name, counter=k)}"
                    f" {n}")
                if k == "jit_recompiles":
                    # first-class family: frame-path compiles per filter
                    # (jitcheck's runtime contract — zero once warm)
                    if not emitted_jit_type:
                        lines.append(
                            "# TYPE nns_jit_recompiles_total counter")
                        emitted_jit_type = True
                    lines.append(
                        f"nns_jit_recompiles_total"
                        f"{_labels(pipeline=pname, element=e.name)} {n}")

    # 3) serve schedulers: live occupancy gauges + reservoir quantiles
    from ..serve.scheduler import SERVE_TABLE, _TABLE_LOCK
    with _TABLE_LOCK:
        scheds = dict(SERVE_TABLE)
    if scheds:
        lines.append("# TYPE nns_serve_depth gauge")
        lines.append("# TYPE nns_serve_streams gauge")
        lines.append("# TYPE nns_serve_occupancy_avg gauge")
        lines.append("# TYPE nns_serve_queue_delay_us gauge")
        lines.append("# TYPE nns_serve_batch_latency_us gauge")
    for sid, sched in sorted(scheds.items(), key=lambda kv: str(kv[0])):
        try:
            occ = sched.occupancy()
            rep = sched.report()
        except Exception:  # noqa: BLE001 — a scrape never takes the runtime down
            continue
        lab = _labels(serve=sid, name=sched.name)
        lines.append(f"nns_serve_depth{lab} {occ['depth']}")
        lines.append(f"nns_serve_streams{lab} {occ['streams']}")
        lines.append(f"nns_serve_occupancy_avg{lab} {occ['occupancy_avg']}")
        for q, v in sorted(rep.get("queue_delay_us", {}).items()):
            lines.append(
                f"nns_serve_queue_delay_us"
                f"{_labels(serve=sid, name=sched.name, quantile=q)} {v}")
        for q, v in sorted(rep.get("batch_latency_us", {}).items()):
            lines.append(
                f"nns_serve_batch_latency_us"
                f"{_labels(serve=sid, name=sched.name, quantile=q)} {v}")

    # 3b) KV block pools (paged LLM serving): occupancy is the
    # admission budget, the hit ratio is the prefix cache earning (or
    # not earning) its blocks
    from ..filters.kvpool import POOL_TABLE, _POOL_LOCK
    with _POOL_LOCK:
        pools = dict(POOL_TABLE)
    if pools:
        lines.append("# TYPE nns_kv_blocks_free gauge")
        lines.append("# TYPE nns_kv_blocks_used gauge")
        lines.append("# TYPE nns_kv_blocks_cached gauge")
        lines.append("# TYPE nns_kv_prefix_hit_ratio gauge")
        lines.append("# TYPE nns_kv_prefix_evictions_total counter")
    for pname, pool in sorted(pools.items()):
        try:
            d = pool.stats_dict()
        except Exception:  # noqa: BLE001 — a scrape never takes the runtime down
            continue
        lab = _labels(pool=pname)
        lines.append(f"nns_kv_blocks_free{lab} {d['blocks_free']}")
        lines.append(f"nns_kv_blocks_used{lab} {d['blocks_used']}")
        lines.append(f"nns_kv_blocks_cached{lab} {d['blocks_cached']}")
        lines.append(
            f"nns_kv_prefix_hit_ratio{lab} {d['prefix_hit_ratio']:.6f}")
        lines.append(
            f"nns_kv_prefix_evictions_total{lab} {d['prefix_evictions']}")

    # 3c) delta transport: the wire codec's keyframe/diff economics plus
    # the compute-skip gate, aggregated across every registered pipeline
    # — the fleet-level "bytes and invokes we did not pay for" series
    delta = {"keyframes": 0, "diffs": 0, "promotions": 0, "bytes_saved": 0,
             "frames_skipped": 0, "tiles_skipped": 0, "tiles_total": 0}
    for p in pipelines:
        for e in getattr(p, "elements", {}).values():
            try:
                snap = e.stats.snapshot()
            except Exception:  # noqa: BLE001 — a scrape never takes the runtime down
                continue
            delta["keyframes"] += snap.get("wire_delta_keyframes", 0)
            delta["diffs"] += snap.get("wire_delta_diffs", 0)
            delta["promotions"] += snap.get("wire_delta_promotions", 0)
            delta["bytes_saved"] += snap.get("wire_delta_bytes_saved", 0)
            delta["frames_skipped"] += snap.get("delta_frames_skipped", 0)
            delta["tiles_skipped"] += snap.get("delta_tiles_skipped", 0)
            delta["tiles_total"] += snap.get("delta_tiles_total", 0)
    if any(delta.values()):
        for key, val in delta.items():
            lines.append(f"# TYPE nns_delta_{key} gauge")
            lines.append(f"nns_delta_{key} {val}")

    # 3d) elastic fleet: live autoscalers expose the replica lifecycle
    # (the conservation identity's terms) as per-state gauges — what a
    # dashboard needs to see scale events and in-progress rollouts
    from ..fleet.autoscaler import live_autoscalers
    autos = live_autoscalers()
    if autos:
        lines.append("# TYPE nns_fleet_replicas gauge")
        lines.append("# TYPE nns_fleet_lifecycle_total counter")
    for auto in sorted(autos, key=lambda a: a.name):
        try:
            states = auto.replicas()
            life = auto.lifecycle()
        except Exception:  # noqa: BLE001 — a scrape never takes the runtime down
            continue
        by_state: Dict[str, int] = {}
        for st in states.values():
            by_state[st] = by_state.get(st, 0) + 1
        for st in ("serving", "draining", "resurrecting"):
            lines.append(
                f"nns_fleet_replicas"
                f"{_labels(autoscaler=auto.name, state=st)}"
                f" {by_state.get(st, 0)}")
        for k, v in sorted(life.items()):
            n = _num(v)
            if n is None:
                continue
            lines.append(
                f"nns_fleet_lifecycle_total"
                f"{_labels(autoscaler=auto.name, counter=k)} {n}")

    # 4) attached tracers: the full report, flattened — every
    # Counters/Reservoir trace.py aggregates becomes a series
    emitted_trace_type = False
    for p in pipelines:
        tracer = getattr(p, "tracer", None)
        if tracer is None:
            continue
        try:
            rep = tracer.report(p)
        except Exception:  # noqa: BLE001 — a scrape never takes the runtime down
            continue
        flat: List[Tuple[str, float]] = []
        _flatten("", rep, flat)
        pname = getattr(p, "name", "") or ""
        for path, v in flat:
            if not emitted_trace_type:
                lines.append("# TYPE nns_trace gauge")
                emitted_trace_type = True
            lines.append(
                f"nns_trace{_labels(pipeline=pname, path=path)} {v}")

    # 5) flight-recorder structured events by kind
    from .recorder import RECORDER
    counts = RECORDER.event_counts()
    if counts:
        lines.append("# TYPE nns_events_total counter")
        for kind, n in sorted(counts.items()):
            lines.append(f"nns_events_total{_labels(kind=kind)} {n}")

    return "\n".join(lines) + "\n"


# -- scrape-side parsing (the `top` CLI reuses it) ----------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Parse a text exposition back into {(name, ((k, v), ...)): value}."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, rawlab, val = m.groups()
        labels = tuple(sorted(
            (k, v.replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(rawlab or "")))
        try:
            out[(name, labels)] = float(val)
        except ValueError:
            continue
    return out
