"""``python -m nnstreamer_tpu_torch top`` — the fleet cockpit.

A copy of ``nnstreamer_tpu/obs/top.py``; it reads either package's
endpoints (the exposition format is shared).

Scrapes every telemetry endpoint it can find — explicit ``--targets``
plus whatever registered under ``--topic`` on a discovery broker — and
renders one table row per process: serve depth/streams/occupancy,
queue-delay p50, end-to-end latency p50-ish (from the histogram), frame
throughput, and shed/event counts. One-shot by default; ``--watch N``
redraws every N seconds (rates are computed between scrapes).
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from . import metrics
from .server import scrape

Sample = Dict[Tuple[str, tuple], float]


def _discover(broker: str, topic: str, timeout: float
              ) -> List[Tuple[str, int]]:
    host, _, port = broker.partition(":")
    from ..edge.broker import discover_meta
    eps = []
    for (h, p), meta in discover_meta(host or "localhost",
                                      int(port or 3100), topic,
                                      timeout=timeout):
        if not meta or meta.get("role") == "obs":
            eps.append((h, p))
    return eps


def _get(samples: Sample, name: str, **match) -> float:
    """Sum every sample of ``name`` whose labels include ``match``."""
    total, hit = 0.0, False
    for (n, labels), v in samples.items():
        if n != name:
            continue
        lab = dict(labels)
        if all(lab.get(k) == str(w) for k, w in match.items()):
            total += v
            hit = True
    return total if hit else float("nan")


def _hist_p50(samples: Sample) -> float:
    """Approximate pooled p50 (ms) from the e2e histogram buckets."""
    by_le: Dict[float, float] = {}
    total = 0.0
    for (n, labels), v in samples.items():
        if n == "nns_e2e_latency_seconds_bucket":
            le = dict(labels).get("le", "+Inf")
            edge = float("inf") if le == "+Inf" else float(le)
            by_le[edge] = by_le.get(edge, 0.0) + v
        elif n == "nns_e2e_latency_seconds_count":
            total += v
    if not by_le or total <= 0:
        return float("nan")
    half = total / 2.0
    for edge in sorted(by_le):
        if by_le[edge] >= half:
            return edge * 1e3 if edge != float("inf") else float("nan")
    return float("nan")


def _row(host: str, port: int, samples: Sample,
         prev: Optional[Tuple[float, Sample]]) -> Dict[str, object]:
    frames = _get(samples, "nns_element_counter_total", counter="buffers")
    fps = float("nan")
    if prev is not None:
        t_prev, s_prev = prev
        dt = time.monotonic() - t_prev
        f_prev = _get(s_prev, "nns_element_counter_total",
                      counter="buffers")
        if dt > 0 and frames == frames and f_prev == f_prev:
            fps = max(0.0, (frames - f_prev) / dt)
    shed = sum(v for (n, labels), v in samples.items()
               if n == "nns_events_total"
               and dict(labels).get("kind") == "shed")
    return {
        "endpoint": f"{host}:{port}",
        "depth": _get(samples, "nns_serve_depth"),
        "streams": _get(samples, "nns_serve_streams"),
        "occ": _get(samples, "nns_serve_occupancy_avg"),
        "qd_p50_us": _get(samples, "nns_serve_queue_delay_us",
                          quantile="p50"),
        "e2e_p50_ms": _hist_p50(samples),
        "fps": fps,
        "shed": shed,
        "events": sum(v for (n, _), v in samples.items()
                      if n == "nns_events_total"),
    }


def _fmt(v: object) -> str:
    if isinstance(v, float):
        if v != v:
            return "-"
        return f"{v:.1f}" if abs(v) < 1e5 else f"{v:.3g}"
    return str(v)


_COLS = ("endpoint", "depth", "streams", "occ", "qd_p50_us",
         "e2e_p50_ms", "fps", "shed", "events")


def render_table(rows: List[Dict[str, object]]) -> str:
    headers = [c.upper() for c in _COLS]
    cells = [[_fmt(r.get(c)) for c in _COLS] for r in rows]
    widths = [max(len(h), *(len(row[i]) for row in cells)) if cells
              else len(h) for i, h in enumerate(headers)]
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for row in cells:
        out.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    return "\n".join(out)


def collect(targets: List[Tuple[str, int]], timeout: float,
            prev: Dict[Tuple[str, int], Tuple[float, Sample]]
            ) -> List[Dict[str, object]]:
    rows = []
    for host, port in targets:
        try:
            samples = metrics.parse(scrape(host, port, timeout=timeout))
        except (OSError, ConnectionError) as exc:
            rows.append({"endpoint": f"{host}:{port}",
                         "events": f"unreachable ({exc})"})
            continue
        rows.append(_row(host, port, samples, prev.get((host, port))))
        prev[(host, port)] = (time.monotonic(), samples)
    return rows


def main(argv: List[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch top",
        description="scrape a fleet's telemetry endpoints into one table")
    ap.add_argument("--targets", default="",
                    help="comma-separated host:port telemetry endpoints")
    ap.add_argument("--broker", default="",
                    help="discovery broker host:port to query for --topic")
    ap.add_argument("--topic", default="obs")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="redraw every SECS seconds (0 = one-shot)")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--json", action="store_true",
                    help="emit rows as JSON instead of a table")
    args = ap.parse_args(argv)

    targets: List[Tuple[str, int]] = []
    for t in args.targets.split(","):
        t = t.strip()
        if t:
            h, _, p = t.rpartition(":")
            targets.append((h or "localhost", int(p)))
    if args.broker:
        try:
            for ep in _discover(args.broker, args.topic, args.timeout):
                if ep not in targets:
                    targets.append(ep)
        except (OSError, ConnectionError) as exc:
            print(f"top: broker {args.broker} unreachable: {exc}",
                  file=sys.stderr)
    if not targets:
        print("top: no targets (give --targets and/or --broker)",
              file=sys.stderr)
        return 2

    prev: Dict[Tuple[str, int], Tuple[float, Sample]] = {}
    while True:
        rows = collect(targets, args.timeout, prev)
        if args.json:
            print(json.dumps(rows, default=str))
        else:
            if args.watch > 0:
                print("\x1b[2J\x1b[H", end="")
            print(render_table(rows))
        if args.watch <= 0:
            return 0
        time.sleep(args.watch)
