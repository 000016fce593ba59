"""Frame-level observability: spans, the flight recorder, and the
telemetry plane.

Port of ``nnstreamer_tpu/obs/``, which is framework neutral; every
module is a copy that reads host clocks and counters only, so no part
of it synchronises the card.

* **frame spans** (`context.py` + `spans.py`) — every source stamps a
  :class:`~.context.TraceContext` into ``Buffer.extras``; every element
  hop, queue wait, wire hop, in-flight dispatch/completion, serve batch
  and KV handoff records a span into a bounded per-thread ring. Wire
  hops carry the context in DATA meta and the DATA_BATCH per-frame
  header, on links that negotiated it.
* **flight recorder** (`recorder.py` + `events.py`) — the last N
  seconds of spans plus structured events (shed, breaker flips,
  failover, RESUME, preemption), dumped to Chrome ``trace_event`` JSON
  on demand, on ``Pipeline.preempt()``, and on any abort.
* **telemetry plane** (`metrics.py` + `server.py` + `top.py`) — a pull
  endpoint per process serving the Prometheus-style exposition of the
  runtime's counters and reservoirs plus end-to-end latency histograms
  with queue/compute/wire attribution, and
  ``python -m nnstreamer_tpu_torch top`` to scrape a fleet into one
  table.

``NNS_TPU_OBS=0`` disables recording entirely; everything else
defaults on.
"""
from __future__ import annotations

from . import events  # noqa: F401  (re-export: obs.events.emit)
from .context import (CTX_KEY, TraceContext, ctx_of, ensure_ctx,  # noqa: F401
                      stamp)
from .recorder import RECORDER, FlightRecorder  # noqa: F401
from .spans import enabled, record_span, set_enabled  # noqa: F401


def serve_metrics(port: int = 0, host: str = "127.0.0.1",
                  broker: object = None, topic: str = "obs",
                  labels: dict = None):
    """Start this process's telemetry pull endpoint (lazy import so the
    hot span path never pays for the server module)."""
    from .server import MetricsServer
    srv = MetricsServer(port=port, host=host, broker=broker, topic=topic,
                        labels=labels)
    srv.start()
    return srv
