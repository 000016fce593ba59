"""Frame-level observability: trace contexts, span ids and events.

Port of the part of ``nnstreamer_tpu/obs/`` that the wire and the
elements stamp. A :class:`~.context.TraceContext` rides in wire meta
(DATA) and in the DATA_BATCH per-frame header on links that negotiated
``trace``; the receiving side gives the wire hop a span id
(``spans.py``), and ``events.emit`` reports ``resume``, ``breaker`` and
``shed`` to the log and the bus. ``NNS_TPU_OBS=0`` disables tracing.

Not ported yet (``ROADMAP.md`` item 8): the span rings and the flight
recorder with its dumps, the per-element spans of the pipeline, and the
telemetry plane (``metrics.py``, ``server.py``, ``top.py``).
"""
from __future__ import annotations

from . import events  # noqa: F401  (re-export: obs.events.emit)
from .context import CTX_KEY, TraceContext, stamp  # noqa: F401
from .spans import record_span  # noqa: F401
