"""Span ids for the wire hop.

Port of the id-minting half of ``nnstreamer_tpu/obs/spans.py``. The
reference appends every span to a per-thread ring that its flight
recorder dumps; the port has no reader of such rings yet (the dumps,
``metrics.py`` and ``top.py`` are ``ROADMAP.md`` item 8), so it keeps
none. What the wire needs stays: a recorded span gets a fleet-unique
id, parents onto the context's current span and becomes the new
current, so the next hop (a JAX peer included) parents onto it.

``NNS_TPU_OBS=0`` turns the layer off; the wire then negotiates no
trace field.
"""
from __future__ import annotations

import os
from typing import Optional

from .context import TraceContext, next_id

ENABLED = os.environ.get("NNS_TPU_OBS", "1").lower() \
    not in ("0", "false", "off")


def record_span(name: str, cat: str, ts_ns: int, dur_ns: int,
                ctx: Optional[TraceContext] = None,
                parent: Optional[int] = None) -> int:
    """Mint the id of one span (``name``, ``cat``, ``ts_ns``, ``dur_ns``
    and ``parent`` are the reference's signature; nothing stores them
    yet). With a context the span becomes its current one. Returns the
    span id (0 when recording is off)."""
    if not ENABLED:
        return 0
    sid = next_id()
    if ctx is not None:
        ctx.span_id = sid
    return sid
