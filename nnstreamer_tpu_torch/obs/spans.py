"""Bounded, lock-cheap per-thread span rings.

A copy of ``nnstreamer_tpu/obs/spans.py``, which is framework neutral.
Every element hop (:func:`chain_span`, from ``Element.chain``), queue
wait, wire hop, in-flight dispatch and completion, serve batch and KV
handoff records a span here; the flight recorder (``recorder.py``) dumps
the rings. Spans read host clocks only: a hop never synchronises the
card, so recording adds no device wait to the frame path.

The hot path touches no shared lock: each thread appends fixed-shape
tuples to its own bounded ``deque`` (C-level append, maxlen eviction).
The registry of rings is locked only when a new thread records its
first span and when a reader snapshots them. A span is the tuple::

    (name, cat, ts_ns, dur_ns, trace_id, span_id, parent_id)

with wall-clock (epoch) timestamps, so spans recorded in different
processes align. ``NNS_TPU_OBS=0`` turns the layer off; the wire then
negotiates no trace field.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import List, Optional, Tuple

from .context import CTX_KEY, _BASE, _IDS, TraceContext, next_id
from .context import _tls as _ctx_tls

# per-thread ring capacity (spans); NNS_TPU_OBS_RING overrides it
RING_SPANS = int(os.environ.get("NNS_TPU_OBS_RING", "8192"))

ENABLED = os.environ.get("NNS_TPU_OBS", "1").lower() \
    not in ("0", "false", "off")


def enabled() -> bool:
    return ENABLED


def set_enabled(on: bool) -> None:
    global ENABLED
    ENABLED = bool(on)


_tls = threading.local()
_rings: List[Tuple[int, str, deque]] = []     # (tid, thread name, ring)
_rings_lock = threading.Lock()


def _new_ring() -> deque:
    """Slow path of ``_ring()``: first span on this thread."""
    r = deque(maxlen=RING_SPANS)
    _tls.ring = r
    t = threading.current_thread()
    with _rings_lock:
        _rings.append((t.ident or 0, t.name, r))
    return r


def _ring() -> deque:
    try:
        return _tls.ring
    except AttributeError:
        return _new_ring()


def snapshot() -> List[tuple]:
    """Every live span, all threads: [(tid, span), ...]. Copying under
    the registry lock keeps concurrent appends safe."""
    with _rings_lock:
        rings = list(_rings)
    out = []
    for tid, _name, ring in rings:
        out.extend((tid, s) for s in list(ring))
    return out


def thread_names() -> dict:
    with _rings_lock:
        return {tid: name for tid, name, _ in _rings}


def clear() -> None:
    """Test hook: drop every recorded span (rings stay registered)."""
    with _rings_lock:
        for _tid, _name, ring in _rings:
            ring.clear()


def record_span(name: str, cat: str, ts_ns: int, dur_ns: int,
                ctx: Optional[TraceContext] = None,
                parent: Optional[int] = None) -> int:
    """Record one span; with a context the span parents onto the
    context's current span and becomes the new current (the linear
    causality chain). Returns the span id (0 when recording is off)."""
    if not ENABLED:
        return 0
    sid = _BASE | (next(_IDS) & 0xFFFFFF)   # next_id(), inlined
    ring = _ring()
    if ctx is not None:
        p = ctx.span_id if parent is None else parent
        ring.append((name, cat, ts_ns, dur_ns, ctx.trace_id, sid, p))
        ctx.span_id = sid
    else:
        ring.append((name, cat, ts_ns, dur_ns, 0, sid,
                     0 if parent is None else parent))
    return sid


def record_root(name: str, ctx: TraceContext) -> int:
    """The source-stamp root span (zero duration, no parent): children
    recorded downstream always find their parent in a snapshot."""
    if not ENABLED:
        return 0
    sid = next_id()
    _ring().append((name, "source", ctx.t0_ns, 0, ctx.trace_id, sid, 0))
    ctx.span_id = sid
    return sid


_observe_e2e = None    # metrics.observe_e2e, bound on first sink frame


def chain_span(element, buf, ts_ns: int, dur_ns: int) -> None:
    """The per-element hop: one span per buffer through ``chain()``,
    attributed to compute. Sinks additionally settle the frame's
    end-to-end histogram. ``ensure_ctx`` + ``record_span`` are inlined:
    this is the hottest call in the obs plane (once per element per
    frame)."""
    extras = buf.extras
    ctx = extras.get(CTX_KEY)
    if ctx is None:                  # fresh buffer: chain-thread inherit
        ctx = getattr(_ctx_tls, "ctx", None)
        if ctx is None:
            return
        extras[CTX_KEY] = ctx
    else:
        _ctx_tls.ctx = ctx
    sid = _BASE | (next(_IDS) & 0xFFFFFF)
    try:
        ring = _tls.ring
    except AttributeError:
        ring = _new_ring()
    ring.append((element.name, "element", ts_ns, dur_ns,
                 ctx.trace_id, sid, ctx.span_id))
    ctx.span_id = sid
    ctx.c_ns += dur_ns
    if not element.src_pads:         # terminal: the frame settles here
        global _observe_e2e
        if _observe_e2e is None:
            from .metrics import observe_e2e as _obs
            _observe_e2e = _obs
        _observe_e2e(element, ctx, ts_ns + dur_ns)
