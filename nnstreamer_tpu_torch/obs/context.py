"""TraceContext: the per-frame identity a span tree hangs off.

A copy of ``nnstreamer_tpu/obs/context.py``, which is framework
neutral.

One context object rides in ``Buffer.extras[CTX_KEY]`` from the source
that stamped it to whatever finally settles the frame — across queue
hops (extras survive the queue), element rewrites (``copy_meta_from`` /
``with_chunks`` copy extras; elements that mint fresh buffers inherit
the chain thread's current context, mirroring ``utils.trace``'s
birth-stamp inheritance), and wire hops (``edge.wire`` re-creates the
context on the receiving side from the negotiated trace field).

The context is deliberately mutable: each recorded span advances
``span_id`` so the next hop parents onto it — frame causality is a
linear chain per process, forked only by explicit links (batch
adoption, overlap completion). The ``q_ns``/``c_ns``/``w_ns``
accumulators attribute the frame's end-to-end latency to queue wait,
compute, and wire time; they cross process boundaries inside the wire
trace field so the final sink's histogram sees the whole journey.
"""
from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Optional

# extras key; must not collide with utils.trace's "_trace*" namespace
# (test_trace pins that tracing-off leaves no "_trace" keys behind)
CTX_KEY = "_obs_ctx"
# queue-entry wall stamp (pipeline/basic.py Queue): set on put, consumed
# on the worker's pop to record the queue-wait span
QT_KEY = "_obs_qns"

# id allocation: a per-process random 63-bit base with a low 24-bit
# counter — unique across the fleet without paying getrandbits() per
# frame. itertools.count.__next__ is atomic under the GIL.
_BASE = random.getrandbits(63) & ~0xFFFFFF
_IDS = itertools.count(1)


def next_id() -> int:
    return _BASE | (next(_IDS) & 0xFFFFFF)


class TraceContext:
    """(trace_id, current span) + latency attribution accumulators."""

    __slots__ = ("trace_id", "span_id", "t0_ns", "q_ns", "c_ns", "w_ns")

    def __init__(self, trace_id: int, span_id: int, t0_ns: int,
                 q_ns: int = 0, c_ns: int = 0, w_ns: int = 0):
        self.trace_id = trace_id
        self.span_id = span_id       # most recent span = next hop's parent
        self.t0_ns = t0_ns           # birth wall time (epoch ns)
        self.q_ns = q_ns             # queue-wait attribution
        self.c_ns = c_ns             # compute attribution
        self.w_ns = w_ns             # wire attribution

    def child(self) -> "TraceContext":
        """Fork for a derived frame (batch adoption): same trace, same
        parent span, fresh accumulators."""
        return TraceContext(self.trace_id, self.span_id, self.t0_ns)

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id:#x}, span={self.span_id:#x}, "
                f"q={self.q_ns} c={self.c_ns} w={self.w_ns})")

    # pickle support for checkpointed buffers (slots, no __dict__)
    def __getstate__(self):
        return (self.trace_id, self.span_id, self.t0_ns,
                self.q_ns, self.c_ns, self.w_ns)

    def __setstate__(self, state):
        (self.trace_id, self.span_id, self.t0_ns,
         self.q_ns, self.c_ns, self.w_ns) = state


# chain-thread inheritance for elements that mint fresh buffers
# (converter, mux, aggregator, decoders): the last context seen on this
# thread re-attaches, exactly like utils.trace's birth inheritance
_tls = threading.local()


def ctx_of(buf) -> Optional[TraceContext]:
    return buf.extras.get(CTX_KEY)


def ensure_ctx(buf) -> Optional[TraceContext]:
    """The chain-path lookup: the buffer's own context, else the chain
    thread's inherited one (re-attached), else None."""
    ctx = buf.extras.get(CTX_KEY)
    if ctx is None:
        ctx = getattr(_tls, "ctx", None)
        if ctx is not None:
            buf.extras[CTX_KEY] = ctx
    else:
        _tls.ctx = ctx
    return ctx


def stamp(buf) -> TraceContext:
    """Source-side root: mint a fresh trace for this frame (the root
    span itself is recorded by the caller so children never dangle)."""
    ctx = TraceContext(next_id(), 0, time.time_ns())
    buf.extras[CTX_KEY] = ctx
    _tls.ctx = ctx
    return ctx


def attach(buf, ctx: TraceContext) -> None:
    buf.extras[CTX_KEY] = ctx


# -- wire encoding ------------------------------------------------------
# The DATA-meta trace field: [trace_id, span_id, t_send_ns, t0_ns,
# q_ns, c_ns, w_ns]. Only emitted on links that negotiated trace
# (wire.WireConfig.trace), so old peers see byte-identical traffic.

def to_wire(ctx: TraceContext) -> list:
    return [ctx.trace_id, ctx.span_id, time.time_ns(), ctx.t0_ns,
            ctx.q_ns, ctx.c_ns, ctx.w_ns]


def from_wire(field) -> Optional[tuple]:
    """-> (ctx_without_wire_span, t_send_ns) or None on a malformed
    field (a hostile/buggy peer must not take the pipeline down)."""
    try:
        tid, sid, t_send, t0, q, c, w = (int(x) for x in field)
    except (TypeError, ValueError):
        return None
    if tid == 0:
        return None
    return TraceContext(tid, sid, t0, q, c, w), t_send
