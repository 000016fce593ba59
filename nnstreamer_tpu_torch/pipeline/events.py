"""In-band pipeline events.

Downstream-serialized events modeled on GStreamer's: STREAM_START, CAPS,
SEGMENT, EOS, plus custom events (ref: GStreamer event model; the reference
relies on gst events for caps negotiation and EOS propagation, e.g.
gsttensor_trainer.c EOS handling).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..tensors.caps import Caps


class Event:
    """Base class for in-band events (flow downstream with buffers)."""

    __slots__ = ()


@dataclass
class StreamStart(Event):
    stream_id: str = "stream0"


@dataclass
class CapsEvent(Event):
    caps: Caps


@dataclass
class SegmentEvent(Event):
    """New segment: base running time in ns."""

    base_time: int = 0
    rate: float = 1.0


@dataclass
class EosEvent(Event):
    pass


@dataclass
class FlushEvent(Event):
    pass


@dataclass
class CustomEvent(Event):
    name: str
    data: Dict[str, Any] = field(default_factory=dict)


@dataclass
class QosEvent(Event):
    """Upstream QoS feedback (≙ GST_EVENT_QOS as consumed by the
    reference's tensor_filter throttling, tensor_filter.c:532-584).

    ``proportion`` > 1 means downstream is falling behind (it received
    frames faster than it can emit them); ``period_ns`` is the minimum
    inter-frame spacing downstream can sustain (the throttling delay).
    Travels upstream, out-of-band (not through queues).
    """

    proportion: float = 1.0
    period_ns: int = 0
    timestamp: Optional[int] = None


EOS = EosEvent
