"""Pipeline runtime: elements, pads, events, parser, container."""
from . import basic  # noqa: F401  (registers core elements)
from .element import (Element, NotPortedError, SinkElement, SrcElement,
                      TransformElement)
from .events import (CapsEvent, CustomEvent, EosEvent, Event, FlushEvent,
                     QosEvent, SegmentEvent, StreamStart)
from .pad import FlowError, Pad, PadDirection
from .parser import parse_launch
from .pipeline import Bus, Message, Pipeline
from .registry import element_names, make_element, register_element

__all__ = [
    "Element", "SrcElement", "SinkElement", "TransformElement",
    "NotPortedError", "Event", "CapsEvent", "EosEvent", "FlushEvent",
    "SegmentEvent", "StreamStart", "CustomEvent", "QosEvent", "Pad",
    "PadDirection", "FlowError", "parse_launch", "Pipeline", "Bus",
    "Message", "make_element", "register_element", "element_names",
]
