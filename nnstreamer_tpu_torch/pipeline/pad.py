"""Pads: the typed connection points between elements.

The dataflow analog of GstPad. Src pads push buffers/events to their linked
peer sink pad; caps are negotiated by intersecting pad templates at link
time and fixed by the CAPS event at stream start (ref: GStreamer pad
negotiation as used by the reference's elements).
"""
from __future__ import annotations

import enum
import threading
from typing import TYPE_CHECKING, Optional

from ..tensors.caps import Caps

if TYPE_CHECKING:  # pragma: no cover
    from .element import Element


class PadDirection(enum.Enum):
    SRC = "src"
    SINK = "sink"


class FlowError(RuntimeError):
    """Downstream returned a fatal flow error."""


class Pad:
    def __init__(self, element: "Element", name: str, direction: PadDirection,
                 template: Optional[Caps] = None):
        self.element = element
        self.name = name
        self.direction = direction
        self.template = template if template is not None else Caps.ANY()
        self.peer: Optional["Pad"] = None
        self.caps: Optional[Caps] = None  # negotiated, fixed caps
        self._lock = threading.Lock()

    # -- linking ----------------------------------------------------------
    def link(self, sinkpad: "Pad") -> None:
        if self.direction != PadDirection.SRC or sinkpad.direction != PadDirection.SINK:
            raise ValueError(
                f"can only link src->sink, got {self.direction}->{sinkpad.direction}")
        if self.peer is not None or sinkpad.peer is not None:
            raise ValueError(f"pad already linked: {self} or {sinkpad}")
        if not self.template.can_intersect(sinkpad.template):
            raise ValueError(
                f"incompatible pad templates linking {self} -> {sinkpad}: "
                f"{self.template} vs {sinkpad.template}")
        self.peer = sinkpad
        sinkpad.peer = self

    def unlink(self) -> None:
        if self.peer is not None:
            self.peer.peer = None
            self.peer = None

    @property
    def is_linked(self) -> bool:
        return self.peer is not None

    # -- dataflow ---------------------------------------------------------
    def push(self, item) -> None:
        """Push a Buffer or Event to the linked peer (src pads only)."""
        assert self.direction == PadDirection.SRC, "push on sink pad"
        peer = self.peer
        if peer is None:
            return  # unlinked src pad: drop (like gst's not-linked on leaf)
        peer.element.chain(peer, item)

    def set_caps(self, caps: Caps) -> None:
        if not caps.is_fixed():
            raise ValueError(f"pad caps must be fixed, got {caps}")
        if not self.template.can_intersect(caps):
            raise ValueError(
                f"caps {caps} not accepted by template {self.template} on {self}")
        self.caps = caps

    def __repr__(self) -> str:
        ename = getattr(self.element, "name", "?")
        return f"<Pad {ename}.{self.name} {self.direction.value}>"
