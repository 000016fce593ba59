"""Structured runtime events: one emit API for every "something
operationally notable happened" site.

A copy of ``nnstreamer_tpu/obs/events.py``: ``emit`` appends the event
to the flight-recorder ring, writes the log line the call sites used to
hand-roll and, when asked, posts the bus message, so the recorder, the
log and the bus cannot drift apart.

Kinds in use: ``breaker`` (open/close flips), ``shed`` (admission,
deadline, invoke and no-replica drops), ``failover`` (a fleet router's
replica death), ``drain``, ``preempt``, ``resume`` (session RESUME
replay), ``abort``.
"""
from __future__ import annotations

import logging
from typing import Any, Optional

from ..utils.log import logger
from .recorder import RECORDER


def emit(kind: str, source: str = "", *, element: Optional[Any] = None,
         level: int = logging.WARNING, message: Optional[str] = None,
         bus: Optional[str] = None, **fields) -> None:
    """Record a structured event.

    ``source`` names the emitter (element/component); ``message`` is
    the human log line (skipped when None — some sites keep their own
    richer logging); ``bus`` posts a pipeline bus message of that kind
    via ``element`` (which must then be a live pipeline element).
    """
    if element is not None and not source:
        source = getattr(element, "name", "") or ""
    RECORDER.add_event(kind, source, fields)
    if message is not None:
        logger.log(level, "%s: %s", source or kind, message)
    if bus is not None and element is not None:
        pipeline = getattr(element, "pipeline", None)
        if pipeline is not None:
            pipeline.post_message(bus, source=source, **fields)
