"""Static caps/shape/dtype inference over a parsed, unstarted pipeline.

A copy of ``nnstreamer_tpu/analysis/infer.py``: the inference pass the
fusion planner reads (fusion/planner.py).

Walks the dataflow graph in topological order and propagates ``Caps``
through each element's declared :meth:`Element.static_transfer`. Typing
is gradual: an unknown (None) flows silently through downstream
elements, so only *provable* contradictions become findings — exactly
the failures runtime negotiation would hit mid-stream, reported here
with the element and pad before anything starts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..pipeline.element import Element, TransferError
from ..pipeline.pad import Pad
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from ..utils.log import logger
from .findings import Finding, Severity

RULE_CAPS = "caps-inference"


def config_of(caps: Optional[Caps]) -> Optional[TensorsConfig]:
    """Tensor config of known, fixed other/tensors caps; else None."""
    if caps is None or caps.any or not caps.structures:
        return None
    try:
        return caps.to_config() if caps.is_fixed() else None
    except ValueError:
        return None


@dataclass
class InferenceResult:
    pad_caps: Dict[Pad, Optional[Caps]] = field(default_factory=dict)
    findings: List[Finding] = field(default_factory=list)
    cyclic: Set[str] = field(default_factory=set)  # element names in cycles
    order: List[Element] = field(default_factory=list)

    def in_caps(self, elem: Element) -> Dict[str, Optional[Caps]]:
        """Per-sink-pad caps seen by *elem* (peer's inferred output)."""
        out: Dict[str, Optional[Caps]] = {}
        for pname, pad in elem.sink_pads.items():
            out[pname] = (self.pad_caps.get(pad.peer)
                          if pad.peer is not None else None)
        return out

    def out_caps(self, elem: Element) -> Dict[str, Optional[Caps]]:
        return {pname: self.pad_caps.get(pad)
                for pname, pad in elem.src_pads.items()}

    def in_config(self, elem: Element) -> Optional[TensorsConfig]:
        """Tensor config on a single-sink element's input, else None.
        Convenience shared by lint rules and the fusion planner."""
        caps = self.in_caps(elem)
        if len(caps) != 1:
            return None
        return config_of(next(iter(caps.values())))

    def out_config(self, elem: Element) -> Optional[TensorsConfig]:
        caps = self.out_caps(elem)
        if len(caps) != 1:
            return None
        return config_of(next(iter(caps.values())))


def element_transfer(
        elem: Element, in_caps: Dict[str, Optional[Caps]],
        findings: Optional[List[Finding]] = None,
) -> Dict[str, Optional[Caps]]:
    """Invoke *elem*'s declared :meth:`Element.static_transfer` under the
    shared error discipline. This is the single call site contract —
    pipelint propagation, the fusion rules, and the fusion planner all
    go through here, so each element declares its transfer exactly once
    and every consumer maps its failures the same way: TransferError /
    ValueError become findings (when a sink is passed), anything else is
    a lint bug and degrades to unknown."""
    try:
        return elem.static_transfer(in_caps) or {}
    except TransferError as exc:
        if findings is not None:
            findings.append(Finding(
                RULE_CAPS, Severity.ERROR, str(exc), elem.name, exc.pad))
        return {}
    except ValueError as exc:
        # the same error runtime negotiation would raise mid-stream
        if findings is not None:
            pad = (next(iter(elem.sink_pads))
                   if len(elem.sink_pads) == 1 else None)
            findings.append(Finding(
                RULE_CAPS, Severity.ERROR, str(exc), elem.name, pad))
        return {}
    except Exception:  # noqa: BLE001 -- never block launch on a lint bug
        logger.debug("pipelint: %s.static_transfer failed; treating "
                     "outputs as unknown", elem.name, exc_info=True)
        return {}


def _topo_order(elements: List[Element]):
    """Kahn's algorithm over pad links. Returns (order, cyclic_names):
    elements never reaching indegree 0 sit on (or downstream of) a
    cycle and are excluded from propagation."""
    indeg = {e.name: 0 for e in elements}
    for e in elements:
        for pad in e.sink_pads.values():
            if pad.peer is not None:
                indeg[e.name] += 1
    ready = [e for e in elements if indeg[e.name] == 0]
    order: List[Element] = []
    while ready:
        e = ready.pop(0)
        order.append(e)
        for pad in e.src_pads.values():
            if pad.peer is not None:
                down = pad.peer.element
                indeg[down.name] -= 1
                if indeg[down.name] == 0:
                    ready.append(down)
    done = {e.name for e in order}
    cyclic = {e.name for e in elements if e.name not in done}
    return order, cyclic


def infer_caps(pipeline) -> InferenceResult:
    """Run declared-transfer propagation over ``pipeline``'s graph."""
    elements = list(pipeline.elements.values())
    order, cyclic = _topo_order(elements)
    res = InferenceResult(cyclic=cyclic, order=order)
    for elem in order:
        out = element_transfer(elem, res.in_caps(elem), res.findings)
        for pname, pad in elem.src_pads.items():
            res.pad_caps[pad] = out.get(pname)
    return res
