"""Fusion planner: mark maximal device-capable runs and rewire them.

A copy of ``nnstreamer_tpu/fusion/planner.py`` with its vetoes, so that
both packages choose the same segments for the same launch line.

Two layers of fusibility, mirroring pipelint's never-start discipline:

* :func:`static_veto` — purely static, safe for lint rules: pad
  topology, thread boundaries, the element's own
  :meth:`Element.device_veto` declaration, and caps knowable from the
  shared inference pass. Never opens a model or touches a device.
* plan time (:func:`plan_fusion`) — runs inside ``Pipeline.start()``
  after validation, so it MAY open resources: each candidate member's
  :meth:`Element.device_fn` is invoked with the planned input config
  and may still decline (return None) for config-specific reasons
  (e.g. a dtype whose host/device promotion rules diverge, which would
  break the byte-parity oracle). A member declining ends the run at
  that point; upstream members ≥ ``min_run`` still fuse.

Segment boundaries (kept on :attr:`FusionPlan.vetoes` for
observability): sources, sinks, queues (deliberate thread boundaries),
multi-pad fan-in/out (mux/demux/tee/crop), edge/query links, stateful
elements (aggregator/trainer — no ``device_fn``), unknown or non-STATIC
caps, 64-bit dtypes (the reference's x64 is off: the port could compute
in float64, but it keeps the JAX planner's choice), a change of ``on-error``
policy mid-run (a segment applies ONE policy; splitting keeps each
member under the policy its author chose), and a change of ``mesh:``
spec mid-run (one fused program compiles for one mesh — uniform
members stay mesh-resident across member boundaries instead).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..analysis.infer import (InferenceResult, config_of, element_transfer,
                              infer_caps)
from ..pipeline.element import Element, SinkElement, SrcElement
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from ..tensors.types import TensorFormat, TensorType
from ..utils.log import logger
from .segment import FusedSegment

# fusing a single element buys nothing (same one-in/one-out transfer
# the chain path already does) but costs a retrace; runs must be >= 2
DEFAULT_MIN_RUN = 2

# the JAX package runs with x64 disabled, so its planner vetoes 64-bit
# streams; the port keeps the veto so both packages plan the same segments
_WIDE_TYPES = {TensorType.FLOAT64, TensorType.INT64, TensorType.UINT64}


def _kind(elem: Element) -> str:
    return getattr(type(elem), "ELEMENT_NAME", type(elem).__name__.lower())


@dataclass
class FusionCtx:
    """Plan-time context handed to :meth:`Element.device_fn`: the
    statically planned caps/config on the member's (single) input."""

    element: Element
    in_caps: Optional[Caps] = None
    in_config: Optional[TensorsConfig] = None


@dataclass
class PlannedSegment:
    members: List[Element]
    fns: List[Callable]
    ctxs: List[FusionCtx]
    in_caps: Optional[Caps] = None

    @property
    def names(self) -> List[str]:
        return [m.name for m in self.members]


@dataclass
class FusionPlan:
    segments: List[PlannedSegment] = field(default_factory=list)
    # element name -> why it did not fuse (lint/trace observability)
    vetoes: Dict[str, str] = field(default_factory=dict)

    def summary(self) -> Dict[str, object]:
        return {
            "segments": [s.names for s in self.segments],
            "vetoes": dict(self.vetoes),
        }


def static_veto(elem: Element,
                inference: Optional[InferenceResult] = None) -> Optional[str]:
    """Reason *elem* can never join a fused run, or None when it is a
    static fusion candidate. Pipelint-safe: never opens anything."""
    if isinstance(elem, SrcElement):
        return "source element (owns the streaming thread)"
    if isinstance(elem, SinkElement):
        return "sink element (host boundary)"
    kind = _kind(elem)
    if kind == "queue":
        return "thread boundary (queue)"
    sink_linked = [p for p in elem.sink_pads.values() if p.is_linked]
    src_linked = [p for p in elem.src_pads.values() if p.is_linked]
    if len(sink_linked) != 1 or len(src_linked) != 1:
        return (f"not a linear 1-in/1-out element "
                f"({len(sink_linked)} sink / {len(src_linked)} src links)")
    veto = elem.device_veto()
    if veto:
        return veto
    if inference is not None:
        in_caps = inference.in_caps(elem)
        caps = next(iter(in_caps.values())) if len(in_caps) == 1 else None
        if caps is not None:
            v = _caps_veto(caps)
            if v:
                return v
    return None


def _caps_veto(caps: Optional[Caps]) -> Optional[str]:
    """Why *caps* cannot feed a fused member, or None when they can."""
    cfg = config_of(caps)
    if cfg is None:
        return "input caps unknown or not fixed (dynamic-caps boundary)"
    if cfg.format != TensorFormat.STATIC or not len(cfg.info):
        return f"non-static stream format ({cfg.format})"
    for i in range(len(cfg.info)):
        if cfg.info[i].type in _WIDE_TYPES:
            return (f"64-bit tensor dtype {cfg.info[i].type} "
                    f"(the reference plans with x64 disabled)")
    return None


def _plan_out_caps(elem: Element, in_caps: Caps) -> Optional[Caps]:
    """Output caps of *elem* under the planned input. The declared
    static transfer is authoritative (declared once, in infer.py's
    shared discipline); when it answers unknown — a tensor_filter with
    no declared output props — fall back to the element's plan-time
    refinement, which may open the model (we run after validation,
    before start, so that is allowed here and only here)."""
    pname = next(iter(elem.sink_pads))
    out = element_transfer(elem, {pname: in_caps})
    caps = next(iter(out.values())) if len(out) == 1 else None
    if caps is not None:
        return caps
    plan = getattr(elem, "plan_out_caps", None)
    if plan is None:
        return None
    try:
        return plan(in_caps)
    except Exception:  # noqa: BLE001 -- a refusal, not a planner error
        logger.debug("fusion: %s.plan_out_caps failed", elem.name,
                     exc_info=True)
        return None


def _policy_of(elem: Element) -> str:
    return str(getattr(elem, "on_error", "fail"))


def _mesh_of(elem: Element) -> str:
    """The member's declared ``mesh:`` spec ("" = unsharded). A fused
    program runs under ONE placement: every member must agree, so a
    spec change breaks the run."""
    get = getattr(elem, "mesh_spec", None)
    return str(get()) if callable(get) else ""


def _linked_sink(elem: Element):
    """The element's sole linked sink pad (candidates have exactly one,
    which need not be the FIRST declared pad)."""
    return next(p for p in elem.sink_pads.values() if p.is_linked)


def _linked_src(elem: Element):
    return next(p for p in elem.src_pads.values() if p.is_linked)


def plan_fusion(pipeline, inference: Optional[InferenceResult] = None,
                min_run: int = DEFAULT_MIN_RUN) -> FusionPlan:
    """Walk the graph and build the fusion plan. May open member
    models/subplugins (via ``device_fn``); mutates nothing."""
    inference = inference if inference is not None else infer_caps(pipeline)
    plan = FusionPlan()
    candidates: Dict[str, Element] = {}
    for elem in pipeline.elements.values():
        v = static_veto(elem, inference)
        if v is None:
            candidates[elem.name] = elem
        else:
            plan.vetoes[elem.name] = v

    def extends(prev: Element, elem: Element) -> bool:
        """True when *elem* continues *prev*'s run (same predicate for
        head detection and forward extension, so runs are maximal)."""
        if elem.name not in candidates or prev.name not in candidates:
            return False
        if _linked_src(prev).peer.element is not elem:
            return False
        if _policy_of(prev) != _policy_of(elem):
            plan.vetoes.setdefault(
                elem.name, f"on-error policy changes mid-run "
                           f"({_policy_of(prev)!r} -> {_policy_of(elem)!r})")
            return False
        if _mesh_of(prev) != _mesh_of(elem):
            plan.vetoes.setdefault(
                elem.name, f"mesh spec changes mid-run "
                           f"({_mesh_of(prev)!r} -> {_mesh_of(elem)!r}); "
                           f"one fused program runs on one mesh")
            return False
        return True

    visited: set = set()
    for head in inference.order:
        if head.name not in candidates or head.name in visited:
            continue
        up = _linked_sink(head).peer.element
        if extends(up, head):
            continue  # not a run head; reached from `up`'s walk
        # walk forward, propagating caps and binding device programs
        in_caps = inference.in_caps(head)
        cur_caps = next(iter(in_caps.values())) if len(in_caps) == 1 else None
        members: List[Element] = []
        fns: List[Callable] = []
        ctxs: List[FusionCtx] = []
        elem: Optional[Element] = head
        while elem is not None:
            visited.add(elem.name)
            v = _caps_veto(cur_caps)
            if v:
                plan.vetoes.setdefault(elem.name, v)
                break
            ctx = FusionCtx(elem, cur_caps, config_of(cur_caps))
            try:
                fn = elem.device_fn(ctx)
            except Exception:  # noqa: BLE001 -- decline, don't block launch
                logger.warning("fusion: %s.device_fn raised; leaving it "
                               "on the chain path", elem.name, exc_info=True)
                fn = None
            if fn is None:
                plan.vetoes.setdefault(
                    elem.name, "device_fn declined at plan time")
                break
            out_caps = _plan_out_caps(elem, cur_caps)
            if out_caps is None:
                plan.vetoes.setdefault(
                    elem.name, "output caps not plannable")
                break
            members.append(elem)
            fns.append(fn)
            ctxs.append(ctx)
            cur_caps = out_caps
            nxt = _linked_src(elem).peer.element
            elem = nxt if extends(members[-1], nxt) else None
        if len(members) >= max(2, min_run):
            plan.segments.append(PlannedSegment(
                members, fns, ctxs, in_caps=ctxs[0].in_caps))
        elif members:
            plan.vetoes.setdefault(
                members[0].name,
                "run of 1 (nothing adjacent to fuse with)")
    return plan


def apply_fusion(pipeline, plan: FusionPlan) -> List[FusedSegment]:
    """Rewire each planned run behind a :class:`FusedSegment`.

    Members stay in ``pipeline.elements`` (stats, name lookup, stop()
    all keep working) but their external links move to the segment:
    upstream src pad -> segment sink pad, segment src pad -> downstream
    sink pad. Member-to-member links are left intact — the segment
    replays caps negotiation through them (fusion/segment.py), and the
    tail's now-unlinked src pad drops the cascade at the boundary."""
    segments: List[FusedSegment] = []
    for planned in plan.segments:
        head, tail = planned.members[0], planned.members[-1]
        seg = FusedSegment(planned.members, planned.fns,
                           name=f"fused_{head.name}")
        head_sink, tail_src = _linked_sink(head), _linked_src(tail)
        up_src = head_sink.peer          # upstream element's src pad
        down_sink = tail_src.peer        # downstream element's sink pad
        up_src.unlink()
        tail_src.unlink()
        up_src.link(seg.sinkpad)
        seg.srcpad.link(down_sink)
        pipeline.add(seg)
        segments.append(seg)
    return segments


def fuse_pipeline(pipeline, inference: Optional[InferenceResult] = None,
                  min_run: int = DEFAULT_MIN_RUN) -> FusionPlan:
    """Plan and apply fusion over *pipeline*; returns the plan (also
    stored on ``pipeline._fusion_plan`` by Pipeline.start)."""
    plan = plan_fusion(pipeline, inference, min_run)
    apply_fusion(pipeline, plan)
    if plan.segments:
        logger.info("fusion: %d segment(s): %s",
                    len(plan.segments),
                    "; ".join(" ! ".join(s.names) for s in plan.segments))
    return plan
