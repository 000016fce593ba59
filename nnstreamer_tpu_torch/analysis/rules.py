"""pipelint graph rules.

Port of ``nnstreamer_tpu/analysis/rules.py``: the rules whose elements
the port has (21 of the reference's 28). Each :class:`Rule` inspects the
parsed-but-unstarted pipeline plus the caps inference result and yields
findings with element/pad locations. Rules never execute elements and
never raise past :func:`analyze` — a broken rule must not block a
launch; :func:`analyze` lists the ids of rules that raised on the
report's ``crashed``.

The reference's other 7 rules inspect elements or options the port
does not have yet; each comes with the slice that ports them (ROADMAP.md,
queue A): ``sharding-divisibility``, ``serve-mesh-divisibility`` and
``mesh-colocation`` with the mesh (item 12),
``llm-prefix-cache-lossy-link`` with the llm filter's KV link (item 8),
``stateful-no-checkpoint`` and ``delta-lossy-gate-feeds-trainer`` with
the checkpoint hooks and the trainer (item 11; the latter's
``tensor_delta`` is ported, but it fires only on a ``tensor_trainer``),
and ``autoscaler-config`` with the fleet (item 13).
Rules keyed on kind names of such elements (``tensor_trainer``,
``mqttsrc``) keep those branches and stay silent until then.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Optional, Set

from ..pipeline.element import Element, SinkElement, SrcElement
from ..tensors.types import TensorFormat
from ..utils.log import logger
from .findings import Finding, Report, Severity
from .infer import InferenceResult, config_of, infer_caps


def kind_of(elem: Element) -> str:
    return getattr(type(elem), "ELEMENT_NAME", type(elem).__name__.lower())


@dataclass
class LintContext:
    pipeline: object
    inference: InferenceResult

    @property
    def elements(self) -> List[Element]:
        return list(self.pipeline.elements.values())

    def of_kind(self, *kinds: str) -> List[Element]:
        return [e for e in self.elements if kind_of(e) in kinds]

    def downstream(self, elem: Element) -> Iterable[Element]:
        for pad in elem.src_pads.values():
            if pad.peer is not None:
                yield pad.peer.element

    def upstream(self, elem: Element) -> Iterable[Element]:
        for pad in elem.sink_pads.values():
            if pad.peer is not None:
                yield pad.peer.element

    def sources_feeding(self, elem: Element) -> List[Element]:
        """Transitive upstream closure, returning the true sources."""
        seen: Set[str] = set()
        stack, out = [elem], []
        while stack:
            e = stack.pop()
            if e.name in seen:
                continue
            seen.add(e.name)
            ups = list(self.upstream(e))
            if not ups and e is not elem and not e.sink_pads:
                out.append(e)
            stack.extend(ups)
        return out


class Rule:
    """Base lint rule. ``id`` names the rule in findings; ``severity``
    is the default used by :meth:`finding`."""

    id = "rule"
    severity = Severity.WARNING

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, message: str, element: Optional[str] = None,
                pad: Optional[str] = None,
                severity: Optional[Severity] = None) -> Finding:
        return Finding(self.id,
                       self.severity if severity is None else severity,
                       message, element, pad)


class DanglingPadRule(Rule):
    """Static sink pads that were never linked: the element will wait
    forever for data (crop's ``info`` pad, a combiner leg, ...).
    Completely isolated elements are flagged too."""

    id = "dangling-pad"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        for e in ctx.elements:
            pads = list(e.sink_pads.values()) + list(e.src_pads.values())
            linked = [p for p in pads if p.is_linked]
            if pads and not linked:
                yield self.finding(
                    "element is not linked to anything", e.name)
                continue
            for pname, pad in e.sink_pads.items():
                if not pad.is_linked:
                    yield self.finding(
                        f"sink pad {pname!r} is never linked; the element "
                        f"waits on it forever", e.name, pname)


class CycleRule(Rule):
    """Cycles in the dataflow graph: buffers would chase their own tail
    and caps can never settle."""

    id = "cycle"
    severity = Severity.ERROR

    def check(self, ctx: LintContext):
        cyc = ctx.inference.cyclic
        if not cyc:
            return
        # restrict the blame to elements actually ON a cycle (Kahn also
        # strands everything downstream of one)
        by_name = {e.name: e for e in ctx.elements}
        on_cycle = sorted(n for n in cyc if self._reaches_self(
            by_name[n], by_name, cyc))
        for name in on_cycle:
            yield self.finding(
                f"element is part of a dataflow cycle "
                f"({' -> '.join(on_cycle)})", name)

    @staticmethod
    def _reaches_self(elem, by_name, cyc) -> bool:
        seen: Set[str] = set()
        stack = [p.peer.element for p in elem.src_pads.values()
                 if p.peer is not None]
        while stack:
            e = stack.pop()
            if e.name == elem.name:
                return True
            if e.name in seen or e.name not in cyc:
                continue
            seen.add(e.name)
            stack.extend(p.peer.element for p in e.src_pads.values()
                         if p.peer is not None)
        return False


class TeeNoQueueRule(Rule):
    """A tee branch that reaches a sink without a queue runs serialized
    with its sibling branches in one streaming thread — one slow/blocked
    branch stalls them all (deadlock-prone with combiners downstream)."""

    id = "tee-no-queue"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        from ..pipeline.basic import Queue
        for tee in ctx.of_kind("tee"):
            branches = [(n, p) for n, p in tee.src_pads.items()
                        if p.peer is not None]
            if len(branches) < 2:
                continue
            for pname, pad in branches:
                if self._lacks_queue(pad.peer.element, Queue):
                    yield self.finding(
                        f"branch {pname!r} reaches a sink without a "
                        f"queue; branches share one streaming thread",
                        tee.name, pname)

    @staticmethod
    def _lacks_queue(start: Element, queue_cls) -> bool:
        seen: Set[str] = set()
        stack = [start]
        while stack:
            e = stack.pop()
            if e.name in seen or isinstance(e, queue_cls):
                continue
            seen.add(e.name)
            if isinstance(e, SinkElement):
                return True
            stack.extend(p.peer.element for p in e.src_pads.values()
                         if p.peer is not None)
        return False


class JitSignatureRule(Rule):
    """A tensor_filter fed by a dynamic-shape (flexible) upstream gets
    one executable (on the card: one CUDA-graph capture) per distinct
    shape. Bucketed sources bound the
    signature count to len(buckets); anything else is unbounded."""

    id = "jit-signatures"
    severity = Severity.WARNING
    bucket_budget = 8

    def check(self, ctx: LintContext):
        for filt in ctx.of_kind("tensor_filter"):
            pad = filt.sink_pads.get("sink")
            if pad is None or pad.peer is None:
                continue
            caps = ctx.inference.pad_caps.get(pad.peer)
            cfg = config_of(caps)
            if cfg is None or cfg.format != TensorFormat.FLEXIBLE:
                continue  # static/unknown stream: nothing provable
            srcs = ctx.sources_feeding(filt)
            bounded = False
            for src in srcs:
                skind = kind_of(src)
                if skind == "tensor_serve_src":
                    buckets = [b for b in str(src.buckets).split(",") if b]
                    bounded = True
                    if len(buckets) > self.bucket_budget:
                        yield self.finding(
                            f"{len(buckets)} batch buckets exceed the "
                            f"jit-signature budget of {self.bucket_budget} "
                            f"(one compile each)", filt.name, "sink")
                elif skind == "tensor_query_serversrc" \
                        and int(getattr(src, "batch", 0)) > 0:
                    bounded = True  # padded micro-batches: fixed signature
            if not bounded:
                origin = ", ".join(sorted(kind_of(s) for s in srcs)) \
                    or "upstream"
                yield self.finding(
                    f"flexible-shape stream from {origin}: one jit "
                    f"compile per distinct shape (unbounded signature "
                    f"cardinality); bucket via tensor_serve_src or pin "
                    f"dims with a capsfilter", filt.name, "sink")


class SinklessBranchRule(Rule):
    """Data flowing into an element whose src pads go nowhere is
    silently dropped; a pipeline with no sink at all never reaches
    EOS."""

    id = "sinkless-branch"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        elems = ctx.elements
        if elems and not any(isinstance(e, SinkElement) for e in elems):
            yield self.finding(
                "pipeline has no sink element; wait_eos() would hang")
        for e in elems:
            if isinstance(e, SinkElement) or not e.src_pads:
                continue
            if any(p.is_linked for p in e.sink_pads.values()) \
                    and not any(p.is_linked for p in e.src_pads.values()):
                yield self.finding(
                    "branch dead-ends here: no src pad is linked, "
                    "buffers are dropped", e.name)


class CombinerDtypeRule(Rule):
    """tensor_merge concatenates its legs — mismatched dtypes would
    silently upcast (or fail) at runtime; join forwards the first leg's
    caps, so a differing leg violates them mid-stream."""

    id = "combiner-dtype"
    severity = Severity.ERROR

    def check(self, ctx: LintContext):
        from ..elements.combiner import pad_sort_key
        for comb in ctx.of_kind("tensor_merge", "join"):
            kind = kind_of(comb)
            legs = []
            for pname in sorted(comb.sink_pads, key=pad_sort_key):
                pad = comb.sink_pads[pname]
                if pad.peer is None:
                    continue
                cfg = config_of(ctx.inference.pad_caps.get(pad.peer))
                if cfg is not None and len(cfg.info):
                    legs.append((pname, cfg))
            if len(legs) < 2:
                continue
            ref_name, ref = legs[0]
            for pname, cfg in legs[1:]:
                dtypes = [i.type for i in cfg.info]
                ref_dtypes = [i.type for i in ref.info]
                if dtypes != ref_dtypes:
                    yield self.finding(
                        f"dtype {[str(t) for t in dtypes]} differs from "
                        f"{ref_name!r}'s {[str(t) for t in ref_dtypes]}; "
                        f"{kind} would silently widen or corrupt",
                        comb.name, pname)
                elif kind == "join" and not cfg.info.is_equal(ref.info):
                    yield self.finding(
                        f"shape differs from {ref_name!r} "
                        f"({cfg.info!r} vs {ref.info!r}); join forwards "
                        f"one caps for all legs", comb.name, pname)


class UnboundedAdmissionRule(Rule):
    """Serving entry points must bound admission: an unbounded queue
    turns an overloaded server into a memory leak with unbounded tail
    latency instead of shedding load."""

    id = "unbounded-admission"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        for e in ctx.of_kind("tensor_serve_src"):
            if int(e.max_queue) <= 0:
                yield self.finding(
                    f"max-queue={int(e.max_queue)} disables admission "
                    f"control (clamped to 1 silently); set a real bound",
                    e.name)
            if float(e.deadline_ms) < 0:
                yield self.finding(
                    "negative deadline-ms sheds every request", e.name)
        for e in ctx.of_kind("tensor_query_serversrc"):
            yield self.finding(
                "per-request path has no admission control or shedding; "
                "production traffic belongs on tensor_serve_src",
                e.name, severity=Severity.INFO)


class ShedNoRetryAfterRule(Rule):
    """A SHED reply without a positive retry-after hint gives clients
    nothing to pace themselves by: they hot-loop resubmitting into the
    very overload that shed them, or back off blind. Every element that
    mints SHEDs must carry a usable hint — backpressure is part of the
    settlement contract (RESULT xor SHED-with-retry-after)."""

    id = "shed-no-retry-after"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        for e in ctx.of_kind("tensor_serve_src", "tensor_serve_router"):
            if float(getattr(e, "retry_after_ms", 0.0)) <= 0:
                yield self.finding(
                    f"retry-after-ms={float(e.retry_after_ms):g} on a "
                    "shedding entry point: SHED replies carry no "
                    "backpressure hint, so shed clients resubmit "
                    "immediately into the same overload", e.name)
        for e in ctx.of_kind("tensor_filter"):
            if int(getattr(e, "breaker_threshold", 0)) > 0 and \
                    float(getattr(e, "breaker_retry_after_ms", 0.0)) <= 0:
                yield self.finding(
                    "breaker-retry-after-ms<=0 with the circuit breaker "
                    "armed: breaker-open sheds pace nothing upstream",
                    e.name)


class LinkResilienceRule(Rule):
    """Network-edge elements with no timeout or with reconnection
    disabled turn a transient peer outage into a permanent hang or a
    silent EOS."""

    id = "link-resilience"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        for e in ctx.of_kind("tensor_query_client", "edgesrc", "mqttsrc"):
            if float(getattr(e, "timeout", 0.0)) <= 0:
                yield self.finding(
                    "timeout<=0 on a network element: a dead peer hangs "
                    "the stream forever", e.name)
            if kind_of(e) in ("edgesrc", "mqttsrc") \
                    and not bool(getattr(e, "reconnect", True)):
                yield self.finding(
                    "reconnect=false: a dropped link ends the stream as "
                    "EOS instead of re-dialing with backoff", e.name,
                    severity=Severity.INFO)


class ErrorPolicyRule(Rule):
    """on-error specs are parsed lazily at the first fault — a typo'd
    spec or an impossible policy (restart of a stateful element) must
    surface at lint time, not mid-incident."""

    id = "error-policy"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        from ..fault.policy import ErrorPolicy
        for e in ctx.elements:
            spec = str(getattr(e, "on_error", "fail"))
            try:
                policy = ErrorPolicy.parse(spec)
            except ValueError as exc:
                yield self.finding(
                    f"unparseable on-error spec {spec!r}: {exc}",
                    e.name, severity=Severity.ERROR)
                continue
            if policy.action == "retry" and isinstance(e, SinkElement):
                yield self.finding(
                    "on-error=retry on a sink re-runs side effects "
                    "(duplicate renders/publishes); prefer skip or fail",
                    e.name)
            elif policy.action == "restart" \
                    and not getattr(type(e), "RESTART_SAFE", False):
                yield self.finding(
                    f"on-error=restart on {kind_of(e)}: element is not "
                    f"restart-safe (a restart discards internal state)",
                    e.name, severity=Severity.ERROR)


class WireConfigRule(Rule):
    """Wire-v2 link properties are negotiated strings: a typo'd codec
    silently degrades to raw (the peer clamps it), so it must surface at
    lint time; and a lossy on-wire downcast feeding a trainer corrupts
    gradients silently — the operator must opt in knowingly."""

    id = "wire-config"
    severity = Severity.ERROR

    def check(self, ctx: LintContext):
        from ..edge.wire import CODECS, PRECISIONS
        for e in ctx.of_kind("tensor_query_client", "edgesink"):
            codec = str(getattr(e, "wire_codec", "raw"))
            if codec not in CODECS:
                yield self.finding(
                    f"invalid wire-codec {codec!r}; valid: "
                    f"{', '.join(CODECS)}", e.name)
            precision = str(getattr(e, "wire_precision", "none"))
            if precision not in PRECISIONS:
                yield self.finding(
                    f"invalid wire-precision {precision!r}; valid: "
                    f"{', '.join(PRECISIONS)}", e.name)
            elif precision != "none" and kind_of(e) == "tensor_query_client":
                # lossy downcast + a trainer consuming the results =
                # silently degraded gradients; warn loudly
                seen: Set[str] = set()
                stack = list(ctx.downstream(e))
                while stack:
                    d = stack.pop()
                    if d.name in seen:
                        continue
                    seen.add(d.name)
                    if kind_of(d) == "tensor_trainer":
                        yield self.finding(
                            f"wire-precision={precision} is lossy and the "
                            f"results feed trainer '{d.name}': gradients "
                            f"see fp32-rounded activations",
                            e.name, severity=Severity.WARNING)
                        break
                    stack.extend(ctx.downstream(d))
        for e in ctx.of_kind("edgesink"):
            frames = int(getattr(e, "coalesce_frames", 1))
            if frames < 1:
                yield self.finding(
                    f"coalesce-frames={frames} is not a batch size; "
                    f"use 1 to disable coalescing", e.name)
            elif frames > 1 and float(getattr(e, "coalesce_ms", 0.0)) <= 0:
                yield self.finding(
                    "coalesce-frames>1 with coalesce-ms<=0: a partial "
                    "batch below the size threshold stalls until more "
                    "frames arrive (no age flush)", e.name,
                    severity=Severity.WARNING)


class FusionBreakRule(Rule):
    """A single non-fusible element sandwiched between two device-fusible
    neighbors splits what would otherwise be one FusedSegment into two
    (or none) — every split re-crosses the host/device boundary and adds
    a graph launch per frame."""

    id = "fusion-break"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        from ..fusion.planner import static_veto
        for e in ctx.elements:
            if isinstance(e, (SrcElement, SinkElement)):
                continue  # runs necessarily end at the graph edge
            reason = static_veto(e, ctx.inference)
            if reason is None:
                continue
            ups = [p.peer.element for p in e.sink_pads.values()
                   if p.peer is not None]
            downs = [p.peer.element for p in e.src_pads.values()
                     if p.peer is not None]
            if len(ups) != 1 or len(downs) != 1:
                continue
            up, down = ups[0], downs[0]
            if static_veto(up, ctx.inference) is not None \
                    or static_veto(down, ctx.inference) is not None:
                continue
            yield self.finding(
                f"breaks a device-fusible run between '{up.name}' and "
                f"'{down.name}' ({reason}); move it outside the run, or "
                f"accept per-element dispatch with fuse=false", e.name)


class FusionTransferRule(Rule):
    """An element that declares a device_fn promises the fusion planner
    that its *static* caps transfer matches what the chain path
    negotiates at runtime (``transform_caps``). If they disagree, a
    fused segment advertises caps the unfused pipeline never produces —
    a guaranteed parity break, so this is an error."""

    id = "fusion-transfer"
    severity = Severity.ERROR

    def check(self, ctx: LintContext):
        from .infer import element_transfer
        for e in ctx.elements:
            if type(e).device_fn is Element.device_fn:
                continue  # no device_fn declared: nothing promised
            if type(e).transform_caps is Element.transform_caps:
                continue  # runtime path negotiates elsewhere; not comparable
            in_caps = ctx.inference.in_caps(e)
            known = {p: c for p, c in in_caps.items()
                     if c is not None and c.is_fixed()}
            if len(known) != 1:
                continue  # gradual typing: only fire on fully-known caps
            incaps = next(iter(known.values()))
            try:
                runtime = e.transform_caps(incaps)
            except Exception:  # noqa: BLE001 -- transfer rule, not crash rule
                continue
            declared = element_transfer(e, in_caps)
            for pname, dcaps in declared.items():
                if dcaps is None or runtime is None:
                    continue
                if dcaps != runtime:
                    yield self.finding(
                        f"device_fn is declared but static transfer "
                        f"({dcaps}) disagrees with the chain path's "
                        f"transform_caps ({runtime}); a fused segment "
                        f"would break byte parity", e.name, pname)


class SessionReplayBudgetRule(Rule):
    """An edgesink replay ring smaller than ONE coalesced batch cannot
    replay even the minimal unit of loss: the very first reconnect gap
    is guaranteed to contain declared-lost frames. That configuration
    can never deliver the zero-loss promise session=true makes, so it
    is an error, not a tuning warning."""

    id = "session-replay-budget"
    severity = Severity.ERROR

    def check(self, ctx: LintContext):
        for e in ctx.of_kind("edgesink"):
            if not bool(getattr(e, "session", False)):
                continue
            ring_bytes = int(getattr(e, "session_ring_kb", 0)) * 1024
            frames = max(1, int(getattr(e, "coalesce_frames", 1)))
            pad = e.sink_pads.get("sink")
            if pad is None or pad.peer is None:
                continue
            cfg = config_of(ctx.inference.pad_caps.get(pad.peer))
            if cfg is None or cfg.format != TensorFormat.STATIC \
                    or not len(cfg.info):
                continue  # gradual typing: only fire on provable frames
            # element_size, not the numpy itemsize: bfloat16 has no
            # numpy dtype in the port
            frame_bytes = sum(math.prod(i.shape) * i.type.element_size
                              for i in cfg.info)
            batch_bytes = frames * frame_bytes
            if frame_bytes > 0 and ring_bytes < batch_bytes:
                yield self.finding(
                    f"session replay ring ({ring_bytes} B) is smaller than "
                    f"one coalesced batch ({frames} frame(s) x "
                    f"{frame_bytes} B = {batch_bytes} B): the first "
                    f"reconnect gap is GUARANTEED to declare lost frames; "
                    f"raise session-ring-kb or lower coalesce-frames",
                    e.name, "sink")


class SessionNoReconnectRule(Rule):
    """session=true buys replay-on-RESUME — but RESUME only happens on a
    re-dial. With reconnect=false a dropped link just ends the stream as
    EOS and the session's replay ring never gets asked, so the operator
    is paying for acks with no delivery guarantee in return."""

    id = "session-no-reconnect"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        for e in ctx.of_kind("edgesrc"):
            if bool(getattr(e, "session", False)) \
                    and not bool(getattr(e, "reconnect", True)):
                yield self.finding(
                    "session=true with reconnect=false: a dropped link "
                    "ends the stream before any RESUME can replay the "
                    "gap — the session guarantees nothing; enable "
                    "reconnect or drop the session overhead", e.name)


class RouterNoReplicasRule(Rule):
    """A fleet router with neither a static replica list nor a broker
    topic can never route anything: every request it accepts sheds.
    That is a dead configuration, not a tuning choice — an error before
    launch."""

    id = "router-no-replicas"
    severity = Severity.ERROR

    def check(self, ctx: LintContext):
        for e in ctx.of_kind("tensor_serve_router"):
            replicas = str(getattr(e, "replicas", "") or "").strip()
            topic = str(getattr(e, "topic", "") or "").strip()
            if not replicas and not topic:
                yield self.finding(
                    "router has zero replica endpoints and no broker "
                    "topic: every request will be shed; set replicas= "
                    "(host:port,...) or topic= + dest-port= for broker "
                    "discovery", e.name)


class RouterAffinitySessionlessRule(Rule):
    """affinity=true keys dispatch on per-client session identity — but
    session=false disables minting those keys, so every frame silently
    degrades to least-loaded placement and the operator's affinity
    expectation (stream order, warm per-replica state) is not actually
    being honored."""

    id = "router-affinity-sessionless"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        for e in ctx.of_kind("tensor_serve_router"):
            if bool(getattr(e, "affinity", True)) \
                    and not bool(getattr(e, "session", True)):
                yield self.finding(
                    "affinity=true with session=false: no session keys "
                    "are minted, so dispatch silently degrades to "
                    "least-loaded and sessions do NOT stick to a "
                    "replica; enable session or set affinity=false",
                    e.name)


class AsyncWindowRule(Rule):
    """In-flight window sanity for tensor_filter's overlapped executor.

    ERROR on ``in-flight < 1`` (a zero/negative window can never admit
    a frame: the dispatcher blocks forever on the first buffer) and on
    a window wider than the serve batcher's jit-signature budget when
    fed by a bucketed tensor_serve_src — up to K distinct bucket
    signatures can then be in flight at once, each holding a compiled
    executable, which blows the same budget JitSignatureRule enforces
    for compiles. WARN when ``in-flight > 1`` feeds an order-sensitive
    element (aggregator stacking windows, trainer consuming a sample
    stream, rate pacing on PTS) with the reorder buffer disabled —
    completions may then overtake each other on error gaps and the
    downstream element silently mis-groups frames.
    """

    id = "async-window"
    severity = Severity.ERROR
    _ORDER_SENSITIVE = ("tensor_aggregator", "tensor_trainer",
                        "tensor_rate")

    def check(self, ctx: LintContext):
        budget = JitSignatureRule.bucket_budget
        for filt in ctx.of_kind("tensor_filter"):
            try:
                k = int(getattr(filt, "in_flight", 1))
            except (TypeError, ValueError):
                yield self.finding(
                    f"in-flight={getattr(filt, 'in_flight', None)!r} is "
                    f"not an integer", filt.name)
                continue
            if k < 1:
                yield self.finding(
                    f"in-flight={k}: the window can never admit a frame "
                    f"(dispatch blocks forever); use 1 for synchronous "
                    f"operation", filt.name)
                continue
            if k > budget and any(
                    kind_of(s) == "tensor_serve_src"
                    and len([b for b in str(s.buckets).split(",") if b]) > 1
                    for s in ctx.sources_feeding(filt)):
                yield self.finding(
                    f"in-flight={k} behind a bucketed tensor_serve_src: "
                    f"up to {k} distinct bucket signatures can be in "
                    f"flight at once, exceeding the jit-signature budget "
                    f"of {budget} live executables; shrink the window or "
                    f"the bucket list", filt.name)
            if k > 1 and not bool(getattr(filt, "reorder", True)):
                hit = self._order_sensitive_downstream(ctx, filt)
                if hit is not None:
                    yield self.finding(
                        f"in-flight={k} with reorder=false feeds "
                        f"order-sensitive {kind_of(hit)} '{hit.name}': "
                        f"completions can arrive out of PTS order; "
                        f"enable reorder or set in-flight=1",
                        filt.name, severity=Severity.WARNING)

    def _order_sensitive_downstream(self, ctx: LintContext, elem):
        seen, stack = set(), list(ctx.downstream(elem))
        while stack:
            e = stack.pop()
            if e.name in seen:
                continue
            seen.add(e.name)
            if kind_of(e) in self._ORDER_SENSITIVE:
                return e
            stack.extend(ctx.downstream(e))
        return None


class TraceExportRule(Rule):
    """A source with ``trace-export=true`` promises frame-level trace
    continuity — but the trace context rides in buffer extras, and an
    element that mints fresh output buffers (``STRIPS_META``) drops it.
    Downstream spans then fall back to same-thread inheritance (fine
    inside one streaming thread) and the WIRE loses the context
    entirely: the remote half of the span tree detaches. WARN naming
    the first stripping element on each path."""

    id = "trace-export-stripped"
    severity = Severity.WARNING

    def check(self, ctx: LintContext):
        for src in ctx.elements:
            if not isinstance(src, SrcElement) \
                    or not bool(getattr(src, "trace_export", False)):
                continue
            seen: Set[str] = set()
            stack = list(ctx.downstream(src))
            while stack:
                e = stack.pop()
                if e.name in seen:
                    continue
                seen.add(e.name)
                if getattr(type(e), "STRIPS_META", False):
                    yield self.finding(
                        f"source '{src.name}' exports trace context but "
                        f"{kind_of(e)} '{e.name}' mints fresh buffers "
                        f"(STRIPS_META): frame spans past it lose their "
                        f"trace ids on wire hops; move the element "
                        f"upstream of the source stamp or accept "
                        f"same-thread-only spans", e.name)
                    continue  # report the FIRST stripper per path
                stack.extend(ctx.downstream(e))


class DeltaNoKeyframeIntervalRule(Rule):
    """Delta wire codec with no finite keyframe interval: the link's
    only scheduled resynchronization points are gone. A subscriber that
    joins late, or whose reference drifts for any unforeseen reason,
    then has no bounded-time path back to a self-contained frame: the
    stream degrades into diffs against state only the sender has."""

    id = "delta-no-keyframe-interval"
    severity = Severity.ERROR

    def check(self, ctx: LintContext):
        from ..edge.wire import CODEC_DELTA
        for e in ctx.of_kind("edgesink"):
            if str(getattr(e, "wire_codec", "raw")) != CODEC_DELTA:
                continue
            k = int(getattr(e, "wire_delta_k", 0))
            if k <= 0:
                yield self.finding(
                    f"wire-codec=delta with wire-delta-k={k}: no finite "
                    "keyframe interval — only connect/layout-change/"
                    "promotion keyframes remain, so a reference that "
                    "drifts has no bounded-time resync; set "
                    "wire-delta-k to a positive frame count", e.name)


class LlmDecodeNoKvBudgetRule(Rule):
    """A paged llm filter (``paged:true``, or a decode role, which the
    port refuses at open until the KV link comes) without an explicit
    ``pool_blocks`` budget sizes its KV pool from n_parallel x max_len —
    the contiguous worst case — so admission is not token-budgeted."""

    id = "llm-decode-no-kv-budget"
    severity = Severity.ERROR

    def check(self, ctx: LintContext):
        from ..filters.base import parse_custom_properties
        for filt in ctx.of_kind("tensor_filter"):
            opts = parse_custom_properties(str(filt.custom or ""))
            paged = (opts.get("role") == "decode"
                     or opts.get("paged", "").lower()
                     in ("1", "true", "yes", "on"))
            if not paged or "pool_blocks" in opts:
                continue
            yield self.finding(
                "paged llm decode without custom=pool_blocks:N — the "
                "KV pool silently defaults to the contiguous worst "
                "case (n_parallel x max_len tokens), so decode "
                "occupancy is not actually token-budgeted; size the "
                "pool explicitly", filt.name, "sink")


ALL_RULES: List[Rule] = [
    DanglingPadRule(), CycleRule(), TeeNoQueueRule(), JitSignatureRule(),
    SinklessBranchRule(), CombinerDtypeRule(), UnboundedAdmissionRule(),
    ShedNoRetryAfterRule(), LinkResilienceRule(), ErrorPolicyRule(),
    WireConfigRule(), FusionBreakRule(), FusionTransferRule(),
    SessionReplayBudgetRule(), SessionNoReconnectRule(),
    RouterNoReplicasRule(), RouterAffinitySessionlessRule(),
    AsyncWindowRule(), TraceExportRule(), DeltaNoKeyframeIntervalRule(),
    LlmDecodeNoKvBudgetRule(),
]

def analyze(pipeline, rules: Optional[List[Rule]] = None) -> Report:
    """Run caps inference + every rule over ``pipeline``; returns the
    aggregated :class:`Report`. Never starts an element. A rule that
    raises is logged and skipped, and its id lands on ``crashed``."""
    inference = infer_caps(pipeline)
    report = Report(findings=list(inference.findings),
                    num_elements=len(pipeline.elements))
    ctx = LintContext(pipeline, inference)
    for rule in (ALL_RULES if rules is None else rules):
        try:
            report.findings.extend(rule.check(ctx))
        except Exception:  # noqa: BLE001 -- a broken rule must not block launch
            logger.warning("pipelint: rule %s crashed; skipped",
                           rule.id, exc_info=True)
            report.crashed.append(rule.id)
    return report
