"""The acquire/settle registry: what flowcheck knows to conserve.

A copy of ``nnstreamer_tpu/analysis/flow/registry.py``, which is
framework neutral (the port imports nothing of the JAX package). The
static pass (:mod:`.model`, :mod:`.passes`) matches call sites against
these specs, and :mod:`.runtime`'s :func:`~.runtime.check_identities`,
which the autoscaler, the router and the serve elements' settlement
checks assert over live ``Counters`` snapshots, evaluates the
identities.

Two kinds of declarations live here:

* :class:`ResourceSpec` — a paired acquire/settle protocol (window
  slots, KV blocks, sockets...). Call sites are matched by method name
  *and* a receiver regex (``self.window.acquire`` is a slot acquire;
  ``self._lock.acquire`` is not). ``@flow.acquires/@flow.settles``
  decorations found during the scan union extra method names into the
  matching spec, so new code self-registers without editing this file.

* :class:`Identity` — a module's declared conservation identity over
  its ``Counters`` (e.g. the serve identity
  ``requests == completed + shed_deadline + cancelled + shed_failed +
  pending``). Each term names the port file that produces it. The
  static pass proves every non-derived term is actually *produced*
  (``inc``/``add``) in its declaring file; the runtime validator
  (:mod:`.runtime`) asserts the arithmetic over live snapshots.

Fixture modules can declare their own identity with a module-level
string constant ``FLOW_IDENTITY = "lhs == a + b"`` — every name is then
required to be produced in that same module.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ResourceSpec:
    name: str
    # method names whose calls mint a token (one per call)
    acquire_attrs: frozenset
    # method names whose calls settle a token
    settle_attrs: frozenset
    # settle names that DISCARD the payload: the calling path must also
    # increment one of loss_counters, else missing-declared-loss
    loss_settle_attrs: frozenset = frozenset()
    loss_counters: frozenset = frozenset()
    # regex over the dotted receiver ("self.window", "pool") gating
    # which call sites belong to this spec
    receiver_re: str = r".*"
    doc: str = ""

    def matches_receiver(self, receiver: str) -> bool:
        return re.search(self.receiver_re, receiver) is not None


SPECS: Tuple[ResourceSpec, ...] = (
    ResourceSpec(
        name="window-slot",
        acquire_attrs=frozenset({"acquire"}),
        settle_attrs=frozenset({"release"}),
        receiver_re=r"(^|\.)_?window$",
        doc="InFlightWindow slot: acquire() at dispatch must reach "
            "release() on every completion path (including completer "
            "exceptions), or the window permanently loses depth."),
    ResourceSpec(
        name="kv-block",
        acquire_attrs=frozenset({"alloc", "lookup", "cow"}),
        settle_attrs=frozenset({"release", "free"}),
        receiver_re=r"(^|\.)_?(mgr|pool_mgr|kvpool|blockpool)$",
        doc="KVBlockPool blocks: alloc/lookup/cow take a reference "
            "that must be released, seated into a lane (escape), or "
            "given back on the admission error path."),
    ResourceSpec(
        name="socket",
        acquire_attrs=frozenset({"accept"}),
        settle_attrs=frozenset({"close", "sever_socket"}),
        receiver_re=r"(^|\.)_?(srv|server|sock|listener)$",
        doc="Accepted connections: every accept() must reach close()/"
            "sever_socket() or be handed to an owning reader thread."),
    ResourceSpec(
        name="ring-slot",
        acquire_attrs=frozenset(),
        settle_attrs=frozenset({"release"}),
        loss_settle_attrs=frozenset({"evict", "drop_frames"}),
        loss_counters=frozenset({"declared_lost", "session_declared_lost",
                                 "dropped", "shed", "frames_dropped"}),
        receiver_re=r"(^|\.)_?ring$",
        doc="ReplayRing retention: an eviction that discards frames is "
            "a DECLARED loss — the evicting path must increment a loss "
            "counter so `sent == delivered + declared_lost` can hold."),
)


@dataclass(frozen=True)
class IdentityTerm:
    name: str                      # key in a runtime snapshot
    counter: Optional[str] = None  # Counters key produced statically
    file: Optional[str] = None     # file suffix that must produce it
    # derived terms (counter None) are computed at snapshot time
    # (e.g. pending = batcher depth) and skipped by the static pass


@dataclass(frozen=True)
class Identity:
    name: str
    lhs: IdentityTerm
    rhs: Tuple[IdentityTerm, ...]
    doc: str = ""
    line: int = 1                  # pin for module-declared identities

    @property
    def expression(self) -> str:
        return (f"{self.lhs.name} == "
                + " + ".join(t.name for t in self.rhs))

    def terms(self) -> Tuple[IdentityTerm, ...]:
        return (self.lhs,) + tuple(self.rhs)


def _t(name: str, file: Optional[str] = None,
       counter: Optional[str] = None) -> IdentityTerm:
    return IdentityTerm(name=name, counter=(counter or name) if file
                        else None, file=file)


DECLARED_IDENTITIES: Tuple[Identity, ...] = (
    Identity(
        name="serve-settlement",
        lhs=_t("requests", "serve/batcher.py", "submitted"),
        rhs=(_t("completed", "serve/scheduler.py"),
             _t("shed_deadline", "serve/batcher.py"),
             _t("cancelled", "serve/batcher.py"),
             _t("shed_failed", "serve/scheduler.py"),
             _t("pending")),
        doc="Every admitted request settles exactly once: demuxed "
            "result, deadline shed, cancellation, invoke-failure shed, "
            "or still pending in the batcher."),
    Identity(
        name="roi-settlement",
        lhs=_t("serve_roi_requests", "serve/elements.py"),
        rhs=(_t("serve_roi_results", "serve/elements.py"),
             _t("serve_roi_shed", "serve/elements.py"),
             _t("serve_roi_pending")),
        doc="One RESULT xor one SHED answers every ROI-gated frame; "
            "a shed frame's sibling crops are cancelled, never "
            "half-stitched."),
    Identity(
        name="session-delivery",
        lhs=_t("session_sent", "elements/edge.py"),
        rhs=(_t("session_delivered", "elements/edge.py"),
             _t("session_declared_lost", "elements/edge.py")),
        doc="Zero-loss session accounting: every sent frame is either "
            "delivered (post-dedup) or explicitly declared lost at "
            "RESUME — never silently dropped."),
    Identity(
        name="router-settlement",
        lhs=_t("router_requests", "serve/router.py"),
        rhs=(_t("router_delivered", "serve/router.py"),
             _t("router_shed", "serve/router.py"),
             _t("router_orphaned", "serve/router.py")),
        doc="Fleet router conservation: every accepted request is "
            "delivered, shed with retry-after, or declared orphaned "
            "after replica death."),
    Identity(
        name="fleet-replica-lifecycle",
        lhs=_t("replicas_spawned", "fleet/autoscaler.py"),
        rhs=(_t("replicas_serving", "fleet/autoscaler.py"),
             _t("replicas_draining", "fleet/autoscaler.py"),
             _t("replicas_retired", "fleet/autoscaler.py"),
             _t("replicas_resurrecting", "fleet/autoscaler.py")),
        doc="Autoscaler conservation: every spawned replica is serving, "
            "draining toward preemption, retired (exited), or "
            "resurrecting from its snapshot — scale-down and chaos "
            "kills book through the same transitions."),
)


def identities_by_name() -> Dict[str, Identity]:
    return {i.name: i for i in DECLARED_IDENTITIES}


_IDENT_RE = re.compile(
    r"^\s*(\w+)\s*==\s*(\w+(?:\s*\+\s*\w+)*)\s*$")


def parse_identity_expr(expr: str, file: str,
                        line: int) -> Optional[Identity]:
    """Parse a fixture-declared ``FLOW_IDENTITY = "lhs == a + b"``
    string into an Identity whose every term must be produced in
    ``file``. Returns None when the string does not parse."""
    m = _IDENT_RE.match(expr)
    if not m:
        return None
    lhs = IdentityTerm(name=m.group(1), counter=m.group(1), file=file)
    rhs = tuple(IdentityTerm(name=t.strip(), counter=t.strip(), file=file)
                for t in m.group(2).split("+"))
    return Identity(name=f"{file}:{m.group(1)}", lhs=lhs, rhs=rhs,
                    doc="module-declared identity", line=line)
