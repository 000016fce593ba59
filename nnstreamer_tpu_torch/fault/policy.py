"""Per-element error policies for the buffer chain path.

A copy of ``nnstreamer_tpu/fault/policy.py``, which is framework
neutral. On the card, a ``restart`` of a filter or a fused segment
re-opens its model and recaptures its CUDA graphs into the element's
graph pool, which the element keeps across the restart (the backend
frees the old module and graphs at close).

Every element carries an ``on-error`` property (base ``Element.PROPS``)
naming what happens when its ``do_chain`` raises:

=========  ==============================================================
policy     behavior
=========  ==============================================================
fail       post the error, raise FlowError — aborts the pipeline
           (today's behavior; the default, so nothing changes unless
           a policy is asked for)
skip       drop the failing buffer, count it in ``stats['dropped']``,
           keep streaming (rate-limited bus warning)
retry      transient errors only: re-run ``do_chain`` on the SAME
           buffer up to N times with exponential backoff + jitter
           (``stats['retries']``); fatal errors and exhausted retries
           escalate to ``fail``
restart    tear the element down (``stop()``/``start()``), replay the
           negotiated caps, and re-run the buffer once; budgeted at
           most N restarts per rolling window (``stats['restarts']``)
=========  ==============================================================

Spec grammar (launch string or Python API, no spaces)::

    on-error=fail | skip | retry | retry(n[,backoff_s[,jitter]])
           | restart | restart(budget[,window_s])
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from ..utils.log import logger
from .backoff import Backoff, RestartBudget
from .errors import is_transient

_SPEC_RE = re.compile(
    r"^(?P<action>fail|skip|retry|restart)"
    r"(?:\((?P<args>[^)]*)\))?$")


@dataclass(frozen=True)
class ErrorPolicy:
    action: str = "fail"
    max_retries: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.5
    max_backoff_s: float = 2.0
    restart_budget: int = 3
    window_s: float = 30.0

    @classmethod
    def parse(cls, spec) -> "ErrorPolicy":
        """``"retry(5,0.01)"`` -> ErrorPolicy. Raises ValueError with
        the offending spec (pipelint surfaces it pre-launch)."""
        if isinstance(spec, ErrorPolicy):
            return spec
        text = str(spec or "fail").strip().lower()
        m = _SPEC_RE.match(text)
        if m is None:
            raise ValueError(
                f"bad on-error spec {spec!r}: expected fail | skip | "
                f"retry[(n[,backoff_s[,jitter]])] | "
                f"restart[(budget[,window_s])]")
        action = m.group("action")
        args = [a.strip() for a in (m.group("args") or "").split(",") if
                a.strip()]
        if args and action in ("fail", "skip"):
            raise ValueError(f"on-error={action} takes no arguments "
                             f"(got {spec!r})")
        try:
            if action == "retry":
                kw = {}
                if len(args) > 0:
                    kw["max_retries"] = int(args[0])
                if len(args) > 1:
                    kw["backoff_s"] = float(args[1])
                if len(args) > 2:
                    kw["jitter"] = float(args[2])
                if len(args) > 3:
                    raise ValueError("too many arguments")
                return cls(action="retry", **kw)
            if action == "restart":
                kw = {}
                if len(args) > 0:
                    kw["restart_budget"] = int(args[0])
                if len(args) > 1:
                    kw["window_s"] = float(args[1])
                if len(args) > 2:
                    raise ValueError("too many arguments")
                return cls(action="restart", **kw)
        except ValueError as exc:
            raise ValueError(f"bad on-error spec {spec!r}: {exc}") from None
        return cls(action=action)

    def make_backoff(self, seed: Optional[int] = None) -> Backoff:
        return Backoff(self.backoff_s, self.multiplier,
                       self.max_backoff_s, self.jitter, seed=seed)

    def make_budget(self) -> RestartBudget:
        return RestartBudget(self.restart_budget, self.window_s)


def policy_of(element) -> ErrorPolicy:
    """The element's parsed policy, cached against the property value
    (the property is a plain string so launch parsing stays dumb)."""
    spec = getattr(element, "on_error", "fail")
    cached = getattr(element, "_error_policy_cache", None)
    if cached is not None and cached[0] == spec:
        return cached[1]
    policy = ErrorPolicy.parse(spec)
    element._error_policy_cache = (spec, policy)
    return policy


def _warn_rate_limited(element, count: int, **data) -> None:
    # 1, 2, 4, 8, ... then every 64th — the tensor_filter invoke-error
    # convention: observable without flooding an unread bus
    if count & (count - 1) == 0 or count % 64 == 0:
        element.post_message("warning", **data)


def escalate(element, exc: Exception, **ctx) -> None:
    """Post a structured error (element, cause, policy context) and
    raise FlowError — the one place policy failures become pipeline
    failures."""
    from ..pipeline.pad import FlowError
    logger.exception("%s: error in chain (policy escalation)", element.name)
    if element.pipeline is not None:
        element.pipeline.post_message(
            "error", element=element.name, error=exc, cause=repr(exc), **ctx)
    raise FlowError(f"{element.name}: {exc}") from exc


def restart_element(element) -> None:
    """Tear down and re-start the element in place, replaying the caps
    each sink pad had negotiated so downstream re-negotiates from the
    same stream state (≙ a READY->PLAYING bounce of one element)."""
    element.stop()
    element.start()
    for pad in element.sink_pads.values():
        if pad.caps is not None:
            element.on_sink_caps(pad, pad.caps)


def handle_chain_error(element, pad, buf, exc: Exception) -> bool:
    """Apply ``element``'s policy to an exception from ``do_chain``.

    Returns True when the buffer was eventually processed (a retry or
    post-restart re-run succeeded) — the caller then does its normal
    success accounting — or False when the buffer was consumed by the
    policy (skipped). Escalations raise FlowError.
    """
    policy = policy_of(element)
    if policy.action == "skip":
        n = element.stats.inc("dropped")
        logger.warning("%s: buffer skipped by on-error=skip (%s)",
                       element.name, exc)
        _warn_rate_limited(element, n, policy="skip", dropped=n,
                           cause=repr(exc))
        return False

    if policy.action == "retry":
        if not is_transient(exc):
            escalate(element, exc, policy="retry",
                     detail="fatal (non-transient) error")
        backoff = policy.make_backoff()
        stop_evt = getattr(element, "_stop_evt", None)
        for attempt in range(1, policy.max_retries + 1):
            backoff.sleep(stop_evt)
            element.stats.inc("retries")
            _warn_rate_limited(element, element.stats["retries"],
                               policy="retry", attempt=attempt,
                               cause=repr(exc))
            try:
                element.do_chain(pad, buf)
                return True
            except Exception as exc2:  # noqa: BLE001 — classified below
                from ..pipeline.pad import FlowError
                if isinstance(exc2, FlowError):
                    raise
                exc = exc2
                if not is_transient(exc):
                    break
        escalate(element, exc, policy="retry", attempts=policy.max_retries,
                 detail="retries exhausted")

    if policy.action == "restart":
        budget = getattr(element, "_restart_budget", None)
        if budget is None:
            budget = element._restart_budget = policy.make_budget()
        if not budget.allow():
            escalate(element, exc, policy="restart",
                     attempts=budget.limit,
                     detail=f"restart budget exhausted "
                            f"({budget.limit}/{policy.window_s:g}s)")
        element.stats.inc("restarts")
        element.post_message("warning", policy="restart",
                             attempt=element.stats["restarts"],
                             cause=repr(exc))
        logger.warning("%s: restarting element after error (%s)",
                       element.name, exc)
        try:
            restart_element(element)
            element.do_chain(pad, buf)
            return True
        except Exception as exc2:  # noqa: BLE001 — one re-run, then escalate
            from ..pipeline.pad import FlowError
            if isinstance(exc2, FlowError):
                raise
            escalate(element, exc2, policy="restart",
                     detail="element failed again after restart")

    # action == "fail" (and any unknown spec caught at parse time)
    escalate(element, exc, policy="fail")
    return False  # unreachable; escalate always raises
