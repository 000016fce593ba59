"""Supervisor for streaming threads (source loops).

A copy of ``nnstreamer_tpu/fault/supervisor.py``, which is framework
neutral.

A source's streaming thread has no caller to unwind into — when
``create()`` or the stream preamble raises, somebody must decide
between retrying, restarting the stream, and declaring the pipeline
dead. The supervisor is that somebody: it applies the element's
``on-error`` policy with exponential backoff + jitter and a restart
budget (max N restarts per rolling window), posts structured
``"warning"`` messages (element, attempt, cause) for every recovery,
and answers :data:`ESCALATE` once the budget is spent — at which point
the loop posts the pipeline error exactly like today.

≙ GStreamer's error-resilient sources (rtspsrc retry/reconnect) plus an
Erlang-style restart intensity limit.
"""
from __future__ import annotations

from typing import Optional

from ..utils.log import logger
from .backoff import Backoff, RestartBudget
from .errors import is_transient
from .policy import ErrorPolicy, policy_of

# decisions handed back to the supervised loop
CONTINUE = "continue"   # drop/retry at the failure site, keep the stream
RESTART = "restart"     # replay the stream preamble (caps et al.)
ESCALATE = "escalate"   # out of policy: post the pipeline error


class Supervisor:
    """One per supervised thread (created inside the loop, so a
    stop()/start() bounce gets a fresh budget)."""

    def __init__(self, element, policy: Optional[ErrorPolicy] = None):
        self.element = element
        self.policy = policy if policy is not None else policy_of(element)
        self.backoff: Backoff = self.policy.make_backoff()
        self.budget: RestartBudget = self.policy.make_budget()
        self._consecutive = 0

    def ok(self) -> None:
        """Call after a successful unit of work: resets the consecutive
        failure count and the backoff ladder."""
        if self._consecutive:
            self._consecutive = 0
            self.backoff.reset()

    def handle(self, exc: Exception, where: str = "stream") -> str:
        """Apply the policy to a failure escaping the supervised loop;
        sleeps the backoff itself (interruptibly) before answering
        CONTINUE/RESTART."""
        action = self.policy.action
        self._consecutive += 1
        stop_evt = getattr(self.element, "_stop_evt", None)
        if stop_evt is not None and stop_evt.is_set():
            return ESCALATE  # stopping: don't retry into a torn-down world

        if action == "skip":
            n = self.element.stats.inc("dropped")
            logger.warning("%s: %s failure skipped by on-error=skip (%s)",
                           self.element.name, where, exc)
            self._post_warning(policy="skip", where=where, dropped=n,
                               cause=repr(exc))
            return CONTINUE

        if action == "retry":
            if not is_transient(exc) \
                    or self._consecutive > self.policy.max_retries:
                return ESCALATE
            delay = self.backoff.sleep(stop_evt)
            self.element.stats.inc("retries")
            self._post_warning(policy="retry", where=where,
                               attempt=self._consecutive,
                               backoff_s=round(delay, 4), cause=repr(exc))
            logger.warning("%s: %s failed (attempt %d/%d), retrying: %s",
                           self.element.name, where, self._consecutive,
                           self.policy.max_retries, exc)
            return CONTINUE

        if action == "restart":
            if not self.budget.allow():
                return ESCALATE
            delay = self.backoff.sleep(stop_evt)
            self.element.stats.inc("restarts")
            self._post_warning(policy="restart", where=where,
                               attempt=self.element.stats["restarts"],
                               backoff_s=round(delay, 4), cause=repr(exc))
            logger.warning("%s: restarting %s after error (%s)",
                           self.element.name, where, exc)
            return RESTART

        return ESCALATE  # fail (default)

    def _post_warning(self, **data) -> None:
        self.element.post_message("warning", **data)
