"""Fault-tolerance layer: error policies, supervised restarts, backoff,
circuit breaking, and fault injection.

Port of ``nnstreamer_tpu/fault/``; every module but ``element.py``
(``tensor_fault``) is framework neutral and copied as it stands,
``PreemptGuard``/``install_sigterm`` (``fault/preempt.py``, SIGTERM →
``Pipeline.preempt``) included.
"""
from .backoff import Backoff, RestartBudget
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .errors import (FaultInjected, TransientError, is_transient,
                     register_fatal, register_transient)
from .preempt import PreemptGuard, install_sigterm
from .policy import ErrorPolicy, handle_chain_error, policy_of, \
    restart_element
from .supervisor import CONTINUE, ESCALATE, RESTART, Supervisor

__all__ = [
    "Backoff", "RestartBudget", "CircuitBreaker",
    "CLOSED", "OPEN", "HALF_OPEN",
    "TransientError", "FaultInjected", "is_transient",
    "register_transient", "register_fatal",
    "ErrorPolicy", "policy_of", "handle_chain_error", "restart_element",
    "Supervisor", "CONTINUE", "RESTART", "ESCALATE",
    "PreemptGuard", "install_sigterm",
]
