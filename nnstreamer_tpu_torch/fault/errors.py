"""Error classification: transient vs fatal.

A copy of ``nnstreamer_tpu/fault/errors.py``, which is framework
neutral. The port adds one entry to the fatal registry:
``torch.cuda.OutOfMemoryError`` stays fatal even where a deployment
registers ``RuntimeError`` (the base of every CUDA runtime error) as
transient. CUDA runtime errors are fatal by default: a sticky error
poisons the context, and a retry on it reproduces the failure.

≙ the reference's GstFlowReturn discipline — GST_FLOW_ERROR kills the
pipeline, but element errors that are *recoverable* (a flaky socket, a
torn wire frame) are bus warnings with a retry story. An exception is
transient when retrying the same operation can plausibly succeed:
network hiccups, timeouts, torn codec frames. Everything else (shape
mismatches, programming errors, OOM) is fatal — retrying reproduces it.

Elements (and tests) signal an explicitly-retryable failure by raising
:class:`TransientError`; the registry classifies stdlib exception types
so socket/codec failures from third-party code classify correctly
without wrapping.
"""
from __future__ import annotations

import socket
from typing import Tuple, Type

import torch


class TransientError(RuntimeError):
    """An operation failed in a way that a retry can plausibly fix
    (lost packet, momentary overload, torn frame). Raise it from
    ``do_chain``/``create`` to opt a failure into retry/skip policies
    explicitly."""


class FaultInjected(TransientError):
    """Raised by the ``tensor_fault`` element in ``transient`` mode —
    a :class:`TransientError` tagged as synthetic so chaos tests can
    tell injected faults from organic ones."""


# exception types whose instances classify as transient. socket.timeout
# is an alias of TimeoutError since 3.10 but listed for clarity; codec
# errors surface as ValueError/EOFError from struct/json/numpy parsing
# of torn wire frames.
_TRANSIENT_TYPES: Tuple[Type[BaseException], ...] = (
    TransientError,
    TimeoutError,
    socket.timeout,
    ConnectionError,        # ConnectionReset/Aborted/Refused, BrokenPipe
    InterruptedError,
    BlockingIOError,
)

# fatal even if a registered transient base matches (checked first);
# e.g. a subclass someone registers too broadly can be carved back out
_FATAL_TYPES: Tuple[Type[BaseException], ...] = (
    torch.cuda.OutOfMemoryError,
)


def register_transient(*types: Type[BaseException]) -> None:
    """Extend the transient registry (module-global, like the element
    registry): deployments mapping their own codec/driver exceptions
    into retry policies register them here."""
    global _TRANSIENT_TYPES
    _TRANSIENT_TYPES = _TRANSIENT_TYPES + tuple(
        t for t in types if t not in _TRANSIENT_TYPES)


def register_fatal(*types: Type[BaseException]) -> None:
    """Mark exception types fatal even when a transient base class
    matches (fatal wins over transient)."""
    global _FATAL_TYPES
    _FATAL_TYPES = _FATAL_TYPES + tuple(
        t for t in types if t not in _FATAL_TYPES)


def is_transient(exc: BaseException) -> bool:
    """True when retrying the failed operation can plausibly succeed."""
    if _FATAL_TYPES and isinstance(exc, _FATAL_TYPES):
        return False
    return isinstance(exc, _TRANSIENT_TYPES)
