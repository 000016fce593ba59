"""flowmarks — zero-cost acquire/settle annotations for flowcheck.

A copy of ``nnstreamer_tpu/utils/flowmarks.py`` (the port imports
nothing of the JAX package). The flow analyzer
(``nnstreamer_tpu.analysis.flow``) builds its acquire/settle model from
two sources: name-based seeding (regexes over receiver names, for code
that predates the analyzer) and these explicit decorators. Decorating a method registers its NAME with the named
resource, so call sites like ``self.mgr.alloc(...)`` are recognized as
minting (or settling) a token of that resource — the spec's receiver
regex still scopes which call sites count, so ``lock.release()`` never
masquerades as a KV-block settle.

The decorators are identity functions at runtime: no wrapper frame, no
import cost beyond this module, no behavior change. They live in utils
(dependency-free) rather than in the analysis package so annotating a
leaf module like ``filters/kvpool.py`` can never create an import
cycle through the analyzer's own dependencies.

Usage::

    from ..utils import flowmarks as flow

    class KVBlockPool:
        @flow.acquires("kv-block")
        def alloc(self, n): ...

        @flow.settles("kv-block")
        def release(self, blocks): ...
"""
from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def acquires(resource: str) -> Callable[[F], F]:
    """Mark a function/method as minting one token of ``resource`` per
    call. flowcheck's scanner reads the decoration statically; at
    runtime this returns the function unchanged."""

    def mark(fn: F) -> F:
        return fn

    return mark


def settles(resource: str, kind: str = "ok") -> Callable[[F], F]:
    """Mark a function/method as settling a token of ``resource``.
    ``kind="loss"`` declares a lossy settle (the payload is discarded):
    flowcheck then requires the calling path to also increment one of
    the resource's declared loss counters."""

    def mark(fn: F) -> F:
        return fn

    return mark
