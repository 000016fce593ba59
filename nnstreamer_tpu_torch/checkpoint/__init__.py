"""Pipeline-wide checkpoint/restore: crash-consistent snapshots of
every stateful element, SIGTERM drain-and-snapshot, and resume.

Port of ``nnstreamer_tpu/checkpoint/``. Three pieces:

- the ``Checkpointable`` element contract
  (``Element.snapshot_state()/restore_state()``, advertised by the
  ``CHECKPOINTABLE`` doc attribute) implemented by the stateful
  elements — trainer, aggregator, rate, repo, serve source ledger,
  edge session rings, and the filter by delegation to its backend;
- :class:`SnapshotStore` — write-temp + hashed manifest + atomic
  rename + retain-N GC; :meth:`~SnapshotStore.verify` rejects a
  truncated or tampered snapshot with a :class:`SnapshotError` naming
  the bad blob;
- the preemption path — ``Pipeline.preempt(grace_s, dir)`` (quiesce →
  bounded drain → snapshot → stop, degrading to snapshot-without-drain
  under a short grace with abandoned frames *declared*), wired to
  SIGTERM by :class:`~..fault.preempt.PreemptGuard`, and
  ``Pipeline.restore(dir)`` rebuilding element state before
  ``start()``.

Not ported: the ``llm`` backend's stream snapshot (its hooks raise
:class:`~..pipeline.element.NotPortedError`, so a line holding an
``llm`` filter refuses to snapshot rather than losing its streams).
"""
from ..fault.preempt import PreemptGuard, install_sigterm
from .store import MANIFEST, SnapshotError, SnapshotStore

__all__ = ["SnapshotStore", "SnapshotError", "MANIFEST",
           "PreemptGuard", "install_sigterm"]
