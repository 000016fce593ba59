"""racecheck — static concurrency analysis for the runtime itself.

pipelint (the sibling package) validates pipeline GRAPHS; racecheck
validates the CODE that executes them: an Eraser-style lockset pass
over a thread-role model, a lock-order graph with deadlock-cycle
detection, and a blocking-under-lock pass — plus an opt-in runtime
lock monitor that cross-checks the static graph against acquisitions
recorded while the test suite runs.

Port of ``nnstreamer_tpu/analysis/concurrency/``. The analyzer reads
source as text and never imports what it scans, so it is a copy: the
same module layout, rule names, ``# racecheck: ok(reason)`` pragma,
report JSON and CLI flags, and over any tree it reports what the JAX
package's racecheck reports there.

    from nnstreamer_tpu_torch.analysis.concurrency import analyze_paths
    report = analyze_paths(["nnstreamer_tpu_torch/"])
    assert report.exit_code == 0, report.to_text()

See Documentation/concurrency.md for the role model, the lock
hierarchy, and the ``# racecheck: ok(reason)`` suppression pragma.
"""
from .findings import (BLOCKING_UNDER_LOCK, LOCK_ORDER_CYCLE,
                       SLEEP_UNDER_LOCK, UNGUARDED_WRITE, RaceFinding,
                       RaceReport)
from .model import Model, roles_of, scan_paths
from .passes import analyze_paths, find_cycles, run_passes
from .runtime import (LockMonitor, TracedCondition, TracedLock,
                      instrument_counters, instrument_object)

__all__ = [
    "analyze_paths", "run_passes", "scan_paths", "roles_of",
    "find_cycles", "Model", "RaceFinding", "RaceReport",
    "UNGUARDED_WRITE", "LOCK_ORDER_CYCLE", "BLOCKING_UNDER_LOCK",
    "SLEEP_UNDER_LOCK", "LockMonitor", "TracedLock", "TracedCondition",
    "instrument_object", "instrument_counters",
]
