"""jitcheck — static CUDA-graph capture/host-sync hazard analysis.

The port of ``nnstreamer_tpu/analysis/jit/``, the fourth analyzer in
the family: pipelint validates pipeline GRAPHS, racecheck the lock
discipline of the CODE, flowcheck the settlement LEDGER — jitcheck
proves the hot path stays on the card. It rides on racecheck's
thread-role model to find the bodies a frame actually crosses, tracks
device-tensor taint through them, and reports hidden host syncs,
recapture triggers, donation-after-use, and impurity inside captured
functions; a runtime compile-stability monitor
(``tools/torch_jit_stability.py``) then cross-checks the static
capture-site map against what a warmed process actually captures.

    from nnstreamer_tpu_torch.analysis.jit import analyze_paths
    report = analyze_paths(["nnstreamer_tpu_torch/"])
    assert report.exit_code == 0, report.to_text()

The finding classes, the ``# jitcheck: ok(reason)`` suppression
pragma, the report JSON and the CLI flags are the JAX package's
(Documentation/jitcheck.md). The taint model is the JAX one with its
triggers mapped onto PyTorch and CUDA graphs (:mod:`.model`).
"""
from .findings import (DONATION_MISUSE, HOST_SYNC, IMPURE_DEVICE_FN,
                       RETRACE, VACUOUS_COVERAGE, JitFinding, JitReport)
from .model import (EXTRA_SEEDS, HOT_ROLES, FuncUnit, JitBinding,
                    JitModel, JitSite, scan_paths, site_kind)
from .passes import analyze_paths, run_passes
from .runtime import (CompileEventMonitor, StabilityResult,
                      check_against_static, jit_stat_snapshot,
                      steady_recompiles)

__all__ = [
    "analyze_paths", "run_passes", "scan_paths", "JitModel", "FuncUnit",
    "JitBinding", "JitSite", "JitFinding", "JitReport", "HOST_SYNC",
    "RETRACE", "DONATION_MISUSE", "IMPURE_DEVICE_FN", "VACUOUS_COVERAGE",
    "HOT_ROLES", "EXTRA_SEEDS", "site_kind", "CompileEventMonitor",
    "StabilityResult", "check_against_static", "jit_stat_snapshot",
    "steady_recompiles",
]
