"""flowcheck — static settlement & resource-conservation analysis.

Port of ``nnstreamer_tpu/analysis/flow/``. pipelint validates pipeline
GRAPHS, racecheck validates the lock discipline of the CODE; flowcheck
proves the third property family: *conservation along every code
path*. Every acquired resource token (window slot, KV block, accepted
socket, admitted request) must settle exactly once — or its ownership
must provably escape — on every path, including exception edges; every
lossy settle must declare its loss in a counter; and every module's
declared conservation identity must be both statically producible and
arithmetically true at runtime.

    from nnstreamer_tpu_torch.analysis.flow import analyze_paths
    report = analyze_paths(["nnstreamer_tpu_torch/"])
    assert report.exit_code == 0, report.to_text()

The static half reads source as text and never imports what it scans,
so it is a copy of the JAX package's: the same rules, the
``@flow.acquires/@flow.settles`` annotations, the
``# flow: owns(resource)`` handoff marker, the
``# flowcheck: ok(reason)`` suppression pragma, the report JSON and the
CLI flags (Documentation/accounting.md describes the model).
"""
from .findings import (DOUBLE_SETTLE, IDENTITY_BREAK, LEAK,
                       MISSING_DECLARED_LOSS, VACUOUS_COVERAGE,
                       FlowFinding, FlowReport)
from .model import FlowModel, scan_paths
from .passes import analyze_paths, run_passes
from .registry import (DECLARED_IDENTITIES, SPECS, Identity,
                       IdentityTerm, ResourceSpec, identities_by_name)
from .runtime import IdentityResult, check_identities

__all__ = [
    "analyze_paths", "run_passes", "scan_paths", "FlowModel",
    "FlowFinding", "FlowReport", "LEAK", "DOUBLE_SETTLE",
    "MISSING_DECLARED_LOSS", "IDENTITY_BREAK", "VACUOUS_COVERAGE",
    "ResourceSpec", "SPECS", "Identity", "IdentityTerm",
    "DECLARED_IDENTITIES", "identities_by_name", "check_identities",
    "IdentityResult",
]
