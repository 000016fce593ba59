"""Findings assembly for flowcheck.

The path walk (:mod:`.model`) already produced the raw leak /
double-settle / missing-declared-loss events; this module applies the
``# flowcheck: ok(reason)`` pragma, runs the module-level
identity-break pass (every statically declared conservation identity
must have each of its counter terms *produced* in its declaring file),
enforces the vacuous-coverage guard, and sorts everything into a
:class:`~.findings.FlowReport`.
"""
from __future__ import annotations

from typing import List, Sequence

from .findings import (IDENTITY_BREAK, VACUOUS_COVERAGE, FlowFinding,
                       FlowReport)
from .model import FlowModel, scan_paths
from .registry import DECLARED_IDENTITIES, Identity


def _emit(report: FlowReport, model: FlowModel,
          finding: FlowFinding) -> None:
    reason = model.pragma_reason(finding.file, finding.line)
    if reason is not None:
        report.suppressed.append(finding)
    else:
        report.findings.append(finding)


def _files_matching(model: FlowModel, suffix: str) -> List[str]:
    """Scanned files whose path ends with the registry's ``file``
    suffix (``serve/batcher.py``)."""
    return [f for f in model.files
            if f.replace("\\", "/").endswith(suffix)]


def _check_identity(report: FlowReport, model: FlowModel,
                    ident: Identity) -> bool:
    """Identity-break pass for one identity. Returns True when the
    identity was applicable to this scan (all declaring files present)
    and therefore counted as checked."""
    static_terms = [t for t in ident.terms() if t.counter and t.file]
    if not static_terms:
        return False
    per_term_files = {}
    for t in static_terms:
        matched = _files_matching(model, t.file)
        if not matched:
            return False        # declaring module outside this scan
        per_term_files[t] = matched
    for t in static_terms:
        produced = any(t.counter in model.productions.get(f, set())
                       for f in per_term_files[t])
        if not produced:
            _emit(report, model, FlowFinding(
                rule=IDENTITY_BREAK,
                file=per_term_files[t][0],
                line=ident.line,
                message=(f"identity '{ident.name}' "
                         f"({ident.expression}) declares term "
                         f"'{t.name}' but counter '{t.counter}' is "
                         f"never produced in {t.file} — the identity "
                         f"cannot balance"),
                resource=ident.name))
    return True


def run_passes(model: FlowModel,
               min_acquire_sites: int = 0) -> FlowReport:
    report = FlowReport(num_files=model.num_files,
                        num_functions=model.num_functions,
                        acquire_sites=model.acquire_sites)
    for finding in model.raw:
        _emit(report, model, finding)

    checked: List[str] = []
    for ident in DECLARED_IDENTITIES:
        if _check_identity(report, model, ident):
            checked.append(ident.name)
    for ident in model.module_identities:
        if _check_identity(report, model, ident):
            checked.append(ident.name)
    report.identities_checked = tuple(checked)

    if min_acquire_sites and model.acquire_sites < min_acquire_sites:
        scope = model.files[0] if model.files else "(empty scan)"
        report.findings.append(FlowFinding(
            rule=VACUOUS_COVERAGE, file=scope, line=0,
            message=(f"only {model.acquire_sites} acquire site(s) "
                     f"modeled (< {min_acquire_sites}): the scan "
                     f"proves nothing — receiver regexes or "
                     f"decorations have rotted")))

    report.findings.sort(key=lambda f: (f.rule, f.file, f.line))
    report.suppressed.sort(key=lambda f: (f.file, f.line))
    return report


def analyze_paths(paths: Sequence[str],
                  min_acquire_sites: int = 0) -> FlowReport:
    return run_passes(scan_paths(paths), min_acquire_sites)
