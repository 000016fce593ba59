"""Finding/severity/report model for pipelint.

A copy of ``nnstreamer_tpu/analysis/findings.py``, with one addition:
``Report.crashed`` lists the ids of rules that raised during
:func:`~.rules.analyze` (which skips them, so a broken rule never blocks
a launch, but a caller can still refuse to hide the crash).

A ``Finding`` pins a defect to an element (and, when known, the pad
where it was detected). A ``Report`` aggregates findings and maps them
to the CLI exit-code contract: 0 clean (info only), 1 warnings,
2 errors.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional


class Severity(IntEnum):
    """Ordered so ``max(findings)`` is the report verdict."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR"
        return self.name.lower()


@dataclass(frozen=True)
class Finding:
    rule: str
    severity: Severity
    message: str
    element: Optional[str] = None
    pad: Optional[str] = None

    @property
    def location(self) -> str:
        if self.element is None:
            return "<pipeline>"
        return f"{self.element}.{self.pad}" if self.pad else self.element

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": str(self.severity),
                "element": self.element, "pad": self.pad,
                "location": self.location, "message": self.message}

    def __str__(self) -> str:
        return (f"{str(self.severity):7s} {self.rule:22s} "
                f"{self.location}: {self.message}")


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    num_elements: int = 0
    crashed: List[str] = field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    @property
    def exit_code(self) -> int:
        """0 clean / 1 warnings / 2 errors (the CLI contract)."""
        if self.errors:
            return 2
        if self.warnings:
            return 1
        return 0

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def to_text(self) -> str:
        lines = [str(f) for f in sorted(
            self.findings, key=lambda f: (-int(f.severity), f.rule))]
        lines.append(
            f"pipelint: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s), "
            f"{len(self.findings) - len(self.errors) - len(self.warnings)} "
            f"info in {self.num_elements} element(s)")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "findings": [f.to_dict() for f in self.findings],
            "errors": len(self.errors), "warnings": len(self.warnings),
            "elements": self.num_elements, "exit_code": self.exit_code,
        }, indent=2)


class PipelineValidationError(ValueError):
    """Raised by ``Pipeline.start()`` when validation finds errors."""

    def __init__(self, report: Report):
        self.report = report
        errs = "; ".join(f"{f.location}: {f.message}" for f in report.errors)
        super().__init__(
            f"pipeline failed validation with {len(report.errors)} "
            f"error(s): {errs} (set pipeline.validate_on_start=False to "
            f"launch anyway)")
