"""Finding/report model for jitcheck.

A copy of ``nnstreamer_tpu/analysis/jit/findings.py``: the same five
finding classes, report fields and JSON, so a report of either
package's jitcheck reads the same. In the port a "jit site" is a
capture site (a CUDA-graph capture, ``torch.compile`` or a TorchScript
trace), bucketed by the compile-cache kind the runtime records.

Same contract as the sibling analyzers: findings pin to ``file:line``
of the codebase itself, there is no benign tier (ANY live finding
fails the gate — 0 clean / 1 findings / 2 usage error), and
deliberate exceptions are spelled at the site with a reasoned
``# jitcheck: ok(reason)`` pragma.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# finding classes (the ``rule`` field)
HOST_SYNC = "host-sync-in-hot-path"
RETRACE = "retrace-hazard"
DONATION_MISUSE = "donation-misuse"
IMPURE_DEVICE_FN = "impure-device-fn"
VACUOUS_COVERAGE = "vacuous-coverage"


@dataclass(frozen=True)
class JitFinding:
    rule: str
    file: str
    line: int
    message: str
    cls: Optional[str] = None       # owning class, e.g. "TensorFilter"
    func: Optional[str] = None      # owning function/method name
    roles: Tuple[str, ...] = ()     # hot thread roles the site runs under

    @property
    def location(self) -> str:
        return f"{self.file}:{self.line}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "location": self.location, "class": self.cls,
                "func": self.func, "roles": list(self.roles),
                "message": self.message}

    def __str__(self) -> str:
        return f"{self.rule:22s} {self.location}: {self.message}"


@dataclass
class JitReport:
    findings: List[JitFinding] = field(default_factory=list)
    suppressed: List[JitFinding] = field(default_factory=list)
    num_files: int = 0
    hot_sites: int = 0              # hot-path bodies actually walked
    compiled_bodies: int = 0        # device-program bodies walked
    jit_sites: int = 0              # capture constructions seen
    # kind -> count of capture constructions, the static half of the
    # runtime contract: observed CompileCache kinds must be a subset.
    jit_site_kinds: Dict[str, int] = field(default_factory=dict)

    def by_rule(self, rule: str) -> List[JitFinding]:
        return [f for f in self.findings if f.rule == rule]

    @property
    def exit_code(self) -> int:
        """0 clean / 1 findings (suppressions don't count) — the CLI
        maps usage errors to 2 before analysis ever runs."""
        return 1 if self.findings else 0

    def to_text(self, verbose: bool = False) -> str:
        lines = [str(f) for f in sorted(
            self.findings, key=lambda f: (f.rule, f.file, f.line))]
        if verbose:
            lines += [f"suppressed {f}" for f in sorted(
                self.suppressed, key=lambda f: (f.file, f.line))]
        lines.append(
            f"jitcheck: {len(self.findings)} finding(s) "
            f"({len(self.suppressed)} suppressed) across "
            f"{self.num_files} file(s); walked {self.hot_sites} hot-path "
            f"site(s) + {self.compiled_bodies} compiled bod(ies), "
            f"{self.jit_sites} jit site(s)")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "files": self.num_files,
            "hot_sites": self.hot_sites,
            "compiled_bodies": self.compiled_bodies,
            "jit_sites": self.jit_sites,
            "jit_site_kinds": dict(sorted(self.jit_site_kinds.items())),
            "exit_code": self.exit_code,
        }, indent=2)
