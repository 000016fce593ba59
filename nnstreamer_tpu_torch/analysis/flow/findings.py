"""Finding/report model for flowcheck.

Same shape as racecheck's (``file:line``-pinned findings, 0/1/2 exit
contract, suppressions listed separately) with one extra axis: a
finding names the *resource* whose conservation it violates, and the
report carries the coverage counters (acquire sites modeled, identities
checked) the vacuous-coverage guard and the docs generator read.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# finding classes (the ``rule`` field)
LEAK = "leak"
DOUBLE_SETTLE = "double-settle"
MISSING_DECLARED_LOSS = "missing-declared-loss"
IDENTITY_BREAK = "identity-break"
VACUOUS_COVERAGE = "vacuous-coverage"


@dataclass(frozen=True)
class FlowFinding:
    rule: str
    file: str
    line: int
    message: str
    resource: Optional[str] = None  # resource or identity name involved
    func: Optional[str] = None      # qualified function, e.g. "Cls.meth"

    @property
    def location(self) -> str:
        return f"{self.file}:{self.line}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "location": self.location, "resource": self.resource,
                "func": self.func, "message": self.message}

    def __str__(self) -> str:
        return f"{self.rule:22s} {self.location}: {self.message}"


@dataclass
class FlowReport:
    findings: List[FlowFinding] = field(default_factory=list)
    suppressed: List[FlowFinding] = field(default_factory=list)
    num_files: int = 0
    num_functions: int = 0
    # coverage: matched acquire call sites (+ `# flow: owns()` markers)
    # and declared identities whose terms were statically checked — the
    # vacuous-coverage guard fails the gate when acquire_sites falls
    # under the CLI's --min-acquire-sites floor.
    acquire_sites: int = 0
    identities_checked: Tuple[str, ...] = ()

    def by_rule(self, rule: str) -> List[FlowFinding]:
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
            f"flowcheck: {len(self.findings)} finding(s) "
            f"({len(self.suppressed)} suppressed) across "
            f"{self.num_files} file(s) / {self.num_functions} "
            f"function(s); {self.acquire_sites} acquire site(s) "
            f"modeled, {len(self.identities_checked)} identity(ies) "
            f"checked")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "files": self.num_files,
            "functions": self.num_functions,
            "acquire_sites": self.acquire_sites,
            "identities_checked": list(self.identities_checked),
            "exit_code": self.exit_code,
        }, indent=2)
