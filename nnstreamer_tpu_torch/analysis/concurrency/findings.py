"""Finding/report model for racecheck.

Where pipelint findings pin to an element/pad of one pipeline,
racecheck findings pin to ``file:line`` of the codebase itself. The
exit-code contract also differs: concurrency findings have no benign
tier, so ANY live finding fails the gate (0 clean / 1 findings /
2 usage error).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

# finding classes (the ``rule`` field)
UNGUARDED_WRITE = "unguarded-shared-write"
LOCK_ORDER_CYCLE = "lock-order-cycle"
BLOCKING_UNDER_LOCK = "blocking-under-lock"
SLEEP_UNDER_LOCK = "sleep-under-lock"


@dataclass(frozen=True)
class RaceFinding:
    rule: str
    file: str
    line: int
    message: str
    cls: Optional[str] = None       # owning class, e.g. "Element"
    attr: Optional[str] = None      # attribute or lock name involved
    roles: Tuple[str, ...] = ()     # thread roles that collide

    @property
    def location(self) -> str:
        return f"{self.file}:{self.line}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "location": self.location, "class": self.cls,
                "attr": self.attr, "roles": list(self.roles),
                "message": self.message}

    def __str__(self) -> str:
        return f"{self.rule:22s} {self.location}: {self.message}"


@dataclass
class RaceReport:
    findings: List[RaceFinding] = field(default_factory=list)
    suppressed: List[RaceFinding] = field(default_factory=list)
    num_classes: int = 0
    num_files: int = 0
    # the static lock-order graph, for the runtime validator cross-check
    lock_edges: Set[Tuple[str, str]] = field(default_factory=set)

    def by_rule(self, rule: str) -> List[RaceFinding]:
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
            f"racecheck: {len(self.findings)} finding(s) "
            f"({len(self.suppressed)} suppressed) in {self.num_classes} "
            f"class(es) across {self.num_files} file(s); "
            f"lock-order graph has {len(self.lock_edges)} edge(s)")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "classes": self.num_classes, "files": self.num_files,
            "lock_order_edges": sorted(list(e) for e in self.lock_edges),
            "exit_code": self.exit_code,
        }, indent=2)
