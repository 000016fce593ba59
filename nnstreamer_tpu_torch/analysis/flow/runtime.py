"""Runtime cross-check of the declared conservation identities.

A copy of ``nnstreamer_tpu/analysis/flow/runtime.py``. This validator
proves the arithmetic actually balances over live
``Counters`` snapshots — the serve, chaos, and router suites call
:func:`check_identities` on their merged reports so a settlement bug
that slips past the AST model still fails a fast test, not a slow
chaos run.

    from nnstreamer_tpu_torch.analysis.flow import check_identities
    snap = dict(scheduler.report())
    snap["pending"] = scheduler.pending()
    check_identities(snap, names=["serve-settlement"])

An identity is evaluated when every one of its term names is a key of
the snapshot (terms the caller can't observe simply exclude the
identity — unless it was requested by name, which makes a missing term
an error). Violations raise ``AssertionError`` with a per-term
breakdown; ``strict=False`` returns the results for inspection
instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from .registry import DECLARED_IDENTITIES, Identity, identities_by_name


@dataclass(frozen=True)
class IdentityResult:
    name: str
    expression: str
    lhs: Tuple[str, int]
    rhs: Tuple[Tuple[str, int], ...]
    holds: bool

    def breakdown(self) -> str:
        terms = " + ".join(f"{n}={v}" for n, v in self.rhs)
        total = sum(v for _, v in self.rhs)
        status = "holds" if self.holds else "VIOLATED"
        return (f"{self.name}: {self.lhs[0]}={self.lhs[1]} vs "
                f"{terms} (= {total}) — {status}")


def check_identities(snapshot: Mapping[str, int],
                     names: Optional[Iterable[str]] = None,
                     strict: bool = True) -> List[IdentityResult]:
    """Assert the declared conservation identities over a counter
    snapshot. Returns one :class:`IdentityResult` per identity
    evaluated; raises ``AssertionError`` on any violation (or on a
    requested-by-name identity whose terms the snapshot lacks) unless
    ``strict=False``."""
    if names is None:
        selected: List[Identity] = list(DECLARED_IDENTITIES)
        required = False
    else:
        by_name = identities_by_name()
        unknown = [n for n in names if n not in by_name]
        if unknown:
            raise KeyError(f"unknown identity name(s): {unknown} "
                           f"(known: {sorted(by_name)})")
        selected = [by_name[n] for n in names]
        required = True

    results: List[IdentityResult] = []
    problems: List[str] = []
    for ident in selected:
        term_names = [t.name for t in ident.terms()]
        missing = [n for n in term_names if n not in snapshot]
        if missing:
            if required:
                problems.append(
                    f"{ident.name}: snapshot lacks term(s) {missing} "
                    f"(needs {term_names})")
            continue
        lhs_v = int(snapshot[ident.lhs.name])
        rhs = tuple((t.name, int(snapshot[t.name])) for t in ident.rhs)
        holds = lhs_v == sum(v for _, v in rhs)
        res = IdentityResult(name=ident.name,
                             expression=ident.expression,
                             lhs=(ident.lhs.name, lhs_v),
                             rhs=rhs, holds=holds)
        results.append(res)
        if not holds:
            problems.append(res.breakdown())

    if problems and strict:
        raise AssertionError(
            "conservation identity violation:\n  "
            + "\n  ".join(problems))
    return results
