"""The racecheck analysis passes: lockset, lock-order, blocking.

Lockset (Eraser, Savage et al. SOSP '97, adapted)
-------------------------------------------------
For each class attribute with post-init accesses: if accesses span >=2
live thread roles and at least one is a write, every WRITE must hold a
common lock. Reads are exempt (CPython attribute loads are GIL-atomic
reference reads; a reader sees the old or the new object, never a torn
one), and so is single-writer publication: plain ``self.x = value``
stores all coming from ONE role (the classic publish-then-read flag
pattern). Read-modify-writes (``+=``, ``d[k] = d[k] + 1``, container
mutators) never qualify for the exemption — lost updates are exactly
what this pass exists to catch.

Lock-order
----------
``with self._a:`` nested (lexically or through intra-class calls and
typed-attribute calls) inside ``with self._b:`` adds the edge
``Cls._b -> Cls._a``. A cycle in the resulting graph is a potential
deadlock: two threads can interleave the two orders.

Blocking-under-lock
-------------------
Intra-procedural: a call that can block indefinitely (``time.sleep``,
socket ``recv``/``accept``/``connect``, zero-arg ``queue.get()``,
zero-arg ``Thread.join()``, untimed ``Event.wait()``, model
``invoke``) issued while a ``with self._lock`` is lexically held.
``cond.wait()`` on the held condition itself is exempt — waiting
releases it. Interprocedural holds (a helper that blocks, called with
a lock held) are NOT tracked; keep blocking helpers out of critical
sections or suppress with an explicit pragma.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .findings import (BLOCKING_UNDER_LOCK, LOCK_ORDER_CYCLE,
                       SLEEP_UNDER_LOCK, UNGUARDED_WRITE, RaceFinding,
                       RaceReport)
from .model import API, Access, Model, live_roles, roles_of


def _emit(report: RaceReport, model: Model, finding: RaceFinding) -> None:
    reason = model.pragma_reason(finding.file, finding.line)
    if reason is not None:
        report.suppressed.append(finding)
    else:
        report.findings.append(finding)


# -- lockset pass ----------------------------------------------------------

def _entry_locks(model: Model, cls_name: str) -> Dict[str, FrozenSet[str]]:
    """Locks provably held at ENTRY of each method: the intersection
    over every intra-class call site of (locks lexically held there +
    the caller's own entry locks). This is what keeps a helper like
    ``_try_endpoint`` — only ever called inside ``with
    self._connect_mutex`` — from looking unguarded. Methods that are
    also callable from outside the class (anything public, plus
    recursion cycles) conservatively get the empty set."""
    eff = model.effective_methods(cls_name)
    sites: Dict[str, List[Tuple[str, FrozenSet[str]]]] = \
        {name: [] for name in eff}
    for m in eff.values():
        for call in m.calls:
            if call.attr is None and call.callee in sites:
                sites[call.callee].append((m.name, call.locks))
    entry: Dict[str, Optional[FrozenSet[str]]] = {}
    for name in eff:
        # public methods are external entry points regardless of
        # internal call sites; purely-internal helpers start unknown
        if not sites[name] or not name.startswith("_"):
            entry[name] = frozenset()
        else:
            entry[name] = None
    changed = True
    while changed:
        changed = False
        for name in eff:
            if entry[name] is not None and not sites[name]:
                continue
            if entry[name] == frozenset() and not name.startswith("_"):
                continue
            acc: Optional[FrozenSet[str]] = None
            unknown = False
            for caller, locks in sites[name]:
                ce = entry.get(caller)
                if ce is None:
                    unknown = True
                    break
                held = locks | ce
                acc = held if acc is None else (acc & held)
            if unknown or acc is None:
                continue
            if acc != entry[name]:
                entry[name] = acc
                changed = True
    return {n: (e if e is not None else frozenset())
            for n, e in entry.items()}


def lockset_pass(model: Model, report: RaceReport) -> None:
    # public attrs written post-init anywhere: targets for foreign reads
    foreign_by_attr: Dict[str, List] = {}
    for fa in model.foreign:
        if fa.kind == "read":
            foreign_by_attr.setdefault(fa.attr, []).append(fa)

    # role table per accessing class, for foreign-access role lookup
    role_cache: Dict[str, Dict[str, Set[str]]] = {}

    def roles_for(cls_name: Optional[str], method: str) -> Set[str]:
        if cls_name is None or cls_name not in model.classes:
            return {API}
        if cls_name not in role_cache:
            role_cache[cls_name] = roles_of(model, cls_name)
        return role_cache[cls_name].get(method, {API})

    for cls_name, cls in model.classes.items():
        if cls_name not in role_cache:
            role_cache[cls_name] = roles_of(model, cls_name)
        roles = role_cache[cls_name]
        safe = {a for a, t in model.effective_attr_types(cls_name).items()
                if _is_safe_type(t)}
        entry = _entry_locks(model, cls_name)
        # own accesses grouped by attribute, lifecycle methods excluded
        by_attr: Dict[str, List] = {}
        for m in cls.methods.values():
            mroles = live_roles(roles.get(m.name, {API}))
            if not mroles:          # init-only method: quiescent
                continue
            held_at_entry = entry.get(m.name, frozenset())
            for acc in m.accesses:
                if acc.attr in safe:
                    continue
                if held_at_entry:
                    acc = Access(attr=acc.attr, kind=acc.kind,
                                 lineno=acc.lineno,
                                 locks=acc.locks | held_at_entry,
                                 method=acc.method)
                by_attr.setdefault(acc.attr, []).append((acc, mroles))

        for attr, accs in sorted(by_attr.items()):
            writes = [(a, r) for a, r in accs if a.is_write]
            if not writes:
                continue
            all_roles: Set[str] = set()
            for _, r in accs:
                all_roles |= r
            if not attr.startswith("_"):
                for fa in foreign_by_attr.get(attr, ()):
                    if fa.cls == cls_name:
                        continue    # same-class helper, already counted
                    all_roles |= live_roles(roles_for(fa.cls, fa.method))
            if len(all_roles) < 2:
                continue
            common: Optional[FrozenSet[str]] = None
            for a, _ in writes:
                common = a.locks if common is None else common & a.locks
            if common:
                continue            # every write shares a guard
            write_roles: Set[str] = set()
            for _, r in writes:
                write_roles |= r
            if all(a.kind == "store" for a, _ in writes) \
                    and len(write_roles) <= 1:
                continue            # single-writer publication
            worst = next((a for a, _ in writes if not a.locks), writes[0][0])
            _emit(report, model, RaceFinding(
                rule=UNGUARDED_WRITE, file=cls.file, line=worst.lineno,
                cls=cls_name, attr=attr,
                roles=tuple(sorted(all_roles)),
                message=(f"{cls_name}.{attr} written in "
                         f"{cls_name}.{worst.method}() without a "
                         f"consistent lock, but accessed from roles "
                         f"{{{', '.join(sorted(all_roles))}}}")))


def _is_safe_type(type_name: str) -> bool:
    from .model import SAFE_TYPES
    return type_name in SAFE_TYPES


# -- lock-order pass -------------------------------------------------------

def _locks_acquired(model: Model) -> Dict[Tuple[str, str], Set[str]]:
    """(class, method) -> qualified lock names the call may acquire,
    transitively through self-calls and typed-attribute calls."""
    acq: Dict[Tuple[str, str], Set[str]] = {}
    for cls_name, cls in model.classes.items():
        types = model.effective_attr_types(cls_name)
        for m in cls.methods.values():
            own = {f"{cls_name}.{a.lock}" for a in m.acquisitions}
            acq[(cls_name, m.name)] = own
    changed = True
    while changed:
        changed = False
        for cls_name, cls in model.classes.items():
            types = model.effective_attr_types(cls_name)
            eff = model.effective_methods(cls_name)
            for m in cls.methods.values():
                mine = acq[(cls_name, m.name)]
                before = len(mine)
                for call in m.calls:
                    target: Optional[Tuple[str, str]] = None
                    if call.attr is None:
                        callee = eff.get(call.callee)
                        if callee is not None:
                            target = (callee.cls_name, call.callee)
                    else:
                        tname = types.get(call.attr.split(".")[0])
                        if tname in model.classes and \
                                call.callee in model.classes[tname].methods:
                            target = (tname, call.callee)
                    if target and target in acq:
                        mine |= acq[target]
                if len(mine) != before:
                    changed = True
    return acq


def lock_order_pass(model: Model, report: RaceReport) -> None:
    acq = _locks_acquired(model)
    # edge -> example (file, line) where it is created
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    for cls_name, cls in model.classes.items():
        types = model.effective_attr_types(cls_name)
        eff = model.effective_methods(cls_name)
        for m in cls.methods.values():
            for a in m.acquisitions:
                inner = f"{cls_name}.{a.lock}"
                for held in a.held:
                    outer = f"{cls_name}.{held}"
                    if outer != inner:
                        edges.setdefault((outer, inner),
                                         (cls.file, a.lineno))
            for call in m.calls:
                if not call.locks:
                    continue
                target: Optional[Tuple[str, str]] = None
                if call.attr is None:
                    callee = eff.get(call.callee)
                    if callee is not None:
                        target = (callee.cls_name, call.callee)
                else:
                    tname = types.get(call.attr.split(".")[0])
                    if tname in model.classes and \
                            call.callee in model.classes[tname].methods:
                        target = (tname, call.callee)
                if not target:
                    continue
                for inner in acq.get(target, ()):
                    for held in call.locks:
                        outer = f"{cls_name}.{held}"
                        if outer != inner:
                            edges.setdefault((outer, inner),
                                             (cls.file, call.lineno))

    report.lock_edges = set(edges)

    for cycle in find_cycles(set(edges)):
        first = min(cycle)
        idx = cycle.index(first)
        ordered = cycle[idx:] + cycle[:idx]
        file, line = edges[(ordered[0], ordered[1 % len(ordered)])]
        chain = " -> ".join(ordered + (ordered[0],))
        _emit(report, model, RaceFinding(
            rule=LOCK_ORDER_CYCLE, file=file, line=line,
            cls=ordered[0].split(".")[0], attr=ordered[0],
            message=(f"lock-order cycle {chain}: two threads taking "
                     f"these locks in different orders can deadlock")))


def find_cycles(edges: Set[Tuple[str, str]]) -> List[Tuple[str, ...]]:
    """Elementary cycles in a small digraph (DFS back-edge walk; each
    cycle reported once, rotation-normalized)."""
    graph: Dict[str, List[str]] = {}
    for src, dst in edges:
        graph.setdefault(src, []).append(dst)
    seen_cycles: Set[Tuple[str, ...]] = set()
    out: List[Tuple[str, ...]] = []

    def dfs(node: str, path: List[str], on_path: Set[str],
            visited: Set[str]) -> None:
        for nxt in graph.get(node, ()):
            if nxt in on_path:
                cyc = tuple(path[path.index(nxt):])
                idx = cyc.index(min(cyc))
                norm = cyc[idx:] + cyc[:idx]
                if norm not in seen_cycles:
                    seen_cycles.add(norm)
                    out.append(norm)
            elif nxt not in visited:
                path.append(nxt)
                on_path.add(nxt)
                dfs(nxt, path, on_path, visited)
                on_path.discard(nxt)
                path.pop()
        visited.add(node)

    visited: Set[str] = set()
    for start in sorted(graph):
        if start not in visited:
            dfs(start, [start], {start}, visited)
    return out


# -- blocking pass ---------------------------------------------------------

def blocking_pass(model: Model, report: RaceReport) -> None:
    units: List[Tuple[Optional[str], object, str]] = []
    for cls_name, cls in model.classes.items():
        for m in cls.methods.values():
            units.append((cls_name, m, cls.file))
    for fn in model.functions:
        units.append((None, fn, fn.file))

    for cls_name, m, file in units:
        for b in m.blocking:
            held = ", ".join(
                f"{cls_name}.{l}" if cls_name else l
                for l in sorted(b.locks))
            where = f"{cls_name}.{m.name}" if cls_name else m.name
            rule = SLEEP_UNDER_LOCK if b.rule == "sleep-under-lock" \
                else BLOCKING_UNDER_LOCK
            _emit(report, model, RaceFinding(
                rule=rule, file=file, line=b.lineno, cls=cls_name,
                attr=next(iter(sorted(b.locks)), None),
                message=(f"{where}() calls {b.what} while holding "
                         f"{held}: blocks every thread contending for "
                         f"the lock")))


def run_passes(model: Model) -> RaceReport:
    report = RaceReport(num_classes=len(model.classes),
                        num_files=model.num_files)
    lockset_pass(model, report)
    lock_order_pass(model, report)
    blocking_pass(model, report)
    report.findings.sort(key=lambda f: (f.rule, f.file, f.line))
    return report


def analyze_paths(paths: Sequence[str]) -> RaceReport:
    from .model import scan_paths
    return run_passes(scan_paths(paths))
