"""Path-sensitive acquire/settle extraction for flowcheck.

The scan runs in two phases over the parsed sources — no code is ever
executed:

**Phase 1 (registration)** collects, per file: ``# flowcheck: ok(...)``
pragma lines, ``# flow: owns(resource)`` ownership markers,
``@flow.acquires/@flow.settles`` decorations (which union the decorated
method NAMES into the matching :class:`~.registry.ResourceSpec`, or
mint a new any-receiver spec for a resource name the registry doesn't
know — how the fixture corpus declares toy resources), module-level
``FLOW_IDENTITY = "lhs == a + b"`` declarations, and every statically
visible ``Counters`` *production* site (``.inc("x")``, ``.add(x=...)``,
``c["x"] = ...`` — ``update()``/constructor seeding is initialisation,
not production).

**Phase 2 (path walk)** symbolically executes every function: an
acquire call (or owns marker) mints a *token*; the walker then forks
the state at branches, exception edges (every non-whitelisted call may
raise), loop bodies (0-or-1 iteration), and ``try``/``except``/
``finally`` (every handler is assumed to catch everything; ``finally``
applies to all outcome classes) and demands that on every path each
token is settled exactly once or its ownership provably *escapes*
(stored to an attribute/container, returned/yielded, passed to a
non-borrowing call, captured by a closure). Violations surface as
``leak`` / ``double-settle`` findings; a lossy settle whose path never
bumps a declared loss counter surfaces as ``missing-declared-loss``.

The model is deliberately optimistic where the repo's idiom is sound
(ownership transfers on argument passing even when the callee raises;
``if tok is None`` kills the token in the failure branch) and
pessimistic where leaks actually ship (any unlisted call can raise
between acquire and settle).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import (DOUBLE_SETTLE, LEAK, MISSING_DECLARED_LOSS,
                       FlowFinding)
from .registry import (Identity, ResourceSpec, SPECS, parse_identity_expr)

PRAGMA_RE = re.compile(r"#\s*flowcheck:\s*ok\(([^)]*)\)")
OWNS_RE = re.compile(r"#\s*flow:\s*owns\(([^)]*)\)")

# cap on simultaneously tracked states per function: path explosion is
# truncated, never an error (coverage degrades gracefully)
MAX_STATES = 400

# calls trusted not to raise AND not to take ownership of arguments
# (builtins, logging, container/sync primitives, clocks, Counters)
TRUSTED_CALLS = {
    "len", "int", "float", "str", "bool", "list", "dict", "tuple", "set",
    "frozenset", "min", "max", "sum", "sorted", "reversed", "isinstance",
    "issubclass", "getattr", "hasattr", "setattr", "enumerate", "range",
    "zip", "map", "filter", "repr", "print", "abs", "id", "round", "any",
    "all", "iter", "next", "format", "divmod",
    "append", "appendleft", "extend", "insert", "remove", "discard",
    "notify", "notify_all", "clear", "popleft", "pop", "get", "put",
    "setdefault", "index", "count",
    "inc", "add", "update", "snapshot", "items", "keys", "values",
    "copy", "deepcopy",
    "acquire", "release", "wait", "join", "close", "start", "is_alive",
    "locked", "set", "is_set",
    "info", "debug", "warning", "error", "exception", "log",
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "sleep",
}

# default loss counters granted to fixture-declared (decorator-minted)
# resources so `settles("res", "loss")` is testable without a registry
# entry
DEFAULT_LOSS_COUNTERS = frozenset(
    {"declared_lost", "dropped", "shed", "lost", "evicted"})


def _receiver_of(func: ast.AST) -> Optional[str]:
    """Dotted receiver of a call target: ``self.mgr.alloc`` -> "self.mgr",
    ``pool.alloc`` -> "pool", bare ``alloc`` -> "", non-name chains
    (e.g. calls) -> None."""
    if isinstance(func, ast.Name):
        return ""
    if not isinstance(func, ast.Attribute):
        return None
    parts: List[str] = []
    node = func.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """``entry.t_dispatch_ns`` -> "entry", ``x`` -> "x", else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


@dataclass
class _Token:
    spec_name: str
    line: int                       # acquire/owns line
    names: Set[str] = field(default_factory=set)
    settled: bool = False
    escaped: bool = False

    def copy(self) -> "_Token":
        return _Token(self.spec_name, self.line, set(self.names),
                      self.settled, self.escaped)


class _State:
    """One symbolic path: live/settled tokens, pending declared losses,
    loss counters already bumped."""

    __slots__ = ("tokens", "pending_loss", "bumped")

    def __init__(self) -> None:
        self.tokens: List[_Token] = []
        self.pending_loss: List[Tuple[str, int]] = []  # (spec, line)
        self.bumped: Set[str] = set()

    def clone(self) -> "_State":
        st = _State()
        st.tokens = [t.copy() for t in self.tokens]
        st.pending_loss = list(self.pending_loss)
        st.bumped = set(self.bumped)
        return st


# outcome kinds
_FALL, _RETURN, _RAISE, _BREAK, _CONTINUE = (
    "fall", "return", "raise", "break", "continue")


@dataclass
class FlowModel:
    """Everything the passes need: raw (pre-pragma) findings from the
    path walk, pragma/production tables, declared fixture identities,
    and coverage counters."""
    raw: List[FlowFinding] = field(default_factory=list)
    pragmas: Dict[str, Dict[int, str]] = field(default_factory=dict)
    productions: Dict[str, Set[str]] = field(default_factory=dict)
    module_identities: List[Identity] = field(default_factory=list)
    files: List[str] = field(default_factory=list)
    acquire_sites: int = 0
    num_files: int = 0
    num_functions: int = 0
    specs: Tuple[ResourceSpec, ...] = SPECS

    def pragma_reason(self, file: str, lineno: int) -> Optional[str]:
        """``# flowcheck: ok(reason)`` on the line or the line above."""
        table = self.pragmas.get(file, {})
        for ln in (lineno, lineno - 1):
            if ln in table:
                return table[ln]
        return None


class _FunctionAnalyzer:
    """Walks one function body over all paths, emitting raw findings
    into the shared model."""

    def __init__(self, model: FlowModel, file: str, qualname: str,
                 specs: Sequence[ResourceSpec],
                 owns: Dict[int, str]) -> None:
        self.model = model
        self.file = file
        self.func = qualname
        self.specs = specs
        self.spec_by_name = {s.name: s for s in specs}
        self.owns = owns
        self._seen: Set[Tuple[str, int, str]] = set()

    # -- finding emission --------------------------------------------------
    def _event(self, rule: str, line: int, resource: str,
               message: str) -> None:
        key = (rule, line, resource)
        if key in self._seen:
            return
        self._seen.add(key)
        self.model.raw.append(FlowFinding(
            rule=rule, file=self.file, line=line, message=message,
            resource=resource, func=self.func))

    # -- entry -------------------------------------------------------------
    def run(self, fnode: ast.AST) -> None:
        self.model.num_functions += 1
        outcomes = self._walk(list(fnode.body), _State())
        for kind, st, line in outcomes:
            for tok in st.tokens:
                if tok.settled or tok.escaped:
                    continue
                spec = tok.spec_name
                if kind == _RAISE:
                    self._event(
                        LEAK, line, spec,
                        f"{spec} acquired at line {tok.line} in "
                        f"{self.func} leaks when the call here raises "
                        f"(no settle/escape on the exception path)")
                else:
                    self._event(
                        LEAK, tok.line, spec,
                        f"{spec} acquired here is neither settled nor "
                        f"handed off on some path through {self.func}")
            for spec_name, line_ in st.pending_loss:
                spec = self.spec_by_name.get(spec_name)
                counters = sorted(spec.loss_counters) if spec else []
                self._event(
                    MISSING_DECLARED_LOSS, line_, spec_name,
                    f"lossy settle of {spec_name} in {self.func} but no "
                    f"loss counter ({', '.join(counters)}) is bumped on "
                    f"this path — the loss is silent, not declared")

    # -- statement walking -------------------------------------------------
    def _walk(self, stmts: List[ast.stmt],
              state: _State) -> List[Tuple[str, _State, int]]:
        cur: List[_State] = [state]
        done: List[Tuple[str, _State, int]] = []
        last_line = stmts[-1].lineno if stmts else 0
        for stmt in stmts:
            nxt: List[_State] = []
            for st in cur:
                for kind, s2, line in self._stmt(stmt, st):
                    if kind == _FALL:
                        nxt.append(s2)
                    else:
                        done.append((kind, s2, line))
            cur = nxt[:MAX_STATES]
            done = done[:MAX_STATES]
            if not cur:
                break
        done.extend((_FALL, s, last_line) for s in cur)
        return done[:MAX_STATES]

    def _stmt(self, stmt: ast.stmt,
              st: _State) -> List[Tuple[str, _State, int]]:
        if isinstance(stmt, ast.Expr):
            raise_line = self._may_raise_line(stmt)
            pre = st.clone() if raise_line is not None else None
            self._apply_owns(stmt, st, None)
            minted, refs = self._expr(stmt.value, st)
            for tok in minted:   # unbound acquire: anonymous live token
                st.tokens.append(tok)
            return self._forked(stmt, st, pre, raise_line)

        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            return self._assign(stmt, st)

        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                minted, refs = self._expr(stmt.value, st)
                for tok in minted:
                    tok.escaped = True
                    st.tokens.append(tok)
                self._escape_names(st, refs)
            return [(_RETURN, st, stmt.lineno)]

        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                minted, refs = self._expr(stmt.exc, st)
                for tok in minted:
                    tok.escaped = True
                    st.tokens.append(tok)
                self._escape_names(st, refs)
            return [(_RAISE, st, stmt.lineno)]

        if isinstance(stmt, ast.Break):
            return [(_BREAK, st, stmt.lineno)]
        if isinstance(stmt, ast.Continue):
            return [(_CONTINUE, st, stmt.lineno)]

        if isinstance(stmt, ast.If):
            return self._if(stmt, st)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, st)
        if isinstance(stmt, (ast.While,)):
            return self._while(stmt, st)
        if isinstance(stmt, ast.For):
            return self._for(stmt, st)
        if isinstance(stmt, ast.With):
            return self._with(stmt, st)

        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # nested def: any outer token named inside escapes (closure
            # takes ownership — e.g. completion callbacks)
            names = {n.id for n in ast.walk(stmt)
                     if isinstance(n, ast.Name)}
            self._escape_names(st, names)
            return [(_FALL, st, stmt.lineno)]

        if isinstance(stmt, (ast.Assert, ast.Delete, ast.Pass,
                             ast.Global, ast.Nonlocal, ast.Import,
                             ast.ImportFrom, ast.ClassDef)):
            return [(_FALL, st, stmt.lineno)]

        # anything else: process expressions conservatively
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._expr(node, st)
        return [(_FALL, st, stmt.lineno)]

    # -- assignments -------------------------------------------------------
    def _assign(self, stmt: ast.stmt,
                st: _State) -> List[Tuple[str, _State, int]]:
        raise_line = self._may_raise_line(stmt)
        pre = st.clone() if raise_line is not None else None
        value = getattr(stmt, "value", None)
        minted: List[_Token] = []
        refs: Set[str] = set()
        if value is not None:
            minted, refs = self._expr(value, st)
        self._apply_owns(stmt, st, stmt)
        if pre is not None:
            # the owns marker binds on the exception path too: the
            # obligation exists the moment the statement starts
            self._apply_owns(stmt, pre, stmt)

        targets = getattr(stmt, "targets", None) or \
            ([stmt.target] if getattr(stmt, "target", None) is not None
             else [])
        for tgt in targets:
            name = None
            if isinstance(tgt, ast.Name):
                name = tgt.id
            elif isinstance(tgt, (ast.Tuple, ast.List)) and tgt.elts and \
                    isinstance(tgt.elts[0], ast.Name):
                # conn, addr = srv.accept(): the token is the first elt
                name = tgt.elts[0].id
            if name is not None:
                for tok in minted:
                    tok.names.add(name)
                for tok in st.tokens:
                    if not tok.settled and tok.names & refs:
                        tok.names.add(name)
            elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
                # storing into an attribute/container publishes the
                # value: ownership escapes to the object
                if isinstance(tgt, ast.Subscript):
                    self._note_setitem(tgt, st)
                for tok in minted:
                    tok.escaped = True
                self._escape_names(st, refs)
        for tok in minted:
            st.tokens.append(tok)
        return self._forked(stmt, st, pre, raise_line)

    def _note_setitem(self, tgt: ast.Subscript, st: _State) -> None:
        """``counters["x"] = v`` counts as producing/bumping x."""
        sl = tgt.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            self._bump(st, sl.value)

    # -- control flow ------------------------------------------------------
    def _if(self, stmt: ast.If,
            st: _State) -> List[Tuple[str, _State, int]]:
        self._expr(stmt.test, st)
        name, none_branch = self._none_test(stmt.test)
        body_st, else_st = st.clone(), st
        if name is not None:
            killed = body_st if none_branch == "body" else else_st
            killed.tokens = [t for t in killed.tokens
                             if name not in t.names or t.settled]
        out = self._walk(list(stmt.body), body_st)
        out += self._walk(list(stmt.orelse), else_st)
        return out[:MAX_STATES]

    @staticmethod
    def _none_test(test: ast.expr) -> Tuple[Optional[str], str]:
        """Detect acquire-failure tests. Returns (token name, branch in
        which the token is absent) — ("t","body") for ``if t is None``,
        ("t","orelse") for ``if t:`` — or (None, "")."""
        if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
                isinstance(test.comparators[0], ast.Constant) and \
                test.comparators[0].value is None:
            name = _root_name(test.left)
            if name:
                if isinstance(test.ops[0], ast.Is):
                    return name, "body"
                if isinstance(test.ops[0], ast.IsNot):
                    return name, "orelse"
        if isinstance(test, ast.UnaryOp) and \
                isinstance(test.op, ast.Not):
            name = _root_name(test.operand)
            if name:
                return name, "body"
        if isinstance(test, ast.Name):
            return test.id, "orelse"
        return None, ""

    def _try(self, stmt: ast.Try,
             st: _State) -> List[Tuple[str, _State, int]]:
        body_out = self._walk(list(stmt.body), st)
        pre_finally: List[Tuple[str, _State, int]] = []
        for kind, s, line in body_out:
            if kind == _RAISE and stmt.handlers:
                # every handler is assumed able to catch this exception
                for h in stmt.handlers:
                    pre_finally += self._walk(list(h.body), s.clone())
            elif kind == _FALL and stmt.orelse:
                pre_finally += self._walk(list(stmt.orelse), s)
            else:
                pre_finally.append((kind, s, line))
        pre_finally = pre_finally[:MAX_STATES]
        if not stmt.finalbody:
            return pre_finally
        out: List[Tuple[str, _State, int]] = []
        for kind, s, line in pre_finally:
            for fk, fs, fl in self._walk(list(stmt.finalbody), s):
                # a finally that falls through preserves the pending
                # outcome; one that returns/raises overrides it
                out.append((kind, fs, line) if fk == _FALL
                           else (fk, fs, fl))
        return out[:MAX_STATES]

    def _while(self, stmt: ast.While,
               st: _State) -> List[Tuple[str, _State, int]]:
        self._expr(stmt.test, st)
        infinite = (isinstance(stmt.test, ast.Constant)
                    and stmt.test.value is True)
        body_out = self._walk(list(stmt.body), st.clone())
        out: List[Tuple[str, _State, int]] = []
        after: List[_State] = []
        for kind, s, line in body_out:
            if kind in (_FALL, _CONTINUE):
                if not infinite:
                    after.append(s)   # loop condition turns false next
            elif kind == _BREAK:
                after.append(s)
            else:
                out.append((kind, s, line))
        if not infinite:
            after.append(st)          # zero-iteration path
        out += [(_FALL, s, stmt.lineno) for s in after]
        return out[:MAX_STATES]

    def _for(self, stmt: ast.For,
             st: _State) -> List[Tuple[str, _State, int]]:
        minted, refs = self._expr(stmt.iter, st)
        for tok in minted:
            st.tokens.append(tok)
        body_st = st.clone()
        if isinstance(stmt.target, ast.Name):
            # for b in cov: b is a view into the token's payload
            for tok in body_st.tokens:
                if not tok.settled and tok.names & refs:
                    tok.names.add(stmt.target.id)
        body_out = self._walk(list(stmt.body), body_st)
        out: List[Tuple[str, _State, int]] = []
        after: List[_State] = [st]    # zero-iteration path
        for kind, s, line in body_out:
            if kind in (_FALL, _CONTINUE, _BREAK):
                after.append(s)
            else:
                out.append((kind, s, line))
        out += [(_FALL, s, stmt.lineno) for s in after]
        return out[:MAX_STATES]

    def _with(self, stmt: ast.With,
              st: _State) -> List[Tuple[str, _State, int]]:
        for item in stmt.items:
            minted, refs = self._expr(item.context_expr, st)
            if item.optional_vars is not None and \
                    isinstance(item.optional_vars, ast.Name):
                for tok in minted:
                    tok.names.add(item.optional_vars.id)
            for tok in minted:
                st.tokens.append(tok)
        return self._walk(list(stmt.body), st)

    # -- expression effects ------------------------------------------------
    def _expr(self, node: ast.expr,
              st: _State) -> Tuple[List[_Token], Set[str]]:
        """Apply acquire/settle/escape effects of one expression.
        Returns (tokens minted at top level, surviving referenced
        names usable as alias sources)."""
        minted: List[_Token] = []
        refs: Set[str] = set()
        self._expr_into(node, st, minted, refs)
        return minted, refs

    def _expr_into(self, node: ast.expr, st: _State,
                   minted: List[_Token], refs: Set[str]) -> None:
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                refs.add(node.id)
            return
        if isinstance(node, (ast.Lambda,)):
            names = {n.id for n in ast.walk(node)
                     if isinstance(n, ast.Name)}
            self._escape_names(st, names)
            return
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            inner = getattr(node, "value", None)
            if inner is not None:
                m2, r2 = self._expr(inner, st)
                for tok in m2:
                    tok.escaped = True
                    st.tokens.append(tok)
                self._escape_names(st, r2)
            return
        if isinstance(node, ast.Call):
            self._call(node, st, minted, refs)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr_into(child, st, minted, refs)

    def _call(self, node: ast.Call, st: _State,
              minted: List[_Token], refs: Set[str]) -> None:
        name = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name) else "")
        receiver = _receiver_of(node.func)
        if receiver is None:
            receiver = ""
        else:
            # visit the receiver chain root as a plain reference
            root = _root_name(node.func)
            if root and root not in ("self",):
                refs.add(root)

        spec, role = self._classify(name, receiver)

        arg_minted: List[_Token] = []
        arg_refs: Set[str] = set()
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            self._expr_into(arg, st, arg_minted, arg_refs)
        for tok in arg_minted:          # token used as an argument:
            tok.escaped = True          # ownership moves to the callee
            st.tokens.append(tok)

        # Counters production: .inc("x", ...) / .add(x=...)
        if name == "inc" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            self._bump(st, node.args[0].value)
        elif name == "add":
            for kw in node.keywords:
                if kw.arg:
                    self._bump(st, kw.arg)

        if role == "acquire":
            self.model.acquire_sites += 1
            minted.append(_Token(spec.name, node.lineno))
            refs |= arg_refs            # acquire borrows its args
            return
        if role in ("settle", "loss"):
            self._settle(st, spec, arg_refs, node.lineno,
                         is_loss=(role == "loss"))
            return

        # settle invoked ON the token itself (``conn.close()``): the
        # receiver is the token, so the spec's receiver regex (which
        # names the POOL) can't match — match by token name instead
        root = _root_name(node.func) \
            if isinstance(node.func, ast.Attribute) else None
        if root:
            for tok in st.tokens:
                if root not in tok.names:
                    continue
                tspec = self.spec_by_name.get(tok.spec_name)
                if tspec is None:
                    continue
                if name in tspec.loss_settle_attrs:
                    self._settle(st, tspec, {root}, node.lineno,
                                 is_loss=True)
                    return
                if name in tspec.settle_attrs:
                    self._settle(st, tspec, {root}, node.lineno,
                                 is_loss=False)
                    return

        if name in TRUSTED_CALLS or receiver.split(".")[-1] in (
                "logger", "log"):
            refs |= arg_refs            # borrowing call
        else:
            self._escape_names(st, arg_refs)

    def _classify(self, name: str, receiver: str):
        """(spec, "acquire"|"settle"|"loss") for a matching call site,
        else (None, "")."""
        for spec in self.specs:
            if not spec.matches_receiver(receiver):
                continue
            if name in spec.acquire_attrs:
                return spec, "acquire"
            if name in spec.loss_settle_attrs:
                return spec, "loss"
            if name in spec.settle_attrs:
                return spec, "settle"
        return None, ""

    # -- settle / bump / escape / owns -------------------------------------
    def _settle(self, st: _State, spec: ResourceSpec,
                arg_names: Set[str], line: int, is_loss: bool) -> None:
        if is_loss and not (spec.loss_counters & st.bumped):
            # a lossy settle needs a declared-loss bump on this path
            # whether or not the token itself is tracked here (ring
            # evictions settle retention acquired elsewhere)
            st.pending_loss.append((spec.name, line))
        mine = [t for t in st.tokens if t.spec_name == spec.name]
        live = [t for t in mine if not t.settled]
        # a settle arg can alias several tokens at once (``allb = cov +
        # fresh; release(allb)``): one call settles them all
        matched = [t for t in live if t.names & arg_names]
        if matched:
            for t in matched:
                t.settled = True
            return
        for t in mine:
            if t.settled and t.names & arg_names:
                self._event(
                    DOUBLE_SETTLE, line, spec.name,
                    f"{spec.name} already settled on this path is "
                    f"settled again in {self.func} — one terminal "
                    f"event per token")
                return
        if arg_names and mine:
            # named settle of something we never tracked: a helper
            # settling a parameter it doesn't own — not ours to judge
            return
        anon = [t for t in live if not t.escaped] or live
        if anon:
            anon[0].settled = True      # unnamed settle: oldest live
        elif [t for t in mine if t.settled]:
            self._event(
                DOUBLE_SETTLE, line, spec.name,
                f"every {spec.name} token on this path is already "
                f"settled; this second settle in {self.func} "
                f"double-counts a terminal event")

    def _bump(self, st: _State, counter: str) -> None:
        st.bumped.add(counter)
        keep = []
        for spec_name, line in st.pending_loss:
            spec = self.spec_by_name.get(spec_name)
            if spec is not None and counter in spec.loss_counters:
                continue
            keep.append((spec_name, line))
        st.pending_loss = keep

    @staticmethod
    def _escape_names(st: _State, names: Set[str]) -> None:
        if not names:
            return
        for tok in st.tokens:
            if not tok.settled and tok.names & names:
                tok.escaped = True

    def _apply_owns(self, stmt: ast.stmt, st: _State,
                    assign: Optional[ast.stmt]) -> None:
        """``# flow: owns(resource)`` on a statement line mints an
        ownership obligation there (cross-function handoff, e.g. a
        completer thread popping an entry whose slot it must release)."""
        resource = self.owns.get(stmt.lineno)
        if resource is None or resource not in self.spec_by_name:
            return
        tok = _Token(resource, stmt.lineno)
        targets = getattr(assign, "targets", None) if assign else None
        if targets and isinstance(targets[0], ast.Name):
            tok.names.add(targets[0].id)
        st.tokens.append(tok)
        self.model.acquire_sites += 1

    # -- exception edges ---------------------------------------------------
    @staticmethod
    def _forked(stmt: ast.stmt, st: _State, pre: Optional[_State],
                raise_line: Optional[int]
                ) -> List[Tuple[str, _State, int]]:
        """Fall-through with the statement's effects applied, plus an
        exception edge carrying the PRE-statement state: ownership only
        transfers to a callee that actually completed, so a raising
        call leaves every token where it was."""
        out: List[Tuple[str, _State, int]] = [(_FALL, st, stmt.lineno)]
        if raise_line is not None and pre is not None:
            out.append((_RAISE, pre, raise_line))
        return out

    def _may_raise_line(self, stmt: ast.stmt) -> Optional[int]:
        """First call in the statement that isn't whitelisted as
        non-raising (registered acquires/settles, builtins, logging,
        sync primitives)."""
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if not isinstance(node, ast.Call):
                continue
            name = node.func.attr if isinstance(node.func, ast.Attribute) \
                else (node.func.id
                      if isinstance(node.func, ast.Name) else "")
            receiver = _receiver_of(node.func) or ""
            spec, role = self._classify(name, receiver)
            if role:
                continue
            if name in TRUSTED_CALLS:
                continue
            if receiver.split(".")[-1] in ("logger", "log"):
                continue
            return node.lineno
        return None


# -- phase 1: registration -------------------------------------------------

@dataclass
class _FileFacts:
    label: str
    tree: ast.Module
    owns: Dict[int, str] = field(default_factory=dict)


def _collect_decorations(tree: ast.Module) -> List[Tuple[str, str, str]]:
    """(resource, method name, "acquire"|"settle"|"loss") for every
    ``@flow.acquires/@flow.settles`` decoration in the module."""
    regs: List[Tuple[str, str, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            dname = dec.func.attr if isinstance(dec.func, ast.Attribute) \
                else (dec.func.id
                      if isinstance(dec.func, ast.Name) else "")
            if dname not in ("acquires", "settles"):
                continue
            if not (dec.args and isinstance(dec.args[0], ast.Constant)
                    and isinstance(dec.args[0].value, str)):
                continue
            resource = dec.args[0].value
            if dname == "acquires":
                regs.append((resource, node.name, "acquire"))
            else:
                kind = "ok"
                if len(dec.args) > 1 and \
                        isinstance(dec.args[1], ast.Constant):
                    kind = str(dec.args[1].value)
                for kw in dec.keywords:
                    if kw.arg == "kind" and \
                            isinstance(kw.value, ast.Constant):
                        kind = str(kw.value.value)
                regs.append((resource, node.name,
                             "loss" if kind == "loss" else "settle"))
    return regs


def _collect_productions(tree: ast.Module) -> Set[str]:
    """Counter names this module *produces*: ``.inc("x")``,
    ``.add(x=...)``, ``c["x"] = v``. ``update({...})`` and constructor
    kwargs are initialisation, not production."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = node.func.attr \
                if isinstance(node.func, ast.Attribute) else ""
            if name == "inc" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                out.add(node.args[0].value)
            elif name == "add":
                for kw in node.keywords:
                    if kw.arg:
                        out.add(kw.arg)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        isinstance(tgt.slice, ast.Constant) and \
                        isinstance(tgt.slice.value, str):
                    out.add(tgt.slice.value)
    return out


def _collect_identities(tree: ast.Module, label: str) -> List[Identity]:
    out: List[Identity] = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "FLOW_IDENTITY" and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            ident = parse_identity_expr(node.value.value, label,
                                        node.lineno)
            if ident is not None:
                out.append(ident)
    return out


def _effective_specs(regs: List[Tuple[str, str, str]]
                     ) -> Tuple[ResourceSpec, ...]:
    """Union decorator-registered method names into the seeded specs;
    resource names the registry doesn't know become new any-receiver
    specs (the fixture-corpus mechanism)."""
    by_name = {s.name: s for s in SPECS}
    extra: Dict[str, Dict[str, Set[str]]] = {}
    for resource, meth, role in regs:
        slot = extra.setdefault(resource, {"acquire": set(),
                                           "settle": set(),
                                           "loss": set()})
        slot[role].add(meth)
    out: List[ResourceSpec] = []
    for spec in SPECS:
        e = extra.pop(spec.name, None)
        if e:
            spec = replace(
                spec,
                acquire_attrs=spec.acquire_attrs | frozenset(e["acquire"]),
                settle_attrs=spec.settle_attrs | frozenset(e["settle"]),
                loss_settle_attrs=(spec.loss_settle_attrs
                                   | frozenset(e["loss"])))
        out.append(spec)
    for resource, e in sorted(extra.items()):
        out.append(ResourceSpec(
            name=resource,
            acquire_attrs=frozenset(e["acquire"]),
            settle_attrs=frozenset(e["settle"]),
            loss_settle_attrs=frozenset(e["loss"]),
            loss_counters=DEFAULT_LOSS_COUNTERS,
            receiver_re=r".*",
            doc="declared via @flow.acquires/@flow.settles"))
    return tuple(out)


# -- phase 2 driver --------------------------------------------------------

def _scan_functions(model: FlowModel, facts: _FileFacts,
                    specs: Sequence[ResourceSpec]) -> None:
    def run(fn: ast.AST, qual: str) -> None:
        _FunctionAnalyzer(model, facts.label, qual, specs,
                          facts.owns).run(fn)

    for node in facts.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            run(node, node.name)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    run(item, f"{node.name}.{item.name}")


def scan_paths(paths: Sequence[str]) -> FlowModel:
    """Parse every ``.py`` under the given files/directories and run
    both phases. Unparseable files are skipped."""
    model = FlowModel()
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)

    parsed: List[_FileFacts] = []
    regs: List[Tuple[str, str, str]] = []
    seen: Set[Path] = set()
    for path in files:
        rp = path.resolve()
        if rp in seen:
            continue
        seen.add(rp)
        try:
            source = path.read_text(encoding="utf-8")
            tree = ast.parse(source)
        except (OSError, SyntaxError, UnicodeDecodeError):
            continue
        label = str(path)
        model.num_files += 1
        model.files.append(label)
        facts = _FileFacts(label=label, tree=tree)
        pragma_table: Dict[int, str] = {}
        for n, line in enumerate(source.splitlines(), 1):
            m = PRAGMA_RE.search(line)
            if m:
                pragma_table[n] = m.group(1).strip() or "unspecified"
            m = OWNS_RE.search(line)
            if m:
                facts.owns[n] = m.group(1).strip()
        if pragma_table:
            model.pragmas[label] = pragma_table
        regs += _collect_decorations(tree)
        model.productions[label] = _collect_productions(tree)
        model.module_identities += _collect_identities(tree, label)
        parsed.append(facts)

    model.specs = _effective_specs(regs)
    for facts in parsed:
        _scan_functions(model, facts, model.specs)
    return model
