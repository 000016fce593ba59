"""AST scan + thread-role model for racecheck.

This module turns Python sources into the facts the passes consume —
no code is ever executed:

* per class: methods, base classes, attribute type assignments
  (``self.x = ClassName(...)``), safe-typed attributes (locks, queues,
  events, Counters — objects that synchronize internally);
* per method: ``self`` attribute accesses (read / plain store /
  read-modify-write) each annotated with the locks lexically held,
  nested ``with self._lock`` acquisitions, ``self.*()`` calls,
  ``threading.Thread/Timer`` spawn targets, and potentially blocking
  calls with the locks held at the call site;
* foreign accesses: ``x.attr`` reads of PUBLIC attributes of other
  objects (how ``Pipeline.stats()`` reading every element's counters
  contributes the user-thread role to each element's lockset).

Thread roles
------------
Each method of each class is classified by the thread(s) that execute
it. Roles are seeded at known entry points (``Element.chain``,
``SrcElement._loop``, the fault supervisor, watchdog/timer callbacks,
scheduler flush workers, network reader loops — plus any method passed
as ``threading.Thread(target=self.m)``) and propagated to callees
through intra-class ``self.*()`` calls to a fixpoint. A method with no
role after propagation defaults to ``api`` (the user thread). Lifecycle
methods (``__init__``/``start``/``stop``/...) carry the quiescent
``init`` pseudo-role: ``Pipeline.start()`` orders them strictly
before/after the streaming threads, so their accesses cannot race and
the role is dropped when locksets are evaluated.

The port keeps the JAX package's seeds: every class they name exists in
the port under the same name. Its own threads need none added. The mesh
world's follower reader ``World._watch`` takes the timer role from its
spawn target's name, the query client's ``_recv_loop`` the net-reader
role, and a follower (``_Follower.serve``) is the main thread of a
process of its own, which shares no object with another thread.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

PRAGMA_RE = re.compile(r"#\s*racecheck:\s*ok\(([^)]*)\)")

# -- thread roles ----------------------------------------------------------
API = "api"                  # the user thread (default)
CHAIN = "chain"              # buffer chain path (possibly fan-in)
SOURCE = "source-loop"       # supervised src streaming thread
TIMER = "timer"              # watchdog / breaker half-open timers
NET = "net-reader"           # accept loops + per-client reader threads
WORKER = "worker"            # scheduler/batcher flush threads
DISPATCHER = "dispatcher"    # overlap window: chain-side frame dispatch
COMPLETER = "completer"      # overlap window: per-element completer
UPLOADER = "uploader"        # coalescing H2D upload service thread
SCRAPER = "scraper"          # obs metrics endpoint serve/handle threads
INIT = "init"                # quiescent lifecycle (dropped in locksets)

# (ancestor class, method name) -> role: known entry points. Applied to
# every class that inherits the method.
DEFAULT_SEEDS: List[Tuple[str, str, str]] = [
    ("Element", "chain", CHAIN),
    ("Element", "handle_event", CHAIN),
    ("Element", "handle_upstream_event", CHAIN),
    ("SrcElement", "_loop", SOURCE),
    ("Supervisor", "run", SOURCE),
    ("Supervisor", "handle", SOURCE),
    ("Supervisor", "ok", SOURCE),
    ("Watchdog", "_loop", TIMER),
    ("TensorFilter", "_on_idle", TIMER),
    # async overlapped executor (elements/overlap.py): the chain thread
    # dispatches into the window, a dedicated thread completes frames
    ("OverlapExecutor", "submit", DISPATCHER),
    ("OverlapExecutor", "_complete_loop", COMPLETER),
    ("TensorFilter", "_complete_frame", COMPLETER),
    ("TensorFilter", "_complete_error", COMPLETER),
    ("FusedSegment", "_complete_frame", COMPLETER),
    ("FusedSegment", "_complete_error", COMPLETER),
    # bidirectional transfer service (tensors/transfer.py)
    ("_Uploader", "_run", UPLOADER),
    # obs telemetry plane (obs/server.py): the pull endpoint's accept
    # loop + per-request handlers run off the pipeline threads entirely
    ("MetricsServer", "_serve_loop", SCRAPER),
    ("MetricsServer", "_handle", SCRAPER),
]

# methods whose accesses are ordered by the pipeline lifecycle
# (Pipeline.start()/stop() run them strictly before/after streaming;
# "create" is the framework-subplugin open hook — the SrcElement
# per-buffer create() keeps its source-loop role through propagation)
LIFECYCLE = {"__init__", "start", "stop", "close", "destroy", "open",
             "shutdown", "create", "__del__"}

# attribute types that synchronize internally — accesses are skipped
SAFE_TYPES = {"Lock", "RLock", "Condition", "Event", "Semaphore",
              "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
              "LifoQueue", "PriorityQueue", "local", "Counters"}

# method names that mutate their receiver (list/dict/set/deque/Counters)
MUTATORS = {"append", "appendleft", "extend", "insert", "remove", "pop",
            "popleft", "clear", "add", "discard", "update", "setdefault",
            "inc"}


def _dotted_self_attr(node: ast.AST) -> Optional[str]:
    """``self.a`` -> "a", ``self.a.b`` -> "a.b", else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self":
        return ".".join(reversed(parts)) or None
    return None


def _call_name(func: ast.AST) -> str:
    """Trailing name of a call target: ``time.sleep`` -> "sleep"."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


@dataclass
class Access:
    attr: str
    kind: str                      # "read" | "store" | "rmw"
    lineno: int
    locks: FrozenSet[str]          # self locks lexically held
    method: str

    @property
    def is_write(self) -> bool:
        return self.kind != "read"


@dataclass
class Acquire:
    lock: str                      # "a" or "a.b" (self-attr chain)
    lineno: int
    held: Tuple[str, ...]          # self locks already held at this site


@dataclass
class BlockingCall:
    what: str                      # e.g. "time.sleep", ".recv()"
    rule: str                      # sleep-under-lock | blocking-under-lock
    lineno: int
    locks: FrozenSet[str]


@dataclass
class CallSite:
    callee: str                    # method name for self.m(...)
    attr: Optional[str]            # attr name for self.attr.m(...)
    lineno: int
    locks: FrozenSet[str]


@dataclass
class ForeignAccess:
    attr: str
    kind: str                      # "read" | "store"
    lineno: int
    file: str
    cls: Optional[str]             # class of the accessing method
    method: str


@dataclass
class MethodInfo:
    name: str
    lineno: int
    cls_name: str
    file: str
    accesses: List[Access] = field(default_factory=list)
    acquisitions: List[Acquire] = field(default_factory=list)
    blocking: List[BlockingCall] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    spawn_targets: Set[str] = field(default_factory=set)
    timer_targets: Set[str] = field(default_factory=set)


@dataclass
class ClassInfo:
    name: str
    file: str
    lineno: int
    bases: List[str]
    methods: Dict[str, MethodInfo] = field(default_factory=dict)
    attr_types: Dict[str, str] = field(default_factory=dict)


@dataclass
class Model:
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    foreign: List[ForeignAccess] = field(default_factory=list)
    # module-level functions get blocking analysis too
    functions: List[MethodInfo] = field(default_factory=list)
    pragmas: Dict[str, Dict[int, str]] = field(default_factory=dict)
    num_files: int = 0

    # -- hierarchy helpers -------------------------------------------------
    def ancestry(self, cls_name: str) -> List[str]:
        """cls_name + transitive base names resolvable in the model."""
        out, todo, seen = [], [cls_name], set()
        while todo:
            name = todo.pop(0)
            if name in seen:
                continue
            seen.add(name)
            out.append(name)
            info = self.classes.get(name)
            if info:
                todo.extend(info.bases)
        return out

    def effective_methods(self, cls_name: str) -> Dict[str, MethodInfo]:
        """name -> nearest definition walking the (name-resolved) MRO."""
        eff: Dict[str, MethodInfo] = {}
        for name in self.ancestry(cls_name):
            info = self.classes.get(name)
            if not info:
                continue
            for mname, m in info.methods.items():
                eff.setdefault(mname, m)
        return eff

    def effective_attr_types(self, cls_name: str) -> Dict[str, str]:
        types: Dict[str, str] = {}
        for name in self.ancestry(cls_name):
            info = self.classes.get(name)
            if not info:
                continue
            for attr, t in info.attr_types.items():
                types.setdefault(attr, t)
        return types

    def pragma_reason(self, file: str, lineno: int) -> Optional[str]:
        """``# racecheck: ok(reason)`` on the line or the line above."""
        table = self.pragmas.get(file, {})
        for ln in (lineno, lineno - 1):
            if ln in table:
                return table[ln]
        return None


class _MethodVisitor(ast.NodeVisitor):
    """Collects one method's facts, tracking the lexical with-lock stack.

    Only ``with self.<attr-chain>:`` items count as lock acquisitions —
    a with on a local variable can't be named in the class-level lock
    graph and is ignored (documented limitation)."""

    def __init__(self, info: MethodInfo):
        self.info = info
        self.stack: List[str] = []

    # -- helpers -----------------------------------------------------------
    def _locks(self) -> FrozenSet[str]:
        return frozenset(self.stack)

    def _record_access(self, attr: str, kind: str, lineno: int) -> None:
        self.info.accesses.append(Access(
            attr=attr, kind=kind, lineno=lineno, locks=self._locks(),
            method=self.info.name))

    def _record_foreign(self, model_sink: List[ForeignAccess],
                        attr: str, kind: str, lineno: int) -> None:
        pass  # foreign accesses are collected by the module visitor

    # -- with: lock acquisition --------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            lock = _dotted_self_attr(item.context_expr)
            if lock is not None:
                self.info.acquisitions.append(Acquire(
                    lock=lock, lineno=item.context_expr.lineno,
                    held=tuple(self.stack)))
                self.stack.append(lock)
                acquired.append(lock)
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.stack.pop()

    # -- assignments -------------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._visit_store_target(tgt)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._visit_store_target(node.target)
        if node.value is not None:
            self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        tgt = node.target
        attr = _dotted_self_attr(tgt) if isinstance(tgt, ast.Attribute) \
            else None
        if attr is not None:
            kind = "rmw" if "." not in attr else "read"
            self._record_access(attr.split(".")[0], kind, tgt.lineno)
        elif isinstance(tgt, ast.Subscript):
            inner = _dotted_self_attr(tgt.value)
            if inner is not None:
                # self.d[k] += 1: read-modify-write of the container;
                # self.a.b[k] += 1 mutates the FOREIGN object b, which
                # is only a read of our own attribute a
                kind = "rmw" if "." not in inner else "read"
                self._record_access(inner.split(".")[0], kind,
                                    tgt.lineno)
            else:
                self.visit(tgt.value)
            self.visit(tgt.slice)
        else:
            self.visit(tgt)
        self.visit(node.value)

    def _visit_store_target(self, tgt: ast.AST) -> None:
        if isinstance(tgt, ast.Attribute):
            attr = _dotted_self_attr(tgt)
            if attr is not None:
                kind = "store" if "." not in attr else "read"
                self._record_access(attr.split(".")[0], kind,
                                    tgt.lineno)
                return
        if isinstance(tgt, ast.Subscript):
            inner = _dotted_self_attr(tgt.value)
            if inner is not None:
                # self.d[k] = v mutates the container in place; on a
                # deeper chain the mutated object belongs elsewhere
                kind = "rmw" if "." not in inner else "read"
                self._record_access(inner.split(".")[0], kind,
                                    tgt.lineno)
                self.visit(tgt.slice)
                return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._visit_store_target(elt)
            return
        self.visit(tgt)

    # -- calls -------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        handled_receiver = False
        if isinstance(func, ast.Attribute):
            recv = _dotted_self_attr(func.value)
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                # self.m(...): intra-class call
                self.info.calls.append(CallSite(
                    callee=func.attr, attr=None, lineno=node.lineno,
                    locks=self._locks()))
                handled_receiver = True
            elif recv is not None:
                # self.attr.m(...): cross-object call; a mutator method
                # is a write of the container attribute (but mutating
                # self.a.b mutates the foreign object b, which only
                # READS our own attribute a)
                base = recv.split(".")[0]
                kind = "rmw" if (func.attr in MUTATORS
                                 and "." not in recv) else "read"
                self._record_access(base, kind, node.lineno)
                self.info.calls.append(CallSite(
                    callee=func.attr, attr=recv, lineno=node.lineno,
                    locks=self._locks()))
                handled_receiver = True
        self._check_spawn(node)
        self._check_blocking(node)
        if not handled_receiver:
            self.visit(func)
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)

    def _check_spawn(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        if name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    tgt = _dotted_self_attr(kw.value)
                    if tgt:
                        self.info.spawn_targets.add(tgt.split(".")[0])
        elif name == "Timer":
            for arg in list(node.args) + [kw.value for kw in node.keywords
                                          if kw.arg == "function"]:
                tgt = _dotted_self_attr(arg)
                if tgt:
                    self.info.timer_targets.add(tgt.split(".")[0])

    def _check_blocking(self, node: ast.Call) -> None:
        if not self.stack:
            return
        func = node.func
        name = _call_name(func)
        kwargs = {kw.arg for kw in node.keywords}
        lineno = node.lineno
        locks = self._locks()

        def hit(what: str, rule: str) -> None:
            self.info.blocking.append(BlockingCall(
                what=what, rule=rule, lineno=lineno, locks=locks))

        if name == "sleep":
            hit("sleep()", "sleep-under-lock")
        elif name in ("recv", "recv_msg", "accept", "connect",
                      "create_connection"):
            hit(f"{name}()", "blocking-under-lock")
        elif name == "get" and not node.args and "timeout" not in kwargs:
            # zero-arg .get(): queue.Queue.get() blocks forever;
            # dict.get(k) always has a positional arg and never matches
            hit(".get() without timeout", "blocking-under-lock")
        elif name == "join" and not node.args:
            # zero-arg .join(): Thread.join() blocks; str.join(seq)
            # always has an argument and never matches
            hit(".join()", "blocking-under-lock")
        elif name == "invoke":
            hit("model invoke()", "blocking-under-lock")
        elif name == "wait" and "timeout" not in kwargs and not node.args:
            # cond.wait() RELEASES the condition it is called on — only
            # flag when some OTHER lock stays held while blocked
            recv = _dotted_self_attr(func.value) \
                if isinstance(func, ast.Attribute) else None
            others = [l for l in self.stack if l != recv]
            if others:
                hit(".wait() without timeout", "blocking-under-lock")


class _ModuleVisitor:
    """Walks one module: classes, their methods, module functions, and
    foreign public-attribute accesses anywhere in the file."""

    def __init__(self, model: Model, file: str):
        self.model = model
        self.file = file

    def scan(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._scan_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(node, cls=None)
        self._scan_foreign(tree)

    def _scan_class(self, node: ast.ClassDef) -> None:
        bases = []
        for b in node.bases:
            if isinstance(b, ast.Name):
                bases.append(b.id)
            elif isinstance(b, ast.Attribute):
                bases.append(b.attr)
        info = ClassInfo(name=node.name, file=self.file,
                         lineno=node.lineno, bases=bases)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                minfo = MethodInfo(name=item.name, lineno=item.lineno,
                                   cls_name=node.name, file=self.file)
                visitor = _MethodVisitor(minfo)
                for stmt in item.body:
                    visitor.visit(stmt)
                info.methods[item.name] = minfo
                self._collect_attr_types(item, info)
        # first definition wins on a (rare) cross-module name collision
        self.model.classes.setdefault(node.name, info)

    def _scan_function(self, node: ast.FunctionDef,
                       cls: Optional[str]) -> None:
        minfo = MethodInfo(name=node.name, lineno=node.lineno,
                           cls_name=cls or "<module>", file=self.file)
        visitor = _MethodVisitor(minfo)
        for stmt in node.body:
            visitor.visit(stmt)
        self.model.functions.append(minfo)

    def _collect_attr_types(self, fn: ast.FunctionDef,
                            info: ClassInfo) -> None:
        """``self.x = ClassName(...)`` anywhere in the method body."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            tname = _call_name(node.value.func)
            if not tname:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute):
                    attr = _dotted_self_attr(tgt)
                    if attr and "." not in attr:
                        info.attr_types.setdefault(attr, tname)

    def _scan_foreign(self, tree: ast.Module) -> None:
        """Reads of PUBLIC attributes on non-self receivers, with the
        class+method context they occur in. Private attributes are
        skipped (cross-object private access is its own smell, but it
        cannot be bound to an owner by name alone), and so are
        receivers that name an import (``np.stack`` is a module
        function, not somebody's ``stack`` attribute)."""
        imported: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imported.add(alias.asname or alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    imported.add(alias.asname or alias.name)

        def walk(node: ast.AST, cls: Optional[str], meth: str) -> None:
            if isinstance(node, ast.ClassDef):
                for child in node.body:
                    walk(child, node.name, meth)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for child in node.body:
                    walk(child, cls, node.name)
                return
            if isinstance(node, ast.Attribute):
                base_is_self = (isinstance(node.value, ast.Name)
                                and node.value.id == "self")
                if (not base_is_self and not node.attr.startswith("_")
                        and isinstance(node.value, ast.Name)
                        and node.value.id not in imported):
                    kind = "store" if isinstance(node.ctx, ast.Store) \
                        else "read"
                    self.model.foreign.append(ForeignAccess(
                        attr=node.attr, kind=kind, lineno=node.lineno,
                        file=self.file, cls=cls, method=meth))
            for child in ast.iter_child_nodes(node):
                walk(child, cls, meth)

        for node in tree.body:
            walk(node, None, "<module>")


def scan_paths(paths: Sequence[str]) -> Model:
    """Parse every ``.py`` under the given files/directories into one
    Model. Unparseable files are skipped (they are compileall's problem,
    not racecheck's)."""
    model = Model()
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
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
        table: Dict[int, str] = {}
        for n, line in enumerate(source.splitlines(), 1):
            m = PRAGMA_RE.search(line)
            if m:
                table[n] = m.group(1).strip() or "unspecified"
        if table:
            model.pragmas[label] = table
        _ModuleVisitor(model, label).scan(tree)
    return model


# -- thread-role computation ----------------------------------------------

def _spawn_role(target: str, model: Model, cls_name: str) -> str:
    n = target.lower()
    if any(k in n for k in ("accept", "client", "recv", "listen",
                            "reader", "sub")):
        return NET
    if any(k in n for k in ("watch", "timer", "idle")):
        return TIMER
    # before the generic loop/stream bucket: _complete_loop is the
    # overlap completer, _run on an uploader is the H2D service
    if "complete" in n:
        return COMPLETER
    if "upload" in n:
        return UPLOADER
    if "loop" in n or "stream" in n:
        if "SrcElement" in model.ancestry(cls_name):
            return SOURCE
        return WORKER
    return WORKER


def roles_of(
    model: Model,
    cls_name: str,
    extra_seeds: Optional[List[Tuple[str, str, str]]] = None,
) -> Dict[str, Set[str]]:
    """method name -> roles, for the class viewed as concrete (its own
    + inherited methods resolved nearest-definition-first).

    ``extra_seeds`` lets sibling analyzers (jitcheck) graft additional
    (ancestor, method, role) entry points onto the same propagation
    without disturbing racecheck's defaults."""
    eff = model.effective_methods(cls_name)
    roles: Dict[str, Set[str]] = {name: set() for name in eff}
    ancestry = set(model.ancestry(cls_name))

    seeds = DEFAULT_SEEDS if not extra_seeds else DEFAULT_SEEDS + extra_seeds
    for base, meth, role in seeds:
        if base in ancestry and meth in roles:
            roles[meth].add(role)
    for name in roles:
        if name in LIFECYCLE:
            roles[name].add(INIT)
    for m in eff.values():
        for tgt in m.spawn_targets:
            if tgt in roles:
                roles[tgt].add(_spawn_role(tgt, model, cls_name))
        for tgt in m.timer_targets:
            if tgt in roles:
                roles[tgt].add(TIMER)

    changed = True
    while changed:
        changed = False
        for name, m in eff.items():
            mine = roles[name]
            if not mine:
                continue
            for call in m.calls:
                if call.attr is None and call.callee in roles:
                    before = len(roles[call.callee])
                    roles[call.callee] |= mine
                    if len(roles[call.callee]) != before:
                        changed = True

    for name in roles:
        if not roles[name]:
            roles[name] = {API}
    return roles


def live_roles(roles: Set[str]) -> Set[str]:
    """Roles that can actually race: the quiescent INIT role is dropped
    (lifecycle ordering, not locking, serializes those accesses)."""
    return {r for r in roles if r != INIT}
