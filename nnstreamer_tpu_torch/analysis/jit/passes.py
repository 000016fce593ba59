"""jitcheck analysis passes, over PyTorch and CUDA graphs.

The counterpart of ``nnstreamer_tpu/analysis/jit/passes.py``: one
intra-procedural walker per analyzable body, two modes.

hot bodies (chain / source-loop / dispatcher / completer / worker /
uploader roles) get the *host-boundary* rules — a device-taint lattice
(none < seq-of-tensors < tensor) seeded from ``.raw`` reads, torch ops
on a tainted input or with a ``device=``, framework invoke/dispatch
results, ``.cuda()``/``.to(device)`` and declared device params,
sanitized only by the port's host boundary (``Chunk.host()``,
``fetch_host``, ``PendingHost.resolve()``):

* host-sync-in-hot-path — ``float()/int()/bool()``, ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``np.*`` on a
  device value, implicit truthiness of a device tensor;
  ``torch.cuda.synchronize()`` and ``Event``/``Stream.synchronize()``
  outside the completer role or while holding a lock.
* retrace-hazard — a capture (``Executable``, ``CUDAGraph``,
  ``torch.compile``, ...) constructed per call or inside a loop; a
  capture cache subscripted with an unhashable or per-call key;
  ``*set(...)`` feeding a compiled callable's signature.
* donation-misuse — any read of a name after it was passed to a
  donating dispatch (``donate=True``) without rebinding.

compiled bodies (functions handed to a capture, ``device_fn`` inner
programs, ``@torch.compile`` functions — every param is a captured
tensor) get the *device-program* rules:

* impure-device-fn — writes to captured/self state, Counters bumps,
  I/O, host randomness or clocks, host conversion of a captured value,
  a synchronize: each runs once at capture and never at replay.
* retrace-hazard — data-dependent or shape-dependent Python control
  flow (the capture bakes one branch in / each shape captures its own
  graph).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from .findings import (DONATION_MISUSE, HOST_SYNC, IMPURE_DEVICE_FN,
                       RETRACE, VACUOUS_COVERAGE, JitFinding, JitReport)
from .model import (COMPLETER, DEVICE_PRODUCERS, META_ATTRS, META_CALLS,
                    SANITIZERS, SYNC_METHODS, FuncUnit, JitModel,
                    capture_call_of, scan_paths)

# taint lattice
NONE, SEQ, ARRAY = 0, 1, 2

NP_ROOTS = frozenset({"np", "numpy"})
# torch op namespaces: their result lives where their inputs live
TORCH_ROOTS = frozenset({"torch", "F"})
SEQ_BUILTINS = frozenset({"list", "tuple", "sorted", "reversed", "zip",
                          "enumerate"})
SCALAR_CASTS = frozenset({"float", "int", "bool"})
MUTATORS = frozenset({"append", "extend", "add", "inc", "insert",
                      "setdefault", "pop", "popleft", "remove",
                      "clear", "write", "put", "observe"})
IO_ROOTS = frozenset({"print", "open", "logger", "logging", "log"})
HOST_ENTROPY_ROOTS = frozenset({"random", "time"})
# keys that differ on every call: a cache keyed by one never hits
VOLATILE_KEYS = frozenset({"id", "data_ptr", "time", "monotonic",
                           "perf_counter", "perf_counter_ns", "time_ns",
                           "object", "uuid4"})


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = getattr(node, "value", None) or getattr(node, "func", None)
        if node is None:
            return None
    return node.id if isinstance(node, ast.Name) else None


def _trailing(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"``, ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    if isinstance(node, ast.Call) and _trailing(node.func) == "device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _is_dtype(node: ast.AST) -> bool:
    """``torch.float32``-style arguments: a dtype, not a device."""
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "torch" and node.attr != "device")


def _emit(report: JitReport, model: JitModel, finding: JitFinding) -> None:
    if model.pragma_reason(finding.file, finding.line):
        report.suppressed.append(finding)
    else:
        report.findings.append(finding)


class _BodyWalker:
    """Statement-ordered walk of one body, carrying the taint
    environment, the donated-name set, and the lexical lock stack."""

    def __init__(self, model: JitModel, report: JitReport,
                 unit: FuncUnit) -> None:
        self.model = model
        self.report = report
        self.unit = unit
        self.env: Dict[str, int] = {}
        self.donated: Dict[str, int] = {}
        self.locks: List[str] = []
        self.locals: Set[str] = set()
        node = unit.node
        args = node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + [x for x in (args.vararg, args.kwarg) if x]):
            self.locals.add(a.arg)
            if unit.compiled and a.arg != "self":
                self.env[a.arg] = ARRAY          # captured tensors
            elif a.arg in unit.tainted_params:
                self.env[a.arg] = ARRAY
        # prepass: every name ever stored is local (not captured state)
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                self.locals.add(n.id)

    # -- emission -----------------------------------------------------
    def finding(self, rule: str, node: ast.AST, message: str) -> None:
        _emit(self.report, self.model, JitFinding(
            rule=rule, file=self.unit.file,
            line=getattr(node, "lineno", 0), message=message,
            cls=self.unit.cls, func=self.unit.name,
            roles=tuple(sorted(self.unit.roles))))

    def sync(self, node: ast.AST, message: str) -> None:
        """host-boundary violation: host-sync in a hot body, impurity
        in a captured one (there it runs at capture only)."""
        if self.unit.compiled:
            self.finding(IMPURE_DEVICE_FN, node,
                         message.replace("on the hot path",
                                         "inside captured code"))
        else:
            self.finding(HOST_SYNC, node, message)

    # -- environment --------------------------------------------------
    def bind(self, target: ast.AST, taint: int) -> None:
        if isinstance(target, ast.Name):
            if taint:
                self.env[target.id] = taint
            else:
                self.env.pop(target.id, None)
            self.donated.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.bind(elt, ARRAY if taint else NONE)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, SEQ if taint else NONE)
        # attribute/subscript stores don't enter the local env

    # -- statements ---------------------------------------------------
    def run(self) -> None:
        self.block(self.unit.node.body)

    def block(self, stmts: Sequence[ast.stmt]) -> None:
        for s in stmts:
            self.stmt(s)

    def stmt(self, s: ast.stmt) -> None:       # noqa: C901
        if isinstance(s, ast.Assign):
            t = self.expr(s.value)
            for tgt in s.targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    self.impure_store(tgt)
                    if isinstance(tgt, ast.Subscript):
                        self.cache_key(tgt.value, tgt.slice)
                self.bind(tgt, t)
        elif isinstance(s, ast.AnnAssign):
            t = self.expr(s.value) if s.value else NONE
            if isinstance(s.target, (ast.Attribute, ast.Subscript)):
                self.impure_store(s.target)
            self.bind(s.target, t)
        elif isinstance(s, ast.AugAssign):
            t = self.expr(s.value)
            if isinstance(s.target, (ast.Attribute, ast.Subscript)):
                self.impure_store(s.target)
            elif isinstance(s.target, ast.Name):
                prev = self.env.get(s.target.id, NONE)
                self.bind(s.target, max(t, prev))
        elif isinstance(s, ast.Expr):
            self.expr(s.value)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self.expr(s.value)
        elif isinstance(s, ast.If):
            self.test(s.test)
            self.branches([s.body, s.orelse])
        elif isinstance(s, ast.While):
            self.test(s.test)
            self.loop_scan(s)
            self.branches([s.body, []])       # body may run zero times
            self.block(s.orelse)
        elif isinstance(s, ast.For):
            it = self.expr(s.iter)
            self.loop_scan(s)
            pre = (dict(self.env), dict(self.donated))
            self.bind(s.target, ARRAY if it else NONE)
            self.block(s.body)
            self.merge(*pre)                  # zero-iteration path
            self.block(s.orelse)
        elif isinstance(s, ast.With):
            held = []
            for item in s.items:
                lock = self._lock_name(item.context_expr)
                if lock is not None:
                    held.append(lock)
                else:
                    t = self.expr(item.context_expr)
                    if item.optional_vars is not None:
                        self.bind(item.optional_vars, t)
            self.locks.extend(held)
            self.block(s.body)
            for _ in held:
                self.locks.pop()
        elif isinstance(s, ast.Try):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
        elif isinstance(s, ast.Assert):
            self.test(s.test)
        elif isinstance(s, (ast.Global, ast.Nonlocal)):
            if self.unit.compiled:
                self.finding(IMPURE_DEVICE_FN, s,
                             f"{'global' if isinstance(s, ast.Global) else 'nonlocal'} "
                             "rebinding inside captured code — captured "
                             "functions must be pure")
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            pass          # inner defs are separate units (if compiled)
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self.expr(s.exc)
        elif isinstance(s, ast.Delete):
            for tgt in s.targets:
                if isinstance(tgt, ast.Name):
                    self.env.pop(tgt.id, None)
                    self.donated.pop(tgt.id, None)
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self.expr(child)

    def branches(self, blocks: Sequence[Sequence[ast.stmt]]) -> None:
        """Path-sensitive join: run each block from a copy of the
        pre-state, then merge the post-states (max taint, union of
        donations) — a reassignment in one branch must not leak taint
        into its sibling."""
        pre_env, pre_don = dict(self.env), dict(self.donated)
        posts = []
        for b in blocks:
            self.env, self.donated = dict(pre_env), dict(pre_don)
            self.block(b)
            posts.append((self.env, self.donated))
        self.env, self.donated = {}, {}
        for env, don in posts:
            self.merge(env, don)

    def merge(self, env: Dict[str, int], don: Dict[str, int]) -> None:
        for k, v in env.items():
            self.env[k] = max(self.env.get(k, NONE), v)
        for k, v in don.items():
            self.donated.setdefault(k, v)

    def _lock_name(self, expr: ast.AST) -> Optional[str]:
        """with self._lock: / with self._cv: — mirrors racecheck's
        lexical lock model (only self-attribute context managers whose
        name smells like a lock are treated as one)."""
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and any(k in expr.attr for k in ("lock", "cv", "cond",
                                                 "mutex"))):
            return expr.attr
        return None

    def impure_store(self, target: ast.AST) -> None:
        if not self.unit.compiled:
            return
        root = _root_name(target)
        if root == "self" or (root is not None
                              and root not in self.locals):
            self.finding(IMPURE_DEVICE_FN, target,
                         "write to captured state inside captured code "
                         "— the effect runs once at capture time, then "
                         "never again at replay")

    def loop_scan(self, loop: ast.stmt) -> None:
        """A capture constructed inside a hot loop captures (or
        compiles) per iteration: each construction is a fresh graph."""
        if self.unit.compiled or not self.unit.hot:
            return
        for n in ast.walk(loop):
            if capture_call_of(n) is not None:
                self.finding(RETRACE, n,
                             "capture constructed inside a loop — each "
                             "construction captures a fresh graph; "
                             "hoist it and replay the one capture")

    def cache_key(self, container: ast.AST, key: ast.AST) -> None:
        """A capture cache subscripted (or ``get``/``setdefault``/``pop``
        called) with a key that cannot hit: an unhashable literal, or a
        value that differs on every call."""
        name = None
        if isinstance(container, ast.Name):
            name = container.id
        elif (isinstance(container, ast.Attribute)
              and isinstance(container.value, ast.Name)
              and container.value.id == "self"):
            name = f"self.{container.attr}"
        if name is None:
            return
        qual = f"{self.unit.cls}.{name}" if self.unit.cls else name
        if not (self.model.is_cache(self.unit.file, qual)
                or self.model.is_cache(self.unit.file, name)):
            return
        if isinstance(key, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                            ast.DictComp, ast.SetComp)):
            self.finding(RETRACE, key,
                         f"non-hashable key into the capture cache "
                         f"'{name}' — a cache key must hash stably; "
                         "use a tuple")
        elif (isinstance(key, ast.Call)
              and _trailing(key.func) in VOLATILE_KEYS):
            self.finding(RETRACE, key,
                         f"per-call key ({_trailing(key.func)}()) into the "
                         f"capture cache '{name}' — it never hits, so "
                         "every call captures a fresh graph")

    # -- truthiness contexts ------------------------------------------
    def test(self, e: ast.expr) -> None:
        if isinstance(e, ast.BoolOp):
            for v in e.values:
                self.test(v)
            return
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not):
            self.test(e.operand)
            return
        t = self.expr(e)
        if t == ARRAY:
            if self.unit.compiled:
                self.finding(RETRACE, e,
                             "data-dependent Python control flow on a "
                             "captured value — the capture bakes in one "
                             "branch (and reading the value syncs); use "
                             "torch.where")
            else:
                self.sync(e, "implicit bool() of a device tensor blocks "
                             "on the device — compare on host "
                             "metadata or materialize via .host()")
        if self.unit.compiled:
            self._shape_branch(e)

    def _shape_branch(self, e: ast.expr) -> None:
        for n in ast.walk(e):
            hit = None
            if (isinstance(n, ast.Attribute) and n.attr == "shape"
                    and self.expr_quiet(n.value) == ARRAY):
                hit = n
            elif (isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr in ("size", "dim", "numel")
                  and self.expr_quiet(n.func.value) == ARRAY):
                hit = n
            elif (isinstance(n, ast.Call) and _trailing(n.func) == "len"
                    and n.args and self.expr_quiet(n.args[0]) >= SEQ):
                hit = n
            if hit is not None:
                self.finding(RETRACE, hit,
                             "shape-dependent Python control flow "
                             "inside captured code — every distinct "
                             "shape captures its own graph")
                return

    # -- expressions --------------------------------------------------
    def expr_quiet(self, e: ast.expr) -> int:
        """taint of ``e`` without re-emitting findings (used by
        secondary scans over subtrees the main walk already visited)."""
        save_r, save_s = self.report.findings, self.report.suppressed
        self.report.findings, self.report.suppressed = [], []
        save_d = dict(self.donated)
        try:
            return self.expr(e)
        finally:
            self.report.findings, self.report.suppressed = save_r, save_s
            self.donated = save_d

    def expr(self, e: ast.expr) -> int:        # noqa: C901
        if e is None:
            return NONE
        if isinstance(e, ast.Name):
            if isinstance(e.ctx, ast.Load) and e.id in self.donated:
                dline = self.donated.pop(e.id)
                self.finding(DONATION_MISUSE, e,
                             f"'{e.id}' read after being donated to the "
                             f"device at line {dline} — a donated input "
                             "may be reused for the outputs; copy or "
                             "rebind before dispatch")
            return self.env.get(e.id, NONE)
        if isinstance(e, ast.Attribute):
            if e.attr == "raw":
                return ARRAY                    # Chunk.raw: maybe-device
            base = self.expr(e.value)
            if e.attr in META_ATTRS:
                return NONE
            if base == ARRAY:
                return ARRAY
            return NONE
        if isinstance(e, ast.Subscript):
            base = self.expr(e.value)
            self.expr(e.slice) if isinstance(e.slice, ast.expr) else None
            self.cache_key(e.value, e.slice)
            if base == SEQ:
                return SEQ if isinstance(e.slice, ast.Slice) else ARRAY
            return ARRAY if base == ARRAY else NONE
        if isinstance(e, ast.Call):
            return self.call(e)
        if isinstance(e, ast.BinOp):
            return max(self.expr(e.left), self.expr(e.right))
        if isinstance(e, ast.UnaryOp):
            if isinstance(e.op, ast.Not):
                self.test(e.operand)
                return NONE
            return self.expr(e.operand)
        if isinstance(e, ast.BoolOp):
            self.test(e)
            return NONE
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                self.expr(e.left)
                for c in e.comparators:
                    self.expr(c)
                return NONE
            t = max([self.expr(e.left)]
                    + [self.expr(c) for c in e.comparators])
            return ARRAY if t == ARRAY else NONE
        if isinstance(e, ast.IfExp):
            self.test(e.test)
            return max(self.expr(e.body), self.expr(e.orelse))
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            t = max([self.expr(x) for x in e.elts], default=NONE)
            return SEQ if t else NONE
        if isinstance(e, ast.Dict):
            t = max([self.expr(v) for v in e.values if v is not None],
                    default=NONE)
            for k in e.keys:
                if k is not None:
                    self.expr(k)
            return SEQ if t else NONE
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for gen in e.generators:
                it = self.expr(gen.iter)
                self.bind(gen.target, ARRAY if it else NONE)
                for cond in gen.ifs:
                    self.test(cond)
            t = self.expr(e.elt)
            return SEQ if t else NONE
        if isinstance(e, ast.DictComp):
            for gen in e.generators:
                it = self.expr(gen.iter)
                self.bind(gen.target, ARRAY if it else NONE)
                for cond in gen.ifs:
                    self.test(cond)
            self.expr(e.key)
            t = self.expr(e.value)
            return SEQ if t else NONE
        if isinstance(e, ast.Starred):
            return self.expr(e.value)
        if isinstance(e, ast.Await):
            return self.expr(e.value)
        if isinstance(e, ast.Lambda):
            return NONE                          # opaque; not inlined
        if isinstance(e, ast.JoinedStr):
            for v in e.values:
                if isinstance(v, ast.FormattedValue):
                    self.expr(v.value)
            return NONE
        if isinstance(e, ast.NamedExpr):
            t = self.expr(e.value)
            self.bind(e.target, t)
            return t
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self.expr(child)
        return NONE

    # -- calls --------------------------------------------------------
    def call(self, e: ast.Call) -> int:         # noqa: C901
        trail = _trailing(e.func)
        root = _root_name(e.func)

        # torch.compile(f)(x), Executable(fn, dev)(xs): the capture
        # dies with the expression and is made again on every call
        if isinstance(e.func, ast.Call) \
                and capture_call_of(e.func) is not None:
            if self.unit.hot and not self.unit.compiled:
                self.finding(RETRACE, e,
                             "capture constructed and called in one "
                             "expression — the graph dies with the "
                             "expression and is captured again on every "
                             "call; bind the capture once")
            self.expr(e.func)
            for a in e.args:
                self.expr(a)
            return ARRAY

        recv = (self.expr(e.func.value)
                if isinstance(e.func, ast.Attribute) else NONE)
        if isinstance(e.func, ast.Subscript):
            self.expr(e.func)                    # cache[key](x)
        arg_taints = [self.expr(a.value if isinstance(a, ast.Starred)
                                else a) for a in e.args]
        kw_taints = [self.expr(kw.value) for kw in e.keywords]
        any_taint = max(arg_taints + kw_taints + [NONE])

        if capture_call_of(e) is not None:
            return NONE                          # construction site only

        # sanctioned materialization: Chunk.host(), fetch_host(...)
        if trail in SANITIZERS:
            return NONE
        if trail in META_CALLS and isinstance(e.func, ast.Attribute):
            return NONE

        # -- host-sync family --
        if (isinstance(e.func, ast.Name) and trail in SCALAR_CASTS
                and any(t == ARRAY for t in arg_taints)):
            self.sync(e, f"{trail}() on a device tensor forces a "
                         "blocking D2H sync on the hot path — use "
                         ".host() (Chunk.host, fetch_host) at the "
                         "sanctioned boundary")
            return NONE
        if trail in SYNC_METHODS and recv == ARRAY:
            self.sync(e, f".{trail}() on a device tensor forces a "
                         "blocking D2H sync on the hot path")
            return NONE
        if (trail == "to" and recv == ARRAY
                and (any(_is_cpu(a) for a in e.args)
                     or any(kw.arg == "device" and _is_cpu(kw.value)
                            for kw in e.keywords))):
            self.sync(e, ".to('cpu') on a device tensor forces a "
                         "blocking D2H sync on the hot path")
            return NONE
        if root in NP_ROOTS and any_taint:
            self.sync(e, f"np.{trail}() on a device value forces a D2H "
                         "copy per tensor (or raises on a CUDA tensor) — "
                         "batch it through fetch_host at the boundary")
            return NONE
        if trail == "synchronize":
            if self.unit.compiled:
                self.finding(IMPURE_DEVICE_FN, e,
                             "synchronize inside captured code")
            elif self.locks:
                self.finding(HOST_SYNC, e,
                             "synchronize while holding "
                             f"'{self.locks[-1]}' — the device wait "
                             "serializes every thread behind the lock")
            elif self.unit.hot and COMPLETER not in self.unit.roles:
                self.finding(HOST_SYNC, e,
                             "synchronize outside the completer role — "
                             "only the overlap completer may wait on "
                             "the device")
            return NONE

        # -- purity (compiled bodies) --
        if self.unit.compiled:
            self._compiled_call_purity(e, trail, root)

        # -- retrace at known compiled call sites and capture caches --
        self._compiled_call_site(e)
        if (trail in ("get", "setdefault", "pop")
                and isinstance(e.func, ast.Attribute) and e.args):
            self.cache_key(e.func.value, e.args[0])

        # -- donation --
        self._donation(e, trail)

        # -- result taint --
        if root in TORCH_ROOTS:
            # a torch op runs where its inputs live, or where device=
            # puts it
            on_card = any(kw.arg == "device" and not _is_cpu(kw.value)
                          for kw in e.keywords)
            return ARRAY if (any_taint or on_card) else NONE
        if trail == "to" and isinstance(e.func, ast.Attribute):
            # .to(dtype) stays where it is; .to(device) lands on the card
            if all(_is_dtype(a) for a in e.args) and all(
                    kw.arg in ("dtype", "non_blocking", "copy")
                    for kw in e.keywords):
                return recv
            return ARRAY
        if trail in DEVICE_PRODUCERS:
            return SEQ if trail in ("invoke", "dispatch") else ARRAY
        if (isinstance(e.func, ast.Name) and trail in SEQ_BUILTINS
                and any_taint):
            return SEQ
        if recv:
            return recv                          # x.sum(), outs.copy()
        return NONE

    def _compiled_call_purity(self, e: ast.Call, trail: Optional[str],
                              root: Optional[str]) -> None:
        if root in IO_ROOTS or trail in ("print", "open"):
            self.finding(IMPURE_DEVICE_FN, e,
                         "I/O inside captured code runs once at capture "
                         "time, then never again at replay")
            return
        if root in HOST_ENTROPY_ROOTS:
            self.finding(IMPURE_DEVICE_FN, e,
                         f"host {root}.* inside captured code is baked "
                         "in as a capture-time constant — pass clocks "
                         "and seeds in as tensors")
            return
        if (root in NP_ROOTS and isinstance(e.func, ast.Attribute)
                and isinstance(e.func.value, ast.Attribute)
                and e.func.value.attr == "random"):
            self.finding(IMPURE_DEVICE_FN, e,
                         "np.random inside captured code is a "
                         "capture-time constant — draw on the device "
                         "with a torch.Generator")
            return
        if trail in MUTATORS and isinstance(e.func, ast.Attribute):
            rroot = _root_name(e.func.value)
            if rroot == "self" or (rroot is not None
                                   and rroot not in self.locals):
                self.finding(IMPURE_DEVICE_FN, e,
                             f".{trail}() on captured state inside "
                             "captured code — Counters/containers "
                             "mutate once at capture time, then never "
                             "again at replay")

    def _compiled_call_site(self, e: ast.Call) -> None:
        binding = None
        if isinstance(e.func, ast.Name):
            if self.unit.cls:
                binding = self.model.binding(
                    self.unit.file, f"{self.unit.cls}.{e.func.id}")
            binding = binding or self.model.binding(self.unit.file,
                                                    e.func.id)
        elif (isinstance(e.func, ast.Attribute)
              and isinstance(e.func.value, ast.Name)
              and e.func.value.id == "self" and self.unit.cls):
            binding = self.model.binding(
                self.unit.file, f"{self.unit.cls}.self.{e.func.attr}")
        if binding is None:
            return
        for a in e.args:
            if (isinstance(a, ast.Starred)
                    and (isinstance(a.value, (ast.Set, ast.SetComp))
                         or (isinstance(a.value, ast.Call)
                             and _trailing(a.value.func) == "set"))):
                self.finding(RETRACE, a,
                             "set iteration feeds a compiled call "
                             "signature — set order varies per process, "
                             "so the same logical call meets different "
                             "guards and compiles again")

    def _donation(self, e: ast.Call, trail: Optional[str]) -> None:
        if trail != "dispatch":
            return
        donating = False
        for kw in e.keywords:
            if kw.arg == "donate":
                donating = not (isinstance(kw.value, ast.Constant)
                                and kw.value.value in (False, None))
        if donating:
            for a in e.args:
                if isinstance(a, ast.Name):
                    self.donated[a.id] = e.lineno


# -- pass driver ------------------------------------------------------------

def run_passes(model: JitModel, min_hot_sites: int = 0) -> JitReport:
    report = JitReport(num_files=model.num_files)
    for unit in model.units:
        if unit.compiled:
            report.compiled_bodies += 1
        elif unit.hot:
            report.hot_sites += 1
        else:
            continue
        _BodyWalker(model, report, unit).run()
    report.jit_sites = len(model.jit_sites)
    for site in model.jit_sites:
        report.jit_site_kinds[site.kind] = (
            report.jit_site_kinds.get(site.kind, 0) + 1)
    if min_hot_sites and report.hot_sites < min_hot_sites:
        _emit(report, model, JitFinding(
            rule=VACUOUS_COVERAGE, file="<scan>", line=0,
            message=f"only {report.hot_sites} hot-path site(s) analyzed "
                    f"(< {min_hot_sites}) — the scan is not seeing the "
                    "runtime; a gate that sees nothing proves nothing"))
    return report


def analyze_paths(paths: Sequence[str],
                  min_hot_sites: int = 0) -> JitReport:
    return run_passes(scan_paths(paths), min_hot_sites=min_hot_sites)
