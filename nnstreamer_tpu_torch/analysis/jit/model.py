"""AST scan + hot-path model for jitcheck, with PyTorch and CUDA-graph
triggers.

The counterpart of ``nnstreamer_tpu/analysis/jit/model.py``. jitcheck
rides on racecheck's thread-role machinery: the same class model and
seed-propagated role map decide WHICH bodies are hot (chain,
source-loop, dispatcher, completer, worker, uploader — the threads a
frame crosses between source and sink), and jitcheck then walks those
bodies with its own device-taint tracker. Separately it collects every
capture construction in the tree (the *static* capture-site map the
runtime gate checks observed CompileCache kinds against) plus the
bodies those constructions capture, which get the purity and recapture
passes instead of the host-sync pass.

How the JAX package's triggers map onto the port:

* **compile sites.** A ``jax.jit`` construction becomes a graph capture
  or a compile: ``Executable(...)`` and ``capture_in_place(...)``
  (``filters/executable.py``), ``torch.cuda.CUDAGraph()``,
  ``torch.cuda.graph(...)``, ``torch.compile`` and
  ``torch.jit.trace``/``torch.jit.script``.
* **compiled bodies.** The functions handed to those sites (a sibling
  ``def`` by name, or a method of the same class as ``self.m``), bodies
  decorated with ``@torch.compile``/``@torch.jit.script``, and the inner
  ``def``s of
  :data:`COMPILED_WRAPPERS` (``device_fn``, ``traceable_fn``,
  ``_compile``), whose programs a fused segment or a backend captures.
* **host syncs.** ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``float()/int()/bool()`` and truthiness on a device
  tensor; ``torch.cuda.synchronize()`` and ``Event``/``Stream``
  ``.synchronize()`` outside the completer role (they take the place of
  ``block_until_ready``). The sanctioned materialization points are the
  port's own: ``Chunk.host()``, ``Buffer.host_arrays()``/``fetch_host``
  and ``PendingHost.resolve()``.
* **donation.** The port's ``dispatch(..., donate=True)`` has nothing
  to donate (``filters/torch_cuda_backend.py``), but the contract is
  kept: reading an input after handing it to a donating dispatch is
  still reported.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..concurrency.model import (CHAIN, COMPLETER, DISPATCHER, SOURCE,
                                 UPLOADER, WORKER, Model, live_roles,
                                 roles_of)
from ..concurrency.model import scan_paths as _scan_roles

PRAGMA_RE = re.compile(r"#\s*jitcheck:\s*ok\(([^)]*)\)")

# roles whose bodies sit on the frame path — a hidden sync here stalls
# the pipeline, not just one caller.
HOT_ROLES = frozenset({CHAIN, SOURCE, WORKER, DISPATCHER, COMPLETER,
                       UPLOADER})

# jitcheck-specific role entry points grafted onto racecheck's seeds:
# cross-object calls (element -> framework, decoder registry -> plugin,
# batcher -> scheduler) that intra-class propagation cannot reach.
EXTRA_SEEDS: List[Tuple[str, str, str]] = [
    ("FilterFramework", "invoke", CHAIN),
    ("FilterFramework", "dispatch", DISPATCHER),
    ("FilterFramework", "complete", COMPLETER),
    ("DecoderPlugin", "decode", CHAIN),
    ("ServeScheduler", "complete", WORKER),
    ("OverlapExecutor", "submit", DISPATCHER),
]

# (ancestor, method) -> parameter names that carry device tensors when
# the method runs (the taint seeds a signature implies).
DEVICE_PARAMS: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("ServeScheduler", "complete"): ("outputs",),
    # only the torch-cuda backend's dispatch handle holds card tensors —
    # the plain/simulated backends hand host objects around.
    ("TorchCudaFilter", "complete"): ("handle",),
}

# methods whose inner ``def`` bodies a fused segment or a backend
# captures — those inner bodies are device programs.
COMPILED_WRAPPERS = frozenset({"device_fn", "_compile", "traceable_fn"})

# attribute reads that return host metadata, never a device value
META_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "nbytes",
                        "sharding", "is_device", "done", "dev", "name",
                        "device", "is_cuda", "layout", "requires_grad",
                        "itemsize"})

# tensor methods that return host metadata without touching the card
META_CALLS = frozenset({"size", "dim", "numel", "nelement", "stride",
                        "element_size", "data_ptr", "get_device",
                        "is_contiguous", "is_pinned", "storage_offset"})

# trailing call names whose RESULT is a device tensor (taint sources)
DEVICE_PRODUCERS = frozenset({"invoke", "dispatch", "cuda", "device",
                              "place_batch", "tile_error"})

# the port's sanctioned materialization points
SANITIZERS = frozenset({"host", "host_arrays", "fetch_host", "resolve"})

# the host-sync calls on a device tensor
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})


def site_kind(file: str) -> str:
    """Map a capture site to the CompileCache ``kind`` bucket the runtime
    half will observe for it: the torch-cuda backend records its
    signatures as ``"torch-cuda"`` (``TorchCudaFilter.NAME``), the fused
    segment as ``"fusion"``."""
    p = file.replace("\\", "/")
    if "/fusion/" in p:
        return "fusion"
    if "/filters/" in p:
        return "torch-cuda"
    if "/ops/" in p:
        return "ops"
    if "/models/" in p:
        return "models"
    if "/parallel/" in p:
        return "parallel"
    if "/trainers/" in p:
        return "trainer"
    return Path(p).stem


@dataclass(frozen=True)
class JitSite:
    file: str
    line: int
    kind: str


@dataclass(frozen=True)
class JitBinding:
    """A name bound to a compiled callable (``f = torch.compile(fn)``,
    ``self._exe = Executable(...)`` or a compile decorator) — call sites
    of the name get the recapture checks."""
    name: str                       # "step" or "self._step"
    file: str
    line: int


@dataclass
class FuncUnit:
    """One analyzable body: a method, module function, or inner def."""
    file: str
    cls: Optional[str]
    name: str
    node: ast.AST                   # FunctionDef / AsyncFunctionDef
    roles: Set[str] = field(default_factory=set)
    tainted_params: Set[str] = field(default_factory=set)
    compiled: bool = False          # body is captured or compiled

    @property
    def qual(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name

    @property
    def hot(self) -> bool:
        return bool(self.roles & HOT_ROLES)


@dataclass
class JitModel:
    roles_model: Optional[Model] = None
    units: List[FuncUnit] = field(default_factory=list)
    bindings: Dict[Tuple[str, str], JitBinding] = field(default_factory=dict)
    # (file, "Cls.self._graphs" or "graphs") -> line: dicts that hold
    # captures, keyed per signature
    caches: Dict[Tuple[str, str], int] = field(default_factory=dict)
    jit_sites: List[JitSite] = field(default_factory=list)
    pragmas: Dict[str, Dict[int, str]] = field(default_factory=dict)
    num_files: int = 0

    def pragma_reason(self, file: str, lineno: int) -> Optional[str]:
        """pragma on the line itself or the line above."""
        table = self.pragmas.get(file, {})
        return table.get(lineno) or table.get(lineno - 1)

    def binding(self, file: str, name: str) -> Optional[JitBinding]:
        return self.bindings.get((file, name))

    def is_cache(self, file: str, name: str) -> bool:
        return (file, name) in self.caches


# -- capture recognition ----------------------------------------------------

def _trailing_attr(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


# constructors and functions that capture (by trailing name, so the
# import spelling does not matter)
CAPTURE_NAMES = frozenset({"Executable", "capture_in_place", "CUDAGraph"})
# dotted tails that compile or capture: torch.compile, torch.jit.trace,
# torch.jit.script, torch.cuda.graph (a context manager)
CAPTURE_TAILS = ("torch.compile", "jit.trace", "jit.script", "cuda.graph")


def is_capture_func(func: ast.AST) -> bool:
    """``func`` names a capture constructor: ``Executable``,
    ``capture_in_place``, ``torch.cuda.CUDAGraph``, ``torch.compile``,
    ``torch.jit.trace/script`` or ``torch.cuda.graph``."""
    name = _trailing_attr(func)
    if name in CAPTURE_NAMES:
        return True
    dotted = _dotted(func)
    return any(dotted == t or dotted.endswith("." + t)
               for t in CAPTURE_TAILS)


def capture_call_of(node: ast.AST) -> Optional[ast.Call]:
    """The capture Call if ``node`` is one: a call of a capture
    constructor, or ``functools.partial`` over one."""
    if isinstance(node, ast.Call):
        if is_capture_func(node.func):
            return node
        if (_trailing_attr(node.func) == "partial" and node.args
                and is_capture_func(node.args[0])):
            return node
    return None


# -- per-file collection ----------------------------------------------------

class _FileCollector:
    """Walks one module: finds capture constructions + bindings,
    classifies function bodies into units, and marks compiled bodies."""

    def __init__(self, model: JitModel, ro_model: Model, label: str):
        self.model = model
        self.ro = ro_model
        self.label = label

    def is_capture_decorator(self, dec: ast.AST) -> Optional[ast.AST]:
        """``@torch.compile``, ``@torch.compile(...)``,
        ``@torch.jit.script`` — the decorator node, else None."""
        if capture_call_of(dec) is not None:
            return dec
        if not isinstance(dec, ast.Call) and is_capture_func(dec):
            return dec
        return None

    def note_site(self, node: ast.AST) -> None:
        self.model.jit_sites.append(JitSite(
            file=self.label, line=getattr(node, "lineno", 0),
            kind=site_kind(self.label)))

    # -- module walk --
    def scan(self, tree: ast.Module) -> None:
        # every capture construction anywhere in the tree is a site
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and capture_call_of(node):
                self.note_site(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if not isinstance(dec, ast.Call) \
                            and is_capture_func(dec):
                        self.note_site(dec)   # bare @torch.compile

        for stmt in tree.body:
            if isinstance(stmt, ast.ClassDef):
                self._scan_class(stmt)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(stmt, cls=None, roles={"api"})
                self._scan_bindings(stmt, list(stmt.body), cls=None)
            elif isinstance(stmt, (ast.Assign, ast.Expr)):
                self._scan_binding_stmt(stmt, tree.body, cls=None,
                                        cnode=None)

    def _scan_bindings(self, fn, scope_body, cls: Optional[str],
                       cnode: Optional[ast.ClassDef] = None) -> None:
        for inner in ast.walk(fn):
            if isinstance(inner, (ast.Assign, ast.Expr)):
                self._scan_binding_stmt(inner, scope_body, cls, cnode)

    def _key(self, cls: Optional[str], name: str) -> Tuple[str, str]:
        return (self.label, f"{cls}.{name}" if cls else name)

    @staticmethod
    def _target_name(tgt: ast.AST) -> Optional[str]:
        if isinstance(tgt, ast.Name):
            return tgt.id
        if (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"):
            return f"self.{tgt.attr}"
        return None

    def _scan_binding_stmt(self, stmt, scope_body, cls: Optional[str],
                           cnode: Optional[ast.ClassDef]) -> None:
        """``f = capture(...)`` binds a compiled callable; ``c[k] =
        capture(...)``, ``c.setdefault(k, capture(...))`` and ``c = {k:
        capture(...)}`` make ``c`` a capture cache."""
        value = stmt.value
        calls: List[ast.Call] = []
        if isinstance(stmt, ast.Assign):
            call = capture_call_of(value)
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Subscript) and call is not None:
                    name = self._target_name(tgt.value)
                    if name:
                        self.model.caches[self._key(cls, name)] = \
                            stmt.lineno
                    continue
                name = self._target_name(tgt)
                if not name:
                    continue
                if call is not None:
                    self.model.bindings[self._key(cls, name)] = JitBinding(
                        name=name, file=self.label, line=stmt.lineno)
                elif isinstance(value, ast.Dict) and any(
                        capture_call_of(v) for v in value.values):
                    self.model.caches[self._key(cls, name)] = stmt.lineno
            if call is not None:
                calls.append(call)
        if (isinstance(value, ast.Call)
                and _trailing_attr(value.func) == "setdefault"
                and isinstance(value.func, ast.Attribute)
                and len(value.args) == 2
                and capture_call_of(value.args[1]) is not None):
            name = self._target_name(value.func.value)
            if name:
                self.model.caches[self._key(cls, name)] = stmt.lineno
            calls.append(value.args[1])
        for call in calls:
            self._mark_handed(call, scope_body, cnode)

    def _mark_handed(self, call: ast.Call, scope_body,
                     cnode: Optional[ast.ClassDef]) -> None:
        """The function handed to a capture: a sibling def by name, or
        ``self.m`` for a method of the same class."""
        if not call.args:
            return
        arg = call.args[0]
        if _trailing_attr(call.func) == "partial" and len(call.args) > 1:
            arg = call.args[1]
        if isinstance(arg, ast.Name):
            self._mark_compiled_def(arg.id, scope_body)
        elif (cnode is not None and isinstance(arg, ast.Attribute)
              and isinstance(arg.value, ast.Name)
              and arg.value.id == "self"):
            self._mark_compiled_def(arg.attr, cnode.body, method=True)

    def _mark_compiled_def(self, fname: str, scope_body,
                           method: bool = False) -> None:
        for s in scope_body:
            if (isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and s.name == fname):
                for u in self.model.units:
                    if u.node is s:
                        u.compiled = True
                        return
                if not method:
                    self._add_unit(s, cls=None, roles=set(), compiled=True)
                return

    def _add_unit(self, node, cls, roles, compiled=False,
                  tainted: Optional[Set[str]] = None) -> FuncUnit:
        unit = FuncUnit(file=self.label, cls=cls, name=node.name,
                        node=node, roles=set(roles),
                        tainted_params=set(tainted or ()),
                        compiled=compiled)
        self.model.units.append(unit)
        return unit

    def _decorated(self, node) -> Optional[ast.AST]:
        for dec in node.decorator_list:
            hit = self.is_capture_decorator(dec)
            if hit is not None:
                return hit
        return None

    def _scan_function(self, node, cls: Optional[str],
                       roles: Set[str],
                       tainted: Optional[Set[str]] = None) -> None:
        dec = self._decorated(node)
        self._add_unit(node, cls, roles, compiled=dec is not None,
                       tainted=tainted)
        if dec is not None:
            self.model.bindings[self._key(cls, node.name)] = JitBinding(
                name=node.name, file=self.label, line=node.lineno)
        self._scan_inner(node, outer_compiled=dec is not None,
                         wrapper=node.name in COMPILED_WRAPPERS)

    def _scan_inner(self, node, outer_compiled: bool,
                    wrapper: bool) -> None:
        """Inner defs: compiled if the enclosing scope captures them (by
        name or by being a COMPILED_WRAPPERS method), else skipped —
        they run in the enclosing body's role and the walker inlines
        nothing."""
        handed: Set[str] = set()
        for n in ast.walk(node):
            call = capture_call_of(n)
            if call is not None and call.args:
                arg = call.args[0]
                if _trailing_attr(call.func) == "partial" \
                        and len(call.args) > 1:
                    arg = call.args[1]
                if isinstance(arg, ast.Name):
                    handed.add(arg.id)
        for s in node.body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if (wrapper or outer_compiled or s.name in handed
                        or self._decorated(s) is not None
                        or s.name in COMPILED_WRAPPERS):
                    self._add_unit(s, cls=None, roles=set(), compiled=True)
                    self._scan_inner(s, outer_compiled=True, wrapper=False)

    def _scan_class(self, cnode: ast.ClassDef) -> None:
        roles_map = roles_of(self.ro, cnode.name, extra_seeds=EXTRA_SEEDS)
        ancestry = set(self.ro.ancestry(cnode.name)) | {cnode.name}
        for stmt in cnode.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                roles = live_roles(roles_map.get(stmt.name, {"api"}))
                tainted: Set[str] = set()
                for (base, meth), params in DEVICE_PARAMS.items():
                    if base in ancestry and meth == stmt.name:
                        tainted.update(params)
                self._scan_function(stmt, cls=cnode.name, roles=roles,
                                    tainted=tainted)
        # bindings after every method has its unit, so a method handed
        # to a capture as ``self.m`` is marked whatever the order
        for stmt in cnode.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_bindings(stmt, list(stmt.body), cnode.name,
                                    cnode)


def scan_paths(paths: Sequence[str]) -> JitModel:
    """Parse every ``.py`` under the given files/directories into one
    JitModel (racecheck's role model rides along for the hot-path
    classification). Unparseable files are skipped — compileall's
    problem, not jitcheck's."""
    ro_model = _scan_roles(paths)
    model = JitModel(roles_model=ro_model)
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
        _FileCollector(model, ro_model, label).scan(tree)
    return model
