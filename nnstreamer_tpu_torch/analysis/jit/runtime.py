"""Runtime half of jitcheck: the compile-stability monitor.

The counterpart of ``nnstreamer_tpu/analysis/jit/runtime.py``. The
static passes predict WHERE capture may happen (the capture-site map,
bucketed by CompileCache ``kind``); the runtime half observes what
actually happened — per-element ``jit_hits`` / ``jit_misses`` /
``jit_prewarmed`` / ``jit_recompiles`` counters (the filter's
``jit_recompiles`` counts the executables its backend made for a new
signature during a frame, the fused segment's ``jit_misses`` the
executables it made) plus the CUDA-graph captures themselves, counted
through the listener hook of ``filters/executable.py`` (torch has no
``jax.monitoring``) — and ``check_against_static`` closes the contract:

* steady-state recompiles == 0 — a warmed process serving the same
  traffic must never capture on the frame path again;
* observed signatures ⊆ statically predicted — every CompileCache
  ``kind`` that recorded a signature must correspond to a capture
  construction the static scan saw (a kind the scan can't see means
  the model is unhooked, the gate's version of vacuous coverage).

``tools/torch_jit_stability.py`` drives the builtin corpus through two
passes and applies exactly this check.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Set

JIT_STAT_KEYS = ("jit_recompiles", "jit_misses", "jit_hits",
                 "jit_prewarmed")


def jit_stat_snapshot(pipeline: Any) -> Dict[str, Dict[str, int]]:
    """Per-element jit counters for every element that has any (filter
    backends and fused segments), from one consistent stats() pass."""
    out: Dict[str, Dict[str, int]] = {}
    for name, snap in pipeline.stats().items():
        row = {k: int(snap[k]) for k in JIT_STAT_KEYS if k in snap}
        if row:
            out[name] = row
    return out


def steady_recompiles(snapshot: Dict[str, Dict[str, int]]) -> int:
    """Frame-path compilations in the window the snapshot covers: a
    filter's post-warmup signature compiles plus a fused segment's
    program-cache misses. Both must be zero once warm."""
    return sum(row.get("jit_recompiles", 0) + row.get("jit_misses", 0)
               for row in snapshot.values())


class CompileEventMonitor:
    """Counts the CUDA-graph captures of the process: every capture that
    completes in ``filters/executable.py`` (an executable's graph, the
    LLM backend's graphs, a graph pool's keeper) reports to it while it
    is installed. ``available`` is true: the hook is the port's own.
    ``reset()`` rebases the count (and clears ``threads``);
    ``uninstall()`` stops counting. On the CPU nothing is captured and
    the count stays at zero.

    ``threads`` counts the captures since the last reset by the name of
    the thread that made them: a compile cache's prewarm captures on the
    thread that starts the pipeline, the frame path on the streaming
    threads."""

    def __init__(self) -> None:
        self.available = False
        self._count = 0
        self._base = 0
        self.events: Dict[str, int] = {}
        self.threads: Dict[str, int] = {}

    def _on_event(self, event: str) -> None:
        if "captur" in event:
            name = threading.current_thread().name
            self._count += 1
            self.events[event] = self.events.get(event, 0) + 1
            self.threads[name] = self.threads.get(name, 0) + 1

    def install(self) -> "CompileEventMonitor":
        from ...filters.executable import add_capture_listener
        add_capture_listener(self._on_event)
        self.available = True
        return self

    def uninstall(self) -> None:
        from ...filters.executable import remove_capture_listener
        remove_capture_listener(self._on_event)

    def reset(self) -> None:
        self._base = self._count
        self.threads = {}

    @property
    def count(self) -> int:
        return self._count - self._base


@dataclass
class StabilityResult:
    steady_recompiles: int
    observed_kinds: Set[str] = field(default_factory=set)
    static_kinds: Set[str] = field(default_factory=set)
    problems: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    def __str__(self) -> str:
        status = "ok" if self.ok else "BROKEN"
        return (f"jit-stability {status}: steady recompiles="
                f"{self.steady_recompiles}, observed kinds="
                f"{sorted(self.observed_kinds)} ⊆ static "
                f"{sorted(self.static_kinds)}"
                + ("".join(f"\n  {p}" for p in self.problems)))


def check_against_static(static: Any,
                         observed_kinds: Iterable[str],
                         steady: int,
                         strict: bool = True) -> StabilityResult:
    """The static↔runtime contract. ``static`` is a JitReport (or any
    object with ``jit_site_kinds``) or a plain iterable of kind names;
    ``observed_kinds`` is what CompileCache recorded; ``steady`` is the
    second-pass recompile count. Raises AssertionError with the full
    breakdown when strict (the gate path), else returns the result."""
    kinds = getattr(static, "jit_site_kinds", None)
    static_kinds = set(kinds) if kinds is not None else set(static)
    observed = set(observed_kinds)
    result = StabilityResult(steady_recompiles=int(steady),
                             observed_kinds=observed,
                             static_kinds=static_kinds)
    if steady:
        result.problems.append(
            f"{steady} compilation(s) on the frame path of a warmed "
            "process — the compile cache is not holding steady state")
    extra = observed - static_kinds
    if extra:
        result.problems.append(
            f"observed compile kind(s) {sorted(extra)} have no "
            "statically predicted capture site — the static scan does "
            "not see the code that captured them")
    if strict and result.problems:
        raise AssertionError(str(result))
    return result
