"""racecheck in the port (``nnstreamer_tpu_torch/analysis/concurrency``)
against the JAX package's, on the CPU.

* Every test of ``tests/test_racecheck.py`` runs with its analyzer calls
  going through both packages (tests/torch_analyzer_parity.py): the
  findings agree rule, file, line and message, and the test's own
  assertions hold on the port's report.
* Both analyzers agree over both trees.
* The port's own tree is clean at the JAX Makefile's gate, every
  analyzer pragma in the port carries a reason, and each finding the
  gate raised on the port stays triaged: fixed in the port (with a test
  that fails without the fix where one can) or suppressed with a reason.
* The runtime lock validators of ``tests/test_async.py``,
  ``tests/test_serve.py`` and ``tests/test_chaos.py`` run on the port's
  lines (``accelerator=true:cpu``) beside the JAX package's own run of
  the same line.
"""
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import torch_analyzer_parity as parity
from nnstreamer_tpu.analysis import concurrency as nt_race
from nnstreamer_tpu.analysis.concurrency.cli import main as nt_main
from nnstreamer_tpu_torch.analysis import concurrency as pt_race
from nnstreamer_tpu_torch.analysis.concurrency.cli import main as pt_main

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "nnstreamer_tpu_torch"
JAX_DIR = ROOT / "nnstreamer_tpu"

JAX_TESTS = parity.load("test_racecheck")
CASES = parity.cases(JAX_TESTS)


def _same_report(ref, got):
    assert parity.findings_of(got) == parity.findings_of(ref)
    assert got.lock_edges == ref.lock_edges
    assert (got.num_classes, got.num_files) == \
        (ref.num_classes, ref.num_files)
    assert got.exit_code == ref.exit_code


def _same(ref, got):
    assert got == ref


def test_corpus_cases_cover_the_jax_module():
    assert len(CASES) >= 31


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_jax_corpus_through_both_analyzers(case, tmp_path, capsys,
                                           monkeypatch):
    parity.run(JAX_TESTS, case, {"tmp_path": tmp_path, "capsys": capsys},
               {"analyze_paths": parity.twin(nt_race.analyze_paths,
                                             pt_race.analyze_paths,
                                             _same_report),
                "find_cycles": parity.twin(nt_race.find_cycles,
                                           pt_race.find_cycles, _same),
                "racecheck_main": parity.twin_main(nt_main, pt_main)},
               monkeypatch)


# ---------------------------------------------------------- both trees

@pytest.fixture(scope="module")
def port_report():
    return pt_race.analyze_paths([str(PORT_DIR)])


@pytest.mark.parametrize("tree", ["nnstreamer_tpu", "nnstreamer_tpu_torch"])
def test_both_packages_agree_over_both_trees(tree, port_report):
    ref = nt_race.analyze_paths([str(ROOT / tree)])
    got = port_report if tree == "nnstreamer_tpu_torch" \
        else pt_race.analyze_paths([str(ROOT / tree)])
    _same_report(ref, got)


# ------------------------------------------------------------ self-scan

def test_gate_is_clean_on_the_port(port_report):
    """``python -m nnstreamer_tpu_torch racecheck nnstreamer_tpu_torch``
    exits 0: no live finding, and the lock graph is acyclic."""
    assert port_report.findings == [], port_report.to_text()
    assert port_report.num_classes > 300
    assert pt_race.find_cycles(port_report.lock_edges) == []
    r = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch",
                        "racecheck", "nnstreamer_tpu_torch", "-q"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


PRAGMA = re.compile(r"#\s*(racecheck|flowcheck|jitcheck):\s*ok\(([^)]*)\)")


@pytest.mark.parametrize("tool", ["racecheck", "flowcheck", "jitcheck"])
def test_every_port_pragma_has_a_reason(tool):
    """Every ``# <tool>: ok(reason)`` in the port's code (the analyzers'
    own docstrings aside) names its reason. The port needs no flowcheck
    suppression, as the JAX package's code needs none."""
    seen = 0
    for path in sorted(PORT_DIR.rglob("*.py")):
        if "analysis" in path.relative_to(PORT_DIR).parts[:1]:
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            for m in PRAGMA.finditer(line):
                if m.group(1) != tool:
                    continue
                seen += 1
                reason = m.group(2).strip()
                assert len(reason) > 10 and reason != "unspecified", \
                    f"{path}:{n}: {tool} pragma without a reason"
    assert seen >= (0 if tool == "flowcheck" else 1)


# (port file, class, attribute, outcome): the twelve findings the gate
# raised on the port before this triage, and what became of each
TRIAGE = [
    ("parallel/world.py", "World", "_lock", "fixed"),          # .wait()
    ("parallel/world.py", "World", "_broken", "fixed"),
    ("serve/scheduler.py", "ServeScheduler", "_mesh", "fixed"),
    ("serve/scheduler.py", "ServeScheduler", "_mesh_retained", "fixed"),
    ("elements/query.py", "TensorQueryClient", "_pending", "fixed"),
    ("elements/aggregator.py", "TensorAggregator", "_window", "pragma"),
    ("elements/edge.py", "EdgeSrc", "_restored_last", "pragma"),
    ("elements/flowctl.py", "TensorRate", "_next_ts", "pragma"),
    ("elements/flowctl.py", "TensorRate", "_last_in_pts", "pragma"),
    ("elements/flowctl.py", "TensorRate", "_throttling", "pragma"),
    ("elements/flowctl.py", "TensorRate", "_prev", "pragma"),
    ("trainers/torch_cuda_trainer.py", "TorchCudaTrainer", "_epoch_done",
     "pragma"),
]


@pytest.mark.parametrize("rel,cls,attr,outcome", TRIAGE,
                         ids=[f"{t[1]}.{t[2]}" for t in TRIAGE])
def test_triaged_finding_stays_triaged(rel, cls, attr, outcome,
                                       port_report):
    def hits(findings):
        return [f for f in findings
                if f.file.endswith(rel) and f.cls == cls
                and f.attr == attr]
    assert hits(port_report.findings) == []
    suppressed = hits(port_report.suppressed)
    if outcome == "fixed":
        assert suppressed == [], "fixed in the code, not suppressed"
    else:
        assert len(suppressed) == 1
        reason = pt_race.scan_paths([str(PORT_DIR / rel)]).pragma_reason(
            str(PORT_DIR / rel), suppressed[0].line)
        assert "start(" in reason   # the reason ends at its first ")"


# --------------------------------------------------- the port's fixes

def test_scheduler_mesh_release_waits_for_a_build_in_flight(monkeypatch):
    """release_mesh() racing the serving thread's first place(): the
    release waits for the mesh being built and lets go of it, so every
    world.retain() meets a world.release(). Unguarded, the release found
    nothing retained yet and the build retained the world afterwards."""
    from nnstreamer_tpu_torch.parallel import mesh as pmesh
    from nnstreamer_tpu_torch.parallel import world
    from nnstreamer_tpu_torch.serve.scheduler import ServeScheduler

    entered, go = threading.Event(), threading.Event()
    counts = {"retain": 0, "release": 0}

    def slow_mesh(spec):
        entered.set()
        assert go.wait(10)
        return object()

    monkeypatch.setattr(pmesh, "mesh_from_spec", slow_mesh)
    monkeypatch.setattr(world, "retain", lambda *a: counts.__setitem__(
        "retain", counts["retain"] + 1))
    monkeypatch.setattr(world, "release", lambda *a: counts.__setitem__(
        "release", counts["release"] + 1))
    sched = ServeScheduler(buckets=(2, 4), mesh_spec="2x1x1")
    builder = threading.Thread(target=sched._mesh_for_place)
    builder.start()
    assert entered.wait(10)
    releaser = threading.Thread(target=sched.release_mesh)
    releaser.start()
    time.sleep(0.2)
    go.set()
    builder.join(10)
    releaser.join(10)
    assert not builder.is_alive() and not releaser.is_alive()
    assert counts == {"retain": 1, "release": 1}
    assert sched._mesh is None and not sched._mesh_retained


def _bare_world():
    from nnstreamer_tpu_torch.parallel.world import World
    w = World.__new__(World)
    w.size = 2
    w._lock = threading.RLock()
    w._broken = None
    w._broken_lock = threading.Lock()
    w._closing = False
    w._conns = []
    return w


def test_world_keeps_the_first_reason_it_broke_for():
    """The monitor thread and the command thread both break the world;
    the first reason stays, whichever thread gives it."""
    w = _bare_world()
    threads = [threading.Thread(target=w._break, args=(f"r{i}",))
               for i in range(8)]
    w._break("first")
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert w.broken == "first"


def test_world_close_does_not_wait_forever_on_an_unkillable_follower(
        monkeypatch):
    """close() holds the world lock while it reaps the followers; a
    follower that outlives SIGKILL (stuck in the driver) must not keep
    it, and every caller of run(), waiting forever."""
    import subprocess as sp

    from nnstreamer_tpu_torch.parallel import world as wmod
    monkeypatch.setattr(wmod, "_KILL_WAIT_S", 0.2)

    class Stuck:
        pid = 4242

        def wait(self, timeout=None):
            if timeout is None:
                threading.Event().wait()      # the unbounded wait hangs
            time.sleep(min(timeout, 0.05))
            raise sp.TimeoutExpired("follower", timeout)

        def kill(self):
            pass

        def poll(self):
            return None

    w = _bare_world()
    w._procs = [Stuck()]
    monkeypatch.setattr(wmod.dist, "is_initialized", lambda: False)
    t = threading.Thread(target=w.close, daemon=True)
    t.start()
    t.join(15)
    assert not t.is_alive()
    assert w._procs == [] and w._lock.acquire(timeout=1)


def test_query_client_takes_one_lock_for_its_pending_requests():
    """The client's settlement condition is over ``_plock``, the lock
    the replay set has always been guarded by: every mutation of
    ``_pending`` runs under it, whichever name the code takes it by."""
    import nnstreamer_tpu_torch as pt
    client = pt.make_element("tensor_query_client")
    with client._settled:
        assert client._plock.locked()
    assert not client._plock.locked()


# ------------------------------------------- runtime lock validators

CAPS = ("other/tensors,format=static,num_tensors=1,"
        "types=(string)float32,dimensions=(string)8,"
        "framerate=(fraction)30/1")
CAPS_U8 = "other/tensors,format=static,num_tensors=1,types=uint8,dimensions=4"


def test_static_model_assigns_overlap_roles():
    """tests/test_async.py::TestRacecheckRoles on the port's tree: the
    same roles on the same methods as in the JAX package's."""
    from nnstreamer_tpu_torch.analysis.concurrency.model import (
        COMPLETER, DISPATCHER, UPLOADER, roles_of, scan_paths)
    from nnstreamer_tpu.analysis.concurrency.model import (
        roles_of as nt_roles_of, scan_paths as nt_scan_paths)
    model = scan_paths([str(PORT_DIR)])
    ref = nt_scan_paths([str(JAX_DIR)])
    ov = roles_of(model, "OverlapExecutor")
    assert DISPATCHER in ov["submit"]
    assert COMPLETER in ov["_complete_loop"]
    tf = roles_of(model, "TensorFilter")
    assert COMPLETER in tf["_complete_frame"]
    up = roles_of(model, "_Uploader")
    assert UPLOADER in up["_run"]
    for cls, meth in [("OverlapExecutor", "submit"),
                      ("OverlapExecutor", "_complete_loop"),
                      ("TensorFilter", "_complete_frame"),
                      ("_Uploader", "_run")]:
        assert roles_of(model, cls)[meth] == nt_roles_of(ref, cls)[meth]


def _check(mon, static):
    assert mon.acquisitions, "instrumented locks were never taken"
    cycles, missed = mon.check_against_static(static)
    assert cycles == [], f"runtime witnessed a deadlockable order: {cycles}"
    assert missed == set(), f"static graph missed edges: {missed}"


def _overlap_run(pkg, conc, acc):
    p = pkg.parse_launch(
        f'tensortestsrc caps="{CAPS}" num-buffers=10 pattern=counter '
        '! queue ! tensor_filter name=f framework=simlink '
        f'custom=rtt:10,svc:1,fail-every:4 in-flight=4{acc} '
        'breaker-threshold=50 ! appsink name=out')
    p.fuse = False
    mon = conc.LockMonitor()
    p.start()
    f = p["f"]
    conc.instrument_object(f._overlap, mon)           # OverlapExecutor._cv
    conc.instrument_object(f._overlap.window, mon)    # InFlightWindow._cv
    conc.instrument_object(f, mon)                    # TensorFilter._stats_lock
    conc.instrument_object(f._breaker, mon)           # CircuitBreaker._lock
    conc.instrument_counters(f.stats, mon)
    p.wait_eos(timeout=60)
    p.stop()
    assert len(p["out"].pop_all()) == 8  # frames 4 and 8 fail
    return mon


def test_runtime_lock_validator_over_overlap_roles():
    """A windowed simlink line with the executor's, the window's, the
    element's and the breaker's locks traced, in each package: each
    recorded acquisition graph is acyclic and a subset of its package's
    static racecheck graph, and the two runs take the same nestings."""
    import nnstreamer_tpu as nt
    import nnstreamer_tpu_torch as pt
    ref = _overlap_run(nt, nt_race, "")
    _check(ref, nt_race.analyze_paths([str(JAX_DIR)]).lock_edges)
    mon = _overlap_run(pt, pt_race, " accelerator=true:cpu")
    _check(mon, pt_race.analyze_paths([str(PORT_DIR)]).lock_edges)
    assert set(mon.acquisitions) == set(ref.acquisitions)


def _serve_run(sched_cls, conc):
    mon = conc.LockMonitor()
    sched = sched_cls(buckets=(1, 2, 4), max_wait_s=0.002,
                      invoke_fn=lambda xs: [x * 2 for x in xs])
    conc.instrument_object(sched, mon)            # ServeScheduler._mlock
    conc.instrument_object(sched.batcher, mon)    # BucketBatcher._cond
    conc.instrument_counters(sched.stats, mon)
    conc.instrument_counters(sched.batcher.stats, mon)
    done = threading.Event()
    results = []
    rlock = threading.Lock()

    def on_result(req, row):
        with rlock:
            results.append(req.stream_id)
            if len(results) == 30:
                done.set()

    sched.start()
    try:
        for i in range(10):
            for s in range(3):
                assert sched.submit(s, [np.full(4, float(i), np.float32)],
                                    seq=i, on_result=on_result)
        assert done.wait(timeout=20)
    finally:
        sched.stop()
    return mon


def test_serve_path_matches_static_graph():
    """tests/test_serve.py's validator on the port's scheduler, beside
    the JAX scheduler's run: both acyclic, both within their static
    graphs, and the canonical nestings exercised in both."""
    from nnstreamer_tpu.serve import ServeScheduler as NtScheduler
    from nnstreamer_tpu_torch.serve import ServeScheduler
    ref = _serve_run(NtScheduler, nt_race)
    _check(ref, nt_race.analyze_paths([str(JAX_DIR)]).lock_edges)
    mon = _serve_run(ServeScheduler, pt_race)
    _check(mon, pt_race.analyze_paths([str(PORT_DIR)]).lock_edges)
    for m in (ref, mon):
        assert ("ServeScheduler._mlock", "Counters._lock") in m.edge_set()
        assert ("BucketBatcher._cond", "Counters._lock") in m.edge_set()


class _FlakyBackend:
    """custom-easy model whose failure window is script-controlled."""

    def __init__(self):
        self.broken = False
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        if self.broken:
            raise ConnectionError("backend down")
        return x * 2


def _chaos_run(pkg, conc, register, name):
    backend = _FlakyBackend()
    register(name, backend)
    p = pkg.parse_launch(
        f'appsrc name=in caps="{CAPS_U8}" ! '
        "tensor_filter name=f framework=custom-easy "
        f"model={name} breaker-threshold=3 "
        "breaker-reset-ms=100 ! tensor_sink name=s")
    mon = conc.LockMonitor()
    p.start()
    conc.instrument_object(p["f"]._breaker, mon)      # CircuitBreaker._lock
    conc.instrument_counters(p["f"]._breaker.stats, mon)
    for el in p.elements.values():
        conc.instrument_counters(el.stats, mon)

    def push(v):
        p["in"].push_buffer(pkg.Buffer.from_arrays(
            [np.full(4, v, np.uint8)]))
    push(1)
    deadline = time.monotonic() + 10
    while backend.calls < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    backend.broken = True
    for v in range(2, 7):  # 3 invoke failures open; 2 more are shed
        push(v)
    deadline = time.monotonic() + 10
    while p["f"].stats["shed"] < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    backend.broken = False
    time.sleep(0.15)  # past breaker-reset-ms: half-open
    push(7)           # the probe closes the breaker again
    p["in"].end_stream()
    p.wait_eos(timeout=30)
    p.stop()
    assert p["f"]._breaker.stats["opened"] == 1
    assert p["f"]._breaker.stats["closed"] == 1
    return mon


def test_chaos_breaker_path_matches_static_graph():
    """tests/test_chaos.py's validator: the breaker's open/shed/close
    cycle under traced locks, on the port's line and the JAX line."""
    import nnstreamer_tpu as nt
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu.filters import register_custom_easy as nt_reg
    from nnstreamer_tpu_torch.filters.custom import \
        register_custom_easy as pt_reg
    ref = _chaos_run(nt, nt_race, nt_reg, "chaos_racecheck_nt")
    _check(ref, nt_race.analyze_paths([str(JAX_DIR)]).lock_edges)
    mon = _chaos_run(pt, pt_race, pt_reg, "chaos_racecheck_pt")
    _check(mon, pt_race.analyze_paths([str(PORT_DIR)]).lock_edges)
    for m in (ref, mon):
        assert ("CircuitBreaker._lock", "Counters._lock") in m.edge_set()
