"""jitcheck in the port (``nnstreamer_tpu_torch/analysis/jit``): the JAX
taint model with its triggers mapped onto PyTorch and CUDA graphs.

* Every corpus of ``tests/test_jitcheck.py`` sits beside its torch
  translation, written line for line: the JAX package's analyzer on the
  JAX corpus and the port's on the translation report the same rule at
  the same line, and the clean corpora stay clean in both.
* Corpora only the port has: the torch host syncs (``.to("cpu")``,
  ``.tolist()``, ``torch.cuda.synchronize``), capture caches, a method
  handed to a capture.
* The gate (``--min-hot-sites 20``) is clean on the port; the findings
  the JAX jitcheck raised on the port, and those only the port's sees,
  stay triaged.
* The CLI contract, the static↔runtime contract, the capture monitor,
  and the two-pass stability run (``tools/torch_jit_stability.py
  --device cpu``).
"""
import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

import torch_analyzer_parity as parity
from nnstreamer_tpu.analysis.jit import analyze_paths as nt_analyze
from nnstreamer_tpu_torch.analysis.jit import (DONATION_MISUSE, HOST_SYNC,
                                               IMPURE_DEVICE_FN, RETRACE,
                                               VACUOUS_COVERAGE,
                                               CompileEventMonitor,
                                               analyze_paths,
                                               check_against_static,
                                               jit_stat_snapshot, site_kind,
                                               steady_recompiles)
from nnstreamer_tpu_torch.analysis.jit.cli import main as jitcheck_main

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "nnstreamer_tpu_torch"

JAX = parity.load("test_jitcheck")


def scan(tmp_path, source, name, analyze=analyze_paths, sub="pt"):
    d = tmp_path / sub
    d.mkdir(exist_ok=True)
    f = d / name
    f.write_text(textwrap.dedent(source))
    return analyze([str(f)])


def rules_lines(report):
    return sorted((f.rule, f.line) for f in report.findings)


# ------------------------------------------------------ torch translations
# Line for line with tests/test_jitcheck.py: the same line carries the
# same hazard.

HOT_ITEM = """\
import torch

class Element:      # role seed: Element.chain runs on the chain thread
    pass

class Probe(Element):
    def chain(self, pad, buf):
        y = torch.abs(buf.raw)
        return y.item()            # line 9: blocking D2H on the hot path
"""

HOT_CAST = """\
import torch

class Element:
    pass

class Caster(Element):
    def chain(self, pad, buf):
        y = torch.square(buf.raw)
        v = float(y)               # line 9: scalar cast forces a sync
        return v
"""

HOT_TRUTH = """\
import torch

class Element:
    pass

class Truthy(Element):
    def chain(self, pad, buf):
        y = torch.abs(buf.raw)
        if y:                      # line 9: implicit bool() blocks
            return y
        return None
"""

HOT_NP = """\
import numpy as np

class Element:
    pass

class Npcopy(Element):
    def chain(self, pad, buf):
        x = buf.raw
        return x.cpu().numpy()     # line 9: D2H copy to numpy
"""

HOT_BLOCK = """\
class Element:
    pass

class Waiter(Element):
    def chain(self, pad, buf):
        out, done = self.fw.dispatch(buf.raw)
        done.synchronize()             # line 7: not the completer role
        return out
"""

CLEAN_HOST = """\
import torch

class Element:
    pass

class Boundary(Element):
    def chain(self, pad, buf):
        y = torch.abs(buf.raw)
        if y.shape[0] > 4:          # host metadata: no sync
            return None
        host = Chunk(y).host()      # sanctioned materialization point
        return float(host[0])
"""

RETRACE_CREATE_CALL = """\
import torch

class Element:
    pass

class PerCall(Element):
    def chain(self, pad, buf):
        return torch.compile(self.step)(buf.raw)   # line 8: per-call capture
"""

RETRACE_LOOP = """\
import torch

class Element:
    pass

class Looper(Element):
    def chain(self, pad, buf):
        outs = []
        for x in buf.chunks:
            f = torch.compile(self.step)    # line 10: fresh graph per iter
            outs.append(f(x))
        return outs
"""

RETRACE_STATIC = """\
import torch

class Element:
    pass

class Stepper(Element):
    def __init__(self, step):
        self._graphs = {(4, 4): torch.compile(step)}

    def chain(self, pad, buf):
        return self._graphs[[4, 4]](buf.raw)    # line 11: unhashable
"""

RETRACE_SET_UNPACK = """\
import torch

class Element:
    pass

class SetFeed(Element):
    def __init__(self, step):
        self._step = torch.compile(step)

    def chain(self, pad, buf):
        return self._step(*set(buf.parts))      # line 11: set order
"""

RETRACE_SHAPE = """\
def device_fn(scale):
    def fn(x):
        if x.shape[0] > 4:          # line 3: captures per shape
            return x * scale
        return x
    return fn
"""

RETRACE_DATA = """\
import torch

def device_fn(scale):
    def fn(x):
        if torch.sum(x) > 0:        # line 5: bakes one branch in
            return x * scale
        return x
    return fn
"""

DONATED_READ = """\
class Element:
    pass

class Donor(Element):
    def chain(self, pad, buf):
        x = buf.raw
        handle = self.fw.dispatch(x, donate=True)
        y = x * 2                   # line 8: read after donate
        return handle, y
"""

DONATED_REBIND = """\
class Element:
    pass

class Rebinder(Element):
    def chain(self, pad, buf):
        x = buf.raw
        handle = self.fw.dispatch(x, donate=True)
        x = handle[0]               # rebinding clears the donation
        return x * 2
"""

IMPURE_COUNTER = """\
class Backend:
    def device_fn(self):
        def fn(x):
            self.counters.inc("frames")     # line 4: capture time only
            return x * 2
        return fn
"""

IMPURE_PRINT = """\
import torch

@torch.compile
def step(x):
    print("tracing", x)     # line 5: I/O runs once at capture time
    return x + 1
"""

IMPURE_STORE = """\
import torch

@torch.compile
def accum(x):
    total[0] = x            # line 5: write to captured state
    return x
"""

CLEAN_COMPILED = """\
import torch
import torch.nn.functional as F

@torch.compile
def step(x):
    y = torch.tanh(x)
    return y * 2
"""

# (id, JAX corpus, torch corpus, file name): each pair must report the
# same (rule, line) list, the JAX analyzer on the JAX corpus and the
# port's on the translation
PAIRS = [
    ("hot_item", JAX.HOT_ITEM, HOT_ITEM, "probe.py"),
    ("hot_cast", JAX.HOT_CAST, HOT_CAST, "cast.py"),
    ("hot_truth", JAX.HOT_TRUTH, HOT_TRUTH, "truth.py"),
    ("hot_np", JAX.HOT_NP, HOT_NP, "npcopy.py"),
    ("hot_block", JAX.HOT_BLOCK, HOT_BLOCK, "waiter.py"),
    ("clean_host", JAX.CLEAN_HOST, CLEAN_HOST, "boundary.py"),
    ("cold_code", JAX.HOT_ITEM.replace("(Element)", ""),
     HOT_ITEM.replace("(Element)", ""), "cold.py"),
    ("retrace_create_call", JAX.RETRACE_CREATE_CALL, RETRACE_CREATE_CALL,
     "percall.py"),
    ("retrace_loop", JAX.RETRACE_LOOP, RETRACE_LOOP, "looper.py"),
    ("retrace_static", JAX.RETRACE_STATIC, RETRACE_STATIC, "stepper.py"),
    ("hashable_static_clean", JAX.RETRACE_STATIC.replace("[4, 4]", "(4, 4)"),
     RETRACE_STATIC.replace("[4, 4]", "(4, 4)"), "stepper.py"),
    ("retrace_set_unpack", JAX.RETRACE_SET_UNPACK, RETRACE_SET_UNPACK,
     "setfeed.py"),
    ("retrace_shape", JAX.RETRACE_SHAPE, RETRACE_SHAPE, "shapes.py"),
    ("retrace_data", JAX.RETRACE_DATA, RETRACE_DATA, "datadep.py"),
    ("donated_read", JAX.DONATED_READ, DONATED_READ, "donor.py"),
    ("donated_rebind", JAX.DONATED_REBIND, DONATED_REBIND, "rebinder.py"),
    ("nondonating_clean", JAX.DONATED_READ.replace(", donate=True", ""),
     DONATED_READ.replace(", donate=True", ""), "donor.py"),
    ("impure_counter", JAX.IMPURE_COUNTER, IMPURE_COUNTER, "backend.py"),
    ("impure_print", JAX.IMPURE_PRINT, IMPURE_PRINT, "printer.py"),
    ("impure_store", JAX.IMPURE_STORE, IMPURE_STORE, "accum.py"),
    ("clean_compiled", JAX.CLEAN_COMPILED, CLEAN_COMPILED, "step.py"),
    ("pragma_same_line",
     JAX.HOT_ITEM.replace("return y.item()  ",
                          "return y.item()  # jitcheck: ok(probe boundary)"),
     HOT_ITEM.replace("return y.item()  ",
                      "return y.item()  # jitcheck: ok(probe boundary)"),
     "probe.py"),
    ("pragma_line_above",
     JAX.HOT_ITEM.replace("        return y.item()",
                          "        # jitcheck: ok(probe boundary)\n"
                          "        return y.item()"),
     HOT_ITEM.replace("        return y.item()",
                      "        # jitcheck: ok(probe boundary)\n"
                      "        return y.item()"),
     "probe.py"),
    ("pragma_elsewhere", "# jitcheck: ok(not here)\n" + JAX.HOT_ITEM,
     "# jitcheck: ok(not here)\n" + HOT_ITEM, "probe.py"),
]

# the rule each non-clean translation must report, and where
EXPECTED = {
    "hot_item": [(HOST_SYNC, 9)], "hot_cast": [(HOST_SYNC, 9)],
    "hot_truth": [(HOST_SYNC, 9)], "hot_np": [(HOST_SYNC, 9)],
    "hot_block": [(HOST_SYNC, 7)], "retrace_create_call": [(RETRACE, 8)],
    "retrace_loop": [(RETRACE, 10)], "retrace_static": [(RETRACE, 11)],
    "retrace_set_unpack": [(RETRACE, 11)], "retrace_shape": [(RETRACE, 3)],
    "retrace_data": [(RETRACE, 5)], "donated_read": [(DONATION_MISUSE, 8)],
    "impure_counter": [(IMPURE_DEVICE_FN, 4)],
    "impure_print": [(IMPURE_DEVICE_FN, 5)],
    "impure_store": [(IMPURE_DEVICE_FN, 5)],
    "pragma_elsewhere": [(HOST_SYNC, 10)],
}


@pytest.mark.parametrize("case,jax_src,torch_src,name", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_translation_reports_the_jax_rule_at_the_same_line(
        case, jax_src, torch_src, name, tmp_path):
    ref = scan(tmp_path, jax_src, name, nt_analyze, "jax")
    got = scan(tmp_path, torch_src, name)
    assert rules_lines(got) == rules_lines(ref), got.to_text()
    assert rules_lines(got) == EXPECTED.get(case, [])
    assert len(got.suppressed) == len(ref.suppressed)
    assert (got.hot_sites, got.compiled_bodies, got.jit_sites) == \
        (ref.hot_sites, ref.compiled_bodies, ref.jit_sites)


def test_corpus_pins_all_four_classes(tmp_path):
    """The seeded torch corpus pins all four classes to file:line."""
    seeds = {"sync.py": (HOT_ITEM, HOST_SYNC, 9),
             "retrace.py": (RETRACE_CREATE_CALL, RETRACE, 8),
             "donate.py": (DONATED_READ, DONATION_MISUSE, 8),
             "impure.py": (IMPURE_COUNTER, IMPURE_DEVICE_FN, 4)}
    for name, (src, _, _) in seeds.items():
        (tmp_path / name).write_text(src)
    report = analyze_paths([str(tmp_path)])
    got = {(f.rule, Path(f.file).name, f.line) for f in report.findings}
    assert got == {(rule, name, line)
                   for name, (_, rule, line) in seeds.items()}
    assert report.exit_code == 1


def test_messages_name_the_torch_hazard(tmp_path):
    assert "float()" in scan(tmp_path, HOT_CAST, "c.py").findings[0].message
    assert "bool()" in scan(tmp_path, HOT_TRUTH, "t.py").findings[0].message
    assert "completer" in scan(tmp_path, HOT_BLOCK,
                               "w.py").findings[0].message
    assert "loop" in scan(tmp_path, RETRACE_LOOP, "l.py").findings[0].message
    assert "key" in scan(tmp_path, RETRACE_STATIC,
                         "s.py").findings[0].message
    assert "data-dependent" in scan(tmp_path, RETRACE_DATA,
                                    "d.py").findings[0].message
    assert "line 7" in scan(tmp_path, DONATED_READ,
                            "o.py").findings[0].message
    assert "capture time" in scan(tmp_path, IMPURE_COUNTER,
                                  "b.py").findings[0].message


# ------------------------------------------------- port-only corpora

TORCH_ONLY = [
    ("to_cpu", """\
class Element:
    pass

class Mover(Element):
    def chain(self, pad, buf):
        x = buf.raw.to("cpu")           # line 6
        return x
""", [(HOST_SYNC, 6)]),
    ("to_dtype_stays_on_device", """\
import torch

class Element:
    pass

class Caster(Element):
    def chain(self, pad, buf):
        x = buf.raw.to(torch.float32)
        y = torch.from_numpy(buf.meta)
        return x.tolist(), y.tolist()   # line 10: x only
""", [(HOST_SYNC, 10)]),
    ("numpy_of_device", """\
import numpy as np

class Element:
    pass

class Npcopy(Element):
    def chain(self, pad, buf):
        return np.asarray(buf.raw)      # line 8
""", [(HOST_SYNC, 8)]),
    ("synchronize_under_lock", """\
import torch

class FilterFramework:
    pass

class Fw(FilterFramework):
    def complete(self, handle):
        with self._lock:
            torch.cuda.synchronize()    # line 9: under a lock
        return handle
""", [(HOST_SYNC, 9)]),
    ("synchronize_in_the_completer_is_clean", """\
class FilterFramework:
    pass

class Fw(FilterFramework):
    def complete(self, handle):
        outs, done = handle
        done.synchronize()
        return list(outs)
""", []),
    ("graph_in_a_loop", """\
import torch

class Element:
    pass

class Capturer(Element):
    def chain(self, pad, buf):
        for c in buf.chunks:
            g = torch.cuda.CUDAGraph()  # line 9
        return g
""", [(RETRACE, 9)]),
    ("executable_built_and_called", """\
class Element:
    pass

class Once(Element):
    def chain(self, pad, buf):
        return Executable(self.fn, self.dev)([buf.raw])   # line 6
""", [(RETRACE, 6)]),
    ("cache_keyed_per_call", """\
class Element:
    pass

class Cached(Element):
    def chain(self, pad, buf):
        exe = self._exes.get(id(buf))   # line 6: never hits
        if exe is None:
            exe = self._exes[id(buf)] = Executable(self.fn, self.dev)
        return exe([buf.raw])
""", [(RETRACE, 6), (RETRACE, 8)]),
    ("cache_keyed_by_signature_is_clean", """\
class Element:
    pass

class Cached(Element):
    def chain(self, pad, buf):
        sig = signature(buf.arrays())
        exe = self._exes.get(sig)
        if exe is None:
            exe = self._exes[sig] = Executable(self.fn, self.dev)
        return exe([buf.raw])
""", []),
    ("method_handed_to_a_capture_is_captured", """\
class Segment:
    def build(self, dev):
        self._exe = Executable(self._program, dev)

    def _program(self, arrays):
        self.frames += 1                # line 6: capture time only
        return arrays
""", [(IMPURE_DEVICE_FN, 6)]),
]


@pytest.mark.parametrize("case,src,want", TORCH_ONLY,
                         ids=[c[0] for c in TORCH_ONLY])
def test_torch_only_corpus(case, src, want, tmp_path):
    assert rules_lines(scan(tmp_path, src, f"{case}.py")) == want


# ------------------------------------------------------------ self-scan

@pytest.fixture(scope="module")
def port_report():
    return analyze_paths([str(PORT_DIR)], min_hot_sites=20)


def test_self_scan_is_clean(port_report):
    """The port's own hot path carries no live finding, and the scan is
    not vacuous: it walks the runtime and sees its capture sites."""
    assert port_report.findings == [], port_report.to_text()
    assert port_report.hot_sites >= 20
    assert port_report.compiled_bodies >= 5
    assert port_report.jit_sites >= 5
    r = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch",
                        "jitcheck", "nnstreamer_tpu_torch",
                        "--min-hot-sites", "20", "-q"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_static_capture_map_covers_runtime_kinds(port_report):
    """The kinds the runtime gate observes: the torch-cuda backend
    records ``"torch-cuda"``, the fused segment ``"fusion"``."""
    assert {"torch-cuda", "fusion"} <= set(port_report.jit_site_kinds)


def test_site_kind_buckets():
    assert site_kind("nnstreamer_tpu_torch/fusion/segment.py") == "fusion"
    assert site_kind("nnstreamer_tpu_torch/filters/torch_cuda_backend.py") \
        == "torch-cuda"
    assert site_kind("nnstreamer_tpu_torch/filters/executable.py") == \
        "torch-cuda"
    assert site_kind("nnstreamer_tpu_torch/trainers/torch_cuda_trainer.py") \
        == "trainer"


# (port file, rule, outcome): the JAX jitcheck's three findings on the
# port, and the two only the port's jitcheck sees
TRIAGE = [
    ("elements/flowctl.py", HOST_SYNC, "fixed"),       # .item(), float()
    ("decoders/segment.py", IMPURE_DEVICE_FN, "pragma"),
    ("elements/delta.py", HOST_SYNC, "fixed"),
    ("tensors/transfer.py", HOST_SYNC, "pragma"),
    ("filters/executable.py", IMPURE_DEVICE_FN, "pragma"),
]


@pytest.mark.parametrize("rel,rule,outcome", TRIAGE,
                         ids=[t[0] for t in TRIAGE])
def test_triaged_finding_stays_triaged(rel, rule, outcome, port_report):
    own = analyze_paths([str(PORT_DIR / rel)])
    for report in (port_report, own):
        assert [f for f in report.findings if f.file.endswith(rel)] == []
        suppressed = [f for f in report.suppressed
                      if f.file.endswith(rel) and f.rule == rule]
        assert len(suppressed) == (1 if outcome == "pragma" else 0)


def test_tensor_if_compares_through_the_host_boundary():
    """The compared value of ``tensor_if`` crosses to the host through
    ``Chunk.host()``: the JAX jitcheck no longer sees a raw sync, and the
    value is the element the option names."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as pt
    assert nt_analyze([str(PORT_DIR / "elements/flowctl.py")]).findings \
        == []
    el = pt.make_element("tensor_if")
    el.set_property("compared-value", "A_VALUE")
    el.set_property("compared-value-option", "1:2,0")
    arr = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    buf = pt.Buffer([pt.Chunk(arr)])
    assert el._compared_value(buf) == float(arr[2, 1])
    buf = pt.Buffer([pt.Chunk(arr.numpy())])
    assert el._compared_value(buf) == float(np.float32(13.0))


# --------------------------------------------------------------------- CLI

class TestCli:
    def test_exit_zero_on_clean(self, tmp_path, capsys):
        f = tmp_path / "clean.py"
        f.write_text(CLEAN_HOST)
        assert jitcheck_main([str(f)]) == 0
        assert "0 finding(s)" in capsys.readouterr().out

    def test_exit_one_on_findings(self, tmp_path, capsys):
        f = tmp_path / "bad.py"
        f.write_text(HOT_ITEM)
        assert jitcheck_main([str(f)]) == 1
        out = capsys.readouterr().out
        assert HOST_SYNC in out and "bad.py:9" in out

    def test_exit_two_on_missing_path(self, tmp_path, capsys):
        assert jitcheck_main([str(tmp_path / "nope.py")]) == 2

    def test_exit_two_on_bad_flag(self, capsys):
        assert jitcheck_main(["--no-such-flag"]) == 2

    def test_json_round_trip(self, tmp_path, capsys):
        f = tmp_path / "bad.py"
        f.write_text(HOT_ITEM)
        assert jitcheck_main([str(f), "--json"]) == 1
        data = json.loads(capsys.readouterr().out)
        assert data["exit_code"] == 1
        assert data["findings"][0]["rule"] == HOST_SYNC
        assert data["findings"][0]["line"] == 9

    def test_output_file_written(self, tmp_path, capsys):
        f = tmp_path / "clean.py"
        f.write_text(CLEAN_COMPILED)
        out = tmp_path / "report" / "jitcheck.json"
        assert jitcheck_main([str(f), "-o", str(out), "-q"]) == 0
        data = json.loads(out.read_text())
        assert data["compiled_bodies"] == 1
        assert data["jit_sites"] == 1

    def test_min_hot_sites_guards_vacuous_scan(self, tmp_path, capsys):
        f = tmp_path / "step.py"
        f.write_text(CLEAN_COMPILED)          # compiled, but no hot path
        assert jitcheck_main([str(f), "--min-hot-sites", "2",
                              "--json"]) == 1
        data = json.loads(capsys.readouterr().out)
        assert [x["rule"] for x in data["findings"]] == [VACUOUS_COVERAGE]

    def test_verbose_lists_suppressed(self, tmp_path, capsys):
        src = HOT_ITEM.replace(
            "return y.item()  ",
            "return y.item()  # jitcheck: ok(probe boundary)")
        f = tmp_path / "probe.py"
        f.write_text(src)
        assert jitcheck_main([str(f), "-v"]) == 0
        assert "suppressed" in capsys.readouterr().out


# ------------------------------------------------- static↔runtime contract

class TestStabilityContract:
    def test_snapshot_and_steady(self):
        class FakePipe:
            def stats(self):
                return {"f0": {"jit_hits": 5, "jit_misses": 1,
                               "jit_recompiles": 0, "frames": 9},
                        "sink": {"frames": 9}}
        snap = jit_stat_snapshot(FakePipe())
        assert set(snap) == {"f0"}          # only jit-bearing elements
        assert snap["f0"] == {"jit_hits": 5, "jit_misses": 1,
                              "jit_recompiles": 0}
        assert steady_recompiles(snap) == 1

    def test_contract_clean(self):
        result = check_against_static({"torch-cuda": 3, "fusion": 1},
                                      ["torch-cuda"], 0, strict=False)
        assert result.ok

    def test_contract_rejects_steady_recompiles(self):
        with pytest.raises(AssertionError, match="frame path"):
            check_against_static(["torch-cuda"], ["torch-cuda"], 2)

    def test_contract_rejects_unpredicted_kind(self):
        with pytest.raises(AssertionError, match="statically predicted"):
            check_against_static(["torch-cuda"], ["mystery"], 0)

    def test_contract_nonstrict_collects_problems(self):
        result = check_against_static(["torch-cuda"], ["mystery"], 1,
                                      strict=False)
        assert not result.ok
        assert len(result.problems) == 2
        assert "BROKEN" in str(result)

    def test_contract_accepts_report_object(self):
        report = analyze_paths([str(PORT_DIR / "filters")])
        result = check_against_static(report, ["torch-cuda"], 0,
                                      strict=False)
        assert result.ok


class TestCaptureMonitor:
    def test_counts_the_captures_the_hook_reports(self):
        from nnstreamer_tpu_torch.filters import executable
        mon = CompileEventMonitor().install()
        try:
            assert mon.available
            with executable._capture_lock:
                executable._captured("graph_capture")
                executable._captured("pool_keeper_capture")
            assert mon.count == 2
            assert mon.events == {"graph_capture": 1,
                                  "pool_keeper_capture": 1}
            assert mon.threads == {threading.current_thread().name: 2}
            mon.reset()
            assert mon.count == 0 and mon.threads == {}

            def other():
                with executable._capture_lock:
                    executable._captured("graph_capture")
            t = threading.Thread(target=other, name="frame-thread")
            t.start()
            t.join()
            assert mon.count == 1 and mon.threads == {"frame-thread": 1}
        finally:
            mon.uninstall()
        with executable._capture_lock:
            executable._captured("graph_capture")
        assert mon.count == 1                 # uninstalled: not counted

    def test_a_cpu_line_captures_nothing(self):
        import nnstreamer_tpu_torch as pt
        mon = CompileEventMonitor().install()
        try:
            p = pt.parse_launch(
                "tensortestsrc caps=other/tensors,format=static,"
                "num_tensors=1,types=(string)float32,"
                "dimensions=(string)64:2,framerate=(fraction)0/1 "
                "num-buffers=3 ! tensor_filter framework=torch-cuda "
                "accelerator=true:cpu model=zoo://mlp?dtype=float32 "
                "name=f ! appsink name=out")
            p.run(timeout=60)
            assert len(p["out"].pop_all()) == 3
            assert mon.count == 0
            assert steady_recompiles(jit_stat_snapshot(p)) == 1
        finally:
            mon.uninstall()


# ------------------------------------------------- two-pass runtime gate

def test_jit_stability_tool_on_the_cpu_exits_0():
    """``tools/torch_jit_stability.py --device cpu``: both passes of the
    builtin corpus, no second-pass frame-path capture, the observed
    kinds within the static map."""
    r = subprocess.run([sys.executable, "tools/torch_jit_stability.py",
                        "--device", "cpu", "--json"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["device"] == "cpu"
    assert res["signatures"] >= 2
    assert set(res["observed_kinds"]) == {"torch-cuda", "fusion"}
    assert all(row["pass2_compiles"] == 0
               and row["pass2_captures_on_frames"] == 0
               for row in res["lines"])
    assert "JIT-STABILITY OK" in r.stdout


def test_jit_stability_tool_refuses_to_fall_back_to_the_cpu(monkeypatch):
    """Without ``--device cpu`` the tool wants ``cuda:0``: with no CUDA
    it raises instead of running the CPU path in its place."""
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import torch_jit_stability as tool
    finally:
        sys.path.remove(str(ROOT / "tools"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tool.run("cuda")
