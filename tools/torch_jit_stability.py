#!/usr/bin/env python
"""Capture-stability gate for the PyTorch/CUDA port: a warmed process
must never capture on the frame path again.

The port of ``tools/jit_stability.py``. jitcheck's static passes prove
the hot path CAN stay on the card; this gate proves the compile cache
actually HOLDS: every builtin corpus entry runs twice with one shared
persistent CompileCache — pass 1 is the learning pass (signatures
recorded, CUDA graphs captured), pass 2 builds fresh pipelines against
the now-warm registry. A CUDA graph does not outlive its executable, so
pass 2 captures the recorded signatures again at ``open()``, on the
thread that starts the pipeline, before any frame; any capture on the
frame path in pass 2 — a filter's ``jit_recompiles``, a fused segment's
``jit_misses``, or a CUDA-graph capture the
:class:`~nnstreamer_tpu_torch.analysis.jit.CompileEventMonitor` saw on a
streaming thread — fails the gate. On top of the per-run check,
``check_against_static`` closes the static↔runtime contract: observed
CompileCache kinds must be a subset of the statically predicted
capture-site kinds, and the gate fails if the corpus recorded no
signatures at all (a gate that captured nothing proved nothing).

    python3 tools/torch_jit_stability.py                # on cuda:0
    python3 tools/torch_jit_stability.py --device cpu   # eager, no graphs

It runs on ``cuda:0`` unless ``--device cpu`` is given, and raises
without CUDA. ``--json`` prints the result as one JSON line last.
Exit status: nonzero on any second-pass frame-path capture, contract
breach, or vacuous coverage.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_CAPS_SEG = ("other/tensors,format=static,num_tensors=1,"
             "types=(string)float32,dimensions=(string)8:8,"
             "framerate=(fraction)0/1")
_CAPS_MLP = ("other/tensors,format=static,num_tensors=1,"
             "types=(string)float32,dimensions=(string)64:8,"
             "framerate=(fraction)0/1")

# Elements are NAMED: a fused segment's compile-cache key is built from
# its member names, and auto-generated names come from a process-global
# counter — unnamed, pass 2 could never find pass 1's signatures.
# "{acc}" is where --device cpu puts accelerator=true:cpu.
CORPUS = [
    # (label, description, fuse, in_flight)
    ("stability:filter",
     f"tensortestsrc caps={_CAPS_MLP} num-buffers=6 ! "
     "tensor_filter framework=torch-cuda{acc} "
     "model=zoo://mlp?dtype=float32 name=stab_f0 ! appsink name=stab_out0",
     False, 1),
    ("stability:fused-chain",
     f"tensortestsrc caps={_CAPS_SEG} num-buffers=6 ! "
     "tensor_filter framework=torch-cuda{acc} model=zoo://toyseg "
     "name=stab_f1 ! tensor_decoder mode=image_segment name=stab_d1 ! "
     "appsink name=stab_out1",
     True, 1),
    ("stability:windowed",
     f"tensortestsrc caps={_CAPS_MLP} num-buffers=6 ! "
     "tensor_filter framework=torch-cuda{acc} "
     "model=zoo://mlp?dtype=float32 name=stab_f2 ! appsink name=stab_out2",
     False, 4),
]


def _run_once(desc: str, fuse: bool, in_flight: int, timeout: float):
    """Build a FRESH pipeline (no executables — only the installed
    CompileCache persists between passes), run it, snapshot jit stats."""
    from nnstreamer_tpu_torch.analysis.jit.runtime import jit_stat_snapshot
    from nnstreamer_tpu_torch.analysis.rules import kind_of
    from nnstreamer_tpu_torch.pipeline.parser import parse_launch
    pipe = parse_launch(desc)
    pipe.fuse = fuse
    if in_flight > 1:
        for e in pipe.elements.values():
            if kind_of(e) == "tensor_filter":
                e.set_property("in-flight", in_flight)
                e.set_property("reorder", True)
    pipe.run(timeout=timeout)
    return jit_stat_snapshot(pipe)


def run(device: str = "cuda", timeout: float = 120.0,
        cache_dir: str = "") -> dict:
    """Both passes of every corpus line; the result as a dict (``ok``,
    per-line ``lines``, ``failures``)."""
    import torch

    from nnstreamer_tpu_torch.analysis.jit import (CompileEventMonitor,
                                                   analyze_paths,
                                                   check_against_static,
                                                   steady_recompiles)
    from nnstreamer_tpu_torch.fleet import cache as compile_cache

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_jit_stability: no CUDA device; pass "
                           "--device cpu to run the eager CPU path")
    acc = " accelerator=true:cpu" if device == "cpu" else ""
    root = cache_dir or tempfile.mkdtemp(prefix="nns-jitstab-")
    compile_cache.deactivate()
    cc = compile_cache.install(root, export_env=False)
    monitor = CompileEventMonitor().install()
    starter = threading.current_thread().name

    static = analyze_paths([str(ROOT / "nnstreamer_tpu_torch")])
    failures = []
    lines = []
    total_steady = 0
    try:
        for label, desc, fuse, in_flight in CORPUS:
            desc = desc.replace("{acc}", acc)
            monitor.reset()
            snap1 = _run_once(desc, fuse, in_flight, timeout)
            caps1 = monitor.count
            monitor.reset()
            snap2 = _run_once(desc, fuse, in_flight, timeout)
            at_open = monitor.threads.get(starter, 0)
            on_frames = monitor.count - at_open
            s1, s2 = steady_recompiles(snap1), steady_recompiles(snap2)
            total_steady += s2
            lines.append({"label": label, "pass1_compiles": s1,
                          "pass1_captures": caps1, "pass2_compiles": s2,
                          "pass2_captures_at_open": at_open,
                          "pass2_captures_on_frames": on_frames})
            if s2 or on_frames:
                detail = {k: v for k, v in snap2.items()
                          if v.get("jit_recompiles") or v.get("jit_misses")}
                failures.append(
                    f"{label}: {s2} second-pass compilation(s) and "
                    f"{on_frames} capture(s) on the frame path: {detail}")
    finally:
        monitor.uninstall()
        compile_cache.deactivate()

    observed = cc.kinds()
    entries = cc.entry_count()
    if len(CORPUS) < 2 or entries == 0:
        failures.append("vacuous coverage: the corpus recorded no "
                        "compile signatures — the gate proved nothing")
    try:
        check_against_static(static, observed, total_steady)
    except AssertionError as exc:
        failures.append(str(exc))
    return {"ok": not failures, "device": device, "lines": lines,
            "signatures": entries, "observed_kinds": observed,
            "static_kinds": sorted(static.jit_site_kinds),
            "static_sites": static.jit_sites,
            "hot_sites": static.hot_sites, "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda:0 (default; raises without CUDA) or the "
                         "eager CPU path")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-pipeline-run timeout (s)")
    ap.add_argument("--cache-dir", default="",
                    help="compile-cache root (default: fresh tempdir)")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON line last")
    opts = ap.parse_args(argv)

    res = run(opts.device, opts.timeout, opts.cache_dir)
    print(f"static: {res['static_sites']} capture site(s) in kinds "
          f"{res['static_kinds']}; {res['hot_sites']} hot bodies walked")
    for row in res["lines"]:
        print(f"{row['label']}: pass1 compiles={row['pass1_compiles']} "
              f"captures={row['pass1_captures']}, pass2 compiles="
              f"{row['pass2_compiles']} captures at open="
              f"{row['pass2_captures_at_open']} on frames="
              f"{row['pass2_captures_on_frames']}")
    print(f"cache: {res['signatures']} signature(s) recorded, kinds "
          f"{res['observed_kinds']}")
    if res["failures"]:
        print("JIT-STABILITY FAIL")
        for f in res["failures"]:
            print(f"  {f}")
    else:
        print("JIT-STABILITY OK: zero second-pass frame-path captures; "
              f"observed kinds {res['observed_kinds']} ⊆ static "
              f"{res['static_kinds']}")
    if opts.json:
        print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
