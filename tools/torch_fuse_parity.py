#!/usr/bin/env python
"""Fusion and in-flight byte-parity gates for the PyTorch/CUDA port.

The port of ``tools/fuse_parity.py``. Every runnable description of the
repo's corpus (``tests/*.py`` string literals and ``README.md`` code
blocks, read by :mod:`nnstreamer_tpu_torch.analysis.corpus`, JAX
frameworks rewritten to ``torch-cuda``, each description once) runs
twice and every sink's output is compared byte for byte (dtype, shape,
raw bytes, per buffer, per chunk):

* ``--mode fuse`` (default): fused (one CUDA graph a segment on the
  card) against ``fuse=false`` (one graph a filter), the segments planned
  by ``fusion.plan_fusion``. Status ``fused-ok``, ``unfused``,
  ``skipped`` or ``FAIL``.
* ``--mode async``: unfused, every synchronous filter at
  ``in-flight=K reorder=true`` against ``in-flight=1``, sinks keyed by
  parse position. Status ``async-ok``, ``no-filter``, ``skipped`` or
  ``FAIL``.

A built-in suite (filter into decoder, transform chains, mux fan-in,
crop fan-out) always runs, so the gate compares something even where the
corpus yields nothing to fuse. A line that needs a network peer, a file
on disk, hardware or another framework is skipped and counted.

A line compares only what its filters made. Where a filter (or a fused
segment) lost frames to failed invokes in either twin, or no buffer
reached a sink, the line is ``skipped`` with that reason, not passed:
equal empty sinks prove nothing. On the card such a loss (and the
async gate's crashed synchronous twin) is skipped only where the same
line on the CPU loses as many frames (crashes too): the line's input
does not fit its model. A loss the card alone shows is ``FAIL``.

    python3 tools/torch_fuse_parity.py                       # on cuda:0
    python3 tools/torch_fuse_parity.py --device cpu          # on the CPU
    python3 tools/torch_fuse_parity.py --mode async --device cpu

It runs on ``cuda:0`` unless ``--device cpu`` is given (which puts
``accelerator=true:cpu`` on every filter) and raises without CUDA.
``--json`` prints the result as one JSON line last. Exit status: 1 if a
line that fused (or windowed) gave other bytes than its twin, or if
nothing was compared at all; else 0.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from nnstreamer_tpu_torch.analysis import analyze  # noqa: E402
from nnstreamer_tpu_torch.analysis.corpus import (  # noqa: E402
    bound_sources, capture_sinks, distinct, first_difference, mesh_world,
    place, port_corpus, run_to_eos, runnable, sink_keys)
from nnstreamer_tpu_torch.analysis.rules import kind_of  # noqa: E402
from nnstreamer_tpu_torch.fusion import plan_fusion  # noqa: E402
from nnstreamer_tpu_torch.models.vit import MultiHeadAttention  # noqa: E402
from nnstreamer_tpu_torch.ops import attention  # noqa: E402
from nnstreamer_tpu_torch.parallel.world import host_devices  # noqa: E402
from nnstreamer_tpu_torch.pipeline.parser import parse_launch  # noqa: E402

_CAPS_U8 = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)uint8,dimensions=(string)3:4:4,"
            "framerate=(fraction)0/1")
_CAPS_SEG = ("other/tensors,format=static,num_tensors=1,"
             "types=(string)float32,dimensions=(string)8:8,"
             "framerate=(fraction)0/1")
_CAPS_INFO = ("other/tensors,format=static,num_tensors=1,"
              "types=(string)uint32,dimensions=(string)4,"
              "framerate=(fraction)0/1")
# the JAX gate's suite, translated
BUILTIN = [
    ("builtin:filter-decoder",
     f"tensortestsrc caps={_CAPS_SEG} num-buffers=4 ! "
     "tensor_filter framework=torch-cuda model=zoo://toyseg ! "
     "tensor_decoder mode=image_segment ! appsink name=out"),
    ("builtin:transform-chain",
     f"tensortestsrc caps={_CAPS_U8} num-buffers=4 ! "
     "tensor_transform mode=typecast option=float32 ! "
     "tensor_transform mode=arithmetic option=mul:2,add:1 ! "
     "tensor_transform mode=transpose option=1:0:2 ! appsink name=out"),
    ("builtin:mux-transform",
     "tensor_mux name=m ! "
     "tensor_transform mode=typecast option=float32 ! "
     "tensor_transform mode=arithmetic option=div:2 ! appsink name=out "
     f"tensortestsrc caps={_CAPS_U8} num-buffers=3 ! m.sink_0 "
     f"tensortestsrc caps={_CAPS_U8} num-buffers=3 ! m.sink_1"),
    ("builtin:transform-crop",
     "tensor_crop name=c ! appsink name=out "
     f"tensortestsrc caps={_CAPS_U8} num-buffers=5 ! "
     "tensor_transform mode=typecast option=float32 ! "
     "tensor_transform mode=arithmetic option=mul:2 ! c.raw "
     f"tensortestsrc caps={_CAPS_INFO} num-buffers=5 ! c.info"),
]

STATUSES = {"fuse": ("fused-ok", "unfused", "skipped", "FAIL"),
            "async": ("async-ok", "no-filter", "skipped", "FAIL")}


def _parse(desc: str, device: str):
    pipe = parse_launch(desc)
    place(pipe, device)
    bound_sources(pipe)
    return pipe


def _hand_attention(fw) -> int:
    """Attention-kernel launches one call of an open backend's model
    makes on the card: the built model's attention modules that route
    through ``ops.fused_attention``; 0 for a backend on the CPU."""
    module = getattr(fw, "module", None)
    device = getattr(fw, "device", None)
    if not isinstance(module, torch.nn.Module) \
            or getattr(device, "type", None) != "cuda":
        return 0
    return sum(isinstance(m, MultiHeadAttention) and m.fused
               for m in module.modules())


def _read_run(pipe) -> Dict[str, int]:
    """A finished run, read before its backends close: ``lost``, the
    frames its filters (and fused segments) lost to failed invokes, and
    ``attention``, the launches its calls should have made on the card
    (a filter's completed invokes, a segment's dispatched frames, times
    each built model's hand-attention modules)."""
    lost = expected = 0
    for e in pipe.elements.values():
        if getattr(e, "IS_FUSED_SEGMENT", False):
            lost += e.stats.snapshot().get("dropped", 0)
            calls = e.stats["jit_hits"] + e.stats["jit_misses"]
            members = e.members
        elif kind_of(e) == "tensor_filter":
            lost += e.stats["invoke_errors"]
            calls, members = e.invokes, [e]
        else:
            continue
        expected += calls * sum(_hand_attention(getattr(m, "fw", None))
                                for m in members)
    return {"lost": lost, "attention": expected}


def _run_line(pipe, timeout: float, tally: Optional[Dict]) -> int:
    """Run a parsed line to EOS; the frames it lost to failed invokes.
    ``tally`` books the run: ``runs``, ``attention`` (the launches the
    run made, read off the kernel's counter) and
    ``attention_expected`` (:func:`_read_run`)."""
    read: Dict[str, int] = {}
    before = attention.launches
    try:
        run_to_eos(pipe, timeout, lambda p: read.update(_read_run(p)))
    finally:
        if tally is not None:
            tally["runs"] += 1
            tally["attention"] += attention.launches - before
            tally["attention_expected"] += read.get("attention", 0)
    return read["lost"]


def _run_once(desc: str, fuse: bool, device: str, timeout: float,
              tally: Optional[Dict] = None):
    pipe = _parse(desc, device)
    pipe.fuse = fuse
    got = capture_sinks(pipe)
    lost = _run_line(pipe, timeout, tally)
    fused = [e.name for e in pipe.elements.values()
             if getattr(e, "IS_FUSED_SEGMENT", False)]
    return got, fused, lost


def _run_async(desc: str, k: int, device: str, timeout: float,
               tally: Optional[Dict] = None):
    """Run UNFUSED with every synchronous filter at a k-frame in-flight
    window (reorder on); k=1 is the synchronous twin."""
    pipe = _parse(desc, device)
    pipe.fuse = False
    for e in pipe.elements.values():
        if kind_of(e) == "tensor_filter" \
                and not getattr(e, "invoke_async", False):
            e.set_property("in-flight", k)
            e.set_property("reorder", True)
    got = capture_sinks(pipe)
    keys = sink_keys(pipe)
    lost = _run_line(pipe, timeout, tally)
    # a stopped filter keeps its (stopped) executor
    windowed = [e.name for e in pipe.elements.values()
                if getattr(e, "_overlap", None) is not None]
    return {keys[n]: recs for n, recs in got.items()}, windowed, lost


def _lost_verdict(desc: str, lost: Tuple[int, int], device: str,
                  timeout: float, twin) -> Tuple[str, str]:
    """The status of a line whose twins lost ``lost`` frames to failed
    invokes (their outputs equal): skipped, with the reason, where the
    CPU loses as many on ``twin``'s run of the line (the input does not
    fit the model); FAIL where only the card does."""
    what = f"{lost[0]} and {lost[1]} frame(s) lost to failed invokes"
    nothing = "; nothing of theirs compared"
    if device == "cpu":
        return "skipped", what + nothing
    try:
        cpu_lost = twin(desc, "cpu", timeout)[-1]
    except Exception as exc:  # noqa: BLE001
        return "FAIL", f"{what} on the card; the CPU run crashed: {exc!r}"
    if cpu_lost != lost[1]:
        return "FAIL", (f"{what} on the card, {cpu_lost} on the CPU: the "
                        "card's invokes fail where the CPU's do not")
    return "skipped", f"{what}, as many on the CPU{nothing}"


def _probe(desc: str, device: str):
    """(pipeline, None) when the line can run here, else (None, (status,
    detail))."""
    try:
        probe = parse_launch(desc)
    except ValueError as exc:
        return None, ("skipped", f"not a pipeline: {exc}")
    reason = runnable(probe)
    if reason is not None:
        return None, ("skipped", reason)
    place(probe, device)
    return probe, None


def _nothing_compared(out: Dict[str, list]) -> Optional[Tuple[str, str]]:
    if not any(out.values()):
        return "skipped", "no buffer reached a sink: nothing compared"
    return None


def check_parity(where: str, desc: str, device: str = "cuda",
                 timeout: float = 60.0,
                 tally: Optional[Dict] = None) -> Tuple[str, str]:
    """-> (status, detail); status in {fused-ok, unfused, skipped, FAIL}.
    ``tally`` books each run (:func:`_run_line`)."""
    probe, verdict = _probe(desc, device)
    if verdict is not None:
        return verdict
    if analyze(probe).errors:
        return "skipped", "pipelint rejects it (validation gate)"
    try:
        if not plan_fusion(probe).segments:
            return "unfused", "planner finds nothing to fuse"
    except Exception as exc:  # noqa: BLE001 -- report, don't crash the gate
        return "FAIL", f"planner crashed: {exc!r}"
    finally:
        probe.stop()  # the planner opens the models (and a mesh's world)
    try:
        fused_out, fused, fused_lost = _run_once(desc, True, device,
                                                 timeout, tally)
        plain_out, _, plain_lost = _run_once(desc, False, device, timeout,
                                             tally)
    except Exception as exc:  # noqa: BLE001
        return "FAIL", f"run crashed: {exc!r}"
    if not fused:
        return "FAIL", "planner fused the probe but not the live run"
    diff = first_difference(plain_out, fused_out,
                            "fused bytes differ from the chain path")
    if diff is not None:
        return "FAIL", diff
    if fused_lost or plain_lost:
        return _lost_verdict(
            desc, (fused_lost, plain_lost), device, timeout,
            lambda d, dev, t: _run_once(d, False, dev, t))
    empty = _nothing_compared(plain_out)
    if empty is not None:
        return empty
    nbuf = sum(len(v) for v in plain_out.values())
    return "fused-ok", f"{len(fused)} segment(s), {nbuf} buffers identical"


def check_async_parity(where: str, desc: str, device: str = "cuda",
                       k: int = 4, timeout: float = 60.0,
                       tally: Optional[Dict] = None) -> Tuple[str, str]:
    """-> (status, detail); status in {async-ok, no-filter, skipped,
    FAIL}. The windowed run (in-flight=k) against the synchronous run
    (in-flight=1) of the same unfused line."""
    probe, verdict = _probe(desc, device)
    if verdict is not None:
        return verdict
    if not [e for e in probe.elements.values()
            if kind_of(e) == "tensor_filter"
            and not getattr(e, "invoke_async", False)]:
        return "no-filter", "no synchronous tensor_filter to window"
    if analyze(probe).errors:
        return "skipped", "pipelint rejects it (validation gate)"
    try:
        sync_out, _, sync_lost = _run_async(desc, 1, device, timeout, tally)
    except Exception as exc:  # noqa: BLE001
        # the line cannot run even without a window: not an async
        # defect, no coverage -- where the CPU cannot run it either
        return _sync_crash_verdict(desc, device, timeout, exc)
    try:
        async_out, windowed, async_lost = _run_async(desc, k, device,
                                                     timeout, tally)
    except Exception as exc:  # noqa: BLE001
        return "FAIL", f"windowed run crashed: {exc!r}"
    if not windowed:
        return "no-filter", "no filter backend took the in-flight window"
    diff = first_difference(sync_out, async_out,
                            "windowed bytes differ from the sync path")
    if diff is not None:
        return "FAIL", diff
    if async_lost or sync_lost:
        return _lost_verdict(
            desc, (async_lost, sync_lost), device, timeout,
            lambda d, dev, t: _run_async(d, 1, dev, t))
    empty = _nothing_compared(sync_out)
    if empty is not None:
        return empty
    nbuf = sum(len(v) for v in sync_out.values())
    return "async-ok", (f"window={k} on {len(windowed)} filter(s), "
                        f"{nbuf} buffers identical")


def _sync_crash_verdict(desc: str, device: str, timeout: float,
                        exc: Exception) -> Tuple[str, str]:
    what = f"baseline (sync) run crashed: {exc!r}"
    if device == "cpu":
        return "skipped", what
    try:
        _run_async(desc, 1, "cpu", timeout)
    except Exception:  # noqa: BLE001
        return "skipped", f"{what} (on the CPU too)"
    return "FAIL", f"{what} on the card; the CPU runs it"


def run(mode: str = "fuse", device: str = "cuda",
        paths: Optional[List[Path]] = None, timeout: float = 60.0,
        window: int = 4, verbose: bool = False) -> Dict:
    """The gate over BUILTIN and the corpus; the result as a dict
    (``rc``, ``counts``, per-line ``results`` [where, desc, status, detail],
    ``failures``, ``seconds``, ``lines_run``: lines that ran at least one
    pipeline, ``runs``, ``attention_launches``: the attention kernel's
    launches over the runs, read off its counter, and by line in
    ``line_launches``; ``attention_expected``: what the runs' completed
    invokes should have launched, from each built model). On the CPU the
    mesh lines share one world of the host pool's ranks
    (``parallel.mesh.set_host_devices``, one by default), as the JAX
    gate's lines get the virtual CPU devices of their process; a mesh
    larger than the pool fails to build and its line is skipped."""

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_fuse_parity: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    ranks = host_devices() if device == "cpu" else 1
    with (mesh_world(device, ranks) if ranks > 1
          else contextlib.nullcontext()):
        return _run(mode, device, paths, timeout, window, verbose)


def _run(mode, device, paths, timeout, window, verbose) -> Dict:
    t0 = time.perf_counter()
    counts = {s: 0 for s in STATUSES[mode]}
    results: List[List[str]] = []
    failures: List[str] = []
    tally = {"runs": 0, "attention": 0, "attention_expected": 0}
    lines_run = 0
    line_launches: Dict[str, int] = {}
    for where, desc in distinct(BUILTIN + port_corpus(paths)):
        runs, launched = tally["runs"], tally["attention"]
        if mode == "async":
            status, detail = check_async_parity(where, desc, device,
                                                window, timeout, tally)
        else:
            status, detail = check_parity(where, desc, device, timeout,
                                          tally)
        lines_run += tally["runs"] > runs
        if tally["attention"] > launched:
            line_launches[where] = tally["attention"] - launched
        counts[status] += 1
        results.append([where, desc, status, detail])
        if status == "FAIL":
            failures.append(f"{where}: {detail}\n    {desc}")
        if verbose or status == "FAIL":
            print(f"[{status}] {where}: {detail}", flush=True)
    vacuous = counts[STATUSES[mode][0]] == 0
    rc = 1 if failures or vacuous else 0
    return {"gate": f"{mode}-parity", "mode": mode, "device": device,
            "rc": rc, "counts": counts, "vacuous": vacuous,
            "lines_run": lines_run, "runs": tally["runs"],
            "attention_launches": tally["attention"],
            "attention_expected": tally["attention_expected"],
            "line_launches": line_launches,
            "seconds": time.perf_counter() - t0, "results": results,
            "failures": failures}


def summary(res: Dict) -> str:
    c = res["counts"]
    ok_key, none_key = STATUSES[res["mode"]][:2]
    verb = "window" if res["mode"] == "async" else "fuse"
    return (f"{res['mode']}-parity: {c[ok_key]} pipelines byte-identical, "
            f"{c[none_key]} had nothing to {verb}, {c['skipped']} skipped, "
            f"{c['FAIL']} failures")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="files to scan (default: "
                    "tests/*.py and README.md)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--mode", choices=("fuse", "async"), default="fuse",
                    help="fuse: fused against the chain path (default); "
                    "async: windowed against synchronous")
    ap.add_argument("--window", type=int, default=4,
                    help="in-flight window for --mode async (default 4)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda:0 (default; raises without CUDA) or the CPU")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON line last")
    opts = ap.parse_args(argv)
    res = run(opts.mode, opts.device,
              [Path(p) for p in opts.paths] or None, opts.timeout,
              opts.window, opts.verbose)
    for line in res["failures"]:
        print(line)
    print(summary(res))
    if res["vacuous"]:
        print(f"{opts.mode}-parity: BUILTIN suite yielded no coverage — "
              "the gate is vacuous", file=sys.stderr)
    if opts.json:
        print(json.dumps(res))
    return res["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
