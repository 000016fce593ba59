#!/usr/bin/env python
"""Sharded-serving byte-parity gate for the PyTorch/CUDA port: a mesh
line's output must equal its single-device line's.

The port of ``tools/shard_parity.py``, over ``nnstreamer_tpu_torch.
parallel``. Every runnable description of the repo's corpus (read by
:mod:`nnstreamer_tpu_torch.analysis.corpus`, JAX frameworks rewritten to
``torch-cuda``, each description once) with a ``custom=mesh:...``
tensor_filter runs twice: as written (the batch split over the mesh's
``data`` axis) and with every ``mesh:`` spec stripped (one device). Every
sink's output is compared byte for byte. A built-in suite (batch-major
zoo invoke, elementwise chain, fused mesh segment) always runs. Corpus
lines run with fusion off on both sides, as in the JAX gate.

    python3 tools/torch_shard_parity.py                 # the card's world
    python3 tools/torch_shard_parity.py --device cpu    # 8 gloo ranks

With ``--device cpu`` the world is 8 gloo ranks on the host (the JAX
gate's 8 virtual CPU devices) and every filter gets
``accelerator=true:cpu``. On the card
(the default; raises without CUDA) the world is the machine's cards, and
a ``mesh:DxSxT`` that needs more devices than that is rewritten to
``Nx1x1`` over the N cards (``1x1x1`` on one card), its ``rules:`` kept;
the result counts the lines it rewrote. ``--json`` prints the result as
one JSON line last. Exit status: 1 if a mesh line gave other bytes than
its one-device twin, or if nothing was compared at all; else 0.
"""
from __future__ import annotations

import argparse
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
from nnstreamer_tpu_torch.parallel.mesh import spec_dims  # noqa: E402
from nnstreamer_tpu_torch.pipeline.parser import parse_launch  # noqa: E402

_CAPS_MLP = ("other/tensors,format=static,num_tensors=1,"
             "types=(string)float32,dimensions=(string)64:8,"
             "framerate=(fraction)0/1")
_CAPS_SEG = ("other/tensors,format=static,num_tensors=1,"
             "types=(string)float32,dimensions=(string)8:8,"
             "framerate=(fraction)0/1")

# the JAX gate's suite, translated: (name, description-with-mesh, fuse)
BUILTIN = [
    ("builtin:mlp-batch-major",
     f"tensortestsrc caps={_CAPS_MLP} num-buffers=4 ! "
     "tensor_filter framework=torch-cuda model=zoo://mlp?dtype=float32 "
     "custom=mesh:8x1x1 ! appsink name=out", False),
    ("builtin:elementwise",
     f"tensortestsrc caps={_CAPS_SEG} num-buffers=4 ! "
     "tensor_filter framework=torch-cuda model=zoo://toyseg "
     "custom=mesh:8x1x1 ! appsink name=out", False),
    ("builtin:fused-mesh-segment",
     f"tensortestsrc caps={_CAPS_SEG} num-buffers=4 ! "
     "tensor_filter framework=torch-cuda model=zoo://toyseg "
     "custom=mesh:8x1x1 ! "
     "tensor_filter framework=torch-cuda model=zoo://toyscale "
     "custom=mesh:8x1x1 ! appsink name=out", True),
]
STATUSES = ("mesh-ok", "no-mesh", "skipped", "FAIL")
CPU_RANKS = 8  # the JAX gate's xla_force_host_platform_device_count


def _mesh_filters(pipe) -> List:
    return [e for e in pipe.elements.values()
            if kind_of(e) == "tensor_filter"
            and "mesh:" in str(getattr(e, "custom", "") or "")]


def _parts(custom) -> List[str]:
    return [p.strip() for p in str(custom or "").split(",") if p.strip()]


def _strip_mesh(custom: str) -> str:
    return ",".join(p for p in _parts(custom) if not p.startswith("mesh:"))


def _fit_mesh(custom: str, pool: int) -> str:
    """``custom`` with an explicit mesh spec that needs more than
    ``pool`` devices rewritten to ``{pool}x1x1``; the rest kept."""
    out = []
    for p in _parts(custom):
        if p.startswith("mesh:"):
            dims = spec_dims(p[len("mesh:"):])
            if dims and dims[0] * dims[1] * dims[2] > pool:
                p = f"mesh:{pool}x1x1"
        out.append(p)
    return ",".join(out)


def _devices_needed(pipe) -> int:
    need = 1
    for e in _mesh_filters(pipe):
        for p in _parts(e.custom):
            if p.startswith("mesh:"):
                dims = spec_dims(p[len("mesh:"):])
                if dims:
                    need = max(need, dims[0] * dims[1] * dims[2])
    return need


def _fit(pipe, pool: int) -> bool:
    """Rewrite every mesh filter of ``pipe`` to fit ``pool`` devices;
    True if any spec changed."""
    changed = False
    for e in _mesh_filters(pipe):
        fitted = _fit_mesh(e.custom, pool)
        if fitted != ",".join(_parts(e.custom)):
            e.set_property("custom", fitted)
            changed = True
    return changed


def _run_variant(desc: str, mesh: bool, fuse: bool, device: str,
                 pool: int, timeout: float):
    """Run the line as written (``mesh=True``, specs fitted to the pool
    on the card) or with every mesh spec stripped."""
    pipe = parse_launch(desc)
    pipe.fuse = fuse
    place(pipe, device)
    if mesh:
        if device != "cpu":
            _fit(pipe, pool)
    else:
        for e in _mesh_filters(pipe):
            e.set_property("custom", _strip_mesh(e.custom))
    bound_sources(pipe)
    got = capture_sinks(pipe)
    keys = sink_keys(pipe)
    run_to_eos(pipe, timeout)
    fused = [e.name for e in pipe.elements.values()
             if getattr(e, "IS_FUSED_SEGMENT", False)]
    return {keys[n]: recs for n, recs in got.items()}, fused


def check_shard_parity(where: str, desc: str, fuse: bool = False,
                       device: str = "cuda", pool: int = 1,
                       timeout: float = 60.0) -> Tuple[str, str, bool]:
    """-> (status, detail, rewritten); status in {mesh-ok, no-mesh,
    skipped, FAIL}; ``rewritten``: a spec was fitted to the card's
    pool."""
    try:
        probe = parse_launch(desc)
    except ValueError as exc:
        return "skipped", f"not a pipeline: {exc}", False
    reason = runnable(probe)
    if reason is not None:
        return "skipped", reason, False
    if not _mesh_filters(probe):
        return "no-mesh", "no tensor_filter declares a mesh spec", False
    rewritten = device != "cpu" and _fit(probe, pool)
    need = _devices_needed(probe)
    if pool < need:
        # the sharded run could not build its mesh: no coverage
        return "skipped", (f"the world has {pool} devices, mesh needs "
                           f"{need}"), rewritten
    place(probe, device)
    if analyze(probe).errors:
        return "skipped", "pipelint rejects it (validation gate)", rewritten
    try:
        one_out, _ = _run_variant(desc, False, fuse, device, pool, timeout)
    except Exception as exc:  # noqa: BLE001
        # the line cannot run even without a mesh: not a sharding
        # defect, no coverage
        return ("skipped", f"baseline (single-device) run crashed: "
                f"{exc!r}", rewritten)
    try:
        mesh_out, fused = _run_variant(desc, True, fuse, device, pool,
                                       timeout)
    except Exception as exc:  # noqa: BLE001
        return "FAIL", f"sharded run crashed: {exc!r}", rewritten
    if fuse and not fused:
        return ("FAIL", "fused-mesh case did not fuse in the live run",
                rewritten)
    diff = first_difference(one_out, mesh_out, "sharded bytes differ from "
                            "the single-device path")
    if diff is not None:
        return "FAIL", diff, rewritten
    nbuf = sum(len(v) for v in one_out.values())
    return "mesh-ok", (f"{need} devices"
                       + (f", {len(fused)} fused segment(s)" if fused
                          else "")
                       + f", {nbuf} buffers identical"), rewritten


def run(device: str = "cuda", paths: Optional[List[Path]] = None,
        timeout: float = 60.0, verbose: bool = False) -> Dict:
    """The gate over BUILTIN and the corpus in one world; the result as a
    dict (``rc``, ``counts``, per-line ``results``, ``rewritten``,
    ``world``, ``failures``, ``seconds``)."""

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_shard_parity: no CUDA device; pass "
                           "--device cpu to run on gloo ranks")
    t0 = time.perf_counter()
    counts = {s: 0 for s in STATUSES}
    results: List[List[str]] = []
    failures: List[str] = []
    rewritten = 0
    candidates = distinct(BUILTIN + [(w, d, False)
                                     for w, d in port_corpus(paths)])
    with mesh_world(device, CPU_RANKS) as pool:
        for where, desc, fuse in candidates:
            status, detail, fitted = check_shard_parity(
                where, desc, fuse, device, pool, timeout)
            counts[status] += 1
            rewritten += bool(fitted) and status != "skipped"
            results.append([where, desc, status, detail])
            if status == "FAIL":
                failures.append(f"{where}: {detail}\n    {desc}")
            if verbose or status == "FAIL":
                print(f"[{status}] {where}: {detail}", flush=True)
    vacuous = counts["mesh-ok"] == 0
    return {"gate": "shard-parity", "device": device, "world": pool,
            "rc": 1 if failures or vacuous else 0, "counts": counts,
            "vacuous": vacuous, "rewritten": rewritten,
            "seconds": time.perf_counter() - t0, "results": results,
            "failures": failures}


def summary(res: Dict) -> str:
    c = res["counts"]
    return (f"shard-parity: {c['mesh-ok']} pipelines byte-identical "
            f"sharded vs single-device, {c['no-mesh']} had no mesh, "
            f"{c['skipped']} skipped, {c['FAIL']} failures "
            f"(world of {res['world']} {res['device']} rank(s), "
            f"{res['rewritten']} mesh line(s) fitted to it)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="files to scan (default: "
                    "tests/*.py and README.md)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the cards (default; raises without CUDA) or "
                         "gloo ranks on the CPU")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON line last")
    opts = ap.parse_args(argv)
    res = run(opts.device, [Path(p) for p in opts.paths] or None,
              opts.timeout, opts.verbose)
    print(summary(res))
    if res["vacuous"]:
        print("shard-parity: BUILTIN suite yielded no coverage — "
              "the gate is vacuous", file=sys.stderr)
    if opts.json:
        print(json.dumps(res))
    return res["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
