#!/usr/bin/env python3
"""obs-overhead gate for the PyTorch/CUDA port: recording spans must cost
less than 3 % fps.

The port of ``tools/obs_overhead.py``. It runs the devres row (a
device-resident ``tensortestsrc`` pool, a queue, the filter with
``prefetch-host=true``, a delivery queue, an appsink that materialises
every buffer on the host) in SUBPROCESSES, with the observability plane
on (``NNS_TPU_OBS=1``, the default) and hard off (``NNS_TPU_OBS=0``, the
control arm); the switch is read at import, so the arms never share an
interpreter. Reps interleave the arms (off, on, off, on, ...) so drift in
the machine's load lands on both, and each arm keeps its best rep: the
gate compares ceilings, so a pause in one rep does not fail it, while
the systematic cost it bounds survives best-of.

* On the card (the default; raises without CUDA) the row is
  ``bench.py``'s ``bench_pipeline_devres`` at full width: MobileNet-v2,
  batch 32 (``3:224:224:32`` uint8), ``device=true unique=true``, queues
  of 8 and 32, 40 warm-up buffers and 200 measured. The queues are the
  Python queue on both devices (``backend=python``), whatever native
  ring library a build left on disk.
* With ``--device cpu`` it is the JAX gate's CI-sized row: a zoo MLP
  (1024 → 4096 → 256, f32) on 1024-float frames, 60 warm-up and 600
  measured, ``accelerator=true:cpu`` and the source staged on the host.

    python3 tools/torch_obs_overhead.py [--device cpu] [--reps 3] [--json]

Exit 0 = within budget; 1 = overhead above budget; 2 = harness failure
(a child failed or saw too few buffers). ``--json`` prints the result as
one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BUDGET_PCT = 3.0
# (caps dims, type, model, frames, warm-up) of each device's row
ROWS = {
    "cuda": ("3:224:224:32", "uint8", "zoo://mobilenet_v2", 200, 40),
    "cpu": ("1024", "float32",
            '"zoo://mlp?in_dim=1024&hidden=4096&out_dim=256&dtype=float32"',
            600, 60),
}


class HarnessError(RuntimeError):
    """A child run failed: the gate measured nothing (exit 2)."""


def row_desc(device: str, frames: int, warmup: int) -> str:
    dims, dtype, model, _, _ = ROWS[device]
    caps = (f'"other/tensors,format=static,num_tensors=1,'
            f'types=(string){dtype},dimensions=(string){dims},'
            f'framerate=(fraction)0/1"')
    acc = " accelerator=true:cpu" if device == "cpu" else ""
    staged = "true" if device == "cuda" else "false"
    return (f"tensortestsrc caps={caps} pattern=random device={staged} "
            f"unique=true num-buffers={warmup + frames} "
            "! queue max-size-buffers=8 backend=python "
            f"! tensor_filter framework=torch-cuda model={model}{acc} "
            "prefetch-host=true ! queue max-size-buffers=32 backend=python "
            "! appsink name=out")


def run_child(device: str, frames: int, warmup: int,
              timeout: float = 300.0) -> Dict:
    """One measured run in THIS process: the fps over the measured
    buffers, the spans the run recorded and the hand kernels' launches
    in this process (the parent's counters never see a child's)."""
    import threading

    from nnstreamer_tpu_torch.obs import spans
    from nnstreamer_tpu_torch.ops import attention, normalize
    from nnstreamer_tpu_torch.pipeline.parser import parse_launch

    pipe = parse_launch(row_desc(device, frames, warmup))
    mark = {"n": 0, "t0": None, "t1": None}
    done = threading.Event()

    def on_buffer(buf):
        buf.host_arrays()  # materialise: deliver, don't just dispatch
        mark["n"] += 1
        if mark["n"] == warmup:
            mark["t0"] = time.perf_counter()
        elif mark["n"] == warmup + frames:
            mark["t1"] = time.perf_counter()
            done.set()

    spans.clear()
    pipe["out"].connect(on_buffer)
    pipe.start()
    ok = done.wait(timeout=timeout)
    pipe.stop()
    if not ok or mark["t0"] is None or mark["t1"] is None:
        return {"error": f"saw {mark['n']} buffers"}
    return {"fps": frames / (mark["t1"] - mark["t0"]),
            "spans": len(spans.snapshot()), "obs": spans.enabled(),
            "device": device,
            "launches": {"attention": attention.launches,
                         "normalize": normalize.launches}}


def run_once(obs_on: bool, device: str, frames: int, warmup: int,
             timeout: float = 600.0) -> Dict:
    """One arm's rep in a fresh interpreter; its JSON line as a dict."""
    env = dict(os.environ, NNS_TPU_OBS="1" if obs_on else "0",
               NNS_TPU_FLIGHT_DIR="")  # no abort dumps from the bench
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           "--device", device, "--frames", str(frames),
           "--warmup", str(warmup)]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    lines = out.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1]) if lines else {}
    except ValueError:
        res = {}
    if out.returncode != 0 or "fps" not in res:
        raise HarnessError(
            f"child (obs={'on' if obs_on else 'off'}) failed with "
            f"{out.returncode}:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return res


def verdict(off: Sequence[float], on: Sequence[float],
            budget_pct: float = BUDGET_PCT) -> Tuple[float, int]:
    """(loss %, exit code) of the best-of comparison: the traced arm's
    best fps against the control arm's best."""
    best_off, best_on = max(off), max(on)
    loss_pct = (best_off - best_on) / best_off * 100.0 if best_off else 0.0
    return loss_pct, 0 if loss_pct <= budget_pct else 1


def run(device: str = "cuda", frames: int = 0, warmup: int = 0,
        reps: int = 3, budget_pct: float = BUDGET_PCT) -> Dict:
    """Both arms, interleaved; the result as a dict (``rc``, each arm's
    fps, ``loss_pct``, ``seconds``, ``launches``: the hand kernels'
    launches summed over the children). ``frames``/``warmup`` 0 take the
    row's own."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_obs_overhead: no CUDA device; pass "
                           "--device cpu to run the CPU row")
    frames = frames or ROWS[device][3]
    warmup = warmup or ROWS[device][4]
    t0 = time.perf_counter()
    samples: Dict[bool, List[float]] = {False: [], True: []}
    spans_seen: Dict[bool, List[int]] = {False: [], True: []}
    launches = {"attention": 0, "normalize": 0}
    res = {"gate": "obs-overhead", "device": device, "frames": frames,
           "warmup": warmup, "reps": reps, "budget_pct": budget_pct,
           "row": row_desc(device, frames, warmup)}
    try:
        for _ in range(reps):      # interleaved: drift hits both arms
            for obs_on in (False, True):
                child = run_once(obs_on, device, frames, warmup)
                samples[obs_on].append(child["fps"])
                spans_seen[obs_on].append(child["spans"])
                for kernel, n in child["launches"].items():
                    launches[kernel] += n
    except HarnessError as exc:
        res.update(rc=2, error=str(exc),
                   seconds=time.perf_counter() - t0)
        return res
    loss_pct, rc = verdict(samples[False], samples[True], budget_pct)
    res.update(rc=rc, fps_off=samples[False], fps_on=samples[True],
               spans_off=spans_seen[False], spans_on=spans_seen[True],
               best_off=max(samples[False]), best_on=max(samples[True]),
               loss_pct=loss_pct, launches=launches,
               seconds=time.perf_counter() - t0)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card's devres row (default; raises without "
                         "CUDA) or the CPU row")
    ap.add_argument("--frames", type=int, default=0,
                    help="measured buffers (default: the row's)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="warm-up buffers (default: the row's)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--budget-pct", type=float, default=BUDGET_PCT)
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON line last")
    args = ap.parse_args(argv)
    if args.child:
        out = run_child(args.device, args.frames or ROWS[args.device][3],
                        args.warmup or ROWS[args.device][4])
        print(json.dumps(out))
        return 0 if "fps" in out else 2
    print(f"obs-overhead gate: devres row on {args.device}, "
          "tracing on vs off")
    res = run(args.device, args.frames, args.warmup, args.reps,
              args.budget_pct)
    if res["rc"] == 2:
        print(res["error"], file=sys.stderr)
    else:
        for obs_on in (False, True):
            v = res["fps_on" if obs_on else "fps_off"]
            print(f"  obs={'on ' if obs_on else 'off'}: best {max(v):.1f} "
                  f"fps (median {statistics.median(v):.1f}, "
                  f"{args.reps} reps)")
        print(f"overhead: {res['loss_pct']:+.2f}% (budget "
              f"{args.budget_pct}%) -> {'OK' if res['rc'] == 0 else 'FAIL'}")
    if args.json:
        print(json.dumps(res))
    return res["rc"]


if __name__ == "__main__":
    sys.exit(main())
