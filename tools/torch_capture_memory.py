"""Device memory around failed CUDA-graph captures and filter restarts,
and the cost of emptying the allocator's cache, on a GPU.

    python3 tools/torch_capture_memory.py [--failures N] [--restarts R]
                                          [--turns T]

Prints the card's name and power limit, then one JSON line a
measurement:

1. ``failed_captures``: ``memory_reserved()``/``memory_allocated()``
   after 8 and after 8 + N captures that fail (a program raising during
   the capture, a 1024x1024 f32 matmul before it) into one
   :class:`GraphPool`: through :class:`Executable`, whose captures all
   run on the device's one capture stream, and through the same
   sequence on a fresh ``torch.cuda.Stream()`` a capture.
2. ``restarts``: ``memory_reserved()`` after each of R + 1 opens of the
   full-width MobileNet-v2 backend (two invokes each: the capture and a
   replay), each closed before the next, all capturing into one
   :class:`GraphPool` as a ``tensor_filter``'s backends do.
3. ``empty_cache_at_close``: ``chip_smoke.py``'s DeepLab logits line
   (bench.py's bench_deeplab with ``argmax=0``: 5.5 MB of f32 a frame,
   every frame held at the sink; 8 + 48 frames) run just after the u8
   line, with ``torch.cuda.empty_cache()`` called after every backend
   close and without, in T turns of (with, without, without, with): fps
   each, as ``chip_smoke.py`` measures it.

Imports nothing of JAX. Needs one CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _mib(n):
    return n / 2 ** 20


def _failing(xs):
    y = xs[0] @ xs[0]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("capture refused")
    return [y]


def _capture_on_fresh_stream(fn, x, pool):
    """One capture the way a fresh side stream a capture does it: the
    eager warm-up, then capture_begin/capture_end on a new stream."""
    from nnstreamer_tpu_torch.filters.executable import _capture_lock
    static = [x.clone()]
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with _capture_lock, torch.cuda.stream(side), torch.inference_mode():
        [o.clone() for o in fn(static)]
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            fn(static)
        finally:
            graph.capture_end()
    current.wait_stream(side)


def failed_captures(n):
    from nnstreamer_tpu_torch.filters.executable import Executable, GraphPool
    dev = torch.device("cuda", 0)
    x = torch.randn(1024, 1024, device=dev)
    out = {}
    for name in ("capture_stream", "fresh_stream"):
        pool = GraphPool()
        marks = []
        for i in range(8 + n):
            try:
                if name == "capture_stream":
                    Executable(_failing, dev, pool.handle_for(dev))([x])
                else:
                    _capture_on_fresh_stream(_failing, x,
                                             pool.handle_for(dev))
            except RuntimeError:
                pass
            if i in (7, 7 + n):
                torch.cuda.synchronize()
                marks.append((torch.cuda.memory_reserved(),
                              torch.cuda.memory_allocated()))
        pool.release()
        (r0, a0), (r1, a1) = marks
        out[name] = {"reserved_mib_after_8": _mib(r0),
                     f"reserved_mib_after_{8 + n}": _mib(r1),
                     "allocated_growth_mib": _mib(a1 - a0),
                     "reserved_growth_mib_per_failure": _mib(r1 - r0) / n}
    return out


def restarts(r):
    import numpy as np
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.executable import GraphPool
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    pool = GraphPool()
    frame = np.random.default_rng(0).integers(0, 255, (224, 224, 3),
                                              dtype=np.uint8)
    reserved, first, same = [], None, True
    for _ in range(r + 1):
        fw = TorchCudaFilter()
        fw.open(FilterProperties(framework="torch-cuda",
                                 model_files=("zoo://mobilenet_v2",),
                                 graph_pool=pool))
        fw.invoke([frame])
        out = fw.invoke([frame])[0].cpu()
        torch.cuda.synchronize()
        reserved.append(_mib(torch.cuda.memory_reserved()))
        first = out if first is None else first
        same = same and torch.equal(out, first)
        fw.close()
    pool.release()
    return {"reserved_mib_after_each_open": reserved,
            "replays_equal": same}


def empty_cache_at_close(turns, smi):
    import chip_smoke as cs
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    close = TorchCudaFilter.close

    def close_and_empty(self):
        close(self)
        torch.cuda.empty_cache()

    n = cs.DET_WARMUP + cs.DET_FRAMES
    u8 = cs._bench_line(257, "zoo://deeplab_v3?argmax=u8", "", n)
    logits = cs._bench_line(257, "zoo://deeplab_v3?argmax=0", "", n)
    fps = {"with": [], "without": []}
    try:
        for _ in range(turns):
            for mode in ("with", "without", "without", "with"):
                TorchCudaFilter.close = close_and_empty \
                    if mode == "with" else close
                cs._run_line("deeplab u8", u8, cs.DET_WARMUP,
                             cs.DET_FRAMES, smi)
                _, row = cs._run_line(f"deeplab logits ({mode} empty_cache)",
                                      logits, cs.DET_WARMUP, cs.DET_FRAMES,
                                      smi)
                fps[mode].append(row["fps"])
    finally:
        TorchCudaFilter.close = close
    return {"logits_fps_with_empty_cache": fps["with"],
            "logits_fps_without": fps["without"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--failures", type=int, default=40)
    ap.add_argument("--restarts", type=int, default=5)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_capture_memory: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"failed_captures": failed_captures(args.failures),
                      "card": smi}), flush=True)
    print(json.dumps({"restarts": restarts(args.restarts), "card": smi}),
          flush=True)
    print(json.dumps({"empty_cache_at_close":
                      empty_cache_at_close(args.turns, smi), "card": smi}),
          flush=True)


if __name__ == "__main__":
    main()
