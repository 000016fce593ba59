"""Where a frame's time goes in the port's ViT-B/16 labeling line on a GPU.

    python3 tools/torch_vit_profile.py [--frames N]

Runs chip_smoke.py's line with an ``appsrc`` in place of
``tensortestsrc`` (appsrc ! tensor_filter framework=torch-cuda
model="zoo://vit?attn=pallas" ! tensor_decoder mode=image_labeling !
appsink; full-width ViT-B/16, seeded random weights, batch 1 per frame),
so the frames (made as tensortestsrc makes them, before the run) can be
pushed after the model is open and warm: 4 warm-up frames, then N frames
timed, then N frames under torch.profiler. Prints the card, the frame
time (p50 gap between frames at the sink, plain and profiled), device
kernel time and launches per frame in the profiled window, the device's
idle share (1 - kernel time / frame time), and the kernels that take the
most device time. Frame generation is not in the frame time here; it is
in chip_smoke.py's. CPU ops are not listed: the model runs on the
pipeline's source thread, which the profiler's CPU side does not follow.
Needs a CUDA device; exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
        "dimensions=(string)3:224:224,framerate=(fraction)0/1")
WARMUP = 4


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_vit_profile: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import nnstreamer_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile

    n = args.frames
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (224, 224, 3), np.uint8, endpoint=True)
              for _ in range(WARMUP + 2 * n)]
    arrivals = []
    arrived = threading.Condition()

    def on_frame(buf):
        with arrived:
            arrivals.append(time.perf_counter())
            arrived.notify_all()

    def push(lo, hi):
        for i in range(lo, hi):
            pipe["src"].push_buffer(pt.Buffer.from_arrays([frames[i]], pts=i))
        with arrived:
            if not arrived.wait_for(lambda: len(arrivals) >= hi, 600):
                sys.exit(f"{len(arrivals)} of {hi} frames arrived")
        return float(np.percentile(np.diff(arrivals[lo:hi]) * 1e3, 50))

    with tempfile.TemporaryDirectory() as tmp:
        labels = os.path.join(tmp, "labels.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"class{i}" for i in range(1000)))
        pipe = pt.parse_launch(
            f"appsrc name=src caps={CAPS} ! tensor_filter "
            'framework=torch-cuda model="zoo://vit?attn=pallas" '
            f"! tensor_decoder mode=image_labeling option1={labels} "
            "! appsink name=out")
        pipe["out"].connect(on_frame)
        pipe.start()
        try:
            push(0, WARMUP)
            plain_ms = push(WARMUP, WARMUP + n)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_ms = push(WARMUP + n, WARMUP + 2 * n)
            pipe["src"].end_stream()
            pipe.wait_eos(60)
        finally:
            pipe.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("torch_vit_profile: the profiler recorded no device kernel")
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    print(f"frame time p50: {plain_ms:.3f} ms plain, {prof_ms:.3f} ms "
          f"profiled; device kernel time {dev_ms:.3f} ms/frame over "
          f"{launches:.1f} kernel launches/frame; device idle share "
          f"{1 - dev_ms / plain_ms:.3f} (plain), {1 - dev_ms / prof_ms:.3f} "
          f"(profiled); {smi}", flush=True)
    print("top kernels by device time (ms/frame, launches/frame):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.4f} "
              f"{e.count / n:6.1f}  {e.key[:110]}")


if __name__ == "__main__":
    main()
