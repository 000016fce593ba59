"""Where a frame's time goes in one of the port's model lines on a GPU.

    python3 tools/torch_profile.py [--model vit|mobilenet_v2|
                                    ssd_mobilenet_v2|posenet|deeplab_v3|
                                    deeplab_fused]
                                   [--batch B] [--frames N]
                                   [--in-flight K] [--no-fuse]

Runs chip_smoke.py's line for the model with an ``appsrc`` in place of
``tensortestsrc``:

* ``vit`` (default): appsrc ! tensor_filter framework=torch-cuda
  model="zoo://vit?attn=pallas" ! tensor_decoder mode=image_labeling !
  appsink; full-width ViT-B/16, 1000 labels;
* ``mobilenet_v2``: the same with model=zoo://mobilenet_v2
  prefetch-host=true (width 1.0, 224x224, 1001 labels) — the headline
  line with its golden decoder;
* ``ssd_mobilenet_v2``: model="zoo://ssd_mobilenet_v2?packed=1"
  prefetch-host=true at 300x300 (91 classes, topk 100), then
  tensor_decoder mode=bounding_boxes (mobilenet-ssd-postprocess) —
  bench.py's bench_ssd line;
* ``posenet``: model="zoo://posenet?decode=device" at 257x257, then
  tensor_decoder mode=pose_estimation — bench_posenet's line;
* ``deeplab_v3``: model="zoo://deeplab_v3?argmax=u8" at 257x257, then
  tensor_decoder mode=image_segment — bench_deeplab's line;
* ``deeplab_fused``: model=zoo://deeplab_v3 (logits) prefetch-host=true,
  then tensor_decoder mode=image_segment with no queue between them —
  bench_pipeline_fused's line, which the fusion planner runs as one
  FusedSegment (one CUDA graph for the filter and the decoder);

all at full width with seeded random weights. ``--batch B`` (>1) stacks
B frames a buffer (caps ``3:S:S:B``) and drops the decoder, as the
batched line does. ``--in-flight K`` sets the filter's in-flight window;
``--no-fuse`` starts the line with ``fuse=false`` (without it a filter
directly followed by the image_segment decoder runs fused, as one
graph, in ``deeplab_v3`` as in ``deeplab_fused``).
The frames (made as tensortestsrc makes them, before the run) are pushed
after the model is open and warm: 4 warm-up buffers, then N buffers
timed, then N buffers under torch.profiler, each window pushed at once
and every buffer materialised on the host at the sink. Prints the card,
the buffer time (the window's wall time from its first push to its last
arrival, over N; and the p50 gap between arrivals), plain and profiled,
device
kernel time and kernels executed per buffer in the profiled window, the
host's launches per buffer apart from them (``cudaLaunchKernel`` and its
variants, and ``cudaGraphLaunch``, from the CUDA runtime trace: a line
that replays one captured graph a frame executes hundreds of kernels
from one host launch), the device's idle share (1 - kernel time /
buffer time), and the kernels that take the most device time. Frame generation is not in the buffer time here;
it is in chip_smoke.py's. CPU ops are not listed: the model runs on the
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
        "dimensions=(string){dims},framerate=(fraction)0/1")
WARMUP = 4
LABELS = "tensor_decoder mode=image_labeling option1={labels}"
SEGMENT = "tensor_decoder mode=image_segment option1=tflite-deeplab"
# host-side CUDA calls that launch device work
KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCH_APIS = ("cudaGraphLaunch", "cuGraphLaunch")
MODELS = {  # model property, filter options, frame size, decoder, labels
    "vit": ('"zoo://vit?attn=pallas"', "", 224, LABELS, 1000),
    "mobilenet_v2": ("zoo://mobilenet_v2", "prefetch-host=true", 224,
                     LABELS, 1001),
    "ssd_mobilenet_v2": (
        '"zoo://ssd_mobilenet_v2?packed=1"', "prefetch-host=true", 300,
        "tensor_decoder mode=bounding_boxes option1=mobilenet-ssd-postprocess"
        " option4=300:300 option5=300:300", 0),
    "posenet": ('"zoo://posenet?decode=device"', "prefetch-host=true", 257,
                "tensor_decoder mode=pose_estimation option1=257:257 "
                "option2=257:257", 0),
    "deeplab_v3": ('"zoo://deeplab_v3?argmax=u8"', "prefetch-host=true", 257,
                   SEGMENT, 0),
    "deeplab_fused": ("zoo://deeplab_v3", "prefetch-host=true", 257,
                      SEGMENT, 0),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="vit")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--in-flight", type=int, default=1)
    ap.add_argument("--no-fuse", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import nnstreamer_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile

    n, batch = args.frames, args.batch
    model, opts, size, decoder, classes = MODELS[args.model]
    shape = (size, size, 3) if batch == 1 else (batch, size, size, 3)
    dims = f"3:{size}:{size}" + ("" if batch == 1 else f":{batch}")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, shape, np.uint8, endpoint=True)
              for _ in range(WARMUP + 2 * n)]
    arrivals = []
    arrived = threading.Condition()

    def on_frame(buf):
        buf.host_arrays()  # each frame materialised at the sink
        with arrived:
            arrivals.append(time.perf_counter())
            arrived.notify_all()

    def push(lo, hi):
        """Push buffers lo..hi-1 at once and wait for them at the sink;
        returns (mean ms a buffer from the first push to the last
        arrival, p50 ms of the gaps between arrivals)."""
        t0 = time.perf_counter()
        for i in range(lo, hi):
            pipe["src"].push_buffer(pt.Buffer.from_arrays([frames[i]], pts=i))
        with arrived:
            if not arrived.wait_for(lambda: len(arrivals) >= hi, 600):
                sys.exit(f"{len(arrivals)} of {hi} frames arrived")
        mean = (arrivals[hi - 1] - t0) * 1e3 / (hi - lo)
        return mean, float(np.percentile(np.diff(arrivals[lo:hi]) * 1e3, 50))

    with tempfile.TemporaryDirectory() as tmp:
        labels = os.path.join(tmp, "labels.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"class{i}" for i in range(classes)))
        decoder = ("" if batch > 1 else
                   f"! {decoder.format(labels=labels)} ")
        pipe = pt.parse_launch(
            ("fuse=false " if args.no_fuse else "")
            + f"appsrc name=src caps={CAPS.format(dims=dims)} ! tensor_filter "
            f"framework=torch-cuda model={model} {opts} "
            f"in-flight={args.in_flight} {decoder}! appsink name=out")
        pipe["out"].connect(on_frame)
        pipe.start()
        try:
            push(0, WARMUP)
            plain_ms, plain_p50 = push(WARMUP, WARMUP + n)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_ms, prof_p50 = push(WARMUP + n, WARMUP + 2 * n)
            pipe["src"].end_stream()
            pipe.wait_eos(60)
        finally:
            pipe.stop()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("torch_profile: the profiler recorded no device kernel")
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    executed = sum(e.count for e in kernels) / n
    kernel_calls = sum(e.count for e in events
                       if e.key in KERNEL_LAUNCH_APIS) / n
    graph_calls = sum(e.count for e in events
                      if e.key in GRAPH_LAUNCH_APIS) / n
    segments = [e.name for e in pipe.elements.values()
                if getattr(e, "IS_FUSED_SEGMENT", False)]
    print(f"{args.model}, batch {batch}, in-flight {args.in_flight}, fused "
          f"segments {segments}: buffer time (mean over the window) "
          f"{plain_ms:.3f} ms plain, {prof_ms:.3f} ms profiled; p50 gap "
          f"at the sink {plain_p50:.3f} / {prof_p50:.3f} ms; device kernel "
          f"time {dev_ms:.3f} "
          f"ms/buffer over {executed:.1f} kernels executed/buffer; host "
          f"launches/buffer {kernel_calls + graph_calls:.1f} "
          f"({kernel_calls:.1f} kernel launches, {graph_calls:.1f} graph "
          f"launches); device idle share {1 - dev_ms / plain_ms:.3f} "
          f"(plain), {1 - dev_ms / prof_ms:.3f} (profiled); {smi}",
          flush=True)
    print("top kernels by device time (ms/buffer, executed/buffer):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.4f} "
              f"{e.count / n:6.1f}  {e.key[:110]}")
    print("host CUDA calls (calls/buffer):")
    for e in sorted((e for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and e.key.startswith(("cuda", "cu"))),
                    key=lambda e: e.count, reverse=True)[:10]:
        print(f"  {e.count / n:8.1f}  {e.key[:80]}")


if __name__ == "__main__":
    main()
