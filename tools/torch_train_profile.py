"""Where a training step's time goes in the port's trainer on a GPU.

    python3 tools/torch_train_profile.py [--model ZOO_SPEC] [--batch B]
                                         [--val V] [--steps N]

Creates chip_smoke.py phase 38's trainer on the card (the ``torch-cuda``
trainer on ``zoo://vit?lr=1e-4``: ViT-B/16 at full width, stock
attention, bf16 compute, Adam) and runs one epoch's work the way its
training loop does, on B seeded 224x224x3 frames and V validation
frames, without a pipeline around it:

* per part, host clock around work that ends in a synchronize, over N
  steps after 2 warm-up steps: ``batch`` (the samples stacked with numpy
  and copied to the card: ``_batch_of``), ``step`` (forward, backward
  and Adam: ``_step``, which reads the loss back), ``val`` (the
  validation forward under no_grad) — against phase 38's ms a step,
  which also holds the samples' path through the pipeline;
* under torch.profiler, N more steps: kernels executed and device
  kernel time a step, the device's idle share (1 - kernel time / the
  unprofiled step's host-clock time; the profiler's own overhead
  stretches its wall time), host-side kernel launches a step, and the
  kernels that take the most device time;
* the step's bound: 6 x parameters x tokens (B x patches) operations at
  989 TFLOP/s (bf16 dense), beside the f32 weights, gradients and two
  moments read and written once at 3.35 TB/s.

Prints the card's name and power limit first. Needs a CUDA device;
exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _timed(fn, n):
    """Mean host-clock seconds of ``fn`` (which ends in a synchronize)
    over ``n`` calls."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def main():
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=cs.TRAIN_MODEL)
    ap.add_argument("--batch", type=int, default=cs.TRAIN_SAMPLES)
    ap.add_argument("--val", type=int, default=cs.TRAIN_VAL)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_profile: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.trainers import TrainerProperties, find_trainer
    tr = find_trainer("torch-cuda")()
    tr.create(TrainerProperties(
        model_config=args.model, num_inputs=1, num_labels=1,
        num_training_samples=args.batch,
        num_validation_samples=args.val, epochs=1))
    rng = np.random.default_rng(cs.SEED)
    n = args.batch + args.val
    frames = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, (n, 1)).astype(np.int32)
    samples = [[f, y] for f, y in zip(frames, labels)]
    train, val = samples[:args.batch], samples[args.batch:]
    params = sum(p.numel() for p in tr.module.parameters())

    def batch():
        tr._batch_of(train)
        torch.cuda.synchronize()

    inputs, targets = tr._batch_of(train)

    def step():
        tr._step(inputs, targets)  # reads the loss back: a sync

    vi, vl = tr._batch_of(val)

    def evaluate():
        with torch.no_grad():
            float(tr._loss_fn(tr.module, vi, vl)[0])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    parts = {"batch": _timed(batch, args.steps) * 1e3,
             "step": _timed(step, args.steps) * 1e3,
             "val": _timed(evaluate, args.steps) * 1e3}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    events = prof.key_averages()
    # the device timeline also carries the optimizer's annotation range
    # ("Optimizer.step#Adam.step"), which spans kernels and is no kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Optimizer.")]
    if not kernels:
        sys.exit("torch_train_profile: the profiler recorded no device "
                 "kernel")
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / args.steps
    executed = sum(e.count for e in kernels) / args.steps
    tokens = args.batch * (224 // 16) ** 2
    flop_ms = 6 * params * tokens / 989e12 * 1e3
    bytes_ms = params * 4 * 7 / 3.35e12 * 1e3
    print(f"train step ({args.model}, batch {args.batch}, {params} "
          f"parameters): batch {parts['batch']:.3f} ms, step "
          f"{parts['step']:.3f} ms, val {parts['val']:.3f} ms (host clock "
          f"over {args.steps}); under the profiler {wall_ms:.3f} ms a "
          f"step, {executed:.1f} kernels and {kernel_ms:.3f} ms of kernel "
          f"time a step, device idle share "
          f"{1 - kernel_ms / parts['step']:.3f}, "
          f"{launches / args.steps:.1f} host kernel launches a step; bound "
          f"{max(flop_ms, bytes_ms):.3f} ms ({flop_ms:.3f} ms of "
          f"operations, {bytes_ms:.3f} ms of weight/grad/moment bytes); "
          f"{smi}", flush=True)
    print("top kernels by device time (ms/step, executed/step):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / args.steps:8.4f} "
              f"{e.count / args.steps:6.1f}  {e.key[:110]}")


if __name__ == "__main__":
    main()
