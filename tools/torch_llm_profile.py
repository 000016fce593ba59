"""Where a decode step's time goes in the port's generative line on a GPU.

    python3 tools/torch_llm_profile.py [--model ZOO_SPEC] [--streams M]
                                       [--max-len L] [--chunk K]
                                       [--replays R]

Opens ``tensor_filter framework=llm``'s backend (``find_filter("llm")``)
on the card with chip_smoke.py phase 32's options (default: bench.py's
LLM_LARGE, 8 streams, max_len 128, chunk 32), runs one warm-up prompt
through one chunk (the captures: the prefill pass and the chunk
graph), then replays the K-step chunk graph alone, the decode state
left as the warm-up left it:

* the step's device time from CUDA events over R replays, against the
  bound (every weight but the embedding and the whole [M, L] KV cache
  read once at 3.35 TB/s, chip_smoke.py's ``llm_bound``);
* under torch.profiler, R more replays: kernels executed and device
  kernel time a step, the device's idle share inside a replay (1 -
  kernel time / replay time), and the kernels that take the most time;
* the prefill graph's device time (the warm-up prompt: an 8-row pass).

Prints the card's name and power limit first. Needs a CUDA device;
exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=cs.LLM_LARGE)
    ap.add_argument("--streams", type=int, default=cs.LLM_STREAMS)
    ap.add_argument("--max-len", type=int, default=cs.LLM_MAX_LEN)
    ap.add_argument("--chunk", type=int, default=cs.LLM_CHUNK)
    ap.add_argument("--replays", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_llm_profile: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.filters import FilterProperties, find_filter
    fw = find_filter("llm")()
    fw.open(FilterProperties(model_files=(args.model,), custom_properties=(
        f"max_tokens:{args.chunk},n_parallel:{args.streams},"
        f"max_len:{args.max_len},chunk:{args.chunk}")))
    cs._llm_collect(fw, [np.arange(8, dtype=np.int32)], args.chunk,
                    "warm-up")
    _, _, bound_ms = cs.llm_bound(fw, args.streams, args.max_len)
    graph = fw._backend._graphs["chunk"]
    n = args.replays
    step_ms = cs._event_ms(graph.replay, n) / args.chunk
    # the warm-up prompt's prefill graph: 8 rows (its bucket), no past
    (rows, _), prefill = next(iter(
        fw._prefills[args.max_len]._graphs.items()))
    prefill_ms = cs._event_ms(prefill.replay, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
    fw.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("torch_llm_profile: the profiler recorded no device kernel")
    steps = n * args.chunk
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    executed = sum(e.count for e in kernels) / steps
    print(f"decode step ({args.streams} streams, max_len {args.max_len}, "
          f"chunk {args.chunk}): {step_ms:.4f} ms on the device (CUDA "
          f"events over {n} chunk replays), bound {bound_ms:.4f} ms "
          f"({bound_ms / step_ms:.4f} of it); under the profiler "
          f"{executed:.1f} kernels and {kernel_ms:.4f} ms of kernel time a "
          f"step, device idle share inside a replay "
          f"{1 - kernel_ms / step_ms:.3f}, {step_ms / executed * 1e3:.2f} "
          f"us a kernel; prefill pass ({rows} rows) "
          f"{prefill_ms:.4f} ms; {smi}", flush=True)
    print("top kernels by device time (ms/step, executed/step):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.4f} "
              f"{e.count / steps:6.1f}  {e.key[:110]}")


if __name__ == "__main__":
    main()
