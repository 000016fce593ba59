"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device   — a CUDA device must be present; prints nvidia-smi's card
              name and power limit.
2. build    — compiles every CUDA kernel of the port (one nvcc per source,
              all at once: attention.cu, normalize.cu) and prints the
              build seconds, ptxas's registers, shared memory and spills
              for each kernel instantiation and, where cuobjdump is
              present, the HMMA (tensor-core)
              instructions in each attention kernel's SASS: a bf16/f16
              kernel without them fails.
3. kernels  — the attention kernel against its plain PyTorch version on
              the card, at the main path's shapes and ragged, D=20/72 and
              storage-offset-1 ones, with the tolerance stated beside
              each; kernel, plain and library times from CUDA events, and
              for bf16 the kernel's device time (torch.profiler).
3b. normalize — the normalize kernel against normalize_plain on the card,
              bitwise, at frame, batch, ragged and unaligned shapes in
              bf16/f16/f32; kernel and plain times (CUDA events), the
              kernel's device time (torch.profiler) and the bound.
4. pipeline — the ViT-B/16 labeling line at full published width
              (patch 16, d_model 768, 12 layers, 12 heads, 224x224, 1000
              classes; seeded random weights) through parse_launch:
              16 labelled frames, 12 attention launches per frame, and the
              same frames' logits against attn=stock.
5. mobilenet — the MobileNet-v2 lines at full published width (width
              1.0, 224x224, 1001 classes; seeded random weights) through
              parse_launch, all with prefetch-host=true: the headline
              line (fps, p50 frame time, frames per fetch RPC), its
              image_labeling variant (labels equal the argmax of the same
              frames' logits from the module itself), the batch-32 line
              (frames/s) and top1=1 (ids equal that argmax); the card's
              logits against the same weights in f32 on the CPU.
6. normalize entry — the headline frames on the card through
              ops.fused_normalize, the kernel's own entry point (no
              pipeline path calls it), counting its launches.
7. vit batch — the ViT-B/16 line at batch 64 (caps 3:224:224:64,
              tensortestsrc ! tensor_filter ... attn=pallas ! appsink):
              2 warm-up and 4 measured buffers, 12 attention launches a
              buffer, frames/s, and the first buffer's logits against
              attn=stock on the same frames.
8. ssd      — bench.py's bench_ssd line at full published width (width
              1.0, 300x300, 91 classes, topk 100, packed=1; seeded random
              weights), queues of 8 and 32, prefetch-host=true, the
              bounding_boxes decoder (mobilenet-ssd-postprocess):
              8 warm-up and 48 measured frames (fps, p50, frames per
              fetch RPC); the decoded boxes against the module's packed
              output on the same frames, packed against the quad, and the
              card's head outputs and top-k scores against the same
              weights in f32 on the CPU.
9. posenet  — bench_posenet's line (257x257, decode=device,
              pose_estimation): 8 + 48 frames; keypoint positions equal
              the argmax of the heatmap variant's output on the same
              frames, and that variant's heatmaps of 2 frames agree with
              the same weights in f32 on the CPU.
10. deeplab — bench_deeplab's line (257x257, 21 classes, argmax=u8,
              image_segment): 8 + 48 frames; the logits variant
              (argmax=0, 5.5 MB of f32 a frame), 8 + 48 frames timed
              the same way, whose argmax equals the u8 class maps and
              whose logits of 2 frames agree with the same weights in
              f32 on the CPU.
11. video   — the video front end: videotestsrc (RGB 300x300) !
              tensor_converter ! queue ! the SSD filter ! queue !
              bounding_boxes ! appsink, 8 + 32 frames; and a device-
              resident transform line (tensortestsrc device=true !
              tensor_transform arithmetic ! tensor_transform transpose !
              appsink) whose chunks stay CUDA tensors until the sink and
              equal numpy's float32 result within one ulp.
12. graphs  — each zoo model at batch 1 at the variant its line runs
              (vit attn=pallas, mobilenet_v2, ssd_mobilenet_v2 packed=1,
              posenet decode=device, deeplab_v3 argmax=u8 and logits)
              through the torch-cuda backend: the first invoke (eager
              warm-up, then the CUDA-graph capture) and a replay against
              an eager apply on the same input, bitwise; one executable
              each (compile_count 1); ViT's 12 attention launches a frame
              counted by replay, and attention_fwd_mma_kernel seen in a
              profiled replay's device trace.
13. fused   — bench.py's bench_pipeline_fused line (tensortestsrc
              device=true unique=true ! queue 8 ! DeepLab-v3 logits
              filter, prefetch-host ! image_segment ! queue ! appsink),
              8 + 48 frames: exactly one FusedSegment holding the filter
              and the decoder with jit_misses 1, fps and p50, and the
              first 8 frames' RGBA bytes equal to a fuse=false twin's.
14. in-flight — the ViT-B/16 labeling line behind a queue with
              in-flight=4 and prefetch-host=true, 8 + 48 frames: labels
              equal the in-flight=1 run's over the same seeded frames in
              PTS order, 12 attention launches a frame counted by
              replay, compile_count 1; fps, p50 and the window report.
15. ensemble — MobileNet-v2 and ViT-B/16 (attn=pallas) on the same
              seeded frames: tensortestsrc ! tee, each leg a queue and a
              filter on its own thread, tensor_mux sync-mode=slowest,
              tensor_demux, a queue and an appsink per model; 8 + 48
              frames, traced: every frame at both sinks in PTS order,
              each model's outputs against its own line on the same
              frames (bitwise expected, else the f32-twin tolerance), 12
              attention launches a frame, fps, p50 and the tracer's
              per-element report.
16. aggregated — tensortestsrc ! tensor_aggregator frames-out=32
              concat=false (frames stacked on a new outer dim, so the
              filter sees 3:224:224:32 and makes one graph) ! queue 4 !
              MobileNet-v2, prefetch-host ! queue 8 ! tensor_aggregator
              frames-in=32 frames-out=1 frames-dim=1 ! appsink; 2 + 8
              batches: per-frame logits against the batch-1 headline
              line's on the same frames (5 % of the largest logit),
              frames/s, traced.
17. crop    — videotestsrc (RGB 300x300) ! tensor_converter ! tee; one
              leg the packed SSD filter ! tensor_decoder tensor_region
              (top 4) ! tensor_crop's info pad, the other a queue to its
              raw pad; 8 + 32 frames: each frame's regions equal the
              bounding_boxes decoder's top 4 on the same SSD output, every
              crop byte-equal to the numpy slice of the same frame; fps,
              p50 and the tracer's report.
18. throttled — ViT-B/16 on a 60/1 stream into tensor_rate
              framerate=15/1 throttle=true and a tensor_if gate, 64
              frames: the filter drops frames before the invoke on the
              rate's QoS events (invokes + qos_dropped = 64, attention
              launches = 12 x invokes, the sink's count = the rate's
              out); then appsink qos=true behind a 25 ms render sends
              QoS events and the filter drops frames.
Then the tracer on phase 8's SSD line and phase 10's DeepLab line (a
queue between filter and decoder: unfused): host time a frame by element.
19. policies — the headline MobileNet-v2 line (queues of 8 and 32,
              prefetch-host=true) with a tensor_fault between the first
              queue and the filter, 64 seeded frames each, against a clean
              run of the same frames: mode=transient every=5
              on-error=retry(2,0.01) (every frame arrives), mode=raise
              every=5 on-error=skip (exactly 64 - 12 arrive, every 5th
              missing), mode=transient every=5 on-error=restart(32,60)
              (every frame arrives; start() resets the schedule, so a
              fault every 4 frames after the first), each frame's logits
              bitwise equal to the clean run's at its PTS; the retry
              variant with image_labeling (labels equal the clean argmax);
              the default on-error=fail aborts the run. fps and p50 of the
              clean, retry, skip and restart runs.
20. segment faults — a device-capable test element (chip_capture_fault)
              fused after the MobileNet-v2 filter, whose program raises a
              TransientError during its first k CUDA-graph captures:
              k = 2 under on-error=retry(4,0.01) (2 retries) and k = 1
              under restart(8,30) (1 restart: restart re-runs the frame
              once, so two failures in a row escalate, as in the JAX
              package), every frame bitwise equal to the clean run's;
              every capture failing under on-error=skip, without and
              with breaker-threshold=2 (every frame dropped; the breaker
              opens and sheds), memory_reserved() after 48 failing frames
              within 20 MiB of its value after 8; restart_element on the
              plain filter five times mid-stream (on the filter's own
              thread, between frames): one more compile each, every frame
              bitwise equal to the clean run's, memory_reserved() after
              the fifth restart within 10 % of its value after the
              first; then a clean line that still matches.
21. pipelint — Pipeline.validate() on every launch line phases 1-20 ran:
              0 errors and 0 crashed rules, with the host ms a line; a
              line with a caps contradiction after a device=true source,
              ahead of a torch-cuda filter, refused at start() by
              PipelineValidationError with memory_allocated() unchanged
              and no model loaded.
Every model line runs through the backend's per-signature executable,
one captured CUDA graph per input signature: the first frame runs
eagerly (the capture's warm-up), every later frame is one replay, so a
hand kernel inside the graph counts once a frame.
Phases 8-11, 13, 16, 17, 19, 20, 22 and 24 launch neither hand kernel
(their models inline their input affine, as the JAX models do); their
launch counts are read all the same and written on the kernels line as
0. The
tracer's times are host times: a filter's proctime is its dispatch
(staging and the graph launch), not the device time.

The second-to-last line is the kernels JSON, the last line the result:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Imports nothing of JAX and nothing of the JAX package.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
VIT_LAYERS = 12
FRAMES = 16
SEED = 0
MOBILENET_WARMUP = 16
MOBILENET_FRAMES = 64      # measured frames of the headline line
BATCH = 32
BATCH_BUFFERS = 10         # batch-32 buffers: 2 warm-up + 8 measured
VIT_BATCH = 64
VIT_BATCH_WARMUP = 2
VIT_BATCH_BUFFERS = 4      # measured batch-64 buffers
LABELED_FRAMES = 16
DET_WARMUP = 8
DET_FRAMES = 48            # measured frames of the SSD/PoseNet/DeepLab lines
VIDEO_FRAMES = 32          # measured frames of the videotestsrc SSD line
CHECK_FRAMES = 8           # frames held against a second variant
FRAME_DIMS = "3:224:224"   # the ViT / MobileNet frame of phases 15-18
SSD_SIZE = 300             # the SSD frame of phase 17 and the traced line
SEG_SIZE = 257             # the DeepLab frame of the traced line
CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
        "dimensions=(string){dims},framerate=(fraction)0/1")


def log(*a):
    print(*a, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def _demangle(names):
    """C++ names of ``names`` through c++filt where it exists."""
    import shutil
    if not names or not shutil.which("c++filt"):
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, timeout=60).stdout
    return out.splitlines() if out.count("\n") >= len(names) - 1 \
        else list(names)


def _ptxas_report(out):
    """(function, registers line, spill line) for each kernel in nvcc's
    -Xptxas -v output."""
    import re
    funcs, regs, spills, current = [], {}, {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_$]+)'?", line)
        if m:
            current = m.group(1)
            if current not in funcs:
                funcs.append(current)
        elif current and "registers" in line:
            regs[current] = line.split(":", 1)[-1].strip()
        elif current and "spill" in line:
            spills[current] = line.strip()
    names = _demangle(funcs)
    return [(_short(n), regs.get(f, "?"), spills.get(f, "?"))
            for f, n in zip(funcs, names)]


def _short(name):
    """A kernel's name without its return type, namespace and
    parameters: ``attention_fwd_mma_kernel<__nv_bfloat16, 64, true>``."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::",
                                                "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def _sass_hmma(lib):
    """{kernel: HMMA/HGMMA instruction count} from cuobjdump's SASS of
    ``lib``; None where cuobjdump is absent."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts[current] = 0
        elif current and ("HMMA" in line or "HGMMA" in line):
            counts[current] += 1
    return dict(zip(map(_short, _demangle(list(counts))), counts.values()))


def phase_build():
    from nnstreamer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, out in logs.items():
        for func, regs, spill in _ptxas_report(out):
            log(f"  ptxas[{name}] {func}: {regs}; {spill}")
    hmma = _sass_hmma(_build.library_path("attention"))
    if hmma is None:
        log("  cuobjdump: not present; SASS not inspected")
    else:
        for func, n in hmma.items():
            log(f"  sass {func}: {n} HMMA/HGMMA")
        mma = {f: n for f, n in hmma.items() if "mma_kernel" in f}
        if not mma or not all(mma.values()):
            sys.exit(f"chip_smoke: a tensor-core attention kernel has no "
                     f"HMMA in its SASS: {mma}")
    return hmma


def time_ms(fn, iters=50, warmup=5):
    """Mean time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel, iters=20):
    """Mean device time (ms) of the kernels named ``kernel`` in one call,
    from torch.profiler's CUDA trace over ``iters`` calls; None if the
    profiler records none. Event times of back-to-back calls measure the
    host's enqueue rate where a launch is shorter than its enqueue."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if kernel in e.key and
             e.device_type == torch.autograd.DeviceType.CUDA]
    if not found:
        return None
    return sum(e.self_device_time_total for e in found) / 1e3 / iters


def attention_bound(b, s, h, d, itemsize):
    """Least time (ms) for one call: q, k, v read once and o written once,
    against QK^T and PV at 2 FLOP per multiply-add."""
    nbytes = 4 * b * s * h * d * itemsize
    flops = 4 * b * h * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    import torch.nn.functional as F
    from nnstreamer_tpu_torch.ops import attention as A

    def qkv(shape, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(shape, generator=g, device="cuda").to(dtype)
                for _ in range(3)]

    def offset1(shape, dtype, seed):
        """q/k/v as views at storage offset 1: no row is 16-byte
        aligned, so the kernel stages with element loads."""
        n = int(np.prod(shape))
        return [t[1:].view(shape)
                for t in qkv((n + 1,), dtype, seed)]

    # (shape, dtype, tolerance[, view]): bf16 allows two bf16 ulps below
    # 2 in magnitude (2**-6): the plain version rounds the normalised p
    # to bf16 before p.v, the tensor-core kernel the unnormalised p of
    # each key tile, and each rounds o once. f32 differs by summation
    # order only; f16 as bf16 with 3 more mantissa bits.
    cases = [((1, 196, 12, 64), torch.bfloat16, 2.0 ** -6),
             ((64, 196, 12, 64), torch.bfloat16, 2.0 ** -6),
             ((1, 7, 2, 8), torch.bfloat16, 2.0 ** -6),
             ((2, 1000, 4, 128), torch.bfloat16, 2.0 ** -6),
             ((1, 65, 2, 64), torch.bfloat16, 2.0 ** -6),
             ((1, 50, 3, 20), torch.bfloat16, 2.0 ** -6),
             ((3, 33, 5, 72), torch.bfloat16, 2.0 ** -6),
             ((2, 50, 4, 32), torch.bfloat16, 2.0 ** -6, offset1),
             ((1, 196, 12, 64), torch.float32, 1e-5),
             ((1, 196, 12, 64), torch.float16, 2.0 ** -9),
             ((64, 196, 12, 64), torch.float16, 2.0 ** -9)]
    rows = []
    for i, (shape, dtype, tol, *view) in enumerate(cases):
        q, k, v = (view[0] if view else qkv)(shape, dtype, seed=i)
        got = A.fused_attention(q, k, v)
        torch.cuda.synchronize()
        want = A.attention_plain(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(got).all())
        plan = A.plan(q, k, v)
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "kernel": plan.kernel, "staging": plan.staging,
               "max_abs_err": err, "tol": tol}
        if dtype == torch.bfloat16 and not view:
            bq, bk, bv = (t.transpose(1, 2) for t in (q, k, v))
            row["ms"] = time_ms(lambda: A.fused_attention(q, k, v))
            row["device_ms"] = device_ms(
                lambda: A.fused_attention(q, k, v), "attention_fwd")
            row["plain_ms"] = time_ms(lambda: A.attention_plain(q, k, v))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(bq, bk, bv))
            row["bound_ms"], row["bound_by"] = attention_bound(
                *shape, q.element_size())
        log(f"kernel attention {row} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            sys.exit(f"chip_smoke: attention kernel disagrees with "
                     f"attention_plain at {shape} {dtype}: {err} > {tol}")
        rows.append(row)
    return rows


def _frames(n, shape):
    """tensortestsrc's random frames of ``shape`` (seed SEED), drawn as
    it draws them."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(np.stack([
        rng.integers(0, 255, shape, np.uint8, endpoint=True)
        for _ in range(n)]))


def phase_pipeline(smi, tmp):
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.ops import attention as A

    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1000)))
    line = (f"tensortestsrc caps={CAPS.format(dims='3:224:224')} "
            f"pattern=random seed={SEED} "
            f"num-buffers={FRAMES} ! tensor_filter name=f "
            'framework=torch-cuda model="zoo://vit?attn=pallas" '
            f"! tensor_decoder mode=image_labeling option1={labels} "
            "! appsink name=out")
    pipe = pt.parse_launch(line)
    arrivals = []
    pipe["out"].connect(lambda buf: arrivals.append(time.perf_counter()))

    A.launches = 0
    t0 = time.perf_counter()
    pipe.run(timeout=600)
    launches = A.launches

    bufs = pipe["out"].buffers
    if len(bufs) != FRAMES:
        sys.exit(f"chip_smoke: {len(bufs)} of {FRAMES} frames arrived")
    if launches != VIT_LAYERS * FRAMES:
        sys.exit(f"chip_smoke: {launches} attention launches for {FRAMES} "
                 f"frames, expected {VIT_LAYERS} per frame")
    gaps = np.diff(arrivals) * 1e3
    steady_fps = (FRAMES - 1) / (arrivals[-1] - arrivals[0])
    log(f"pipeline: {FRAMES} frames, {launches} attention launches; "
        f"first frame {1e3 * (arrivals[0] - t0):.1f} ms after start; "
        f"steady {steady_fps:.2f} fps, p50 frame time "
        f"{np.percentile(gaps, 50):.3f} ms (frames 2..{FRAMES}); {smi}")

    # the same frames, re-made as tensortestsrc makes them, through the
    # same weights with the kernel and with stock attention
    frames = _frames(FRAMES, (224, 224, 3)).cuda()
    with torch.inference_mode():
        apply_fn, fused, _, _ = zoo.build("vit", attn="pallas")
        fused_logits = apply_fn(fused.cuda().eval(), frames)
        _, stock, _, _ = zoo.build("vit", attn="stock")
        stock_logits = apply_fn(stock.cuda().eval(), frames)
    torch.cuda.synchronize()
    if fused_logits.shape != (FRAMES, 1000) \
            or not bool(torch.isfinite(fused_logits).all()):
        sys.exit("chip_smoke: ViT logits are not finite [16, 1000]")
    got_labels = [b.extras["label_index"] for b in bufs]
    if got_labels != fused_logits.argmax(-1).tolist():
        sys.exit("chip_smoke: pipeline labels differ from the argmax of "
                 "the same frames' logits")
    # bf16 tolerance on logits: 5e-2 absolute plus 5% of the largest
    # |logit|. Stock attention rounds scores and softmax weights to bf16,
    # the kernel keeps them in f32; over 12 blocks that moves logits by a
    # few bf16 ulps of the residual stream.
    diff = (fused_logits - stock_logits).abs().max().item()
    scale = stock_logits.abs().max().item()
    tol = 5e-2 + 0.05 * scale
    log(f"pipeline logits: attn=pallas vs attn=stock max |diff| {diff:.4g} "
        f"(max |logit| {scale:.4g}, tol {tol:.4g}); top-1 agreement "
        f"{(fused_logits.argmax(-1) == stock_logits.argmax(-1)).float().mean().item():.3f}")
    if not diff <= tol:
        sys.exit("chip_smoke: attn=pallas and attn=stock logits disagree")
    return {"frames": FRAMES, "launches": launches, "fps": steady_fps,
            "p50_ms": float(np.percentile(gaps, 50))}


def phase_vit_batch(smi):
    """The ViT-B/16 line at batch 64; returns its launches and
    frames/s."""
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.ops import attention as A

    n = VIT_BATCH_WARMUP + VIT_BATCH_BUFFERS
    line = (f"tensortestsrc caps={CAPS.format(dims=f'3:224:224:{VIT_BATCH}')} "
            f"pattern=random seed={SEED} num-buffers={n} ! tensor_filter "
            'framework=torch-cuda model="zoo://vit?attn=pallas" '
            "! appsink name=out")
    A.launches = 0
    pipe, stamps = _run_timed(line, VIT_BATCH_WARMUP, VIT_BATCH_BUFFERS)
    launches = A.launches
    if launches != VIT_LAYERS * n:
        sys.exit(f"chip_smoke: {launches} attention launches for {n} "
                 f"batch-{VIT_BATCH} buffers, expected {VIT_LAYERS} a "
                 "buffer")
    fps = (len(stamps) - 1) * VIT_BATCH / (stamps[-1] - stamps[0])
    got = torch.from_numpy(pipe["out"].buffers[0].chunks[0].host())
    if tuple(got.shape) != (VIT_BATCH, 1000) \
            or not bool(torch.isfinite(got).all()):
        sys.exit(f"chip_smoke: batch-{VIT_BATCH} ViT logits are "
                 f"{tuple(got.shape)} or not finite")
    # the first buffer's frames, re-made as tensortestsrc makes them,
    # through the same weights with stock attention; the batch-1 phase's
    # tolerance
    frames = _frames(1, (VIT_BATCH, 224, 224, 3))[0].cuda()
    with torch.inference_mode():
        apply_fn, stock, _, _ = zoo.build("vit", attn="stock")
        want = apply_fn(stock.cuda().eval(), frames).float().cpu()
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = 5e-2 + 0.05 * scale
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"vit batch-{VIT_BATCH}: {n} buffers ({VIT_BATCH_BUFFERS} measured "
        f"after {VIT_BATCH_WARMUP}), {launches} attention launches, "
        f"{fps:.2f} frames/s; logits vs attn=stock max |diff| {diff:.4g} "
        f"(max |logit| {scale:.4g}, tol {tol:.4g}), top-1 agreement "
        f"{agree:.3f}; {smi}")
    if not diff <= tol:
        sys.exit(f"chip_smoke: batch-{VIT_BATCH} attn=pallas and attn=stock "
                 "logits disagree")
    return {"buffers": n, "measured": VIT_BATCH_BUFFERS,
            "launches": launches, "frames_per_s": fps, "max_abs_diff": diff}


def normalize_bound(n, itemsize):
    """Least time (ms): n bytes read and n * itemsize written once; no
    arithmetic bound applies."""
    return n * (1 + itemsize) / HBM_BYTES_S * 1e3, "bytes"


def phase_normalize():
    from nnstreamer_tpu_torch.ops import normalize as N

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def frames(shape):
        return torch.randint(0, 256, shape, generator=g, device="cuda",
                             dtype=torch.uint8)

    # tolerance 0 (bitwise): kernel and plain version both do an f32
    # subtraction, an f32 product and one round-to-nearest cast
    raw = frames((1_000_004,))
    cases = [((224, 224, 3), frames((224, 224, 3))),
             ((8,), frames((8,))),
             ((3, 5, 7), frames((3, 5, 7))),
             ((64, 1024), frames((64, 1024))),
             ((BATCH, 224, 224, 3), frames((BATCH, 224, 224, 3))),
             ((1_000_003,), raw[:1_000_003]),
             (("unaligned", 1_000_003), raw[1:])]
    rows, worst = [], 0.0
    for label, x in cases:
        for dtype, scale, offset in ((torch.bfloat16, 1 / 127.5, 127.5),
                                     (torch.float16, 1 / 127.5, 127.5),
                                     (torch.float32, 1 / 127.5, 127.5),
                                     (torch.float32, 2.0, 1.0)):
            got = N.fused_normalize(x, scale, offset, dtype)
            torch.cuda.synchronize()
            want = N.normalize_plain(x, scale, offset, dtype)
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            same = got.dtype == dtype and got.shape == x.shape \
                and torch.equal(got.view(bits), want.view(bits))
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            if not same:
                sys.exit(f"chip_smoke: normalize kernel differs from "
                         f"normalize_plain at {label} {dtype} scale={scale} "
                         f"offset={offset}: max |err| {err}")
    log(f"kernel normalize: bitwise equal to normalize_plain at "
        f"{len(cases)} shapes x 4 dtype/scale cases "
        f"(x storage offset {raw[1:].storage_offset()} for the unaligned "
        f"view)")
    for shape in ((224, 224, 3), (BATCH, 224, 224, 3)):
        x = frames(shape)
        row = {"shape": list(shape), "dtype": "bfloat16", "max_abs_err": 0.0,
               "tol": 0.0}
        row["ms"] = time_ms(lambda: N.fused_normalize(x))
        row["device_ms"] = device_ms(lambda: N.fused_normalize(x),
                                     "normalize_kernel")
        row["plain_ms"] = time_ms(lambda: N.normalize_plain(x))
        row["bound_ms"], row["bound_by"] = normalize_bound(x.numel(), 2)
        row["library_ms"] = None
        log(f"kernel normalize {row}")
        rows.append(row)
    return rows, worst


def _run_timed(line, warmup, frames, timeout=600, probe=None, trace=False):
    """Run a line to EOS, materialising every buffer on the host at the
    sink; returns (pipeline, arrival times of buffers warmup+1..).
    ``probe(pipe)``, if given, runs after EOS and before the stop (the
    filters' backends are still open then); its result is stored on
    ``pipe.probed``. ``trace`` runs the line with the tracer on and
    stores its condensed report on ``pipe.trace``."""
    import nnstreamer_tpu_torch as pt
    pipe = pt.parse_launch(line)
    tracer = pipe.enable_tracing() if trace else None
    steady = _Steady(pipe, warmup)
    stamps = []

    def on_buffer(buf):
        buf.host_arrays()
        stamps.append(time.perf_counter())
        steady.frame()

    pipe["out"].connect(on_buffer)
    pipe.start()
    try:
        pipe.wait_eos(timeout)
        pipe.probed = probe(pipe) if probe is not None else None
        pipe.trace = (_trace_table(tracer.report(pipe), steady.us())
                      if trace else None)
    finally:
        pipe.stop()
    if len(stamps) != warmup + frames:
        sys.exit(f"chip_smoke: {len(stamps)} of {warmup + frames} buffers "
                 f"arrived: {line[:100]}")
    return pipe, stamps[warmup:]


def phase_mobilenet(smi, tmp):
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.models.mobilenet import MobileNetV2
    from nnstreamer_tpu_torch.ops import attention as A, normalize as N
    from nnstreamer_tpu_torch.tensors.transfer import fetch_stats

    filt = ("tensor_filter framework=torch-cuda model=zoo://mobilenet_v2"
            "{opts} latency=1 prefetch-host=true")
    frame_caps = CAPS.format(dims="3:224:224")
    out = {}

    # -- the headline line
    n = MOBILENET_WARMUP + MOBILENET_FRAMES
    line = (f"tensortestsrc caps={frame_caps} pattern=random seed={SEED} "
            f"num-buffers={n} ! queue max-size-buffers=8 ! "
            f"{filt.format(opts='')} ! queue max-size-buffers=32 "
            "! appsink name=out")
    A.launches = N.launches = 0
    fetch_stats(reset=True)
    pipe, stamps = _run_timed(line, MOBILENET_WARMUP, MOBILENET_FRAMES)
    fetch = fetch_stats(reset=True)
    if fetch["frames"] != n:
        sys.exit(f"chip_smoke: prefetch-host fetched {fetch['frames']} of "
                 f"{n} frames")
    gaps = np.diff(stamps) * 1e3
    fps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    p50 = float(np.percentile(gaps, 50))
    out["headline"] = {"frames": n, "measured": len(stamps), "fps": fps,
                       "p50_ms": p50, "fetch": fetch}
    log(f"mobilenet headline: {n} frames ({MOBILENET_FRAMES} measured "
        f"after {MOBILENET_WARMUP}), steady {fps:.2f} fps, p50 frame time "
        f"{p50:.3f} ms, fetch {fetch}, kernel launches attention "
        f"{A.launches} normalize {N.launches}; {smi}")
    bufs = pipe["out"].buffers
    logits0 = bufs[0].chunks[0].host()
    if logits0.shape != (1001,) or logits0.dtype != np.float32:
        sys.exit(f"chip_smoke: headline output is {logits0.shape} "
                 f"{logits0.dtype}, expected (1001,) float32")

    # -- the module itself on the same frames, per frame as the filter
    # runs it; and its f32 twin on the CPU as the reference
    frames = _frames(LABELED_FRAMES, (224, 224, 3))
    apply_fn, module, _, _ = zoo.build("mobilenet_v2")
    module = module.cuda().eval()
    with torch.inference_mode():
        logits = torch.stack([apply_fn(module, f)
                              for f in frames.cuda()]).cpu()
        ref = MobileNetV2(dtype=torch.float32)
        ref.load_state_dict(module.state_dict())
        ref_logits = ref.eval()(frames[:2].float() / 127.5 - 1.0)
    if logits.shape != (LABELED_FRAMES, 1001) \
            or not bool(torch.isfinite(logits).all()):
        sys.exit("chip_smoke: MobileNet logits are not finite [16, 1001]")
    pipe_logits = torch.from_numpy(np.stack(
        [b.chunks[0].host() for b in bufs[:LABELED_FRAMES]]))
    # the filter runs the same module on the same card and shapes:
    # equal up to the convolution algorithm cuDNN picks (observed 0)
    diff = (pipe_logits - logits).abs().max().item()
    log(f"mobilenet: headline line vs module logits on the same "
        f"{LABELED_FRAMES} frames max |diff| {diff:.4g}")
    if not diff <= 1e-3 * logits.abs().max().item():
        sys.exit("chip_smoke: the headline line's logits differ from the "
                 "module's on the same frames")
    # bf16 on the card against f32 on the CPU: 5 % of the largest
    # |logit|. bf16 keeps 8 bits; 52 conv+BatchNorm layers round their
    # outputs to it (observed on the CPU: 1.5 %).
    diff = (logits[:2] - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    log(f"mobilenet logits: card bf16 vs CPU f32 max |diff| {diff:.4g} "
        f"(max |logit| {scale:.4g}, tol {0.05 * scale:.4g})")
    if not diff <= 0.05 * scale:
        sys.exit("chip_smoke: MobileNet bf16 logits on the card disagree "
                 "with the f32 reference")
    want = logits.argmax(-1).tolist()

    # -- the golden variant: image_labeling on the same frames
    labels = os.path.join(tmp, "labels1001.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)))
    line = (f"tensortestsrc caps={frame_caps} pattern=random seed={SEED} "
            f"num-buffers={LABELED_FRAMES} ! queue max-size-buffers=8 ! "
            f"{filt.format(opts='')} ! queue max-size-buffers=32 ! "
            f"tensor_decoder mode=image_labeling option1={labels} "
            "! appsink name=out")
    pipe, _ = _run_timed(line, 0, LABELED_FRAMES)
    got = [b.extras["label_index"] for b in pipe["out"].buffers]
    if got != want:
        sys.exit(f"chip_smoke: labels {got} differ from the logits' "
                 f"argmax {want}")
    log(f"mobilenet golden: {LABELED_FRAMES} labels equal the argmax of "
        f"the module's logits ({len(set(got))} distinct)")

    # -- top1=1: one int32 id per frame
    line = (f"tensortestsrc caps={frame_caps} pattern=random seed={SEED} "
            f"num-buffers={LABELED_FRAMES} ! queue max-size-buffers=8 ! "
            f"{filt.format(opts='?top1=1')} ! queue max-size-buffers=32 "
            "! appsink name=out")
    pipe, _ = _run_timed(line, 0, LABELED_FRAMES)
    ids = [b.chunks[0].host() for b in pipe["out"].buffers]
    if any(i.shape != (1,) or i.dtype != np.int32 for i in ids) \
            or [int(i[0]) for i in ids] != want:
        sys.exit(f"chip_smoke: top1=1 ids {[i.tolist() for i in ids]} "
                 f"differ from the logits' argmax {want}")
    log(f"mobilenet top1=1: {LABELED_FRAMES} int32 ids equal the argmax")

    # -- the batch-32 line, shallow queues
    line = (f"tensortestsrc caps={CAPS.format(dims=f'3:224:224:{BATCH}')} "
            f"pattern=random seed={SEED} num-buffers={BATCH_BUFFERS} "
            f"! queue max-size-buffers=4 ! {filt.format(opts='')} "
            "! queue max-size-buffers=8 ! appsink name=out")
    fetch_stats(reset=True)
    pipe, stamps = _run_timed(line, 2, BATCH_BUFFERS - 2)
    fetch = fetch_stats(reset=True)
    bfps = (len(stamps) - 1) * BATCH / (stamps[-1] - stamps[0])
    shape = pipe["out"].buffers[0].chunks[0].shape
    if shape != (BATCH, 1001):
        sys.exit(f"chip_smoke: batch-32 output is {shape}")
    out["batch32"] = {"buffers": BATCH_BUFFERS, "frames_per_s": bfps,
                      "fetch": fetch}
    log(f"mobilenet batch-{BATCH}: {BATCH_BUFFERS} buffers "
        f"({BATCH_BUFFERS - 2} measured), {bfps:.2f} frames/s, fetch "
        f"{fetch}; {smi}")
    return out, frames


def phase_normalize_entry(frames):
    """The kernel's own entry point on the headline's frames, one call a
    frame and one for the stack; returns the launches it made."""
    from nnstreamer_tpu_torch.ops import fused_normalize
    from nnstreamer_tpu_torch.ops import normalize as N

    dev = frames.cuda()
    torch.cuda.synchronize()
    N.launches = 0
    outs = [fused_normalize(f) for f in dev] + [fused_normalize(dev)]
    torch.cuda.synchronize()
    launches = N.launches
    if launches != len(dev) + 1:
        sys.exit(f"chip_smoke: fused_normalize launched {launches} times "
                 f"for {len(dev) + 1} calls")
    if not all(torch.equal(o, N.normalize_plain(f))
               for o, f in zip(outs, list(dev) + [dev])):
        sys.exit("chip_smoke: fused_normalize differs from normalize_plain "
                 "on the headline frames")
    log(f"normalize entry: {launches} launches for {len(dev)} frames and "
        "their stack, bitwise equal to normalize_plain")
    return launches


class _Steady:
    """Each element's host proctime a buffer over the buffers it chained
    after the warm-up, the window the line's fps is measured over. The
    tracer's proctime average is over the whole run: the first frame
    runs eagerly and captures the graph (hundreds of ms), and while the
    queues fill behind it the threads contend for the interpreter.
    ``frame()`` is called at a sink; the elements' stats are read when
    the ``warmup``-th frame arrives there (at least the second, so every
    chain call of the first frame has returned, the ones the sink itself
    runs inside of too) and again at the end (``us()``). An element that
    had chained every buffer by then (the source side of a deep queue)
    has no steady figure."""

    def __init__(self, pipe, warmup):
        self.pipe, self.seen, self.base = pipe, 0, None
        self.warmup = max(2, warmup)

    def _read(self):
        return {name: (st["proctime_ns"], st["buffers"])
                for name, st in self.pipe.stats().items()}

    def frame(self):
        self.seen += 1
        if self.seen == self.warmup:
            self.base = self._read()

    def us(self):
        out = {}
        for name, (ns, n) in self._read().items():
            ns0, n0 = (self.base or {}).get(name, (0, 0))
            if n > n0:
                out[name] = (ns - ns0) / (n - n0) / 1e3
        return out


def _trace_table(report, steady):
    """The tracer's report cut to what PERF.md reads: per element its
    buffers, host proctime a buffer (µs) over the whole run and after the
    first frame (``steady_us``, from :class:`_Steady`), interlatency
    p50/p95 (µs) and, for queues, the level at the report; the fusion and
    transfer blocks as they are. A proctime holds every element after
    it on the same thread and any wait on a full queue there."""
    keep = {"buffers": "buffers", "proctime_us_avg": "proctime_us",
            "interlatency_us_p50": "il_p50_us",
            "interlatency_us_p95": "il_p95_us", "queue_level": "queue"}
    out = {}
    for name, entry in report.items():
        if name in ("fusion", "transfer"):
            out[name] = entry
            continue
        out[name] = {short: (round(entry[k], 2) if isinstance(entry[k], float)
                             else entry[k])
                     for k, short in keep.items() if k in entry}
        if name in steady:
            out[name]["steady_us"] = round(steady[name], 2)
    return out


def _line_stats(stamps):
    gaps = np.diff(stamps) * 1e3
    return ((len(stamps) - 1) / (stamps[-1] - stamps[0]),
            float(np.percentile(gaps, 50)))


def _kernel_launches():
    from nnstreamer_tpu_torch.ops import attention as A, normalize as N
    return {"attention": A.launches, "normalize": N.launches}


def _reset_launches():
    from nnstreamer_tpu_torch.ops import attention as A, normalize as N
    A.launches = N.launches = 0


def _bench_line(size, model, tail, n):
    """bench.py's detection line shape: tensortestsrc ! queue 8 !
    tensor_filter prefetch-host=true ! queue 32 ! <tail> ! appsink."""
    return (f"tensortestsrc caps={CAPS.format(dims=f'3:{size}:{size}')} "
            f"pattern=random seed={SEED} num-buffers={n} "
            f"! queue max-size-buffers=8 ! tensor_filter name=f "
            f'framework=torch-cuda model="{model}" latency=1 '
            "prefetch-host=true ! queue max-size-buffers=32 "
            f"{tail} ! appsink name=out")


def _run_line(name, line, warmup, frames, smi):
    """One measured run of a line with the kernels' counts zeroed just
    before it and read just after; returns (pipeline, stats row)."""
    from nnstreamer_tpu_torch.tensors.transfer import fetch_stats
    _reset_launches()
    fetch_stats(reset=True)
    pipe, stamps = _run_timed(line, warmup, frames)
    fetch = fetch_stats(reset=True)
    launches = _kernel_launches()
    fps, p50 = _line_stats(stamps)
    row = {"frames": warmup + frames, "measured": frames, "fps": fps,
           "p50_ms": p50, "fetch": fetch, "kernel_launches": launches}
    log(f"{name}: {warmup + frames} frames ({frames} measured after "
        f"{warmup}), steady {fps:.2f} fps, p50 frame time {p50:.3f} ms, "
        f"fetch {fetch}, kernel launches {launches}; {smi}")
    return pipe, row


SSD_TAIL = ("! tensor_decoder mode=bounding_boxes "
            "option1=mobilenet-ssd-postprocess option4=300:300 "
            "option5=300:300")


def phase_ssd(smi):
    from nnstreamer_tpu_torch.models import detection as D, zoo

    line = _bench_line(300, "zoo://ssd_mobilenet_v2?packed=1",
                       SSD_TAIL, DET_WARMUP + DET_FRAMES)
    pipe, row = _run_line("ssd", line, DET_WARMUP, DET_FRAMES, smi)
    bufs = pipe["out"].buffers
    if bufs[0].chunks[0].shape != (300, 300, 4):
        sys.exit(f"chip_smoke: ssd overlay is {bufs[0].chunks[0].shape}")

    # the module itself (the zoo's seed-0 weights, as the filter built
    # them) on the same frames, packed and as the quad
    frames = _frames(CHECK_FRAMES, (300, 300, 3))
    apply_packed, module, _, _ = zoo.build("ssd_mobilenet_v2", packed="1")
    module = module.cuda().eval()
    with torch.inference_mode():
        dev = frames.cuda()
        packed = apply_packed(module, dev).cpu()
        quad = [o.cpu() for o in D.make_ssd_apply(100, False)(module, dev)]
        cls, box = (o.float().cpu() for o in module(
            dev.to(torch.bfloat16) / 127.5 - 1.0))
        ref = D.SSDMobileNetV2(dtype=torch.float32)
        ref.load_state_dict(module.state_dict())
        x = frames[:2].float() / 127.5 - 1.0
        ref_cls, ref_box = ref.eval()(x)
        ref_quad = D.ssd_postprocess(ref_cls, ref_box, 100)
    flat = torch.cat([quad[0].flatten(1), quad[1], quad[2], quad[3]], 1)
    if packed.shape != (CHECK_FRAMES, 601) or not torch.equal(packed, flat):
        sys.exit("chip_smoke: ssd packed=1 differs from the flattened quad")
    if not bool(torch.isfinite(packed).all()) \
            or not bool((quad[3] == 100).all()):
        sys.exit("chip_smoke: ssd outputs are not finite or count != 100")
    # the line's decoded scores are the module's: the module runs the
    # frames as one batch and the filter one at a time, so cuDNN may
    # pick other conv algorithms (observed 3.1e-5 on an H100)
    worst = 0.0
    for b, scores in zip(bufs, quad[2]):
        got = torch.tensor([d["score"] for d in b.extras["boxes"]])
        if got.shape != scores.shape:
            sys.exit(f"chip_smoke: ssd line decoded {len(got)} of 100 boxes")
        worst = max(worst, (got - scores).abs().max().item())
    if worst > 1e-4:
        sys.exit(f"chip_smoke: ssd line scores differ from the module's on "
                 f"the same frames by {worst}")
    # bf16 on the card against f32 on the CPU: the head's conv outputs
    # within 5 % of their largest magnitude (MobileNet's rule; observed
    # 2.0-2.5 % on the CPU and 2.7 % on an H100 at full width), and the
    # top-k scores within a quarter of that (sigmoid's slope is at most
    # 1/4)
    diff = max((cls[:2] - ref_cls).abs().max().item(),
               (box[:2] - ref_box).abs().max().item())
    scale = max(ref_cls.abs().max().item(), ref_box.abs().max().item())
    sdiff = (quad[2][:2] - ref_quad[2]).abs().max().item()
    log(f"ssd: line vs module scores max |diff| {worst:.3g}; packed equals "
        f"the quad; head card bf16 vs CPU f32 max |diff| {diff:.4g} (max "
        f"|output| {scale:.4g}, tol {0.05 * scale:.4g}); top-100 scores "
        f"max |diff| {sdiff:.4g} (tol {0.0125 * scale:.4g})")
    if not diff <= 0.05 * scale or not sdiff <= 0.0125 * scale:
        sys.exit("chip_smoke: SSD bf16 outputs on the card disagree with "
                 "the f32 reference")
    row.update({"head_vs_f32_max_abs_diff": diff, "head_scale": scale,
                "scores_vs_f32_max_abs_diff": sdiff})
    return row


def phase_posenet(smi):
    from nnstreamer_tpu_torch.models import detection as D, zoo

    tail = ("! tensor_decoder mode=pose_estimation option1=257:257 "
            "option2=257:257")
    line = _bench_line(257, "zoo://posenet?decode=device", tail,
                       DET_WARMUP + DET_FRAMES)
    pipe, row = _run_line("posenet", line, DET_WARMUP, DET_FRAMES, smi)
    kps = np.array([b.extras["keypoints"] for b in
                    pipe["out"].buffers[:CHECK_FRAMES]])
    # the heatmap variant on the same frames, no decoder
    line = _bench_line(257, "zoo://posenet", "", CHECK_FRAMES)
    pipe, _ = _run_timed(line, 0, CHECK_FRAMES)
    hm = np.stack([b.chunks[0].host() for b in pipe["out"].buffers])
    if hm.shape != (CHECK_FRAMES, 17, 17, 17) \
            or not np.isfinite(hm).all():
        sys.exit(f"chip_smoke: posenet heatmaps are {hm.shape} or not "
                 "finite")
    flat = hm.reshape(CHECK_FRAMES, -1, 17)
    idx = flat.argmax(1)
    want = np.stack([(idx % 17) / 16, (idx // 17) / 16], -1)
    if kps.shape != (CHECK_FRAMES, 17, 3) \
            or not np.array_equal(kps[..., :2], want):
        sys.exit("chip_smoke: decode=device keypoints are not the heatmap "
                 "argmax positions")
    score_diff = float(np.abs(kps[..., 2] - np.take_along_axis(
        flat, idx[:, None], 1)[:, 0]).max())
    # the line's heatmaps against the f32 twin on the CPU: the head's
    # conv outputs obey SSD's 5 %-of-max rule, so the sigmoid of them
    # is within a quarter of it (on the CPU at full width the head was
    # 2.1 % off and the heatmaps at half their tolerance)
    _, module, _, _ = zoo.build("posenet")
    ref = D.PoseNet(dtype=torch.float32)
    ref.load_state_dict(module.state_dict())
    with torch.inference_mode():
        x = _frames(2, (257, 257, 3)).float() / 127.5 - 1.0
        head = ref.eval().head(ref.backbone(x.permute(0, 3, 1, 2)))
        ref_hm = torch.sigmoid(head).permute(0, 2, 3, 1).numpy()
    scale = head.abs().max().item()
    diff = float(np.abs(hm[:2] - ref_hm).max())
    log(f"posenet: decode=device keypoints of {CHECK_FRAMES} frames equal "
        f"the heatmap variant's argmax; scores max |diff| {score_diff:.3g}; "
        f"heatmaps card bf16 vs CPU f32 max |diff| {diff:.4g} (head max "
        f"|output| {scale:.4g}, tol {0.0125 * scale:.4g})")
    if not diff <= 0.0125 * scale:
        sys.exit("chip_smoke: PoseNet bf16 heatmaps on the card disagree "
                 "with the f32 reference")
    row.update({"keypoint_score_max_abs_diff": score_diff,
                "heatmap_vs_f32_max_abs_diff": diff, "head_scale": scale})
    return row


def phase_deeplab(smi):
    from nnstreamer_tpu_torch.models import detection as D, zoo

    tail = "! tensor_decoder mode=image_segment option1=tflite-deeplab"
    line = _bench_line(257, "zoo://deeplab_v3?argmax=u8", tail,
                       DET_WARMUP + DET_FRAMES)
    pipe, row = _run_line("deeplab", line, DET_WARMUP, DET_FRAMES, smi)
    maps = np.stack([b.extras["class_map"] for b in
                     pipe["out"].buffers[:CHECK_FRAMES]])
    # the logits variant on the same frames, no decoder, timed as the
    # u8 line is
    line = _bench_line(257, "zoo://deeplab_v3?argmax=0", "",
                       DET_WARMUP + DET_FRAMES)
    pipe, row["logits"] = _run_line("deeplab logits", line, DET_WARMUP,
                                    DET_FRAMES, smi)
    logits = np.stack([b.chunks[0].host() for b in
                       pipe["out"].buffers[:CHECK_FRAMES]])
    if logits.shape != (CHECK_FRAMES, 257, 257, 21) \
            or logits.dtype != np.float32 or not np.isfinite(logits).all():
        sys.exit(f"chip_smoke: deeplab logits are {logits.shape} "
                 f"{logits.dtype} or not finite")
    if not np.array_equal(logits.argmax(-1), maps):
        agree = float((logits.argmax(-1) == maps).mean())
        sys.exit(f"chip_smoke: deeplab argmax=u8 maps differ from the "
                 f"logits' argmax (agreement {agree})")
    # the line's logits against the f32 twin on the CPU, SSD's 5 %-of-max
    # rule (observed 3.0 % on the CPU at full width)
    _, module, _, _ = zoo.build("deeplab_v3")
    ref = D.DeepLabV3(dtype=torch.float32)
    ref.load_state_dict(module.state_dict())
    with torch.inference_mode():
        x = _frames(2, (257, 257, 3)).float() / 127.5 - 1.0
        ref_logits = ref.eval()(x).permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(ref_logits).max())
    diff = float(np.abs(logits[:2] - ref_logits).max())
    agree = float((logits[:2].argmax(-1) == ref_logits.argmax(-1)).mean())
    log(f"deeplab: argmax=u8 maps of {CHECK_FRAMES} frames equal the "
        f"logits variant's argmax; logits card vs CPU f32 max |diff| "
        f"{diff:.4g} (max |logit| {scale:.4g}, tol {0.05 * scale:.4g}), "
        f"class maps agree on {agree:.4f} of pixels")
    if not diff <= 0.05 * scale:
        sys.exit("chip_smoke: DeepLab logits on the card disagree with the "
                 "f32 reference")
    row.update({"logits_vs_f32_max_abs_diff": diff, "logits_scale": scale,
                "class_map_vs_f32_agreement": agree})
    return row


def phase_video(smi):
    import nnstreamer_tpu_torch as pt

    n = DET_WARMUP + VIDEO_FRAMES
    line = ("videotestsrc pattern=random seed=1 "
            'caps="video/x-raw,format=RGB,width=300,height=300,'
            f'framerate=30/1" num-buffers={n} ! tensor_converter ! queue '
            "! tensor_filter framework=torch-cuda "
            'model="zoo://ssd_mobilenet_v2?packed=1" prefetch-host=true '
            f"! queue {SSD_TAIL} ! appsink name=out")
    pipe, row = _run_line("video ssd", line, DET_WARMUP, VIDEO_FRAMES, smi)
    boxes = [len(b.extras["boxes"]) for b in pipe["out"].buffers]
    if set(boxes) != {100}:
        sys.exit(f"chip_smoke: video ssd line decoded {set(boxes)} boxes")

    # the device-resident transform line: u8 frames on the card, to f32
    # in [-1, 1], then HWC -> CHW
    pool = 4
    line = (f"tensortestsrc caps={CAPS.format(dims='3:224:224')} "
            f"pattern=random seed={SEED} device=true pool-size={pool} "
            f"num-buffers={2 * pool} ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! tensor_transform "
            "mode=transpose option=1:2:0:3 ! appsink name=out")
    pipe = pt.parse_launch(line)
    on_card, outs = [], []

    def on_buffer(buf):
        on_card.append(all(c.is_device for c in buf.chunks))
        outs.append(buf.chunks[0].host())

    pipe["out"].connect(on_buffer)
    _reset_launches()
    pipe.run(timeout=600)
    launches = _kernel_launches()
    frames = _frames(pool, (224, 224, 3)).numpy()
    ulps = 0.0
    for i, got in enumerate(outs):
        f = frames[i % pool]
        want = ((f.astype(np.float32) + np.float32(-127.5))
                / np.float32(127.5)).transpose(2, 0, 1)
        if got.shape != (3, 224, 224) or got.dtype != np.float32:
            sys.exit(f"chip_smoke: transform line gave {got.shape} "
                     f"{got.dtype}")
        ulps = max(ulps, float((np.abs(got - want) / np.spacing(
            np.abs(want))).max()))
    if len(outs) != 2 * pool or not all(on_card) or ulps > 1:
        sys.exit(f"chip_smoke: transform line: {len(outs)} buffers, on "
                 f"the card {on_card}, {ulps} ulps from numpy")
    log(f"video transform: {len(outs)} buffers stayed on the card to the "
        f"sink, within {ulps:g} ulp of numpy float32; kernel launches "
        f"{launches}")
    row["transform"] = {"buffers": len(outs), "max_ulps": ulps,
                        "kernel_launches": launches}
    return row


def phase_graphs():
    """Each zoo model's captured graph against an eager run on the same
    input; returns the rows and ViT's attention launches."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    from nnstreamer_tpu_torch.ops import attention as A

    rows = {}
    for uri, size in (("zoo://vit?attn=pallas", 224),
                      ("zoo://mobilenet_v2", 224),
                      ("zoo://ssd_mobilenet_v2?packed=1", 300),
                      ("zoo://posenet?decode=device", 257),
                      ("zoo://deeplab_v3?argmax=u8", 257),
                      ("zoo://deeplab_v3", 257)):
        fw = TorchCudaFilter()
        fw.open(FilterProperties(framework="torch-cuda", model_files=(uri,)))
        x = _frames(1, (size, size, 3))[0].numpy()
        _reset_launches()
        first = fw.invoke([x])
        replay = fw.invoke([x])
        torch.cuda.synchronize()
        launches = A.launches
        with torch.inference_mode():
            eager = fw.traceable_fn()(torch.from_numpy(x).cuda())
        eager = eager if isinstance(eager, (list, tuple)) else [eager]
        torch.cuda.synchronize()
        same = all(torch.equal(a, e) and torch.equal(b, e)
                   for a, b, e in zip(first, replay, eager))
        diff = max((a.float() - e.float()).abs().max().item()
                   for a, e in zip(replay, eager))
        row = {"compile_count": fw.compile_count, "bitwise": same,
               "max_abs_diff": diff, "attention_launches": launches,
               "replay_ms": time_ms(lambda: fw.invoke([x]), iters=20,
                                    warmup=2)}
        if "vit" in uri:
            row["replay_attention_device_ms"] = device_ms(
                lambda: fw.invoke([x]), "attention_fwd_mma_kernel", iters=5)
            if row["replay_attention_device_ms"] is None:
                sys.exit("chip_smoke: attention_fwd_mma_kernel is not in a "
                         "profiled replay's device trace")
            if launches != 2 * VIT_LAYERS:
                sys.exit(f"chip_smoke: {launches} attention launches for "
                         f"one eager frame and one replay, expected "
                         f"{2 * VIT_LAYERS}")
        log(f"graph {uri}: {row}")
        if not same or fw.compile_count != 1:
            sys.exit(f"chip_smoke: {uri}: the graph replay differs from "
                     f"the eager run (max |diff| {diff}) or "
                     f"{fw.compile_count} executables were made")
        fw.close()
        rows[uri] = row
    return rows


def _segments(pipe):
    return [e for e in pipe.elements.values()
            if getattr(e, "IS_FUSED_SEGMENT", False)]


def phase_fused(smi):
    """bench.py's fused DeepLab line: one FusedSegment (filter +
    image_segment decoder, one CUDA graph), against its fuse=false
    twin."""
    def line(n, fuse):
        return (("" if fuse else "fuse=false ")
                + f"tensortestsrc caps={CAPS.format(dims='3:257:257')} "
                f"pattern=random seed={SEED} device=true unique=true "
                f"num-buffers={n} ! queue max-size-buffers=8 "
                "! tensor_filter name=f framework=torch-cuda "
                "model=zoo://deeplab_v3 prefetch-host=true "
                "! tensor_decoder name=d mode=image_segment "
                "option1=tflite-deeplab ! queue max-size-buffers=8 "
                "! appsink name=out")

    pipe, row = _run_line("fused deeplab", line(DET_WARMUP + DET_FRAMES,
                                                True),
                          DET_WARMUP, DET_FRAMES, smi)
    segs = _segments(pipe)
    if len(segs) != 1 or [m.name for m in segs[0].members] != ["f", "d"]:
        sys.exit(f"chip_smoke: the fused line formed segments "
                 f"{[[m.name for m in s.members] for s in segs]}, "
                 "expected one of the filter and the decoder")
    stats = segs[0].stats.snapshot()
    if stats["jit_misses"] != 1 \
            or stats["jit_hits"] != DET_WARMUP + DET_FRAMES - 1:
        sys.exit(f"chip_smoke: fused segment stats {stats}")
    twin, _ = _run_timed(line(CHECK_FRAMES, False), 0, CHECK_FRAMES)
    if _segments(twin):
        sys.exit("chip_smoke: fuse=false formed a segment")
    got = [b.chunks[0].host() for b in pipe["out"].buffers[:CHECK_FRAMES]]
    want = [b.chunks[0].host() for b in twin["out"].buffers]
    same = all(g.shape == w.shape == (257, 257, 4) and g.dtype == np.uint8
               and g.tobytes() == w.tobytes() for g, w in zip(got, want))
    log(f"fused deeplab: one segment {[m.name for m in segs[0].members]}, "
        f"jit_misses {stats['jit_misses']} jit_hits {stats['jit_hits']}; "
        f"RGBA of {CHECK_FRAMES} frames "
        f"{'equal' if same else 'DIFFERENT'} to the fuse=false twin's")
    if not same:
        sys.exit("chip_smoke: the fused line's RGBA differs from the "
                 "fuse=false twin's")
    row.update({"segment": [m.name for m in segs[0].members],
                "jit_misses": stats["jit_misses"],
                "jit_hits": stats["jit_hits"],
                "rgba_equal_unfused": same})
    return row


def phase_vit_inflight(smi, tmp):
    """The ViT-B/16 labeling line with in-flight=4 against in-flight=1
    on the same seeded frames."""
    labels = os.path.join(tmp, "labels.txt")
    n = DET_WARMUP + DET_FRAMES

    def line(k):
        return (f"tensortestsrc caps={CAPS.format(dims='3:224:224')} "
                f"pattern=random seed={SEED} num-buffers={n} "
                "! queue max-size-buffers=8 ! tensor_filter name=f "
                'framework=torch-cuda model="zoo://vit?attn=pallas" '
                f"in-flight={k} prefetch-host=true ! tensor_decoder "
                f"mode=image_labeling option1={labels} ! appsink name=out")

    def probe(pipe):
        f = pipe["f"]
        return {"compile_count": f.fw.compile_count,
                "window": f.transfer_report(),
                "jit_recompiles": f.stats.get("jit_recompiles", 0)}

    out = {}
    for k in (1, 4):
        _reset_launches()
        pipe, stamps = _run_timed(line(k), DET_WARMUP, DET_FRAMES,
                                  probe=probe)
        launches = _kernel_launches()
        fps, p50 = _line_stats(stamps)
        bufs = pipe["out"].buffers
        out[k] = {"fps": fps, "p50_ms": p50, "kernel_launches": launches,
                  "labels": [b.extras["label_index"] for b in bufs],
                  "pts": [b.pts for b in bufs], **pipe.probed}
        log(f"vit in-flight={k}: {n} frames ({DET_FRAMES} measured after "
            f"{DET_WARMUP}), steady {fps:.2f} fps, p50 frame time "
            f"{p50:.3f} ms, kernel launches {launches}, compile_count "
            f"{pipe.probed['compile_count']}, window "
            f"{pipe.probed['window']}; {smi}")
        if launches["attention"] != VIT_LAYERS * n \
                or pipe.probed["compile_count"] != 1:
            sys.exit(f"chip_smoke: vit in-flight={k}: {launches} launches "
                     f"for {n} frames (expected {VIT_LAYERS} a frame), "
                     f"compile_count {pipe.probed['compile_count']}")
    if out[4]["labels"] != out[1]["labels"] or out[4]["pts"] != out[1]["pts"] \
            or out[4]["pts"] != sorted(out[4]["pts"]):
        sys.exit("chip_smoke: in-flight=4 labels or PTS differ from "
                 "in-flight=1's")
    log(f"vit in-flight: {n} labels of in-flight=4 equal in-flight=1's in "
        "PTS order")
    for row in out.values():
        del row["labels"], row["pts"]
    return out


def _caps_at(dims, rate="0/1"):
    return CAPS.format(dims=dims).replace("(fraction)0/1",
                                          f"(fraction){rate}")


def _max_diff(got, want):
    """(largest |diff|, largest |diff| over the largest |want|)."""
    diff = float(np.abs(got - want).max())
    return diff, diff / float(np.abs(want).max())


def _model_outputs(model, n):
    """One model's own batch-1 line on the seeded frames: its per-frame
    outputs on the host, stacked."""
    line = (f"tensortestsrc caps={_caps_at(FRAME_DIMS)} pattern=random "
            f"seed={SEED} num-buffers={n} ! queue max-size-buffers=8 ! "
            f'tensor_filter framework=torch-cuda model="{model}" '
            "! appsink name=out")
    pipe, _ = _run_timed(line, 0, n)
    return np.stack([b.chunks[0].host() for b in pipe["out"].buffers])


def phase_ensemble(smi):
    """MobileNet-v2 and ViT-B/16 on the same frames: tee into two
    filters on their own queue threads, tensor_mux sync-mode=slowest,
    tensor_demux, two sinks; traced."""
    import nnstreamer_tpu_torch as pt
    n = DET_WARMUP + DET_FRAMES
    line = ("tensor_mux name=m sync-mode=slowest ! tensor_demux name=d "
            "d.src_0 ! queue name=qa ! appsink name=a "
            "d.src_1 ! queue name=qb ! appsink name=b "
            f"tensortestsrc name=src caps={_caps_at(FRAME_DIMS)} "
            f"pattern=random seed={SEED} num-buffers={n} ! tee name=t "
            "t. ! queue name=q0 ! tensor_filter name=mnv2 "
            "framework=torch-cuda model=zoo://mobilenet_v2 ! m.sink_0 "
            "t. ! queue name=q1 ! tensor_filter name=vit "
            'framework=torch-cuda model="zoo://vit?attn=pallas" ! m.sink_1')
    pipe = pt.parse_launch(line)
    tracer = pipe.enable_tracing()
    steady = _Steady(pipe, 2 * DET_WARMUP)  # both sinks count
    arrivals = {"a": {}, "b": {}}

    def sink_cb(name):
        def on_buffer(buf):
            buf.host_arrays()
            arrivals[name][buf.pts] = time.perf_counter()
            steady.frame()
        return on_buffer

    for name in arrivals:
        pipe[name].connect(sink_cb(name))
    _reset_launches()
    pipe.start()
    try:
        pipe.wait_eos(600)
        trace = _trace_table(tracer.report(pipe), steady.us())
    finally:
        pipe.stop()
    launches = _kernel_launches()
    src_pts = list(range(n))  # framerate 0/1: the PTS is the count
    outs = {}
    for name in ("a", "b"):
        bufs = pipe[name].buffers
        pts = [b.pts for b in bufs]
        if pts != src_pts:
            sys.exit(f"chip_smoke: ensemble sink {name} got {len(bufs)} of "
                     f"{n} frames or out of PTS order: {pts[:10]}")
        outs[name] = np.stack([b.chunks[0].host() for b in bufs])
    done = [max(arrivals["a"][p], arrivals["b"][p]) for p in src_pts]
    fps, p50 = _line_stats(done[DET_WARMUP:])
    if launches["attention"] != VIT_LAYERS * n:
        sys.exit(f"chip_smoke: ensemble: {launches['attention']} attention "
                 f"launches for {n} frames (expected {VIT_LAYERS} a frame)")
    row = {"frames": n, "measured": DET_FRAMES, "fps": fps, "p50_ms": p50,
           "kernel_launches": launches, "trace": trace}
    for name, model, width in (("a", "zoo://mobilenet_v2", 1001),
                               ("b", "zoo://vit?attn=pallas", 1000)):
        if outs[name].shape != (n, width) \
                or not np.isfinite(outs[name]).all():
            sys.exit(f"chip_smoke: ensemble sink {name} outputs "
                     f"{outs[name].shape}, expected ({n}, {width}) finite")
        alone = _model_outputs(model, n)
        diff, rel = _max_diff(outs[name], alone)
        # bitwise expected: each filter has its own graph of the same
        # signature; else the f32-twin tolerance of phases 5 and 8-10
        how = "bitwise" if diff == 0 else "within 5 % of the largest output"
        log(f"ensemble {model}: {n} frames vs the model's own line max "
            f"|diff| {diff:.4g} (relative {rel:.3g}): {how}")
        if rel > 0.05:
            sys.exit(f"chip_smoke: ensemble {model} differs from its own "
                     "line")
        row[f"{name}_max_abs_diff"] = diff
        row[f"{name}_equal"] = how
    log(f"ensemble: {n} frames ({DET_FRAMES} measured after {DET_WARMUP}) "
        f"at both sinks in PTS order, steady {fps:.2f} fps, p50 frame time "
        f"{p50:.3f} ms, kernel launches {launches}; {smi}")
    log(f"ensemble trace: {json.dumps(trace)}")
    return row


def phase_aggregated(smi):
    """MobileNet-v2 batched by tensor_aggregator (32 frames stacked on a
    new outer dim: 3:224:224:32) and split back per frame, against the
    batch-1 headline line on the same frames."""
    n = BATCH * BATCH_BUFFERS
    warm = 2 * BATCH
    line = (f"tensortestsrc caps={_caps_at(FRAME_DIMS)} pattern=random "
            f"seed={SEED} num-buffers={n} ! tensor_aggregator name=g "
            f"frames-out={BATCH} frames-dim=3 concat=false "
            "! queue max-size-buffers=4 ! tensor_filter name=f "
            "framework=torch-cuda model=zoo://mobilenet_v2 "
            "prefetch-host=true ! queue max-size-buffers=8 "
            f"! tensor_aggregator name=s frames-in={BATCH} frames-out=1 "
            "frames-dim=1 ! appsink name=out")

    def probe(pipe):
        cfg = pipe["f"].sinkpad.caps.to_config()
        return {"filter_dims": cfg.info.dims_string(),
                "compile_count": pipe["f"].fw.compile_count}

    _reset_launches()
    pipe, stamps = _run_timed(line, warm, n - warm, probe=probe, trace=True)
    launches = _kernel_launches()
    fps, p50 = _line_stats(stamps)
    got = np.stack([b.chunks[0].host() for b in pipe["out"].buffers])
    if pipe.probed["filter_dims"] != f"{FRAME_DIMS}:{BATCH}" \
            or pipe.probed["compile_count"] != 1:
        sys.exit(f"chip_smoke: aggregated line: the filter saw "
                 f"{pipe.probed}, expected {FRAME_DIMS}:{BATCH} and one graph")
    if got.shape != (n, 1, 1001):
        sys.exit(f"chip_smoke: aggregated line gave {got.shape}")
    line1 = (f"tensortestsrc caps={_caps_at(FRAME_DIMS)} pattern=random "
             f"seed={SEED} num-buffers={n} ! queue max-size-buffers=8 ! "
             "tensor_filter framework=torch-cuda model=zoo://mobilenet_v2 "
             "prefetch-host=true ! queue max-size-buffers=32 "
             "! appsink name=out")
    one, _ = _run_timed(line1, 0, n)
    want = np.stack([b.chunks[0].host() for b in one["out"].buffers])
    diff, rel = _max_diff(got[:, 0], want)
    log(f"aggregated: {n} frames in {BATCH_BUFFERS} batches of {BATCH} "
        f"({n - warm} measured), filter caps {pipe.probed['filter_dims']}, "
        f"compile_count {pipe.probed['compile_count']}, {fps:.2f} frames/s; "
        f"per-frame logits vs the batch-1 line max |diff| {diff:.4g}, "
        f"relative {rel:.3g} (tol 0.05); {smi}")
    log(f"aggregated trace: {json.dumps(pipe.trace)}")
    # batched convolutions may take other cuDNN algorithms than batch 1:
    # the f32-twin tolerance of phases 5 and 8-10
    if rel > 0.05:
        sys.exit("chip_smoke: aggregated per-frame logits differ from the "
                 "batch-1 line's")
    return {"frames": n, "measured": n - warm, "frames_per_s": fps,
            "p50_ms": p50, "max_abs_diff": diff, "max_rel_diff": rel,
            "kernel_launches": launches, "trace": pipe.trace,
            **pipe.probed}


def phase_crop(smi):
    """SSD detections -> tensor_region -> tensor_crop of the same video
    frames, through a tee."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.decoders.registry import find_decoder
    n = DET_WARMUP + VIDEO_FRAMES
    video = ("videotestsrc pattern=random seed=1 "
             f'caps="video/x-raw,format=RGB,width={SSD_SIZE},'
             f'height={SSD_SIZE},framerate=30/1" num-buffers={n} '
             "! tensor_converter")
    line = ("tensor_crop name=c ! appsink name=out "
            f"{video} ! tee name=t t. ! queue name=q0 ! tensor_filter "
            'name=f framework=torch-cuda model="zoo://ssd_mobilenet_v2?'
            'packed=1" ! tensor_decoder name=r mode=tensor_region '
            f"option1=4 option3={SSD_SIZE}:{SSD_SIZE} ! c.info "
            "t. ! queue name=q1 ! c.raw")
    pipe = pt.parse_launch(line)
    tracer = pipe.enable_tracing()
    region = pipe["r"]
    decoded = []
    transform = region.transform

    def recording(buf):  # keep each SSD output and its regions
        out = transform(buf)
        decoded.append((buf, out))
        return out

    region.transform = recording
    steady = _Steady(pipe, DET_WARMUP)
    stamps = []

    def on_buffer(buf):
        buf.host_arrays()
        stamps.append(time.perf_counter())
        steady.frame()

    pipe["out"].connect(on_buffer)
    _reset_launches()
    pipe.start()
    try:
        pipe.wait_eos(600)
        trace = _trace_table(tracer.report(pipe), steady.us())
    finally:
        pipe.stop()
    launches = _kernel_launches()
    frames = pt.parse_launch(f"{video} ! appsink name=out")
    frames.run(timeout=600)
    raw = {b.pts: b.chunks[0].host() for b in frames["out"].buffers}
    if len(decoded) != n or len(raw) != n:
        sys.exit(f"chip_smoke: crop line decoded {len(decoded)} of {n}")
    bb = find_decoder("bounding_boxes")()
    wh = f"{SSD_SIZE}:{SSD_SIZE}"
    bb.set_options(["mobilenet-ssd-postprocess", "", "", wh, wh,
                    "", "", "", ""])
    want_out = {}
    for ssd, out in decoded:
        boxes = sorted(bb.decode(ssd).extras["boxes"],
                       key=lambda b: -b["score"])[:4]
        want = np.zeros((4, 4), np.uint32)
        for i, b in enumerate(boxes):
            want[i] = [max(0, int(b["x"] * SSD_SIZE)),
                       max(0, int(b["y"] * SSD_SIZE)),
                       int(b["w"] * SSD_SIZE), int(b["h"] * SSD_SIZE)]
        got = out.chunks[0].host()
        if got.dtype != np.uint32 or not np.array_equal(got, want):
            sys.exit(f"chip_smoke: frame {ssd.pts}: regions {got.tolist()} "
                     f"differ from bounding_boxes' top 4 {want.tolist()}")
        crops = []
        frame = raw[ssd.pts]
        for x, y, w, h in want.astype(np.int64):
            x0, y0 = max(0, x), max(0, y)
            x1, y1 = min(SSD_SIZE, x0 + w), min(SSD_SIZE, y0 + h)
            if w > 0 and h > 0 and x1 > x0 and y1 > y0:
                crops.append(frame[y0:y1, x0:x1])
        if crops:
            want_out[ssd.pts] = crops
    bufs = pipe["out"].buffers
    if [b.pts for b in bufs] != sorted(want_out):
        sys.exit(f"chip_smoke: crop line emitted {len(bufs)} buffers for "
                 f"{len(want_out)} frames with regions")
    n_crops = 0
    for b in bufs:
        want = want_out[b.pts]
        got = [c.host() for c in b.chunks]
        if len(got) != len(want) or any(
                g.shape != w.shape or g.tobytes() != w.tobytes()
                for g, w in zip(got, want)):
            sys.exit(f"chip_smoke: frame {b.pts}: crops differ from the "
                     "numpy slices of the frame")
        n_crops += len(got)
    fps, p50 = _line_stats(stamps[DET_WARMUP:])
    log(f"crop: {n} frames ({VIDEO_FRAMES} measured after {DET_WARMUP}), "
        f"regions equal bounding_boxes' top 4 on every frame, {n_crops} "
        f"crops byte-equal to numpy slices, steady {fps:.2f} fps, p50 "
        f"frame time {p50:.3f} ms, kernel launches {launches}; {smi}")
    log(f"crop trace: {json.dumps(trace)}")
    return {"frames": n, "measured": VIDEO_FRAMES, "fps": fps, "p50_ms": p50,
            "crops": n_crops, "kernel_launches": launches, "trace": trace}


def phase_throttled(smi):
    """ViT-B/16 on a 60/1 stream into tensor_rate framerate=15/1
    throttle=true and a tensor_if gate: QoS makes the filter skip
    invokes. Then appsink qos=true behind a render the script slows."""
    import nnstreamer_tpu_torch as pt
    n = 64
    caps = _caps_at(FRAME_DIMS, "60/1")
    vit = ('tensor_filter name=f framework=torch-cuda '
           'model="zoo://vit?attn=pallas"')
    line = (f"tensortestsrc caps={caps} pattern=random seed={SEED} "
            f"num-buffers={n} ! {vit} ! tensor_rate name=r framerate=15/1 "
            "throttle=true ! tensor_if compared-value=TENSOR_AVERAGE_VALUE "
            "operator=GT supplied-value=-1e30 then=PASSTHROUGH else=SKIP "
            "! appsink name=out")

    def probe(pipe):
        f, r = pipe["f"], pipe["r"]
        return {"invokes": f._invoke_count,
                "qos_dropped": f.stats["qos_dropped"],
                "rate": {k: r.stats[k] for k in ("in", "out", "dup", "drop")}}

    pipe = pt.parse_launch(line)
    tracer = pipe.enable_tracing()
    steady = _Steady(pipe, 2)  # after the first (capturing) frame
    stamps = []

    def on_buffer(buf):
        buf.host_arrays()
        stamps.append(time.perf_counter())
        steady.frame()

    pipe["out"].connect(on_buffer)
    _reset_launches()
    pipe.start()
    try:
        pipe.wait_eos(600)
        got = probe(pipe)
        trace = _trace_table(tracer.report(pipe), steady.us())
    finally:
        pipe.stop()
    launches = _kernel_launches()
    sunk = len(pipe["out"].buffers)
    if not (got["qos_dropped"] > 0
            and got["invokes"] + got["qos_dropped"] == n
            and launches["attention"] == VIT_LAYERS * got["invokes"]
            and sunk == got["rate"]["out"]):
        sys.exit(f"chip_smoke: throttled line {got}, attention launches "
                 f"{launches['attention']}, {sunk} buffers at the sink")
    fps, p50 = _line_stats(stamps)
    log(f"throttled: {n} frames, {got['invokes']} invoked and "
        f"{got['qos_dropped']} dropped by QoS before the invoke, rate "
        f"{got['rate']}, {sunk} at the sink, attention launches "
        f"{launches['attention']} (12 x invokes), steady {fps:.2f} fps, "
        f"p50 {p50:.3f} ms; {smi}")
    log(f"throttled trace: {json.dumps(trace)}")
    row = {"frames": n, "fps": fps, "p50_ms": p50, "sunk": sunk,
           "kernel_launches": launches, "trace": trace, **got}

    # appsink qos=true: a 25 ms render against 16.7 ms frames
    pipe = pt.parse_launch(f"tensortestsrc caps={caps} pattern=random "
                           f"seed={SEED} num-buffers={n} ! {vit} "
                           "! appsink name=out qos=true")
    events = []
    f = pipe["f"]
    upstream = f.handle_upstream_event

    def counted(pad, event):
        events.append((event.proportion, event.period_ns))
        upstream(pad, event)

    f.handle_upstream_event = counted

    def slow_render(buf):
        buf.host_arrays()
        time.sleep(0.025)

    pipe["out"].connect(slow_render)
    _reset_launches()
    pipe.start()
    try:
        pipe.wait_eos(600)
        got = {"invokes": f._invoke_count,
               "qos_dropped": f.stats["qos_dropped"]}
    finally:
        pipe.stop()
    launches = _kernel_launches()
    if not events or got["qos_dropped"] <= 0 \
            or got["invokes"] + got["qos_dropped"] != n \
            or launches["attention"] != VIT_LAYERS * got["invokes"]:
        sys.exit(f"chip_smoke: appsink qos=true: events {events}, "
                 f"{got}, attention launches {launches['attention']}")
    log(f"throttled appsink qos=true: {len(events)} QoS events "
        f"{events}, {got['invokes']} invoked, {got['qos_dropped']} dropped "
        f"before the invoke, attention launches {launches['attention']}")
    row["appsink_qos"] = {"events": len(events), "kernel_launches": launches,
                          **got}
    return row


def phase_traces(smi):
    """The tracer on phase 8's SSD line and phase 10's DeepLab line
    (queue between the filter and the decoder, so unfused): host time a
    frame by element."""
    out = {}
    for name, size, model, tail in (
            ("ssd", SSD_SIZE, "zoo://ssd_mobilenet_v2?packed=1", SSD_TAIL),
            ("deeplab", SEG_SIZE, "zoo://deeplab_v3?argmax=u8",
             "! tensor_decoder mode=image_segment option1=tflite-deeplab")):
        line = _bench_line(size, model, tail, DET_WARMUP + DET_FRAMES)
        pipe, stamps = _run_timed(line, DET_WARMUP, DET_FRAMES, trace=True)
        fps, p50 = _line_stats(stamps)
        log(f"trace {name}: steady {fps:.2f} fps, p50 {p50:.3f} ms "
            f"(traced); {smi}")
        log(f"trace {name}: {json.dumps(pipe.trace)}")
        out[name] = {"fps": fps, "p50_ms": p50, "trace": pipe.trace}
    return out


# -- phases 19-21: the fault layer and pipelint -------------------------

FAULT_FRAMES = 64          # frames of each phase-19 variant
SEG_FRAMES = 49            # frames of each phase-20 failing line
RESTART_EVERY = 8          # phase 20: a filter restart every 8 frames


def _headline_line(n, mid="", tail="", fuse=True, extra=""):
    """bench.py's headline MobileNet-v2 line (queues of 8 and 32,
    prefetch-host=true), ``mid`` between the first queue and the filter,
    ``tail`` between the second queue and the sink."""
    return (("" if fuse else "fuse=false ")
            + f"tensortestsrc caps={CAPS.format(dims=FRAME_DIMS)} "
            f"pattern=random seed={SEED} num-buffers={n} "
            f"! queue max-size-buffers=8 {'! ' + mid if mid else ''}"
            "! tensor_filter name=f "
            "framework=torch-cuda model=zoo://mobilenet_v2 latency=1 "
            f"prefetch-host=true {extra}! queue max-size-buffers=32 "
            f"{tail}! appsink name=out")


def _by_pts(pipe):
    return {b.pts: b.chunks[0].host() for b in pipe["out"].buffers}


def _bitwise(got, clean):
    """Every delivered frame's bytes equal the clean run's at its PTS."""
    return all(k in clean and v.dtype == clean[k].dtype
               and v.tobytes() == clean[k].tobytes() for k, v in got.items())


def phase_policies(smi, labels):
    """Phase 19: tensor_fault between the source's queue and the
    MobileNet-v2 filter of the headline line, against a clean run on the
    same seeded frames."""
    import nnstreamer_tpu_torch as pt
    n, warm = FAULT_FRAMES, 8
    out = {}
    pipe, row = _run_line("policies clean", _headline_line(n), warm,
                          n - warm, smi)
    clean = _by_pts(pipe)
    out["clean"] = row
    fault = "tensor_fault name=flt mode={mode} every=5 on-error={policy} "
    variants = (("retry", "transient", "retry(2,0.01)", n),
                ("skip", "raise", "skip", n - n // 5),
                ("restart", "transient", "restart(32,60)", n))
    for name, mode, policy, arrive in variants:
        line = _headline_line(n, fault.format(mode=mode, policy=policy))
        pipe, row = _run_line(f"policies {name}", line, warm, arrive - warm,
                              smi)
        got = _by_pts(pipe)
        st = pipe["flt"].stats.snapshot()
        row.update({k: st[k] for k in ("faults", "retries", "dropped",
                                       "restarts")})
        row["arrived"] = len(got)
        row["bitwise_equal_clean"] = _bitwise(got, clean)
        log(f"policies {name}: {len(got)} of {n} frames arrived, "
            f"faults {st['faults']} retries {st['retries']} dropped "
            f"{st['dropped']} restarts {st['restarts']}, logits "
            f"{'equal' if row['bitwise_equal_clean'] else 'DIFFERENT'} to "
            f"the clean run's at each PTS; {smi}")
        if len(got) != arrive or not row["bitwise_equal_clean"]:
            sys.exit(f"chip_smoke: on-error={policy}: {len(got)} frames "
                     f"arrived (expected {arrive}) or logits differ")
        if name == "skip" and (st["dropped"] != n // 5 or sorted(got) !=
                               sorted(k for i, k in enumerate(sorted(clean))
                                      if (i + 1) % 5)):
            sys.exit(f"chip_smoke: skip dropped {st['dropped']} frames, "
                     "not every 5th")
        if name == "retry" and st["retries"] != st["faults"]:
            sys.exit(f"chip_smoke: retry: {st['retries']} retries for "
                     f"{st['faults']} faults")
        if name == "restart" and not n // 5 - 2 <= st["restarts"] <= 32:
            sys.exit(f"chip_smoke: restart: {st['restarts']} restarts")
        out[name] = row
    # the golden variant under retry: labels equal the clean logits' argmax
    line = _headline_line(
        n, fault.format(mode="transient", policy="retry(2,0.01)"),
        f"! tensor_decoder mode=image_labeling option1={labels} ")
    pipe, _ = _run_timed(line, 0, n)
    got = {b.pts: b.extras["label_index"] for b in pipe["out"].buffers}
    want = {k: int(np.argmax(v)) for k, v in clean.items()}
    log(f"policies retry, image_labeling: {len(got)} labels "
        f"{'equal' if got == want else 'DIFFERENT'} to the clean argmax")
    if got != want:
        sys.exit("chip_smoke: labels under on-error=retry differ")
    # the default policy: the same schedule aborts the run
    pipe = pt.parse_launch(_headline_line(
        n, "tensor_fault mode=transient every=5 "))
    pipe.start()
    try:
        pipe.wait_eos(300)
        raised = None
    except Exception as exc:  # noqa: BLE001 -- the abort is the result
        raised = exc
    finally:
        pipe.stop()
    log(f"policies fail: the run raised {type(raised).__name__}: {raised}")
    if type(raised).__name__ != "FaultInjected":
        sys.exit("chip_smoke: on-error=fail did not abort the run")
    out["fail"] = {"raised": type(raised).__name__}
    return out, clean


def _define_fault_elements():
    """The test elements of phase 20, registered once: a device-capable
    pass-through whose program raises a TransientError during its first
    ``fail-captures`` CUDA-graph captures (-1: every capture), and a
    pass-through tap that runs ``on_frame`` before each frame."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.fault import TransientError
    from nnstreamer_tpu_torch.pipeline.element import TransformElement
    from nnstreamer_tpu_torch.pipeline.registry import element_names
    if "chip_capture_fault" in element_names():
        return

    @pt.register_element("chip_capture_fault")
    class CaptureFault(TransformElement):
        PROPS = {"fail-captures": 0}
        DEVICE_FUSIBLE = "always (a pass-through program)"

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.captures = 0

        def transform(self, buf):
            return buf

        def device_fn(self, ctx=None):
            def fn(arrays):
                if torch.cuda.is_current_stream_capturing():
                    self.captures += 1
                    k = int(self.fail_captures)
                    if k < 0 or self.captures <= k:
                        raise TransientError(
                            f"{self.name}: capture {self.captures} refused")
                return list(arrays)
            return fn

    @pt.register_element("chip_tap")
    class Tap(TransformElement):
        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.seen = 0
            self.on_frame = None

        def transform(self, buf):
            if self.on_frame is not None:
                self.on_frame(self.seen)
            self.seen += 1
            return buf


def _run_tapped(line, arrive, on_frame=None, timeout=600):
    """Run a line with a ``chip_tap name=tap``; ``on_frame(pipe, i)``
    runs before frame i passes the tap. Returns the pipeline, stopped."""
    import nnstreamer_tpu_torch as pt
    pipe = pt.parse_launch(line)
    if on_frame is not None:
        pipe["tap"].on_frame = lambda i: on_frame(pipe, i)
    pipe.start()
    try:
        pipe.wait_eos(timeout)
        pipe.probed = {name: e.stats.snapshot()
                       for name, e in pipe.elements.items()}
    finally:
        pipe.stop()
    if len(pipe["out"].buffers) != arrive:
        sys.exit(f"chip_smoke: {len(pipe['out'].buffers)} of {arrive} "
                 f"buffers arrived: {line[:100]}")
    return pipe


def phase_segment_faults(smi, clean):
    """Phase 20: failed captures, restarts and the breaker on a fused
    segment (the MobileNet-v2 filter and a capture-fault element), and
    five restarts of the plain filter mid-stream."""
    from nnstreamer_tpu_torch.fault import restart_element
    _define_fault_elements()
    n = CHECK_FRAMES * 2
    out = {}

    def seg_line(frames, policy, fail, extra="", tap=""):
        return _headline_line(
            frames, tap, extra=f"on-error={policy} {extra}! "
            f"chip_capture_fault name=cf fail-captures={fail} "
            f"on-error={policy} ")

    for name, policy, fail, counter, want in (
            ("retry", "retry(4,0.01)", 2, "retries", 2),
            ("restart", "restart(8,30)", 1, "restarts", 1)):
        _reset_launches()
        pipe = _run_tapped(seg_line(n, policy, fail), n)
        segs = _segments(pipe)
        if len(segs) != 1 or [m.name for m in segs[0].members] != ["f", "cf"]:
            sys.exit("chip_smoke: the capture-fault line did not fuse the "
                     "filter and the fault element")
        st = segs[0].stats.snapshot()
        got = _by_pts(pipe)
        same = len(got) == n and _bitwise(got, clean)
        out[name] = {"arrived": len(got), counter: st[counter],
                     "captures": pipe["cf"].captures,
                     "jit_misses": st["jit_misses"],
                     "bitwise_equal_clean": same,
                     "kernel_launches": _kernel_launches()}
        log(f"segment {name}: {out[name]}; {smi}")
        if not same or st[counter] != want:
            sys.exit(f"chip_smoke: segment on-error={policy}: "
                     f"{out[name]}, expected {want} {counter} and every "
                     "frame equal to the clean run's")

    # every capture fails: skip, with and without the breaker. The tap
    # reads the reserved memory after 8 and after 48 failing frames.
    for name, extra in (("skip", ""),
                        ("breaker", "breaker-threshold=2 ")):
        reserved = {}

        def on_frame(pipe, i, reserved=reserved):
            if i in (8, 48):
                reserved[i] = torch.cuda.memory_reserved()

        _reset_launches()
        pipe = _run_tapped(seg_line(SEG_FRAMES, "skip", -1, extra,
                                    "chip_tap name=tap "), 0, on_frame)
        st = _segments(pipe)[0].stats.snapshot()
        grew = (reserved[48] - reserved[8]) / 2 ** 20
        row = {k: st[k] for k in ("dropped", "shed", "breaker_opened",
                                  "jit_misses")}
        row.update({"failed_captures": pipe["cf"].captures,
                    "reserved_mib_after_8": reserved[8] / 2 ** 20,
                    "reserved_mib_after_48": reserved[48] / 2 ** 20,
                    "kernel_launches": _kernel_launches()})
        out[name] = row
        log(f"segment {name}: {row}; reserved grew {grew:.1f} MiB over "
            f"frames 8-48; {smi}")
        if st["dropped"] != SEG_FRAMES or grew > 20:
            sys.exit(f"chip_smoke: segment {name}: {row}")
        if name == "breaker" and (st["breaker_opened"] < 1
                                  or st["shed"] < 1):
            sys.exit(f"chip_smoke: the segment's breaker did not open and "
                     f"shed: {row}")

    # five restarts of the plain filter, each between two frames on the
    # filter's own thread (the tap sits right before it)
    reserved = []

    def restart(pipe, i):
        if i and i % RESTART_EVERY == 0:
            reserved.append(torch.cuda.memory_reserved())
            if len(reserved) <= 5:
                restart_element(pipe["f"])

    _reset_launches()
    frames = RESTART_EVERY * 6 + 1
    pipe = _run_tapped(_headline_line(frames, "chip_tap name=tap "),
                       frames, restart)
    got = _by_pts(pipe)
    compiles = pipe.probed["f"]["jit_recompiles"]
    same = _bitwise(got, clean)
    ratio = reserved[-1] / reserved[1]
    out["filter_restarts"] = {
        "restarts": 5, "compiles": compiles, "bitwise_equal_clean": same,
        "reserved_mib": [r / 2 ** 20 for r in reserved],
        "kernel_launches": _kernel_launches()}
    log(f"filter restarts: {out['filter_restarts']}; reserved after the "
        f"fifth restart / after the first {ratio:.4f}; {smi}")
    if not same or compiles != 6 or not ratio <= 1.1:
        sys.exit("chip_smoke: filter restarts: outputs differ, compiles "
                 f"{compiles} != 6, or reserved memory grew {ratio:.3f}x")

    # a clean line afterwards: no capture was left open
    pipe, _ = _run_timed(_headline_line(CHECK_FRAMES), 0, CHECK_FRAMES)
    same = _bitwise(_by_pts(pipe), clean)
    log(f"clean line after the faults: {CHECK_FRAMES} frames "
        f"{'equal' if same else 'DIFFERENT'} to the first clean run")
    if not same or torch.cuda.is_current_stream_capturing():
        sys.exit("chip_smoke: the clean line after the fault phases "
                 "differs")
    out["clean_after"] = {"bitwise_equal_clean": same}
    return out


# -- phases 22-24: the among-device layer ------------------------------

FANOUT_CLIENTS = 4         # bench.py:417 bench_query_fanout's config 5
FANOUT_BATCH = 4           # the server's micro-batch (serversrc batch=K)
FANOUT_WINDOW = 32         # each client's max-request
FANOUT_WARMUP = 8          # frames a client before the measured ones
FANOUT_FRAMES = 100        # measured frames a client
QUERY_DISTINCT = 16        # distinct seeded frames the clients cycle over
# a batched reply against the batch-1 headline logits of its frame: max
# |diff| over max |logit|. Batch 4 and batch 1 run other convolution
# blockings, which move the logits by summation order only (read 2.29e-7
# on the H100); a bf16 rounding on the path moves them by ~4e-3.
FANOUT_REL_TOL = 1e-4
EDGE_FRAMES = 48           # frames of each phase-24 pub/sub run


def _frame_shape():
    """FRAME_DIMS (innermost first) as a numpy HWC shape."""
    c, w, h = (int(x) for x in FRAME_DIMS.split(":"))
    return (h, w, c)


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _query_server(port, batch, model, extra=""):
    import nnstreamer_tpu_torch as pt
    server = pt.parse_launch(
        f"tensor_query_serversrc name=qs port={port} id={port} "
        f"batch={batch} ! tensor_filter name=qf framework=torch-cuda "
        f'model="{model}" {extra}! queue max-size-buffers=32 '
        f"! tensor_query_serversink name=qk id={port}")
    server.start()
    return server


def _query_client(port, frames, order, replies, sent, arrived, on_reply):
    """One client pipeline: appsrc ! tensor_query_client ! appsink. The
    client element's do_chain is wrapped to stamp when each frame leaves
    for the server; ``order`` lists the frame index of each request."""
    import nnstreamer_tpu_torch as pt
    client = pt.parse_launch(
        f"appsrc name=in caps={_caps_at(FRAME_DIMS)} ! tensor_query_client "
        f"name=qc port={port} timeout=120 max-request={FANOUT_WINDOW} "
        "! appsink name=out")
    qc = client["qc"]
    chain = qc.do_chain

    def stamped(pad, buf):
        sent[buf.pts] = time.perf_counter()
        chain(pad, buf)

    qc.do_chain = stamped

    def on_buffer(buf):
        arrived[buf.pts] = time.perf_counter()
        replies.append((buf.pts, buf.chunks[0].host()))
        on_reply()

    client["out"].connect(on_buffer)
    client.start()
    for i, k in enumerate(order):
        client["in"].push_buffer(pt.Buffer.from_arrays([frames[k]], pts=i))
    client["in"].end_stream()
    return client


def _peak_in_flight(sent, arrived):
    """Most requests a client had sent and not yet had answered at once,
    from its send and arrival stamps."""
    steps = sorted([(t, 1) for t in sent.values()]
                   + [(t, -1) for t in arrived.values()])
    peak = now = 0
    for _, step in steps:
        now += step
        peak = max(peak, now)
    return peak


def _min_frame_gap(logits):
    """Smallest max |diff| between two different frames' logits, over
    the largest |logit|: what a reply of the wrong frame would read."""
    scale = max(float(np.abs(v).max()) for v in logits)
    return min(float(np.abs(a - b).max())
               for i, a in enumerate(logits) for b in logits[i + 1:]) / scale


def _headline_logits(clean, n):
    """The local headline line's logits (phase 19's clean run) of the
    first ``n`` seeded frames, in frame order."""
    return [clean[k] for k in sorted(clean)[:n]]


def phase_query_fanout(smi, clean):
    """Phase 22: BASELINE config 5 — four clients, one micro-batching
    MobileNet-v2 server; then a batch=0 client whose replies must equal
    the local headline line bit for bit."""
    import threading
    from nnstreamer_tpu_torch.tensors.transfer import PendingHost, fetch_stats
    frames = _frames(QUERY_DISTINCT, _frame_shape()).numpy()
    want = _headline_logits(clean, QUERY_DISTINCT)
    # the check below tells frames apart only if their logits lie
    # further apart than its tolerance: a padded row or another
    # frame's row sent under a reply's pts must fail it
    gap = _min_frame_gap(want)
    if not gap > 100 * FANOUT_REL_TOL:
        sys.exit(f"chip_smoke: fan-out: two frames' headline logits lie "
                 f"{gap:.3g} apart (relative), too close for tol "
                 f"{FANOUT_REL_TOL}")
    n_each = FANOUT_WARMUP + FANOUT_FRAMES
    n_warm, n_all = FANOUT_WARMUP * FANOUT_CLIENTS, n_each * FANOUT_CLIENTS
    port = _free_port()
    _reset_launches()
    fetch_stats(reset=True)
    server = _query_server(port, FANOUT_BATCH, "zoo://mobilenet_v2",
                           "prefetch-host=true ")
    # what the serversink is handed: PendingHost chunks (the filter's
    # fetch already in flight) or anything else
    at_sink = {"pending": 0, "other": 0}
    render = server["qk"].render

    def counted(buf):
        for c in buf.chunks:
            at_sink["pending" if isinstance(c._data, PendingHost)
                    else "other"] += 1
        render(buf)

    server["qk"].render = counted
    lock = threading.Lock()
    total = {"n": 0, "t0": None, "t1": None}
    done = threading.Event()

    def on_reply():
        with lock:
            total["n"] += 1
            if total["n"] == n_warm:
                total["t0"] = time.perf_counter()
            if total["n"] == n_all:
                total["t1"] = time.perf_counter()
                done.set()

    clients, results = [], []
    try:
        for c in range(FANOUT_CLIENTS):
            order = [(c * 4 + i) % QUERY_DISTINCT for i in range(n_each)]
            res = {"order": order, "replies": [], "sent": {},
                   "arrived": {}}
            results.append(res)
            clients.append(_query_client(port, frames, order,
                                         res["replies"], res["sent"],
                                         res["arrived"], on_reply))
        if not done.wait(600):
            sys.exit(f"chip_smoke: fan-out: {total['n']} of {n_all} "
                     "replies arrived")
        for client in clients:
            client.wait_eos(120)
        compiles = server["qf"].fw.compile_count
        invokes = server["qf"].stats["buffers"]
        links = server["qs"].stats.snapshot()
    finally:
        for client in clients:
            client.stop()
        server.stop()
    fetch = fetch_stats(reset=True)
    launches = _kernel_launches()
    fps = (n_all - n_warm) / (total["t1"] - total["t0"])
    p50s, peaks, worst, worst_rel, top1_same = [], [], 0.0, 0.0, 0
    for c, res in enumerate(results):
        pts = [p for p, _ in res["replies"]]
        if pts != list(range(n_each)):
            sys.exit(f"chip_smoke: fan-out client {c}: replies {pts[:12]}"
                     f"... not each frame once in order")
        rtt = [(res["arrived"][i] - res["sent"][i]) * 1e3
               for i in range(FANOUT_WARMUP, n_each)]
        p50s.append(float(np.percentile(rtt, 50)))
        peaks.append(_peak_in_flight(res["sent"], res["arrived"]))
        for i, got in res["replies"]:
            ref = want[res["order"][i]]
            diff, rel = _max_diff(got, ref)
            worst, worst_rel = max(worst, diff), max(worst_rel, rel)
            top1_same += int(int(np.argmax(got)) == int(np.argmax(ref)))
    row = {"clients": FANOUT_CLIENTS, "batch": FANOUT_BATCH,
           "window": FANOUT_WINDOW, "frames_per_client": n_each,
           "measured": n_all - n_warm, "fps": fps, "p50_rtt_ms": p50s,
           "peak_in_flight": peaks,
           "compile_count": compiles, "invokes": invokes,
           "rows_per_invoke": n_all / invokes, "fetch": fetch,
           "d2h_arrays_per_batch": fetch["arrays"] / invokes,
           "sink_chunks": at_sink, "max_abs_diff": worst,
           "max_rel_diff": worst_rel, "min_frame_gap_rel": gap,
           "top1_equal": top1_same,
           "link_errors": links.get("link_errors", 0),
           "kernel_launches": launches}
    log(f"query fan-out: {FANOUT_CLIENTS} clients x {n_each} frames "
        f"({FANOUT_FRAMES} measured after {FANOUT_WARMUP}), server "
        f"batch={FANOUT_BATCH}, max-request={FANOUT_WINDOW}: aggregate "
        f"{fps:.2f} fps; p50 round trip a client "
        f"{', '.join(f'{p:.3f}' for p in p50s)} ms, peak requests in "
        f"flight a client {peaks}; server filter "
        f"{compiles} graph(s) over {invokes} invokes "
        f"({n_all / invokes:.2f} rows an invoke); D2H {fetch['arrays']} "
        f"arrays in {fetch['rpcs']} fetch RPCs = "
        f"{fetch['arrays'] / invokes:.2f} a batch; sink chunks {at_sink}; "
        f"every reply once and in order; vs the headline line max |diff| "
        f"{worst:.4g}, relative {worst_rel:.3g} (tol {FANOUT_REL_TOL}; two "
        f"frames' logits lie at least {gap:.3g} apart), top-1 equal "
        f"{top1_same}/{n_all}; kernel launches {launches}; {smi}")
    if compiles != 1 or top1_same != n_all or worst_rel > FANOUT_REL_TOL \
            or at_sink["other"] or fetch["arrays"] != invokes:
        sys.exit(f"chip_smoke: fan-out: {row}")

    # batch=0, one client: the wire is lossless on the card
    port = _free_port()
    server = _query_server(port, 0, "zoo://mobilenet_v2",
                           "prefetch-host=true ")
    res = {"replies": [], "sent": {}, "arrived": {}}
    try:
        client = _query_client(port, frames, list(range(QUERY_DISTINCT)),
                               res["replies"], res["sent"], res["arrived"],
                               lambda: None)
        client.wait_eos(300)
        compiles0 = server["qf"].fw.compile_count
    finally:
        client.stop()
        server.stop()
    same = [p for p, _ in res["replies"]] == list(range(QUERY_DISTINCT)) \
        and all(g.dtype == w.dtype and g.tobytes() == w.tobytes()
                for (_, g), w in zip(res["replies"], want))
    log(f"query batch=0: {len(res['replies'])} replies "
        f"{'bitwise equal' if same else 'NOT EQUAL'} to the local headline "
        f"line's logits; {compiles0} graph(s); {smi}")
    if not same:
        sys.exit("chip_smoke: batch=0 query replies differ from the local "
                 "headline line")
    row["batch0_bitwise_equal"] = same
    return row


def phase_query_vit(smi):
    """Phase 23: the ViT-B/16 line of phases 1 and 4 behind the query
    link: one client, 16 frames, the attention kernel on the server."""
    frames = _frames(FRAMES, _frame_shape()).numpy()
    model = 'zoo://vit?attn=pallas'
    # the local line on the same frames: appsrc ! filter ! appsink
    import nnstreamer_tpu_torch as pt
    local = pt.parse_launch(
        f"appsrc name=in caps={_caps_at(FRAME_DIMS)} ! tensor_filter "
        f'framework=torch-cuda model="{model}" ! appsink name=out')
    local.start()
    try:
        for i, f in enumerate(frames):
            local["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
        local["in"].end_stream()
        local.wait_eos(300)
    finally:
        local.stop()
    want = [b.chunks[0].host() for b in local["out"].buffers]
    port = _free_port()
    _reset_launches()
    server = _query_server(port, 0, model)
    res = {"replies": [], "sent": {}, "arrived": {}}
    try:
        client = _query_client(port, frames, list(range(FRAMES)),
                               res["replies"], res["sent"], res["arrived"],
                               lambda: None)
        client.wait_eos(300)
    finally:
        client.stop()
        server.stop()
    launches = _kernel_launches()
    rtt = [(res["arrived"][i] - res["sent"][i]) * 1e3 for i in range(FRAMES)]
    same = [p for p, _ in res["replies"]] == list(range(FRAMES)) and all(
        g.tobytes() == w.tobytes() for (_, g), w in zip(res["replies"], want))
    peak = _peak_in_flight(res["sent"], res["arrived"])
    row = {"frames": FRAMES, "p50_rtt_ms": float(np.percentile(rtt, 50)),
           "peak_in_flight": peak, "bitwise_equal_local": same,
           "kernel_launches": launches}
    log(f"query vit: {FRAMES} frames over the query link, attention "
        f"launches {launches['attention']} "
        f"({launches['attention'] / FRAMES:.0f} a frame), replies "
        f"{'bitwise equal' if same else 'NOT EQUAL'} to the local line; "
        f"p50 round trip {row['p50_rtt_ms']:.3f} ms, at most {peak} of "
        f"{FRAMES} requests in flight at once (max-request "
        f"{FANOUT_WINDOW}); {smi}")
    if not same or launches["attention"] != VIT_LAYERS * FRAMES:
        sys.exit(f"chip_smoke: query vit: {row}")
    return row


def _edge_run(frames, sink_props, src_tail="", timeout=120):
    """One pub/sub run: appsrc ! queue ! MobileNet-v2 (prefetch-host) !
    queue ! edgesink name=p <sink_props>, and edgesrc name=s session=true
    <src_tail> ! appsink. Returns (delivered (pts, host logits), the
    publisher's stats, the subscriber's, the stats of a tensor_fault
    named k in the subscriber ({} without one), frames/s)."""
    import nnstreamer_tpu_torch as pt
    port = _free_port()
    pub = pt.parse_launch(
        f"appsrc name=in caps={_caps_at(FRAME_DIMS)} ! queue "
        "max-size-buffers=8 ! tensor_filter framework=torch-cuda "
        "model=zoo://mobilenet_v2 prefetch-host=true ! queue "
        f"max-size-buffers=32 ! edgesink name=p port={port} topic=t "
        f"session=true {sink_props}")
    sub = pt.parse_launch(
        f"edgesrc name=s dest-port={port} topic=t session=true ack-every=4 "
        f"timeout=30 ! {src_tail}appsink name=out")
    pub.start()
    try:
        sub.start()
        deadline = time.monotonic() + timeout
        while pub["p"].session_info().get("sessions") != 1:
            if time.monotonic() > deadline:
                sys.exit("chip_smoke: edge subscriber never attached")
            time.sleep(0.01)
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            pub["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
        while len(sub["out"].buffers) < len(frames):
            if time.monotonic() > deadline:
                break
            time.sleep(0.005)
        dt = time.perf_counter() - t0
        ps, ss = pub["p"].stats.snapshot(), sub["s"].stats.snapshot()
        fault = sub["k"].stats.snapshot() if "k" in sub.elements else {}
        got = [(b.pts, b.chunks[0].host()) for b in sub["out"].buffers]
    finally:
        pub["in"].end_stream()
        pub.wait_eos(60)
        pub.stop()
        sub.stop()
    return got, ps, ss, fault, len(frames) / dt


def phase_edge_pubsub(smi):
    """Phase 24: MobileNet-v2 logits published through edgesink
    (session, shuffle-zlib, coalesce-frames=4) to an edgesrc subscriber;
    a kill-link mid-stream against a clean run, and wire-precision=bf16
    against the sender's logits downcast on the host."""
    frames = _frames(EDGE_FRAMES, _frame_shape()).numpy()
    sink = "wire-codec=shuffle-zlib coalesce-frames=4 coalesce-ms=5 "
    out = {}
    _reset_launches()
    clean, ps, ss, _, fps = _edge_run(frames, sink)
    out["clean"] = {"fps": fps, "delivered": len(clean),
                    "compress_ratio": ps["wire_raw_bytes_out"]
                    / ps["wire_enc_bytes_out"],
                    "frames_per_msg": ps["wire_frames_out"]
                    / ps["wire_msgs_out"]}
    ok = [p for p, _ in clean] == list(range(EDGE_FRAMES))
    log(f"edge clean: {len(clean)} of {EDGE_FRAMES} frames in order "
        f"{ok}, {fps:.2f} fps, shuffle-zlib ratio "
        f"{out['clean']['compress_ratio']:.3f}, "
        f"{out['clean']['frames_per_msg']:.2f} frames a message; {smi}")
    if not ok:
        sys.exit("chip_smoke: the clean edge run lost or reordered frames")
    ref = dict(clean)
    got, ps, ss, fault, fps = _edge_run(
        frames, sink, "tensor_fault name=k mode=kill-link target=s "
        f"every={EDGE_FRAMES // 3} max-faults=1 ! ")
    same = [p for p, _ in got] == list(range(EDGE_FRAMES)) and all(
        g.tobytes() == ref[p].tobytes() for p, g in got)
    out["killed"] = {"fps": fps, "delivered": len(got),
                     "kills": fault.get("faults", 0),
                     "replayed": ps["session_replayed"],
                     "dup_drops": ss["session_dup_drops"],
                     "declared_lost": ss["session_declared_lost"],
                     "reconnects": ss["reconnects"],
                     "bitwise_equal_clean": same}
    log(f"edge kill-link: {len(got)} of {EDGE_FRAMES} frames delivered "
        f"once and in order across {out['killed']['kills']} kill(s), "
        f"{ps['session_replayed']} replayed, {ss['session_dup_drops']} "
        f"duplicates dropped, {ss['session_declared_lost']} declared "
        f"lost, every buffer {'bytewise equal' if same else 'NOT EQUAL'} "
        f"to the clean run's; {fps:.2f} fps; {smi}")
    if not same or out["killed"]["kills"] != 1 \
            or ss["session_declared_lost"] or ss["reconnects"] != 1:
        sys.exit(f"chip_smoke: edge kill-link: {out['killed']}")
    got, ps, ss, _, fps = _edge_run(frames, sink + "wire-precision=bf16 ")
    # torch's own round to nearest even, not the wire's bit code
    want = {p: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
            for p, v in ref.items()}
    same = [p for p, _ in got] == list(range(EDGE_FRAMES)) and all(
        g.tobytes() == want[p].tobytes() for p, g in got)
    out["bf16"] = {"fps": fps, "delivered": len(got),
                   "equal_host_downcast": same,
                   "wire_bytes_out": ps["wire_bytes_out"]}
    log(f"edge wire-precision=bf16: {len(got)} frames "
        f"{'equal' if same else 'NOT EQUAL'} to the sender's logits "
        f"downcast on the host; {fps:.2f} fps; {smi}")
    if not same:
        sys.exit("chip_smoke: bf16 edge frames differ from the host "
                 "downcast")
    out["kernel_launches"] = _kernel_launches()
    return out


def phase_pipelint(smi, lines):
    """Phase 21: Pipeline.validate() on every launch line phases 1-24
    ran (0 errors, 0 crashed rules), and a defective line refused at
    start() before anything is allocated on the card."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.analysis import PipelineValidationError
    rows = []
    for line in lines:
        pipe = pt.parse_launch(line)
        t0 = time.perf_counter()
        report = pipe.validate()
        ms = (time.perf_counter() - t0) * 1e3
        infos = len(report.findings) - len(report.errors) \
            - len(report.warnings)
        rows.append({"line": line[:60], "errors": len(report.errors),
                     "warnings": len(report.warnings), "infos": infos,
                     "crashed": list(report.crashed), "ms": ms})
        if report.errors or report.crashed:
            sys.exit(f"chip_smoke: pipelint on {line[:100]}: "
                     f"{report.to_text()} crashed {report.crashed}")
    ms = [r["ms"] for r in rows]
    log(f"pipelint: {len(rows)} launch lines, 0 errors, 0 crashed rules, "
        f"{sum(r['warnings'] for r in rows)} warnings, "
        f"{sum(r['infos'] for r in rows)} infos; validate() "
        f"{np.median(ms):.3f} ms median, {max(ms):.3f} ms max (host); {smi}")
    bad = (f"tensortestsrc caps={CAPS.format(dims=FRAME_DIMS)} device=true "
           "num-buffers=4 ! other/tensors,format=sparse ! tensor_filter "
           "name=f framework=torch-cuda model=zoo://mobilenet_v2 "
           "! fakesink")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pipe = pt.parse_launch(bad)
    try:
        pipe.start()
        pipe.stop()
        sys.exit("chip_smoke: the defective line started")
    except PipelineValidationError as exc:
        refused = sorted({f.rule for f in exc.report.errors})
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    log(f"pipelint gate: the defective line refused at start() by "
        f"{refused}; memory_allocated {before} -> {after} bytes, model "
        f"{'not ' if pipe['f'].fw is None else ''}loaded")
    if after != before or pipe["f"].fw is not None:
        sys.exit("chip_smoke: the refused line allocated on the card")
    return {"lines": len(rows), "ms_median": float(np.median(ms)),
            "ms_max": float(max(ms)), "rows": rows, "refused_by": refused,
            "allocated_before": before, "allocated_after": after}


def main():
    smi = phase_device()
    kind = torch.cuda.get_device_name(0)
    # every launch line the phases parse, for phase 21's validate()
    import nnstreamer_tpu_torch as pt
    launched = []
    parse = pt.parse_launch

    def parse_recorded(desc, *args, **kwargs):
        launched.append(desc)
        return parse(desc, *args, **kwargs)

    pt.parse_launch = parse_recorded
    hmma = phase_build()
    rows = phase_kernels()
    norm_rows, norm_err = phase_normalize()
    with tempfile.TemporaryDirectory() as tmp:
        run = phase_pipeline(smi, tmp)
        mobilenet, frames = phase_mobilenet(smi, tmp)
    norm_launches = phase_normalize_entry(frames)
    vit_batch = phase_vit_batch(smi)
    lines = {"ssd": phase_ssd(smi), "posenet": phase_posenet(smi),
             "deeplab": phase_deeplab(smi), "video": phase_video(smi)}
    graphs = phase_graphs()
    lines["fused_deeplab"] = phase_fused(smi)
    with tempfile.TemporaryDirectory() as tmp:
        labels = os.path.join(tmp, "labels.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"class{i}" for i in range(1000)))
        inflight = phase_vit_inflight(smi, tmp)
    lines["ensemble"] = phase_ensemble(smi)
    lines["aggregated"] = phase_aggregated(smi)
    lines["crop"] = phase_crop(smi)
    lines["throttled"] = phase_throttled(smi)
    traces = phase_traces(smi)
    with tempfile.TemporaryDirectory() as tmp:
        labels = os.path.join(tmp, "labels1001.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"class{i}" for i in range(1001)))
        policies, clean = phase_policies(smi, labels)
    segment = phase_segment_faults(smi, clean)
    lines["query_fanout"] = phase_query_fanout(smi, clean)
    lines["query_vit"] = phase_query_vit(smi)
    lines["edge_pubsub"] = phase_edge_pubsub(smi)
    pt.parse_launch = parse
    pipelint = phase_pipelint(smi, list(dict.fromkeys(launched)))
    for k in ("clean", "retry", "skip", "restart"):
        lines[f"policies_{k}"] = policies[k]
    for k in ("retry", "restart", "skip", "breaker", "filter_restarts"):
        lines[f"segment_{k}"] = segment[k]
    new_paths = {k: row["kernel_launches"] for k, row in lines.items()}
    new_paths.update({f"vit_inflight{k}": row["kernel_launches"]
                      for k, row in inflight.items()})
    main_row = rows[0]
    kernels = [{
        "name": "attention",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/attention.cu",
        "replaces": "nnstreamer_tpu/ops/attention.py:80",
        "launches": run["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "device_ms": main_row["device_ms"],
        "path_launches": {"vit_batch1": run["launches"],
                          f"vit_batch{VIT_BATCH}": vit_batch["launches"],
                          **{k: v["attention"] for k, v in new_paths.items()}},
        "shapes": rows,
        "sass_hmma": hmma,
        "card": smi,
    }, {
        "name": "normalize",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/normalize.cu",
        "replaces": "nnstreamer_tpu/ops/normalize.py:43",
        "launches": norm_launches,
        "max_abs_err": norm_err,
        "ms": norm_rows[0]["ms"],
        "plain_ms": norm_rows[0]["plain_ms"],
        "bound_ms": norm_rows[0]["bound_ms"],
        "bound_by": norm_rows[0]["bound_by"],
        "library_ms": None,
        "path_launches": {k: v["normalize"] for k, v in new_paths.items()},
        "shapes": norm_rows,
        "card": smi,
    }]
    log(json.dumps({"mobilenet": mobilenet, f"vit_batch{VIT_BATCH}": vit_batch,
                    **lines, "graphs": graphs,
                    "vit_inflight": {str(k): v for k, v in inflight.items()},
                    "vit_batch1": run, "traces": traces,
                    "policies_fail": policies["fail"],
                    "segment_clean_after": segment["clean_after"],
                    "pipelint": pipelint, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
