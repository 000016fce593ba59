"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order, but for 32-34, which run right after phase 1 while
phase 2's compilers run; any failure exits non-zero and prints no result
line:

1. device   — a CUDA device must be present; prints nvidia-smi's card
              name and power limit.
2. build    — compiles every CUDA kernel of the port (one nvcc per source,
              all at once: attention.cu, normalize.cu, on a worker
              thread) and prints the build seconds and the seconds
              waited for it after phases 32-34, ptxas's registers,
              shared memory and spills
              for each kernel instantiation and, where cuobjdump is
              present, the HMMA (tensor-core)
              instructions in each attention kernel's SASS: a bf16/f16
              kernel without them fails.
3. kernels  — the attention kernel against its plain PyTorch version on
              the card, at the main path's shapes (a ViT frame, a ViT
              serve bucket of 8, batch 64) and ragged, D=20/72 and
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
22-24. among devices — BASELINE config 5's query fan-out, the ViT line
              behind the query link, edge pub/sub across a killed link.
              Phases 22-37 and the native queue lines run before phase
              21, whose validate() reads their lines too.
25. shared vit — tensortestsrc ! tee into two ViT-B/16 legs (queue,
              filter, appsink) under one shared-tensor-filter-key, 16
              frames: one backend and one graph, 24 attention launches a
              frame, both legs bitwise equal to the lone line;
              memory_allocated() with the pair running against a pair
              under two keys: lower by at least 0.9x the weights' bytes.
26. suspend/reload — the headline line fed by appsrc with suspend=200:
              16 frames, 600 ms idle (memory_allocated() falls by at
              least the weights' bytes), 16 frames (one recapture, bitwise
              equal to the clean run); reload_model(seed=1) while frames
              stream 5 ms apart (a prefix bitwise equal to seed 0's line,
              the rest to seed 1's, none lost); the filter fused with a
              tensor_transform keeps serving seed 0 after the reload and a
              suspend.
27. combination — output-combination=i0,o0 on the headline line (the
              frame and the logits, bitwise); a two-tensor stream with
              input-combination=1; in-flight=4 donate-input=true (host
              and card frames bitwise equal to in-flight=1, the card
              frames unwritten, what donation did); an invoke-dynamic
              custom-easy filter (indices of the logits above the mean,
              FLEXIBLE caps) equal to numpy's.
28. plain backends — framework=pytorch on a .pt traced from the seeded
              MobileNet-v2 (fps and host launches a frame against the
              torch-cuda line in the same call, logits within 1e-2 of
              the largest |logit|; the gap's cause held on 8 frames:
              the torch-cuda replays, the wrapper untraced and the
              traced module with TorchScript's fuser off bitwise equal
              to the torch-cuda eager logits); framework=custom on
              csrc/custom_scaler.cc built with g++ into build/custom/
              (equal to numpy); a python3 script after the card filter
              (equal to numpy); SingleShot("zoo://vit?attn=pallas"): CUDA
              outputs, 12 attention launches a call, bitwise equal to the
              pipeline's.
29. delta link — bench.py's 5 %-motion stream (120 224x224x3 u8 frames,
              one 50x50 patch redrawn a frame) from appsrc through
              edgesink wire-codec=raw, zlib and delta (wire-delta-k=32)
              over loopback into edgesrc ! tee: MobileNet-v2 (torch-cuda)
              on one leg, the frames on the other; wire bytes a frame,
              keyframes, diffs and promotions (the tracer's wire block);
              frames byte-identical to the source, logits bitwise equal to
              the raw link's. Then a session delta link killed twice (every
              40 frames): every frame once and in order, each of the three
              connections' first decoded frame a keyframe, no declared
              loss, one link error a kill.
30. delta gate — the motion stream with each frame held for two, CUDA
              frames through tensor_delta mode=gate tile=16 device=true and
              device=false into MobileNet-v2: the same frames pass, invokes
              = frames in - skipped, tile_error on the card every frame of
              device=true and on none of device=false; tile_error on the
              card against numpy within 1e-5 relative; mode=roi through a
              tensor_query_serversrc server (custom-easy x3) into
              tensor_delta_stitch, equal to the full-frame oracle.
31. sparse   — 32 card frames a dtype (f32, bf16; 224x224x3, 5 %
              non-zeros) through tensor_sparse_enc density=0.1 !
              tensor_sparse_dec device=true: bitwise round trip, every
              frame packed and unpacked on the card (ops/sparse.py's
              counts), nnz within the capacity, the bytes a frame copied
              to the host against the dense frame.
32. llm decode — bench.py:2148's generative line at LLM_LARGE's full
              width (zoo://gpt vocab 32000, d_model 1536, 16 heads, 24
              layers: 1.0 B parameters, seeded random weights on the
              card's generator) through find_filter("llm") and
              invoke_async: bench's one-prompt warm-up, then 8 prompts,
              8 streams, 48 tokens, max_len 128, chunk 32: tokens/s and
              steps/s from submit to last token against the decode
              step's bound (every weight but the embedding and the
              whole KV cache at 3.35 TB/s: 0.6153 ms), time to first
              token, prefill rows, graph captures, the step's device
              time (the 32-step chunk graph replayed alone), host calls
              (torch.profiler) of the run's two kinds of chunk, a
              32-step chunk and a 16-step tail, D2H copies a chunk, open
              time, memory_allocated(); then appsrc !
              tensor_filter framework=llm invoke-async=true ! appsink
              with two prompts in flight, every token buffer carrying
              its prompt's pts.
33. llm parity — at LLM_LARGE: chunk 1 against phase 32's chunk 32;
              a decode graph's replay against an eager step, bitwise;
              paged (block 16, pool_blocks 64) against contiguous,
              greedy and at temperature 0.7, seed 11, top_k 8; the
              prefix cache on against off on bench.py:1617's prompts
              (8 x 64 tokens, 57 shared) with hits, fewer prompt
              tokens computed and fewer prefill rows run (those runs
              decode a token a step, so they capture no chunk graph); a
              16-token prompt's prefill logits against the same weights
              in f32 on the CPU (within 2**-5 of the largest logit).
34. llm single shot — SingleShot(framework=llamacpp) at LLM_LARGE: the
              tokens of invoke_async with set_async_callback equal a
              sync invoke's.
Native queue — the headline line with queue backend=native against
              backend=python, in turns (python, native, native, python),
              after `make native` (its seconds printed): logits bitwise
              equal, fps and p50. Every other line runs the Python
              queue, whatever build/native/ holds: main() adds
              backend=python to each queue of a line that names no
              backend (backend=auto would take the ring once the library
              is on disk), counts the queues of each kind and fails on a
              ring queue outside the native lines.
35. serve mobilenet — bench.py:562's bench_serve_row with the port's
              framework: 8 port tensor_query_clients (max-request 16, 8
              warm-up and 80 timed frames each, 16 seeded frames) into
              tensor_serve_src buckets=1,2,4,8 max-wait-ms=4 max-queue=64
              ! the full-width MobileNet-v2 (prefetch-host=true) ! queue
              32 ! tensor_serve_sink: aggregate fps, batches, occupancy,
              queue delay p50/p95, sheds (none allowed), compile_count
              (<= 4, one captured graph a bucket), D2H arrays a batch (1,
              the sink handed PendingHost chunks only), every reply once
              and in order and within FANOUT_REL_TOL of its frame's
              batch-1 headline logits (the gap printed); then the same
              clients against tensor_query_serversrc batch=0 (one invoke
              a frame): its fps, and served over per-request.
36. serve vit — the same serve line over ViT-B/16 attn=pallas at full
              width: the attention kernel at (b,196,12,64), b in
              {1,2,4,8}, 12 launches a batch (counted, = 12 x batches),
              each reply within phase 4's ViT bf16 rule of phase 23's
              batch-1 logits of its frame.
37. drain and router — the MobileNet serve line, 4 clients x 16 frames
              all on the wire, Pipeline.drain() while part is queued:
              drain returns True, every request answered once (RESULT
              or SHED, none declared lost) and requests = completed +
              shed_deadline + cancelled + shed_failed; then two serve
              replicas under one shared-tensor-filter-key (one backend)
              behind tensor_serve_router (heartbeat 50 ms, affinity on),
              4 clients x 32 frames, the busier replica's links killed
              after a third: every frame delivered once, none shed or
              lost, the router's requests = delivered + shed + orphaned,
              redispatches printed.
Every model line runs through the backend's per-signature executable,
one captured CUDA graph per input signature: the first frame runs
eagerly (the capture's warm-up), every later frame is one replay, so a
hand kernel inside the graph counts once a frame.
Phases 8-11, 13, 16, 17, 19, 20, 22, 24, 26, 27, 29-35, 37 and the
native queue lines launch neither hand kernel
(their models inline their input affine, as the JAX models do); their
launch counts are read all the same and written on the kernels line as
0. The
tracer's times are host times: a filter's proctime is its dispatch
(staging and the graph launch), not the device time.

Before the kernels line, a line gives each phase's wall seconds and the
seconds since the script started.
The second-to-last line is the kernels JSON, the last line the result:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Imports nothing of JAX and nothing of the JAX package.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 FLOP/s
HBM_BYTES_S = 3.35e12
# each phase's wall seconds, printed with the total before the result
PHASE_S = {}


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = round(time.perf_counter() - t0, 2)
    return out
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


def start_build():
    """Phase 2's work on a worker thread: every kernel's nvcc, started
    together, then the attention library's SASS; then `make native` for
    the native queue lines (its seconds). The phases that launch neither
    kernel (32-34) run meanwhile."""
    from concurrent.futures import ThreadPoolExecutor
    from nnstreamer_tpu_torch.native.lib import load_native_lib
    from nnstreamer_tpu_torch.ops import _build

    def work():
        t0 = time.perf_counter()
        logs = _build.build_all()
        secs = time.perf_counter() - t0
        hmma = _sass_hmma(_build.library_path("attention"))
        t0 = time.perf_counter()
        if load_native_lib() is None:
            sys.exit("chip_smoke: make native failed")
        return logs, secs, hmma, time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    try:
        return pool.submit(work)
    finally:
        pool.shutdown(wait=False)


def phase_build(building):
    t0 = time.perf_counter()
    logs, secs, hmma, _ = building.result()
    log(f"build: {secs:.2f} s for {sorted(logs)}, "
        f"{time.perf_counter() - t0:.2f} s of it waited for after phases "
        "32-34")
    for name, out in logs.items():
        for func, regs, spill in _ptxas_report(out):
            log(f"  ptxas[{name}] {func}: {regs}; {spill}")
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


def _profiled():
    """The activities of every profiler session of the script, CPU and
    CUDA: the profiler's first session of a kind takes seconds to set
    up."""
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _trace_counts(parts, names):
    """Run each ``(label, fn)`` of ``parts`` in turn inside one
    torch.profiler session, each under a record_function range of its
    label, and count the trace's events named in ``names`` (name ->
    key) whose start falls in each range: {label: {key: count}}. Reads
    the raw trace: a chunk graph's replay records ~48,000 device
    kernels, which key_averages() takes seconds to turn into Python
    events."""
    from torch.profiler import profile, record_function
    torch.cuda.synchronize()
    with profile(activities=_profiled()) as prof:
        for label, fn in parts:
            with record_function(label):
                fn()
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    # the host's ranges (the device timeline repeats each label)
    spans = {e.name(): (e.start_ns(), e.end_ns()) for e in events
             if e.name() in dict(parts)
             and e.device_type() == torch.autograd.DeviceType.CPU}
    if len(spans) != len(parts):
        sys.exit(f"chip_smoke: the trace lacks ranges {dict(parts).keys()}"
                 f" - {spans.keys()}")
    out = {label: {} for label, _ in parts}
    for e in events:
        key = names.get(e.name())
        if key is None:
            continue
        for label, (t0, t1) in spans.items():
            if t0 <= e.start_ns() <= t1:
                out[label][key] = out[label].get(key, 0) + 1
    return out


def device_ms(fn, kernel, iters=20):
    """Mean device time (ms) of the kernels named ``kernel`` in one call,
    from torch.profiler's CUDA trace over ``iters`` calls; None if the
    profiler records none. Event times of back-to-back calls measure the
    host's enqueue rate where a launch is shorter than its enqueue."""
    from torch.profiler import profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=_profiled()) as prof:
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
             # a full bucket of the ViT serve line (phase 36)
             ((8, 196, 12, 64), torch.bfloat16, 2.0 ** -6),
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


def _query_client(port, frames, order, replies, sent, arrived, on_reply,
                  window=FANOUT_WINDOW):
    """One client pipeline: appsrc ! tensor_query_client ! appsink. The
    client element's do_chain is wrapped to stamp when each frame leaves
    for the server; ``order`` lists the frame index of each request and
    ``window`` is the client's max-request."""
    import nnstreamer_tpu_torch as pt
    client = pt.parse_launch(
        f"appsrc name=in caps={_caps_at(FRAME_DIMS)} ! tensor_query_client "
        f"name=qc port={port} timeout=120 max-request={window} "
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
    link: one client, 16 frames, the attention kernel on the server.
    Returns its row and the local line's logits of the 16 frames (phase
    36's batch-1 reference)."""
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
    return row, want


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


# -- phases 25-28: the rest of tensor_filter, the plain backends --------

SUSPEND_MS = 200           # phase 26's suspend window
SWAP_FRAMES = 16           # phase 26's frames around a reload
GAP_FRAMES = 8             # phase 28's frames for the pytorch gap
# phase 28: the pytorch line's logits against the torch-cuda line's, as a
# share of the largest |logit|. TorchScript runs the same bf16 model
# through its own graph executor and fuser, which round at other points:
# 0.57 % read on an H100 80GB HBM3 (700 W), on the first frames and the
# steady ones alike; 1 % is about 2.5 bf16 ulps of the largest logit
PT_TOL_REL = 1e-2


def _weights_bytes(fw):
    """Bytes of a torch-cuda backend's parameters and buffers."""
    m = fw._module
    return sum(t.numel() * t.element_size()
               for t in list(m.parameters()) + list(m.buffers()))


def _allocated():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _push_all(pipe, frames, gap_s=0.0, start=0):
    import nnstreamer_tpu_torch as pt
    for i, f in enumerate(frames):
        pipe["in"].push_buffer(pt.Buffer.from_arrays([f], pts=start + i))
        if gap_s:
            time.sleep(gap_s)


def _wait_frames(pipe, n, what, timeout=300):
    deadline = time.monotonic() + timeout
    while len(pipe["out"].buffers) < n:
        if time.monotonic() > deadline:
            sys.exit(f"chip_smoke: {what}: {len(pipe['out'].buffers)} of "
                     f"{n} frames arrived")
        time.sleep(0.002)


def phase_shared_vit(smi):
    """Phase 25: tensortestsrc ! tee into two ViT-B/16 legs (queue,
    filter, appsink each) under one shared-tensor-filter-key, against
    the lone line and against a pair under two keys; returns the row
    and the lone line's logits."""
    import nnstreamer_tpu_torch as pt
    model = "zoo://vit?attn=pallas"
    want = _model_outputs(model, FRAMES)

    def pair(keys):
        legs = " ".join(
            f"t. ! queue max-size-buffers=8 ! tensor_filter name={leg} "
            f'framework=torch-cuda model="{model}" '
            f"shared-tensor-filter-key={key} ! appsink name=o{leg}"
            for leg, key in zip("ab", keys))
        pipe = pt.parse_launch(
            f"tensortestsrc caps={_caps_at(FRAME_DIMS)} pattern=random "
            f"seed={SEED} num-buffers={FRAMES} ! tee name=t {legs}")
        _reset_launches()
        pipe.start()
        try:
            if not pipe.wait_eos(600):
                sys.exit(f"chip_smoke: shared vit {keys}: no EOS")
            row = {"allocated": _allocated(),
                   "same_backend": pipe["a"].fw is pipe["b"].fw,
                   "compile_count": [pipe["a"].fw.compile_count,
                                     pipe["b"].fw.compile_count],
                   "weights_bytes": _weights_bytes(pipe["a"].fw),
                   "kernel_launches": _kernel_launches()}
        finally:
            pipe.stop()
        legs = {leg: np.stack([b.chunks[0].host()
                               for b in pipe[f"o{leg}"].buffers])
                for leg in "ab"}
        row["bitwise_equal_lone"] = all(
            v.shape == want.shape and v.tobytes() == want.tobytes()
            for v in legs.values())
        return row

    shared = pair(("vit", "vit"))
    apart = pair(("vit_a", "vit_b"))
    saved = apart["allocated"] - shared["allocated"]
    weights = shared["weights_bytes"]
    launches = shared["kernel_launches"]["attention"]
    row = {"frames": FRAMES, "allocated_shared": shared["allocated"],
           "allocated_two_keys": apart["allocated"], "saved_bytes": saved,
           "weights_bytes": weights, "shared": shared, "two_keys": apart,
           "kernel_launches": shared["kernel_launches"]}
    log(f"shared vit: two legs under one key share one backend "
        f"({shared['same_backend']}), graphs {shared['compile_count']}, "
        f"attention launches {launches} ({launches / FRAMES:.0f} a frame), "
        f"legs {'bitwise equal' if shared['bitwise_equal_lone'] else 'NOT EQUAL'}"
        f" to the lone line; memory_allocated {shared['allocated']} B "
        f"shared vs {apart['allocated']} B under two keys: "
        f"{saved / 2**20:.1f} MiB saved, ViT-B/16 weights "
        f"{weights / 2**20:.1f} MiB; {smi}")
    if not shared["same_backend"] or shared["compile_count"] != [1, 1] \
            or not shared["bitwise_equal_lone"] \
            or not apart["bitwise_equal_lone"] \
            or launches != 2 * VIT_LAYERS * FRAMES \
            or saved < 0.9 * weights:
        sys.exit(f"chip_smoke: shared vit: {row}")
    return row, want


def _suspend_line(fused):
    """The headline MobileNet-v2 line fed by appsrc with suspend; fused,
    the filter runs in one segment with a tensor_transform after it."""
    mid = ("! tensor_transform name=x mode=arithmetic option=mul:2 "
           if fused else "")
    return (f"appsrc name=in caps={_caps_at(FRAME_DIMS)} ! queue "
            "max-size-buffers=8 ! tensor_filter name=f framework=torch-cuda "
            "model=zoo://mobilenet_v2 latency=1 prefetch-host=true "
            f"suspend={SUSPEND_MS} {mid}! queue max-size-buffers=32 "
            "! appsink name=out")


def _swap_split(got, before, after):
    """The index where the outputs switch from ``before`` to ``after``:
    a prefix bitwise equal to ``before``, the rest to ``after``; None
    when they are not."""
    split = 0
    while split < len(got) and got[split].tobytes() == \
            before[split].tobytes():
        split += 1
    ok = all(got[i].tobytes() == after[i].tobytes()
             for i in range(split, len(got)))
    return split if ok else None


def phase_suspend_reload(smi, clean):
    """Phase 26: suspend=200 on the headline line (16 frames, 3 windows
    idle, 16 frames) and reload_model to seed 1 mid-stream; then the
    same reload on the filter fused with the transform after it."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.filters.base import FilterEvent
    n = SWAP_FRAMES
    frames = _frames(2 * n, _frame_shape()).numpy()
    seed0 = _headline_logits(clean, 2 * n)
    line1 = _headline_line(n).replace(
        "model=zoo://mobilenet_v2", "model=zoo://mobilenet_v2?seed=1")
    seed1, _ = _run_timed(line1, 0, n)
    seed1 = [b.chunks[0].host() for b in seed1["out"].buffers]
    out = {}
    _reset_launches()
    pipe = pt.parse_launch(_suspend_line(False))
    pipe.start()
    try:
        f = pipe["f"]
        _push_all(pipe, frames[:n])
        _wait_frames(pipe, n, "suspend, first frames")
        weights = _weights_bytes(f.fw)
        busy = _allocated()
        time.sleep(3 * SUSPEND_MS / 1e3)
        suspended = f.fw._host_module is not None
        idle = _allocated()
        compiles = f.fw.compile_count
        t0 = time.perf_counter()
        _push_all(pipe, frames[n:n + 1], start=n)
        _wait_frames(pipe, n + 1, "suspend, first frame after the resume")
        first_ms = (time.perf_counter() - t0) * 1e3
        _push_all(pipe, frames[n + 1:], start=n + 1)
        _wait_frames(pipe, 2 * n, "suspend, frames after the resume")
        resumed = f.fw.compile_count
        # a steady frame for scale: one more, pushed and awaited alone
        t0 = time.perf_counter()
        _push_all(pipe, frames[:1], start=2 * n)
        _wait_frames(pipe, 2 * n + 1, "suspend, a steady frame")
        steady_ms = (time.perf_counter() - t0) * 1e3
        # reload mid-stream: a thread pushes frames 5 ms apart from
        # before the reload starts until SWAP_FRAMES after it returned,
        # while this one loads the seed-1 model and swaps it in
        import threading
        base = 2 * n + 1
        stop, pushed = threading.Event(), [0]

        def feed():
            while not stop.is_set():
                i = pushed[0]
                pipe["in"].push_buffer(pt.Buffer.from_arrays(
                    [frames[i % n]], pts=base + i))
                pushed[0] = i + 1
                time.sleep(0.005)

        feeder = threading.Thread(target=feed)
        feeder.start()
        time.sleep(0.05)
        t0 = time.perf_counter()
        f.reload_model("zoo://mobilenet_v2?seed=1")
        reload_ms = (time.perf_counter() - t0) * 1e3
        at_swap = pushed[0]
        while pushed[0] < at_swap + n:
            time.sleep(0.005)
        stop.set()
        feeder.join()
        sent = pushed[0]
        _wait_frames(pipe, base + sent, "reload")
        pipe["in"].end_stream()
        pipe.wait_eos(60)
    finally:
        pipe.stop()
    launches = _kernel_launches()
    got = [b.chunks[0].host() for b in pipe["out"].buffers]
    across = all(g.tobytes() == w.tobytes()
                 for g, w in zip(got[:2 * n], seed0))
    split = _swap_split(got[base:], [seed0[i % n] for i in range(sent)],
                        [seed1[i % n] for i in range(sent)])
    out["plain"] = {
        "weights_bytes": weights, "allocated_busy": busy,
        "allocated_idle": idle, "freed_bytes": busy - idle,
        "suspended": suspended, "compile_count_before": compiles,
        "compile_count_after_resume": resumed,
        "first_frame_after_resume_ms": first_ms,
        "steady_frame_ms": steady_ms, "bitwise_across_resume": across,
        "reload_ms": reload_ms, "reload_sent": sent, "reload_split": split,
        "frames": len(got), "kernel_launches": launches}
    log(f"suspend: {n} frames, {3 * SUSPEND_MS} ms idle (suspended "
        f"{suspended}), memory_allocated {busy} -> {idle} B "
        f"({(busy - idle) / 2**20:.2f} MiB freed; weights "
        f"{weights / 2**20:.2f} MiB), {n} frames after the resume "
        f"{'bitwise equal' if across else 'NOT EQUAL'} to the clean run, "
        f"graphs {compiles} -> {resumed}; first frame after the resume "
        f"{first_ms:.2f} ms, a steady frame {steady_ms:.2f} ms (pushed and "
        f"awaited alone); {smi}")
    log(f"reload: reload_model(seed=1) took {reload_ms:.1f} ms while "
        f"frames streamed 5 ms apart; {len(got) - base} of {sent} arrived, "
        f"the first {split} bitwise equal to seed 0's and the rest to seed "
        f"1's; {smi}")
    if not suspended or busy - idle < weights or not across \
            or resumed != compiles + 1 or split is None \
            or not 0 < split < sent or len(got) != base + sent:
        sys.exit(f"chip_smoke: suspend/reload: {out['plain']}")

    # fused with the transform after it: the segment keeps the weights
    # it was planned with across the reload (as the JAX package's does)
    _reset_launches()
    pipe = pt.parse_launch(_suspend_line(True))
    pipe.start()
    try:
        segs = _segments(pipe)
        _push_all(pipe, frames[:n // 2])
        _wait_frames(pipe, n // 2, "fused reload, first frames")
        pipe["f"].reload_model("zoo://mobilenet_v2?seed=1")
        pipe["f"].fw.handle_event(FilterEvent.SUSPEND)
        _push_all(pipe, frames[n // 2:n], start=n // 2)
        _wait_frames(pipe, n, "fused reload, frames after it")
        pipe["in"].end_stream()
        pipe.wait_eos(60)
    finally:
        pipe.stop()
    launches = _kernel_launches()
    got = [b.chunks[0].host() for b in pipe["out"].buffers]
    twice = [(w * 2).astype(np.float32) for w in seed0[:n]]
    serves = "seed 0" if all(g.tobytes() == w.tobytes()
                             for g, w in zip(got, twice)) else "other"
    out["fused"] = {"segments": [[m.name for m in s.members] for s in segs],
                    "frames": len(got), "serves_after_reload": serves,
                    "kernel_launches": launches}
    log(f"fused reload: segment {out['fused']['segments']}; after "
        f"reload_model(seed=1) and a suspend the fused line serves "
        f"{serves}'s weights ({len(got)} frames, each 2x the seed-0 "
        f"logits bitwise), as the JAX package's fused segment does; {smi}")
    if out["fused"]["segments"] != [["f", "x"]] or serves != "seed 0":
        sys.exit(f"chip_smoke: fused reload: {out['fused']}")
    return out


def phase_combination(smi, clean):
    """Phase 27: output-combination=i0,o0 on the headline line, a
    two-tensor stream with input-combination=1, in-flight=4 with
    donate-input=true, and an invoke-dynamic custom-easy filter."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.filters import (register_custom_easy,
                                              unregister_custom_easy)
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        DONATION_NOTE
    n = SWAP_FRAMES
    frames = _frames(n, _frame_shape()).numpy()
    want = _headline_logits(clean, n)
    out = {}
    _reset_launches()
    pipe, _ = _run_timed(_headline_line(n, extra="output-combination=i0,o0 "),
                         0, n)
    launches = _kernel_launches()
    bufs = pipe["out"].buffers
    ok = all(len(b.chunks) == 2 and b.chunks[0].host().tobytes()
             == f.tobytes() and b.chunks[1].host().tobytes() == w.tobytes()
             for b, f, w in zip(bufs, frames, want))
    out["output_combination"] = {"frames": len(bufs), "equal": ok,
                                 "caps": str(pipe["out"].sinkpad.caps),
                                 "kernel_launches": launches}
    log(f"output-combination=i0,o0: {len(bufs)} frames, each the u8 frame "
        f"and the logits, {'bitwise equal' if ok else 'NOT EQUAL'} to the "
        f"input and the headline line's; caps {out['output_combination']['caps']}")
    if not ok:
        sys.exit("chip_smoke: output-combination differs")
    # two tensors a frame: noise, then the frame; the model takes tensor 1
    noise = np.random.default_rng(SEED).random((n, 10)).astype(np.float32)
    caps = ('other/tensors,format=static,num_tensors=2,types=(string)'
            f'"float32,uint8",dimensions=(string)"10,{FRAME_DIMS}",'
            'framerate=(fraction)0/1')
    _reset_launches()
    pipe = pt.parse_launch(
        f"appsrc name=in caps={caps} ! queue max-size-buffers=8 ! "
        "tensor_filter framework=torch-cuda model=zoo://mobilenet_v2 "
        "input-combination=1 output-combination=o0,i0 ! appsink name=out")
    pipe.start()
    try:
        for i in range(n):
            pipe["in"].push_buffer(pt.Buffer.from_arrays(
                [noise[i], frames[i]], pts=i))
        pipe["in"].end_stream()
        pipe.wait_eos(300)
    finally:
        pipe.stop()
    launches = _kernel_launches()
    bufs = pipe["out"].buffers
    ok = len(bufs) == n and all(
        b.chunks[0].host().tobytes() == w.tobytes()
        and b.chunks[1].host().tobytes() == z.tobytes()
        for b, w, z in zip(bufs, want, noise))
    out["input_combination"] = {"frames": len(bufs), "equal": ok,
                                "kernel_launches": launches}
    log(f"input-combination=1 on a two-tensor stream: {len(bufs)} frames, "
        f"logits {'bitwise equal' if ok else 'NOT EQUAL'} to the headline "
        "line's, tensor 0 passed through")
    if not ok:
        sys.exit("chip_smoke: input-combination differs")

    # in-flight=4 with donate-input: host frames, then frames on the card
    _reset_launches()
    pipe, _ = _run_timed(_headline_line(
        n, extra="in-flight=4 donate-input=true "), 0, n)
    out["donate_host"] = {"kernel_launches": _kernel_launches()}
    got = _by_pts(pipe)
    host_ok = _bitwise(got, clean) and len(got) == n
    dev = [torch.from_numpy(f).cuda() for f in frames]
    kept = [d.clone() for d in dev]
    _reset_launches()
    pipe = pt.parse_launch(_suspend_line(False).replace(
        f"suspend={SUSPEND_MS}", "in-flight=4 donate-input=true"))
    pipe.start()
    try:
        _push_all(pipe, dev)
        pipe["in"].end_stream()
        pipe.wait_eos(300)
        fw = pipe["f"].fw
        noted = fw._donation_noted
    finally:
        pipe.stop()
    launches = _kernel_launches()
    torch.cuda.synchronize()
    intact = all(torch.equal(d, k) for d, k in zip(dev, kept))
    dev_ok = len(pipe["out"].buffers) == n and all(
        b.chunks[0].host().tobytes() == w.tobytes()
        for b, w in zip(pipe["out"].buffers, want))
    out["donate"] = {"host_bitwise": host_ok, "device_bitwise": dev_ok,
                     "upstream_intact": intact, "noted": noted,
                     "note": DONATION_NOTE, "kernel_launches": launches}
    out["donate_host"]["bitwise"] = host_ok
    log(f"in-flight=4 donate-input=true: logits of {n} host frames "
        f"{'bitwise equal' if host_ok else 'NOT EQUAL'} to in-flight=1, of "
        f"{n} frames pushed on the card "
        f"{'bitwise equal' if dev_ok else 'NOT EQUAL'}, every upstream CUDA "
        f"frame {'intact' if intact else 'WRITTEN'}; what donation did: "
        f"{DONATION_NOTE}")
    if not (host_ok and dev_ok and intact and noted):
        sys.exit(f"chip_smoke: donate-input: {out['donate']}")

    # invoke-dynamic: the indices of the logits above the frame's mean
    def above_mean(x):
        return np.nonzero(x > x.mean())[0].astype(np.int32)

    register_custom_easy("above_mean", above_mean)
    _reset_launches()
    try:
        pipe, _ = _run_timed(_headline_line(
            n, tail="! tensor_filter framework=custom-easy model=above_mean "
                    "invoke-dynamic=true "), 0, n)
    finally:
        unregister_custom_easy("above_mean")
    launches = _kernel_launches()
    got = [b.chunks[0].host() for b in pipe["out"].buffers]
    ok = len(got) == n and all(
        g.dtype == np.int32 and np.array_equal(g, above_mean(w))
        for g, w in zip(got, want))
    caps = pipe["out"].sinkpad.caps.to_config()
    out["dynamic"] = {"frames": len(got), "equal": ok,
                      "lengths": [int(g.shape[0]) for g in got],
                      "format": caps.format.name,
                      "kernel_launches": launches}
    log(f"invoke-dynamic: {len(got)} frames of {sorted(set(out['dynamic']['lengths']))[:4]}"
        f"... indices, caps format {caps.format.name}, each "
        f"{'equal' if ok else 'NOT EQUAL'} to numpy's on the headline "
        f"logits; {smi}")
    if not ok or caps.format.name != "FLEXIBLE":
        sys.exit(f"chip_smoke: invoke-dynamic: {out['dynamic']}")
    return out


PY3_SOFTMAX = """
import numpy as np


def invoke(inputs):
    x = np.asarray(inputs[0], dtype=np.float32)
    e = np.exp(x - x.max())
    return [(e / e.sum()).astype(np.float32)]
"""


def _host_launches(fn, calls):
    """Kernel launches the host makes per call of ``fn``
    (cudaLaunchKernel and its variants in torch.profiler's trace)."""
    names = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx")

    def run():
        for _ in range(calls):
            fn()
    counts = _trace_counts([("calls", run)], {n: n for n in names})
    return sum(counts["calls"].values()) / calls


def _build_custom_scaler():
    """csrc/custom_scaler.cc built with g++ into build/custom/; returns
    (the .so's path, build seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    so_dir = os.path.join(root, "build", "custom")
    os.makedirs(so_dir, exist_ok=True)
    so = os.path.join(so_dir, "libcustom_scaler.so")
    t0 = time.perf_counter()
    subprocess.run(["g++", "-shared", "-fPIC", "-O2", "-I",
                    os.path.join(root, "csrc"),
                    os.path.join(root, "csrc", "custom_scaler.cc"),
                    "-o", so], check=True, timeout=300)
    return so, time.perf_counter() - t0


def _pytorch_gap(path, frames, frame_cls):
    """Where the pytorch line's logits part from the torch-cuda line's:
    each variant against the torch-cuda backend's eager logits (its
    first, uncaptured frame path) on the same card frames: its graph
    replays, the wrapper ``frame_cls`` untraced, and the traced module at
    ``path`` under framework=pytorch as the line runs it, with
    TorchScript's tensor-expression fuser off, and unoptimised. A row:
    the largest |diff|, that over the largest |logit|, the frames
    bitwise equal."""
    from nnstreamer_tpu_torch.filters import find_filter
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.tensors.info import TensorsInfo
    xs = [torch.from_numpy(f).cuda() for f in frames]
    fw = find_filter("torch-cuda")()
    fw.open(FilterProperties(model_files=("zoo://mobilenet_v2",)))
    with torch.inference_mode():
        eager = [fw._apply(fw._module, x).float().cpu().numpy() for x in xs]
    got = {"torch_cuda_replayed": []}
    for x in xs:
        fw.invoke([x])  # the first call of a signature runs eagerly
        got["torch_cuda_replayed"].append(
            fw.invoke([x])[0].float().cpu().numpy())
    with torch.no_grad():
        wrapper = frame_cls(fw._module).eval()
        got["eager_untraced"] = [wrapper(x).float().cpu().numpy()
                                 for x in xs]
    fw.close()

    def traced():
        pfw = find_filter("pytorch")()
        pfw.open(FilterProperties(
            model_files=(path,),
            input_info=TensorsInfo.make("uint8", FRAME_DIMS)))
        out = [pfw.invoke([x])[0].float().cpu().numpy() for x in xs]
        pfw.close()
        return out

    got["traced_default"] = traced()
    torch._C._jit_set_texpr_fuser_enabled(False)
    try:
        got["traced_fuser_off"] = traced()
    finally:
        torch._C._jit_set_texpr_fuser_enabled(True)
    with torch.jit.optimized_execution(False):
        got["traced_unoptimized"] = traced()
    scale = max(float(np.abs(e).max()) for e in eager)
    rows = {}
    for name, outs in got.items():
        diff = max(float(np.abs(g - e).max()) for g, e in zip(outs, eager))
        rows[name] = {"max_abs_diff": diff, "rel_to_max_logit": diff / scale,
                      "bitwise_frames": sum(g.tobytes() == e.tobytes()
                                            for g, e in zip(outs, eager)),
                      "frames": len(outs)}
    return rows


def phase_plain_backends(smi, clean, vit, tmp):
    """Phase 28: framework=pytorch on a .pt traced from the seeded
    MobileNet-v2, framework=custom on csrc/custom_scaler.cc built with
    g++, a python3 script after the card filter, and SingleShot on the
    ViT line's model against the lone line's logits ``vit``."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.filters import find_filter
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.tensors.info import TensorsInfo
    out = {}
    n = MOBILENET_WARMUP + MOBILENET_FRAMES
    frames = _frames(SWAP_FRAMES, _frame_shape()).numpy()
    want = _headline_logits(clean, SWAP_FRAMES)

    # -- pytorch: the zoo's seed-0 MobileNet-v2 behind a u8-frame wrapper
    apply_fn, module, _, _ = zoo.build("mobilenet_v2")

    class Frame(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, x):
            return apply_fn(self.m, x)

    path = os.path.join(tmp, "mobilenet_v2.pt")
    with torch.no_grad():
        torch.jit.trace(Frame(module.cuda().eval()),
                        torch.from_numpy(frames[0]).cuda()).save(path)
    del module
    pt_line = _headline_line(n).replace(
        "framework=torch-cuda model=zoo://mobilenet_v2",
        f"framework=pytorch model={path} input={FRAME_DIMS} inputtype=uint8")
    rows = {}
    for name, line in (("torch-cuda", _headline_line(n)),
                       ("pytorch", pt_line)):
        pipe, row = _run_line(f"plain {name}", line, MOBILENET_WARMUP,
                              MOBILENET_FRAMES, smi)
        rows[name] = (row, [b.chunks[0].host() for b in pipe["out"].buffers])
    scale = max(float(np.abs(w).max()) for w in want)
    diffs = [float(np.abs(g - w).max())
             for g, w in zip(rows["pytorch"][1], rows["torch-cuda"][1])]
    fw = find_filter("pytorch")()
    fw.open(FilterProperties(model_files=(path,),
                             input_info=TensorsInfo.make("uint8",
                                                         FRAME_DIMS)))
    x = torch.from_numpy(frames[0]).cuda()
    launches = _host_launches(lambda: fw.invoke([x]), 8)
    fw.close()
    r = out["pytorch"] = {
        "fps": rows["pytorch"][0]["fps"],
        "p50_ms": rows["pytorch"][0]["p50_ms"],
        "torch_cuda_fps": rows["torch-cuda"][0]["fps"],
        "torch_cuda_p50_ms": rows["torch-cuda"][0]["p50_ms"],
        "host_launches_a_frame": launches,
        "max_abs_diff_first2": max(diffs[:2]),
        "max_abs_diff_steady": max(diffs[2:]),
        "bitwise_frames": sum(d == 0 for d in diffs), "frames": len(diffs),
        "max_abs_logit": scale, "tol": PT_TOL_REL * scale,
        "torch_cuda_bitwise_clean": all(
            g.tobytes() == w.tobytes()
            for g, w in zip(rows["torch-cuda"][1], want)),
        "kernel_launches": rows["pytorch"][0]["kernel_launches"]}
    out["torch_cuda"] = rows["torch-cuda"][0]
    log(f"pytorch (TorchScript, eager): {r['fps']:.2f} fps, p50 "
        f"{r['p50_ms']:.3f} ms, {launches:.1f} host launches a frame, "
        f"against torch-cuda {r['torch_cuda_fps']:.2f} fps, p50 "
        f"{r['torch_cuda_p50_ms']:.3f} ms in the same call; logits vs the "
        f"torch-cuda line: max |diff| first 2 frames "
        f"{r['max_abs_diff_first2']:.4g}, frames 3..{len(diffs)} "
        f"{r['max_abs_diff_steady']:.4g} ({r['bitwise_frames']} of "
        f"{len(diffs)} bitwise; tol {r['tol']:.4g} = {PT_TOL_REL} of max "
        f"|logit| {scale:.4g}); {smi}")
    if max(diffs) > r["tol"] or not r["torch_cuda_bitwise_clean"]:
        sys.exit(f"chip_smoke: pytorch line: {r}")
    # the cause of the gap: TorchScript's fuser, which the line keeps on
    gap = r["gap"] = _pytorch_gap(path, frames[:GAP_FRAMES], Frame)
    log("pytorch gap against the torch-cuda eager logits, " + ", ".join(
        f"{k} {v['rel_to_max_logit']:.4g} of max |logit| "
        f"({v['bitwise_frames']} of {v['frames']} bitwise)"
        for k, v in gap.items()) + f"; {smi}")
    if any(gap[k]["bitwise_frames"] != GAP_FRAMES for k in (
            "torch_cuda_replayed", "eager_untraced", "traced_fuser_off")):
        sys.exit(f"chip_smoke: the fuser does not explain the pytorch "
                 f"line's gap: {gap}")

    # -- custom: csrc/custom_scaler.cc, built with g++ at first use
    so, build_s = _build_custom_scaler()
    f32 = np.random.default_rng(SEED).random(
        (SWAP_FRAMES,) + _frame_shape()).astype(np.float32)
    caps = _caps_at(FRAME_DIMS).replace("uint8", "float32")
    _reset_launches()
    pipe = pt.parse_launch(
        f"appsrc name=in caps={caps} ! tensor_filter framework=custom "
        f"model={so} custom=2.5 ! appsink name=out")
    pipe.start()
    try:
        _push_all(pipe, f32)
        pipe["in"].end_stream()
        pipe.wait_eos(120)
    finally:
        pipe.stop()
    launches = _kernel_launches()
    got = [b.chunks[0].host() for b in pipe["out"].buffers]
    ok = len(got) == SWAP_FRAMES and all(
        g.tobytes() == (x * np.float32(2.5)).tobytes()
        for g, x in zip(got, f32))
    out["custom"] = {"frames": len(got), "equal_numpy": ok,
                     "build_s": build_s, "kernel_launches": launches}
    log(f"custom .so (g++ {build_s:.2f} s): {len(got)} f32 frames "
        f"{'equal' if ok else 'NOT EQUAL'} to numpy's x * 2.5")
    if not ok:
        sys.exit("chip_smoke: the custom .so differs from numpy")

    # -- python3: softmax in numpy after the MobileNet filter's CUDA output
    script = os.path.join(tmp, "softmax.py")
    with open(script, "w") as f:
        f.write(PY3_SOFTMAX)
    _reset_launches()
    pipe, _ = _run_timed(_headline_line(
        SWAP_FRAMES, tail=f"! tensor_filter framework=python3 "
        f"model={script} "), 0, SWAP_FRAMES)
    launches = _kernel_launches()
    got = [b.chunks[0].host() for b in pipe["out"].buffers]
    ns = {}
    exec(PY3_SOFTMAX, ns)  # noqa: S102 - the same script as the filter's
    ok = len(got) == SWAP_FRAMES and all(
        g.tobytes() == ns["invoke"]([w])[0].tobytes()
        for g, w in zip(got, want))
    out["python3"] = {"frames": len(got), "equal_numpy": ok,
                      "kernel_launches": launches}
    log(f"python3: {len(got)} softmax frames after the card filter "
        f"{'equal' if ok else 'NOT EQUAL'} to numpy's on the headline "
        "logits")
    if not ok:
        sys.exit("chip_smoke: the python3 filter differs from numpy")

    # -- SingleShot on the ViT line's model
    vframes = _frames(FRAMES, _frame_shape()).numpy()
    _reset_launches()
    with pt.SingleShot("zoo://vit?attn=pallas") as shot:
        outs = [shot.invoke([f])[0] for f in vframes]
        torch.cuda.synchronize()
    single = _kernel_launches()
    on_card = all(o.is_cuda for o in outs)
    same = all(o.cpu().numpy().tobytes() == v.tobytes()
               for o, v in zip(outs, vit))
    out["single_shot"] = {"calls": FRAMES, "cuda_outputs": on_card,
                          "kernel_launches": single,
                          "bitwise_equal_pipeline": same}
    log(f"SingleShot(zoo://vit?attn=pallas): {FRAMES} calls, outputs on "
        f"the card {on_card}, attention launches {single['attention']} "
        f"({single['attention'] / FRAMES:.0f} a call), logits "
        f"{'bitwise equal' if same else 'NOT EQUAL'} to the pipeline's; "
        f"{smi}")
    if not on_card or not same or single["attention"] != VIT_LAYERS * FRAMES:
        sys.exit(f"chip_smoke: SingleShot: {out['single_shot']}")
    return out


# -- phases 29-31: sparse and delta; the native queue --------------------

DELTA_FRAMES = 120         # bench.py:724 _delta_motion_frames' stream
DELTA_PATCH = 50           # one 50x50 patch redrawn a frame: ~5 % motion
DELTA_K = 32               # wire-delta-k of phase 29's links
DELTA_KILL_EVERY = 40      # phase 29: a link kill every 40 frames, twice
DELTA_RING_KB = 32768      # its replay ring holds the whole 18 MB stream
DELTA_TILE = 16            # phase 30's change-grid tile
TILE_RTOL = 1e-5           # tile_error on the card against numpy: f32 sums
SPARSE_FRAMES = 32         # phase 31's frames a dtype
SPARSE_DENSITY = 0.05      # non-zeros a frame
SPARSE_CAPACITY = 0.1      # tensor_sparse_enc density=0.1


def _delta_motion_frames(n=None):
    """bench.py's 5 %-motion camera stream: a fixed sensor-noise frame
    (FRAME_DIMS: 224x224x3) with one random DELTA_PATCH x DELTA_PATCH
    region redrawn a frame (seed 7)."""
    n = DELTA_FRAMES if n is None else n
    side, patch = _frame_shape()[0], DELTA_PATCH
    rng = np.random.default_rng(7)
    cur = rng.integers(0, 255, (side, side, 3), np.uint8, endpoint=True)
    frames = [cur.copy()]
    for _ in range(n - 1):
        cur = cur.copy()
        y = int(rng.integers(0, side - patch))
        x = int(rng.integers(0, side - patch))
        cur[y:y + patch, x:x + patch] = rng.integers(
            0, 255, (patch, patch, 3), np.uint8, endpoint=True)
        frames.append(cur.copy())
    return frames


def _reset_device_ops():
    from nnstreamer_tpu_torch.ops import delta, sparse
    _reset_launches()
    sparse.reset_counts()
    delta.runs = 0


def _device_ops():
    """The kernels' launches and the card runs of the sparse and delta
    torch ops since the last reset."""
    from nnstreamer_tpu_torch.ops import delta, sparse
    return {**_kernel_launches(), "sparse_packs": sparse.packs,
            "sparse_unpacks": sparse.unpacks,
            "sparse_d2h_bytes": sparse.pack_d2h_bytes,
            "tile_error_runs": delta.runs}


def _delta_link_run(frames, codec, extra_sink="", extra_src=""):
    """appsrc ! edgesink wire-codec=<codec> -> loopback -> edgesrc ! tee:
    one leg the MobileNet-v2 filter (torch-cuda) ! appsink name=out, the
    other the frames as they arrived (appsink name=frames). Returns the
    delivered (pts, frame), (pts, logits), both ends' stats and wire
    blocks, the counts and frames/s."""
    import nnstreamer_tpu_torch as pt
    port = _free_port()
    pub = pt.parse_launch(
        f"appsrc name=in caps={_caps_at(FRAME_DIMS)} ! edgesink name=p "
        f"port={port} topic=t wire-codec={codec} wire-delta-k={DELTA_K} "
        f"{extra_sink}")
    sub = pt.parse_launch(
        f"edgesrc name=s dest-port={port} topic=t timeout=60 {extra_src}"
        "! tee name=t t. ! queue max-size-buffers=32 ! tensor_filter "
        "name=f framework=torch-cuda model=zoo://mobilenet_v2 "
        "! appsink name=out t. ! queue max-size-buffers=256 "
        "! appsink name=frames")
    ptr, st = pub.enable_tracing(), sub.enable_tracing()
    _reset_device_ops()
    pub.start()
    try:
        sub.start()
        deadline = time.monotonic() + 120
        while not pub["p"]._subs:
            if time.monotonic() > deadline:
                sys.exit("chip_smoke: delta link: no subscriber attached")
            time.sleep(0.01)
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            pub["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
        while len(sub["out"].buffers) < len(frames) \
                or len(sub["frames"].buffers) < len(frames):
            if time.monotonic() > deadline:
                break
            time.sleep(0.002)
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = _device_ops()
        ps, ss = pub["p"].stats.snapshot(), sub["s"].stats.snapshot()
        pw = ptr.report(pub)["p"].get("wire", {})
        sw = st.report(sub)["s"].get("wire", {})
        got = [(b.pts, b.chunks[0].host()) for b in sub["frames"].buffers]
        logits = [(b.pts, b.chunks[0].host()) for b in sub["out"].buffers]
        fault = sub["k"].stats.snapshot() if "k" in sub.elements else {}
    finally:
        pub["in"].end_stream()
        pub.wait_eos(60)
        pub.stop()
        sub.stop()
    return {"frames": got, "logits": logits, "ps": ps, "ss": ss,
            "pub_wire": pw, "sub_wire": sw, "counts": counts,
            "fault": fault, "fps": len(frames) / dt}


def phase_delta_link(smi):
    """Phase 29: the 5 %-motion stream over an edge link with
    wire-codec=raw, zlib and delta, each into MobileNet-v2 on the card;
    then a session delta link killed twice mid-stream."""
    from nnstreamer_tpu_torch.edge import wire
    frames = _delta_motion_frames()
    src = [(i, f.tobytes()) for i, f in enumerate(frames)]
    out, runs = {}, {}
    for codec in ("raw", "zlib", "delta"):
        r = runs[codec] = _delta_link_run(frames, codec)
        same = [(p, g.tobytes()) for p, g in r["frames"]] == src
        n = r["ps"]["wire_frames_out"]
        row = out[codec] = {
            "frames": len(r["frames"]), "bytes_per_frame":
            r["ps"]["wire_bytes_out"] / max(n, 1),
            "raw_bytes_per_frame": r["ps"]["wire_raw_bytes_out"] / max(n, 1),
            "fps": r["fps"], "byte_identical_source": same,
            "pub_wire": r["pub_wire"], "sub_wire": r["sub_wire"],
            "kernel_launches": r["counts"]}
        if codec != "raw":
            row["logits_bitwise_raw"] = [
                (p, g.tobytes()) for p, g in r["logits"]] == [
                (p, g.tobytes()) for p, g in runs["raw"]["logits"]]
        log(f"delta link {codec}: {row['frames']} of {DELTA_FRAMES} "
            f"frames, {row['bytes_per_frame']:.1f} wire bytes a frame "
            f"(raw {row['raw_bytes_per_frame']:.1f}), byte-identical to "
            f"the source {same}, logits bitwise equal to the raw link's "
            f"{row.get('logits_bitwise_raw', True)}, wire block "
            f"{r['pub_wire'].get('delta')} / {r['sub_wire'].get('delta_in')}"
            f", {r['fps']:.2f} fps, counts {r['counts']}; {smi}")
        if not same or not row.get("logits_bitwise_raw", True) \
                or len(r["logits"]) != DELTA_FRAMES:
            sys.exit(f"chip_smoke: delta link {codec}: {row}")
    d = out["delta"]["pub_wire"].get("delta", {})
    if not d.get("diffs") or out["delta"]["bytes_per_frame"] >= \
            out["zlib"]["bytes_per_frame"]:
        sys.exit(f"chip_smoke: the delta link shipped no diffs or no "
                 f"fewer bytes than zlib: {out['delta']}")
    # the session link killed twice: which connection decoded what
    decoded = []
    orig = wire._delta_decode

    def spy(tensors, payloads, key, epoch, cfg, codes=None):
        decoded.append((id(cfg), bool(key)))
        return orig(tensors, payloads, key, epoch, cfg, codes)

    wire._delta_decode = spy
    try:
        r = _delta_link_run(
            frames, "delta", "session=true coalesce-frames=4 "
            f"coalesce-ms=5 session-ring-kb={DELTA_RING_KB}",
            "session=true ack-every=4 ! tensor_fault "
            f"name=k mode=kill-link target=s every={DELTA_KILL_EVERY} "
            "max-faults=2 ")
    finally:
        wire._delta_decode = orig
    firsts = {}
    for link, key in decoded:
        firsts.setdefault(link, key)
    same = [(p, g.tobytes()) for p, g in r["frames"]] == src
    logits_same = [(p, g.tobytes()) for p, g in r["logits"]] == [
        (p, g.tobytes()) for p, g in runs["raw"]["logits"]]
    ss = r["ss"]
    out["killed"] = {
        "frames": len(r["frames"]), "kills": r["fault"].get("faults", 0),
        "links": len(firsts), "every_link_opens_with_keyframe":
        all(firsts.values()), "byte_identical_source": same,
        "logits_bitwise_raw": logits_same,
        "reconnects": ss["reconnects"], "link_errors": ss["link_errors"],
        "replayed": r["ps"]["session_replayed"],
        "dup_drops": ss["session_dup_drops"],
        "declared_lost": ss["session_declared_lost"],
        "sub_wire": r["sub_wire"], "fps": r["fps"],
        "kernel_launches": r["counts"]}
    k = out["killed"]
    log(f"delta link killed: {k['frames']} of {DELTA_FRAMES} frames once "
        f"and in order {same} across {k['kills']} kills, {k['links']} "
        f"connections each opening with a keyframe "
        f"{k['every_link_opens_with_keyframe']}, {k['replayed']} replayed, "
        f"{k['dup_drops']} duplicates dropped, {k['declared_lost']} "
        f"declared lost, link errors {k['link_errors']}, logits bitwise "
        f"{logits_same}; {smi}")
    if not (same and logits_same and k["kills"] == 2 and k["links"] == 3
            and k["every_link_opens_with_keyframe"]
            and k["link_errors"] == 2 and not k["declared_lost"]):
        sys.exit(f"chip_smoke: delta link killed: {k}")
    return out


def _gate_line(device, n):
    """appsrc ! tensor_delta mode=gate ! MobileNet-v2 ! appsink."""
    import nnstreamer_tpu_torch as pt
    pipe = pt.parse_launch(
        f"appsrc name=in caps={_caps_at(FRAME_DIMS)} ! tensor_delta name=d "
        f"mode=gate device={device} tile={DELTA_TILE} ! tensor_filter "
        "name=f framework=torch-cuda model=zoo://mobilenet_v2 "
        "! appsink name=out")
    return pipe


def phase_delta_gate(smi):
    """Phase 30: the motion stream, each frame held for two (a camera at
    twice its scene's rate), pushed as CUDA frames through tensor_delta
    mode=gate device=true and device=false into MobileNet-v2; tile_error
    on the card against numpy; then mode=roi through a query server and
    tensor_delta_stitch against the full-frame oracle."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.ops import delta
    motion = _delta_motion_frames(DELTA_FRAMES // 2)
    frames = [motion[i // 2] for i in range(DELTA_FRAMES)]
    dev = [torch.from_numpy(f).cuda() for f in frames]
    out, passed = {}, {}
    for device in ("true", "false"):
        pipe = _gate_line(device, len(dev))
        _reset_device_ops()
        pipe.start()
        try:
            t0 = time.perf_counter()
            _push_all(pipe, dev)
            pipe["in"].end_stream()
            pipe.wait_eos(300)
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = _device_ops()
            st = pipe["d"].stats.snapshot()
            invokes = pipe["f"]._invoke_count
            got = [b.pts for b in pipe["out"].buffers]
        finally:
            pipe.stop()
        passed[device] = got
        row = out[f"device_{device}"] = {
            "frames_in": len(dev), "skipped": st["delta_frames_skipped"],
            "tiles_total": st["delta_tiles_total"],
            "tiles_skipped": st["delta_tiles_skipped"],
            "keyframes": st["delta_keyframes"], "invokes": invokes,
            "delivered": len(got), "fps_in": len(dev) / dt,
            "kernel_launches": counts}
        log(f"delta gate device={device}: {len(dev)} frames in, "
            f"{row['skipped']} skipped, {invokes} invoked, {len(got)} "
            f"delivered, tiles {row['tiles_skipped']} of "
            f"{row['tiles_total']} skipped, {row['fps_in']:.2f} frames/s "
            f"in, counts {counts}; {smi}")
        if invokes != len(dev) - row["skipped"] or len(got) != invokes:
            sys.exit(f"chip_smoke: delta gate: {row}")
    if passed["true"] != passed["false"] \
            or out["device_true"]["kernel_launches"]["tile_error_runs"] \
            != DELTA_FRAMES - 1 \
            or out["device_false"]["kernel_launches"]["tile_error_runs"]:
        sys.exit(f"chip_smoke: device gating differs from host gating: "
                 f"{out}")
    # tile_error on the card against its numpy version on the same frames
    cur, ref = (f.astype(np.float32).mean(axis=2) for f in motion[1::-1])
    delta.runs = 0
    got = delta.tile_error(torch.from_numpy(cur).cuda(),
                           torch.from_numpy(ref).cuda(), DELTA_TILE)
    got = got.cpu().numpy()
    want = delta.tile_error_reference(cur, ref, DELTA_TILE)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    ms = time_ms(lambda: delta.tile_error(
        torch.from_numpy(cur).cuda(), torch.from_numpy(ref).cuda(),
        DELTA_TILE))
    out["tile_error"] = {"max_rel_err": rel, "rtol": TILE_RTOL, "ms": ms,
                         "changed_tiles": int((want > 0).sum())}
    log(f"tile_error on the card (224x224, tile {DELTA_TILE}): max "
        f"relative error {rel:.3g} against numpy (tol {TILE_RTOL}), "
        f"{out['tile_error']['changed_tiles']} changed tiles, {ms:.4f} ms "
        f"a call with its H2D copies; {smi}")
    if rel > TILE_RTOL:
        sys.exit(f"chip_smoke: tile_error: {out['tile_error']}")
    out["roi"] = _delta_roi(frames, smi)
    return out


def _delta_roi(frames, smi):
    """tensor_delta mode=roi ! tensor_query_client to a
    tensor_query_serversrc running a custom-easy scale, then
    tensor_delta_stitch: the stitched frames equal the scaled frames."""
    import nnstreamer_tpu_torch as pt
    crops = []
    pt.filters.register_custom_easy(
        "chip_roi_scale", lambda x: (crops.append(np.asarray(x).shape),
                                     x * np.uint8(3))[1])
    port = _free_port()
    server = pt.parse_launch(
        f"tensor_query_serversrc name=qs port={port} id={port} "
        "! tensor_filter framework=custom-easy model=chip_roi_scale "
        f"! tensor_query_serversink id={port}")
    server.start()
    client = pt.parse_launch(
        f"appsrc name=in caps={_caps_at(FRAME_DIMS)} ! tensor_delta name=d "
        f"mode=roi tile={DELTA_TILE} ! tensor_query_client name=qc "
        f"port={port} timeout=60 ! tensor_delta_stitch ! appsink name=out")
    _reset_device_ops()
    try:
        client.start()
        t0 = time.perf_counter()
        _push_all(client, [torch.from_numpy(f).cuda() for f in frames])
        client["in"].end_stream()
        client.wait_eos(300)
        dt = time.perf_counter() - t0
        counts = _device_ops()
        st = client["d"].stats.snapshot()
        got = {b.pts: b.chunks[0].host() for b in client["out"].buffers}
    finally:
        client.stop()
        server.stop()
    equal = all(g.tobytes() == (frames[p] * np.uint8(3)).tobytes()
                for p, g in got.items())
    rows = sum(s[0] for s in crops if len(s) == 4)
    row = {"frames_in": len(frames), "delivered": len(got),
           "skipped": st["delta_frames_skipped"], "crops_inferred": rows,
           "full_frames_inferred": sum(1 for s in crops if len(s) == 3),
           "tiles_total": st["delta_tiles_total"],
           "equal_full_frame_oracle": equal, "fps_in": len(frames) / dt,
           "kernel_launches": counts}
    log(f"delta roi through the query link: {len(got)} frames stitched "
        f"({row['skipped']} skipped), {rows} crops and "
        f"{row['full_frames_inferred']} full frames inferred against "
        f"{len(frames)} frames of {DELTA_TILE}x{DELTA_TILE} tiles "
        f"({row['tiles_total']} tiles seen), every output "
        f"{'equal' if equal else 'NOT EQUAL'} to the full-frame oracle; "
        f"{smi}")
    if not equal or len(got) != len(frames) - row["skipped"]:
        sys.exit(f"chip_smoke: delta roi: {row}")
    return row


def _sparse_frames(dtype, n):
    """Seeded frames on the card with SPARSE_DENSITY of their elements
    non-zero (no -0.0: a decoded zero is +0.0)."""
    gen = torch.Generator().manual_seed(SEED)
    shape = (n,) + _frame_shape()
    vals = torch.randn(shape, generator=gen) + 4.0
    keep = torch.rand(shape, generator=gen) < SPARSE_DENSITY
    x = torch.where(keep, vals, torch.zeros_like(vals)).to(dtype)
    return [f.cuda() for f in x]


def phase_sparse(smi):
    """Phase 31: card frames at 5 % non-zeros through tensor_sparse_enc
    density=0.1 ! tensor_sparse_dec device=true ! appsink, f32 and bf16:
    a bitwise round trip, every frame packed and unpacked on the card,
    and the bytes that crossed to the host against the dense frame."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.ops import sparse
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        frames = _sparse_frames(dtype, SPARSE_FRAMES)
        size = frames[0].numel()
        cap = max(1, min(size, int(np.ceil(size * SPARSE_CAPACITY))))
        nnz = [int(torch.count_nonzero(f)) for f in frames]
        caps = _caps_at(FRAME_DIMS).replace(
            "uint8", "float32" if name == "f32" else "bfloat16")
        pipe = pt.parse_launch(
            f"appsrc name=in caps={caps} ! tensor_sparse_enc "
            f"density={SPARSE_CAPACITY} ! tensor_sparse_dec device=true "
            "! appsink name=out")
        _reset_device_ops()
        pipe.start()
        try:
            t0 = time.perf_counter()
            _push_all(pipe, frames)
            pipe["in"].end_stream()
            pipe.wait_eos(300)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = _device_ops()
            got = [b.chunks[0].raw for b in pipe["out"].buffers]
        finally:
            pipe.stop()
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        equal = len(got) == len(frames) and all(
            g.is_cuda and torch.equal(g.view(bits), f.view(bits))
            for g, f in zip(got, frames))
        dense = size * frames[0].element_size()
        row = out[name] = {
            "frames": len(got), "nnz_min": min(nnz), "nnz_max": max(nnz),
            "capacity": cap, "packs": counts["sparse_packs"],
            "unpacks": counts["sparse_unpacks"],
            "d2h_bytes_per_frame": counts["sparse_d2h_bytes"] / len(frames),
            "dense_bytes_per_frame": dense, "bitwise_round_trip": equal,
            "frames_per_s": len(frames) / dt, "kernel_launches": counts}
        log(f"sparse {name}: {len(got)} card frames, nnz {min(nnz)}-"
            f"{max(nnz)} (capacity {cap}), {row['packs']} packs and "
            f"{row['unpacks']} unpacks on the card, "
            f"{row['d2h_bytes_per_frame']:.0f} bytes a frame to the host "
            f"against {dense} dense, round trip "
            f"{'bitwise' if equal else 'NOT EQUAL'}, "
            f"{row['frames_per_s']:.2f} frames/s; {smi}")
        if not equal or max(nnz) > cap or row["packs"] != len(frames) \
                or row["unpacks"] != len(frames):
            sys.exit(f"chip_smoke: sparse {name}: {row}")
    return out


def phase_native_queue(smi, clean, build_s):
    """The headline line with queue backend=native against
    backend=python in the same call, in turns (python, native, native,
    python), after `make native` (``build_s`` seconds, on phase 2's
    worker): logits bitwise equal to the clean run's, fps and p50."""
    n = MOBILENET_WARMUP + MOBILENET_FRAMES
    # phase 19's clean run covers the first FAULT_FRAMES frames; the rest
    # are held against the first python run
    want = _headline_logits(clean, FAULT_FRAMES)
    out = {"build_s": build_s}
    for i, backend in enumerate(("python", "native", "native", "python")):
        line = _headline_line(n).replace(
            "queue max-size-buffers", f"queue backend={backend} "
            "max-size-buffers")
        pipe, row = _run_line(f"queue backend={backend} ({i + 1} of 4)",
                              line, MOBILENET_WARMUP, MOBILENET_FRAMES, smi)
        kinds = {type(e._q).__name__ for name, e in pipe.elements.items()
                 if name.startswith("queue")}
        got = [b.chunks[0].host() for b in pipe["out"].buffers]
        if i == 0:
            want = want + got[len(want):]
        row["bitwise_clean"] = len(got) == n and all(
            g.tobytes() == w.tobytes() for g, w in zip(got, want))
        row["queues"] = sorted(kinds)
        out[f"{backend}_{1 + (i in (2, 3))}"] = row
        if not row["bitwise_clean"] or kinds != (
                {"_NativeQueueAdapter"} if backend == "native"
                else {"Queue"}):
            sys.exit(f"chip_smoke: queue backend={backend}: {row}")
    return out


LLM_LARGE = "zoo://gpt?vocab=32000&d_model=1536&n_heads=16&n_layers=24"
LLM_STREAMS = 8            # bench.py:2148: 8 prompts, 8 streams,
LLM_TOKENS = 48            # 48 tokens each,
LLM_MAX_LEN = 128          # max_len 128,
LLM_CHUNK = 32             # chunk 32
LLM_PIPE_TOKENS = 16       # phase 32's pipeline line: 2 prompts x 16
LLM_PARITY_TOKENS = 16     # phase 33's sampled and prefix-cache runs
LLM_BLOCK = 16
LLM_POOL_BLOCKS = 64       # 8 streams x ceil((7 + 48) / 16) = 32 needed
LLM_PREFIX_BLOCKS = 96     # 8 x ceil((64 + 16) / 16) = 40 needed
# phase 33: one prompt's prefill logits, bf16 on the card against the
# same weights in f32 on the CPU, as a share of the largest |logit|.
# bf16 keeps 8 significant bits: each of 24 layers rounds its norms,
# products and residual adds, so the logits drift by a few ulps of the
# largest. An H100 80GB HBM3 at 700 W read 1.324e-02 (64 tokens) and
# 1.348e-02 (16 tokens); 2**-5 (3.1e-02) is 2.3 times that, and fails
# a wrong layout, a wrong rope, a stale cache row or a bf16 split-K
# reduction in every layer, which move logits by more
LLM_F32_REL_TOL = 2.0 ** -5


def _llm(custom):
    """An opened llm filter at LLM_LARGE on the card, and its open time
    (the 1.0 B-parameter init on the card's generator)."""
    from nnstreamer_tpu_torch.filters import FilterProperties, find_filter
    t0 = time.perf_counter()
    fw = find_filter("llm")()
    fw.open(FilterProperties(model_files=(LLM_LARGE,),
                             custom_properties=custom))
    torch.cuda.synchronize()
    return fw, time.perf_counter() - t0


def _llm_prompts():
    """bench.py:1595's prompts for bench_llm_decode."""
    return [np.arange(1 + (i % 7), dtype=np.int32) + i
            for i in range(LLM_STREAMS)]


def _llm_disagg_prompts(n, plen, shared):
    """bench.py:1617: n prompts of plen tokens sharing the first
    ``shared``."""
    base = (np.arange(plen, dtype=np.int32) % 500) + 1
    out = []
    for i in range(n):
        p = base.copy()
        p[shared:] = ((np.arange(plen - shared) * 7 + i * 31) % 500) + 1
        out.append(p)
    return out


def _llm_collect(fw, prompts, per_stream, what, timeout=300):
    """invoke_async every prompt; -> (tokens a prompt, t_submit,
    t_first_token, t_last_token)."""
    import threading
    got, stamps = {}, []
    lock, done = threading.Lock(), threading.Event()
    want = len(prompts) * per_stream

    def dispatch(outs, ctx):
        with lock:
            stamps.append(time.perf_counter())
            got.setdefault(ctx, []).append(
                int(np.asarray(outs[0]).ravel()[0]))
            if len(stamps) == want:
                done.set()

    fw.set_async_dispatcher(dispatch)
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        fw.invoke_async([p], ctx=i)
    if not done.wait(timeout):
        sys.exit(f"chip_smoke: {what}: {len(stamps)} of {want} tokens")
    return [got[i] for i in range(len(prompts))], t0, stamps[0], stamps[-1]


def llm_bound(fw, streams, max_len):
    """(weight bytes a decode step reads, KV bytes, bound ms): every
    weight but the embedding table (a step gathers M rows of it) and the
    whole [streams, max_len] cache, once each, at HBM_BYTES_S."""
    weights = sum(p.numel() * p.element_size()
                  for name, p in fw._params.named_parameters()
                  if name != "embed")
    cfg = fw._cfg
    kv = 2 * cfg.n_layers * streams * max_len * cfg.n_heads * \
        cfg.head_dim * torch.finfo(cfg.dtype).bits // 8
    return weights, kv, (weights + kv) / HBM_BYTES_S * 1e3


def _host_calls(parts):
    """Host CUDA calls each ``(label, fn)`` of ``parts`` makes, on every
    thread, in one torch.profiler session: graph launches, kernel
    launches and copies."""
    names = {"cudaGraphLaunch": "graph_launches",
             "cudaLaunchKernel": "kernel_launches",
             "cudaLaunchKernelExC": "kernel_launches",
             "cuLaunchKernel": "kernel_launches",
             "cuLaunchKernelEx": "kernel_launches",
             "cudaMemcpyAsync": "memcpy", "cudaMemcpy": "memcpy"}
    counts = _trace_counts(parts, names)
    return {label: {k: c.get(k, 0) for k in (
        "graph_launches", "kernel_launches", "memcpy")}
        for label, c in counts.items()}


def _event_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_llm_decode(smi):
    """Phase 32: bench.py:2148's generative line at LLM_LARGE's full
    width through find_filter("llm") and invoke_async (8 prompts, 8
    streams, 48 tokens, max_len 128, chunk 32), after bench's one-prompt
    warm-up: tokens/s and decode steps/s from submit to last token, time
    to first token, prefill rows, graph captures, the decode step's
    device time (the 32-step chunk graph replayed alone, CUDA events)
    against its bound, D2H copies a chunk, open time, memory_allocated();
    host calls of each kind of chunk the run takes (a 32-step chunk and
    a 16-step tail); then the same model in a pipeline with two prompts
    in flight, each token buffer carrying its own prompt's pts."""
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.filters import llm as L
    from nnstreamer_tpu_torch.tensors.transfer import fetch_stats
    out = {}
    t_phase = time.perf_counter()
    _reset_launches()
    mem0 = _allocated()
    custom = (f"max_tokens:{LLM_TOKENS},n_parallel:{LLM_STREAMS},"
              f"max_len:{LLM_MAX_LEN},chunk:{LLM_CHUNK}")
    fw, open_s = _llm(custom)
    mem_open = _allocated()
    weights, kv, bound_ms = llm_bound(fw, LLM_STREAMS, LLM_MAX_LEN)
    t0 = time.perf_counter()
    _llm_collect(fw, [np.arange(8, dtype=np.int32)], LLM_TOKENS, "warm-up")
    warm_s = time.perf_counter() - t0
    captures_warm = fw.compile_count
    s0 = fw.stats.snapshot()
    fetch_stats(reset=True)
    toks, t0, t_first, t_last = _llm_collect(fw, _llm_prompts(), LLM_TOKENS,
                                             "llm decode")
    fetched = fetch_stats()
    s1 = fw.stats.snapshot()
    steps = s1["decode_steps"] - s0["decode_steps"]
    chunks = s1["decode_dispatches"] - s0["decode_dispatches"]
    wall = t_last - t0
    n_tok = LLM_STREAMS * LLM_TOKENS
    be = fw._backend
    graph = be._graphs["chunk"]
    step_ms = _event_ms(graph.replay, 3) / LLM_CHUNK
    tail = LLM_TOKENS % LLM_CHUNK
    on = np.ones(be.m, bool)
    t_prof = time.perf_counter()
    calls = _host_calls(
        [(f"chunk{k}", lambda k=k: L._host(be.chunk(k, 0.0, on)))
         for k in (LLM_CHUNK, tail)])
    prof_s = time.perf_counter() - t_prof
    flat = [t for row in toks for t in row]
    row = out["decode"] = {
        "streams": LLM_STREAMS, "tokens": n_tok,
        "tokens_per_s": n_tok / wall, "steps_per_s": steps / wall,
        "bound_ms": bound_ms, "bound_steps_per_s": 1e3 / bound_ms,
        "share_of_bound": steps / wall * bound_ms / 1e3,
        "ttft_ms": (t_first - t0) * 1e3,
        "first_to_last_ms": (t_last - t_first) * 1e3,
        "step_ms_device": step_ms,
        "device_share_of_bound": bound_ms / step_ms,
        "decode_steps": steps, "chunks": chunks,
        "d2h_per_chunk": fetched["arrays"] / max(1, chunks),
        "host_calls": calls, "host_calls_s": prof_s,
        "prefill_rows": s1["prefill_rows"] - s0["prefill_rows"],
        "graph_captures": fw.compile_count,
        "captures_at_warmup": captures_warm, "warmup_s": warm_s,
        "open_s": open_s, "weights_bytes": weights, "kv_bytes": kv,
        "allocated_open_mib": (mem_open - mem0) / 2**20,
        "allocated_run_mib": (_allocated() - mem0) / 2**20,
        "prefill_dispatches": s1["prefill_dispatches"]
        - s0["prefill_dispatches"]}
    fw.close()
    log(f"llm decode (LLM_LARGE, {LLM_STREAMS} prompts x {LLM_TOKENS} "
        f"tokens, chunk {LLM_CHUNK}): {row['tokens_per_s']:.1f} tokens/s, "
        f"{row['steps_per_s']:.2f} steps/s from submit to last token "
        f"({row['share_of_bound']:.4f} of the {bound_ms:.4f} ms bound's "
        f"{1e3 / bound_ms:.1f} steps/s), time to first token "
        f"{row['ttft_ms']:.2f} ms, decode step {step_ms:.4f} ms on the "
        f"device ({row['device_share_of_bound']:.4f} of bound), "
        f"{row['prefill_rows']} prefill rows for {LLM_STREAMS} prompts "
        f"of 1-7 tokens, {row['graph_captures']} graph captures, "
        f"{chunks} chunks, host calls of a {LLM_CHUNK}-step chunk "
        f"{calls[f'chunk{LLM_CHUNK}']} and of a {tail}-step tail "
        f"{calls[f'chunk{tail}']}, "
        f"{row['d2h_per_chunk']:.2f} D2H copies a chunk, "
        f"warm-up {warm_s:.2f} s with {captures_warm} captures, open "
        f"{open_s:.2f} s, memory_allocated() +"
        f"{row['allocated_open_mib']:.1f} MiB at open, "
        f"+{row['allocated_run_mib']:.1f} MiB after the run; {smi}")
    if not all(0 <= t < 32000 for t in flat) or chunks < 2 \
            or row["d2h_per_chunk"] != 1:
        sys.exit(f"chip_smoke: llm decode: {row}")
    row["kernel_launches"] = _kernel_launches()
    # the pipeline: appsrc ! tensor_filter invoke-async ! appsink
    _reset_launches()
    caps = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)int32,dimensions=(string)8")
    line = (f'appsrc name=in caps="{caps}" ! tensor_filter name=f '
            f'framework=llm model="{LLM_LARGE}" invoke-async=true '
            'invoke-dynamic=true custom="max_tokens:'
            f'{LLM_PIPE_TOKENS},n_parallel:2,max_len:{LLM_MAX_LEN}" '
            '! appsink name=out')
    pipe = pt.parse_launch(line)
    pipe.start()
    try:
        t0 = time.perf_counter()
        for i, pts in enumerate((1000, 2000)):
            pipe["in"].push_buffer(pt.Buffer.from_arrays(
                [np.arange(8, dtype=np.int32) + 100 * i], pts=pts))
        _wait_frames(pipe, 2 * LLM_PIPE_TOKENS, "llm pipeline")
        dt = time.perf_counter() - t0
        captures = pipe["f"].fw.compile_count
    finally:
        pipe.stop()
    by_pts = {}
    for b in pipe["out"].buffers:
        by_pts.setdefault(b.pts, []).append(int(b.chunks[0].host()[0]))
    prow = out["pipeline"] = {
        "buffers": len(pipe["out"].buffers),
        "tokens_by_pts": {k: len(v) for k, v in by_pts.items()},
        "tokens_per_s": 2 * LLM_PIPE_TOKENS / dt,
        "graph_captures": captures, "kernel_launches": _kernel_launches(),
        "phase_s": time.perf_counter() - t_phase}
    log(f"llm pipeline (appsrc ! tensor_filter framework=llm invoke-async "
        f"! appsink, 2 prompts in flight): {prow['buffers']} token "
        f"buffers, by pts {prow['tokens_by_pts']}, "
        f"{prow['tokens_per_s']:.1f} tokens/s with the captures, "
        f"{captures} graph captures; phase 32 {prow['phase_s']:.1f} s; "
        f"{smi}")
    if sorted(by_pts) != [1000, 2000] or any(
            len(v) != LLM_PIPE_TOKENS for v in by_pts.values()):
        sys.exit(f"chip_smoke: llm pipeline: {prow}")
    return out, toks


def _llm_graph_equals_eager(fw):
    """One decode step of the per-token backend: its graph's replay
    against decode_step_multi run eagerly on a copy of the same state,
    bitwise. All lanes active, at the positions the run left."""
    from nnstreamer_tpu_torch.models import transformer as tfm
    be = fw._backend
    with torch.no_grad():
        be.active.fill_(True)
        cache = {k: v.clone() for k, v in be.cache.items()}
        eager, _ = tfm.decode_step_multi(fw._params, cache, be.tok.clone(),
                                         be.active.clone(), fw._cfg)
        be._graphs["step"].replay()
        torch.cuda.synchronize()
        return torch.equal(eager, be.logits) and \
            torch.equal(cache["k"], be.cache["k"])


def _llm_f32_gap(fw, prompt):
    """One prompt's prefill logits on the card (bf16) against the same
    weights, copied back, in f32 on the CPU (forward over the prompt):
    max |difference| as a share of the largest |logit|."""
    import dataclasses
    from nnstreamer_tpu_torch.models import transformer as tfm
    card = fw._prefill_prompt(prompt, LLM_MAX_LEN)[0][0].float().cpu()
    cfg = dataclasses.replace(fw._cfg, dtype=torch.float32)
    cpu = tfm.GPT(cfg, device="meta")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in fw._params.state_dict().items()},
                        assign=True)
    with torch.no_grad():
        want = tfm.forward(cpu, torch.from_numpy(prompt[None]).long(),
                           cfg)[0, -1]
    return float((card - want).abs().max() / want.abs().max())


def phase_llm_parity(smi, ref):
    """Phase 33, at LLM_LARGE on the card: chunk 1 against phase 32's
    chunk 32 (greedy, 8 x 48 tokens); a graph replay's decode logits
    against an eager step's, bitwise; paged (block 16, an explicit
    pool_blocks budget) against contiguous, greedy (48 tokens) and at
    temperature 0.7, seed 11, top_k 8 (16 tokens); the prefix cache on
    against off on bench.py's disagg prompts (8 x 64 tokens, 57 shared),
    with hits and fewer computed prompt tokens; one prompt's prefill
    logits against f32 on the CPU. Every mismatch fails the run. Past the
    chunk-32 check every run decodes a token a step, so it captures only
    the step and the prefill, not a multi-step chunk graph (the chunk
    captures are most of phase 32's warm-up)."""
    out = {}
    t0 = time.perf_counter()
    _reset_launches()
    prompts = _llm_prompts()
    base = (f"max_tokens:{LLM_TOKENS},n_parallel:{LLM_STREAMS},"
            f"max_len:{LLM_MAX_LEN},chunk:{LLM_CHUNK}")
    paged = (f",paged:true,block_size:{LLM_BLOCK},"
             f"pool_blocks:{LLM_POOL_BLOCKS}")
    checks = {}

    def run(custom, plist, n, what, keep=False):
        fw, _ = _llm(custom)
        toks = _llm_collect(fw, plist, n, what)[0]
        stats = dict(fw.stats.snapshot())
        if fw._pool_mgr is not None:
            stats.update(fw._pool_mgr.stats_dict())
        stats["graph_captures"] = fw.compile_count
        if keep:
            return toks, stats, fw
        fw.close()
        return toks, stats

    per_token = base.replace(f"chunk:{LLM_CHUNK}", "chunk:1")
    toks, stats, fw = run(per_token, prompts, LLM_TOKENS, "per-token",
                          keep=True)
    checks["chunk1_equals_chunk32"] = toks == ref
    checks["graph_equals_eager"] = _llm_graph_equals_eager(fw)
    fw.close()
    paged_toks, _ = run(per_token + paged, prompts, LLM_TOKENS,
                        "paged greedy")
    checks["paged_greedy"] = paged_toks == toks
    samp = (f"max_tokens:{LLM_PARITY_TOKENS},n_parallel:{LLM_STREAMS},"
            f"max_len:{LLM_MAX_LEN},temperature:0.7,seed:11,top_k:8")
    a, _ = run(samp, prompts, LLM_PARITY_TOKENS, "sampled")
    b, _ = run(samp + paged, prompts, LLM_PARITY_TOKENS, "sampled paged")
    checks["paged_sampled"] = a == b
    checks["sampled_differs_from_greedy"] = a != [r[:LLM_PARITY_TOKENS]
                                                  for r in ref]
    disagg = _llm_disagg_prompts(8, 64, 57)
    pre = (f"max_tokens:{LLM_PARITY_TOKENS},n_parallel:{LLM_STREAMS},"
           f"max_len:{LLM_MAX_LEN},paged:true,block_size:{LLM_BLOCK},"
           f"pool_blocks:{LLM_PREFIX_BLOCKS}")
    off, off_stats, fw = run(pre + ",prefix_cache:false", disagg,
                             LLM_PARITY_TOKENS, "prefix off", keep=True)
    gap = _llm_f32_gap(fw, disagg[0][:16])
    fw.close()
    on, on_stats = run(pre + ",prefix_cache:true", disagg,
                       LLM_PARITY_TOKENS, "prefix on")
    admitted = sum(p.size for p in disagg)
    checks["prefix_cache_exact"] = on == off
    checks["prefix_hits"] = on_stats["prefix_hits"] > 0
    checks["prefix_saves_prefill"] = \
        on_stats["prefill_computed_tokens"] < admitted and \
        on_stats["prefill_rows"] < off_stats["prefill_rows"]
    checks["f32_gap"] = gap <= LLM_F32_REL_TOL
    row = out["parity"] = {
        "checks": checks, "f32_gap_rel": gap,
        "f32_tol_rel": LLM_F32_REL_TOL,
        "prefix_on": {k: on_stats[k] for k in (
            "prefix_hits", "prefix_misses", "prefill_computed_tokens",
            "prefill_cached_tokens", "prefill_dispatches",
            "prefill_rows")},
        "prefix_off_computed": off_stats["prefill_computed_tokens"],
        "prefix_off_rows": off_stats["prefill_rows"],
        "admitted_prompt_tokens": admitted, "s": time.perf_counter() - t0,
        "kernel_launches": _kernel_launches()}
    log(f"llm parity (LLM_LARGE): {checks}; prefix cache on: "
        f"{row['prefix_on']} of {admitted} admitted prompt tokens (off: "
        f"{row['prefix_off_computed']} computed in "
        f"{row['prefix_off_rows']} rows); a 16-token prompt's "
        f"prefill logits against f32 on the CPU {gap:.3e} of the largest "
        f"(tolerance {LLM_F32_REL_TOL}); {row['s']:.1f} s; {smi}")
    if not all(checks.values()):
        sys.exit(f"chip_smoke: llm parity: {row}")
    return out


def phase_llm_single_shot(smi):
    """Phase 34: SingleShot(LLM_LARGE, framework=llamacpp) on the card:
    the tokens of invoke_async with set_async_callback equal a sync
    invoke's."""
    import threading
    import nnstreamer_tpu_torch as pt
    _reset_launches()
    prompt = np.arange(5, dtype=np.int32) + 7
    shot = pt.SingleShot(LLM_LARGE, framework="llamacpp",
                         custom=f"max_tokens:{LLM_PARITY_TOKENS}")
    try:
        t0 = time.perf_counter()
        (want,) = shot.invoke([prompt])
        sync_s = time.perf_counter() - t0
        got, done = [], threading.Event()

        def cb(outs):
            got.append(int(np.asarray(outs[0]).ravel()[0]))
            if len(got) == LLM_PARITY_TOKENS:
                done.set()

        shot.set_async_callback(cb)
        t0 = time.perf_counter()
        shot.invoke_async([prompt])
        if not done.wait(300):
            sys.exit(f"chip_smoke: llm single shot: {len(got)} tokens")
        async_s = time.perf_counter() - t0
        captures = shot.fw.compile_count
    finally:
        shot.stop()
    row = {"equal": got == want.tolist(), "tokens": len(got),
           "sync_s": sync_s, "async_s": async_s, "graph_captures": captures,
           "kernel_launches": _kernel_launches()}
    log(f"llm single shot (framework=llamacpp): invoke_async "
        f"{'equals' if row['equal'] else 'DIFFERS FROM'} the sync invoke "
        f"over {len(got)} tokens, sync {sync_s:.3f} s (with the captures), "
        f"async {async_s:.3f} s, {captures} graph captures; {smi}")
    if not row["equal"]:
        sys.exit(f"chip_smoke: llm single shot: {row}")
    return {"single_shot": row}


SERVE_CLIENTS = 8          # bench.py:488 bench_serve_row: 8 clients,
SERVE_WINDOW = 16          # max-request 16 each,
SERVE_WARMUP = 8           # 8 warm-up frames and
SERVE_FRAMES = 80          # 80 timed frames a client,
SERVE_BUCKETS = "1,2,4,8"  # buckets 1,2,4,8, max-wait-ms 4, max-queue 64
DRAIN_CLIENTS = 4          # phase 37's drain: 4 clients x 16 frames, all
DRAIN_FRAMES = 16          # on the wire (max-request 16) before the drain
ROUTER_CLIENTS = 4         # phase 37's fleet: 4 clients x 32 frames over
ROUTER_FRAMES = 32         # two replicas behind one router
# A served row against its frame's logits from the batch-1 line on the
# same card: the MobileNet rule of phase 22 (FANOUT_REL_TOL: a bucket runs
# other cuDNN convolution blockings than one frame), and for ViT phase
# 4's bf16 rule (5e-2 + 5 % of the largest |logit|): cuBLAS may pick
# other GEMM algorithms for 8 x 196 rows than for 196, and the bf16
# roundings add up over 12 blocks.


def _serve_server(port, model, name="s", extra=""):
    """bench_serve_row's server: tensor_serve_src (buckets 1,2,4,8) !
    tensor_filter prefetch-host=true ! queue 32 ! tensor_serve_sink;
    elements ``<name>src``, ``<name>f``, ``<name>k``."""
    import nnstreamer_tpu_torch as pt
    server = pt.parse_launch(
        f"tensor_serve_src name={name}src port={port} id={port} "
        f"buckets={SERVE_BUCKETS} max-wait-ms=4 max-queue=64 "
        f"! tensor_filter name={name}f framework=torch-cuda "
        f'model="{model}" prefetch-host=true {extra}'
        f"! queue max-size-buffers=32 ! tensor_serve_sink name={name}k "
        f"id={port}")
    server.start()
    return server


def _fanout(port, frames, n_clients, warmup, n_frames, window,
            during=None):
    """``n_clients`` clients, each sending ``warmup + n_frames`` of the
    distinct ``frames`` (client c's frame i is (4c + i) mod len) at once
    through a max-request ``window``; ``during(n)``, if given, runs once
    when ``n`` replies have arrived in all. Returns (aggregate fps after
    every client's warm-up, per-client results, the client pipelines'
    query-client stats)."""
    import threading
    n_each = warmup + n_frames
    n_warm, n_all = warmup * n_clients, n_each * n_clients
    lock = threading.Lock()
    total = {"n": 0, "t0": None, "t1": None}
    done, hook = threading.Event(), threading.Event()

    def on_reply():
        with lock:
            total["n"] += 1
            if total["n"] == n_warm:
                total["t0"] = time.perf_counter()
            if total["n"] == n_all:
                total["t1"] = time.perf_counter()
                done.set()
            if during is not None and total["n"] == during[0]:
                hook.set()

    clients, results = [], []
    try:
        for c in range(n_clients):
            order = [(c * 4 + i) % len(frames) for i in range(n_each)]
            res = {"order": order, "replies": [], "sent": {},
                   "arrived": {}}
            results.append(res)
            clients.append(_query_client(port, frames, order,
                                         res["replies"], res["sent"],
                                         res["arrived"], on_reply,
                                         window=window))
        if during is not None:
            if not hook.wait(300):
                sys.exit(f"chip_smoke: {total['n']} replies before the "
                         "mid-stream action")
            during[1]()
        else:
            if not done.wait(600):
                sys.exit(f"chip_smoke: {total['n']} of {n_all} replies "
                         "arrived")
        for client in clients:
            client.wait_eos(300)
        stats = [client["qc"].stats.snapshot() for client in clients]
    finally:
        for client in clients:
            client.stop()
    fps = ((n_all - n_warm) / (total["t1"] - total["t0"])
           if total["t1"] is not None and total["t0"] is not None else None)
    return fps, results, stats


def _replies_vs(results, want, in_order=True):
    """Every client's replies: each frame once (in order where the path
    keeps it), and the largest |diff| and |diff| / max |want| against
    the batch-1 logits of the frame each reply answers; returns (worst
    abs, worst rel, top-1 equal, replies)."""
    worst, worst_rel, top1, n = 0.0, 0.0, 0, 0
    for c, res in enumerate(results):
        pts = [p for p, _ in res["replies"]]
        ok = (pts == list(range(len(res["order"]))) if in_order
              else len(set(pts)) == len(pts))
        if not ok:
            sys.exit(f"chip_smoke: client {c}: replies {pts[:12]}... not "
                     "each frame once")
        for i, got in res["replies"]:
            ref = want[res["order"][i]]
            diff, rel = _max_diff(got, ref)
            worst, worst_rel = max(worst, diff), max(worst_rel, rel)
            top1 += int(int(np.argmax(got)) == int(np.argmax(ref)))
            n += 1
    return worst, worst_rel, top1, n


def _sink_chunks(server, sink):
    """Count what the serve sink is handed: PendingHost chunks (the
    filter's prefetch already in flight) or anything else."""
    from nnstreamer_tpu_torch.tensors.transfer import PendingHost
    seen = {"pending": 0, "other": 0}
    render = server[sink].render

    def counted(buf):
        for c in buf.chunks:
            seen["pending" if isinstance(c._data, PendingHost)
                 else "other"] += 1
        render(buf)

    server[sink].render = counted
    return seen


def _serve_line_run(name, model, frames, want, tol, smi, vit=False):
    """One bench_serve_row run of the serve line over ``model``: 8
    clients x (8 + 80) frames; returns its row after every check. ``tol``
    bounds a reply's distance to its frame's batch-1 logits: relative
    for MobileNet, absolute for ViT (``vit``, which also counts 12
    attention launches a batch)."""
    from nnstreamer_tpu_torch.tensors.transfer import fetch_stats
    port = _free_port()
    _reset_launches()
    fetch_stats(reset=True)
    server = _serve_server(port, model)
    at_sink = _sink_chunks(server, "sk")
    try:
        fps, results, stats = _fanout(port, frames, SERVE_CLIENTS,
                                      SERVE_WARMUP, SERVE_FRAMES,
                                      SERVE_WINDOW)
        fw = server["sf"].fw
        compiles, sigs = fw.compile_count, len(fw._executables)
        rep = server["ssrc"].scheduler.report()
        invokes = server["sf"].stats["buffers"]
    finally:
        server.stop()
    fetch = fetch_stats(reset=True)
    launches = _kernel_launches()
    worst, worst_rel, top1, n = _replies_vs(results, want)
    # MobileNet: relative to each frame's largest |logit|; ViT: absolute
    within = worst <= tol if vit else worst_rel <= tol
    shed = rep["shed_admission"] + rep["shed_deadline"]
    row = {"clients": SERVE_CLIENTS, "window": SERVE_WINDOW,
           "frames_per_client": SERVE_WARMUP + SERVE_FRAMES,
           "measured": SERVE_FRAMES * SERVE_CLIENTS, "fps": fps,
           "batches": rep["batches"], "invokes": invokes,
           "rows_per_batch": rep["completed"] / rep["batches"],
           "occupancy_avg": rep["occupancy_avg"],
           "queue_delay_us": rep["queue_delay_us"],
           "batch_latency_us": rep["batch_latency_us"],
           "shed_admission": rep["shed_admission"],
           "shed_deadline": rep["shed_deadline"],
           "compile_count": compiles, "signatures": sigs, "fetch": fetch,
           "d2h_arrays_per_batch": fetch["arrays"] / rep["batches"],
           "sink_chunks": at_sink, "max_abs_diff": worst,
           "max_rel_diff": worst_rel, "tol": tol, "top1_equal": top1,
           "replies": n, "kernel_launches": launches,
           "link_errors": sum(s.get("link_errors", 0) for s in stats)}
    log(f"{name}: {SERVE_CLIENTS} clients x "
        f"{SERVE_WARMUP + SERVE_FRAMES} frames ({SERVE_FRAMES} measured "
        f"after {SERVE_WARMUP}), buckets {SERVE_BUCKETS}: aggregate "
        f"{fps:.2f} fps; {rep['batches']} batches, "
        f"{row['rows_per_batch']:.2f} rows a batch, occupancy "
        f"{rep['occupancy_avg']:.3f}, queue delay p50 "
        f"{rep['queue_delay_us']['p50']:.1f} / p95 "
        f"{rep['queue_delay_us']['p95']:.1f} us, shed "
        f"{rep['shed_admission']} + {rep['shed_deadline']}; "
        f"compile_count {compiles}; D2H {fetch['arrays']} arrays in "
        f"{fetch['rpcs']} fetch RPCs = {row['d2h_arrays_per_batch']:.2f} a "
        f"batch ({fetch['frames_per_rpc_avg']:.2f} batches an RPC); sink "
        f"chunks {at_sink}; every reply once and in order; vs the batch-1 "
        f"line max |diff| {worst:.4g}, relative {worst_rel:.3g} (tol "
        f"{tol:.3g} {'absolute' if vit else 'relative'}), top-1 equal "
        f"{top1}/{n}; kernel launches "
        f"{launches}; {smi}")
    bad = (compiles > 4 or sigs != compiles or shed or not within
           or at_sink["other"] or fetch["arrays"] != rep["batches"]
           or rep["completed"] != n or invokes != rep["batches"])
    if vit:
        bad = bad or launches["attention"] != VIT_LAYERS * rep["batches"]
    if bad:
        sys.exit(f"chip_smoke: {name}: {row}")
    return row


def phase_serve_mobilenet(smi, clean):
    """Phase 35: bench_serve_row (bench.py:562) with the port's framework:
    8 clients through tensor_serve_src into the full-width MobileNet-v2;
    then its comparator, the same clients against the per-request
    tensor_query_serversrc (one invoke a frame). Returns both rows."""
    frames = _frames(QUERY_DISTINCT, _frame_shape()).numpy()
    want = _headline_logits(clean, QUERY_DISTINCT)
    gap = _min_frame_gap(want)
    if not gap > 100 * FANOUT_REL_TOL:
        sys.exit(f"chip_smoke: serve: two frames' headline logits lie "
                 f"{gap:.3g} apart, too close for tol {FANOUT_REL_TOL}")
    served = _serve_line_run("serve mobilenet", "zoo://mobilenet_v2",
                             frames, want, FANOUT_REL_TOL, smi)
    served["min_frame_gap_rel"] = gap
    port = _free_port()
    _reset_launches()
    server = _query_server(port, 0, "zoo://mobilenet_v2",
                           "prefetch-host=true ")
    try:
        fps, results, _ = _fanout(port, frames, SERVE_CLIENTS, SERVE_WARMUP,
                                  SERVE_FRAMES, SERVE_WINDOW)
        compiles = server["qf"].fw.compile_count
        invokes = server["qf"].stats["buffers"]
    finally:
        server.stop()
    launches = _kernel_launches()
    worst, worst_rel, top1, n = _replies_vs(results, want)
    per_request = {"fps": fps, "invokes": invokes, "compile_count": compiles,
                   "max_rel_diff": worst_rel, "top1_equal": top1,
                   "replies": n, "kernel_launches": launches}
    ratio = served["fps"] / fps
    served["per_request_fps"], served["served_over_per_request"] = fps, ratio
    log(f"serve per-request: the same {SERVE_CLIENTS} clients against "
        f"tensor_query_serversrc batch=0: aggregate {fps:.2f} fps, "
        f"{invokes} invokes (one a frame), compile_count {compiles}, every "
        f"reply once and in order, relative {worst_rel:.3g}; served / "
        f"per-request fps {ratio:.3f}; kernel launches {launches}; {smi}")
    if invokes != n or worst_rel > FANOUT_REL_TOL:
        sys.exit(f"chip_smoke: serve per-request: {per_request}")
    return served, per_request


def phase_serve_vit(smi, vit_local):
    """Phase 36: the same serve line over ViT-B/16 attn=pallas at full
    width: the attention kernel at each bucket's shape, 12 launches a
    batch."""
    frames = _frames(FRAMES, _frame_shape()).numpy()
    scale = max(float(np.abs(w).max()) for w in vit_local)
    row = _serve_line_run("serve vit", "zoo://vit?attn=pallas", frames,
                          vit_local, 5e-2 + 0.05 * scale, smi, vit=True)
    row["min_frame_gap_rel"] = _min_frame_gap(vit_local)
    return row


def phase_serve_drain_router(smi, clean):
    """Phase 37: Pipeline.drain() on the MobileNet serve line mid-stream,
    then two serve replicas (one shared-tensor-filter-key) behind
    tensor_serve_router with 4 clients and session affinity, one
    replica's links killed mid-stream. Returns both rows."""
    import nnstreamer_tpu_torch as pt
    frames = _frames(QUERY_DISTINCT, _frame_shape()).numpy()
    want = _headline_logits(clean, QUERY_DISTINCT)
    n_sent = DRAIN_CLIENTS * DRAIN_FRAMES
    port = _free_port()
    _reset_launches()
    server = _serve_server(port, "zoo://mobilenet_v2", "d")
    sched = server["dsrc"].scheduler
    drained = {}

    def drain():
        # every frame is on the wire (window = frames a client); drain once
        # the server has read them all, with part still queued
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = sched.batcher.stats.snapshot()
            if st["submitted"] + st["shed_admission"] >= n_sent:
                break
            time.sleep(0.001)
        drained["pending"] = sched.pending()
        t0 = time.perf_counter()
        drained["ok"] = server.drain(deadline=60)
        drained["ms"] = (time.perf_counter() - t0) * 1e3

    _, results, stats = _fanout(port, frames, DRAIN_CLIENTS, 0, DRAIN_FRAMES,
                                DRAIN_FRAMES, during=(4, drain))
    rep = sched.report()
    launches = _kernel_launches()
    sheds = sum(s["shed"] for s in stats)
    lost = sum(s["session_declared_lost"] for s in stats)
    n_result = sum(len(r["replies"]) for r in results)
    settled = rep["completed"] + rep["shed_deadline"] + rep["cancelled"] \
        + rep["shed_failed"]
    _, worst_rel, _, _ = _replies_vs(results, want, in_order=False)
    drain_row = {"clients": DRAIN_CLIENTS, "frames_per_client": DRAIN_FRAMES,
                 "drain_ok": drained.get("ok"), "drain_ms": drained.get("ms"),
                 "pending_at_drain": drained.get("pending"),
                 "results": n_result, "shed": sheds, "declared_lost": lost,
                 "requests": rep["requests"], "completed": rep["completed"],
                 "shed_admission": rep["shed_admission"],
                 "settled": settled, "max_rel_diff": worst_rel,
                 "kernel_launches": launches}
    log(f"serve drain: {DRAIN_CLIENTS} clients x {DRAIN_FRAMES} frames, "
        f"Pipeline.drain() with {drained.get('pending')} requests queued: "
        f"returned {drained.get('ok')} in {drained.get('ms', 0):.1f} ms; "
        f"{n_result} RESULT + {sheds} SHED = {n_result + sheds} of {n_sent}, "
        f"{lost} declared lost; requests {rep['requests']} = completed "
        f"{rep['completed']} + shed_deadline {rep['shed_deadline']} + "
        f"cancelled {rep['cancelled']} + shed_failed {rep['shed_failed']}; "
        f"admission shed {rep['shed_admission']}; relative {worst_rel:.3g} "
        f"(tol {FANOUT_REL_TOL}); {smi}")
    if drained.get("ok") is not True or n_result + sheds != n_sent or lost \
            or rep["requests"] != settled or rep["completed"] != n_result \
            or rep["shed_admission"] != sheds or worst_rel > FANOUT_REL_TOL:
        sys.exit(f"chip_smoke: serve drain: {drain_row}")

    # the fleet: two replicas, one copy of the weights, one router
    _reset_launches()
    ports = [_free_port(), _free_port()]
    reps = [_serve_server(p, "zoo://mobilenet_v2", f"r{i}",
                          "shared-tensor-filter-key=fleet ")
            for i, p in enumerate(ports)]
    router = pt.parse_launch(
        f"tensor_serve_router name=rt port=0 replicas=localhost:{ports[0]},"
        f"localhost:{ports[1]} heartbeat-ms=50 breaker-reset-ms=100")
    router.start()
    rt = router["rt"]
    killed = {}

    def healthy():
        rows = rt.router_report()
        return len(rows) == 2 and all(r["state"] == "healthy"
                                      for r in rows.values())

    def kill():
        loads = [r[f"r{i}src"].scheduler.report()["completed"]
                 for i, r in enumerate(reps)]
        victim = loads.index(max(loads))
        killed["replica"] = victim
        killed["links"] = reps[victim][f"r{victim}src"].kill_link()

    try:
        deadline = time.monotonic() + 30
        while not healthy() and time.monotonic() < deadline:
            time.sleep(0.01)
        _, results, stats = _fanout(
            rt.bound_port, frames, ROUTER_CLIENTS, 0, ROUTER_FRAMES, 8,
            during=(ROUTER_CLIENTS * ROUTER_FRAMES // 3, kill))
        st = rt.stats.snapshot()
        per_replica = [r[f"r{i}src"].scheduler.report()["completed"]
                       for i, r in enumerate(reps)]
        fws = [r[f"r{i}f"].fw for i, r in enumerate(reps)]
        compiles = fws[0].compile_count
    finally:
        router.stop()
        for r in reps:
            r.stop()
    launches = _kernel_launches()
    sheds = sum(s["shed"] for s in stats)
    lost = sum(s["session_declared_lost"] for s in stats)
    n_result = sum(len(r["replies"]) for r in results)
    _, worst_rel, _, _ = _replies_vs(results, want, in_order=False)
    router_row = {"replicas": 2, "clients": ROUTER_CLIENTS,
                  "frames_per_client": ROUTER_FRAMES,
                  "killed_replica": killed.get("replica"),
                  "links_killed": killed.get("links"),
                  "results": n_result, "shed": sheds, "declared_lost": lost,
                  "per_replica_completed": per_replica,
                  "one_backend": fws[0] is fws[1], "compile_count": compiles,
                  "max_rel_diff": worst_rel, "kernel_launches": launches,
                  **{k: v for k, v in st.items() if k.startswith("router_")}}
    log(f"serve router: {ROUTER_CLIENTS} clients x {ROUTER_FRAMES} frames "
        f"over 2 replicas (one shared backend: {fws[0] is fws[1]}, "
        f"compile_count {compiles}), replica {killed.get('replica')}'s "
        f"{killed.get('links')} link(s) killed after a third: {n_result} "
        f"RESULT, {sheds} SHED, {lost} declared lost; router requests "
        f"{st['router_requests']} = delivered {st['router_delivered']} + "
        f"shed {st['router_shed']} + orphaned {st['router_orphaned']}; "
        f"redispatched {st['router_redispatched']}, replica deaths "
        f"{st['router_replica_deaths']}, connects "
        f"{st['router_replica_connects']}, duplicate drops "
        f"{st['router_dup_drops']}; completed a replica {per_replica}; "
        f"relative {worst_rel:.3g} (tol {FANOUT_REL_TOL}); {smi}")
    if n_result != ROUTER_CLIENTS * ROUTER_FRAMES or sheds or lost \
            or st["router_requests"] != st["router_delivered"] \
            + st["router_shed"] + st["router_orphaned"] \
            or not killed.get("links") or fws[0] is not fws[1] \
            or compiles > 4 or worst_rel > FANOUT_REL_TOL:
        sys.exit(f"chip_smoke: serve router: {router_row}")
    return drain_row, router_row


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
    smi = timed("device", phase_device)
    kind = torch.cuda.get_device_name(0)
    # every launch line the phases parse, for phase 21's validate()
    import nnstreamer_tpu_torch as pt
    launched = []
    parse = pt.parse_launch

    queues = {"python": 0, "native": 0}

    def parse_recorded(desc, *args, **kwargs):
        # every line but the native queue lines runs the Python queue it
        # was measured with, whatever build/native/ holds (backend=auto
        # takes the ring once the library is on disk)
        pinned = "backend=" not in desc
        if pinned:
            desc = re.sub(r"(?<![\w.=-])queue(?=\s|$)",
                          "queue backend=python", desc)
        launched.append(desc)
        pipe = parse(desc, *args, **kwargs)
        for e in pipe.elements.values():
            if getattr(e, "is_native", None) is not None:
                queues["native" if e.is_native else "python"] += 1
                if pinned and e.is_native:
                    sys.exit(f"chip_smoke: a ring queue on {desc[:100]}")
        return pipe

    pt.parse_launch = parse_recorded
    building = start_build()
    # phases 32-34: the generative line, which neither hand kernel runs,
    # while the kernels build
    llm = {}
    llm["llm_decode"], llm_tokens = timed("llm_decode", phase_llm_decode,
                                          smi)
    llm["llm_parity"] = timed("llm_parity", phase_llm_parity, smi,
                              llm_tokens)
    llm["llm_single_shot"] = timed("llm_single_shot",
                                   phase_llm_single_shot, smi)
    hmma = timed("build", phase_build, building)
    rows = timed("kernels", phase_kernels)
    norm_rows, norm_err = timed("normalize", phase_normalize)
    with tempfile.TemporaryDirectory() as tmp:
        run = timed("pipeline", phase_pipeline, smi, tmp)
        mobilenet, frames = timed("mobilenet", phase_mobilenet, smi, tmp)
    norm_launches = timed("normalize_entry", phase_normalize_entry, frames)
    vit_batch = timed("vit_batch", phase_vit_batch, smi)
    lines = {k: timed(k, fn, smi) for k, fn in (
        ("ssd", phase_ssd), ("posenet", phase_posenet),
        ("deeplab", phase_deeplab), ("video", phase_video))}
    graphs = timed("graphs", phase_graphs)
    lines["fused_deeplab"] = timed("fused", phase_fused, smi)
    with tempfile.TemporaryDirectory() as tmp:
        labels = os.path.join(tmp, "labels.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"class{i}" for i in range(1000)))
        inflight = timed("vit_inflight", phase_vit_inflight, smi, tmp)
    lines["ensemble"] = timed("ensemble", phase_ensemble, smi)
    lines["aggregated"] = timed("aggregated", phase_aggregated, smi)
    lines["crop"] = timed("crop", phase_crop, smi)
    lines["throttled"] = timed("throttled", phase_throttled, smi)
    traces = timed("traces", phase_traces, smi)
    with tempfile.TemporaryDirectory() as tmp:
        labels = os.path.join(tmp, "labels1001.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"class{i}" for i in range(1001)))
        policies, clean = timed("policies", phase_policies, smi, labels)
    segment = timed("segment_faults", phase_segment_faults, smi, clean)
    lines["query_fanout"] = timed("query_fanout", phase_query_fanout, smi,
                                  clean)
    lines["query_vit"], vit_local = timed("query_vit", phase_query_vit,
                                          smi)
    lines["edge_pubsub"] = timed("edge_pubsub", phase_edge_pubsub, smi)
    lines["shared_vit"], vit = timed("shared_vit", phase_shared_vit, smi)
    # phases 26-28 run several lines each: one row, and one count, a line
    multi = {k: timed(k, fn, smi, clean) for k, fn in (
        ("suspend_reload", phase_suspend_reload),
        ("combination", phase_combination))}
    with tempfile.TemporaryDirectory() as tmp:
        multi["plain_backends"] = timed(
            "plain_backends", phase_plain_backends, smi, clean, vit, tmp)
    # phases 29-31 and the native queue lines: one row, and one count, a
    # line; neither hand kernel runs on any of them
    multi["delta_link"] = timed("delta_link", phase_delta_link, smi)
    gate = timed("delta_gate", phase_delta_gate, smi)
    tile_error = gate.pop("tile_error")
    multi["delta_gate"] = gate
    multi["sparse"] = timed("sparse", phase_sparse, smi)
    native = timed("native_queue", phase_native_queue, smi, clean,
                   building.result()[3])
    native_build_s = native.pop("build_s")
    multi["native_queue"] = native
    # phases 35-37: the serving stack
    lines["serve_mobilenet"], lines["serve_per_request"] = timed(
        "serve_mobilenet", phase_serve_mobilenet, smi, clean)
    lines["serve_vit"] = timed("serve_vit", phase_serve_vit, smi, vit_local)
    lines["serve_drain"], lines["serve_router"] = timed(
        "serve_drain_router", phase_serve_drain_router, smi, clean)
    for k in ("serve_mobilenet", "serve_per_request", "serve_drain",
              "serve_router"):
        if lines[k]["kernel_launches"]["attention"] \
                or lines[k]["kernel_launches"]["normalize"]:
            sys.exit(f"chip_smoke: a hand kernel ran on {k}: "
                     f"{lines[k]['kernel_launches']}")
    multi.update(llm)
    for k in ("delta_link", "delta_gate", "sparse", "native_queue",
              "llm_decode", "llm_parity", "llm_single_shot"):
        for line, row in multi[k].items():
            if row["kernel_launches"]["attention"] \
                    or row["kernel_launches"]["normalize"]:
                sys.exit(f"chip_smoke: a hand kernel ran on {k}_{line}: "
                         f"{row['kernel_launches']}")
    pt.parse_launch = parse
    log(f"queues: {queues['python']} Python queues on the lines of "
        f"phases 1-37, {queues['native']} ring queues, all on the native "
        "queue lines")
    pipelint = phase_pipelint(smi, list(dict.fromkeys(launched)))
    for k in ("clean", "retry", "skip", "restart"):
        lines[f"policies_{k}"] = policies[k]
    for k in ("retry", "restart", "skip", "breaker", "filter_restarts"):
        lines[f"segment_{k}"] = segment[k]
    new_paths = {k: row["kernel_launches"] for k, row in lines.items()}
    new_paths.update({f"{k}_{line}": row["kernel_launches"]
                      for k, rows in multi.items()
                      for line, row in rows.items()})
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
                    **lines, **multi, "graphs": graphs,
                    "vit_inflight": {str(k): v for k, v in inflight.items()},
                    "vit_batch1": run, "traces": traces,
                    "policies_fail": policies["fail"],
                    "segment_clean_after": segment["clean_after"],
                    "tile_error": tile_error,
                    "native_build_s": native_build_s, "queues": queues,
                    "pipelint": pipelint, "card": smi}))
    log(f"phase seconds: {PHASE_S}; "
        f"{time.perf_counter() - T_START:.1f} s since the script started")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
