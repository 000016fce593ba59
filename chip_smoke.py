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


def _run_timed(line, warmup, frames, timeout=600):
    """Run a line to EOS, materialising every buffer on the host at the
    sink; returns (pipeline, arrival times of buffers warmup+1..)."""
    import nnstreamer_tpu_torch as pt
    pipe = pt.parse_launch(line)
    stamps = []

    def on_buffer(buf):
        buf.host_arrays()
        stamps.append(time.perf_counter())

    pipe["out"].connect(on_buffer)
    pipe.run(timeout=timeout)
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


def main():
    smi = phase_device()
    kind = torch.cuda.get_device_name(0)
    hmma = phase_build()
    rows = phase_kernels()
    norm_rows, norm_err = phase_normalize()
    with tempfile.TemporaryDirectory() as tmp:
        run = phase_pipeline(smi, tmp)
        mobilenet, frames = phase_mobilenet(smi, tmp)
    norm_launches = phase_normalize_entry(frames)
    vit_batch = phase_vit_batch(smi)
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
                          f"vit_batch{VIT_BATCH}": vit_batch["launches"]},
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
        "shapes": norm_rows,
        "card": smi,
    }]
    log(json.dumps({"mobilenet": mobilenet, f"vit_batch{VIT_BATCH}": vit_batch,
                    "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
