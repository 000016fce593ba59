"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device   — a CUDA device must be present; prints nvidia-smi's card
              name and power limit.
2. build    — compiles every CUDA kernel of the port (one nvcc per source,
              all at once) and prints the build seconds and ptxas report.
3. kernels  — each kernel against its plain PyTorch version on the card,
              at the main path's shapes and a few ragged ones, with the
              tolerance stated beside each; kernel, plain and library
              times from CUDA events.
4. pipeline — the ViT-B/16 labeling line at full published width
              (patch 16, d_model 768, 12 layers, 12 heads, 224x224, 1000
              classes; seeded random weights) through parse_launch:
              16 labelled frames, 12 attention launches per frame, and the
              same frames' logits against attn=stock.

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


def phase_build():
    from nnstreamer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


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

    # (shape, dtype, tolerance): bf16 allows two bf16 ulps below 2 in
    # magnitude (2**-6): the plain version rounds the normalised p to bf16
    # before p.v, the kernel keeps the unnormalised p in f32, and each
    # rounds o once. f32 differs by summation order only; f16 as bf16
    # with 3 more mantissa bits.
    cases = [((1, 196, 12, 64), torch.bfloat16, 2.0 ** -6),
             ((64, 196, 12, 64), torch.bfloat16, 2.0 ** -6),
             ((1, 7, 2, 8), torch.bfloat16, 2.0 ** -6),
             ((2, 1000, 4, 128), torch.bfloat16, 2.0 ** -6),
             ((1, 196, 12, 64), torch.float32, 1e-5),
             ((1, 196, 12, 64), torch.float16, 2.0 ** -9)]
    rows = []
    for i, (shape, dtype, tol) in enumerate(cases):
        q, k, v = qkv(shape, dtype, seed=i)
        got = A.fused_attention(q, k, v)
        torch.cuda.synchronize()
        want = A.attention_plain(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(got).all())
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "max_abs_err": err, "tol": tol}
        if dtype == torch.bfloat16:
            bq, bk, bv = (t.transpose(1, 2) for t in (q, k, v))
            row["ms"] = time_ms(lambda: A.fused_attention(q, k, v))
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


def phase_pipeline(smi, tmp):
    import nnstreamer_tpu_torch as pt
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.ops import attention as A

    labels = os.path.join(tmp, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1000)))
    caps = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
            "dimensions=(string)3:224:224,framerate=(fraction)0/1")
    line = (f"tensortestsrc caps={caps} pattern=random seed={SEED} "
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
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(np.stack([
        rng.integers(0, 255, (224, 224, 3), np.uint8, endpoint=True)
        for _ in range(FRAMES)])).cuda()
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


def main():
    smi = phase_device()
    kind = torch.cuda.get_device_name(0)
    phase_build()
    rows = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        run = phase_pipeline(smi, tmp)
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
        "shapes": rows,
        "card": smi,
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
