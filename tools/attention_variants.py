"""Compare builds of the attention kernel on one card, in turns.

    python3 tools/attention_variants.py [--source NAME=PATH ...]
                                        [--warps N ...] [--shapes B,S,H,D ...]

Each variant is an attention source with the port's C interface
(``nnstreamer_tpu_torch/csrc/attention.cu``, named ``current``, unless
``--source`` names others), compiled with the port's nvcc flags into
``build/torch_kernels/variants/``, all at once. ``--warps N`` adds
``warpsN``: the first source with N warps (16·N query rows) a
tensor-core block in place of 4. For every shape (bf16 q/k/v from a seeded
generator), each variant is held against ``attention_plain`` (2**-6) and
timed in turns, A B .. B A: the mean time of one call from CUDA events
over back-to-back calls, and its device time from torch.profiler. The
wrapper's library handle is pointed at each variant in turn, so a call
goes through ``fused_attention`` as on the main path. Prints the card,
one line a variant and shape, and a JSON summary as the last line.
Needs a CUDA device; exits non-zero without one.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARPS_LINE = "constexpr int kWarps = 4;"


def build(sources, warps):
    """{name: loaded library} for every variant, one nvcc each, in
    parallel."""
    from nnstreamer_tpu_torch.ops import _build
    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {name: open(path).read() for name, path in sources}
    first = next(iter(texts.values()))
    for n in warps:
        if WARPS_LINE not in first:
            sys.exit(f"attention_variants: {WARPS_LINE!r} not in the source")
        texts[f"warps{n}"] = first.replace(WARPS_LINE,
                                           f"constexpr int kWarps = {n};")
    procs = {}
    for name, text in texts.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(out_dir / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"attention_variants: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, (restype, argtypes) in _build.SIGNATURES["attention"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--warps", type=int, nargs="+", default=[])
    ap.add_argument("--shapes", nargs="+",
                    default=["1,196,12,64", "64,196,12,64"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attention_variants: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import chip_smoke
    from nnstreamer_tpu_torch.ops import attention as A

    sources = [tuple(s.split("=", 1)) for s in args.source] or [
        ("current", os.path.join(ROOT, "nnstreamer_tpu_torch", "csrc",
                                 "attention.cu"))]
    libs = build(sources, args.warps)
    names = list(libs)
    order = names + names[::-1]
    summary = []
    for spec in args.shapes:
        shape = tuple(int(x) for x in spec.split(","))
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = [torch.randn(shape, generator=g, device="cuda").bfloat16()
                   for _ in range(3)]
        want = A.attention_plain(q, k, v)
        runs = {name: {"ms": [], "device_ms": []} for name in names}
        for name in order:
            A._lib = libs[name]
            got = A.fused_attention(q, k, v)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 2.0 ** -6:
                sys.exit(f"attention_variants: {name} at {shape}: max |err| "
                         f"{err} > 2**-6")
            runs[name]["max_abs_err"] = err
            runs[name]["ms"].append(chip_smoke.time_ms(
                lambda: A.fused_attention(q, k, v)))
            runs[name]["device_ms"].append(chip_smoke.device_ms(
                lambda: A.fused_attention(q, k, v), "attention_fwd"))
        for name in names:
            row = {"variant": name, "shape": list(shape), **runs[name]}
            print(f"{name} {shape}: ms {runs[name]['ms']} device_ms "
                  f"{runs[name]['device_ms']} max |err| "
                  f"{runs[name]['max_abs_err']}", flush=True)
            summary.append(row)
    A._lib = None
    print(json.dumps({"card": smi, "rows": summary}))


if __name__ == "__main__":
    main()
