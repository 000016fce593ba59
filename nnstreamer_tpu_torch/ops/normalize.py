"""uint8 -> scaled float: a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``nnstreamer_tpu/ops/normalize.py``
(``_normalize_pallas``, body ``_kernel``, entry ``fused_normalize``). It
computes the same function, element by element:
``((float32(x) - offset) * scale)`` rounded once to ``dtype`` (bfloat16
by default, float16 or float32), with the subtraction and the product
each an f32 operation, in that order.

Bound on the H100 (3.35 TB/s HBM): one call reads ``n`` bytes and writes
``n * itemsize``, with no arithmetic worth counting, so it is
memory-bound: ``n * (1 + itemsize) / 3.35e12`` s. One 224x224x3 frame to
bf16 is 0.45 MB (0.13 µs), far below a launch, so at frame size the
kernel is launch-bound; a batch-32 stack is 14.5 MB (4.3 µs).

What the design does about it (``csrc/normalize.cu``): one pass over
the flat data, 16-byte loads of 16 u8 values and 16-byte stores of
their results, a grid-stride loop with no padding for any ``n``. The TPU
kernel reshaped the data to (rows, 128..1024) lane tiles and padded the
ragged case; none of that is needed here. A scalar loop takes the
``n % 16`` tail and any input that is not 16-byte aligned.

Nothing in the JAX package's pipelines calls this kernel (its models
compute their own bf16 affine inline); it is the port of the entry
point ``fused_normalize``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _tally

# kernel launches made by fused_normalize (reset it to 0 to count a run);
# a launch inside a captured CUDA graph counts at each replay (_tally.py)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def normalize_plain(x: torch.Tensor, scale: float = 1.0 / 127.5,
                    offset: float = 127.5,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function:
    ``(float32(x) - offset) * scale``, cast to ``dtype``."""
    return ((x.to(torch.float32) - offset) * scale).to(dtype)


def _launch(x: torch.Tensor, scale: float, offset: float,
            dtype: torch.dtype) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    global launches
    from ._build import load_library
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = load_library("normalize")
    err = lib.nns_normalize_u8(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_longlong(x.numel()), ctypes.c_int(_DTYPE_CODES[dtype]),
        ctypes.c_float(offset), ctypes.c_float(scale),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        msg = lib.nns_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_normalize: CUDA launch failed with "
                           f"error {err} ({msg})")
    if not _tally.captured("normalize"):
        launches += 1
    return out


def fused_normalize(x: torch.Tensor, scale: float = 1.0 / 127.5,
                    offset: float = 127.5,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(x - offset) * scale`` as one pass over a uint8 tensor of any
    rank, output in ``dtype`` (float32, float16 or bfloat16).

    On a CPU tensor it computes :func:`normalize_plain`; on a CUDA tensor
    it launches the kernel or raises (a non-uint8 input raises: the
    kernel's contract is uint8). A non-contiguous input is made
    contiguous first."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_normalize: dtype {dtype} is not one of "
                        "float32, float16, bfloat16")
    if x.device.type == "cpu":
        return normalize_plain(x, scale, offset, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_normalize: device {x.device} is neither "
                         "cpu nor cuda")
    if x.dtype != torch.uint8:
        raise TypeError(f"fused_normalize: the kernel takes uint8, got "
                        f"{x.dtype}")
    return _launch(x, scale, offset, dtype)
