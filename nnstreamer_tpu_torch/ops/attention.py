"""Fused multi-head attention: a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``nnstreamer_tpu/ops/attention.py``
(``_fused_bshd``, body ``_attn_kernel``, entry ``fused_attention``). It
computes the same function: non-causal attention per (batch, head) over
``[B, S, H, D]`` q/k/v, scores ``q·kᵀ`` accumulated in f32 and scaled by
``D**-0.5`` inside the kernel (flax hands an ``attention_fn`` unscaled
q/k/v), an f32 softmax over the keys, ``p·v`` accumulated in f32, output
in q's dtype.

Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): at the ViT-B/16
shapes (S=196, H=12, D=64, bf16) one call moves 1.2 MB of q/k/v/o at
B=1 and 77 MB at B=64, against 0.12 and 7.5 GFLOP, so the call is
memory-bound at both batch sizes (0.36 µs and 23 µs of HBM time). What the
design does about it: q/k/v are read once each, straight from the
``[B, S, H, D]`` layout through their strides, and o is written once. The
TPU kernel paid for transposes and pads to 128 around its call; here
there are none, and no ``S×S`` score tensor ever reaches device memory.

The kernel (``csrc/attention.cu``) runs one block per (b·h, 16 query
rows) and walks the keys in tiles of 32 staged in shared memory, with an
online softmax in f32 registers. It runs its products on the CUDA
cores in f32 with scalar shared-memory loads (about 2·D + 64 per query
row and key tile), so at large batch the shared-memory load issue rate
bounds it, far above the HBM bound; tensor cores (``mma``/``wgmma``),
vector loads and TMA are for a later change (times in PERF.md). Any S
is taken; D must be at most 128.

Rounding differs from the TPU kernel in one place: the TPU kernel rounds
the *normalised* ``p`` to the input dtype before ``p·v``; the online
softmax keeps the unnormalised ``p`` of each key tile in f32 and divides
by the row sum once at the end. :func:`attention_plain` keeps the TPU
kernel's rounding, and is what the kernel is held against.

``bias``/``mask`` are outside the kernel's contract, as in the JAX
package: :func:`fused_attention` then takes the stock path
(:func:`dot_product_attention`) and launches nothing.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

# kernel launches made by fused_attention (reset it to 0 to count a run)
launches = 0

MAX_HEAD_DIM = 128

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the Pallas kernel's function: f32 scores
    scaled by ``D**-0.5``, f32 softmax, ``p`` cast to the input dtype,
    ``p·v`` accumulated in f32, output in q's dtype. [B, S, H, D] in and
    out."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stock attention in the arithmetic of flax's
    ``nn.dot_product_attention``: q scaled by ``1/sqrt(D)`` in its own
    dtype, scores and softmax weights in that dtype, masked entries set
    to the dtype's lowest value. ``mask`` is boolean (True = attend) and,
    like ``bias``, broadcasts to [B, H, Sq, Sk]."""
    dtype = q.dtype
    q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if bias is not None:
        w = w + bias
    if mask is not None:
        w = torch.where(mask, w, torch.finfo(dtype).min)
    w = torch.softmax(w, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention: dtype {q.dtype} is not one of "
                        "float32, float16, bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("fused_attention: q, k and v must share a dtype")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("fused_attention: q, k and v must all be "
                         f"[B, S, H, D] of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"fused_attention: head dim {q.shape[-1]} is "
                         f"outside 1..{MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("fused_attention: q, k and v must be on one "
                             "device")
        if t.stride(-1) != 1:
            raise ValueError(f"fused_attention: {name} must be contiguous "
                             "in its last (head) dim")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    global launches
    from ._build import load_library
    lib = load_library("attention")
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [ctypes.c_longlong(x) for t in (q, k, v, out)
               for x in t.stride()[:3]]
    err = lib.nns_attention_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int(_DTYPE_CODES[q.dtype]), ctypes.c_int(b),
        ctypes.c_int(s), ctypes.c_int(h), ctypes.c_int(d), *strides,
        ctypes.c_float(d ** -0.5),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        msg = lib.nns_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_attention: CUDA launch failed with "
                           f"error {err} ({msg})")
    launches += 1
    return out


def fused_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, H, D] attention through the hand-written kernel.

    On CPU tensors it computes :func:`attention_plain`; on CUDA tensors it
    launches the kernel or raises. ``bias``/``mask`` take the stock path
    (:func:`dot_product_attention`), so a mask is never ignored."""
    if bias is not None or mask is not None:
        return dot_product_attention(query, key, value, bias=bias, mask=mask)
    _check(query, key, value)
    if query.device.type == "cpu":
        return attention_plain(query, key, value)
    if query.device.type != "cuda":
        raise ValueError(f"fused_attention: device {query.device} is "
                         "neither cpu nor cuda")
    return _launch(query, key, value)
