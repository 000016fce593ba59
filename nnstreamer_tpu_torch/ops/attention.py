"""Fused multi-head attention: a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``nnstreamer_tpu/ops/attention.py``
(``_fused_bshd`` at :80, body ``_attn_kernel`` at :60, entry
``fused_attention``). It computes the same function: non-causal
attention per (batch, head) over ``[B, S, H, D]`` q/k/v, scores ``q·kᵀ``
accumulated in f32 and scaled by ``D**-0.5`` inside the kernel (flax
hands an ``attention_fn`` unscaled q/k/v), an f32 softmax over the keys,
``p·v`` accumulated in f32, output in q's dtype. Any S is taken; D must
be at most 128.

Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): one call
moves ``4·B·S·H·D·itemsize`` bytes of q/k/v/o, so at the ViT-B/16 shapes
(S=196, H=12, D=64, bf16) 1.2 MB at B=1 and 77 MB at B=64, against 0.12
and 7.5 GFLOP: memory-bound at both batch sizes (0.36 µs and 23 µs of
HBM time). What the design does about it: q/k/v are read once each,
straight from the ``[B, S, H, D]`` layout through their strides, o is
written once, and no ``S×S`` score tensor ever reaches device memory.

The kernels (``csrc/attention.cu``), routed by dtype (:func:`plan`):

* bf16/f16 run a FlashAttention-2 forward on the tensor cores
  (``mma.sync.m16n8k16``, f32 accumulate). A block of 4 warps takes 64
  query rows of one (b, h), each warp 16 rows with its Q fragments held
  in registers; keys and values go through shared memory in tiles of 64
  in a two-stage ring, loaded with 16-byte ``cp.async`` while the
  previous tile is computed on (or with element loads where a row is not
  16-byte aligned or ``D·itemsize`` is not a multiple of 16); an online
  softmax runs on the accumulator fragments, and the probabilities go
  from the score accumulators to the ``p·v`` product in registers.
* f32 runs on the CUDA cores in f32 (the tensor cores would take TF32):
  one block per (b·h, 16 query rows), key tiles of 32 staged in shared
  memory, an online softmax in registers.

Rounding differs from the TPU kernel in one place: the TPU kernel rounds
the *normalised* ``p`` to the input dtype before ``p·v``; the bf16/f16
kernel rounds the *unnormalised* ``p`` of each key tile (at most 1,
before the division) to the input dtype, accumulates ``p·v`` and the row
sum in f32 and divides once at the end; the f32 kernel keeps ``p`` in
f32. :func:`attention_plain` keeps the TPU kernel's rounding, and is
what the kernels are held against.

``bias``/``mask`` are outside the kernel's contract, as in the JAX
package: :func:`fused_attention` then takes the stock path
(:func:`dot_product_attention`) and launches nothing.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _tally

# kernel launches made by fused_attention (reset it to 0 to count a run);
# a launch inside a captured CUDA graph counts at each replay (_tally.py)
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


class Plan(NamedTuple):
    """How :func:`fused_attention` runs a call on the card."""
    kernel: str   # "tensor_core" (bf16/f16, mma.sync) or "cuda_core" (f32)
    staging: str  # "vec16" (16-byte cp.async) or "element" (2- or 4-byte)


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The kernel and the staging a call takes: by dtype, then by whether
    every row q/k/v starts on is 16-byte aligned (the data pointer and the
    batch, sequence and head strides in bytes) and ``D·itemsize`` is a
    multiple of 16, as 16-byte ``cp.async`` needs."""
    if q.dtype == torch.float32:
        return Plan("cuda_core", "element")
    size = q.element_size()
    aligned = (q.shape[-1] * size) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st * size % 16 == 0
                                       for st in t.stride()[:3])
        for t in (q, k, v))
    return Plan("tensor_core", "vec16" if aligned else "element")


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load_library
        _lib = load_library("attention")
    return _lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    err = lib.nns_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, s, h, d, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(plan(q, k, v).staging == "vec16"), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.nns_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_attention: CUDA launch failed with "
                           f"error {err} ({msg})")
    _tally.launched("attention")
    return out


def _fused_local_map(query, key, value):
    """The kernel over each rank's local q/k/v: attention is independent
    per batch row and per head, so a layout split over B (dim 0) or H
    (dim 2) stays; any other is made whole first."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in query.placements]
    q, k, v = (x.redistribute(query.device_mesh, pl)
               for x in (query, key, value))
    return local_map(fused_attention, out_placements=pl,
                     in_placements=(pl, pl, pl),
                     device_mesh=query.device_mesh)(q, k, v)


def fused_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, H, D] attention through the hand-written kernel.

    On CPU tensors it computes :func:`attention_plain`; on CUDA tensors it
    launches the kernel or raises. ``bias``/``mask`` take the stock path
    (:func:`dot_product_attention`), so a mask is never ignored. The
    kernel takes raw pointers and has no DTensor rule: a DTensor (a mesh
    invoke with heads or batch split over ``model``) runs the kernel on
    each rank's local tensors through ``local_map``."""
    if bias is not None or mask is not None:
        return dot_product_attention(query, key, value, bias=bias, mask=mask)
    from torch.distributed.tensor import DTensor
    if isinstance(query, DTensor):
        return _fused_local_map(query, key, value)
    _check(query, key, value)
    if query.device.type == "cpu":
        return attention_plain(query, key, value)
    if query.device.type != "cuda":
        raise ValueError(f"fused_attention: device {query.device} is "
                         "neither cpu nor cuda")
    return _launch(query, key, value)
