"""MobileNet-v2 — port of ``nnstreamer_tpu/models/mobilenet.py``.

    zoo://mobilenet_v2?width=1.0&num_classes=1001&size=224&top1=0

The repo's headline model. Same output contract as the JAX model: a
uint8 HWC frame in (or a BHWC batch), ``[num_classes]`` float32 logits
out (``[B, num_classes]`` for a batch); ``top1=1`` emits the int32 argmax
instead, ``[1]`` per frame or ``[B, 1]`` per batch.

The arithmetic follows the flax modules step by step, so that the
port's logits can be held against the JAX model's:

* convolutions take flax's ``padding="SAME"``: per spatial dim
  ``total = max((ceil(H/s) - 1)·s + k - H, 0)``, ``lo = total // 2``,
  ``hi = total - lo``. A stride-2 3x3 conv on an even size pads (0, 1),
  which torch's symmetric ``padding=`` cannot say, so such a conv pads
  with ``F.pad`` first. The conv kernels are f32 parameters cast to the
  compute dtype at each use, no bias; depthwise convs use
  ``groups=channels``. Convolutions are cuDNN (``F.conv2d``), as XLA
  computed them outside any Pallas kernel;
* BatchNorm is flax's ``_normalize`` with running statistics and
  epsilon 1e-3: ``(x - mean) · (rsqrt(var + eps) · scale) + bias`` in
  f32 (x promoted from the compute dtype), rounded to the compute dtype
  once. It is not folded into the conv weights;
* relu6 and the residual add are in the compute dtype;
* the global average pool sums in f32 and rounds to the compute dtype,
  as ``jnp.mean`` on bf16 does; the classifier runs in f32;
* the input affine is ``frame.to(bf16) / 127.5 - 1.0``, as the JAX
  apply function computes it (not the normalize kernel's function).

Activations are NCHW views of the NHWC frames (``channels_last``), so
no layout copy is made.

Init draws flax's default distributions (LeCun-normal truncated at two
standard deviations for conv and Dense kernels, zero biases, BatchNorm
scale 1, bias 0, mean 0, var 1) from a ``torch.Generator`` seeded with
``seed``; to run the JAX model's weights, convert its variables with
:func:`..models.convert.mobilenet_params_from_jax`.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..tensors.info import TensorsInfo
from .vit import lecun_normal
from .zoo import register_model

# (expansion t, channels c, repeats n, stride s) — the standard v2 table
_V2_BLOCKS: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

BN_EPS = 1e-3


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dim: (lo, hi)."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ConvBN(nn.Module):
    """flax ``ConvBN``: SAME conv (no bias) + inference BatchNorm
    (+ relu6). ``weight`` is OIHW ``[out, in/groups, k, k]``."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1, act: bool = True,
                 gen: torch.Generator = None):
        super().__init__()
        self.k, self.stride, self.groups, self.act = k, stride, groups, act
        fan_in = (cin // groups) * k * k
        self.weight = nn.Parameter(
            lecun_normal((cout, cin // groups, k, k), fan_in, gen))
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = 0
        if self.k > 1:
            (top, bottom), (left, right) = (
                same_pads(x.shape[2], self.k, self.stride),
                same_pads(x.shape[3], self.k, self.stride))
            if top == bottom and left == right:
                pad = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                     padding=pad, groups=self.groups)
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        y = ((y.float() - self.mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None]).to(x.dtype)
        return F.relu6(y) if self.act else y


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 gen: torch.Generator):
        super().__init__()
        hidden = cin * expand
        layers: List[nn.Module] = []
        if expand != 1:
            layers.append(ConvBN(cin, hidden, gen=gen))
        layers.append(ConvBN(hidden, hidden, k=3, stride=stride,
                             groups=hidden, gen=gen))
        layers.append(ConvBN(hidden, cout, act=False, gen=gen))
        self.layers = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layers(x)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """[B, H, W, 3] input (already normalised, compute dtype) ->
    [B, num_classes] float32 logits."""

    def __init__(self, num_classes: int = 1001, width: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        c0 = _make_divisible(32 * width)
        self.stem = ConvBN(3, c0, k=3, stride=2, gen=gen)
        blocks, cin = [], c0
        for t, c, n, s in _V2_BLOCKS:
            ch = _make_divisible(c * width)
            for i in range(n):
                blocks.append(InvertedResidual(cin, ch, s if i == 0 else 1,
                                               t, gen))
                cin = ch
        self.blocks = nn.Sequential(*blocks)
        last = _make_divisible(1280 * max(1.0, width))
        self.head_conv = ConvBN(cin, last, gen=gen)
        self.fc = nn.Linear(last, num_classes)
        with torch.no_grad():
            self.fc.weight.copy_(lecun_normal((num_classes, last), last, gen))
            self.fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last
        x = self.head_conv(self.blocks(self.stem(x)))
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
        return self.fc(x.float())


def make_apply(top1: bool):
    """The JAX package's ``apply_fn``: uint8 HWC frame (or BHWC batch) ->
    logits, or the int32 top-1 id with ``top1``."""

    def apply_fn(model: MobileNetV2, frame: torch.Tensor) -> torch.Tensor:
        batched = frame.dim() == 4
        x = frame.to(torch.bfloat16) / 127.5 - 1.0
        out = model(x if batched else x[None])
        if top1:
            out = out.argmax(-1, keepdim=True).to(torch.int32)
        return out if batched else out[0]

    return apply_fn


@register_model("mobilenet_v2")
def _build_mobilenet_v2(width: str = "1.0", num_classes: str = "1001",
                        size: str = "224", seed: str = "0",
                        top1: str = "0"):
    """uint8 HWC frame in, float32 logits out; ``top1=1`` emits one int32
    class id per frame instead."""
    w, nc, hw = float(width), int(num_classes), int(size)
    want_top1 = top1 not in ("0", "", "false")
    model = MobileNetV2(num_classes=nc, width=w, seed=int(seed))
    in_info = TensorsInfo.make("uint8", f"3:{hw}:{hw}")
    out_info = TensorsInfo.make("int32", "1") if want_top1 \
        else TensorsInfo.make("float32", str(nc))
    return make_apply(want_top1), model, in_info, out_info
