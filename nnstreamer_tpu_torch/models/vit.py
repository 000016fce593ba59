"""Vision Transformer — port of ``nnstreamer_tpu/models/vit.py``.

    zoo://vit?size=224&patch=16&d_model=768&layers=12&heads=12&attn=pallas

Same output contract as the JAX model: a uint8 HWC frame in (or a BHWC
batch), ``[classes]`` float32 logits out, so image_labeling decodes it
unchanged. ``attn=pallas`` routes every encoder block's attention
through the hand-written CUDA kernel (:func:`..ops.attention.
fused_attention`); ``attn=stock`` is plain PyTorch attention in flax's
``dot_product_attention`` arithmetic; ``attn=auto`` resolves to stock,
as in the JAX package. The weights are the same either way.

The arithmetic follows the flax modules step by step, so that the
port's logits can be held against the JAX model's:

* parameters are f32 and are cast to the compute dtype (bf16 by
  default) at each use, as flax's ``dtype=`` does;
* LayerNorm is flax's: statistics in f32 as ``E[x²] − E[x]²`` clipped at
  0, epsilon 1e-6, f32 scale and bias, one rounding to the compute
  dtype at the end;
* Dense adds its bias after the product, in the compute dtype;
* GELU is the tanh approximation (flax ``nn.gelu``);
* ``pos_embed`` is cast to the compute dtype before the add;
* mean-pooling is in the compute dtype; the head Dense runs in f32;
* the input affine is ``frame.to(dtype) / 127.5 - 1.0``, in the compute
  dtype, as the JAX apply function computes it.

Init draws flax's default distributions (LeCun-normal truncated at two
standard deviations for kernels, zeros for biases, N(0, 0.02) for
``pos_embed``, ones/zeros for LayerNorm) from an explicit
``torch.Generator`` seeded with ``seed``. PyTorch's generator is not
JAX's, so the numbers differ from the JAX zoo model of the same seed;
to run the JAX model's weights, convert its param tree with
:func:`..models.convert.vit_params_from_jax`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, fused_attention
from ..tensors.info import TensorsInfo
from .zoo import register_model

# flax variance_scaling's constant: the std of a unit normal truncated to
# [-2, 2], which its truncated-normal draw divides by
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal()``: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t = torch.empty(shape)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=gen)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ W + b`` with W and b cast to x's dtype,
    the bias added after the product. ``weight`` is [out, in]."""

    def __init__(self, in_features: int, out_features: int,
                 gen: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(
            lecun_normal((out_features, in_features), in_features, gen))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (see the module docstring)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class PatchEmbed(nn.Module):
    """flax ``nn.Conv`` with kernel = stride = patch and VALID padding on
    an NHWC input; ``weight`` is OIHW [d_model, 3, patch, patch]. Returns
    [B, patches, d_model], patches in row-major order."""

    def __init__(self, patch: int, d_model: int, gen: torch.Generator):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(lecun_normal(
            (d_model, 3, patch, patch), 3 * patch * patch, gen))
        self.bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     stride=self.patch)
        return y.flatten(2).transpose(1, 2) + self.bias.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` self-attention: q/k/v/out
    projections (flax's ``DenseGeneral`` kernels reshaped to ``Dense``)
    around an unscaled-q/k/v attention core on ``[B, S, H, D]``."""

    def __init__(self, d_model: int, heads: int, fused: bool,
                 gen: torch.Generator):
        super().__init__()
        if d_model % heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"heads {heads}")
        self.heads = heads
        self.fused = fused
        self.query = Dense(d_model, d_model, gen)
        self.key = Dense(d_model, d_model, gen)
        self.value = Dense(d_model, d_model, gen)
        self.out = Dense(d_model, d_model, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        shape = (b, s, self.heads, d // self.heads)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        attend = fused_attention if self.fused else dot_product_attention
        return self.out(attend(q, k, v).reshape(b, s, d))


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int, heads: int, fused: bool,
                 gen: torch.Generator, mlp_ratio: int = 4):
        super().__init__()
        self.ln0 = LayerNorm(d_model)
        self.attn = MultiHeadAttention(d_model, heads, fused, gen)
        self.ln1 = LayerNorm(d_model)
        self.mlp_in = Dense(d_model, d_model * mlp_ratio, gen)
        self.mlp_out = Dense(d_model * mlp_ratio, d_model, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln0(x))
        h = F.gelu(self.mlp_in(self.ln1(x)), approximate="tanh")
        return x + self.mlp_out(h)


class ViT(nn.Module):
    """[B, H, W, 3] input (already normalised, compute dtype) ->
    [B, classes] float32 logits."""

    def __init__(self, patch: int = 16, d_model: int = 768, layers: int = 12,
                 heads: int = 12, classes: int = 1000, size: int = 224,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        n_patches = (size // patch) ** 2
        self.patch_embed = PatchEmbed(patch, d_model, gen)
        self.pos_embed = nn.Parameter(
            torch.empty(1, n_patches, d_model).normal_(0.0, 0.02,
                                                       generator=gen))
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, heads, fused, gen) for _ in range(layers))
        self.ln_f = LayerNorm(d_model)
        self.head = Dense(d_model, classes, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x.to(self.dtype))
        x = x + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x).mean(dim=1)  # mean-pool in the compute dtype
        return self.head(x.float())


def apply_vit(model: ViT, frame: torch.Tensor) -> torch.Tensor:
    """uint8 HWC frame (or BHWC batch) -> logits ([classes] or
    [B, classes]); the JAX package's ``apply_fn``."""
    batched = frame.dim() == 4
    x = frame.to(model.dtype) / 127.5 - 1.0
    out = model(x if batched else x[None])
    return out if batched else out[0]


@register_model("vit")
def _build_vit(size: str = "224", patch: str = "16", d_model: str = "768",
               layers: str = "12", heads: str = "12",
               classes: str = "1000", seed: str = "0",
               attn: str = "auto"):
    """``attn``: ``stock`` (plain PyTorch attention), ``pallas`` (the
    hand-written kernel, ops/attention.py; the name is the JAX
    package's). ``auto`` resolves to stock, as in the JAX package."""
    hw = int(size)
    if attn == "auto":
        attn = "stock"
    if attn not in ("stock", "pallas"):
        # a typo must not silently benchmark the wrong attention path
        raise ValueError(f"vit: attn must be auto|stock|pallas, "
                         f"got {attn!r}")
    model = ViT(patch=int(patch), d_model=int(d_model), layers=int(layers),
                heads=int(heads), classes=int(classes), size=hw,
                fused=(attn == "pallas"), seed=int(seed))
    in_info = TensorsInfo.make("uint8", f"3:{hw}:{hw}")
    out_info = TensorsInfo.make("float32", classes)
    return apply_vit, model, in_info, out_info
