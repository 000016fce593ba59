"""Detection, pose and segmentation zoo models — port of
``nnstreamer_tpu/models/detection.py``.

    zoo://ssd_mobilenet_v2?width=1.0&num_classes=91&size=300&topk=100&packed=0
    zoo://posenet?width=1.0&size=257&keypoints=17&decode=0
    zoo://deeplab_v3?width=1.0&size=257&num_classes=21&argmax=0

All three share the MobileNet-v2 backbone of :mod:`.mobilenet`, cut at
output stride 16, and keep their postprocessing inside the model's
forward (top-k, argmax, resize), so one invoke is one pass on the card.
The output contracts are the JAX models':

* ``ssd_mobilenet_v2`` emits the TFLite detection-postprocess quad —
  boxes ``[K, 4]`` (ymin, xmin, ymax, xmax, normalised), classes ``[K]``,
  scores ``[K]``, count ``[1]``, all float32 — or, with ``packed=1``, the
  same values flat in one ``[6K + 1]`` tensor;
* ``posenet`` emits sigmoid heatmaps ``[H', W', K]``, or with
  ``decode=device`` the keypoints ``[K, 3]`` (x, y, score);
* ``deeplab_v3`` emits logits ``[H, W, C]`` upsampled to the input size,
  or with ``argmax=1`` / ``argmax=u8`` the int32 / uint8 class map.

Every builder takes an HWC uint8 frame, or a BHWC stack and then gives
every output one more leading dim.

Arithmetic, as flax computes it:

* the backbone and the ConvBN blocks are :mod:`.mobilenet`'s (bf16 convs,
  f32 BatchNorm with running statistics rounded to bf16, relu6);
* a flax ``nn.Conv(dtype=bf16)`` with a bias (the SSD head's two convs,
  PoseNet's head) rounds the conv to bf16 and then adds the bias cast to
  bf16; DeepLab's classifier is an f32 conv on the f32-widened features;
* ``jax.lax.top_k`` returns the lower index first among equal scores,
  and ``torch.topk`` does not promise that, so the SSD rank is a stable
  descending sort; ``jnp.argmax`` and ``torch.argmax`` both take the
  first maximum;
* ``jax.image.resize(..., "bilinear")`` is ``F.interpolate(mode=
  "bilinear", align_corners=False)`` on NCHW (half-pixel centres, edge
  taps renormalised).

Seeded random init, as :mod:`.mobilenet` draws it; the JAX models'
variables convert with :mod:`.convert` (``ssd_params_from_jax``,
``posenet_params_from_jax``, ``deeplab_params_from_jax``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..tensors.info import TensorsInfo
from .mobilenet import _V2_BLOCKS, ConvBN, InvertedResidual, _make_divisible
from .vit import lecun_normal
from .zoo import register_model


def _flag(value: str) -> bool:
    return value not in ("0", "", "false")


class Backbone(nn.Module):
    """flax ``_Backbone``: MobileNet-v2 features up to ``max_stride``.

    The stride bookkeeping is the JAX module's loop, as written: a block
    whose stride would take the running stride past ``max_stride`` runs
    at stride 1 (at 16, the first block of the 160-channel stage), and
    that block has no residual (96 != 160 channels)."""

    def __init__(self, width: float = 1.0, max_stride: int = 16,
                 gen: torch.Generator = None):
        super().__init__()
        c0 = _make_divisible(32 * width)
        self.stem = ConvBN(3, c0, k=3, stride=2, gen=gen)
        blocks: List[nn.Module] = []
        cin, stride = c0, 2
        for t, c, n, s in _V2_BLOCKS:
            ch = _make_divisible(c * width)
            for i in range(n):
                blk_s = s if i == 0 else 1
                if stride * blk_s > max_stride:
                    blk_s = 1
                if i == 0 and s > 1 and stride * s <= max_stride:
                    stride *= blk_s
                blocks.append(InvertedResidual(cin, ch, blk_s, t, gen))
                cin = ch
        self.blocks = nn.Sequential(*blocks)
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.stem(x))


class Conv(nn.Module):
    """flax ``nn.Conv`` with a bias, SAME padding at stride 1: the conv in
    ``dtype``, rounded, then the bias cast to ``dtype`` added."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.pad = (k - 1) // 2  # flax SAME at stride 1, odd k
        self.weight = nn.Parameter(
            lecun_normal((cout, cin, k, k), cin * k * k, gen))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        y = F.conv2d(x, self.weight.to(self.dtype), padding=self.pad)
        return y + self.bias.to(self.dtype)[:, None, None]


def rank_cells(best: torch.Tensor, topk: int) -> torch.Tensor:
    """The ``topk`` indices of ``best`` (``[B, N]``) in ``lax.top_k``'s
    order: descending, the lower index first among equal values."""
    return torch.sort(best, dim=-1, descending=True,
                      stable=True).indices[:, :topk]


def ssd_postprocess(cls: torch.Tensor, box: torch.Tensor, topk: int):
    """flax ``SSDHead``'s in-graph postprocess on the two conv outputs
    (``[B, C, h, w]`` and ``[B, 4, h, w]``): one centre anchor a cell,
    sigmoid class scores, tanh box deltas, the ``topk`` cells by best
    class score. Returns the quad with a leading batch dim."""
    b, nc, h, w = cls.shape
    dev = cls.device
    scores = torch.sigmoid(cls.float()).permute(0, 2, 3, 1).reshape(b, -1, nc)
    deltas = torch.tanh(box.float()).permute(0, 2, 3, 1).reshape(b, -1, 4)
    ys, xs = torch.meshgrid(
        (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h,
        (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w,
        indexing="ij")
    cy = ys.reshape(-1) + deltas[..., 0] * 0.5
    cx = xs.reshape(-1) + deltas[..., 1] * 0.5
    bh = torch.exp(deltas[..., 2]) * (2.0 / h)
    bw = torch.exp(deltas[..., 3]) * (2.0 / w)
    cls_id = scores.argmax(-1)
    best = scores.gather(-1, cls_id[..., None])[..., 0]
    idx = rank_cells(best, topk)

    def pick(t):
        return t.gather(1, idx)

    cy, cx, bh, bw = pick(cy), pick(cx), pick(bh), pick(bw)
    boxes = torch.stack([(cy - bh / 2).clamp(0, 1), (cx - bw / 2).clamp(0, 1),
                         (cy + bh / 2).clamp(0, 1), (cx + bw / 2).clamp(0, 1)],
                        dim=-1)
    count = torch.full((b, 1), float(topk), dtype=torch.float32, device=dev)
    return boxes, pick(cls_id).float(), pick(best), count


class SSDMobileNetV2(nn.Module):
    """[B, H, W, 3] normalised input -> (the head's class and box conv
    outputs, NCHW in the compute dtype ``dtype``). :func:`ssd_postprocess`
    turns them into the quad. ``dtype=float32`` is the all-f32 twin the
    card's bf16 outputs are held against."""

    def __init__(self, num_classes: int = 91, width: float = 1.0,
                 seed: int = 0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.backbone = Backbone(width, 16, gen)
        c = self.backbone.out_channels
        self.cls = Conv(c, num_classes, 3, dtype, gen)
        self.box = Conv(c, 4, 3, dtype, gen)

    def forward(self, x: torch.Tensor):
        feat = self.backbone(x.to(self.dtype).permute(0, 3, 1, 2))
        return self.cls(feat), self.box(feat)


def _normalise(frame: torch.Tensor) -> torch.Tensor:
    """The JAX apply functions' input affine; a frame gains a batch dim."""
    x = frame.to(torch.bfloat16) / 127.5 - 1.0
    return x if frame.dim() == 4 else x[None]


def make_ssd_apply(topk: int, packed: bool):
    def apply_fn(model: SSDMobileNetV2, frame: torch.Tensor):
        out = ssd_postprocess(*model(_normalise(frame)), topk)
        if packed:
            boxes, classes, scores, count = out
            out = (torch.cat([boxes.flatten(1), classes, scores, count], 1),)
        if frame.dim() == 3:
            out = tuple(o[0] for o in out)
        return out[0] if packed else out

    return apply_fn


@register_model("ssd_mobilenet_v2")
def _build_ssd(width: str = "1.0", num_classes: str = "91",
               size: str = "300", topk: str = "100", seed: str = "0",
               packed: str = "0"):
    """``packed=1`` concatenates the quad into one flat float32 tensor
    [6K+1] inside the forward, so a host consumer fetches one tensor
    instead of four; the bounding_boxes decoder reads either form."""
    w, nc, hw, k = float(width), int(num_classes), int(size), int(topk)
    want_packed = _flag(packed)
    model = SSDMobileNetV2(num_classes=nc, width=w, seed=int(seed))
    in_info = TensorsInfo.make("uint8", f"3:{hw}:{hw}")
    out_info = TensorsInfo.make("float32", str(6 * k + 1)) if want_packed \
        else TensorsInfo.make("float32,float32,float32,float32",
                              f"4:{k},{k},{k},1")
    return make_ssd_apply(k, want_packed), model, in_info, out_info


class PoseNet(nn.Module):
    """Heatmap pose head over the /16 backbone: [B, H, W, 3] normalised
    input -> sigmoid heatmaps [B, K, H', W'] (NCHW, float32)."""

    def __init__(self, keypoints: int = 17, width: float = 1.0,
                 seed: int = 0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.backbone = Backbone(width, 16, gen)
        self.head = Conv(self.backbone.out_channels, keypoints, 1, dtype,
                         gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(x.to(self.dtype).permute(0, 3, 1, 2))
        return torch.sigmoid(self.head(feat).float())


def keypoints_of(hm: torch.Tensor) -> torch.Tensor:
    """[B, K, H', W'] heatmaps -> [B, K, 3] (x, y, score): each keypoint's
    first maximum, its position normalised by (W'-1, H'-1)."""
    b, k, hp, wp = hm.shape
    flat = hm.reshape(b, k, hp * wp)
    idx = flat.argmax(-1)
    ys = (idx // wp).float() / max(hp - 1, 1)
    xs = (idx % wp).float() / max(wp - 1, 1)
    scores = flat.gather(-1, idx[..., None])[..., 0]
    return torch.stack([xs, ys, scores], dim=-1)


def make_posenet_apply(decode: bool):
    def apply_fn(model: PoseNet, frame: torch.Tensor) -> torch.Tensor:
        hm = model(_normalise(frame))
        out = keypoints_of(hm) if decode \
            else hm.permute(0, 2, 3, 1).contiguous()
        return out if frame.dim() == 4 else out[0]

    return apply_fn


@register_model("posenet")
def _build_posenet(width: str = "1.0", size: str = "257",
                   keypoints: str = "17", seed: str = "0",
                   decode: str = "0"):
    """``decode=device`` emits [K, 3] keypoints (x, y, score; normalised,
    the pose decoder's keypoint form) instead of the [H', W', K]
    heatmap."""
    w, hw, kp = float(width), int(size), int(keypoints)
    want_decode = _flag(decode)
    model = PoseNet(keypoints=kp, width=w, seed=int(seed))
    hm = -(-hw // 16)
    in_info = TensorsInfo.make("uint8", f"3:{hw}:{hw}")
    out_info = TensorsInfo.make("float32", f"3:{kp}") if want_decode \
        else TensorsInfo.make("float32", f"{kp}:{hm}:{hm}")
    return make_posenet_apply(want_decode), model, in_info, out_info


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(method="bilinear")`` of NCHW ``x`` to
    ``size`` x ``size``."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False)


class DeepLabV3(nn.Module):
    """ASPP-lite segmentation over the /16 backbone: [B, H, W, 3]
    normalised input -> float32 logits [B, C, out, out] (NCHW)."""

    def __init__(self, num_classes: int = 21, width: float = 1.0,
                 out_size: int = 257, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.out_size = out_size
        self.backbone = Backbone(width, 16, gen)
        c = self.backbone.out_channels
        self.aspp = ConvBN(c, 256, gen=gen)
        self.pool = ConvBN(c, 256, gen=gen)
        self.fuse = ConvBN(512, 256, gen=gen)
        self.classifier = Conv(256, num_classes, 1, torch.float32, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(x.to(self.dtype).permute(0, 3, 1, 2))
        b0 = self.aspp(feat)
        gp = feat.mean(dim=(2, 3), keepdim=True,
                       dtype=torch.float32).to(feat.dtype)
        gp = self.pool(gp).expand_as(b0)
        h = self.fuse(torch.cat([b0, gp], dim=1))
        return resize_bilinear(self.classifier(h.float()), self.out_size)


def make_deeplab_apply(argmax: str):
    out_dtype = torch.uint8 if argmax == "u8" else torch.int32

    def apply_fn(model: DeepLabV3, frame: torch.Tensor) -> torch.Tensor:
        logits = model(_normalise(frame))
        out = logits.argmax(1).to(out_dtype) if _flag(argmax) \
            else logits.permute(0, 2, 3, 1).contiguous()
        return out if frame.dim() == 4 else out[0]

    return apply_fn


@register_model("deeplab_v3")
def _build_deeplab(width: str = "1.0", size: str = "257",
                   num_classes: str = "21", seed: str = "0",
                   argmax: str = "0"):
    """``argmax=1`` emits the int32 [H, W] class map instead of the
    [H, W, C] logits; ``argmax=u8`` emits it as uint8 and is refused
    above 255 classes."""
    w, hw, nc = float(width), int(size), int(num_classes)
    if argmax == "u8" and nc > 255:
        raise ValueError(
            f"deeplab_v3: argmax=u8 cannot represent {nc} classes; "
            "use argmax=1 (int32)")
    model = DeepLabV3(num_classes=nc, width=w, out_size=hw, seed=int(seed))
    in_info = TensorsInfo.make("uint8", f"3:{hw}:{hw}")
    out_info = TensorsInfo.make(
        "uint8" if argmax == "u8" else "int32", f"{hw}:{hw}") \
        if _flag(argmax) else TensorsInfo.make("float32", f"{nc}:{hw}:{hw}")
    return make_deeplab_apply(argmax), model, in_info, out_info
