"""Model zoo: named model builders for the torch-cuda filter backend.

Port of ``nnstreamer_tpu/models/zoo.py``. ``model=zoo://<name>?k=v``
resolves here. A builder returns ``(apply_fn, module, input_info,
output_info)``: ``module`` is an ``nn.Module`` holding the weights and
``apply_fn(module, *inputs)`` runs it on *unbatched* frame tensors
(builders add/remove the batch dim internally, so pipeline caps stay
per-frame), or on a batch with one extra leading dim.

Weights are seeded random init (``seed`` in the kwargs), drawn from an
explicit ``torch.Generator``; ``params_dir=<dir>`` loads trained weights
into the built module from ``<dir>/params`` (a ``state_dict`` file that
``tensor_trainer`` or :func:`..trainers.checkpoint.save_params` wrote;
the JAX package's orbax trees are refused there and go through
:mod:`.convert` instead).

``gpt`` (the logit model of ``models/transformer.py``, registered there
with the JAX entry's defaults and query keys) is the model the ``llm``
filter runs. The toy models of the JAX zoo live here too: ``toyseg`` and
``toyscale`` (elementwise-only, so fused and unfused runs stay
bit-exact) and ``mlp``, the filter-level test model.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..tensors.info import TensorsInfo

Builder = Callable[..., Tuple[Callable, Any, Optional[TensorsInfo],
                              Optional[TensorsInfo]]]

_ZOO: Dict[str, Builder] = {}


def register_model(name: str):
    def deco(fn: Builder) -> Builder:
        _ZOO[name] = fn
        return fn
    return deco


def build(name: str, params_dir: Optional[str] = None, **kwargs):
    if name not in _ZOO:
        raise ValueError(f"unknown zoo model {name!r}; known: {sorted(_ZOO)}")
    apply_fn, module, in_info, out_info = _ZOO[name](**kwargs)
    if params_dir is not None:
        from ..trainers.checkpoint import restore_params
        restore_params(params_dir, module)
    return apply_fn, module, in_info, out_info


class Affine(nn.Module):
    """Per-class ``scale`` and ``shift`` ([classes] each, float32): the
    parameters of ``toyseg`` and ``toyscale``."""

    def __init__(self, classes: int, seed: int):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.scale = nn.Parameter(torch.randn(classes, generator=gen))
        self.shift = nn.Parameter(torch.randn(classes, generator=gen))


def apply_toyseg(m: Affine, x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)[..., None] * m.scale + m.shift


def apply_toyscale(m: Affine, x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * m.scale + m.shift


@register_model("toyseg")
def _build_toyseg(height: str = "8", width: str = "8", classes: str = "5",
                  seed: str = "0"):
    """Toy per-pixel segmenter: [H, W] float32 -> [H, W, C] logits via
    per-class elementwise scale+shift. Elementwise-only (no matmul or
    conv, no reductions), so its outputs are bit-exact fused or not."""
    h, w, c = int(height), int(width), int(classes)
    in_info = TensorsInfo.make("float32", f"{h}:{w}")
    out_info = TensorsInfo.make("float32", f"{h}:{w}:{c}")
    return apply_toyseg, Affine(c, int(seed)), in_info, out_info


@register_model("toyscale")
def _build_toyscale(height: str = "8", width: str = "8", classes: str = "5",
                    seed: str = "1"):
    """Elementwise per-class affine over [H, W, C] logits -> [H, W, C]
    (a toy calibration head), the second link after ``toyseg``."""
    h, w, c = int(height), int(width), int(classes)
    info = TensorsInfo.make("float32", f"{h}:{w}:{c}")
    return apply_toyscale, Affine(c, int(seed)), info, info.copy()


class MLP(nn.Module):
    """Two dense layers in ``dtype``, the JAX zoo's layout: ``w1`` [in,
    hidden], ``w2`` [hidden, out], zero biases."""

    def __init__(self, d_in: int, d_h: int, d_out: int, seed: int,
                 dtype: torch.dtype):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.w1 = nn.Parameter((torch.randn(d_in, d_h, generator=gen)
                                * (1.0 / d_in) ** 0.5).to(dtype))
        self.b1 = nn.Parameter(torch.zeros(d_h, dtype=dtype))
        self.w2 = nn.Parameter((torch.randn(d_h, d_out, generator=gen)
                                * (1.0 / d_h) ** 0.5).to(dtype))
        self.b2 = nn.Parameter(torch.zeros(d_out, dtype=dtype))


def apply_mlp(m: MLP, x: torch.Tensor) -> torch.Tensor:
    """``relu(x @ w1 + b1) @ w2 + b2`` in the model's dtype, each product
    rounded before its bias is added, output float32."""
    x = x.to(m.dtype)
    h = torch.relu(x @ m.w1 + m.b1)
    return (h @ m.w2 + m.b2).to(torch.float32)


@register_model("mlp")
def _build_mlp(in_dim: str = "64", hidden: str = "128", out_dim: str = "10",
               seed: str = "0", dtype: str = "bfloat16"):
    """Tiny MLP — the zoo's passthrough-grade test model."""
    d_in, d_h, d_out = int(in_dim), int(hidden), int(out_dim)
    model = MLP(d_in, d_h, d_out, int(seed), getattr(torch, dtype))
    in_info = TensorsInfo.make("float32", str(d_in))
    out_info = TensorsInfo.make("float32", str(d_out))
    return apply_mlp, model, in_info, out_info
