"""Weights from the JAX package's flax param trees.

The JAX zoo models are seeded random init; to run the *same* weights in
the port, take a model's param tree off the device (``jax.device_get``,
or arrays loaded from a file) as a nested dict of numpy arrays and
convert it here. This module imports neither JAX nor flax: it only
renames and transposes arrays.

Layout changes:

* Conv kernels HWIO -> OIHW;
* Dense kernels ``[in, out]`` -> ``[out, in]``;
* the attention's ``DenseGeneral`` kernels: query/key/value
  ``[d, H, Dh]`` -> ``[H*Dh, d]``, their biases ``[H, Dh]`` -> ``[H*Dh]``;
  out ``[H, Dh, d]`` -> ``[d, H*Dh]``;
* LayerNorm ``scale`` -> ``weight``; ``pos_embed`` unchanged.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(prefix: str, p: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(prefix: str, p: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def vit_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``ViT`` params (with or without the top ``"params"`` level)
    -> the ``state_dict`` of :class:`..models.vit.ViT`."""
    p = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}
    conv = p["Conv_0"]
    out["patch_embed.weight"] = _t(
        np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
    out["patch_embed.bias"] = _t(conv["bias"])
    out["pos_embed"] = _t(p["pos_embed"])
    i = 0
    while f"EncoderBlock_{i}" in p:
        blk = p[f"EncoderBlock_{i}"]
        pre = f"blocks.{i}"
        _layernorm(f"{pre}.ln0", blk["LayerNorm_0"], out)
        _layernorm(f"{pre}.ln1", blk["LayerNorm_1"], out)
        mha = blk["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            kernel = np.asarray(mha[name]["kernel"])  # [d, H, Dh]
            out[f"{pre}.attn.{name}.weight"] = _t(
                kernel.reshape(kernel.shape[0], -1).T)
            out[f"{pre}.attn.{name}.bias"] = _t(
                np.asarray(mha[name]["bias"]).reshape(-1))
        kernel = np.asarray(mha["out"]["kernel"])  # [H, Dh, d]
        out[f"{pre}.attn.out.weight"] = _t(
            kernel.reshape(-1, kernel.shape[-1]).T)
        out[f"{pre}.attn.out.bias"] = _t(mha["out"]["bias"])
        _dense(f"{pre}.mlp_in", blk["Dense_0"], out)
        _dense(f"{pre}.mlp_out", blk["Dense_1"], out)
        i += 1
    _layernorm("ln_f", p["LayerNorm_0"], out)
    _dense("head", p["Dense_0"], out)
    return out
