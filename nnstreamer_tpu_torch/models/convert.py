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
* LayerNorm ``scale`` -> ``weight``; ``pos_embed`` unchanged;
* MobileNet-v2: conv kernels HWIO -> OIHW (a depthwise ``(3, 3, 1, C)``
  kernel becomes ``(C, 1, 3, 3)``), BatchNorm ``scale``/``bias`` from
  ``params`` and ``mean``/``var`` from ``batch_stats``;
* the detection models (SSD, PoseNet, DeepLab) as MobileNet-v2 for the
  backbone and ConvBN blocks, and their biased convs (``Conv_i``) as
  kernel + bias. Their converters check that every leaf of the JAX tree
  is used exactly once;
* the toy models (``toyseg``, ``toyscale``, ``mlp``) keep the JAX
  names and layouts;
* the GPT (``gpt``, models/transformer.py) keeps the JAX names and
  layouts too: ``layers`` (a list) becomes ``layers.{i}``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

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


def _conv_bn(prefix: str, p: Mapping, stats: Mapping,
             out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(
        np.transpose(np.asarray(p["Conv_0"]["kernel"]), (3, 2, 0, 1)))
    out[f"{prefix}.scale"] = _t(p["BatchNorm_0"]["scale"])
    out[f"{prefix}.bias"] = _t(p["BatchNorm_0"]["bias"])
    out[f"{prefix}.mean"] = _t(stats["BatchNorm_0"]["mean"])
    out[f"{prefix}.var"] = _t(stats["BatchNorm_0"]["var"])


def mobilenet_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``MobileNetV2`` variables (``{"params": ..., "batch_stats":
    ...}``) -> the ``state_dict`` of
    :class:`..models.mobilenet.MobileNetV2`."""
    p, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    _conv_bn("stem", p["ConvBN_0"], stats["ConvBN_0"], out)
    i = 0
    while f"InvertedResidual_{i}" in p:
        name = f"InvertedResidual_{i}"
        j = 0
        while f"ConvBN_{j}" in p[name]:
            _conv_bn(f"blocks.{i}.layers.{j}", p[name][f"ConvBN_{j}"],
                     stats[name][f"ConvBN_{j}"], out)
            j += 1
        i += 1
    _conv_bn("head_conv", p["ConvBN_1"], stats["ConvBN_1"], out)
    _dense("fc", p["Dense_0"], out)
    return out


class _Reads(Mapping):
    """A read-only view of a nested dict that records the path of every
    leaf read through it, so a converter can prove it used each leaf of
    the tree exactly once."""

    def __init__(self, tree: Mapping, path: Tuple[str, ...] = (),
                 log: List[Tuple[str, ...]] = None):
        self._tree, self._path = tree, path
        self.log = [] if log is None else log

    def __getitem__(self, key):
        value = self._tree[key]
        path = self._path + (key,)
        if isinstance(value, Mapping):
            return _Reads(value, path, self.log)
        self.log.append(path)
        return value

    def __iter__(self) -> Iterator:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def _leaf_paths(tree: Mapping, path: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaf_paths(value, path + (key,))
        else:
            yield path + (key,)


def _check_all_read(tree: Mapping, reads: _Reads, model: str) -> None:
    want = sorted(_leaf_paths(tree))
    got = sorted(reads.log)
    if got != want:
        unused = sorted(set(want) - set(got))
        twice = sorted({p for p in got if got.count(p) > 1})
        raise ValueError(f"{model}: the JAX variables do not map one to one "
                         f"onto the torch module: unused {unused}, read "
                         f"more than once {twice}")


def _conv(prefix: str, p: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(
        np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _backbone(p: Mapping, stats: Mapping,
              out: Dict[str, torch.Tensor]) -> None:
    """flax ``_Backbone`` -> :class:`..models.detection.Backbone`."""
    _conv_bn("backbone.stem", p["ConvBN_0"], stats["ConvBN_0"], out)
    i = 0
    while f"InvertedResidual_{i}" in p:
        name = f"InvertedResidual_{i}"
        j = 0
        while f"ConvBN_{j}" in p[name]:
            _conv_bn(f"backbone.blocks.{i}.layers.{j}",
                     p[name][f"ConvBN_{j}"], stats[name][f"ConvBN_{j}"], out)
            j += 1
        i += 1


def _detection(variables: Mapping, model: str, head) -> Dict[str, torch.Tensor]:
    reads = _Reads(variables)
    p, stats = reads["params"], reads["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    _backbone(p["_Backbone_0"], stats["_Backbone_0"], out)
    head(p, stats, out)
    _check_all_read(variables, reads, model)
    return out


def ssd_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``SSDMobileNetV2`` variables -> the ``state_dict`` of
    :class:`..models.detection.SSDMobileNetV2`."""
    def head(p, stats, out):
        _conv("cls", p["SSDHead_0"]["Conv_0"], out)
        _conv("box", p["SSDHead_0"]["Conv_1"], out)
    return _detection(variables, "ssd_mobilenet_v2", head)


def posenet_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``PoseNet`` variables -> the ``state_dict`` of
    :class:`..models.detection.PoseNet`."""
    def head(p, stats, out):
        _conv("head", p["Conv_0"], out)
    return _detection(variables, "posenet", head)


def deeplab_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``DeepLabV3`` variables -> the ``state_dict`` of
    :class:`..models.detection.DeepLabV3`: ``ConvBN_0`` is the 1x1
    branch, ``ConvBN_1`` the pooled branch, ``ConvBN_2`` the fuse,
    ``Conv_0`` the f32 classifier."""
    def head(p, stats, out):
        for i, name in enumerate(("aspp", "pool", "fuse")):
            _conv_bn(name, p[f"ConvBN_{i}"], stats[f"ConvBN_{i}"], out)
        _conv("classifier", p["Conv_0"], out)
    return _detection(variables, "deeplab_v3", head)


def toy_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``toyseg``/``toyscale`` params ``{"scale", "shift"}`` -> the
    ``state_dict`` of :class:`..models.zoo.Affine`."""
    reads = _Reads(tree)
    out = {k: _t(reads[k]) for k in ("scale", "shift")}
    _check_all_read(tree, reads, "toyseg/toyscale")
    return out


def mlp_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``mlp`` params ``{"w1", "b1", "w2", "b2"}`` -> the ``state_dict``
    of :class:`..models.zoo.MLP` (float32 here; bf16 values convert
    exactly, and ``load_state_dict`` casts to the module's dtype)."""
    reads = _Reads(tree)
    out = {k: _t(reads[k]) for k in ("w1", "b1", "w2", "b2")}
    _check_all_read(tree, reads, "mlp")
    return out


def gpt_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``init_params`` tree of ``models/transformer.py``
    (``embed``, ``head``, ``ln_f`` and a list ``layers`` of dicts) -> the
    ``state_dict`` of :class:`..models.transformer.GPT` (float32 here;
    bf16 values convert exactly, and ``load_state_dict`` casts to the
    module's dtype)."""
    flat = {k: tree[k] for k in ("embed", "head", "ln_f")}
    flat.update({f"layers.{i}": dict(layer)
                 for i, layer in enumerate(tree["layers"])})
    reads = _Reads(flat)
    out = {k: _t(reads[k]) for k in ("embed", "head", "ln_f")}
    for i in range(len(tree["layers"])):
        layer = reads[f"layers.{i}"]
        for name in ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3",
                     "w2"):
            out[f"layers.{i}.{name}"] = _t(layer[name])
    _check_all_read(flat, reads, "gpt")
    return out
