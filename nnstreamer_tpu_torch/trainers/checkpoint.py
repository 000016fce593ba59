"""Param checkpoint save/restore: ``state_dict`` files.

Port of ``nnstreamer_tpu/trainers/checkpoint.py`` (≙ the reference's
model-save-path / model-load-path trainer properties,
include/nnstreamer_plugin_api_trainer.h:35-36 — save at training end,
resume by loading). Where the JAX package writes an orbax tree at
``<path>/params``, the port writes one file there: the module's
``state_dict`` with every tensor on the CPU (``torch.save``), read back
with ``torch.load(weights_only=True)``, so loading a checkpoint runs no
pickled code. An orbax directory at ``<path>/params`` is refused by
name: the port does not read the JAX package's format (its trees go
through :mod:`..models.convert`).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch

StateDict = Dict[str, torch.Tensor]


def _params_file(path: str) -> str:
    target = os.path.join(os.path.abspath(path), "params")
    if os.path.isdir(target):
        raise ValueError(
            f"{target} is a directory — an orbax checkpoint of the JAX "
            "package; the port reads only its own params files (a "
            "state_dict saved by torch.save)")
    return target


def save_params(path: str,
                params: Union[torch.nn.Module, StateDict]) -> None:
    """Write ``params`` (a module or its ``state_dict``) to
    ``<path>/params``, overwriting an earlier save."""
    target = _params_file(path)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    sd = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    host = {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}
    tmp = target + ".tmp"
    torch.save(host, tmp)
    os.replace(tmp, target)


def restore_params(path: str, like: Optional[torch.nn.Module] = None
                   ) -> Union[torch.nn.Module, StateDict]:
    """Read what :func:`save_params` wrote. With ``like`` (a module of
    the same structure, wherever it lives) the weights are loaded into
    it, strictly, and it is returned; without, the CPU ``state_dict``."""
    target = _params_file(path)
    sd = torch.load(target, map_location="cpu", weights_only=True)
    if like is None:
        return sd
    like.load_state_dict(sd)
    return like
