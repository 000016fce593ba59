"""Model zoo: named model builders for the torch-cuda filter backend.

Port of ``nnstreamer_tpu/models/zoo.py``. ``model=zoo://<name>?k=v``
resolves here. A builder returns ``(apply_fn, module, input_info,
output_info)``: ``module`` is an ``nn.Module`` holding the weights and
``apply_fn(module, *inputs)`` runs it on *unbatched* frame tensors
(builders add/remove the batch dim internally, so pipeline caps stay
per-frame), or on a batch with one extra leading dim.

Weights are seeded random init (``seed`` in the kwargs), drawn from an
explicit ``torch.Generator``. Not ported yet: ``params_dir`` (trained
weights from a checkpoint); weights from the JAX package's param trees
go through :mod:`.convert` instead.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ..tensors.info import TensorsInfo

Builder = Callable[..., Tuple[Callable, Any, Optional[TensorsInfo],
                              Optional[TensorsInfo]]]

_ZOO: Dict[str, Builder] = {}


def register_model(name: str):
    def deco(fn: Builder) -> Builder:
        _ZOO[name] = fn
        return fn
    return deco


def build(name: str, **kwargs):
    if name not in _ZOO:
        raise ValueError(f"unknown zoo model {name!r}; known: {sorted(_ZOO)}")
    return _ZOO[name](**kwargs)
