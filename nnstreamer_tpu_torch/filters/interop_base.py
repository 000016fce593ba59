"""Shared lifecycle for the imported-model filter backends.

Port of ``nnstreamer_tpu/filters/interop_base.py``: tensorflow-lite,
onnxruntime and tensorflow differ only in their importer, so the
open/invoke/suspend/reload machinery lives here once. Subclasses set
``NAME``, ``EXTENSIONS`` and ``_import`` (path -> an object with
``module``, ``input_info`` and ``output_info``; interop/tflite.py,
interop/onnx.py, interop/tf_graphdef.py).

Where the JAX backend jits the importer's function, this one runs the
importer's module through the torch-cuda backend's machinery
(filters/torch_cuda_backend.py): the module's weights move to the
filter's device once at open; on the card each input signature is one
captured CUDA graph in the element's graph pool
(filters/executable.py), on the CPU the eager module; SUSPEND keeps the
weights on the host until the next frame, RESUME brings them back, and
RELOAD_MODEL imports the new file beside the old one, which serves until
the swap. ``open`` sets full f32 numerics (no TF32). An empty
``accelerator`` means ``cuda:0`` and raises without CUDA; the backend
never falls back to the CPU by itself (``accelerator=true:cpu`` asks for
it).

As in the JAX package, an imported filter joins no fused segment
(``traceable_fn`` is None), takes no extra batch dim and has no
in-flight window. Pipeline buffers may omit the model's size-1 batch dims
(``3:224:224`` against ``[1,224,224,3]``): an input of the model's
element count is reshaped to its declared shape before the invoke.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from ..utils.log import logger
from .base import FilterProperties
from .torch_cuda_backend import TorchCudaFilter


class ImportedModelFilter(TorchCudaFilter):
    """Backend whose model is imported to one torch module with static
    input/output_info."""

    SUPPORTS_BATCH = False
    SUPPORTS_DISPATCH = False

    #: importer: path -> object with .module / .input_info / .output_info
    _import: Callable[[str], Any]

    def _load(self, props: FilterProperties):
        if not props.model_files:
            raise ValueError(f"{self.NAME} backend needs a model file")
        model = type(self)._import(props.model_files[0])
        module = model.module.to(self.device).eval()
        logger.info("%s backend imported %s (%d in, %d out) on %s",
                    self.NAME, props.model_files[0],
                    len(model.input_info), len(model.output_info),
                    self.device)
        return (lambda m, *xs: m(*xs), module, model.input_info,
                model.output_info)

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        xs = []
        for x, info in zip(inputs, self._in_info):
            # pipeline buffers omit size-1 batch dims (3:224:224 vs the
            # model's [1,224,224,3]); reshape by element count
            if tuple(x.shape) != tuple(info.shape):
                x = x.reshape(info.shape) if isinstance(x, torch.Tensor) \
                    else np.asarray(x).reshape(info.shape)
            xs.append(x)
        return super().invoke(xs)

    def traceable_fn(self):
        return None
