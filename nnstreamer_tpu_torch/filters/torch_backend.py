"""framework=pytorch: TorchScript (``.pt``/``.pth``) models.

Port of ``nnstreamer_tpu/filters/torch_backend.py`` (≙ ext/nnstreamer/
tensor_filter/tensor_filter_pytorch.cc). The JAX package runs such a
file on the host CPU as a compatibility backend; the port loads it onto
the card (``torch.jit.load(path, map_location=device)``, ``cuda:0``
unless ``accelerator`` asks for the CPU; without CUDA and without that
request, open raises) and runs it there eagerly, as the reference runs
it: no executable cache and no graph capture, so each invoke launches
the module's kernels one by one. Inputs (host arrays or tensors) go to
the module's device; outputs stay there. Its f32 products run in full
f32, as the reference's do on the host: ``full_f32_numerics`` (which the
torch-cuda backend sets too) for what reads the process flags, and
``_full_f32_convolutions`` for the convolutions a trace froze them into.

As in the reference, input dimensions come from the properties or the
negotiated caps (TorchScript carries no static shapes); the output info
is probed with one zero forward when the inputs are known.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tensors.info import TensorInfo, TensorsInfo
from ..tensors.types import TensorType
from ..utils.log import logger
from .base import FilterEvent, FilterFramework, FilterProperties
from .registry import register_filter
from .torch_cuda_backend import device_for, full_f32_numerics


def _as_tensor(x: Any, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


# aten::_convolution(input, weight, bias, stride, padding, dilation,
#   transposed, output_padding, groups, benchmark, deterministic,
#   cudnn_enabled, allow_tf32): the two cuDNN flags rewritten below
_CONV_BENCHMARK, _CONV_ALLOW_TF32 = 9, 12


def _full_f32_convolutions(module) -> None:
    """Run a loaded TorchScript module's convolutions in full f32 with no
    cuDNN autotuning, as ``full_f32_numerics`` sets for the process.

    ``torch.jit.trace`` records the cuDNN flags of the process that
    traced the model as constant arguments of each ``aten::_convolution``
    (``allow_tf32`` is on by default), so the runtime flags never reach a
    traced convolution: rewrite those constants in every method's graph
    before the first run."""
    for m in module.modules():
        for name in m._c._method_names():
            graph = m._c._get_method(name).graph
            for node in graph.nodes():
                if node.kind() != "aten::_convolution" or \
                        len(list(node.inputs())) <= _CONV_ALLOW_TF32:
                    continue
                for k in (_CONV_BENCHMARK, _CONV_ALLOW_TF32):
                    const = graph.insertConstant(False)
                    const.node().moveBefore(node)
                    node.replaceInput(k, const)


@register_filter
class TorchScriptFilter(FilterFramework):
    NAME = "pytorch"
    EXTENSIONS = (".pt", ".pth")

    def __init__(self):
        self._module = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._lock = threading.Lock()
        self._path = ""
        self.device: Optional[torch.device] = None

    def open(self, props: FilterProperties) -> None:
        if not props.model_files:
            raise ValueError("pytorch backend needs a model file")
        self.device = device_for(props.accelerators)
        full_f32_numerics()
        self._path = props.model_files[0]
        self._module = self._load(self._path)
        self._in_info = props.input_info
        self._out_info = props.output_info
        if self._in_info is not None and self._out_info is None:
            self._out_info = self._probe_outputs(self._in_info)
        logger.info("pytorch backend loaded %s on %s", self._path,
                    self.device)

    def _load(self, path: str):
        module = torch.jit.load(path, map_location=self.device)
        module.eval()
        _full_f32_convolutions(module)
        return module

    def close(self) -> None:
        self._module = None

    def _probe_outputs(self, in_info: TensorsInfo) -> TensorsInfo:
        zeros = [torch.zeros(tuple(i.shape), dtype=i.type.torch_dtype,
                             device=self.device) for i in in_info]
        with torch.inference_mode():
            out = self._module(*zeros)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return TensorsInfo(
            TensorInfo(None, TensorType.from_dtype(o.dtype), tuple(o.shape))
            for o in outs)

    def get_model_info(self) -> Tuple[Optional[TensorsInfo],
                                      Optional[TensorsInfo]]:
        return self._in_info, self._out_info

    def set_input_info(self, info: TensorsInfo) -> Optional[TensorsInfo]:
        self._in_info = info
        self._out_info = self._probe_outputs(info)
        return self._out_info

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        with self._lock:
            xs = [_as_tensor(x, self.device) for x in inputs]
            if self._in_info is not None:
                xs = [x.reshape(i.shape) if tuple(x.shape) != tuple(i.shape)
                      else x for x, i in zip(xs, self._in_info)]
            with torch.inference_mode():
                out = self._module(*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def handle_event(self, event: FilterEvent, data=None) -> bool:
        if event == FilterEvent.RELOAD_MODEL:
            path = (data or {}).get("model_files", (self._path,))[0]
            fresh = self._load(path)  # the old module serves meanwhile
            with self._lock:
                self._module = fresh
                self._path = path
            return True
        return False
