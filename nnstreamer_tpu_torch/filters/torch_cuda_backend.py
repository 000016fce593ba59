"""The PyTorch/CUDA filter backend: the port's inference engine.

Counterpart of ``nnstreamer_tpu/filters/jax_backend.py``. A model resolves
to ``(apply_fn, module, input_info, output_info)``: ``module`` is an
``nn.Module`` holding the weights, moved once to the filter's device, and
``apply_fn(module, *inputs)`` runs one invoke under
``torch.inference_mode()``. PyTorch runs eagerly, so there is no
per-signature executable cache to keep.

Model URIs accepted by the ``model`` property:
  * ``zoo://<name>?k=v&...`` — the port's model zoo (models/zoo.py),
    seeded random init;
  * ``<file>.py`` — a python module defining ``get_model()`` returning
    the same 4-tuple.

Device: ``cuda:0`` unless ``accelerator`` opts out (``false`` or
``true:cpu``). Asking for the card where CUDA is missing raises at open;
the backend never falls back to the CPU by itself. Outputs stay on the
filter's device, so chained device elements keep them on the card.

Not ported yet: mesh mode, ``dispatch``/``complete`` (the in-flight
window), the persistent compile cache, reload and suspend/resume.
"""
from __future__ import annotations

import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..tensors.info import TensorsInfo
from ..utils.log import logger
from .base import Accelerator, FilterFramework, FilterProperties
from .registry import register_filter


def _device_for(accelerators: Sequence[Accelerator]) -> torch.device:
    """``cpu`` for an explicit opt-out (``false``, ``true:cpu``), else the
    first CUDA device; raises when CUDA is wanted and missing."""
    if accelerators and accelerators[0] in (Accelerator.CPU, Accelerator.NONE):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch-cuda filter: no CUDA device is available; pass "
            "accelerator=true:cpu (or false) to run on the CPU")
    return torch.device("cuda", 0)


def _as_tensor(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def load_model(model: str):
    """Resolve a ``zoo://`` URI or a ``.py`` file to ``(apply_fn, module,
    input_info, output_info)``."""
    if model.startswith("zoo://"):
        from ..models import zoo
        parsed = urllib.parse.urlparse(model)
        kwargs = {k: v[0] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        name = parsed.netloc or parsed.path.lstrip("/")
        return zoo.build(name, **kwargs)
    if model.endswith(".py"):
        ns: Dict[str, Any] = {}
        with open(model) as f:
            code = f.read()
        exec(compile(code, model, "exec"), ns)  # noqa: S102 - user script, like the jax backend
        if "get_model" not in ns:
            raise ValueError(f"{model}: must define get_model()")
        return ns["get_model"]()
    raise ValueError(f"torch-cuda backend cannot load model {model!r}")


@register_filter
class TorchCudaFilter(FilterFramework):
    """framework=torch-cuda. Distinct from the JAX package's TorchScript
    ``pytorch`` compat backend, which the port does not carry."""

    NAME = "torch-cuda"
    EXTENSIONS = ("zoo://", ".py")
    SUPPORTS_BATCH = True  # zoo apply fns take a leading batch dim

    def __init__(self):
        self._apply: Optional[Callable] = None
        self._module: Optional[torch.nn.Module] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self.device: Optional[torch.device] = None

    def open(self, props: FilterProperties) -> None:
        self.device = _device_for(props.accelerators)
        if self.device.type == "cuda":
            # full f32 in every f32 product, as the reference computes
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = props.model_files[0] if props.model_files else ""
        (self._apply, module,
         self._in_info, self._out_info) = load_model(model)
        self._module = module.to(self.device).eval()
        logger.info("torch-cuda filter opened model=%s on %s", model,
                    self.device)

    def close(self) -> None:
        self._apply = None
        self._module = None

    def get_model_info(self):
        return self._in_info, self._out_info

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        xs = [_as_tensor(x, self.device) for x in inputs]
        with torch.inference_mode():
            out = self._apply(self._module, *xs)
        if isinstance(out, (list, tuple)):
            return list(out)
        return [out]

