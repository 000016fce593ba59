"""The PyTorch/CUDA filter backend: the port's inference engine.

Counterpart of ``nnstreamer_tpu/filters/jax_backend.py``. A model resolves
to ``(apply_fn, module, input_info, output_info)``: ``module`` is an
``nn.Module`` holding the weights, moved once to the filter's device, and
``apply_fn(module, *inputs)`` runs one invoke under
``torch.inference_mode()``.

Execution follows the JAX backend's: one executable per input signature
(each input's shape and dtype), made at the signature's first call and
counted in ``compile_count``. On the card an executable is one captured
CUDA graph (filters/executable.py); all signatures of one backend share
one graph memory pool. On the CPU it is the eager function. An
executable enters the cache only once its first call (on the card: the
capture) succeeded, so a failed capture leaves no half-built entry and
the next frame of that signature tries afresh. The graphs capture into
the element's :class:`GraphPool` (``FilterProperties.graph_pool``),
which outlives the backend: ``close`` frees the module and the graphs
into PyTorch's allocator cache and the pool, so a ``stop()``/``start()``
(on-error=restart) re-opens the model into those same blocks and the
reserved device memory does not climb per restart. A backend opened
without a pool makes its own and releases it at ``close``. ``invoke``
runs a frame through its executable on the caller's current stream (the
filter's stream) without blocking the host: host inputs reach the
graph's static inputs through pinned memory, and the outputs are
clones the next replay cannot overwrite. ``dispatch`` does the same and
records a CUDA event; ``complete`` waits for that event, on the
element's completer thread. ``traceable_fn`` hands the eager
``apply(module, *xs)`` closure to the fusion compiler.

Model URIs accepted by the ``model`` property:
  * ``zoo://<name>?k=v&...`` — the port's model zoo (models/zoo.py),
    seeded random init;
  * ``<file>.py`` — a python module defining ``get_model()`` returning
    the same 4-tuple.

Device: ``cuda:0`` unless ``accelerator`` opts out (``false`` or
``true:cpu``). Asking for the card where CUDA is missing raises at open;
the backend never falls back to the CPU by itself. Outputs stay on the
filter's device, so chained device elements keep them on the card.

Not ported yet: mesh mode (``custom=mesh:...`` raises
:class:`~..pipeline.element.NotPortedError`), input donation, the
persistent compile cache, reload and suspend/resume.
"""
from __future__ import annotations

import threading
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..tensors.info import TensorsInfo
from ..utils.log import logger
from .base import (Accelerator, FilterFramework, FilterProperties,
                   parse_custom_properties)
from .executable import Executable, GraphPool, signature
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
    SUPPORTS_DISPATCH = True

    def __init__(self):
        self._apply: Optional[Callable] = None
        self._module: Optional[torch.nn.Module] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self.device: Optional[torch.device] = None
        self._executables: Dict[Tuple, Executable] = {}
        self._pool: Optional[GraphPool] = None
        self._own_pool = False
        # executables made, one per new input signature (≙ the JAX
        # backend's compile_count)
        self.compile_count = 0
        # dispatch runs on the chain thread while complete runs on the
        # completer: the cache and the capture sit under this lock
        self._lock = threading.Lock()

    def open(self, props: FilterProperties) -> None:
        if "mesh" in parse_custom_properties(props.custom_properties):
            from ..pipeline.element import NotPortedError
            raise NotPortedError(
                f"custom={props.custom_properties!r}: mesh mode is not "
                "ported yet")
        self.device = _device_for(props.accelerators)
        self._own_pool = props.graph_pool is None
        self._pool = GraphPool() if self._own_pool else props.graph_pool
        if self.device.type == "cuda":
            # full f32 in every f32 product, as the reference computes;
            # no cuDNN autotuning, so a graph replays what an eager run
            # computes
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.benchmark = False
        model = props.model_files[0] if props.model_files else ""
        (self._apply, module,
         self._in_info, self._out_info) = load_model(model)
        self._module = module.to(self.device).eval()
        logger.info("torch-cuda filter opened model=%s on %s", model,
                    self.device)

    def close(self) -> None:
        with self._lock:
            self._apply = None
            self._module = None
            self._executables.clear()
            if self._own_pool and self._pool is not None:
                self._pool.release()
            self._pool = None

    def get_model_info(self):
        return self._in_info, self._out_info

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        """Run one frame through its signature's executable; a new
        signature makes one (one compile) and keeps it once its first
        call succeeded."""
        sig = signature(inputs)
        with self._lock:
            exe = self._executables.get(sig)
            if exe is not None:
                return exe(inputs)
            pool = self._pool.handle_for(self.device) \
                if self.device.type == "cuda" else None
            apply_fn, module = self._apply, self._module
            exe = Executable(lambda xs: apply_fn(module, *xs), self.device,
                             pool)
            self.compile_count += 1
            outs = exe(inputs)
            self._executables[sig] = exe
            return outs

    # -- overlapped execution ---------------------------------------------
    def dispatch(self, inputs: Sequence[Any], donate: bool = False) -> Any:
        """Enqueue one frame through its executable and return ``(outputs,
        event)`` without waiting: the event is recorded on the filter's
        stream after the outputs' clone (None on the CPU, where the
        outputs are ready). ``donate`` is ignored: the port does not
        donate inputs."""
        outs = self.invoke(inputs)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return outs, done

    def complete(self, handle: Any) -> List[Any]:
        """Wait for a dispatched frame's event and return its outputs.
        Takes no lock: runs on the completer thread beside dispatch."""
        outs, done = handle
        if done is not None:
            done.synchronize()
        return list(outs)

    # -- fusion -----------------------------------------------------------
    def traceable_fn(self) -> Optional[Callable]:
        """The eager ``apply(module, *xs)`` closure over the loaded model,
        for a fused segment to compose into its program."""
        with self._lock:
            apply_fn, module = self._apply, self._module
        if apply_fn is None:
            return None

        def fn(*xs):
            return apply_fn(module, *xs)

        return fn
