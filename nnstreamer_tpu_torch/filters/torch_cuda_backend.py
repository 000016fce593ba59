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

Events (``handle_event``, the counterpart of the JAX backend's):
``SUSPEND`` (from the element's ``suspend`` watchdog thread) waits for
the card to finish the work already queued, drops every executable and
only then takes the weights off the card; the first invoke after it
brings them back and captures afresh into the same graph pool
(``compile_count`` counts the recapture). ``RELOAD_MODEL`` builds the
new model beside the old one, which keeps serving until the swap; the
swap waits for the card as a suspend does and drops the executables.
Both work on copies: ``Module.to`` swaps the tensors of the module it is
called on, and a fused segment's program (``traceable_fn``) holds that
module, so a fused filter keeps serving the weights it was planned with,
on the card, across a suspend or a reload — as the JAX backend's
closure keeps the params it captured by value.

Input donation (``dispatch(donate=True)``) has nothing to reuse here:
a host input is staged into the captured graph's static input, which
every replay reuses, and the outputs are clones out of the graph's pool
(on the CPU there is no staging at all). The backend accepts the request
and says so once in an INFO log; no tensor handed to it is written.

The persistent compile cache (fleet/cache.py): with a cache installed
(``NNS_COMPILE_CACHE``, as the autoscaler's replicas inherit it) every
signature this model captures is recorded, and ``open`` captures every
recorded one — an eager run and a capture on zeros of that shape and
dtype, the same static-input signature a later frame replays — before
the element reports ready, counted in ``prewarmed``. A CUDA graph does
not outlive its process, so the cache keeps the signatures, not the
graphs.

Not ported yet: mesh mode (``custom=mesh:...`` raises
:class:`~..pipeline.element.NotPortedError`).
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..tensors.info import TensorsInfo
from ..utils.log import logger
from .base import (Accelerator, FilterEvent, FilterFramework,
                   FilterProperties, parse_custom_properties)
from .executable import Executable, GraphPool, signature
from .registry import register_filter


def device_for(accelerators: Sequence[Accelerator]) -> torch.device:
    """``cpu`` for an explicit opt-out (``false``, ``true:cpu``), else the
    first CUDA device; raises when CUDA is wanted and missing."""
    if accelerators and accelerators[0] in (Accelerator.CPU, Accelerator.NONE):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass "
            "accelerator=true:cpu (or false) to run on the CPU")
    return torch.device("cuda", 0)


def full_f32_numerics() -> None:
    """Full f32 in every f32 product on the card (no TF32 in matmuls or
    cuDNN convolutions) and f32 sums in every bf16 product (no bf16
    reduction of a split-K GEMM's partial sums), as the reference's XLA
    computes them, and no cuDNN autotuning, so a graph replays what an
    eager run computes. The flags are process-wide: every backend that
    runs a module on the card sets them at open, so no result depends on
    which filter opened first. They act on CUDA only, so setting them on
    the CPU is harmless."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False


def _moved(module: torch.nn.Module,
           device: torch.device) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers live on
    ``device``, leaving ``module`` and its tensors as they are."""
    memo: Dict[int, Any] = {}
    for p in module.parameters():
        memo[id(p)] = torch.nn.Parameter(p.detach().to(device),
                                         requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = b.to(device)
    return copy.deepcopy(module, memo)


DONATION_NOTE = (
    "donate-input: nothing to donate — on the card a host input is staged "
    "into the captured graph's static input, which every replay reuses, "
    "and the outputs are clones out of the graph's pool; on the CPU "
    "nothing is staged; no input is written")


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
    """framework=torch-cuda, the counterpart of the JAX package's ``jax``
    backend (TorchScript files go to ``pytorch``,
    filters/torch_backend.py)."""

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
        self._props: Optional[FilterProperties] = None
        # SUSPEND keeps the weights here, off the card, until the next
        # invoke; None otherwise
        self._host_module: Optional[torch.nn.Module] = None
        self._donation_noted = False
        # executables made, one per new input signature (≙ the JAX
        # backend's compile_count)
        self.compile_count = 0
        # signatures captured at open from the compile cache
        self.prewarmed = 0
        self._cache_key = ""
        # dispatch runs on the chain thread while complete runs on the
        # completer: the cache and the capture sit under this lock
        self._lock = threading.Lock()

    def open(self, props: FilterProperties) -> None:
        if "mesh" in parse_custom_properties(props.custom_properties):
            from ..pipeline.element import NotPortedError
            raise NotPortedError(
                f"custom={props.custom_properties!r}: mesh mode is not "
                "ported yet")
        self._props = props
        self.device = device_for(props.accelerators)
        self._own_pool = props.graph_pool is None
        self._pool = GraphPool() if self._own_pool else props.graph_pool
        full_f32_numerics()
        (self._apply, self._module,
         self._in_info, self._out_info) = self._load(props)
        logger.info("torch-cuda filter opened model=%s on %s",
                    props.model_files[:1], self.device)
        self._cache_key = props.model_files[0] if props.model_files else ""
        self._prewarm_from_cache()

    def _prewarm_from_cache(self) -> None:
        """Capture every signature this model captured in earlier lives
        (fleet/cache.py) before the first frame arrives — and before a
        serve pipeline REGISTERs on the broker — so a resurrected or
        scaled-up replica replays a graph on its first frame."""
        from ..fleet import cache as compile_cache

        def capture(xs) -> bool:
            if signature(xs) in self._executables:
                return False
            self.invoke(xs)
            return True

        self.prewarmed += compile_cache.prewarm(
            self.NAME, self._cache_key, capture, "torch-cuda filter")
        if self.prewarmed:
            logger.info("torch-cuda filter: prewarmed %d signature(s) for "
                        "%s", self.prewarmed, self._cache_key)

    def _load(self, props: FilterProperties):
        """``(apply_fn, module on the device, in_info, out_info)``."""
        model = props.model_files[0] if props.model_files else ""
        apply_fn, module, in_info, out_info = load_model(model)
        return apply_fn, module.to(self.device).eval(), in_info, out_info

    def close(self) -> None:
        with self._lock:
            self._apply = None
            self._module = self._host_module = None
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
            if self._host_module is not None:
                self._resume()
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
        from ..fleet import cache as compile_cache
        compile_cache.record_quietly(self.NAME, self._cache_key, sig,
                                     "torch-cuda filter")
        return outs

    # -- overlapped execution ---------------------------------------------
    def dispatch(self, inputs: Sequence[Any], donate: bool = False) -> Any:
        """Enqueue one frame through its executable and return ``(outputs,
        event)`` without waiting: the event is recorded on the filter's
        stream after the outputs' clone (None on the CPU, where the
        outputs are ready). ``donate`` has nothing to reuse (see the
        module's docstring): the first request logs why."""
        if donate and not self._donation_noted:
            self._donation_noted = True
            logger.info("torch-cuda filter on %s: %s", self.device,
                        DONATION_NOTE)
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
        for a fused segment to compose into its program. It holds the
        module it was made with: a later suspend or reload leaves that
        module, and so the fused program, as it is."""
        with self._lock:
            if self._host_module is not None:
                self._resume()
            apply_fn, module = self._apply, self._module
        if apply_fn is None:
            return None

        def fn(*xs):
            return apply_fn(module, *xs)

        return fn

    # -- events -----------------------------------------------------------
    def handle_event(self, event: FilterEvent, data=None) -> bool:
        if event == FilterEvent.CHECK_HW_AVAILABILITY:
            from ..utils.hw import is_available
            return is_available((data or {}).get("hw", "default"))
        if event == FilterEvent.RELOAD_MODEL:
            # keep serving the old model while the new one loads
            # (≙ is-updatable reload, nnstreamer_plugin_api_filter.h:359-365)
            props = self._props if not data else \
                dataclasses.replace(self._props, **data)
            fresh = self._load(props)
            with self._lock:
                self._settle()
                (self._apply, self._module,
                 self._in_info, self._out_info) = fresh
                self._host_module = None
                self._props = props
            return True
        if event == FilterEvent.SUSPEND:
            # (≙ suspend watchdog unload, tensor_filter.c:1078-1090)
            with self._lock:
                if self._module is not None:
                    self._settle()
                    self._host_module = _moved(self._module,
                                               torch.device("cpu"))
                    self._module = None
            return True
        if event == FilterEvent.RESUME:
            with self._lock:
                if self._host_module is not None:
                    self._resume()
            return True
        return False

    def _settle(self) -> None:
        """Wait for every replay already queued on the card, then drop
        the executables: a captured graph reads the weights at raw
        addresses, so none may replay once they move. The caller holds
        the lock and lets go of the old module after this."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._executables.clear()

    def _resume(self) -> None:
        """Bring suspended weights back onto the device; the next invoke
        of each signature captures afresh. The caller holds the lock."""
        self._module = _moved(self._host_module, self.device)
        self._host_module = None
