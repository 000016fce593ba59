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

**Mesh mode** (after the JAX backend's): ``custom=mesh:<dp>x<sp>x<tp>``
(or ``mesh:auto``) builds a parallel/mesh.py mesh over the mesh world's
ranks (parallel/world.py) on the device ``accelerator`` names, as a
per-card open does (the cards, or the host CPU's gloo ranks on an
explicit opt-out; no CUDA raises), opens the model on every rank and
places the weights by the ``rules:`` table (``gpt``: Megatron TP;
default: replicate; rank 0's weights reach every rank), and each invoke
is one mesh command: the batch (dim 0, when the input carries one
beyond the model's frame rank) is split over ``data`` as
parallel/sharding.py ``batch_sharding`` says (an indivisible batch is
replicated), each
rank runs the model on its rows, and the rows come back whole on rank
0. Inputs already placed on the mesh (``tensor_serve_src mesh=``) pass
through. A hand kernel inside the model (``ops/attention.py``) runs on
each rank's local tensors. A mesh invoke runs eagerly, without graph
capture: the command's collectives and DTensor's host-side dispatch
do not belong in a captured graph, and on one card (a world of one
rank) the invoke is the same kernels the captured line replays.
``mesh`` names the live mesh (None per-card), read by the fused
segment, the in-flight window and the tracer.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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
        # mesh mode: the DeviceMesh and the model kept on every rank
        self._mesh = None
        self.mesh_model: Optional["MeshModel"] = None
        self._mesh_suspended = False
        self._mesh_sigs: set = set()

    @property
    def module(self) -> Optional[torch.nn.Module]:
        """The open model (on the host while suspended; this rank's copy
        in mesh mode); None once closed."""
        if self.mesh_model is not None:
            return self.mesh_model.module
        return self._module if self._module is not None \
            else self._host_module

    # -- mesh mode ----------------------------------------------------------
    @property
    def mesh(self):
        """The live DeviceMesh in mesh mode (None per-card)."""
        return self._mesh

    def _open_mesh(self, props: FilterProperties, opts: Dict) -> None:
        from ..parallel import mesh as pmesh, sharding, world
        # the card unless the caller opts out; raises without CUDA
        device = device_for(props.accelerators)
        mesh = pmesh.mesh_from_spec(str(opts["mesh"]), device.type)
        rules = sharding.rules_by_name(str(opts.get("rules", "")))
        world.retain(device.type)
        try:
            self._props = props
            self.device = world.local_device()
            full_f32_numerics()
            model = props.model_files[0] if props.model_files else ""
            self.mesh_model = world.run(open_on_mesh, model, rules, mesh)
        except BaseException:
            world.release()
            raise
        self._mesh = mesh
        self._in_info = self.mesh_model.in_info
        self._out_info = self.mesh_model.out_info
        self._apply = self.mesh_model.apply
        self._cache_key = ""
        logger.info("torch-cuda filter opened model=%s on mesh %s",
                    props.model_files[:1], pmesh.shape_of(mesh))

    def _mesh_call(self, inputs: Sequence[Any]) -> List[Any]:
        from ..parallel import world
        inputs = mesh_inputs(inputs)
        sig = signature(inputs)
        with self._lock:
            if sig not in self._mesh_sigs:
                self._mesh_sigs.add(sig)  # eager: counted, not captured
                self.compile_count += 1
            if self._mesh_suspended:
                world.run(move_mesh_model, self.mesh_model, False)
                self._mesh_suspended = False
            return world.run(mesh_invoke, [self.mesh_model], inputs,
                             self._mesh)

    def open(self, props: FilterProperties) -> None:
        opts = parse_custom_properties(props.custom_properties)
        if "mesh" in opts:
            self._open_mesh(props, opts)
            return
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
        if self._mesh is not None:
            from ..parallel import world
            with self._lock:
                self.mesh_model = None
                self._mesh = None
                self._apply = None
                self._mesh_sigs.clear()
            world.release()
            return
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
        if self._mesh is not None:
            return self._mesh_call(inputs)
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
        module, and so the fused program, as it is. In mesh mode: the
        model's apply on this rank's local tensors (the fused segment's
        mesh branch runs it inside its command)."""
        if self._mesh is not None:
            return self.mesh_model.local_fn()
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
        if self._mesh is not None and event in (
                FilterEvent.SUSPEND, FilterEvent.RESUME,
                FilterEvent.RELOAD_MODEL):
            return self._mesh_event(event, data)
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

    def _mesh_event(self, event: FilterEvent, data) -> bool:
        """Suspend takes each rank's weights to the host, keeping their
        placement; the next invoke (or RESUME) brings them back. A
        reload opens the new model on the mesh beside the old one."""
        from ..parallel import sharding, world
        if event == FilterEvent.RELOAD_MODEL:
            props = self._props if not data else \
                dataclasses.replace(self._props, **data)
            opts = parse_custom_properties(props.custom_properties)
            rules = sharding.rules_by_name(str(opts.get("rules", "")))
            model = props.model_files[0] if props.model_files else ""
            fresh = world.run(open_on_mesh, model, rules, self._mesh)
            with self._lock:
                self.mesh_model = fresh
                self._in_info, self._out_info = fresh.in_info, fresh.out_info
                self._props = props
                self._mesh_suspended = False
            return True
        with self._lock:
            want = event == FilterEvent.SUSPEND
            if want != self._mesh_suspended:
                world.run(move_mesh_model, self.mesh_model, want)
                self._mesh_suspended = want
        return True

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


# -- mesh mode: the commands every rank runs (parallel/world.py) --------------

class MeshModel:
    """A model opened on every rank of a mesh: the apply function, the
    placed module and the model's tensor infos (rank 0's copy is the
    one the backend holds; each follower keeps its own)."""

    def __init__(self, apply_fn, module, in_info, out_info, mesh):
        self.apply = apply_fn
        self.module = module
        self.in_info = in_info
        self.out_info = out_info
        self.mesh = mesh

    def batched(self, i: int, x) -> bool:
        """Whether input ``i`` carries a batch dim beyond the frame."""
        if self.in_info is None or i >= len(self.in_info):
            return True
        return x.dim() > len(self.in_info[i].shape)

    def local_fn(self):
        apply_fn, module = self.apply, self.module

        def fn(*xs):
            return apply_fn(module, *xs)

        return fn


def mesh_inputs(inputs: Sequence[Any]) -> List[Any]:
    """Host arrays as tensors (a command carries a tensor's shape, and
    the command places rank 0's data); tensors as they are."""
    return [x if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.ascontiguousarray(x)) for x in inputs]


def open_on_mesh(model: str, rules, mesh) -> MeshModel:
    """Open ``model`` on this rank and place it on ``mesh`` (rank 0's
    weights; a follower's own draws are overwritten)."""
    from ..parallel import world
    from ..parallel.sharding import place_module
    apply_fn, module, in_info, out_info = load_model(model)
    module = place_module(module.eval(), rules, mesh)
    mm = MeshModel(apply_fn, module, in_info, out_info, mesh)
    return world.keep(mm, int(mesh.mesh.numel()))


def move_mesh_model(mm: MeshModel, to_host: bool) -> None:
    """Take each rank's weights to the host (SUSPEND) or back."""
    from ..parallel import world
    dev = torch.device("cpu") if to_host else world.local_device()
    mm.module = mm.module.to(dev)


def _place_inputs(mm: MeshModel, inputs, mesh):
    """This rank's block of each input and whether rows were split."""
    from torch.distributed.tensor import Replicate, Shard
    from ..parallel.sharding import distribute, is_placed, place_local
    xs, split = [], False
    for i, x in enumerate(inputs):
        if is_placed(x, mesh):
            d = x
        elif mm.batched(i, x):
            d = place_local(x, mesh)
        else:
            d = distribute(x, mesh, [Replicate()] * mesh.ndim)
        xs.append(d.to_local())
        split = split or any(isinstance(p, Shard) for p in d.placements)
    return xs, split


def mesh_invoke(models: Sequence[MeshModel], inputs, mesh) -> List[Any]:
    """One (fused) invoke on every rank: place the inputs, run each
    model on this rank's rows (a fused run's members back to back, the
    blocks staying batch-major on the mesh between them), gather the
    rows whole."""
    from torch.distributed.tensor.experimental import implicit_replication
    from ..parallel.sharding import gather_rows
    xs, split = _place_inputs(models[0], inputs, mesh)
    with torch.no_grad(), implicit_replication():
        for mm in models:
            outs = mm.apply(mm.module, *xs)
            xs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        return [gather_rows(o, mesh, split) for o in xs]
