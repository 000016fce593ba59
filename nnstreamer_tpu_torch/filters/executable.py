"""One executable per input signature: a captured CUDA graph on the card,
the eager function on the CPU.

The counterpart of the JAX package's per-signature ``jax.jit``
executables (``filters/jax_backend.py`` ``_executable``,
``fusion/segment.py`` ``_compile``). An :class:`Executable` wraps a
function ``fn(tensors) -> tensors`` for one signature (each input's
shape and dtype, :func:`signature`):

* on the card its first call runs ``fn`` eagerly on the capture stream
  for that call's frame — the warm-up PyTorch asks for before a capture:
  lazy library set-up such as the attention kernel's
  ``cudaFuncSetAttribute`` and cuBLAS/cuDNN handles happens there —
  and then captures one run of ``fn`` into a ``torch.cuda.CUDAGraph``
  over static input tensors. Every later call copies its inputs into the
  static inputs on the caller's current stream (host data through
  pinned memory, ``non_blocking``), replays the graph and clones the
  outputs out of the graph's memory pool, so the next replay cannot
  overwrite a frame that is still held downstream. Nothing blocks the
  host. A capture that fails raises: there is no eager fallback on the
  card. Since the warm-up is the first frame's own run, a hand kernel
  runs, and counts, once a frame: eagerly for the first, by replay for
  the rest.
* on the CPU it is ``fn`` itself, run eagerly under
  ``torch.inference_mode()``; the CPU tests count it all the same.

A capture that fails — ``fn`` raising during the warm-up or the
capture, or a CUDA error ending it — leaves no stream capturing
(``capture_end`` runs before the error propagates) and no executable
behind: the caller makes a new one for the next try. The graphs of one
element share a :class:`GraphPool`, which holds the pool alive from
the first capture until ``Pipeline.stop`` releases it, so a failed
capture's blocks, and a restarted backend's, go back to that pool and
the next capture reuses them; without the hold, PyTorch's allocator
refuses a capture into a pool whose last graph is gone.

Captures use ``capture_error_mode="thread_local"``: other pipeline
threads (the fetcher's copy stream, a ``device=true`` source staging its
pool, another filter) go on making CUDA calls while one thread captures.
One capture runs at a time in the process, always on the device's one
capture stream: the allocator keys cached blocks, and cuBLAS its
workspace, by stream, so a fresh side stream per capture would leave a
workspace and a set of blocks behind on each of PyTorch's pooled
streams in turn (``tools/torch_capture_memory.py`` measures both).
cuDNN's autotuner stays off (the backend sets it), so the eager warm-up
and the captured graph pick the same algorithms and a replay equals an
eager run bit for bit.
"""
from __future__ import annotations

import collections
import threading
from typing import (Any, Callable, Counter, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..ops import _tally

_capture_lock = threading.Lock()
# device index -> the side stream every capture on that device runs on;
# made at the first capture, read and written under _capture_lock
_capture_streams: Dict[int, torch.cuda.Stream] = {}
# told the kind of every capture that completes (jitcheck's
# CompileEventMonitor counts them); read under _capture_lock
_capture_listeners: List[Callable[[str], None]] = []


def add_capture_listener(fn: Callable[[str], None]) -> None:
    """Call ``fn(event)`` after every CUDA-graph capture that completes:
    ``"graph_capture"`` for a graph of :func:`capture_in_place`,
    ``"pool_keeper_capture"`` for a :class:`GraphPool`'s keeper."""
    with _capture_lock:
        _capture_listeners.append(fn)


def remove_capture_listener(fn: Callable[[str], None]) -> None:
    with _capture_lock:
        if fn in _capture_listeners:
            _capture_listeners.remove(fn)


def _captured(event: str) -> None:
    """Tell the listeners; the caller holds ``_capture_lock``."""
    for fn in list(_capture_listeners):
        fn(event)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's capture stream; the caller holds ``_capture_lock``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(device)
    return stream


def _torch_dtype(x: Any) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, dtype=np.asarray(x).dtype)).dtype


def signature(inputs: Sequence[Any]) -> Tuple:
    """The cache key of a call: each input's shape and torch dtype."""
    return tuple((tuple(x.shape), str(_torch_dtype(x))) for x in inputs)


def _host_tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _as_list(out: Any) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (list, tuple)) else [out]


class GraphPool:
    """One CUDA-graph memory pool for the graphs of one element (a
    ``tensor_filter``, which hands it to each backend it opens, or a
    fused segment), kept across the element's ``stop()``/``start()`` so
    that a restart recaptures into the blocks the old graphs held. It is
    made without touching the card: the pool itself comes at the first
    :meth:`handle_for`, with a one-kernel keeper graph captured into it
    that holds the allocator's use count, so the pool survives a failed
    capture and a closed backend's graphs. :meth:`release` (at
    ``Pipeline.stop``) drops the keeper; the pool's memory then returns
    to PyTorch's allocator once the element's last graph is gone."""

    def __init__(self):
        self._handle: Optional[Any] = None
        self._keeper: Optional[torch.cuda.CUDAGraph] = None

    def handle_for(self, device: torch.device) -> Any:
        """The pool's handle, making the pool on ``device`` at the first
        call."""
        with _capture_lock:
            if self._keeper is None:
                handle = torch.cuda.graph_pool_handle()
                current = torch.cuda.current_stream(device)
                keeper = torch.cuda.CUDAGraph()
                side = _capture_stream(device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    keeper.capture_begin(pool=handle,
                                         capture_error_mode="thread_local")
                    torch.zeros(1, device=device)
                    keeper.capture_end()
                current.wait_stream(side)
                self._handle, self._keeper = handle, keeper
                _captured("pool_keeper_capture")
            return self._handle

    def release(self) -> None:
        """Drop the hold; the next :meth:`handle_for` makes a new pool.
        Under the capture lock, so no capture runs while the keeper
        graph is destroyed."""
        with _capture_lock:
            self._handle = self._keeper = None


def capture_in_place(fn: Callable[[], None], device: torch.device,
                     pool: Optional[Any] = None) -> torch.cuda.CUDAGraph:
    """Run ``fn`` once eagerly on the device's capture stream (the
    warm-up, and the work of the caller's first call), then capture one
    more run of it into a graph in ``pool`` and return the graph; the
    caller replays it on its current stream. :class:`Executable`
    captures through it, and so does the LLM backend, whose functions
    read and write only tensors it owns (its decode state)."""
    current = torch.cuda.current_stream(device)
    graph = torch.cuda.CUDAGraph()
    with _capture_lock:
        side = _capture_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side), torch.no_grad():
            fn()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is void; fn's error says why
                raise
            graph.capture_end()
        _captured("graph_capture")
    current.wait_stream(side)
    return graph


class Executable:
    """``fn`` for one input signature on ``device``; graphs of one element
    share the memory ``pool`` (their :meth:`GraphPool.handle_for`)."""

    def __init__(self, fn: Callable[[List[torch.Tensor]], Any],
                 device: torch.device, pool: Optional[Any] = None):
        self.fn = fn
        self.device = device
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: List[torch.Tensor] = []
        self.static_out: List[torch.Tensor] = []
        # hand-kernel launches inside the graph, counted at each replay
        self.tally: Counter = collections.Counter()

    def __call__(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        if self.device.type != "cuda":
            xs = [_host_tensor(x).to(self.device) for x in inputs]
            with torch.inference_mode():
                return _as_list(self.fn(xs))
        if self.graph is None:
            return self._capture(inputs)
        self._stage(inputs)
        self.graph.replay()
        _tally.replayed(self.tally)
        with torch.inference_mode():
            return [o.clone() for o in self.static_out]

    def _stage(self, inputs: Sequence[Any]) -> None:
        """Copy the call's inputs into the static inputs on the current
        stream; host data goes through pinned memory."""
        for dst, x in zip(self.static_in, inputs):
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                dst.copy_(x)
            else:
                dst.copy_(_host_tensor(x).pin_memory(), non_blocking=True)

    def _capture(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        """Run the first frame eagerly on the capture stream, capture the
        graph there, and return the first frame's outputs."""
        dev = self.device
        self.static_in = [torch.empty(tuple(x.shape), dtype=_torch_dtype(x),
                                      device=dev) for x in inputs]
        self._stage(inputs)
        runs: List[List[torch.Tensor]] = []

        def run() -> None:
            out = _as_list(self.fn(list(self.static_in)))
            # the eager run's outputs are cloned before the capture
            # begins: fn may hand back views of the static inputs
            runs.append(out if runs else [o.clone() for o in out])  # jitcheck: ok(collects the eager warm-up's outputs and the capture's static outputs, once each; a replay writes into those same static tensors)

        with torch.inference_mode(), _tally.recording() as tally:
            graph = capture_in_place(run, dev, self.pool)
        first, out = runs
        current = torch.cuda.current_stream(dev)
        for o in first:
            o.record_stream(current)  # made on the side stream, used here
        self.graph, self.static_out = graph, out
        self.tally = tally
        return first
