"""One executable per input signature: a captured CUDA graph on the card,
the eager function on the CPU.

The counterpart of the JAX package's per-signature ``jax.jit``
executables (``filters/jax_backend.py`` ``_executable``,
``fusion/segment.py`` ``_compile``). An :class:`Executable` wraps a
function ``fn(tensors) -> tensors`` for one signature (each input's
shape and dtype, :func:`signature`):

* on the card its first call runs ``fn`` eagerly on a side stream for
  that call's frame — the warm-up PyTorch asks for before a capture:
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

Captures use ``capture_error_mode="thread_local"``: other pipeline
threads (the fetcher's copy stream, a ``device=true`` source staging its
pool, another filter) go on making CUDA calls while one thread captures.
One capture runs at a time in the process. cuDNN's autotuner stays off
(the backend sets it), so the eager warm-up and the captured graph pick
the same algorithms and a replay equals an eager run bit for bit.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Counter, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _tally

_capture_lock = threading.Lock()


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


class Executable:
    """``fn`` for one input signature on ``device``; graphs of one owner
    share the memory ``pool`` (``torch.cuda.graph_pool_handle()``)."""

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
        """Run the first frame eagerly on a side stream, capture the
        graph there, and return the first frame's outputs."""
        dev = self.device
        self.static_in = [torch.empty(tuple(x.shape), dtype=_torch_dtype(x),
                                      device=dev) for x in inputs]
        self._stage(inputs)
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, torch.cuda.stream(side), torch.inference_mode():
            first = [o.clone()
                     for o in _as_list(self.fn(list(self.static_in)))]
            with _tally.recording() as tally:
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self.fn(list(self.static_in))
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is void; fn's error says why
                    raise
                graph.capture_end()
        current.wait_stream(side)
        for o in first:
            o.record_stream(current)  # made on the side stream, used here
        self.graph, self.static_out = graph, _as_list(out)
        self.tally = tally
        return first
