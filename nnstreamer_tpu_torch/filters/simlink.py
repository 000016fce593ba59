"""framework=simlink — deterministic slow-link queueing model.

A copy of ``nnstreamer_tpu/filters/simlink.py``, which is framework
neutral (numpy and the host clock); ``mesh`` reads its data-parallel
degree with parallel/mesh.py ``spec_dp`` (``auto`` factors the pool's
device count, as JAX's factors its devices).

A filter backend that behaves, timing-wise, like a model served over a
remote-attached chip: every frame pays a link round trip (``rtt``) plus
a serial on-chip service time (``svc``). The compute itself is a
trivial deterministic affine map (``y = 2x + 1`` in the input dtype),
so sync and overlapped runs are byte-comparable.

It exists for the bench's ``async_overlap`` row and the overlap tests:
with it the queueing math is exact —

  * synchronous invoke:   fps ≈ 1 / (rtt + svc)      (≈ 1/RTT collapse)
  * K-frame window:       fps ≈ min(K / rtt, 1 / svc)

because :meth:`dispatch` returns immediately (the frame is "on the
link") and :meth:`complete` waits out THIS frame's absolute deadline
(RTT legs overlap across frames) then serializes ``svc`` on the
completer (the chip runs one program at a time). Doubling ``rtt``
mid-run via :func:`set_weather` leaves the windowed pipeline's
throughput at min(K/rtt, 1/svc) while the sync pipeline halves — the
weather-resilience verdict the bench row checks.

Custom properties (``custom=rtt:60,svc:5,fail-every:0``):
  * ``rtt``        link round trip per frame, ms (default 0)
  * ``svc``        serial service time per frame, ms (default 0)
  * ``svc-row``    serial service time PER BATCH ROW, ms (default 0) —
                   with it a stacked batch of R rows costs
                   ``svc + svc-row * ceil(R / dp)``
  * ``mesh``       a ``DxSxT`` spec whose data-parallel degree divides
                   the per-row service across simulated chips (default
                   dp=1): rows of one batch run dp-wide, so batch
                   service scales as ceil(R/dp)
  * ``fail-every`` raise on every Nth frame's completion (0 = never) —
                   chaos hook for breaker/shed accounting with frames
                   in flight
"""
from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence

import numpy as np

from ..tensors.info import TensorsInfo
from .base import (FilterFramework, FilterProperties,
                   parse_custom_properties as _parse_custom)
from .registry import register_filter

# live link weather, keyed by override scope (None = all simlink
# instances). Written only from the bench/test (API) thread via
# set_weather and read per frame — single-writer plain store.
_weather_rtt_ms: Optional[float] = None


def set_weather(rtt_ms: Optional[float]) -> None:
    """Override every simlink instance's RTT mid-run (None = back to
    each instance's configured value). The bench's weather-doubling
    knob."""
    global _weather_rtt_ms
    _weather_rtt_ms = None if rtt_ms is None else float(rtt_ms)


@register_filter
class SimLinkFilter(FilterFramework):
    """framework=simlink: remote-link timing model, deterministic math."""

    NAME = "simlink"
    SUPPORTS_BATCH = True
    SUPPORTS_DISPATCH = True

    def __init__(self):
        self._rtt_s = 0.0
        self._svc_s = 0.0
        self._svc_row_s = 0.0
        self._dp = 1
        self._fail_every = 0
        self._in_info: Optional[TensorsInfo] = None
        # frame counter for fail-every: dispatched from the chain
        # thread only, but a lock keeps it exact if a future caller
        # dispatches from several threads
        self._lock = threading.Lock()
        self._n = 0

    def open(self, props: FilterProperties) -> None:
        opts = _parse_custom(props.custom_properties)
        self._rtt_s = float(opts.get("rtt", 0.0)) / 1e3
        self._svc_s = float(opts.get("svc", 0.0)) / 1e3
        self._svc_row_s = float(opts.get("svc-row", 0.0)) / 1e3
        self._dp = 1
        if "mesh" in opts:
            from ..parallel.mesh import spec_dp
            self._dp = max(1, spec_dp(str(opts["mesh"])))
        self._fail_every = int(opts.get("fail-every", 0))
        self._in_info = props.input_info

    def set_input_info(self, info: TensorsInfo):
        # push-path negotiation: output mirrors the input exactly
        self._in_info = info
        return info

    def get_model_info(self):
        return self._in_info, self._in_info

    def _rtt(self) -> float:
        w = _weather_rtt_ms
        return self._rtt_s if w is None else w / 1e3

    @staticmethod
    def _compute(inputs: Sequence[Any]) -> List[Any]:
        # same-dtype affine map: wraps identically for integer dtypes on
        # every path, so sync/async byte parity is exact
        return [(np.asarray(x) * 2 + 1).astype(np.asarray(x).dtype)
                for x in inputs]

    def _svc(self, inputs: Sequence[Any]) -> float:
        """Per-frame service time: the flat ``svc`` plus the per-row
        cost with the rows of one stacked batch spread dp-wide —
        ``svc + svc-row * ceil(rows / dp)``, rows = leading dim."""
        svc = self._svc_s
        if self._svc_row_s > 0.0 and len(inputs):
            x = np.asarray(inputs[0])
            rows = int(x.shape[0]) if x.ndim else 1
            svc += self._svc_row_s * (-(-rows // self._dp))
        return svc

    def _tick(self) -> int:
        with self._lock:
            self._n += 1
            return self._n

    def _maybe_fail(self, n: int) -> None:
        if self._fail_every > 0 and n % self._fail_every == 0:
            raise RuntimeError(f"simlink: injected failure on frame {n}")

    # -- synchronous path: the full serial cost per frame -----------------
    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        n = self._tick()
        time.sleep(self._rtt() + self._svc(inputs))
        self._maybe_fail(n)
        return self._compute(inputs)

    # -- overlapped path --------------------------------------------------
    def dispatch(self, inputs: Sequence[Any], donate: bool = False) -> Any:
        """The frame goes "onto the link" and the chain thread returns:
        the handle carries the absolute arrival deadline, so RTT legs of
        consecutive in-flight frames overlap in wall time."""
        n = self._tick()
        return (list(inputs), time.monotonic() + self._rtt(), n)

    def complete(self, handle: Any) -> List[Any]:
        inputs, deadline, n = handle
        # wait out THIS frame's link deadline (overlapped across frames),
        # then pay the service time serially — the completer thread is
        # the stand-in for the chip running one program at a time
        left = deadline - time.monotonic()
        if left > 0:
            time.sleep(left)
        svc = self._svc(inputs)
        if svc > 0:
            time.sleep(svc)
        self._maybe_fail(n)
        return self._compute(inputs)
