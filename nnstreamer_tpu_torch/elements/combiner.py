"""tensor_mux / tensor_merge / join — N-to-1 stream combiners with the
reference's time-sync engine.

Port of ``nnstreamer_tpu/elements/combiner.py`` (≙ gst/nnstreamer/
elements/gsttensor_mux.c, gsttensor_merge.c and the shared PTS algebra
in nnstreamer_plugin_api_impl.c:101-520, policies documented in
Documentation/synchronization-policies-at-mux-merge.md):

* nosync  — first-come collection, no PTS logic
* slowest — base = max of head PTS; older heads are consumed; each pad
            contributes whichever of {last, head} is closer to base
* basepad — base = designated pad's head PTS; other pads contribute their
            head only if within the option duration, else their last
* refresh — any arrival emits, absent pads reuse their last buffer

``tensor_mux`` and ``join`` pass chunk references along, so CUDA chunks
stay on the card; ``tensor_merge`` concatenates on the host, as the
reference does (its output chunk is a host array).
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..pipeline.element import Element, TransferError
from ..pipeline.events import CapsEvent, EosEvent, Event
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensors.types import TensorFormat

_MAX_QUEUED = 16


def pad_sort_key(name: str):
    """Natural order for request pads: sink_2 before sink_10."""
    base, _, idx = name.rpartition("_")
    return (base, int(idx)) if idx.isdigit() else (name, -1)


def host_concat(arrays: Sequence[Any], axis: int) -> Any:
    """Concatenate host arrays (``Chunk.host()`` results) on ``axis``;
    bfloat16 comes back from ``host()`` as a CPU tensor, which numpy
    cannot hold, so such a list is joined by torch."""
    if any(isinstance(a, torch.Tensor) for a in arrays):
        return torch.cat([torch.as_tensor(a) for a in arrays], dim=axis)
    return np.concatenate(arrays, axis=axis)


def host_stack(arrays: Sequence[Any]) -> Any:
    """Stack host arrays on a new outermost axis (see :func:`host_concat`)."""
    if any(isinstance(a, torch.Tensor) for a in arrays):
        return torch.stack([torch.as_tensor(a) for a in arrays])
    return np.stack(arrays)


def host_contiguous(a: Any) -> Any:
    """A contiguous copy-or-self of a host array or CPU tensor slice."""
    if isinstance(a, torch.Tensor):
        return a.contiguous()
    return np.ascontiguousarray(a)


class _PadState:
    __slots__ = ("queue", "last", "eos", "config")

    def __init__(self):
        self.queue: Deque[Buffer] = collections.deque()
        self.last: Optional[Buffer] = None
        self.eos = False
        self.config: Optional[TensorsConfig] = None


class _CollectBase(Element):
    """GstCollectPads analog: per-sink-pad queues + the 4 sync policies."""

    SINK_TEMPLATES = {"sink_%u": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    STRIPS_META = True  # combined output is a fresh buffer, N legs -> 1
    PROPS = {"sync-mode": "slowest", "sync-option": ""}

    # -- device placement (fusion compiler) --------------------------------
    # deliberately None: collection is stateful fan-in — per-pad queues
    # under a condition variable, PTS time-sync policies deciding WHICH
    # buffers pair up — so the pairing itself is host control flow. The
    # planner also rejects it structurally (N sink pads).
    DEVICE_FUSIBLE = None

    def device_veto(self) -> Optional[str]:
        return ("stateful N-to-1 collection (time-sync pairing is host "
                "control flow)")

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._states: Dict[str, _PadState] = {}
        self._lock = threading.Condition()
        self._sent_eos = False
        self._caps_sent = False

    def _state(self, pad: Pad) -> _PadState:
        if pad.name not in self._states:
            self._states[pad.name] = _PadState()
        return self._states[pad.name]

    def _pads_in_order(self) -> List[Pad]:
        return [p for _, p in sorted(self.sink_pads.items(),
                                     key=lambda kv: pad_sort_key(kv[0]))
                if p.is_linked]

    # -- events / caps ----------------------------------------------------
    def handle_event(self, pad: Pad, event: Event) -> None:
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            with self._lock:
                self._state(pad).config = event.caps.to_config()
                self._maybe_send_caps()
            return
        if isinstance(event, EosEvent):
            with self._lock:
                self._state(pad).eos = True
                self._drain()
            return
        pads = self._pads_in_order()
        if pads and pad is pads[0]:
            self.forward_event(event)  # segment/stream-start from first pad

    def _combined_config(self) -> Optional[TensorsConfig]:
        return self._combine_configs(
            [self._state(p).config for p in self._pads_in_order()])

    def _combine_configs(
            self, cfgs: List[TensorsConfig]) -> Optional[TensorsConfig]:
        """Pure N-config -> combined-config computation; shared by the
        runtime caps path and the static transfer."""
        raise NotImplementedError

    def static_transfer(self, in_caps):
        """Combine the per-leg declared configs (legs in pad order)."""
        cfgs = []
        for pname in sorted(in_caps, key=pad_sort_key):
            caps = in_caps[pname]
            if caps is None or caps.any or not caps.structures \
                    or not caps.is_fixed():
                return {"src": None}
            try:
                cfgs.append(caps.to_config())
            except ValueError as exc:
                raise TransferError(f"{self.name}: {exc}", pad=pname)
        if not cfgs:
            return {"src": None}
        cfg = self._combine_configs(cfgs)
        return {"src": Caps.from_config(cfg) if cfg is not None else None}

    def _maybe_send_caps(self) -> None:
        if self._caps_sent:
            return
        pads = self._pads_in_order()
        if not pads or any(self._state(p).config is None for p in pads):
            return
        cfg = self._combined_config()
        if cfg is not None:
            self._caps_sent = True
            self.set_src_caps(Caps.from_config(cfg))

    @staticmethod
    def _out_rate(configs: List[TensorsConfig]):
        """min numerator / min denominator, each independently
        (ref: old_numerator/old_denominator logic, :409-415)."""
        return (min(c.rate_n for c in configs),
                min(c.rate_d for c in configs))

    # -- dataflow ---------------------------------------------------------
    def chain(self, pad: Pad, item) -> None:
        if isinstance(item, Event):
            self.stats.inc("events")
            self.handle_event(pad, item)
            return
        # collection bypasses Element.chain, as in the reference: the
        # tracer and the per-buffer stats see the combined buffer at the
        # next element, not the legs here
        with self._lock:
            st = self._state(pad)
            while len(st.queue) >= _MAX_QUEUED and not self._sent_eos:
                # backpressure upstream thread; collection happens under
                # other pads' chains
                if not self._try_collect_locked():
                    self._lock.wait(timeout=0.1)
            st.queue.append(item)
            if self.sync_mode == "refresh":
                self._refresh_collect(pad)
            else:
                self._drain()
            self._lock.notify_all()

    def _drain(self) -> None:
        while self._try_collect_locked():
            pass
        self._check_eos()

    def _check_eos(self) -> None:
        if self._sent_eos:
            return
        pads = self._pads_in_order()
        if not pads:
            return
        if self.sync_mode == "refresh":
            done = all(self._state(p).eos and not self._state(p).queue
                       for p in pads)
        else:
            done = any(self._state(p).eos and not self._state(p).queue
                       for p in pads)
        if done:
            self._sent_eos = True
            self.forward_event(EosEvent())

    # -- policy engine ----------------------------------------------------
    def _try_collect_locked(self) -> bool:
        """One collection attempt; True if a buffer was pushed."""
        if self._sent_eos:
            return False
        pads = self._pads_in_order()
        if not pads:
            return False
        mode = self.sync_mode
        if mode == "nosync":
            return self._collect_nosync(pads)
        if mode in ("slowest", "basepad"):
            return self._collect_synced(pads, mode)
        return False  # refresh collects on arrival

    def _collect_nosync(self, pads) -> bool:
        sts = [self._state(p) for p in pads]
        if any(not st.queue for st in sts):
            return False
        bufs = [st.queue.popleft() for st in sts]
        pts = max((b.pts or 0) for b in bufs)
        self._emit(pads, bufs, pts)
        return True

    def _collect_synced(self, pads, mode) -> bool:
        sts = [self._state(p) for p in pads]
        # GstCollectPads gate: collection fires only when every live
        # (non-EOS) pad has queued data — collecting earlier would have
        # to abort halfway and lose the buffers it already consumed
        if any(not st.queue and not st.eos for st in sts):
            return False
        # pick current (base) timestamp
        if mode == "basepad":
            opt = (self.sync_option or "0").split(":")
            base_id = int(opt[0] or 0)
            if base_id >= len(sts):
                return False
            bst = sts[base_id]
            if not bst.queue:
                return False
            current = bst.queue[0].pts or 0
            # ≙ nnstreamer_plugin_api_impl.c:368-377 — the window is
            # MIN(duration, ABS(pts_delta)-1), assigned only once the base
            # pad has a previous buffer; before that it stays 0. The
            # delta term is clamped >= 0 (the reference leaves -1 for
            # equal consecutive PTS) so stale buffers can't wedge pads.
            duration = int(opt[1]) if len(opt) > 1 and opt[1] else None
            if bst.last is not None:
                delta_win = max(0, abs(current - (bst.last.pts or 0)) - 1)
                base_win = delta_win if duration is None \
                    else min(duration, delta_win)
            else:
                base_win = 0
        else:
            heads = [st.queue[0].pts or 0 for st in sts if st.queue]
            if not heads:
                return False
            current = max(heads)
            base_win = 0

        # per-pad buffer update (≙ _gst_tensor_time_sync_buffer_update),
        # two-phase: decide every pad's contribution by peeking, and only
        # commit (pop queues / advance .last) once the whole tuple is
        # known to be assemblable — an aborted collection must not
        # consume buffers, or tuples are silently lost
        chosen: List[Buffer] = []
        plans: List[tuple] = []  # (n_outdated_pops, take_head)
        for st in sts:
            q = st.queue
            k = 0
            while k < len(q) and (q[k].pts or 0) < current:
                k += 1
            last = q[k - 1] if k else st.last
            take = False
            if k < len(q):
                head = q[k]
                if mode == "slowest" and last is not None and \
                        abs(current - (last.pts or 0)) < \
                        abs(current - (head.pts or 0)):
                    pass  # keep last
                elif mode == "basepad" and last is not None and \
                        abs((head.pts or 0) - current) > base_win:
                    pass  # out of window: keep last
                else:
                    take = True
            elif not st.eos:
                return False  # need more data to decide
            buf = head if take else last
            if buf is None:
                return False
            plans.append((k, take))
            chosen.append(buf)
        for st, (k, take) in zip(sts, plans):
            for _ in range(k + (1 if take else 0)):
                st.last = st.queue.popleft()
        self._emit(pads, chosen, current)
        return True

    def _refresh_collect(self, pad: Pad) -> None:
        st = self._state(pad)
        if st.queue:
            st.last = st.queue.popleft()
        pads = self._pads_in_order()
        sts = [self._state(p) for p in pads]
        if any(s.last is None for s in sts):
            return
        self._emit(pads, [s.last for s in sts], st.last.pts or 0)

    # -- output -----------------------------------------------------------
    def _emit(self, pads, bufs: List[Buffer], pts) -> None:
        out = self._combine(pads, bufs)
        if out is not None:
            out.pts = pts
            self.srcpad.push(out)

    def _combine(self, pads, bufs: List[Buffer]) -> Optional[Buffer]:
        raise NotImplementedError


@register_element("tensor_mux")
class TensorMux(_CollectBase):
    """N tensor streams -> one stream whose num_tensors is the sum
    (≙ gsttensor_mux.c)."""

    def _combine_configs(self, cfgs) -> Optional[TensorsConfig]:
        info = TensorsInfo()
        fmt = TensorFormat.STATIC
        for c in cfgs:
            if c.format != TensorFormat.STATIC:
                fmt = TensorFormat.FLEXIBLE
            for i in c.info:
                info.append(i.copy())
        rn, rd = self._out_rate(cfgs)
        return TensorsConfig(info, fmt, rn, rd)

    def _combine(self, pads, bufs: List[Buffer]) -> Buffer:
        chunks = []
        for b in bufs:
            chunks.extend(b.chunks)
        return Buffer(chunks)


@register_element("tensor_merge")
class TensorMerge(_CollectBase):
    """N single-tensor streams -> one tensor concatenated along a chosen
    dim (≙ gsttensor_merge.c, mode=linear option=<ref dim index>). The
    legs are read on the host, as in the reference."""

    PROPS = {"mode": "linear", "option": "3"}

    def _np_axis(self, ndim: int) -> int:
        ref_dim = int(self.option or 0)
        if ref_dim >= ndim:
            # reference pads rank; concat on a new outermost axis
            return 0
        return ndim - 1 - ref_dim

    def _combine_configs(self, cfgs) -> Optional[TensorsConfig]:
        infos = [c.info[0] for c in cfgs]
        base = infos[0]
        ndim = max(len(i.shape) for i in infos)
        shapes = [list(i.shape) + [1] * (ndim - len(i.shape)) for i in infos]
        axis = self._np_axis(ndim)
        merged = list(shapes[0])
        merged[axis] = sum(s[axis] for s in shapes)
        for s in shapes[1:]:
            for d in range(ndim):
                if d != axis and s[d] != shapes[0][d]:
                    raise ValueError(
                        f"{self.name}: cannot merge shapes {shapes} on "
                        f"axis {axis}")
        info = TensorsInfo([TensorInfo(base.name, base.type, tuple(merged))])
        rn, rd = self._out_rate(cfgs)
        return TensorsConfig(info, TensorFormat.STATIC, rn, rd)

    def _combine(self, pads, bufs: List[Buffer]) -> Buffer:
        arrs = [b.chunks[0].host() for b in bufs]
        ndim = max(a.ndim for a in arrs)
        arrs = [a.reshape(tuple(a.shape) + (1,) * (ndim - a.ndim))
                for a in arrs]
        return Buffer([Chunk(host_concat(arrs, self._np_axis(ndim)))])


@register_element("join")
class Join(Element):
    """N-to-1 first-come forwarding, no synchronization
    (≙ gst/join/gstjoin.c)."""

    SINK_TEMPLATES = {"sink_%u": None}
    SRC_TEMPLATES = {"src": None}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._eos_pads: set = set()
        self._caps_done = False
        self._lock = threading.Lock()

    def handle_event(self, pad: Pad, event: Event) -> None:
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            with self._lock:
                if not self._caps_done:
                    self._caps_done = True
                    self.set_src_caps(event.caps)
            return
        if isinstance(event, EosEvent):
            with self._lock:
                self._eos_pads.add(pad.name)
                linked = [p.name for p in self.sink_pads.values()
                          if p.is_linked]
                done = all(n in self._eos_pads for n in linked)
            if done:
                self.forward_event(event)
            return

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        self.srcpad.push(buf)

    def static_transfer(self, in_caps):
        """First leg's caps when every known leg agrees; differing legs
        are unknown here."""
        known = [c for c in in_caps.values() if c is not None]
        if not known or any(c != known[0] for c in known[1:]):
            return {"src": None}
        return {"src": known[0]}
