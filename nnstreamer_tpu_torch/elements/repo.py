"""tensor_reposink / tensor_reposrc — in-process repository enabling
pipeline cycles (recurrent topologies).

Port of ``nnstreamer_tpu/elements/repo.py`` (≙
gst/nnstreamer/elements/gsttensor_repo{,sink,src}.c): a global slot
table keyed by ``slot-index`` lets the back of a pipeline feed the front
without a pad link (LSTM/RNN scaffolds, tests/nnstreamer_repo_lstm).
Slots hold frames as they were rendered (card frames stay on the card);
the reposink's snapshot hook materializes them on the host
(checkpoint/state.py).
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Optional

from ..pipeline.element import SinkElement, SrcElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer
from ..tensors.caps import Caps


class _Slot:
    def __init__(self, capacity: int = 2):
        self.queue: Deque[Buffer] = collections.deque()
        self.cond = threading.Condition()
        self.capacity = capacity
        self.eos = False


class TensorRepo:
    """Global slot table (≙ GstTensorRepo hash + cond-vars)."""

    def __init__(self):
        self._slots: Dict[int, _Slot] = {}
        self._lock = threading.Lock()

    def slot(self, index: int) -> _Slot:
        with self._lock:
            if index not in self._slots:
                self._slots[index] = _Slot()
            return self._slots[index]

    def push(self, index: int, buf: Buffer) -> None:
        s = self.slot(index)
        with s.cond:
            while len(s.queue) >= s.capacity and not s.eos:
                s.cond.wait(timeout=0.1)
            s.queue.append(buf)
            s.cond.notify_all()

    def pop(self, index: int, timeout: Optional[float] = None) -> Optional[Buffer]:
        s = self.slot(index)
        with s.cond:
            while not s.queue:
                if s.eos:
                    return None
                if not s.cond.wait(timeout=timeout or 0.1) and timeout:
                    return None
            buf = s.queue.popleft()
            s.cond.notify_all()
            return buf

    def set_eos(self, index: int) -> None:
        s = self.slot(index)
        with s.cond:
            s.eos = True
            s.cond.notify_all()

    def reset(self) -> None:
        with self._lock:
            self._slots.clear()

    def snapshot_slot(self, index: int):
        """Coherent (queued buffers, eos) view of one slot for the
        checkpoint path (tensor_reposink's snapshot_state)."""
        s = self.slot(index)
        with s.cond:
            return list(s.queue), s.eos

    def restore_slot(self, index: int, bufs, eos: bool) -> None:
        s = self.slot(index)
        with s.cond:
            s.queue = collections.deque(bufs)
            s.eos = bool(eos)
            s.cond.notify_all()


GLOBAL_REPO = TensorRepo()


@register_element("tensor_reposink")
class TensorRepoSink(SinkElement):
    PROPS = {"slot-index": 0, "silent": True}
    # the writer owns the slot: one snapshot/restore site per cycle
    CHECKPOINTABLE = "the repo slot's queued frames + EOS flag"

    def render(self, buf: Buffer) -> None:
        GLOBAL_REPO.push(self.slot_index, buf)

    def on_eos(self) -> None:
        GLOBAL_REPO.set_eos(self.slot_index)
        super().on_eos()

    def snapshot_state(self, snap_dir):
        from ..checkpoint.state import dump_buffers
        bufs, eos = GLOBAL_REPO.snapshot_slot(self.slot_index)
        if not bufs and not eos:
            return None
        return {"queue": dump_buffers(bufs), "eos": eos}

    def restore_state(self, state, snap_dir):
        from ..checkpoint.state import load_buffers
        GLOBAL_REPO.restore_slot(self.slot_index,
                                 load_buffers(state["queue"]),
                                 state.get("eos", False))


@register_element("tensor_reposrc")
class TensorRepoSrc(SrcElement):
    PROPS = {"slot-index": 0, "caps": "", "silent": True}

    def negotiate_src_caps(self) -> Optional[Caps]:
        if not self.caps:
            raise ValueError(f"{self.name}: 'caps' property is required")
        return Caps(self.caps).fixate()

    def create(self) -> Optional[Buffer]:
        while not self._stop_evt.is_set():
            buf = GLOBAL_REPO.pop(self.slot_index, timeout=0.1)
            if buf is not None:
                return buf
            s = GLOBAL_REPO.slot(self.slot_index)
            if s.eos and not s.queue:
                return None
        return None
