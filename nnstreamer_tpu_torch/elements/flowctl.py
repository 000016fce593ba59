"""tensor_if / tensor_rate — data-dependent flow control & QoS.

Port of ``nnstreamer_tpu/elements/flowctl.py`` (≙ gst/nnstreamer/
elements/gsttensor_if.c: condition on tensor values, then/else actions,
custom callbacks; gsttensor_rate.c: framerate control + throttling).

Both pass chunk references along, so CUDA chunks stay on the card.
``tensor_if`` reads its compared value on the host: a host sync for a
CUDA chunk (``A_VALUE`` copies the one element it compares,
``TENSOR_AVERAGE_VALUE`` the whole tensor, averaged by numpy as in the
reference). ``tensor_rate throttle=true`` sends a ``QosEvent`` upstream
when it drops, which an upstream ``tensor_filter`` answers by skipping
invokes.

Not ported: ``tensor_rate``'s ``snapshot_state``/``restore_state`` (the
checkpoint layer is not in the port).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..pipeline.element import Element, TransformElement
from ..pipeline.events import FlushEvent, QosEvent, SegmentEvent
from ..pipeline.pad import Pad, PadDirection
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig, TensorsInfo

# runtime-registered custom conditions (≙ nnstreamer_if_custom_register);
# the port keeps its own registry
_custom_conditions: Dict[str, Callable[[Buffer], bool]] = {}
_cc_lock = threading.Lock()


def register_if_condition(name: str, fn: Callable[[Buffer], bool]) -> None:
    with _cc_lock:
        _custom_conditions[name] = fn


def unregister_if_condition(name: str) -> None:
    with _cc_lock:
        _custom_conditions.pop(name, None)


_OPERATORS = {
    "EQ": lambda v, sv: v == sv[0],
    "NE": lambda v, sv: v != sv[0],
    "GT": lambda v, sv: v > sv[0],
    "GE": lambda v, sv: v >= sv[0],
    "LT": lambda v, sv: v < sv[0],
    "LE": lambda v, sv: v <= sv[0],
    "RANGE_INCLUSIVE": lambda v, sv: sv[0] <= v <= sv[1],
    "RANGE_EXCLUSIVE": lambda v, sv: sv[0] < v < sv[1],
    "NOT_IN_RANGE_INCLUSIVE": lambda v, sv: not (sv[0] <= v <= sv[1]),
    "NOT_IN_RANGE_EXCLUSIVE": lambda v, sv: not (sv[0] < v < sv[1]),
}


def _picked(cfg: TensorsConfig, option: str) -> TensorsConfig:
    picks = [int(i) for i in option.split(",")]
    return TensorsConfig(TensorsInfo(cfg.info[i].copy() for i in picks),
                         cfg.format, cfg.rate_n, cfg.rate_d)


@register_element("tensor_if")
class TensorIf(Element):
    """Condition-gated routing: ``then`` branch on src_0, ``else`` branch
    on src_1 (each action PASSTHROUGH | SKIP | TENSORPICK)."""

    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src_%u": "other/tensors"}
    PROPS = {
        "compared-value": "A_VALUE",        # A_VALUE | TENSOR_AVERAGE_VALUE | CUSTOM
        "compared-value-option": "",        # "d0:d1:d2:d3,n" | "n" | custom name
        "operator": "EQ",
        "supplied-value": "",               # "v" or "v1:v2" for ranges
        "then": "PASSTHROUGH",
        "then-option": "",
        "else": "SKIP",
        "else-option": "",
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._then_pad: Optional[Pad] = None
        self._else_pad: Optional[Pad] = None

    def _pads(self):
        if self._then_pad is None:
            self._then_pad = self.get_static_or_request_pad(
                "src_0", PadDirection.SRC)
            self._else_pad = self.get_static_or_request_pad(
                "src_1", PadDirection.SRC)
        return self._then_pad, self._else_pad

    def _branches(self):
        return (("src_0", getattr(self, "then"), self.then_option),
                ("src_1", getattr(self, "else"), self.else_option))

    # -- negotiation ------------------------------------------------------
    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        cfg = caps.to_config()
        then_pad, else_pad = self._pads()
        for p, (_, action, option) in zip((then_pad, else_pad),
                                          self._branches()):
            if not p.is_linked or action == "SKIP":
                continue
            out = _picked(cfg, option) \
                if action == "TENSORPICK" and option else cfg
            self.set_src_caps(Caps.from_config(out), pad=p)

    def static_transfer(self, in_caps):
        """Per-branch config: passthrough, or the TENSORPICK selection;
        SKIP branches carry nothing."""
        caps = in_caps.get("sink")
        cfg = caps.to_config() \
            if caps is not None and caps.is_fixed() else None
        out: dict = {}
        for pname, action, option in self._branches():
            if pname not in self.src_pads:
                continue
            if cfg is None or action == "SKIP":
                out[pname] = None
                continue
            sel = _picked(cfg, option) \
                if action == "TENSORPICK" and option else cfg
            out[pname] = Caps.from_config(sel)
        for pname in self.src_pads:
            out.setdefault(pname, None)
        return out

    # -- condition --------------------------------------------------------
    def _compared_value(self, buf: Buffer) -> float:
        cv = self.compared_value
        opt = self.compared_value_option
        if cv == "A_VALUE":
            # "d0:d1:...,n" — innermost-first element index + tensor id
            idx_str, _, tid_str = opt.partition(",")
            chunk = buf.chunks[int(tid_str or 0)]
            arr = chunk.raw if chunk.is_device else chunk.host()
            ref_idx = [int(i) for i in idx_str.split(":")] if idx_str else []
            ref_idx += [0] * (arr.ndim - len(ref_idx))
            np_idx = tuple(reversed(ref_idx[:arr.ndim]))
            # on the card: a copy of the one element compared
            value = arr[np_idx]
            return float(value.item() if isinstance(value, torch.Tensor)
                         else value)
        if cv == "TENSOR_AVERAGE_VALUE":
            host = buf.chunks[int(opt or 0)].host()
            if isinstance(host, torch.Tensor):  # bfloat16
                host = host.float().numpy()
            return float(np.mean(host))
        raise ValueError(f"{self.name}: unknown compared-value {cv!r}")

    def _evaluate(self, buf: Buffer) -> bool:
        if self.compared_value == "CUSTOM":
            with _cc_lock:
                fn = _custom_conditions.get(self.compared_value_option)
            if fn is None:
                raise ValueError(
                    f"{self.name}: no custom condition "
                    f"{self.compared_value_option!r} registered")
            return bool(fn(buf))
        v = self._compared_value(buf)
        sv = [float(x) for x in self.supplied_value.split(":") if x != ""]
        op = _OPERATORS.get(self.operator.upper())
        if op is None:
            raise ValueError(f"{self.name}: unknown operator {self.operator!r}")
        return op(v, sv)

    # -- dataflow ---------------------------------------------------------
    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        result = self._evaluate(buf)
        then_pad, else_pad = self._pads()
        _, action, option = self._branches()[0 if result else 1]
        out_pad = then_pad if result else else_pad
        if action == "SKIP" or not out_pad.is_linked:
            return
        if action == "TENSORPICK" and option:
            picks = [int(i) for i in option.split(",")]
            buf = buf.with_chunks([buf.chunks[i] for i in picks])
        out_pad.push(buf)


@register_element("tensor_rate")
class TensorRate(TransformElement):
    """PTS-based framerate conversion: drop early frames, duplicate the
    previous frame to fill gaps; in/out/dup/drop counters in ``stats``
    (≙ gsttensor_rate.c). ``throttle=true`` asks upstream, by one
    ``QosEvent`` per throttle episode, to space frames at the target
    period, so the dropped frames are never computed."""

    PROPS = {"framerate": "", "throttle": True, "silent": True}
    RESTART_SAFE = False  # restart loses the PTS schedule mid-stream

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._next_ts: Optional[int] = None
        self._prev: Optional[Buffer] = None
        self._throttling = False
        self._last_in_pts: Optional[int] = None
        self.stats.update({"in": 0, "out": 0, "dup": 0, "drop": 0})

    def _target(self):
        if not self.framerate:
            return None
        n, _, d = self.framerate.partition("/")
        return int(n), int(d or 1)

    def handle_event(self, pad, event) -> None:
        if isinstance(event, (SegmentEvent, FlushEvent)):
            # PTS discontinuity: mirror tensor_filter's reset — stale
            # _next_ts would drop every post-restart frame and a stuck
            # _throttling flag would suppress all future QoS events
            self._next_ts = None
            self._prev = None
            self._last_in_pts = None
            self._throttling = False
        super().handle_event(pad, event)

    def transform_caps(self, incaps: Caps) -> Optional[Caps]:
        tgt = self._target()
        if tgt is None:
            return incaps
        cfg = incaps.to_config()
        cfg = TensorsConfig(cfg.info, cfg.format, tgt[0], tgt[1])
        return Caps.from_config(cfg)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        tgt = self._target()
        self.stats.inc("in")
        if tgt is None or buf.pts is None:
            self.stats.inc("out")
            return buf
        period = int(1e9 * tgt[1] / tgt[0])
        if self._next_ts is None:
            self._next_ts = buf.pts
        in_delta = (buf.pts - self._last_in_pts
                    if self._last_in_pts is not None else None)
        self._last_in_pts = buf.pts
        if buf.pts < self._next_ts:
            self.stats.inc("drop")
            self._prev = buf
            if self.throttle and not self._throttling:
                # upstream is overproducing: proportion = target period /
                # observed inter-arrival spacing (> 1 when frames arrive
                # faster than they can be emitted)
                self._throttling = True
                prop = (period / in_delta) if in_delta and in_delta > 0 else 2.0
                self.send_upstream_event(QosEvent(
                    proportion=max(prop, 1.01),
                    period_ns=period, timestamp=buf.pts))
            return None
        if self._throttling and self.throttle:
            # back under budget: clear the throttle
            self._throttling = False
            self.send_upstream_event(QosEvent(proportion=1.0, period_ns=0,
                                              timestamp=buf.pts))
        # duplicate previous frame into any gap
        while self._prev is not None and buf.pts >= self._next_ts + period:
            dup = self._prev.with_chunks(self._prev.chunks)
            dup.pts, dup.duration = self._next_ts, period
            self.stats.add(dup=1, out=1)
            self.push(dup)
            self._next_ts += period
        out = buf.with_chunks(buf.chunks)
        out.pts, out.duration = self._next_ts, period
        self._next_ts += period
        self._prev = buf
        self.stats.inc("out")
        return out
