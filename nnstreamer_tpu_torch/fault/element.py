"""tensor_fault — deterministic fault injection for chaos testing.

Port of ``nnstreamer_tpu/fault/element.py``. ``corrupt`` goes through
the host as in the JAX package: the first chunk comes back as a host
array with every byte inverted, whether it arrived on the card or not,
so the output bytes and the chunk's residency match the reference.
``kill-link`` targets the port's network elements (``tensor_query_client``,
``tensor_query_serversrc``, ``edgesink``, ``edgesrc``), each of which has
a ``kill_link()`` hook; a target without one raises as in the reference.

A passthrough element that injects failures into a live pipeline on a
seeded, reproducible schedule — the chaos harness's hand on the wheel::

    ... ! tensor_fault mode=transient every=5 on-error=retry ! ...

Modes:

* ``raise``      — raise RuntimeError (classified FATAL)
* ``transient``  — raise :class:`~..errors.FaultInjected`
                   (a TransientError: retry policies apply)
* ``delay``      — sleep ``delay-ms`` then pass the buffer through
* ``corrupt``    — invert the first chunk's bytes (shape/dtype intact:
                   caps stay valid, the VALUES are garbage)
* ``drop``       — swallow the buffer (counted in ``stats['dropped']``)
* ``kill-link``  — call ``kill_link()`` on the element named by
                   ``target`` (edgesrc/edgesink, query client,
                   serversrc): force-close its live
                   socket(s) mid-stream, then pass the buffer through.
                   The session layer's reconnect + resume must absorb
                   it with zero loss — that is the chaos assertion.

Firing: ``every=N`` fires on every Nth ``transform`` call (N>0), else
``probability=p`` fires per-call from a ``seed``-ed RNG — both replay
identically run to run. ``max-faults`` caps the total injected (-1 =
unlimited). ``stats['faults']`` counts injections, so a chaos test can
assert every injected fault is accounted for as retried/skipped/shed.

Note the every-N counter counts *calls*: when an ``on-error=retry``
policy re-runs the failed buffer, the retry is call N+1 and passes —
i.e. a transient fault heals on first retry, exactly the fault shape
retry policies exist for.
"""
from __future__ import annotations

import random
import time
from typing import Optional

import numpy as np
import torch

from ..pipeline.element import TransformElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from .errors import FaultInjected

_MODES = ("raise", "transient", "delay", "corrupt", "drop", "kill-link")


@register_element("tensor_fault")
class TensorFault(TransformElement):
    PROPS = {"mode": "transient",
             "every": 0,          # fire on every Nth call; 0 = use probability
             "probability": 0.0,  # per-call fire probability when every=0
             "seed": 0,           # RNG seed: schedules replay exactly
             "delay-ms": 10.0,    # sleep length for mode=delay
             "max-faults": -1,    # total injection cap; -1 = unlimited
             "target": ""}        # element whose link mode=kill-link kills

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._rng = random.Random(int(self.seed))
        self._calls = 0
        self.stats.update({"faults": 0, "passed": 0})

    def start(self) -> None:
        super().start()
        # a restart (on-error=restart) replays the schedule from zero —
        # the element is restart-safe BECAUSE its state is just this
        self._rng = random.Random(int(self.seed))
        self._calls = 0

    def _should_fire(self) -> bool:
        self._calls += 1
        mf = int(self.max_faults)
        if 0 <= mf <= self.stats["faults"]:
            return False
        every = int(self.every)
        if every > 0:
            return self._calls % every == 0
        p = float(self.probability)
        return p > 0 and self._rng.random() < p

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        if not self._should_fire():
            self.stats.inc("passed")
            return buf
        n = self.stats.inc("faults")
        mode = str(self.mode)
        if mode == "raise":
            raise RuntimeError(
                f"{self.name}: injected fatal fault #{n} "
                f"(call {self._calls})")
        if mode == "transient":
            raise FaultInjected(
                f"{self.name}: injected transient fault #{n} "
                f"(call {self._calls})")
        if mode == "delay":
            time.sleep(max(0.0, float(self.delay_ms)) / 1e3)
            return buf
        if mode == "corrupt":
            if not buf.chunks:
                return buf
            host = buf.chunks[0].host()
            if isinstance(host, torch.Tensor):
                # bfloat16 comes back as a CPU tensor (numpy has no bf16)
                host = host.clone()
                host.view(torch.uint8).bitwise_not_()
            else:
                host = np.array(host, copy=True)
                flat = host.view(np.uint8)
                flat ^= 0xFF  # every byte inverted: loud, shape-preserving
            out = buf.with_chunks([Chunk(host)] +
                                  list(buf.chunks[1:]))
            return out
        if mode == "drop":
            self.stats.inc("dropped")
            return None
        if mode == "kill-link":
            self._kill_target_link(n)
            return buf
        raise ValueError(f"{self.name}: unknown mode {mode!r} "
                         f"(expected one of {_MODES})")

    def _kill_target_link(self, n: int) -> None:
        """Sever the target element's live socket(s): the network-
        partition fault shape the session layer must absorb. The buffer
        in hand passes through — only the LINK dies, not the stream."""
        tname = str(self.target)
        el = (self.pipeline.elements.get(tname)
              if self.pipeline is not None else None)
        kill = getattr(el, "kill_link", None)
        if not callable(kill):
            raise ValueError(
                f"{self.name}: mode=kill-link needs target= naming an "
                f"element with a kill_link() hook (got {tname!r})")
        killed = kill()
        self.post_message("warning", fault=n, target=tname,
                          links_killed=killed,
                          detail="injected link kill")
