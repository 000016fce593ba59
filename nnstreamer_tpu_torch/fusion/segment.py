"""FusedSegment: one element standing in for a run of device-capable
members, executing their composed ``device_fn`` programs as one CUDA
graph per caps signature.

Port of ``nnstreamer_tpu/fusion/segment.py``, whose segment runs one
cached ``jax.jit`` per caps signature. Here the composed program is an
:class:`~..filters.executable.Executable`: on the card one captured
CUDA graph per signature (all signatures of a segment share one graph
memory pool), on the CPU the eager composition. ``jit_misses`` counts
the executables made, ``jit_hits`` the frames that reused one.

Dataflow after rewiring (planner.apply_fusion): the upstream element
pushes into the segment's sink pad; the segment pushes one buffer per
input buffer from its src pad — member activations never leave the
device between stages, and a frame's whole run is one graph replay.

Caps negotiation is NOT re-implemented: the members' internal pad
links are left intact, so the segment replays the incoming CAPS event
through the head member's chain and lets the members' own
``on_sink_caps`` cascade settle it (the tail's src pad is unlinked, so
the cascade stops at the segment boundary).

The in-flight window: with a member's ``in-flight`` above 1 the segment
enqueues each frame's replay, records a CUDA event and hands the frame
to an :class:`~..elements.overlap.OverlapExecutor`, whose completer
waits for the event and pushes the outputs (``prefetch-host`` starting
their host copy). A completion error is latched and re-raised on the
next frame's chain, so ``Element.chain`` applies the segment's policy
on the chain thread.

Fault integration: the segment adopts the run's (uniform) ``on-error``
policy and the strongest member circuit-breaker settings. A failure in
the program — the capture, the eager warm-up before it, or a replay —
records on the breaker and re-raises, so ``Element.chain`` applies the
policy exactly as it would for a member; an open breaker sheds frames
with the filter's QosEvent retry-after convention. A ``restart`` drops
the executables and keeps the segment's graph pool, so the next frame
recaptures into the blocks the old graphs held; ``Pipeline.stop``
frees the pool (``teardown``), as it does a filter's.

With tracing on, each frame's host dispatch time (the executable's
lookup, input staging and the graph launch) is observed as the series
``fusion/<name>``, which the tracer folds into its fusion block.

The persistent compile cache (fleet/cache.py): each signature the
segment captures is recorded under its members' names, and ``start``
captures every recorded one on zeros before the first frame
(``jit_prewarmed``), as the JAX segment compiles them.

The mesh branch (after the JAX segment's): when the members run on a
device mesh (their backends' ``custom=mesh:``; the planner breaks runs
on a spec change, so they share one), each frame is one mesh command
(filters/torch_cuda_backend.py ``mesh_invoke``): the inputs are laid
out batch-major on the mesh once, every member runs on each rank's
rows back to back — the blocks stay on the mesh across the member
boundary, pinned batch-major — and the rows come back whole at the
segment's output. ``stats["devices"]`` is the mesh's size. It runs
eagerly (a mesh invoke is never captured) and prewarms nothing.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import torch

from ..fault.breaker import element_breaker, shed_frame
from ..filters.executable import Executable, GraphPool, signature
from ..pipeline.element import TransformElement
from ..pipeline.events import CapsEvent
from ..pipeline.pad import Pad
from ..tensors.buffer import Buffer, Chunk
from ..tensors.transfer import is_device_tensor, submit_fetch
from ..utils.log import logger


class FusedSegment(TransformElement):
    """Composite element executing fused member programs on the device.

    Constructed only by the fusion planner — it is deliberately not
    registered for launch strings (a launch string describes the
    *unfused* graph; fusion is a start-time placement decision).
    """

    ELEMENT_NAME = "fused_segment"
    SINK_TEMPLATES = {"sink": None}
    SRC_TEMPLATES = {"src": None}
    # stop()/start() drops only the executables; programs rebuild from
    # the bound member fns, so on-error=restart is lossless
    RESTART_SAFE = True
    IS_FUSED_SEGMENT = True

    def __init__(self, members: List, fns: List[Callable],
                 name: Optional[str] = None, **props):
        assert len(members) == len(fns) and members, "empty fused run"
        # the run has a uniform policy (planner breaks runs otherwise);
        # adopt it so chain-level error handling matches the members'
        props.setdefault("on-error", str(getattr(members[0], "on_error",
                                                 "fail")))
        super().__init__(name, **props)
        self.members = list(members)
        for m in self.members:
            m.fused_in = self.name
        self._fns = list(fns)
        # a member asking for prefetch-host meant "ship my output via
        # the coalescing fetcher"; mid-segment outputs no longer leave
        # the device, but the SEGMENT's output does — honor the intent
        # there
        self._prefetch = any(bool(getattr(m, "prefetch_host", False))
                             for m in members)
        # per-caps-signature executables; only the segment's streaming
        # thread touches it (one segment = one thread)
        self._programs: dict = {}
        # kept across restarts, freed by teardown (filters/executable.py)
        self._pool = GraphPool()
        self.stats.update(jit_hits=0, jit_misses=0, jit_prewarmed=0, shed=0,
                          breaker_opened=0, fused_elements=len(members))
        # strongest member breaker settings win; 0 threshold = no breaker
        # the run's mesh (uniform: the planner breaks runs on a spec
        # change) and the members' models kept on it; None per-card
        self._mesh = next(
            (getattr(m.fw, "mesh", None) for m in members
             if getattr(getattr(m, "fw", None), "mesh", None) is not None),
            None)
        self.stats["devices"] = int(self._mesh.mesh.numel()) \
            if self._mesh is not None else 1
        self._breaker = None
        self.breaker_threshold = max(
            (int(getattr(m, "breaker_threshold", 0) or 0) for m in members),
            default=0)
        resets = [float(getattr(m, "breaker_reset_ms", 0) or 0)
                  for m in members
                  if int(getattr(m, "breaker_threshold", 0) or 0) > 0]
        self.breaker_reset_ms = min(resets) if resets else 1000.0
        retries = [float(getattr(m, "breaker_retry_after_ms", 0) or 0)
                   for m in members]
        self.breaker_retry_after_ms = max(retries) if retries else 100.0
        # overlapped execution: the widest member window wins (the run
        # was device-capable end to end, so one window governs the fused
        # program); reorder stays on unless EVERY member opted out
        self.in_flight = max(
            (int(getattr(m, "in_flight", 1) or 1) for m in members),
            default=1)
        self.reorder = all(bool(getattr(m, "reorder", True))
                           for m in members)
        self.reorder_deadline_ms = max(
            (float(getattr(m, "reorder_deadline_ms", 1000.0) or 1000.0)
             for m in members), default=1000.0)
        self._overlap = None
        # completion errors are latched by the completer and re-raised
        # on the NEXT frame's chain; the completer sets the field and
        # the chain thread clears it, so the handoff sits under a lock
        self._err_lock = threading.Lock()
        self._pending_error: Optional[BaseException] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        super().start()
        self._breaker = element_breaker(self)
        self._overlap = None
        if int(self.in_flight) > 1:
            from ..elements.overlap import OverlapExecutor
            self._overlap = OverlapExecutor(
                int(self.in_flight),
                complete_cb=self._complete_frame,
                error_cb=self._complete_error,
                push_cb=self.push,
                name=self.name,
                reorder=bool(self.reorder),
                reorder_deadline_s=float(self.reorder_deadline_ms) / 1e3,
                devices=int(self.stats["devices"]))
        if self._mesh is None:
            self._prewarm_from_cache()

    def _cache_key(self) -> str:
        """Segment identity for the persistent compile cache: the
        member names (launch-string stable) — the same fused run in a
        resurrected replica maps to the same signature bucket."""
        return "+".join(m.name for m in self.members)

    def _prewarm_from_cache(self) -> None:
        """Capture (an eager run on zeros, then the graph) every
        signature this segment's earlier incarnations served, so the
        first real frame replays a graph (fleet/cache.py)."""
        from ..fleet import cache as compile_cache

        def capture(arrays) -> bool:
            device = self._device(arrays)
            key = (signature(arrays), str(device))
            if key in self._programs:
                return False
            exe = Executable(self._program, device,
                             self._pool.handle_for(device)
                             if device.type == "cuda" else None)
            exe(arrays)
            self._programs[key] = exe
            return True

        self.stats.inc("jit_prewarmed", compile_cache.prewarm(
            "fusion", self._cache_key(), capture, self.name))

    def _record_signature(self, sig) -> None:
        from ..fleet import cache as compile_cache
        compile_cache.record_quietly("fusion", self._cache_key(), sig,
                                     self.name)

    def stop(self) -> None:
        super().stop()
        if self._overlap is not None:
            self._overlap.flush()
            self._overlap.stop()
        # the graph pool stays: a restart recaptures into its blocks
        self._programs.clear()

    def teardown(self) -> None:
        """Free the graph pool the segment kept across restarts."""
        self._pool.release()

    # -- negotiation ------------------------------------------------------
    def on_sink_caps(self, pad: Pad, caps) -> None:
        """Replay the CAPS event through the members' own negotiation
        (their internal links are intact; the tail's unlinked src pad
        ends the cascade), then forward the tail's answer."""
        head, tail = self.members[0], self.members[-1]
        head.chain(head.sinkpad, CapsEvent(caps))
        out = None
        for p in tail.src_pads.values():
            if p.caps is not None:
                out = p.caps
                break
        if out is None:
            raise ValueError(
                f"{self.name}: member negotiation produced no caps for "
                f"{caps} (members: {[m.name for m in self.members]})")
        self.set_src_caps(out)

    # -- dataflow ---------------------------------------------------------
    def _device(self, arrays) -> torch.device:
        """Where the program runs: a member filter's device, else the
        card when an input already lives there, else the CPU."""
        for m in self.members:
            dev = getattr(getattr(m, "fw", None), "device", None)
            if dev is not None:
                return dev
        for a in arrays:
            if is_device_tensor(a):
                return a.device
        return torch.device("cpu")

    def _program(self, arrays):
        for fn in self._fns:
            arrays = fn(arrays)
        return arrays

    def _mesh_program(self, arrays):
        """One mesh command for the whole run (see the module docstring)."""
        from ..filters.torch_cuda_backend import mesh_inputs, mesh_invoke
        from ..parallel import world
        models = [m.fw.mesh_model for m in self.members]
        return world.run(mesh_invoke, models, mesh_inputs(arrays),
                         self._mesh)

    def do_chain(self, pad: Pad, buf: Buffer) -> None:
        if self._overlap is not None:
            # a completion error latched by the completer surfaces HERE,
            # one frame late, so Element.chain applies the segment's
            # policy on the chain thread (the failed frame itself was
            # already accounted dropped by _complete_error)
            with self._err_lock:
                err, self._pending_error = self._pending_error, None
            if err is not None:
                raise err
        if self._breaker is not None and not self._breaker.allow():
            shed_frame(self, buf)
            return
        arrays = [c.raw for c in buf.chunks]
        device = self._device(arrays)
        sig = (signature(arrays), str(device))
        t0 = time.perf_counter_ns()
        exe = self._programs.get(sig)
        if exe is None and self._mesh is not None:
            self.stats.inc("jit_misses")
            exe = self._mesh_program
        elif exe is None:
            self.stats.inc("jit_misses")
            exe = Executable(self._program, device,
                             self._pool.handle_for(device)
                             if device.type == "cuda" else None)
        else:
            self.stats.inc("jit_hits")
        if self._overlap is not None:
            t_disp = self._overlap.window.acquire()
            t0 = time.perf_counter_ns()  # the dispatch, not the wait
            try:
                outs = self._run(exe, arrays)
                self._observe_dispatch(t0)
                done = None
                if device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(device))
                if sig not in self._programs:
                    self._programs[sig] = exe
                    self._record_signature(sig[0])
                self._overlap.submit(buf, (outs, done), t_disp)
            except BaseException:
                # never strand the slot on a failed enqueue: the
                # completer will not see this frame
                self._overlap.window.release(t_disp)
                raise
            return
        outs = self._run(exe, arrays)
        self._observe_dispatch(t0)
        if sig not in self._programs:
            self._programs[sig] = exe
            self._record_signature(sig[0])
        if self._breaker is not None:
            self._breaker.record_success()
        self.push(buf.with_chunks(self._out_chunks(outs)))

    def _run(self, exe: Executable, arrays) -> List[torch.Tensor]:
        """One call of the program. A failure (the capture or its eager
        warm-up, or a replay) counts on the breaker, then
        Element.chain applies the segment's on-error policy — exactly the
        member path's fault flow. A failed capture leaves nothing in
        ``_programs``: the next frame captures afresh in the same pool."""
        try:
            return exe(arrays)
        except Exception:
            if self._breaker is not None:
                self._breaker.record_failure()
            raise

    def _observe_dispatch(self, t0: int) -> None:
        tracer = getattr(self.pipeline, "tracer", None)
        if tracer is not None:
            tracer.observe(f"fusion/{self.name}", time.perf_counter_ns() - t0)

    def _out_chunks(self, outs) -> List[Chunk]:
        if self._prefetch:
            outs = submit_fetch(outs)
        return [Chunk(o) for o in outs]

    # -- completer side (in-flight window) --------------------------------
    def _complete_frame(self, entry) -> Buffer:
        """Wait for one in-flight replay's event and wrap its outputs."""
        outs, done = entry.payload
        if done is not None:
            done.synchronize()
        if self._breaker is not None:
            self._breaker.record_success()
        return entry.buf.with_chunks(self._out_chunks(outs))

    def _complete_error(self, entry, exc: BaseException) -> None:
        """Per-frame accounting for a failure at completion, then latch
        the error for the chain thread to re-raise."""
        if self._breaker is not None:
            self._breaker.record_failure()
        self.stats.inc("dropped")
        logger.warning("%s: fused program failed at completion (frame "
                       "dropped): %s", self.name, exc)
        with self._err_lock:
            if self._pending_error is None:
                self._pending_error = exc

    def handle_event(self, pad: Pad, event) -> None:
        if self._overlap is not None:
            # serialized events must not overtake in-flight frames
            self._overlap.flush()
        super().handle_event(pad, event)

    def transfer_report(self) -> dict:
        """Window occupancy / overlap stats; {} when running
        synchronously."""
        return self._overlap.report() if self._overlap is not None else {}
