"""Device-resident pipeline compiler: fuse element chains into one
CUDA graph.

Port of ``nnstreamer_tpu/fusion/``. After parse, before start, the
planner walks the graph, marks maximal runs of device-capable elements
(those whose :meth:`Element.device_fn` yields a pure program of torch
ops), and replaces each run's dataflow with a single
:class:`FusedSegment` whose body composes the member programs and runs
them as one captured CUDA graph per caps signature — so activations stay
on the card and a frame's run is one graph replay.

The per-element chain path stays intact: it is the opt-out
(``fuse=false`` pipeline prop, ``pipeline.fuse = False``) and the parity
oracle — a fused pipeline produces byte-identical tensors to the unfused
chain on the CPU (``tests/test_torch_fusion.py``).
"""
from .planner import (FusionCtx, FusionPlan, PlannedSegment,  # noqa: F401
                      fuse_pipeline, plan_fusion, static_veto)
from .segment import FusedSegment  # noqa: F401

__all__ = [
    "FusionCtx", "FusionPlan", "PlannedSegment", "FusedSegment",
    "fuse_pipeline", "plan_fusion", "static_veto",
]
