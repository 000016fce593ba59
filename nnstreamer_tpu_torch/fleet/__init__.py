"""Elastic fleet: autoscaler control plane, preemptible replicas, and
zero-downtime blue/green rollouts.

Port of ``nnstreamer_tpu/fleet/``. Replicas are subprocess serve
pipelines of the port (``python -m
nnstreamer_tpu_torch.fleet.replica_main``), each with its own CUDA
context, that are **preemptible by default** (SIGTERM → PreemptGuard →
snapshot → router drain settlement); scale-down *is* a preemption, and
an unexpected death resurrects from its own snapshot. The persistent
compile cache captures every recorded signature at open, so a spawn is
warm before it advertises readiness.
"""
from .autoscaler import (DRAINING, RESURRECTING, SERVING,  # noqa: F401
                         Autoscaler, AutoscalerConfig, live_autoscalers)
from .cache import CompileCache  # noqa: F401
from .cache import active as active_compile_cache  # noqa: F401
from .cache import deactivate as deactivate_compile_cache  # noqa: F401
from .cache import install as install_compile_cache  # noqa: F401
from .replica import ReplicaProcess, ReplicaSpec  # noqa: F401
from .rollout import BlueGreenRollout, rollout  # noqa: F401

__all__ = [
    "Autoscaler", "AutoscalerConfig",
    "SERVING", "DRAINING", "RESURRECTING",
    "live_autoscalers",
    "ReplicaProcess", "ReplicaSpec",
    "BlueGreenRollout", "rollout",
    "CompileCache", "install_compile_cache", "active_compile_cache",
    "deactivate_compile_cache",
]
