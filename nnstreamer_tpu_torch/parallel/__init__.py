"""Distributed execution on ``torch.distributed``: the mesh world,
device meshes, sharding rules, ring and Ulysses attention, and the
sharded training step.

Port of ``nnstreamer_tpu/parallel/``. JAX's single-controller mesh is
kept: the process that builds a mesh is rank 0 and runs the pipeline,
follower processes (one per further device) run its mesh commands
(parallel/world.py). A mesh is a ``DeviceMesh`` over the axes
``("data", "seq", "model")`` (parallel/mesh.py), parameters are placed
by a rule table over the JAX package's parameter paths
(parallel/sharding.py), sequence parallelism is ring attention
(parallel/ring.py) or Ulysses all-to-all (parallel/ulysses.py), and
parallel/train.py runs the sharded step.
"""
from .mesh import best_mesh, make_mesh, set_host_devices
from .sharding import GPT_RULES, named_sharding_tree, pspec_tree

__all__ = ["make_mesh", "best_mesh", "set_host_devices", "pspec_tree",
           "named_sharding_tree", "GPT_RULES"]
