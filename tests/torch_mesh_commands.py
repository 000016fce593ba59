"""Mesh commands for tests/test_torch_parallel.py that a follower
imports by name (this module imports nothing of JAX: the followers run
without it)."""
import torch
import torch.distributed as dist

from nnstreamer_tpu_torch.parallel import world


def fail_on_rank(bad_rank, mesh):
    """Raise on ``bad_rank``; every other rank all-reduces over its
    ``model`` group, so the failed rank's partner waits on it."""
    if world.rank() == bad_rank:
        raise OverflowError(f"raised on rank {bad_rank}")
    x = torch.ones(2)
    dist.all_reduce(x, group=mesh.get_group("model"))
    return float(x[0])
