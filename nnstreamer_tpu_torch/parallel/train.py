"""Sharded training step.

Port of ``nnstreamer_tpu/parallel/train.py``. The parameters live on the
mesh (parallel/sharding.py rules: a tensor a rule shards over ``model``
is a DTensor on ``mesh["model"]``), the batch is split over ``data``,
and one step — forward, ``backward()``, ``torch.optim`` — runs as one
mesh command on every rank. DTensor inserts the tensor-parallel
collectives in forward and backward; the data- and sequence-parallel
gradients are averaged over each rank's replica group (the ranks of
its ``model`` coordinate), where GSPMD inserts the psum.

The JAX optimizer is an optax transformation; here ``optimizer`` is a
picklable factory ``params -> torch.optim.Optimizer`` (e.g.
``functools.partial(torch.optim.AdamW, lr=1e-3)``), called on every
rank on its own placed parameters, so the moments are placed like the
parameters they mirror.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from . import world as _world
from .collectives import all_mean
from .mesh import AXES, replica_group, size
from .sharding import P, Rule, distribute, place_module, placements_for


@dataclasses.dataclass(eq=False)
class TrainState:
    params: Any                 # the model (an nn.Module), placed
    opt_state: Any              # the torch.optim optimizer
    step: int = 0
    mesh: Any = None


def place_state(params: torch.nn.Module, optimizer: Callable, mesh,
                rules: Sequence[Rule]) -> TrainState:
    """The train state of this rank (call inside a command): ``params``
    placed per the rules, in place, and the optimizer made over the
    placed parameters, so its moments are placed like them."""
    place_module(params, rules or [], mesh)
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params, optimizer(list(params.parameters())), 0, mesh)


def _create(params, optimizer, mesh, rules) -> TrainState:
    state = place_state(params, optimizer, mesh, rules)
    _world.keep(params, size(mesh))  # a later command may name it alone
    return _world.keep(state, size(mesh))


def create_train_state(params: torch.nn.Module,
                       optimizer: Callable[[Sequence[torch.nn.Parameter]],
                                           torch.optim.Optimizer],
                       mesh=None, rules: Optional[Sequence[Rule]] = None
                       ) -> TrainState:
    """The optimizer over ``params``; with a mesh, a copy of ``params``
    placed per the rules first, and the state kept on the mesh."""
    if mesh is None:
        for p in params.parameters():
            p.requires_grad_(True)
        return TrainState(params, optimizer(list(params.parameters())))
    return _world.run(_create, copy.deepcopy(params), optimizer, mesh,
                      list(rules or []))


def _average_grads(state: TrainState) -> None:
    # a plain (replicated) parameter used in a DTensor op gets its
    # gradient as a DTensor: make it whole and plain, as its moments are
    for p in state.params.parameters():
        if isinstance(p.grad, DTensor) and not isinstance(p, DTensor):
            p.grad = p.grad.full_tensor()
    group = replica_group(state.mesh)
    n = dist.get_world_size(group)
    if n == 1:
        return
    for p in state.params.parameters():
        if p.grad is None:
            continue
        g = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
        dist.all_reduce(g, group=group)
        g.div_(n)


def train_step(state: TrainState, batch, loss_fn: Callable,
               has_aux: bool = False) -> Tuple:
    """One step: ``loss_fn(params, batch)`` -> scalar (with ``has_aux``,
    ``(scalar, aux)``, ``aux`` a scalar such as an accuracy), its
    gradients, one optimizer step. ``batch`` is a tensor or a nested
    list or tuple of them, each split over ``data`` on a mesh. Returns
    ``(state, loss)`` (with ``has_aux``, ``(state, (loss, aux))``), both
    averaged over the replicas; ``state`` is updated in place."""
    if state.mesh is not None and not _world.in_command():
        return _world.run(train_step, state, batch, loss_fn,
                          has_aux=has_aux)
    if state.mesh is not None:
        batch = local_rows(batch, state.mesh)
    with implicit_replication():
        out = loss_fn(state.params, batch)
        loss, aux = out if has_aux else (out, None)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        state.opt_state.zero_grad(set_to_none=True)
        loss.backward()
        if state.mesh is not None:
            _average_grads(state)
        state.opt_state.step()
    state.step += 1
    loss = loss.detach()
    if state.mesh is not None:
        group = replica_group(state.mesh)
        loss = all_mean(loss, group)
        if has_aux:
            aux = all_mean(scalar(aux), group)
    return state, ((loss, aux) if has_aux else loss)


def make_train_step(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch)`` -> scalar. Returns ``(state, batch) ->
    (state, loss)``; the placement flows from the state's mesh, and the
    state holds the optimizer (torch steps in place, so there is nothing
    to donate). ``loss_fn`` is carried to the followers by reference: a
    module-level function or a ``functools.partial`` of one, never a
    lambda."""
    return functools.partial(train_step, loss_fn=loss_fn)


def local_rows(batch, mesh):
    """This rank's rows of each tensor of ``batch`` (a tensor or a
    nested list or tuple of them; call inside a command): a placed
    DTensor's local block, a host batch split over ``data``."""
    from .sharding import place_local
    if isinstance(batch, (list, tuple)):
        return type(batch)(local_rows(b, mesh) for b in batch)
    if isinstance(batch, DTensor):
        return batch.to_local()
    return place_local(batch, mesh).to_local()


def scalar(x) -> torch.Tensor:
    """A loss or metric as a whole f32 0-dim tensor."""
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return torch.as_tensor(x, dtype=torch.float32).detach().reshape(())


def _shard_batch(batch, mesh, spec):
    pl = placements_for(spec, None, batch.dim(), mesh.mesh_dim_names or AXES)
    placed = distribute(batch, mesh, pl)
    return _world.keep(placed, size(mesh))


def shard_batch(batch: torch.Tensor, mesh, spec: P):
    """Place a host batch onto the mesh (data/seq sharded per ``spec``)."""
    return _world.run(_shard_batch, batch, mesh, spec)
