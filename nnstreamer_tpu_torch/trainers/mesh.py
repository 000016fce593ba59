"""The torch-cuda trainer's mesh mode: the commands every rank runs.

``tensor_trainer mesh=DxSxT rules=<table>`` (the JAX trainer's sharded
state, ``trainers/jax_trainer.py``): every rank of the mesh builds the
model-config's ``(loss_fn, module, optimizer)`` itself (the same file or
zoo URI), the module is placed on the mesh by the rule table with rank
0's weights (a ``model-load-path`` is read on rank 0 before placing: the
restore onto the sharded template), and the optimizer is made on each
rank over its placed parameters, so its moments are placed like the
parameters they mirror (parallel/train.py ``place_state``). A step is
one mesh command running parallel/train.py ``train_step``: the batch is
split over ``data`` when it divides the dp degree, each rank
differentiates ``loss_fn`` on its rows, the gradients are averaged over
its replica group, and each optimizer steps; the loss and accuracy come
back averaged. Saves and snapshots gather whole tensors on rank 0; a
resume scatters them back onto the placements.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..parallel import world
from ..parallel.collectives import all_mean
from ..parallel.mesh import replica_group, size
from ..parallel.sharding import broadcast_
from ..parallel.train import (TrainState, local_rows, place_state, scalar,
                              train_step)


class MeshTrainer:
    """The loss function and the train state of one rank."""

    def __init__(self, loss_fn, state: TrainState):
        self.loss_fn = loss_fn
        self.state = state


def open_trainer(cfg: str, load_path: str, rules, mesh) -> MeshTrainer:
    from .torch_cuda_trainer import load_trainer_config
    loss_fn, module, optimizer = load_trainer_config(cfg)
    if load_path and world.rank() == 0:
        from .checkpoint import restore_params
        restore_params(load_path, module)
    if isinstance(optimizer, torch.optim.Optimizer):
        # a ready optimizer was made over the unplaced parameters: make
        # one of its kind over the placed ones
        optimizer = functools.partial(type(optimizer), **optimizer.defaults)
    state = place_state(module, optimizer, mesh, rules)
    return world.keep(MeshTrainer(loss_fn, state), size(mesh))


def _batch_loss(params, batch, loss_fn):
    # the trainer config's loss_fn(params, inputs, labels) -> (loss, acc)
    # as parallel/train.py's loss_fn(params, batch)
    return loss_fn(params, *batch)


def step(mt: MeshTrainer, inputs, labels) -> Tuple[float, float]:
    """One optimizer step on the batch (parallel/train.py
    ``train_step``); (loss, accuracy) before it, averaged over the
    replicas."""
    _, (loss, acc) = train_step(
        mt.state, (list(inputs), list(labels)),
        functools.partial(_batch_loss, loss_fn=mt.loss_fn), has_aux=True)
    return float(loss), float(acc)


def evaluate(mt: MeshTrainer, inputs, labels) -> Tuple[float, float]:
    """The loss and accuracy of the current weights on a batch."""
    st = mt.state
    xs, ys = local_rows((list(inputs), list(labels)), st.mesh)
    with torch.no_grad(), implicit_replication():
        loss, acc = mt.loss_fn(st.params, xs, ys)
    group = replica_group(st.mesh)
    return (float(all_mean(scalar(loss), group)),
            float(all_mean(scalar(acc), group)))


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def gather_state(mt: MeshTrainer, with_opt: bool):
    """(the whole ``state_dict``, the optimizer's ``state_dict`` with
    whole tensors) — on every rank, rank 0's are the ones kept."""
    st = mt.state
    sd = {k: _whole(v).detach().to("cpu", copy=True)
          for k, v in st.params.state_dict().items()}
    opt = None
    if with_opt:
        raw = st.opt_state.state_dict()
        opt = {"param_groups": raw["param_groups"],
               "state": {i: {k: (_whole(v).detach().to("cpu", copy=True)
                                 if isinstance(v, torch.Tensor) else v)
                             for k, v in s.items()}
                         for i, s in raw["state"].items()}}
    return sd, opt


def restore_state(mt: MeshTrainer, sd: Dict[str, torch.Tensor],
                  opt: Optional[Dict]) -> None:
    """Load rank 0's whole weights (and optimizer state) back onto each
    rank's placements."""
    st = mt.state
    params = dict(st.params.named_parameters())
    params.update(dict(st.params.named_buffers()))
    names = sorted(sd)
    full = [sd[n].to(world.local_device()) for n in names]
    broadcast_(full, st.mesh)
    with torch.no_grad():
        for n, t in zip(names, full):
            _load_into(params[n], t)
    if opt is None:
        return
    st.opt_state.load_state_dict(opt)
    order = [p for g in st.opt_state.param_groups for p in g["params"]]
    for p in order:
        s = st.opt_state.state.get(p, {})
        for k, v in list(s.items()):
            if isinstance(v, torch.Tensor):
                # every tensor, the 0-dim step count too: a follower's
                # copy of the state arrived as empty placeholders
                v = v.to(world.local_device())
                broadcast_([v], st.mesh)
                if isinstance(p, DTensor) and v.dim() > 0:
                    v = distribute_tensor(v, p.device_mesh, p.placements,
                                          src_data_rank=None)
                s[k] = v


def _load_into(dst: torch.Tensor, full: torch.Tensor) -> None:
    if isinstance(dst, DTensor):
        dst.to_local().copy_(distribute_tensor(
            full, dst.device_mesh, dst.placements,
            src_data_rank=None).to_local())
    else:
        dst.copy_(full)
