"""Partition rules: regex over a parameter's path -> a partition spec.

Port of ``nnstreamer_tpu/parallel/sharding.py``: a small rule table over
stable parameter names, placements derived per mesh. Rules reference
logical mesh axes by name; axes missing from a mesh drop out, so the
same rules serve one device, dp-only and full dp x sp x tp meshes.

Rules match the **JAX path string** of each parameter (``layers/0/wq``),
not torch's dotted name: :func:`jax_path` maps a port parameter to the
path the JAX package's tree has for it (ViT's flax names; the GPT, mlp
and toy models keep the JAX names), and the spec's dims to the port
tensor's dims (a flax ``Dense`` kernel is ``[in, out]``, the port's
weight ``[out, in]``), so ``rules:gpt`` gives the placements JAX gives.

A spec is a :class:`P` (a tuple: one mesh-axis name or None a dim of the
JAX tensor). :func:`placements_for` turns it into one placement a mesh
axis (``Shard(d)``/``Replicate()``) for the port's tensor.

Placed parameters live on the mesh's ``model`` axis: a parameter a rule
shards over ``model`` becomes a DTensor on the one-dimensional
``mesh["model"]`` (its local shard on each rank), the others stay plain
tensors, replicated on every rank. The data and sequence axes split the
batch and the sequence of the activations (each rank computes its own
block), so DTensor propagates only across the model axis — on torch
2.13 the sharding propagation of a forward over a three-dimensional
mesh costs minutes per new input signature (PERF.md), over one
dimension under a second.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from . import world as _world
from .mesh import AXES, axis_size

Rule = Tuple[str, Sequence[Optional[str]]]


class P(tuple):
    """A partition spec: one mesh-axis name (or None) a tensor dim,
    ``jax.sharding.PartitionSpec``'s shape; ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def __reduce__(self):
        return (P, tuple(self))


# Megatron-style TP for models/transformer.py param names:
# column-parallel in-projections, row-parallel out-projections.
GPT_RULES: List[Rule] = [
    (r"embed$", ("model", None)),     # vocab-sharded embedding
    (r"head$", (None, "model")),
    (r"\bw[qkv]$", (None, "model")),
    (r"\bwo$", ("model", None)),
    (r"\bw[13]$", (None, "model")),
    (r"\bw2$", ("model", None)),
    (r"ln.*|.*scale$|.*bias$", ()),   # norms: replicated
]


def rules_by_name(name: str) -> List[Rule]:
    """Named rule tables for element properties (``rules:gpt``)."""
    tables = {"gpt": GPT_RULES, "none": [], "": []}
    if name not in tables:
        raise ValueError(f"unknown sharding rule table {name!r} "
                         f"(have: {sorted(k for k in tables if k)})")
    return tables[name]


def spec_for(path: str, rules: Sequence[Rule],
             mesh_axes: Sequence[str]) -> P:
    for pattern, axes in rules:
        if re.search(pattern, path):
            return P(*(a if a in mesh_axes else None for a in axes))
    return P()  # default: replicate


# -- port names -> the JAX tree's paths --------------------------------------

_VIT_BLOCK = {"ln0": "LayerNorm_0", "ln1": "LayerNorm_1",
              "mlp_in": "Dense_0", "mlp_out": "Dense_1"}


def _vit_path(name: str) -> Tuple[str, Optional[Tuple]]:
    """A ViT parameter's flax path and its dim map (JAX dim -> port dim;
    None: the same layout)."""
    parts = name.split(".")
    leaf = parts[-1]
    if parts[0] == "pos_embed":
        return "params/pos_embed", None
    if parts[0] == "patch_embed":
        # kernel HWIO -> OIHW
        return (f"params/Conv_0/{'kernel' if leaf == 'weight' else 'bias'}",
                (2, 3, 1, 0) if leaf == "weight" else None)
    if parts[0] == "ln_f":
        return (f"params/LayerNorm_0/"
                f"{'scale' if leaf == 'weight' else 'bias'}"), None
    if parts[0] == "head":
        return (f"params/Dense_0/{'kernel' if leaf == 'weight' else 'bias'}",
                (1, 0) if leaf == "weight" else None)
    i, sub = parts[1], parts[2]
    pre = f"params/EncoderBlock_{i}"
    if sub in ("ln0", "ln1"):
        return (f"{pre}/{_VIT_BLOCK[sub]}/"
                f"{'scale' if leaf == 'weight' else 'bias'}"), None
    if sub in ("mlp_in", "mlp_out"):
        return (f"{pre}/{_VIT_BLOCK[sub]}/"
                f"{'kernel' if leaf == 'weight' else 'bias'}",
                (1, 0) if leaf == "weight" else None)
    proj = parts[3]  # attn.{query,key,value,out}
    path = f"{pre}/MultiHeadDotProductAttention_0/{proj}/"
    if leaf == "bias":
        # [H, Dh] (out: [d]) -> [H*Dh]
        return path + "bias", ((0, 0) if proj != "out" else None)
    # q/k/v kernel [d, H, Dh] -> weight [H*Dh, d]; out [H, Dh, d] ->
    # weight [d, H*Dh]
    return path + "kernel", ((1, 0, 0) if proj != "out" else (1, 1, 0))


def jax_path(module: torch.nn.Module, name: str) -> Tuple[str, Optional[Tuple]]:
    """The JAX tree's path of the port parameter ``name`` of ``module``
    and its dim map (None when the layout is the JAX one)."""
    from ..models.mobilenet import MobileNetV2
    from ..models.vit import ViT
    if isinstance(module, ViT):
        return _vit_path(name)
    path = name.replace(".", "/")
    if isinstance(module, MobileNetV2):
        stat = path.rsplit("/", 1)[-1] in ("mean", "var")
        return ("batch_stats/" if stat else "params/") + path, None
    return path, None


def _named_tensors(module: torch.nn.Module):
    yield from module.named_parameters()
    yield from module.named_buffers()


def pspec_tree(params: torch.nn.Module, rules: Sequence[Rule],
               mesh: DeviceMesh) -> Dict[str, P]:
    """``{JAX path: spec}`` for every parameter and buffer of
    ``params`` — JAX's ``pspec_tree``, flattened to its path strings."""
    axes = mesh.mesh_dim_names or AXES
    return {jax_path(params, n)[0]: spec_for(jax_path(params, n)[0],
                                             rules, axes)
            for n, _ in _named_tensors(params)}


def placements_for(spec: P, dim_map: Optional[Tuple], ndim: int,
                   axes: Sequence[str] = AXES) -> List[Any]:
    """One placement a mesh axis for a port tensor of ``ndim`` dims
    whose JAX counterpart has ``spec``."""
    out: List[Any] = []
    for axis in axes:
        pl: Any = Replicate()
        for d, entry in enumerate(spec):
            if entry == axis:
                td = dim_map[d] if dim_map is not None else d
                if td < ndim:
                    pl = Shard(td)
                break
        out.append(pl)
    return out


def placement_tree(params: torch.nn.Module, rules: Sequence[Rule],
                   mesh: DeviceMesh) -> Dict[str, List[Any]]:
    """``{port name: [placement on data, seq, model]}``."""
    axes = mesh.mesh_dim_names or AXES
    out = {}
    for n, t in _named_tensors(params):
        path, dim_map = jax_path(params, n)
        out[n] = placements_for(spec_for(path, rules, axes), dim_map,
                                t.dim(), axes)
    return out


named_sharding_tree = placement_tree


# -- placing parameters --------------------------------------------------------

def mesh_group(mesh: DeviceMesh):
    """The group of every rank of ``mesh`` (the default group when the
    mesh spans the world)."""
    from .mesh import _MESH_GROUPS
    return _MESH_GROUPS.get(id(mesh))


def broadcast_(tensors: Sequence[torch.Tensor], mesh: DeviceMesh) -> None:
    """Give every rank of the mesh rank 0's values of ``tensors``, one
    broadcast a dtype."""
    if axis_size(mesh, "data") * axis_size(mesh, "seq") * \
            axis_size(mesh, "model") == 1:
        return
    group = mesh_group(mesh)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.reshape(-1) for t in ts]) if len(ts) > 1 \
            else ts[0].reshape(-1).clone()
        # as bytes: gloo reduces no bf16, and a broadcast needs no type
        dist.broadcast(flat.view(torch.uint8), src=0, group=group)
        at = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[at:at + n].view(t.shape))
            at += n


def place_module(module: torch.nn.Module, rules: Sequence[Rule],
                 mesh: DeviceMesh) -> torch.nn.Module:
    """Place ``module`` on the mesh, in place (call inside a command):
    rank 0's values reach every rank, and a tensor a rule shards over
    ``model`` becomes a DTensor on ``mesh["model"]`` holding this rank's
    shard. Returns the module."""
    module = module.to(_world.local_device())
    with torch.no_grad():
        broadcast_([t.data for _, t in _named_tensors(module)], mesh)
    places = placement_tree(module, rules, mesh)
    model_axis = (mesh.mesh_dim_names or AXES).index("model")
    tp = axis_size(mesh, "model")
    sub = mesh["model"] if tp > 1 else None
    for name, pl in places.items():
        want = pl[model_axis]
        if sub is None or not isinstance(want, Shard):
            continue
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        t = getattr(mod, leaf)
        local = distribute_tensor(t.detach(), sub, [want],
                                  src_data_rank=None)
        if leaf in mod._parameters:
            mod._parameters[leaf] = torch.nn.Parameter(
                local, requires_grad=t.requires_grad)
        else:
            mod._buffers[leaf] = local
    module.mesh_placements = places
    return module


def _shard_params(module: torch.nn.Module, rules: Sequence[Rule],
                  mesh: DeviceMesh) -> torch.nn.Module:
    return _world.keep(place_module(module, rules, mesh),
                       int(mesh.mesh.numel()))


def shard_params(params: torch.nn.Module, rules: Sequence[Rule],
                 mesh: DeviceMesh) -> torch.nn.Module:
    """Place a copy of ``params`` on the mesh per the rules and keep it
    there (a mesh command; ``params`` itself is left as it is)."""
    import copy
    return _world.run(_shard_params, copy.deepcopy(params), list(rules), mesh)


# -- placing batches -----------------------------------------------------------

def batch_sharding(mesh: DeviceMesh, ndim: int, batch: int) -> List[Any]:
    """Batch-major layout for one stacked batch: dim 0 split over
    ``data`` when the batch divides the dp degree, replicated otherwise
    (an indivisible batch still runs — every rank sees all rows)."""
    ndp = axis_size(mesh, "data")
    pl: List[Any] = [Replicate() for _ in (mesh.mesh_dim_names or AXES)]
    if ndim > 0 and ndp > 1 and batch % ndp == 0:
        pl[(mesh.mesh_dim_names or AXES).index("data")] = Shard(0)
    return pl


def distribute(x: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Any]) -> DTensor:
    """Rank 0's ``x`` as a DTensor on ``mesh`` (call inside a command on
    every rank of the mesh): one broadcast over the mesh, then each rank
    keeps its block. (``distribute_tensor(..., src_data_rank=0)`` takes
    the data from the first rank of each mesh-dim group, which on a
    follower is an empty placeholder.)"""
    x = x.to(_world.local_device()).contiguous()
    broadcast_([x], mesh)
    return distribute_tensor(x, mesh, list(placements), src_data_rank=None)


def place_local(x: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """Place one input (rank 0's data) on the mesh batch-major (call
    inside a command): a DTensor on the whole mesh whose local tensor is
    this rank's block."""
    want = batch_sharding(mesh, x.dim(), x.shape[0] if x.dim() else 0)
    return distribute(x, mesh, want)


def _place_batch(arrays: Sequence[torch.Tensor],
                 mesh: DeviceMesh) -> List[DTensor]:
    n = int(mesh.mesh.numel())
    return [_world.keep(place_local(a, mesh), n) for a in arrays]


def is_placed(x: Any, mesh: DeviceMesh) -> bool:
    """True for an input already laid out batch-major on ``mesh``."""
    if not isinstance(x, DTensor) or x.device_mesh is not mesh:
        return False
    return list(x.placements) == batch_sharding(
        mesh, x.dim(), x.shape[0] if x.dim() else 0)


def place_batch(arrays: Sequence[Any], mesh: DeviceMesh) -> List[Any]:
    """Lay a stacked batch out on the mesh batch-major (a mesh command;
    dim 0 over ``data``). Arrays already placed so pass through
    untouched, so placing upstream of the filter costs nothing when the
    filter places again."""
    todo = [i for i, a in enumerate(arrays) if not is_placed(a, mesh)]
    if not todo:
        return list(arrays)
    host = [a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
            for a in (arrays[i] for i in todo)]
    placed = _world.run(_place_batch, host, mesh)
    out = list(arrays)
    for i, p in zip(todo, placed):
        out[i] = p
    return out


def gather_rows(local: torch.Tensor, mesh: DeviceMesh,
                sharded: bool) -> torch.Tensor:
    """The full batch from each rank's block of rows (all-gather over
    ``data``; a replicated batch is already whole)."""
    if isinstance(local, DTensor):
        local = local.full_tensor()
    if not sharded or axis_size(mesh, "data") == 1:
        return local
    group = mesh.get_group("data")
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=0)
