"""Device-mesh construction helpers.

Port of ``nnstreamer_tpu/parallel/mesh.py``. A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the first
``dp*sp*tp`` ranks of the mesh world (parallel/world.py), with the axes
``("data", "seq", "model")``: ``data`` (batch; data-parallel gradients
are averaged over it), ``seq`` (sequence parallelism: ring attention
neighbours) and ``model`` (tensor parallelism). The factoring, the spec
grammar and the errors are the JAX package's.

Building a mesh is a command for every rank of the world (each one
makes the same process groups), so a follower finds the mesh a later
command names by its shape (:func:`cached_mesh`). Meshes are shared: a
serving filter and a colocated trainer declaring the same spec get the
same ``DeviceMesh`` object (one device pool, two workloads).

Besides the mesh itself, each mesh carries one more group a rank: the
ranks of its ``model`` coordinate across ``data`` x ``seq``
(:func:`replica_group`), over which data- and sequence-parallel
gradients are averaged.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import world as _world

AXES = ("data", "seq", "model")

_SHARED: Dict[Tuple[int, ...], DeviceMesh] = {}
_REPLICA_GROUPS: Dict[int, object] = {}
_MESH_GROUPS: Dict[int, object] = {}
_SHARED_LOCK = threading.Lock()


def set_host_devices(n: Optional[int]) -> None:
    """Run meshes on the host CPU with ``n`` devices, before the world
    starts (see :func:`.world.set_host_devices`)."""
    _world.set_host_devices(n)


def device_count(device: Optional[str] = None) -> int:
    return _world.pool_size(device)


def _size(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def make_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = AXES) -> DeviceMesh:
    """The mesh of the given logical shape over the first ranks of the
    pool; raises when the pool is too small, as the JAX package does.
    Meshes are immutable, so this is :func:`shared_mesh`."""
    if tuple(axis_names) != AXES:
        raise ValueError(f"mesh axes must be {AXES}, got {tuple(axis_names)}")
    return shared_mesh(shape)


def shared_mesh(dims: Sequence[int],
                device: Optional[str] = None) -> DeviceMesh:
    """The process-wide shared mesh of a logical shape on ``device``
    (``"cuda"`` or ``"cpu"``; default: the world's, see
    :func:`.world.device_type`), built on every rank of the world the
    first time it is asked for."""
    dims = tuple(int(d) for d in dims)
    n, have = _size(dims), device_count(device)
    if n > have:
        raise ValueError(f"mesh {dims} needs {n} devices, have {have}")
    if _world.in_command():
        return _build_shared(dims)
    w = _world.world(device)
    mesh = _SHARED.get(dims)
    if mesh is None:
        # every rank builds it: commands are serialised by the world's
        # lock, and _build_shared returns a mesh an earlier one built
        mesh = w.run(_build_shared, (dims,), {}, ranks=w.size)
    return mesh


def _build_shared(dims: Tuple[int, ...]) -> DeviceMesh:
    with _SHARED_LOCK:
        mesh = _SHARED.get(dims)
        if mesh is not None:
            return mesh
        n = _size(dims)
        mesh = DeviceMesh(_world.device_type(),
                          torch.arange(n).reshape(dims), mesh_dim_names=AXES)
        # the replica group of each model coordinate (every rank makes
        # every group, in the same order)
        ranks = torch.arange(n).reshape(dims).reshape(-1, dims[-1])
        me = _world.rank()
        group = dist.new_group(list(range(n)))
        if me < n:
            _MESH_GROUPS[id(mesh)] = group
        for col in range(dims[-1]):
            members = ranks[:, col].tolist()
            group = dist.new_group(members)
            if me in members:
                _REPLICA_GROUPS[id(mesh)] = group
        _SHARED[dims] = mesh
        return mesh


def replica_group(mesh: DeviceMesh):
    """This rank's group over ``data`` x ``seq`` (same ``model`` index)."""
    return _REPLICA_GROUPS.get(id(mesh))


def axis_size(mesh: DeviceMesh, axis: Optional[str]) -> int:
    """The size of ``axis`` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    if axis is None or axis not in names:
        return 1
    return int(mesh.mesh.shape[names.index(axis)])


def shape_of(mesh: DeviceMesh) -> Dict[str, int]:
    """``{"data": dp, "seq": sp, "model": tp}`` — ``dict(mesh.shape)``
    of the JAX package."""
    return dict(zip(mesh.mesh_dim_names, (int(d) for d in mesh.mesh.shape)))


def size(mesh: DeviceMesh) -> int:
    return int(mesh.mesh.numel())


def spec_dims(spec: str) -> Optional[Tuple[int, int, int]]:
    """Parse an explicit ``"DxSxT"`` spec into (dp, sp, tp) without
    touching devices; None for ``auto``/``true``/empty (device-count
    dependent) or anything unparseable."""
    if not spec or spec in ("auto", "true"):
        return None
    try:
        dims = [int(d) for d in str(spec).lower().split("x")]
    except ValueError:
        return None
    if not dims or any(d < 1 for d in dims):
        return None
    while len(dims) < 3:
        dims.append(1)
    return tuple(dims[:3])  # type: ignore[return-value]


def best_dims(n_devices: Optional[int] = None, model_parallel: int = 0,
              seq_parallel: int = 0) -> Tuple[int, int, int]:
    """Factor n into (data, seq, model): the model axis gets 2 when n is
    even, seq gets 2 when 4 | n, data takes the rest; explicit sizes
    override. Reads only the device count."""
    n = n_devices if n_devices is not None else device_count()
    if n < 1:
        raise ValueError(f"cannot factor {n} devices into a mesh")
    tp = model_parallel or (2 if n % 2 == 0 else 1)
    rest = n // tp
    sp = seq_parallel or (2 if rest % 2 == 0 and rest >= 2 else 1)
    dp = rest // sp
    if dp * sp * tp != n:
        raise ValueError(f"cannot factor {n} into dp*sp*tp = {dp}*{sp}*{tp}")
    return dp, sp, tp


def spec_dp(spec: str) -> int:
    """The data-parallel factor a spec declares: parsed statically for
    explicit specs (no device access — safe for lint/admission code);
    ``auto`` factors the pool's device count; anything empty or
    unparseable is 1 (no snapping, no sharding)."""
    dims = spec_dims(spec)
    if dims is not None:
        return dims[0]
    if spec in ("auto", "true"):
        try:
            return best_dims()[0]
        except Exception:  # noqa: BLE001 — no pool: degrade to unsharded
            return 1
    return 1


def mesh_from_spec(spec: str, device: Optional[str] = None) -> DeviceMesh:
    """Element-property mesh grammar: ``"2x2x2"`` -> (dp=2, sp=2, tp=2);
    missing trailing factors default to 1; ``"auto"``/``"true"`` factors
    every device of the pool via :func:`best_mesh`. ``device`` as
    :func:`shared_mesh`'s. Resolved meshes are shared (see the module
    docstring)."""
    if spec in ("auto", "true"):
        return shared_mesh(best_dims(device_count(device)), device)
    dims = spec_dims(spec)
    if dims is None:
        raise ValueError(f"unparseable mesh spec {spec!r} "
                         f"(want 'DxSxT', 'auto' or 'true')")
    return shared_mesh(dims, device)


def cached_mesh(dims: Sequence[int]) -> DeviceMesh:
    """A shared mesh by its shape, as a command's argument names it: a
    follower finds the one the world-wide build made."""
    dims = tuple(int(d) for d in dims)
    mesh = _SHARED.get(dims)
    if mesh is None:
        raise RuntimeError(f"mesh {dims} was never built on rank "
                           f"{_world.rank()}")
    return mesh


def clear_cached_meshes() -> None:
    """Forget every mesh (the world that made their groups is gone)."""
    with _SHARED_LOCK:
        _SHARED.clear()
        _REPLICA_GROUPS.clear()
        _MESH_GROUPS.clear()


def best_mesh(n_devices: Optional[int] = None, model_parallel: int = 0,
              seq_parallel: int = 0) -> DeviceMesh:
    """The shared mesh of :func:`best_dims`."""
    return shared_mesh(best_dims(n_devices, model_parallel, seq_parallel))


def factorization(mesh: DeviceMesh) -> Tuple[int, int, int]:
    return tuple(int(d) for d in mesh.mesh.shape)  # type: ignore
