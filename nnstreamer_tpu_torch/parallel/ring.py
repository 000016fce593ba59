"""Ring attention: exact causal attention with the sequence dim sharded
across a mesh axis.

Port of ``nnstreamer_tpu/parallel/ring.py``. Each rank holds one block of
Q/K/V along the sequence; K/V blocks rotate around the ring (a
point-to-point send to the next rank of the ``seq`` axis and a receive
from the previous one: ``dist.batch_isend_irecv`` over
``mesh.get_group("seq")``, where JAX has ``ppermute``) while a
flash-style online softmax accumulates the exact result — memory per
rank stays O(block²) instead of O(S²). The rotation is differentiable
(parallel/collectives.py), so a train step's backward runs the ring
the other way.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from . import world as _world
from .collectives import ring_shift
from .mesh import axis_size


def _block_attend(q, k, v, q_pos, k_pos, o, m, l):
    """One online-softmax accumulation step.

    q: [B,T,H,D]; k/v: [B,T,H,D]; *_pos: [T] global positions;
    carry o: [B,T,H,D] f32, m/l: [B,H,T] f32 running max / denominator.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = q_pos[None, None, :, None] >= k_pos[None, None, None, :]
    s = torch.where(mask, s, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # fully-masked rows keep m == -inf; guard exp against nan
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(mask, p, 0.0)
    alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention_local(q, k, v, mesh: DeviceMesh, axis_name: str):
    """Per-shard ring attention body (call through ``local_map``, or on
    local blocks inside a command).

    q/k/v: this rank's blocks [B, T, H, D]; the sequence axis is sharded
    over ``axis_name``. Returns the local output block [B, T, H, D].
    """
    group = mesh.get_group(axis_name)
    idx = mesh.get_local_rank(axis_name)
    n = axis_size(mesh, axis_name)
    b, t, h, d = q.shape
    q_pos = idx * t + torch.arange(t, device=q.device)
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), float("-inf"), device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    k_blk, v_blk, src = k, v, idx
    for step in range(n):
        k_pos = src * t + torch.arange(t, device=q.device)
        o, m, l = _block_attend(q, k_blk, v_blk, q_pos, k_pos, o, m, l)
        if step + 1 < n:
            # rotate: our block moves to the next rank; we receive the
            # previous rank's
            k_blk = ring_shift(k_blk, group, 1, tag=1)
            v_blk = ring_shift(v_blk, group, 1, tag=2)
            src = (src - 1) % n
    l = torch.where(l == 0.0, 1.0, l)  # rows with no visible keys
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _spec(mesh: DeviceMesh, data_axis: Optional[str], seq_axis: str,
          model_axis: Optional[str]):
    """Placements of [B, S, H, D]: B over data, S over seq, heads over
    model (axes the mesh lacks replicate)."""
    names = mesh.mesh_dim_names
    out = []
    for axis in names:
        if axis == seq_axis:
            out.append(Shard(1))
        elif axis == data_axis:
            out.append(Shard(0))
        elif axis == model_axis:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return out


def _sharded(body, q, k, v, mesh, data_axis, seq_axis, model_axis):
    """Place global q/k/v (rank 0's) on the mesh, run ``body`` on each
    rank's blocks through ``local_map``, and gather the whole output."""
    from .sharding import distribute
    spec = _spec(mesh, data_axis, seq_axis, model_axis)
    qd, kd, vd = (distribute(x, mesh, spec) for x in (q, k, v))
    fn = local_map(partial(body, mesh=mesh, axis_name=seq_axis),
                   out_placements=spec, in_placements=(spec, spec, spec),
                   device_mesh=mesh, redistribute_inputs=False)
    return fn(qd, kd, vd).full_tensor()


def ring_attention_sharded(q, k, v, mesh: DeviceMesh,
                           data_axis: Optional[str], seq_axis: str,
                           model_axis: Optional[str]):
    """Global [B,S,H,D] q/k/v (on rank 0) -> the global causal attention
    output, computed with B over data, S over seq and heads over model
    (a mesh command: every rank of the mesh runs its blocks)."""
    return _world.run(_sharded, ring_attention_local, q, k, v, mesh,
                      data_axis, seq_axis, model_axis)


def dense_reference(q, k, v):
    """Unsharded causal attention for correctness tests."""
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = pos[None, None, :, None] >= pos[None, None, None, :]
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
