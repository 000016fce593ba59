"""Ulysses-style all-to-all sequence parallelism.

Port of ``nnstreamer_tpu/parallel/ulysses.py``, the second of the two
long-context schemes (the other is ring attention, parallel/ring.py):
instead of rotating K/V blocks around the ring, every rank swaps its
sequence shard for a HEAD shard with one all-to-all
(``dist.all_to_all_single`` over ``mesh.get_group("seq")``), computes
ordinary full-sequence attention over its head slice, and swaps back.
Two collectives per layer, each moving activations once, at the cost of
requiring heads % n == 0 (the local head count, after the model axis).

When to use which (both are exact):
  * ring    — heads < ranks, or ultra-long S where even one gathered
              head slice [B, S, H/n, D] exceeds the memory budget.
  * ulysses — plenty of heads, moderate S: fewer collectives.
"""
from __future__ import annotations

from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

from . import world as _world
from .collectives import all_to_all
from .mesh import axis_size
from .ring import _sharded, dense_reference


def ulysses_attention_local(q, k, v, mesh: DeviceMesh, axis_name: str):
    """Per-shard body (call through ``local_map``, or on local blocks
    inside a command).

    q/k/v: local sequence blocks [B, T, H, D] with S = n·T sharded over
    ``axis_name``; requires H % n == 0. Returns the local [B, T, H, D]
    output block.
    """
    group = mesh.get_group(axis_name)
    n = axis_size(mesh, axis_name)
    b, t, h, d = q.shape

    def seq_to_heads(x):
        # [B, T, H, D] -> keep H/n heads, gain the full sequence: chunk
        # j (head group j) goes to rank j; the received seq blocks come
        # in source-rank order (= global sequence order)
        x = x.reshape(b, t, n, h // n * d).movedim(2, 0)
        x = all_to_all(x, group)                 # [n, B, T, H/n*D]
        return x.movedim(0, 1).reshape(b, n * t, h // n, d)

    def heads_to_seq(x):
        # inverse: [B, n*T, H/n, D] -> [B, T, H, D]; chunk j (seq block
        # j) goes to rank j; head groups come back in source-rank order
        x = x.reshape(b, n, t, h // n * d).movedim(1, 0)
        x = all_to_all(x, group)                 # [n, B, T, H/n*D]
        return x.movedim(0, 2).reshape(b, t, h, d)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = dense_reference(qg, kg, vg)  # full-seq causal attn, H/n heads
    return heads_to_seq(out)


def check_heads(heads: int, mesh: DeviceMesh, seq_axis: str,
                model_axis: Optional[str]) -> None:
    """The local head count (heads over the model axis) must divide by
    the seq axis size."""
    n = axis_size(mesh, seq_axis)
    local_heads = heads // axis_size(mesh, model_axis)
    if local_heads == 0 or local_heads % n != 0:
        raise ValueError(
            f"ulysses: local head count {local_heads} (= {heads} "
            f"heads / model axis) not divisible by seq axis size {n}; "
            "use ring attention for this shape")


def ulysses_attention_sharded(q, k, v, mesh: DeviceMesh,
                              data_axis: Optional[str], seq_axis: str,
                              model_axis: Optional[str]):
    """Global [B,S,H,D] q/k/v (on rank 0) -> the global causal attention
    output; B over data, S over seq, heads over model (the signature of
    ring_attention_sharded, so callers switch schemes by name)."""
    check_heads(q.shape[2], mesh, seq_axis, model_axis)
    return _world.run(_sharded, ulysses_attention_local, q, k, v, mesh,
                      data_axis, seq_axis, model_axis)
