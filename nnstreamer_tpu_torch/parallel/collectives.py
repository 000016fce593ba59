"""Differentiable collectives over one mesh axis.

The JAX package's ``ppermute`` and ``all_to_all`` carry their own
transposes, so ``jax.grad`` flows through ring and Ulysses attention.
``torch.distributed``'s point-to-point and all-to-all calls do not, so
these wrap them in :class:`torch.autograd.Function`\\ s whose backward is
the transpose: a ring shift by ``-step``, and the same all-to-all.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _shift_raw(x: torch.Tensor, group, step: int, tag: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1 or step % n == 0:
        return x
    me = dist.get_rank(group)
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    x = x.contiguous()
    buf = torch.empty_like(x)
    reqs = dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, x, to, group, tag),
         dist.P2POp(dist.irecv, buf, frm, group, tag)])
    for r in reqs:
        r.wait()
    return buf


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step, tag):
        ctx.group, ctx.step, ctx.tag = group, step, tag
        return _shift_raw(x, group, step, tag)

    @staticmethod
    def backward(ctx, grad):
        return _shift_raw(grad, ctx.group, -ctx.step, ctx.tag), None, None, \
            None


def ring_shift(x: torch.Tensor, group, step: int = 1,
               tag: int = 0) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on in ``group`` and return
    what the rank ``step`` places back sent (``ppermute`` over the ring
    ``i -> i + step``). With one rank, no send to self: ``x`` itself.
    ``tag`` tells apart shifts the backward may run in another order on
    another rank (K's and V's)."""
    return _Shift.apply(x, group, step, tag)


def _a2a_raw(x: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a_raw(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _a2a_raw(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over dim 0 (chunk ``j`` goes to rank ``j``,
    chunk ``j`` of the result came from rank ``j``), differentiable."""
    return _AllToAll.apply(x, group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (``pmean``; not differentiable:
    the train step reads losses with it)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / n
