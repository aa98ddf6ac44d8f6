"""Differentiable collectives over one mesh axis's process group: the
counterparts of the reference's `lax.ppermute` and of the `psum` that a
shard_map with a replicated input or output inserts (ring attention and
the pipeline use them).

Each is an autograd Function whose backward is the transposed
collective, so every rank of the group must run the same forward
sequence and reach the same backward nodes: the callers keep each one's
output in the graph on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send x to group rank r + shift, receive from r - shift (mod n)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: rank i sends to i + 1 and receives from i - 1 (the
    reference's ppermute [(i, (i + 1) % n)]); backward: the reverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


class _CopyIn(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' gradients (a value
    replicated over the group into per-rank work: shard_map's P() input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceOut(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward: every rank consumes
    the sum alike (replicated downstream), so each already holds the
    whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _KeepInGraph(torch.autograd.Function):
    """x as it is, with `others` joined to the graph at a zero gradient."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(s, dtype=d, device=v)
                         for s, d, v in ctx.others))


def keep_in_graph(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """x, with `others` (a collective's outputs that this rank reads no
    further) kept in the autograd graph: their producers' backward, a
    collective the other ranks run too, then runs here as well."""
    return _KeepInGraph.apply(x, *others)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """x from group rank i - 1 (mod n), differentiably."""
    return _RingShift.apply(x, group)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; its gradient is the sum of the group's gradients."""
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group; the gradient passes through."""
    return _ReduceOut.apply(x, group)
