"""Differentiable collectives over a torch.distributed ProcessGroup.

The sharded step (sharding.py, primitive.py) differentiates through its
communication with these three autograd Functions. They call the plain
c10d collectives, which gloo (CPU tensors) and NCCL (CUDA tensors) both
provide on sub-groups of a DeviceMesh: all_gather_into_tensor, all_reduce
and all_to_all_single. (`torch.distributed.nn.functional.all_gather` is
not used: its backward on gloo goes through a scatter that takes the
group rank for a global rank and fails on a sub-group.)

Gradient convention, one for the whole package: every rank runs backward
on its own objective, and the objective being differentiated is the SUM
of the ranks' objectives. Each backward below is the adjoint of its
forward under that sum:

  all_gather (tiled)  -> all_reduce(sum) of the cotangent, then the
                         rank's own slice (a reduce-scatter);
  all_reduce (sum)    -> all_reduce(sum) of the cotangent;
  all_to_all (equal)  -> the reverse all_to_all of the cotangent.

So a loss that every rank holds replicated is seeded with loss / world on
each rank, and a tensor that several ranks hold as copies (a gauss shard
on every rank of the pixel axis) ends backward with a partial gradient on
each copy, which the caller sums over those ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather(x, group):
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _gather(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0).contiguous()
        dist.all_reduce(g, group=ctx.group)
        k = dist.get_rank(ctx.group)
        return g[k * ctx.n:(k + 1) * ctx.n].movedim(0, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in group-rank order
    (tiled); differentiable, backward a reduce-scatter."""
    return _AllGather.apply(x, group, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's tensors on every rank; differentiable."""
    return _AllReduce.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of x split into group-size equal blocks; block j goes to group
    rank j, and the result holds the blocks received, in source order.
    Differentiable, backward the reverse exchange."""
    return _AllToAll.apply(x, group)


def gather_values(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather of a tensor that carries no gradient (depth keys, counts)."""
    return _gather(x.detach(), group)


def reduce_value(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """all_reduce of a tensor that carries no gradient (counts, maxima)."""
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y
