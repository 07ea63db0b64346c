"""Collectives over mesh axes, with the gradients that data-, tensor-,
sequence- and pipeline-parallel training and the sharded bank need.

`torch.distributed.nn.functional.all_gather` cannot serve here: on a
subgroup its backward passes a group rank to `dist.scatter` where a
global rank is expected, and raises (or reduces to the wrong rank).
`gather_stack` is the port's own: its forward gathers every rank's
tensor, its backward all-reduces the incoming gradient over the group
and keeps this rank's slice. In torch every rank backpropagates its own
loss, so the gradient it computes is that of the sum of the ranks'
losses: a rank's tensor gets the gradient of every rank's use of it.

The model-parallel collectives are `torch.autograd.Function`s over an
explicit process group (a mesh axis's), for the same reason:
- `ppermute(x, group, shift)`: JAX's `lax.ppermute` around the ring,
  rank i sends to i + shift and receives from i - shift; the backward is
  the reverse hop. Ring attention and the pipeline ride it.
- `copy_in` / `reduce_out`: Megatron's two region operators for tensor
  parallelism, where every rank of the 'model' axis computes the same
  loss. `copy_in` is the identity whose backward all-reduces (a
  replicated tensor entering per-rank math, its gradient summed from
  every rank's part); `reduce_out` all-reduces partial sums and passes
  the gradient through.
- `gather_dim` all-gathers shards along a dimension (the backward keeps
  this rank's part of the gradient); `reduce_scatter_dim` all-reduces
  and keeps this rank's part (the backward all-gathers): both for the
  replicated loss of the 'model' axis.
- `all_reduce_sum`: a sum whose backward sums too, for the sum of the
  ranks' own losses (the 'seq' axis, where each rank's loss covers its
  chunk of the sequence).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aura_snn_rag_tpu_torch.parallel.mesh import (
    Axes, axes_size, axes_tuple)


def _gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


class _GatherStack(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.index = dist.get_rank(group)
        return torch.stack(_gather(x, group))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.index], None


def gather_stack(x: torch.Tensor, group, grad: bool = False
                 ) -> torch.Tensor:
    """[n, *x.shape]: every rank's `x` over `group`, in group-rank order.
    With `grad` (every rank must pass the same value) the result carries
    the gradient back to each rank's `x`; a rank whose `x` needs none
    joins the backward's all-reduce all the same."""
    if not grad:
        return torch.stack(_gather(x.detach(), group))
    if not x.requires_grad:
        x = x.detach().requires_grad_()
    return _GatherStack.apply(x, group)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, axes: Axes,
                grad: bool = False) -> torch.Tensor:
    """Every rank's rows of `x` over `axes`, concatenated in outer-major
    order (the inner axis gathered first): the global batch that
    `shard_batch` cut."""
    for a in reversed(axes_tuple(axes)):
        x = gather_stack(x, mesh.get_group(a), grad).flatten(0, 1)
    return x


def all_reduce_mean_(x: torch.Tensor, mesh: DeviceMesh,
                     axes: Axes) -> torch.Tensor:
    """In place: the mean of `x` over the ranks of `axes` (a sum over each
    axis, then one division)."""
    for a in axes_tuple(axes):
        dist.all_reduce(x, group=mesh.get_group(a))
    return x.div_(axes_size(mesh, axes))


# --------------------------------------------------------------------------
# model-parallel collectives
# --------------------------------------------------------------------------

def _ppermute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (i - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _ppermute(grad, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank i of `group` sends `x` to rank (i + shift) % n and returns what
    rank (i - shift) % n sent (`lax.ppermute` with the ring's pairs); the
    gradient takes the reverse hop. The identity on a group of one."""
    if dist.get_world_size(group) == 1:
        return x
    return _PPermute.apply(x, group, shift)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyIn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward all-reduces the gradient over `group`
    (a replicated tensor that enters each rank's share of the work)."""
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's partial `x` over `group`; the gradient
    passes through (each rank's loss is the same)."""
    return _ReduceOut.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `x` over `group`, whose gradient is the sum
    of every rank's gradient: the reduction for ranks whose losses add up
    to the loss (sequence chunks)."""
    return _AllReduceSum.apply(x, group)


def _gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return torch.cat(_gather(x, group), dim=dim)


def _own_part(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _GatherDim(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own_part(grad, ctx.group, ctx.dim), None, None


class _ReduceScatterDim(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_part(_all_reduce(x, group), group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_cat(grad, ctx.group, ctx.dim), None, None


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` over `group` concatenated along `dim`, in group-rank
    order; the gradient keeps this rank's part."""
    return _GatherDim.apply(x, group, dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's part, along `dim`, of the sum of every rank's `x` over
    `group`; the gradient all-gathers the parts."""
    return _ReduceScatterDim.apply(x, group, dim)
