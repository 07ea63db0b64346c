"""Collectives over mesh axes, with the gradients that data-parallel
training and the sharded bank need.

`torch.distributed.nn.functional.all_gather` cannot serve here: on a
subgroup its backward passes a group rank to `dist.scatter` where a
global rank is expected, and raises (or reduces to the wrong rank).
`gather_stack` is the port's own: its forward gathers every rank's
tensor, its backward all-reduces the incoming gradient over the group
and keeps this rank's slice. In torch every rank backpropagates its own
loss, so the gradient it computes is that of the sum of the ranks'
losses: a rank's tensor gets the gradient of every rank's use of it.
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
