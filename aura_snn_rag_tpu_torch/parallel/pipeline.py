"""Pipeline parallelism: the GPipe microbatch pipeline over a mesh axis
(counterpart of `aura_snn_rag_tpu/parallel/pipeline.py`).

The layer stack is split into S contiguous stages, one per rank of the
'stage' axis; a rank holds only its own stage's parameters (where JAX
stacks them [S, ...] and places them `P(axis)`). A batch is split into M
microbatches, and the schedule is JAX's: M + S - 1 steps; at step t
stage 0 takes microbatch min(t, M - 1), every other stage takes what the
previous stage handed it at step t - 1 (one `ppermute` hop a step), and
the last stage's outputs at steps S - 1 .. T - 1 are the microbatches'
results, replicated over the axis. A stage idles in the bubble (a step
at which its input is not a microbatch's) instead of computing JAX's
discarded values, so a stage runs its block M times.

The backward runs the same schedule in reverse, step by step: each stage
backpropagates its block from the gradient the next stage hands back
(the reverse hop) and hands its input's gradient to the previous stage.
Ranks run one program, so the hops pair and no collective waits on a
rank that skipped it, whatever each rank's loss reaches. The stages'
gradients accumulate into their parameters' `.grad`.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aura_snn_rag_tpu_torch.parallel.collectives import ppermute
from aura_snn_rag_tpu_torch.parallel.mesh import (
    _map, axis_index, axis_size, mesh_device)


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(lambda t: out.append(t) if torch.is_tensor(t) else None, tree)
    return out


def _params(tree) -> List[torch.Tensor]:
    """The tensors of a stage's parameters: its tensors, and the
    parameters of its modules."""
    out: List[torch.Tensor] = []

    def add(t):
        if torch.is_tensor(t):
            out.append(t)
        elif isinstance(t, torch.nn.Module):
            out.extend(t.parameters())
    _map(add, tree)
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _map(lambda t: next(it) if torch.is_tensor(t) else t, tree)


def stack_stage_params(per_stage_params, mesh: DeviceMesh,
                       axis: str = "stage"):
    """This rank's stage of S per-stage parameter structures (a list over
    the stages), on its device: the slice of JAX's stacked [S, ...] tree
    that `P(axis)` places here. Tensors already on the device are returned
    as they are, so a leaf parameter stays the leaf."""
    S = axis_size(mesh, axis)
    if len(per_stage_params) != S:
        raise ValueError(f"{len(per_stage_params)} stages for a {axis!r} "
                         f"axis of {S}")
    dev = mesh_device(mesh)
    return _map(lambda t: t.to(dev) if torch.is_tensor(t) else t,
                per_stage_params[axis_index(mesh, axis)])


def split_microbatches(batch: torch.Tensor,
                       num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    B = batch.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by {num_microbatches} "
                         f"microbatches")
    return batch.reshape((num_microbatches, B // num_microbatches)
                         + tuple(batch.shape[1:]))


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node. Inputs: an anchor (a 0-dim
    tensor that requires grad when anything upstream does, so every
    rank's backward reaches the node) and the microbatches' leaves; the
    stage's parameters are reached through the block, and their
    gradients accumulate in `.grad`."""

    @staticmethod
    def forward(ctx, run, anchor, *xs):
        ctx.run = run
        return tuple(run.forward(list(xs)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.run.backward(list(grads)))


class _Schedule:
    """One GPipe run on this rank: stage `sid` of `S` over `group`."""

    def __init__(self, block_fn, params, consts, template, group, S, sid):
        self.block_fn, self.params, self.consts = block_fn, params, consts
        self.template = template       # the microbatches' structure
        self.group, self.S, self.sid = group, S, sid
        self.saved = {}                # step -> (inputs, outputs)

    def _block(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        tree = _unflatten(self.template, x)
        y = (self.block_fn(self.params, tree) if self.consts is None
             else self.block_fn(self.params, tree, self.consts))
        return _leaves(y)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        S, sid = self.S, self.sid
        self.M = M = xs[0].shape[0]
        T = M + S - 1
        self.mb = [x[0] for x in xs]             # one microbatch's leaves
        inflow = [torch.zeros_like(a) for a in self.mb]
        last = []
        for t in range(T):
            x = [a[min(t, M - 1)] for a in xs] if sid == 0 else inflow
            if sid <= t < sid + M:                # else the bubble: idle
                x = [a.detach().requires_grad_(a.is_floating_point())
                     for a in x]
                with torch.enable_grad():
                    y = self._block(x)
                self.saved[t] = (x, y)
                y = [a.detach() for a in y]
            else:
                y = [torch.zeros_like(a) for a in self.mb]
            if t >= S - 1:
                last.append(y)
            if t < T - 1:
                inflow = [ppermute(a, self.group) for a in y]
        # the last stage's outputs, replicated over the axis
        outs = [torch.stack(step) for step in zip(*last)]
        if S > 1:
            src = dist.get_global_rank(self.group, S - 1)
            for o in outs:
                dist.broadcast(o, src=src, group=self.group)
        return outs

    def backward(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        S, sid, M = self.S, self.sid, self.M
        T = M + S - 1
        g_out = []
        for g, mb in zip(grads, self.mb):
            g = (torch.zeros((M,) + tuple(mb.shape), dtype=mb.dtype,
                             device=mb.device) if g is None
                 else g.contiguous().clone())
            if S > 1:          # one loss on every rank: the ranks' mean
                dist.all_reduce(g, group=self.group)
                g = g / S
            g_out.append(g)
        g_xs = [torch.zeros_like(g) for g in g_out]
        hop = None
        for t in reversed(range(T)):
            gy = ([g[t - S + 1] for g in g_out]
                  if sid == S - 1 and t >= S - 1 else hop)
            gx = None
            if t in self.saved:
                x, y = self.saved.pop(t)
                pairs = [(a, b) for a, b in zip(y, gy) if a.requires_grad]
                if pairs:
                    torch.autograd.backward([a for a, _ in pairs],
                                            [b for _, b in pairs])
                gx = [torch.zeros_like(a) if a.grad is None else a.grad
                      for a in x]
                if sid == 0:
                    for acc, g in zip(g_xs, gx):
                        acc[t] += g
            if t > 0:          # the reverse hop: to the previous stage
                if gx is None:
                    gx = [torch.zeros_like(a) for a in self.mb]
                hop = [ppermute(g, self.group, -1) for g in gx]
        if S > 1:              # stage 0's input gradient, on every rank
            src = dist.get_global_rank(self.group, 0)
            for g in g_xs:
                dist.broadcast(g, src=src, group=self.group)
        return g_xs


def pipeline_apply(block_fn: Callable[..., Any], stage_params,
                   microbatches, mesh: DeviceMesh, axis: str = "stage",
                   consts: Any = None):
    """Run `microbatches` (a tensor, or a tuple, list or dict of tensors,
    with leaves [M, mb, ...]) through the S stages of `mesh`'s `axis`.

    `block_fn(stage_params, x[, consts])` is this rank's stage, shape-
    preserving (x and its result have the same structure and shapes,
    such as (hidden, prosody) with the prosody passed through);
    `stage_params` are this rank's (`stack_stage_params`); `consts` (such
    as the episodic `MemoryState`) are replicated and passed to every
    stage as they are, without a gradient.

    Returns the last stage's outputs, leaves [M, mb, ...], on every rank
    of the axis. Differentiable: each stage's parameters get their
    gradient in `.grad`, and the microbatches theirs on every rank. The
    ranks of the axis are taken to compute one loss from the replicated
    output, as JAX's replicated result is one value: the backward takes
    the mean of the S ranks' output gradients, so a caller whose ranks
    each compute the loss divides it by nothing (where the ranks' losses
    differ, the gradient is that of their mean)."""
    S = axis_size(mesh, axis)
    xs = _leaves(microbatches)
    run = _Schedule(block_fn, stage_params, consts, microbatches,
                    mesh.get_group(axis), S, axis_index(mesh, axis))
    grad = torch.is_grad_enabled() and (
        any(x.requires_grad for x in xs)
        or any(p.requires_grad for p in _params(stage_params)))
    anchor = torch.zeros((), device=xs[0].device, requires_grad=grad)
    return _unflatten(microbatches, list(_Pipeline.apply(run, anchor, *xs)))
