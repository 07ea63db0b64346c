"""Meshes and the data-parallel placement (counterpart of
`aura_snn_rag_tpu/parallel/mesh.py`, its data half).

A mesh is a `torch.distributed` DeviceMesh with the JAX mesh's axis
names. One process runs per device, so where JAX places a global array on
the mesh, a rank here holds its own part: `shard_batch` cuts a batch to
this rank's rows, `shard_params` replicates parameters by a broadcast.

The tensor-parallel half (`param_sharding_rules`, `param_specs`, and
`shard_params` over a 'model' axis larger than 1) comes with the port's
tensor-, sequence- and pipeline-parallel slice: until then `shard_params`
raises `NotImplementedError` for it.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from aura_snn_rag_tpu_torch.parallel.distributed import mesh_from_ranks

Axes = Union[str, Sequence[str]]


def make_mesh(n_model: int = 1, devices=None,
              axis_names=("data", "model")) -> DeviceMesh:
    """('data', 'model') mesh over `devices` (global ranks; default all
    ranks of the default group, in order)."""
    ranks = (np.arange(dist.get_world_size()) if devices is None
             else np.asarray(list(devices)))
    n = len(ranks)
    if n % n_model:
        raise ValueError(f"{n} ranks not divisible by model={n_model}")
    return mesh_from_ranks(ranks.reshape(n // n_model, n_model), axis_names)


def axes_tuple(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def axes_size(mesh: DeviceMesh, axes: Axes) -> int:
    return math.prod(axis_size(mesh, a) for a in axes_tuple(axes))


def rank_index(mesh: DeviceMesh, axes: Axes, rank: int) -> int:
    """`rank`'s outer-major flat index over `axes` (the order of JAX's
    [S, ...] stacking over a tuple of mesh axes)."""
    coords = (mesh.mesh == rank).nonzero()[0].tolist()
    index = 0
    for a in axes_tuple(axes):
        d = mesh.mesh_dim_names.index(a)
        index = index * mesh.size(d) + coords[d]
    return index


def axes_index(mesh: DeviceMesh, axes: Axes) -> int:
    """This rank's `rank_index`."""
    return rank_index(mesh, axes, dist.get_rank())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_broadcast_(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """In place: the mesh's first rank's `x` on every rank of the mesh. A
    broadcast from coordinate 0 over each axis in turn, outer first, so
    only the mesh's own groups take part (a mesh may hold some of the
    job's ranks)."""
    for d, name in enumerate(mesh.mesh_dim_names):
        if mesh.size(d) > 1:
            group = mesh.get_group(name)
            dist.broadcast(x, src=dist.get_global_rank(group, 0),
                           group=group)
    return x


def mesh_barrier(mesh: DeviceMesh) -> None:
    """Wait for every rank of the mesh, and for no other: a barrier over
    each axis in turn (after the last, each rank has waited on the whole
    grid)."""
    for d, name in enumerate(mesh.mesh_dim_names):
        if mesh.size(d) > 1:
            dist.barrier(group=mesh.get_group(name))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def batch_slice(batch_size: int, mesh: DeviceMesh,
                axes: Axes = "data") -> slice:
    """This rank's rows of a batch sharded over `axes`."""
    n = axes_size(mesh, axes)
    if batch_size % n:
        raise ValueError(f"batch {batch_size} not divisible by the "
                         f"{n} shards of {axes_tuple(axes)}")
    per = batch_size // n
    i = axes_index(mesh, axes)
    return slice(i * per, (i + 1) * per)


def shard_batch(batch, mesh: DeviceMesh, axes: Axes = "data"):
    """This rank's rows (the leading dimension) of every array of `batch`
    (a tensor, a numpy array, or a dict, list or tuple of them), sharded
    over `axes` ('data', or every batch axis such as ('replica',
    'data')), as tensors on the rank's device."""
    dev = mesh_device(mesh)

    def cut(x):
        if not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x))
        return x[batch_slice(x.shape[0], mesh, axes)].to(dev)
    return _map(cut, batch)


def _tensors(params):
    if isinstance(params, nn.Module):
        return list(params.parameters()) + list(params.buffers())
    out = []
    _map(lambda t: out.append(t) if torch.is_tensor(t) else None, params)
    return out


def shard_params(params, mesh: DeviceMesh):
    """Place parameters on the mesh: replicated, as the JAX rules place
    every parameter on a mesh whose 'model' axis has size 1. The mesh's
    first rank broadcasts each tensor of `params` (a module, a tensor or
    a structure of tensors, on the rank's device) in place; returns
    `params`. Tensor parallelism over a larger 'model' axis comes with the
    port's tensor-parallel slice."""
    if "model" in mesh.mesh_dim_names and axis_size(mesh, "model") > 1:
        raise NotImplementedError(
            "tensor-parallel parameters over a 'model' axis larger than 1 "
            "are not ported yet")
    with torch.no_grad():
        for t in _tensors(params):
            mesh_broadcast_(t.data, mesh)
    return params
