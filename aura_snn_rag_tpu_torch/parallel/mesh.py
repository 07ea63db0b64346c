"""Meshes, parameter sharding rules and placement (counterpart of
`aura_snn_rag_tpu/parallel/mesh.py`).

A mesh is a `torch.distributed` DeviceMesh with the JAX mesh's axis
names. One process runs per device, so where JAX places a global array on
the mesh, a rank here holds its own part: `shard_batch` cuts a batch to
this rank's rows, and `shard_params` replicates parameters by a
broadcast and, over a 'model' axis larger than 1, keeps this rank's
slice of each tensor-parallel weight.

Tensor parallelism follows the JAX rules (`_RULES`, matched against the
flax parameter paths, which `models/convert.py` maps onto the port's
names): column-parallel Q/K/V, FFN up and the spiking FFN's `syn1`, then
row-parallel O, FFN down, `gif1_in` and `syn2`, the memory attention's
query/key/value and out, the token embedding's feature dimension, and the
expert banks' leading expert axis. A spec is a tuple with one entry per
dimension, a mesh axis name or None (JAX's `PartitionSpec`).
`param_specs` gives every parameter's spec in the port's layout ([out,
in] weights, flattened attention heads), so it can be held to JAX's.
"""

from __future__ import annotations

import math
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

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


Spec = Tuple[Optional[str], ...]


def P(*axes: Optional[str]) -> Spec:
    """A partition spec: one mesh axis name (or None) per dimension."""
    return tuple(axes)


# path regex -> spec for the transformer's flax parameter tree (kernels
# [in, out]); 'model' on the dimension that splits heads / FFN hidden
# (column-parallel) or contracts them (row-parallel)
_RULES = [
    (r"token_embedding/embedding", P(None, "model")),      # [V, D/model]
    (r"(q_proj|k_proj|v_proj)/kernel", P(None, "model")),  # column parallel
    (r"o_proj/kernel", P("model", None)),                  # row parallel
    (r"ffn/(up|mlp/up)/kernel", P(None, "model")),
    (r"ffn/(down|mlp/down)/kernel", P("model", None)),
    (r"ffn/snn/syn1/kernel", P(None, "model")),
    (r"ffn/snn/gif1_in/kernel", P("model", None)),
    (r"ffn/snn/syn2/kernel", P("model", None)),
    (r"memory_attention/(query|key|value)/kernel", P(None, None, "model")),
    (r"memory_attention/out/kernel", P("model", None, None)),
]


def param_sharding_rules(path: str, ndim: Optional[int] = None) -> Spec:
    """The spec of the flax parameter at `path` ("layer_0/attention/q_proj/
    kernel") with `ndim` dimensions, in flax's layout. Stacked [E, ...]
    expert parameters shard their expert axis over 'model' (expert
    parallelism); everything the rules do not name is replicated."""
    if "experts/" in path and ndim is not None and ndim >= 1:
        return P(*(("model",) + (None,) * (ndim - 1)))
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            return spec
    return P()


def _flax_leaf(module: nn.Module, name: str, own: str, parent: str
               ) -> Tuple[str, int, Optional[str]]:
    """(flax leaf name, flax ndim, layout) of parameter `name` of `module`
    (named `own` under `parent`): the layout is "dense" for an [out, in]
    weight of a flax [in, out] kernel, "mha_in" / "mha_out" / "mha_bias"
    for the memory attention's flattened heads, None where the port keeps
    flax's layout."""
    from aura_snn_rag_tpu_torch.models.layers import Dense, Embed, LayerNorm
    ndim = getattr(module, name).dim()
    if isinstance(module, Dense):
        if parent == "memory_attention":         # flax [D, H, Hd] kernels
            if name == "weight":
                return "kernel", 3, "mha_out" if own == "out" else "mha_in"
            if own != "out":
                return "bias", 2, "mha_bias"
        elif name == "weight":
            return "kernel", 2, "dense"
        return name, ndim, None
    if isinstance(module, Embed):
        return "embedding", ndim, None
    if isinstance(module, LayerNorm):
        return ("scale" if name == "weight" else name), ndim, None
    return name, ndim, None


def _port_spec(spec: Spec, ndim: int, layout: Optional[str]) -> Spec:
    """A flax-layout spec in the port's layout (padded to `ndim`)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if layout == "dense":                    # [in, out] -> [out, in]
        return spec[::-1]
    if layout == "mha_in":                   # [D, H, Hd] -> [H*Hd, D]
        spec = tuple(spec) + (None,) * (3 - len(spec))
        return (spec[1] or spec[2], spec[0])
    if layout == "mha_out":                  # [H, Hd, D] -> [D, H*Hd]
        spec = tuple(spec) + (None,) * (3 - len(spec))
        return (spec[2], spec[0] or spec[1])
    if layout == "mha_bias":                 # [H, Hd] -> [H*Hd]
        spec = tuple(spec) + (None,) * (2 - len(spec))
        return (spec[0] or spec[1],)
    return spec


def _prune(spec: Spec, mesh: Optional[DeviceMesh]) -> Spec:
    """Axes the mesh lacks replicate (the TP rules on a ('data', 'seq')
    mesh)."""
    if mesh is None:
        return spec
    names = tuple(mesh.mesh_dim_names)
    return tuple(a if a in names else None for a in spec)


def param_paths(module: nn.Module
                ) -> Dict[str, Tuple[str, int, Optional[str]]]:
    """Every parameter's port name -> (flax path, flax ndim, layout), the
    path as `models/convert.py` maps the flax tree onto the port
    (`layers.<i>` is `layer_<i>`)."""
    out = {}
    for mod_name, m in module.named_modules():
        parts = re.sub(r"(^|\.)layers\.(\d+)", r"\1layer_\2",
                       mod_name).split(".") if mod_name else []
        own = parts[-1] if parts else ""
        parent = parts[-2] if len(parts) >= 2 else ""
        for name, _ in m.named_parameters(recurse=False):
            leaf, ndim, layout = _flax_leaf(m, name, own, parent)
            key = f"{mod_name}.{name}" if mod_name else name
            out[key] = ("/".join(parts + [leaf]), ndim, layout)
    return out


def param_specs(params, mesh: Optional[DeviceMesh] = None
                ) -> Dict[str, Spec]:
    """Every parameter's spec, by its port name, in the port's layout
    (the JAX spec of the same flax parameter, its dimensions mapped as
    `models/convert.py` maps the tensor). With `mesh` given, axes the mesh
    lacks are dropped (replicated)."""
    named = dict(params.named_parameters())
    return {key: _prune(_port_spec(param_sharding_rules(path, ndim),
                                   named[key].dim(), layout), mesh)
            for key, (path, ndim, layout) in param_paths(params).items()}


def memory_state_specs(state):
    """The episodic bank's specs (a MemoryState of specs): every field with
    a dimension shards its leading dimension (bank rows, cluster buckets,
    centroids) over 'data', as `memory/sharded.py` holds one shard per
    rank; scalars replicate."""
    return _map(lambda x: P() if x.ndim == 0 else P("data"), state)


class TensorParallel(NamedTuple):
    """The 'model' axis as a tensor-parallel module sees it."""
    group: object        # the axis's process group
    size: int
    index: int           # this rank's coordinate


def tensor_parallel(mesh: DeviceMesh, axis: str = "model"
                    ) -> Optional[TensorParallel]:
    """The mesh's 'model' axis, or None where it is absent or of size 1."""
    if axis not in mesh.mesh_dim_names or axis_size(mesh, axis) == 1:
        return None
    return TensorParallel(mesh.get_group(axis), axis_size(mesh, axis),
                          axis_index(mesh, axis))


def shard_dim(spec: Spec, axis: str = "model") -> Optional[int]:
    """The dimension a spec shards over `axis`, or None."""
    return spec.index(axis) if axis in spec else None


def take_shard(x: torch.Tensor, dim: Optional[int],
               tp: Optional[TensorParallel]) -> torch.Tensor:
    """This rank's contiguous part of `x` along `dim` (the whole of `x`
    where `dim` or `tp` is None)."""
    if dim is None or tp is None:
        return x
    if x.shape[dim] % tp.size:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide over {tp.size} 'model' ranks")
    return x.chunk(tp.size, dim=dim)[tp.index]


def shard_params(params, mesh: DeviceMesh):
    """Place parameters on the mesh; returns `params`.

    The mesh's first rank broadcasts each tensor of `params` (a module, a
    tensor or a structure of tensors, on the rank's device) in place, as
    the JAX rules place every parameter on a mesh whose 'model' axis has
    size 1. Over a larger 'model' axis a module's tensor-parallel
    parameters (`param_specs` with 'model' in the spec) are then cut to
    this rank's contiguous part along the sharded dimension (new
    `Parameter`s), and each module that computes on such parts (its
    class has a `tp` attribute) records the axis in `tp`. Everything
    else stays replicated."""
    with torch.no_grad():
        for t in _tensors(params):
            mesh_broadcast_(t.data, mesh)
    tp = tensor_parallel(mesh)
    if tp is None or not isinstance(params, nn.Module):
        return params
    specs = param_specs(params, mesh)
    sharded = set()
    for key, spec in specs.items():
        dim = shard_dim(spec)
        if dim is None:
            continue
        owner_name, _, leaf = key.rpartition(".")
        owner = params.get_submodule(owner_name) if owner_name else params
        p = getattr(owner, leaf)
        setattr(owner, leaf, nn.Parameter(
            take_shard(p.detach(), dim, tp).clone(),
            requires_grad=p.requires_grad))
        sharded.add(owner_name)
    for name, m in params.named_modules():
        if hasattr(type(m), "tp") and any(
                not name or s == name or s.startswith(name + ".")
                for s in sharded):
            m.tp = tp
    return params
