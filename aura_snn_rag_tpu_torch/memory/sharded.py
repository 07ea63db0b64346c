"""The episodic bank sharded over one or more mesh axes (counterpart of
`aura_snn_rag_tpu/memory/sharded.py`).

Each rank owns one independent shard of the bank: its own rows,
centroids and buckets, a plain single-shard `MemoryState` on the rank's
device. Shard `s` is the rank's outer-major flat index over the bank
axes, so it is row `s` of the JAX package's stacked [S, ...] state
(`stack_shards` / `shard_of` carry states between the two layouts).
Writes go to the local shard; a query runs the engine's `retrieve_auto`
on every shard (the same kernels as an unsharded bank), then the
candidates merge by all-gather and top-k: over the innermost axis first,
so on a multi-slice mesh ('replica', 'data') the outer, slower links
carry only each slice's k survivors.

Every rank must call each function, in the same order: they hold the
collectives of the merge. A rank's path inside `retrieve_auto` (IVF,
flat or brute force, and its host sync) may differ from another's; it
runs no collective.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from aura_snn_rag_tpu_torch.config import MemoryConfig
from aura_snn_rag_tpu_torch.memory import engine
from aura_snn_rag_tpu_torch.memory.engine import RetrievalResult
from aura_snn_rag_tpu_torch.memory.state import (
    MemoryState, init_memory_state, state_from_numpy, state_to_numpy)
from aura_snn_rag_tpu_torch.parallel.collectives import gather_stack
from aura_snn_rag_tpu_torch.parallel.mesh import (
    Axes, axes_index, axes_tuple, batch_slice, mesh_device)


def init_sharded_memory(config: MemoryConfig, mesh: DeviceMesh,
                        axis: Axes = "data") -> MemoryState:
    """This rank's empty shard, on its device. `config.max_memories` is
    the per-shard capacity: the bank holds S x max_memories rows. `axis`
    is one mesh axis or a tuple, outer to inner (("replica", "data") for
    a multi-slice mesh)."""
    return init_memory_state(config, mesh_device(mesh))


def write_memories_sharded(config: MemoryConfig, mesh: DeviceMesh,
                           state: MemoryState, features: torch.Tensor,
                           locations: torch.Tensor,
                           axis: Axes = "data") -> MemoryState:
    """Batched write: `features` [B, D] and `locations` [B, S] are the
    whole batch (every rank passes the same); shard s writes rows
    [s B / S, (s + 1) B / S) into its own bank. No collective."""
    rows = batch_slice(features.shape[0], mesh, axis)
    return engine.write_memories(config, state, features[rows],
                                 locations[rows])


def rebuild_centroids_sharded(config: MemoryConfig, mesh: DeviceMesh,
                              state: MemoryState, seed: int = 0,
                              axis: Axes = "data") -> MemoryState:
    """Per-shard index rebuild (independent local k-means). Shard s draws
    its initial centroid rows from a CPU `torch.Generator` seeded with
    seed + s (the JAX package splits one key per shard)."""
    s = axes_index(mesh, axis)
    return engine.rebuild_centroids(
        config, state, torch.Generator().manual_seed(seed + s))


def _merge_topk(scores, slots, feats, k: int, group, grad: bool):
    """all-gather [B, k'] candidates over `group` and keep the top k of
    the [B, S k'] row, in (group rank, candidate) order: a stable
    descending sort, so equal scores keep that order as `lax.top_k`
    does."""
    all_scores = gather_stack(scores, group, grad)           # [S, B, k']
    all_slots = gather_stack(slots, group)
    all_feats = gather_stack(feats, group)
    S, B, K_ = all_scores.shape
    flat_scores = all_scores.transpose(0, 1).reshape(B, S * K_)
    flat_slots = all_slots.transpose(0, 1).reshape(B, S * K_)
    flat_feats = all_feats.transpose(0, 1).reshape(B, S * K_, -1)
    masked = torch.where(flat_slots >= 0, flat_scores,
                         torch.full_like(flat_scores, -torch.inf))
    pick = torch.sort(masked.detach(), dim=1, descending=True,
                      stable=True).indices[:, :k]
    return (masked.gather(1, pick), flat_slots.gather(1, pick),
            flat_feats.gather(1, pick[..., None].expand(
                -1, -1, flat_feats.shape[-1])))


def retrieve_sharded(config: MemoryConfig, mesh: DeviceMesh,
                     state: MemoryState, queries: torch.Tensor, k: int = 5,
                     axis: Axes = "data") -> RetrievalResult:
    """Batched retrieval over every shard: `queries` [B, D] are the same
    on every rank, and every rank gets the same result.

    Each shard runs `engine.retrieve_auto` on its bank and globalizes its
    slots as s * max_memories + local slot; the candidates then merge
    axis by axis, innermost first. A slot the merge cannot fill (too few
    rows in the whole bank) is -1 with score 0 and zero features.

    Gradient: the scores carry the queries' gradient back through each
    merge's all-gather (`parallel.collectives.gather_stack`), whose
    backward sums every rank's gradient of the result: the gradient of
    the sum of the ranks' losses. A rank's queries then get its own
    shard's share. So with the same loss on every rank, divide it by the
    number of ranks and sum the queries' gradient (or their producers')
    over the ranks, as data-parallel training does: that is the gradient
    of the one replicated loss."""
    M = config.max_memories
    axes = axes_tuple(axis)
    grad = torch.is_grad_enabled() and queries.requires_grad
    res = engine.retrieve_auto(config, state, queries, None, k)
    shard = axes_index(mesh, axes)
    scores = res.scores
    slots = torch.where(res.indices >= 0, res.indices + shard * M, -1)
    feats = res.features
    for a in reversed(axes):                     # the inner axis first
        scores, slots, feats = _merge_topk(scores, slots, feats, k,
                                           mesh.get_group(a), grad)
    hit = torch.isfinite(scores)
    return RetrievalResult(
        torch.where(hit, slots, -1),
        torch.where(hit, scores, torch.zeros_like(scores)),
        torch.where(hit[..., None], feats, torch.zeros_like(feats)))


def decay_memories_sharded(state: MemoryState,
                           decay_rate: float = 0.01) -> MemoryState:
    """Decay is elementwise, so each rank decays its shard; through
    `engine.decay_memories`, so `strength` and `decay_accum` advance
    together (the IVF coarse path rebuilds strength from the pair)."""
    return engine.decay_memories(state, decay_rate)


def shard_of(stacked: Sequence[np.ndarray], s: int,
             device="cuda") -> MemoryState:
    """Shard s of a stacked [S, ...] state (numpy arrays in field order,
    such as the JAX package's `jax.tree.map(np.asarray, state)` of a
    sharded bank) as a port MemoryState on `device`."""
    return state_from_numpy([np.asarray(x)[s] for x in stacked], device)


def stack_shards(shards: Sequence[MemoryState]) -> MemoryState:
    """Port shards (in shard order) as one stacked [S, ...] MemoryState of
    numpy arrays, the JAX package's layout (bf16 fields as f32, as
    `state_to_numpy` gives them)."""
    per = [state_to_numpy(st) for st in shards]
    return MemoryState(*[np.stack(field) for field in zip(*per)])
