"""MemoryState: the episodic memory bank as a named tuple of tensors.

Counterpart of `aura_snn_rag_tpu/memory/state.py`: same fields, order,
dtypes and fill values. Scalars are 0-dim tensors on the bank's device.
The engine updates the large tensors in place and returns a new
MemoryState for every mutation, so a state object that was passed to a
mutating function is consumed (as the JAX package's donated buffers are).

`state_from_numpy` / `state_to_numpy` carry a bank between the packages:
the JAX package's `jax.tree.map(np.asarray, state)` is a MemoryState of
numpy arrays in the same field order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import MemoryConfig


class MemoryState(NamedTuple):
    """Episodic memory bank + centroid index. All shapes static."""

    # --- bank (row-indexed by bank slot) ---
    features: torch.Tensor       # [M, D] f32 raw stored features
    features_nb16: torch.Tensor  # [M, D] bf16 or int8 normalised coarse copy
    coarse_scale: torch.Tensor   # [M] f32 per-row dequant scale (int8 rows:
                                 #   cos = acc * scale / 127; bf16 rows: 1.0)
    locations: torch.Tensor      # [M, S] f32 spatial coordinates
    strength: torch.Tensor       # [M] f32 decayable strength
    timestamp: torch.Tensor      # [M] f32 logical step at write
    centroid_id: torch.Tensor    # [M] i32 assigned centroid (-1 = none)
    slot_gen: torch.Tensor       # [M] i32 write generation of the slot
    # --- centroid index ---
    centroids: torch.Tensor      # [K, D] f32
    centroid_counts: torch.Tensor  # [K] f32 members per centroid
    # --- IVF clustered candidate store ---
    clustered: torch.Tensor      # [K, C, D] bf16 normalised member copies
    cluster_slot: torch.Tensor   # [K, C] i32 bank slot (-1 = empty)
    cluster_gen: torch.Tensor    # [K, C] i32 generation stamp
    cluster_ts: torch.Tensor     # [K, C] f32 write timestamp
    cluster_decay: torch.Tensor  # [K, C] f32 decay_accum at write
    cluster_loc: torch.Tensor    # [K, C, S] f32 write locations
    bucket_fill: torch.Tensor    # [K] i32 ring write cursor per bucket
    # --- scalars ---
    count: torch.Tensor          # i32 total writes ever
    step: torch.Tensor           # f32 logical clock
    decay_accum: torch.Tensor    # f32 cumulative log(1 - rate)
    index_ready: torch.Tensor    # bool centroid index usable

    @property
    def max_memories(self) -> int:
        return self.features.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]

    @property
    def k_centroids(self) -> int:
        return self.centroids.shape[0]

    @property
    def bucket_capacity(self) -> int:
        return self.clustered.shape[1]

    @property
    def device(self) -> torch.device:
        return self.features.device

    def active_count(self) -> torch.Tensor:
        return torch.clamp(self.count, max=self.max_memories)


def init_memory_state(config: MemoryConfig,
                      device: Union[str, torch.device, None] = "cuda"
                      ) -> MemoryState:
    """An empty bank on `device` (CUDA by default; raises without a card
    unless device='cpu')."""
    dev = resolve_device(device)
    M, D, S = config.max_memories, config.feature_dim, config.spatial_dims
    K, C = config.k_centroids, config.bucket_capacity
    coarse = torch.int8 if config.coarse_dtype == "int8" else torch.bfloat16
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return MemoryState(
        features=z(M, D),
        features_nb16=z(M, D, dtype=coarse),
        coarse_scale=full((M,), 1.0, f32),
        locations=z(M, S),
        strength=z(M),
        timestamp=z(M),
        centroid_id=full((M,), -1, i32),
        slot_gen=full((M,), -1, i32),
        centroids=z(K, D),
        centroid_counts=z(K),
        clustered=z(K, C, D, dtype=torch.bfloat16),
        cluster_slot=full((K, C), -1, i32),
        cluster_gen=full((K, C), -1, i32),
        cluster_ts=z(K, C),
        cluster_decay=z(K, C),
        cluster_loc=z(K, C, S),
        bucket_fill=z(K, dtype=i32),
        count=z(dtype=i32),
        step=z(),
        decay_accum=z(),
        index_ready=z(dtype=torch.bool),
    )


def _from_numpy(arr, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(arr)                       # a private, writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from JAX
        a = a.view(np.int16)
        return torch.from_numpy(a).view(torch.bfloat16).to(device, dtype)
    return torch.from_numpy(a).to(device, dtype)


# target dtype per field (features_nb16 follows the array: int8 or bf16)
_DTYPES = {
    "centroid_id": torch.int32, "slot_gen": torch.int32,
    "cluster_slot": torch.int32, "cluster_gen": torch.int32,
    "bucket_fill": torch.int32, "count": torch.int32,
    "clustered": torch.bfloat16, "index_ready": torch.bool,
}


def state_from_numpy(arrays: Sequence,
                     device: Union[str, torch.device, None] = "cuda"
                     ) -> MemoryState:
    """A MemoryState from numpy arrays in field order (e.g. the JAX
    package's `jax.tree.map(np.asarray, state)`, or `state_to_numpy`)."""
    dev = resolve_device(device)
    arrays = list(arrays)
    if len(arrays) != len(MemoryState._fields):
        raise ValueError(f"expected {len(MemoryState._fields)} arrays, "
                         f"got {len(arrays)}")
    out = {}
    for name, arr in zip(MemoryState._fields, arrays):
        if name == "features_nb16":
            dt = (torch.int8 if np.asarray(arr).dtype == np.int8
                  else torch.bfloat16)
        else:
            dt = _DTYPES.get(name, torch.float32)
        out[name] = _from_numpy(arr, dt, dev)
    return MemoryState(**out)


def state_to_numpy(state: MemoryState) -> MemoryState:
    """A MemoryState of numpy arrays on the host. bf16 fields come back as
    float32 (exact; numpy has no bfloat16) and `state_from_numpy` casts
    them back."""
    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return MemoryState(*[conv(t) for t in state])
