"""Host-side hippocampal formation: string-id API over the device engine.

Counterpart of `aura_snn_rag_tpu/memory/hippocampus.py`:
`create_episodic_memory`, `write_batch`, `retrieve_similar_memories`,
`retrieve_batch`, `decay_memories`, `rebuild_centroids`, the spatial and
temporal context, and `state_dict` / `load_state_dict`. String ids live
in a numpy array indexed by bank slot.

`load_state_dict` accepts the JAX package's `state_dict()` as it is
(numpy arrays, bf16 arrays included) as well as this class's own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import MemoryConfig
from aura_snn_rag_tpu_torch.memory import engine
from aura_snn_rag_tpu_torch.memory.cognitive_map import (
    CognitiveMapParams, grid_cell_rates, init_cognitive_map,
    place_cell_rates, time_cell_rates,
)
from aura_snn_rag_tpu_torch.memory.state import (
    MemoryState, init_memory_state, state_from_numpy, state_to_numpy)


class HippocampalFormation:
    """Stateful episodic memory store with a string-id host API."""

    def __init__(self, config: Optional[MemoryConfig] = None,
                 seed: int = 0, use_centroid_index: bool = True,
                 device: Union[str, torch.device, None] = "cuda",
                 **overrides):
        if config is None:
            config = MemoryConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = resolve_device(device)
        self.use_centroid_index = use_centroid_index
        # CPU generator: the same seed draws the same numbers on any device
        self._generator = torch.Generator().manual_seed(seed)
        self.state: MemoryState = init_memory_state(config, self.device)
        self.cognitive_map: CognitiveMapParams = init_cognitive_map(
            self._generator, config, self.device)
        # slot -> string id (None = empty); fixed capacity like the bank
        self._slot_ids: np.ndarray = np.full(
            config.max_memories, None, dtype=object)
        self._id_to_slot: Dict[str, int] = {}
        self.current_location = np.zeros(config.spatial_dims, np.float32)
        self._writes_since_rebuild = 0
        self._last_event_step = 0.0
        # IVF kernel metadata sidecar, keyed on state identity. The engine
        # mutates tensors in place, so every mutating method below also
        # clears it explicitly.
        self._aux_cache: Optional[Tuple[Any, Any]] = None

    def _set_state(self, state: MemoryState) -> None:
        self.state = state
        self._aux_cache = None

    def _tensor(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x, np.float32))
        return x.to(self.device, torch.float32)

    # ------------------------------------------------------------------
    @property
    def memory_count(self) -> int:
        return int(min(int(self.state.count), self.config.max_memories))

    @property
    def index_ready(self) -> bool:
        return bool(self.state.index_ready)

    # ------------------------------------------------------------------
    # spatial / temporal context (cognitive map)
    # ------------------------------------------------------------------
    def update_spatial_state(self, new_location, dt: float = 0.1) -> None:
        loc = np.asarray(new_location, np.float32)
        if loc.ndim > 1:
            loc = loc[0]
        self.current_location = loc

    def get_spatial_context(self) -> Dict[str, Any]:
        loc = self._tensor(self.current_location)
        return {
            "current_location": self.current_location,
            "place_cells": place_cell_rates(
                self.cognitive_map, loc, self.config.place_max_rate),
            "grid_cells": grid_cell_rates(
                self.cognitive_map, loc, self.config.grid_max_rate),
            "n_memories": self.memory_count,
        }

    def get_temporal_context(self) -> Dict[str, Any]:
        elapsed = (float(self.state.step) - self._last_event_step) \
            * self.config.seconds_per_step
        return {
            "time_cells": time_cell_rates(self.cognitive_map,
                                          self._tensor(elapsed)),
            "elapsed": elapsed,
        }

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------
    def create_episodic_memory(self, memory_id: str, event_id: str,
                               features, associated_experts=None) -> None:
        """Single one-shot write (reference API). Prefer `write_batch`."""
        self.write_batch([memory_id], self._tensor(features)[None, :])

    def write_batch(self, memory_ids: Sequence[str], features,
                    locations=None) -> None:
        """Batched one-shot writes."""
        features = self._tensor(features)
        B = features.shape[0]
        assert len(memory_ids) == B
        if locations is None:
            locations = self._tensor(self.current_location)[None].expand(
                B, self.config.spatial_dims)
        else:
            locations = self._tensor(locations)

        start = int(self.state.count)
        M = self.config.max_memories
        self._set_state(engine.write_memories(
            self.config, self.state, features, locations))

        for i, mid in enumerate(memory_ids):
            slot = (start + i) % M
            old = self._slot_ids[slot]
            if old is not None:
                self._id_to_slot.pop(old, None)
            self._slot_ids[slot] = mid
            self._id_to_slot[mid] = slot
        self._last_event_step = float(self.state.step)

        self._writes_since_rebuild += B
        if (self.use_centroid_index
                and self._writes_since_rebuild >= self.config.rebuild_interval
                and self.memory_count > self.config.k_centroids):
            self.rebuild_centroids()

    # ------------------------------------------------------------------
    # retrieval
    # ------------------------------------------------------------------
    def retrieve_similar_memories(self, query_features, location=None,
                                  k: int = 5) -> List[Tuple[str, float]]:
        """Single-query reference API -> [(memory_id, score)]."""
        if self.memory_count == 0:
            return []
        q = self._tensor(query_features)[None, :]
        loc = None if location is None else self._tensor(location)[None, :]
        res = self.retrieve_batch(q, loc, k=k)
        out = []
        for slot, score in zip(res.indices[0].tolist(),
                               res.scores[0].tolist()):
            if slot >= 0 and self._slot_ids[slot] is not None:
                out.append((self._slot_ids[slot], float(score)))
        return out

    def retrieve_batch(self, queries, query_locations=None,
                       k: int = 5) -> engine.RetrievalResult:
        """Batched retrieval returning device tensors."""
        queries = self._tensor(queries)
        if query_locations is not None:
            query_locations = self._tensor(query_locations)
        use_index = (self.use_centroid_index and self.index_ready
                     and self.memory_count > self.config.k_centroids)
        if not use_index:
            return engine.retrieve_bruteforce(
                self.config, self.state, queries, query_locations, k)
        aux = None
        if self.config.use_pallas_ivf and query_locations is None:
            if (self._aux_cache is None
                    or self._aux_cache[0] is not self.state):
                self._aux_cache = (
                    self.state, engine.build_ivf_aux(self.config, self.state))
            aux = self._aux_cache[1]
        return engine.retrieve(self.config, self.state, queries,
                               query_locations, k, aux=aux)

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------
    def decay_memories(self, decay_rate: float = 0.01) -> None:
        self._set_state(engine.decay_memories(self.state, decay_rate))

    def decay(self, rate: float = 0.01) -> None:
        self.decay_memories(rate)

    def tick(self, steps: float = 1.0) -> None:
        self._set_state(engine.tick(self.state, steps))

    def rebuild_centroids(self) -> None:
        if self.memory_count == 0 or not self.use_centroid_index:
            return
        self._set_state(engine.rebuild_centroids(
            self.config, self.state, self._generator))
        self._writes_since_rebuild = 0

    # ------------------------------------------------------------------
    # checkpointing (id table included)
    # ------------------------------------------------------------------
    def host_state_dict(self) -> Dict[str, Any]:
        """The host-side part of `state_dict` (string ids, location,
        rebuild counter), without copying the bank off the device."""
        return {
            "slot_ids": [i if i is not None else "" for i in self._slot_ids],
            "current_location": self.current_location,
            "writes_since_rebuild": self._writes_since_rebuild,
        }

    def state_dict(self) -> Dict[str, Any]:
        return {
            "memory_state": state_to_numpy(self.state),
            "cognitive_map": CognitiveMapParams(
                *[t.cpu().numpy() for t in self.cognitive_map]),
            **self.host_state_dict(),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._set_state(state_from_numpy(sd["memory_state"], self.device))
        self.cognitive_map = CognitiveMapParams(
            *[torch.tensor(np.asarray(x, np.float32), device=self.device)
              for x in sd["cognitive_map"]])
        self._slot_ids = np.array(
            [s if s else None for s in sd["slot_ids"]], dtype=object)
        self._id_to_slot = {s: i for i, s in enumerate(self._slot_ids)
                            if s is not None}
        self.current_location = np.asarray(sd["current_location"], np.float32)
        self._writes_since_rebuild = int(sd["writes_since_rebuild"])
