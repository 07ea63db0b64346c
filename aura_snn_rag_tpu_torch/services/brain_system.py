"""NeuromorphicBrainSystem: the service facade of the brain zones
(counterpart of `aura_snn_rag_tpu/services/brain_system.py`).

One object wires an `EventBus`, a keyword-routed `NeuromorphicProcessor`
over the eight `DEFAULT_ZONES` (LIF populations of `n_neurons`), a
`NeuralPlasticityEngine` holding each zone's homeostatic bias (numpy), a
`StatsCollector`, a `HippocampalFormation` and a
`ContinuousLearningOrchestrator` whose `zone_executor` routes each
ingested item through the zones (feeds only with `enable_rss`).

Each zone call uploads the zone's bias to the device and reads its
average firing rate back to the host for the stats collector (one host
sync), as the JAX package does. The zones' weights come from a
`torch.Generator` seeded `seed` (on the CPU, so any device draws the
same); `models/convert.load_brain_system` carries a JAX system's zones
across.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import MemoryConfig
from aura_snn_rag_tpu_torch.memory.hippocampus import HippocampalFormation
from aura_snn_rag_tpu_torch.services.continuous_learning import (
    ContinuousLearningOrchestrator, create_default_feeds)
from aura_snn_rag_tpu_torch.zones.brain_zone import (
    BrainZoneConfig, NeuromorphicBrainZone, SpikingNeuronConfig)
from aura_snn_rag_tpu_torch.zones.events import EventBus
from aura_snn_rag_tpu_torch.zones.processor import (
    NeuralPlasticityEngine, NeuromorphicProcessor)
from aura_snn_rag_tpu_torch.zones.stats import StatsCollector

DEFAULT_ZONES = (
    ("prefrontal_cortex", {"reasoning", "planning"}),
    ("temporal_cortex", {"language", "audio"}),
    ("hippocampus", {"memory"}),
    ("parietal_cortex", {"spatial", "integration"}),
    ("occipital_cortex", {"visual"}),
    ("cerebellum", {"timing", "coordination"}),
    ("amygdala", {"emotion"}),
    ("insular_cortex", {"interoception"}),
)


class NeuromorphicBrainSystem:
    """Wired brain service: zones + routing + memory + optional feeds."""

    def __init__(self, d_model: int = 64, n_neurons: int = 64,
                 memory_config: Optional[MemoryConfig] = None,
                 enable_rss: bool = False, seed: int = 0, device="cuda"):
        self.d_model = d_model
        self.device = resolve_device(device)
        self.event_bus = EventBus()
        self.processor = NeuromorphicProcessor(
            d_model=d_model, event_bus=self.event_bus, device=self.device)
        self.plasticity = NeuralPlasticityEngine(event_bus=self.event_bus)
        self.stats = StatsCollector()
        self.hippocampus = HippocampalFormation(
            memory_config or MemoryConfig(
                max_memories=4096, feature_dim=d_model, k_centroids=32,
                n_place_cells=64, n_grid_cells=16, n_time_cells=8),
            seed=seed, device=self.device)

        self._zone_modules: Dict[str, NeuromorphicBrainZone] = {}
        generator = torch.Generator().manual_seed(seed)
        for name, caps in DEFAULT_ZONES:
            cfg = BrainZoneConfig(
                name=name, n_neurons=n_neurons, input_dim=d_model,
                output_dim=d_model,
                neuron_configs=(SpikingNeuronConfig("lif"),))
            self._zone_modules[name] = NeuromorphicBrainZone(
                cfg, self.device, generator).requires_grad_(False)
            self.plasticity.register_zone(name, n_neurons)
            self.processor.register_zone(
                name, self._make_forward(name), caps)

        self.orchestrator = ContinuousLearningOrchestrator(
            self.hippocampus,
            feeds=create_default_feeds() if enable_rss else None,
            memory_only=False, zone_executor=self._execute_zone_plan)

        self.event_bus.emit("brain_created", zones=len(self._zone_modules))

    def _make_forward(self, name: str):
        def forward(x):
            homeo = torch.as_tensor(self.plasticity.homeo_i[name],
                                    device=self.device)
            out, zstats = self._zone_modules[name](torch.atleast_2d(x),
                                                   homeo)
            self.stats.update_firing_rates(
                {name: float(zstats["avg_firing_rate"])})
            return out, zstats
        return forward

    def _features(self, features) -> torch.Tensor:
        return torch.as_tensor(np.asarray(features, np.float32),
                               device=self.device)[None, :]

    def _execute_zone_plan(self, features: np.ndarray, category: str):
        out, info = self.processor.run_plan(
            self._features(features), text=category,
            embedding=np.asarray(features[:self.d_model], np.float32))
        self.event_bus.emit("content_processed", category=category)
        return out, info

    def process_text(self, text: str, features: Optional[np.ndarray] = None):
        """Route a text (with an optional feature vector) through the
        zones: (output [1, d_model], {"plan", "zone_stats"})."""
        if features is None:
            features = self.orchestrator.hash_embedder.embed(text)[
                :self.d_model]
        return self.processor.run_plan(self._features(features), text=text)

    def get_health(self) -> Dict[str, Any]:
        return {
            "zones": list(self._zone_modules),
            "memory_count": self.hippocampus.memory_count,
            "processor_stats": self.processor.get_stats(),
            "recommendations": (self.processor.get_recommendations()
                                + self.stats.get_recommendations()),
        }
