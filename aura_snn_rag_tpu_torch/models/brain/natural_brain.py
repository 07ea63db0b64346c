"""NaturalBrain: the fully wired brain-simulation model (counterpart of
`aura_snn_rag_tpu/models/brain/natural_brain.py`).

embed -> limbic (arousal, valence) -> thalamus (arousal + 0.1 cortisol +
0.1 norepinephrine) -> one cortex per region, its input scaled by
1 + 0.1 dopamine (the temporal cortex a `FullLanguageZone` over the
sequence, the others `NeuromorphicBrainZone`s over the sequence-mean) ->
basal ganglia -> sequence-mean + 0.1 x integrated -> vocab head. Hormone
levels are host floats (an `EndocrineSystem`'s `levels`), so they add no
sync; the arousal stays a 0-dim device tensor, one value for the batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.models.brain.basal_ganglia import BasalGanglia
from aura_snn_rag_tpu_torch.models.brain.limbic import LimbicSystem
from aura_snn_rag_tpu_torch.models.brain.thalamus import Thalamus
from aura_snn_rag_tpu_torch.models.language_zone import FullLanguageZone
from aura_snn_rag_tpu_torch.models.layers import (
    Dense, Embed, draw_device, initialize)
from aura_snn_rag_tpu_torch.zones.brain_zone import (
    BrainZoneConfig, NeuromorphicBrainZone)

DEFAULT_REGIONS = ("temporal_cortex", "prefrontal_cortex",
                   "parietal_cortex")


class NaturalBrain(nn.Module):

    def __init__(self, vocab_size: int, d_model: int = 128,
                 regions: Sequence[str] = DEFAULT_REGIONS,
                 num_experts: int = 4, zone_neurons: int = 64,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.regions = tuple(regions)
        self.d_model = d_model
        self.embedding = Embed(vocab_size, d_model, draw)
        self.limbic = LimbicSystem(d_model, device=draw, generator=generator)
        self.thalamus = Thalamus(d_model, self.regions, device=draw)
        initialize(self.embedding, generator)
        initialize(self.thalamus, generator)
        for region in self.regions:
            if region == "temporal_cortex":
                cortex = FullLanguageZone(d_model, num_experts=num_experts,
                                          device=draw, generator=generator)
            else:
                cortex = NeuromorphicBrainZone(BrainZoneConfig(
                    name=region, n_neurons=zone_neurons, input_dim=d_model,
                    output_dim=d_model), draw, generator)
            self.add_module(f"cortex_{region}", cortex)
        self.basal_ganglia = BasalGanglia(d_model, self.regions, draw,
                                          generator)
        self.vocab_head = Dense(d_model, vocab_size, torch.float32, draw)
        initialize(self.vocab_head, generator)
        self.to(dev)

    def forward(self, token_ids: torch.Tensor,
                hormone_levels: Optional[Dict[str, float]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """token_ids [B, T] -> (logits [B, vocab], info). `generator`
        draws the temporal cortex's Poisson spikes."""
        hormones = hormone_levels or {}
        x = F.embedding(token_ids, self.embedding.weight)       # [B, T, D]

        # 1. limbic assessment
        limbic = self.limbic(x)
        arousal = limbic["emotional_state"]["arousal"]

        # 2. thalamic routing modulated by arousal and stress hormones
        arousal_eff = arousal + 0.1 * float(hormones.get("cortisol", 0.0)) \
            + 0.1 * float(hormones.get("norepinephrine", 0.0))
        routed, routing = self.thalamus(x, {"arousal": arousal_eff})

        # 3. cortical processing, dopamine scaling the drive
        dopamine_scale = 1.0 + 0.1 * float(hormones.get("dopamine", 0.0))
        cortical: Dict[str, torch.Tensor] = {}
        info: Dict[str, Any] = {"routing": routing,
                                "emotion": limbic["emotional_state"]}
        for region in self.regions:
            signal = routed[region] * dopamine_scale
            cortex = getattr(self, f"cortex_{region}")
            if region == "temporal_cortex":
                out, zinfo = cortex(token_ids, signal, generator)
                info[f"{region}_info"] = {"spike_rate": zinfo["spike_rate"]}
            else:
                out, zstats = cortex(signal.mean(dim=1))
                info[f"{region}_info"] = zstats
            cortical[region] = out                               # [B, D]

        # 4. basal ganglia integration, residual, head
        integrated = self.basal_ganglia(cortical)
        pooled = x.mean(dim=1)
        final = pooled + 0.1 * (integrated if integrated is not None
                                else torch.zeros_like(pooled))
        return self.vocab_head(final), info
