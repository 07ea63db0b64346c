"""Thalamus: sensory gating + Liquid-MoE routing over cortical regions
(counterpart of `aura_snn_rag_tpu/models/brain/thalamus.py`).

A sigmoid sensory gate, scaled by (1 + arousal) and clamped to [0, 1],
multiplies the input; the gated sequence-mean is routed by a
`LiquidMoERouter` whose temperature the arousal scales; each region gets
the gated input times its routing gain (a dense [B, L, D] tensor per
region, zero gain where it was not routed).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from aura_snn_rag_tpu_torch.models.brain.liquid_moe import LiquidMoERouter
from aura_snn_rag_tpu_torch.models.layers import Dense


class Thalamus(nn.Module):

    def __init__(self, d_model: int, region_names: Sequence[str],
                 hidden_dim: int = 256, top_k: int = 3, device=None):
        super().__init__()
        self.region_names = tuple(region_names)
        n = len(self.region_names)
        self.sensory_gate = Dense(d_model, d_model, torch.float32, device)
        self.router = LiquidMoERouter(d_model, hidden_dim, n,
                                      top_k=min(top_k, n), device=device)

    def forward(self, x: torch.Tensor,
                limbic_state: Optional[Dict[str, torch.Tensor]] = None):
        """x [B, L, D] -> ({region: [B, L, D]}, routing dict)."""
        B = x.shape[0]
        gate = torch.sigmoid(self.sensory_gate(x))
        arousal = None
        if limbic_state is not None:
            arousal = limbic_state.get("arousal")
        if arousal is not None:
            gate = torch.clamp(gate * (1.0 + arousal), 0.0, 1.0)
        gated = x * gate
        pooled = gated.mean(dim=1)                               # [B, D]
        attn_gain = None
        if arousal is not None:
            attn_gain = torch.as_tensor(arousal, dtype=x.dtype,
                                        device=x.device).expand(B)[:, None]
        routing = self.router(pooled, attn_gain=attn_gain)
        gains = torch.zeros(B, len(self.region_names), dtype=x.dtype,
                            device=x.device).scatter_add(
            1, routing["indices"], routing["weights"].to(x.dtype))
        routed = {name: gated * gains[:, i][:, None, None]
                  for i, name in enumerate(self.region_names)}
        return routed, routing
