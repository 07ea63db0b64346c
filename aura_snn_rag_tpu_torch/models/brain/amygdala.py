"""Amygdala: arousal and valence from token features (counterpart of
`aura_snn_rag_tpu/models/brain/amygdala.py`).

A two-layer MLP (ReLU, then tanh) on the sequence-mean of the features,
averaged over the batch: arousal in [0, 1], valence in [-1, 1], as 0-dim
device tensors (no host sync). `build_prosody` broadcasts them to the
[B, L, 4] prosody tensor [arousal, valence, arousal, valence].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from aura_snn_rag_tpu_torch.models.layers import Dense


class Amygdala(nn.Module):
    """flax `Amygdala(d_model, hidden)`: f32 `Dense` fc1 and fc2 with
    flax's default initialisers (`layers.initialize` draws them)."""

    def __init__(self, d_model: int, hidden: int = 64, device=None):
        super().__init__()
        self.fc1 = Dense(d_model, hidden, torch.float32, device)
        self.fc2 = Dense(hidden, 2, torch.float32, device)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, L, D] -> {'arousal', 'valence'}, 0-dim tensors."""
        pooled = x.mean(dim=1)                                   # [B, D]
        h = torch.relu(self.fc1(pooled))
        sentiment = torch.tanh(self.fc2(h))                      # [B, 2]
        avg = sentiment.mean(dim=0)
        return {"arousal": (avg[0] + 1.0) / 2.0, "valence": avg[1]}


def build_prosody(arousal: torch.Tensor, valence: torch.Tensor,
                  batch: int, seq_len: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, L, 4] prosody = [arousal, valence, arousal, valence]."""
    pros = torch.stack([arousal, valence, arousal, valence]).to(dtype)
    return pros[None, None, :].expand(batch, seq_len, 4)
