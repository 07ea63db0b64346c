"""Emotion / intent / tone / personality multi-task head (counterpart of
`aura_snn_rag_tpu/models/emotion_head.py`): a shared two-layer ReLU trunk
over pooled features and four linear heads, and the weighted multi-task
cross-entropy with masked (label -1) entries.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.models.layers import (
    Dense, Dropout, draw_device, initialize)


class EmotionHeadConfig(NamedTuple):
    d_model: int = 256
    trunk_dim: int = 128
    n_emotions: int = 8      # joy/sad/anger/fear/surprise/disgust/trust/neutral
    n_intents: int = 6       # inform/ask/command/express/social/other
    n_tones: int = 4         # formal/casual/urgent/calm
    n_personality: int = 5   # big-five dominant trait
    dropout: float = 0.1


class EmotionPersonalityHead(nn.Module):
    """flax `EmotionPersonalityHead(config, deterministic)`: f32 `Dense`
    trunk1, trunk2 and the four heads, drawn from `generator`. Dropout
    after trunk1 runs only when the head is not `deterministic`, is in
    training mode and a forward gets a `dropout_seed` (`layers.Dropout`:
    the mask comes from a generator seeded with it)."""

    def __init__(self, config: EmotionHeadConfig = EmotionHeadConfig(),
                 deterministic: bool = True, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        cfg = self.config = config
        self.deterministic = deterministic
        f32 = torch.float32
        self.trunk1 = Dense(cfg.d_model, cfg.trunk_dim, f32, draw)
        self.dropout = Dropout(cfg.dropout)
        self.trunk2 = Dense(cfg.trunk_dim, cfg.trunk_dim, f32, draw)
        self.emotion_head = Dense(cfg.trunk_dim, cfg.n_emotions, f32, draw)
        self.intent_head = Dense(cfg.trunk_dim, cfg.n_intents, f32, draw)
        self.tone_head = Dense(cfg.trunk_dim, cfg.n_tones, f32, draw)
        self.personality_head = Dense(cfg.trunk_dim, cfg.n_personality, f32,
                                      draw)
        initialize(self, generator)
        self.to(dev)

    def forward(self, features: torch.Tensor,
                dropout_seed: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        """features [B, D] pooled text features -> per-task logits."""
        h = torch.relu(self.trunk1(features))
        if self.config.dropout > 0 and not self.deterministic:
            h = self.dropout(h, dropout_seed)
        h = torch.relu(self.trunk2(h))
        return {"emotion": self.emotion_head(h),
                "intent": self.intent_head(h),
                "tone": self.tone_head(h),
                "personality": self.personality_head(h)}


TASK_WEIGHTS = {"emotion": 1.0, "intent": 0.8, "tone": 0.5,
                "personality": 0.3}


def emotion_multitask_loss(logits: Dict[str, torch.Tensor],
                           labels: Dict[str, torch.Tensor],
                           weights: Optional[Dict[str, float]] = None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of per-task cross-entropies; entries labelled -1 are
    masked out (a task with every label -1 contributes 0)."""
    weights = weights or TASK_WEIGHTS
    total = torch.zeros((), device=next(iter(logits.values())).device)
    per_task = {}
    for task, lg in logits.items():
        if task not in labels:
            continue
        lab = labels[task]
        mask = (lab >= 0).to(torch.float32)
        ce = F.cross_entropy(lg, lab.clamp(min=0), reduction="none")
        ce = (ce * mask).sum() / mask.sum().clamp(min=1.0)
        per_task[task] = ce
        total = total + weights.get(task, 1.0) * ce
    return total, per_task
