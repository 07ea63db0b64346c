"""Limbic system: the amygdala and a hippocampal context (counterpart of
`aura_snn_rag_tpu/models/brain/limbic.py`). With `n_place_cells` > 0 and
place-cell activity given, `memory_proj` projects the activity into model
space; otherwise the memory context is None.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.models.brain.amygdala import Amygdala
from aura_snn_rag_tpu_torch.models.layers import (
    Dense, draw_device, initialize)


class LimbicSystem(nn.Module):

    def __init__(self, d_model: int, n_place_cells: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.amygdala = Amygdala(d_model, device=draw)
        self.memory_proj = (Dense(n_place_cells, d_model, torch.float32, draw)
                            if n_place_cells > 0 else None)
        initialize(self, generator)
        self.to(dev)

    def forward(self, x: torch.Tensor,
                place_activity: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        """x [B, L, D]; place_activity [Np] rates from the hippocampus."""
        emotional_state = self.amygdala(x)
        memory_context = None
        if place_activity is not None and self.memory_proj is not None:
            memory_context = self.memory_proj(place_activity.to(x.dtype))
        return {"emotional_state": emotional_state,
                "memory_context": memory_context}
