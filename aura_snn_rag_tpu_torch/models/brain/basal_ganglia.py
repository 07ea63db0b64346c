"""Basal ganglia: gated integration of the cortical regions' outputs
(counterpart of `aura_snn_rag_tpu/models/brain/basal_ganglia.py`): a
learnable scalar gate per region (`gate_<name>`, 1.0 at init) through a
sigmoid, the gated sum over the regions present divided by the total gate
weight, then a Dense and a LayerNorm. None when no region is present.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.models.layers import (
    Dense, LayerNorm, draw_device, initialize)


class BasalGanglia(nn.Module):

    def __init__(self, d_model: int, region_names: Sequence[str],
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.region_names = tuple(region_names)
        for name in self.region_names:
            self.register_parameter(f"gate_{name}", nn.Parameter(
                torch.ones((), device=draw)))
        self.integration = Dense(d_model, d_model, torch.float32, draw)
        self.integration_norm = LayerNorm(d_model, torch.float32, draw)
        initialize(self, generator)
        self.to(dev)

    def forward(self, cortical_outputs: Dict[str, torch.Tensor]
                ) -> Optional[torch.Tensor]:
        integrated = None
        total_w = 0.0
        for name in self.region_names:
            if name not in cortical_outputs:
                continue
            w = torch.sigmoid(getattr(self, f"gate_{name}"))
            contrib = cortical_outputs[name] * w
            integrated = contrib if integrated is None else integrated + contrib
            total_w = total_w + w
        if integrated is None:
            return None
        integrated = integrated / (total_w + 1e-6)
        return self.integration_norm(self.integration(integrated))
