"""Spike-aware core ops (counterpart of `aura_snn_rag_tpu/ops/snn_ops.py`):
a spike-driven linear scaled by 1/sqrt(fan_in), softmax with a
temperature, SiLU, a five-segment piecewise-linear SiLU (a lookup-table
design for neuromorphic hardware) and RMSNorm."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def snn_matmul(spikes: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """spikes [..., in] @ weight [in, out] (+ bias), over sqrt(in)."""
    fan_in = spikes.shape[-1]
    out = spikes @ weight
    if bias is not None:
        out = out + bias
    return out / math.sqrt(fan_in)


def snn_softmax(x: torch.Tensor, axis: int = -1,
                temperature: float = 1.0) -> torch.Tensor:
    return torch.softmax(x / max(temperature, 1e-6), dim=axis)


def snn_silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def piecewise_silu(x: torch.Tensor) -> torch.Tensor:
    """Five linear segments: 0 below -4, then 0.05 (x + 4) - 0.2,
    0.5 x (1 + 0.25 x) on [-1, 1), x - 0.3 + 0.05 (x - 1) on [1, 4), x."""
    return torch.where(
        x < -4.0, 0.0,
        torch.where(x < -1.0, 0.05 * (x + 4.0) - 0.2,
                    torch.where(x < 1.0, 0.5 * x * (1.0 + 0.25 * x),
                                torch.where(x < 4.0,
                                            x - 0.3 + 0.05 * (x - 1.0),
                                            x))))


def snn_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale
