"""Spike <-> continuous bridges (counterpart of
`aura_snn_rag_tpu/ops/spike_bridge.py`):

- `spikes_to_continuous` pools [..., T, D] spikes over time: "rate" (the
  mean), "temporal" (weights exp(t / (T - 1)), normalised, so late steps
  weigh more) or "phase" (the phase of the fundamental of the FFT along
  time, over pi, in (-1, 1]);
- `continuous_to_spikes` makes [..., T, D] spikes of [..., D] values:
  "poisson" (uniform draws from a `torch.Generator`, on its device,
  below sigmoid(x)) or
  "temporal" (step t fires while sigmoid(x) > (t + 1) / (T + 1)).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def spikes_to_continuous(spikes: torch.Tensor, mode: str = "rate",
                         axis: int = -2) -> torch.Tensor:
    """[..., T, D] spikes -> [..., D] continuous features."""
    T = spikes.shape[axis]
    if mode == "rate":
        return spikes.mean(dim=axis)
    if mode == "temporal":
        w = torch.exp(torch.arange(T, dtype=spikes.dtype,
                                   device=spikes.device) / max(T - 1, 1))
        w = w / w.sum()
        shape = [1] * spikes.ndim
        shape[axis] = T
        return (spikes * w.reshape(shape)).sum(dim=axis)
    if mode == "phase":
        fft = torch.fft.rfft(spikes, dim=axis)
        fund = fft.select(axis, 1 if fft.shape[axis] > 1 else 0)
        return torch.angle(fund) / math.pi
    raise ValueError(f"unknown bridge mode {mode!r}")


def continuous_to_spikes(x: torch.Tensor, timesteps: int,
                         generator: Optional[torch.Generator] = None,
                         mode: str = "poisson") -> torch.Tensor:
    """[..., D] continuous -> [..., T, D] spikes. "poisson" draws from
    `generator` on the generator's device and moves the draw to x's (so a
    CPU generator gives the card the CPU's draws); without a generator it
    draws on x's device."""
    p = torch.sigmoid(x)[..., None, :]
    if mode == "poisson":
        dev = generator.device if generator is not None else x.device
        u = torch.rand(x.shape[:-1] + (timesteps, x.shape[-1]),
                       generator=generator, dtype=x.dtype, device=dev)
        return (u.to(x.device) < p).to(x.dtype)
    if mode == "temporal":
        thresholds = (torch.arange(timesteps, dtype=x.dtype, device=x.device)
                      + 1.0) / (timesteps + 1.0)
        shape = (1,) * (x.ndim - 1) + (timesteps, 1)
        return (p > thresholds.reshape(shape)).to(x.dtype)
    raise ValueError(f"unknown bridge mode {mode!r}")
