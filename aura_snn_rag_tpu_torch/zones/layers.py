"""Spiking layer primitives (counterpart of
`aura_snn_rag_tpu/zones/layers.py`):

- `SpikingLayer`: Dense -> dropout -> LIF; the LIF's beta and threshold
  are buffers (flax's "constants" collection), its surrogate slope a
  parameter; returns (spikes, stats);
- `AdaptiveSpikingLayer`: Dense -> LIF at an explicit threshold state ->
  a fixed lateral-inhibition matrix (a buffer) subtracted as
  relu(spikes @ W^T) * 0.1, clipped to [0, 1] -> the threshold moved
  toward a 10% target rate; returns (spikes, new threshold, stats);
- `ReservoirLayer`: an echo-state reservoir, a sparse fixed recurrent
  matrix (a buffer) scaled to spectral radius 0.95 by 20 power-iteration
  steps, the leaky tanh update over time, a Dense readout;
- `make_layer`: one of the three by name.

The JAX package draws the constant matrices from `PRNGKey(0)` and
`PRNGKey(1)`; PyTorch cannot draw threefry's bits, so these layers draw
the same distributions from the `torch.Generator` they are given (on its
device, then moved to theirs), and
`models/convert.module_from_numpy` carries the JAX package's constants
across where two runs must agree. Inputs come before outputs in the
constructors (flax infers the input width at its first call).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.models.layers import Dense, draw_device
from aura_snn_rag_tpu_torch.ops.neurons import LIFParams, lif_scan


def _dense(in_features, features, dev, generator, use_bias=True) -> Dense:
    layer = Dense(in_features, features, torch.float32, dev, use_bias)
    layer.init_parameters(generator)
    return layer


class SpikingLayer(nn.Module):

    def __init__(self, in_features: int, features: int, beta: float = 0.5,
                 threshold: float = 0.6, init_slope: float = 15.0,
                 dropout: float = 0.0, deterministic: bool = True,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dropout = dropout
        self.deterministic = deterministic
        self.linear = _dense(in_features, features,
                             draw_device(generator, dev), generator)
        self.register_buffer("beta", torch.full((features,), beta))
        self.register_buffer("threshold", torch.full((features,), threshold))
        self.slope = nn.Parameter(torch.full((features,), init_slope))
        self.to(dev)

    def forward(self, x: torch.Tensor, mem0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x [B, T, D_in] currents -> (spikes [B, T, features], stats).
        Dropout runs when the layer is not deterministic, with its mask
        drawn from `generator` (on x's device)."""
        h = self.linear(x)
        if self.dropout > 0 and not self.deterministic:
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) < 1.0 - self.dropout
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
        params = LIFParams(self.beta, self.threshold, self.slope)
        spikes, mem = lif_scan(params, h, mem0)
        stats = {"firing_rate": spikes.mean(),
                 "spike_count": spikes.sum(),
                 "mem_mean": mem.mean()}
        return spikes, stats


class AdaptiveSpikingLayer(nn.Module):

    def __init__(self, in_features: int, features: int, beta: float = 0.5,
                 threshold: float = 0.6, init_slope: float = 15.0,
                 target_rate: float = 0.1, inhibition_strength: float = 0.1,
                 adapt_rate: float = 0.01, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.features = features
        self.beta_value = beta
        self.threshold_value = threshold
        self.target_rate = target_rate
        self.adapt_rate = adapt_rate
        self.linear = _dense(in_features, features, draw, generator)
        self.slope = nn.Parameter(torch.full((features,), init_slope))
        # a fixed random lateral inhibition, zero on the diagonal
        inhib = (torch.randn(features, features, generator=generator,
                             device=draw)
                 * inhibition_strength
                 * (1 - torch.eye(features, device=draw)))
        self.register_buffer("lateral_inhibition", inhib)
        self.to(dev)

    def forward(self, x: torch.Tensor,
                threshold_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        """Returns (spikes, new threshold state, stats)."""
        h = self.linear(x)
        if threshold_state is None:
            threshold_state = torch.full((self.features,),
                                         self.threshold_value,
                                         device=h.device)
        params = LIFParams(
            torch.full((self.features,), self.beta_value, device=h.device),
            threshold_state, self.slope)
        spikes, _ = lif_scan(params, h)
        # lateral inhibition as a subtractive recurrent correction
        inhibited = spikes - torch.relu(
            spikes @ self.lateral_inhibition.T) * 0.1
        spikes = torch.clamp(inhibited, 0.0, 1.0)

        # homeostatic threshold adaptation toward the target rate
        rate = spikes.mean(dim=tuple(range(spikes.ndim - 1)))
        new_threshold = threshold_state + self.adapt_rate * (
            rate - self.target_rate)
        new_threshold = torch.clamp(new_threshold, 0.1, 5.0)
        stats = {"firing_rate": spikes.mean(),
                 "threshold_mean": new_threshold.mean()}
        return spikes, new_threshold, stats


def _recurrent_matrix(features: int, spectral_radius: float,
                      sparsity: float, generator, device) -> torch.Tensor:
    """A sparse normal matrix scaled to `spectral_radius` by 20 steps of
    power iteration."""
    W = torch.randn(features, features, generator=generator, device=device)
    keep = torch.rand(features, features, generator=generator,
                      device=device) > sparsity
    W = W * keep
    v = torch.ones(features, device=device) / math.sqrt(features)
    for _ in range(20):
        v = W @ v
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    lam = torch.abs(v @ (W @ v))
    return W * (spectral_radius / (lam + 1e-12))


class ReservoirLayer(nn.Module):

    def __init__(self, in_features: int, features: int,
                 spectral_radius: float = 0.95, sparsity: float = 0.9,
                 leak: float = 0.3, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.features = features
        self.leak = leak
        self.register_buffer("W_rec", _recurrent_matrix(
            features, spectral_radius, sparsity, generator, draw))
        self.input_proj = _dense(in_features, features, draw, generator,
                                 use_bias=False)
        self.readout = _dense(features, features, draw, generator)
        self.to(dev)

    def forward(self, x: torch.Tensor,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, D_in] -> (readout [B, T, features], final state)."""
        h_in = self.input_proj(x)                              # [B, T, F]
        state = (x.new_zeros(x.shape[:-2] + (self.features,))
                 if state0 is None else state0)
        states = []
        for t in range(h_in.shape[-2]):
            state = ((1 - self.leak) * state + self.leak * torch.tanh(
                h_in[..., t, :] + state @ self.W_rec.T))
            states.append(state)
        return self.readout(torch.stack(states, dim=-2)), state


def make_layer(neuron_type: str, in_features: int, features: int, **kw):
    """A layer by type name ('spiking' | 'adaptive' | 'reservoir')."""
    types = {
        "spiking": SpikingLayer,
        "adaptive": AdaptiveSpikingLayer,
        "reservoir": ReservoirLayer,
    }
    if neuron_type not in types:
        raise ValueError(f"unknown neuron_type {neuron_type!r}; "
                         f"expected one of {sorted(types)}")
    return types[neuron_type](in_features, features, **kw)
