"""Spiking neuron dynamics over time steps.

Counterpart of `aura_snn_rag_tpu/ops/neurons.py`. Ported so far: the
generalised integrate-and-fire neuron (`GIFParams`, `gif_params`,
`gif_scan`, `gif_scan_const`), which the spiking FFN of the LM runs, and
the linear leaky integrator `leaky_integrate` (the STDP learner's
eligibility traces). The JAX package scans time with `lax.scan`; here
each time step is a few elementwise PyTorch ops in a Python loop (T = 4
in the LM). LIF, Izhikevich and AdEx come in a later slice.

The parameters are 0-dim tensors of the compute dtype, as in the JAX
package, so in bf16 every step rounds to bf16 as there.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from aura_snn_rag_tpu_torch.ops.surrogate import multi_bit_spike


class GIFParams(NamedTuple):
    decay: torch.Tensor       # scalar exp(-dt/tau)
    threshold: torch.Tensor   # scalar baseline theta_0
    alpha: torch.Tensor       # scalar threshold adaptation rate
    levels: float             # multi-bit level count L


def gif_params(levels: int = 16, dt: float = 1.0, tau: float = 10.0,
               threshold: float = 1.0, alpha: float = 0.01,
               dtype: torch.dtype = torch.float32) -> GIFParams:
    return GIFParams(
        decay=torch.tensor(math.exp(-dt / tau), dtype=dtype),
        threshold=torch.tensor(threshold, dtype=dtype),
        alpha=torch.tensor(alpha, dtype=dtype),
        levels=float(levels),
    )


def _gif_step(p: GIFParams, v: torch.Tensor, theta: torch.Tensor,
              current: torch.Tensor):
    """One step (gif_neuron.py:54-71 of the reference): v = v*decay + i;
    clamp to +-2*L*theta; spike = floor(v/theta) clipped to [0, L]; soft
    reset v -= spike*theta; theta += alpha*spike - alpha*(theta - theta_0).
    The operations and their order are the JAX package's, so at f32 both
    round alike: `floor` turns a last-bit difference into a whole level."""
    v = v * p.decay + current
    clamp = p.levels * theta * 2.0
    v = torch.clamp(v, -clamp, clamp)
    spk = multi_bit_spike(v / (theta + 1e-6), p.levels)
    v = v - spk * theta
    theta = theta + p.alpha * spk - p.alpha * (theta - p.threshold)
    return v, theta, spk


def _initial_state(p: GIFParams, like: torch.Tensor, state):
    if state is not None:
        return state
    return (torch.zeros_like(like),
            torch.full_like(like, float(p.threshold)))


def gif_scan(params: GIFParams, currents: torch.Tensor,
             state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Generalized-IF multi-bit spiking over [..., T, D] currents.
    Returns (spikes [..., T, D], (v, theta))."""
    v, theta = _initial_state(params, currents[..., 0, :], state)
    spikes = []
    for t in range(currents.shape[-2]):
        v, theta, spk = _gif_step(params, v, theta, currents[..., t, :])
        spikes.append(spk)
    return torch.stack(spikes, dim=-2), (v, theta)


def gif_scan_const(params: GIFParams, current: torch.Tensor, timesteps: int,
                   state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """GIF dynamics over `timesteps` steps of a CONSTANT [..., D] current
    (the spiking FFN's first stage, whose linears run once per token, not
    once per step). Returns (spikes [..., T, D], (v, theta))."""
    v, theta = _initial_state(params, current, state)
    spikes = []
    for _ in range(timesteps):
        v, theta, spk = _gif_step(params, v, theta, current)
        spikes.append(spk)
    return torch.stack(spikes, dim=-2), (v, theta)


def leaky_integrate(decay, x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Linear leaky integrator v_t = decay * v_{t-1} + x_t along `axis`.

    The recurrence is linear, so it runs as an inclusive scan of
    (d, v) pairs under (d1, v1) . (d2, v2) = (d1 d2, v2 + d2 v1), the
    JAX package's `associative_scan` operator, in log2(T) Hillis-Steele
    steps of whole-tensor ops. `decay` broadcasts against x with `axis`
    moved to the front, as there."""
    v = x.movedim(axis, 0)
    d = torch.broadcast_to(torch.as_tensor(decay, dtype=v.dtype,
                                           device=v.device), v.shape)
    shift = 1
    while shift < v.shape[0]:
        v = torch.cat([v[:shift], v[shift:] + d[shift:] * v[:-shift]])
        d = torch.cat([d[:shift], d[shift:] * d[:-shift]])
        shift *= 2
    return v.movedim(0, axis)
