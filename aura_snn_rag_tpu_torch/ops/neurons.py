"""Spiking neuron dynamics over time steps.

Counterpart of `aura_snn_rag_tpu/ops/neurons.py`: the leaky
integrate-and-fire neuron (`LIFParams`, `lif_params`, `lif_scan`, with the
`heaviside_spike` surrogate), Izhikevich's neuron (`IzhikevichParams`,
`izhikevich_params`, `izhikevich_scan`) and the adaptive exponential
integrate-and-fire neuron (`AdExParams`, `adex_params`, `adex_scan`),
which the brain zones run; the generalised integrate-and-fire neuron
(`GIFParams`, `gif_params`, `gif_scan`, `gif_scan_const`), which the
spiking FFN of the LM runs; and the linear leaky integrator
`leaky_integrate` (the STDP learner's eligibility traces). The JAX
package scans time with `lax.scan`; here each time step is a few
elementwise PyTorch ops in a Python loop, in the JAX step's order of
operations.

The scalar parameters are 0-dim tensors of the compute dtype, as in the
JAX package, so in bf16 every step rounds to bf16 as there. The
Izhikevich and AdEx scans make each of them a 0-dim tensor on the
currents' device first (a fill, no copy from the host): a CPU scalar
would reach a CUDA kernel as a host constant, and CUDA divides by one by
multiplying with its reciprocal, which is not JAX's division.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from aura_snn_rag_tpu_torch.ops.surrogate import (
    heaviside_spike, multi_bit_spike)


def _on(params, like: torch.Tensor):
    """`params` (a named tuple of scalars) as 0-dim tensors of `like`'s
    dtype on its device."""
    return type(params)(*(
        x if torch.is_tensor(x) and x.device == like.device
        and x.dtype == like.dtype
        else torch.full((), float(x), dtype=like.dtype, device=like.device)
        for x in params))


class LIFParams(NamedTuple):
    beta: torch.Tensor       # [D] membrane decay
    threshold: torch.Tensor  # [D]
    slope: torch.Tensor      # [D] learnable surrogate slope


def lif_params(size: int, beta: float = 0.5, threshold: float = 0.6,
               init_slope: float = 15.0, dtype: torch.dtype = torch.float32,
               device=None) -> LIFParams:
    return LIFParams(
        beta=torch.full((size,), beta, dtype=dtype, device=device),
        threshold=torch.full((size,), threshold, dtype=dtype, device=device),
        slope=torch.full((size,), init_slope, dtype=dtype, device=device),
    )


def lif_scan(params: LIFParams, currents: torch.Tensor,
             mem0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LIF over a [..., T, D] current sequence: mem = beta*mem + I;
    spike = H(mem - threshold) (fast-sigmoid surrogate); soft reset
    mem -= spike*threshold. Returns (spikes [..., T, D], mem [..., D])."""
    mem = torch.zeros_like(currents[..., 0, :]) if mem0 is None else mem0
    spikes = []
    for t in range(currents.shape[-2]):
        mem = params.beta * mem + currents[..., t, :]
        spk = heaviside_spike(mem - params.threshold, params.slope)
        mem = mem - spk * params.threshold
        spikes.append(spk)
    return torch.stack(spikes, dim=-2), mem


class IzhikevichParams(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    dt: torch.Tensor


def izhikevich_params(a=0.02, b=0.2, c=-65.0, d=6.0, dt=0.2,
                      dtype: torch.dtype = torch.float32
                      ) -> IzhikevichParams:
    return IzhikevichParams(*(torch.tensor(v, dtype=dtype)
                              for v in (a, b, c, d, dt)))


def izhikevich_scan(params: IzhikevichParams, currents: torch.Tensor,
                    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Izhikevich dynamics over [..., T, D] currents; spikes are hard (no
    gradient): dv = 0.04 v^2 + 5 v + 140 - u + I; du = a(bv - u); a spike
    at v >= 30 resets v to c and adds d to u. Returns (spikes, (v, u))."""
    p = _on(params, currents)
    if state is None:
        v = torch.full_like(currents[..., 0, :], -65.0)
        u = p.b * v
    else:
        v, u = state
    spikes = []
    for t in range(currents.shape[-2]):
        v = v + p.dt * (0.04 * v * v + 5.0 * v + 140.0 - u
                        + currents[..., t, :])
        u = u + p.dt * (p.a * (p.b * v - u))
        spk = (v >= 30.0).to(v.dtype)
        fired = spk > 0
        v = torch.where(fired, p.c, v)
        u = torch.where(fired, u + p.d, u)
        spikes.append(spk)
    return torch.stack(spikes, dim=-2), (v, u)


class AdExParams(NamedTuple):
    tau_m: torch.Tensor
    E_L: torch.Tensor
    V_T: torch.Tensor
    Delta_T: torch.Tensor
    R: torch.Tensor
    tau_w: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    V_reset: torch.Tensor
    V_spike: torch.Tensor
    dt: torch.Tensor


def adex_params(C=200.0, g_L=10.0, E_L=-70.0, V_T=-50.0, Delta_T=2.0,
                tau_w=120.0, a=0.0, b=0.0, R=1.0, V_reset=-65.0,
                V_spike=30.0, dt=0.1, dtype: torch.dtype = torch.float32
                ) -> AdExParams:
    tau_m = C / max(1e-6, g_L)          # in Python floats, as in JAX
    vals = (tau_m, E_L, V_T, Delta_T, R, tau_w, a, b, V_reset, V_spike, dt)
    return AdExParams(*(torch.tensor(v, dtype=dtype) for v in vals))


def adex_scan(params: AdExParams, currents: torch.Tensor,
              state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Adaptive-exponential IF over [..., T, D] currents. Returns
    (spikes, (V, w))."""
    p = _on(params, currents)
    if state is None:
        V = p.E_L.expand_as(currents[..., 0, :]).clone()
        w = torch.zeros_like(V)
    else:
        V, w = state
    spikes = []
    for t in range(currents.shape[-2]):
        exp_term = p.Delta_T * torch.exp((V - p.V_T) / p.Delta_T)
        V = V + p.dt * ((-(V - p.E_L) + exp_term - p.R * w
                         + p.R * currents[..., t, :]) / p.tau_m)
        w = w + p.dt * ((p.a * (V - p.E_L) - w) / p.tau_w)
        spk = (V >= p.V_spike).to(V.dtype)
        fired = spk > 0
        V = torch.where(fired, p.V_reset, V)
        w = torch.where(fired, w + p.b, w)
        spikes.append(spk)
    return torch.stack(spikes, dim=-2), (V, w)


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
