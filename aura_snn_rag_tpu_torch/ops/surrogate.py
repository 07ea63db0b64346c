"""Surrogate-gradient spike functions as `torch.autograd.Function`s.

Counterpart of `aura_snn_rag_tpu/ops/surrogate.py`. Ported so far:
`multi_bit_spike`, with the JAX package's `custom_vjp` rule: forward is
floor + clip to [0, L] multi-bit spikes; backward is the triangular
straight-through estimate `clip(1 - 2*|x - round(x)|, 0, 1)`, masked to
the in-range interval [0, L + 1]. `heaviside_spike` comes with the LIF
neurons that use it.
"""

from __future__ import annotations

import torch


class _MultiBitSpike(torch.autograd.Function):

    @staticmethod
    def forward(ctx, v: torch.Tensor, levels: float) -> torch.Tensor:
        ctx.save_for_backward(v)
        ctx.levels = levels
        return torch.clamp(torch.floor(v), 0.0, levels)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (v,) = ctx.saved_tensors
        # torch.round, like jnp.round, rounds half to even
        dist = (v - torch.round(v)).abs()
        grad_scale = torch.clamp(1.0 - 2.0 * dist, 0.0, 1.0)
        in_range = ((v >= 0.0) & (v <= ctx.levels + 1.0)).to(g.dtype)
        return g * in_range * grad_scale, None


def multi_bit_spike(v: torch.Tensor, levels: float) -> torch.Tensor:
    """Multi-bit spike: floor(v) clipped to [0, levels]."""
    return _MultiBitSpike.apply(v, float(levels))
