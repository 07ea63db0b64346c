"""Surrogate-gradient spike functions as `torch.autograd.Function`s.

Counterpart of `aura_snn_rag_tpu/ops/surrogate.py`, with the JAX
package's `custom_vjp` rules:

- `multi_bit_spike`: forward is floor + clip to [0, L] multi-bit spikes;
  backward is the triangular straight-through estimate
  `clip(1 - 2*|x - round(x)|, 0, 1)`, masked to the in-range interval
  [0, L + 1].
- `heaviside_spike`: forward is the binary spike `v >= 0`; backward is the
  fast-sigmoid surrogate, with s the slope, d/dv = g*s / (1 + s|v|)^2 and
  d/ds = -g*v / (1 + s|v|)^2, the latter summed over the dimensions the
  slope was broadcast along (a [D] slope against [B, D] potentials sums
  over the batch).
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


def _reduce_to_shape(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum `x` down to `shape`: leading broadcast dimensions first, then
    the dimensions that are 1 in `shape` (the JAX package's rule)."""
    shape = tuple(shape)
    if shape == ():
        return x.sum()
    extra = x.ndim - len(shape)
    if extra > 0:
        x = x.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (a, b) in enumerate(zip(x.shape, shape))
                 if b == 1 and a != 1)
    if axes:
        x = x.sum(dim=axes, keepdim=True)
    return x


class _HeavisideSpike(torch.autograd.Function):

    @staticmethod
    def forward(ctx, v: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(v, slope)
        return (v >= 0.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        v, slope = ctx.saved_tensors
        denom = (1.0 + slope * v.abs()) ** 2
        dv = g * slope / denom if ctx.needs_input_grad[0] else None
        dslope = (_reduce_to_shape(-g * v / denom, slope.shape)
                  if ctx.needs_input_grad[1] else None)
        return dv, dslope


def heaviside_spike(v: torch.Tensor, slope) -> torch.Tensor:
    """Binary spike: 1 where v >= 0, with the fast-sigmoid surrogate
    gradient for v and for the (learnable) slope."""
    return _HeavisideSpike.apply(v, torch.as_tensor(slope, dtype=v.dtype,
                                                    device=v.device))
