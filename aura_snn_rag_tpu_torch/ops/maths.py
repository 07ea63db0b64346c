"""Addition-only maths of the brain zones (counterpart of
`aura_snn_rag_tpu/ops/maths.py`).

- `addition_linear`: output = -sum_i |w_i - x| (+ bias), an L1 distance
  in place of a dot product;
- `additive_receptance`: clip(0.5 + 0.25 (theta - L1(x, p)), 0, 1);
- `sign_activation`: sign(x - theta), with the triangular straight-through
  gradient clip(1 - |x - theta|, 0, 1);
- `AdditionLinearModule`: `addition_linear` over learned patterns, stored
  as uniform(0, 0.2) and centred by -0.1 in the forward, as the flax
  module stores them, so its `weight_patterns` load unchanged;
- `softmax_np`, `softplus_np`, `sigmoid_np`: numpy helpers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn


def addition_linear(x: torch.Tensor, weight_patterns: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., D_in], weight_patterns [D_out, D_in] -> [..., D_out]."""
    out = -(x[..., None, :] - weight_patterns).abs().sum(dim=-1)
    if bias is not None:
        out = out + bias
    return out


def additive_receptance(x: torch.Tensor, patterns: torch.Tensor,
                        threshold) -> torch.Tensor:
    """Addition-only sigmoid gate: clip(0.5 + 0.25 (theta - L1(x, p)),
    0, 1)."""
    dists = (x[..., None, :] - patterns).abs().sum(dim=-1)
    return torch.clamp(0.5 + 0.25 * (threshold - dists), 0.0, 1.0)


class _SignActivation(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: torch.Tensor, threshold: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.threshold = threshold
        return torch.sign(x - threshold)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        grad = torch.clamp(1.0 - (x - ctx.threshold).abs(), 0.0, 1.0)
        return g * grad, None


def sign_activation(x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    return _SignActivation.apply(x, float(threshold))


class AdditionLinearModule(nn.Module):
    """`addition_linear` over `weight_patterns` [features, in_features]."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = False, device=None):
        super().__init__()
        self.weight_patterns = nn.Parameter(
            torch.empty(features, in_features, device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    def init_parameters(self, generator) -> None:
        """flax's `uniform(scale=0.2)`: U[0, 0.2); zero bias."""
        with torch.no_grad():
            self.weight_patterns.uniform_(0.0, 0.2, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # centre uniform(0, 0.2) to (-0.1, 0.1)
        return addition_linear(x, self.weight_patterns - 0.1, self.bias)


def softmax_np(x: np.ndarray, temp: float = 1.0) -> np.ndarray:
    x = np.asarray(x, np.float64) / max(1e-8, temp)
    x = x - np.max(x)
    e = np.exp(x)
    return e / (e.sum() + 1e-12)


def softplus_np(x):
    return np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0)


def sigmoid_np(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
