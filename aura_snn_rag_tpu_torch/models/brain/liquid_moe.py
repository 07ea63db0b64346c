"""Liquid (CfC-style) cell and Liquid-MoE router (counterpart of
`aura_snn_rag_tpu/models/brain/liquid_moe.py`).

- `LiquidCell`: input-dependent time constant
  tau = min(tau_min + softplus(Vx), tau_max);
  h' = h + dt * (-h / (tau + 1e-6) + tanh(Wh + Ux)).
- `LiquidMoERouter`: one liquid step from a zero state, gate logits,
  temperature scaled by the attention gain, top-k probabilities
  renormalised (ties in index order, as `lax.top_k` takes them); the
  batch's expert usage is returned for the caller's EMA.
- `BanditGating`: UCB-1 expert selection on the host (numpy).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from aura_snn_rag_tpu_torch.models.layers import Dense


class XavierDense(Dense):
    """f32 `Dense` with flax's `xavier_uniform` kernel init."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__(in_features, out_features, torch.float32, device)

    def init_parameters(self, generator) -> None:
        out_f, in_f = self.weight.shape
        a = math.sqrt(6.0 / (in_f + out_f))
        nn.init.uniform_(self.weight, -a, a, generator=generator)
        nn.init.zeros_(self.bias)


class LiquidCell(nn.Module):

    def __init__(self, in_features: int, hidden_dim: int, dt: float = 0.02,
                 tau_min: float = 0.02, tau_max: float = 2.0, device=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.dt, self.tau_min, self.tau_max = dt, tau_min, tau_max
        self.V = XavierDense(in_features, hidden_dim, device)
        self.W = XavierDense(hidden_dim, hidden_dim, device)
        self.U = XavierDense(in_features, hidden_dim, device)

    def forward(self, x: torch.Tensor,
                h_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        if h_prev is None:
            h_prev = x.new_zeros(x.shape[:-1] + (self.hidden_dim,))
        tau = torch.clamp(self.tau_min + F.softplus(self.V(x)),
                          max=self.tau_max)
        gates = torch.tanh(self.W(h_prev) + self.U(x))
        dh = -h_prev / (tau + 1e-6) + gates
        return h_prev + self.dt * dh


class LiquidMoERouter(nn.Module):

    def __init__(self, in_features: int, hidden_dim: int, num_experts: int,
                 top_k: int = 2, temperature: float = 1.0, device=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.temperature = temperature
        self.cell = LiquidCell(in_features, hidden_dim, device=device)
        self.gate_proj = Dense(hidden_dim, num_experts, torch.float32,
                               device)

    def forward(self, x: torch.Tensor,
                attn_gain: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """x [B, D] pooled features -> weights [B, k] (renormalised),
        indices [B, k], probs [B, E], usage [E]."""
        logits = self.gate_proj(self.cell(x))
        if attn_gain is not None:
            if attn_gain.dim() == 1:
                attn_gain = attn_gain[:, None]
            temp = torch.clamp(self.temperature / (attn_gain + 1e-6),
                               0.1, 5.0)
            logits = logits / temp
        else:
            logits = logits / self.temperature
        probs = torch.softmax(logits, dim=-1)
        k = min(self.top_k, self.num_experts)
        # a stable descending sort keeps tied experts in index order, as
        # lax.top_k does (a silent row's probs are all equal); torch.topk
        # orders ties arbitrarily
        topk_probs, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                          stable=True)
        topk_probs, topk_idx = topk_probs[..., :k], topk_idx[..., :k]
        weights = topk_probs / (topk_probs.sum(-1, keepdim=True) + 1e-8)
        usage = torch.zeros(self.num_experts, device=x.device).index_add_(
            0, topk_idx.reshape(-1),
            torch.ones(topk_idx.numel(), device=x.device)) \
            / max(x.shape[0], 1)
        return {"weights": weights, "indices": topk_idx, "probs": probs,
                "usage": usage}


# the JAX package's back-compat name for the router
LiquidGatingNetwork = LiquidMoERouter


class BanditGating:
    """UCB-1 expert selection, host-side: reward max(0, 1 - error / 10)
    per update (incremental mean), a UCB exploration bonus, and the
    selected experts' gates renormalised by score mass."""

    def __init__(self, n_experts: int, exploration_factor: float = 0.1):
        self.n_experts = n_experts
        self.exploration_factor = exploration_factor
        self.mean_reward = np.zeros(n_experts, np.float64)
        self.pulls = np.zeros(n_experts, np.int64)
        self.total_pulls = 0

    def update(self, expert_idx: int, error: float) -> None:
        reward = max(0.0, 1.0 - 0.1 * error)
        self.pulls[expert_idx] += 1
        self.total_pulls += 1
        n = self.pulls[expert_idx]
        self.mean_reward[expert_idx] += (
            reward - self.mean_reward[expert_idx]) / n

    def get_ucb_scores(self) -> np.ndarray:
        # unpulled arms get the full exploration bonus via the epsilon floor
        eps = 1e-6
        t = max(self.total_pulls, 1) + 1
        bonus = np.sqrt(np.log(t) / (self.pulls + eps))
        return self.mean_reward + self.exploration_factor * bonus

    def select_top_k(self, k: int, base_gates: np.ndarray):
        scores = self.get_ucb_scores()
        k = min(k, self.n_experts)
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        gates = np.array(base_gates, copy=True)
        mass = float(scores[top].sum())
        if mass > 0:
            gates[top] = scores[top] / mass
        return top.tolist(), gates
