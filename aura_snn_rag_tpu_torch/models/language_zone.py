"""Spiking mixture-of-experts language zones (counterpart of
`aura_snn_rag_tpu/models/language_zone.py`).

- `SNNExpert`: Synapsis -> GIF -> Synapsis -> GIF over time, time-mean,
  linear readout; both Synapsis layers in f32;
- `topk_dispatch`: the capacity plan of top-k routing (GShard style,
  static shapes): a one-hot cumsum ranks the assignments token-major, so
  earlier tokens win capacity ties;
- `ExpertBank`: E experts with stacked [E, ...] parameters
  (`StackedLinear`, the layout of the flax `nn.vmap` tree), evaluated in
  one batched product per layer and one `gif_scan` over [E, N, T, H], so
  the launch count does not grow with E. Dense mode runs every expert on
  every row; sparse mode routes rows into [E, C, T, D] capacity buckets
  and combines the outputs with the routing weights;
- `FullLanguageZone`: prosody gains -> prosody-modulated GIF encoder ->
  rate bridge -> liquid router -> expert bank (sparse, or dense with
  `dense_dispatch`) -> Poisson bridge (drawn from a `torch.Generator`;
  a fixed seed 0 when none is given, as JAX's `PRNGKey(0)`) -> GIF
  decoder -> LayerNorm;
- `MoELanguageZone`: embedding -> zone -> vocab head, a standalone LM.

`capacity` is a Python int from B, k, E and the capacity factor;
`dropped_fraction` stays a device scalar, so neither syncs.

Expert parallelism: `parallel.mesh.shard_params` over a 'model' axis
larger than 1 leaves each rank E/n of an `ExpertBank`'s stacked experts
(the JAX rule `experts/` -> P('model', ...)); the bank then runs its own
experts' buckets of the replicated dispatch plan and sums the ranks'
partial [B, D] outputs with one `reduce_out` (dense mode gathers the
experts' outputs). Routing, capacity and `dropped_fraction` are the
whole bank's, as before.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import LiquidMoERouter
from aura_snn_rag_tpu_torch.models.layers import (
    Dense, Embed, LayerNorm, Synapsis, draw_device, initialize,
    lecun_normal_)
from aura_snn_rag_tpu_torch.models.prosody import (
    prosody_attention_gains, prosody_gif_scan)
from aura_snn_rag_tpu_torch.ops.neurons import gif_params, gif_scan
from aura_snn_rag_tpu_torch.ops.spike_bridge import (
    continuous_to_spikes, spikes_to_continuous)
from aura_snn_rag_tpu_torch.parallel.collectives import (
    copy_in, gather_dim, reduce_out)


class SNNExpert(nn.Module):
    """Synapsis -> GIF x 2 over time, mean-pooled, linear readout."""

    def __init__(self, in_features: int, hidden_dim: int, output_dim: int,
                 levels: int = 8, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.levels = levels
        f32 = torch.float32
        self.syn1 = Synapsis(in_features, hidden_dim, dtype=f32, device=draw)
        self.syn2 = Synapsis(hidden_dim, hidden_dim, dtype=f32, device=draw)
        self.readout = Dense(hidden_dim, output_dim, f32, draw)
        initialize(self, generator)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] spikes or currents -> [B, output_dim]."""
        gp = gif_params(levels=self.levels)
        s1, _ = gif_scan(gp, self.syn1(x))
        s2, _ = gif_scan(gp, self.syn2(s1))
        return self.readout(s2.mean(dim=1))


class StackedLinear(nn.Module):
    """E f32 linears with a stacked `kernel` [E, in, out] and `bias`
    [E, out], as the flax `nn.vmap` over a Dense or Synapsis stores them.
    `init` is "synapsis" (normal, std 1/sqrt(in * 0.3)) or "lecun"
    (flax's Dense default); each expert draws its own weights."""

    def __init__(self, num: int, in_features: int, features: int,
                 init: str, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num, in_features, features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(num, features, device=device))
        self.init = init

    def init_parameters(self, generator) -> None:
        fan_in = self.kernel.shape[1]
        for w in self.kernel:
            if self.init == "synapsis":
                nn.init.normal_(w, 0.0, 1.0 / math.sqrt(fan_in * 0.3),
                                generator=generator)
            else:
                lecun_normal_(w, fan_in, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [E or 1, N, in] -> [E, N, out]: one batched product."""
        return torch.matmul(x, self.kernel) + self.bias[:, None, :]


class StackedExperts(nn.Module):
    """The bank's E `SNNExpert`s, parameters stacked along a leading
    expert axis (names `syn1`, `syn2`, `readout`, as the flax tree's)."""

    def __init__(self, num_experts: int, in_features: int, hidden_dim: int,
                 output_dim: int, levels: int = 8, device=None):
        super().__init__()
        self.levels = levels
        self.syn1 = StackedLinear(num_experts, in_features, hidden_dim,
                                  "synapsis", device)
        self.syn2 = StackedLinear(num_experts, hidden_dim, hidden_dim,
                                  "synapsis", device)
        self.readout = StackedLinear(num_experts, hidden_dim, output_dim,
                                     "lecun", device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [E, N, T, D] (each expert its own rows) or [N, T, D] (every
        expert the same rows) -> [E, N, output_dim]."""
        gp = gif_params(levels=self.levels)
        lead = x.shape[:-2] if x.dim() == 4 else (1,) + x.shape[:-2]
        T, D = x.shape[-2:]
        E = self.syn1.kernel.shape[0]
        h = self.syn1(x.reshape(lead[0], -1, D))                 # [E, NT, H]
        s1, _ = gif_scan(gp, h.reshape(E, lead[1], T, -1))
        h2 = self.syn2(s1.reshape(E, lead[1] * T, -1))
        s2, _ = gif_scan(gp, h2.reshape(E, lead[1], T, -1))
        return self.readout(s2.mean(dim=2))                     # [E, N, Do]


def topk_dispatch(indices: torch.Tensor, weights: torch.Tensor,
                  num_experts: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-based top-k dispatch plan. indices/weights [B, k] router
    picks -> dispatch [B, E, C] 0/1 (token b occupies slot c of expert e),
    combine [B, E, C] (dispatch x routing weight), dropped [] (the share
    of assignments beyond capacity, a device scalar)."""
    B, k = indices.shape
    S = B * k
    flat_idx = indices.reshape(S)
    mask = F.one_hot(flat_idx, num_experts).to(torch.float32)   # [S, E]
    pos = torch.cumsum(mask, dim=0) - mask          # rank within expert
    keep = mask * (pos < capacity)
    # one-hot of the slot, all zero past the capacity (jax.nn.one_hot's
    # out-of-range rule; F.one_hot would raise)
    slots = torch.arange(capacity, device=indices.device, dtype=pos.dtype)
    slot = (pos[..., None] == slots).to(torch.float32)         # [S, E, C]
    disp_slots = keep[..., None] * slot
    comb_slots = disp_slots * weights.reshape(S)[:, None, None]
    dispatch = disp_slots.reshape(B, k, num_experts, capacity).sum(dim=1)
    combine = comb_slots.reshape(B, k, num_experts, capacity).sum(dim=1)
    # XLA:CPU computes 1 - sum / S as one fused multiply-add with the f32
    # reciprocal of S (a full plan drops -3e-8, not 0); the product of two
    # f32 values is exact in f64, so the same in f64, rounded once
    recip = float(torch.tensor(1.0 / S, dtype=torch.float32))
    dropped = (1.0 - keep.sum().double() * recip).float()
    return dispatch, combine, dropped


class ExpertBank(nn.Module):
    """E experts with stacked parameters, evaluated together.

    Dense (no routing): x [B, T, D] -> [B, E, output_dim], every expert on
    every row. Sparse (routing {'indices', 'weights'}): rows go into
    per-expert capacity buckets [E, C, T, D] -> (combined [B, output_dim],
    {'dropped_fraction', 'capacity'}). Expert-parallel (`tp`), the rank
    holds and runs experts [i E/n, (i + 1) E/n)."""

    tp = None

    def __init__(self, num_experts: int, in_features: int, hidden_dim: int,
                 output_dim: int, levels: int = 8,
                 capacity_factor: float = 1.5, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.experts = StackedExperts(num_experts, in_features, hidden_dim,
                                      output_dim, levels, draw)
        initialize(self, generator)
        self.to(dev)

    def forward(self, x: torch.Tensor,
                routing: Optional[Dict[str, torch.Tensor]] = None):
        tp = self.tp
        if tp is not None:
            x = copy_in(x, tp.group)
        if routing is None:
            out = self.experts(x).transpose(0, 1)              # [B, E, Do]
            return out if tp is None else gather_dim(out, tp.group, 1)
        B = x.shape[0]
        k = routing["indices"].shape[-1]
        capacity = max(1, int(self.capacity_factor * B * k
                              / self.num_experts))
        dispatch, combine, dropped = topk_dispatch(
            routing["indices"], routing["weights"], self.num_experts,
            capacity)
        if tp is not None:             # this rank's experts' buckets
            mine = slice(tp.index * self.num_experts // tp.size,
                         (tp.index + 1) * self.num_experts // tp.size)
            dispatch = dispatch[:, mine]
            combine = copy_in(combine, tp.group)[:, mine]
        expert_in = torch.einsum("bec,btd->ectd", dispatch,
                                 x.to(torch.float32))
        out_e = self.experts(expert_in)                        # [E, C, Do]
        y = torch.einsum("bec,ecd->bd", combine, out_e)
        if tp is not None:
            y = reduce_out(y, tp.group)
        return y, {"dropped_fraction": dropped, "capacity": capacity}


class FullLanguageZone(nn.Module):
    """Prosody -> GIF encode -> MoE experts -> Poisson -> GIF decode ->
    LayerNorm, over [B, T, d_model] features."""

    def __init__(self, d_model: int, num_experts: int = 8, top_k: int = 2,
                 timesteps: int = 4, levels: int = 8,
                 dense_dispatch: bool = False, capacity_factor: float = 2.0,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.d_model, self.num_experts, self.top_k = d_model, num_experts, \
            top_k
        self.timesteps, self.levels = timesteps, levels
        self.dense_dispatch = dense_dispatch
        f32 = torch.float32
        self.encoder_proj = Dense(d_model, d_model, f32, draw)
        self.router = LiquidMoERouter(d_model, min(256, d_model),
                                      num_experts, top_k=top_k, device=draw)
        self.bank = ExpertBank(num_experts, d_model, d_model, d_model,
                               levels, capacity_factor, draw, generator)
        self.decoder_proj = Dense(d_model, d_model, f32, draw)
        self.output_norm = LayerNorm(d_model, f32, draw)
        for m in (self.encoder_proj, self.router, self.decoder_proj,
                  self.output_norm):
            initialize(m, generator)
        self.to(dev)

    def forward(self, token_ids: torch.Tensor, features: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """token_ids [B, T], features [B, T, D] -> ([B, d_model], info)."""
        B = features.shape[0]
        if generator is None:
            generator = torch.Generator(device=features.device)
            generator.manual_seed(0)

        # 1. prosody gains from the token ids
        gains, pros_info = prosody_attention_gains(token_ids)

        # 2. prosody-modulated GIF encoder
        gp = gif_params(levels=self.levels)
        spikes, _ = prosody_gif_scan(gp, self.encoder_proj(features), gains)

        # 3. rate bridge -> routing
        rates = spikes_to_continuous(spikes, "rate")              # [B, D]
        routing = self.router(rates)

        # 4. the expert bank: top-k dispatch, or dense for comparison
        moe_aux: Dict[str, Any] = {}
        if self.dense_dispatch:
            expert_out = self.bank(spikes)                      # [B, E, D]
            w = torch.zeros(B, self.num_experts, dtype=expert_out.dtype,
                            device=expert_out.device).scatter_add(
                1, routing["indices"], routing["weights"])
            combined = torch.einsum("be,bed->bd", w, expert_out)
        else:
            combined, moe_aux = self.bank(spikes, routing)        # [B, D]

        # 5. Poisson bridge -> GIF decoder -> LayerNorm
        dec_spikes = continuous_to_spikes(combined, self.timesteps,
                                          generator, "poisson")
        dec_out, _ = gif_scan(gp, self.decoder_proj(dec_spikes))
        out = self.output_norm(spikes_to_continuous(dec_out, "rate"))
        return out, {"routing": routing, "prosody": pros_info,
                     "spike_rate": spikes.mean(), **moe_aux}


class MoELanguageZone(nn.Module):
    """Standalone spiking-MoE language model: embed -> zone -> vocab
    head."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_experts: int = 8, top_k: int = 2, levels: int = 8,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        draw = draw_device(generator, dev)
        self.embedding = Embed(vocab_size, d_model, draw)
        self.zone = FullLanguageZone(d_model, num_experts, top_k,
                                     levels=levels, device=draw,
                                     generator=generator)
        self.lm_head = Dense(d_model, vocab_size, torch.float32, draw)
        initialize(self.embedding, generator)
        initialize(self.lm_head, generator)
        self.to(dev)

    def forward(self, token_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """token_ids [B, T] -> (logits [B, vocab], info)."""
        features = F.embedding(token_ids, self.embedding.weight)
        zone_out, info = self.zone(token_ids, features, generator)
        return self.lm_head(zone_out), info
