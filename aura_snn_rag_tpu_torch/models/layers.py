"""Transformer building blocks (counterpart of
`aura_snn_rag_tpu/models/layers.py`).

Each module has the flax module's name and its parameters' names, so the
flax parameter tree maps onto the `state_dict` by name (`models/convert.py`
does it). Where flax and PyTorch differ, the port follows flax:

- `Dense` keeps an f32 weight and bias and casts them and the input to the
  compute dtype at every use, as `nn.Dense(dtype=bf16)` does. Its weight
  is [out, in] (`F.linear`'s layout); a flax kernel is [in, out].
- `LayerNorm` uses flax's epsilon 1e-6 (PyTorch's default is 1e-5) and
  computes in f32, casting only its output to the compute dtype; its
  variance takes two passes where flax's takes one (see `LayerNorm`).
- A Python constant that multiplies an array is rounded to the array's
  dtype first, as JAX does with its weak types (`_scalar`).
- The MLP's GELU is the tanh approximation (flax's `nn.gelu` default).
- Attention runs in PyTorch's [B, H, L, Hd] layout (`scaled_dot_product_
  attention`); JAX's is [B, L, H, Hd]. KV caches are [B, H, T, Hd].
- Initialisers mirror flax's in distribution: lecun_normal (a truncated
  normal, std sqrt(1/fan_in) / 0.8796) on every Dense, normal(0.02) on
  the embedding, normal(1/sqrt(fan_in * 0.3)) on `Synapsis`, normal(0.1)
  on the theta/gamma offsets, logit(`snn_ratio`) on the hybrid gate.
  Every module draws from the `torch.Generator` it is given.
- Dropout (`Dropout`, at flax's sites: after the attention's `o_proj`,
  the MLP's `down`, the spiking FFN's time mean, and the model's input
  norm) runs only when a forward is given a `dropout_seed` in training
  mode; without one a module runs as flax's with `deterministic=True`.
  Each site draws its mask from a generator seeded with the seed and the
  site's index, so a recompute (remat) draws the same mask; flax's masks
  come from JAX's PRNG and are not the same bits.

DeepSeek-V3's block (`config.DeepSeekV3Config`, no JAX counterpart)
follows the published modelling code (Hugging Face's `modeling_deepseek.
py` for Moonlight-16B-A3B): `RMSNorm`, `LatentAttention` (MLA with RoPE),
the SwiGLU `GatedMLP` and `MoEFFN`; `TransformerLayer` and
`MemoryAugmentedLayer` take their norms, attention and FFN by the
config's block kind. Kimi-Linear's hybrid block (`config.KimiLinearConfig`)
is that stem with `KimiDeltaAttention` in the layers its pattern names
(after the published `modeling_kimi.py` and the Flash Linear Attention
layer it builds on) and `LatentAttention` without RoPE in the others.

`Synapsis` carries the JAX module's STDP traces and `stdp_update` (no
module of the LM calls them). The RAG layers reach a sharded bank
through their `retrieve_fn`.

Model parallelism (`parallel/`):
- tensor parallelism: `parallel.mesh.shard_params` over a 'model' axis
  larger than 1 leaves each rank its part of the sharded weights and
  sets `tp` on the modules that compute on them. `ProsodyGatedAttention`
  then runs its H/n local heads (the prosody gain sliced to match) and
  one row-parallel `o_proj`; `MLP` a column-parallel `up` and a row-
  parallel `down`; `SNNFFN` a column-parallel `syn1`, a row-parallel
  `gif1_in` whose sum each rank keeps its part of, the first GIF scan on
  that part, and a row-parallel `syn2`; `MultiHeadDotProductAttention`
  its local heads; `PlaceCellEncoder` an embedding of D/n features
  (gathered) and a tied head that sums the parts' logits. Each module
  enters its per-rank math through `copy_in` (the gradient of a
  replicated input sums every rank's part) and leaves it through one
  `reduce_out`; a replicated bias or gate used in part is taken through
  `copy_in` too, so every rank's replicated parameters get the whole
  gradient. Biases stay replicated, as in JAX;
- sequence parallelism: with a `mesh` whose 'seq' axis is larger than 1
  (`HippocampalTransformer.set_mesh`), each rank holds one chunk of the
  sequence; `ProsodyGatedAttention`'s causal core runs ring attention
  over the axis (heads stay sharded over 'model' inside the ring), and
  `MemoryAugmentedLayer`'s query is the mean over the whole sequence
  (`all_reduce_sum` over 'seq').
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from aura_snn_rag_tpu_torch.config import MemoryConfig, ModelConfig
from aura_snn_rag_tpu_torch.memory import engine as memory_engine
from aura_snn_rag_tpu_torch.ops.experts import (
    held_experts_grouped, held_experts_loop)
from aura_snn_rag_tpu_torch.ops.kda import kda
from aura_snn_rag_tpu_torch.ops.neurons import (
    gif_params, gif_scan, gif_scan_const)
from aura_snn_rag_tpu_torch.ops.place_cells import sparse_place_code
from aura_snn_rag_tpu_torch.ops.theta_gamma import (
    ThetaGammaParams, theta_gamma_encoding)
from aura_snn_rag_tpu_torch.parallel.collectives import (
    all_reduce_sum, copy_in, gather_dim, reduce_out, reduce_scatter_dim)
from aura_snn_rag_tpu_torch.parallel.ring_attention import (
    mesh_seq_axis, sequence_sharded_attention)
from aura_snn_rag_tpu_torch.utils.trace import count, span

LN_EPS = 1e-6            # flax nn.LayerNorm's epsilon
PROSODY_DIM = 4          # prosody features: arousal, valence, ...
LECUN_TRUNC = 0.87962566103423978   # std of a unit normal truncated at +-2

KVCache = Tuple[torch.Tensor, torch.Tensor]


def compute_dtype(config: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's lecun_normal: a normal truncated at +-2 std, scaled so its
    std is sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / fan_in) / LECUN_TRUNC
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as JAX applies it to an array: rounded to the
    array's dtype first (a weak type), so 0.1 * x in bf16 multiplies by
    bf16(0.1) = 0.10009765625 as in the JAX package, where PyTorch would
    multiply by the f32 constant. A 0-dim CPU tensor, so no copy to the
    card."""
    return torch.tensor(value, dtype=like.dtype)


class Dropout(nn.Module):
    """flax `nn.Dropout(rate)` with an explicit seed: where a uniform draw
    is below 1 - rate the input is kept and divided by 1 - rate (rounded
    to the input's dtype first, as JAX does), elsewhere it is 0. The
    draw comes from a `torch.Generator` on the input's device seeded with
    `dropout_seed` and the module's `site` (its index among the model's
    dropout sites, set by `HippocampalTransformer`), so the same seed
    gives the same mask, in a recompute too. Identity with no seed, in
    eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.site = 0

    def forward(self, x: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        if dropout_seed is None or not self.training or self.rate <= 0:
            return x
        gen = torch.Generator(device=x.device)
        gen.manual_seed((int(dropout_seed) * 1_000_003 + self.site)
                        % (2 ** 63))
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=gen, device=x.device) \
            < keep_prob
        return torch.where(keep, x / _scalar(keep_prob, x), 0.0)


def draw_device(generator: Optional[torch.Generator], device
                ) -> torch.device:
    """Where a module's parameters are drawn: on the generator's device
    (so a CPU generator draws the same numbers whichever device the
    module then moves to), else on `device` from the default generator."""
    return generator.device if generator is not None \
        else torch.device(device)


def initialize(module: nn.Module,
               generator: Optional[torch.Generator]) -> None:
    """Draw every parameter of `module` from `generator`, module by module
    in `module.modules()` order."""
    for m in module.modules():
        init = getattr(m, "init_parameters", None)
        if init is not None:
            init(generator)


class Dense(nn.Module):
    """flax `nn.Dense(out_features, dtype=dtype, use_bias=use_bias)`."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if use_bias else None)
        self.dtype = dtype

    def init_parameters(self, generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


def part(x: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    """This rank's part, along `dim`, of a tensor replicated over the
    'model' axis `tp`; through `copy_in`, so the whole tensor's gradient
    (every rank's part of it) reaches every rank."""
    return copy_in(x, tp.group).chunk(tp.size, dim)[tp.index]


def column_parallel(dense: "Dense", x: torch.Tensor, tp) -> torch.Tensor:
    """A column-parallel `Dense` on its part of the outputs: x (entered
    through `copy_in`) times this rank's rows of the [out, in] weight,
    plus its part of the replicated bias."""
    dt = dense.dtype
    b = None if dense.bias is None else part(dense.bias, tp, 0).to(dt)
    return F.linear(x.to(dt), dense.weight.to(dt), b)


def row_parallel(dense: "Dense", x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel `Dense`: this rank's part of the inputs times its
    columns of the weight, summed over the ranks (`reduce_out`), plus the
    replicated bias."""
    dt = dense.dtype
    y = reduce_out(F.linear(x.to(dt), dense.weight.to(dt)), tp.group)
    return y if dense.bias is None else y + dense.bias.to(dt)


class Embed(nn.Module):
    """flax `nn.Embed`: a [vocab, features] f32 table, normal(0.02)."""

    def __init__(self, num_embeddings: int, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features,
                                               device=device))

    def init_parameters(self, generator) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=dtype)`: statistics and affine in f32,
    epsilon 1e-6 (PyTorch's default is 1e-5), output in the compute dtype.
    flax takes the variance in one pass, max(0, E[x^2] - E[x]^2), which
    cancels where a row's mean is large against its spread (the theta
    carrier near a quarter period gives such rows); `F.layer_norm` takes
    E[(x - E[x])^2]. `test_layer_norm_matches_flax` measures both against
    f64 on such rows."""

    def __init__(self, features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.dtype = dtype

    def init_parameters(self, generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape,
                            self.weight.float(), self.bias.float(),
                            LN_EPS).to(self.dtype)


class PlaceCellEncoder(nn.Module):
    """Token embedding with sparse place-cell population coding; `attend`
    is the tied output head. Tensor-parallel (`tp`), the table holds this
    rank's D/n features: the embedding gathers them, and `attend` sums the
    parts' logits."""

    tp = None

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        self.token_embedding = Embed(cfg.vocab_size, cfg.embedding_dim,
                                     device)
        self.semantic_projection = Dense(cfg.embedding_dim, cfg.n_place_cells,
                                         dt, device)
        self.place_to_semantic = Dense(cfg.n_place_cells, cfg.embedding_dim,
                                       dt, device)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        token_embeds = F.embedding(input_ids, self.token_embedding.weight)
        if self.tp is not None:
            token_embeds = gather_dim(token_embeds, self.tp.group, -1)
        token_embeds = token_embeds.to(self.dtype)                # [B, L, D]
        logits = self.semantic_projection(token_embeds)
        activity = sparse_place_code(logits.float(), cfg.place_k)
        recon = self.place_to_semantic(activity.to(token_embeds.dtype))
        out = token_embeds + _scalar(cfg.place_residual_scale, recon) * recon
        return out, activity

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied output head: hidden @ embedding^T (flax `Embed.attend`)."""
        dt = self.dtype
        if self.tp is not None:
            return reduce_out(F.linear(
                part(hidden, self.tp).to(dt),
                self.token_embedding.weight.to(dt)), self.tp.group)
        return F.linear(hidden.to(dt), self.token_embedding.weight.to(dt))


class ThetaGammaPositional(nn.Module):
    """Learnable theta-gamma phase-coupled positional encoding."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = config
        D = config.embedding_dim
        self.theta_phase_offsets = nn.Parameter(torch.empty(D, device=device))
        self.gamma_phase_offsets = nn.Parameter(torch.empty(D, device=device))
        self.amplitude_modulation = nn.Parameter(torch.empty(D,
                                                             device=device))

    def init_parameters(self, generator) -> None:
        nn.init.normal_(self.theta_phase_offsets, 0.0, 0.1,
                        generator=generator)
        nn.init.normal_(self.gamma_phase_offsets, 0.0, 0.1,
                        generator=generator)
        nn.init.ones_(self.amplitude_modulation)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        params = ThetaGammaParams(self.theta_phase_offsets,
                                  self.gamma_phase_offsets,
                                  self.amplitude_modulation)
        enc = theta_gamma_encoding(params, positions, cfg.max_seq_len,
                                   cfg.theta_freq, cfg.gamma_freq)
        return enc.to(compute_dtype(cfg))


def _cache_mask(cache_index: int, L: int, device) -> torch.Tensor:
    """[L, T] with T = cache_index + L: query p = cache_index + i attends
    keys [0, p]. `is_causal=True` would align the mask top-left when the
    query and key lengths differ, so the cached path passes this one."""
    T = cache_index + L
    qpos = cache_index + torch.arange(L, device=device)
    return torch.arange(T, device=device)[None, :] <= qpos[:, None]


class ProsodyGatedAttention(nn.Module):
    """Causal MHA with prosody/arousal/valence/memory query gates:
      q *= (1 + sigmoid(W_p prosody))        per-head prosody gain
      q *= 1 + 0.2*tanh(arousal)             arousal boost
      q *= 1 + 0.05*tanh(valence)            valence gain
      q *= 1 + 0.5*sigmoid(W_m h)            memory gate
    Tensor-parallel (`tp`), the rank runs its H/n heads; with a `mesh`
    whose 'seq' axis is larger than 1, the causal core is ring attention
    over it (the batch axes are the mesh's other axes but 'model' and
    'stage')."""

    tp = None

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = config
        D, H = config.embedding_dim, config.num_heads
        dt = compute_dtype(config)
        self.q_proj = Dense(D, D, dt, device)
        self.k_proj = Dense(D, D, dt, device)
        self.v_proj = Dense(D, D, dt, device)
        self.prosody_gate = Dense(PROSODY_DIM, H, dt, device)
        self.memory_gate = Dense(D, 1, dt, device)
        self.o_proj = Dense(D, D, dt, device)
        self.dropout = Dropout(config.dropout)
        self.mesh = None
        self.seq_axis_name = "seq"

    def forward(self, hidden: torch.Tensor,
                prosody: Optional[torch.Tensor] = None,
                use_memory: bool = True,
                kv_cache: Optional[KVCache] = None,
                cache_index=None, dropout_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """hidden [B, L, D]; with `kv_cache` ([B, H, T, Hd] each, H this
        rank's heads, updated in place) the L new keys and values go to
        rows [cache_index, cache_index + L) and the queries attend rows
        [0, their position]."""
        cfg = self.config
        tp = self.tp
        B, L, D = hidden.shape
        H, Hd = cfg.num_heads, cfg.head_dim
        if tp is not None:
            H //= tp.size
            x = copy_in(hidden, tp.group)
            q, k, v = (column_parallel(p, x, tp) for p in
                       (self.q_proj, self.k_proj, self.v_proj))
        else:
            q, k, v = (p(hidden) for p in
                       (self.q_proj, self.k_proj, self.v_proj))
        q, k, v = (t.view(B, L, H, Hd) for t in (q, k, v))

        if prosody is not None:
            prosody = prosody.to(compute_dtype(cfg))
            gain = torch.sigmoid(self.prosody_gate(prosody))       # [B, L, H]
            arousal = prosody[..., 0:1]
            valence = prosody[..., 1:2]
            boost = ((1.0 + _scalar(0.2, prosody) * torch.tanh(arousal))
                     * (1.0 + _scalar(0.05, prosody)
                        * torch.tanh(valence)))                   # [B, L, 1]
            if tp is not None:
                gain = part(gain, tp)
                boost = copy_in(boost, tp.group)
            q = q * (1.0 + gain)[..., None] * boost[..., None]

        if use_memory:
            mem_w = torch.sigmoid(self.memory_gate(hidden))        # [B, L, 1]
            if tp is not None:
                mem_w = copy_in(mem_w, tp.group)
            q = q * (1.0 + 0.5 * mem_w)[..., None]

        new_cache = None
        if kv_cache is not None:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # [B,H,L,Hd]
            ck, cv = kv_cache
            idx = int(cache_index)
            if not 0 <= idx <= ck.shape[2] - L:
                raise ValueError(f"cache_index {idx} + {L} rows outside a "
                                 f"cache of {ck.shape[2]}")
            ck[:, :, idx:idx + L] = k
            cv[:, :, idx:idx + L] = v
            new_cache = (ck, cv)
            # rows past idx + L are masked in the JAX package's full-length
            # attention; leaving them out gives the same softmax
            ctx = F.scaled_dot_product_attention(
                q, ck[:, :, :idx + L], cv[:, :, :idx + L],
                attn_mask=_cache_mask(idx, L, hidden.device))
            ctx = ctx.transpose(1, 2)
        elif mesh_seq_axis(self.mesh, self.seq_axis_name) > 1:
            names = self.mesh.mesh_dim_names
            ctx = sequence_sharded_attention(
                q, k, v, self.mesh, seq_axis=self.seq_axis_name,
                batch_axes=tuple(a for a in names if a not in (
                    self.seq_axis_name, "model", "stage")),
                head_axis="model" if "model" in names else None,
                causal=True)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # [B,H,L,Hd]
            ctx = F.scaled_dot_product_attention(
                q, k, v, is_causal=True).transpose(1, 2)

        ctx = ctx.reshape(B, L, H * Hd)
        out = (row_parallel(self.o_proj, ctx, tp) if tp is not None
               else self.o_proj(ctx))
        return self.dropout(out, dropout_seed), new_cache


class MLP(nn.Module):
    """GELU MLP (tanh approximation, as flax's `nn.gelu`); tensor-parallel
    (`tp`), column-parallel `up` and row-parallel `down`."""

    tp = None

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        dt = compute_dtype(config)
        self.up = Dense(config.embedding_dim, config.intermediate_size, dt,
                        device)
        self.down = Dense(config.intermediate_size, config.embedding_dim, dt,
                          device)
        self.dropout = Dropout(config.dropout)

    def forward(self, x: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        tp = self.tp
        if tp is None:
            h = self.down(F.gelu(self.up(x), approximate="tanh"))
        else:
            h = F.gelu(column_parallel(self.up, copy_in(x, tp.group), tp),
                       approximate="tanh")
            h = row_parallel(self.down, h, tp)
        return self.dropout(h, dropout_seed)


class Synapsis(nn.Module):
    """Spike-aware linear: init std = 1/sqrt(fan_in * firing_rate). The
    kernel keeps flax's [in, out] layout.

    With `enable_plasticity` the forward also returns the STDP eligibility
    traces: exponential moving averages (decay `trace_decay`) of the
    time-mean pre-synaptic spikes and post-synaptic currents, threaded
    through `trace_state` as the JAX module returns them; `stdp_update`
    turns them into a weight change for a training loop to apply. No
    module of the LM calls either, as in the JAX package."""

    def __init__(self, in_features: int, features: int,
                 target_firing_rate: float = 0.3,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 enable_plasticity: bool = False,
                 trace_decay: float = 0.95):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.target_firing_rate = target_firing_rate
        self.dtype = dtype
        self.enable_plasticity = enable_plasticity
        self.trace_decay = trace_decay

    def init_parameters(self, generator) -> None:
        fan_in = self.kernel.shape[0]
        nn.init.normal_(self.kernel, 0.0,
                        1.0 / math.sqrt(fan_in * self.target_firing_rate),
                        generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, spikes: torch.Tensor,
                trace_state: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None):
        """spikes [..., T, in] -> out [..., T, out]; with plasticity,
        (out, (pre trace [..., in], post trace [..., out] f32))."""
        dt = self.dtype
        out = F.linear(spikes.to(dt), self.kernel.to(dt).t(),
                       self.bias.to(dt))
        if not self.enable_plasticity:
            return out
        pre = spikes.mean(dim=-2)
        post = out.mean(dim=-2).float()
        if trace_state is None:
            pre_trace, post_trace = torch.zeros_like(pre), \
                torch.zeros_like(post)
        else:
            pre_trace, post_trace = trace_state
        d = self.trace_decay
        return out, (d * pre_trace + (1 - d) * pre,
                     d * post_trace + (1 - d) * post)

    @staticmethod
    def stdp_update(kernel: torch.Tensor, pre_trace: torch.Tensor,
                    post_trace: torch.Tensor,
                    lr: float = 0.001) -> torch.Tensor:
        """dW = lr (pre outer post), batch-averaged, added to the kernel
        and clamped to [-10, 10]."""
        if pre_trace.dim() > 1:
            pre_trace = pre_trace.mean(dim=0)
            post_trace = post_trace.mean(dim=0)
        dw = lr * torch.outer(pre_trace, post_trace)
        return torch.clamp(kernel + dw, -10.0, 10.0)


class SNNFFN(nn.Module):
    """Spiking FFN: two Synapsis -> GIF stages over T time steps, mean over
    time. The first stage's linears run once per token and its GIF scan
    takes the constant current T times (as the JAX package does).

    Tensor-parallel (`tp`): `syn1` column-parallel (this rank's I/n
    units), `gif1_in` row-parallel over them, its sum over the ranks of
    which each rank keeps its I/n units (`reduce_scatter_dim`; GSPMD
    all-reduces and re-slices), the first GIF scan on those units (the
    neurons are independent), and `syn2` row-parallel over them."""

    tp = None

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = config
        D, I = config.embedding_dim, config.intermediate_size
        dt = self.dtype = compute_dtype(config)
        self.syn1 = Synapsis(D, I, dtype=dt, device=device)
        self.gif1_in = Dense(I, I, dt, device)
        self.syn2 = Synapsis(I, D, dtype=dt, device=device)
        self.gif2_in = Dense(D, D, dt, device)
        # GIF dynamics run in the compute dtype, as in the JAX package
        self.gif = gif_params(levels=config.snn_levels, dtype=dt)
        self.dropout = Dropout(config.dropout)

    def forward(self, x: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        B, L, D = x.shape
        dt = self.dtype
        tp = self.tp
        if tp is None:
            h1 = self.gif1_in(self.syn1(x.reshape(B * L, D)))
        else:
            syn1, gif1 = self.syn1, self.gif1_in
            h1 = F.linear(copy_in(x.reshape(B * L, D), tp.group).to(dt),
                          syn1.kernel.to(dt).t(),
                          part(syn1.bias, tp, 0).to(dt))          # [N, I/n]
            h1 = reduce_scatter_dim(F.linear(h1, gif1.weight.to(dt)),
                                    tp.group, -1) \
                + part(gif1.bias, tp, 0).to(dt)
        s1, _ = gif_scan_const(self.gif, h1.to(dt),
                               self.config.snn_timesteps)         # [N, T, I]
        if tp is None:
            h2 = self.syn2(s1)
        else:
            h2 = reduce_out(F.linear(s1.to(dt), self.syn2.kernel.to(dt).t()),
                            tp.group) + self.syn2.bias.to(dt)
        h2 = self.gif2_in(h2)
        s2, _ = gif_scan(self.gif, h2.to(dt))                     # [N, T, D]
        return self.dropout(s2.float().mean(dim=1).reshape(B, L, D).to(dt),
                            dropout_seed)


class HybridFFN(nn.Module):
    """Learnable sigmoid-gated blend of the MLP and SNN paths."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = config
        self.mlp = MLP(config, device)
        self.snn = SNNFFN(config, device)
        self.gate = nn.Parameter(torch.empty((), device=device))

    def init_parameters(self, generator) -> None:
        r = self.config.snn_ratio
        nn.init.constant_(self.gate, math.log(r / (1 - r)))

    def forward(self, x: torch.Tensor,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        mlp_out = self.mlp(x, dropout_seed)
        snn_out = self.snn(x, dropout_seed)
        g = torch.sigmoid(self.gate).to(mlp_out.dtype)
        return (1.0 - g) * mlp_out + g * snn_out


class RMSNorm(nn.Module):
    """DeepSeek-V3's RMSNorm: x / sqrt(mean(x^2) + eps) times an f32
    weight, in f32, cast to the compute dtype at the end (the published
    code casts before the weight's product)."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.eps, self.dtype = eps, dtype

    def init_parameters(self, generator) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight * x).to(self.dtype)


def rope_tables(L: int, dim: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [L, dim] f32 of positions 0..L-1: frequencies
    theta^(-2i/dim), each used twice (cat(freqs, freqs)), no scaling."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device,
                                        dtype=torch.float32) / dim))
    freqs = torch.outer(torch.arange(L, device=device, dtype=torch.float32),
                        inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """The published `apply_rotary_pos_emb` on x [..., L, n, dim] (cos and
    sin [L, dim]), in f32: the dims de-interleaved (evens, then odds),
    then x * cos + rotate_half(x) * sin. Returns f32."""
    *lead, d = x.shape
    x = x.float().reshape(*lead, d // 2, 2).transpose(-1, -2) \
        .reshape(*lead, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[:, None, :] + half * sin[:, None, :]


class LatentAttention(nn.Module):
    """DeepSeek-V3's multi-head latent attention without a query
    compression (`q_lora_rank` null): per head a query of
    `qk_nope_head_dim` + `qk_rope_head_dim` dims (W_q h); the latent
    `kv_a` = W_kva h, whose first `kv_lora_rank` dims pass through
    `kv_a_layernorm` and W_kvb into each head's key (nope part) and value,
    and whose last `qk_rope_head_dim` dims are one rope key every head
    shares; RoPE on the rope dims; the causal core at softmax scale
    1/sqrt(nope + rope) on SDPA, keys of 192 dims and values of 128 as
    they are (on the H100 PyTorch's cuDNN backend takes them: its flash
    backend needs one width for all three, and padding the values to 192
    for it took 28 ms a layer's forward and backward at 4 x 8192 against
    cuDNN's 10); `o_proj`. No bias anywhere, no prosody or memory query
    gains, no dropout. With `mla_use_nope` (Kimi-Linear's full layers)
    no rotation: the rope dims, the shared rope key and the scale stay.
    Spans `mla.project` (the projections and RoPE) and `mla.core`;
    counter `path.mla`."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = c = config
        D, H = c.embedding_dim, c.num_heads
        dt = self.dtype = compute_dtype(c)
        self.qk_dim = c.qk_nope_head_dim + c.qk_rope_head_dim
        self.q_proj = Dense(D, H * self.qk_dim, dt, device, use_bias=False)
        self.kv_a_proj_with_mqa = Dense(
            D, c.kv_lora_rank + c.qk_rope_head_dim, dt, device,
            use_bias=False)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, dt,
                                      device)
        self.kv_b_proj = Dense(c.kv_lora_rank,
                               H * (c.qk_nope_head_dim + c.v_head_dim), dt,
                               device, use_bias=False)
        self.o_proj = Dense(H * c.v_head_dim, D, dt, device, use_bias=False)

    def forward(self, hidden: torch.Tensor, prosody=None,
                use_memory: bool = True, kv_cache=None, cache_index=None,
                dropout_seed=None) -> Tuple[torch.Tensor, None]:
        """hidden [B, L, D] at positions 0..L-1; no KV cache."""
        if kv_cache is not None:
            raise ValueError("latent attention keeps no KV cache")
        c = self.config
        B, L, _ = hidden.shape
        H, nope, rope = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        count("path.mla")
        with span("mla.project"):
            q = self.q_proj(hidden).view(B, L, H, self.qk_dim)
            kv_a = self.kv_a_proj_with_mqa(hidden)
            kv = self.kv_b_proj(self.kv_a_layernorm(
                kv_a[..., :c.kv_lora_rank])).view(B, L, H, nope + c.v_head_dim)
            q_pe, k_pe = q[..., nope:], kv_a[..., None, c.kv_lora_rank:]
            if not c.mla_use_nope:
                cos, sin = rope_tables(L, rope, c.rope_theta, hidden.device)
                q_pe = apply_rope(q_pe, cos, sin).to(self.dtype)
                k_pe = apply_rope(k_pe, cos, sin).to(self.dtype)
            q = torch.cat([q[..., :nope], q_pe], dim=-1).transpose(1, 2)
            k = torch.cat([kv[..., :nope], k_pe.expand(B, L, H, rope)],
                          dim=-1).transpose(1, 2)
            v = kv[..., nope:].transpose(1, 2)
        with span("mla.core"):
            ctx = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=self.qk_dim ** -0.5)
        ctx = ctx.transpose(1, 2).reshape(B, L, H * c.v_head_dim)
        return self.o_proj(ctx), None


def causal_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A causal depthwise convolution without bias over x [B, L, n] with
    weight [n, 1, w] (`nn.Conv1d`'s layout, the published
    `ShortConvolution`'s): y_t = sum_j weight[:, 0, j] x_{t - w + 1 + j},
    zeros before the sequence; the taps as w shifted products."""
    w = weight.shape[-1]
    L = x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    taps = weight[:, 0].to(x.dtype)
    y = xp[:, :L] * taps[:, 0]
    for j in range(1, w):
        y = y + xp[:, j:j + L] * taps[:, j]
    return y


def l2_unit(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / sqrt(sum x^2 + eps) over the last dim, in f32, cast back."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).sum(-1, keepdim=True) + eps)) \
        .to(x.dtype)


class KimiDeltaAttention(nn.Module):
    """Kimi Delta Attention (Kimi-Linear's linear layers), on x [B, L, D]
    at positions 0..L-1 with H = `kda_num_heads` heads of d =
    `kda_head_dim`:
      q, k, v = SiLU(causal depthwise conv(x W_q)), and so with W_k, W_v;
      q and k unit per head (eps 1e-6), q times d^-1/2;
      g = -exp(A_log[h]) softplus(W_fb W_fa x + dt_bias) per channel, f32;
      beta = sigmoid(x W_b) per head, f32;
      o = the gated delta rule over (q, k, v, g, beta) (`ops.kda.kda`);
      out = W_o [RMSNorm_d(o) * o_norm * sigmoid(W_gb W_ga x)] (eps
      `rms_norm_eps`).
    No bias anywhere (the published `g_b_proj`'s is assumed absent), no
    cache, no dropout. Parameter names are the published ones (`q_proj`,
    `q_conv1d`, `A_log`, `f_a_proj`, `f_b_proj`, `dt_bias`, `b_proj`,
    `g_a_proj`, `g_b_proj`, `o_norm`, `o_proj`). `A_log` is drawn as log
    U(1, 16), `dt_bias` as 0. With gradients on, the work between the
    projections and `o_proj` is recomputed in the backward
    (`torch.utils.checkpoint`): at 32k tokens its f32 gates and norms
    would keep ~7 GB a layer. Spans `kda.project`, `kda.conv`,
    `kda.gate`, `kda.core` (`kda.core_bwd` in the backward on the card)
    and `kda.out`."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = c = config
        D, H, d = c.embedding_dim, c.kda_num_heads, c.kda_head_dim
        dt = self.dtype = compute_dtype(c)
        n, w = H * d, c.short_conv_kernel_size
        self.q_proj = Dense(D, n, dt, device, use_bias=False)
        self.k_proj = Dense(D, n, dt, device, use_bias=False)
        self.v_proj = Dense(D, n, dt, device, use_bias=False)
        self.q_conv1d = _Conv(n, w, device)
        self.k_conv1d = _Conv(n, w, device)
        self.v_conv1d = _Conv(n, w, device)
        self.A_log = nn.Parameter(torch.empty(H, device=device))
        self.f_a_proj = Dense(D, d, dt, device, use_bias=False)
        self.f_b_proj = Dense(d, n, dt, device, use_bias=False)
        self.dt_bias = nn.Parameter(torch.empty(n, device=device))
        self.b_proj = Dense(D, H, dt, device, use_bias=False)
        self.g_a_proj = Dense(D, d, dt, device, use_bias=False)
        self.g_b_proj = Dense(d, n, dt, device, use_bias=False)
        self.o_norm = RMSNorm(d, c.rms_norm_eps, torch.float32, device)
        self.o_proj = Dense(n, D, dt, device, use_bias=False)

    def init_parameters(self, generator) -> None:
        u = torch.empty_like(self.A_log, device=draw_device(
            generator, self.A_log.device))
        u.uniform_(1.0, 16.0, generator=generator)
        with torch.no_grad():
            self.A_log.copy_(u.log())
        nn.init.zeros_(self.dt_bias)

    def forward(self, hidden: torch.Tensor, prosody=None,
                use_memory: bool = True, kv_cache=None, cache_index=None,
                dropout_seed=None) -> Tuple[torch.Tensor, None]:
        """hidden [B, L, D] at positions 0..L-1; no cache."""
        if kv_cache is not None:
            raise ValueError("Kimi Delta Attention keeps no cache here")
        with span("kda.project"):
            args = (self.q_proj(hidden), self.k_proj(hidden),
                    self.v_proj(hidden), self.f_a_proj(hidden),
                    self.b_proj(hidden), self.g_a_proj(hidden))
        o = (checkpoint(self._mix, *args, use_reentrant=False)
             if torch.is_grad_enabled() else self._mix(*args))
        with span("kda.out"):
            return self.o_proj(o), None

    def _mix(self, q, k, v, fa, b, ga) -> torch.Tensor:
        """Everything between the projections (q, k, v, the gate's and the
        output gate's first factors, beta's logits) and `o_proj`: the
        input to `o_proj`, [B, L, H * d] in the compute dtype. Recomputed
        in the backward, so that a layer keeps only its projections'
        outputs (the core saves its inputs only while it runs)."""
        c = self.config
        B, L, _ = q.shape
        H, d = c.kda_num_heads, c.kda_head_dim
        with span("kda.conv"):
            q, k, v = (F.silu(causal_conv(t, conv.weight)).view(B, L, H, d)
                       for t, conv in ((q, self.q_conv1d),
                                       (k, self.k_conv1d),
                                       (v, self.v_conv1d)))
        with span("kda.gate"):
            q = l2_unit(q) * _scalar(d ** -0.5, q)
            k = l2_unit(k)
            f = self.f_b_proj(fa).float() + self.dt_bias
            g = (-torch.exp(self.A_log)[:, None]
                 * F.softplus(f.view(B, L, H, d)))
            beta = torch.sigmoid(b.float())
        o = kda(q, k, v, g, beta)
        with span("kda.out"):
            gate = torch.sigmoid(self.g_b_proj(ga).float()).view(B, L, H, d)
            o = (self.o_norm(o) * gate).to(self.dtype)
            return o.reshape(B, L, H * d)


class _Conv(nn.Module):
    """The weight [n, 1, w] of a depthwise convolution without bias."""

    def __init__(self, channels: int, width: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, width,
                                               device=device))

    def init_parameters(self, generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[-1], generator)


class GatedMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)), no bias (DeepSeek-V3's dense
    FFN and its shared experts)."""

    def __init__(self, features: int, width: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.gate_proj = Dense(features, width, dtype, device, use_bias=False)
        self.up_proj = Dense(features, width, dtype, device, use_bias=False)
        self.down_proj = Dense(width, features, dtype, device, use_bias=False)

    def forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoEGate(nn.Module):
    """The router: a bias-free [n_routed_experts, D] f32 weight and the
    load-balancing bias `e_score_correction_bias` (a buffer the trainer
    moves, no gradient)."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        E = config.n_routed_experts
        self.weight = nn.Parameter(torch.empty(E, config.embedding_dim,
                                               device=device))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(E, device=device))

    def init_parameters(self, generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)


class HeldExperts(nn.Module):
    """The SwiGLU experts held here, stacked: `gate_up_proj` [held, 2I, D]
    (gate rows, then up rows) and `down_proj` [held, D, I], f32."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        n, D, I = (config.experts_held, config.embedding_dim,
                   config.moe_intermediate_size)
        self.gate_up_proj = nn.Parameter(torch.empty(n, 2 * I, D,
                                                     device=device))
        self.down_proj = nn.Parameter(torch.empty(n, D, I, device=device))

    def init_parameters(self, generator) -> None:
        lecun_normal_(self.gate_up_proj, self.gate_up_proj.shape[2],
                      generator)
        lecun_normal_(self.down_proj, self.down_proj.shape[2], generator)


class MoEFFN(nn.Module):
    """DeepSeek-V3's MoE (`noaux_tc` with one group) over this model's
    share of the experts:
      s = sigmoid(x W_r^T) in f32 over all `n_routed_experts`;
      the top `num_experts_per_tok` of s + bias;
      w = s_chosen / sum(s_chosen) * routed scaling;
      y = sum of w_i E_i(x) over the chosen experts held here + shared(x).
    On the card the held experts run as grouped products
    (`ops.experts.held_experts_grouped`, counter `path.moe_grouped`) with
    hand-written passes around them that touch only the filled rows of
    the worst-case row buffer, and a combine that gathers each token's
    held picks and sums them in f32 (no atomics); on the CPU one at a
    time (`held_experts_loop`, `path.moe_loop`); no host sync, no token
    dropped. Each forward outside a backward adds its
    picks per expert (all `n_routed_experts`) to `step_load`, which the
    trainer's bias update reads and clears (`update_bias`), and to
    `load_tally`, which only grows (read around a window). Spans
    `moe.route`, `moe.dispatch`, `moe.experts`, `moe.combine` and
    `moe.shared`."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = c = config
        dt = self.dtype = compute_dtype(c)
        self.gate = MoEGate(c, device)
        self.experts = HeldExperts(c, device)
        self.shared_experts = GatedMLP(
            c.embedding_dim, c.n_shared_experts * c.moe_intermediate_size,
            dt, device)
        E = c.n_routed_experts
        self.register_buffer("step_load", torch.zeros(E, device=device),
                             persistent=False)
        self.register_buffer("load_tally",
                             torch.zeros(E, dtype=torch.float64,
                                         device=device), persistent=False)

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(top [T, k] global expert ids, w [T, k] f32 weights) of x
        [T, D]."""
        c = self.config
        s = torch.sigmoid(F.linear(x.float(), self.gate.weight))
        top = torch.topk(s + self.gate.e_score_correction_bias,
                         c.num_experts_per_tok, dim=-1).indices
        w = s.gather(-1, top)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return top, w * c.routed_scaling_factor

    def forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        c = self.config
        B, L, D = x.shape
        xf = x.reshape(B * L, D)
        with span("moe.route"):
            top, w = self.route(xf)
            if torch._C._current_graph_task_id() == -1:   # not a recompute
                with torch.no_grad():
                    load = torch.zeros_like(self.step_load).scatter_add_(
                        0, top.reshape(-1),
                        torch.ones(top.numel(), device=x.device))
                    self.step_load += load
                    self.load_tally += load.double()
        dt = self.dtype
        w13 = self.experts.gate_up_proj.to(dt)
        w2 = self.experts.down_proj.to(dt)
        if x.is_cuda:
            count("path.moe_grouped")
            y = held_experts_grouped(xf.to(dt), w13, w2, top, w,
                                     c.experts_offset)
        else:
            count("path.moe_loop")
            with span("moe.experts"):
                y = held_experts_loop(xf.to(dt), w13, w2, top, w,
                                      c.experts_offset)
        with span("moe.shared"):
            y = y + self.shared_experts(xf)
        return y.reshape(B, L, D)

    @torch.no_grad()
    def update_bias(self, rate: float) -> None:
        """bias += rate * sign(mean load - load) over the picks counted
        since the last update; then the count restarts."""
        load = self.step_load
        self.gate.e_score_correction_bias.add_(
            rate * torch.sign(load.mean() - load))
        load.zero_()


def _ffn(config: ModelConfig, use_snn_ffn: bool, device) -> nn.Module:
    return (HybridFFN if use_snn_ffn else MLP)(config, device)


def _block(config: ModelConfig, use_snn_ffn: bool, layer_index: int, device
           ) -> Tuple[nn.Module, nn.Module, nn.Module, nn.Module]:
    """(attention norm, attention, FFN norm, FFN) of a layer by the
    config's block kind."""
    D, dt = config.embedding_dim, compute_dtype(config)
    if config.latent_stem:
        eps = config.rms_norm_eps
        ffn = (GatedMLP(D, config.intermediate_size, dt, device)
               if layer_index < config.first_k_dense_replace
               else MoEFFN(config, device))
        mixer = (KimiDeltaAttention if config.delta_rule_layer(layer_index)
                 else LatentAttention)(config, device)
        return (RMSNorm(D, eps, dt, device), mixer,
                RMSNorm(D, eps, dt, device), ffn)
    return (LayerNorm(D, dt, device), ProsodyGatedAttention(config, device),
            LayerNorm(D, dt, device), _ffn(config, use_snn_ffn, device))


class TransformerLayer(nn.Module):
    """Pre-norm block: LN -> attention -> residual; LN -> FFN -> residual."""

    def __init__(self, config: ModelConfig, use_snn_ffn: bool = False,
                 device=None, layer_index: int = 0):
        super().__init__()
        (self.attention_norm, self.attention, self.ffn_norm,
         self.ffn) = _block(config, use_snn_ffn, layer_index, device)

    def forward(self, hidden, prosody=None, use_memory: bool = True,
                kv_cache=None, cache_index=None, dropout_seed=None):
        attn_out, new_cache = self.attention(
            self.attention_norm(hidden), prosody, use_memory, kv_cache,
            cache_index, dropout_seed)
        hidden = hidden + attn_out
        return (hidden + self.ffn(self.ffn_norm(hidden), dropout_seed),
                new_cache)


class MultiHeadDotProductAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads, dtype)` over
    inputs_q [B, L, D] and inputs_kv [B, S, D]. flax's kernels are [D, H,
    Hd] (query, key, value) and [H, Hd, D] (out); here they are flattened
    to `Dense` weights [H*Hd, D] and [D, H*Hd]. Tensor-parallel (`tp`),
    the rank runs its H/n heads and a row-parallel `out`."""

    tp = None

    def __init__(self, num_heads: int, features: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(features, features, dtype, device)
        self.key = Dense(features, features, dtype, device)
        self.value = Dense(features, features, dtype, device)
        self.out = Dense(features, features, dtype, device)

    def forward(self, inputs_q: torch.Tensor,
                inputs_kv: torch.Tensor) -> torch.Tensor:
        B, L, D = inputs_q.shape
        H, Hd = self.num_heads, D // self.num_heads
        tp = self.tp
        if tp is not None:
            H //= tp.size
            xq, xkv = copy_in(inputs_q, tp.group), copy_in(inputs_kv,
                                                             tp.group)
            q, k, v = (column_parallel(self.query, xq, tp),
                       column_parallel(self.key, xkv, tp),
                       column_parallel(self.value, xkv, tp))
        else:
            q, k, v = (self.query(inputs_q), self.key(inputs_kv),
                       self.value(inputs_kv))

        def heads(t):
            return t.view(B, t.shape[1], H, Hd).transpose(1, 2)
        ctx = F.scaled_dot_product_attention(
            heads(q), heads(k), heads(v))                         # [B,H,L,Hd]
        ctx = ctx.transpose(1, 2).reshape(B, L, H * Hd)
        return (row_parallel(self.out, ctx, tp) if tp is not None
                else self.out(ctx))


RetrieveFn = Callable[[MemoryConfig, Any, torch.Tensor, int], Any]


class MemoryAugmentedLayer(nn.Module):
    """RAG layer: self-attention, batched episodic retrieval + injection,
    FFN (the attention, norms and FFN by the config's block kind, the
    retrieval and injection the same for every kind). Injection modes:
    - "cross_attention": hidden attends over the k retrieved memories;
    - "concat": score-softmax-weighted memory mean, `h + 0.1*ctx`;
    - "gate": sigmoid([h; ctx]) gated additive injection.
    Retrieval is one batched call over the whole batch: `retrieve_fn(
    memory_config, memory_state, queries, k)` when given, else the
    engine's `retrieve_auto`. The query is the mean of the chunk's hidden
    states, so in decode it is the one new token's; with a `mesh` whose
    'seq' axis is larger than 1 it is the mean over every rank's chunk,
    the whole sequence's."""

    def __init__(self, config: ModelConfig, memory_config: MemoryConfig,
                 use_snn_ffn: bool = False,
                 retrieve_fn: Optional[RetrieveFn] = None, device=None,
                 layer_index: int = 0):
        super().__init__()
        self.config = config
        self.memory_config = memory_config
        self.retrieve_fn = retrieve_fn
        D = config.embedding_dim
        dt = self.dtype = compute_dtype(config)
        attention_norm, attention, ffn_norm, ffn = _block(
            config, use_snn_ffn, layer_index, device)
        self.attention_norm = attention_norm
        self.attention = attention
        self.query_proj = Dense(D, D, dt, device)
        mode = config.memory_injection
        if mode == "cross_attention":
            self.memory_norm = LayerNorm(D, dt, device)
            self.memory_attention = MultiHeadDotProductAttention(
                config.num_heads, D, dt, device)
        elif mode == "gate":
            self.memory_proj = Dense(D, D, dt, device)
            self.memory_gate_proj = Dense(2 * D, D, dt, device)
        elif mode != "concat":
            raise ValueError(f"memory_injection {mode!r}")
        self.ffn_norm = ffn_norm
        self.ffn = ffn
        self.mesh = None
        self.seq_axis_name = "seq"

    def _sequence_mean(self, hidden: torch.Tensor) -> torch.Tensor:
        """[B, D] mean over the sequence: over every rank's chunk when the
        mesh shards it."""
        n = mesh_seq_axis(self.mesh, self.seq_axis_name)
        if n == 1:
            return hidden.mean(dim=1)
        total = all_reduce_sum(hidden.float().sum(dim=1),
                               self.mesh.get_group(self.seq_axis_name))
        return (total / (hidden.shape[1] * n)).to(hidden.dtype)

    def _inject_memory(self, hidden, memory_state):
        """The query (the projected sequence mean), one retrieval over the
        batch and the retrieved memories injected into `hidden`."""
        cfg = self.config
        dt = self.dtype
        query = self.query_proj(self._sequence_mean(hidden))   # [B, D]
        if self.retrieve_fn is not None:
            result = self.retrieve_fn(self.memory_config, memory_state,
                                      query.float(), cfg.num_retrieved)
        else:
            result = memory_engine.retrieve_auto(
                self.memory_config, memory_state, query.float(), None,
                cfg.num_retrieved)
        mem_feats = result.features.to(dt)                     # [B, K, D]
        mem_scores = result.scores.to(dt)                      # [B, K]

        if cfg.memory_injection == "cross_attention":
            hidden = hidden + self.memory_attention(
                self.memory_norm(hidden), mem_feats)
        else:
            weights = torch.softmax(mem_scores, dim=-1)[..., None]
            ctx = (mem_feats * weights).sum(dim=1, keepdim=True)  # [B,1,D]
            if cfg.memory_injection == "concat":
                hidden = hidden + _scalar(0.1, ctx) * ctx
            else:
                # every position gets the same context: project it once
                ctx = self.memory_proj(ctx).expand(hidden.shape)
                gate = torch.sigmoid(self.memory_gate_proj(
                    torch.cat([hidden, ctx], dim=-1)))
                hidden = hidden + gate * ctx
        return hidden

    def forward(self, hidden, memory_state=None, prosody=None,
                use_memory: bool = True, kv_cache=None, cache_index=None,
                dropout_seed=None):
        attn_out, new_cache = self.attention(
            self.attention_norm(hidden), prosody, use_memory, kv_cache,
            cache_index, dropout_seed)
        hidden = hidden + attn_out

        if use_memory and memory_state is not None:
            with span("layer.memory"):
                hidden = self._inject_memory(hidden, memory_state)

        return (hidden + self.ffn(self.ffn_norm(hidden), dropout_seed),
                new_cache)
