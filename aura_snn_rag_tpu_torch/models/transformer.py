"""HippocampalTransformer: the flagship LM (counterpart of
`aura_snn_rag_tpu/models/transformer.py`).

One module covers both of the JAX package's presets: `config.use_rag`
with a `memory_config` selects `MemoryAugmentedLayer`s (retrieval +
injection per layer), `config.snn_layers` selects HybridFFN layers. The
episodic `MemoryState` is an input; the forward writes nothing to it and
returns the pooled `memory_summary` for the caller to write.

The module owns its parameters (the JAX package passes a params tree to
`apply`): they are drawn on `device` from `generator`, or loaded from a
flax tree with `models/convert.py`.

Training options: a forward given a `dropout_seed` in training mode runs
dropout at flax's sites (`layers.Dropout`); `use_gradient_checkpointing`
recomputes each layer in the backward when gradients are on and no KV
cache is passed, as the JAX package's `nn.remat` does: policy "full"
with `torch.utils.checkpoint`, "dots" with selective checkpointing that
saves the outputs of the matmuls and of attention (`_SAVED_OPS`) and
recomputes the rest (norms, gates, GIF steps). A recompute sees the same
seed, so it draws the same dropout masks.

Model parallelism: `parallel.mesh.shard_params(model, mesh)` makes the
layers tensor-parallel over the mesh's 'model' axis (the KV caches then
hold this rank's H/n heads), and a `mesh` (the constructor's, or
`set_mesh`) with a 'seq' axis larger than 1 makes the model sequence-
parallel: each rank runs its chunk of the sequence, at its global
positions, every attention core runs ring attention, and the RAG
layers' query and `memory_summary` are means over the whole sequence.

With DeepSeek-V3's block (`config.DeepSeekV3Config`) the model is a
plain token embedding (`embed_tokens`), the layers (latent attention
with RoPE in place of the theta-gamma positions, the dense FFN or the
MoE), a final RMSNorm and an untied head without bias; it has no place
cells (`place_activity` is None), no input norm and no dropout, runs on
one rank, and keeps no KV cache (`init_kv_caches` refuses it). Kimi-
Linear's hybrid block (`config.KimiLinearConfig`) is the same stem
(`ModelConfig.latent_stem`) with Kimi Delta Attention in the layers of
its pattern.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import MemoryConfig, ModelConfig
from aura_snn_rag_tpu_torch.models.layers import (
    Dense, Dropout, Embed, KVCache, LayerNorm, MemoryAugmentedLayer, MoEFFN,
    PlaceCellEncoder, ProsodyGatedAttention, RetrieveFn, RMSNorm,
    ThetaGammaPositional, TransformerLayer, compute_dtype, initialize)
from aura_snn_rag_tpu_torch.parallel.collectives import all_reduce_sum
from aura_snn_rag_tpu_torch.parallel.mesh import axis_index
from aura_snn_rag_tpu_torch.parallel.ring_attention import mesh_seq_axis

# remat policy "dots": the ops whose outputs are saved (the Dense products
# and the attention core); everything else is recomputed
_SAVED_OPS = ("mm", "addmm", "bmm", "baddbmm",
              "_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_cudnn_attention",
              "_scaled_dot_product_flash_attention_for_cpu")


def _dots_context():
    """The selective-checkpoint context of policy "dots" (PyTorch >= 2.4
    names imported here, so the model imports without them)."""
    from torch.utils.checkpoint import (
        CheckpointPolicy, create_selective_checkpoint_contexts)
    aten = torch.ops.aten
    saved = frozenset(getattr(aten, name).default for name in _SAVED_OPS
                      if hasattr(aten, name))

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


class TransformerOutput(NamedTuple):
    logits: torch.Tensor           # [B, L, V] f32
    place_activity: Optional[torch.Tensor]   # [B, L, n_place_cells]
    memory_summary: torch.Tensor   # [B, D] f32 mean-pooled features for writes
    hidden: torch.Tensor           # [B, L, D] final hidden states


class HippocampalTransformer(nn.Module):
    """The LM. Parameters are f32 on `device` (CUDA unless the caller asks
    for the CPU), drawn from `generator` (a `torch.Generator` on that
    device; seed 0 when None); `device="meta"` builds the shapes only.
    `mesh` routes the attention over its 'seq' axis (`set_mesh`)."""

    def __init__(self, config: ModelConfig,
                 memory_config: Optional[MemoryConfig] = None,
                 retrieve_fn: Optional[RetrieveFn] = None,
                 device: Union[str, torch.device, None] = "cuda",
                 generator: Optional[torch.Generator] = None,
                 mesh=None, seq_axis_name: str = "seq"):
        super().__init__()
        dev = resolve_device(device)
        self.config = cfg = config
        self.memory_config = memory_config
        dt = compute_dtype(cfg)
        latent = cfg.latent_stem
        if latent:
            if cfg.tie_word_embeddings:
                raise ValueError("DeepSeek-V3's block has an untied head")
            self.embed_tokens = Embed(cfg.vocab_size, cfg.embedding_dim, dev)
        else:
            self.semantic_encoder = PlaceCellEncoder(cfg, dev)
            self.pos_encoder = ThetaGammaPositional(cfg, dev)
            self.input_norm = LayerNorm(cfg.embedding_dim, dt, dev)
        rag = cfg.use_rag and memory_config is not None
        self.layers = nn.ModuleList([
            MemoryAugmentedLayer(cfg, memory_config, use_snn_ffn=i in
                                 cfg.snn_layers, retrieve_fn=retrieve_fn,
                                 device=dev, layer_index=i) if rag else
            TransformerLayer(cfg, use_snn_ffn=i in cfg.snn_layers,
                             device=dev, layer_index=i)
            for i in range(cfg.num_layers)])
        self.final_norm = (RMSNorm(cfg.embedding_dim, cfg.rms_norm_eps, dt,
                                   dev) if latent
                           else LayerNorm(cfg.embedding_dim, dt, dev))
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.embedding_dim, cfg.vocab_size, dt, dev,
                                 use_bias=not latent)
        self.input_dropout = Dropout(cfg.dropout)
        # every dropout site gets its own index: its masks' seed
        sites = [m for m in self.modules() if isinstance(m, Dropout)]
        for i, m in enumerate(sites):
            m.site = i
        if dev.type != "meta":
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            initialize(self, generator)
        self.set_mesh(mesh, seq_axis_name)

    def set_mesh(self, mesh, seq_axis_name: str = "seq") -> None:
        """Sequence-parallel routing: with a mesh whose `seq_axis_name`
        axis is larger than 1, every attention core runs ring attention
        over it and every sequence mean covers the whole sequence (None
        turns it off). The JAX package's model takes the mesh as a field
        and `Trainer.shard_to_mesh` clones the model with it."""
        self.mesh, self.seq_axis_name = mesh, seq_axis_name
        for m in self.modules():
            if isinstance(m, (ProsodyGatedAttention, MemoryAugmentedLayer)):
                m.mesh, m.seq_axis_name = mesh, seq_axis_name

    def _seq_shards(self) -> int:
        return mesh_seq_axis(self.mesh, self.seq_axis_name)

    @property
    def device(self) -> torch.device:
        return self.final_norm.weight.device

    @property
    def token_table(self) -> torch.Tensor:
        """The token embedding's [vocab, D] f32 table."""
        if self.config.latent_stem:
            return self.embed_tokens.weight
        return self.semantic_encoder.token_embedding.weight

    @property
    def moe_layers(self) -> Tuple[MoEFFN, ...]:
        """The layers' MoE FFNs, in order."""
        return tuple(m for m in self.modules() if isinstance(m, MoEFFN))

    def forward(self, input_ids: torch.Tensor,
                prosody: Optional[torch.Tensor] = None,
                use_memory: bool = True, memory_state=None,
                positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[Tuple[KVCache, ...]] = None,
                cache_index=None, dropout_seed: Optional[int] = None
                ) -> Tuple[TransformerOutput, Optional[Tuple[KVCache, ...]]]:
        """input_ids [B, L]; positions default to 0..L-1 (sequence-parallel,
        to this rank's chunk's global positions, rank * L + 0..L-1). With
        `kv_caches` (`init_kv_caches`, updated in place) the L tokens sit
        at rows [cache_index, cache_index + L) and the caches come back.
        In training mode a `dropout_seed` turns dropout on."""
        cfg = self.config
        B, L = input_ids.shape
        n_seq = self._seq_shards()
        if n_seq > 1 and kv_caches is not None:
            raise ValueError("a KV cache decodes one sequence on one rank; "
                             "a 'seq'-sharded model has none")
        if cfg.latent_stem:
            if n_seq > 1 or kv_caches is not None or positions is not None:
                raise ValueError("DeepSeek-V3's block runs whole sequences "
                                 "at positions 0..L-1, on one rank")
            place_activity = None
            hidden = F.embedding(input_ids, self.embed_tokens.weight).to(
                compute_dtype(cfg))
        else:
            hidden, place_activity = self.semantic_encoder(input_ids)
            if positions is None:
                start = (L * axis_index(self.mesh, self.seq_axis_name)
                         if n_seq > 1 else 0)
                positions = (start + torch.arange(
                    L, device=input_ids.device)).expand(B, L)
            hidden = self.input_norm(hidden + self.pos_encoder(positions))
            hidden = self.input_dropout(hidden, dropout_seed)

        remat = (cfg.use_gradient_checkpointing and kv_caches is None
                 and torch.is_grad_enabled())
        context = (_dots_context() if remat
                   and cfg.gradient_checkpoint_policy == "dots"
                   else noop_context_fn)
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layers):
            cache_i = kv_caches[i] if kv_caches is not None else None
            if isinstance(layer, MemoryAugmentedLayer):
                args = (hidden, memory_state, prosody, use_memory, cache_i,
                        cache_index, dropout_seed)
            else:
                args = (hidden, prosody, use_memory, cache_i, cache_index,
                        dropout_seed)
            if remat:
                hidden, cache_out = checkpoint(layer, *args,
                                               use_reentrant=False,
                                               context_fn=context)
            else:
                hidden, cache_out = layer(*args)
            if new_caches is not None:
                new_caches.append(cache_out)

        hidden = self.final_norm(hidden)
        if cfg.tie_word_embeddings:
            logits = self.semantic_encoder.attend(hidden)
        else:
            logits = self.lm_head(hidden)
        if n_seq > 1:                 # the mean over every rank's chunk
            summary = all_reduce_sum(
                hidden.float().sum(dim=1),
                self.mesh.get_group(self.seq_axis_name)) / (L * n_seq)
        else:
            summary = hidden.mean(dim=1).float()
        out = TransformerOutput(
            logits=logits.float(),
            place_activity=place_activity,
            memory_summary=summary,
            hidden=hidden)
        return out, (tuple(new_caches) if new_caches is not None else None)

    def init_kv_caches(self, batch_size: int, max_len: int
                       ) -> Tuple[KVCache, ...]:
        """Empty per-layer (K, V) caches [B, H, max_len, Hd] in the compute
        dtype (the JAX package's are [B, max_len, H, Hd]); H is this
        rank's heads under tensor parallelism."""
        cfg = self.config
        if cfg.latent_stem:
            raise NotImplementedError(
                "DeepSeek-V3's block has no KV cache here: decoding needs a "
                "latent cache (kv_a and the rope key per position)")
        tp = self.layers[0].attention.tp if len(self.layers) else None
        heads = cfg.num_heads // (tp.size if tp is not None else 1)
        shape = (batch_size, heads, max_len, cfg.head_dim)
        dt = compute_dtype(cfg)
        return tuple((torch.zeros(shape, dtype=dt, device=self.device),
                      torch.zeros(shape, dtype=dt, device=self.device))
                     for _ in range(cfg.num_layers))
