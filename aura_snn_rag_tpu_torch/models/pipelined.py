"""Pipeline-parallel forward of the HippocampalTransformer (counterpart of
`aura_snn_rag_tpu/models/pipelined.py`).

The model's layer stack is split into S contiguous stages over a 'stage'
mesh axis and run through the GPipe schedule of `parallel.pipeline`. The
embedding, positional encoding and input norm (`_encode`) and the final
norm and tied head (`_head`) run replicated on every rank; each rank runs
its own stage's layers.

- `pipelined_lm_apply`: the plain (non-RAG) layer stack;
- `pipelined_rag_apply`: the RAG stack (`MemoryAugmentedLayer` stages).
  The episodic `MemoryState` rides as a replicated constant, so each
  stage's retrieval is local, through `retrieve_auto` (kernel B on the
  card), with no collective across stages.

The JAX functions take the flax params beside the model; a port module
holds its parameters, so these take the model alone. The layers'
gradients accumulate in their `.grad` on the rank of their stage, the
encoder's and head's on every rank (see `pipeline_apply` for the loss).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from aura_snn_rag_tpu_torch.config import ModelConfig
from aura_snn_rag_tpu_torch.parallel.mesh import axis_size
from aura_snn_rag_tpu_torch.parallel.pipeline import (
    pipeline_apply, split_microbatches, stack_stage_params)


def stage_pattern(cfg: ModelConfig, num_stages: int) -> Tuple[bool, ...]:
    """The per-stage SNN-FFN layout (one flag per layer of a stage); raises
    if the stages' layouts differ, as every stage runs one block."""
    N = cfg.num_layers
    if N % num_stages:
        raise ValueError(f"{N} layers do not split into {num_stages} "
                         f"stages")
    k = N // num_stages
    pats = [tuple((s * k + j) in cfg.snn_layers for j in range(k))
            for s in range(num_stages)]
    if any(p != pats[0] for p in pats):
        raise ValueError(
            f"snn_layers {cfg.snn_layers} is not uniform across "
            f"{num_stages} stages of {k} layers: pick a stage count that "
            f"tiles the SNN pattern (e.g. stages of 2 layers)")
    return pats[0]


def make_stage_params(model, num_stages: int, mesh: DeviceMesh,
                      axis: str = "stage"):
    """This rank's stage of the model's layers: layers [s k, (s + 1) k) of
    stage s (k = num_layers / S), as JAX regroups `layer_i` into stacked
    per-stage trees placed over `axis`."""
    k = model.config.num_layers // num_stages
    per_stage = [list(model.layers[s * k:(s + 1) * k])
                 for s in range(num_stages)]
    return stack_stage_params(per_stage, mesh, axis)


def _encode(model, input_ids: torch.Tensor) -> torch.Tensor:
    """Replicated front: place cells + theta-gamma + input norm."""
    B, L = input_ids.shape
    hidden, _ = model.semantic_encoder(input_ids)
    positions = torch.arange(L, device=input_ids.device).expand(B, L)
    return model.input_norm(hidden + model.pos_encoder(positions))


def _head(model, hidden: torch.Tensor) -> torch.Tensor:
    """Replicated output: final norm + tied (or dense) head, f32."""
    hidden = model.final_norm(hidden)
    if model.config.tie_word_embeddings:
        return model.semantic_encoder.attend(hidden).float()
    return model.lm_head(hidden).float()


def _run(model, input_ids, mesh, num_microbatches, prosody, axis, consts):
    S = axis_size(mesh, axis)
    stage_pattern(model.config, S)
    B, L = input_ids.shape
    hidden = _encode(model, input_ids)
    layers = make_stage_params(model, S, mesh, axis)

    def apply(layer, h, pr, ms):
        if consts is None:
            return layer(h, pr, True, None, None)[0]
        return layer(h, ms, pr, True, None, None)[0]

    def block(stage, x, ms=None):
        h, pr = x if prosody is not None else (x, None)
        for layer in stage:
            h = apply(layer, h, pr, ms)
        return (h, pr) if prosody is not None else h

    mb = split_microbatches(hidden, num_microbatches)
    acts = (mb, split_microbatches(prosody, num_microbatches)) \
        if prosody is not None else mb
    out = pipeline_apply(block, layers, acts, mesh, axis, consts=consts)
    hidden = (out[0] if prosody is not None else out).reshape(B, L, -1)
    return _head(model, hidden)


def pipelined_lm_apply(model, input_ids: torch.Tensor, mesh: DeviceMesh,
                       num_microbatches: int,
                       prosody: Optional[torch.Tensor] = None,
                       axis: str = "stage") -> torch.Tensor:
    """Forward `input_ids` [B, L] through a non-RAG model with its layer
    stack pipelined over `axis`; logits [B, L, V] f32 on every rank.
    Equal to `model(ids, prosody=prosody, use_memory=True)` (no dropout)."""
    if model.config.use_rag and model.memory_config is not None:
        raise ValueError("a RAG model: use pipelined_rag_apply")
    return _run(model, input_ids, mesh, num_microbatches, prosody, axis,
                None)


def pipelined_rag_apply(model, input_ids: torch.Tensor, memory_state,
                        mesh: DeviceMesh, num_microbatches: int,
                        prosody: Optional[torch.Tensor] = None,
                        axis: str = "stage") -> torch.Tensor:
    """Pipelined forward of the RAG stack (`MemoryAugmentedLayer`
    stages); logits [B, L, V] f32 on every rank. `memory_state` rides as
    a replicated constant: each stage's layers retrieve from it locally.
    Equal to `model(ids, prosody=prosody, use_memory=True,
    memory_state=memory_state)` (no dropout)."""
    if not (model.config.use_rag and model.memory_config is not None):
        raise ValueError("not a RAG model: use pipelined_lm_apply")
    return _run(model, input_ids, mesh, num_microbatches, prosody, axis,
                memory_state)
