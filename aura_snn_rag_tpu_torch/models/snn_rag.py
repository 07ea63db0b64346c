"""SNNRAGTransformer: the RAG + spiking-FFN flagship configuration
(counterpart of `aura_snn_rag_tpu/models/snn_rag.py`): a
`HippocampalTransformer` with `use_rag=True` and SNN FFNs on even layers;
`generate` binds the KV-cached sampler with the reference's sampling
defaults."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from aura_snn_rag_tpu_torch.config import MemoryConfig, ModelConfig
from aura_snn_rag_tpu_torch.models.transformer import HippocampalTransformer


def snn_rag_config(base: ModelConfig, snn_every: int = 2) -> ModelConfig:
    """RAG on + SNN FFN on even layers (reference default)."""
    return dataclasses.replace(
        base, use_rag=True,
        snn_layers=tuple(range(0, base.num_layers, snn_every)))


class SNNRAGTransformer(HippocampalTransformer):
    """HippocampalTransformer preset with retrieval-augmented layers."""

    @classmethod
    def create(cls, config: ModelConfig, memory_config: MemoryConfig,
               device: Union[str, torch.device, None] = "cuda",
               generator: Optional[torch.Generator] = None
               ) -> "SNNRAGTransformer":
        return cls(snn_rag_config(config), memory_config=memory_config,
                   device=device, generator=generator)

    def generate(self, input_ids: torch.Tensor, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None,
                 memory_state=None, temperature: float = 0.8,
                 top_k: int = 50, top_p: float = 0.9,
                 repetition_penalty: float = 1.2,
                 eos_token_id: Optional[int] = None) -> torch.Tensor:
        """KV-cached sampling with the reference's decoding defaults;
        `generator` defaults to one seeded 0 on the model's device."""
        from aura_snn_rag_tpu_torch.generation.sampler import generate
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generate(
            self, input_ids, max_new_tokens, generator,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty,
            memory_state=memory_state, use_memory=memory_state is not None,
            eos_token_id=eos_token_id)
