"""One-shot memorisation helpers (counterpart of
`aura_snn_rag_tpu/services/one_shot.py`): write a text's model-embedding
summary into episodic memory, then generate with memory conditioning on.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch.memory.hippocampus import HippocampalFormation


def _ids_2d(token_ids, device) -> torch.Tensor:
    ids = torch.as_tensor(np.asarray(token_ids) if not torch.is_tensor(
        token_ids) else token_ids).to(device, torch.long)
    return ids[None, :] if ids.ndim == 1 else ids


@torch.no_grad()
def embed_with_model(model, token_ids) -> torch.Tensor:
    """Mean-pooled final hidden state [B, D] (the model's memory
    summary), without memory."""
    out, _ = model(_ids_2d(token_ids, model.device), use_memory=False)
    return out.memory_summary


def store_custom_memory(hippocampus: HippocampalFormation, memory_id: str,
                        features) -> None:
    f = features if torch.is_tensor(features) else \
        torch.as_tensor(np.asarray(features, np.float32))
    hippocampus.write_batch([memory_id], f.reshape(1, -1))


def retrieve_custom_memories(hippocampus: HippocampalFormation,
                             query_features, k: int = 5
                             ) -> List[Tuple[str, float]]:
    return hippocampus.retrieve_similar_memories(query_features, k=k)


def one_shot_memorize_text(model, hippocampus: HippocampalFormation,
                           token_ids, memory_id: Optional[str] = None) -> str:
    """Write the text's pooled summary; the default id hashes the token ids
    as int32, as the JAX package does, so both name a text alike."""
    ids = _ids_2d(token_ids, model.device)
    summary = embed_with_model(model, ids)
    mid = memory_id or "oneshot-" + hashlib.sha256(
        ids.cpu().numpy().astype(np.int32).tobytes()).hexdigest()[:12]
    hippocampus.write_batch([mid], summary[:1])
    return mid


def one_shot_memorize_and_generate(model, hippocampus: HippocampalFormation,
                                   memorize_ids, prompt_ids,
                                   max_new_tokens: int = 32,
                                   generator: Optional[torch.Generator] = None,
                                   **sample_kw):
    """Memorise the support text, then generate from the prompt with
    `use_memory=True`, so retrieval conditions the continuation. Returns
    (memory id, [B, L + max_new_tokens] token ids)."""
    from aura_snn_rag_tpu_torch.generation.sampler import generate

    mid = one_shot_memorize_text(model, hippocampus, memorize_ids)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    out = generate(model, _ids_2d(prompt_ids, model.device), max_new_tokens,
                   generator, memory_state=hippocampus.state,
                   use_memory=True, **sample_kw)
    return mid, out
