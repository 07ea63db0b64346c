"""Services (counterpart of `aura_snn_rag_tpu.services`). Ported so far:
the one-shot memorisation helpers. Ingestion, continuous learning and
the brain-system facade come in later slices."""

from aura_snn_rag_tpu_torch.services.one_shot import (  # noqa: F401
    embed_with_model,
    one_shot_memorize_and_generate,
    one_shot_memorize_text,
    retrieve_custom_memories,
    store_custom_memory,
)
