"""Services (counterpart of `aura_snn_rag_tpu.services`). Ported so far:
the one-shot memorisation helpers, corpus ingestion (`ingest`) and the
continuous-learning orchestrator. The brain-system facade comes in a
later slice."""

from aura_snn_rag_tpu_torch.services.continuous_learning import (  # noqa: F401
    ContinuousLearningOrchestrator,
    FeedConfig,
    create_default_feeds,
)
from aura_snn_rag_tpu_torch.services.one_shot import (  # noqa: F401
    embed_with_model,
    one_shot_memorize_and_generate,
    one_shot_memorize_text,
    retrieve_custom_memories,
    store_custom_memory,
)
