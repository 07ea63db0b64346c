"""Services (counterpart of `aura_snn_rag_tpu.services`): the one-shot
memorisation helpers, corpus ingestion (`ingest`), the
continuous-learning orchestrator and the brain-system facade
(`NeuromorphicBrainSystem`)."""

from aura_snn_rag_tpu_torch.services.brain_system import (  # noqa: F401
    DEFAULT_ZONES,
    NeuromorphicBrainSystem,
)
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
