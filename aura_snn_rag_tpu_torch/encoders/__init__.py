"""Feature encoders (counterpart of `aura_snn_rag_tpu.encoders`). Ported
so far: the n-gram hash embedder and the embedding cache, host-side
numpy code the ingestion path runs."""

from aura_snn_rag_tpu_torch.encoders.hash_embedder import (  # noqa: F401
    FastHashEmbedder)
from aura_snn_rag_tpu_torch.encoders.embedding_cache import (  # noqa: F401
    EmbeddingCache)
