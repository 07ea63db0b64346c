"""Feature encoders and ingestion pipelines (counterpart of
`aura_snn_rag_tpu.encoders`): the n-gram hash embedder and the embedding
cache (exported here, as in the JAX package), the event-pattern and
formant encoders, the dual-layer SRFFN and the corpus pre-embedding
pipeline (in their modules)."""

from aura_snn_rag_tpu_torch.encoders.hash_embedder import (  # noqa: F401
    FastHashEmbedder)
from aura_snn_rag_tpu_torch.encoders.embedding_cache import (  # noqa: F401
    EmbeddingCache)
