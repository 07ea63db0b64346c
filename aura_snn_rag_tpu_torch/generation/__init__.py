"""Generation: KV-cached incremental decode, sampling transforms and the
batched server (counterpart of `aura_snn_rag_tpu.generation`)."""

from aura_snn_rag_tpu_torch.generation.sampler import (  # noqa: F401
    apply_repetition_penalty,
    exact_topk_blockwise,
    top_k_filter,
    top_p_filter,
    sample_token,
    generate,
)
from aura_snn_rag_tpu_torch.generation.serving import (  # noqa: F401
    BatchedGenerator,
    GenerationRequest,
)
