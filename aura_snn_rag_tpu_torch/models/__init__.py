"""Model stack: the hippocampal transformer LM and its building blocks,
and the spiking mixture-of-experts language zones (counterpart of
`aura_snn_rag_tpu.models`). The trainer's modulators, the brain
orchestration and `NaturalBrain` are in `models.brain`; the prosody
chain and the emotion head in `models.prosody` and
`models.emotion_head`; the pipeline-parallel forwards in
`models.pipelined`."""

from aura_snn_rag_tpu_torch.models.transformer import (  # noqa: F401
    HippocampalTransformer,
    TransformerOutput,
)
from aura_snn_rag_tpu_torch.models.layers import (  # noqa: F401
    PlaceCellEncoder,
    ThetaGammaPositional,
    ProsodyGatedAttention,
    TransformerLayer,
    MemoryAugmentedLayer,
    Synapsis,
    MLP,
    SNNFFN,
    HybridFFN,
)
from aura_snn_rag_tpu_torch.models.snn_rag import (  # noqa: F401
    SNNRAGTransformer,
    snn_rag_config,
)
from aura_snn_rag_tpu_torch.models.language_zone import (  # noqa: F401
    FullLanguageZone,
    MoELanguageZone,
    SNNExpert,
)
from aura_snn_rag_tpu_torch.models.pipelined import (  # noqa: F401
    pipelined_lm_apply,
    pipelined_rag_apply,
)
from aura_snn_rag_tpu_torch.models.convert import (  # noqa: F401
    module_from_numpy,
    params_from_numpy,
    trainer_from_numpy,
)
