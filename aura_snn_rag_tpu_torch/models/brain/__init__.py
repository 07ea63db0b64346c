"""Brain modulators that the LM's trainer runs (counterpart of
`aura_snn_rag_tpu.models.brain`): the amygdala, the endocrine system, the
liquid router and the thalamus. The basal ganglia, limbic system and the
brain orchestration come in a later slice."""

from aura_snn_rag_tpu_torch.models.brain.amygdala import (  # noqa: F401
    Amygdala, build_prosody)
from aura_snn_rag_tpu_torch.models.brain.endocrine import (  # noqa: F401
    EndocrineSystem, HormoneType)
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import (  # noqa: F401
    BanditGating, LiquidCell, LiquidMoERouter)
from aura_snn_rag_tpu_torch.models.brain.thalamus import Thalamus  # noqa: F401
