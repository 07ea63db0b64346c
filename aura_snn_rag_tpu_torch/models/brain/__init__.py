"""Brain orchestration and modulators (counterpart of
`aura_snn_rag_tpu.models.brain`): the amygdala, the endocrine system,
the liquid router and the thalamus that the LM's trainer runs, and the
brain orchestration (`EnhancedBrain`, `LiquidBrain`, the central nervous
system) and topic specialists. The basal ganglia, the limbic system and
`NaturalBrain` come in a later slice."""

from aura_snn_rag_tpu_torch.models.brain.amygdala import (  # noqa: F401
    Amygdala, build_prosody)
from aura_snn_rag_tpu_torch.models.brain.endocrine import (  # noqa: F401
    EndocrineSystem, HormoneType)
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import (  # noqa: F401
    BanditGating, LiquidCell, LiquidMoERouter)
from aura_snn_rag_tpu_torch.models.brain.thalamus import Thalamus  # noqa: F401
from aura_snn_rag_tpu_torch.models.brain.brain import (  # noqa: F401
    Brain, CentralNervousSystem, EnhancedBrain, LiquidBrain,
    TemporalMemoryInterpolator, fix_neuromorphic_crisis)
from aura_snn_rag_tpu_torch.models.brain.specialist import (  # noqa: F401
    Specialist, SpecialistRegistry, slugify)
