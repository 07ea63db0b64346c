"""Brain orchestration and modulators (counterpart of
`aura_snn_rag_tpu.models.brain`): the amygdala, the endocrine system,
the liquid router and the thalamus that the LM's trainer runs, the basal
ganglia, the brain orchestration (`EnhancedBrain`, `LiquidBrain`, the
central nervous system) and topic specialists. The limbic system and
`NaturalBrain` are in `limbic.py` and `natural_brain.py`."""

from aura_snn_rag_tpu_torch.models.brain.amygdala import (  # noqa: F401
    Amygdala, build_prosody)
from aura_snn_rag_tpu_torch.models.brain.endocrine import (  # noqa: F401
    EndocrineSystem, HormoneType)
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import (  # noqa: F401
    BanditGating, LiquidCell, LiquidMoERouter)
from aura_snn_rag_tpu_torch.models.brain.thalamus import Thalamus  # noqa: F401
from aura_snn_rag_tpu_torch.models.brain.basal_ganglia import (  # noqa: F401
    BasalGanglia)
from aura_snn_rag_tpu_torch.models.brain.brain import (  # noqa: F401
    Brain, CentralNervousSystem, EnhancedBrain, LiquidBrain,
    TemporalMemoryInterpolator, fix_neuromorphic_crisis)
from aura_snn_rag_tpu_torch.models.brain.specialist import (  # noqa: F401
    Specialist, SpecialistRegistry, slugify)
