"""Utilities: host array pooling, device memory statistics, energy
accounting and profiling (counterpart of `aura_snn_rag_tpu/utils`)."""

from aura_snn_rag_tpu_torch.utils.memory_utils import (  # noqa: F401
    ArrayPool, get_memory_stats, maybe_defragment,
)
from aura_snn_rag_tpu_torch.utils.energy import EnergyTracker  # noqa: F401
from aura_snn_rag_tpu_torch.utils.trace import (  # noqa: F401
    StepTimer, annotate, trace,
)
