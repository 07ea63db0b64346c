"""Observability for training (counterpart of `aura_snn_rag_tpu.zones`):
the event bus and the stats collector. The spiking zones and the routing
runtime come in a later slice."""

from aura_snn_rag_tpu_torch.zones.events import Event, EventBus  # noqa: F401
from aura_snn_rag_tpu_torch.zones.stats import (  # noqa: F401
    BrainStats, StatsCollector)
