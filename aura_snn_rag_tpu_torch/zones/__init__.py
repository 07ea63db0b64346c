"""Spiking layers, brain zones and the routing runtime (counterpart of
`aura_snn_rag_tpu.zones`): layer primitives, zone containers,
keyword / liquid / top-k routing, multi-modal adapters, the event bus
and the stats collector."""

from aura_snn_rag_tpu_torch.zones.events import Event, EventBus  # noqa: F401
from aura_snn_rag_tpu_torch.zones.stats import (  # noqa: F401
    BrainStats, StatsCollector)
from aura_snn_rag_tpu_torch.zones.layers import (  # noqa: F401
    AdaptiveSpikingLayer, ReservoirLayer, SpikingLayer, make_layer)
from aura_snn_rag_tpu_torch.zones.brain_zone import (  # noqa: F401
    BrainZoneConfig, CorticalRegion, NeuromorphicBrainZone,
    SpikingNeuronConfig)
from aura_snn_rag_tpu_torch.zones.processor import (  # noqa: F401
    ContentRouter, NeuralPlasticityEngine, NeuromorphicProcessor)
