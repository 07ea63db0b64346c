"""Episodic memory engine (hippocampal formation) in PyTorch.

Counterpart of `aura_snn_rag_tpu.memory`: a device-resident vector bank
with one-shot writes, an IVF centroid index with a clustered candidate
store, combined cosine/spatial/temporal scoring and k-means rebuilds, and
the host-spilled bank (`SpilledBank`: int8 coarse rows on the card, exact
rows in host RAM), and the bank sharded over a mesh's ranks
(`memory.sharded`: one shard per rank, a per-shard top-k merged by
all-gather).
"""

from aura_snn_rag_tpu_torch.memory.state import (  # noqa: F401
    MemoryState, init_memory_state, state_from_numpy, state_to_numpy)
from aura_snn_rag_tpu_torch.memory.engine import (  # noqa: F401
    write_memories,
    bulk_load,
    retrieve,
    retrieve_bruteforce,
    retrieve_flat,
    retrieve_auto,
    decay_memories,
    rebuild_centroids,
)
from aura_snn_rag_tpu_torch.memory.hippocampus import (  # noqa: F401
    HippocampalFormation)
from aura_snn_rag_tpu_torch.memory.host_spill import (  # noqa: F401
    SpillDeviceState, SpilledBank)
from aura_snn_rag_tpu_torch.memory.sharded import (  # noqa: F401
    decay_memories_sharded,
    init_sharded_memory,
    rebuild_centroids_sharded,
    retrieve_sharded,
    write_memories_sharded,
)
from aura_snn_rag_tpu_torch.memory.cognitive_map import (  # noqa: F401
    CognitiveMapParams,
    init_cognitive_map,
    place_cell_rates,
    grid_cell_rates,
    time_cell_rates,
)
