"""PyTorch/CUDA port of aura_snn_rag_tpu, slice by slice.

This package imports torch and never JAX or the JAX package; the JAX
package beside it is the reference its tests hold it against. Entry
points run on the CUDA card unless the caller passes device="cpu".
Ported so far: the episodic-memory engine (`memory`) and its five
kernels (`ops.cuda`); the LM's serving path: the spiking and encoding
ops it runs (`ops`), the model (`models`), the sampler and the batched
server (`generation`) and the one-shot memorisation helpers
(`services`); the LM's training path: the trainer, loss, schedule,
optimizer and data (`training`), the modulators it runs
(`models.brain`) and its telemetry (`zones`); the operator's path:
checkpoints and online learning (`training`), the hash embedder
(`encoders`, native C++ through `_native`), corpus ingestion and the
continuous-learning orchestrator (`services`) and the command line
(`python -m aura_snn_rag_tpu_torch.cli`); the neuromorphic brain system:
the LIF, Izhikevich and AdEx neurons and the addition-only maths (`ops`),
the spiking layers, brain zones and routing runtime (`zones`),
`EnhancedBrain` and `LiquidBrain` (`models.brain`) and the
`NeuromorphicBrainSystem` facade (`services`, `cli brain-demo`); the
NaturalBrain path and the encoders (`models`, `encoders`); the data-
parallel runtime on `torch.distributed` (`parallel`: the launcher seam,
meshes, collectives), the bank sharded over a mesh (`memory.sharded`),
`Trainer.shard_to_mesh`, the utils (`utils`) and the CLI's `corpus` and
`mnist` (`bench_mnist`).
"""

from aura_snn_rag_tpu_torch.config import (  # noqa: F401
    AuraConfig,
    MemoryConfig,
    MeshConfig,
    ModelConfig,
    TrainingConfig,
    get_debug_config,
    get_full_config,
    get_medium_config,
    get_small_config,
    get_test_config,
    get_xl_config,
)
from aura_snn_rag_tpu_torch.memory import (  # noqa: F401
    CognitiveMapParams,
    HippocampalFormation,
    MemoryState,
    SpillDeviceState,
    SpilledBank,
    bulk_load,
    decay_memories,
    grid_cell_rates,
    init_cognitive_map,
    init_memory_state,
    place_cell_rates,
    rebuild_centroids,
    retrieve,
    retrieve_auto,
    retrieve_bruteforce,
    retrieve_flat,
    state_from_numpy,
    state_to_numpy,
    time_cell_rates,
    write_memories,
)
from aura_snn_rag_tpu_torch.models import (  # noqa: F401
    HippocampalTransformer,
    SNNRAGTransformer,
    TransformerOutput,
    params_from_numpy,
)
from aura_snn_rag_tpu_torch.generation import (  # noqa: F401
    BatchedGenerator,
    GenerationRequest,
    generate,
)
from aura_snn_rag_tpu_torch.training import (  # noqa: F401
    Trainer,
    hippocampal_loss,
    warmup_cosine_schedule,
)

__version__ = "0.1.0"
