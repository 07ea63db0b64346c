"""The parallel runtime on `torch.distributed` (counterpart of
`aura_snn_rag_tpu/parallel`): the launcher seam, meshes with the JAX
mesh's axis names, batch placement, the tensor-parallel sharding rules
and parameter placement, the GPipe microbatch pipeline over a 'stage'
axis, ring attention over a 'seq' axis, and the collectives with the
gradients that data-, tensor-, sequence- and pipeline-parallel training
and the sharded bank need."""

from aura_snn_rag_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    param_sharding_rules,
    param_specs,
    shard_batch,
    shard_params,
)
from aura_snn_rag_tpu_torch.parallel.distributed import (  # noqa: F401
    global_mesh,
    initialize,
    is_multiprocess,
    local_batch_slice,
    make_global_array,
    multislice_mesh,
    shutdown,
)
from aura_snn_rag_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    split_microbatches,
    stack_stage_params,
)
from aura_snn_rag_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    sequence_sharded_attention,
)
from aura_snn_rag_tpu_torch.parallel.collectives import (  # noqa: F401
    all_reduce_mean_,
    gather_rows,
    gather_stack,
)
