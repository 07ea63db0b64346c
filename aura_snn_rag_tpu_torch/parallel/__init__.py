"""Data-parallel runtime on `torch.distributed` (counterpart of
`aura_snn_rag_tpu/parallel`, its data half): the launcher seam, meshes
with the JAX mesh's axis names, batch and parameter placement, and the
collectives with the gradients the sharded bank and the data-parallel
trainer need. The tensor-parallel rules, the GPipe pipeline and ring
attention (`pipeline.py`, `ring_attention.py`) are not ported yet."""

from aura_snn_rag_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
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
from aura_snn_rag_tpu_torch.parallel.collectives import (  # noqa: F401
    all_reduce_mean_,
    gather_rows,
    gather_stack,
)
