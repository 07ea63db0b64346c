#!/bin/sh
# Two-process distributed demo on one machine (the CPU, gloo): the same
# launcher seam a multi-host job uses (aura_snn_rag_tpu_torch/parallel/
# distributed.py): process 0 hosts the rendezvous; each process joins the
# default process group through AURA_COORDINATOR / AURA_NUM_PROCESSES /
# AURA_PROCESS_ID, builds the global ('data', 'model') mesh, loads its own
# slice of the global batch, and an all-reduce crosses the process
# boundary. On a cluster, export the same variables (or run under
# torchrun) and start one process per card.
#
#   sh aura_snn_rag_tpu_torch/examples/run_multihost_cpu.sh
set -e
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
PY="${PYTHON:-python3}"
COORD="${AURA_COORDINATOR:-127.0.0.1:$(PYTHONPATH="$REPO" "$PY" -c \
  'from aura_snn_rag_tpu_torch.parallel.distributed import free_port; print(free_port())')}"

run_worker() {
  AURA_COORDINATOR=$COORD AURA_NUM_PROCESSES=2 AURA_PROCESS_ID=$1 \
  PYTHONPATH="$REPO" "$PY" - <<PYEOF
import numpy as np
import torch
import torch.distributed as tdist
from aura_snn_rag_tpu_torch.parallel import distributed as dist

multi = dist.initialize(device="cpu", timeout=120)
pid = tdist.get_rank()
mesh = dist.global_mesh(n_model=1)
sl = dist.local_batch_slice(8)
local = np.arange(8, dtype=np.float32)[sl, None]
garr = dist.make_global_array(local, mesh)
# a torch rank holds its slice only: the global sum is an all-reduce
total = garr.local.sum()
tdist.all_reduce(total)
total = float(total)
shape = {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
# one write per line: the two processes share the terminal
print(f"process {pid}: mesh={shape} global_sum={total}\n", end="",
      flush=True)
assert multi and garr.global_shape == (8, 1) and total == 28.0
dist.shutdown()
PYEOF
}

run_worker 1 &
W1=$!
run_worker 0
wait $W1
echo "multihost demo OK"
