"""The multi-process launcher seam on `torch.distributed` (counterpart of
`aura_snn_rag_tpu/parallel/distributed.py`, which runs over
`jax.distributed`).

The port runs one process per device. A process group over every
process, NCCL on the cards or gloo on the CPU, stands for JAX's global
device list; a `torch.distributed` DeviceMesh over its ranks stands for a
`jax.sharding.Mesh`. Elasticity follows the JAX package: checkpoint-based
resumption, no live elastic scaling.

- `initialize()`: idempotent process-group set-up from explicit arguments
  or the environment (AURA_COORDINATOR / AURA_NUM_PROCESSES /
  AURA_PROCESS_ID; a process started by torchrun takes its rank from
  RANK and its card from LOCAL_RANK);
- `spawn_ranks(target, world, out_dir)`: a local launcher, one process
  per rank, with `free_port()` for a TCP rendezvous and
  `record_failure` for a rank's traceback;
- `global_mesh(n_model)`: a ('data', 'model') mesh over every rank;
- `multislice_mesh(n_slices, n_model)`: a ('replica', 'data', 'model')
  mesh;
- `local_batch_slice(global_batch)`: this process's rows of a batch;
- `make_global_array(local_batch, mesh)`: this rank's slice beside the
  global shape (a rank cannot hold a global array).

Ranks are laid out as JAX orders its devices, by (process, device):
consecutive ranks share 'model' (innermost, within a host), 'replica' is
outermost.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import time
import traceback
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aura_snn_rag_tpu_torch._device import resolve_device


def is_multiprocess() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device: Union[str, torch.device, None] = "cuda",
               timeout: Optional[float] = None) -> bool:
    """Join the default process group (idempotent: once a group exists
    this only reports it).

    Returns True when a group of more than one process was set up, False
    for the single-process no-op path (no coordinator and no process
    count given, in the arguments or the environment). Arguments fall
    back to AURA_COORDINATOR, AURA_NUM_PROCESSES and AURA_PROCESS_ID (the
    process id then to RANK, which torchrun sets per process).
    `coordinator_address` is "host:port" (a TCP rendezvous) or any
    `init_method` URL, such as "file:///path". On `device` "cuda" (the
    default; raises without a card) the group runs NCCL on card
    `local_device_ids[0]` (default LOCAL_RANK, else process_id modulo the
    cards); on "cpu" it runs gloo. `timeout` (seconds) bounds the
    rendezvous and every collective."""
    if dist.is_initialized():
        return is_multiprocess()
    coordinator_address = (coordinator_address
                           or os.environ.get("AURA_COORDINATOR"))
    if num_processes is None:
        num_processes = _env_int("AURA_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("AURA_PROCESS_ID", "RANK")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"a process group needs a coordinator, a process count and a "
            f"process id; got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_device_ids:
            index = int(local_device_ids[0])
        else:
            index = _env_int("LOCAL_RANK")
            if index is None:
                index = process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    return is_multiprocess()


def shutdown() -> None:
    """Leave the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def record_failure(out_dir: str, rank: int) -> None:
    """Write the exception being handled to `out_dir`/error<rank>.txt,
    where `spawn_ranks` reads it."""
    with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
        f.write(traceback.format_exc())


def spawn_ranks(target: Callable, world: int, out_dir: str,
                args: Sequence = (), timeout: float = 900.0,
                name: str = "ranks") -> None:
    """Run `target(rank, *args)` in `world` processes (the spawn method;
    `target` must be importable by its module's name) and wait up to
    `timeout` seconds for all of them; a rank still running then is
    killed. Raises RuntimeError naming the hung ranks, the exit codes and
    every rank's traceback left by `record_failure` in `out_dir`, if any
    rank hung, failed or exited non-zero."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, *args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for rank in range(world):
        path = os.path.join(out_dir, f"error{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    if hung or errors or any(p.exitcode for p in procs):
        raise RuntimeError(
            f"{name} on {world} ranks: hung {hung}, exit codes "
            f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))


def _world() -> Tuple[int, int]:
    """(world size, rank); (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_from_ranks(ranks, axis_names: Sequence[str]) -> DeviceMesh:
    """A DeviceMesh over `ranks` (an array of global ranks, one dimension
    per axis name) on the default group's device type. Every rank of the
    default group calls it, as for any new process group."""
    return DeviceMesh(_device_type(), torch.as_tensor(np.asarray(ranks)),
                      mesh_dim_names=tuple(axis_names))


def global_mesh(n_model: int = 1,
                axis_names: Tuple[str, str] = ("data", "model")
                ) -> DeviceMesh:
    """('data', 'model') mesh over every rank: 'model' over consecutive
    ranks (one host's cards, where tensor-parallel collectives stay on
    NVLink), 'data' across them."""
    n, _ = _world()
    if n % n_model:
        raise ValueError(f"{n} ranks not divisible by model={n_model}")
    return mesh_from_ranks(np.arange(n).reshape(n // n_model, n_model),
                           axis_names)


def multislice_mesh(n_slices: int, n_model: int = 1,
                    axis_names: Tuple[str, str, str] = ("replica", "data",
                                                        "model"),
                    devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """('replica', 'data', 'model') mesh: 'replica' outermost (across
    slices, the slow links), 'data' and 'model' within a slice. `devices`
    are global ranks (default: all, in order). Designed for gradient
    all-reduce over ('replica', 'data') and the hierarchical sharded bank
    over the same axes (`memory.sharded`)."""
    ranks = (np.arange(_world()[0]) if devices is None
             else np.asarray(list(devices)))
    n = len(ranks)
    if n % (n_slices * n_model):
        raise ValueError(f"{n} ranks not divisible by {n_slices} slices x "
                         f"model={n_model}")
    return mesh_from_ranks(
        ranks.reshape(n_slices, n // (n_slices * n_model), n_model),
        axis_names)


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a global batch: each process loads its own
    slice."""
    pc, pi = _world()
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{pc} processes")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


class GlobalArray(NamedTuple):
    """This rank's slice of a batch sharded over a mesh axis."""
    local: torch.Tensor          # this rank's rows, on its device
    global_shape: Tuple[int, ...]
    start: int                   # the first global row of `local`


def make_global_array(local_batch, mesh: DeviceMesh,
                      axis: str = "data") -> GlobalArray:
    """The port's counterpart of JAX's global array assembled from
    per-process batches. A torch rank holds no global array: this returns
    the rank's slice on its device with the global shape (rows times the
    size of `axis`) and its offset; code that needs the whole array
    gathers it with a collective."""
    from aura_snn_rag_tpu_torch.parallel.mesh import (
        axis_index, axis_size, mesh_device)
    if not torch.is_tensor(local_batch):
        local_batch = torch.as_tensor(np.asarray(local_batch))
    local = local_batch.to(mesh_device(mesh))
    n = axis_size(mesh, axis)
    return GlobalArray(local, (local.shape[0] * n, *local.shape[1:]),
                       axis_index(mesh, axis) * local.shape[0])
