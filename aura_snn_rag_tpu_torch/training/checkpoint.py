"""Checkpoints of the trainer: parameters, optimizer, step, memory bank and
id table (counterpart of `aura_snn_rag_tpu/training/checkpoint.py`, which
is built on orbax and needs JAX).

A checkpoint holds what the JAX package's holds, and nothing more:
- the parameters (the optimizer's flat f32 buffer);
- the optimizer state `AdamWState(count, mu, nu)`;
- the step given to `save`;
- the bank's `MemoryState` and the cognitive map;
- the amygdala's and the thalamus's weights (empty when disabled);
- a `meta_{step}.json` sidecar with `loss`, `slot_ids`,
  `current_location` and `writes_since_rebuild`, as the JAX package
  writes it.
The hormones, the thalamus gate's last reading, the replay buffer, EWC
and the dropout seed stream are not saved, as in the JAX package.

Format: `ckpt_{step}.pt`, `torch.save` of a dict of CPU tensors (in
their own dtypes) and Python scalars, read back with
`torch.load(..., map_location="cpu", weights_only=True)`. Each file is
written under a temporary name, flushed to disk and moved into place
with `os.replace`, the sidecar first and the tensors last: a save cut
short leaves no `ckpt_{step}.pt`, so it never becomes `latest_step()`.

A data-parallel trainer (`Trainer.shard_to_mesh`) is saved once, by the
mesh's first rank, while the mesh's other ranks wait at a barrier: its
parameters, optimizer state and modulators are replicated. A sharded
bank is saved in the JAX package's stacked layout: every field [S, ...],
shard s at row s (the first rank receives the shards, one at a time,
into host memory), with a `memory_layout` entry
({"axes": the bank axes, "shards": S}); restore gives each rank its row,
and a checkpoint of another layout (sharded or not, other axes, another
S) raises. Every rank of the mesh calls `save` and `restore`, and reads
the same directory; ranks of the job outside the mesh take no part. A
single-process trainer's checkpoint has no `memory_layout` and is
written as before.

A tensor-parallel trainer (a 'model' axis larger than 1) saves the whole,
unsharded parameters and moments, in the unsharded trainer's layout
(`Trainer.full_tensors`, gathered over the 'model' axis), and restores
by taking its parts of them (`Trainer.local_tensors`): a checkpoint
moves between meshes, as the JAX package's global arrays do.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from aura_snn_rag_tpu_torch.memory.cognitive_map import CognitiveMapParams
from aura_snn_rag_tpu_torch.memory.state import MemoryState
from aura_snn_rag_tpu_torch.parallel.mesh import (
    axes_size, mesh_barrier, rank_index)

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy that owns its storage (a view would save its base)."""
    return t.detach().to("cpu", copy=True)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """The numpy form `HippocampalFormation.load_state_dict` takes: bf16
    as f32 (exact; numpy has no bfloat16)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _write_atomic(path: str, write) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _expect(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.is_tensor(got):
        raise ValueError(f"checkpoint {name}: not a tensor")
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise ValueError(
            f"checkpoint {name}: {tuple(got.shape)} {got.dtype}, trainer "
            f"{tuple(want.shape)} {want.dtype}")


def _expect_modules(name: str, got: Dict[str, Any], module) -> None:
    want = {} if module is None else module.state_dict()
    if set(got) != set(want):
        raise ValueError(f"checkpoint {name}: keys {sorted(got)}, trainer "
                         f"{sorted(want)}")
    for key, t in want.items():
        _expect(f"{name}.{key}", got[key], t)


def _layout(trainer) -> Optional[Dict[str, Any]]:
    """The bank's layout entry: None for an unsharded bank."""
    mesh = getattr(trainer, "_memory_mesh", None)
    if mesh is None:
        return None
    axes = list(trainer._batch_axes)
    return {"axes": axes, "shards": axes_size(mesh, axes)}


def _writer(trainer) -> bool:
    """Whether this process writes the checkpoint: the mesh's first rank
    of a data-parallel trainer, or the one process."""
    mesh = getattr(trainer, "mesh", None)
    return mesh is None or dist.get_rank() == int(mesh.mesh.reshape(-1)[0])


def _gather_bank(trainer) -> Optional[Dict[str, torch.Tensor]]:
    """The sharded bank as stacked [S, ...] CPU tensors on the writer
    (None on the other ranks). Shard s comes from the first rank of the
    mesh that holds it, by a point-to-point send of one field at a time,
    and the writer moves it to the host before it takes the next: on the
    device it holds at most one shard of one field beyond its own bank.
    Only the mesh's ranks take part."""
    mesh, axes = trainer._memory_mesh, trainer._batch_axes
    S = axes_size(mesh, axes)
    rank = dist.get_rank()
    writer = int(mesh.mesh.reshape(-1)[0])
    owner = {}
    for r in mesh.mesh.reshape(-1).tolist():
        owner.setdefault(rank_index(mesh, axes, r), r)
    out = {}
    for name, t in zip(MemoryState._fields, trainer.hippocampus.state):
        # as bytes: gloo takes neither bool nor every dtype
        wire = t.contiguous().reshape(-1).view(torch.uint8)
        if rank == writer:
            out[name] = torch.empty((S, *t.shape), dtype=t.dtype)
        for s, r in sorted(owner.items()):
            if r == writer:
                if rank == writer:
                    out[name][s].copy_(t)
            elif rank == r:
                dist.send(wire, dst=writer)
            elif rank == writer:
                part = torch.empty_like(wire)
                dist.recv(part, src=r)
                out[name][s].copy_(part.view(t.dtype).reshape(t.shape))
    return out if rank == writer else None


def _full_like(trainer, flat: torch.Tensor) -> torch.Tensor:
    """A tensor of the unsharded layout's shape and `flat`'s dtype, for
    the checks (no collective)."""
    if trainer._tp is None:
        return flat
    n = sum(p.numel() * (trainer._tp.size if d is not None else 1)
            for p, d in zip(trainer.optimizer.params, trainer._tp_dims))
    return torch.empty(n, dtype=flat.dtype, device="meta")


class CheckpointManager:
    """Saves and restores a port `Trainer` (`training/trainer.py`) under
    `directory`, keeping the newest `max_to_keep` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"meta_{step}.json")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_CKPT.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer, loss: float = 0.0) -> None:
        opt, hippo = trainer.optimizer, trainer.hippocampus
        layout = _layout(trainer)
        memory = (_gather_bank(trainer) if layout is not None else
                  {name: _host(t) for name, t in
                   zip(MemoryState._fields, hippo.state)})
        count, mu, nu = opt.state
        full = [trainer.full_tensors(t) for t in (opt.flat, mu, nu)]
        if not _writer(trainer):
            mesh_barrier(trainer.mesh)
            return
        payload = {
            "params": _host(full[0]),
            "count": _host(count),
            "mu": _host(full[1]),
            "nu": _host(full[2]),
            "step": int(step),
            "memory_state": memory,
            "cognitive_map": {name: _host(t) for name, t in
                              zip(CognitiveMapParams._fields,
                                  hippo.cognitive_map)},
            "amygdala": ({} if trainer.amygdala is None else
                         {k: _host(t) for k, t in
                          trainer.amygdala.state_dict().items()}),
            "thalamus": ({} if trainer.thalamus is None else
                         {k: _host(t) for k, t in
                          trainer.thalamus.state_dict().items()}),
        }
        sd = hippo.host_state_dict()
        meta = {
            "loss": float(loss),
            "slot_ids": list(sd["slot_ids"]),
            "current_location": np.asarray(sd["current_location"]).tolist(),
            "writes_since_rebuild": sd["writes_since_rebuild"],
        }
        if layout is not None:
            payload["memory_layout"] = layout
        _write_atomic(self.meta_path(step),
                      lambda f: f.write(json.dumps(meta).encode()))
        _write_atomic(self.path(step), lambda f: torch.save(payload, f))
        for old in self.all_steps()[:-self.max_to_keep]:
            for p in (self.path(old), self.meta_path(old)):
                if os.path.exists(p):
                    os.remove(p)
        if getattr(trainer, "mesh", None) is not None:
            mesh_barrier(trainer.mesh)

    def restore(self, trainer, step: Optional[int] = None,
                load_optimizer: bool = True) -> int:
        """Restore `step` (the latest when None) into `trainer`; returns
        the step, or 0 when the directory holds no checkpoint.

        The whole checkpoint is read and checked on the host before the
        trainer is touched, so a missing, corrupt or mis-shaped one
        raises and leaves the trainer as it was (the JAX package's
        `via_host=True` contract; the port has only that path, so there
        is no `via_host` argument). The parameters, moments and count
        are copied into the optimizer's buffers in place: every
        `Parameter` stays a view of `optimizer.flat`. With
        `load_optimizer=False` the trainer keeps its optimizer state."""
        step = self.latest_step() if step is None else step
        if step is None:
            return 0
        payload = torch.load(self.path(step), map_location="cpu",
                             weights_only=True)
        with open(self.meta_path(step)) as f:
            meta = json.load(f)

        opt, hippo = trainer.optimizer, trainer.hippocampus
        layout = _layout(trainer)
        if payload.get("memory_layout") != layout:
            raise ValueError(f"checkpoint bank layout "
                             f"{payload.get('memory_layout')}, trainer "
                             f"{layout}")
        memory = payload["memory_state"]
        if layout is not None:                   # this rank's shard
            s = rank_index(trainer._memory_mesh, layout["axes"],
                           dist.get_rank())
            for name, t in memory.items():
                if not torch.is_tensor(t) or t.dim() == 0 \
                        or t.shape[0] != layout["shards"]:
                    raise ValueError(f"checkpoint memory_state.{name}: "
                                     f"not stacked over "
                                     f"{layout['shards']} shards")
            memory = {name: t[s] for name, t in memory.items()}
        count, mu, nu = opt.state
        _expect("count", payload["count"], count)
        for name, want in (("params", opt.flat), ("mu", mu), ("nu", nu)):
            _expect(name, payload[name], _full_like(trainer, want))
        for group, values, fields, state in (
                ("memory_state", memory, MemoryState._fields, hippo.state),
                ("cognitive_map", payload["cognitive_map"],
                 CognitiveMapParams._fields, hippo.cognitive_map)):
            if set(values) != set(fields):
                raise ValueError(f"checkpoint {group}: fields "
                                 f"{sorted(values)}")
            for name, want in zip(fields, state):
                _expect(f"{group}.{name}", values[name], want)
        _expect_modules("amygdala", payload["amygdala"], trainer.amygdala)
        _expect_modules("thalamus", payload["thalamus"], trainer.thalamus)
        mcfg = hippo.config
        if (len(meta["slot_ids"]) != mcfg.max_memories
                or len(meta["current_location"]) != mcfg.spatial_dims):
            raise ValueError(f"checkpoint {self.meta_path(step)}: "
                             f"{len(meta['slot_ids'])} slot ids and a "
                             f"location of {len(meta['current_location'])}, "
                             f"bank of {mcfg.max_memories} in "
                             f"{mcfg.spatial_dims} dims")

        local = trainer.local_tensors
        with torch.no_grad():
            opt.flat.copy_(local(payload["params"]))
            if load_optimizer:
                count.copy_(payload["count"])
                mu.copy_(local(payload["mu"]))
                nu.copy_(local(payload["nu"]))
        trainer._step = int(payload["step"])
        trainer._pending = trainer._last_fetched = None
        hippo.load_state_dict({
            "memory_state": [_numpy(memory[name])
                             for name in MemoryState._fields],
            "cognitive_map": [_numpy(payload["cognitive_map"][name])
                              for name in CognitiveMapParams._fields],
            "slot_ids": meta["slot_ids"],
            "current_location": np.asarray(meta["current_location"],
                                           np.float32),
            "writes_since_rebuild": meta["writes_since_rebuild"],
        })
        for module, sd in ((trainer.amygdala, payload["amygdala"]),
                           (trainer.thalamus, payload["thalamus"])):
            if module is not None:
                module.load_state_dict(sd)
        return int(payload["step"])
