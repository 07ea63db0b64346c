"""Pipeline-parallel dry run at the xl preset's scale (counterpart of
`examples/dryrun_pp_xl.py`).

    python -m aura_snn_rag_tpu_torch.examples.dryrun_pp_xl [--device cuda]

The xl preset's 16 transformer layers (1024 wide, 16 heads, FFN 4096,
dropout 0; plain FFNs, as the script builds them) as 4 GPipe stages of 4
layers on a ('stage', 'data') = (4, 2) mesh of 8 ranks, one process
each: 4 microbatches of a [8, 128, 1024] batch (`RandomState(0)` normal
x 0.02), the loss mean(out^2), forward and backward twice. Each rank
builds and holds only its stage's layers (layer i's weights from a
generator seeded i, so a layer is the same on any mesh); the 'data'
ranks of a stage run the same pipeline on the same microbatches, as the
script's replicated microbatches do. Rank 0 writes the record to
`runs/pp_xl_dryrun.json` and it is printed with the script's keys:
`compile_s` is the first step's seconds (eager PyTorch compiles
nothing), `grad_sharding_spec` the ranks that hold each stage's
gradients (a torch rank holds no global array, so there is no
PartitionSpec to print).

`--device cuda` (the default) runs one NCCL rank per card and needs 8
cards; `--device cpu` runs 8 gloo ranks on the CPU, as the script runs
on 8 virtual CPU devices. `rank_work(mesh_shape)` is one rank's work on
any ('stage', 'data') mesh of the default process group, (1, 1)
included.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import ModelConfig, get_xl_config
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.models.layers import TransformerLayer, initialize
from aura_snn_rag_tpu_torch.parallel import distributed
from aura_snn_rag_tpu_torch.parallel.mesh import (
    axis_index, axis_size, mesh_device)
from aura_snn_rag_tpu_torch.parallel.pipeline import (
    pipeline_apply, split_microbatches, stack_stage_params)

STAGES = 4
DATA = 2
MICRO = 4
B, L = 8, 128          # small batch/seq: this validates the stages and
                       # their gradients, not throughput
AXES = ("stage", "data")
RECORD = os.path.join("runs", "pp_xl_dryrun.json")
GROUP_TIMEOUT = 600    # seconds: the rendezvous and each collective


def model_config() -> ModelConfig:
    """The xl preset's model at dropout 0."""
    return dataclasses.replace(get_xl_config().model, dropout=0.0)


def make_stage(cfg: ModelConfig, stage: int, n_stages: int,
               device) -> List[TransformerLayer]:
    """Stage `stage`'s layers: layers [s k, (s + 1) k) of the config's
    `num_layers` (k = num_layers / n_stages), layer i drawn from a
    generator seeded i on `device`."""
    k = cfg.num_layers // n_stages
    layers = []
    for i in range(stage * k, (stage + 1) * k):
        layer = TransformerLayer(cfg, device=device)
        initialize(layer, torch.Generator(device=device).manual_seed(i))
        layers.append(layer)
    return layers


def block_fn(layers, x):
    for layer in layers:
        x, _ = layer(x)
    return x


def make_batch(cfg: ModelConfig, device) -> torch.Tensor:
    """[B, L, D] f32: `RandomState(0)` normal x 0.02."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randn(B, L, cfg.embedding_dim)
                            .astype(np.float32)).to(device) * 0.02


class StageRun(NamedTuple):
    record: Dict                  # the script's keys
    layers: List[TransformerLayer]  # this rank's stage, gradients in .grad
    batch: torch.Tensor


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_work(mesh_shape=(STAGES, DATA),
              layers: Optional[List[TransformerLayer]] = None,
              cfg: Optional[ModelConfig] = None) -> StageRun:
    """One rank's dry run on a ('stage', 'data') mesh of `mesh_shape`
    over the default process group's ranks: this rank's stage of the
    config's layers (`layers`, or drawn by `make_stage`), two forward and
    backward passes of the pipeline, and the record (the loss of each,
    the gradient norm over every stage, the trunk's parameters)."""
    cfg = model_config() if cfg is None else cfg
    mesh = distributed.mesh_from_ranks(
        np.arange(math.prod(mesh_shape)).reshape(mesh_shape), AXES)
    S, sid = axis_size(mesh, "stage"), axis_index(mesh, "stage")
    dev = mesh_device(mesh)
    stage_group = mesh.get_group("stage")

    t0 = time.time()
    if layers is None:
        layers = make_stage(cfg, sid, S, dev)
    stage = stack_stage_params(
        [layers if s == sid else None for s in range(S)], mesh)
    params = [p for layer in stage for p in layer.parameters()]
    init_s = time.time() - t0

    batch = make_batch(cfg, dev)
    mbs = split_microbatches(batch, MICRO)

    def step():
        for p in params:
            p.grad = None
        out = pipeline_apply(block_fn, stage, mbs, mesh)
        loss = out.float().pow(2).mean()
        loss.backward()
        _sync(dev)
        return loss.item()

    t0 = time.time()
    loss = step()
    compile_s = time.time() - t0
    t0 = time.time()
    loss2 = step()
    step_s = time.time() - t0

    # the parameters the forward uses: without prosody the attention's
    # prosody gate takes no part (flax does not even create it)
    used = [p for p in params if p.grad is not None]
    n_params = torch.tensor(float(sum(p.numel() for p in used)),
                            dtype=torch.float64, device=dev)
    dist.all_reduce(n_params, group=stage_group)
    grads = [p.grad for p in used]
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise RuntimeError("non-finite grads")
    sq = torch.stack([g.float().pow(2).sum() for g in grads]).sum()
    dist.all_reduce(sq, group=stage_group)
    gnorm = math.sqrt(sq.item())
    if not gnorm > 0:
        raise RuntimeError("zero gradient through the pipeline")
    # each stage's gradients live with its parameters: on the ranks of
    # its 'stage' coordinate, replicated over 'data'
    ranks = mesh.mesh.reshape(S, -1).tolist()
    spec = ("Shard('stage'), Replicate('data'): stage -> ranks "
            + str({s: ranks[s] for s in range(S)}))
    record = {
        "preset": "xl", "d_model": cfg.embedding_dim,
        "layers": cfg.num_layers, "stages": S,
        "microbatches": MICRO,
        "mesh": {a: axis_size(mesh, a) for a in AXES},
        "trunk_params": int(n_params.item()), "loss": loss,
        "loss_repeat": loss2, "grad_norm": gnorm,
        "grad_sharding_spec": spec,
        "init_s": round(init_s, 1), "compile_s": round(compile_s, 1),
        "step_s": round(step_s, 2),
        "bubble_fraction": (S - 1) / (MICRO + S - 1),
    }
    return StageRun(record, stage, batch)


def _rank(rank: int, world: int, device: str, out_dir: str,
          cfg: Dict) -> None:
    """A spawned rank: join the group, run `rank_work`, and on rank 0
    write the record to `out_dir`/record.json."""
    try:
        if device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        distributed.initialize(f"file://{out_dir}/rendezvous", world, rank,
                               device=device, timeout=GROUP_TIMEOUT)
        res = rank_work((STAGES, DATA), cfg=ModelConfig(**cfg))
        if rank == 0:
            with open(os.path.join(out_dir, "record.json"), "w") as f:
                json.dump(res.record, f)
    except BaseException:
        distributed.record_failure(out_dir, rank)
        raise SystemExit(1)
    finally:
        distributed.shutdown()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.examples.dryrun_pp_xl",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: one NCCL rank per card (8 cards); cpu: 8 "
                         "gloo ranks")
    return ap


class DryrunResult(NamedTuple):
    lines: List[str]
    record: Dict


def run(argv: Optional[Sequence[str]] = None) -> DryrunResult:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    world = STAGES * DATA
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"dryrun_pp_xl runs one rank per card on a ('stage', 'data') = "
            f"({STAGES}, {DATA}) mesh and needs {world} CUDA cards; this "
            f"machine has {torch.cuda.device_count()}. Pass --device cpu "
            f"for {world} gloo ranks on the CPU")
    cfg = dataclasses.asdict(model_config())
    with tempfile.TemporaryDirectory(prefix="pp_xl_") as tmp:
        distributed.spawn_ranks(_rank, world, tmp, (world, dev.type, tmp,
                                                    cfg),
                                timeout=3 * GROUP_TIMEOUT,
                                name="dryrun_pp_xl")
        with open(os.path.join(tmp, "record.json")) as f:
            record = json.load(f)
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=1)
    out = Lines()
    out(json.dumps(record))
    out("PP xl dryrun OK")
    return DryrunResult(out, record)


def main(argv: Optional[Sequence[str]] = None) -> DryrunResult:
    """Spawn the 8 ranks and print the record."""
    return run(argv)


if __name__ == "__main__":
    main()
