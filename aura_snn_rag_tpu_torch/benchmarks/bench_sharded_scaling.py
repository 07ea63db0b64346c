"""The sharded bank's scaling check on the port (counterpart of
`benchmarks/bench_sharded_scaling.py`): the sharded retrieval on N ranks
against one flat bank, and the bytes its collectives move.

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_sharded_scaling
        [--n=8] [--per-shard=16384] [--device cuda]

`--device cuda` (the default) runs one NCCL rank per card and refuses an
`--n` above the number of cards; `--device cpu` runs `--n` gloo ranks on
the host, the JAX script's virtual CPU mesh. One rank runs in this
process; more are spawned, each joining a group over a localhost TCP
rendezvous. The port's `bench --sharded=N` runs this module on its
`--device`; `bench --sharded=N --device cpu` is the root `bench.py
--sharded=N`, which runs the JAX script on a virtual CPU mesh.

Every rank draws the JAX script's rows (`RandomState(0)`, N x per-shard
rows of 768) and writes them through `write_memories_sharded` in
batches that carry 8192 rows of every shard, so shard s's slot l holds
row s * per-shard + l. 64 queries near random rows then go through
`retrieve_sharded` (each shard's `retrieve_auto` takes the flat scan at
these sizes, then the candidates merge by all-gather), and rank 0 holds
the top-10 to one flat bank's brute force over every row
(`topk_agreement_vs_flat`).

The bytes are counted for the length of the one retrieval
(`counted_all_gathers`): every `torch.distributed.all_gather` the rank
makes adds its output bytes (what XLA's HLO sizes) under HLO's name.
The analytic count is one all-gather of the [S, B, k] scores and int32
slots and the [S, B, k, D] f32 features, B * k * (D + 2) * S * 4 bytes.
The JAX script reads its bytes from the compiled HLO; torch has none.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Dict, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from aura_snn_rag_tpu_torch._device import resolve_device

D = 768
TOPK = 10
B = 64
WRITE_ROWS = 8192           # rows of each shard per write batch
GROUP_TIMEOUT = 120         # seconds: the rendezvous and each collective
JOIN_TIMEOUT = 900          # seconds: the spawned ranks' whole run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "bench_sharded_scaling",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8, help="shards (ranks)")
    ap.add_argument("--per-shard", type=int, default=16_384,
                    help="rows per shard")
    ap.add_argument("--device", default="cuda")
    return ap


class ShardedResult(NamedTuple):
    line: dict                   # the JSON line
    indices: np.ndarray          # [B, k] the sharded result's global slots
    mapped: np.ndarray           # [B, k] those slots as row ids
    reference: np.ndarray        # [B, k] one flat bank's brute force


def make_data(n: int, per_shard: int):
    """(rows [n * per_shard, D], queries [B, D]): the JAX script's draws."""
    rng = np.random.RandomState(0)
    total = n * per_shard
    feats = rng.randn(total, D).astype(np.float32)
    queries = (feats[rng.randint(0, total, B)]
               + 0.3 * rng.randn(B, D).astype(np.float32))
    return feats, queries


@contextlib.contextmanager
def counted_all_gathers() -> Iterator[Dict[str, int]]:
    """{"all-gather": bytes}: the output bytes of every
    `torch.distributed.all_gather` this process makes inside the block."""
    counts: Dict[str, int] = {}
    real = dist.all_gather

    def all_gather(tensor_list, tensor, *args, **kwargs):
        counts["all-gather"] = counts.get("all-gather", 0) + sum(
            t.numel() * t.element_size() for t in tensor_list)
        return real(tensor_list, tensor, *args, **kwargs)

    dist.all_gather = all_gather
    try:
        yield counts
    finally:
        dist.all_gather = real


def shard_run(n: int, per_shard: int, dev: torch.device) -> ShardedResult:
    """This rank's part of the run (every rank of an n-rank group calls
    it); every rank returns the same result."""
    from aura_snn_rag_tpu_torch.config import MemoryConfig
    from aura_snn_rag_tpu_torch.memory import engine
    from aura_snn_rag_tpu_torch.memory.sharded import (
        init_sharded_memory, retrieve_sharded, write_memories_sharded)
    from aura_snn_rag_tpu_torch.memory.state import init_memory_state
    from aura_snn_rag_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(1)
    index = dict(k_centroids=32, retrieve_k=TOPK, use_pallas_ivf=False,
                 n_place_cells=16, n_grid_cells=8, n_time_cells=4)
    cfg = MemoryConfig(max_memories=per_shard, feature_dim=D,
                       probe_centroids=8, **index)
    total = n * per_shard
    feats, queries = make_data(n, per_shard)

    state = init_sharded_memory(cfg, mesh, axis="data")
    blocks = feats.reshape(n, per_shard, D)
    for j in range(0, per_shard, WRITE_ROWS):
        batch = np.concatenate([blocks[s, j:j + WRITE_ROWS]
                                for s in range(n)])
        state = write_memories_sharded(
            cfg, mesh, state, torch.from_numpy(batch).to(dev),
            torch.zeros((batch.shape[0], 2), device=dev), axis=("data",))

    q = torch.from_numpy(queries).to(dev)
    with counted_all_gathers() as coll:
        got = retrieve_sharded(cfg, mesh, state, q, k=TOPK, axis="data")
    g = got.indices.cpu().numpy()
    del state

    # one flat bank of every row; brute force is exact
    ref_cfg = MemoryConfig(max_memories=total, feature_dim=D, **index)
    ref_state = engine.bulk_load(
        ref_cfg, init_memory_state(ref_cfg, dev), torch.from_numpy(feats),
        torch.zeros((total, 2)))
    ref = engine.retrieve_bruteforce(ref_cfg, ref_state, q, None, TOPK)
    ref_idx = ref.indices.cpu().numpy()

    # shard s's slot l holds row s * per_shard + l
    shard, local = g // per_shard, g % per_shard
    mapped = np.where(g >= 0, shard * per_shard + local, -1)
    agree = np.mean([
        len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist())) / TOPK
        for a, b in zip(mapped, ref_idx)])
    coll_total = sum(coll.values())
    predicted = B * TOPK * (D + 2) * n * 4
    line = {
        "metric": f"sharded retrieval correctness+collectives @ {n} shards",
        "n_shards": n, "per_shard_rows": per_shard, "total_rows": total,
        "topk_agreement_vs_flat": round(float(agree), 4),
        "collective_bytes_per_batch": coll,
        "collective_bytes_total": coll_total,
        "analytic_allgather_bytes": predicted,
        "bytes_per_query": round(coll_total / B, 1),
        "batch": B,
    }
    return ShardedResult(line, g, mapped, ref_idx)


def rank_main(rank: int, n: int, per_shard: int, device: str,
              address: str, out_dir: str) -> None:
    """A spawned rank: join the group, run, and (rank 0) write the
    result to `out_dir`; a failure is recorded for `spawn_ranks`."""
    from aura_snn_rag_tpu_torch.parallel import distributed
    try:
        if device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        distributed.initialize(address, n, rank, device=device,
                               timeout=GROUP_TIMEOUT)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device("cpu"))
        res = shard_run(n, per_shard, dev)
        if rank == 0:
            np.savez(os.path.join(out_dir, "result.npz"),
                     indices=res.indices, mapped=res.mapped,
                     reference=res.reference)
            with open(os.path.join(out_dir, "line.json"), "w") as f:
                json.dump(res.line, f)
    except BaseException:
        distributed.record_failure(out_dir, rank)
        raise SystemExit(1)
    finally:
        distributed.shutdown()


def _spawn(n: int, per_shard: int, device: str) -> ShardedResult:
    import tempfile
    # the ranks' target by its module's own name, also when this module
    # runs as __main__
    from aura_snn_rag_tpu_torch.benchmarks import bench_sharded_scaling
    from aura_snn_rag_tpu_torch.parallel import distributed
    address = f"localhost:{distributed.free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        distributed.spawn_ranks(
            bench_sharded_scaling.rank_main, n, out_dir,
            (n, per_shard, device, address, out_dir), JOIN_TIMEOUT,
            "sharded scaling")
        with open(os.path.join(out_dir, "line.json")) as f:
            line = json.load(f)
        arrays = np.load(os.path.join(out_dir, "result.npz"))
        return ShardedResult(line, arrays["indices"], arrays["mapped"],
                             arrays["reference"])


def run(argv: Optional[Sequence[str]] = None) -> ShardedResult:
    """The check at the flags in `argv`: one rank in this process (a
    group is opened for it unless one of one rank exists), more spawned."""
    from aura_snn_rag_tpu_torch.parallel import distributed
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n
    if n < 1:
        raise ValueError(f"--n={n}: need at least one shard")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"--n={n} ranks on {torch.cuda.device_count()} "
                         f"card(s): one NCCL rank per card; pass --device "
                         f"cpu for gloo ranks on the host")
    if n > 1:
        return _spawn(n, args.per_shard, dev.type)
    opened = not dist.is_initialized()
    if opened:
        address = f"localhost:{distributed.free_port()}"
        distributed.initialize(address, 1, 0, device=dev.type,
                               timeout=GROUP_TIMEOUT)
    elif dist.get_world_size() != 1:
        raise RuntimeError("a process group of more than one rank is open; "
                           "--n=1 runs in a group of its own")
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return shard_run(1, args.per_shard, dev)
    finally:
        if opened:
            distributed.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the check and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
