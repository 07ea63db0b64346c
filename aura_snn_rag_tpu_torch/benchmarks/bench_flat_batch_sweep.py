"""The flat retrieval path over query batches and strategies, for the
serving batch of the best throughput (counterpart of
`benchmarks/bench_flat_batch_sweep.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_flat_batch_sweep
        [--small] [--out PATH] [--device cuda]

The JAX script's configuration and data: 1,000,000 x 768 clustered rows
of `RandomState(0)` (`--small`: 100,000), int8 coarse rows, k = 10;
queries near random rows from `RandomState(1)`; batches of 128, 256, 512
and 1024 (`--small`: 64 and 128), 16 of each (`--small`: 4), recall@10
of the warm call's first 64 queries (`--small`: 32) against exact numpy
search. For each batch, `retrieve_flat` through four variants:

- `scan/f32`, `scan/bf16`: the [B, M] coarse scores in f32 or bf16, the
  exact top-kk funnel, the exact f32 rerank;
- `blockmax`: kernel A's block-max surface, then the top blocks' rows;
- `blockmax-plain` (the script's `blockmax-xla`): the same funnel
  without kernel A, `memory.engine._flat_kernel_ok` patched to refuse
  for this variant only, as the script patches its own.

One call to warm up, then the batches back to back, timed to the card's
finish. A row per variant and batch, with the script's keys; then the
winner, the fastest row at recall@10 >= 0.999 (of all rows when none
reaches it). Only an out-of-memory error becomes an error row, as a data
point; any other failure, a kernel's among them, ends the run. The
summary ({winner, rows, n_vectors}) is written to `--out` when it is
given: the JAX script's `runs/flat_batch_sweep_r3.json` is a TPU record
and is never written here.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.bench import (
    _sync, exact_topk_numpy, make_data, make_queries, recall_at_k)
from aura_snn_rag_tpu_torch.config import MemoryConfig
from aura_snn_rag_tpu_torch.memory import (
    bulk_load, init_memory_state, retrieve_flat)
from aura_snn_rag_tpu_torch.memory import engine as engine_mod

D = 768
TOPK = 10
RECALL_BAR = 0.999            # the winner rule's
VARIANTS = (
    ("scan/f32", dict(flat_strategy="scan", flat_score_dtype="f32"), True),
    ("scan/bf16", dict(flat_strategy="scan", flat_score_dtype="bf16"), True),
    ("blockmax", dict(flat_strategy="blockmax"), True),
    ("blockmax-plain", dict(flat_strategy="blockmax", flat_tile_m=2048),
     False),
)


def sizes(small: bool) -> Tuple[int, int, int, Tuple[int, ...]]:
    """(rows, batches per size, recall queries, batch sizes)."""
    return ((100_000, 4, 32, (64, 128)) if small
            else (1_000_000, 16, 64, (128, 256, 512, 1024)))


@contextlib.contextmanager
def kernel_allowed(allowed: bool):
    """The engine's kernel-A gate for one variant: refused when not
    allowed, restored after."""
    real = engine_mod._flat_kernel_ok
    if not allowed:
        engine_mod._flat_kernel_ok = lambda *a, **k: False
    try:
        yield
    finally:
        engine_mod._flat_kernel_ok = real


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "bench_flat_batch_sweep",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write the summary JSON here (default: nowhere)")
    ap.add_argument("--device", default="cuda")
    return ap


class SweepResult(NamedTuple):
    rows: List[dict]              # the JSON rows, error rows aside
    summary: dict                 # {winner, rows, n_vectors}
    calls: Dict[Tuple[str, int], int]          # (variant, B) -> calls
    indices: Dict[Tuple[str, int], np.ndarray]  # the warm call's [B, k]
    exact: np.ndarray             # [n_eval, k] exact top-k, ordered


def run(argv: Optional[Sequence[str]] = None) -> SweepResult:
    """The sweep at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    n, n_batches, n_eval, batch_sizes = sizes(args.small)
    if dev.type == "cuda":
        # nvcc before any timer
        from aura_snn_rag_tpu_torch.ops.cuda import _build
        _build.build_all()
        _build.load("flat_scan")
    feats, _ = make_data(n, D)
    queries = make_queries(feats, max(batch_sizes) * n_batches)
    exact = exact_topk_numpy(feats, queries[:n_eval], TOPK)

    base_kw = dict(max_memories=n, feature_dim=D, retrieve_k=TOPK,
                   coarse_dtype="int8", n_place_cells=16, n_grid_cells=8,
                   n_time_cells=4)
    # one bank for every variant: the swept knobs do not touch the state
    cfg0 = MemoryConfig(**base_kw)
    state = bulk_load(cfg0, init_memory_state(cfg0, dev),
                      torch.from_numpy(feats).to(dev),
                      torch.zeros((n, 2), device=dev))
    del feats
    q_dev = torch.from_numpy(queries).to(dev)
    _sync(dev)

    rows, calls, indices = [], {}, {}
    for B in batch_sizes:
        batches = [q_dev[i * B:(i + 1) * B] for i in range(n_batches)]
        for name, kw, allowed in VARIANTS:
            cfg = MemoryConfig(**base_kw, **kw)
            try:
                with kernel_allowed(allowed):
                    idx0 = retrieve_flat(cfg, state, batches[0], None,
                                         TOPK).indices.cpu().numpy()
                    t0 = time.perf_counter()
                    for b in batches:
                        retrieve_flat(cfg, state, b, None, TOPK)
                    _sync(dev)
                    dt = time.perf_counter() - t0
            except torch.OutOfMemoryError as e:    # a data point at large B
                row = {"variant": name, "batch": B,
                       "error": f"{type(e).__name__}: {e}"[:200]}
                print(json.dumps(row), flush=True)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                continue
            calls[(name, B)] = 1 + n_batches
            indices[(name, B)] = idx0
            m = min(n_eval, B)
            row = {"variant": name, "batch": B,
                   "qps": round(n_batches * B / dt, 1),
                   "ms_per_batch": round(dt / n_batches * 1e3, 2),
                   "recall_at_10": round(recall_at_k(idx0[:m], exact[:m]),
                                         4)}
            rows.append(row)
            print(json.dumps(row), flush=True)

    ok = [r for r in rows if r["recall_at_10"] >= RECALL_BAR]
    winner = max(ok or rows, key=lambda r: r["qps"]) if rows else None
    summary = {"winner": winner, "rows": rows, "n_vectors": n}
    print(json.dumps({"winner": winner}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return SweepResult(rows, summary, calls, indices, exact)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the sweep (it prints its rows and winner); returns the
    summary."""
    return run(argv).summary


if __name__ == "__main__":
    main()
