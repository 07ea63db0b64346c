"""The flat funnel's variants at the serving batch: recall@10 and QPS of
each (counterpart of `benchmarks/bench_rescue_ab.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_rescue_ab
        [--small] [--wide-only] [--device cuda]

The JAX script's configuration and data: 1,000,000 x 768 clustered rows
of `RandomState(0)` (`--small`: 100,000), queries near random rows from
`RandomState(1)`, int8 coarse rows with bf16 flat scores, K = 64, probe
8, k = 10; 16 batches of 1024 queries (`--small`: 8 of 32); ground
truth, the exact cosine top-10 of the first 256 queries, computed once
on the host. The bank is loaded once; each of the eleven variants
(`--wide-only`: the last four) overrides the base `MemoryConfig`, makes
one call to warm up, then runs the batches back to back, timed to the
card's finish, and prints one line with the script's keys.

The port's scan funnel is an exact `topk` of the coarse scores, so
`flat_funnel_recall`, `flat_exact_funnel` and `flat_wide_funnel` leave
it as it is (`memory/engine.py`, `_retrieve_flat_scan`): every variant
gives, bit for bit, the indices of the default funnel at its
`rerank_candidates` (the approx-95 rows at 128 and 192). Their rows are
printed all the same, as the script prints them.
"""

from __future__ import annotations

import argparse
import dataclasses
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

D = 768
TOPK = 10
N_EVAL = 256            # recall resolution: 2560 scored items
# (name, config overrides)
VARIANTS = (
    ("approx95_kk128", {}),
    ("approx97_kk128", {"flat_funnel_recall": 0.97}),
    ("approx98_kk128", {"flat_funnel_recall": 0.98}),
    ("exact_kk128", {"flat_exact_funnel": True}),
    ("exact_kk192", {"flat_exact_funnel": True, "rerank_candidates": 192}),
    ("exact_kk256", {"flat_exact_funnel": True, "rerank_candidates": 256}),
    ("approx95_kk192", {"rerank_candidates": 192}),
    ("wide1024_kk128", {"flat_wide_funnel": 1024}),
    ("wide2048_kk160", {"flat_wide_funnel": 2048, "rerank_candidates": 160}),
    ("wide2048_kk192", {"flat_wide_funnel": 2048, "rerank_candidates": 192}),
    ("wide4096_kk192", {"flat_wide_funnel": 4096, "rerank_candidates": 192}),
)
WIDE_ONLY = 7           # --wide-only skips the first seven


def sizes(small: bool) -> Tuple[int, int, int]:
    """(rows, query batch, batches)."""
    return (100_000, 32, 8) if small else (1_000_000, 1024, 16)


def base_config(n: int) -> MemoryConfig:
    """The script's base configuration."""
    return MemoryConfig(
        max_memories=n, feature_dim=D, k_centroids=64, probe_centroids=8,
        retrieve_k=TOPK, coarse_dtype="int8", flat_score_dtype="bf16",
        n_place_cells=16, n_grid_cells=8, n_time_cells=4)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_rescue_ab",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--wide-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


class RescueResult(NamedTuple):
    lines: List[dict]                    # the JSON lines
    indices: Dict[str, np.ndarray]       # variant -> every timed query's
    configs: Dict[str, MemoryConfig]     # variant -> its configuration
    state: object                        # the bank
    batches: List[torch.Tensor]          # the query batches
    exact: np.ndarray                    # [n_eval, k] exact top-k


def run(argv: Optional[Sequence[str]] = None) -> RescueResult:
    """The benchmark at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    n, batch, n_batches = sizes(args.small)
    variants = VARIANTS[WIDE_ONLY:] if args.wide_only else VARIANTS
    feats, _ = make_data(n, D)
    queries = make_queries(feats, batch * n_batches)

    base = base_config(n)
    state = bulk_load(base, init_memory_state(base, dev),
                      torch.from_numpy(feats).to(dev),
                      torch.zeros((n, 2), device=dev))
    # exact ground truth once, on the host
    exact = exact_topk_numpy(feats, queries[:N_EVAL], TOPK)
    del feats
    q = torch.from_numpy(queries).to(dev)
    batches = [q[i * batch:(i + 1) * batch] for i in range(n_batches)]
    _sync(dev)

    lines, indices, configs = [], {}, {}
    for name, kw in variants:
        cfg = dataclasses.replace(base, **kw)
        retrieve_flat(cfg, state, batches[0], None, TOPK)      # warm
        _sync(dev)
        t0 = time.perf_counter()
        results = [retrieve_flat(cfg, state, b, None, TOPK) for b in batches]
        _sync(dev)
        qps = n_batches * batch / (time.perf_counter() - t0)
        got = torch.cat([r.indices for r in results]).cpu().numpy()
        line = {"variant": name, "qps": round(qps, 1),
                "recall_at_10": round(recall_at_k(got[:N_EVAL], exact), 5),
                "n_vectors": n, "batch": batch}
        print(json.dumps(line), flush=True)
        lines.append(line)
        indices[name], configs[name] = got, cfg
    return RescueResult(lines, indices, configs, state, batches, exact)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the benchmark (it prints its lines); returns them."""
    return run(argv).lines


if __name__ == "__main__":
    main()
