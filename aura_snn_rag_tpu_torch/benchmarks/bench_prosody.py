"""The prosody bridge's throughput and its cache's speedup (counterpart of
`benchmarks/bench_prosody.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_prosody
        [--device cuda]

`CachedProsodyBridge(ANALYTICAL_BALANCED)` over the JAX script's 16
seeded [8, 256] id batches (`RandomState(0)`, vocab 32,000), held as ids
on the device as a model's ids arrive: two calls to warm up, then the 16
batches (cold: all but the two warm ones miss), then the 16 again (warm:
every call hits). Each call's gains are read back to the host, as the
script's `np.asarray` reads them. Prints one line with the script's
keys: uncached tokens/s, the cache's speedup in percent, its hit rate.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.bench import _sync
from aura_snn_rag_tpu_torch.models.prosody import (
    ANALYTICAL_BALANCED, CachedProsodyBridge)

N_BATCHES, BATCH, SEQ, VOCAB = 16, 8, 256, 32000


def batches() -> List[np.ndarray]:
    """The script's 16 seeded id batches."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, VOCAB, (BATCH, SEQ)) for _ in range(N_BATCHES)]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_prosody",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap


class ProsodyResult(NamedTuple):
    line: dict                    # the JSON line
    batches: List[np.ndarray]     # the id batches
    gains: List[torch.Tensor]     # the cold pass's gains, on the host
    bridge: CachedProsodyBridge
    calls: int                    # bridge calls made
    cold_s: float
    warm_s: float


def run(argv: Optional[Sequence[str]] = None) -> ProsodyResult:
    """The benchmark at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    ids = batches()
    on_dev = [torch.from_numpy(b).to(dev) for b in ids]
    bridge = CachedProsodyBridge(ANALYTICAL_BALANCED, device=dev)
    bridge(on_dev[0])                                   # warm
    bridge(on_dev[1])
    _sync(dev)
    t0 = time.perf_counter()
    gains = [bridge(b).cpu() for b in on_dev]
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in on_dev:                                    # all cached now
        bridge(b).cpu()
    warm = time.perf_counter() - t0
    tokens = sum(b.size for b in ids)
    line = {"tokens_per_s_uncached": round(tokens / cold, 1),
            "cache_speedup_pct": round(100 * (1 - warm / cold), 1),
            "hit_rate": round(bridge.stats["hit_rate"], 3)}
    return ProsodyResult(line, ids, gains, bridge, 2 + 2 * len(ids), cold,
                         warm)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
