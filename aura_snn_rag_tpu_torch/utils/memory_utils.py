"""Host and device memory utilities (counterpart of
`aura_snn_rag_tpu/utils/memory_utils.py`):

- `ArrayPool`: a thread-safe pool of reusable host staging arrays;
- `get_memory_stats`: the card's memory telemetry, from PyTorch's
  caching allocator (`torch.cuda.memory_stats`) and the card's free and
  total memory (`torch.cuda.mem_get_info`), under the JAX package's keys;
- `maybe_defragment`: `torch.cuda.empty_cache` when the card's free
  share falls below a threshold (the reference's memory manager).
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple, Union

import numpy as np
import torch


class ArrayPool:
    """Thread-safe pool of reusable numpy arrays keyed by (shape, dtype)."""

    def __init__(self, max_per_key: int = 8):
        self._pool: Dict[Tuple, list] = {}
        self._lock = threading.Lock()
        self.max_per_key = max_per_key
        self.hits = 0
        self.misses = 0

    def get(self, shape, dtype=np.float32) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            bucket = self._pool.get(key)
            if bucket:
                self.hits += 1
                return bucket.pop()
        self.misses += 1
        return np.zeros(shape, dtype)

    def put(self, arr: np.ndarray) -> None:
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            bucket = self._pool.setdefault(key, [])
            if len(bucket) < self.max_per_key:
                bucket.append(arr)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            pooled = sum(len(v) for v in self._pool.values())
        return {"hits": self.hits, "misses": self.misses, "pooled": pooled}


def get_memory_stats(device: Union[str, torch.device, None] = None
                     ) -> Dict[str, float]:
    """Device memory telemetry in bytes, under the JAX package's keys:
    - `bytes_in_use`: tensors allocated by PyTorch on the card
      (`torch.cuda.memory_allocated`);
    - `peak_bytes_in_use`: their peak since the last
      `reset_peak_memory_stats`;
    - `bytes_limit`: the card's total memory;
    - `free_ratio`: the share of the card's memory that no allocator holds
      (`mem_get_info`: blocks PyTorch caches count as used).
    A CPU device, or no card, gives zeros and a free ratio of 1."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {"bytes_in_use": 0.0, "bytes_limit": 0.0,
                "peak_bytes_in_use": 0.0, "free_ratio": 1.0}
    stats = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "bytes_limit": float(total),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "free_ratio": free / total if total else 1.0,
    }


def maybe_defragment(threshold: float = 0.12,
                     device: Union[str, torch.device, None] = None) -> bool:
    """When the card's free ratio is below `threshold`, release PyTorch's
    cached blocks (`torch.cuda.empty_cache`); returns whether it did."""
    if get_memory_stats(device)["free_ratio"] < threshold:
        torch.cuda.empty_cache()
        return True
    return False
