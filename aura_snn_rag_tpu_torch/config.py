"""Configuration of the episodic-memory engine.

A copy of `MemoryConfig` from `aura_snn_rag_tpu/config.py` with the same
field names and defaults, so one configuration drives either package.
The port keeps its own copy because importing the JAX package pulls in JAX.

What the fields mean in the port:

- `use_pallas_ivf` selects the hand-written IVF kernel path (kernels B, C,
  D and E in `ops/cuda/ivf_scan.py`); False takes the plain gather path.
- `ivf_kernel`: "v3r" (kernel B), "v3" (kernel D) or "v2" (kernel E), with
  the JAX package's fallbacks: v3r drops to v2 when probe*capacity < 128,
  max_memories % 8 != 0 or k > 128, and v3 drops to v2 when
  probe*capacity < 128. With query locations every setting takes v1
  (kernel C).
- `flat_strategy`: "scan" ([B, M] coarse scores + exact top-k funnel) or
  "blockmax" (kernel A, no [B, M]).
- `flat_rescue_queries`, `flat_wide_funnel` and `flat_exact_funnel` are not
  ported yet and raise NotImplementedError when enabled.
- `ivf_funnel_recall` and `flat_funnel_recall` are kept for parity and
  unused: the port's funnels are exact top-k.
- `flat_tile_m`, `spill_funnel_rows` and `spill_query_chunk` belong to the
  TPU kernel's tiling and the host-spilled tier, which is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MemoryConfig:
    """Episodic memory engine (hippocampal formation) configuration."""

    max_memories: int = 100_000
    feature_dim: int = 768
    spatial_dims: int = 2
    k_centroids: int = 256
    rebuild_interval: int = 512          # rebuild centroids every N inserts
    probe_centroids: int = 8             # nearest centroids scanned per query
    retrieve_k: int = 5
    # coarse -> rerank funnel width (candidates per query that get the exact
    # f32 rerank)
    rerank_candidates: int = 128
    ivf_funnel_recall: float = 0.99
    # per-centroid bucket capacity = overprovision * max_memories / K
    bucket_overprovision: float = 2.0
    # scoring weights: (cosine, spatial, temporal)
    w_cosine: float = 0.5
    w_spatial: float = 0.3
    w_temporal: float = 0.2
    temporal_tau: float = 3600.0         # exp(-age / tau)
    seconds_per_step: float = 1.0        # logical clock -> seconds
    # cognitive map (place / grid / time cells)
    n_place_cells: int = 2000
    n_grid_cells: int = 200
    n_time_cells: int = 100
    place_max_rate: float = 20.0
    grid_max_rate: float = 25.0
    # Lloyd iterations in a full rebuild
    rebuild_lloyd_iters: int = 1
    # capacity-overflow spill rounds: rows overflowing a full bucket move to
    # their next-nearest centroid, round after round
    spill_rounds: int = 8
    # reserved overflow annex: the last min(overflow_buckets, K // 4)
    # clusters hold rows that still overflow after every spill round
    overflow_buckets: int = 16
    use_pallas_ivf: bool = True
    ivf_kernel: str = "v3r"
    # flat-path bank copy: "bf16" or "int8" (per-row max-abs 127 scale)
    coarse_dtype: str = "bf16"
    # dtype of the flat scan's [B, M] score chain: "f32" or "bf16"
    flat_score_dtype: str = "f32"
    flat_funnel_recall: float = 0.95
    flat_strategy: str = "scan"
    # 8-row blocks whose members get the exact rerank (blockmax strategy)
    flat_block_funnel: int = 64
    flat_tile_m: int = 1024
    flat_rescue_queries: int = 0
    flat_rescue_width: int = 1024
    flat_exact_funnel: bool = False
    flat_wide_funnel: int = 0
    spill_funnel_rows: int = 96
    spill_query_chunk: int = 256

    @property
    def bucket_capacity(self) -> int:
        cap = int(self.bucket_overprovision * self.max_memories
                  / self.k_centroids)
        return max(8, ((cap + 127) // 128) * 128)
