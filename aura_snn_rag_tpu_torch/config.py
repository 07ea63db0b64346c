"""Configuration of the episodic-memory engine and of the LM.

Copies of `MemoryConfig`, `ModelConfig`, `TrainingConfig`, `MeshConfig`
and `ParallelConfig` from `aura_snn_rag_tpu/config.py` with the same field
names and defaults, so one configuration drives either package, and the
same presets (`get_debug_config` ... `get_xl_config`). The port keeps its
own copy because importing the JAX package pulls in JAX.

What the `MemoryConfig` fields mean in the port:

- `use_pallas_ivf` selects the hand-written IVF kernel path (kernels B, C,
  D and E in `ops/cuda/ivf_scan.py`); False takes the plain gather path.
- `ivf_kernel`: "v3r" (kernel B), "v3" (kernel D) or "v2" (kernel E), with
  the JAX package's fallbacks: v3r drops to v2 when probe*capacity < 128,
  max_memories % 8 != 0 or k > 128, and v3 drops to v2 when
  probe*capacity < 128. With query locations every setting takes v1
  (kernel C).
- `flat_strategy`: "scan" ([B, M] coarse scores + exact top-k funnel) or
  "blockmax" (kernel A, no [B, M]).
- `flat_exact_funnel` and `flat_wide_funnel` are accepted and ignored:
  the scan's funnel already is the exact top-k that both compute, so the
  port runs the default scan for them. `flat_rescue_queries` and
  `flat_rescue_width` re-funnel the riskiest queries of a scan wider.
- `spill_funnel_rows` and `spill_query_chunk` shape the host-spilled
  bank's device funnel (`memory/host_spill.py`): its second-stage row
  funnel, and the query slices kernel A scans the bank for.
- `ivf_funnel_recall` and `flat_funnel_recall` are kept for parity and
  unused: the port's funnels are exact top-k.
- `flat_tile_m` belongs to the TPU kernel's tiling and is unused.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


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


@dataclass(frozen=True)
class ModelConfig:
    """Hippocampal transformer model configuration.

    What the fields mean in the port: `dropout` applies only in a
    forward that is given a `dropout_seed` in training mode (the
    trainer's); without one the modules run as the JAX package's do with
    `deterministic=True`. `use_gradient_checkpointing` recomputes each
    layer in the backward (`torch.utils.checkpoint`), under
    `gradient_checkpoint_policy` "full" (the whole layer) or "dots"
    (selective: matmul and attention outputs are saved). `dtype` is the
    compute dtype: parameters stay f32 and are cast at every use, as flax
    does.
    """

    vocab_size: int = 32_000
    embedding_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 512
    dropout: float = 0.1

    # Place-cell encoder
    n_place_cells: int = 2000
    place_cell_sparsity: float = 0.03
    place_residual_scale: float = 0.1

    # Theta-gamma positional encoding
    theta_freq: float = 8.0
    gamma_freq: float = 40.0

    # Memory-augmented (RAG) layers
    use_rag: bool = False
    memory_injection: str = "gate"       # "gate" | "cross_attention" | "concat"
    num_retrieved: int = 5

    # Spiking FFN. `snn_layers` lists layer indices using a HybridFFN;
    # empty tuple = standard GELU MLP everywhere.
    snn_layers: Tuple[int, ...] = ()
    snn_timesteps: int = 4
    snn_levels: int = 8                  # multi-bit spike levels L
    snn_ratio: float = 0.5

    use_gradient_checkpointing: bool = False
    gradient_checkpoint_policy: str = "full"
    tie_word_embeddings: bool = True
    dtype: str = "bfloat16"              # computation dtype

    @property
    def head_dim(self) -> int:
        return self.embedding_dim // self.num_heads

    @property
    def place_k(self) -> int:
        return max(1, int(self.n_place_cells * self.place_cell_sparsity))


@dataclass(frozen=True)
class TrainingConfig:
    """Training hyperparameters, as the JAX package's `TrainingConfig`.

    In the port: `optimizer_mu_dtype` "bfloat16" keeps AdamW's first
    moment in bf16; `metrics_fetch_interval` is how often `train_step`
    reads a step's metrics back from the device (one step late);
    `save_steps` is how often the CLI's `train` saves a checkpoint
    (`training/checkpoint.py`).
    """

    batch_size: int = 32
    gradient_accumulation_steps: int = 1
    max_steps: int = 100_000

    lr: float = 1e-4
    warmup_steps: int = 2000
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.01
    gradient_clip: float = 1.0
    optimizer_mu_dtype: str = "float32"

    label_smoothing: float = 0.1
    entropy_lambda: float = 0.05
    sparsity_lambda: float = 0.02
    target_sparsity: float = 0.03

    # Memory system
    memory_warmup_steps: int = 5000
    memory_store_interval: int = 10      # store memories every N steps
    memory_decay_rate: float = 0.001
    replay_buffer_size: int = 50_000
    ewc_lambda: float = 0.4

    # Sleep-wake cycle
    sleep_interval: int = 1000
    sleep_replay_batches: int = 4

    save_steps: int = 1000
    eval_steps: int = 500
    logging_steps: int = 100
    metrics_fetch_interval: int = 1

    # Modulators
    enable_amygdala: bool = True
    enable_endocrine: bool = True
    enable_thalamus: bool = True
    # Let the endocrine memory gate (x[0.8, 1.2]) veto episodic memory
    # when it drops the use_memory product below 0.9; False keeps the
    # hormone-driven LR scaling but not the veto.
    endocrine_memory_gating: bool = True

    seed: int = 42


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh: 'data' (batch and memory-bank rows) and 'model' axes.
    In the port a mesh is a `torch.distributed` DeviceMesh over one
    process per device (`parallel/`)."""

    data_axis: int = -1                  # -1 = all remaining devices
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class ParallelConfig:
    """The strategies that change the program: sequence sharding (ring
    attention over a 'seq' axis, seq_shards > 1) and pipeline stages
    (GPipe over a 'stage' axis, pp_stages > 1). The port's
    `Trainer.shard_to_mesh` runs data parallelism over the batch axes,
    tensor parallelism over 'model', ring attention over the axis named
    `seq_axis_name`, and treats the axis named `stage_axis_name` as
    replicated, as the JAX trainer does; the pipeline runs through
    `models.pipelined` with `pp_microbatches` microbatches."""

    seq_shards: int = 1
    seq_axis_name: str = "seq"
    pp_stages: int = 1
    pp_microbatches: int = 4
    stage_axis_name: str = "stage"


@dataclass(frozen=True)
class AuraConfig:
    """The JAX package's `AuraConfig`: model, memory, training, mesh and
    parallel parts."""

    model: ModelConfig = field(default_factory=ModelConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "AuraConfig":
        return dataclasses.replace(self, **kw)


def _cfg(model_kw, memory_kw, training_kw) -> AuraConfig:
    return AuraConfig(model=ModelConfig(**model_kw),
                      memory=MemoryConfig(**memory_kw),
                      training=TrainingConfig(**training_kw))


def get_test_config() -> AuraConfig:
    """Small config for fast runs (512D/6L/8H, seq 256)."""
    return _cfg(
        dict(vocab_size=32_000, embedding_dim=512, num_layers=6, num_heads=8,
             intermediate_size=2048, max_seq_len=256, n_place_cells=1000),
        dict(max_memories=10_000, feature_dim=512, k_centroids=64,
             rebuild_interval=128, n_place_cells=1000),
        dict(batch_size=16, max_steps=5000, warmup_steps=200,
             memory_warmup_steps=500, sleep_interval=500),
    )


def get_debug_config() -> AuraConfig:
    """Tiny config for unit tests."""
    return _cfg(
        dict(vocab_size=512, embedding_dim=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_seq_len=32, n_place_cells=128),
        dict(max_memories=256, feature_dim=64, k_centroids=8,
             rebuild_interval=32, n_place_cells=64, n_grid_cells=16,
             n_time_cells=8),
        dict(batch_size=4, max_steps=100, warmup_steps=10,
             memory_warmup_steps=10, sleep_interval=50),
    )


def get_small_config() -> AuraConfig:
    return _cfg(
        dict(embedding_dim=512, num_layers=6, num_heads=8,
             intermediate_size=2048, n_place_cells=1000),
        dict(feature_dim=512),
        dict(batch_size=16),
    )


def get_medium_config() -> AuraConfig:
    """12L/768D, the reference's 'medium' preset."""
    return _cfg(dict(), dict(), dict(batch_size=32, max_steps=20_000))


def get_full_config() -> AuraConfig:
    """Flagship preset: 768D/12L/12H/3072, seq 512, SNN FFN on even
    layers, RAG on, 100k memories."""
    return _cfg(
        dict(embedding_dim=768, num_layers=12, num_heads=12,
             intermediate_size=3072, max_seq_len=512, n_place_cells=2000,
             use_rag=True, snn_layers=(0, 2, 4, 6, 8, 10)),
        dict(max_memories=100_000, feature_dim=768),
        # batch 16, not the reference's 32. At this batch `retrieve_auto`
        # takes the flat scan (16 x probe 8 x capacity 896 >= 100k rows);
        # gradient_accumulation_steps = 2 gives micro-batches of 8, which
        # retrieve through IVF v3r (kernel B).
        dict(batch_size=16, max_steps=50_000, warmup_steps=2000,
             memory_warmup_steps=5000),
    )


def get_xl_config() -> AuraConfig:
    """Beyond-reference scale (1024D/16L)."""
    return _cfg(
        dict(embedding_dim=1024, num_layers=16, num_heads=16,
             intermediate_size=4096, n_place_cells=2000, use_rag=True,
             snn_layers=(2, 6, 10, 14)),
        dict(feature_dim=1024),
        dict(batch_size=64, max_steps=50_000),
    )
