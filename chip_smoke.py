#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from the sources in this checkout, then:

1. kernel phase: kernels A (flat_blockmax), B (ivf_retrieve_fused), C
   (ivf_scan_scores), D (ivf_candidates) and E (ivf_topk_scores) at
   full-width shapes on random inputs, each held against its plain
   PyTorch version on the same inputs and timed with CUDA events beside
   the plain version, a PyTorch library yardstick where one exists, and
   the least time the card could take (`bound_ms`); E is also held bit
   for bit against the per-probe top-k of the coarse scores derived from
   kernel C's cosines on the same inputs; for kernel A also a
   ~2 s sustained run with the SM clock and power draw sampled, and at
   int8 the bare `torch._int_mm` product without its epilogue (context
   for how close A comes to cuBLAS's GEMM, not the yardstick). B-E run
   at B = 1 and 8 (C alone is the coarse pass that B and D run before
   their select pass, so B - C and D - C are the select passes' time; E
   scores and selects in one launch, so E - C is its select's cost over
   the same byte stream), and B also at B = 64, 256 and bench.py's batch
   of 1024, D at 1024 (plain versions in chunks of 16 queries); at the
   batches where B and D take their cluster-major coarse pass (the
   library's choice, `ivf_scan.cluster_major`) their bound counts each
   cluster the batch probes once, and at 1024 torch.profiler reads the
   device time of each of their launches (bucketing, coarse, select,
   `launch_ms`); besides their CUDA-event time
   over back-to-back calls (`ms`, which the host's enqueue rate can set
   at B = 1) they are timed by CUDA-graph replay (`graph_ms`, device
   time), and at B = 1 by the host's median time per call up to its
   enqueue (`host_us`, the wrapper's own cost). Then `torch.topk` of 128
   over [B, 32768] as context for the select;
2. engine phase: the episodic-memory engine in bench.py's configuration
   (1,000,000 x 768, K = 4096, probe 64, int8 coarse bank): bulk_load,
   write_memories, rebuild_centroids, a write on the live index, then
   retrieve_flat (scan and blockmax, B = 1024; the scan also with
   `flat_exact_funnel` and `flat_wide_funnel` = 4096, each held equal to
   the default scan's result, and with `flat_rescue_queries` = 64 at
   width 1024, with recall at least the default scan's), retrieve_auto with
   ivf_kernel v3r, v2 and v3 (IVF, B = 1 and 8; in that order and again
   in the reverse order, keys ending "_rev") and retrieve with
   locations (IVF v1, B = 8), with recall@10 against the port's exact
   brute force over 1024 queries;
3. host-API phase: HippocampalFormation(max_memories=65_536) written in
   batches of 512 through automatic rebuilds, then queried with and
   without a location;
4. LM phase: the LM's serving path at `get_full_config()` (768 wide, 12
   RAG layers, SNN FFN on even layers, bf16 compute over f32 weights,
   random weights from a seeded generator) over a 100,000 x 768 bank
   (bench.py's data recipe, bulk_load + rebuild_centroids): 11 requests
   through `BatchedGenerator` (batches of 8, prompts padded to 64, up to
   64 new tokens) under asyncio, one batch with bf16 weights, KV-cached
   greedy decode against the full-prefix recompute, a prefill at B = 8
   through kernel B against the same prefill through kernel B's plain
   version, `one_shot_memorize_and_generate`, and the timings of prefill
   and decode (ms per step and tokens/s at B = 8, f32 and bf16 weights,
   and decode with retrieval's host sync or aux rebuild taken out).
   Kernel B runs in every RAG layer at (K, C, P) = (256, 896, 8), so the
   kernel phase also holds it to its plain version at that shape.

5. training phase: the LM's training path at `get_full_config()` with
   `TRAIN_CHANGES` (batch 16 as 2 micro-batches of 8, which retrieve
   through kernel B; memory from step 0; warmup 2 steps; max_steps 64),
   random weights from a seed, over the same 100,000 x 768 bank: 8
   `Trainer.train_step`s on one repeated batch of 16 x 512 random ids
   (kernel B launches = 12 layers x 2 micro-batches x the steps with
   memory, step 0 among them, no other kernel; 16 rows stored at each
   store step; the loss finite and falling), EWC consolidation through
   memory and a step with its penalty, a sleep phase (memory off, no
   kernel B), one micro-batch's loss and gradients through kernel B
   against the same through kernel B's plain version with autograd
   (every RAG layer's query_proj gradient nonzero), and ms per step,
   tokens/s and peak device memory with memory, without, with memory
   but without `retrieve_auto`'s host sync (aux built once), and with
   memory and remat ("full").

6. operator phase: what an operator of the system does, at
   `get_full_config()` with `TRAIN_CHANGES`, dropout 0 and the thalamus
   and endocrine gates off (`operator_config`), in a temporary directory
   it deletes: a JSONL corpus of 100,000 distinct synthetic texts (from a
   seed) through the CLI's `ingest` into the preset's 100,000 x 768 bank
   (the native hash embedder; rebuilds timed; embedding alone timed),
   then self-recall@1 of 1024 ingested texts at B = 8 (>= 0.99, kernel B
   once per batch); a `Trainer` over that bank takes 2 `train_step`s
   with memory (kernel B 12 x 2 per step), `CheckpointManager.save`,
   restore into a fresh `Trainer` (every tensor, `_step` and the slot ids
   equal bit for bit, every parameter still a view of the optimizer's
   flat buffer; a truncated copy raises and changes nothing); one more
   `train_step` on both, equal bit for bit; 8 requests served from each
   by `BatchedGenerator` with its bank under asyncio (greedy tokens
   equal; kernel B 12 x (1 + steps) per batch); then the CLI in
   subprocesses at `--preset full`: `train --steps 2`, `generate` and
   `serve` (one POST /generate and one GET /stats over a socket), with
   no kernel built again.

7. spill phase: the host-spilled bank (`SpilledBank`) at
   benchmarks/bench_host_spill.py's configuration: 10,000,000 x 768, int8
   coarse rows on the card, the exact f32 rows in host RAM (M is cut to
   what MemAvailable holds, and the cut printed), funnel 64 blocks, rows
   96, query chunk 256, k = 10. Its data recipe (4,096 centres x 2.0 plus
   unit noise) is drawn on the card from a seed, one chunk ahead on a
   side stream into pinned buffers, so the ingest's uploads on the main
   stream are never waited for by the draw, and ingested through
   `bulk_load_chunked`; queries are stored rows plus
   0.5 x noise. `retrieve_stream` at B = 1024 and 128 (coalesce = B) over
   4096 queries after a warm call, with the benchmark's per-batch
   breakdown (dispatch, device funnel, transfer, host rerank), all
   through `bench_host_spill.measure`; the native rerank must serve every
   query of the warm call, the stream and the breakdown; the stream must equal
   `retrieve` batch for batch; recall@10 of 256 queries against the
   exact cosine top-10 over all rows (f32 products on the card) >= 0.99;
   one chunk's funnel through kernel A and through its plain version
   gives the same candidates; kernel A timed at the chunk's shape (B =
   256 over the whole bank); device and host bytes beside those of a
   device-resident `MemoryState` of the same M.

8. brain phase: the neuromorphic brain system at the JAX package's
   sizes: `NeuromorphicBrainSystem()` (d_model 64, 8 zones of 64 LIF
   neurons, 4 steps, a 4096 x 64 hippocampus) routes 1,000 seeded texts
   covering every keyword class through `process_text`, the first 64
   held to a CPU system from the same seed (the same plans; outputs
   within 1e-5 where every spike agrees, flips on at most 1e-4 of the
   entries), then 1,000 more items through `orchestrator.process_batch`
   in batches of 32 and its zone executor; every zone must run, every
   output be finite and on the card, and the processor must have
   swallowed no zone error (checked after every call); per
   `process_text` the time, kernel launches, host syncs (CUDA's sync
   debug mode) and the device's busy share (torch.profiler); a
   `NeuromorphicBrainZone` at `BrainZoneConfig`'s defaults (128 neurons,
   64 -> 64, 4 steps) with LIF, Izhikevich and AdEx thirds and
   `EnhancedBrain` over the 8 default zones at d_model 64, timed at
   B = 1 and 256; 200 `LiquidBrain.learn_text` steps at its defaults on
   a two-topic stream (reasoning keywords -1, memory keywords +1), whose
   last 50 errors must average below the first 50; and the CLI's
   `brain-demo` in a subprocess. The path runs no kernel of the port.

9. natural-brain phase: the NaturalBrain path at the JAX classes'
   defaults, nothing cut, on ids at bench_prosody.py's batch shape
   (B = 8, T = 256, vocab 32,000): `NaturalBrain` (d_model 128, the
   three default regions, 4 experts, 64 zone neurons; 8.71M parameters)
   with hormone levels from the port's `EndocrineSystem`;
   `MoELanguageZone` (d_model 256, 8 experts, top-2, levels 8; 18.33M),
   forward and backward; `FullLanguageZone` in dense mode at width 256.
   Each is held to a CPU copy of the same weights with the same Poisson
   draws (CPU generators of one seed) on 2 batches at its init and 2
   driven (the embedding table, or the features, N(0, 1): spike rate >
   0.1): outputs within 1e-5 on the rows where every spike agrees,
   spikes that flip where they are made (each stage of the card run on
   the CPU's input to it) on at most 1e-4 of the entries; the MoE's
   gradients within 1e-4 of each tensor's RMS. Timed: ms per call,
   launches, device busy share, host syncs and tokens/s. Then
   `CachedProsodyBridge(ANALYTICAL_BALANCED)` over bench_prosody.py's 16
   seeded batches as ids on the card, cold then warm (uncached tokens/s,
   cache speedup, hit rate; one host copy per call); the emotion head at
   bench_emotion_e2e.py's configuration (1024-wide hash features, 28
   labels, Adam 3e-3, 600 full-batch epochs on the stratified split of
   data/emotion_eval.jsonl) on the card and the CPU: the loss falls, the
   card's top-1 test accuracy beats chance; `DualLayerSRFFN()` over
   1,000 seeded texts with phonemes (texts/s, features within 1e-5 of
   the CPU's). The path runs no kernel of the port.

10. sharded phase: the data-parallel path on a one-rank process group
   (NCCL on the card, a rendezvous on a free local port, `global_mesh(1)`):
   the engine phase's 1,000,000 x 768 bank (built again from its seed)
   as shard 0, where `retrieve_sharded` at B = 1, 8 and 1024 must equal
   `retrieve_auto` bit for bit with the same kernel launches (kernel B
   once per call at B = 1 and 8), timed beside it and beside its merge
   alone; the sharded write, rebuild, live write and decay on a 65,536 x
   768 shard, each equal to the engine's; a trainer at `get_full_config()`
   with `TRAIN_CHANGES` and the thalamus gate off (memory at every step)
   after `shard_to_mesh`, over the training phase's bank as its shard,
   against a plain trainer from the same seed over the same bank: 4
   `train_step`s each under deterministic algorithms, kernel B 12 x 2 per
   step in both, losses and every tensor equal bit for bit, ms per step
   and peak memory of each; the sharded trainer's checkpoint (its bank in
   the stacked [S, ...] layout) restored bit for bit into a fresh one;
   the utils: `get_memory_stats` against `memory_allocated`, `StepTimer`
   over decode steps at B = 8 through the sharded adapter and through
   `retrieve_auto`, a `trace` of one decode step that must name kernel
   B's two CUDA functions, `EnergyTracker` over the first spiking FFN's
   spikes; and the CLI's `mnist` in a subprocess on the card, within 3
   points of the JAX script's accuracy on the same digits.

11. model-parallel phase: tensor, sequence, pipeline and expert
   parallelism on a one-rank process group (NCCL on the card, as phase 10
   opens it), at `get_full_config()` over phase 4's 100,000 x 768 bank:
   phase 4's 11 requests, greedy, through `BatchedGenerator(mesh=
   global_mesh(1))` and a plain server (the same tokens, kernel B 12 x
   (1 + steps) per batch in each, ms per decode step of both);
   `sequence_sharded_attention` on a ('data', 'seq', 'model') mesh at B =
   8, L = 512, 12 x 64 heads against causal SDPA (forward and q/k/v
   gradients within 1e-5 of each tensor's largest entry in f32 with TF32
   off, 1e-2 in bf16; ms of both); `pipelined_rag_apply` over one stage
   with 4 microbatches of phase 5's micro-batch of 8 against the plain
   forward (logits within 1e-2, kernel B 12 x 4 and 12, one loss and its
   gradients at phase 5's RMS bound; ms of both); `MoELanguageZone(
   32000)` at B = 8, T = 256 with its experts placed by `shard_params` on
   a ('data', 'model') mesh, equal to the unsharded zone bit for bit;
   and a trainer after `shard_to_mesh` on a ('data', 'seq', 'model',
   'stage') mesh, 2 steps bit-equal to a plain trainer's under
   deterministic algorithms, kernel B 12 x 2 per step.

12. bench phase: the port's counterpart of the root `bench.py`
   (`aura_snn_rag_tpu_torch/bench.py`) in this process at bench.py's
   full defaults (1,000,000 x 768 from its numpy seed, f16 ingest, int8
   coarse rows, K = 4096, probe 64, 16 batches of 1024 queries through
   the flat scan and through IVF v3r with aux built once, the host
   baseline): recall@10 >= 0.99 against the device's exact search and
   against the f32 rows, IVF recall@10 of the timed batches >= 0.98,
   kernel B 1 + 16 times and no other kernel; then `--small
   --flat-strategy=blockmax` (kernel A and kernel B 1 + 8 times each);
   then the CLI's `bench --small` in a subprocess, whose last line must
   carry bench.py's 16 keys.

13. benchmarks phase: the ports of the repo's benchmark scripts
   (`aura_snn_rag_tpu_torch/benchmarks/`), each run in this process
   through its `run(argv)`: `bench_host_spill --small --breakdown`
   (1,000,000 x 768 from the script's numpy chunks; recall@10 >= 0.99,
   kernel A ceil(B / 256) times per funnel dispatch and no other kernel),
   `bench_sharded_scaling --n=1` (one NCCL rank; top-k agreement with
   one flat bank 1.0, the counted all-gather bytes equal to the analytic
   count, no kernel; then the port's `bench --sharded=1`, which hands
   the check over on its default device, the card),
   `bench_retrieval_latency` at its defaults (1M x
   768, B = 1, 8, 32, 128; IVF recall@10 >= 0.98, flat >= 0.99, kernel B
   once per IVF call), `bench_retrieval_breakdown` at its defaults
   (kernels C, D and E once per call of their stages, B once per call of
   the full v3r retrievals), and `bench_decode`, `bench_generation`,
   `bench_decode_breakdown` and `bench_rag_overhead` at `--preset full`
   (`get_full_config()`), cut in new tokens, reps and steps
   (`LM_BENCHMARK_ARGS`; tokens within the vocabulary, losses finite, no
   kernel). Every JSON line must carry its JAX script's keys in order.

14. drivers phase II: the remaining ports of the repo's benchmark
   scripts and its tools (`aura_snn_rag_tpu_torch/benchmarks/`,
   `aura_snn_rag_tpu_torch/tools/`), each run in this process through its
   `run(argv)`: `bench_flat_kernel --small` at int8 and `--bf16` (100,000
   x 768; kernel A exactly 1 + 4 times, its surface equal to
   `flat_blockmax_plain`'s, bit for bit at int8 and within 1e-5 at
   bf16, the kernel phase's bound), `bench_flat_batch_sweep --small
   --out` (a temporary file; recall@10 >= 0.99 in every row, kernel A
   once per `blockmax` call and never in `blockmax-plain` or the
   scans), `bench_rescue_ab --small`
   (recall@10 >= 0.99 in every row, each row's indices those of the
   default funnel at its rerank width, no kernel), `bench_h2d_dtypes`,
   `bench_prosody`, `bench_prosody_sweep --json`, `bench_moe_routing`,
   `ablation_moe_routing`, `bench_energy_tracking` and
   `bench_emotion_e2e` at their defaults (no kernel; the emotion head's
   top-1 above 1/28), `neuron_firing_diag`, `continuous_learning_runner
   --duration 2`, and on phase 6's `--preset full` CLI checkpoint
   `verify_checkpoint` (exit 0, with and without `--deep`; exit 1 on a
   copy with one NaN in `params`, naming the parameter) and
   `inspect_checkpoint` (the full preset's width, depth and vocabulary).
   Every JSON line must carry its JAX script's keys in order.

15. examples phase: the ports of the repo's examples and scripts
   (`aura_snn_rag_tpu_torch/examples/`, `aura_snn_rag_tpu_torch/scripts/`),
   each through its `run(argv)` in this process (a clean return is its
   exit 0), over a corpus folder in `tools/build_offline_corpus.py`'s
   layout made of this checkout's Markdown as byte-tokenizer ids (a
   fifth of the documents held out; `meta.json` declares the full
   preset's vocabulary of 32,000): `train_flagship --preset full --steps
   4 --chunk 2 --memory-warmup 0 --eval-every 2 --save-every 2` (every
   record with the script's keys, finite losses, 0 < MFU < 1 against the
   H100's bf16 peak, the final record, the JSONL log), then `--steps 6`
   from its checkpoint (it must resume at step 4); that checkpoint
   restored by `flagship_demo.restore`, given the LM phase's 100,000 x
   768 bank with its index built, and `flagship_demo.demo` on the byte
   ids of the script's passage and prompt, 48 new tokens: kernel B
   exactly 12 x 48 times (one model call per new token, every RAG layer
   retrieving) and no other kernel, none in the generation without
   memory; `train_tiny` at its defaults, `train_wikitext2 --steps 50
   --eval-every 25`, `pretrain_production --steps 50 --preset debug
   --monitor-interval 5` (the lines the JAX scripts print, finite losses,
   parsed diagnostics, the checkpoint restored at step 50),
   `train_emotion_head` and `train_llm_hybrid` at their defaults (the
   lines and the JSON keys; no kernel); `dryrun_pp_xl.rank_work((1, 1))`
   on a one-rank NCCL group (the xl preset's 16 layers in one stage, 4
   microbatches of 2 x 128, forward and backward twice: finite and equal
   losses, a finite nonzero gradient norm, the loss within 1e-3 and the
   gradients within 2^-4 of the plain forward's over the same layers);
   `run_multihost_cpu.sh` (two gloo processes: exit 0, the sum 28.0 in
   each, "multihost demo OK"); `prepare_dataset` over the Markdown files
   as .txt (the packed shape), `tune_prosody_hyperparameters --trials 24`
   (no kernel) and `visualize_prosody.traces` on the card against the CPU
   port (within 1e-5 where the LIF spikes agree); and, where `tokenizers`
   or matplotlib imports, `flagship_demo.main` (with a BPE tokenizer
   trained on the documents) and `visualize_prosody.main`. Every kernel's
   launches over the phase are added to its row of the kernels line.

`--profile` adds a torch.profiler breakdown of one call of each
retrieval path (device time by kernel, device busy share) to phase 2,
of decode steps (wall, device, busy, `retrieve_auto`'s share) to
phase 4, and of training steps with memory to phase 5.

Launch counters are zeroed just before phase 2 and read after phase 3;
every kernel must have run there. They are zeroed again before phase 4,
where kernel B must run 12 times per model call and no other kernel
runs, again just before phase 5's 8 counted train_steps, and again
before phase 6, after which kernel B alone must have run, and again
just before phase 7's retrievals, after which kernel A alone must have
run, ceil(B / 256) times per funnel dispatch, and again at the start of
phases 8 and 9, after each of which no kernel may have run; phases 10
to 15 zero them around each call whose launches they check. Any failed
check exits non-zero. The last lines are the card's name and power
limit, one JSON object with the per-kernel numbers, and
{"ok": true, "device": {...}}. Without a CUDA card the script exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
NEG_INF = -1e30

# bench.py's configuration (bench.py:173-180) at full width
ENGINE = dict(max_memories=1_000_000, feature_dim=768, k_centroids=4096,
              probe_centroids=64, retrieve_k=10, bucket_overprovision=2.0,
              rebuild_lloyd_iters=2, coarse_dtype="int8",
              overflow_buckets=64, flat_score_dtype="bf16",
              rerank_candidates=128, n_place_cells=16, n_grid_cells=8,
              n_time_cells=4)
KERNEL_SHAPES = dict(M=1_000_000, D=768, K=4096, C=512, P=64, kk=128, k=10)
# kernel B as the LM's RAG layers call it (get_full_config's memory: 100k
# rows, K = 256, capacity 896, probe 8; num_retrieved 5)
LM_KERNEL_SHAPES = dict(M=100_000, D=768, K=256, C=896, P=8, kk=128, k=5)
LM_SERVE = dict(batch_size=8, prompt_pad=64, max_new_tokens=64)
N_REQUESTS = 11
DECODE_STEPS = 32               # decode steps per timing
# kernel B vs its plain version, prefill logits: the two retrieve the same
# slots with scores 3e-8 apart, so the memory context and the logits agree
# to the last bit; 1e-2 leaves room for one bf16 ulp of that context after
# another summation order, not for another memory retrieved
LM_LOGIT_TOL = 1e-2
N_EVAL = 1024                   # queries for recall@10
TOPK = 10
# the training phase: get_full_config() with these changes (batch 16 as
# two micro-batches of 8, which retrieve through kernel B; memory from
# step 0; a short warmup so a few steps move the weights)
TRAIN_CHANGES = dict(gradient_accumulation_steps=2, memory_warmup_steps=0,
                     warmup_steps=2, max_steps=64)
TRAIN_STEPS = 8                 # train_steps on one repeated batch
TRAIN_SEQ = 512
TRAIN_TIMED = 3                 # steps per timing, after one warm-up
# gradients through kernel B (its Function's backward) against autograd
# through its plain version, at the trained bf16 compute, on each
# micro-batch of the step: the forward is the same to the last bit (loss
# within TRAIN_LOSS_RTOL), but the two backwards sum the query's f32
# gradient in different orders, and an ulp that flips one bf16 rounding
# moves every gradient below it. So each tensor's gradients are held by
# their RMS gap against their RMS (at least 1e-3 of the model's largest
# RMS: the floor of gradients that are zero in exact arithmetic). On the
# H100 such gaps were 0 on most micro-batches and at most 5.0e-3 (the
# largest single entry 1.35% of its tensor's largest); a gradient into
# the queries off by 2x gives 0.5, a missing one 1. 2^-4 sits between.
TRAIN_GRAD_RTOL = 2.0 ** -4
TRAIN_LOSS_RTOL = 1e-5

# the operator phase: get_full_config() with TRAIN_CHANGES (see
# operator_config); a corpus of the preset's bank size, ingested through
# the CLI's `ingest`; self-recall@1 of OPERATOR_QUERIES ingested texts at
# B = 8 at least OPERATOR_RECALL (a text's own row scores cosine 1)
OPERATOR_TEXTS = 100_000
OPERATOR_QUERIES = 1024
OPERATOR_RECALL = 0.99
OPERATOR_STEPS = 2              # train_steps before the checkpoint
OPERATOR_REQUESTS = 8           # served from the checkpoint, one batch
OPERATOR_NEW_TOKENS = 16
OPERATOR_PRESET = "full"        # the CLI subprocesses' --preset
OPERATOR_CLI_TIMEOUT = 300      # seconds per CLI subprocess

# the spill phase: benchmarks/bench_host_spill.py's configuration
# (:100-105) with its defaults (funnel 64 blocks, rows 96, chunk 256)
SPILL = dict(max_memories=10_000_000, feature_dim=768, retrieve_k=10,
             coarse_dtype="int8", flat_block_funnel=64, spill_funnel_rows=96,
             spill_query_chunk=256, k_centroids=16, n_place_cells=8,
             n_grid_cells=4, n_time_cells=2)
SPILL_CENTERS = 4096
SPILL_CHUNK = 262_144           # rows per bulk_load_chunked chunk
SPILL_QUERIES = 4096            # per timed retrieve_stream
SPILL_BATCHES = (1024, 128)     # the query batch, also the coalesce width
SPILL_EVAL = 256                # queries held to the exact truth
SPILL_RECALL = 0.99
SPILL_HOST_SPARE = 10e9         # host bytes beside the host half

# the brain phase: the JAX package's sizes (NeuromorphicBrainSystem's
# defaults, BrainZoneConfig's, LiquidBrain's), nothing cut
BRAIN_TEXTS = 1000              # process_text calls, then as many items
BRAIN_BATCH = 32                # orchestrator batch
BRAIN_CHECK = 64                # texts held to the CPU port
BRAIN_PROFILE = 20              # process_text calls profiled
BRAIN_BATCHES = (1, 256)        # the mixed zone's and EnhancedBrain's B
BRAIN_TIMED = 5                 # calls per timing
LIQUID_STEPS = 200
# the card against the CPU, as the parity tests hold the port to JAX:
# outputs within 1e-5 where every spike agrees, flips on at most 1e-4 of
# the entries (a potential within an ulp of its threshold)
BRAIN_TOL = 1e-5
BRAIN_FLIP_FRACTION = 1e-4

# the natural-brain phase: the JAX classes' defaults, nothing cut; ids at
# benchmarks/bench_prosody.py's batch shape, vocab ModelConfig.vocab_size
NB_VOCAB = 32_000
NB_BATCH, NB_SEQ = 8, 256
NB_CHECK = 2                    # batches held to the CPU port, per case
                                # (defaults and driven: 4 per model)
NB_TIMED = 3                    # calls per timing
NB_DRIVE = 1.0                  # std of the driven case's embedding table
NB_GRAD_RTOL = 1e-4             # MoE gradients, of each tensor's RMS
EMOTION_EPOCHS = 600            # bench_emotion_e2e.py's default
SRFFN_TEXTS = 1000

# the bench phase: the port's bench.py at its defaults, then `--small`
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "recall_at_10",
              "recall_eval_queries", "recall_at_10_vs_f32_data",
              "baseline_recall_at_10", "baseline_qps", "ivf_qps",
              "index_build_s", "index_build_cold_s", "ingest_transfer_s",
              "baseline_build_s", "n_vectors", "coarse_dtype")
BENCH_RECALL = 0.99             # flat recall@10: oracle and f32 rows
BENCH_IVF_RECALL = 0.98         # the engine phase's IVF bar
BENCH_CLI_TIMEOUT = 600         # seconds for `cli bench --small`
PLAIN_CHUNK = 16                # queries per plain IVF call (kernel phase)

# the benchmarks phase (phase 13): the JAX scripts' JSON keys, in order
SPILL_KEYS = ("metric", "value", "unit", "recall_at_10", "ingest_s",
              "n_vectors", "coarse_dtype", "batch", "funnel_blocks",
              "funnel_rows", "query_chunk", "hbm_resident_gb",
              "host_resident_gb")
SPILL_BREAKDOWN_KEYS = ("breakdown_per_batch_ms", "funnel_bytes_per_batch",
                        "funnel_blocks", "funnel_rows", "n_vectors")
SPILL_STAGES = ("dispatch", "device_funnel", "transfer", "host_rerank")
SHARDED_KEYS = ("metric", "n_shards", "per_shard_rows", "total_rows",
                "topk_agreement_vs_flat", "collective_bytes_per_batch",
                "collective_bytes_total", "analytic_allgather_bytes",
                "bytes_per_query", "batch")
LATENCY_KEYS = ("wall_latency_ms", "device_ms", "device_qps",
                "recall_at_10")
STAGE_KEYS = ("aux_build_ms", "centroid_topP_ms", "kernel_v2_ms",
              "kernel_v1_ms", "kernel_v3_ms", "funnel_rerank_ms",
              "full_v3_ms", "full_v3r_ms", "full_v2_ms", "full_noaux_ms")
# the kernel each stage of bench_retrieval_breakdown launches, once per
# call (full_v3 and full_noaux run the config's default kernel, v3r)
STAGE_KERNELS = {"kernel_v2": "ivf_topk_scores",
                 "kernel_v1": "ivf_scan_scores",
                 "kernel_v3": "ivf_candidates",
                 "full_v3": "ivf_retrieve_fused",
                 "full_v3r": "ivf_retrieve_fused",
                 "full_v2": "ivf_topk_scores",
                 "full_noaux": "ivf_retrieve_fused"}
DECODE_KEYS = ("tokens_per_s", "latency_s", "per_token_ms")
GENERATION_KEYS = ("cached_tokens_per_s", "recompute_tokens_per_s",
                   "speedup", "batch", "new_tokens")
DECODE_BREAKDOWN_KEYS = ("preset", "batch", "new_tokens", "ms_per_token",
                         "sampler_share_ms", "f32_weight_read_share_ms")
DECODE_VARIANTS = ("full", "greedy", "forward_only", "bf16_full",
                   "blockwise_topk", "bf16_blockwise")
RAG_OVERHEAD_KEYS = ("metric", "n_params", "batch", "seq_len",
                     "step_ms_memory_off", "step_ms_rag_no_store",
                     "step_ms_rag_store", "mfu_memory_off",
                     "mfu_rag_no_store", "mfu_rag_store_every_step",
                     "isolated_retrieval_ms", "isolated_write_ms",
                     "retrieval_gap_ms", "store_gap_ms",
                     "retrieval_hbm_gb_per_step", "tok_s_rag_live_store10")
# the LM benchmarks at --preset full, cut to fit the phase (printed)
LM_BENCHMARK_ARGS = {
    "bench_decode": ["--preset", "full", "--new-tokens", "8", "--reps",
                     "1"],
    "bench_generation": ["--preset", "full", "--new-tokens", "8"],
    "bench_decode_breakdown": ["--preset", "full", "--new-tokens", "8",
                               "--reps", "1"],
    "bench_rag_overhead": ["--steps=2"],
}

SOURCES = {
    "flat_blockmax": ("aura_snn_rag_tpu_torch/ops/cuda/csrc/flat_scan.cu",
                      "aura_snn_rag_tpu/ops/pallas/flat_scan.py:172"),
    "ivf_retrieve_fused": ("aura_snn_rag_tpu_torch/ops/cuda/csrc/ivf_scan.cu",
                           "aura_snn_rag_tpu/ops/pallas/ivf_scan.py:317"),
    "ivf_scan_scores": ("aura_snn_rag_tpu_torch/ops/cuda/csrc/ivf_scan.cu",
                        "aura_snn_rag_tpu/ops/pallas/ivf_scan.py:550"),
    "ivf_candidates": ("aura_snn_rag_tpu_torch/ops/cuda/csrc/ivf_scan.cu",
                       "aura_snn_rag_tpu/ops/pallas/ivf_scan.py:186"),
    "ivf_topk_scores": ("aura_snn_rag_tpu_torch/ops/cuda/csrc/ivf_scan.cu",
                        "aura_snn_rag_tpu/ops/pallas/ivf_scan.py:62"),
}
IVF_KERNELS = ("v3r", "v2", "v3")     # ivf_kernel settings the engine runs
# the flat scan's options the engine runs beside its default funnel
FLAT_OPTIONS = {
    "exact_funnel": dict(flat_exact_funnel=True),
    "wide_funnel": dict(flat_wide_funnel=4096),
    "rescue": dict(flat_rescue_queries=64, flat_rescue_width=1024),
}


class CheckFailed(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def log(*a):
    print(*a, flush=True)


def time_ms(fns, iters=10, warmup=2):
    """Mean ms per call over `iters` calls with CUDA events, cycling
    through `fns` (several input sets, so a small working set cannot stay
    in the 50 MB L2 between calls)."""
    import torch
    fns = list(fns)
    for f in fns[:warmup] or fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, iters=20, replays=5):
    """Mean device ms per call: `iters` calls cycling through `fns`,
    captured once in a CUDA graph and replayed `replays` times between
    CUDA events. Unlike time_ms, the host's enqueue rate (Python, ctypes
    and allocations, tens of microseconds per call) cannot set the pace,
    which it does for the IVF kernels at B = 1."""
    import torch
    fns = list(fns)
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def host_us(fns, iters=200):
    """Median host microseconds per call over `iters` back-to-back calls
    (no sync between them): the wrapper's own cost up to its enqueue
    (checks, allocations, ctypes, launches), which sets `ms` at B = 1
    where the card finishes each call sooner. The median, since a call
    the host's scheduler stalls would swing a mean."""
    import statistics
    import torch
    fns = list(fns)
    for f in fns:
        f()
    torch.cuda.synchronize()
    per_call = []
    for i in range(iters):
        t0 = time.perf_counter()
        fns[i % len(fns)]()
        per_call.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(per_call) * 1e6


def sustained(fn, seconds=2.0):
    """fn run back to back for about `seconds`: (ms per call, SM clock MHz
    (min, max), power W (min, max)), the clock and power sampled with
    nvidia-smi meanwhile, over the last two thirds of the window (None
    where nvidia-smi gave nothing). Shows whether the card held its clock
    or its power limit set the pace."""
    import threading
    import torch
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            try:
                r = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30)
                samples.append(tuple(float(v) for v in
                                     r.stdout.splitlines()[0].split(",")))
            except (OSError, subprocess.SubprocessError, IndexError,
                    ValueError):
                pass
            time.sleep(0.2)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = max(10, int(seconds / (time.perf_counter() - t0)))
    thread = threading.Thread(target=sample)
    thread.start()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    stop.set()
    thread.join()
    tail = samples[len(samples) // 3:]
    span = [(min(v), max(v)) if v else None
            for v in zip(*tail)] if tail else [None, None]
    return start.elapsed_time(end) / n, span[0], span[1]


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def blockmax_bound(M, D, B, dtype):
    """Kernel A's bound: the bank, the row terms and the queries read once,
    the [B, M/8] block maxima written once; 2*B*M*D operations."""
    elem = 1 if dtype == "int8" else 2
    nbytes = M * D * elem + 2 * 4 * M + B * D * elem + 4 * B * (M // 8)
    return bound_ms(nbytes, 2 * B * M * D, dtype)


def kernel_A(dev, gen, M, D, cases):
    """flat_blockmax vs its plain version; returns {case: numbers}."""
    import torch
    from aura_snn_rag_tpu_torch.benchmarks.bench_flat_kernel import (
        blockmax_library)
    from aura_snn_rag_tpu_torch.memory.engine import _to_coarse_rows
    from aura_snn_rag_tpu_torch.ops.cuda.flat_scan import (
        BLOCK_R, flat_blockmax, flat_blockmax_plain, pack_row_terms)

    x = torch.randn(M, D, device=dev, generator=gen)
    x = x * torch.rsqrt((x * x).sum(-1, keepdim=True))
    strength = torch.rand(M, device=dev, generator=gen) * 0.5 + 0.5
    add = 0.2 * strength
    add[torch.rand(M, device=dev, generator=gen) < 0.01] = NEG_INF
    out = {}
    for dtype, B in cases:
        torch_dt = torch.int8 if dtype == "int8" else torch.bfloat16
        bank, row_scale = _to_coarse_rows(x, torch_dt)
        mul_p, add_p = pack_row_terms(0.5 * strength * row_scale, add, M)
        sets = []
        for _ in range(2):
            q = torch.randn(B, D, device=dev, generator=gen)
            qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True))
            qc, qs = _to_coarse_rows(qn, torch_dt)
            sets.append((bank, qc.contiguous(), mul_p, add_p,
                         qs if dtype == "int8" else None))
        got = flat_blockmax(*sets[0])
        want = flat_blockmax_plain(*sets[0])
        torch.cuda.synchronize()
        check(got.shape == want.shape == (B, -(-M // BLOCK_R)),
              f"flat_blockmax shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        # int8: exact integer sums and the same f32 epilogue; bf16: f32
        # sums of exact products in another order
        tol = 0.0 if dtype == "int8" else 1e-5
        check(err <= tol, f"flat_blockmax {dtype} B={B}: err {err} > {tol}")
        del got, want
        ms = time_ms([lambda s=s: flat_blockmax(*s) for s in sets])
        s_ms, clock, power = sustained(lambda: flat_blockmax(*sets[0]))
        log(f"kernel flat_blockmax {dtype} B={B}: sustained for ~2 s "
            f"{s_ms:.4f} ms/call, SM clock {clock} MHz, power {power} W")
        plain_ms = time_ms([lambda s=s: flat_blockmax_plain(*s)
                            for s in sets], iters=3, warmup=1)
        lib_ms = time_ms([lambda s=s: blockmax_library(*s) for s in sets],
                         iters=3, warmup=1)
        if dtype == "int8":
            from aura_snn_rag_tpu_torch.memory.engine import _int8_matmul
            # context, not the yardstick: cuBLAS's int8 GEMM alone, without
            # the epilogue and with its [B, M] int32 output
            gemm_ms = time_ms([lambda s=s: _int8_matmul(s[1], s[0])
                               for s in sets], iters=3, warmup=1)
            log(f"kernel flat_blockmax int8 B={B}: bare _int_mm product "
                f"ms={gemm_ms:.4f}")
        b_ms, b_by = blockmax_bound(M, D, B, dtype)
        out[(dtype, B)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=b_ms,
                               bound_by=b_by)
        log(f"kernel flat_blockmax {dtype} B={B} M={M} D={D}: "
            f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms} bound_ms={b_ms:.4f} ({b_by})")
        del sets, bank
    return out


def ivf_inputs(dev, gen, K, C, D, M, P, B, n_sets):
    import torch
    cl = torch.randn(K, C, D, device=dev, generator=gen)
    cl = (cl * torch.rsqrt((cl * cl).sum(-1, keepdim=True))).to(
        torch.bfloat16)
    aux = torch.zeros(K, 8, C, device=dev)
    aux[:, 0] = torch.rand(K, C, device=dev, generator=gen) * 0.5 + 0.25
    aux[:, 1] = torch.rand(K, C, device=dev, generator=gen) * 0.2
    dead = torch.rand(K, C, device=dev, generator=gen) < 0.1
    aux[:, 1][dead] = NEG_INF
    aux[:, 2] = torch.randint(0, M, (K, C), device=dev, generator=gen).float()
    feats = torch.randn(M, D, device=dev, generator=gen)
    sets = []
    for _ in range(n_sets):
        q = torch.randn(B, D, device=dev, generator=gen)
        qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True))
        top_c = torch.stack([torch.randperm(K, device=dev, generator=gen)[:P]
                             for _ in range(B)]).to(torch.int32)
        sets.append((qn, top_c))
    return cl, aux, feats, sets


def check_slots(name, s, sl, ps, psl):
    """Rows of (score, slot) lanes against the plain version's: slots
    equal wherever the plain score is more than 1e-4 from its neighbours
    (nearer scores may swap under another summation order)."""
    import numpy as np
    for r in range(ps.shape[0]):
        for j in range(ps.shape[1]):
            others = np.delete(ps[r], j)
            if others.size == 0 or np.min(np.abs(others - ps[r, j])) > 1e-4:
                check(sl[r, j] == psl[r, j],
                      f"{name} slot mismatch row={r} lane={j}")


def in_chunks(call, qn, tc, chunk=PLAIN_CHUNK):
    """call(qn, tc) -> a tuple of [B, ...] tensors, over `chunk` queries
    at a time and concatenated: a plain IVF version gathers [B, P, C, D]
    (25.8 GB of bf16 at B = 1024 and the engine's shapes)."""
    import torch
    if qn.shape[0] <= chunk:
        return call(qn, tc)
    parts = [call(qn[i:i + chunk], tc[i:i + chunk])
             for i in range(0, qn.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def kernel_B_C(ivf, K, C, D, M, P, kk, k, cases_B, cases_C,
               union_cases=(), profile_cases=()):
    """Kernels B and C against their plain versions at each batch of
    `cases_B` / `cases_C`; at the batches of `union_cases` (those on the
    cluster-major coarse pass) kernel B's bound reads each cluster the
    batch probes once (a batch of 1024 probes nearly all K), elsewhere once
    per query that probes it; at `profile_cases` also the device time of
    each of its launches (`launch_ms`)."""
    import numpy as np
    import torch
    from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import (
        ivf_candidates_plain, ivf_retrieve_fused, ivf_retrieve_fused_plain,
        ivf_scan_scores, ivf_scan_scores_plain)

    cl, aux, feats, sets = ivf
    res = {}
    for B in cases_B:
        bsets = [(qn[:B].contiguous(), tc[:B].contiguous())
                 for qn, tc in sets]
        qn, tc = bsets[0]
        s, sl = ivf_retrieve_fused(cl, aux, feats, qn, tc, kk, k)
        ps, psl = in_chunks(lambda q, t: ivf_retrieve_fused_plain(
            cl, aux, feats, q, t, kk, k), qn, tc)
        torch.cuda.synchronize()
        s, sl, ps, psl = (t.cpu().numpy() for t in (s, sl, ps, psl))
        hit = ps[:, :k] > -5e29
        check(((s[:, :k] > -5e29) == hit).all(), "ivf_retrieve_fused hits")
        err = float(np.abs(np.where(hit, s[:, :k] - ps[:, :k], 0)).max())
        # exact f32 dot products summed in another order
        check(err <= 1e-5, f"ivf_retrieve_fused B={B}: err {err}")
        check_slots("ivf_retrieve_fused", s[:, :k], sl[:, :k], ps[:, :k],
                    psl[:, :k])
        calls = [lambda q=q, t=t: ivf_retrieve_fused(
            cl, aux, feats, q, t, kk, k) for q, t in bsets]
        ms, g_ms = time_ms(calls, iters=20), graph_ms(calls)
        h_us = host_us(calls) if B == 1 else None
        plain_ms = time_ms([lambda q=q, t=t: in_chunks(
            lambda qc, tc_: ivf_retrieve_fused_plain(
                cl, aux, feats, qc, tc_, kk, k), q, t) for q, t in bsets],
            iters=4, warmup=1)
        # the probed bf16 blocks and aux rows 0-1 once (per query, or per
        # batch at `union_cases`), the query, the probe ids, the slots of
        # the kk candidates, the f32 rows of the live ones (the rerank
        # skips dead lanes), and the (score, slot) lanes written
        n_live = int((in_chunks(lambda q, t: ivf_candidates_plain(
            cl, aux, q, t, kk), qn, tc)[0] > -5e29).sum())
        clusters = (int(torch.unique(tc).numel()) if B in union_cases
                    else B * P)
        nbytes = (clusters * (C * D * 2 + 2 * C * 4)
                  + B * (P * 4 + D * 4 + kk * 4 + 2 * 128 * 4)
                  + n_live * D * 4)
        ops = B * 2 * P * C * D + n_live * 4 * D
        b_ms, b_by = bound_ms(nbytes, ops, "bf16")
        res[("ivf_retrieve_fused", B)] = dict(
            max_abs_err=err, ms=ms, graph_ms=g_ms, host_us=h_us,
            plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
            probed_clusters=clusters,
            coarse_pass="cluster" if B in union_cases else "pair")
        if B in profile_cases:
            res[("ivf_retrieve_fused", B)]["launch_ms"] = launch_ms(calls[0])
        log(f"kernel ivf_retrieve_fused B={B} K={K} C={C} P={P} D={D} "
            f"kk={kk} clusters read={clusters}: max_abs_err={err:.3g} "
            f"ms={ms:.4f} graph_ms={g_ms:.4f} host_us={h_us} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"{res[('ivf_retrieve_fused', B)].get('launch_ms', '')}")

    for B in cases_C:
        bsets = [(qn[:B].contiguous(), tc[:B].contiguous())
                 for qn, tc in sets]
        got = ivf_scan_scores(cl, *bsets[0])
        want = ivf_scan_scores_plain(cl, *bsets[0])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # bf16 products summed in f32 in another order
        check(err <= 1e-5, f"ivf_scan_scores err {err}")
        calls = [lambda q=q, t=t: ivf_scan_scores(cl, q, t)
                 for q, t in bsets]
        ms, g_ms = time_ms(calls, iters=20), graph_ms(calls)
        h_us = host_us(calls) if B == 1 else None
        plain_ms = time_ms([lambda q=q, t=t: ivf_scan_scores_plain(cl, q, t)
                            for q, t in bsets], iters=4, warmup=1)
        nbytes = B * (P * C * D * 2 + D * 4 + P * 4 + P * C * 4)
        b_ms, b_by = bound_ms(nbytes, 2 * B * P * C * D, "bf16")
        res[("ivf_scan_scores", B)] = dict(
            max_abs_err=err, ms=ms, graph_ms=g_ms, host_us=h_us,
            plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel ivf_scan_scores B={B} K={K} C={C} P={P} D={D}: "
            f"max_abs_err={err:.3g} ms={ms:.4f} graph_ms={g_ms:.4f} "
            f"host_us={h_us} "
            f"plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
    return res


def kernel_D_E(ivf, K, C, D, P, kk, k, cases_D, cases_E, union_cases=(),
               profile_cases=()):
    """ivf_candidates (width kk per query) at each batch of `cases_D` and
    ivf_topk_scores (width k per probe) at `cases_E` against their plain
    versions (in chunks of PLAIN_CHUNK queries) on the kernel-phase
    inputs; D's bound and launch times at `union_cases` and
    `profile_cases` as in kernel_B_C."""
    import numpy as np
    import torch
    from aura_snn_rag_tpu_torch.ops.cuda import ivf_scan

    cl, aux, _, sets = ivf
    res = {}
    # per query: the selected lanes whose slot is read, and the lanes written
    for name, width, picked, lanes, cases in (
            ("ivf_candidates", kk, kk, kk, cases_D),
            ("ivf_topk_scores", k, P * k, P * ivf_scan.KPAD, cases_E)):
        fn = getattr(ivf_scan, name)
        plain = getattr(ivf_scan, name + "_plain")
        for B in cases:
            bsets = [(qn[:B].contiguous(), tc[:B].contiguous())
                     for qn, tc in sets]
            qn, tc = bsets[0]
            s, sl = fn(cl, aux, qn, tc, width)
            ps, psl = in_chunks(lambda q, t: plain(cl, aux, q, t, width),
                                qn, tc)
            if name == "ivf_topk_scores":
                # E scores an entry as kernel C's pass does (`row_dot`): its
                # lanes are bit for bit the per-probe top-k of aux0 * cos +
                # aux1 from C's cosines, one rounding per operation as in E
                cos = ivf_scan.ivf_scan_scores(cl, qn, tc)
                a = aux[tc.long()]
                coarse = a[:, :, 0] * cos + a[:, :, 1]
                order = torch.argsort(coarse, dim=2, descending=True,
                                      stable=True)[..., :width]
                bit_err = (s[..., :width] - coarse.gather(2, order)).abs() \
                    .max().item()
                check(bit_err == 0.0 and torch.equal(
                    sl[..., :width], a[:, :, 2].gather(2, order).int()),
                    f"{name} B={B}: not kernel C's scores bit for bit "
                    f"(err {bit_err})")
                check(bool((s[..., width:] == NEG_INF).all())
                      and bool((sl[..., width:] == 0).all()),
                      f"{name} B={B}: pad lanes")
            torch.cuda.synchronize()
            # rows of `width` selected lanes: one per query (D) or probe (E)
            s, sl, ps, psl = (t.reshape(-1, t.shape[-1])[:, :width]
                              .cpu().numpy() for t in (s, sl, ps, psl))
            live = ps > -5e29
            check((live == (s > -5e29)).all(), f"{name} B={B} live lanes")
            err = float(np.abs(np.where(live, s - ps, 0)).max())
            # aux0 * cos + aux1: f32 sums of bf16 products in another order
            check(err <= 1e-5, f"{name} B={B}: err {err}")
            check_slots(name, np.where(live, s, 0), np.where(live, sl, -1),
                        np.where(live, ps, 0), np.where(live, psl, -1))
            calls = [lambda q=q, t=t: fn(cl, aux, q, t, width)
                     for q, t in bsets]
            ms, g_ms = time_ms(calls, iters=20), graph_ms(calls)
            h_us = host_us(calls) if B == 1 else None
            plain_ms = time_ms([lambda q=q, t=t: in_chunks(
                lambda qc, tc_: plain(cl, aux, qc, tc_, width), q, t)
                for q, t in bsets], iters=4, warmup=1)
            # the probed bf16 blocks and aux rows 0-1 once (per query, or
            # per batch on the cluster-major pass), the query, the probe
            # ids, the slots (aux row 2) of the selected lanes only, and
            # the (score, slot) lanes written
            union = name == "ivf_candidates" and B in union_cases
            clusters = int(torch.unique(tc).numel()) if union else B * P
            nbytes = (clusters * (C * D * 2 + 2 * C * 4)
                      + B * (P * 4 + D * 4 + picked * 4 + lanes * 8))
            b_ms, b_by = bound_ms(nbytes, B * 2 * P * C * D, "bf16")
            res[(name, B)] = dict(
                max_abs_err=err, ms=ms, graph_ms=g_ms, host_us=h_us,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, probed_clusters=clusters,
                coarse_pass="cluster" if union else "pair")
            if name == "ivf_candidates" and B in profile_cases:
                res[(name, B)]["launch_ms"] = launch_ms(calls[0])
            log(f"kernel {name} B={B} K={K} C={C} P={P} D={D} "
                f"width={width}: max_abs_err={err:.3g} ms={ms:.4f} "
                f"graph_ms={g_ms:.4f} host_us={h_us} "
                f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                f"{res[(name, B)].get('launch_ms', '')}")
    return res


# B's and D's launches by CUDA function: the cluster-major pass's
# bucketing (a memset and three kernels), the coarse pass (either one),
# the select pass
LAUNCH_GROUPS = (("bucketing", ("Memset", "ivf_bucket_")),
                 ("coarse", ("ivf_coarse_",)),
                 ("select", ("_select_",)))


def launch_ms(fn, reps=5):
    """Device ms per call of fn()'s launches, summed by LAUNCH_GROUPS
    (others under "other"), from torch.profiler's kernel rows over `reps`
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {group: 0.0 for group, _ in LAUNCH_GROUPS}
    out["other"] = 0.0
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        group = next((g for g, keys in LAUNCH_GROUPS
                      if any(key in e.key for key in keys)), "other")
        out[group] += e.self_device_time_total / 1e3 / reps
    return out


def topk_context(dev, gen, N, kk, cases_B):
    """torch.topk of kk over [B, N] f32: context for the select pass of B
    and D (N = P*C coarse scores), not their yardstick."""
    import torch
    out = {}
    for B in cases_B:
        xs = [torch.randn(B, N, device=dev, generator=gen) for _ in range(4)]
        out[B] = time_ms([lambda x=x: torch.topk(x, kk) for x in xs],
                         iters=20)
        log(f"context torch.topk(k={kk}) over [{B}, {N}] f32: "
            f"ms={out[B]:.4f}")
    return out


# --------------------------------------------------------------------------
# engine phase
# --------------------------------------------------------------------------

def make_data(dev, gen, n, d, n_centers=1024):
    """bench.py's make_data, drawn on the card."""
    import torch
    centers = torch.randn(n_centers, d, device=dev, generator=gen) * 2.0
    assign = torch.randint(0, n_centers, (n,), device=dev, generator=gen)
    feats = centers[assign]
    feats += torch.randn(n, d, device=dev, generator=gen)
    return feats, centers


def recall_at_k(approx, exact):
    a, e = approx.cpu().tolist(), exact.cpu().tolist()
    return sum(len(set(x) & set(y)) for x, y in zip(a, e)) / (
        len(e) * len(e[0]))


def timed_batches(fn, batches):
    """Run fn over every batch once; (results, seconds) with a sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [fn(b) for b in batches]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_paths(cfg, state, queries, reps=5):
    """Device time by kernel for one call of each retrieval path, from
    torch.profiler over `reps` calls; busy = device time / wall time."""
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.memory.engine import build_ivf_aux
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loc = torch.zeros(8, cfg.spatial_dims, device=queries.device)
    paths = {
        "flat_scan_b1024": lambda: port.retrieve_flat(
            dataclasses.replace(cfg, flat_strategy="scan"), state,
            queries[:1024], None, TOPK),
        "flat_blockmax_b1024": lambda: port.retrieve_flat(
            dataclasses.replace(cfg, flat_strategy="blockmax"), state,
            queries[:1024], None, TOPK),
        "ivf_v1_b8": lambda: port.retrieve(cfg, state, queries[:8], loc,
                                           TOPK),
    }
    for kern in IVF_KERNELS:
        c = dataclasses.replace(cfg, ivf_kernel=kern)
        for B in (1, 8):
            paths[f"ivf_{kern}_b{B}"] = (
                lambda c=c, B=B: port.retrieve_auto(c, state, queries[:B],
                                                    None, TOPK))
    # bench.py's IVF batch: retrieve at B = 1024 with aux built once
    aux = build_ivf_aux(cfg, state)
    paths["ivf_v3r_b1024_aux"] = lambda: port.retrieve(
        cfg, state, queries[:1024], None, TOPK, aux=aux)
    out = {}
    for name, fn in paths.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        # kernels only: operator rows carry their kernels' time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
        top = sorted(events, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        # the port's own kernels (coarse and select passes) in any case
        port_rows = [e for e in events if "namespace)::" in e.key
                     and ("ivf_" in e.key or "flat_blockmax" in e.key)]

        def row(e):
            return (e.key[:60], e.self_device_time_total / 1e3 / reps,
                    e.count // reps)
        out[name] = dict(
            wall_ms=wall_ms, device_ms=dev_ms, busy=dev_ms / wall_ms,
            top=[row(e) for e in top], port=[row(e) for e in port_rows])
        log(f"profile {name}: wall {wall_ms:.3f} ms/call, device "
            f"{dev_ms:.3f} ms/call, busy {dev_ms / wall_ms:.2f}")
        for key, ms, n in out[name]["top"]:
            log(f"    {ms:9.4f} ms  x{n:<3d} {key}")
        for key, ms, n in out[name]["port"]:
            log(f"    port {ms:9.4f} ms  x{n:<3d} {key}")
    return out


def engine_state(dev, cfg, n_eval, n_live, stats):
    """The engine phase's bank, from its seed: bulk_load, a write, the
    index rebuild, then a write of n_live rows on the live index (timed
    into `stats`); returns (state, the n_eval queries)."""
    import torch
    import aura_snn_rag_tpu_torch as port

    N, D = cfg.max_memories, cfg.feature_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    feats, centers = make_data(dev, gen, N, D)
    pick = torch.randint(0, N, (n_eval,), device=dev, generator=gen)
    queries = feats[pick] + 0.5 * torch.randn(n_eval, D, device=dev,
                                              generator=gen)
    zeros = torch.zeros(N, cfg.spatial_dims, device=dev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = port.init_memory_state(cfg, dev)
    state = port.bulk_load(cfg, state, feats[:N - n_live], zeros[:N - n_live])
    state = port.write_memories(cfg, state, feats[N - n_live:],
                                zeros[:n_live])
    torch.cuda.synchronize()
    stats["ingest_s"] = time.perf_counter() - t0
    check(int(state.count) == N, "count after ingest")
    del feats

    t0 = time.perf_counter()
    state = port.rebuild_centroids(cfg, state,
                                   torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    stats["index_build_s"] = time.perf_counter() - t0
    check(bool(state.index_ready), "index_ready after rebuild")
    live = state.cluster_slot[state.cluster_slot >= 0].numel()
    stats["indexed_rows"] = live
    log(f"engine: ingest {stats['ingest_s']:.3f} s, rebuild "
        f"{stats['index_build_s']:.3f} s, {live} of {N} rows in buckets")

    # a write on the live index: overwrites FIFO slots 0..n_live-1
    fresh = centers[torch.randint(0, len(centers), (n_live,), device=dev,
                                  generator=gen)]
    fresh += torch.randn(n_live, D, device=dev, generator=gen)
    t0 = time.perf_counter()
    state = port.write_memories(cfg, state, fresh, zeros[:n_live])
    torch.cuda.synchronize()
    stats["live_write_s"] = time.perf_counter() - t0
    check(int(state.count) == N + n_live, "count after live write")
    return state, queries


def engine_phase(dev, cfg_kw, n_eval, n_live, profile=False):
    import torch
    import aura_snn_rag_tpu_torch as port

    cfg = port.MemoryConfig(**cfg_kw)
    stats = {}
    state, queries = engine_state(dev, cfg, n_eval, n_live, stats)
    log(f"engine: live write of {n_live} rows {stats['live_write_s']:.3f} s")

    # exact oracle, 128 queries at a time
    qb = [queries[i:i + 128] for i in range(0, n_eval, 128)]
    res, dt = timed_batches(
        lambda b: port.retrieve_bruteforce(cfg, state, b, None, TOPK), qb)
    exact = torch.cat([r.indices for r in res])
    stats["bruteforce_qps"] = n_eval / dt

    for strategy in ("scan", "blockmax"):
        c = dataclasses.replace(cfg, flat_strategy=strategy)
        batch = [queries[:1024]]
        port.retrieve_flat(c, state, batch[0], None, TOPK)       # warm-up
        res, dt = timed_batches(
            lambda b: port.retrieve_flat(c, state, b, None, TOPK), batch * 3)
        r = res[-1]
        check(torch.isfinite(r.scores).all().item(), f"{strategy} finite")
        check(tuple(r.indices.shape) == (1024, TOPK), f"{strategy} shape")
        stats[f"flat_{strategy}_qps"] = 3 * 1024 / dt
        stats[f"flat_{strategy}_recall_at_10"] = recall_at_k(
            r.indices, exact[:1024])
        if strategy == "scan":
            scan_result = r
        log(f"engine: retrieve_flat {strategy} B=1024: "
            f"{stats[f'flat_{strategy}_qps']:.1f} QPS, recall@10 "
            f"{stats[f'flat_{strategy}_recall_at_10']:.4f}")

    # the scan's three options: PyTorch ops and no kernel, as XLA ops in
    # the JAX package. The exact and the wide funnel run the default scan
    # in the port (its funnel already is an exact top-kk), so they are
    # held equal to its result and not timed again; the rescue is timed,
    # with recall at least the default scan's
    for name, kw in FLAT_OPTIONS.items():
        c = dataclasses.replace(cfg, flat_strategy="scan", **kw)
        if name != "rescue":
            r = port.retrieve_flat(c, state, queries[:1024], None, TOPK)
            same = all(torch.equal(getattr(r, f), getattr(scan_result, f))
                       for f in ("indices", "scores", "features"))
            stats[f"flat_scan_{name}_equals_default"] = same
            log(f"engine: retrieve_flat scan with {kw} B=1024 equals the "
                f"default scan's result: {same}")
            check(same, f"scan {name} differs from the default scan")
            continue
        batch = [queries[:1024]]
        port.retrieve_flat(c, state, batch[0], None, TOPK)       # warm-up
        res, dt = timed_batches(
            lambda b: port.retrieve_flat(c, state, b, None, TOPK), batch * 3)
        r = res[-1]
        check(torch.isfinite(r.scores).all().item(), f"scan {name} finite")
        check(tuple(r.indices.shape) == (1024, TOPK), f"scan {name} shape")
        key = f"flat_scan_{name}"
        stats[f"{key}_qps"] = 3 * 1024 / dt
        stats[f"{key}_recall_at_10"] = recall_at_k(r.indices, exact[:1024])
        log(f"engine: retrieve_flat scan with {kw} B=1024: "
            f"{stats[f'{key}_qps']:.1f} QPS, recall@10 "
            f"{stats[f'{key}_recall_at_10']:.4f}")
        check(stats[f"{key}_recall_at_10"]
              >= stats["flat_scan_recall_at_10"],
              f"scan {name} recall {stats[f'{key}_recall_at_10']} below "
              f"the default scan's {stats['flat_scan_recall_at_10']}")

    # each IVF path in the order v3r, v2, v3 and again in v3, v2, v3r
    # (keys ending "_rev"), to tell an order effect from a path's own cost
    for suffix, kerns in (("", IVF_KERNELS), ("_rev", IVF_KERNELS[::-1])):
        for kern in kerns:
            c = dataclasses.replace(cfg, ivf_kernel=kern)
            for B in (1, 8):
                n = n_eval if B == 8 else 128
                batches = [queries[i:i + B] for i in range(0, n, B)]
                port.retrieve_auto(c, state, batches[0], None, TOPK)
                res, dt = timed_batches(
                    lambda b: port.retrieve_auto(c, state, b, None, TOPK),
                    batches)
                idx = torch.cat([r.indices for r in res])
                check(torch.isfinite(torch.cat([r.scores for r in res]))
                      .all().item(), f"ivf {kern} finite")
                check(tuple(idx.shape) == (n, TOPK), f"ivf {kern} shape")
                key = f"ivf_{kern}_b{B}"
                stats[f"{key}_qps{suffix}"] = n / dt
                stats[f"{key}_recall_at_10{suffix}"] = recall_at_k(
                    idx, exact[:n])
                log(f"engine: retrieve_auto (IVF {kern}) B={B}{suffix}: "
                    f"{stats[f'{key}_qps{suffix}']:.1f} QPS, recall@10 "
                    f"{stats[f'{key}_recall_at_10{suffix}']:.4f} over {n} "
                    f"queries")

    # IVF v1: with query locations (all rows sit at the origin, so the
    # spatial term is the same for every row and the ranking is cosine's)
    batches = [queries[i:i + 8] for i in range(0, n_eval, 8)]
    loc = torch.zeros(8, cfg.spatial_dims, device=dev)
    port.retrieve(cfg, state, batches[0], loc, TOPK)             # warm-up
    res, dt = timed_batches(
        lambda b: port.retrieve(cfg, state, b, loc, TOPK), batches)
    stats["ivf_v1_b8_qps"] = n_eval / dt
    stats["ivf_v1_b8_recall_at_10"] = recall_at_k(
        torch.cat([r.indices for r in res]), exact)
    log(f"engine: retrieve with locations (IVF v1) B=8: "
        f"{stats['ivf_v1_b8_qps']:.1f} QPS, recall@10 "
        f"{stats['ivf_v1_b8_recall_at_10']:.4f}")

    for key in ("flat_scan_recall_at_10", "flat_blockmax_recall_at_10"):
        check(stats[key] >= 0.99, f"{key} = {stats[key]} < 0.99")
    for key in [f"ivf_{kern}_b{B}_recall_at_10{suffix}"
                for kern in IVF_KERNELS for B in (1, 8)
                for suffix in ("", "_rev")] + ["ivf_v1_b8_recall_at_10"]:
        check(stats[key] >= 0.98, f"{key} = {stats[key]} < 0.98")
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        stats["profile"] = profile_paths(cfg, state, queries)
    return stats


def host_api_phase(dev, max_memories=65_536, batch=512, n_batches=4):
    import torch
    import aura_snn_rag_tpu_torch as port

    h = port.HippocampalFormation(max_memories=max_memories, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    feats, _ = make_data(dev, gen, batch * n_batches, h.config.feature_dim,
                         n_centers=64)
    rebuilds = 0
    for i in range(n_batches):
        h.write_batch([f"h{j}" for j in range(i * batch, (i + 1) * batch)],
                      feats[i * batch:(i + 1) * batch])
        rebuilds += h._writes_since_rebuild == 0
    check(rebuilds >= 1 and h.index_ready, "no automatic rebuild ran")
    for j in (3, 700, 2000):
        hits = h.retrieve_similar_memories(feats[j], k=5)
        check(hits and hits[0][0] == f"h{j}", f"host API self-hit {j}")
        hits = h.retrieve_similar_memories(feats[j], location=[0.0, 0.0],
                                           k=5)
        check(hits and hits[0][0] == f"h{j}",
              f"host API self-hit with location {j}")
    log(f"host API: {h.memory_count} memories, {rebuilds} automatic "
        f"rebuilds, self-retrieval ok with and without a location")
    return rebuilds


# --------------------------------------------------------------------------
# LM phase
# --------------------------------------------------------------------------

def lm_bank(dev, mcfg):
    """get_full_config's bank at full size: bench.py's data recipe drawn on
    the card, bulk_load, then the index rebuild."""
    import torch
    import aura_snn_rag_tpu_torch as port
    gen = torch.Generator(device=dev).manual_seed(2)
    feats, _ = make_data(dev, gen, mcfg.max_memories, mcfg.feature_dim)
    state = port.init_memory_state(mcfg, dev)
    state = port.bulk_load(mcfg, state, feats, torch.zeros(
        mcfg.max_memories, mcfg.spatial_dims, device=dev))
    state = port.rebuild_centroids(mcfg, state,
                                   torch.Generator().manual_seed(0))
    check(bool(state.index_ready)
          and int(state.active_count()) > mcfg.k_centroids,
          "LM bank: index not ready")
    return state


def synced(fn):
    """(result, seconds) of fn() between two device syncs."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def set_retrieve_fn(model, fn):
    for layer in model.layers:
        layer.retrieve_fn = fn


def serve_requests(server, reqs):
    """Every request through `submit` while `serve_forever` runs; the loop
    stops once every future is done. Returns (outputs, [(batch size,
    tokens decoded, seconds)] per batch, seconds)."""
    import asyncio
    batches = []
    inner = server.generate_batch

    def recording(batch):
        out, seconds = synced(lambda: inner(batch))
        batches.append((len(batch), server._bucket(
            max(r.max_new_tokens for r in batch)), seconds))
        return out

    async def run():
        task = asyncio.create_task(server.serve_forever())
        try:
            return await asyncio.gather(*[
                server.submit(ids, n, temp, 0.9) for ids, n, temp in reqs])
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    server.generate_batch = recording
    try:
        outs, seconds = synced(lambda: asyncio.run(run()))
    finally:
        del server.generate_batch
    return outs, batches, seconds


def decode_ms(model, ids, gen, state, steps=DECODE_STEPS, **kw):
    """Device-synced ms per decode step at ids' batch through `generate`:
    (time of 1 + steps tokens - time of 1 token) / steps, after a
    warm-up."""
    from aura_snn_rag_tpu_torch.generation import generate
    kw = dict(dict(memory_state=state, use_memory=state is not None), **kw)
    generate(model, ids, 2, gen, **kw)
    _, t1 = synced(lambda: generate(model, ids, 1, gen, **kw))
    _, tn = synced(lambda: generate(model, ids, 1 + steps, gen, **kw))
    return (tn - t1) / steps * 1e3


def profile_decode(model, ids, state, gen, reps=4):
    """torch.profiler over `reps` decode steps at ids' batch (prefill
    outside the window): wall and device ms per step, busy share, and the
    share of each step spent inside `retrieve_auto` (host time in the
    scope; the engine's function is wrapped in a record_function scope for
    the window only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from aura_snn_rag_tpu_torch.generation.sampler import sample_token
    from aura_snn_rag_tpu_torch.memory import engine

    B, L = ids.shape
    real = engine.retrieve_auto

    def scoped(*a, **kw):
        with record_function("retrieve_auto"):
            return real(*a, **kw)

    def step(tok, pos, caches):
        out, caches = model(tok[:, None], memory_state=state,
                            positions=torch.full((B, 1), pos,
                                                 device=ids.device),
                            kv_caches=caches, cache_index=pos)
        return sample_token(gen, out.logits[:, 0], 0.8, 50, 0.9), caches

    with torch.no_grad():
        caches = model.init_kv_caches(B, model.config.max_seq_len)
        out, caches = model(ids, memory_state=state, kv_caches=caches,
                            cache_index=0)
        tok = out.logits[:, -1].argmax(-1)
        tok, caches = step(tok, L, caches)             # warm-up
        torch.cuda.synchronize()
        engine.retrieve_auto = scoped
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(reps):
                    tok, caches = step(tok, L + 1 + i, caches)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        finally:
            engine.retrieve_auto = real
    rows = prof.key_averages()
    # kernels only: the scope's own row spans its device time again
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key != "retrieve_auto"]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    ret = [e for e in rows if e.key == "retrieve_auto"
           and e.device_type == DeviceType.CPU]
    ret_ms = ret[0].cpu_time_total / 1e3 / reps if ret else None
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    port_b = [e for e in kernels if "ivf_" in e.key
              and "namespace)::" in e.key]
    res = dict(wall_ms=wall_ms, device_ms=dev_ms, busy=dev_ms / wall_ms,
               retrieve_auto_host_ms=ret_ms,
               retrieve_auto_share=None if ret_ms is None
               else ret_ms / wall_ms,
               kernel_launches_per_step=sum(e.count for e in kernels) / reps,
               top=[(e.key[:60], e.self_device_time_total / 1e3 / reps,
                     e.count // reps) for e in top],
               kernel_B=[(e.key[:60], e.self_device_time_total / 1e3 / reps,
                          e.count // reps) for e in port_b])
    log(f"profile decode B={B}: wall {wall_ms:.3f} ms/step, device "
        f"{dev_ms:.3f} ms/step, busy {dev_ms / wall_ms:.3f}, retrieve_auto "
        f"host {ret_ms} ms/step, {res['kernel_launches_per_step']:.0f} "
        f"kernels/step")
    for key, ms, n in res["top"] + res["kernel_B"]:
        log(f"    {ms:9.4f} ms  x{n:<4d} {key}")
    return res


def greedy_cached_vs_recompute(model, ids, n=8):
    """KV-cached greedy decode (top_k = 1) against recomputing the whole
    prefix for each token, without memory (the retrieval query is the
    mean of the chunk, which the two schedules take over different
    chunks). Returns (identical, smallest top-2 logit gap of the
    recompute)."""
    import torch
    from aura_snn_rag_tpu_torch.generation import generate
    L = ids.shape[1]
    got = generate(model, ids, n, None, top_k=1, repetition_penalty=1.0)
    seq, gaps = ids, []
    with torch.no_grad():
        for _ in range(n):
            out, _ = model(seq, use_memory=False)
            top2 = torch.topk(out.logits[:, -1], 2).values
            gaps.append(float(top2[0, 0] - top2[0, 1]))
            seq = torch.cat([seq, out.logits[:, -1].argmax(-1)[:, None]], 1)
    return bool(torch.equal(got[:, L:], seq[:, L:])), min(gaps)


def kernel_vs_plain_prefill(model, ids, state):
    """One prefill at ids' batch through the engine (kernel B), then the
    same prefill with a retrieve_fn that runs the same retrieval with
    kernel B's plain version. Returns (max |logit difference|, how many
    of the retrieved slots differ, layers x rows x k)."""
    import torch
    from aura_snn_rag_tpu_torch.memory import engine
    from aura_snn_rag_tpu_torch.ops.cuda import ivf_scan

    real_auto, real_kernel = engine.retrieve_auto, engine.ivf_retrieve_fused
    got = {"kernel": [], "plain": []}

    def recording(*a, **kw):
        res = real_auto(*a, **kw)
        got["kernel"].append(res.indices)
        return res

    def plain(cfg, st, q, k):
        engine.ivf_retrieve_fused = ivf_scan.ivf_retrieve_fused_plain
        try:
            res = real_auto(cfg, st, q, None, k)
        finally:
            engine.ivf_retrieve_fused = real_kernel
        got["plain"].append(res.indices)
        return res

    with torch.no_grad():
        engine.retrieve_auto = recording
        try:
            a, _ = model(ids, memory_state=state)
        finally:
            engine.retrieve_auto = real_auto
        set_retrieve_fn(model, plain)
        try:
            b, _ = model(ids, memory_state=state)
        finally:
            set_retrieve_fn(model, None)
    ka, kb = torch.stack(got["kernel"]), torch.stack(got["plain"])
    return ((a.logits - b.logits).abs().max().item(),
            int((ka != kb).sum()), ka.numel())


def lm_requests(vocab, g):
    """Phase 4's N_REQUESTS requests (prompt ids, max_new_tokens,
    temperature), drawn from the CPU generator `g`."""
    import torch
    return [(torch.randint(0, vocab,
                           (int(torch.randint(5, 65, (1,), generator=g)),),
                           generator=g).numpy(),
             int(torch.randint(8, 65, (1,), generator=g)),
             float(0.5 + torch.rand(1, generator=g))) for _ in range(
                 N_REQUESTS)]


def lm_phase(dev, profile=False):
    """The LM's serving path at get_full_config(); see the module doc."""
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.generation import (
        BatchedGenerator, GenerationRequest)
    from aura_snn_rag_tpu_torch.memory import engine
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    from aura_snn_rag_tpu_torch.services import one_shot

    cfg = port.get_full_config()
    mcfg, n_layers = cfg.memory, cfg.model.num_layers
    stats = {}
    model = port.SNNRAGTransformer.create(
        cfg.model, mcfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(7))
    stats["params"] = sum(p.numel() for p in model.parameters())
    state, stats["bank_s"] = synced(lambda: lm_bank(dev, mcfg))
    log(f"LM: {stats['params']} parameters, bank of {mcfg.max_memories} x "
        f"{mcfg.feature_dim} with K={mcfg.k_centroids}, C="
        f"{mcfg.bucket_capacity}, probe {mcfg.probe_centroids} built in "
        f"{stats['bank_s']:.2f} s")
    g = torch.Generator().manual_seed(11)          # request contents
    counts = _build.launch_counts

    def b_launches():
        return counts["ivf_retrieve_fused"]

    # 1. 11 requests through the server under asyncio
    reqs = lm_requests(cfg.model.vocab_size, g)
    server = BatchedGenerator(model, memory_state=state,
                              generator=torch.Generator(device=dev)
                              .manual_seed(3), **LM_SERVE)
    n0 = b_launches()
    outs, batches, serve_s = serve_requests(server, reqs)
    want = n_layers * sum(tokens for _, tokens, _ in batches)
    check(b_launches() - n0 == want,
          f"LM serving: kernel B launched {b_launches() - n0} times, "
          f"expected 12 x (1 + steps) per batch = {want} ({batches})")
    for out, (ids, n, _) in zip(outs, reqs):
        check(out.shape == (n,) and ((out >= 0)
                                     & (out < cfg.model.vocab_size)).all(),
              f"LM serving: output {out.shape} for {n} tokens")
    check([b for b, _, _ in batches] == [8, 3],
          f"LM serving: batches {batches}, expected 8 then 3")
    stats["serve"] = dict(requests=len(reqs), batches=batches, seconds=serve_s,
                          tokens=server.stats["tokens"],
                          tokens_per_s=server.stats["tokens"] / serve_s,
                          kernel_B_launches=want)
    log(f"LM serving: {len(reqs)} requests in batches {batches} (size, "
        f"tokens, s) in {serve_s:.2f} s, {server.stats['tokens']} tokens "
        f"returned, kernel B launched {want} = {n_layers} x (1 + steps) "
        f"per batch")

    # 2. one batch again with bf16 weights
    bserver = BatchedGenerator(model, memory_state=state,
                               weights_dtype="bfloat16",
                               generator=torch.Generator(device=dev)
                               .manual_seed(4), **LM_SERVE)
    check(all(p.dtype == torch.bfloat16 for p in bserver.model.parameters()),
          "bf16 server holds f32 weights")
    n0 = b_launches()
    breqs = [GenerationRequest(ids, n, t) for ids, n, t in reqs[:8]]
    bouts, bf16_s = synced(lambda: bserver.generate_batch(breqs))
    want_b = n_layers * bserver._bucket(max(r.max_new_tokens for r in breqs))
    check(b_launches() - n0 == want_b,
          f"LM bf16 batch: kernel B launched {b_launches() - n0} times, "
          f"expected {want_b}")
    check([o.shape for o in bouts] == [(r.max_new_tokens,) for r in breqs],
          "LM bf16 batch: output shapes")
    stats["serve_bf16_weights"] = dict(seconds=bf16_s,
                                       kernel_B_launches=want_b)
    log(f"LM bf16-weight batch: {bf16_s:.2f} s, kernel B launched {want_b}")

    # 3. KV-cached greedy decode against the full-prefix recompute, B = 1
    ids1 = torch.randint(0, cfg.model.vocab_size, (1, 16), generator=g) \
        .to(dev)
    same, gap = greedy_cached_vs_recompute(model, ids1)
    check(same, f"LM: cached greedy decode differs from the recompute "
          f"(smallest top-2 gap {gap})")
    stats["greedy_cached_equals_recompute"] = same
    stats["greedy_min_top2_gap"] = gap
    log(f"LM: cached greedy decode of 8 tokens at B=1 equals the full "
        f"recompute (smallest top-2 logit gap {gap:.4f})")

    # 4. a prefill at B = 8 through kernel B and through its plain version
    ids8 = torch.randint(0, cfg.model.vocab_size,
                         (LM_SERVE["batch_size"], LM_SERVE["prompt_pad"]),
                         generator=g).to(dev)
    gap_logit, slot_diff, n_slots = kernel_vs_plain_prefill(model, ids8,
                                                            state)
    check(gap_logit <= LM_LOGIT_TOL,
          f"LM prefill: kernel B vs plain logits differ by {gap_logit} > "
          f"{LM_LOGIT_TOL} ({slot_diff} of {n_slots} slots differ)")
    stats["kernel_vs_plain_max_logit_diff"] = gap_logit
    stats["kernel_vs_plain_slots_differ"] = slot_diff
    log(f"LM prefill B=8 L=64: kernel B vs its plain version: max logit "
        f"diff {gap_logit:.3g} (tolerance {LM_LOGIT_TOL}), {slot_diff} of "
        f"{n_slots} retrieved slots differ")

    # 5. one-shot memorisation on a HippocampalFormation
    hippo = port.HippocampalFormation(mcfg, device=dev)
    mid, out = one_shot.one_shot_memorize_and_generate(
        model, hippo, torch.randint(0, cfg.model.vocab_size, (32,),
                                    generator=g),
        torch.randint(0, cfg.model.vocab_size, (8,), generator=g),
        max_new_tokens=8)
    check(hippo.memory_count == 1 and out.shape == (1, 16)
          and mid.startswith("oneshot-"), "one_shot_memorize_and_generate")
    log(f"LM: one_shot_memorize_and_generate wrote {mid}, generated "
        f"{tuple(out.shape)}")
    del hippo

    # 6. timings at B = 8
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        caches = model.init_kv_caches(*ids8.shape[:1],
                                      cfg.model.max_seq_len)
        prefill = [synced(lambda: model(ids8, memory_state=state,
                                        kv_caches=caches,
                                        cache_index=0))[1]
                   for _ in range(4)][1:]
    stats["prefill_ms_b8_l64"] = 1e3 * sum(prefill) / len(prefill)
    aux = engine.build_ivf_aux(mcfg, state)
    # decode variants, each in two rounds (in this order, then reversed):
    # the host's pace moves from run to run
    variants = {
        "f32_weights": (model, state, None),
        "bf16_weights": (bserver.model, state, None),
        # the dispatch's host sync taken out (retrieve directly)
        "no_dispatch_sync": (model, state, lambda c, s, q, k:
                             engine.retrieve(c, s, q, None, k)),
        # the sync and the per-call aux rebuild taken out
        "no_sync_aux_cached": (model, state, lambda c, s, q, k:
                               engine.retrieve(c, s, q, None, k, aux=aux)),
        "no_memory": (model, None, None),
    }
    runs = {name: [] for name in variants}
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            m, st, fn = variants[name]
            set_retrieve_fn(m, fn)
            try:
                runs[name].append(decode_ms(m, ids8, gen, st))
            finally:
                set_retrieve_fn(m, None)
    for name, ms in runs.items():
        stats[f"decode_ms_b8_{name}"] = ms
    for w in ("f32", "bf16"):
        stats[f"tokens_per_s_b8_{w}_weights"] = [
            LM_SERVE["batch_size"] * 1e3 / ms
            for ms in runs[f"{w}_weights"]]
    log(f"LM timings: prefill_ms_b8_l64 {stats['prefill_ms_b8_l64']:.3f}; "
        "decode ms/step at B=8 (two rounds): " + ", ".join(
            f"{name} {ms[0]:.3f} / {ms[1]:.3f}" for name, ms in runs.items()))
    stats["profile"] = profile_decode(model, ids8, state, gen) \
        if profile else None
    return stats


# --------------------------------------------------------------------------
# training phase
# --------------------------------------------------------------------------

def train_config():
    import aura_snn_rag_tpu_torch as port
    cfg = port.get_full_config()
    return cfg.replace(training=dataclasses.replace(cfg.training,
                                                    **TRAIN_CHANGES))


def grads_kernel_vs_plain(model, tcfg, ids, state):
    """One micro-batch's loss and gradients (no prosody, no dropout)
    through kernel B and its Function's backward, then through kernel B's
    plain version with autograd through its einsum (the retrieve_fn hook
    swaps the engine's Function for it). Returns (loss kernel, loss
    plain, {name: (RMS of the gap, RMS of the plain gradient, max |gap|,
    max |plain gradient|)}, [max |query_proj grad| per layer], kernel B
    launches in the kernel run and in the plain run)."""
    from aura_snn_rag_tpu_torch.memory import engine
    from aura_snn_rag_tpu_torch.ops.cuda import _build, ivf_scan
    from aura_snn_rag_tpu_torch.training.losses import hippocampal_loss

    def zero_grads():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.zero_()

    def run():
        zero_grads()
        out, _ = model(ids, memory_state=state)
        loss = hippocampal_loss(
            out.logits[:, :-1], ids[:, 1:], out.place_activity,
            label_smoothing=tcfg.label_smoothing,
            entropy_lambda=tcfg.entropy_lambda,
            sparsity_lambda=tcfg.sparsity_lambda,
            target_sparsity=tcfg.target_sparsity)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    real_fn = engine.ivf_retrieve_fused_grad

    def plain_autograd(cl, aux, f, strength, w, qn, top_c, kk, k, fused):
        return ivf_scan.ivf_retrieve_fused_plain(cl, aux, f, qn, top_c, kk,
                                                 k)

    def plain(cfg, st, q, k):
        engine.ivf_retrieve_fused_grad = plain_autograd
        try:
            return engine.retrieve_auto(cfg, st, q, None, k)
        finally:
            engine.ivf_retrieve_fused_grad = real_fn

    n0 = _build.launch_counts["ivf_retrieve_fused"]
    la, ga = run()
    n1 = _build.launch_counts["ivf_retrieve_fused"]
    set_retrieve_fn(model, plain)
    try:
        lb, gb = run()
    finally:
        set_retrieve_fn(model, None)
    n2 = _build.launch_counts["ivf_retrieve_fused"]
    zero_grads()

    def rms(x):
        return x.float().pow(2).mean().sqrt().item()
    stats = {name: (rms(ga[name] - gb[name]), rms(gb[name]),
                    (ga[name] - gb[name]).abs().max().item(),
                    gb[name].abs().max().item()) for name in ga}
    qp = [ga[f"layers.{i}.query_proj.weight"].abs().max().item()
          for i in range(len(model.layers))]
    return la, lb, stats, qp, (n1 - n0, n2 - n1)


def grad_check(model, tcfg, micro_batches, state):
    """grads_kernel_vs_plain on each micro-batch, with its checks (see
    TRAIN_GRAD_RTOL): the loss, kernel B's launches, every query_proj
    gradient nonzero, and each tensor's RMS gap. Returns the summaries."""
    n_layers = len(model.layers)
    out = []
    for i, ids in enumerate(micro_batches):
        la, lb, st, qp, (nk, npl) = grads_kernel_vs_plain(model, tcfg, ids,
                                                          state)
        rms_floor = 1e-3 * max(v[1] for v in st.values())
        max_floor = 1e-3 * max(v[3] for v in st.values())
        rel = {n: v[0] / max(v[1], rms_floor) for n, v in st.items()}
        peak = {n: v[2] / max(v[3], max_floor) for n, v in st.items()}
        worst, worst_peak = max(rel, key=rel.get), max(peak, key=peak.get)
        q_rel = max(rel[f"layers.{j}.query_proj.weight"]
                    for j in range(n_layers))
        check(nk == n_layers and npl == 0,
              f"gradient check {i}: kernel B launched {nk} / {npl} times")
        check(abs(la - lb) <= TRAIN_LOSS_RTOL * abs(lb),
              f"gradient check {i}: loss {la} through kernel B, {lb} through "
              f"its plain version")
        check(all(x > 0 for x in qp),
              f"gradient check {i}: a query_proj gradient is zero ({qp})")
        check(rel[worst] <= TRAIN_GRAD_RTOL,
              f"gradient check {i}: {worst}'s gradients through kernel B and "
              f"its plain version differ by {rel[worst]:.3g} of their RMS "
              f"(tolerance {TRAIN_GRAD_RTOL})")
        log(f"training: micro-batch {i} through kernel B and its plain "
            f"version: loss {la:.6f} / {lb:.6f}; RMS gap at most "
            f"{rel[worst]:.3g} of a tensor's RMS ({worst}; query_proj "
            f"{q_rel:.3g}; tolerance {TRAIN_GRAD_RTOL}); largest entry gap "
            f"{peak[worst_peak]:.3g} of a tensor's largest entry "
            f"({worst_peak}); |query_proj grad| max per layer "
            f"{[f'{x:.3g}' for x in qp]}")
        out.append(dict(loss_kernel=la, loss_plain=lb,
                        max_rms_gap=rel[worst], worst=worst,
                        query_proj_max_rms_gap=q_rel,
                        max_entry_gap=peak[worst_peak],
                        worst_entry=worst_peak, query_proj_max_abs=qp))
    return out


def time_train_steps(trainer, ids, use_memory, retrieve_fn=None,
                     steps=TRAIN_TIMED):
    """ms per optimizer step and peak device memory (GB) of the step
    `train_step` runs (`Trainer._run_step`, no store), with memory forced
    on or off: at random weights the thalamus gate turns memory off after
    step 0. One warm-up step, then `steps` steps between two syncs; with
    `retrieve_fn` the RAG layers retrieve through it."""
    import torch
    set_retrieve_fn(trainer.model, retrieve_fn)
    try:
        trainer._run_step(ids, ids, use_memory, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer._run_step(ids, ids, use_memory, False)
        torch.cuda.synchronize()
    finally:
        set_retrieve_fn(trainer.model, None)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return ms, torch.cuda.max_memory_allocated() / 1e9


def profile_train(trainer, ids, reps=2):
    """torch.profiler over `reps` optimizer steps with memory on: wall
    and device ms per step, busy share, kernel launches per step, and the
    host time inside `retrieve_auto` (wrapped in a record_function scope
    for the window only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from aura_snn_rag_tpu_torch.memory import engine

    real = engine.retrieve_auto

    def scoped(*a, **kw):
        with record_function("retrieve_auto"):
            return real(*a, **kw)

    trainer._run_step(ids, ids, True, False)
    torch.cuda.synchronize()
    engine.retrieve_auto = scoped
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                trainer._run_step(ids, ids, True, False)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    finally:
        engine.retrieve_auto = real
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key != "retrieve_auto"]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    ret = [e for e in rows if e.key == "retrieve_auto"
           and e.device_type == DeviceType.CPU]
    ret_ms = ret[0].cpu_time_total / 1e3 / reps if ret else None
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    port_b = [e for e in kernels if "ivf_" in e.key
              and "namespace)::" in e.key]
    res = dict(wall_ms=wall_ms, device_ms=dev_ms, busy=dev_ms / wall_ms,
               retrieve_auto_host_ms=ret_ms,
               retrieve_auto_share=None if ret_ms is None
               else ret_ms / wall_ms,
               kernel_launches_per_step=sum(e.count for e in kernels) / reps,
               top=[(e.key[:60], e.self_device_time_total / 1e3 / reps,
                     e.count // reps) for e in top],
               kernel_B=[(e.key[:60], e.self_device_time_total / 1e3 / reps,
                          e.count // reps) for e in port_b])
    log(f"profile train step (memory on): wall {wall_ms:.1f} ms/step, "
        f"device {dev_ms:.1f} ms/step, busy {dev_ms / wall_ms:.3f}, "
        f"retrieve_auto host {ret_ms} ms/step, "
        f"{res['kernel_launches_per_step']:.0f} kernels/step")
    for key, ms, n in res["top"] + res["kernel_B"]:
        log(f"    {ms:9.4f} ms  x{n:<5d} {key}")
    return res


def train_phase(dev, profile=False):
    """The LM's training path at get_full_config() with TRAIN_CHANGES; see
    the module doc. Launch counters are zeroed by the caller just before
    the counted steps run (`train_steps`), so the count the caller reads
    after this phase holds them alone."""
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.memory import engine
    from aura_snn_rag_tpu_torch.ops.cuda import _build

    cfg = train_config()
    mcfg, n_layers = cfg.memory, cfg.model.num_layers
    tcfg = cfg.training
    accum = tcfg.gradient_accumulation_steps
    B, L = tcfg.batch_size, TRAIN_SEQ
    counts = _build.launch_counts
    stats = {"changes": TRAIN_CHANGES, "batch": B, "seq_len": L}
    log(f"training: get_full_config() with {TRAIN_CHANGES}; batch {B} x "
        f"{L} as {accum} micro-batches of {B // accum}")
    trainer = port.Trainer(cfg, seed=7, device=dev)
    state, stats["bank_s"] = synced(lambda: lm_bank(dev, mcfg))
    trainer.hippocampus.state = state
    stats["params"] = sum(p.numel() for p in trainer.model.parameters())
    g = torch.Generator(device=dev).manual_seed(12)
    ids = torch.randint(0, cfg.model.vocab_size, (B, L), device=dev,
                        generator=g)

    # 1. the counted run: TRAIN_STEPS train_steps on one repeated batch
    def bank_count():
        return int(trainer.hippocampus.state.count)

    _build.reset_launch_counts()
    steps = []
    for _ in range(TRAIN_STEPS):
        c0 = bank_count()
        m = trainer.train_step(ids, ids)
        steps.append(dict(step=m["step"], use_memory=m["use_memory"],
                          stored=bank_count() - c0))
    launches = dict(counts)
    losses = trainer.history["loss"][1:] + [trainer.latest_metrics()["loss"]]
    n_mem = sum(s["use_memory"] for s in steps)
    want_b = n_layers * accum * n_mem
    check(steps[0]["use_memory"], "training: step 0 took no memory")
    check(launches.get("ivf_retrieve_fused", 0) == want_b
          and all(launches.get(name, 0) == 0 for name in SOURCES
                  if name != "ivf_retrieve_fused"),
          f"training: launches {launches}, expected kernel B only, "
          f"{n_layers} x {accum} x {n_mem} = {want_b}")
    for s in steps:
        want = B if (s["use_memory"] and s["step"]
                     % tcfg.memory_store_interval == 0) else 0
        check(s["stored"] == want, f"training: step {s['step']} stored "
              f"{s['stored']} rows, expected {want}")
    check(all(math.isfinite(x) for x in losses),
          f"training: non-finite loss {losses}")
    check(losses[-1] < losses[0] and losses[-1] < losses[1],
          f"training: loss did not fall on the repeated batch {losses}")
    stats.update(steps=steps, losses=losses, launches=launches,
                 kernel_B_launches=want_b)
    log(f"training: {TRAIN_STEPS} train_steps, memory on at steps "
        f"{[s['step'] for s in steps if s['use_memory']]}, rows stored "
        f"{[s['stored'] for s in steps]}, kernel B launched "
        f"{launches.get('ivf_retrieve_fused', 0)} = {n_layers} x {accum} "
        f"x {n_mem}; losses {[round(x, 4) for x in losses]}")

    # 2. EWC consolidation on one micro-batch, through memory; then one
    # step with the penalty
    ids8 = ids[:B // accum]
    n0 = counts["ivf_retrieve_fused"]
    trainer.consolidate_ewc([(ids8, ids8)], use_memory=True)
    ewc_b = counts["ivf_retrieve_fused"] - n0
    check(ewc_b == n_layers, f"EWC: kernel B launched {ewc_b}, expected "
          f"{n_layers}")
    m = trainer.train_step(ids, ids)
    penalty = trainer.ewc.penalty(trainer.optimizer.flat).item()
    check(math.isfinite(m["loss"]) and math.isfinite(penalty),
          f"EWC step: loss {m['loss']}, penalty {penalty}")
    # 3. a sleep phase: time-reversed replay with memory off
    n0 = counts["ivf_retrieve_fused"]
    _, sleep_s = synced(trainer.sleep_phase)
    sleep_b = counts["ivf_retrieve_fused"] - n0
    check(sleep_b == 0, f"sleep phase launched kernel B {sleep_b} times")
    stats.update(ewc_kernel_B_launches=ewc_b, ewc_penalty=penalty,
                 sleep_s=sleep_s, sleep_kernel_B_launches=sleep_b,
                 sleep_steps=tcfg.sleep_replay_batches)
    log(f"training: EWC Fisher on one batch of {B // accum} through memory "
        f"(kernel B {ewc_b}), then a step with penalty {penalty:.4g}; sleep "
        f"phase of {tcfg.sleep_replay_batches} reversed replays in "
        f"{sleep_s:.2f} s (kernel B {sleep_b})")

    # 4. gradients through kernel B against its plain version, on each
    # micro-batch of the step
    state = trainer.hippocampus.state
    mb = B // accum
    stats["grad_check"] = grad_check(
        trainer.model, tcfg, [ids[i * mb:(i + 1) * mb] for i in range(accum)],
        state)

    # 5. timings, each with its peak device memory; "memory_no_sync"
    # retrieves without `retrieve_auto`'s host sync and with the aux built
    # once, as the LM phase's decode variant does
    aux = engine.build_ivf_aux(mcfg, trainer.hippocampus.state)
    timing = {}
    for name, use_memory, fn in (
            ("memory", True, None), ("no_memory", False, None),
            ("memory_no_sync", True, lambda c, s, q, k: engine.retrieve(
                c, s, q, None, k, aux=aux))):
        ms, gb = time_train_steps(trainer, ids, use_memory, fn)
        timing[name] = dict(ms_per_step=ms, tokens_per_s=B * L * 1e3 / ms,
                            max_memory_gb=gb)
    stats["profile"] = profile_train(trainer, ids) if profile else None
    del trainer
    torch.cuda.empty_cache()
    remat_cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, use_gradient_checkpointing=True,
        gradient_checkpoint_policy="full"))
    remat = port.Trainer(remat_cfg, seed=7, device=dev)
    remat.hippocampus.state = state
    ms, gb = time_train_steps(remat, ids, True)
    timing["memory_remat_full"] = dict(ms_per_step=ms,
                                       tokens_per_s=B * L * 1e3 / ms,
                                       max_memory_gb=gb)
    del remat
    torch.cuda.empty_cache()
    stats["timing"] = timing
    log(f"training timings (batch {B} x {L} as {accum} x {B // accum}): "
        + "; ".join(
        f"{name} {t['ms_per_step']:.1f} ms/step, {t['tokens_per_s']:.0f} "
        f"tokens/s, peak {t['max_memory_gb']:.2f} GB"
        for name, t in timing.items()))
    return stats


# --------------------------------------------------------------------------
# operator phase: ingest, train, checkpoint, resume, serve, the CLI
# --------------------------------------------------------------------------

@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (where an op has none it
    raises), without filling new tensors: main() sets the cuBLAS
    workspace this needs (`:4096:8`, the size PyTorch picks on sm_90)."""
    import torch
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def operator_config():
    """train_config() with dropout 0 and the thalamus and endocrine
    modulators off. A checkpoint holds, as the JAX package's, neither the
    dropout seed stream nor the modulators' last readings (the thalamus
    gate, the hormones), and a restored trainer starts them anew: so the
    original and the restored trainer take bit-equal steps only at
    dropout 0 and without those two gates. Without the thalamus gate
    (0.5 at random weights) memory is on at every step."""
    cfg = train_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=0.0),
        training=dataclasses.replace(cfg.training, enable_thalamus=False,
                                     enable_endocrine=False))


def synthetic_corpus(path, n, seed):
    """n distinct texts written to `path` as JSONL {"text": ...}: 8 to 40
    words drawn with Zipf weights from 20,000 random lowercase words,
    then the text's number. Returns the texts."""
    import numpy as np
    rng = np.random.RandomState(seed)
    letters = rng.randint(97, 123, (20_000, 10)).astype(np.uint8)
    lengths = rng.randint(3, 11, 20_000)
    vocab = [bytes(w[:k]).decode() for w, k in zip(letters, lengths)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    counts = rng.randint(8, 41, n)
    words = rng.choice(len(vocab), int(counts.sum()), p=p / p.sum())
    ends = np.cumsum(counts)
    texts = [" ".join(vocab[w] for w in words[e - c:e]) + f" ({i})"
             for i, (e, c) in enumerate(zip(ends, counts))]
    with open(path, "w") as f:
        for t in texts:
            f.write(json.dumps({"text": t}) + "\n")
    return texts


def ingest_phase(dev, tmp, counts, feature_dim):
    """The corpus through the CLI's `ingest` (rebuilds timed), embedding
    alone timed, and self-retrieval of OPERATOR_QUERIES ingested texts at
    B = 8. Returns (bank, stats)."""
    import numpy as np
    import torch
    from aura_snn_rag_tpu_torch import cli
    from aura_snn_rag_tpu_torch.memory.hippocampus import HippocampalFormation

    path = f"{tmp}/corpus.jsonl"
    texts, gen_s = synced(lambda: synthetic_corpus(path, OPERATOR_TEXTS, 21))
    rebuilds = []
    real = HippocampalFormation.rebuild_centroids

    def timed(self):
        _, s = synced(lambda: real(self))
        rebuilds.append(s)

    HippocampalFormation.rebuild_centroids = timed
    try:
        (hf, embedder, n), ingest_s = synced(lambda: cli.ingest(
            path, "jsonl", None, feature_dim, device=dev))
    finally:
        HippocampalFormation.rebuild_centroids = real
    check(embedder.native, "ingest: the hash embedder took its numpy path "
          "(the native library did not build or load)")
    check(n == hf.memory_count == OPERATOR_TEXTS,
          f"ingest: stored {n}, bank count {hf.memory_count}, expected "
          f"{OPERATOR_TEXTS}")
    check(hf.index_ready, "ingest: index not built")
    _, embed_s = synced(lambda: embedder.embed_batch(texts))

    pick = np.random.RandomState(5).choice(OPERATOR_TEXTS, OPERATOR_QUERIES,
                                           replace=False)
    q = torch.from_numpy(embedder.embed_batch([texts[i] for i in pick])) \
        .to(dev)
    want = torch.tensor([hf._id_to_slot[f"jsonl-{i}"] for i in pick],
                        device=dev)
    b0 = counts["ivf_retrieve_fused"]

    def query():
        return torch.cat([hf.retrieve_batch(q[i:i + 8]).indices[:, 0]
                          for i in range(0, OPERATOR_QUERIES, 8)])
    top1, query_s = synced(query)
    recall = float((top1 == want).float().mean())
    launches = counts["ivf_retrieve_fused"] - b0
    check(launches == OPERATOR_QUERIES // 8,
          f"ingest retrieval: kernel B launched {launches} times, expected "
          f"{OPERATOR_QUERIES // 8}")
    check(recall >= OPERATOR_RECALL, f"ingest: self-recall@1 {recall} < "
          f"{OPERATOR_RECALL}")
    stats = dict(texts=n, corpus_s=gen_s, ingest_s=ingest_s,
                 ingest_rows_per_s=n / ingest_s, embed_s=embed_s,
                 embed_rows_per_s=n / embed_s, rebuilds=len(rebuilds),
                 rebuild_s=sum(rebuilds), native_embedder=embedder.native,
                 self_recall_at_1=recall, queries=OPERATOR_QUERIES,
                 query_s=query_s, kernel_B_launches=launches)
    log(f"operator ingest: {n} texts in {ingest_s:.2f} s "
        f"({n / ingest_s:.0f} rows/s; {len(rebuilds)} rebuilds, "
        f"{sum(rebuilds):.2f} s), embedding alone {embed_s:.3f} s "
        f"({n / embed_s:.0f} rows/s, native), self-recall@1 {recall:.4f} "
        f"over {OPERATOR_QUERIES} queries at B=8 ({query_s:.2f} s, kernel "
        f"B {launches})")
    return hf, stats


def trainer_tensors(trainer):
    """Every tensor a checkpoint restores, by name, with `_step`."""
    from aura_snn_rag_tpu_torch.memory.state import MemoryState
    count, mu, nu = trainer.optimizer.state
    out = {"params": trainer.optimizer.flat, "count": count, "mu": mu,
           "nu": nu}
    out.update({f"memory_state.{k}": t for k, t in
                zip(MemoryState._fields, trainer.hippocampus.state)})
    out.update({f"cognitive_map.{i}": t for i, t in
                enumerate(trainer.hippocampus.cognitive_map)})
    for name in ("amygdala", "thalamus"):
        mod = getattr(trainer, name)
        if mod is not None:
            out.update({f"{name}.{k}": t for k, t in
                        mod.state_dict().items()})
    return out


def tensors_differ(a, b):
    """Names whose tensors are not equal bit for bit (dtype included),
    and `_step` when the steps differ."""
    import torch
    a_t, b_t = trainer_tensors(a), trainer_tensors(b)
    out = sorted(k for k in set(a_t) | set(b_t)
                 if k not in a_t or k not in b_t
                 or a_t[k].dtype != b_t[k].dtype
                 or not torch.equal(a_t[k], b_t[k]))
    return out + (["_step"] if a.state.step != b.state.step else [])


def views_flat(trainer):
    """True when every Parameter's storage lies inside optimizer.flat's."""
    flat = trainer.optimizer.flat
    lo = flat.data_ptr()
    hi = lo + flat.numel() * flat.element_size()
    return all(p.untyped_storage().data_ptr()
               == flat.untyped_storage().data_ptr()
               and lo <= p.data_ptr() < hi
               for p in trainer.model.parameters())


def cli_run(args, timeout):
    """stdout and seconds of `python -m aura_snn_rag_tpu_torch.cli args`
    from this checkout; a non-zero exit fails the phase."""
    from pathlib import Path
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "aura_snn_rag_tpu_torch.cli", *args],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=timeout)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f"cli {' '.join(args)}: exit "
          f"{out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout, seconds


def cli_serve(args, tmp, n_tokens, timeout):
    """`cli serve args --port 0` in a subprocess: one POST /generate for
    n_tokens and one GET /stats over a socket, then the server is
    terminated. Returns (generate status, tokens, stats status, stats,
    seconds to ready, seconds of the request)."""
    import http.client
    import queue
    import threading
    from pathlib import Path
    t0 = time.perf_counter()
    err = open(f"{tmp}/serve.err", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aura_snn_rag_tpu_torch.cli", "serve", *args,
         "--port", "0"], cwd=Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=err, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x)
                                              for x in proc.stdout],
                              daemon=True)
    reader.start()
    try:
        try:
            line = lines.get(timeout=timeout)
        except queue.Empty:
            line = ""
        if not line.startswith("serving on http://"):
            err.seek(0)
            raise CheckFailed(f"cli serve did not start (exit {proc.poll()})"
                              f": {line!r}\n{err.read()[-4000:]}")
        ready_s = time.perf_counter() - t0
        host, port = line.split("//", 1)[1].strip().rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        t1 = time.perf_counter()
        conn.request("POST", "/generate", json.dumps(
            {"prompt_ids": [5, 6, 7, 8], "max_new_tokens": n_tokens,
             "temperature": 0.8, "top_p": 0.9}))
        r = conn.getresponse()
        body = json.loads(r.read())
        request_s = time.perf_counter() - t1
        conn.close()
        conn.request("GET", "/stats")
        r2 = conn.getresponse()
        stats = json.loads(r2.read())
        conn.close()
        return (r.status, body.get("tokens"), r2.status, stats, ready_s,
                request_s)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
        err.close()


def operator_phase(dev, keep_dir=None):
    """The operator's path at get_full_config() (see the module doc):
    ingest, train, checkpoint and restore, resume, serve from the
    checkpoint, and the CLI in subprocesses. Launch counters are zeroed
    by the caller just before this phase and read just after it. The
    CLI's `--preset full` checkpoint directory is moved to `keep_dir`
    when one is given (phase 14 audits it)."""
    import shutil
    import tempfile
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.generation import BatchedGenerator
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager

    cfg = operator_config()
    mcfg, n_layers = cfg.memory, cfg.model.num_layers
    tcfg = cfg.training
    accum = tcfg.gradient_accumulation_steps
    counts = _build.launch_counts
    stats = {"steps": {}}
    tmp = tempfile.mkdtemp(prefix="aura_operator_")
    t_phase = time.perf_counter()

    def kernel_b():
        return counts["ivf_retrieve_fused"]

    try:
        # 1. ingest a corpus into the bank the preset's trainer holds
        hf, stats["ingest"] = ingest_phase(dev, tmp, counts,
                                           mcfg.feature_dim)
        check(hf.config == mcfg, f"ingest built {hf.config}, the preset's "
              f"bank is {mcfg}")
        stats["steps"]["ingest_s"] = stats["ingest"]["ingest_s"]

        # 2. train 2 steps with memory over the ingested bank, save,
        # restore into a fresh trainer
        trainer, t = synced(lambda: port.Trainer(cfg, seed=7, device=dev))
        trainer.hippocampus = hf
        g = torch.Generator(device=dev).manual_seed(13)
        ids = torch.randint(0, cfg.model.vocab_size,
                            (tcfg.batch_size, TRAIN_SEQ), device=dev,
                            generator=g)
        b0, c0 = kernel_b(), int(hf.state.count)

        def train(tr, n):
            return [tr.train_step(ids, ids) for _ in range(n)]
        ms, train_s = synced(lambda: train(trainer, OPERATOR_STEPS))
        launches = kernel_b() - b0
        want_b = n_layers * accum * OPERATOR_STEPS
        check(all(m["use_memory"] for m in ms) and launches == want_b,
              f"operator training: memory {[m['use_memory'] for m in ms]}, "
              f"kernel B launched {launches}, expected {n_layers} x {accum} "
              f"x {OPERATOR_STEPS} = {want_b}")
        stored = int(hf.state.count) - c0
        check(stored == tcfg.batch_size, f"operator training stored "
              f"{stored} rows, expected {tcfg.batch_size} (step 0)")
        loss = trainer.latest_metrics()["loss"]
        check(math.isfinite(loss), f"operator training: loss {loss}")
        stats["train"] = dict(steps=OPERATOR_STEPS, seconds=train_s,
                              trainer_init_s=t, kernel_B_launches=launches,
                              loss=loss, rows_stored=stored)
        stats["steps"]["train_s"] = train_s
        log(f"operator training: {OPERATOR_STEPS} train_steps with memory "
            f"over the ingested bank in {train_s:.2f} s (trainer built in "
            f"{t:.2f} s), kernel B {launches} = {n_layers} x {accum} x "
            f"{OPERATOR_STEPS}, loss {loss:.4f}")

        ckpt = CheckpointManager(f"{tmp}/ckpt")
        _, save_s = synced(lambda: ckpt.save(OPERATOR_STEPS, trainer, loss))
        nbytes = (os.path.getsize(ckpt.path(OPERATOR_STEPS))
                  + os.path.getsize(ckpt.meta_path(OPERATOR_STEPS)))
        restored = port.Trainer(cfg, seed=8, device=dev)
        step, restore_s = synced(lambda: ckpt.restore(restored))
        differ = tensors_differ(trainer, restored)
        check(step == OPERATOR_STEPS and restored.state.step == OPERATOR_STEPS
              and not differ, f"restore: step {step}, tensors that differ "
              f"{differ}")
        ids_equal = (restored.hippocampus.host_state_dict()["slot_ids"]
                     == hf.host_state_dict()["slot_ids"])
        check(ids_equal, "restore: slot ids differ")
        check(views_flat(restored), "restore: a parameter is no longer a "
              "view of the optimizer's flat buffer")
        # a corrupted copy (the first half of the file) raises and leaves
        # the trainer as it was
        bad = CheckpointManager(f"{tmp}/bad")
        with open(ckpt.path(OPERATOR_STEPS), "rb") as src, \
                open(bad.path(OPERATOR_STEPS), "wb") as dst:
            dst.write(src.read(os.path.getsize(ckpt.path(OPERATOR_STEPS))
                               // 2))
        shutil.copy(ckpt.meta_path(OPERATOR_STEPS),
                    bad.meta_path(OPERATOR_STEPS))
        try:
            bad.restore(restored)
            corrupt_raised = None
        except (RuntimeError, ValueError, OSError, EOFError) as e:
            corrupt_raised = type(e).__name__
        shutil.rmtree(f"{tmp}/bad")
        differ_after = tensors_differ(trainer, restored)
        check(corrupt_raised is not None and not differ_after,
              f"corrupt restore: raised {corrupt_raised}, tensors that "
              f"differ afterwards {differ_after}")
        stats["checkpoint"] = dict(
            save_s=save_s, restore_s=restore_s, bytes=nbytes,
            tensors_checked=len(trainer_tensors(trainer)),
            slot_ids_equal=ids_equal, views_flat=True,
            corrupt_copy_raised=corrupt_raised)
        stats["steps"].update(save_s=save_s, restore_s=restore_s)
        log(f"operator checkpoint: saved {nbytes} bytes in {save_s:.2f} s, "
            f"restored in {restore_s:.2f} s; "
            f"{len(trainer_tensors(trainer))} tensors, _step and slot ids "
            f"equal bit for bit, parameters view the flat buffer; a "
            f"truncated copy raised {corrupt_raised} and changed nothing")

        # 3. resume: one more step on each, at dropout 0 (the dropout
        # seed stream is not in the checkpoint, as in the JAX package),
        # under deterministic algorithms: by default the card's attention
        # backward sums with atomics, in an order that can differ between
        # two calls on the same inputs
        b0 = kernel_b()
        with deterministic():
            _, resume_s = synced(lambda: (trainer.train_step(ids, ids),
                                          restored.train_step(ids, ids)))
        la = trainer.latest_metrics()["loss"]
        lb = restored.latest_metrics()["loss"]
        differ = tensors_differ(trainer, restored)
        launches = kernel_b() - b0
        check(la == lb and not differ and launches == 2 * n_layers * accum,
              f"resume: loss {la} / {lb}, tensors that differ {differ}, "
              f"kernel B {launches}")
        stats["resume"] = dict(loss=la, loss_restored=lb, seconds=resume_s,
                               bit_equal=True, kernel_B_launches=launches)
        stats["steps"]["resume_s"] = resume_s
        log(f"operator resume: the next step of the original and the "
            f"restored trainer: loss {la:.6f} / {lb:.6f}, every tensor "
            f"equal bit for bit ({resume_s:.2f} s for both, kernel B "
            f"{launches})")

        # 4. serve from the checkpoint with its bank: greedy tokens equal
        # to the original trainer's model on the same prompts
        g = torch.Generator().manual_seed(17)
        reqs = [(torch.randint(0, cfg.model.vocab_size,
                               (int(torch.randint(5, 65, (1,), generator=g)),),
                               generator=g).numpy(), OPERATOR_NEW_TOKENS, 0.0)
                for _ in range(OPERATOR_REQUESTS)]
        outs = {}
        for name, tr in (("restored", restored), ("original", trainer)):
            tr.model.eval()
            server = BatchedGenerator(
                tr.model, memory_state=tr.hippocampus.state,
                generator=torch.Generator(device=dev).manual_seed(3),
                **LM_SERVE)
            b0 = kernel_b()
            out, batches, seconds = serve_requests(server, reqs)
            launches = kernel_b() - b0
            want = n_layers * sum(tokens for _, tokens, _ in batches)
            check(launches == want and [b for b, _, _ in batches]
                  == [OPERATOR_REQUESTS],
                  f"operator serving ({name}): batches {batches}, kernel B "
                  f"{launches}, expected 12 x (1 + steps) per batch = {want}")
            outs[name] = (out, batches, seconds, launches)
        same = all(a.shape == (OPERATOR_NEW_TOKENS,) and (a == b).all()
                   for a, b in zip(outs["restored"][0], outs["original"][0]))
        check(same, "operator serving: greedy tokens from the restored "
              "checkpoint differ from the original trainer's")
        out, batches, seconds, launches = outs["restored"]
        stats["serve"] = dict(requests=len(reqs), batches=batches,
                              seconds=seconds, kernel_B_launches=launches,
                              tokens_equal_original=same,
                              seconds_original=outs["original"][2])
        stats["steps"]["serve_s"] = seconds
        log(f"operator serving from the checkpoint: {len(reqs)} requests "
            f"in batches {batches} in {seconds:.2f} s, kernel B {launches} "
            f"= {n_layers} x (1 + steps); greedy tokens equal the original "
            f"trainer's")
        del trainer, restored, hf, server
        shutil.rmtree(f"{tmp}/ckpt")
        torch.cuda.empty_cache()

        # 5. the CLI in subprocesses, reusing this checkout's kernel build
        built = sorted(os.listdir(_build.BUILD_DIR))
        d = f"{tmp}/cli"
        common = ["--preset", OPERATOR_PRESET, "--device", dev.type,
                  "--checkpoint-dir", d]
        out, train_cli_s = cli_run(["train", "--steps",
                                    str(OPERATOR_STEPS)] + common,
                                   OPERATOR_CLI_TIMEOUT)
        latest = CheckpointManager(d).latest_step()
        check("done" in out and latest == OPERATOR_STEPS,
              f"cli train: latest_step {latest}\n{out[-2000:]}")
        out, gen_cli_s = cli_run(["generate", "--max-new-tokens",
                                  str(OPERATOR_NEW_TOKENS)] + common,
                                 OPERATOR_CLI_TIMEOUT)
        toks = json.loads(out.strip().splitlines()[-1])
        check(len(toks) == 3 + OPERATOR_NEW_TOKENS and all(
            0 <= t < cfg.model.vocab_size for t in toks),
            f"cli generate: {toks}")
        status, served, s_status, s_stats, ready_s, request_s = cli_serve(
            common + ["--max-new-tokens", str(OPERATOR_NEW_TOKENS)], tmp,
            OPERATOR_NEW_TOKENS // 2, OPERATOR_CLI_TIMEOUT)
        check(status == 200 and len(served) == OPERATOR_NEW_TOKENS // 2
              and s_status == 200 and s_stats.get("requests") == 1,
              f"cli serve: {status} {served}, stats {s_status} {s_stats}")
        check(sorted(os.listdir(_build.BUILD_DIR)) == built,
              f"the CLI built kernels again: {built} -> "
              f"{sorted(os.listdir(_build.BUILD_DIR))}")
        stats["cli"] = dict(preset=OPERATOR_PRESET, train_s=train_cli_s,
                            generate_s=gen_cli_s, serve_ready_s=ready_s,
                            serve_request_s=request_s,
                            latest_step=latest, generated=len(toks),
                            served=len(served))
        stats["steps"].update(cli_train_s=train_cli_s,
                              cli_generate_s=gen_cli_s,
                              cli_serve_s=ready_s + request_s)
        if keep_dir is not None:
            shutil.move(d, keep_dir)
        log(f"operator CLI at --preset {OPERATOR_PRESET}: train --steps "
            f"{OPERATOR_STEPS} {train_cli_s:.1f} s (latest_step {latest}), "
            f"generate {gen_cli_s:.1f} s ({len(toks)} tokens), serve ready "
            f"in {ready_s:.1f} s, POST /generate 200 with {len(served)} "
            f"tokens in {request_s:.2f} s, GET /stats 200")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"operator phase: {stats['seconds']:.1f} s; steps "
        + ", ".join(f"{k} {v:.2f}" for k, v in stats["steps"].items()))
    return stats


# --------------------------------------------------------------------------
# spill phase: the host-spilled bank at 10M x 768
# --------------------------------------------------------------------------

def mem_available():
    """The host's MemAvailable in bytes (Linux), or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def spill_rows(M, D):
    """M, or the largest multiple of SPILL_CHUNK whose host half fits in
    MemAvailable beside SPILL_HOST_SPARE bytes (the cut is printed)."""
    avail = mem_available()
    per_row = 4 * D + 6 * 4                 # f32 row, inverse norm, mirrors
    if avail is None or M * per_row + SPILL_HOST_SPARE <= avail:
        return M
    cut = (avail - SPILL_HOST_SPARE) // per_row // SPILL_CHUNK * SPILL_CHUNK
    check(cut > 0, f"host RAM: MemAvailable {avail / 1e9:.1f} GB holds no "
          f"spilled bank")
    log(f"spill phase: M cut from {M:,} to {cut:,}: MemAvailable "
        f"{avail / 1e9:.1f} GB")
    return cut


def spill_truth(dev, host_features, queries, k, rows=1 << 20):
    """Exact cosine top-k over every stored row, independent of the port:
    chunks of the host rows go to the card, f32 products (TF32 off). It
    is the reference the spill phase's recall is held to, so it shares no
    code with the port, `bench_host_spill.exact_ground_truth` included."""
    import numpy as np
    import torch
    qn = torch.from_numpy(queries / np.linalg.norm(
        queries, axis=1, keepdims=True)).to(dev)
    best_v = torch.full((len(queries), k), -2.0, device=dev)
    best_i = torch.zeros((len(queries), k), dtype=torch.long, device=dev)
    for off in range(0, len(host_features), rows):
        x = torch.from_numpy(host_features[off:off + rows]).to(dev)
        s = qn @ (x / x.norm(dim=1, keepdim=True)).T
        v, i = torch.topk(s, k, dim=1)
        best_v, pick = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
        best_i = torch.cat([best_i, i + off], 1).gather(1, pick)
    return best_i


def spill_kernel_A(bank, queries, B):
    """Kernel A at the spilled tier's shape (its device funnel's chunk of B
    queries over the whole bank) against its plain version and the
    library yardstick, in 1M-row slabs for the two."""
    import torch
    from aura_snn_rag_tpu_torch.benchmarks.bench_flat_kernel import (
        blockmax_library)
    from aura_snn_rag_tpu_torch.ops.cuda.flat_scan import (
        flat_blockmax, flat_blockmax_plain, pack_row_terms)
    cfg, dev = bank.config, bank.dev
    M, D = dev.coarse.shape
    # the funnel's row terms at step 0 (temporal term 1 for every row)
    mul, add = pack_row_terms(cfg.w_cosine * dev.strength * dev.scale,
                              cfg.w_temporal * dev.strength, M)
    sets = []
    for i in range(2):
        _, qc, qs, _ = bank._prep_queries(queries[i * B:(i + 1) * B])
        sets.append((dev.coarse, qc, mul, add, qs))
    got = flat_blockmax(*sets[0])
    want = flat_blockmax_plain(*sets[0])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == want.shape == (B, -(-M // 8)),
          f"flat_blockmax spill shape {tuple(got.shape)}")
    check(err == 0.0, f"flat_blockmax int8 at the spill shape: err {err}")
    del got, want
    out = dict(max_abs_err=err)
    out["ms"] = time_ms([lambda s=s: flat_blockmax(*s) for s in sets])
    out["graph_ms"] = graph_ms([lambda s=s: flat_blockmax(*s) for s in sets],
                               iters=4)
    torch.cuda.empty_cache()
    out["plain_ms"] = time_ms([lambda s=s: flat_blockmax_plain(*s)
                               for s in sets], iters=3, warmup=1)
    out["library_ms"] = time_ms(
        [lambda s=s: blockmax_library(*s, slab=1 << 20) for s in sets],
        iters=3, warmup=1)
    out["bound_ms"], out["bound_by"] = blockmax_bound(M, D, B, "int8")
    log(f"kernel flat_blockmax int8 B={B} M={M} D={D} (spill): "
        f"max_abs_err={err} ms={out['ms']:.4f} graph_ms="
        f"{out['graph_ms']:.4f} plain_ms={out['plain_ms']:.4f} "
        f"library_ms={out['library_ms']:.4f} bound_ms={out['bound_ms']:.4f}"
        f" ({out['bound_by']})")
    return out


def spill_phase(dev):
    """The host-spilled bank at bench_host_spill.py's configuration (see
    the module doc). Launch counters are zeroed here just before the
    bank's retrievals and read just after them."""
    import numpy as np
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.benchmarks import bench_host_spill
    from aura_snn_rag_tpu_torch.memory import host_spill
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    from aura_snn_rag_tpu_torch.ops.cuda.flat_scan import flat_blockmax_plain

    t_phase = time.perf_counter()
    M = spill_rows(SPILL["max_memories"], SPILL["feature_dim"])
    cfg = port.MemoryConfig(**dict(SPILL, max_memories=M))
    D, chunk = cfg.feature_dim, cfg.spill_query_chunk
    stats = {"n_vectors": M, "mem_available_gb": (mem_available() or 0) / 1e9}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # 1. ingest: bench_host_spill.py's chunk_factory recipe (4,096 centres
    # x 2.0 plus unit noise), drawn on the card from a seed
    gen = torch.Generator(device=dev).manual_seed(7)
    centers = torch.randn(SPILL_CENTERS, D, device=dev, generator=gen) * 2.0
    datagen = [0.0]
    # chunk i+1 is drawn on a side stream into the pinned buffer chunk i-1
    # used (its host half is done by then) while the host ingests chunk i;
    # waiting on the side stream's event alone leaves the ingest's uploads
    # on the main stream in flight (a CPU rehearsal draws in line)
    on_card = dev.type == "cuda"
    side = torch.cuda.Stream() if on_card else None
    if on_card:
        side.wait_stream(torch.cuda.current_stream())
    bufs = [torch.empty((SPILL_CHUNK, D), pin_memory=on_card)
            for _ in range(2)]
    drawn = {}

    def draw(offset):
        b, slot = min(SPILL_CHUNK, M - offset), len(drawn) % 2
        with torch.cuda.stream(side):            # no-op for None
            assign = torch.randint(0, SPILL_CENTERS, (b,), device=dev,
                                   generator=gen)
            x = centers[assign] + torch.randn(b, D, device=dev,
                                              generator=gen)
            bufs[slot][:b].copy_(x, non_blocking=on_card)
            done = torch.cuda.Event() if on_card else None
            if on_card:
                done.record(side)
        drawn[offset] = (bufs[slot][:b], done)

    def make(offset, b):
        t0 = time.perf_counter()
        if offset not in drawn:
            draw(offset)
        rows, done = drawn[offset]
        if done is not None:
            done.synchronize()
        if offset + b < M:
            draw(offset + b)
        datagen[0] += time.perf_counter() - t0
        return rows.numpy()

    t0 = time.perf_counter()
    bank = port.SpilledBank(cfg, device=dev)
    bank.bulk_load_chunked(make, M, chunk=SPILL_CHUNK)
    torch.cuda.synchronize()
    stats["ingest_s"] = time.perf_counter() - t0
    stats["ingest_datagen_s"] = datagen[0]
    check(bank.count == M and bank.native, f"ingest: count {bank.count}, "
          f"native rerank {bank.native}")
    log(f"spill: ingest of {M:,} x {D} {stats['ingest_s']:.1f} s "
        f"({M / stats['ingest_s']:.0f} rows/s; waiting for the rows drawn "
        f"on the card {datagen[0]:.1f} s of it)")
    del centers

    # queries: stored rows at random offsets plus 0.5 x noise
    rng = np.random.RandomState(7)
    queries = bank.host_features[rng.randint(0, M, SPILL_QUERIES)]
    queries += 0.5 * rng.randn(SPILL_QUERIES, D).astype(np.float32)

    def launches_for(sizes):
        return sum(-(-b // chunk) for b in sizes)

    # 2. the main path, counts from zero: retrieve_stream at B = 1024 and
    # 128 (coalesce = B) after one warm call, the breakdown, and
    # retrieve_stream against retrieve
    _build.reset_launch_counts()
    expect = 0
    results = {}
    for B in SPILL_BATCHES:
        batches = [queries[i:i + B] for i in range(0, SPILL_QUERIES, B)]
        served0 = bank.served["native"]
        # the benchmark's measurement: a warm call, the timed stream, the
        # per-batch stages (each batch reranked once more)
        run = bench_host_spill.measure(bank, batches, breakdown=True)
        served = bank.served["native"] - served0
        check(served == B + 2 * SPILL_QUERIES, f"B={B}: the native rerank "
              f"served {served} of {B + 2 * SPILL_QUERIES}")
        stats[f"qps_b{B}"] = run.qps
        stats[f"breakdown_b{B}_ms"] = dict(
            run.stages_ms, funnel_bytes_per_batch=run.funnel_bytes)
        expect += launches_for(run.dispatches)
        results[B] = (batches, run.results)
        log(f"spill: retrieve_stream B={B}: {stats[f'qps_b{B}']:.1f} QPS "
            f"over {SPILL_QUERIES} queries; per batch (ms) "
            f"{stats[f'breakdown_b{B}_ms']}")
    stats["device_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for B in SPILL_BATCHES:
        batches, res = results[B]
        for b, r in list(zip(batches, res))[:4]:
            single = bank.retrieve(b)
            check(np.array_equal(single.indices, r.indices)
                  and np.array_equal(single.scores, r.scores),
                  f"retrieve_stream B={B} differs from retrieve")
            expect += launches_for([len(b)])
    launches = dict(_build.launch_counts)
    check(bank.served["numpy"] == 0, f"the numpy rerank served "
          f"{bank.served['numpy']} queries")
    check(launches.get("flat_blockmax", 0) == expect
          and all(n == 0 for name, n in launches.items()
                  if name != "flat_blockmax"),
          f"spill path launches {launches}: kernel A {expect} times "
          f"(ceil(B / {chunk}) per dispatch), no other kernel")
    stats["launches"] = launches
    log(f"spill-path launches: {launches} (expected kernel A {expect})")

    # 3. recall@10 against the exact truth, from the B = 1024 stream
    idx = np.concatenate([r.indices for r in results[1024][1]])[:SPILL_EVAL]
    truth = spill_truth(dev, bank.host_features, queries[:SPILL_EVAL],
                        cfg.retrieve_k)
    stats["recall_at_10"] = recall_at_k(torch.from_numpy(idx), truth)
    log(f"spill: recall@10 {stats['recall_at_10']:.4f} over {SPILL_EVAL} "
        f"queries against the exact cosine top-10 of all {M:,} rows")
    check(stats["recall_at_10"] >= SPILL_RECALL,
          f"spill recall@10 {stats['recall_at_10']} < {SPILL_RECALL}")
    del truth
    torch.cuda.empty_cache()

    # 4. the funnel of one chunk through kernel A and through its plain
    # version: the same candidates per query (not counted launches)
    q = queries[:chunk]
    _, _, kern = bank._dispatch_funnel(q)
    saved = host_spill.flat_blockmax
    host_spill.flat_blockmax = flat_blockmax_plain
    try:
        _, _, plain = bank._dispatch_funnel(q)
    finally:
        host_spill.flat_blockmax = saved
    check(torch.equal(kern.sort(dim=1).values, plain.sort(dim=1).values),
          f"spill funnel of {chunk} queries: kernel A's candidates differ "
          f"from its plain version's")
    del kern, plain
    torch.cuda.empty_cache()

    # 5. kernel A at this shape, and the bytes each tier holds
    stats["kernel_A"] = spill_kernel_A(bank, queries, chunk)
    stats["host_gb"] = sum(a.nbytes for a in (
        bank.host_features, bank.host_inv_norm, bank.host_locations,
        bank.host_strength, bank.host_timestamp)) / 1e9
    stats["device_bank_gb"] = sum(t.numel() * t.element_size() for t in (
        bank.dev.coarse, bank.dev.scale, bank.dev.strength,
        bank.dev.timestamp)) / 1e9
    resident = port.init_memory_state(cfg, device="meta")
    stats["resident_state_gb"] = sum(t.numel() * t.element_size()
                                     for t in resident) / 1e9
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"spill: device {stats['device_bank_gb']:.2f} GB of bank, peak "
        f"{stats['device_peak_gb']:.2f} GB allocated; host "
        f"{stats['host_gb']:.2f} GB; a device-resident MemoryState at "
        f"M = {M:,} would take {stats['resident_state_gb']:.2f} GB; phase "
        f"{stats['seconds']:.1f} s")
    del bank
    return stats


# --------------------------------------------------------------------------
# brain phase
# --------------------------------------------------------------------------

def brain_texts(n, seed):
    """n synthetic texts from a seed: text i leads with a keyword of class
    i mod 8 (every class of the keyword router in turn), a third carry a
    second class's keyword, among filler words."""
    import numpy as np
    from aura_snn_rag_tpu_torch.zones import processor
    classes = list(processor._KEYWORDS.values())
    filler = ("the", "a", "of", "this", "about", "quickly", "signal",
              "morning", "river", "system", "note", "again")
    rng = np.random.RandomState(seed)
    texts = []
    for i in range(n):
        lead = classes[i % len(classes)]
        words = [lead[rng.randint(len(lead))]]
        words += [filler[j] for j in rng.randint(len(filler),
                                                 size=rng.randint(2, 7))]
        if i % 3 == 0:
            other = classes[rng.randint(len(classes))]
            words.append(other[rng.randint(len(other))])
        rng.shuffle(words)
        texts.append(" ".join(words) + f" {i}")
    return texts


def liquid_stream(n, seed):
    """n (text, target) pairs from a seed: three keywords of the reasoning
    class and target -1, or of the memory class and target +1, among
    three filler words. (On the JAX package's own test stream, four texts
    repeated, the whitener's variance collapses after ~50 steps and the
    error grows again, in both packages.)"""
    import numpy as np
    from aura_snn_rag_tpu_torch.zones import processor
    topics = (processor._KEYWORDS[processor.ContentType.REASONING],
              processor._KEYWORDS[processor.ContentType.MEMORY])
    filler = ("the", "a", "of", "this", "about", "quickly", "signal",
              "morning", "river", "system", "note", "again")
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(2)
        words = [topics[t][rng.randint(len(topics[t]))] for _ in range(3)]
        words += [filler[j] for j in rng.randint(len(filler), size=3)]
        rng.shuffle(words)
        out.append((" ".join(words), 1.0 if t else -1.0))
    return out


def profile_calls(fn, reps):
    """torch.profiler over `reps` calls of fn: wall and device ms per
    call, the device's busy share and kernel launches per call. Only the
    device is traced, and its events are read raw: sorting them into
    `key_averages` takes ~3 s per 15,000 launches (host events ~2 s more)
    and gives the same kernels and device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    dev_ms = sum(e.duration_ns() for e in kernels) / 1e6 / reps
    return dict(wall_ms=wall_ms, device_ms=dev_ms, busy=dev_ms / wall_ms,
                launches_per_call=len(kernels) / reps)


def syncs_per_call(fn, reps):
    """Host syncs per call of fn, counted by CUDA's sync debug mode (each
    synchronising operation warns once)."""
    import warnings
    import torch
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(reps):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught) / reps


def wall_ms(fn, reps):
    """Host ms per call over `reps` calls ending in a synchronise (the
    brain path is host-bound, so this is its time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def zone_rows_flipped(zone_a, zone_b, x):
    """Rows of x where the spikes of two copies of a zone (the card's and
    the CPU's) differ, and the number of differing entries."""
    import torch
    with torch.no_grad():
        sa, _ = zone_a.population(x.to(zone_a.input_proj.weight_patterns
                                       .device))
        sb, _ = zone_b.population(x.to(zone_b.input_proj.weight_patterns
                                       .device))
    flips = sa.cpu() != sb.cpu()
    check(flips.float().mean().item() <= BRAIN_FLIP_FRACTION,
          f"zone spikes differ on {flips.float().mean().item():.2e} of "
          f"the entries between the card and the CPU")
    return flips.any(dim=2).any(dim=1), int(flips.sum())


def brain_phase(dev):
    """The neuromorphic brain system at the JAX package's sizes (see the
    module doc). No kernel may launch: the counts are zeroed first and
    read at the end."""
    import numpy as np
    import torch
    from aura_snn_rag_tpu_torch.models.brain.brain import (
        EnhancedBrain, LiquidBrain)
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    from aura_snn_rag_tpu_torch.services.brain_system import (
        DEFAULT_ZONES, NeuromorphicBrainSystem)
    from aura_snn_rag_tpu_torch.services.continuous_learning import (
        IngestItem)
    from aura_snn_rag_tpu_torch.zones.brain_zone import (
        BrainZoneConfig, NeuromorphicBrainZone, SpikingNeuronConfig)

    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    stats = {}
    system = NeuromorphicBrainSystem(seed=0, device=dev)
    reference = NeuromorphicBrainSystem(seed=0, device="cpu")
    zone_devices = set()
    for zone in system._zone_modules.values():
        zone.register_forward_pre_hook(
            lambda _, args: zone_devices.update(
                a.device.type for a in args if torch.is_tensor(a)))

    def checked(out, what):
        check(system.processor.stats["errors"] == 0,
              f"{what}: {system.processor.stats['errors']} zone errors "
              f"swallowed by the processor")
        check(out.device.type == dev.type
              and bool(torch.isfinite(out).all()),
              f"{what}: output on {out.device} or not finite")

    # 1. process_text over seeded texts; the first BRAIN_CHECK against
    # the CPU port from the same seed
    texts = brain_texts(BRAIN_TEXTS, seed=11)
    flipped_rows = flips = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for i, text in enumerate(texts):
        out, info = system.process_text(text)
        checked(out, f"process_text {i}")
        outs.append((out, info["plan"]))
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t0
    max_err = 0.0
    for i, text in enumerate(texts[:BRAIN_CHECK]):
        ref, ref_info = reference.process_text(text)
        out, plan = outs[i]
        check(plan == ref_info["plan"], f"text {i}: plan {plan} on the "
              f"card, {ref_info['plan']} on the CPU")
        x = torch.from_numpy(reference.orchestrator.hash_embedder.embed(
            text)[:system.d_model])[None, :]
        row_flipped = False
        for zone, _ in plan:
            rows, n = zone_rows_flipped(system._zone_modules[zone],
                                        reference._zone_modules[zone], x)
            row_flipped |= bool(rows[0])
            flips += n
        if row_flipped:
            flipped_rows += 1
            continue
        max_err = max(max_err, (out.cpu() - ref).abs().max().item())
    check(max_err <= BRAIN_TOL, f"card against CPU: {max_err} > "
          f"{BRAIN_TOL} on texts whose spikes agree")
    usage = system.processor.stats["zone_usage"]
    check(all(usage[name] > 0 for name, _ in DEFAULT_ZONES),
          f"a zone never ran: {usage}")
    steps = {"process_text": time.perf_counter() - t_phase}
    stats["process_text"] = dict(
        texts=len(texts), seconds=text_s, items_per_s=len(texts) / text_s,
        ms_per_text=text_s * 1e3 / len(texts), zone_usage=dict(usage),
        checked_texts=BRAIN_CHECK, max_abs_err_vs_cpu=max_err,
        texts_with_flips=flipped_rows, spike_flips=flips)

    # 2. the orchestrator's zone executor over more texts, in batches
    more = brain_texts(BRAIN_TEXTS, seed=12)
    categories = ["memory", "emotion", "pattern", "time", "analyze",
                  "create", "language", "calculate", "general"]
    executed = []
    inner = system.orchestrator.zone_executor

    def executor(features, category):
        out, info = inner(features, category)
        checked(out, f"zone executor ({category})")
        executed.append(out)
        return out, info
    system.orchestrator.zone_executor = executor
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(0, len(more), BRAIN_BATCH):
        system.orchestrator.process_batch([
            IngestItem(t, categories[(b + j) % len(categories)])
            for j, t in enumerate(more[b:b + BRAIN_BATCH])])
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    system.orchestrator.zone_executor = inner
    check(len(executed) == len(more), f"{len(executed)} of {len(more)} "
          f"items went through the zone executor")
    stats["orchestrator"] = dict(
        items=len(more), batch=BRAIN_BATCH, seconds=batch_s,
        items_per_s=len(more) / batch_s,
        errors=system.orchestrator.stats["errors"])
    check(system.orchestrator.stats["errors"] == 0,
          "orchestrator batch errors")
    steps["orchestrator"] = time.perf_counter() - t_phase

    # 3. per call of process_text: time, launches, host syncs, busy share
    probe = itertools.cycle(texts[:BRAIN_PROFILE])

    def one_text():
        return system.process_text(next(probe))
    prof = profile_calls(one_text, BRAIN_PROFILE)
    prof["host_syncs_per_call"] = syncs_per_call(one_text, BRAIN_PROFILE)
    stats["process_text"]["profile"] = prof
    steps["profile"] = time.perf_counter() - t_phase

    # 4. the mixed zone and EnhancedBrain at B = 1 and 256
    gen = torch.Generator().manual_seed(5)
    third = 1 / 3
    mixed = NeuromorphicBrainZone(BrainZoneConfig(neuron_configs=(
        SpikingNeuronConfig("lif", third),
        SpikingNeuronConfig("izhikevich", third),
        SpikingNeuronConfig("adex", third))), dev, gen).requires_grad_(False)
    brain = EnhancedBrain([BrainZoneConfig(name=name) for name, _ in
                           DEFAULT_ZONES], d_model=64, device=dev,
                          generator=gen).requires_grad_(False)
    for name, module in (("mixed_zone", mixed), ("enhanced_brain", brain)):
        rows = {}
        for B in BRAIN_BATCHES:
            x = torch.randn(B, 64, generator=gen).to(dev)
            call = (lambda m=module, x=x: m(x))
            r = profile_calls(call, 1)
            r["ms"] = wall_ms(call, BRAIN_TIMED)
            r["host_syncs_per_call"] = syncs_per_call(call, 1)
            out, _ = call()
            check(bool(torch.isfinite(out).all()), f"{name} B={B}")
            rows[B] = r
        stats[name] = rows
    zstats = mixed(torch.randn(256, 64, generator=gen).to(dev))[1]
    stats["mixed_zone"]["avg_firing_rate"] = float(zstats["avg_firing_rate"])
    steps["modules"] = time.perf_counter() - t_phase

    # 5. LiquidBrain at its defaults learns a two-topic stream online
    liquid = LiquidBrain(seed=0, device=dev)
    t0 = time.perf_counter()
    errs = [abs(liquid.learn_text(text, target)["error"])
            for text, target in liquid_stream(LIQUID_STEPS, seed=13)]
    liquid_s = time.perf_counter() - t0
    first, last = float(np.mean(errs[:50])), float(np.mean(errs[-50:]))
    check(last < first, f"LiquidBrain error did not fall: {first} -> "
          f"{last}")
    stats["liquid_brain"] = dict(steps=LIQUID_STEPS, first50=first,
                                 last50=last, K=int(liquid.hippocampus.K),
                                 ms_per_step=liquid_s * 1e3 / LIQUID_STEPS)
    steps["liquid_brain"] = time.perf_counter() - t_phase

    launches = dict(_build.launch_counts)
    check(not any(launches.values()), f"a kernel launched on the brain "
          f"path: {launches}")
    check(zone_devices == {dev.type}, f"zone forwards saw tensors on "
          f"{zone_devices}")

    # 6. the CLI's brain-demo on the card
    out, seconds = cli_run(["brain-demo"], timeout=300)
    check("plan:" in out and "output norm:" in out,
          f"brain-demo printed {out!r}")
    stats["brain_demo"] = dict(seconds=seconds, output=out.splitlines())
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    stats["seconds_at_end_of"] = steps
    p = stats["process_text"]
    log(f"brain: {p['items_per_s']:.1f} texts/s, {p['ms_per_text']:.3f} ms "
        f"per process_text, {p['profile']['launches_per_call']:.0f} "
        f"launches and {p['profile']['host_syncs_per_call']:.1f} host syncs "
        f"per call, busy {p['profile']['busy']:.3f}; orchestrator "
        f"{stats['orchestrator']['items_per_s']:.1f} items/s")
    for name in ("mixed_zone", "enhanced_brain"):
        for B in BRAIN_BATCHES:
            r = stats[name][B]
            log(f"brain: {name} B={B}: {r['ms']:.3f} ms per call, "
                f"{r['launches_per_call']:.0f} launches, busy "
                f"{r['busy']:.3f}")
    return stats


# --------------------------------------------------------------------------
# natural-brain phase
# --------------------------------------------------------------------------

class Taps:
    """Outputs of a model's submodules by name (forward hooks), detached
    on their device; "<name>_in" holds the first input of those in
    `inputs`."""

    def __init__(self, inputs=(), **modules):
        self.out = {}
        self._handles = []
        for name, m in modules.items():
            def hook(_, args, out, name=name):
                self.out[name] = out.detach()
                if name in inputs:
                    self.out[name + "_in"] = args[0].detach()
            self._handles.append(m.register_forward_hook(hook))

    def remove(self):
        for h in self._handles:
            h.remove()


def zone_taps(zone):
    """Taps of a `FullLanguageZone`'s layers whose outputs feed a spiking
    stage, with their inputs (the decoder's input is the Poisson
    spikes)."""
    return Taps(inputs=("encoder_proj", "syn1", "syn2", "decoder_proj"),
                encoder_proj=zone.encoder_proj, syn1=zone.bank.experts.syn1,
                syn2=zone.bank.experts.syn2, decoder_proj=zone.decoder_proj)


def zone_spikes(zone, taps, ids, info):
    """A `FullLanguageZone` call's spikes, recomputed on the call's device
    by the port's own functions from its layers' outputs and returned on
    the CPU: the encoder's, each expert's two GIF layers'
    ([E, N, T, H]), the Poisson draw's and the decoder's; and the
    dispatch plan [B, E, C] (None in dense mode)."""
    import torch
    from aura_snn_rag_tpu_torch.models.language_zone import topk_dispatch
    from aura_snn_rag_tpu_torch.models.prosody import (
        prosody_attention_gains, prosody_gif_scan)
    from aura_snn_rag_tpu_torch.ops.neurons import gif_params, gif_scan
    gp = gif_params(levels=zone.levels)
    o = taps.out
    T = ids.shape[1]
    E = zone.num_experts
    N = o["syn1"].shape[1] // T
    with torch.no_grad():
        gains, _ = prosody_attention_gains(ids.to(o["encoder_proj"].device))
        spikes = dict(
            enc=prosody_gif_scan(gp, o["encoder_proj"], gains)[0],
            s1=gif_scan(gp, o["syn1"].reshape(E, N, T, -1))[0],
            s2=gif_scan(gp, o["syn2"].reshape(E, N, T, -1))[0],
            poisson=o["decoder_proj_in"],
            dec=gif_scan(gp, o["decoder_proj"])[0])
    spikes = {k: v.cpu() for k, v in spikes.items()}
    plan = None if zone.dense_dispatch else topk_dispatch(
        info["routing"]["indices"].cpu(), info["routing"]["weights"].cpu(),
        E, info["capacity"])[0]
    return spikes, plan


def zone_flipped_rows(card, ref, plan):
    """Rows [B] where the card's spikes of a zone call differ from the
    CPU's, anywhere downstream of a flip too (an expert slot marks the
    row routed there)."""
    import torch
    rows = torch.zeros(card["enc"].shape[0], dtype=torch.bool)
    for key, a in card.items():
        f = a != ref[key]
        if key in ("s1", "s2"):
            slots = f.flatten(2).any(dim=2)                    # [E, N]
            rows |= (slots.any(dim=0) if plan is None else torch.einsum(
                "bec,ec->b", plan, slots.float()) > 0)
        else:
            rows |= f.flatten(1).any(dim=1)
    return rows


def local_flips(zone, taps, ref, ids):
    """Spikes that flip where they are made: each spiking stage of the
    card's zone run on the CPU run's input to that stage, against the
    CPU's spikes. A flip there (a potential within an ulp of a level)
    makes everything downstream of it differ, which `zone_flipped_rows`
    counts as rows, not as flips. Returns (flips, entries)."""
    import torch
    from aura_snn_rag_tpu_torch.models.prosody import (
        prosody_attention_gains, prosody_gif_scan)
    from aura_snn_rag_tpu_torch.ops.neurons import gif_params, gif_scan
    dev = next(zone.parameters()).device
    gp = gif_params(levels=zone.levels)
    o = taps.out
    E, N, T = ref["s1"].shape[:3]
    with torch.no_grad():
        gains, _ = prosody_attention_gains(ids.to(dev))
        local = dict(
            enc=prosody_gif_scan(gp, zone.encoder_proj(
                o["encoder_proj_in"].to(dev)), gains)[0],
            s1=gif_scan(gp, zone.bank.experts.syn1(o["syn1_in"].to(dev))
                        .reshape(E, N, T, -1))[0],
            s2=gif_scan(gp, zone.bank.experts.syn2(o["syn2_in"].to(dev))
                        .reshape(E, N, T, -1))[0],
            dec=gif_scan(gp, zone.decoder_proj(
                o["decoder_proj_in"].to(dev)))[0])
    flips = sum(int((v.cpu() != ref[k]).sum()) for k, v in local.items())
    return flips, sum(v.numel() for v in local.values())


def hormone_levels():
    """Hormone levels from the port's `EndocrineSystem` after 30 steps of
    a stressed, inaccurate run and 40 of an accurate one, so cortisol,
    norepinephrine and dopamine (the hormones the brain reads) are all
    above 0."""
    from aura_snn_rag_tpu_torch.models.brain.endocrine import (
        EndocrineSystem)
    endocrine = EndocrineSystem()
    for step in range(70):
        levels = endocrine.step({"accuracy": 0.3 if step < 30 else 0.97,
                                 "gate_diversity": 0.2, "energy": 1.0})
    check(all(levels[h] > 0 for h in ("cortisol", "norepinephrine",
                                      "dopamine")), f"hormones {levels}")
    return levels


def lm_pair(make, dev, seed):
    """A port model on the card and the same weights on the CPU, drawn
    from a seeded CPU generator."""
    import torch
    card = make(dev, torch.Generator().manual_seed(seed))
    ref = make("cpu", torch.Generator().manual_seed(seed + 1))
    ref.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card.requires_grad_(False), ref.requires_grad_(False)


def card_vs_cpu(card, ref, batches, call, zone_of, extra_rows=None):
    """Holds a model on the card to its CPU copy on `batches` of ids with
    the same Poisson draws (CPU generators of one seed): outputs within
    BRAIN_TOL on the rows whose spikes agree. `call(model, ids, gen)`
    returns (out, info); `zone_of(model)` is its language zone;
    `extra_rows(card, ref)` adds rows flipped elsewhere (after a call).
    Returns the largest error, rows compared and flipped, the flips and
    the spike rates seen."""
    import torch
    err, compared, flipped, flips, entries, rates = 0.0, 0, 0, 0, 0, []
    for i, ids in enumerate(batches):
        runs = []
        for model in (card, ref):
            zone = zone_of(model)
            taps = zone_taps(zone)
            with torch.no_grad():
                out, info = call(model, ids.to(next(model.parameters())
                                               .device),
                                 torch.Generator().manual_seed(100 + i))
            taps.remove()
            check(bool(torch.isfinite(out).all()), "output not finite")
            runs.append((out.cpu(), zone_spikes(zone, taps, ids, info),
                         info, taps))
        (oc, (sc, plan), info, _), (orf, (sr, _), _, rtaps) = runs
        rows = zone_flipped_rows(sc, sr, plan)
        if extra_rows is not None:
            rows |= extra_rows(card, ref)
        n, total = local_flips(zone_of(card), rtaps, sr, ids)
        flips += n
        entries += total
        keep = ~rows
        flipped += int(rows.sum())
        compared += int(keep.sum())
        if keep.any():
            err = max(err, (oc[keep] - orf[keep]).abs().max().item())
        rates.append(float(info.get("spike_rate", float("nan"))))
    check(flips <= BRAIN_FLIP_FRACTION * entries, f"zone spikes flip on "
          f"{flips / entries:.2e} of the entries between the card and the "
          f"CPU")
    check(compared >= len(batches) * batches[0].shape[0] // 2,
          f"only {compared} rows free of spike flips")
    check(err <= BRAIN_TOL, f"card against CPU: {err} > {BRAIN_TOL} on "
          f"rows whose spikes agree")
    return dict(max_abs_err_vs_cpu=err, rows_compared=compared,
                rows_with_flips=flipped, spike_flips=flips,
                spike_entries=entries, spike_rates=rates)


def sync_sites(fn):
    """fn's host syncs per call and their source lines (CUDA's sync debug
    mode warns at each, from the Python line that caused it)."""
    import warnings
    import torch
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    return len(syncs), sorted({f"{os.path.relpath(w.filename)}:{w.lineno}"
                               for w in syncs})


def timed_model(fn, reps=NB_TIMED):
    """ms per call (host clock, ending in a synchronise), launches per
    call, device busy share and host syncs per call of fn, and where
    they happen."""
    r = profile_calls(fn, 1)
    r["ms"] = wall_ms(fn, reps)
    r["host_syncs_per_call"], r["host_sync_sites"] = sync_sites(fn)
    r["tokens_per_s"] = NB_BATCH * NB_SEQ / (r["ms"] / 1e3)
    return r


def nb_ids(seed, n):
    """n batches of [NB_BATCH, NB_SEQ] ids in [0, NB_VOCAB) from a seed."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, NB_VOCAB, (NB_BATCH, NB_SEQ)))
            for _ in range(n)]


def driven(card, ref, seed):
    """The embedding tables of a pair replaced by N(0, NB_DRIVE^2) draws
    of one seed (so the temporal cortex spikes); returns the restore."""
    import torch
    saved = card.embedding.weight.detach().clone()
    table = torch.randn(ref.embedding.weight.shape,
                        generator=torch.Generator().manual_seed(seed)) \
        * NB_DRIVE
    with torch.no_grad():
        card.embedding.weight.copy_(table)
        ref.embedding.weight.copy_(table)

    def restore():
        with torch.no_grad():
            card.embedding.weight.copy_(saved)
            ref.embedding.weight.copy_(saved.cpu())
    return restore


def brain_zones_flipped(card, ref, inputs):
    """Rows where a `NaturalBrain`'s non-temporal cortices spike
    differently on the card and the CPU (each on the CPU run's input)."""
    import torch
    rows = None
    for region, x in inputs.items():
        r, _ = zone_rows_flipped(getattr(card, f"cortex_{region}"),
                                 getattr(ref, f"cortex_{region}"), x)
        rows = r if rows is None else rows | r
    return rows if rows is not None else torch.zeros(NB_BATCH,
                                                     dtype=torch.bool)


def natural_brain_vs_cpu(card, ref, batches, hormones):
    """`card_vs_cpu` for a `NaturalBrain` pair: the temporal cortex's
    spikes and its routing (for the dispatch plan) through hooks, and the
    rows where another cortex's population spikes differently."""
    inputs = {}
    hooks = [getattr(ref, f"cortex_{r}").register_forward_pre_hook(
        lambda _, args, r=r: inputs.__setitem__(r, args[0].detach().cpu()))
        for r in ref.regions if r != "temporal_cortex"]
    routing = {}
    for model in (card, ref):
        hooks.append(model.cortex_temporal_cortex.register_forward_hook(
            lambda _, __, out, model=model: routing.__setitem__(
                id(model), {k: out[1][k] for k in ("routing", "capacity")})))

    def call(model, ids, gen):
        out, info = model(ids, hormones, gen)
        return out, dict(info["temporal_cortex_info"], **routing[id(model)])
    try:
        return card_vs_cpu(card, ref, batches, call,
                           lambda m: m.cortex_temporal_cortex,
                           lambda c, r: brain_zones_flipped(c, r, inputs))
    finally:
        for h in hooks:
            h.remove()


def natural_brain_check(dev, hormones):
    """`NaturalBrain` at its defaults on the card against the CPU port,
    at the defaults and driven, and its timing."""
    import torch
    from aura_snn_rag_tpu_torch.models.brain.natural_brain import (
        DEFAULT_REGIONS, NaturalBrain)
    card, ref = lm_pair(lambda d, g: NaturalBrain(NB_VOCAB, device=d,
                                                  generator=g), dev, 31)
    stats = dict(params=sum(p.numel() for p in card.parameters()),
                 hormones=hormones)
    stats["defaults"] = natural_brain_vs_cpu(card, ref, nb_ids(41, NB_CHECK),
                                             hormones)
    restore = driven(card, ref, 42)
    stats["driven"] = natural_brain_vs_cpu(card, ref, nb_ids(43, NB_CHECK),
                                           hormones)
    restore()
    check(min(stats["driven"]["spike_rates"]) > 0.1,
          f"driven temporal cortex rates {stats['driven']['spike_rates']}")

    ids = nb_ids(44, 1)[0].to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        logits, info = card(ids, hormones, gen)
    check(logits.shape == (NB_BATCH, NB_VOCAB)
          and bool(torch.isfinite(logits).all()), "NaturalBrain logits")
    stats["temporal_cortex_spike_rate"] = float(
        info["temporal_cortex_info"]["spike_rate"])
    stats["zone_firing_rates"] = {
        r: float(info[f"{r}_info"]["avg_firing_rate"])
        for r in DEFAULT_REGIONS if r != "temporal_cortex"}

    def forward():
        with torch.no_grad():
            return card(ids, hormones, gen)
    stats["forward"] = timed_model(forward)
    return stats


def moe_grads_vs_cpu(card, ref, ids):
    """Gradients of the logits' sum of a `MoELanguageZone` on the card
    against its CPU copy (the same Poisson draws), tensor by tensor, on a
    batch where no spike differs; returns the largest error over each
    tensor's RMS (floored at 1e-3 of the largest RMS)."""
    import torch
    grads, runs = [], []
    for model in (card, ref):
        taps = zone_taps(model.zone)
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        out, info = model(ids.to(next(model.parameters()).device),
                          torch.Generator().manual_seed(7))
        out.sum().backward()
        taps.remove()
        runs.append(zone_spikes(model.zone, taps, ids, info))
        grads.append({n: (torch.zeros_like(p) if p.grad is None
                          else p.grad).detach().cpu()
                      for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)
    rows = zone_flipped_rows(runs[0][0], runs[1][0], runs[0][1])
    check(not rows.any(), f"{int(rows.sum())} rows of the gradient batch "
          f"spike differently on the card")
    rms = {n: g.square().mean().sqrt().item() for n, g in grads[1].items()}
    floor = 1e-3 * max(rms.values())
    worst = max((grads[0][n] - g).abs().max().item() / max(rms[n], floor)
                for n, g in grads[1].items())
    check(worst <= NB_GRAD_RTOL, f"MoE gradients on the card against the "
          f"CPU: {worst} of the RMS")
    return worst


def moe_check(dev):
    """`MoELanguageZone` at its defaults (and `FullLanguageZone` in dense
    mode at its width) on the card against the CPU port, at the defaults
    and driven; the card's gradients against the CPU's at the defaults;
    forward and backward timings."""
    import torch
    from aura_snn_rag_tpu_torch.models.language_zone import (
        FullLanguageZone, MoELanguageZone)
    card, ref = lm_pair(lambda d, g: MoELanguageZone(NB_VOCAB, device=d,
                                                     generator=g), dev, 51)
    stats = dict(params=sum(p.numel() for p in card.parameters()))

    def call(model, ids, gen):
        return model(ids, gen)
    zone_of = (lambda m: m.zone)
    stats["defaults"] = card_vs_cpu(card, ref, nb_ids(52, NB_CHECK), call,
                                    zone_of)
    stats["grad_max_err_over_rms"] = moe_grads_vs_cpu(card, ref,
                                                      nb_ids(55, 1)[0])
    restore = driven(card, ref, 53)
    stats["driven"] = card_vs_cpu(card, ref, nb_ids(54, NB_CHECK), call,
                                  zone_of)
    check(min(stats["driven"]["spike_rates"]) > 0.1,
          f"driven MoE rates {stats['driven']['spike_rates']}")
    restore()

    ids = nb_ids(56, 1)[0].to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        logits, info = card(ids, gen)
    check(logits.shape == (NB_BATCH, NB_VOCAB)
          and bool(torch.isfinite(logits).all()), "MoE logits")
    stats["spike_rate"] = float(info["spike_rate"])
    stats["capacity"] = info["capacity"]
    stats["dropped_fraction"] = float(info["dropped_fraction"])

    def forward():
        with torch.no_grad():
            return card(ids, gen)

    def forward_backward():
        card.zero_grad(set_to_none=True)
        out, _ = card(ids, gen)
        out.sum().backward()
    stats["forward"] = timed_model(forward)
    card.requires_grad_(True)
    stats["forward_backward"] = timed_model(forward_backward)
    card.requires_grad_(False)
    card.zero_grad(set_to_none=True)
    stats["backward_ms"] = (stats["forward_backward"]["ms"]
                            - stats["forward"]["ms"])

    # dense dispatch at the same width, on unit-scale features
    dcard, dref = lm_pair(lambda d, g: FullLanguageZone(
        256, dense_dispatch=True, device=d, generator=g), dev, 57)
    feats = torch.randn(NB_BATCH, NB_SEQ, 256,
                        generator=torch.Generator().manual_seed(58))

    def dcall(model, ids, gen):
        return model(ids, feats.to(next(model.parameters()).device), gen)
    stats["dense"] = card_vs_cpu(dcard, dref, nb_ids(59, NB_CHECK), dcall,
                                 lambda m: m)
    dfeats = feats.to(dev)

    def dense_forward():
        with torch.no_grad():
            return dcard(ids, dfeats, gen)
    stats["dense"]["forward"] = timed_model(dense_forward)
    return stats


def prosody_check(dev):
    """benchmarks/bench_prosody.py's run on the card (`CachedProsodyBridge(
    ANALYTICAL_BALANCED)` over its 16 seeded [8, 256] batches as ids on
    the card, cold then warm): one host copy per call, the key; the cold
    pass's gains against a CPU bridge's where the LIF chains' spikes
    agree."""
    import torch
    from aura_snn_rag_tpu_torch.benchmarks import bench_prosody
    from aura_snn_rag_tpu_torch.models.prosody import (
        ANALYTICAL_BALANCED, CachedProsodyBridge, _lif_chains,
        prosody_channels_from_tokens)
    res = bench_prosody.run(["--device", dev.type])
    bridge = res.bridge
    copies = res.calls if dev.type == "cuda" else 0  # one per call, the key
    check(bridge.host_copies == copies, f"{bridge.host_copies} host copies "
          f"over {res.calls} calls")
    ref = CachedProsodyBridge(ANALYTICAL_BALANCED, device="cpu")
    err, flipped = 0.0, 0
    decay = torch.tensor(ANALYTICAL_BALANCED.decay)[:, None]
    for b, g in zip(res.batches, res.gains):
        b = torch.from_numpy(b)
        check(bool(torch.isfinite(g).all()), "prosody gains not finite")
        spikes = [_lif_chains(torch.stack(prosody_channels_from_tokens(x)),
                              decay.to(x.device)).cpu()
                  for x in (b.to(dev), b)]
        rows = (spikes[0] != spikes[1]).any(dim=2).any(dim=0)
        flipped += int(rows.sum())
        keep = ~rows
        err = max(err, (g[keep] - ref(b)[keep]).abs().max().item())
    check(err <= 1e-5, f"prosody gains on the card against the CPU: {err}")
    return dict(**res.line, cold_s=res.cold_s, warm_s=res.warm_s,
                host_copies=bridge.host_copies, calls=res.calls,
                max_abs_err_vs_cpu=err, rows_with_lif_flips=flipped)


def emotion_check(dev):
    """The emotion head at bench_emotion_e2e.py's configuration, trained
    on the card and, from the same weights, on the CPU: the loss must
    fall and the card's top-1 test accuracy beat chance."""
    import torch
    from aura_snn_rag_tpu_torch.benchmarks.bench_emotion_e2e import (
        DIM, LR, load_curated, stratified_split)
    from aura_snn_rag_tpu_torch.encoders.hash_embedder import (
        FastHashEmbedder)
    from aura_snn_rag_tpu_torch.models.emotion_head import (
        EmotionHeadConfig, EmotionPersonalityHead, emotion_multitask_loss)
    texts, labels, n_cls = load_curated()
    train, test = stratified_split(labels)
    X = torch.from_numpy(FastHashEmbedder(dim=DIM).embed_batch(texts))
    y = torch.from_numpy(labels)
    cfg = EmotionHeadConfig(d_model=DIM, n_emotions=n_cls)
    card, ref = lm_pair(lambda d, g: EmotionPersonalityHead(
        cfg, device=d, generator=g), dev, 61)
    out = dict(n=len(texts), n_test=int(len(test)), chance=1 / n_cls)
    for name, head in (("card", card), ("cpu", ref)):
        d = next(head.parameters()).device
        Xtr, ytr = X[train].to(d), y[train].to(d)
        Xte, yte = X[test].to(d), y[test].to(d)
        head.requires_grad_(True)
        opt = torch.optim.Adam(head.parameters(), lr=LR)
        losses = []
        if d.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EMOTION_EPOCHS):
            opt.zero_grad()
            loss, _ = emotion_multitask_loss(head(Xtr), {"emotion": ytr})
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        losses = torch.stack(losses).cpu()
        seconds = time.perf_counter() - t0
        head.requires_grad_(False)
        with torch.no_grad():
            logits = head(Xte)["emotion"]
        check(bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(losses).all()), f"emotion head "
              f"({name}) not finite")
        top3 = logits.topk(3, dim=-1).indices
        out[name] = dict(
            first_loss=losses[0].item(), final_loss=losses[-1].item(),
            top1=(logits.argmax(-1) == yte).float().mean().item(),
            top3=(top3 == yte[:, None]).any(-1).float().mean().item(),
            ms_per_epoch=seconds * 1e3 / EMOTION_EPOCHS)
    c = out["card"]
    check(c["final_loss"] < c["first_loss"], f"emotion loss did not fall: "
          f"{c['first_loss']} -> {c['final_loss']}")
    check(c["top1"] > out["chance"], f"emotion top-1 {c['top1']} at "
          f"chance {out['chance']}")
    return out


def srffn_texts(n, seed):
    """n seeded texts with event keywords among filler words, and a
    phoneme sequence each (3-8 IPA phonemes)."""
    import numpy as np
    from aura_snn_rag_tpu_torch.encoders.event_encoder import DEFAULT_EVENTS
    from aura_snn_rag_tpu_torch.encoders.frequency_encoder import (
        IPA_FORMANTS)
    keywords = [k for kws in DEFAULT_EVENTS.values() for k in kws]
    filler = ("the", "a", "of", "this", "about", "quickly", "signal",
              "morning", "river", "system", "note", "again")
    phonemes = list(IPA_FORMANTS)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        words = [keywords[j] for j in rng.randint(len(keywords),
                                                  size=rng.randint(0, 4))]
        words += [filler[j] for j in rng.randint(len(filler),
                                                 size=rng.randint(2, 8))]
        rng.shuffle(words)
        out.append((" ".join(words), [phonemes[j] for j in rng.randint(
            len(phonemes), size=rng.randint(3, 9))]))
    return out


def srffn_check(dev):
    """`DualLayerSRFFN()` at its defaults over seeded texts with phonemes
    on the card (texts/s), every feature held to a CPU SRFFN's."""
    import torch
    from aura_snn_rag_tpu_torch.encoders.dual_layer_srffn import (
        DualLayerSRFFN)
    items = srffn_texts(SRFFN_TEXTS, seed=71)
    card, ref = DualLayerSRFFN(device=dev), DualLayerSRFFN(device="cpu")
    card.forward(*items[0])
    ref.forward(*items[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = [card.forward(text, ph)["features"] for text, ph in items]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    feats = torch.stack(feats).cpu()
    want = torch.stack([ref.forward(text, ph)["features"]
                        for text, ph in items])
    check(bool(torch.isfinite(feats).all()), "SRFFN features not finite")
    err = (feats - want).abs().max().item()
    check(err <= BRAIN_TOL, f"SRFFN on the card against the CPU: {err}")
    return dict(texts=len(items), texts_per_s=len(items) / seconds,
                ms_per_text=seconds * 1e3 / len(items),
                max_abs_err_vs_cpu=err)


def natural_brain_phase(dev):
    """The NaturalBrain path (see the module doc). No kernel may launch:
    the counts are zeroed first and read at the end."""
    import torch
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    torch.manual_seed(0)
    hormones = hormone_levels()
    stats = {}
    steps = {}
    for name, fn in (("natural_brain", lambda: natural_brain_check(
            dev, hormones)), ("moe_language_zone", lambda: moe_check(dev)),
                     ("prosody_bridge", lambda: prosody_check(dev)),
                     ("emotion_head", lambda: emotion_check(dev)),
                     ("srffn", lambda: srffn_check(dev))):
        stats[name] = fn()
        steps[name] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
    launches = dict(_build.launch_counts)
    check(not any(launches.values()), f"a kernel launched on the "
          f"natural-brain path: {launches}")
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    stats["seconds_at_end_of"] = steps
    nb, moe = stats["natural_brain"], stats["moe_language_zone"]
    for name, r in (("NaturalBrain forward", nb["forward"]),
                    ("MoELanguageZone forward", moe["forward"]),
                    ("MoELanguageZone forward+backward",
                     moe["forward_backward"]),
                    ("FullLanguageZone dense forward",
                     moe["dense"]["forward"])):
        log(f"natural-brain: {name}: {r['ms']:.2f} ms, "
            f"{r['tokens_per_s']:.0f} tokens/s, "
            f"{r['launches_per_call']:.0f} launches, busy {r['busy']:.3f}, "
            f"{r['host_syncs_per_call']:.0f} host syncs")
    log(f"natural-brain: rates NaturalBrain temporal "
        f"{nb['temporal_cortex_spike_rate']:.4f} (driven "
        f"{min(nb['driven']['spike_rates']):.3f}), MoE "
        f"{moe['spike_rate']:.4f} (driven "
        f"{min(moe['driven']['spike_rates']):.3f})")
    pb, em, sr = (stats["prosody_bridge"], stats["emotion_head"],
                  stats["srffn"])
    log(f"natural-brain: prosody {pb['tokens_per_s_uncached']:.0f} "
        f"tokens/s uncached, cache speedup {pb['cache_speedup_pct']:.1f}%, "
        f"hit rate {pb['hit_rate']:.3f}; emotion top-1 "
        f"{em['card']['top1']:.4f} (CPU {em['cpu']['top1']:.4f}), top-3 "
        f"{em['card']['top3']:.4f} (CPU {em['cpu']['top3']:.4f}); SRFFN "
        f"{sr['texts_per_s']:.0f} texts/s; phase {stats['seconds']:.1f} s")
    return stats


# --------------------------------------------------------------------------
# sharded phase: the data-parallel path on a one-rank process group
# --------------------------------------------------------------------------

SHARDED_BATCHES = (1, 8, 1024)  # retrieve_sharded against retrieve_auto
SHARDED_REPS = 20               # calls per timing
SHARDED_SMALL = dict(max_memories=65_536, feature_dim=768, k_centroids=256)
SHARDED_STEPS = 4               # train_steps of each trainer
TRACE_STEPS = 20                # decode steps timed by StepTimer
# benchmarks/bench_mnist.py (JAX, on the CPU) at its defaults (5 epochs,
# --hidden 1024, capped to 64 components) on sklearn's digits: 92.22%
MNIST_JAX_ACCURACY = 92.22
MNIST_TOLERANCE = 3.0           # points; the Oja basis starts elsewhere


def states_equal(a, b):
    import torch
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b))


def clone_state(state):
    return type(state)(*[t.clone() for t in state])


def nonzero_counts(counts):
    return {k: v for k, v in counts.items() if v}


def sharded_bank_check(dev, mesh):
    """retrieve_sharded on phase 2's bank as shard 0 against retrieve_auto
    at B = 1, 8 and 1024: equal results and kernel launches, ms per call
    of both and of the merge alone; then the sharded write, rebuild and
    decay against the engine's on a small bank."""
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.memory import engine, sharded
    from aura_snn_rag_tpu_torch.ops.cuda import _build

    cfg = port.MemoryConfig(**ENGINE)
    state, queries = engine_state(dev, cfg, N_EVAL, 256, {})
    out = {}
    for B in SHARDED_BATCHES:
        q = queries[:B]
        _build.reset_launch_counts()
        plain = engine.retrieve_auto(cfg, state, q, None, TOPK)
        torch.cuda.synchronize()
        n_plain = nonzero_counts(_build.launch_counts)
        _build.reset_launch_counts()
        got = sharded.retrieve_sharded(cfg, mesh, state, q, TOPK)
        torch.cuda.synchronize()
        n_sharded = nonzero_counts(_build.launch_counts)
        check(all(torch.equal(getattr(got, f), getattr(plain, f))
                  for f in ("indices", "scores", "features")),
              f"sharded: retrieve_sharded at B={B} differs from "
              f"retrieve_auto")
        check(n_sharded == n_plain, f"sharded: launches at B={B} "
              f"{n_sharded}, retrieve_auto {n_plain}")
        if B in (1, 8):
            check(n_sharded == {"ivf_retrieve_fused": 1},
                  f"sharded: B={B} launched {n_sharded}, expected kernel B "
                  f"once")
        merge_ms = wall_ms(lambda: sharded._merge_topk(
            plain.scores, plain.indices, plain.features, TOPK,
            mesh.get_group("data"), False, narrow=True), SHARDED_REPS)
        out[f"b{B}"] = dict(
            launches=n_sharded,
            retrieve_auto_ms=wall_ms(lambda: engine.retrieve_auto(
                cfg, state, q, None, TOPK), SHARDED_REPS),
            retrieve_sharded_ms=wall_ms(lambda: sharded.retrieve_sharded(
                cfg, mesh, state, q, TOPK), SHARDED_REPS),
            merge_ms=merge_ms)
        log(f"sharded bank B={B}: equal to retrieve_auto bit for bit, "
            f"launches {n_sharded}; ms per call retrieve_auto "
            f"{out[f'b{B}']['retrieve_auto_ms']:.3f}, retrieve_sharded "
            f"{out[f'b{B}']['retrieve_sharded_ms']:.3f}, merge alone "
            f"{merge_ms:.3f}")
    del state, queries
    torch.cuda.empty_cache()

    # the write, rebuild and decay on a small bank, against the engine's
    small = port.MemoryConfig(**SHARDED_SMALL)
    gen = torch.Generator(device=dev).manual_seed(5)
    feats, _ = make_data(dev, gen, 33_024, small.feature_dim, n_centers=64)
    locs = torch.zeros(len(feats), small.spatial_dims, device=dev)
    a = sharded.init_sharded_memory(small, mesh)
    b = port.init_memory_state(small, dev)
    steps = (
        ("write", lambda st: sharded.write_memories_sharded(
            small, mesh, st, feats[:32_768], locs[:32_768]),
         lambda st: engine.write_memories(small, st, feats[:32_768],
                                          locs[:32_768])),
        ("rebuild", lambda st: sharded.rebuild_centroids_sharded(
            small, mesh, st, 0),
         lambda st: engine.rebuild_centroids(
             small, st, torch.Generator().manual_seed(0))),
        ("live write", lambda st: sharded.write_memories_sharded(
            small, mesh, st, feats[32_768:], locs[32_768:]),
         lambda st: engine.write_memories(small, st, feats[32_768:],
                                          locs[32_768:])),
        ("decay", lambda st: sharded.decay_memories_sharded(st, 0.05),
         lambda st: engine.decay_memories(st, 0.05)))
    with deterministic():
        for name, fa, fb in steps:
            a, b = fa(a), fb(b)
            check(states_equal(a, b), f"sharded: {name} differs from the "
                  f"engine's")
    check(bool(a.index_ready), "sharded: small bank not indexed")
    out["small_bank_equal"] = True
    log(f"sharded bank: write, rebuild, live write and decay on a "
        f"{small.max_memories} x {small.feature_dim} shard equal the "
        f"engine's bit for bit")
    return out


def dp_train_check(dev, mesh, tmp):
    """A data-parallel trainer (shard_to_mesh) and a plain one from the
    same weights over the same bank, SHARDED_STEPS train_steps each with
    memory: launches, losses and every tensor equal; then a checkpoint of
    the sharded one restored into a fresh one. Returns (stats, the
    restored trainer)."""
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager

    cfg = train_config()
    # the thalamus gate off, so memory stays on at every step
    cfg = cfg.replace(training=dataclasses.replace(cfg.training,
                                                   enable_thalamus=False))
    n_layers, accum = cfg.model.num_layers, \
        cfg.training.gradient_accumulation_steps
    B, L = cfg.training.batch_size, TRAIN_SEQ
    bank = lm_bank(dev, cfg.memory)
    g = torch.Generator(device=dev).manual_seed(12)
    ids = torch.randint(0, cfg.model.vocab_size, (B, L), device=dev,
                        generator=g)
    out = {}
    trainers = {}
    with deterministic():
        sharded_tr = port.Trainer(cfg, seed=7, device=dev)
        sharded_tr.shard_to_mesh(mesh)
        sharded_tr.hippocampus._set_state(clone_state(bank))
        plain_tr = port.Trainer(cfg, seed=7, device=dev)
        plain_tr.hippocampus._set_state(bank)
        for name, tr in (("sharded", sharded_tr), ("plain", plain_tr)):
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(SHARDED_STEPS):
                t0 = time.perf_counter()
                m = tr.train_step(ids, ids)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                check(m["use_memory"], f"{name} trainer: memory off")
            launches = nonzero_counts(_build.launch_counts)
            want = n_layers * accum * SHARDED_STEPS
            check(launches == {"ivf_retrieve_fused": want},
                  f"{name} trainer: launches {launches}, expected kernel B "
                  f"{n_layers} x {accum} x {SHARDED_STEPS} = {want}")
            trainers[name] = tr
            out[name] = dict(
                launches=launches, ms_per_step=times,
                ms_per_step_after_first=sum(times[1:]) / (len(times) - 1),
                max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                losses=tr.history["loss"][1:]
                + [tr.latest_metrics()["loss"]])
    differ = tensors_differ(sharded_tr, plain_tr)
    check(out["sharded"]["losses"] == out["plain"]["losses"] and not differ,
          f"sharded trainer differs from the plain one: losses "
          f"{out['sharded']['losses']} / {out['plain']['losses']}, tensors "
          f"{differ}")
    log(f"sharded training: {SHARDED_STEPS} train_steps each, kernel B "
        f"{out['sharded']['launches']} / {out['plain']['launches']}, losses "
        f"equal {[round(x, 6) for x in out['sharded']['losses']]}, every "
        f"tensor equal; ms per step after the first "
        f"{out['sharded']['ms_per_step_after_first']:.1f} / "
        f"{out['plain']['ms_per_step_after_first']:.1f}, peak "
        f"{out['sharded']['max_memory_gb']:.2f} / "
        f"{out['plain']['max_memory_gb']:.2f} GB (sharded / plain)")
    del plain_tr, trainers, bank
    torch.cuda.empty_cache()

    ckpt = CheckpointManager(os.path.join(tmp, "sharded_ckpt"))
    _, out["save_s"] = synced(lambda: ckpt.save(
        SHARDED_STEPS, sharded_tr, out["sharded"]["losses"][-1]))
    restored = port.Trainer(cfg, seed=8, device=dev)
    restored.shard_to_mesh(mesh)
    step, out["restore_s"] = synced(lambda: ckpt.restore(restored))
    differ = tensors_differ(sharded_tr, restored)
    check(step == SHARDED_STEPS and not differ,
          f"sharded checkpoint: step {step}, tensors differ {differ}")
    log(f"sharded checkpoint: saved in {out['save_s']:.2f} s, restored in "
        f"{out['restore_s']:.2f} s, every tensor equal bit for bit")
    del sharded_tr
    torch.cuda.empty_cache()
    return out, restored


def utils_check(dev, trainer, tmp):
    """The utils on the card: memory stats, a trace of one decode step
    naming kernel B's CUDA functions, StepTimer over decode steps, the
    EnergyTracker over a spiking FFN's spikes."""
    import glob
    import torch
    from aura_snn_rag_tpu_torch.generation.sampler import sample_token
    from aura_snn_rag_tpu_torch.utils import (
        EnergyTracker, StepTimer, get_memory_stats, trace)

    out = {}
    mem = get_memory_stats()
    check(mem["bytes_in_use"] == torch.cuda.memory_allocated(),
          f"get_memory_stats {mem} against memory_allocated "
          f"{torch.cuda.memory_allocated()}")
    out["memory_stats"] = mem

    model, state = trainer.model.eval(), trainer.hippocampus.state
    spikes = []
    snn = model.layers[0].ffn.snn
    hook = snn.syn2.register_forward_pre_hook(
        lambda mod, args: spikes.append(args[0].detach()))
    B, L = LM_SERVE["batch_size"], LM_SERVE["prompt_pad"]
    gen = torch.Generator(device=dev).manual_seed(21)
    ids = torch.randint(0, model.config.vocab_size, (B, L), device=dev,
                        generator=gen)
    pos = [L]

    def step(tok, caches):
        o, caches = model(tok[:, None], memory_state=state,
                          positions=torch.full((B, 1), pos[0], device=dev),
                          kv_caches=caches, cache_index=pos[0])
        pos[0] += 1
        return sample_token(gen, o.logits[:, 0], 0.8, 50, 0.9), caches

    sharded_fn = model.layers[0].retrieve_fn
    timers = {}
    try:
        with torch.no_grad():
            caches = model.init_kv_caches(B, model.config.max_seq_len)
            o, caches = model(ids, memory_state=state, kv_caches=caches,
                              cache_index=0)
            tok = o.logits[:, -1].argmax(-1)
            tok, caches = step(tok, caches)                    # warm-up
            # decode steps through the sharded adapter, then through
            # retrieve_auto on the same bank
            for name, fn in (("sharded", sharded_fn), ("plain", None)):
                set_retrieve_fn(model, fn)
                timers[name] = StepTimer()
                for _ in range(TRACE_STEPS):
                    fence = []
                    with timers[name].measure(fence):
                        tok, caches = step(tok, caches)
                        fence.append(tok)
            torch.cuda.synchronize()
            trace_dir = os.path.join(tmp, "trace")
            with trace(trace_dir):
                tok, caches = step(tok, caches)
                torch.cuda.synchronize()
    finally:
        hook.remove()
        set_retrieve_fn(model, sharded_fn)
        model.train()
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    check(len(files) == 1, f"trace wrote {files}")
    with open(files[0]) as f:
        text = f.read()
    names = [k for k in ("ivf_coarse_kernel", "ivf_select_rerank_kernel")
             if k in text]
    check(len(names) == 2, f"trace of a decode step names {names} of "
          f"kernel B's CUDA functions")
    out["trace_bytes"] = len(text)
    out["step_timer"] = {k: t.summary() for k, t in timers.items()}
    tracker = EnergyTracker()
    for s in spikes:
        tracker.record("layer0.snn", s, fan_out=snn.syn2.kernel.shape[1])
    energy = tracker.summary()
    check(energy["components"] == 1 and math.isfinite(
        energy["total_spiking_pj"]), f"energy tracker: {energy}")
    out["energy"] = dict(energy, spike_rate=float(
        sum(s.float().mean() for s in spikes) / len(spikes)))
    log(f"utils: get_memory_stats {mem['bytes_in_use'] / 1e9:.2f} GB in "
        f"use = memory_allocated; trace of one decode step ({len(text)} "
        f"bytes) names {names}; StepTimer over {TRACE_STEPS} decode steps "
        f"at B={B}, p50 / p95 ms: "
        + ", ".join(f"{k} {v['p50_ms']:.2f} / {v['p95_ms']:.2f}"
                    for k, v in out["step_timer"].items())
        + f"; energy {out['energy']}")
    return out


def sharded_phase(dev):
    """Phase 10: the sharded bank and data-parallel training on a one-rank
    process group (NCCL on the card), the utils and the CLI's mnist; see
    the module doc. Launch counters are zeroed inside, around each call
    they check."""
    import tempfile
    import torch
    from aura_snn_rag_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0,
                           device=dev.type, timeout=300)
    try:
        mesh = distributed.global_mesh(1)
        stats = {"bank": sharded_bank_check(dev, mesh)}
        with tempfile.TemporaryDirectory() as tmp:
            stats["train"], restored = dp_train_check(dev, mesh, tmp)
            stats["utils"] = utils_check(dev, restored, tmp)
        del restored
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    stdout, seconds = cli_run(["mnist"], OPERATOR_CLI_TIMEOUT)
    result = json.loads(stdout.strip().splitlines()[-1])
    check(abs(result["value"] - MNIST_JAX_ACCURACY) <= MNIST_TOLERANCE,
          f"mnist: {result['value']}% against the JAX script's "
          f"{MNIST_JAX_ACCURACY}%")
    stats["mnist"] = dict(result, cli_s=seconds)
    stats["phase_s"] = time.perf_counter() - t0
    log(f"mnist via the CLI: {result['value']}% on {result['dataset']} "
        f"(JAX {MNIST_JAX_ACCURACY}%), {seconds:.1f} s; sharded phase "
        f"{stats['phase_s']:.1f} s")
    return stats


# --------------------------------------------------------------------------
# model-parallel phase (phase 11)
# --------------------------------------------------------------------------

# ring attention at the LM's shapes (get_full_config: 12 heads of 64, L =
# 512, B = 8): the forward and the q/k/v gradients against SDPA within
# these fractions of each tensor's largest entry (f32 with TF32 off; bf16
# at the bound phase 4 puts on prefill logits)
MP_RING = dict(B=8, L=512, H=12, Dh=64)
MP_RING_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
MP_RING_REPS = 5
MP_GREEDY = 1e-6                # the sampler's floor: a greedy draw
MP_DECODE_STEPS = 15            # decode steps per server timing
MP_MICROBATCHES = 4             # of phase 5's micro-batch of 8
MP_TRAIN_STEPS = 2
MP_ZONE_T = 256                 # MoELanguageZone at B = 8, T = 256


def mp_mesh(names):
    """A one-rank mesh with `names` (every axis of size 1)."""
    import numpy as np
    from aura_snn_rag_tpu_torch.parallel.distributed import mesh_from_ranks
    return mesh_from_ranks(np.zeros((1,) * len(names), dtype=np.int64),
                           names)


def server_step_ms(server, reqs, steps=MP_DECODE_STEPS):
    """ms per decode step of a server's batch: (time of 1 + steps tokens -
    time of 1 token) / steps through `generate_batch`, after a warm-up."""
    from aura_snn_rag_tpu_torch.generation import GenerationRequest

    def batch(n):
        return [GenerationRequest(ids, n, MP_GREEDY, 1.0)
                for ids, _, _ in reqs]
    server.generate_batch(batch(2))
    _, t1 = synced(lambda: server.generate_batch(batch(1)))
    _, tn = synced(lambda: server.generate_batch(batch(1 + steps)))
    return (tn - t1) / steps * 1e3


def mp_serve_check(dev, mesh, model, state, n_layers):
    """Phase 4's requests, greedy, through a BatchedGenerator on the mesh
    and through a plain one: the same tokens, kernel B 12 x (1 + steps)
    per batch in each, and ms per decode step of both."""
    import torch
    from aura_snn_rag_tpu_torch.generation import (
        BatchedGenerator, GenerationRequest)
    from aura_snn_rag_tpu_torch.ops.cuda import _build

    reqs = lm_requests(model.config.vocab_size,
                       torch.Generator().manual_seed(11))
    out, tokens = {}, {}
    for name, kw in (("plain", {}), ("mesh", dict(mesh=mesh))):
        server = BatchedGenerator(model, memory_state=state,
                                  generator=torch.Generator(device=dev)
                                  .manual_seed(3), **LM_SERVE, **kw)
        toks, launches, secs = [], [], []
        for batch in (reqs[:LM_SERVE["batch_size"]],
                      reqs[LM_SERVE["batch_size"]:]):
            rs = [GenerationRequest(ids, n, MP_GREEDY, 1.0)
                  for ids, n, _ in batch]
            _build.reset_launch_counts()
            got, sec = synced(lambda: server.generate_batch(rs))
            n = _build.launch_counts["ivf_retrieve_fused"]
            want = n_layers * server._bucket(max(r.max_new_tokens
                                                 for r in rs))
            check(n == want and nonzero_counts(_build.launch_counts)
                  == {"ivf_retrieve_fused": n},
                  f"{name} server: kernel B launched {n} times, expected "
                  f"12 x (1 + steps) = {want}")
            toks += got
            launches.append(n)
            secs.append(sec)
        tokens[name] = toks
        out[name] = dict(kernel_B_launches=launches, batch_s=secs,
                         ms_per_decode_step=server_step_ms(
                             server, reqs[:LM_SERVE["batch_size"]]))
    check(all((a == b).all() for a, b in zip(tokens["plain"],
                                              tokens["mesh"])),
          "the server on the mesh decodes other tokens than the plain one")
    log(f"model-parallel serving: {len(reqs)} greedy requests, tokens equal "
        f"to the plain server's; kernel B {out['mesh']['kernel_B_launches']}"
        f" per batch; ms per decode step at B = 8 "
        f"{out['mesh']['ms_per_decode_step']:.2f} (mesh) / "
        f"{out['plain']['ms_per_decode_step']:.2f} (plain)")
    return out


def mp_ring_check(dev, mesh):
    """sequence_sharded_attention against SDPA (causal) at the LM's
    shapes, f32 and bf16: forward and q/k/v gradients, ms of each."""
    import torch
    import torch.nn.functional as F
    from aura_snn_rag_tpu_torch.parallel.ring_attention import (
        sequence_sharded_attention)

    r = MP_RING
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        gen = torch.Generator(device=dev).manual_seed(21)
        q, k, v, do = (torch.randn(r["B"], r["L"], r["H"], r["Dh"],
                                   device=dev, generator=gen).to(dt)
                       for _ in range(4))

        def ring(q, k, v):
            return sequence_sharded_attention(
                q, k, v, mesh, batch_axes=("data",), head_axis="model")

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in (q, k, v)),
                is_causal=True).transpose(1, 2)

        def run(fn):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves)
            o.backward(do)
            return [o.detach()] + [t.grad for t in leaves]

        got, want = run(ring), run(sdpa)
        errs = [((a.float() - b.float()).abs().max()
                 / b.float().abs().max()).item() for a, b in zip(got, want)]
        check(max(errs) <= MP_RING_TOL[name],
              f"ring attention {name}: (out, dq, dk, dv) differ from SDPA by "
              f"{errs} of each tensor's largest entry (tolerance "
              f"{MP_RING_TOL[name]})")
        with torch.no_grad():
            fwd = {fn.__name__: time_ms([lambda f=fn: f(q, k, v)],
                                        iters=MP_RING_REPS)
                   for fn in (ring, sdpa)}
        fb = {fn.__name__: wall_ms(lambda f=fn: run(f), MP_RING_REPS)
              for fn in (ring, sdpa)}
        out[name] = dict(rel_err=errs, ring_ms=fwd["ring"],
                         sdpa_ms=fwd["sdpa"], ring_fwd_bwd_ms=fb["ring"],
                         sdpa_fwd_bwd_ms=fb["sdpa"])
        log(f"ring attention {name} at B={r['B']} L={r['L']} H={r['H']} "
            f"Dh={r['Dh']}: (out, dq, dk, dv) within "
            f"{[f'{e:.2g}' for e in errs]} of SDPA; forward ms ring "
            f"{fwd['ring']:.3f} / SDPA {fwd['sdpa']:.3f}, forward + "
            f"backward {fb['ring']:.2f} / {fb['sdpa']:.2f}")
    return out


def mp_pipeline_check(dev, model, state):
    """pipelined_rag_apply over a one-stage mesh with MP_MICROBATCHES
    microbatches of phase 5's micro-batch of 8 against the model's plain
    forward over the same bank: logits, kernel B launches (12 x M), one
    loss and its gradients (phase 5's RMS bound), ms of each forward."""
    import torch
    from aura_snn_rag_tpu_torch.models.pipelined import pipelined_rag_apply
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    from aura_snn_rag_tpu_torch.training.losses import hippocampal_loss

    mesh = mp_mesh(("stage",))
    M, n_layers = MP_MICROBATCHES, len(model.layers)
    ids = torch.randint(0, model.config.vocab_size, (8, TRAIN_SEQ),
                        device=dev,
                        generator=torch.Generator(device=dev).manual_seed(13))

    def pipelined():
        return pipelined_rag_apply(model, ids, state, mesh, M)

    def plain():
        return model(ids, memory_state=state)[0].logits
    out = {}
    with torch.no_grad():
        for name, fn, want in (("pipelined", pipelined, n_layers * M),
                               ("plain", plain, n_layers)):
            _build.reset_launch_counts()
            logits = fn()
            torch.cuda.synchronize()
            launches = nonzero_counts(_build.launch_counts)
            check(launches == {"ivf_retrieve_fused": want},
                  f"{name} forward: launches {launches}, expected kernel B "
                  f"{want}")
            out[name] = dict(kernel_B_launches=want, logits=logits)
        gap = (out["pipelined"].pop("logits")
               - out["plain"].pop("logits")).abs().max().item()
        check(gap <= LM_LOGIT_TOL, f"pipelined logits differ from the plain "
              f"forward's by {gap} > {LM_LOGIT_TOL}")
        for name, fn in (("pipelined", pipelined), ("plain", plain)):
            out[name]["ms"] = wall_ms(fn, 3)

    def grads(fn):
        for p in model.parameters():
            p.grad = None
        loss = hippocampal_loss(fn()[:, :-1], ids[:, 1:], None,
                                label_smoothing=0.0, entropy_lambda=0.0,
                                sparsity_lambda=0.0)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}
    la, ga = grads(pipelined)
    lb, gb = grads(plain)
    for p in model.parameters():
        p.grad = None

    def rms(x):
        return x.float().pow(2).mean().sqrt().item()
    floor = 1e-3 * max(rms(g) for g in gb.values())
    rel = {n: rms(ga[n] - gb[n]) / max(rms(gb[n]), floor) for n in gb}
    worst = max(rel, key=rel.get)
    check(set(ga) == set(gb) and rel[worst] <= TRAIN_GRAD_RTOL
          and abs(la - lb) <= 1e-3 * abs(lb),
          f"pipelined step: loss {la} / {lb}; {worst}'s gradient differs "
          f"by {rel[worst]:.3g} of its RMS (tolerance {TRAIN_GRAD_RTOL})")
    out.update(max_logit_diff=gap, loss=[la, lb], max_rms_gap=rel[worst],
               worst=worst)
    log(f"pipelined RAG, 1 stage x {M} microbatches of {8 // M}: logits "
        f"within {gap:.3g} of the plain forward, kernel B "
        f"{out['pipelined']['kernel_B_launches']} / "
        f"{out['plain']['kernel_B_launches']} launches; loss {la:.6f} / "
        f"{lb:.6f}, gradient RMS gap at most {rel[worst]:.3g} ({worst}); "
        f"forward ms {out['pipelined']['ms']:.1f} / "
        f"{out['plain']['ms']:.1f}")
    return out


def mp_expert_check(dev, mesh):
    """MoELanguageZone(32000) with its experts placed by shard_params on a
    one-rank ('data', 'model') mesh against the unsharded zone: outputs
    equal bit for bit, ms of each."""
    import copy
    import torch
    from aura_snn_rag_tpu_torch.models.language_zone import MoELanguageZone
    from aura_snn_rag_tpu_torch.parallel.mesh import shard_params

    zone = MoELanguageZone(NB_VOCAB, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(31))
    ep = shard_params(copy.deepcopy(zone), mesh)
    ids = torch.randint(0, NB_VOCAB, (NB_BATCH, MP_ZONE_T), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))

    def run(m):
        return m(ids, torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        (a, ia), (b, ib) = run(zone), run(ep)
        check(torch.equal(a, b) and torch.equal(ia["dropped_fraction"],
                                                ib["dropped_fraction"]),
              "expert-parallel zone differs from the unsharded one")
        out = dict(ms=wall_ms(lambda: run(ep), 3),
                   plain_ms=wall_ms(lambda: run(zone), 3),
                   dropped_fraction=float(ia["dropped_fraction"]))
    log(f"expert parallelism: MoELanguageZone({NB_VOCAB}) at B={NB_BATCH} "
        f"T={MP_ZONE_T} on the mesh equals the unsharded zone bit for bit; "
        f"ms {out['ms']:.1f} / {out['plain_ms']:.1f}")
    return out


def mp_train_check(dev, bank):
    """Trainer.shard_to_mesh on a one-rank ('data', 'seq', 'model',
    'stage') mesh against a plain trainer from the same seed over the
    same bank: MP_TRAIN_STEPS train_steps each under deterministic
    algorithms, kernel B 12 x 2 per step, losses and every tensor equal
    bit for bit."""
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.ops.cuda import _build

    cfg = train_config()
    cfg = cfg.replace(training=dataclasses.replace(cfg.training,
                                                   enable_thalamus=False))
    n_layers = cfg.model.num_layers
    accum = cfg.training.gradient_accumulation_steps
    ids = torch.randint(0, cfg.model.vocab_size,
                        (cfg.training.batch_size, TRAIN_SEQ), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(12))
    out = {}
    with deterministic():
        mp_tr = port.Trainer(cfg, seed=7, device=dev)
        mp_tr.shard_to_mesh(mp_mesh(("data", "seq", "model", "stage")))
        mp_tr.hippocampus._set_state(clone_state(bank))
        plain_tr = port.Trainer(cfg, seed=7, device=dev)
        plain_tr.hippocampus._set_state(clone_state(bank))
        for name, tr in (("mesh", mp_tr), ("plain", plain_tr)):
            _build.reset_launch_counts()
            times = []
            for _ in range(MP_TRAIN_STEPS):
                m, sec = synced(lambda: tr.train_step(ids, ids))
                check(m["use_memory"], f"{name} trainer: memory off")
                times.append(sec * 1e3)
            launches = nonzero_counts(_build.launch_counts)
            want = n_layers * accum * MP_TRAIN_STEPS
            check(launches == {"ivf_retrieve_fused": want},
                  f"{name} trainer: launches {launches}, expected {want}")
            out[name] = dict(ms_per_step=times, losses=tr.history["loss"][1:]
                             + [tr.latest_metrics()["loss"]])
    differ = tensors_differ(mp_tr, plain_tr)
    check(out["mesh"]["losses"] == out["plain"]["losses"] and not differ,
          f"trainer on the ('data', 'seq', 'model', 'stage') mesh differs "
          f"from the plain one: {out}, tensors {differ}")
    log(f"model-parallel trainer: shard_to_mesh on a one-rank ('data', "
        f"'seq', 'model', 'stage') mesh; {MP_TRAIN_STEPS} steps equal the "
        f"plain trainer's bit for bit, losses "
        f"{[round(x, 6) for x in out['mesh']['losses']]}")
    del mp_tr, plain_tr
    torch.cuda.empty_cache()
    return out


def model_parallel_phase(dev):
    """Phase 11: tensor-parallel serving, ring attention, the pipelined RAG
    stack, expert parallelism and the trainer over 'model', 'seq' and
    'stage' axes, on a one-rank process group (NCCL on the card); see the
    module doc. Launch counters are zeroed inside, around each call they
    check."""
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0,
                           device=dev.type, timeout=300)
    try:
        cfg = port.get_full_config()
        model = port.SNNRAGTransformer.create(
            cfg.model, cfg.memory, device=dev,
            generator=torch.Generator(device=dev).manual_seed(7))
        bank = lm_bank(dev, cfg.memory)
        stats = {"serve": mp_serve_check(
            dev, distributed.global_mesh(1), model, bank,
            cfg.model.num_layers)}
        stats["ring"] = mp_ring_check(dev, mp_mesh(("data", "seq",
                                                    "model")))
        stats["pipeline"] = mp_pipeline_check(dev, model, bank)
        del model
        torch.cuda.empty_cache()
        stats["expert"] = mp_expert_check(dev, mp_mesh(("data", "model")))
        stats["train"] = mp_train_check(dev, bank)
        del bank
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    stats["phase_s"] = time.perf_counter() - t0
    log(f"model-parallel phase: {stats['phase_s']:.1f} s")
    return stats


# --------------------------------------------------------------------------
# bench phase (phase 12): the port's counterpart of bench.py
# --------------------------------------------------------------------------

def bench_run(argv, expect):
    """The port's bench in this process at `argv`, the launch counts
    zeroed just before it and read just after; fails unless they equal
    `expect` (kernel -> launches, no other kernel). Returns its stats:
    the JSON object, launches, seconds, the IVF recall@10 of the first
    n_eval timed queries against the device's exact search."""
    import numpy as np
    import torch
    from aura_snn_rag_tpu_torch import bench as port_bench
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = port_bench.run(argv)
    seconds = time.perf_counter() - t0
    launches = {name: n for name, n in _build.launch_counts.items() if n}
    line, eng = res.line, res.engine
    log(f"bench {' '.join(argv) or '(defaults)'}: {seconds:.1f} s, "
        f"launches {launches}")
    log(json.dumps(line))
    check(launches == expect, f"bench {argv}: launches {launches}, "
          f"expected {expect}")
    check(tuple(line) == BENCH_KEYS, f"bench {argv}: keys {list(line)}")
    for key in ("recall_at_10", "recall_at_10_vs_f32_data"):
        check(line[key] >= BENCH_RECALL,
              f"bench {argv}: {key} = {line[key]} < {BENCH_RECALL}")
    # the IVF results of every timed batch: finite, and those of the
    # first n_eval queries against the device's exact search
    check(eng.ivf_idx.shape == eng.approx_idx.shape
          and bool((eng.ivf_idx >= 0).all())
          and bool(np.isfinite(eng.ivf_scores).all()), f"bench {argv}: "
          f"IVF results {eng.ivf_idx.shape}")
    ivf_recall = recall_at_k(torch.from_numpy(eng.ivf_idx[:eng.n_eval]),
                             torch.from_numpy(eng.exact_idx))
    log(f"bench {' '.join(argv) or '(defaults)'}: IVF recall@10 "
        f"{ivf_recall:.4f} over {eng.n_eval} queries")
    return dict(line=line, launches=launches, seconds=seconds,
                ivf_recall_at_10=ivf_recall,
                queries=int(eng.approx_idx.shape[0]))


def bench_phase():
    """Phase 12: the port's bench at bench.py's defaults, then `--small
    --flat-strategy=blockmax`, then the CLI's `bench --small`."""
    import torch
    t_phase = time.perf_counter()
    stats = {}
    # bench.py's defaults: 1 warm-up + 16 timed IVF batches through B
    stats["full"] = bench_run([], {"ivf_retrieve_fused": 17})
    check(stats["full"]["ivf_recall_at_10"] >= BENCH_IVF_RECALL,
          f"bench: IVF recall@10 {stats['full']['ivf_recall_at_10']} < "
          f"{BENCH_IVF_RECALL}")
    check(stats["full"]["queries"] == 16 * 1024
          and stats["full"]["line"]["n_vectors"] == 1_000_000,
          "bench: not bench.py's defaults")
    torch.cuda.empty_cache()
    # the blockmax flat strategy at --small: A and B 1 + 8 times each
    stats["blockmax"] = bench_run(
        ["--small", "--flat-strategy=blockmax"],
        {"flat_blockmax": 9, "ivf_retrieve_fused": 9})
    torch.cuda.empty_cache()
    # the CLI's bench in a subprocess
    out, seconds = cli_run(["bench", "--small"], BENCH_CLI_TIMEOUT)
    line = json.loads(out.strip().splitlines()[-1])
    check(tuple(line) == BENCH_KEYS, f"cli bench: keys {list(line)}")
    stats["cli"] = dict(line=line, seconds=seconds)
    log(f"cli bench --small: {seconds:.1f} s; {json.dumps(line)}")
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"bench phase: {stats['phase_s']:.1f} s")
    return stats


# --------------------------------------------------------------------------
# benchmarks phase (phase 13): the ports of the repo's benchmark scripts
# --------------------------------------------------------------------------

def benchmark_run(name, argv, package="benchmarks"):
    """`aura_snn_rag_tpu_torch.<package>.<name>.run(argv)` in this
    process, the launch counts zeroed just before it and read just after:
    (its result, {kernel: launches} of the kernels that ran, seconds)."""
    import importlib
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    module = importlib.import_module(
        f"aura_snn_rag_tpu_torch.{package}.{name}")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = module.run(argv)
    seconds = time.perf_counter() - t0
    launches = {k: n for k, n in _build.launch_counts.items() if n}
    log(f"{name} {' '.join(argv) or '(defaults)'}: {seconds:.1f} s, "
        f"launches {launches}")
    return res, launches, seconds


def check_launches(name, launches, expect):
    want = {k: n for k, n in expect.items() if n}
    check(launches == want, f"{name}: launches {launches}, expected {want} "
          f"and no other kernel")


def check_keys(name, obj, keys):
    check(tuple(obj) == tuple(keys), f"{name}: keys {list(obj)}, expected "
          f"{list(keys)}")


def tokens_ok(name, ids, vocab):
    import torch
    check(ids.dtype == torch.long and bool(((ids >= 0) & (ids < vocab))
                                           .all()),
          f"{name}: tokens outside [0, {vocab})")


def benchmarks_phase():
    """Phase 13: each of the eight benchmark modules in this process, its
    launches counted around its run; see the module doc."""
    import math
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    stats = {}

    # S1: the spilled tier at --small (1M x 768) with the breakdown
    res, launches, seconds = benchmark_run("bench_host_spill",
                                        ["--small", "--breakdown"])
    (m,) = res.configs
    check_keys("bench_host_spill", m.line, SPILL_KEYS)
    check_keys("bench_host_spill breakdown", m.breakdown,
               SPILL_BREAKDOWN_KEYS)
    check_keys("bench_host_spill stages", m.breakdown[
        "breakdown_per_batch_ms"], SPILL_STAGES)
    check(m.line["n_vectors"] == 1_000_000 and res.truth.shape[0] ==
          min(256, len(res.queries)), "bench_host_spill: not --small")
    check(m.line["recall_at_10"] >= SPILL_RECALL,
          f"bench_host_spill: recall@10 {m.line['recall_at_10']} < "
          f"{SPILL_RECALL}")
    chunk = m.line["query_chunk"]
    check_launches("bench_host_spill", launches, {
        "flat_blockmax": sum(-(-b // chunk) for b in m.dispatches)})
    stats["spill"] = dict(line=m.line, breakdown=m.breakdown,
                          launches=launches, seconds=seconds)
    del res
    torch.cuda.empty_cache()

    # S2: the sharded check on one NCCL rank
    res, launches, seconds = benchmark_run("bench_sharded_scaling", ["--n=1"])
    check_keys("bench_sharded_scaling", res.line, SHARDED_KEYS)
    check(res.line["topk_agreement_vs_flat"] == 1.0,
          f"bench_sharded_scaling: agreement "
          f"{res.line['topk_agreement_vs_flat']}")
    analytic = res.line["analytic_allgather_bytes"]
    check(res.line["collective_bytes_per_batch"] == {"all-gather": analytic}
          and res.line["collective_bytes_total"] == analytic,
          f"bench_sharded_scaling: counted "
          f"{res.line['collective_bytes_per_batch']}, analytic {analytic}")
    check_launches("bench_sharded_scaling", launches, {})
    # the port's `bench --sharded=1` hands the check over on its default
    # device, the card
    from aura_snn_rag_tpu_torch import bench as bench_mod
    handed = bench_mod.run(["--sharded=1"]).line
    check(handed["n_shards"] == 1
          and handed["topk_agreement_vs_flat"] == 1.0
          and handed["collective_bytes_total"] == analytic,
          f"bench --sharded=1: {handed}")
    stats["sharded"] = dict(line=res.line, launches=launches,
                            seconds=seconds)
    torch.cuda.empty_cache()

    # S3a: IVF against flat at the defaults (1M x 768; B = 1, 8, 32, 128)
    res, launches, seconds = benchmark_run("bench_retrieval_latency", [])
    batches = (1, 8, 32, 128)
    check_keys("bench_retrieval_latency", res.line,
               ("metric", "n_vectors") + tuple(
                   f"{p}_B{B}" for B in batches for p in ("ivf", "flat")))
    for key, value in res.line.items():
        if key.startswith(("ivf_", "flat_")):
            check_keys(f"bench_retrieval_latency {key}", value,
                       LATENCY_KEYS)
            bar = BENCH_IVF_RECALL if key.startswith("ivf") else BENCH_RECALL
            check(value["recall_at_10"] >= bar,
                  f"bench_retrieval_latency: {key} recall@10 "
                  f"{value['recall_at_10']} < {bar}")
    check_launches("bench_retrieval_latency", launches, {
        "ivf_retrieve_fused": sum(n for key, n in res.calls.items()
                                  if key.startswith("ivf_"))})
    stats["latency"] = dict(line=res.line, launches=launches,
                            seconds=seconds)
    del res
    torch.cuda.empty_cache()

    # S3b: the stage breakdown at the defaults (B = 1 and 8)
    res, launches, seconds = benchmark_run("bench_retrieval_breakdown", [])
    check_keys("bench_retrieval_breakdown", res.line,
               ("metric", "n_vectors", "probe", "bucket_capacity", "per_k",
                "B1", "B8"))
    expect = {}
    for B, calls in res.calls.items():
        check_keys(f"bench_retrieval_breakdown B{B}", res.line[f"B{B}"],
                   STAGE_KEYS)
        for stage, kernel in STAGE_KERNELS.items():
            expect[kernel] = expect.get(kernel, 0) + calls[stage]
        for stage, out in res.outputs[B].items():
            for t in (out if isinstance(out, tuple) else (out,)):
                if t.is_floating_point():
                    check(bool(torch.isfinite(t[t > NEG_INF / 2]).all()),
                          f"bench_retrieval_breakdown: {stage} at B={B} "
                          f"not finite")
    check_launches("bench_retrieval_breakdown", launches, expect)
    stats["breakdown"] = dict(line=res.line, launches=launches,
                              seconds=seconds)
    del res
    torch.cuda.empty_cache()

    # S4: the LM's benchmarks at --preset full, cut (printed); no bank in the
    # decode models, and the training step's batch of 16 takes the flat
    # scan: no kernel of the port's runs
    for name, argv in LM_BENCHMARK_ARGS.items():
        log(f"{name}: cut to {' '.join(argv)}")
        res, launches, seconds = benchmark_run(name, argv)
        line = res.line
        if name == "bench_decode":
            check_keys(name, line, ("metric", "preset", "new_tokens", "B1",
                                    "B8", "B32"))
            for B, ids in res.tokens.items():
                check_keys(f"{name} B{B}", line[f"B{B}"], DECODE_KEYS)
                check(ids.shape == (B, 32 + 8), f"{name}: {ids.shape}")
                tokens_ok(name, ids, res.vocab_size)
        elif name == "bench_generation":
            check_keys(name, line, GENERATION_KEYS)
            check(res.cached.shape == (8, 64 + 8), f"{name}: "
                  f"{res.cached.shape}")
            tokens_ok(name, res.cached, res.vocab_size)
            tokens_ok(name, res.context, res.vocab_size)
        elif name == "bench_decode_breakdown":
            check_keys(name, line, DECODE_BREAKDOWN_KEYS)
            check_keys(f"{name} ms_per_token", line["ms_per_token"],
                       DECODE_VARIANTS)
            for variant, ids in res.outputs.items():
                tokens_ok(f"{name} {variant}", ids, res.vocab_size)
            check(all(math.isfinite(v) and v > 0
                      for v in line["ms_per_token"].values()),
                  f"{name}: {line['ms_per_token']}")
        else:
            check_keys(name, line, RAG_OVERHEAD_KEYS)
            check(bool(np.isfinite(res.losses).all()) and len(res.losses)
                  == 3 * (1 + 2), f"{name}: losses {res.losses}")
            check(line["n_params"] > 200e6 and line["seq_len"] == 512,
                  f"{name}: not the full preset")
        check_launches(name, launches, {})
        stats[name] = dict(line=line, launches=launches, seconds=seconds)
        del res
        torch.cuda.empty_cache()
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"benchmarks phase: {stats['phase_s']:.1f} s")
    return stats


# --------------------------------------------------------------------------
# drivers phase II (phase 14): the flat, transfer, brain and emotion
# benchmarks and the operator's tools
# --------------------------------------------------------------------------

FLAT_KERNEL_KEYS = ("name", "ms_per_batch", "gb_s_eff", "qps_coarse")
SWEEP_KEYS = ("variant", "batch", "qps", "ms_per_batch", "recall_at_10")
RESCUE_KEYS = ("variant", "qps", "recall_at_10", "n_vectors", "batch")
H2D_KEYS = ("metric", "payload_mb", "f32", "f16", "bf16", "u16", "i8",
            "u8_raw")
PROSODY_KEYS = ("tokens_per_s_uncached", "cache_speedup_pct", "hit_rate")
PROSODY_SWEEP_KEYS = ("config", "total_spikes", "avg_spike_rate",
                      "inference_ms", "spike_ratio_vs_baseline",
                      "winner_utilization", "attention_entropy",
                      "mean_gain")
MOE_KEYS = ("routing_accuracy", "utilization_entropy", "final_loss")
ABLATION_KEYS = ("rows", "baseline_corr", "full_corr", "corr_degradation",
                 "prosody_signal_survives")
ABLATION_ROW_KEYS = ("config", "use_bandit", "usage_beta", "low_entropy",
                     "high_entropy", "gain_entropy_corr", "status")
ENERGY_KEYS = ("per_component", "summary")
EMOTION_KEYS = ("dataset", "n", "n_classes", "n_test", "test_accuracy",
                "test_top3_accuracy", "final_loss", "chance")
DIAG_KEYS = ("lif", "gif", "izhikevich_rs", "adex",
             "izhikevich_pattern_spike_counts")
RUNNER_KEYS = ("stats", "health")
FLAT_RECALL = 0.99              # the flat drivers' rows (the engine's bar)
# kernel A's bf16 surface against its plain version: the kernel phase's
# bound for the same comparison (f32 sums of exact products in another
# order; at bench_flat_kernel's self-matching queries, whose block maxima
# are cosines near 1, the gap measured 1.13e-6)
BF16_SURFACE_TOL = 1e-5


def flat_drivers(tmp):
    """bench_flat_kernel (int8 and bf16), bench_flat_batch_sweep and
    bench_rescue_ab at `--small`; see the module doc."""
    import torch
    from aura_snn_rag_tpu_torch.benchmarks import (
        bench_flat_kernel, bench_flat_batch_sweep)
    from aura_snn_rag_tpu_torch.memory import retrieve_flat
    from aura_snn_rag_tpu_torch.ops.cuda.flat_scan import flat_blockmax_plain
    stats = {}
    M, reps = bench_flat_kernel.sizes(True)
    for dtype, argv in (("int8", ["--small"]), ("bf16", ["--small",
                                                          "--bf16"])):
        res, launches, seconds = benchmark_run("bench_flat_kernel", argv)
        kernel = bench_flat_kernel.KERNEL[dtype]
        check([line["name"] for line in res.lines]
              == [bench_flat_kernel.LIBRARY, kernel],
              f"bench_flat_kernel {dtype}: lines {res.lines}")
        for line in res.lines:
            check_keys("bench_flat_kernel", line, FLAT_KERNEL_KEYS)
        check(res.calls[kernel] == 1 + reps, f"bench_flat_kernel: "
              f"{res.calls[kernel]} kernel calls")
        check_launches(f"bench_flat_kernel {dtype}", launches,
                       {"flat_blockmax": 1 + reps})
        want = flat_blockmax_plain(*res.inputs)
        err = (res.surfaces[kernel] - want).abs().max().item()
        lib_err = (res.surfaces[bench_flat_kernel.LIBRARY]
                   - want).abs().max().item()
        tol = 0.0 if dtype == "int8" else BF16_SURFACE_TOL
        check(res.surfaces[kernel].shape == (bench_flat_kernel.B, M // 8)
              and err <= tol, f"bench_flat_kernel {dtype}: kernel A's "
              f"surface against its plain version: {err} > {tol}")
        b_ms, b_by = blockmax_bound(M, bench_flat_kernel.D,
                                    bench_flat_kernel.B, dtype)
        stats[f"flat_kernel_{dtype}"] = dict(
            lines=res.lines, launches=launches, seconds=seconds,
            max_abs_err=err, library_max_abs_err=lib_err, bound_ms=b_ms,
            bound_by=b_by)
        log(f"bench_flat_kernel {dtype} --small: kernel A "
            f"{res.lines[1]['ms_per_batch']:.4f} ms (bound {b_ms:.4f}, "
            f"{b_by}), library {res.lines[0]['ms_per_batch']:.4f} ms; "
            f"surface err {err} (library's {lib_err})")
        del res, want
        torch.cuda.empty_cache()

    out = os.path.join(tmp, "flat_batch_sweep.json")
    res, launches, seconds = benchmark_run("bench_flat_batch_sweep",
                                           ["--small", "--out", out])
    _, _, _, batches = bench_flat_batch_sweep.sizes(True)
    check(len(res.rows) == len(batches) * len(
        bench_flat_batch_sweep.VARIANTS), f"bench_flat_batch_sweep: "
        f"{len(res.rows)} rows (an error row?)")
    for row in res.rows:
        check_keys("bench_flat_batch_sweep", row, SWEEP_KEYS)
        check(row["recall_at_10"] >= FLAT_RECALL, f"bench_flat_batch_sweep "
              f"{row['variant']} B={row['batch']}: recall@10 "
              f"{row['recall_at_10']} < {FLAT_RECALL}")
    check_launches("bench_flat_batch_sweep", launches, {
        "flat_blockmax": sum(n for (variant, _), n in res.calls.items()
                             if variant == "blockmax")})
    with open(out) as f:
        check(json.load(f) == json.loads(json.dumps(res.summary)),
              "bench_flat_batch_sweep: --out differs from the summary")
    stats["flat_batch_sweep"] = dict(rows=res.rows, winner=res.summary[
        "winner"], launches=launches, seconds=seconds)
    del res
    torch.cuda.empty_cache()

    res, launches, seconds = benchmark_run("bench_rescue_ab", ["--small"])
    check(len(res.lines) == 11, f"bench_rescue_ab: {len(res.lines)} rows")
    for line in res.lines:
        check_keys("bench_rescue_ab", line, RESCUE_KEYS)
        check(line["recall_at_10"] >= FLAT_RECALL, f"bench_rescue_ab "
              f"{line['variant']}: recall@10 {line['recall_at_10']} < "
              f"{FLAT_RECALL}")
    check_launches("bench_rescue_ab", launches, {})
    # the funnel options leave the exact scan as it is: each row's indices
    # are those of the default funnel at its rerank width
    base = res.configs["approx95_kk128"]
    twins = {}
    for name, cfg in res.configs.items():
        plain = dataclasses.replace(
            cfg, flat_funnel_recall=base.flat_funnel_recall,
            flat_exact_funnel=base.flat_exact_funnel,
            flat_wide_funnel=base.flat_wide_funnel)
        key = plain.rerank_candidates
        if key not in twins:
            twins[key] = torch.cat([
                retrieve_flat(plain, res.state, b, None, 10).indices
                for b in res.batches]).cpu().numpy()
        check((res.indices[name] == twins[key]).all(), f"bench_rescue_ab "
              f"{name}: indices differ from the default funnel's at "
              f"rerank {key}")
    stats["rescue_ab"] = dict(lines=res.lines, launches=launches,
                              seconds=seconds)
    del res
    torch.cuda.empty_cache()
    return stats


def checkpoint_tools(ckpt_dir, tmp):
    """verify_checkpoint and inspect_checkpoint on the operator phase's
    `--preset full` checkpoint; see the module doc."""
    import shutil
    import torch
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.tools.verify_checkpoint import (
        build_template)
    stats = {}
    for argv in ([ckpt_dir], [ckpt_dir, "--deep"]):
        res, launches, seconds = benchmark_run("verify_checkpoint", argv,
                                               "tools")
        check(res.status == 0 and res.preset == "full", f"verify_checkpoint "
              f"{argv}: exit {res.status}, preset {res.preset}, findings "
              f"{res.findings}")
        check_launches("verify_checkpoint", launches, {})
        stats["verify" + ("_deep" if "--deep" in argv else "")] = dict(
            status=res.status, seconds=seconds)
    # a copy with one NaN in the flat parameter buffer
    step = res.step
    _, layout = build_template("full")
    name, shape = layout[len(layout) // 2]
    offset = sum(math.prod(s) for _, s in layout[:len(layout) // 2])
    bad = os.path.join(tmp, "nan_ckpt")
    os.makedirs(bad)
    payload = torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"),
                         map_location="cpu", weights_only=True)
    payload["params"][offset + math.prod(shape) // 2] = float("nan")
    torch.save(payload, os.path.join(bad, f"ckpt_{step}.pt"))
    del payload
    shutil.copy(os.path.join(ckpt_dir, f"meta_{step}.json"), bad)
    res, launches, seconds = benchmark_run(
        "verify_checkpoint", [bad, "--deep"], "tools")
    named = [f for f in res.findings
             if f.startswith(f"NONFINITE ['params']['{name}']")]
    check(res.status == 1 and named, f"verify_checkpoint on a NaN in "
          f"{name}: exit {res.status}, findings {res.findings}")
    stats["verify_nan"] = dict(status=res.status, findings=res.findings,
                               seconds=seconds)
    shutil.rmtree(bad)
    res, launches, seconds = benchmark_run("inspect_checkpoint", [ckpt_dir],
                                           "tools")
    model = port.get_full_config().model
    got = {k: res.config.get(k) for k in ("embedding_dim", "num_layers",
                                          "vocab_size")}
    check(got == dict(embedding_dim=model.embedding_dim,
                      num_layers=model.num_layers,
                      vocab_size=model.vocab_size),
          f"inspect_checkpoint: {res.config}")
    check_launches("inspect_checkpoint", launches, {})
    stats["inspect"] = dict(config=res.config, count=res.count,
                            seconds=seconds)
    log(f"checkpoint tools: verify exit 0 ({stats['verify']['seconds']:.1f}"
        f" s; --deep {stats['verify_deep']['seconds']:.1f} s), NaN in "
        f"{name}: exit 1 naming it; inspect {res.config}")
    return stats


def drivers_phase(ckpt_dir):
    """Phase 14: the flat and transfer drivers, the brain and emotion
    drivers and the four tools, each in this process, its launches
    counted around its run; see the module doc."""
    import tempfile
    import numpy as np
    t_phase = time.perf_counter()
    stats = {}
    with tempfile.TemporaryDirectory(prefix="aura_drivers_") as tmp:
        stats.update(flat_drivers(tmp))

        res, launches, seconds = benchmark_run("bench_h2d_dtypes", [])
        check_keys("bench_h2d_dtypes", res.line, H2D_KEYS)
        mib = res.line["payload_mb"] << 20
        check(res.nbytes == dict(f32=mib, f16=mib // 2, bf16=mib // 2,
                                 u16=mib // 2, i8=mib // 4, u8_raw=mib)
              and all(res.line[k] > 0 for k in H2D_KEYS[2:]),
              f"bench_h2d_dtypes: {res.nbytes} {res.line}")
        check_launches("bench_h2d_dtypes", launches, {})
        stats["h2d"] = dict(line=res.line, seconds=seconds)

        # the brain, emotion and neuron drivers: no kernel
        brain = (("bench_prosody", []), ("bench_prosody_sweep", ["--json"]),
                 ("bench_moe_routing", []), ("ablation_moe_routing", []),
                 ("bench_energy_tracking", []), ("bench_emotion_e2e", []))
        for name, argv in brain:
            res, launches, seconds = benchmark_run(name, argv)
            check_launches(name, launches, {})
            if name == "bench_prosody":
                check_keys(name, res.line, PROSODY_KEYS)
                line = res.line
            elif name == "bench_prosody_sweep":
                check(len(res.rows) == 8, f"{name}: {len(res.rows)} rows")
                for row in res.rows:
                    check_keys(name, row, PROSODY_SWEEP_KEYS)
                line = res.rows
            elif name == "bench_moe_routing":
                check_keys(name, res.line, MOE_KEYS)
                check(all(np.isfinite(res.losses)), f"{name}: losses")
                line = res.line
            elif name == "ablation_moe_routing":
                check_keys(name, res, ABLATION_KEYS)
                for row in res["rows"]:
                    check_keys(name, row, ABLATION_ROW_KEYS)
                line = res
            elif name == "bench_energy_tracking":
                check_keys(name, res.line, ENERGY_KEYS)
                line = res.line
            else:
                check_keys(name, res.line, EMOTION_KEYS)
                check(res.line["test_accuracy"] > 1 / 28, f"{name}: top-1 "
                      f"{res.line['test_accuracy']} at chance")
                line = res.line
            stats[name] = dict(line=line, seconds=seconds)
            log(f"{name}: {json.dumps(line)}")

        res, launches, seconds = benchmark_run("neuron_firing_diag", [],
                                               "tools")
        check_keys("neuron_firing_diag", res.report, DIAG_KEYS)
        check_launches("neuron_firing_diag", launches, {})
        stats["neuron_firing_diag"] = dict(report=res.report,
                                           warnings=res.warnings,
                                           seconds=seconds)

        res, launches, seconds = benchmark_run(
            "continuous_learning_runner", ["--duration", "2"], "tools")
        check_keys("continuous_learning_runner", res, RUNNER_KEYS)
        check_launches("continuous_learning_runner", launches, {})
        stats["continuous_learning_runner"] = dict(line=res,
                                                   seconds=seconds)

        stats.update(checkpoint_tools(ckpt_dir, tmp))
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"drivers phase II: {stats['phase_s']:.1f} s")
    return stats


# --------------------------------------------------------------------------
# examples phase (phase 15): the ports of the repo's examples and scripts
# --------------------------------------------------------------------------

# train_flagship at the full preset over the repo's Markdown as a byte
# corpus, cut to 4 steps and resumed to 6
FLAGSHIP_ARGS = ["--preset", "full", "--chunk", "2", "--memory-warmup",
                 "0", "--eval-every", "2", "--save-every", "2"]
FLAGSHIP_STEPS = (4, 6)
FLAGSHIP_KEYS = ("step", "loss", "ce", "ppl", "tok_s", "mfu", "mem_count",
                 "elapsed_s", "val_loss", "val_ppl")
FLAGSHIP_FINAL_KEYS = ("final", "steps", "avg_tok_s", "avg_mfu", "n_params",
                       "val_loss", "val_ppl")
CORPUS_VOCAB = 32_000           # the full preset's vocabulary
DEMO_NEW_TOKENS = 48            # flagship_demo.py's --max-new-tokens
PRODUCTION_ARGS = ["--steps", "50", "--preset", "debug",
                   "--monitor-interval", "5"]
DIAGNOSTIC_KEYS = ("entropy", "max_prob", "top5_mass", "effective_vocab",
                   "collapse_warning")
HYBRID_KEYS = ("final_mean_error", "salience('the neuron fired')",
               "predict(finance)", "predict(neuro)")
PP_XL_KEYS = ("preset", "d_model", "layers", "stages", "microbatches",
              "mesh", "trunk_params", "loss", "loss_repeat", "grad_norm",
              "grad_sharding_spec", "init_s", "compile_s", "step_s",
              "bubble_fraction")
TUNE_KEYS = ("decay", "gain_up", "k_winners", "smoothing", "score",
             "coverage", "dynamic_range", "mean_mu")
# the prosody traces on the card against the CPU port: phase 9's bound
# for the prosody gains, where the LIF chains' spikes agree
PROSODY_TOL = 1e-5
# the runs whose launches phase 15 records, beside the flagship's and the
# demo's
EXAMPLE_RUNS = ("train_tiny", "train_wikitext2", "pretrain_production",
                "train_emotion_head", "train_llm_hybrid", "dryrun_pp_xl",
                "prepare_dataset", "tune_prosody_hyperparameters")
EXAMPLE_TIMEOUT = 120           # seconds for run_multihost_cpu.sh


def md_corpus(path, vocab_size=CORPUS_VOCAB, val_every=5):
    """A corpus folder in `tools/build_offline_corpus.py`'s layout
    (`train.npy` and `val.npy` uint16 token streams, each document
    followed by the end-of-text id, and `meta.json`): the byte-tokenizer
    ids of this checkout's Markdown files, every `val_every`-th document
    (in path order) held out. `meta.json` declares `vocab_size`, the
    model's vocabulary. Returns (the documents' texts, meta)."""
    import glob
    import numpy as np
    from aura_snn_rag_tpu_torch.training.tokenizer import ByteTokenizer
    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(root, "*.md"))
                   + glob.glob(os.path.join(root, "docs", "*.md")))
    tok = ByteTokenizer()
    texts = []
    streams = {"val": [], "train": []}
    for i, p in enumerate(paths):
        with open(p, encoding="utf-8", errors="ignore") as f:
            texts.append(f.read())
        split = "val" if i % val_every == 0 else "train"
        streams[split].extend(tok.encode(texts[-1]) + [tok.eos_token_id])
    os.makedirs(path, exist_ok=True)
    meta = {"vocab_size": vocab_size, "eos_id": tok.eos_token_id,
            "n_docs": len(paths), "bytes": sum(len(t) for t in texts)}
    for split, ids in streams.items():
        arr = np.asarray(ids, np.uint16)
        np.save(os.path.join(path, f"{split}.npy"), arr)
        meta[f"{split}_tokens"] = int(arr.size)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return texts, meta


def finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def flagship_check(corpus, tmp):
    """train_flagship at the full preset, 4 steps in chunks of 2, then
    resumed to 6: every record's keys, finite losses, 0 < MFU < 1, the
    final record, the log file, the resumed step."""
    ckpt, log_path = os.path.join(tmp, "flagship"), os.path.join(
        tmp, "flagship.jsonl")
    stats = {}
    for steps in FLAGSHIP_STEPS:
        argv = FLAGSHIP_ARGS + ["--steps", str(steps), "--corpus", corpus,
                                "--log", log_path, "--checkpoint-dir", ckpt]
        res, launches, seconds = benchmark_run("train_flagship", argv,
                                               "examples")
        *recs, final = res.records
        check(recs and all(tuple(r) == FLAGSHIP_KEYS for r in recs),
              f"train_flagship: record keys {[list(r) for r in recs]}")
        check(tuple(final) == FLAGSHIP_FINAL_KEYS and final["final"]
              and final["steps"] == steps,
              f"train_flagship: final record {final}")
        check(all(finite(r[k]) for r in res.records
                  for k in ("loss", "val_loss") if k in r),
              f"train_flagship: losses {res.records}")
        check(all(0 < r["mfu"] < 1 for r in recs)
              and 0 < final["avg_mfu"] < 1,
              f"train_flagship: MFU {[r['mfu'] for r in recs]}")
        check(res.start == (0 if steps == FLAGSHIP_STEPS[0]
                            else FLAGSHIP_STEPS[0])
              and recs[0]["step"] == res.start + 2,
              f"train_flagship --steps {steps}: started at {res.start}")
        # the trainer's own bank holds a few rows (16 after 4 steps), which
        # retrieve_auto searches by brute force: no kernel
        check_launches(f"train_flagship --steps {steps}", launches, {})
        with open(log_path) as f:
            logged = [json.loads(line) for line in f]
        check(logged[-len(res.records):] == json.loads(
            json.dumps(res.records)), "train_flagship: the log's records")
        stats[f"steps_{steps}"] = dict(
            start=res.start, records=res.records, launches=launches,
            seconds=seconds)
        log(f"train_flagship --steps {steps}: from step {res.start}, "
            f"tok/s {[r['tok_s'] for r in recs]}, MFU "
            f"{[r['mfu'] for r in recs]}, launches {launches}, "
            f"{seconds:.1f} s")
        del res
    return stats, ckpt


def demo_check(dev, ckpt, corpus):
    """flagship_demo.demo on the flagship checkpoint with the LM's 100k
    bank and its index: kernel B 12 x the memory-conditioned generation's
    model calls and no other kernel; none in the plain generation."""
    import torch
    from aura_snn_rag_tpu_torch.examples import flagship_demo
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    from aura_snn_rag_tpu_torch.training.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    trainer, step = flagship_demo.restore(ckpt, corpus, "full", dev)
    check(step == FLAGSHIP_STEPS[-1], f"flagship_demo: restored step {step}")
    trainer.hippocampus.state = lm_bank(dev, trainer.config.memory)
    restore_s = time.perf_counter() - t0
    tok = ByteTokenizer()
    support = tok.encode(flagship_demo.SUPPORT)
    prompt = tok.encode(flagship_demo.PROMPT)
    plain, plain_s = {}, [0.0]
    inner = flagship_demo.generate

    def counted(*a, **kw):
        before = dict(_build.launch_counts)
        out, plain_s[0] = synced(lambda: inner(*a, **kw))
        plain.update({k: n - before.get(k, 0)
                      for k, n in _build.launch_counts.items()
                      if n != before.get(k, 0)})
        return out

    # the model's calls with memory, observed
    memory_calls = [0]

    def count_call(module, args, kwargs):
        memory_calls[0] += bool(kwargs.get("use_memory"))
    hook = trainer.model.register_forward_pre_hook(count_call,
                                                   with_kwargs=True)
    flagship_demo.generate = counted
    try:
        _build.reset_launch_counts()
        res, seconds = synced(lambda: flagship_demo.demo(
            trainer, support, prompt, DEMO_NEW_TOKENS,
            torch.Generator(device=dev).manual_seed(0)))
        launches = {k: n for k, n in _build.launch_counts.items() if n}
    finally:
        flagship_demo.generate = inner
        hook.remove()
    n_layers = trainer.config.model.num_layers
    vocab = trainer.config.model.vocab_size
    calls = memory_calls[0]
    # generation/sampler.generate: the prefill makes the first token, then
    # one model call per further token, so max_new_tokens calls with
    # memory; each RAG layer retrieves once per call
    check(calls == DEMO_NEW_TOKENS, f"flagship_demo: {calls} model calls "
          f"with memory, expected {DEMO_NEW_TOKENS}")
    want = n_layers * DEMO_NEW_TOKENS
    check(plain == {}, f"flagship_demo: the plain generation launched "
          f"{plain}")
    check_launches("flagship_demo", launches, {"ivf_retrieve_fused": want})
    check(res.memory_id.startswith("oneshot-"),
          f"flagship_demo: memory id {res.memory_id}")
    for name, ids in (("with memory", res.with_memory),
                      ("without memory", res.without_memory)):
        check(ids.shape == (len(prompt) + DEMO_NEW_TOKENS,)
              and list(ids[:len(prompt)]) == prompt
              and bool(((ids >= 0) & (ids < vocab)).all()),
              f"flagship_demo {name}: tokens {ids}")
    log(f"flagship_demo: restored step {step} + the "
        f"{trainer.config.memory.max_memories}-row bank in {restore_s:.1f} "
        f"s; {res.memory_id}; kernel B {want} launches ({n_layers} x "
        f"{calls} model calls), none without memory; "
        f"{seconds:.2f} s in all, {plain_s[0]:.2f} s of it the generation "
        f"without memory")
    stats = dict(step=step, memory_id=res.memory_id, launches=launches,
                 model_calls=calls, seconds=seconds,
                 without_memory_s=plain_s[0],
                 restore_s=restore_s, tokens_with_memory=res.with_memory
                 .tolist(), tokens_without_memory=res.without_memory
                 .tolist())
    del trainer
    torch.cuda.empty_cache()
    return stats


def lines_like(name, lines, patterns):
    """Each pattern (a regular expression) matches its line, in order."""
    import re
    check(len(lines) == len(patterns)
          and all(re.fullmatch(p, l, re.S) for p, l in zip(patterns, lines)),
          f"{name}: lines {lines}, expected {patterns}")


def no_hf(*args, **kwargs):
    raise ImportError("the HuggingFace loader is not called here")


@contextlib.contextmanager
def hermetic_data():
    """`training.data.load_hf_streaming` raising ImportError, as the CPU
    tests patch it: the card's machine has `datasets` and `transformers`
    but no network, so the scripts' HuggingFace branch would fail there
    (with OSError, which the JAX scripts do not catch either); with it
    patched they take their synthetic fallback and nothing reaches for
    the network."""
    from aura_snn_rag_tpu_torch.training import data
    inner = data.load_hf_streaming
    data.load_hf_streaming = no_hf
    try:
        yield
    finally:
        data.load_hf_streaming = inner


def trainers_check(dev, tmp):
    """train_tiny at its defaults, train_wikitext2 --steps 50 --eval-every
    25 and pretrain_production at the JAX test's flags: the lines the JAX
    scripts print, finite losses, the production checkpoint restored."""
    import argparse
    import torch
    from aura_snn_rag_tpu_torch.examples import pretrain_production
    from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
    from aura_snn_rag_tpu_torch.training.trainer import Trainer
    stats = {}
    num = r"-?[0-9.]+"
    res, launches, seconds = benchmark_run("train_tiny", [], "examples")
    lines_like("train_tiny", res.lines, [
        *(rf"step {s}: loss={num} ppl={num} mem=(on|off) bank=\d+"
          for s in range(0, 100, 20)),
        rf"trained 100 steps in {num}s \({num} tok/s\)",
        r"generated: \[(\d+, ){15}\d+\]"])
    check(all(finite(m["loss"]) for m in res.metrics), "train_tiny: loss")
    stats["train_tiny"] = dict(lines=res.lines, launches=launches,
                               seconds=seconds)

    argv = ["--steps", "50", "--eval-every", "25", "--checkpoint-dir",
            os.path.join(tmp, "wt2")]
    res, launches, seconds = benchmark_run("train_wikitext2", argv,
                                           "examples")
    lines_like("train_wikitext2", res.lines, [
        r"synthetic fallback: \(\d+, \d+\)",
        *(rf"step {s}: train_loss={num} val_ppl={num}" for s in (0, 25)),
        rf"best val ppl: {num}"])
    check(all(finite(p) for p in res.val_ppl), "train_wikitext2: ppl")
    stats["train_wikitext2"] = dict(lines=res.lines, launches=launches,
                                    seconds=seconds)

    ckpt = os.path.join(tmp, "prod")
    argv = PRODUCTION_ARGS + ["--checkpoint-dir", ckpt]
    res, launches, seconds = benchmark_run("pretrain_production", argv,
                                           "examples")
    body = [l for l in res.lines if not l.startswith("[monitor]")]
    lines_like("pretrain_production", body, [
        r"data: synthetic \(HF datasets unavailable\), \(\d+, \d+\)",
        # at steps 12, 24, 36 and 48: every quarter of 50
        *([r"\[diagnostics\] \{.*\}"] * 4), rf"final: loss={num} bank=\d+"])
    for line in body[1:5]:
        diag = json.loads(line.split(" ", 1)[1])
        check(tuple(diag) == DIAGNOSTIC_KEYS
              and math.isfinite(diag["entropy"]),
              f"pretrain_production: diagnostics {diag}")
    check(all(finite(l) for l in res.losses) and res.retries == 0,
          "pretrain_production: losses")
    args = argparse.Namespace(steps=50, preset="debug")
    t2 = Trainer(pretrain_production.config(args), seed=0, device=dev)
    restored = CheckpointManager(ckpt).restore(t2)
    check(restored == 50 and bool(torch.isfinite(t2.optimizer.flat).all()),
          f"pretrain_production: restored step {restored}")
    stats["pretrain_production"] = dict(
        lines=res.lines, launches=launches, seconds=seconds,
        restored_step=restored)
    for name in ("train_tiny", "train_wikitext2", "pretrain_production"):
        # each trainer's fresh bank stays small enough for brute force
        check_launches(name, stats[name]["launches"], {})
        log(f"{name}: {stats[name]['lines'][-1]}")
    del res, t2
    torch.cuda.empty_cache()
    return stats


def online_examples_check():
    """train_emotion_head and train_llm_hybrid at their defaults: the
    lines and the JSON line's keys."""
    stats = {}
    num = r"-?[0-9.]+"
    res, launches, seconds = benchmark_run("train_emotion_head", [],
                                           "examples")
    lines_like("train_emotion_head", res.lines, [
        *(rf"epoch {e}: loss={num}" for e in range(0, 20, 5)),
        rf"final emotion accuracy: {num}"])
    check(all(finite(l) for l in res.losses)
          and res.losses[-1] < res.losses[0] and 0 <= res.accuracy <= 1,
          f"train_emotion_head: losses {res.losses}")
    stats["train_emotion_head"] = dict(lines=res.lines, launches=launches,
                                       seconds=seconds)
    res, launches, seconds = benchmark_run("train_llm_hybrid", [],
                                           "examples")
    lines_like("train_llm_hybrid", res.lines, [
        *(rf"pass {p}: mean\|err\|={num} K=\d+ consciousness=\w+"
          for p in range(3)), r"\{.*\}"])
    check_keys("train_llm_hybrid", json.loads(res.lines[-1]), HYBRID_KEYS)
    check(all(finite(e) for e in res.errors), "train_llm_hybrid: errors")
    stats["train_llm_hybrid"] = dict(lines=res.lines, launches=launches,
                                     seconds=seconds)
    for name in stats:
        check_launches(name, stats[name]["launches"], {})
        log(f"{name}: {stats[name]['lines'][-1]}")
    return stats


def pp_xl_check(dev):
    """dryrun_pp_xl's rank work at (1, 1) on a one-rank group: the xl
    preset's 16 layers in one stage, 4 microbatches of 2 x 128, forward
    and backward, against the plain forward of the same layers."""
    import torch
    from aura_snn_rag_tpu_torch.examples import dryrun_pp_xl
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    from aura_snn_rag_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0,
                           device=dev.type, timeout=300)
    try:
        _build.reset_launch_counts()
        res = dryrun_pp_xl.rank_work((1, 1))
        launches = {k: n for k, n in _build.launch_counts.items() if n}
    finally:
        distributed.shutdown()
    rec, cfg = res.record, dryrun_pp_xl.model_config()
    check_keys("dryrun_pp_xl", rec, PP_XL_KEYS)
    check(rec["layers"] == cfg.num_layers
          and rec["d_model"] == cfg.embedding_dim
          and rec["mesh"] == {"stage": 1, "data": 1}, f"dryrun_pp_xl: {rec}")
    check(math.isfinite(rec["loss"]) and rec["loss"] == rec["loss_repeat"],
          f"dryrun_pp_xl: loss {rec['loss']} then {rec['loss_repeat']}")
    check(math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0,
          f"dryrun_pp_xl: gradient norm {rec['grad_norm']}")
    check_launches("dryrun_pp_xl", launches, {})
    named = {f"layers.{i}.{n}": p for i, layer in enumerate(res.layers)
             for n, p in layer.named_parameters() if p.grad is not None}
    params = list(named.values())
    piped = {n: p.grad.clone() for n, p in named.items()}

    def plain():
        for p in params:
            p.grad = None
        h = res.batch
        for layer in res.layers:
            h, _ = layer(h)
        loss = h.float().pow(2).mean()
        loss.backward()
        return loss.item()
    plain_loss, plain_s = synced(plain)
    gnorm = torch.stack([p.grad.float().pow(2).sum() for p in params]
                        ).sum().sqrt().item()

    # phase 11's check of the pipelined path: each tensor's gradient
    # against the plain run's, by RMS, with a floor of 1e-3 of the
    # largest RMS
    def rms(x):
        return x.float().pow(2).mean().sqrt().item()
    check(all(p.grad is not None for p in params),
          "dryrun_pp_xl: the plain run left a gradient out")
    floor = 1e-3 * max(rms(p.grad) for p in params)
    rel = {n: rms(piped[n] - p.grad) / max(rms(p.grad), floor)
           for n, p in named.items()}
    worst = max(rel, key=rel.get)
    check(abs(rec["loss"] - plain_loss) <= 1e-3 * abs(plain_loss),
          f"dryrun_pp_xl: pipelined loss {rec['loss']} against the plain "
          f"forward's {plain_loss}")
    check(rel[worst] <= TRAIN_GRAD_RTOL, f"dryrun_pp_xl: {worst}'s "
          f"gradient differs by {rel[worst]:.3g} of its RMS (tolerance "
          f"{TRAIN_GRAD_RTOL})")
    log(f"dryrun_pp_xl at (1, 1): {rec['trunk_params']} trunk parameters, "
        f"loss {rec['loss']:.6g} (plain {plain_loss:.6g}), gradient norm "
        f"{rec['grad_norm']:.6g} (plain {gnorm:.6g}), gradient RMS gap at "
        f"most {rel[worst]:.3g} ({worst}) over {len(rel)} tensors, step "
        f"{1e3 * rec['step_s']:.0f} ms (first {rec['compile_s']} s), plain "
        f"forward and backward {1e3 * plain_s:.0f} ms")
    del res, named, params, piped
    torch.cuda.empty_cache()
    return dict(record=rec, plain_loss=plain_loss, plain_grad_norm=gnorm,
                max_rms_gap=rel[worst], worst=worst, plain_ms=1e3 * plain_s,
                launches=launches)


def multihost_check():
    """examples/run_multihost_cpu.sh: two gloo processes, exit 0."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "aura_snn_rag_tpu_torch", "examples",
                          "run_multihost_cpu.sh")
    t0 = time.perf_counter()
    out = subprocess.run(["sh", script], capture_output=True, text=True,
                         timeout=EXAMPLE_TIMEOUT,
                         env=dict(os.environ, PYTHON=sys.executable))
    seconds = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and lines and lines[-1] == "multihost demo OK"
          and sum("global_sum=28.0" in l for l in lines) == 2,
          f"run_multihost_cpu.sh: exit {out.returncode}\n{out.stdout}\n"
          f"{out.stderr[-2000:]}")
    log(f"run_multihost_cpu.sh: exit 0 in {seconds:.1f} s: {lines}")
    return dict(lines=lines, seconds=seconds)


def scripts_check(dev, texts, tmp):
    """prepare_dataset on the checkout's Markdown, the prosody tuner's 24
    trials, and visualize_prosody's traces on the card against the CPU
    port's."""
    import numpy as np
    import torch
    from aura_snn_rag_tpu_torch.models.prosody import (
        ProsodyAttentionConfig, _lif_chains, prosody_channels_from_tokens)
    from aura_snn_rag_tpu_torch.scripts import visualize_prosody
    from aura_snn_rag_tpu_torch.training.tokenizer import ByteTokenizer
    stats = {}
    src = os.path.join(tmp, "md")
    os.makedirs(src, exist_ok=True)
    for i, text in enumerate(texts):
        with open(os.path.join(src, f"doc{i:03d}.txt"), "w") as f:
            f.write(text)
    out = os.path.join(tmp, "dataset.npz")
    res, launches, seconds = benchmark_run(
        "prepare_dataset", ["--out", out, "--corpus-dir", src], "scripts")
    saved = np.load(out)
    want = sum(len(ByteTokenizer().encode(t.strip())) for t in texts) // 256
    check(saved["sequences"].shape == (want, 256)
          and saved["sequences"].dtype == np.int32
          and len(saved["sources"]) == want
          and int(saved["sequences"].max()) < ByteTokenizer.vocab_size,
          f"prepare_dataset: {saved['sequences'].shape}, expected "
          f"({want}, 256)")
    stats["prepare_dataset"] = dict(lines=res.lines, launches=launches,
                                    seconds=seconds)

    res, launches, seconds = benchmark_run(
        "tune_prosody_hyperparameters", ["--trials", "24"], "scripts")
    check(res.summary["trials"] == 24 and len(res.summary["best"]) == 3
          and all(tuple(r) == TUNE_KEYS and all(finite(r[k]) for k in
                                                TUNE_KEYS[4:])
                  for r in res.results), f"tuner: {res.summary}")
    check_launches("tune_prosody_hyperparameters", launches, {})
    stats["tune_prosody_hyperparameters"] = dict(best=res.summary["best"],
                                                 launches=launches,
                                                 seconds=seconds)

    ids = visualize_prosody.token_ids()
    card, seconds = synced(lambda: visualize_prosody.traces(ids, dev))
    cpu = visualize_prosody.traces(ids, "cpu")
    # the LIF chains' spikes, each device's from its own channels
    decay = torch.tensor(ProsodyAttentionConfig().decay)[:, None]
    spikes = [_lif_chains(torch.stack(prosody_channels_from_tokens(x)),
                          decay.to(x.device)).cpu()
              for x in (torch.as_tensor(ids, device=dev),
                        torch.as_tensor(ids))]
    agree = bool((spikes[0] == spikes[1]).all())
    err = {k: float(np.abs(card[k].astype(np.float64)
                           - cpu[k].astype(np.float64)).max())
           for k in visualize_prosody.TRACES}
    check(all(err[k] <= PROSODY_TOL for k in ("amplitude", "pitch",
                                              "boundary"))
          and (not agree or max(err.values()) <= PROSODY_TOL),
          f"visualize_prosody traces on the card against the CPU: {err}")
    stats["visualize_prosody"] = dict(max_abs_err=err, lif_spikes_agree=agree,
                                      seconds=seconds)
    log(f"prepare_dataset: {stats['prepare_dataset']['lines'][-1]}; tuner "
        f"best {json.dumps(res.summary['best'][0])}; prosody traces on the "
        f"card within {max(err.values()):.3g} of the CPU (spikes agree: "
        f"{agree})")
    return stats


def optional_mains(dev, corpus, ckpt, tmp):
    """flagship_demo.main where `tokenizers` imports (a BPE tokenizer
    trained on the corpus's documents) and visualize_prosody.main where
    matplotlib does; returns which parts ran."""
    import importlib.util
    ran = {}
    if importlib.util.find_spec("matplotlib") is not None:
        from aura_snn_rag_tpu_torch.scripts import visualize_prosody
        png = os.path.join(tmp, "prosody.png")
        res = visualize_prosody.main(["--out", png, "--device", dev.type])
        check(os.path.getsize(png) > 0, "visualize_prosody: no PNG")
        ran["visualize_prosody.main"] = res.lines
    if importlib.util.find_spec("tokenizers") is not None:
        from tokenizers import (
            Tokenizer, decoders, models, pre_tokenizers, trainers)
        from aura_snn_rag_tpu_torch.examples import flagship_demo
        from aura_snn_rag_tpu_torch.ops.cuda import _build
        tok = Tokenizer(models.BPE(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel()
        tok.decoder = decoders.ByteLevel()
        with open(os.path.join(corpus, "meta.json")) as f:
            vocab = min(4096, json.load(f)["vocab_size"])
        tok.train([os.path.join(tmp, "md", f) for f in sorted(os.listdir(
            os.path.join(tmp, "md")))], trainers.BpeTrainer(
                vocab_size=vocab, special_tokens=["<unk>", "<eos>"]))
        tok.save(os.path.join(corpus, "tokenizer.json"))
        _build.reset_launch_counts()
        lines, line, res = flagship_demo.main([
            "--checkpoint-dir", ckpt, "--corpus", corpus, "--device",
            dev.type])
        check(line["checkpoint_step"] == FLAGSHIP_STEPS[-1],
              f"flagship_demo.main: {line}")
        ran["flagship_demo.main"] = dict(line=line, launches={
            k: n for k, n in _build.launch_counts.items() if n})
    return ran


def examples_phase(dev):
    """Phase 15: the examples and scripts, each in this process (the
    multihost demo in its own two), its launches counted around its run;
    see the module doc."""
    import importlib.util
    import tempfile
    import torch
    t_phase = time.perf_counter()
    stats = {}
    with tempfile.TemporaryDirectory(prefix="aura_examples_") as tmp:
        corpus = os.path.join(tmp, "corpus")
        texts, meta = md_corpus(corpus)
        log(f"examples corpus: {meta['n_docs']} Markdown files, "
            f"{meta['train_tokens']} train / {meta['val_tokens']} val byte "
            f"tokens, vocab {meta['vocab_size']}")
        stats["flagship"], ckpt = flagship_check(corpus, tmp)
        torch.cuda.empty_cache()
        stats["demo"] = demo_check(dev, ckpt, corpus)
        with hermetic_data():
            stats.update(trainers_check(dev, tmp))
        stats.update(online_examples_check())
        stats["dryrun_pp_xl"] = pp_xl_check(dev)
        stats["multihost"] = multihost_check()
        stats.update(scripts_check(dev, texts, tmp))
        found = {m: importlib.util.find_spec(m) is not None
                 for m in ("tokenizers", "matplotlib")}
        stats["optional"] = optional_mains(dev, corpus, ckpt, tmp)
    # every kernel's launches over the phase's runs
    total = {}
    for entry in (*stats["flagship"].values(), stats["demo"],
                  *(stats[name] for name in EXAMPLE_RUNS)):
        for k, n in entry.get("launches", {}).items():
            total[k] = total.get(k, 0) + n
    stats["launches"] = total
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"examples phase: {stats['phase_s']:.1f} s; installed {found}; "
        f"ran {sorted(stats['optional']) or 'no optional main'}")
    return stats


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def main() -> int:
    # the cuBLAS workspace that deterministic algorithms require (phase
    # 6's resumed steps); the size PyTorch takes on sm_90 anyway
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from aura_snn_rag_tpu_torch.ops.cuda import _build

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = _build.build_all()
    for stem in _build.SOURCES:
        _build.load(stem)
    log(f"kernel build: {build_s:.1f} s compiling, "
        f"{time.perf_counter() - t0:.1f} s to load")

    s = KERNEL_SHAPES
    gen = torch.Generator(device=dev).manual_seed(1234)
    res_a = kernel_A(dev, gen, s["M"], s["D"],
                     [("int8", 128), ("bf16", 128), ("int8", 1024)])
    # 1024 queries per set: kernels B and D also run at bench.py's batch;
    # B and D take the cluster-major coarse pass at the batches where the
    # library chooses it (B = 64, 256 and 1024 at these shapes), where
    # their bounds read each probed cluster once
    from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import cluster_major
    cases_B = (1, 8, 64, 256, 1024)
    union = tuple(B for B in cases_B if cluster_major(B, s["P"], s["K"]))
    log(f"cluster-major coarse pass at B in {union} of {cases_B}")
    ivf = ivf_inputs(dev, gen, s["K"], s["C"], s["D"], s["M"], s["P"], 1024,
                     4)
    res_bc = kernel_B_C(ivf, s["K"], s["C"], s["D"], s["M"], s["P"],
                        s["kk"], s["k"], cases_B=cases_B,
                        cases_C=(1, 8), union_cases=union,
                        profile_cases=(1024,))
    # the engine's widths at these shapes: kk = 128 for D, and for E
    # per_k = min(max(k, ceil(kk / P)), C) = k
    res_de = kernel_D_E(ivf, s["K"], s["C"], s["D"], s["P"], s["kk"],
                        s["k"], cases_D=(1, 8, 1024), cases_E=(1, 8),
                        union_cases=union, profile_cases=(1024,))
    del ivf
    topk_ms = topk_context(dev, gen, s["P"] * s["C"], s["kk"], (1, 8))
    # kernel B at the LM's shape: P*C = 7168 keys over the select's 8 CTAs
    ls = LM_KERNEL_SHAPES
    ivf = ivf_inputs(dev, gen, ls["K"], ls["C"], ls["D"], ls["M"], ls["P"],
                     8, 4)
    res_lm_b = kernel_B_C(ivf, ls["K"], ls["C"], ls["D"], ls["M"], ls["P"],
                          ls["kk"], ls["k"], cases_B=(1, 8), cases_C=())
    del ivf
    torch.cuda.empty_cache()

    # ---- the main path: counts from zero, read after the last phase ----
    _build.reset_launch_counts()
    stats = engine_phase(dev, ENGINE, N_EVAL, n_live=256,
                         profile="--profile" in sys.argv[1:])
    torch.cuda.empty_cache()
    stats["host_api_rebuilds"] = host_api_phase(dev)
    launches = dict(_build.launch_counts)
    for name in SOURCES:
        check(launches.get(name, 0) > 0, f"{name} never launched on the "
              f"main path ({launches})")
    log(f"main-path launches: {launches}")
    torch.cuda.empty_cache()

    # ---- the LM's serving path: counts from zero again ----
    _build.reset_launch_counts()
    lm = lm_phase(dev, profile="--profile" in sys.argv[1:])
    launches_lm = dict(_build.launch_counts)
    check(launches_lm.get("ivf_retrieve_fused", 0) > 0
          and all(launches_lm.get(name, 0) == 0 for name in SOURCES
                  if name != "ivf_retrieve_fused"),
          f"LM path launches {launches_lm}: kernel B only, at least once")
    lm["launches"] = launches_lm
    log(f"LM-path launches: {launches_lm}")
    torch.cuda.empty_cache()

    # ---- the LM's training path: counts zeroed inside, just before the
    # counted train_steps, and read just after them ----
    train = train_phase(dev, profile="--profile" in sys.argv[1:])
    launches_train = train["launches"]
    log(f"training-path launches: {launches_train}")
    torch.cuda.empty_cache()

    # ---- the operator's path: counts from zero again; the CLI's
    # `--preset full` checkpoint is kept for phase 14 ----
    import atexit
    import shutil
    import tempfile
    keep = tempfile.mkdtemp(prefix="aura_ckpt_")
    atexit.register(shutil.rmtree, keep, True)
    _build.reset_launch_counts()
    operator = operator_phase(dev, keep_dir=os.path.join(keep, "cli"))
    launches_op = dict(_build.launch_counts)
    check(launches_op.get("ivf_retrieve_fused", 0) > 0
          and all(launches_op.get(name, 0) == 0 for name in SOURCES
                  if name != "ivf_retrieve_fused"),
          f"operator path launches {launches_op}: kernel B only, at least "
          f"once")
    operator["launches"] = launches_op
    log(f"operator-path launches: {launches_op}")
    torch.cuda.empty_cache()

    # ---- the host-spilled bank: counts zeroed inside, just before its
    # retrievals, and read just after them ----
    spill = spill_phase(dev)
    launches_spill = spill["launches"]
    torch.cuda.empty_cache()

    # ---- the neuromorphic brain system: counts zeroed inside, first, and
    # read at its end; no kernel may run there ----
    brain = brain_phase(dev)
    log(f"brain-path launches: {brain['launches']}")
    torch.cuda.empty_cache()

    # ---- the NaturalBrain path: counts zeroed inside, first, and read at
    # its end; no kernel may run there ----
    natural = natural_brain_phase(dev)
    log(f"natural-brain-path launches: {natural['launches']}")
    torch.cuda.empty_cache()

    # ---- the sharded bank and data-parallel training on a one-rank
    # group: counts zeroed inside, around each call they check ----
    sharded = sharded_phase(dev)
    torch.cuda.empty_cache()

    # ---- model parallelism on a one-rank group: counts zeroed inside,
    # around each call they check ----
    mp = model_parallel_phase(dev)
    torch.cuda.empty_cache()

    # ---- the port's bench.py: counts zeroed inside, around each run in
    # this process ----
    bench = bench_phase()
    torch.cuda.empty_cache()

    # ---- the benchmark modules: counts zeroed inside, around each
    # module's run ----
    benchmarks = benchmarks_phase()
    torch.cuda.empty_cache()

    # ---- the remaining drivers and the tools: counts zeroed inside,
    # around each module's run ----
    drivers = drivers_phase(os.path.join(keep, "cli"))
    shutil.rmtree(keep, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the examples and scripts: counts zeroed inside, around each
    # module's run ----
    examples = examples_phase(dev)
    torch.cuda.empty_cache()

    main_shape = {"flat_blockmax": res_a[("int8", 1024)],
                  "ivf_retrieve_fused": res_bc[("ivf_retrieve_fused", 8)],
                  "ivf_scan_scores": res_bc[("ivf_scan_scores", 8)],
                  "ivf_candidates": res_de[("ivf_candidates", 8)],
                  "ivf_topk_scores": res_de[("ivf_topk_scores", 8)]}
    # the IVF kernels at B = 1 too, the single-query serving case
    res_ivf = {**res_bc, **res_de}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        row = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=launches[name], **main_shape[name])
        row.pop("host_us", None)
        if (name, 1) in res_ivf:
            b1 = res_ivf[(name, 1)]
            row.update(ms_b1=b1["ms"], graph_ms_b1=b1["graph_ms"],
                       bound_ms_b1=b1["bound_ms"], host_us_b1=b1["host_us"])
        if name == "flat_blockmax":
            # the spilled tier's device funnel: its chunk of 256 queries
            # over the 10M-row bank, and its launches there
            row["launches_spill"] = launches_spill[name]
            row["launches_bench_blockmax"] = \
                bench["blockmax"]["launches"][name]
            row.update({f"spill_{key}": value for key, value
                        in spill.pop("kernel_A").items()})
            row["launches_benchmarks_spill"] = \
                benchmarks["spill"]["launches"][name]
            # phase 14: bench_flat_kernel (int8 and bf16) and the sweep
            row["launches_drivers_flat_kernel"] = sum(
                drivers[f"flat_kernel_{dt}"]["launches"][name]
                for dt in ("int8", "bf16"))
            row["launches_drivers_sweep"] = \
                drivers["flat_batch_sweep"]["launches"][name]
        if name == "ivf_candidates":
            # bench.py's batch of 1024, on the cluster-major pass
            r = res_de[(name, 1024)]
            row.update({f"b1024_{key}": r[key] for key in (
                "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                "bound_by", "probed_clusters", "coarse_pass", "launch_ms")
                if key in r})
        if name == "ivf_retrieve_fused":
            # the LM's shape, and its launches on the LM and training paths
            row["launches_lm"] = launches_lm[name]
            row["launches_train"] = launches_train[name]
            row["launches_operator"] = launches_op[name]
            # phase 11: the server on a mesh (both batches) and the
            # pipelined RAG forward
            row["launches_mp_serve"] = sum(
                mp["serve"]["mesh"]["kernel_B_launches"])
            row["launches_pipelined"] = \
                mp["pipeline"]["pipelined"]["kernel_B_launches"]
            # phase 12: bench.py's defaults and its --small blockmax run;
            # the kernel at their batch of 1024
            row["launches_bench"] = bench["full"]["launches"][name]
            row["launches_bench_blockmax"] = \
                bench["blockmax"]["launches"][name]
            for B in (64, 256, 1024):
                r = res_bc[(name, B)]
                row.update({f"b{B}_{key}": r[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                    "bound_by", "probed_clusters", "coarse_pass",
                    "launch_ms") if key in r})
            for B, suffix in ((8, ""), (1, "_b1")):
                r = res_lm_b[(name, B)]
                row.update({f"lm_{key}{suffix}": r[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                    "bound_by", "host_us") if r[key] is not None})
        # phase 15: the examples' and scripts' runs (the flagship demo's
        # memory-conditioned generation for kernel B)
        row["launches_examples"] = examples["launches"].get(name, 0)
        if name == "ivf_retrieve_fused":
            row["launches_examples_demo"] = \
                examples["demo"]["launches"].get(name, 0)
        # phase 13: the retrieval benchmarks' launches
        if name != "flat_blockmax":
            row["launches_benchmarks_latency"] = \
                benchmarks["latency"]["launches"].get(name, 0)
            row["launches_benchmarks_breakdown"] = \
                benchmarks["breakdown"]["launches"][name]
        kernels.append(row)
    log(json.dumps({"torch_topk_ms": topk_ms}))
    log(json.dumps({"engine": stats}))
    log(json.dumps({"lm": lm}))
    log(json.dumps({"train": train}))
    log(json.dumps({"operator": operator}))
    log(json.dumps({"spill": spill}))
    log(json.dumps({"brain": brain}))
    log(json.dumps({"natural_brain": natural}))
    log(json.dumps({"sharded": sharded}))
    log(json.dumps({"model_parallel": mp}))
    log(json.dumps({"bench": bench}))
    log(json.dumps({"benchmarks": benchmarks}))
    log(json.dumps({"drivers": drivers}))
    log(json.dumps({"examples": examples}, default=str))
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
