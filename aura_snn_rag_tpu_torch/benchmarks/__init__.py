"""The repo's benchmark modules on the port: one module per script of the
root `benchmarks/` folder, under the same file name, each run as

    python -m aura_snn_rag_tpu_torch.benchmarks.<name> [flags] [--device cpu]

with the script's flags and defaults, printing its JSON line or lines
with the same keys in the same order. Each module has `parser()`,
`run(argv)`, which returns the JSON objects and what a caller needs to
check them, and `main(argv)`, which prints them. Nothing runs at import.
Every module runs on the CUDA card unless `--device cpu` is given, and
raises without a card.

- `bench_host_spill`: the host-spilled bank, 10M x 768 (kernel A);
- `bench_sharded_scaling`: the sharded bank's top-k against one flat
  bank, and its all-gather bytes, on N ranks;
- `bench_retrieval_latency`: IVF (kernel B, D or E) against the flat
  scan at small batches;
- `bench_retrieval_breakdown`: the IVF dispatch's stages, one call each
  (kernels B, C, D and E);
- `bench_decode`, `bench_generation`, `bench_decode_breakdown`: the LM's
  KV-cached decode;
- `bench_rag_overhead`: memory's share of a training step;
- `bench_flat_kernel`: kernel A against the library's coarse scan;
- `bench_flat_batch_sweep`: the flat path over batches and strategies
  (kernel A in `blockmax`);
- `bench_rescue_ab`: the flat funnel's variants;
- `bench_h2d_dtypes`: host-to-device rate by dtype;
- `bench_prosody`, `bench_prosody_sweep`: the prosody bridge and the
  prosody-modulated GIF scan;
- `bench_moe_routing`, `ablation_moe_routing`: the Liquid-MoE router;
- `bench_energy_tracking`: spiking against dense energy estimates;
- `bench_emotion_e2e`: the emotion head on labelled text.
"""
