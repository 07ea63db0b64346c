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
- `bench_rag_overhead`: memory's share of a training step.
"""
