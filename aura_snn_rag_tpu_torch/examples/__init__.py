"""The repo's examples on the port: one module per script of the root
`examples/` folder, under the same file name, each run as

    python -m aura_snn_rag_tpu_torch.examples.<name> [flags] [--device cpu]

with the script's flags and defaults, printing its lines with the same
keys in the same order. Each module has `parser()`, `run(argv)`, which
prints the lines as the script does and returns them with what a caller
needs to check them, and `main(argv)`. Nothing runs at import. Every
module runs on the CUDA card unless `--device cpu` is given, and raises
without a card.

- `train_tiny`: the debug preset trained on synthetic sequences, then a
  short generation;
- `train_wikitext2`: WikiText-2 (or the synthetic fallback) with
  validation perplexity and best-checkpoint saving;
- `pretrain_production`: wake/sleep training with a monitor thread,
  generation diagnostics and an out-of-memory retry;
- `train_flagship`: a preset over an on-disk token corpus, with a JSONL
  log, tokens/s and MFU against the card's peak, resuming from its
  checkpoints;
- `flagship_demo`: a trained checkpoint memorises a passage in one shot,
  then generates with episodic memory (kernel B in every RAG layer) and
  without;
- `train_emotion_head`: the emotion/personality head on hash features;
- `train_llm_hybrid`: the gradient-free `LiquidBrain` with STDP token
  salience;
- `dryrun_pp_xl`: the xl preset's 16 layers as a 4-stage GPipe pipeline
  on a ('stage', 'data') = (4, 2) mesh of 8 ranks, forward and backward;
- `run_multihost_cpu.sh`: two processes on gloo through the launcher's
  environment variables, one global sum.

`tokenizers` (the flagship demo's `tokenizer.json`), `datasets` and
`transformers` (the HuggingFace data branches) are imported only where
they are used.
"""
