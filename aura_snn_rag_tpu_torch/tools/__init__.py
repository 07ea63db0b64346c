"""The repo's operator tools on the port: one module per script of the
root `tools/` folder that drives the JAX package, under the same file
name, each run as

    python -m aura_snn_rag_tpu_torch.tools.<name> [flags]

with the script's flags and output. Each module has `parser()`,
`run(argv)`, which returns what it prints and what a caller needs to
check it, and `main(argv)`. Nothing runs at import.

- `verify_checkpoint`: audits a checkpoint of the port's `Trainer`
  against its preset's template (keys, shapes, dtypes; `--deep`:
  non-finite values, norm outliers, the bank); exit 1 on findings;
- `inspect_checkpoint`: the model configuration a checkpoint was made
  at, the bank's count and the sidecar's ids and loss;
- `neuron_firing_diag`: firing-rate curves of the neuron models;
- `continuous_learning_runner`: a brain system's continuous-learning
  orchestrator, run for a while.

The checkpoint tools compute nothing: they read on the host and build
their template on the meta device, so they take no `--device`. The other
two run on the CUDA card unless `--device cpu` is given, and raise
without a card.
"""
