"""The repo's data and tuning scripts on the port: one module per script
of the root `scripts/` folder, under the same file name, each run as

    python -m aura_snn_rag_tpu_torch.scripts.<name> [flags]

with the script's flags, defaults and output. Each module has
`parser()`, `run(argv)`, which returns what it printed or wrote and what
a caller needs to check it, and `main(argv)`. Nothing runs at import.

- `prepare_dataset`: text corpora packed into a [n, seq_len] token
  matrix (`.npz`); host code, so it takes no `--device`;
- `tune_prosody_hyperparameters`: a grid of prosody configurations
  scored on the device (`--device`, default cuda);
- `visualize_prosody`: the prosody pipeline's channels, salience,
  winners and gains on the device (`traces`), drawn to a PNG with
  matplotlib, which is imported only there.
"""
