"""Build a pre-tokenized dataset file from raw text corpora
(counterpart of `scripts/prepare_dataset.py`).

    python -m aura_snn_rag_tpu_torch.scripts.prepare_dataset --out data.npz
        --corpus-dir ./vocab_src [--hf wikitext] [--seq-len 256]
        [--tokenizer google/flan-t5-base] [--max-sequences 100000]

Every .txt, .jsonl and .csv text under `--corpus-dir`
(`iter_corpus_dir`), encoded by the byte tokenizer (or a HuggingFace
tokenizer through `load_tokenizer`), packed into rows of `--seq-len`
tokens in order; then, with `--hf`, rows streamed from that dataset
(`load_hf_streaming`, which needs `datasets` and `transformers`). Saves
`sequences` (int32 [n, seq_len]) and `sources` (each row's source) with
`np.savez`, the layout `cli train --data` reads. Host code: it takes no
`--device`.
"""

from __future__ import annotations

import argparse
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from aura_snn_rag_tpu_torch.encoders.pretrain_pipeline import iter_corpus_dir
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.training import data as data_mod
from aura_snn_rag_tpu_torch.training.tokenizer import (
    ByteTokenizer, load_tokenizer)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.scripts.prepare_dataset",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--corpus-dir", default=None)
    ap.add_argument("--hf", default=None,
                    help="HF dataset name (e.g. wikitext)")
    ap.add_argument("--hf-config", default="wikitext-2-raw-v1")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--tokenizer", default=None,
                    help="HF tokenizer name; default byte-level")
    ap.add_argument("--max-sequences", type=int, default=100_000)
    return ap


class DatasetResult(NamedTuple):
    lines: List[str]
    sequences: np.ndarray         # what was saved
    sources: np.ndarray


def run(argv: Optional[Sequence[str]] = None) -> DatasetResult:
    args = parser().parse_args(argv)
    tok = load_tokenizer(args.tokenizer) if args.tokenizer \
        else ByteTokenizer()

    sequences = []
    sources = []
    buf = []

    def pack(ids, src):
        nonlocal buf
        buf.extend(ids)
        while len(buf) >= args.seq_len and \
                len(sequences) < args.max_sequences:
            sequences.append(buf[:args.seq_len])
            sources.append(src)
            buf = buf[args.seq_len:]

    if args.corpus_dir:
        for src, text in iter_corpus_dir(args.corpus_dir):
            pack(tok.encode(text), src)
            if len(sequences) >= args.max_sequences:
                break

    if args.hf and len(sequences) < args.max_sequences:
        hf_seqs = data_mod.load_hf_streaming(
            args.hf, args.hf_config,
            args.tokenizer or "gpt2", args.seq_len,
            args.max_sequences - len(sequences))
        for row in hf_seqs:
            sequences.append(row.tolist())
            sources.append(f"hf:{args.hf}")

    arr = np.asarray(sequences, np.int32)
    src = np.asarray(sources)
    np.savez(args.out, sequences=arr, sources=src)
    vocab = int(arr.max()) + 1 if arr.size else 0
    out = Lines()
    out(f"wrote {args.out}: {arr.shape} (max token id {vocab - 1})")
    return DatasetResult(out, arr, src)


def main(argv: Optional[Sequence[str]] = None) -> DatasetResult:
    """Pack the corpora, save and print the script's line."""
    return run(argv)


if __name__ == "__main__":
    main()
