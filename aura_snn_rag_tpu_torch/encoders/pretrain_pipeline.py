"""Corpus pre-embedding pipeline (a copy of
`aura_snn_rag_tpu/encoders/pretrain_pipeline.py`, host numpy; the port
keeps its own): corpus-directory iterators (jsonl, csv, txt), embedding
in a thread pool, a pluggable encoder (the port's hash embedder by
default; any callable), an on-disk cache, and `.npz` output.
"""

from __future__ import annotations

import csv
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from aura_snn_rag_tpu_torch.encoders.embedding_cache import EmbeddingCache
from aura_snn_rag_tpu_torch.encoders.hash_embedder import FastHashEmbedder


def iter_corpus_dir(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (source_file, text) from every jsonl/csv/txt under `path`."""
    for root, _, files in os.walk(path):
        for name in sorted(files):
            full = os.path.join(root, name)
            try:
                if name.endswith(".txt"):
                    with open(full, encoding="utf-8",
                              errors="ignore") as f:
                        text = f.read().strip()
                    if text:
                        yield full, text
                elif name.endswith(".jsonl"):
                    with open(full, encoding="utf-8",
                              errors="ignore") as f:
                        for line in f:
                            try:
                                row = json.loads(line)
                            except json.JSONDecodeError:
                                continue
                            if isinstance(row, dict):
                                for key in ("text", "content", "body"):
                                    if row.get(key):
                                        yield full, str(row[key])
                                        break
                            elif isinstance(row, str) and row:
                                yield full, row
                elif name.endswith(".csv"):
                    with open(full, encoding="utf-8", errors="ignore",
                              newline="") as f:
                        for r in csv.reader(f):
                            text = " ".join(c for c in r if c)
                            if text:
                                yield full, text
            except OSError:
                continue


class PretrainPipeline:
    """Embed a corpus directory in parallel, with caching."""

    def __init__(self, embed_fn: Optional[Callable[[str], np.ndarray]] = None,
                 dim: int = 768, cache_dir: Optional[str] = None,
                 n_workers: int = 4):
        self.embedder = FastHashEmbedder(dim=dim)
        self.embed_fn = embed_fn or self.embedder.embed
        self.cache = EmbeddingCache(cache_dir) if cache_dir else None
        self.n_workers = n_workers

    def _embed_one(self, text: str) -> np.ndarray:
        if self.cache is not None:
            hit = self.cache.get(text)
            if hit is not None:
                return hit[0]
        emb = np.asarray(self.embed_fn(text), np.float32)
        if self.cache is not None:
            self.cache.put(text, emb, self.embedder.token_indices(text))
        return emb

    def run(self, corpus_dir: str, out_path: Optional[str] = None,
            max_items: Optional[int] = None) -> np.ndarray:
        """Embed the corpus; returns [N, dim] and optionally saves .npz."""
        texts = []
        sources = []
        for src, text in iter_corpus_dir(corpus_dir):
            texts.append(text)
            sources.append(src)
            if max_items is not None and len(texts) >= max_items:
                break
        if not texts:
            return np.zeros((0, self.embedder.dim), np.float32)

        # threads: the native embedder releases the GIL while it hashes
        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            embs = list(pool.map(self._embed_one, texts))
        out = np.stack(embs)
        if out_path:
            np.savez(out_path, embeddings=out,
                     sources=np.asarray(sources))
        return out
