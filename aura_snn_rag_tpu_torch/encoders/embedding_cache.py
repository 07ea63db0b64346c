"""sha256-keyed embedding cache (a copy of
`aura_snn_rag_tpu/encoders/embedding_cache.py`, which is numpy only; the
port keeps its own): one .npz per text holding its embedding and token
indices."""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np


class EmbeddingCache:
    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, text: str) -> str:
        key = hashlib.sha256(text.encode("utf-8", "ignore")).hexdigest()
        return os.path.join(self.cache_dir, f"{key}.npz")

    def get(self, text: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        p = self._path(text)
        if not os.path.exists(p):
            return None
        with np.load(p) as data:
            return data["embedding"], data["token_indices"]

    def put(self, text: str, embedding: np.ndarray,
            token_indices: np.ndarray) -> None:
        np.savez(self._path(text), embedding=embedding,
                 token_indices=token_indices)
