"""JSONL/CSV streaming ingestion into episodic memory (counterpart of
`aura_snn_rag_tpu/services/ingest.py`, the same functions over the
port's `HippocampalFormation`).

Field-flexible streaming one-shot writes: text fields tried in order,
pairs joined as "prompt → response"; each batch of `batch_size` texts is
embedded with one `embed_fn` call and written with one `write_batch`, ids
`{id_prefix}-{n}` in order. With `max_items` reading stops once the
stored and pending texts reach it, so at most `max_items` are stored.
"""

from __future__ import annotations

import csv
import json
from typing import Callable, List, Optional

import numpy as np

from aura_snn_rag_tpu_torch.memory.hippocampus import HippocampalFormation

_TEXT_FIELDS = ("text", "content", "body", "prompt", "question", "input")
_PAIR_FIELDS = (("prompt", "response"), ("question", "answer"),
                ("input", "output"))


def _extract_text(row: dict) -> Optional[str]:
    for a, b in _PAIR_FIELDS:
        if a in row and b in row:
            return f"{row[a]} → {row[b]}"
    for f in _TEXT_FIELDS:
        if f in row and row[f]:
            return str(row[f])
    return None


def ingest_jsonl_to_memory(hippocampus: HippocampalFormation,
                           path: str,
                           embed_fn: Callable[[List[str]], np.ndarray],
                           max_items: Optional[int] = None,
                           batch_size: int = 64,
                           id_prefix: str = "jsonl") -> int:
    """Stream a .jsonl file into the bank; returns number stored."""
    texts: List[str] = []
    stored = 0

    def flush():
        nonlocal stored, texts
        if not texts:
            return
        feats = np.asarray(embed_fn(texts), np.float32)
        ids = [f"{id_prefix}-{stored + i}" for i in range(len(texts))]
        hippocampus.write_batch(ids, feats)
        stored += len(texts)
        texts = []

    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            text = _extract_text(row) if isinstance(row, dict) else str(row)
            if not text:
                continue
            texts.append(text)
            if len(texts) >= batch_size:
                flush()
            if max_items is not None and stored + len(texts) >= max_items:
                break
    flush()
    return stored


def ingest_csv_pairs_to_memory(hippocampus: HippocampalFormation,
                               path: str,
                               embed_fn: Callable[[List[str]], np.ndarray],
                               max_items: Optional[int] = None,
                               batch_size: int = 64,
                               id_prefix: str = "csv") -> int:
    """Stream a CSV of (prompt, response)-style pairs; returns number stored."""
    texts: List[str] = []
    stored = 0

    def flush():
        nonlocal stored, texts
        if not texts:
            return
        feats = np.asarray(embed_fn(texts), np.float32)
        ids = [f"{id_prefix}-{stored + i}" for i in range(len(texts))]
        hippocampus.write_batch(ids, feats)
        stored += len(texts)
        texts = []

    with open(path, encoding="utf-8", errors="ignore", newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            text = _extract_text({k.lower(): v for k, v in row.items()
                                  if k})
            if not text and row:
                vals = [v for v in row.values() if v]
                text = " → ".join(vals[:2]) if len(vals) >= 2 else \
                    (vals[0] if vals else None)
            if not text:
                continue
            texts.append(text)
            if len(texts) >= batch_size:
                flush()
            if max_items is not None and stored + len(texts) >= max_items:
                break
    flush()
    return stored
