"""Train the emotion/personality multi-task head on labelled text
(counterpart of `examples/train_emotion_head.py`).

    python -m aura_snn_rag_tpu_torch.examples.train_emotion_head
        [--data rows.jsonl] [--epochs 20] [--lr 1e-3] [--device cuda]

Rows of (text, emotion, intent, tone, personality) from a JSONL file
(`text` and any of the four labels; a missing label is -1) or the
script's 64 synthetic rows; features from `FastHashEmbedder(dim=256)`.
`EmotionPersonalityHead` at d_model 256, deterministic, weights from a
CPU `torch.Generator` seeded 0 unless a head is passed to `run`; Adam
at `--lr` (betas 0.9 / 0.999, eps 1e-8, optax's defaults) on the full
batch of the multitask loss, one step per epoch; the loss every 5
epochs (before that epoch's update), then the emotion accuracy.
"""

from __future__ import annotations

import argparse
import json
from typing import List, NamedTuple, Optional, Sequence

import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.encoders.hash_embedder import FastHashEmbedder
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.models.emotion_head import (
    EmotionHeadConfig, EmotionPersonalityHead, emotion_multitask_loss)

SYNTHETIC = [
    ("i am so happy today", 0, 3, 1, 0),
    ("this makes me furious", 2, 3, 2, 1),
    ("could you explain the theorem", 7, 1, 0, 2),
    ("run the report now", 7, 2, 2, 3),
    ("i love this design", 0, 3, 1, 0),
    ("that is terrifying news", 3, 0, 2, 4),
    ("let us meet for coffee", 6, 4, 1, 2),
    ("the results are disappointing", 1, 0, 0, 1),
] * 8
TASKS = ("emotion", "intent", "tone", "personality")
DIM = 256


def load_rows(path):
    rows = []
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            try:
                r = json.loads(line)
                rows.append((r["text"], r.get("emotion", -1),
                             r.get("intent", -1), r.get("tone", -1),
                             r.get("personality", -1)))
            except (json.JSONDecodeError, KeyError):
                continue
    return rows


def make_head(device="cpu") -> EmotionPersonalityHead:
    """The head at d_model 256, weights from a CPU generator seeded 0."""
    return EmotionPersonalityHead(
        EmotionHeadConfig(d_model=DIM), deterministic=True, device=device,
        generator=torch.Generator().manual_seed(0))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.examples.train_emotion_head",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    return ap


class EmotionResult(NamedTuple):
    lines: List[str]
    losses: List[float]           # every epoch's loss
    accuracy: float


def run(argv: Optional[Sequence[str]] = None,
        head: Optional[EmotionPersonalityHead] = None) -> EmotionResult:
    """The script at the flags in `argv`, from `head`'s weights when one
    is given (it is trained in place)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    rows = load_rows(args.data) if args.data else SYNTHETIC
    embedder = FastHashEmbedder(dim=DIM)
    X = torch.from_numpy(embedder.embed_batch([r[0] for r in rows])).to(dev)
    labels = {k: torch.tensor([r[i + 1] for r in rows], device=dev)
              for i, k in enumerate(TASKS)}

    head = make_head(dev) if head is None else head.to(dev)
    head.requires_grad_(True)
    opt = torch.optim.Adam(head.parameters(), lr=args.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    out = Lines()
    losses = []
    for epoch in range(args.epochs):
        opt.zero_grad()
        loss, _ = emotion_multitask_loss(head(X), labels)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 5 == 0:
            out(f"epoch {epoch}: loss={loss.item():.4f}")
    losses = torch.stack(losses).cpu().tolist() if losses else []

    with torch.no_grad():
        logits = head(X)
    acc = float((logits["emotion"].argmax(-1) == labels["emotion"])
                .float().mean())
    out(f"final emotion accuracy: {acc:.3f}")
    return EmotionResult(out, losses, acc)


def main(argv: Optional[Sequence[str]] = None) -> EmotionResult:
    """Train the head and print the script's lines."""
    return run(argv)


if __name__ == "__main__":
    main()
