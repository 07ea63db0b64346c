"""Emotion classification end to end on labelled text (counterpart of
`benchmarks/bench_emotion_e2e.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_emotion_e2e
        [--epochs 600] [--synthetic] [--device cuda]

The JAX script's data and model. Data: the checkout's hand-curated
`data/emotion_eval.jsonl` (28 GoEmotions labels x 12 texts) by default,
or with `--synthetic` the keyword-template corpus (600 texts, 6
classes; a smoke test, not a quality number). A stratified split puts a
quarter of each label in the test set (`RandomState(0)`). Features:
`FastHashEmbedder(dim=1024)`. Model: `EmotionPersonalityHead` at
d_model 1024 with the data's classes, deterministic, weights from a CPU
`torch.Generator` seeded 0 unless a head is passed in; Adam (lr 3e-3)
on the full training batch for `--epochs` steps of the multitask loss.
Prints the script's eight keys: the source, sizes, top-1 and top-3 test
accuracy, the last step's loss and chance. The script's `--goemotions`
branch downloads the GoEmotions split and has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.encoders.hash_embedder import FastHashEmbedder
from aura_snn_rag_tpu_torch.models.emotion_head import (
    EmotionHeadConfig, EmotionPersonalityHead, emotion_multitask_loss)

DIM = 1024
LR = 3e-3
CURATED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "emotion_eval.jsonl")

GOEMOTIONS_LABELS = [
    "admiration", "amusement", "anger", "annoyance", "approval", "caring",
    "confusion", "curiosity", "desire", "disappointment", "disapproval",
    "disgust", "embarrassment", "excitement", "fear", "gratitude", "grief",
    "joy", "love", "nervousness", "optimism", "pride", "realization",
    "relief", "remorse", "sadness", "surprise", "neutral",
]

EMOTION_WORDS = {
    0: ("joy", "happy", "delighted", "wonderful", "love", "great"),
    1: ("sad", "unhappy", "depressed", "miserable", "crying", "loss"),
    2: ("angry", "furious", "rage", "annoyed", "hate", "outraged"),
    3: ("fear", "scared", "terrified", "anxious", "worried", "dread"),
    4: ("surprise", "astonished", "unexpected", "shocking", "sudden", "wow"),
    5: ("disgust", "gross", "revolting", "nasty", "repulsive", "awful"),
}

FILLER = ("the a it was and then very quite so really that this "
          "today yesterday about with from into over").split()


def load_curated(path: Optional[str] = None
                 ) -> Tuple[List[str], np.ndarray, int]:
    """The bundled hand-curated set: (texts, label ids, 28)."""
    lab_idx = {n: i for i, n in enumerate(GOEMOTIONS_LABELS)}
    texts, labels = [], []
    with open(path or CURATED) as f:
        for line in f:
            row = json.loads(line)
            texts.append(row["text"])
            labels.append(lab_idx[row["label"]])
    return texts, np.asarray(labels), len(GOEMOTIONS_LABELS)


def synthetic_corpus(n: int = 600, seed: int = 0
                     ) -> Tuple[List[str], np.ndarray, int]:
    """The keyword-template corpus: (texts, label ids, 6)."""
    rng = np.random.RandomState(seed)
    texts, labels = [], []
    for _ in range(n):
        lab = rng.randint(0, len(EMOTION_WORDS))
        words = list(rng.choice(FILLER, 6))
        for _ in range(2):
            words.insert(rng.randint(0, len(words)),
                         str(rng.choice(EMOTION_WORDS[lab])))
        texts.append(" ".join(words))
        labels.append(lab)
    return texts, np.asarray(labels), len(EMOTION_WORDS)


def stratified_split(labels: np.ndarray, test_frac: float = 0.25,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class split, so every label is in the train and test sets."""
    rng = np.random.RandomState(seed)
    train_idx, test_idx = [], []
    for lab in np.unique(labels):
        idx = np.where(labels == lab)[0]
        rng.shuffle(idx)
        n_test = max(1, int(round(test_frac * len(idx))))
        test_idx.extend(idx[:n_test])
        train_idx.extend(idx[n_test:])
    return np.asarray(train_idx), np.asarray(test_idx)


def make_head(n_classes: int, device="cpu") -> EmotionPersonalityHead:
    """The head at d_model 1024, weights from a CPU generator seeded 0."""
    return EmotionPersonalityHead(
        EmotionHeadConfig(d_model=DIM, n_emotions=n_classes),
        deterministic=True, device=device,
        generator=torch.Generator().manual_seed(0))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_emotion_e2e",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--synthetic", action="store_true",
                    help="keyword-template smoke corpus (NOT a quality "
                         "metric)")
    ap.add_argument("--device", default="cuda")
    return ap


class EmotionResult(NamedTuple):
    line: dict                    # the JSON line
    losses: List[float]           # every epoch's loss
    logits: torch.Tensor          # the test set's emotion logits
    split: Tuple[np.ndarray, np.ndarray]


def run(argv: Optional[Sequence[str]] = None,
        head: Optional[EmotionPersonalityHead] = None) -> EmotionResult:
    """The benchmark at the flags in `argv`, from `head`'s weights when
    one is given (it is trained in place)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.synthetic:
        texts, labels, n_cls = synthetic_corpus()
        source = "synthetic (smoke only)"
    else:
        texts, labels, n_cls = load_curated()
        source = "curated_offline (data/emotion_eval.jsonl, real labels)"
    tr, te = stratified_split(labels)
    X = torch.from_numpy(FastHashEmbedder(dim=DIM).embed_batch(texts)).to(dev)
    y = torch.from_numpy(labels).to(dev)
    Xtr, ytr, Xte, yte = X[tr], y[tr], X[te], y[te]

    head = make_head(n_cls, dev) if head is None else head.to(dev)
    head.requires_grad_(True)
    opt = torch.optim.Adam(head.parameters(), lr=LR)
    losses = []
    for _ in range(args.epochs):
        opt.zero_grad()
        loss, _ = emotion_multitask_loss(head(Xtr), {"emotion": ytr})
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().tolist()

    with torch.no_grad():
        logits = head(Xte)["emotion"]
    pred = logits.argmax(-1)
    acc = float((pred == yte).float().mean())
    # top-3: with 28 fine-grained emotions, near-synonym labels share
    # probability mass; the last three of a stable ascending sort, as
    # the script's argsort takes them
    top3 = torch.argsort(logits, dim=-1, stable=True)[:, -3:]
    acc3 = float((top3 == yte[:, None]).any(-1).float().mean())
    line = {
        "dataset": source,
        "n": len(texts),
        "n_classes": n_cls,
        "n_test": int(len(te)),
        "test_accuracy": round(acc, 4),
        "test_top3_accuracy": round(acc3, 4),
        "final_loss": round(losses[-1], 4),
        "chance": round(1 / n_cls, 4),
    }
    return EmotionResult(line, losses, logits, (tr, te))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
