"""Prosody hyperparameter tuning: a grid over the spiking-salience
configuration (counterpart of `scripts/tune_prosody_hyperparameters.py`).

    python -m aura_snn_rag_tpu_torch.scripts.tune_prosody_hyperparameters
        [--trials 24] [--seq-len 128] [--device cuda]

The first `--trials` of the 36 (decay, gain_up, k_winners, smoothing)
combinations, each a `ProsodyAttentionConfig` (one decay for the three
channels), scored on 4 batches of 4 x `--seq-len` token ids
(`RandomState(0)`, vocabulary 32,000) through `prosody_attention_gains`
on the device: salience coverage (the share above 0.1), the gains'
dynamic range and the mean mu; the score rewards coverage near 0.35 and
a usable range. Prints the three best and the trial count as indented
JSON.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.models.prosody import (
    ProsodyAttentionConfig, prosody_attention_gains)

GRID = (
    (0.6, 0.7, 0.8),          # decay
    (1.2, 1.8, 2.4),          # gain_up
    (5, 7),                   # k_winners
    (0, 3),                   # smoothing
)


def score_config(cfg: ProsodyAttentionConfig, token_batches,
                 device="cuda") -> Tuple[float, Dict[str, float]]:
    """(score, metrics) of one configuration over the batches."""
    dev = resolve_device(device)
    coverages, ranges, mus = [], [], []
    for ids in token_batches:
        gains, info = prosody_attention_gains(
            torch.as_tensor(np.asarray(ids), device=dev), cfg)
        sal = info["salience"].cpu().numpy()
        coverages.append(float((sal > 0.1).mean()))
        g = gains.cpu().numpy()
        ranges.append(float(g.max() - g.min()))
        mus.append(float(info["mu_scalar"].cpu().numpy().mean()))
    coverage = float(np.mean(coverages))
    dyn_range = float(np.mean(ranges))
    # objective: moderate coverage (not all-silent/all-max), usable range
    return (-(abs(coverage - 0.35)) + 0.25 * min(dyn_range, 2.0),
            {"coverage": coverage, "dynamic_range": dyn_range,
             "mean_mu": float(np.mean(mus))})


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.scripts."
             "tune_prosody_hyperparameters",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=24)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    return ap


class TuneResult(NamedTuple):
    lines: List[str]
    results: List[Dict]           # every trial, best first
    summary: Dict                 # the printed object


def run(argv: Optional[Sequence[str]] = None) -> TuneResult:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 32000, (4, args.seq_len)) for _ in range(4)]

    results = []
    for decay, gain_up, k, smooth in list(
            itertools.product(*GRID))[:args.trials]:
        cfg = ProsodyAttentionConfig(
            k_winners=k, decay=(decay,) * 3, gain_up=gain_up,
            smoothing=smooth)
        score, metrics = score_config(cfg, batches, dev)
        results.append({"decay": decay, "gain_up": gain_up,
                        "k_winners": k, "smoothing": smooth,
                        "score": round(score, 4), **metrics})

    results.sort(key=lambda r: -r["score"])
    summary = {"best": results[:3], "trials": len(results)}
    out = Lines()
    for line in json.dumps(summary, indent=2).splitlines():
        out(line)
    return TuneResult(out, results, summary)


def main(argv: Optional[Sequence[str]] = None) -> TuneResult:
    """Score the grid and print the best three."""
    return run(argv)


if __name__ == "__main__":
    main()
