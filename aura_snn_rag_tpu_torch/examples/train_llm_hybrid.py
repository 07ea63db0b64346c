"""The hybrid STDP / Hebbian online learner on streamed text (counterpart
of `examples/train_llm_hybrid.py`).

    python -m aura_snn_rag_tpu_torch.examples.train_llm_hybrid
        [--passes 3] [--device cuda]

The gradient-free path: `LiquidBrain(input_dim=256, n_components=16,
max_components=64, n_experts=3)` (hash embeddings -> whitener -> Oja
features -> NLMS experts) learns each of the script's 24 labelled texts
per pass, while an STDP table over 32,000 token slots learns the texts'
token order. A line per pass (mean absolute error, the Oja width, the
consciousness level), then one JSON line: the last six errors' mean,
the STDP salience of "the neuron fired" and two predictions. The Oja
weights come from a `torch.Generator` seeded 0 (the script's from its
PRNG key).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.models.brain.brain import LiquidBrain
from aura_snn_rag_tpu_torch.training.online import (
    init_stdp, stdp_modulations, stdp_process_sequence)

CORPUS = [
    ("the cat sat on the mat", 0.0),
    ("dogs chase cats in the park", 0.0),
    ("the stock market rallied today", 1.0),
    ("investors bought shares of the company", 1.0),
    ("the neuron fired an action potential", 2.0),
    ("synapses strengthen with repeated activation", 2.0),
] * 4


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.examples.train_llm_hybrid",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap


class HybridResult(NamedTuple):
    lines: List[str]
    errors: List[float]           # every step's absolute error
    salience: List[float]         # unrounded
    predictions: Dict[str, float]  # unrounded
    line: Dict                    # the JSON line


def run(argv: Optional[Sequence[str]] = None) -> HybridResult:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    brain = LiquidBrain(input_dim=256, n_components=16,
                        max_components=64, n_experts=3, device=dev)
    stdp = init_stdp(32000, device=dev)

    out = Lines()
    errors = []
    for p in range(args.passes):
        for text, label in CORPUS:
            r = brain.learn_text(text, label)
            toks = brain.embedder.token_indices(text)
            if len(toks):
                stdp, _ = stdp_process_sequence(
                    stdp, torch.as_tensor(toks, device=dev)[None, :])
            errors.append(abs(r["error"]))
        out(f"pass {p}: mean|err|={np.mean(errors[-len(CORPUS):]):.3f} "
            f"K={r['K']} consciousness={r['consciousness']}")

    # token salience report
    toks = brain.embedder.token_indices("the neuron fired")
    mods = stdp_modulations(stdp, torch.as_tensor(toks, device=dev)
                            ).cpu().numpy()
    predictions = {"finance": brain.predict_text("shares rallied strongly"),
                   "neuro": brain.predict_text("the synapse potentiated")}
    line = {
        "final_mean_error": round(float(np.mean(errors[-6:])), 3),
        "salience('the neuron fired')": [round(float(m), 3) for m in mods],
        "predict(finance)": round(predictions["finance"], 3),
        "predict(neuro)": round(predictions["neuro"], 3),
    }
    out(json.dumps(line))
    return HybridResult(out, errors, [float(m) for m in mods], predictions,
                        line)


def main(argv: Optional[Sequence[str]] = None) -> HybridResult:
    """Learn the corpus and print the script's lines."""
    return run(argv)


if __name__ == "__main__":
    main()
