"""Prosody visualisation: channels, salience and gains to a PNG
(counterpart of `scripts/visualize_prosody.py`).

    python -m aura_snn_rag_tpu_torch.scripts.visualize_prosody
        [--out prosody.png] [--seq-len 128] [--device cuda]

`traces` runs the prosody pipeline on the device for one row of
`--seq-len` token ids (`RandomState(0)`, vocabulary 32,000): the
(amplitude, pitch, boundary) channels, the salience, the k winners, the
per-token attention gains and mu, returned as numpy arrays. `run` draws
the script's three panels with matplotlib (imported there alone) and
saves the figure.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.examples._common import Lines
from aura_snn_rag_tpu_torch.models.prosody import (
    prosody_attention_gains, prosody_channels_from_tokens)

TRACES = ("amplitude", "pitch", "boundary", "salience", "winners", "gains",
          "mu_scalar")


def token_ids(seq_len: int = 128) -> np.ndarray:
    """The script's [1, seq_len] ids."""
    return np.random.RandomState(0).randint(0, 32000, (1, seq_len))


def traces(ids, device="cuda") -> Dict[str, np.ndarray]:
    """The pipeline's traces of `ids` [B, T] on `device`, as numpy."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(ids), device=dev)
    amp, pitch, boundary = prosody_channels_from_tokens(x)
    gains, info = prosody_attention_gains(x)
    values = (amp, pitch, boundary, info["salience"], info["winners"],
              gains, info["mu_scalar"])
    return {k: v.cpu().numpy() for k, v in zip(TRACES, values)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.scripts.visualize_prosody",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="prosody.png")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    return ap


class PlotResult(NamedTuple):
    lines: List[str]
    traces: Dict[str, np.ndarray]


def run(argv: Optional[Sequence[str]] = None) -> PlotResult:
    args = parser().parse_args(argv)
    tr = traces(token_ids(args.seq_len), args.device)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, figsize=(12, 8), sharex=True)
    t = np.arange(args.seq_len)
    axes[0].plot(t, tr["amplitude"][0], label="amplitude", lw=1)
    axes[0].plot(t, tr["pitch"][0], label="pitch", lw=1)
    axes[0].plot(t, tr["boundary"][0], label="boundary", lw=1)
    axes[0].set_ylabel("channels")
    axes[0].legend(loc="upper right", fontsize=8)

    axes[1].plot(t, tr["salience"][0], color="tab:purple")
    winners = tr["winners"][0]
    axes[1].scatter(winners, tr["salience"][0][winners],
                    color="tab:red", s=18, zorder=3, label="winners")
    axes[1].set_ylabel("salience")
    axes[1].legend(loc="upper right", fontsize=8)

    mu = float(tr["mu_scalar"][0])
    axes[2].plot(t, tr["gains"][0], color="tab:green")
    axes[2].axhline(mu, ls="--", color="gray", label=f"mu={mu:.2f}")
    axes[2].set_ylabel("attention gain")
    axes[2].set_xlabel("token position")
    axes[2].legend(loc="upper right", fontsize=8)

    fig.suptitle("Prosody spiking-salience pipeline")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    out = Lines()
    out(f"wrote {args.out}")
    return PlotResult(out, tr)


def main(argv: Optional[Sequence[str]] = None) -> PlotResult:
    """Trace, draw, save and print the script's line."""
    return run(argv)


if __name__ == "__main__":
    main()
