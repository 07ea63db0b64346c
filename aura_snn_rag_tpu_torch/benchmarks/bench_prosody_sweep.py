"""The spiking layer with and without prosody modulation, per attention
configuration (counterpart of `benchmarks/bench_prosody_sweep.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_prosody_sweep
        [--json] [--device cuda]

The JAX script's inputs, from `RandomState(0)`: token ids [8, 64]
(vocab 32,000), inputs x [8, 64, 64] and a spike-aware linear w [64,
128] (std 1 / sqrt(64 * 0.1)); GIF parameters at 16 levels. The baseline
is `prosody_gif_scan` over x @ w with no gains; each `SWEEP_CONFIGS`
entry computes its gains with `prosody_attention_gains` and modulates
the same scan at strength 0.5. Each forward runs once to warm up, then
10 times, timed to the card's finish. Rows carry the script's seven
columns (total spikes, spike rate, ms per forward, spikes against the
baseline, winner utilisation, attention entropy, mean gain); `--json`
prints them as one object, otherwise as the script's table.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.bench import _sync
from aura_snn_rag_tpu_torch.models.prosody import (
    SWEEP_CONFIGS, prosody_attention_gains, prosody_gif_scan)
from aura_snn_rag_tpu_torch.ops.neurons import gif_params

B, T, D_IN, D_H = 8, 64, 64, 128
N_RUNS = 10
VOCAB = 32000


def _entropy(p: np.ndarray) -> float:
    p = p / (p.sum() + 1e-8)
    return float(-np.sum(p * np.log(p + 1e-8)))


def inputs():
    """(token_ids, x, w) as numpy arrays, the script's draws."""
    rng = np.random.RandomState(0)
    token_ids = rng.randint(0, VOCAB, (B, T))
    x = rng.randn(B, T, D_IN).astype(np.float32)
    # numpy divides in f64; the script's jnp.asarray then takes f32
    w = (rng.randn(D_IN, D_H).astype(np.float32)
         / np.sqrt(D_IN * 0.1)).astype(np.float32)
    return token_ids, x, w


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "bench_prosody_sweep",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


class SweepResult(NamedTuple):
    rows: List[dict]
    spikes: Dict[str, torch.Tensor]    # config -> the last forward's
    calls: int                         # forwards per config


def print_table(rows: List[dict]) -> None:
    """The script's table."""
    hdr = (f"{'config':24s} {'spikes':>10s} {'rate':>7s} {'ms':>8s} "
           f"{'vs_base':>8s} {'util':>6s} {'entropy':>8s} {'gain':>6s}")
    print(hdr)
    print("-" * len(hdr))
    nan = float("nan")
    for r in rows:
        util = r["winner_utilization"]
        ent = r["attention_entropy"]
        print(f"{r['config']:24s} {r['total_spikes']:10.0f} "
              f"{r['avg_spike_rate']:7.4f} {r['inference_ms']:8.3f} "
              f"{r['spike_ratio_vs_baseline']:8.4f} "
              f"{(util if util is not None else nan):6.3f} "
              f"{(ent if ent is not None else nan):8.4f} "
              f"{r['mean_gain']:6.3f}")


def run(argv: Optional[Sequence[str]] = None) -> SweepResult:
    """The sweep at the flags in `argv`; prints its table or object."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    ids_np, x_np, w_np = inputs()
    token_ids = torch.from_numpy(ids_np).to(dev)
    x = torch.from_numpy(x_np).to(dev)
    w = torch.from_numpy(w_np).to(dev)
    params = gif_params(levels=16)

    def baseline_fwd():
        spikes, _ = prosody_gif_scan(params, x @ w, None)
        return spikes, None, None

    def make_prosody_fwd(cfg):
        def fwd():
            gains, info = prosody_attention_gains(token_ids, cfg)
            spikes, _ = prosody_gif_scan(params, x @ w, gains,
                                         modulation_strength=0.5)
            return spikes, info, gains
        return fwd

    def timed(fn):
        fn()                                                # warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(N_RUNS):
            out = fn()
        _sync(dev)
        return out, (time.perf_counter() - t0) / N_RUNS * 1e3

    rows, all_spikes = [], {}
    (spikes, _, _), base_ms = timed(baseline_fwd)
    base_spikes = float(spikes.sum())
    all_spikes["no_prosody_baseline"] = spikes
    rows.append({
        "config": "no_prosody_baseline", "total_spikes": base_spikes,
        "avg_spike_rate": base_spikes / spikes.numel(),
        "inference_ms": round(base_ms, 3),
        "spike_ratio_vs_baseline": 1.0,
        "winner_utilization": None, "attention_entropy": None,
        "mean_gain": 1.0,
    })
    for name, cfg in SWEEP_CONFIGS.items():
        (spikes, info, gains), ms = timed(make_prosody_fwd(cfg))
        all_spikes[name] = spikes
        tot = float(spikes.sum())
        sal = info["salience"].cpu().numpy()
        winners = info["winners"].cpu().numpy()
        # winner utilisation: the share of the k slots that hold a
        # salient token (salience above half the row's maximum)
        wsal = np.take_along_axis(sal, winners, axis=1)
        util = float((wsal > 0.5 * sal.max(axis=1, keepdims=True)).mean())
        rows.append({
            "config": name, "total_spikes": tot,
            "avg_spike_rate": tot / spikes.numel(),
            "inference_ms": round(ms, 3),
            "spike_ratio_vs_baseline": round(tot / base_spikes, 4),
            "winner_utilization": round(util, 4),
            "attention_entropy": round(
                float(np.mean([_entropy(s) for s in sal])), 4),
            "mean_gain": round(float(gains.mean()), 4),
        })
    if args.json:
        print(json.dumps({"benchmark": "prosody_sweep", "rows": rows}),
              flush=True)
    else:
        print_table(rows)
    return SweepResult(rows, all_spikes, 1 + N_RUNS)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the sweep; returns its rows."""
    return run(argv).rows


if __name__ == "__main__":
    main()
