"""Does the prosody signal survive the router's load balancing? Four
incremental configurations (counterpart of
`benchmarks/ablation_moe_routing.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.ablation_moe_routing
        [--hash-channels] [--device cuda]

The JAX script's study. Configurations: clean (no bandit, no usage
bias), usage bias only (beta 0.5), bandit only (UCB), both. For each,
`n_samples` texts (100) of each regime, low and high prosody salience,
drawn from `RandomState(seed)`: the text's prosody gain scales the
router's temperature (temp = T / gain), a random point is routed by
`LiquidMoERouter(32 -> 64, 8 experts, top-2)` at that gain, the usage
bias subtracts beta x the usage moving average from the log-probs, the
bandit renormalises the top-2 by UCB score mass; the entropy of the
final distribution is recorded. PASS: the low regime's mean entropy
above the high regime's and corr(gain, entropy) < -0.3; WEAK: only the
first; FAIL otherwise.

The gain (`gain_for`): by default from the text-derived channels
(`prosody_channels_from_strings`) through `k7_aggressive`'s attention;
with `--hash-channels`, the reference's literal input, positional ids
through the trig-hash channels. The router's weights come from a CPU
`torch.Generator` seeded 0 (the same for every configuration, as the
script's `PRNGKey(0)`) unless a router is passed in. Prints the summary
object with the script's keys.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.benchmarks.bench_moe_routing import make_router
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import (
    BanditGating, LiquidMoERouter)
from aura_snn_rag_tpu_torch.models.prosody import (
    SWEEP_CONFIGS, multi_channel_spiking_attention, prosody_attention_gains,
    prosody_channels_from_strings)

E, D = 8, 32

LOW_PROSODY_TEXTS = [
    "the report covers the second quarter and was filed on tuesday",
    "the bus arrives at quarter past and then it is a short walk",
    "the recipe calls for two eggs and a cup of milk",
    "classes resume on the ninth according to the schedule",
    "the store closes at nine on weekdays and six on sundays",
]

HIGH_PROSODY_TEXTS = [
    "WOW this is absolutely INCREDIBLE I cannot believe it!!",
    "NO WAY they actually WON the entire championship!!",
    "this is URGENT drop everything and CALL me NOW!!",
    "I am SO EXCITED the tickets finally ARRIVED today!!",
    "STOP that is the most AMAZING thing I have EVER seen!!",
]

CONFIGS = (
    ("clean_baseline", False, 0.0),
    ("usage_bias_only", False, 0.5),
    ("bandit_only", True, 0.0),
    ("full_system", True, 0.5),
)


def gain_for(text: str, hash_channels: bool = False,
             device="cpu") -> float:
    """The text's mean prosody gain."""
    if hash_channels:
        # the reference's positional ids through the trig-hash channels
        ids = torch.arange(len(text.split()), dtype=torch.int32,
                           device=device)[None, :]
        gains, _ = prosody_attention_gains(ids)
        return float(gains.mean())
    # k7_aggressive: unnormalised salience keeps the regime's intensity
    amp, pitch, boundary = (torch.from_numpy(c).to(device) for c in
                            prosody_channels_from_strings(text.split()))
    res = multi_channel_spiking_attention(amp, pitch, boundary,
                                          SWEEP_CONFIGS["k7_aggressive"])
    gains = res["mu_scalar"][:, None] * (1.0 + res["salience"])
    return float(gains.mean())


def run_config(name: str, use_bandit: bool, usage_beta: float,
               n_samples: int = 100, seed: int = 0,
               hash_channels: bool = False, device="cpu",
               router: Optional[LiquidMoERouter] = None,
               trace: Optional[Dict[str, list]] = None) -> dict:
    """One configuration's row. `trace`, when given, receives every
    sample's gain and entropy ("gains", "entropies")."""
    rng = np.random.RandomState(seed)
    router = make_router(0, device) if router is None else router
    bandit = BanditGating(E) if use_bandit else None
    usage_ma = np.zeros(E)

    results = {"low": [], "high": []}
    gains_all, ents_all = [], []
    for regime, texts in (("low", LOW_PROSODY_TEXTS),
                          ("high", HIGH_PROSODY_TEXTS)):
        for _ in range(n_samples):
            text = texts[rng.randint(len(texts))]
            gain = gain_for(text, hash_channels, device)
            x = torch.from_numpy(rng.randn(1, D).astype(np.float32)).to(
                device)
            with torch.no_grad():
                out = router(x, attn_gain=torch.tensor([gain],
                                                       device=device))
            probs = out["probs"][0].cpu().numpy().astype(np.float64)
            # usage-bias pressure: beta x the usage moving average off the
            # log-probs
            if usage_beta > 0:
                logits = np.log(probs + 1e-9) - usage_beta * usage_ma
                probs = np.exp(logits - logits.max())
                probs /= probs.sum()
            # bandit blending: the top-k renormalised by UCB score mass
            if bandit is not None:
                top, gates = bandit.select_top_k(2, probs)
                probs = gates / gates.sum()
                bandit.update(top[0], error=rng.rand() * 5)
            usage_ma = 0.99 * usage_ma + 0.01 * probs
            ent = float(-(probs * np.log(probs + 1e-9)).sum())
            results[regime].append(ent)
            gains_all.append(gain)
            ents_all.append(ent)

    if trace is not None:
        trace["gains"], trace["entropies"] = gains_all, ents_all
    low_e = float(np.mean(results["low"]))
    high_e = float(np.mean(results["high"]))
    corr = float(np.corrcoef(gains_all, ents_all)[0, 1])
    status = ("PASS" if (low_e > high_e and corr < -0.3)
              else "WEAK" if low_e > high_e else "FAIL")
    return {"config": name, "use_bandit": use_bandit,
            "usage_beta": usage_beta,
            "low_entropy": round(low_e, 4),
            "high_entropy": round(high_e, 4),
            "gain_entropy_corr": round(corr, 4),
            "status": status}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks."
             "ablation_moe_routing",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--hash-channels", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def run(argv: Optional[Sequence[str]] = None, n_samples: int = 100,
        router: Optional[LiquidMoERouter] = None) -> dict:
    """The study at the flags in `argv`; returns the summary object."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    router = make_router(0, dev) if router is None else router.to(dev)
    rows = [run_config(n, b, u, n_samples=n_samples,
                       hash_channels=args.hash_channels, device=dev,
                       router=router) for n, b, u in CONFIGS]
    baseline, full = rows[0], rows[-1]
    return {
        "rows": rows,
        "baseline_corr": baseline["gain_entropy_corr"],
        "full_corr": full["gain_entropy_corr"],
        "corr_degradation": round(
            full["gain_entropy_corr"] - baseline["gain_entropy_corr"], 4),
        "prosody_signal_survives": abs(full["gain_entropy_corr"]) > 0.3,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the study and print its summary; returns the object."""
    summary = run(argv)
    print(json.dumps(summary, indent=2), flush=True)
    return summary


if __name__ == "__main__":
    main()
