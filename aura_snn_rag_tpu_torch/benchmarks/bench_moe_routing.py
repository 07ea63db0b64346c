"""The Liquid-MoE router's routing quality (counterpart of
`benchmarks/bench_moe_routing.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_moe_routing
        [--device cuda]

The JAX script's study: four clusters in 32 dimensions (centres x 3 from
`RandomState(0)`); `LiquidMoERouter(32 -> 64, 8 experts, top-2)`,
trained with Adam (lr 1e-3) for 300 steps of 64 points to route cluster
i to expert i (cross-entropy of log(probs + 1e-9)), then evaluated on
512 points: routing accuracy (top-1 expert = cluster), the normalised
entropy of the batch's expert usage, and the last step's loss. The draws
are the script's, in its order; the router's weights come from a CPU
`torch.Generator` seeded 0 unless a router is passed in.
"""

from __future__ import annotations

import argparse
import json
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import LiquidMoERouter
from aura_snn_rag_tpu_torch.models.layers import initialize

D, E, N_CLUSTERS, HIDDEN = 32, 8, 4, 64
STEPS, BATCH, N_EVAL = 300, 64, 512
LR = 1e-3


def make_router(seed: int = 0, device="cpu") -> LiquidMoERouter:
    """The router with weights drawn from a CPU generator of `seed` (the
    same numbers on every device)."""
    router = LiquidMoERouter(D, HIDDEN, E, top_k=2, device="cpu")
    initialize(router, torch.Generator().manual_seed(seed))
    return router.to(device)


def routing_loss(router: LiquidMoERouter, x: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """optax's softmax cross-entropy of log(probs + 1e-9)."""
    probs = router(x)["probs"]
    return F.cross_entropy(torch.log(probs + 1e-9), target)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_moe_routing",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap


class RoutingResult(NamedTuple):
    line: dict                    # the JSON line
    losses: List[float]           # every training step's loss
    router: LiquidMoERouter


def run(argv: Optional[Sequence[str]] = None,
        router: Optional[LiquidMoERouter] = None) -> RoutingResult:
    """The benchmark at the flags in `argv`, from `router`'s weights when
    one is given (it is trained in place)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    centers = rng.randn(N_CLUSTERS, D).astype(np.float32) * 3
    router = make_router(0, dev) if router is None else router.to(dev)
    opt = torch.optim.Adam(router.parameters(), lr=LR)

    losses = []
    for _ in range(STEPS):
        cid = rng.randint(0, N_CLUSTERS, BATCH)
        x = centers[cid] + 0.5 * rng.randn(BATCH, D).astype(np.float32)
        opt.zero_grad()
        loss = routing_loss(router, torch.from_numpy(x).to(dev),
                            torch.from_numpy(cid).to(dev))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().tolist()

    cid = rng.randint(0, N_CLUSTERS, N_EVAL)
    x = centers[cid] + 0.5 * rng.randn(N_EVAL, D).astype(np.float32)
    with torch.no_grad():
        out = router(torch.from_numpy(x).to(dev))
    top1 = out["indices"][:, 0].cpu().numpy()
    acc = float((top1 == cid).mean())
    usage = out["usage"].cpu().numpy()
    usage = usage / usage.sum()
    entropy = float(-(usage * np.log(usage + 1e-9)).sum() / np.log(E))
    line = {"routing_accuracy": round(acc, 4),
            "utilization_entropy": round(entropy, 4),
            "final_loss": round(losses[-1], 4)}
    return RoutingResult(line, losses, router)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
