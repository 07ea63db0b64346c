"""A brain system's continuous-learning orchestrator, run for a while
(counterpart of `tools/continuous_learning_runner.py`).

    python -m aura_snn_rag_tpu_torch.tools.continuous_learning_runner
        [--vocab-dir DIR] [--rss] [--duration 30] [--d-model 64]
        [--device cuda]

`NeuromorphicBrainSystem(d_model, enable_rss)` and its orchestrator:
`--vocab-dir` points the orchestrator's watcher at a folder of *.txt
files, `--rss` adds the default feeds (they need the network). The
orchestrator runs for `--duration` seconds and stops; then one line, the
orchestrator's stats and the processor's, with the script's keys.
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import Optional, Sequence

from aura_snn_rag_tpu_torch.services.brain_system import (
    NeuromorphicBrainSystem)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.tools."
             "continuous_learning_runner",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--vocab-dir", default=None)
    ap.add_argument("--rss", action="store_true")
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    return ap


async def _run(args) -> dict:
    system = NeuromorphicBrainSystem(d_model=args.d_model,
                                     enable_rss=args.rss, device=args.device)
    orch = system.orchestrator
    if args.vocab_dir:
        orch.vocab_dir = args.vocab_dir
    await orch.start()
    print(f"orchestrator running for {args.duration}s "
          f"(feeds={len(orch.feeds)}, vocab_dir={orch.vocab_dir})",
          flush=True)
    try:
        await asyncio.sleep(args.duration)
    finally:
        await orch.stop()
    return {"stats": orch.stats,
            "health": system.get_health()["processor_stats"]}


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """The runner at the flags in `argv`; returns the line's object."""
    return asyncio.run(_run(parser().parse_args(argv)))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the orchestrator and print its line; returns the object."""
    line = run(argv)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
