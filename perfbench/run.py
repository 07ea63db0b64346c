"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, when the card is missing or has
fewer devices than the cell asks for, when a driver fails, or when JAX,
flax or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()       # the set-up time counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# caches of the program's compilers stay inside the checkout, at fixed paths
CACHE = ROOT / "perfbench" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="perfbench/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None, device=None, sizes=None, t_start=None) -> int:
    """One run. `device` and `sizes` are for the tests only: a CPU device
    skips the card check, and `sizes` shrinks the configuration."""
    import json
    from perfbench import core

    args = parser().parse_args(argv)
    try:
        cell = core.load_cell(core.load_spec(), args.workload)
        import torch
        if device is None:
            core.require_cuda(cell.chips)
            device = torch.device("cuda", 0)
        run = core.Run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device(device),
                       T_START if t_start is None else t_start,
                       dict(sizes or {}))
        driver = core.load_driver(cell.traffic["driver"])
        out = driver.run(run)
        bad = core.forbidden_loaded()
        if bad:
            raise core.BenchError(f"loaded in this process: {bad}")
        line = core.result_line(cell, out, core.device_info(
            run.device, cell.chips, out.memory_peak_bytes), run.trace)
    except core.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr, flush=True)
        return 2
    print(core.checks_text(out.checks), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
