"""Readings that the limits of `correct` are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control]

For each seed, in one process, runs the cell's driver with a short
window and prints one JSON line with every compared number of the
program's answers; with `--control`, also those of the control (the
reference put in the program's place, one precision down) on the same
sample, and, where the driver has them (training), those of the faults
its steps can have. The benchmark's own runs never run either.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, seconds: float, control: bool,
             device=None, sizes=None) -> dict:
    """The program's (and the control's) compared numbers for one seed."""
    import torch
    from perfbench import core

    cell = core.load_cell(core.load_spec(), workload)
    if device is None:
        core.require_cuda(cell.chips)
        device = torch.device("cuda", 0)
    run = core.Run(cell, seed, seconds, False, torch.device(device),
                   time.perf_counter(), dict(sizes or {}))
    driver = core.load_driver(cell.traffic["driver"])
    seen = {}
    judge = driver.judge

    def both(*args, **kw):
        checks = judge(*args, **kw)
        if control:
            seen["control"] = {c.name: c.value
                               for c in driver.judge_control(*args, **kw)}
            faults = getattr(driver, "judge_faults", None)
            if faults is not None:
                for fault, cs in faults(*args, **kw).items():
                    seen[fault] = {c.name: c.value for c in cs}
        return checks

    driver.judge = both
    try:
        out = driver.run(run)
    finally:
        driver.judge = judge
    line = {"workload": workload, "seed": seed,
            "program": {c.name: c.value for c in out.checks},
            "correct": out.correct}
    line.update(seen)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated run seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
