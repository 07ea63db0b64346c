"""Host-to-device transfer rate by dtype (counterpart of
`benchmarks/bench_h2d_dtypes.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_h2d_dtypes
        [--mb=256] [--device cuda]

The JAX script's payloads, built from one f32 base of `--mb` MiB drawn
from `RandomState(0)`: f32; f16; bf16 (torch's cast of the base on the
host, round to nearest even, in place of `ml_dtypes`); u16 (the f16 bits
as uint16); i8 (round(x * 64) clipped to +-127); u8_raw (the f32 bytes as
uint8). Each is uploaded once from pageable host memory with
`torch.from_numpy(arr).to(device)` after a 1024-element warm upload, and
timed to `torch.cuda.synchronize()`: the path through which `bench.py`'s
`ingest_transfer_s` uploads the rows. Prints one line, MiB/s by dtype,
with the script's keys.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.bench import _sync


def payloads(mb: int) -> Dict[str, torch.Tensor]:
    """The payloads on the host, in the script's order."""
    base = np.random.RandomState(0).randn(mb * (1 << 20) // 4).astype(
        np.float32)
    f16 = base.astype(np.float16)
    return {
        "f32": torch.from_numpy(base),
        "f16": torch.from_numpy(f16),
        "bf16": torch.from_numpy(base).to(torch.bfloat16),
        "u16": torch.from_numpy(f16.view(np.uint16)),
        "i8": torch.from_numpy(np.clip(np.round(base * 64), -127, 127)
                               .astype(np.int8)),
        "u8_raw": torch.from_numpy(base.view(np.uint8)),  # the f32 bytes
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_h2d_dtypes",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    return ap


class H2DResult(NamedTuple):
    line: dict                    # the JSON line
    nbytes: Dict[str, int]        # payload -> bytes uploaded
    seconds: Dict[str, float]     # payload -> seconds of its upload


def run(argv: Optional[Sequence[str]] = None) -> H2DResult:
    """The benchmark at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    rates, nbytes, seconds = {}, {}, {}
    for name, host in payloads(args.mb).items():
        host[:1024].to(dev)                     # warm the path
        _sync(dev)
        t0 = time.perf_counter()
        on_dev = host.to(dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        nbytes[name] = host.numel() * host.element_size()
        seconds[name] = dt
        rates[name] = round(nbytes[name] / dt / (1 << 20), 2)
        del on_dev
    line = {"metric": "h2d MB/s by dtype", "payload_mb": args.mb, **rates}
    return H2DResult(line, nbytes, seconds)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark and print its JSON line; returns the object."""
    line = run(argv).line
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
