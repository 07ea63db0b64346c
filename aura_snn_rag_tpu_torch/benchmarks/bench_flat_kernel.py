"""Kernel A against the library's coarse scan, one batch (counterpart of
`benchmarks/bench_flat_kernel.py`).

    python -m aura_snn_rag_tpu_torch.benchmarks.bench_flat_kernel
        [--small] [--bf16] [--device cuda]

The JAX script's data: 1,000,000 x 768 unit rows of `RandomState(0)`
(`--small`: 100,000), stored as int8 (x 127, rounded) or, with `--bf16`,
as bf16; the first 128 rows are the queries; every row term is mul = 1,
add = 0, so the surface is the per-query maximum cosine of each 8-row
block. Each line is one call to warm up, then REPS calls (4 at
`--small`, else 8) timed to `torch.cuda.synchronize()`, printed with the
script's columns: ms per batch, the bank's bytes over that time
(effective GB/s) and queries per second of the coarse stage.

- "library coarse+blockmax" (the script's "xla coarse+blockmax"): the
  library's product, `torch._int_mm` for int8 or a bf16 `matmul`, then
  the epilogue and the block max in PyTorch (`blockmax_library`);
- kernel A (`ops/cuda/flat_scan.flat_blockmax`) in the one design it
  has: `wgmma` s8 x s8 -> s32 for int8, bf16 for bf16
  (`ops/cuda/csrc/flat_scan.cu`'s header). On a CPU tensor the wrapper
  runs its plain version.

The script's Pallas lines at tile_m 1024 and 2048, and with int8 rows
multiplied as bf16 (`int8_via_bf16`), are tilings of the TPU kernel; the
port's kernel has neither option, so no line stands for them.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.bench import _sync
from aura_snn_rag_tpu_torch.ops.cuda.flat_scan import (
    BLOCK_R, INV_127SQ, flat_blockmax, pack_row_terms)

D = 768
B = 128
LIBRARY = "library coarse+blockmax"
KERNEL = {"int8": "cuda wgmma s8xs8->s32", "bf16": "cuda wgmma bf16"}


def sizes(small: bool) -> Tuple[int, int]:
    """(rows, timed calls per line)."""
    return (100_000, 4) if small else (1_000_000, 8)


def blockmax_library(bank: torch.Tensor, q: torch.Tensor, mul: torch.Tensor,
                     add: torch.Tensor, q_scale: Optional[torch.Tensor] = None,
                     slab: Optional[int] = None) -> torch.Tensor:
    """Kernel A's function through the library: the product (`_int_mm`
    for an int8 bank, a bf16 `matmul` otherwise), then the same epilogue
    and block max in PyTorch; over `slab` bank rows at a time (default
    all), so that the [B, slab] products fit beside a 10M-row bank. A
    bf16 `matmul` rounds each product to bf16, so this is a yardstick of
    time, not of values."""
    from aura_snn_rag_tpu_torch.memory.engine import _int8_matmul
    M, n_q = bank.shape[0], q.shape[0]
    slab = slab or M
    out = []
    for r in range(0, M, slab):
        part = bank[r:r + slab]
        if bank.dtype == torch.int8:
            cos = _int8_matmul(q, part).float() * INV_127SQ
            if q_scale is not None:
                cos = cos * q_scale[:, None]
        else:
            cos = torch.matmul(q, part.T).float()
        comb = cos * mul[r:r + part.shape[0]] + add[r:r + part.shape[0]]
        out.append(comb.reshape(n_q, -1, BLOCK_R).amax(-1))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def make_inputs(M: int, n_q: int, dtype: str, dev: torch.device):
    """(bank, queries, mul, add) as the JAX script makes them: unit rows
    of `RandomState(0)`, int8 as round(x * 127) clipped to +-127, or bf16;
    the queries are the first rows; mul = 1, add = 0, packed."""
    rng = np.random.RandomState(0)
    feats = rng.randn(M, D).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12
    if dtype == "int8":
        rows = np.clip(np.round(feats * 127.0), -127, 127).astype(np.int8)
        bank = torch.from_numpy(rows).to(dev)
    else:
        bank = torch.from_numpy(feats).to(dev).to(torch.bfloat16)
    del feats
    q = bank[:n_q].clone()
    mul, add = pack_row_terms(torch.ones(M, device=dev),
                              torch.zeros(M, device=dev), M)
    return bank, q, mul, add


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.benchmarks.bench_flat_kernel",
        allow_abbrev=False, description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


class FlatKernelResult(NamedTuple):
    lines: List[dict]                  # name, ms_per_batch, gb_s, qps
    surfaces: Dict[str, torch.Tensor]  # name -> the warm call's [B, M/8]
    inputs: Tuple[torch.Tensor, ...]   # (bank, q, mul, add)
    calls: Dict[str, int]              # name -> calls made
    dtype: str


def format_line(line: dict) -> str:
    """The JAX script's printed line."""
    return (f"{line['name']:28s} {line['ms_per_batch']:8.2f} ms/batch   "
            f"{line['gb_s_eff']:7.1f} GB/s eff   "
            f"{line['qps_coarse']:9.0f} QPS(coarse)")


def run(argv: Optional[Sequence[str]] = None) -> FlatKernelResult:
    """The benchmark at the flags in `argv`."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    dtype = "bf16" if args.bf16 else "int8"
    M, reps = sizes(args.small)
    if dev.type == "cuda":
        # nvcc before any timer
        from aura_snn_rag_tpu_torch.ops.cuda import _build
        _build.build_all()
        _build.load("flat_scan")
    bank, q, mul, add = make_inputs(M, B, dtype, dev)
    bank_bytes = M * D * bank.element_size()
    lines, surfaces, calls = [], {}, {}

    def timed(name, fn):
        surfaces[name] = fn()                                # warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        dt = (time.perf_counter() - t0) / reps
        calls[name] = 1 + reps
        line = dict(name=name, ms_per_batch=dt * 1e3,
                    gb_s_eff=bank_bytes / dt / 1e9, qps_coarse=B / dt)
        lines.append(line)
        print(format_line(line), flush=True)

    timed(LIBRARY, lambda: blockmax_library(bank, q, mul, add))
    timed(KERNEL[dtype], lambda: flat_blockmax(bank, q, mul, add))
    return FlatKernelResult(lines, surfaces, (bank, q, mul, add), calls,
                            dtype)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the benchmark (it prints its lines); returns them."""
    return run(argv).lines


if __name__ == "__main__":
    main()
