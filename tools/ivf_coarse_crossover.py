#!/usr/bin/env python3
"""Where kernels B and D of the PyTorch/CUDA port should switch their
coarse pass from per pair to cluster-major, measured on one CUDA card.

    python3 tools/ivf_coarse_crossover.py [--batches 8,16,32,64,128,256,1024]

Builds two copies of `aura_snn_rag_tpu_torch/ops/cuda/csrc/ivf_scan.cu`
into the port's git-ignored build directory, one with
CLUSTER_MAJOR_PAIRS = 0 (every batch takes the cluster-major pass) and
one with 1e30 (every batch runs per pair), and loads each in turn in
place of the library. At the engine's shape (bench.py's: K = 4096,
C = 512, D = 768, P = 64, 1,000,000 bank rows, kk = 128, k = 10) it times
kernel B (`ivf_retrieve_fused`) and kernel D (`ivf_candidates`) at each
batch by CUDA-graph replay, the two builds in turns (per pair, cluster,
cluster, per pair), and holds the cluster-major results to the per-pair
ones as chip_smoke.py holds a kernel to its plain version. Then the LM's
shape (K = 256, C = 896, P = 8, 100,000 rows, k = 5) at B = 8. Prints one
JSON line per shape and batch, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the kernel phase's inputs and timers)

VARIANTS = {"pair": "1e30", "cluster": "0.0"}


def build_variants():
    """{variant: path of its library}, built with the port's nvcc flags,
    both nvcc processes started together."""
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    src = (_build.CSRC / "ivf_scan.cu").read_text()
    out = _build.BUILD_DIR / "crossover"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, value in VARIANTS.items():
        text, n = re.subn(r"constexpr double CLUSTER_MAJOR_PAIRS = [^;]+;",
                          f"constexpr double CLUSTER_MAJOR_PAIRS = {value};",
                          src)
        if n != 1:
            raise RuntimeError("CLUSTER_MAJOR_PAIRS not found in ivf_scan.cu")
        cu = out / f"ivf_scan_{name}.cu"
        cu.write_text(text)
        lib = out / f"libivf_scan_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log.decode()}")
    return {name: lib for name, (lib, _) in procs.items()}


def use(lib):
    """Route the port's wrappers to the library at `lib`."""
    from aura_snn_rag_tpu_torch.ops.cuda import _build
    _build._libs["ivf_scan"] = ctypes.CDLL(str(lib))
    _build._bound.clear()


def measure(libs, ivf, shape, batches, iters):
    import numpy as np
    import torch
    from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import (
        ivf_candidates, ivf_retrieve_fused)
    cl, aux, feats, sets = ivf
    kk, k = shape["kk"], shape["k"]
    rows = []
    for B in batches:
        bsets = [(q[:B].contiguous(), t[:B].contiguous()) for q, t in sets]
        fns = {"B": [lambda q=q, t=t: ivf_retrieve_fused(
                   cl, aux, feats, q, t, kk, k) for q, t in bsets],
               "D": [lambda q=q, t=t: ivf_candidates(cl, aux, q, t, kk)
                     for q, t in bsets]}
        got, ms = {}, {}
        for turn, name in enumerate(("pair", "cluster", "cluster", "pair")):
            use(libs[name])
            for kern, calls in fns.items():
                if turn < 2:
                    got[name, kern] = [x.cpu().numpy() for x in calls[0]()]
                ms.setdefault((name, kern), []).append(
                    chip_smoke.graph_ms(calls, iters=iters, replays=3))
        # the cluster-major results against the per-pair ones
        s, sl = got["cluster", "B"]
        ps, psl = got["pair", "B"]
        err_b = float(np.abs(np.where(ps[:, :k] > -5e29,
                                      s[:, :k] - ps[:, :k], 0)).max())
        chip_smoke.check(err_b <= 1e-5, f"B={B}: kernel B err {err_b}")
        chip_smoke.check_slots("B", s[:, :k], sl[:, :k], ps[:, :k],
                               psl[:, :k])
        s, sl = got["cluster", "D"]
        ps, psl = got["pair", "D"]
        live = ps > -5e29
        err_d = float(np.abs(np.where(live, s - ps, 0)).max())
        chip_smoke.check(err_d <= 1e-5, f"B={B}: kernel D err {err_d}")
        row = dict(shape=shape["name"], B=B,
                   pairs_per_cluster=B * shape["P"] / shape["K"],
                   probed_clusters=int(torch.unique(bsets[0][1]).numel()),
                   err_B=err_b, err_D=err_d)
        for (name, kern), v in ms.items():
            row[f"{kern}_{name}_graph_ms"] = v
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="8,16,32,64,128,256,1024")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ivf_coarse_crossover: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    batches = [int(b) for b in args.batches.split(",")]
    s = dict(chip_smoke.KERNEL_SHAPES, name="engine")
    ivf = chip_smoke.ivf_inputs(dev, gen, s["K"], s["C"], s["D"], s["M"],
                                s["P"], max(batches), 2)
    measure(libs, ivf, s, batches, iters=10)
    del ivf
    torch.cuda.empty_cache()
    s = dict(chip_smoke.LM_KERNEL_SHAPES, name="lm")
    ivf = chip_smoke.ivf_inputs(dev, gen, s["K"], s["C"], s["D"], s["M"],
                                s["P"], 8, 2)
    measure(libs, ivf, s, [8], iters=20)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
