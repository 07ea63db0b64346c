"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the roofline bound."""

from __future__ import annotations

from typing import Dict, Tuple

BYTES_S = 3.35e12                  # HBM3
OPS_S = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "tf32": 495e12,
         "f32": 67e12}             # f32 outside the tensor cores
BF16_FLOPS = OPS_S["bf16"]         # the denominator of every MFU


def bound_s(nbytes: float, ops: Dict[str, float]) -> Tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over their peaks (summed across
    precisions); and which of the two it is."""
    t_bytes = nbytes / BYTES_S
    t_ops = sum(n / OPS_S[kind] for kind, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
