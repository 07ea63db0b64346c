"""Kernel A: the flat block-max scan (counterpart of
`aura_snn_rag_tpu/ops/pallas/flat_scan.py`).

For every query b and every 8-row block g of the coarse bank:

    out[b, g] = max_{r in 8g..8g+7} (cos[b, r] * mul[r] + add[r])

with cos = q . bank^T (an int8 bank: acc * 1/127^2 * q_scale[b]) and rows
past M at -1e30. The [B, M] score matrix is never written; the caller
picks the top blocks and reranks their member rows (engine
`select_block_candidates`).

Blocks are contiguous (block g = rows 8g..8g+7). The TPU kernel's
strided-within-tile layout and its 128-query padding existed for the TPU's
lanes and are dropped; any partition into 8-row blocks keeps the funnel
guarantee.

On a CUDA tensor `flat_blockmax` launches `csrc/flat_scan.cu` (replaces
the TPU kernel at aura_snn_rag_tpu/ops/pallas/flat_scan.py:172; bound,
design and what is left for later are in the source's header). On a CPU
tensor it runs `flat_blockmax_plain`, the same function in PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from aura_snn_rag_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
BLOCK_R = 8                      # rows per funnel block
INV_127SQ = 1.0 / (127.0 * 127.0)
PLAIN_SLAB = 1 << 20             # bank rows per slab of the plain version


def pack_row_terms(mul: torch.Tensor, add: torch.Tensor,
                   M: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M] per-row affine terms -> f32 [n_blocks * 8], the tail padded
    with mul = 0 / add = -1e30 so a padded row never wins a block max."""
    pad = (-M) % BLOCK_R
    mul_p = torch.nn.functional.pad(mul.float(), (0, pad))
    add_p = torch.nn.functional.pad(add.float(), (0, pad), value=NEG_INF)
    return mul_p.contiguous(), add_p.contiguous()


def block_member_slots(blocks: torch.Tensor) -> torch.Tensor:
    """Block ids [..., Kb] -> member row ids [..., Kb, 8] (contiguous)."""
    return (blocks[..., None] * BLOCK_R
            + torch.arange(BLOCK_R, device=blocks.device))


def flat_blockmax_plain(bank: torch.Tensor, q: torch.Tensor,
                        mul: torch.Tensor, add: torch.Tensor,
                        q_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The kernel's function in PyTorch (the CPU path and the kernel's
    oracle on the card). The bank is taken in slabs of PLAIN_SLAB rows, so
    its f32 copy and the [B, slab] scores stay small at 10M rows; a block
    never straddles two slabs."""
    M, D = bank.shape
    if bank.dtype == torch.int8 and D * 127 * 127 >= 2 ** 24:
        raise ValueError(f"flat_blockmax_plain: D={D} too wide for exact "
                         "int8 sums in f32")
    if M > PLAIN_SLAB:
        return torch.cat([
            flat_blockmax_plain(bank[r:r + PLAIN_SLAB], q, mul[r:],
                                add[r:], q_scale)
            for r in range(0, M, PLAIN_SLAB)], dim=1)
    B = q.shape[0]
    nb = -(-M // BLOCK_R)
    if bank.dtype == torch.int8:
        # exact: every partial sum is an integer below D*127^2 < 2^24
        acc = q.float() @ bank.float().T
        cos = acc * INV_127SQ
        if q_scale is not None:
            cos = cos * q_scale.float()[:, None]
    else:
        cos = q.float() @ bank.float().T                  # f32 accumulation
    comb = cos * mul[:M] + add[:M]
    pad = nb * BLOCK_R - M
    if pad:
        comb = torch.nn.functional.pad(comb, (0, pad), value=NEG_INF)
    return comb.reshape(B, nb, BLOCK_R).amax(dim=-1)


def flat_blockmax(bank: torch.Tensor, q: torch.Tensor, mul: torch.Tensor,
                  add: torch.Tensor,
                  q_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-block maxima [B, ceil(M/8)] f32 of the combined coarse score.

    bank: [M, D] int8 (per-row 127-scaled) or bf16 L2-normalised rows.
    q:    [B, D] queries of the bank's dtype.
    mul, add: f32 [>= ceil(M/8)*8] from `pack_row_terms`, in cosine units
          (the int8 1/127^2 dequantisation happens inside).
    q_scale: [B] f32 per-query max-abs scales (int8 banks), or None.
    """
    if not bank.is_cuda:
        return flat_blockmax_plain(bank, q, mul, add, q_scale)
    M, D = bank.shape
    B = q.shape[0]
    nb = -(-M // BLOCK_R)
    if bank.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"flat_blockmax: bank dtype {bank.dtype}")
    if q.dtype != bank.dtype or q.shape != (B, D):
        raise ValueError(f"flat_blockmax: q {tuple(q.shape)} {q.dtype}")
    if D % 64:
        raise ValueError(f"flat_blockmax: D={D} must be a multiple of 64")
    if M >= 2 ** 31 or B >= 2 ** 31:
        raise ValueError(f"flat_blockmax: M={M}, B={B} past the kernel's "
                         "32-bit TMA row coordinates")
    for name, t in (("mul", mul), ("add", add)):
        if t.dtype != torch.float32 or t.numel() < nb * BLOCK_R:
            raise ValueError(f"flat_blockmax: {name} {t.dtype} {t.numel()}")
    tensors = [bank, q, mul, add]
    if q_scale is not None:
        if q_scale.dtype != torch.float32 or q_scale.numel() != B:
            raise ValueError("flat_blockmax: q_scale must be f32 [B]")
        tensors.append(q_scale)
    for t in tensors:
        if (not t.is_contiguous() or t.device != bank.device
                or t.data_ptr() % 16):
            raise ValueError("flat_blockmax: inputs must be contiguous, "
                             "16-byte aligned and on the bank's device")
    out = torch.empty((B, nb), dtype=torch.float32, device=bank.device)
    lib = _build.load("flat_scan")
    fn = lib.flat_blockmax_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_long, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(bank), _build.ptr(q), _build.ptr(mul), _build.ptr(add),
            _build.ptr(q_scale) if q_scale is not None else None,
            _build.ptr(out), M, D, B, int(bank.dtype == torch.int8),
            _build.stream())
    _build.check(rc, "flat_blockmax")
    _build.launch_counts["flat_blockmax"] += 1
    return out
