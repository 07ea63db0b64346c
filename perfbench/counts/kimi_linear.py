"""The Kimi-Linear LM's FLOPs and its KDA core's bytes, counted from the
configuration's shapes and the routed experts' tallied assignments.

`m` holds the port's `KimiLinearConfig` fields. Every product of the
forward counts 2 FLOPs a multiply-add: latent attention's projections (q,
kv_a, kv_b, o) and its causal core (`moonlight.attention_core_flops`) in
the full layers; Kimi Delta Attention's projections (q, k, v, the gate's
and the output gate's two low-rank factors, beta, o) and its chunked
core (`kda_core_flops`) in the others; the memory layers, the FFNs, the
router, the experts and the head as `counts.moonlight` counts them.
Embedding lookups, norms, the convolutions, the elementwise gates, the
episodic retrieval and the recomputed products of a backward are not
counted. A training step is three forwards (the backward counts twice).
"""

from __future__ import annotations

from perfbench.counts import moonlight

CHUNK = 64


def kda_core_flops(m: dict, rows: int, seq: int, chunk: int = CHUNK
                   ) -> float:
    """One forward of the chunked core over `rows` sequences of `seq`, per
    head and chunk of C positions (d channels): the pairwise A (i < t)
    and P (i <= t), the unit-triangular solve for [C, 2d] right-hand
    sides, the products W h, (q exp G) h, P U and Khat^T U."""
    H, d, C = m["kda_num_heads"], m["kda_head_dim"], chunk
    chunks = rows * -(-seq // C)
    pairs = 2.0 * d * C * (C + 1)                 # A and P, 2 FLOPs each
    solve = 2.0 * C * (C - 1) * d                 # (C^2 - C) / 2 x 2d x 2
    state = 3 * 2.0 * C * d * d                   # W h, (q exp G) h, Khat^T U
    out = 1.0 * C * (C + 1) * d                   # P U, lower triangle
    return chunks * H * (pairs + solve + state + out)


def kda_core_bytes(m: dict, rows: int, seq: int) -> float:
    """The core's bytes, forward and backward, each tensor read or written
    once: q, k, v (bf16), g (f32, a channel), beta (f32, a head) read and
    o (f32) written; the backward reads them and do (f32) and writes dq,
    dk, dv (bf16), dg and dbeta (f32)."""
    T, H, d = rows * seq, m["kda_num_heads"], m["kda_head_dim"]
    inputs = 3 * 2 * d + 4 * d + 4
    fwd = inputs + 4 * d
    bwd = inputs + 4 * d + inputs
    return float(T * H * (fwd + bwd))


def kda_proj_flops(m: dict) -> float:
    """One token's KDA projections (one layer)."""
    D, H, d = m["embedding_dim"], m["kda_num_heads"], m["kda_head_dim"]
    n = H * d
    return 2.0 * (3 * D * n + 2 * (D * d + d * n) + D * H + n * D)


def forward_flops(m: dict, rows: int, seq: int, assignments: float
                  ) -> float:
    """One forward over `rows` sequences of `seq` tokens whose routing
    gave the held experts `assignments` pairs in all."""
    T = rows * seq
    n_kda = len(m["kda_layers"])
    n_mla = m["num_layers"] - n_kda
    D, H = m["embedding_dim"], m["num_heads"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    r = m["kv_lora_rank"]
    mla_proj = D * H * (nope + rope) + D * (r + rope) \
        + r * H * (nope + vd) + H * vd * D
    # Moonlight's count with every layer's mixer taken out, then each
    # layer's own mixer put in
    no_mixer = moonlight.forward_flops(
        dict(m, num_heads=0, qk_nope_head_dim=0, qk_rope_head_dim=0,
             v_head_dim=0, kv_lora_rank=0), rows, seq, assignments)
    return (no_mixer
            + n_mla * (2.0 * T * mla_proj
                       + moonlight.attention_core_flops(m, rows, seq))
            + n_kda * (T * kda_proj_flops(m) + kda_core_flops(m, rows, seq)))


def train_flops(m: dict, rows: int, seq: int, assignments: float) -> float:
    """A training step: forward and backward (twice the forward)."""
    return 3.0 * forward_flops(m, rows, seq, assignments)
