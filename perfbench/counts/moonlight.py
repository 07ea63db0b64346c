"""The Moonlight (DeepSeek-V3 block) LM's FLOPs, counted from the
configuration's shapes and the routed experts' tallied assignments.

`m` holds the port's `DeepSeekV3Config` fields. Every product of the
forward counts 2 FLOPs a multiply-add: the latent attention's
projections (q, kv_a, kv_b, o), its causal core (scores over nope + rope
dims and the context over the value dims, each position attending to
itself and those before it), the memory layer's projections (the query
and the memory context once a sequence, the gate at every position),
the dense SwiGLU, the router, the shared experts, the held experts'
SwiGLU once per assignment a held expert takes, and the head. Embedding
lookups, norms, RoPE, the elementwise activations, the episodic
retrieval and the recomputed products of a backward are not counted. A
training step is three forwards (the backward counts twice).
"""

from __future__ import annotations


def expert_flops(m: dict, assignments: float) -> float:
    """One forward of the held experts over `assignments` (token, expert)
    pairs: gate and up (D -> 2I), down (I -> D)."""
    D, I = m["embedding_dim"], m["moe_intermediate_size"]
    return 2.0 * 3 * D * I * assignments


def attention_core_flops(m: dict, rows: int, seq: int) -> float:
    """One forward of the causal core over `rows` sequences of `seq`."""
    H = m["num_heads"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    attended = seq * (seq + 1) / 2
    return float(rows * H * 2 * (qk + m["v_head_dim"]) * attended)


def forward_flops(m: dict, rows: int, seq: int, assignments: float
                  ) -> float:
    """One forward over `rows` sequences of `seq` tokens whose routing
    gave the held experts `assignments` pairs in all."""
    D, H, V = m["embedding_dim"], m["num_heads"], m["vocab_size"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    r = m["kv_lora_rank"]
    T = rows * seq
    n_dense = m["first_k_dense_replace"]
    n_moe = m["num_layers"] - n_dense
    proj = D * H * (nope + rope) + D * (r + rope) + r * H * (nope + vd) \
        + H * vd * D
    per_layer = (2.0 * T * proj
                 + 2.0 * rows * 2 * D * D          # query_proj, memory_proj
                 + 2.0 * T * 2 * D * D)            # memory_gate_proj
    dense_ffn = 2.0 * T * 3 * D * m["intermediate_size"]
    shared = 2.0 * T * 3 * D * m["n_shared_experts"] \
        * m["moe_intermediate_size"]
    router = 2.0 * T * D * m["n_routed_experts"]
    return (m["num_layers"] * per_layer
            + attention_core_flops(m, rows, seq) * m["num_layers"]
            + n_dense * dense_ffn + n_moe * (shared + router)
            + expert_flops(m, assignments) + 2.0 * T * D * V)


def train_flops(m: dict, rows: int, seq: int, assignments: float) -> float:
    """A training step: forward and backward (twice the forward)."""
    return 3.0 * forward_flops(m, rows, seq, assignments)
