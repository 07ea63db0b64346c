"""The LM's model FLOPs, counted from the configuration's shapes.

Every product of the forward counts 2 FLOPs a multiply-add: the
attention, memory and FFN projections, the spiking FFN's synapses (the
second stage once per time step), the place-cell projections, the
attention scores and context (causal: each position attends to itself
and the positions before it), and the tied head. Embedding lookups,
norms, the spiking dynamics and the episodic retrieval are not counted.
"""

from __future__ import annotations


def forward_flops(m: dict, rows: int, new: int) -> float:
    """FLOPs of one forward over `new` positions per row, for `rows`
    rows."""
    D, I, V = m["embedding_dim"], m["intermediate_size"], m["vocab_size"]
    N, T = m["n_place_cells"], m["snn_timesteps"]
    L = new
    attended = L * (L + 1) / 2                        # sum over positions
    per_layer = (4 * 2 * L * D * D                    # q, k, v, o
                 + 2 * L * D                          # the memory gate
                 + 2 * 2 * D * attended               # scores and context
                 + 2 * D * D                          # query_proj, once
                 + 2 * D * D                          # memory_proj, once
                 + 2 * L * 2 * D * D)                 # memory_gate_proj
    mlp = 2 * 2 * L * D * I
    snn = (2 * L * D * I + 2 * L * I * I              # syn1, gif1_in
           + 2 * L * T * I * D + 2 * L * T * D * D)   # syn2, gif2_in
    n_snn = len(m["snn_layers"])
    total = (m["num_layers"] * (per_layer + mlp) + n_snn * snn
             + 2 * 2 * L * D * N                      # place-cell projections
             + 2 * L * D * V)                         # tied head
    return float(rows * total)


def train_flops(m: dict, rows: int, seq: int) -> float:
    """A training step's FLOPs: forward and backward (twice the forward)
    over `rows` sequences of `seq` tokens."""
    return 3.0 * forward_flops(m, rows, seq)
