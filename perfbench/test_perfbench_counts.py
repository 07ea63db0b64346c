"""`counts/` against bytes, operations and FLOPs worked out by hand at
small shapes."""

import pytest
import torch

from perfbench.counts import ivf, lm, peaks


def test_bound_takes_the_larger_side():
    t, side = peaks.bound_s(3.35e12, {"bf16": 989e12 / 2})
    assert t == pytest.approx(1.0) and side == "bytes"
    t, side = peaks.bound_s(0.0, {"bf16": 989e12, "f32": 67e12})
    assert t == pytest.approx(2.0) and side == "operations"


def test_kernel_b_counts_filled_rows_of_each_probed_cluster_once():
    fills = torch.tensor([3, 0, 5, 2])
    top_c = torch.tensor([[0, 2], [2, 3]])            # B = 2, P = 2
    D, kk = 4, 4
    nbytes, ops = ivf.kernel_b(fills, top_c, D, kk)
    rows = 3 + 5 + 2                                  # clusters 0, 2, 3
    per_query = [3 + 5, 5 + 2]                        # 8 and 7 probed rows
    rerank = min(8, kk) + min(7, kk)                  # 4 + 4
    want = (rows * (D * 2 + 12) + 2 * (D * 4 + 2 * 4)
            + rerank * (D * 4 + 4) + 2 * kk * 8)
    assert nbytes == want
    assert ops == {"bf16": 2.0 * 15 * D, "f32": 2.0 * rerank * D}


def test_retrieve_call_adds_probe_annex_and_result():
    fills = torch.tensor([3, 0, 5, 2])
    top_c = torch.tensor([[0, 2], [2, 3]])
    K, D, k, annex, kk = 4, 4, 2, 3, 4
    nb_b, ops_b = ivf.kernel_b(fills, top_c, D, kk)
    nbytes, ops = ivf.retrieve_call(fills, top_c, K, D, k, annex, kk)
    want = (nb_b + K * D * 4 + annex * (D * 2 + 16)
            + 2 * min(kk, annex) * (D * 4 + 4) + 2 * k * (12 + 2 * D * 4))
    assert nbytes == want
    assert ops["bf16"] == ops_b["bf16"] + 2.0 * 2 * annex * D
    assert ops["f32"] == (ops_b["f32"] + 2.0 * 2 * K * D
                          + 2.0 * 2 * min(kk, annex) * D)


def test_probes_are_nearest_by_l2():
    cents = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 3.0]])
    q = torch.tensor([[9.0, 1.0], [0.0, 2.0]])
    assert ivf.probes(q, cents, 1).tolist() == [[1], [2]]


M = dict(embedding_dim=4, intermediate_size=8, vocab_size=10,
         n_place_cells=6, snn_timesteps=2, num_layers=2, snn_layers=[0])


def test_forward_flops_by_hand():
    D, I, V, N, T = 4, 8, 10, 6, 2
    L = 3
    attended = 6                               # 1, 2, 3 keys: 6
    layer = (8 * L * D * D + 2 * L * D + 4 * D * attended + 4 * D * D
             + 4 * L * D * D) + 4 * L * D * I
    snn = 2 * L * D * I + 2 * L * I * I + 2 * L * T * I * D \
        + 2 * L * T * D * D
    want = 2 * layer + snn + 4 * L * D * N + 2 * L * D * V
    assert lm.forward_flops(M, 1, L) == pytest.approx(want)
    assert lm.forward_flops(M, 3, L) == pytest.approx(3 * want)
    assert lm.train_flops(M, 2, L) == pytest.approx(
        3 * lm.forward_flops(M, 2, L))
