"""Kernels A, B, C, D and E against their plain PyTorch versions on the
card, the neuromorphic brain system and the NaturalBrain path
(NaturalBrain, the MoE language zone's forward and gradients, the
prosody gains, the SRFFN; no kernel) on the card against the same port
objects on the CPU, the sharded bank and the data-parallel trainer on a
one-rank NCCL group against the unsharded paths, and on the same group
ring attention against SDPA and the pipelined RAG stack (one stage)
against the model's forward, with kernel B's launches counted.

Marked `cuda`: they skip without a card (decided in a fixture, so every
xdist worker collects the same tests). On a machine with an H100:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Inputs are made with numpy from a seed and copied to the card.
"""

import os

import numpy as np
import pytest
import torch

from aura_snn_rag_tpu_torch.ops.cuda import launch_counts

# the cuBLAS workspace that deterministic algorithms need; read when the
# first cuBLAS handle is made, so set before any test runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
from aura_snn_rag_tpu_torch.ops.cuda.flat_scan import (
    flat_blockmax, flat_blockmax_plain, pack_row_terms)
from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import (
    ivf_candidates, ivf_candidates_plain, ivf_retrieve_fused,
    ivf_retrieve_fused_plain, ivf_scan_scores, ivf_scan_scores_plain,
    ivf_topk_scores, ivf_topk_scores_plain)
from tests.test_torch_probes import crowded_probes

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flat_inputs(rng, M, D, B, int8):
    x = rng.randn(M, D).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(B, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mul = (rng.rand(M) * 0.5 + 0.25).astype(np.float32)
    add = (rng.rand(M) * 0.2).astype(np.float32)
    add[rng.rand(M) < 0.05] = -1e30                      # dead rows
    if int8:
        xs = np.abs(x).max(1, keepdims=True)
        qs = np.abs(q).max(1, keepdims=True)
        bank = torch.from_numpy(np.round(x * 127 / xs).astype(np.int8))
        qq = torch.from_numpy(np.round(q * 127 / qs).astype(np.int8))
        return bank, qq, mul * xs[:, 0], add, torch.from_numpy(qs[:, 0])
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(q).to(torch.bfloat16), mul, add, None)


# The kernel's tiles are 128 queries x 256 bank rows x 128 bytes of depth.
# B = 300 crosses query tiles and ends ragged, B = 1 and 8 leave a consumer
# warpgroup idle; M = 4104 and 769 end one row group into a bank tile, with
# an output row length nb that is not a multiple of 4 (scalar stores);
# 4128 ends ragged with 16-byte stores; D = 192 leaves a partial
# 128-byte box in depth at int8, and D = 64 at int8 a box wider than the
# rows.
@pytest.mark.parametrize("int8,M,D,B,variant", [
    (int8, M, D, B, "") for int8 in (True, False)
    for M, D, B in [(4096, 128, 70), (1029, 768, 5), (4104, 192, 1),
                    (769, 768, 8), (4128, 768, 300), (769, 192, 300),
                    (1029, 64, 70)]] + [
    (True, 4096, 128, 8, "no_q_scale"),
    (True, 2048, 768, 70, "dead_first_tile"),
    (False, 2048, 768, 70, "dead_first_tile")])
def test_flat_blockmax_kernel_matches_plain(dev, int8, M, D, B, variant):
    bank, q, mul, add, qs = _flat_inputs(np.random.RandomState(M + B),
                                         M, D, B, int8)
    if variant == "no_q_scale":
        qs = None
    if variant == "dead_first_tile":
        add[:256] = -1e30
    mul_p, add_p = pack_row_terms(torch.from_numpy(mul),
                                  torch.from_numpy(add), M)
    args = [t.to(dev) if t is not None else None
            for t in (bank, q, mul_p, add_p, qs)]
    n0 = launch_counts["flat_blockmax"]
    got = flat_blockmax(*args)
    torch.cuda.synchronize()
    assert launch_counts["flat_blockmax"] == n0 + 1
    want = flat_blockmax_plain(*args)
    assert got.shape == want.shape == (B, -(-M // 8))
    # int8: exact integer accumulation, identical f32 epilogue -> 0 error;
    # bf16: f32 sums in another order -> a few ulp of |cos| <= 1
    tol = 0.0 if int8 else 2e-5
    assert (got - want).abs().max().item() <= tol


def _ivf_inputs(rng, K, C, D, B, P, M):
    cl = rng.randn(K, C, D).astype(np.float32)
    cl /= np.linalg.norm(cl, axis=-1, keepdims=True)
    aux = np.zeros((K, 8, C), np.float32)
    aux[:, 0] = rng.rand(K, C) * 0.5 + 0.25
    aux[:, 1] = rng.rand(K, C) * 0.2
    aux[:, 1][rng.rand(K, C) < 0.3] = -1e30              # dead entries
    aux[:, 2] = rng.randint(0, M, (K, C))
    feats = rng.randn(M, D).astype(np.float32)
    q = rng.randn(B, D).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    top_c = np.stack([rng.choice(K, P, replace=False) for _ in range(B)])
    return (torch.from_numpy(cl).to(torch.bfloat16), torch.from_numpy(aux),
            torch.from_numpy(feats), torch.from_numpy(qn),
            torch.from_numpy(top_c.astype(np.int32)))


@pytest.mark.parametrize("D", [128, 72])
def test_ivf_scan_scores_kernel_matches_plain(dev, D):
    cl, _, _, qn, top_c = _ivf_inputs(np.random.RandomState(D),
                                      32, 256, D, 5, 4, 4096)
    cl, qn, top_c = cl.to(dev), qn.to(dev), top_c.to(dev)
    got = ivf_scan_scores(cl, qn, top_c)
    want = ivf_scan_scores_plain(cl, qn, top_c)
    torch.cuda.synchronize()
    # f32 sums of bf16 products in another order
    assert (got - want).abs().max().item() <= 2e-5


def _assert_select_matches(s, sl, ps, psl, rows):
    """Scores within 1e-5 on live lanes, the same lanes live, slots equal
    wherever the score is more than 1e-4 from its neighbours."""
    s, sl, ps, psl = (t.cpu().numpy().reshape(rows, -1)
                      for t in (s, sl, ps, psl))
    live = ps > -5e29
    assert (live == (s > -5e29)).all()
    # f32 sums of bf16 products in another order, times aux0 <= 1
    assert np.abs(np.where(live, s - ps, 0)).max() <= 1e-5
    for r in range(rows):
        for j in np.nonzero(live[r])[0]:
            others = np.delete(ps[r], j)
            if others.size == 0 or np.min(np.abs(others - ps[r, j])) > 1e-4:
                assert sl[r, j] == psl[r, j], (r, j)
    return s, sl, psl


def _tied_inputs(seed, C, B, P, K=40, D=128, M=4096, at=None):
    """_ivf_inputs with exact ties planted at the top of every query's
    ranking: its own direction stored three times (probe 0 at c = at(b)
    and at(b) + 1, at(b) = 2b unless given; probe 1 at c = 2b), each with
    aux0 = 1, aux1 = 0.5 and its own slot, so the three coarse scores are
    equal and far above the random entries (|score| < 0.96)."""
    cl, aux, feats, qn, top_c = _ivf_inputs(np.random.RandomState(seed), K,
                                            C, D, B, P, M)
    at = at or (lambda b: 2 * b)
    for b in range(B):
        for n, (p, c) in enumerate(((0, at(b)), (0, at(b) + 1),
                                    (1, 2 * b))):
            cid = int(top_c[b, p])
            cl[cid, c] = qn[b].to(torch.bfloat16)
            aux[cid, 0, c], aux[cid, 1, c] = 1.0, 0.5
            aux[cid, 2, c] = M + 3 * b + n
    return cl, aux, qn, top_c


def _tied_fused_inputs(seed, C, B, P, D):
    """_tied_inputs plus a feature bank whose planted slots M + 3b + n
    hold query b's own direction, so the three tied candidates also tie
    on their exact scores (1.0 * 1 + 0.5) and the final top-k orders them
    by funnel lane, which is the flat-index order p*C + c."""
    M = 4096
    cl, aux, qn, top_c = _tied_inputs(seed, C, B, P, D=D, M=M)
    rng = np.random.RandomState(seed + 1)
    feats = rng.randn(M + 3 * B, D).astype(np.float32)
    feats[M:] = np.repeat(qn.numpy(), 3, axis=0)
    return cl, aux, torch.from_numpy(feats), qn, top_c


# The select pass runs on a cluster of G CTAs per query, each over a
# contiguous share of the P*C scores. (2, 2048, 10, 8, 256, 128): kk =
# 2048 needs > 48 KB of dynamic shared memory (the opt-in path); D = 72
# leaves lanes idle in the row loops; P*C = 3 * 385 is not a multiple of
# G times a share; kk = P*C = 1024 with 30% dead entries puts dead lanes
# into the top-kk; kk = 4096 is the largest kernel B takes; B = 17 needs
# more clusters than fit on the card at once; `tied` plants exact ties
# on the coarse and the exact score. kk <= 512 orders the candidates by
# counting, larger kk by bitonic sorts.
@pytest.mark.parametrize("B,kk,k,P,C,D,tied", [
    (1, 128, 10, 4, 256, 128, False), (6, 256, 5, 4, 256, 128, False),
    (2, 2048, 10, 8, 256, 128, False), (3, 128, 10, 4, 256, 72, False),
    (1, 128, 10, 3, 385, 128, False), (5, 1024, 128, 4, 256, 128, False),
    (2, 4096, 10, 32, 256, 128, False), (17, 128, 10, 4, 256, 128, False),
    (1, 128, 10, 4, 256, 128, True), (5, 256, 10, 3, 385, 128, True),
    (17, 128, 3, 4, 256, 128, True), (2, 1024, 10, 4, 256, 128, True)])
def test_ivf_retrieve_fused_kernel_matches_plain(dev, B, kk, k, P, C, D,
                                                 tied):
    if tied:
        inputs = _tied_fused_inputs(B + C, C, B, P, D)
    else:
        inputs = _ivf_inputs(np.random.RandomState(B), 32, C, D, B, P, 4096)
    cl, aux, feats, qn, top_c = (t.to(dev) for t in inputs)
    n0 = launch_counts["ivf_retrieve_fused"]
    s, sl = ivf_retrieve_fused(cl, aux, feats, qn, top_c, kk, k)
    ps, psl = ivf_retrieve_fused_plain(cl, aux, feats, qn, top_c, kk, k)
    torch.cuda.synchronize()
    assert launch_counts["ivf_retrieve_fused"] == n0 + 1
    assert s.shape == ps.shape == (B, 128)
    assert (sl[:, k:] == -1).all() and (s[:, k:] == -1e30).all()
    # exact scores (f32 dot products summed in another order), well inside
    # the select's 1e-5
    s, sl, psl = _assert_select_matches(s[:, :k], sl[:, :k], ps[:, :k],
                                        psl[:, :k], B)
    if tied:
        # equal exact scores go to the lower funnel lane, and equal coarse
        # scores to the lower flat index, as in the TPU kernel
        lead = min(k, 3)
        for b in range(B):
            np.testing.assert_array_equal(sl[b, :lead], psl[b, :lead])
            np.testing.assert_array_equal(
                sl[b, :lead], 4096 + 3 * b + np.arange(lead))


# Kernel E runs a cluster of G = 8 CTAs per (probe, query), each over a
# contiguous share of ceil(C/8) rows, which it scores 128 rows at a time.
# C = 385 ends in a ragged share; C = 8 gives shares of one row; C = 128
# with k = 128 shares of 16 rows, fewer than k; B = 17 with P = 64 needs
# more clusters than fit on the card at once; C = 600,000 gives shares of
# 75,000 rows, far beyond shared memory, kept as a running top-k over
# pieces. `boundary` plants query b's tie in probe 0 on either side of a
# share boundary, at c = ceil(C/8) * (b + 1) - 1 and c + 1.
@pytest.mark.parametrize("B,C,k,P,K,D,boundary", [
    (B, C, k, 4, 40, 128, False) for B in (1, 5) for C in (128, 384, 896)
    for k in (1, 10, 128)] + [
    (1, 385, 10, 4, 40, 128, False), (3, 385, 128, 4, 40, 128, False),
    (1, 8, 8, 4, 40, 128, False), (2, 128, 128, 4, 40, 128, False),
    (17, 512, 10, 64, 80, 128, False), (1, 600_000, 128, 2, 4, 8, False),
    (1, 385, 10, 4, 40, 128, True), (3, 512, 2, 4, 40, 128, True),
    (2, 600_000, 10, 2, 4, 8, True)])
def test_ivf_topk_scores_kernel_matches_plain(dev, B, C, k, P, K, D,
                                              boundary):
    chunk = -(-C // 8)
    at = (lambda b: chunk * (b + 1) - 1) if boundary else None
    cl, aux, qn, top_c = (t.to(dev) for t in _tied_inputs(
        C + k, C, B, P, K=K, D=D, at=at))
    n0 = launch_counts["ivf_topk_scores"]
    s, sl = ivf_topk_scores(cl, aux, qn, top_c, k)
    ps, psl = ivf_topk_scores_plain(cl, aux, qn, top_c, k)
    torch.cuda.synchronize()
    assert launch_counts["ivf_topk_scores"] == n0 + 1
    assert s.shape == sl.shape == (B, P, 128) and sl.dtype == torch.int32
    assert (s[..., k:] == -1e30).all() and (sl[..., k:] == 0).all()
    s, sl, psl = _assert_select_matches(s[..., :k], sl[..., :k], ps[..., :k],
                                        psl[..., :k], B * P)
    assert (np.diff(s, axis=1) <= 0).all()
    # the tie in probe 0 goes to the lower c, as in the TPU kernel
    lead = min(k, 2)
    for b in range(B):
        np.testing.assert_array_equal(sl[b * P, :lead], psl[b * P, :lead])
        np.testing.assert_array_equal(sl[b * P, :lead],
                                      [4096 + 3 * b, 4096 + 3 * b + 1][:lead])


def test_ivf_topk_scores_kernel_is_kernel_c_bit_for_bit(dev):
    """E scores an entry as the coarse pass of kernel C does (`row_dot`),
    so its lanes are exactly the per-probe top-k of aux0 * cos + aux1
    computed from C's cosines, one rounding per operation as in E."""
    B, C, P, k = 3, 385, 4, 10
    cl, aux, qn, top_c = (t.to(dev) for t in _tied_inputs(7, C, B, P))
    s, sl = ivf_topk_scores(cl, aux, qn, top_c, k)
    cos = ivf_scan_scores(cl, qn, top_c)
    a = aux[top_c.long()]                                    # [B, P, 8, C]
    coarse = a[:, :, 0] * cos + a[:, :, 1]
    order = torch.argsort(coarse, dim=2, descending=True, stable=True)[..., :k]
    assert (s[..., :k] - coarse.gather(2, order)).abs().max().item() == 0.0
    assert torch.equal(sl[..., :k], a[:, :, 2].gather(2, order).int())


# (2, 512, 32, 16384): the largest kk kernel D takes, 128 KB of keys in
# opt-in shared memory; kk = 4 * C = P*C puts dead lanes into the top-kk;
# P*C = 3 * 385 is not a multiple of G times a share; B = 17 needs more
# clusters than fit on the card at once; P*C = 2 * 170000 at kk = 16384
# leaves no room in shared memory for a CTA's share, so the select reads
# its scores from the scratch on every pass; P = 1100 probes are more
# than the select keeps in shared memory, so it reads their cluster ids
# from device memory.
@pytest.mark.parametrize("B,C,P,kk,K,D", [
    (B, C, 4, kk, 40, 128) for B in (1, 5) for C in (128, 384, 896)
    for kk in (128, 4 * C)] + [
    (2, 512, 32, 16384, 40, 128), (1, 385, 3, 128, 40, 128),
    (3, 385, 3, 1152, 40, 128), (17, 256, 4, 256, 40, 128),
    (2, 170000, 2, 16384, 4, 8), (1, 8, 1100, 256, 1200, 8)])
def test_ivf_candidates_kernel_matches_plain(dev, B, C, P, kk, K, D):
    cl, aux, qn, top_c = (t.to(dev) for t in _tied_inputs(C + kk, C, B, P,
                                                          K=K, D=D))
    n0 = launch_counts["ivf_candidates"]
    s, sl = ivf_candidates(cl, aux, qn, top_c, kk)
    ps, psl = ivf_candidates_plain(cl, aux, qn, top_c, kk)
    torch.cuda.synchronize()
    assert launch_counts["ivf_candidates"] == n0 + 1
    assert s.shape == sl.shape == (B, kk) and sl.dtype == torch.int32
    s, sl, psl = _assert_select_matches(s, sl, ps, psl, B)
    assert (np.diff(s, axis=1) <= 0).all()
    # the three-way tie across probes 0 and 1 goes to the lowest p*C + c
    for b in range(B):
        np.testing.assert_array_equal(sl[b, :3], psl[b, :3])
        np.testing.assert_array_equal(sl[b, :3], 4096 + 3 * b + np.arange(3))



# Kernel B as the LM's RAG layers call it at get_full_config(): K = 256
# clusters of C = 896 slots (not a multiple of 512), probe 8, so the
# select's 8 CTAs split P*C = 7168 keys; a 100,000-row bank, kk = 128,
# k = 5 (num_retrieved), at the server's B = 8 and at B = 1.
@pytest.mark.parametrize("B", [1, 8])
def test_ivf_retrieve_fused_kernel_at_the_lm_shape(dev, B):
    cl, aux, feats, qn, top_c = (t.to(dev) for t in _ivf_inputs(
        np.random.RandomState(60 + B), 256, 896, 768, B, 8, 100_000))
    s, sl = ivf_retrieve_fused(cl, aux, feats, qn, top_c, 128, 5)
    ps, psl = ivf_retrieve_fused_plain(cl, aux, feats, qn, top_c, 128, 5)
    torch.cuda.synchronize()
    assert (sl[:, 5:] == -1).all() and (s[:, 5:] == -1e30).all()
    _assert_select_matches(s[:, :5], sl[:, :5], ps[:, :5], psl[:, :5], B)


# Kernel B at bench.py's batch of 1024 queries: a [1024, P*C] scratch and
# a coarse grid 1024 deep, at the engine's P = 64 and kk = 128 over 512
# clusters of 128; the plain version runs 64 queries at a time.
def test_ivf_retrieve_fused_kernel_at_the_bench_batch(dev):
    B = 1024
    cl, aux, feats, qn, top_c = (t.to(dev) for t in _ivf_inputs(
        np.random.RandomState(80), 512, 128, 768, B, 64, 100_000))
    s, sl = ivf_retrieve_fused(cl, aux, feats, qn, top_c, 128, 10)
    parts = [ivf_retrieve_fused_plain(cl, aux, feats, qn[i:i + 64],
                                      top_c[i:i + 64], 128, 10)
             for i in range(0, B, 64)]
    ps, psl = (torch.cat(p) for p in zip(*parts))
    torch.cuda.synchronize()
    assert (sl[:, 10:] == -1).all() and (s[:, 10:] == -1e30).all()
    _assert_select_matches(s[:, :10], sl[:, :10], ps[:, :10], psl[:, :10],
                           B)


def _crowded_inputs(seed, K, C, D, B, P, hot=0, span=None, M=4096):
    """_ivf_inputs with the probes of `crowded_probes`."""
    rng = np.random.RandomState(seed)
    cl, aux, feats, qn, _ = _ivf_inputs(rng, K, C, D, B, P, M)
    top_c = crowded_probes(rng, K, B, P, hot, span)
    return cl, aux, feats, qn, torch.from_numpy(top_c)


def _kernel_names(fn):
    """The CUDA kernels `fn()` launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages())


# Kernels B and D on their cluster-major coarse pass: every shape is at
# least 8 pairs per cluster (B*P/K), above the library's crossover, which
# each case asserts. "bench": 16 pairs per cluster as at bench.py's batch
# of 1024, at K = 256; "hot": cluster 0 in all 150 queries' probes, three
# tiles of 64 pairs; "unprobed": 64 queries over clusters 0-15 of 64;
# "c385": a ragged last row tile; "d72": a depth that is a multiple of 8
# but not of 16 (zero-filled in both operands); "tied": exact ties
# planted on the coarse and the exact score (`_tied_fused_inputs`, 9.6
# pairs per cluster); "kk4096": the widest funnel kernel B takes.
CM_CASES = {
    # K, C, D, B, P, hot, span, kk (B), kk (D)
    "bench": (256, 128, 128, 64, 64, 0, None, 128, 128),
    "hot": (32, 256, 128, 150, 4, 1, None, 128, 256),
    "unprobed": (64, 256, 128, 64, 8, 0, 16, 256, 512),
    "c385": (16, 385, 128, 40, 4, 0, None, 128, 384),
    "d72": (16, 256, 72, 40, 4, 0, None, 128, 256),
    "tied": (40, 256, 128, 96, 4, 0, None, 256, 256),
    "kk4096": (40, 128, 128, 16, 32, 0, None, 4096, 4096),
}


@pytest.mark.parametrize("case", list(CM_CASES))
def test_ivf_kernels_b_and_d_on_the_cluster_major_pass_match_plain(dev,
                                                                   case):
    from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import cluster_major
    K, C, D, B, P, hot, span, kk_b, kk_d = CM_CASES[case]
    if case == "tied":
        inputs = _tied_fused_inputs(11, C, B, P, D)
    else:
        inputs = _crowded_inputs(len(case), K, C, D, B, P, hot, span)
    cl, aux, feats, qn, top_c = (t.to(dev) for t in inputs)
    assert cl.shape[0] == K and B * P >= 8 * K and cluster_major(B, P, K)
    k = 10
    n0 = dict(launch_counts)
    s, sl = ivf_retrieve_fused(cl, aux, feats, qn, top_c, kk_b, k)
    ds, dsl = ivf_candidates(cl, aux, qn, top_c, kk_d)
    torch.cuda.synchronize()
    assert launch_counts["ivf_retrieve_fused"] == n0["ivf_retrieve_fused"] + 1
    assert launch_counts["ivf_candidates"] == n0["ivf_candidates"] + 1
    ps, psl = ivf_retrieve_fused_plain(cl, aux, feats, qn, top_c, kk_b, k)
    pds, pdsl = ivf_candidates_plain(cl, aux, qn, top_c, kk_d)
    assert (sl[:, k:] == -1).all() and (s[:, k:] == -1e30).all()
    s, sl, psl = _assert_select_matches(s[:, :k], sl[:, :k], ps[:, :k],
                                        psl[:, :k], B)
    ds, dsl, pdsl = _assert_select_matches(ds, dsl, pds, pdsl, B)
    assert (np.diff(ds, axis=1) <= 0).all()
    if case == "tied":
        # equal exact scores to the lower funnel lane, equal coarse scores
        # to the lower flat index p*C + c, as in the TPU kernel
        for b in range(B):
            np.testing.assert_array_equal(sl[b, :3], 4096 + 3 * b
                                          + np.arange(3))
            np.testing.assert_array_equal(dsl[b, :3], 4096 + 3 * b
                                          + np.arange(3))


def _replayed(fn):
    """fn()'s outputs from a CUDA graph that captured it, replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


# The cluster-major pass at the "hot" case: the bucketing's atomics order
# each cluster's pairs anew on every call, and a pair's scores must not
# depend on it; the bucketing allocates nothing and reads nothing back, so
# a CUDA graph captures the whole call.
def test_cluster_major_pass_is_bit_stable_and_graph_capturable(dev):
    K, C, D, B, P, hot, span, kk_b, kk_d = CM_CASES["hot"]
    cl, aux, feats, qn, top_c = (t.to(dev) for t in _crowded_inputs(
        3, K, C, D, B, P, hot, span))
    calls = (lambda: ivf_retrieve_fused(cl, aux, feats, qn, top_c, kk_b, 10),
             lambda: ivf_candidates(cl, aux, qn, top_c, kk_d))
    for fn in calls:
        first, second = fn(), fn()
        replay = _replayed(fn)
        for a, b, c in zip(first, second, replay):
            assert torch.equal(a, b) and torch.equal(a, c)


# Which coarse pass runs, read from the kernels a call launches: the
# engine's B = 1 and 8 (K = 4096, P = 64: 1/64 and 1/8 pair per cluster)
# and the LM's B = 8 (K = 256, P = 8: 1/4) stay per pair; the smallest
# batch on the cluster-major pass at the engine's K and P takes it, one
# query fewer does not. C and D are cut (the choice reads B, P and K
# only); both passes still match the plain versions.
@pytest.mark.parametrize("case", ["engine_b1", "engine_b8", "lm_b8",
                                  "below_crossover", "at_crossover"])
def test_coarse_pass_by_batch(dev, case):
    from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import cluster_major
    K, P = (256, 8) if case == "lm_b8" else (4096, 64)
    crossover = next(b for b in range(1, 4097) if cluster_major(b, P, K))
    B = {"engine_b1": 1, "engine_b8": 8, "lm_b8": 8,
         "below_crossover": crossover - 1,
         "at_crossover": crossover}[case]
    cl, aux, feats, qn, top_c = (t.to(dev) for t in _ivf_inputs(
        np.random.RandomState(B), K, 16, 64, B, P, 4096))
    out = {}
    names = _kernel_names(lambda: out.update(
        b=ivf_retrieve_fused(cl, aux, feats, qn, top_c, 128, 10),
        d=ivf_candidates(cl, aux, qn, top_c, 128)))
    want = "ivf_coarse_cm_kernel" if case == "at_crossover" \
        else "ivf_coarse_kernel"
    other = ({"ivf_coarse_cm_kernel", "ivf_coarse_kernel"} - {want}).pop()
    assert want in names and other not in names, names
    ps, psl = ivf_retrieve_fused_plain(cl, aux, feats, qn, top_c, 128, 10)
    pds, pdsl = ivf_candidates_plain(cl, aux, qn, top_c, 128)
    s, sl = out["b"]
    _assert_select_matches(s[:, :10], sl[:, :10], ps[:, :10], psl[:, :10],
                           B)
    _assert_select_matches(*out["d"], pds, pdsl, B)


def test_port_bench_runs_kernel_b_on_the_card(dev, capsys):
    """The port's bench at `--small` over 20,000 rows: one JSON line with
    bench.py's keys, exact recall, kernel B once per IVF batch (1 + 8)
    and no other kernel; with `--flat-strategy=blockmax` kernel A too."""
    import json
    from aura_snn_rag_tpu_torch import bench
    for argv, want in (([], {"ivf_retrieve_fused": 9}),
                       (["--flat-strategy=blockmax"],
                        {"ivf_retrieve_fused": 9, "flat_blockmax": 9})):
        n0 = dict(launch_counts)
        line = bench.main(["--small", "--n=20000"] + argv)
        got = {k: v - n0.get(k, 0) for k, v in launch_counts.items()
               if v - n0.get(k, 0)}
        assert got == want
        out = capsys.readouterr().out.strip().splitlines()
        assert json.loads(out[-1]) == line and len(line) == 16
        assert line["recall_at_10"] >= 0.99
        assert line["n_vectors"] == 20000


def test_lm_prefill_through_kernel_b_matches_its_plain_version(dev):
    """A small LM (f32 compute) over a bank whose batches of 2 take IVF
    v3r: the prefill's logits through kernel B equal, within 1e-4, those
    of a retrieve_fn that runs the same retrieval with kernel B's plain
    version, and every RAG layer launched kernel B once."""
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.memory import engine

    mcfg = port.MemoryConfig(max_memories=16384, feature_dim=128,
                             k_centroids=128, probe_centroids=4)
    cfg = port.ModelConfig(vocab_size=512, embedding_dim=128, num_layers=3,
                           num_heads=4, intermediate_size=256,
                           n_place_cells=128, use_rag=True,
                           snn_layers=(0, 2), dtype="float32")
    rng = np.random.RandomState(70)
    centres = rng.randn(64, 128).astype(np.float32) * 2
    feats = centres[rng.randint(0, 64, 16384)] + rng.randn(
        16384, 128).astype(np.float32)
    state = port.bulk_load(mcfg, port.init_memory_state(mcfg, dev),
                           torch.from_numpy(feats).to(dev),
                           torch.zeros(16384, 2, device=dev))
    state = port.rebuild_centroids(mcfg, state,
                                   torch.Generator().manual_seed(0))
    model = port.HippocampalTransformer(
        cfg, mcfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    ids = torch.from_numpy(rng.randint(0, 512, (2, 24))).to(dev)
    real = engine.ivf_retrieve_fused

    def plain(c, s, q, k):
        engine.ivf_retrieve_fused = ivf_retrieve_fused_plain
        try:
            return engine.retrieve_auto(c, s, q, None, k)
        finally:
            engine.ivf_retrieve_fused = real

    with torch.no_grad():
        n0 = launch_counts["ivf_retrieve_fused"]
        a, _ = model(ids, memory_state=state)
        torch.cuda.synchronize()
        assert launch_counts["ivf_retrieve_fused"] == n0 + 3
        for layer in model.layers:
            layer.retrieve_fn = plain
        b, _ = model(ids, memory_state=state)
    assert launch_counts["ivf_retrieve_fused"] == n0 + 3
    assert (a.logits - b.logits).abs().max().item() <= 1e-4


# Kernel B's autograd Function (`ivf_retrieve_fused_grad`): the forward is
# the kernel, the backward plain PyTorch; held against autograd through
# the plain version on the card. aux row 0 is w_cos * strength[slot], so
# both backwards scale a hit lane's f_hat by the same number. Query 0's
# probes keep only `n_live` live entries: lanes n_live..k-1 miss (slot
# -1) and pass no gradient. The LM's shape (K = 256, C = 896, D = 768,
# P = 8, 100,000 rows, B = 8) and a small odd one (C = 385, D = 72,
# M = 3001, B = 3).
@pytest.mark.parametrize("K,C,D,B,P,M,k,n_live", [
    (256, 896, 768, 8, 8, 100_000, 5, 2),
    (40, 385, 72, 3, 3, 3001, 10, 0),
    (40, 385, 72, 3, 3, 3001, 5, 300)])
def test_ivf_retrieve_fused_grad_matches_plain_autograd(dev, K, C, D, B, P,
                                                         M, k, n_live):
    from aura_snn_rag_tpu_torch.ops.cuda.ivf_scan import (
        ivf_retrieve_fused_grad)
    rng = np.random.RandomState(K + C + k)
    cl, aux, feats, qn, top_c = _ivf_inputs(rng, K, C, D, B, P, M)
    strength = torch.from_numpy(rng.rand(M).astype(np.float32) + 0.5)
    w_cos = 0.5
    aux[:, 0] = w_cos * strength[aux[:, 2].long()]
    probes = top_c[0].long()
    add = aux[probes, 1]
    add[:] = -1e30
    add.view(-1)[:n_live] = 0.1
    aux[probes, 1] = add
    cl, aux, feats, qn, top_c, strength = (
        t.to(dev) for t in (cl, aux, feats, qn, top_c, strength))
    g = torch.from_numpy(rng.randn(B, k).astype(np.float32)).to(dev)

    def loss(s, sl):
        return (torch.where(sl[:, :k] >= 0, s[:, :k], 0.0) * g).sum()

    n0 = launch_counts["ivf_retrieve_fused"]
    q1 = qn.clone().requires_grad_(True)
    s1, sl1 = ivf_retrieve_fused_grad(cl, aux, feats, strength, w_cos, q1,
                                      top_c, 128, k)
    loss(s1, sl1).backward()
    q2 = qn.clone().requires_grad_(True)
    s2, sl2 = ivf_retrieve_fused_plain(cl, aux, feats, q2, top_c, 128, k)
    loss(s2, sl2).backward()
    torch.cuda.synchronize()
    assert launch_counts["ivf_retrieve_fused"] == n0 + 1   # backward: none
    _assert_select_matches(s1.detach()[:, :k], sl1[:, :k],
                           s2.detach()[:, :k], sl2[:, :k], B)
    assert int((sl1[0, :k] >= 0).sum()) == min(n_live, k)
    assert torch.equal(sl1, sl2)
    # f32 products and sums in another order
    assert (q1.grad - q2.grad).abs().max().item() <= 1e-5
    assert q1.grad.abs().sum().item() > 0
    if n_live == 0:
        assert not q1.grad[0].any()


def test_lm_gradient_through_kernel_b_matches_its_plain_version(dev):
    """A small LM (f32 compute, RAG in 3 layers, no SNN FFN: kernel B's
    scores differ from its plain version's by ~3e-8, which at f32 could
    flip a GIF spike level) over a bank whose batches of 2 take IVF v3r:
    the loss and gradients of one backward through kernel B (Function
    backward) equal, within 1e-5 of each tensor's largest entry (at least
    1e-3 of the model's largest), those through kernel B's plain version
    with autograd through its einsum, and every RAG layer's query_proj
    gets a nonzero gradient."""
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.memory import engine

    mcfg = port.MemoryConfig(max_memories=16384, feature_dim=128,
                             k_centroids=128, probe_centroids=4)
    cfg = port.ModelConfig(vocab_size=512, embedding_dim=128, num_layers=3,
                           num_heads=4, intermediate_size=256,
                           n_place_cells=128, use_rag=True, dtype="float32")
    rng = np.random.RandomState(71)
    centres = rng.randn(64, 128).astype(np.float32) * 2
    feats = centres[rng.randint(0, 64, 16384)] + rng.randn(
        16384, 128).astype(np.float32)
    state = port.bulk_load(mcfg, port.init_memory_state(mcfg, dev),
                           torch.from_numpy(feats).to(dev),
                           torch.zeros(16384, 2, device=dev))
    state = port.rebuild_centroids(mcfg, state,
                                   torch.Generator().manual_seed(0))
    model = port.HippocampalTransformer(
        cfg, mcfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2))
    ids = torch.from_numpy(rng.randint(0, 512, (2, 24))).to(dev)

    def grads():
        for p in model.parameters():
            p.grad = None
        out, _ = model(ids, memory_state=state)
        loss = out.logits.square().mean()
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    n0 = launch_counts["ivf_retrieve_fused"]
    la, ga = grads()
    assert launch_counts["ivf_retrieve_fused"] == n0 + 3
    real = engine.ivf_retrieve_fused_grad

    def plain_autograd(cl, aux, f, strength, w, qn, top_c, kk, k, fused):
        return ivf_retrieve_fused_plain(cl, aux, f, qn, top_c, kk, k)
    engine.ivf_retrieve_fused_grad = plain_autograd
    try:
        lb, gb = grads()
    finally:
        engine.ivf_retrieve_fused_grad = real
    assert launch_counts["ivf_retrieve_fused"] == n0 + 3
    assert abs(la - lb) <= 1e-6 * abs(lb)
    assert ga.keys() == gb.keys()
    for i in range(3):
        assert ga[f"layers.{i}.query_proj.weight"].abs().sum().item() > 0
    # a gradient that is zero in exact arithmetic (the key biases: softmax
    # ignores a shift of every key) is f32 cancellation noise, so each
    # tensor's scale is at least 1e-3 of the model's largest gradient
    floor = 1e-3 * max(g.abs().max().item() for g in gb.values())
    for name in ga:
        scale = max(gb[name].abs().max().item(), floor)
        assert (ga[name] - gb[name]).abs().max().item() <= 1e-5 * scale, \
            name


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_with_dropout_on_the_card(dev, policy):
    """Remat on the card, dropout on (masks from CUDA generators seeded
    per site) and memory through kernel B: a recompute draws the same
    masks and launches kernel B again, and the gradients equal those of
    no remat bit for bit."""
    import dataclasses
    import aura_snn_rag_tpu_torch as port

    mcfg = port.MemoryConfig(max_memories=16384, feature_dim=128,
                             k_centroids=128, probe_centroids=4)
    cfg = port.ModelConfig(vocab_size=512, embedding_dim=128, num_layers=2,
                           num_heads=4, intermediate_size=256,
                           n_place_cells=128, use_rag=True, snn_layers=(0,),
                           dtype="float32", dropout=0.1)
    rng = np.random.RandomState(72)
    feats = rng.randn(16384, 128).astype(np.float32)
    state = port.bulk_load(mcfg, port.init_memory_state(mcfg, dev),
                           torch.from_numpy(feats).to(dev),
                           torch.zeros(16384, 2, device=dev))
    state = port.rebuild_centroids(mcfg, state,
                                   torch.Generator().manual_seed(0))
    base = port.HippocampalTransformer(
        cfg, mcfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(3))
    remat = port.HippocampalTransformer(
        dataclasses.replace(cfg, use_gradient_checkpointing=True,
                            gradient_checkpoint_policy=policy), mcfg,
        device=dev)
    remat.load_state_dict(base.state_dict())
    ids = torch.from_numpy(rng.randint(0, 512, (2, 24))).to(dev)

    def grads(model):
        out, _ = model(ids, memory_state=state, dropout_seed=11)
        out.logits.square().mean().backward()
        return out.logits.detach(), {n: p.grad for n, p in
                                     model.named_parameters()
                                     if p.grad is not None}

    n0 = launch_counts["ivf_retrieve_fused"]
    la, ga = grads(base)
    n1 = launch_counts["ivf_retrieve_fused"]
    lb, gb = grads(remat)
    torch.cuda.synchronize()
    assert n1 - n0 == 2 and launch_counts["ivf_retrieve_fused"] - n1 == 4
    assert torch.equal(la, lb) and ga.keys() == gb.keys()
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


def _spill_pair(dev, coarse, rng, D=256):
    """The host-spilled bank on the card and on the CPU, written, decayed,
    ticked and wrapped the same way."""
    import aura_snn_rag_tpu_torch as port

    cfg = port.MemoryConfig(max_memories=4100, feature_dim=D,
                            k_centroids=16, n_place_cells=8, n_grid_cells=4,
                            n_time_cells=2, flat_block_funnel=16,
                            coarse_dtype=coarse, spill_query_chunk=64,
                            retrieve_k=10)
    feats = rng.randn(4600, D).astype(np.float32)
    banks = (port.SpilledBank(cfg, device=dev),
             port.SpilledBank(cfg, device="cpu"))
    for b in banks:
        b.write(feats[:3000])
        b.decay(0.1)
        b.tick(5.0)
        b.write(feats[3000:])                    # wraps the ring
    q = feats[rng.randint(0, 4600, 150)] + 0.5 * rng.randn(150, D).astype(
        np.float32)
    return banks, q


@pytest.mark.parametrize("coarse", ["int8", "bf16"])
def test_spilled_bank_on_the_card_matches_the_cpu_bank(dev, coarse):
    """B = 150 in chunks of 64: kernel A launches 3 times per dispatch. An
    int8 bank's block maxima are exact on both sides, so the results are
    equal; a bf16 bank's cosines are f32 sums in another order, so the
    results agree where no two scores are within 1e-5."""
    (gpu, cpu), q = _spill_pair(dev, coarse, np.random.RandomState(91))
    n0 = launch_counts["flat_blockmax"]
    rg = gpu.retrieve(q)
    assert launch_counts["flat_blockmax"] == n0 + 3
    rc = cpu.retrieve(q)
    assert gpu.served["native"] == cpu.served["native"] == 150
    np.testing.assert_allclose(rg.scores, rc.scores, rtol=1e-5)
    if coarse == "int8":
        np.testing.assert_array_equal(rg.indices, rc.indices)
    else:
        assert np.mean(rg.indices == rc.indices) >= 0.99
    streamed = gpu.retrieve_stream([q[:50], q[50:70], q[70:]], coalesce=64)
    for rs, lo, hi in zip(streamed, (0, 50, 70), (50, 70, 150)):
        single = gpu.retrieve(q[lo:hi])
        np.testing.assert_array_equal(rs.indices, single.indices)
        np.testing.assert_array_equal(rs.scores, single.scores)


# D = 192: not a multiple of 128, kernel A's last K box reads past D
@pytest.mark.parametrize("D", [256, 192])
def test_spill_funnel_through_kernel_a_matches_its_plain_version(
        dev, monkeypatch, D):
    """The device funnel with kernel A (3 launches: B = 150 in chunks of
    64) and with flat_blockmax_plain in its place, on the same card bank:
    the same candidate slots per query."""
    from aura_snn_rag_tpu_torch.memory import host_spill

    (gpu, _), q = _spill_pair(dev, "int8", np.random.RandomState(92), D)
    n0 = launch_counts["flat_blockmax"]
    _, _, kern = gpu._dispatch_funnel(q)
    assert launch_counts["flat_blockmax"] == n0 + 3
    monkeypatch.setattr(host_spill, "flat_blockmax", flat_blockmax_plain)
    n0 = launch_counts["flat_blockmax"]
    _, _, plain = gpu._dispatch_funnel(q)
    assert launch_counts["flat_blockmax"] == n0
    assert torch.equal(kern.sort(dim=1).values, plain.sort(dim=1).values)


# --------------------------------------------------------------------------
# the neuromorphic brain system: the card against the CPU
# --------------------------------------------------------------------------

# a spike flips where a potential lands within an ulp of its threshold
# (CUDA's tanh, exp and reductions round otherwise than the CPU's), as
# between JAX and the port: at most 1e-4 of the entries, and outputs
# within 1e-5 on the rows where every spike agrees
FLIP_FRACTION = 1e-4
ZONE_TOL = 1e-5
THIRDS = (("lif", 1 / 3), ("izhikevich", 1 / 3), ("adex", 1 / 3))


def _zone_config(groups=THIRDS, **kw):
    from aura_snn_rag_tpu_torch.zones.brain_zone import (
        BrainZoneConfig, SpikingNeuronConfig)
    return BrainZoneConfig(neuron_configs=tuple(
        SpikingNeuronConfig(t, percentage=p) for t, p in groups), **kw)


def _flipped_rows(gpu_zone, cpu_zone, x, homeo=None):
    """Rows of x where a spike of the two zones differs (flips held to
    FLIP_FRACTION)."""
    d = gpu_zone.input_proj.weight_patterns.device
    with torch.no_grad():
        sg, _ = gpu_zone.population(x.to(d), None if homeo is None
                                    else homeo.to(d))
        sc, _ = cpu_zone.population(x, homeo)
    flips = (sg.cpu() != sc)
    assert flips.float().mean().item() <= FLIP_FRACTION
    return flips.any(dim=2).any(dim=1)


def _assert_rows(got, want, flipped):
    keep = ~flipped
    assert keep.any()
    assert (got.cpu()[keep] - want[keep]).abs().max().item() <= ZONE_TOL


def _guard_devices(module, dev):
    """A pre-hook that fails on any tensor off `dev` (a CPU tensor)
    reaching the forward."""
    def hook(_, args):
        for a in args:
            if torch.is_tensor(a):
                assert a.device.type == dev.type, \
                    f"a tensor on {a.device} reached a zone forward on {dev}"
    return module.register_forward_pre_hook(hook)


@pytest.mark.parametrize("B", [8, 256])
def test_mixed_zone_on_the_card_matches_the_cpu(dev, B):
    from aura_snn_rag_tpu_torch.zones.brain_zone import NeuromorphicBrainZone
    cfg = _zone_config()
    cpu = NeuromorphicBrainZone(cfg, "cpu",
                                torch.Generator().manual_seed(B))
    gpu = NeuromorphicBrainZone(cfg, dev).requires_grad_(False)
    gpu.load_state_dict(cpu.state_dict())
    cpu.requires_grad_(False)
    gen = torch.Generator().manual_seed(B)
    x = torch.randn(B, 64, generator=gen)
    homeo = torch.randn(128, generator=gen) * 0.3
    _guard_devices(gpu, dev)
    og, stg = gpu(x.to(dev), homeo.to(dev))
    oc, stc = cpu(x, homeo)
    assert og.device.type == dev.type and all(
        v.device.type == dev.type for v in stg.values())
    _assert_rows(og, oc, _flipped_rows(gpu, cpu, x, homeo))
    assert float(stg["avg_firing_rate"]) > 0


def test_enhanced_brain_on_the_card_matches_the_cpu(dev):
    from aura_snn_rag_tpu_torch.models.brain.brain import EnhancedBrain
    from aura_snn_rag_tpu_torch.services.brain_system import DEFAULT_ZONES
    cfgs = [_zone_config((("lif", 1.0),), name=n) for n, _ in DEFAULT_ZONES]
    cpu = EnhancedBrain(cfgs, d_model=64, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    gpu = EnhancedBrain(cfgs, d_model=64, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    for name, _ in DEFAULT_ZONES:
        _guard_devices(getattr(gpu, f"zone_{name}"), dev)
    with torch.no_grad():
        og, ig = gpu(x.to(dev))
        oc, ic = cpu(x)
    assert torch.equal(ig["routing"]["indices"].cpu(),
                       ic["routing"]["indices"])
    flipped = torch.zeros(64, dtype=torch.bool)
    for name, _ in DEFAULT_ZONES:
        flipped |= _flipped_rows(getattr(gpu, f"zone_{name}"),
                                 getattr(cpu, f"zone_{name}"), x)
    _assert_rows(og, oc, flipped)


def test_brain_system_on_the_card_matches_the_cpu(dev):
    """The defaults (d_model 64, 64 LIF neurons, 8 zones) from one seed on
    both devices: the same plans, outputs within 1e-5 where the spikes
    agree, no zone error, no CPU tensor in a zone forward; then an
    orchestrator batch through the zone executor."""
    from aura_snn_rag_tpu_torch.services.brain_system import (
        NeuromorphicBrainSystem)
    from aura_snn_rag_tpu_torch.services.continuous_learning import (
        IngestItem)
    gpu = NeuromorphicBrainSystem(device=dev)
    cpu = NeuromorphicBrainSystem(device="cpu")
    for name, zone in gpu._zone_modules.items():
        assert torch.equal(zone.input_proj.weight_patterns.cpu(),
                           cpu._zone_modules[name].input_proj.weight_patterns)
        _guard_devices(zone, dev)
    for text in ("remember to analyze the pattern", "I feel sad",
                 "calculate the timeline", "create a visual design"):
        og, ig = gpu.process_text(text)
        assert gpu.processor.stats["errors"] == 0
        oc, ic = cpu.process_text(text)
        assert og.device.type == dev.type and ig["plan"] == ic["plan"]
        x = torch.from_numpy(cpu.orchestrator.hash_embedder.embed(text))[
            None, :64]
        flipped = torch.zeros(1, dtype=torch.bool)
        for zone, _ in ic["plan"]:
            flipped |= _flipped_rows(gpu._zone_modules[zone],
                                     cpu._zone_modules[zone], x)
        _assert_rows(og, oc, flipped)
    outs = []
    gpu.orchestrator.zone_executor = (
        lambda f, c, inner=gpu.orchestrator.zone_executor:
        outs.append(inner(f, c)))
    gpu.orchestrator.process_batch([IngestItem("the history", "memory"),
                                    IngestItem("a tune", "emotion")])
    assert len(outs) == 2 and gpu.processor.stats["errors"] == 0
    assert all(torch.isfinite(o).all() and o.device.type == dev.type
               for o, _ in outs)


def test_liquid_brain_on_the_card_matches_the_cpu(dev):
    from aura_snn_rag_tpu_torch.models.brain.brain import LiquidBrain
    gpu = LiquidBrain(device=dev)
    cpu = LiquidBrain(device="cpu")
    cpu.hippocampus = type(gpu.hippocampus)(*(t.cpu()
                                               for t in gpu.hippocampus))
    eg, ec = [], []
    for i in range(40):
        text, target = f"sample text number {i % 4}", float(i % 4)
        eg.append(gpu.learn_text(text, target)["error"])
        ec.append(cpu.learn_text(text, target)["error"])
    np.testing.assert_allclose(eg, ec, rtol=0, atol=1e-4)
    assert np.mean(np.abs(eg[-10:])) < np.mean(np.abs(eg[:10]))


# --------------------------------------------------------------------------
# the NaturalBrain path (no kernel): the card against the CPU port from
# the same weights and the same Poisson draws (CPU generators of one
# seed), outputs within 1e-5 on the rows where every spike agrees and
# stage-local spike flips on at most 1e-4 of the entries, as chip_smoke's
# natural-brain phase holds them (its helpers run here)
# --------------------------------------------------------------------------

def _guard_tree(model, dev):
    """`_guard_devices` on every submodule of a model."""
    return [_guard_devices(m, dev) for m in model.modules()]


def _ids_batches(seed, n, B, T, vocab):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, vocab, (B, T)))
            for _ in range(n)]


@pytest.mark.parametrize("case", ["defaults", "driven"])
def test_natural_brain_on_the_card_matches_the_cpu(dev, case):
    import chip_smoke as cs
    from aura_snn_rag_tpu_torch.models.brain.natural_brain import (
        NaturalBrain)
    card, ref = cs.lm_pair(lambda d, g: NaturalBrain(
        2048, d_model=64, zone_neurons=32, device=d, generator=g), dev, 3)
    if case == "driven":
        cs.driven(card, ref, 4)
    _guard_tree(card, dev)
    hormones = {"dopamine": 0.6, "cortisol": 1.5, "norepinephrine": 0.8}
    res = cs.natural_brain_vs_cpu(card, ref,
                                  _ids_batches(5, 2, 4, 64, 2048), hormones)
    assert res["rows_compared"] >= 4
    if case == "driven":
        assert min(res["spike_rates"]) > 0.1


def test_moe_language_zone_on_the_card_matches_the_cpu(dev):
    """Forward at the defaults and driven, and gradients at the defaults,
    at the MoE's default width (256, 8 experts, top-2)."""
    import chip_smoke as cs
    from aura_snn_rag_tpu_torch.models.language_zone import MoELanguageZone
    card, ref = cs.lm_pair(lambda d, g: MoELanguageZone(
        1024, device=d, generator=g), dev, 6)
    _guard_tree(card, dev)

    def call(model, ids, gen):
        return model(ids, gen)
    batches = _ids_batches(7, 2, 4, 64, 1024)
    res = cs.card_vs_cpu(card, ref, batches, call, lambda m: m.zone)
    assert res["rows_compared"] >= 4
    assert cs.moe_grads_vs_cpu(card, ref, batches[0]) <= cs.NB_GRAD_RTOL
    cs.driven(card, ref, 8)
    res = cs.card_vs_cpu(card, ref, batches, call, lambda m: m.zone)
    assert min(res["spike_rates"]) > 0.1


@pytest.mark.parametrize("cfg_name", ["default", "ANALYTICAL_BALANCED",
                                      "analytical_balanced"])
def test_prosody_gains_on_the_card_keep_tied_winners(dev, cfg_name):
    """Salience rows of binary LIF spikes are full of ties: the card's
    winners are the CPU's (lowest index first), gains within 1e-6, on the
    rows whose LIF spikes agree (the card's sin may differ in the last
    bit)."""
    from aura_snn_rag_tpu_torch.models import prosody as tp
    cfg = {"default": tp.ProsodyAttentionConfig(),
           "ANALYTICAL_BALANCED": tp.ANALYTICAL_BALANCED}.get(
        cfg_name) or tp.SWEEP_CONFIGS[cfg_name]
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, 32000,
                                                            (16, 256)))
    gc, ic = tp.prosody_attention_gains(ids.to(dev), cfg)
    gr, ir = tp.prosody_attention_gains(ids, cfg)
    decay = torch.tensor(cfg.decay)[:, None]
    spikes = [tp._lif_chains(torch.stack(tp.prosody_channels_from_tokens(x)),
                             decay.to(x.device)).cpu()
              for x in (ids.to(dev), ids)]
    keep = ~(spikes[0] != spikes[1]).any(dim=2).any(dim=0)
    assert keep.sum() >= 12
    assert torch.equal(ic["winners"].cpu()[keep], ir["winners"][keep])
    torch.testing.assert_close(gc.cpu()[keep], gr[keep], rtol=1e-6,
                               atol=1e-6)
    tied = torch.zeros(2, 10)
    tied[0, [1, 2, 4, 5, 8]] = 1.0
    zero = torch.zeros_like(tied)
    r = tp.multi_channel_spiking_attention(
        tied.to(dev), zero.to(dev), zero.to(dev),
        tp.ProsodyAttentionConfig(k_winners=3, decay=(0.0, 0.0, 0.0)))
    assert r["winners"][0].tolist() == [1, 2, 4]


def test_dual_layer_srffn_on_the_card_matches_the_cpu(dev):
    import chip_smoke as cs
    from aura_snn_rag_tpu_torch.encoders.dual_layer_srffn import (
        DualLayerSRFFN)
    card, ref = DualLayerSRFFN(device=dev), DualLayerSRFFN(device="cpu")
    for text, ph in cs.srffn_texts(64, seed=10):
        oc, orf = card.forward(text, ph), ref.forward(text, ph)
        assert oc["features"].device.type == dev.type
        for key in ("features", "semantic", "phonetic"):
            torch.testing.assert_close(oc[key].cpu(), orf[key], rtol=0,
                                       atol=1e-5)
        assert oc["voice"] == orf["voice"]


# --------------------------------------------------------------------------
# the sharded bank, the data-parallel trainer and the utils on the card:
# a one-rank NCCL group, where every collective is a copy, so the sharded
# paths must give the unsharded ones' bits
# --------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(dev, tmp_path):
    from aura_snn_rag_tpu_torch.parallel import distributed
    distributed.initialize(f"file://{tmp_path}/rendezvous", 1, 0,
                           device="cuda", timeout=120)
    try:
        yield distributed.global_mesh(1)
    finally:
        distributed.shutdown()


def _small_bank(dev, n=20_000, seed=3):
    import aura_snn_rag_tpu_torch as port
    cfg = port.MemoryConfig(max_memories=32_768, feature_dim=128,
                            k_centroids=128, probe_centroids=4)
    rng = np.random.RandomState(seed)
    centers = rng.randn(64, 128).astype(np.float32) * 2
    feats = torch.from_numpy(centers[rng.randint(0, 64, n)]
                             + rng.randn(n, 128).astype(np.float32)).to(dev)
    st = port.init_memory_state(cfg, dev)
    st = port.bulk_load(cfg, st, feats, torch.zeros(n, 2, device=dev))
    st = port.rebuild_centroids(cfg, st, torch.Generator().manual_seed(0))
    return cfg, st, feats


@pytest.mark.parametrize("B", [1, 8, 256])
def test_retrieve_sharded_equals_retrieve_auto_on_one_rank(nccl_mesh, dev,
                                                            B):
    from aura_snn_rag_tpu_torch.memory import engine, sharded
    cfg, st, feats = _small_bank(dev)
    q = feats[:B] + 0.1
    launch_counts.clear()
    want = engine.retrieve_auto(cfg, st, q, None, 10)
    plain = dict(launch_counts)
    launch_counts.clear()
    got = sharded.retrieve_sharded(cfg, nccl_mesh, st, q, 10)
    assert dict(launch_counts) == plain
    for f in ("indices", "scores", "features"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_sharded_gradient_equals_retrieve_auto_on_one_rank(nccl_mesh, dev):
    from aura_snn_rag_tpu_torch.memory import engine, sharded
    cfg, st, feats = _small_bank(dev)
    x = feats[:8]
    grads = []
    for fn in (lambda q: engine.retrieve_auto(cfg, st, q, None, 5),
               lambda q: sharded.retrieve_sharded(cfg, nccl_mesh, st, q, 5)):
        W = torch.eye(128, device=dev, requires_grad=True)
        fn(x @ W).scores.sum().backward()
        grads.append(W.grad)
    assert grads[0].abs().max() > 0
    assert torch.equal(grads[0], grads[1])


def test_data_parallel_trainer_equals_plain_on_one_rank(nccl_mesh, dev):
    """Two steps with memory at a small width, under deterministic
    algorithms: every tensor of the sharded trainer equals the plain
    one's bit for bit."""
    import dataclasses
    import aura_snn_rag_tpu_torch as port
    cfg = port.AuraConfig(
        model=port.ModelConfig(vocab_size=512, embedding_dim=128,
                               num_layers=2, num_heads=4,
                               intermediate_size=256, max_seq_len=512,
                               n_place_cells=128, snn_layers=(0,),
                               use_rag=True),
        memory=port.MemoryConfig(max_memories=32_768, feature_dim=128,
                                 k_centroids=128, probe_centroids=4),
        training=dataclasses.replace(
            port.TrainingConfig(), batch_size=8, memory_warmup_steps=0,
            enable_thalamus=False, memory_store_interval=1,
            warmup_steps=1))
    _, bank, _ = _small_bank(dev)
    ids = torch.randint(0, 512, (8, 32), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    torch.use_deterministic_algorithms(True)
    try:
        a = port.Trainer(cfg, seed=2, device=dev)
        a.shard_to_mesh(nccl_mesh)
        a.hippocampus._set_state(type(bank)(*[t.clone() for t in bank]))
        b = port.Trainer(cfg, seed=2, device=dev)
        b.hippocampus._set_state(bank)
        for tr in (a, b):
            for _ in range(2):
                tr.train_step(ids, ids)
    finally:
        torch.use_deterministic_algorithms(False)
    assert a.history["loss"] == b.history["loss"]
    assert torch.equal(a.optimizer.flat, b.optimizer.flat)
    for x, y in zip(a.hippocampus.state, b.hippocampus.state):
        assert torch.equal(x, y)


def test_memory_stats_on_the_card(dev):
    from aura_snn_rag_tpu_torch.utils import get_memory_stats
    x = torch.empty(1 << 20, device=dev)
    stats = get_memory_stats()
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated()
    assert stats["bytes_limit"] > 0 and 0 < stats["free_ratio"] <= 1
    del x


# --------------------------------------------------------------------------
# model parallelism on a one-rank NCCL group: ring attention against SDPA,
# the pipeline at S = 1 against the sequential run
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_ring_attention_matches_sdpa_on_the_card(nccl_mesh, dev, dtype,
                                                 tol):
    """sequence_sharded_attention over a 'seq' axis of one against causal
    SDPA: the output and the q/k/v gradients within `tol` of each
    tensor's largest entry (f32 with TF32 off; bf16)."""
    import torch.nn.functional as F
    from aura_snn_rag_tpu_torch.parallel.distributed import mesh_from_ranks
    from aura_snn_rag_tpu_torch.parallel.ring_attention import (
        sequence_sharded_attention)
    mesh = mesh_from_ranks(np.zeros((1, 1), np.int64), ("data", "seq"))
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 128, 4, 32).astype(
        np.float32)).to(dev, dtype) for _ in range(4))
    outs = []
    for fn in (lambda a, b, c: sequence_sharded_attention(a, b, c, mesh),
               lambda a, b, c: F.scaled_dot_product_attention(
                   *(t.transpose(1, 2) for t in (a, b, c)),
                   is_causal=True).transpose(1, 2)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        o.backward(do)
        outs.append([o.detach()] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        err = (got.float() - want.float()).abs().max()
        assert err <= tol * want.float().abs().max(), err


def test_pipelined_rag_matches_the_sequential_run_on_the_card(nccl_mesh,
                                                               dev):
    """pipelined_rag_apply over one stage and 4 microbatches against the
    model's forward over the same bank: logits within 1e-2 (bf16), and
    kernel B launched once per layer per microbatch."""
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.models.pipelined import pipelined_rag_apply
    from aura_snn_rag_tpu_torch.parallel.distributed import mesh_from_ranks
    mcfg, bank, _ = _small_bank(dev)
    cfg = port.ModelConfig(vocab_size=512, embedding_dim=128, num_layers=2,
                           num_heads=4, intermediate_size=256,
                           max_seq_len=512, n_place_cells=128,
                           snn_layers=(0,), use_rag=True)
    model = port.HippocampalTransformer(
        cfg, mcfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(4))
    mesh = mesh_from_ranks(np.zeros((1,), np.int64), ("stage",))
    ids = torch.randint(0, 512, (8, 32), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        launch_counts.clear()
        got = pipelined_rag_apply(model, ids, bank, mesh, 4)
        assert dict(launch_counts) == {"ivf_retrieve_fused": 2 * 4}
        launch_counts.clear()
        want = model(ids, memory_state=bank)[0].logits
        assert dict(launch_counts) == {"ivf_retrieve_fused": 2}
    assert (got - want).abs().max() <= 1e-2
