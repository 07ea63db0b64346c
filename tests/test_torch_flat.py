"""Flat path and exact oracle: kernel A's plain version against the Pallas
kernel in interpret mode, and `retrieve_bruteforce` / `retrieve_flat`
(scan and blockmax) of the port against the JAX package on one bank."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.ops.pallas import flat_scan as jflat
from aura_snn_rag_tpu_torch.ops.cuda import flat_scan as tflat
from tests.test_torch_common import (
    assert_topk_match, bank_pair, configs, highest, queries_near, result_np)

torch.set_num_threads(1)

# exact f32 rerank on both sides, dot products summed in another order
SCORE_TOL = 1e-5


# (4100, 192): M ragged against both kernels' tiles and 8-row blocks, D
# not a multiple of 128
@pytest.mark.parametrize("M,D", [(4096, 128), (4100, 192)])
@pytest.mark.parametrize("int8", [True, False])
def test_flat_blockmax_plain_matches_pallas_kernel(int8, M, D):
    """Both against the same per-row scores: the TPU kernel's strided
    blocks mapped through `block_member_slots`, the port's contiguous;
    rows past M count as -1e30 in both."""
    rng = np.random.RandomState(int(int8) + M - 4096)
    B, tile = 5, 1024
    x = rng.randn(M, D).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(B, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mul = (rng.rand(M) * 0.5 + 0.25).astype(np.float32)
    add = (rng.rand(M) * 0.2).astype(np.float32)
    add[rng.rand(M) < 0.05] = -1e30
    if int8:
        xs = np.abs(x).max(1, keepdims=True)
        qs = np.abs(q).max(1)
        bank = np.round(x * 127 / xs).astype(np.int8)
        qq = np.round(q * 127 / qs[:, None]).astype(np.int8)
        mul = mul * xs[:, 0]
        cos = (qq.astype(np.float64) @ bank.T.astype(np.float64)) \
            / (127.0 * 127.0) * qs[:, None]
        jbank, jq = jnp.asarray(bank), jnp.asarray(qq)
        tbank, tq = torch.from_numpy(bank), torch.from_numpy(qq)
        jqs, tqs = jnp.asarray(qs), torch.from_numpy(qs)
    else:
        jbank = jnp.asarray(x, jnp.bfloat16)
        jq = jnp.asarray(q, jnp.bfloat16)
        xb = np.asarray(jbank.astype(jnp.float32), np.float64)
        qb = np.asarray(jq.astype(jnp.float32), np.float64)
        cos = qb @ xb.T
        tbank = torch.from_numpy(x).to(torch.bfloat16)
        tq = torch.from_numpy(q).to(torch.bfloat16)
        jqs = tqs = None
    rows = cos * mul + add                                        # [B, M]

    mul2d, add2d = jflat.pack_row_terms(jnp.asarray(mul), jnp.asarray(add),
                                        M, tile)
    jpad = jnp.pad(jq, ((0, 128 - B), (0, 0)))
    jqs_p = None if jqs is None else jnp.pad(jqs, (0, 128 - B),
                                             constant_values=1.0)
    jout = np.asarray(jflat.flat_blockmax(jbank, jpad, mul2d, add2d,
                                          q_scale=jqs_p, interpret=True,
                                          tile_m=tile))[:B]
    strided = np.asarray(jflat.block_member_slots(
        jnp.arange(jout.shape[1]), tile, 8))
    mul_p, add_p = tflat.pack_row_terms(torch.from_numpy(mul),
                                        torch.from_numpy(add), M)
    tout = tflat.flat_blockmax(tbank, tq, mul_p, add_p, tqs).numpy()
    contig = tflat.block_member_slots(torch.arange(-(-M // 8))).numpy()
    n_rows = max(strided.max(), contig.max()) + 1
    rows = np.pad(rows, ((0, 0), (0, n_rows - M)),
                  constant_values=np.float32(-1e30))

    # int8: integer products exact on both sides; bf16: f32 sums of exact
    # products in another order
    tol = 1e-6 if int8 else 1e-5
    np.testing.assert_allclose(jout, rows[:, strided].max(-1), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(tout, rows[:, contig].max(-1), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("M", [4096, 1001])
@pytest.mark.parametrize("coarse", ["int8", "bf16"])
def test_coarse_cos_matches(M, coarse):
    """The scan's [B, M] coarse cosine: `torch._int_mm` when M and D are
    multiples of 8, an exact f32 product of the int8 values otherwise."""
    from aura_snn_rag_tpu_torch.memory import engine as tengine
    rng = np.random.RandomState(M)
    x = rng.randn(M, 128).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(7, 128).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jdt = jnp.int8 if coarse == "int8" else jnp.bfloat16
    jrows, jscale = jengine._to_coarse_rows(jnp.asarray(x), jdt)
    want = np.asarray(jengine._coarse_cos(jrows, jnp.asarray(q), jscale))
    tdt = torch.int8 if coarse == "int8" else torch.bfloat16
    trows, tscale = tengine._to_coarse_rows(torch.from_numpy(x), tdt)
    got = tengine._coarse_cos(trows, torch.from_numpy(q), tscale).numpy()
    # int8: exact integer products, the same f32 scaling; the per-row
    # quantisation may land one level apart where the f32 scale differs in
    # its last bit. bf16: products rounded to bf16 on both sides.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 if coarse == "int8" else 4e-3)


def _queries(feats, n=24, seed=13):
    q = queries_near(feats, seed, n)
    qloc = np.random.RandomState(seed).randn(n, 2).astype(np.float32) * 3
    return q, qloc


@pytest.mark.parametrize("with_loc", [False, True])
def test_retrieve_bruteforce_matches(with_loc):
    jcfg, tcfg, js, ts, feats = bank_pair("bf16")
    q, qloc = _queries(feats)
    jl = jnp.asarray(qloc) if with_loc else None
    tl = torch.from_numpy(qloc) if with_loc else None
    with highest():
        jr = result_np(jengine.retrieve_bruteforce(jcfg, js, jnp.asarray(q),
                                                   jl, 10))
    tr = result_np(port.retrieve_bruteforce(tcfg, ts, torch.from_numpy(q),
                                            tl, 10))
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)
    np.testing.assert_array_equal(tr[2][tr[0] == jr[0]],
                                  jr[2][tr[0] == jr[0]])


@pytest.mark.parametrize("strategy,coarse,score_dtype,with_loc", [
    ("scan", "int8", "bf16", False),      # the benchmark configuration
    ("scan", "bf16", "f32", False),
    ("scan", "int8", "f32", True),
    ("blockmax", "int8", "f32", False),   # kernel A (plain version here)
    ("blockmax", "bf16", "f32", False),
    ("blockmax", "int8", "f32", True),    # spatial: plain [B, M] block max
])
def test_retrieve_flat_matches(strategy, coarse, score_dtype, with_loc):
    jcfg, tcfg, js, ts, feats = bank_pair(coarse, flat_strategy=strategy,
                                          flat_score_dtype=score_dtype)
    q, qloc = _queries(feats)
    jl = jnp.asarray(qloc) if with_loc else None
    tl = torch.from_numpy(qloc) if with_loc else None
    with highest():
        jr = result_np(jengine.retrieve_flat(jcfg, js, jnp.asarray(q), jl,
                                             10))
        exact = result_np(jengine.retrieve_bruteforce(
            jcfg, js, jnp.asarray(q), jl, 10))
    tr = result_np(port.retrieve_flat(tcfg, ts, torch.from_numpy(q), tl, 10))
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)
    # the port's funnels are exact top-k: recall at least the reference's
    def recall(idx):
        return np.mean([len(set(a) & set(b)) for a, b in zip(idx, exact[0])])
    assert recall(tr[0]) >= recall(jr[0])


FLAT_OPTIONS = {
    "exact_funnel": dict(flat_exact_funnel=True),
    "wide_funnel": dict(flat_wide_funnel=1024),
    "rescue": dict(flat_rescue_queries=8, flat_rescue_width=512),
}


# int8 with the benchmark's bf16 score chain (the rescue's margin casts
# the bf16 cutoff to f32), bf16 with f32 scores
@pytest.mark.parametrize("option", list(FLAT_OPTIONS))
@pytest.mark.parametrize("coarse,score_dtype", [("int8", "bf16"),
                                                ("bf16", "f32")])
@pytest.mark.parametrize("with_loc", [False, True])
def test_retrieve_flat_options_match(option, coarse, score_dtype, with_loc):
    """The scan's three options against the JAX package's (whose
    `approx_max_k` is exact on the CPU): the exact and the wide funnel
    keep the port's exact top-kk, the rescue re-funnels the riskiest
    queries 512 wide. Recall is at least the default scan's."""
    kw = dict(flat_strategy="scan", flat_score_dtype=score_dtype)
    jcfg, tcfg, js, ts, feats = bank_pair(coarse, **kw,
                                          **FLAT_OPTIONS[option])
    _, base_cfg = configs(coarse_dtype=coarse, **kw)
    q, qloc = _queries(feats)
    jl = jnp.asarray(qloc) if with_loc else None
    tl = torch.from_numpy(qloc) if with_loc else None
    with highest():
        jr = result_np(jengine.retrieve_flat(jcfg, js, jnp.asarray(q), jl,
                                             10))
        exact = result_np(jengine.retrieve_bruteforce(
            jcfg, js, jnp.asarray(q), jl, 10))
    tq = torch.from_numpy(q)
    tr = result_np(port.retrieve_flat(tcfg, ts, tq, tl, 10))
    base = result_np(port.retrieve_flat(base_cfg, ts, tq, tl, 10))
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)

    def recall(idx):
        return np.mean([len(set(a) & set(b)) for a, b in zip(idx, exact[0])])
    assert recall(tr[0]) >= recall(base[0])


@pytest.mark.parametrize("option", ["exact_funnel", "wide_funnel"])
@pytest.mark.parametrize("coarse,score_dtype", [("int8", "bf16"),
                                                ("bf16", "f32")])
def test_flat_exact_and_wide_funnel_equal_the_default_scan(
        option, coarse, score_dtype):
    """The scan's funnel already is an exact top-kk, so the port computes
    the default scan for these two options: the same slots, scores and
    rows, bit for bit."""
    kw = dict(flat_strategy="scan", flat_score_dtype=score_dtype)
    _, tcfg, _, ts, feats = bank_pair(coarse, **kw, **FLAT_OPTIONS[option])
    _, base_cfg = configs(coarse_dtype=coarse, **kw)
    tq = torch.from_numpy(_queries(feats)[0])
    got = result_np(port.retrieve_flat(tcfg, ts, tq, None, 10))
    base = result_np(port.retrieve_flat(base_cfg, ts, tq, None, 10))
    for g, b in zip(got, base):
        np.testing.assert_array_equal(g, b)


def test_flat_rescue_scores_each_slot_once():
    """A rescue as wide as the bank holds every row in both lanes: the
    union is deduplicated, so no slot fills two of the k lanes, and the
    rescued queries get the exact top-k."""
    _, tcfg, _, ts, feats = bank_pair("int8", flat_rescue_queries=24,
                                      flat_rescue_width=4096,
                                      flat_score_dtype="bf16")
    q, _ = _queries(feats)
    tr = result_np(port.retrieve_flat(tcfg, ts, torch.from_numpy(q), None,
                                      10))
    exact = result_np(port.retrieve_bruteforce(tcfg, ts, torch.from_numpy(q),
                                               None, 10))
    for row in tr[0]:
        assert len(set(row.tolist())) == len(row)
    assert_topk_match(tr[0], tr[1], exact[0], exact[1], SCORE_TOL)
