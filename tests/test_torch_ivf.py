"""IVF path: kernels B and C's plain versions against the Pallas kernels in
interpret mode, and `retrieve` (v3r, v3, v2, v1 with locations, plain
gather) and `retrieve_auto` of the port against the JAX package on one
bank. Kernels D and E and the rest of the v2 and v3 paths are in
`test_torch_ivf_v2.py`.

The JAX package takes its kernel branches on the CPU only with
AURA_PALLAS_INTERPRET=1, which every JAX call in this file sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.ops.pallas import ivf_scan as jivf
from aura_snn_rag_tpu_torch.memory import engine as tengine
from aura_snn_rag_tpu_torch.ops.cuda import ivf_scan as tivf
from tests.test_torch_common import (
    assert_topk_match, bank_pair, highest, ivf_kernel_inputs, queries_near,
    result_np, retrieve_both, spy_ivf_kernels)
from tests.test_torch_probes import crowded_probes

torch.set_num_threads(1)

SCORE_TOL = 1e-5      # exact f32 rerank, dot products in another order
# the kernel each ivf_kernel setting reaches on this bank without locations
BRANCH_KERNEL = {"v3r": "ivf_retrieve_fused", "v3": "ivf_candidates",
                 "v2": "ivf_topk_scores"}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AURA_PALLAS_INTERPRET", "1")


def test_ivf_scan_scores_plain_matches_pallas_kernel():
    (cl, _, _, qn, top_c), (tcl, _, _, tqn, ttop) = ivf_kernel_inputs(0)
    want = np.asarray(jivf.ivf_scan_scores(cl, qn, top_c, interpret=True))
    got = tivf.ivf_scan_scores(tcl, tqn, ttop).numpy()
    # bf16 x bf16 products summed in f32 in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kk,k,B", [(128, 10, 3), (256, 5, 2)])
def test_ivf_retrieve_fused_plain_matches_pallas_kernel(kk, k, B):
    _assert_fused_matches(*ivf_kernel_inputs(kk + k, B=B), kk, k, B)


# Crowded probes: many queries share each probed cluster, the inputs on
# which a card's kernels B and D take the cluster-major coarse pass.
# "shared": 32 queries over 16 clusters, 8 pairs per cluster; "same":
# every query probes the same 4 clusters; "hot": cluster 0 in every row.
CROWDED = {"shared": dict(hot=0), "same": dict(hot=4), "hot": dict(hot=1)}


@pytest.mark.parametrize("crowd", sorted(CROWDED))
def test_ivf_retrieve_fused_plain_matches_pallas_kernel_at_crowded_probes(
        crowd):
    B, K, P, kk, k = 32, 16, 4, 128, 10
    inputs = ivf_kernel_inputs(
        90, K=K, B=B, P=P,
        probes=lambda rng: crowded_probes(rng, K, B, P, **CROWDED[crowd]))
    _assert_fused_matches(*inputs, kk, k, B)


def _assert_fused_matches(jx, tx, kk, k, B):
    with highest():
        js, jsl = (np.asarray(x) for x in jivf.ivf_retrieve_fused(
            *jx, kk, k, interpret=True))
    ts, tsl = (x.numpy() for x in tivf.ivf_retrieve_fused(*tx, kk, k))
    assert ts.shape == (B, 128) and tsl.shape == (B, 128)
    hit = js[:, :k] > -5e29
    assert (hit == (ts[:, :k] > -5e29)).all()
    assert_topk_match(np.where(hit, tsl[:, :k], -1),
                      np.where(hit, ts[:, :k], 0.0),
                      np.where(hit, jsl[:, :k], -1),
                      np.where(hit, js[:, :k], 0.0), SCORE_TOL)
    assert (ts[:, k:] == -1e30).all() and (tsl[:, k:] == -1).all()


@pytest.mark.parametrize("kernel,with_loc,k", [
    ("v3r", False, 10),         # kernel B
    ("v3r", False, 40),         # kk = 160 -> 256-wide funnel
    ("v3r", True, 10),          # kernel C (v1) with locations
    (None, False, 10),          # plain gather path
    (None, True, 5),
    ("v2", False, 10),          # kernel E, per_k = 32
    ("v2", False, 40),          # per_k = 40
    ("v3", False, 10),          # kernel D, kk = 128
    ("v3", False, 40),          # kk = 160 -> 256 lanes
    ("v2", True, 5),            # with locations every ivf_kernel takes v1
    ("v3", True, 5),
])
def test_retrieve_matches(monkeypatch, kernel, with_loc, k):
    """The port takes the JAX package's branch (the kernel wrapper it
    calls) and returns the JAX package's top-k from it."""
    kw = {"ivf_kernel": kernel} if kernel else {"use_pallas_ivf": False}
    jcfg, tcfg, js, ts, feats = bank_pair("bf16", **kw)
    q = queries_near(feats, 21, 6)
    qloc = (np.random.RandomState(22).randn(6, 2).astype(np.float32) * 3
            if with_loc else None)
    calls = spy_ivf_kernels(monkeypatch)
    jr, tr = retrieve_both(jcfg, tcfg, js, ts, q, qloc, k)
    want = [] if kernel is None else [
        "ivf_scan_scores" if with_loc else BRANCH_KERNEL[kernel]]
    assert calls == want
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)
    same = tr[0] == jr[0]
    np.testing.assert_array_equal(tr[2][same], jr[2][same])
    assert (tr[0] >= 0).all()


def test_retrieve_reaches_annexed_rows():
    """Rows that overflow every spill round live in the annex, which the
    v3r path merges after the kernel: self-retrieval must find them."""
    jcfg, tcfg, js, ts, feats = bank_pair("bf16", bucket_overprovision=1.0)
    # rebuild at C = 128 so the annex fills
    from aura_snn_rag_tpu.memory import state as jstate
    with highest():
        js = jengine.bulk_load(jcfg, jstate.init_memory_state(jcfg),
                               jnp.asarray(feats[:2000]),
                               jnp.zeros((2000, 2), jnp.float32))
        js = jengine.rebuild_centroids(jcfg, js, jax.random.PRNGKey(0))
    ts = port.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    G = min(jcfg.overflow_buckets, jcfg.k_centroids // 4)
    annexed = np.asarray(js.cluster_slot[-G:]).reshape(-1)
    annexed = annexed[annexed >= 0][:6]
    assert len(annexed) == 6
    jr, tr = retrieve_both(jcfg, tcfg, js, ts, feats[annexed], None, 3)
    np.testing.assert_array_equal(tr[0][:, 0], annexed)
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)


@pytest.mark.parametrize("B", [2, 8])
def test_retrieve_auto_matches(B):
    """B = 2 takes IVF (2 * 4 * 256 < M), B = 8 the flat scan."""
    jcfg, tcfg, js, ts, feats = bank_pair("bf16")
    q = queries_near(feats, 23, B)
    with highest():
        jr = result_np(jengine.retrieve_auto(jcfg, js, jnp.asarray(q),
                                             None, 10))
    tr = result_np(port.retrieve_auto(tcfg, ts, torch.from_numpy(q),
                                      None, 10))
    assert_topk_match(tr[0], tr[1], jr[0], jr[1], SCORE_TOL)


def test_retrieve_auto_without_index_is_bruteforce():
    _, tcfg = bank_pair("bf16")[:2]
    st = port.init_memory_state(tcfg, device="cpu")
    feats = np.random.RandomState(0).randn(500, 128).astype(np.float32)
    st = port.bulk_load(tcfg, st, torch.from_numpy(feats),
                        torch.zeros(500, 2))
    q = torch.from_numpy(feats[:3])
    a = port.retrieve_auto(tcfg, st, q, None, 5)
    b = port.retrieve_bruteforce(tcfg, st, q, None, 5)
    assert torch.equal(a.indices, b.indices)


def test_build_ivf_aux_matches():
    jcfg, tcfg, js, ts, _ = bank_pair("bf16")
    want = np.asarray(jengine.build_ivf_aux(jcfg, js))
    got = tengine.build_ivf_aux(tcfg, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
