"""Kernel B's gradient (`ops/cuda/ivf_scan.exact_score_grad`, the backward
of the annex's Function on the engine's v3r path): the gradient of the
retrieval scores with respect to the queries.

The JAX package's Pallas kernel B has no VJP, so its training with memory
runs the XLA path of `retrieve`, whose exact rerank einsum carries the
gradient: d score / d qn = w_cos * strength[slot] * f_hat[slot] for each
hit. Here:
- `exact_score_grad` over kernel B's lanes against autograd through
  kernel B's plain version, with misses (slot -1) present;
- the port's `retrieve` (v3r, kernel B's plain version on CPU tensors)
  against `jax.grad` through the JAX package's `retrieve` on its XLA path
  (AURA_PALLAS_INTERPRET unset), on `test_torch_common`'s decayed bank,
  with and without the overflow annex merged in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu_torch.memory import engine as tengine
from aura_snn_rag_tpu_torch.ops.cuda import ivf_scan as tivf
from tests.test_torch_common import (
    bank_pair, highest, ivf_kernel_inputs, queries_near, spy_ivf_kernels)

torch.set_num_threads(1)

# f32 dot products and norms summed in another order; the plain version's
# lane multiplier is aux row 0 (w_cos * strength as decayed at the cluster
# entry), `exact_score_grad`'s w_cos * strength[slot]: equal here by
# construction, within an ulp on a real bank
GRAD_TOL = 1e-5


def _fused_inputs(seed, B, k, n_live):
    """Kernel B's inputs with aux row 0 = w_cos * strength[slot] and,
    for query 0, only `n_live` live entries among its probes (so lanes
    n_live..k-1 miss)."""
    _, (cl, aux, feats, qn, top_c) = ivf_kernel_inputs(seed, B=B)
    rng = np.random.RandomState(seed + 1)
    M = feats.shape[0]
    strength = torch.from_numpy(rng.rand(M).astype(np.float32) + 0.5)
    w_cos = 0.5
    slots = aux[:, 2].long()
    aux[:, 0] = w_cos * strength[slots]
    dead = aux[top_c[0].long(), 1]
    dead[:] = -1e30
    dead.view(-1)[:n_live] = 0.1
    aux[top_c[0].long(), 1] = dead
    return cl, aux, feats, qn, top_c, strength, w_cos


@pytest.mark.parametrize("k,n_live", [(5, 2), (10, 0), (5, 64)])
def test_fused_grad_matches_autograd_through_plain(k, n_live):
    cl, aux, feats, qn, top_c, strength, w_cos = _fused_inputs(
        k + n_live, 3, k, n_live)
    g = torch.from_numpy(np.random.RandomState(7).randn(3, k)
                         .astype(np.float32))

    def loss(s, sl):
        hit = sl[:, :k] >= 0
        return (torch.where(hit, s[:, :k], 0.0) * g).sum(), hit

    with torch.no_grad():
        s1, sl1 = tivf.ivf_retrieve_fused_plain(cl, aux, feats, qn, top_c,
                                                128, k)
    g1 = tivf.exact_score_grad(g, feats, strength, sl1[:, :k], w_cos)
    q2 = qn.clone().requires_grad_(True)
    s2, sl2 = tivf.ivf_retrieve_fused_plain(cl, aux, feats, q2, top_c, 128,
                                            k)
    l2, hit = loss(s2, sl2)
    l2.backward()
    assert torch.equal(sl1, sl2) and torch.equal(s1, s2.detach())
    assert int(hit[0].sum()) == min(n_live, k)      # misses on query 0
    np.testing.assert_allclose(g1.numpy(), q2.grad.numpy(), rtol=0,
                               atol=GRAD_TOL)
    if n_live == 0:
        assert not g1[0].any()                      # no hit, no gradient
    assert g1.abs().sum() > 0


@pytest.mark.parametrize("annex", [True, False])
def test_retrieve_grad_matches_jax_xla_path(monkeypatch, annex):
    monkeypatch.delenv("AURA_PALLAS_INTERPRET", raising=False)
    kw = {} if annex else {"overflow_buckets": 0}
    jcfg, tcfg, js, ts, feats = bank_pair("bf16", **kw)
    q = queries_near(feats, 31, 3)
    w = np.random.RandomState(32).randn(3, 5).astype(np.float32)

    def jloss(qq):
        res = jengine.retrieve(jcfg, js, qq, None, 5)
        return (res.scores * w).sum()
    with highest():
        jg = np.asarray(jax.grad(jloss)(jnp.asarray(q)))

    calls = spy_ivf_kernels(monkeypatch)
    tq = torch.from_numpy(q).requires_grad_(True)
    res = port.retrieve(tcfg, ts, tq, None, 5)
    (res.scores * torch.from_numpy(w)).sum().backward()
    assert calls == ["ivf_retrieve_fused"]
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tq.grad.numpy(), jg, rtol=0, atol=GRAD_TOL)


def test_retrieve_grad_flows_through_the_engine_not_the_plain_autograd(
        monkeypatch):
    """The engine's v3r branch takes its gradient from the annex's
    Function (backward `exact_score_grad`): with kernel B swapped for a
    version whose outputs carry no autograd graph (as the CUDA kernel's
    do), the queries still get the same gradient."""
    jcfg, tcfg, js, ts, feats = bank_pair("bf16")
    q = torch.from_numpy(queries_near(feats, 33, 2))

    def grad(fused):
        monkeypatch.setattr(tengine, "ivf_retrieve_fused", fused)
        qq = q.clone().requires_grad_(True)
        port.retrieve(tcfg, ts, qq, None, 5).scores.sum().backward()
        return qq.grad

    def detached(*a):
        with torch.no_grad():
            s, sl = tivf.ivf_retrieve_fused_plain(*a)
        return s, sl
    g_plain = grad(tivf.ivf_retrieve_fused)
    g_detached = grad(detached)
    assert g_plain.abs().sum() > 0
    assert torch.equal(g_plain, g_detached)
