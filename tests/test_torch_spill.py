"""The host-spilled bank: the port's `SpilledBank` against the JAX
package's on the CPU.

Each case mirrors one of `tests/memory/test_host_spill.py` (all but its
interpret-mode kernel case, which holds the Pallas kernel to the JAX XLA
funnel these cases run): the same numpy inputs go into both banks, and
the port's results are held to the JAX package's, indices equal and
scores within rtol 1e-5 (both reranks are the same numpy or C++ on the
same host mirrors; the device funnels only choose the candidates). The
JAX bank takes its XLA funnel here, with contiguous blocks as the port's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.config import MemoryConfig as JaxMemoryConfig
from aura_snn_rag_tpu.memory import host_spill as jax_spill
import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.memory import host_spill
from aura_snn_rag_tpu_torch.ops.cuda import flat_scan
from tests.test_torch_common import highest

torch.set_num_threads(1)

SCORE_RTOL = 1e-5


def _kw(**kw):
    base = dict(max_memories=512, feature_dim=128, k_centroids=16,
                n_place_cells=8, n_grid_cells=4, n_time_cells=2,
                flat_block_funnel=16, coarse_dtype="int8")
    base.update(kw)
    return base


def _data(n, d, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32)


def _banks(**kw):
    """(JAX bank, port bank on the CPU) under one configuration."""
    cfg = _kw(**kw)
    return (jax_spill.SpilledBank(JaxMemoryConfig(**cfg)),
            port.SpilledBank(port.MemoryConfig(**cfg), device="cpu"))


def _assert_same(jr, tr):
    np.testing.assert_array_equal(tr.indices, jr.indices)
    np.testing.assert_allclose(tr.scores, jr.scores, rtol=SCORE_RTOL)
    np.testing.assert_array_equal(tr.features, jr.features)


def _retrieve_both(jb, tb, q, **kw):
    with highest():
        jr = jb.retrieve(q, **kw)
    tr = tb.retrieve(q, **kw)
    _assert_same(jr, tr)
    return tr


def test_self_retrieval_and_uniqueness():
    jb, tb = _banks()
    feats = _data(300, 128)
    for b in (jb, tb):
        b.write(feats)
    r = _retrieve_both(jb, tb, feats[:32], k=5)
    assert r.indices.shape == (32, 5)
    assert (r.indices[:, 0] == np.arange(32)).all()
    for row in r.indices:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    assert np.isfinite(r.scores).all()
    np.testing.assert_allclose(r.features[:, 0], feats[:32], rtol=1e-6)


def test_parity_vs_engine_bruteforce():
    """The spilled top-k equals the device engine's brute force top-k on
    the same rows (the port's engine and the JAX bank alike)."""
    jb, tb = _banks()
    feats = _data(400, 128, seed=3)
    for b in (jb, tb):
        b.write(feats)
    st = port.init_memory_state(tb.config, device="cpu")
    st = port.write_memories(tb.config, st, torch.from_numpy(feats),
                             torch.zeros(400, 2))
    q = _data(24, 128, seed=4)
    r_spill = _retrieve_both(jb, tb, q, k=10)
    r_exact = port.retrieve_bruteforce(tb.config, st, torch.from_numpy(q),
                                       None, 10).indices.numpy()
    agree = np.mean([len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
                     / 10 for a, b in zip(r_spill.indices, r_exact)])
    assert agree >= 0.99


def test_fifo_overwrite_at_spilled_scale():
    jb, tb = _banks(max_memories=64)
    first = _data(64, 128, seed=1)
    second = _data(16, 128, seed=2)          # overwrites slots 0..15
    for b in (jb, tb):
        b.write(first)
        b.write(second)
    assert tb.count == jb.count == 80 and tb.active_count == 64
    r_old = _retrieve_both(jb, tb, first[:8], k=1)
    for i, row in enumerate(r_old.indices):
        if row[0] in range(8):
            assert not np.allclose(r_old.features[i, 0], first[i])
    r_new = _retrieve_both(jb, tb, second, k=1)
    assert (r_new.indices[:, 0] == np.arange(16)).all()
    np.testing.assert_allclose(r_new.features[:, 0], second, rtol=1e-6)


def test_decay_reorders_and_tick_ages():
    """Many decays and a tick: the host mirrors equal the JAX package's to
    the bit; the device strengths are (1 - rate) rounded in f32, which may
    sit one ulp from the host's rate rounded from double, in both
    packages, so they are held within a few ulp of the host's."""
    jb, tb = _banks(w_temporal=0.0)
    a = _data(1, 128, seed=5)
    for b in (jb, tb):
        b.write(a)                                               # slot 0
        b.write(a + 0.01 * _data(1, 128, seed=6))                # slot 1
    r0 = _retrieve_both(jb, tb, a, k=2)
    assert r0.indices[0, 0] == 0
    for b in (jb, tb):
        for _ in range(60):
            b.decay(0.2)
        b.tick(2.5)
        b.write(a + 0.02 * _data(1, 128, seed=7))                # slot 2
    np.testing.assert_array_equal(tb.host_strength, jb.host_strength)
    np.testing.assert_array_equal(tb.host_timestamp, jb.host_timestamp)
    np.testing.assert_array_equal(tb.dev.strength.numpy(),
                                  np.asarray(jb.dev.strength))
    np.testing.assert_array_equal(tb.dev.timestamp.numpy(),
                                  np.asarray(jb.dev.timestamp))
    np.testing.assert_allclose(tb.dev.strength.numpy(), tb.host_strength,
                               rtol=1e-5)
    r1 = _retrieve_both(jb, tb, a, k=2)
    assert r1.indices[0, 0] == 2
    assert r1.scores[0, 0] > r1.scores[0, 1]


def test_temporal_term_prefers_recent():
    jb, tb = _banks(w_temporal=0.5, seconds_per_step=600.0)
    v = _data(1, 128, seed=8)
    for b in (jb, tb):
        b.write(v)
        b.tick(10.0)
        b.write(v)
    r = _retrieve_both(jb, tb, v, k=2)
    assert r.indices[0, 0] == 1


def test_spatial_scoring():
    jb, tb = _banks(w_spatial=5.0)
    v = _data(1, 128, seed=9)
    locs = np.array([[0.0, 0.0], [10.0, 10.0]], np.float32)
    for b in (jb, tb):
        b.write(np.concatenate([v, v]), locs)
    near = _retrieve_both(jb, tb, v, k=2,
                          query_locations=np.array([[0.1, 0.0]]))
    assert near.indices[0, 0] == 0
    far = _retrieve_both(jb, tb, v, k=2,
                         query_locations=np.array([[10.0, 9.9]]))
    assert far.indices[0, 0] == 1
    assert tb.served["numpy"] == 2           # locations take the numpy path


def test_retrieve_stream_matches_single():
    jb, tb = _banks()
    for b in (jb, tb):
        b.write(_data(256, 128, seed=10))
    batches = [_data(16, 128, seed=s) for s in (11, 12, 13)]
    streamed = tb.retrieve_stream(batches, k=5)
    with highest():
        j_streamed = jb.retrieve_stream(batches, k=5)
    for q, rs, js in zip(batches, streamed, j_streamed):
        _assert_same(js, rs)
        r = tb.retrieve(q, k=5)
        np.testing.assert_array_equal(rs.indices, r.indices)
        np.testing.assert_array_equal(rs.scores, r.scores)


def test_retrieve_stream_coalesce_exact():
    """Coalesced packs split back into the caller's uneven batches, equal
    to lone retrieves at every width and to the JAX package's stream."""
    jb, tb = _banks()
    for b in (jb, tb):
        b.write(_data(256, 128, seed=20))
    batches = [_data(n, 128, seed=30 + n) for n in (3, 16, 7, 16)]
    singles = [tb.retrieve(q, k=5) for q in batches]
    for width in (1, 16, 23, 10_000):
        streamed = tb.retrieve_stream(batches, k=5, coalesce=width)
        with highest():
            j_streamed = jb.retrieve_stream(batches, k=5, coalesce=width)
        assert len(streamed) == len(batches)
        for q, rs, r, js in zip(batches, streamed, singles, j_streamed):
            assert rs.indices.shape == (q.shape[0], 5)
            np.testing.assert_array_equal(rs.indices, r.indices)
            np.testing.assert_array_equal(rs.scores, r.scores)
            _assert_same(js, rs)


def test_bf16_coarse_mode():
    jb, tb = _banks(coarse_dtype="bf16")
    feats = _data(200, 128, seed=16)
    for b in (jb, tb):
        b.write(feats)
    assert tb.dev.coarse.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb.dev.coarse.float().numpy(),
        np.asarray(jb.dev.coarse.astype(jnp.float32)))
    r = _retrieve_both(jb, tb, feats[:8], k=3)
    assert (r.indices[:, 0] == np.arange(8)).all()


def test_oversized_write_keeps_last_m():
    """A batch larger than the bank keeps its last M rows. The port puts
    them on the device at the slots the host mirrors hold them in (the
    JAX package writes the device rows from count % M); the funnel covers
    the whole bank here, so both return the same rows."""
    jb, tb = _banks(max_memories=32)
    feats = _data(80, 128, seed=17)
    for b in (jb, tb):
        b.write(feats)
    assert tb.active_count == 32
    slots = (np.arange(80) % 32)[-32:]
    np.testing.assert_array_equal(tb.host_features[slots], feats[-32:])
    rows, _ = host_spill._host_coarse(feats[-32:], torch.int8)
    np.testing.assert_array_equal(tb.dev.coarse[slots].numpy(), rows.numpy())
    r = _retrieve_both(jb, tb, feats[-4:], k=1)
    np.testing.assert_allclose(r.features[:, 0], feats[-4:], rtol=1e-6)


def test_two_stage_row_funnel_matches_single_stage():
    """The second stage ranks by the coarse score the block funnel
    maximised, so it keeps the exact top-k here, in both packages."""
    feats = _data(400, 128, seed=11)
    q = _data(24, 128, seed=12)
    res = {}
    for rows in (0, 64):      # 0 = single stage (F = 128 passes through)
        jb, tb = _banks(spill_funnel_rows=rows)
        for b in (jb, tb):
            b.write(feats)
        res[rows] = _retrieve_both(jb, tb, q, k=10)
    agree = np.mean([
        len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist())) / 10
        for a, b in zip(res[0].indices, res[64].indices)])
    assert agree >= 0.99
    np.testing.assert_allclose(
        np.sort(res[0].scores, axis=1), np.sort(res[64].scores, axis=1),
        rtol=1e-4)


def test_two_stage_funnel_shape_is_row_funnel():
    """The transfer shrinks to [B, spill_funnel_rows], and the kept rows are
    the JAX package's, slot for slot (B is not padded in the port)."""
    jb, tb = _banks(spill_funnel_rows=32)
    for b in (jb, tb):
        b.write(_data(300, 128, seed=13))
    q = _data(8, 128, seed=14)
    _, B, funnel = tb._dispatch_funnel(q)
    assert B == 8 and tuple(funnel.shape) == (8, 32)
    assert funnel.dtype == torch.int32
    with highest():
        jf = np.asarray(jb._dispatch_funnel(q)[2])[:8]
    np.testing.assert_array_equal(np.sort(funnel.numpy(), axis=1),
                                  np.sort(jf, axis=1))


def test_query_chunked_funnel_matches_unchunked():
    """spill_query_chunk cuts the batch into slices; the result does not
    depend on it, B = 300 not a multiple of the chunk included."""
    feats = _data(400, 128, seed=7)
    q = _data(300, 128, seed=8)
    outs = {}
    for chunk in (0, 128):
        jb, tb = _banks(spill_query_chunk=chunk)
        for b in (jb, tb):
            b.write(feats)
        outs[chunk] = _retrieve_both(jb, tb, q, k=10)
    np.testing.assert_array_equal(outs[0].indices, outs[128].indices)
    np.testing.assert_array_equal(outs[0].scores, outs[128].scores)


def test_query_chunked_two_stage_funnel():
    feats = _data(400, 128, seed=9)
    q = _data(256, 128, seed=10)
    jb, tb = _banks(spill_query_chunk=128, spill_funnel_rows=32)
    _, tb0 = _banks(spill_query_chunk=0, spill_funnel_rows=32)
    for b in (jb, tb, tb0):
        b.write(feats)
    a = _retrieve_both(jb, tb, q, k=5)
    np.testing.assert_array_equal(a.indices, tb0.retrieve(q, k=5).indices)


def test_native_rerank_matches_numpy():
    """The C++ rerank reproduces the numpy path after decay and tick, and
    both equal the JAX package's on the same funnel."""
    jb, tb = _banks()
    if not tb.native:
        pytest.skip("native library unavailable")
    feats = _data(400, 128, seed=11)
    for b in (jb, tb):
        b.write(feats[:200])
        b.decay(0.05)
        b.tick(3.0)
        b.write(feats[200:])
    q = _data(64, 128, seed=12)
    qn, B, funnel = tb._dispatch_funnel(q)
    funnel = funnel.numpy()
    a = tb._host_rerank(qn, B, funnel, 10, None, use_native=True)
    b = tb._host_rerank(qn, B, funnel, 10, None, use_native=False)
    assert tb.served == {"native": 64, "numpy": 64}
    np.testing.assert_allclose(
        np.sort(a.scores, axis=1), np.sort(b.scores, axis=1),
        rtol=2e-5, atol=2e-6)
    for ra, rb in zip(a.indices, b.indices):
        assert set(ra[ra >= 0].tolist()) == set(rb[rb >= 0].tolist())
    for use_native, r in ((True, a), (False, b)):
        _assert_same(jb._host_rerank(qn, B, funnel, 10, None,
                                     use_native=use_native), r)


def test_native_rerank_dead_lanes_and_small_bank():
    """Fewer live candidates than k: slot -1 and score 0 in the padding,
    as the numpy path and the JAX package give."""
    jb, tb = _banks()
    if not tb.native:
        pytest.skip("native library unavailable")
    for b in (jb, tb):
        b.write(_data(5, 128, seed=13))
    q = _data(8, 128, seed=14)
    r = _retrieve_both(jb, tb, q, k=10)
    assert tb.served["native"] == 8
    for row, srow in zip(r.indices, r.scores):
        live = row >= 0
        assert live.sum() == 5
        assert (srow[~live] == 0.0).all()
    qn, B, funnel = tb._dispatch_funnel(q)
    _assert_same(r, tb._host_rerank(qn, B, funnel.numpy(), 10, None,
                                    use_native=False))


# D = 192: a width that is not a multiple of 128 (kernel A takes it on the
# card, its TMA boxes reading past D as zeros). A bf16 bank is left out: the JAX XLA funnel rounds its cosines to bf16,
# which neither its Pallas kernel nor kernel A does, so near-ties at the
# funnel's edge fall apart (its results are held in test_bf16_coarse_mode)
@pytest.mark.parametrize("D", [128, 192])
def test_device_funnel_candidates_match_jax(D):
    """The int8 device funnel alone, chunked at 64 over B = 100: per query
    the same candidate slots as the JAX package's funnel, since kernel A's
    plain version gives the block maxima of the JAX XLA funnel."""
    coarse = "int8"
    jb, tb = _banks(coarse_dtype=coarse, feature_dim=D, spill_query_chunk=64,
                    spill_funnel_rows=48)
    for b in (jb, tb):
        b.write(_data(450, D, seed=21))
        b.decay(0.1)
        b.tick(7.0)
        b.write(_data(40, D, seed=22))
    q = _data(100, D, seed=23)
    _, _, funnel = tb._dispatch_funnel(q)
    with highest():
        jf = np.asarray(jb._dispatch_funnel(q)[2])[:100]
    assert funnel.shape == (100, 48)
    np.testing.assert_array_equal(np.sort(funnel.numpy(), axis=1),
                                  np.sort(jf, axis=1))


def test_spill_plain_blockmax_slabs_match_one_pass(monkeypatch):
    """The plain version takes the bank in slabs at 10M rows; its result
    does not depend on the slab (ragged last slab and block included)."""
    rng = np.random.RandomState(5)
    M, D, B = 1003, 128, 6
    bank = torch.from_numpy(rng.randint(-127, 128, (M, D)).astype(np.int8))
    q = torch.from_numpy(rng.randint(-127, 128, (B, D)).astype(np.int8))
    mul, add = flat_scan.pack_row_terms(
        torch.from_numpy(rng.rand(M).astype(np.float32)),
        torch.from_numpy(rng.rand(M).astype(np.float32)), M)
    qs = torch.from_numpy(rng.rand(B).astype(np.float32))
    whole = flat_scan.flat_blockmax_plain(bank, q, mul, add, qs)
    monkeypatch.setattr(flat_scan, "PLAIN_SLAB", 256)
    slabs = flat_scan.flat_blockmax_plain(bank, q, mul, add, qs)
    assert slabs.shape == whole.shape == (B, -(-M // 8))
    assert torch.equal(slabs, whole)


def test_spilled_bank_defaults_to_cuda():
    cfg = port.MemoryConfig(**_kw())
    if torch.cuda.is_available():
        assert port.SpilledBank(cfg).dev.coarse.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.SpilledBank(cfg)


def test_spill_state_has_the_jax_fields():
    _, tb = _banks()
    names = [f.name for f in dataclasses.fields(host_spill.SpillDeviceState)]
    assert names == list(jax_spill.SpillDeviceState._fields)
    assert tb.dev.max_memories == 512
    assert host_spill.NEG_INF == jax_spill.NEG_INF
