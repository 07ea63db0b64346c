"""The port's spiking and encoding ops against the JAX package's.

`multi_bit_spike` (forward and surrogate gradient), the GIF neuron
(`gif_scan`, `gif_scan_const`), `sparse_place_code`, `place_cell_encode`
and `theta_gamma_encoding`, on the same numpy inputs. Spike counts are
compared for equality at f32: `floor` turns a last-bit difference into a
whole level, so the operations keep the JAX package's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.ops import neurons as jneurons
from aura_snn_rag_tpu.ops import place_cells as jplace
from aura_snn_rag_tpu.ops import surrogate as jsurrogate
from aura_snn_rag_tpu.ops import theta_gamma as jtg
from aura_snn_rag_tpu_torch.ops import (
    ThetaGammaParams, gif_params, gif_scan, gif_scan_const,
    init_theta_gamma, multi_bit_spike, place_cell_encode, sparse_place_code,
    theta_gamma_encoding)

torch.set_num_threads(1)


def _spike_inputs(seed, n=4000, levels=8):
    """Values spread over [-2, L + 3], with exact integers, half-integers
    and the range ends among them."""
    rng = np.random.RandomState(seed)
    v = rng.uniform(-2.0, levels + 3.0, n).astype(np.float32)
    grid = np.arange(-2, levels + 3, 0.5, dtype=np.float32)
    v[:grid.size] = grid
    return v


@pytest.mark.parametrize("levels", [4.0, 8.0, 16.0])
def test_multi_bit_spike_forward_and_gradient_match(levels):
    v = _spike_inputs(int(levels), levels=int(levels))
    g = np.random.RandomState(1).randn(v.size).astype(np.float32)
    want = np.asarray(jsurrogate.multi_bit_spike(jnp.asarray(v), levels))
    want_grad = np.asarray(jax.grad(lambda x: jnp.sum(
        jsurrogate.multi_bit_spike(x, levels) * g))(jnp.asarray(v)))
    tv = torch.from_numpy(v).requires_grad_(True)
    got = multi_bit_spike(tv, levels)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # the triangular rule is a few elementwise ops on the same f32 values
    np.testing.assert_allclose(tv.grad.numpy(), want_grad, rtol=0,
                               atol=1e-6)
    assert np.count_nonzero(want_grad) > v.size // 4


def test_multi_bit_spike_bf16_forward_matches():
    v = _spike_inputs(3)
    want = np.asarray(jsurrogate.multi_bit_spike(
        jnp.asarray(v, jnp.bfloat16), 8.0).astype(jnp.float32))
    got = multi_bit_spike(torch.from_numpy(v).to(torch.bfloat16), 8.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gif_params_match():
    for dtype, tdt in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        jp = jneurons.gif_params(levels=8, dtype=dtype)
        tp = gif_params(levels=8, dtype=tdt)
        assert tp.levels == jp.levels == 8.0
        for a, b in zip(jp[:3], tp[:3]):
            assert b.dtype == tdt
            assert float(a) == float(b)


@pytest.mark.parametrize("levels,scale", [(8, 1.5), (16, 4.0), (4, 0.7)])
def test_gif_scan_matches(levels, scale):
    rng = np.random.RandomState(levels)
    cur = (rng.randn(3, 5, 6, 96) * scale).astype(np.float32)  # [..., T, D]
    js, (jv, jth) = jneurons.gif_scan(jneurons.gif_params(levels=levels),
                                      jnp.asarray(cur))
    ts, (tv, tth) = gif_scan(gif_params(levels=levels), torch.from_numpy(cur))
    assert ts.shape == cur.shape
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.asarray(js).max() >= 2                 # multi-bit levels fire
    # XLA may fuse v * decay + i into one multiply-add on the CPU where
    # the port rounds twice: the membranes (|v| up to 2 * L * theta) differ
    # in their last bits while every spike is equal
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tth.numpy(), np.asarray(jth), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("levels,T", [(8, 4), (16, 7)])
def test_gif_scan_const_matches(levels, T):
    rng = np.random.RandomState(T)
    cur = (rng.randn(64, 200) * 2.0).astype(np.float32)
    state = (np.abs(rng.randn(64, 200)).astype(np.float32),
             (1.0 + 0.1 * rng.rand(64, 200)).astype(np.float32))
    for st in (None, state):
        js, (jv, _) = jneurons.gif_scan_const(
            jneurons.gif_params(levels=levels), jnp.asarray(cur), T,
            None if st is None else tuple(map(jnp.asarray, st)))
        ts, (tv, _) = gif_scan_const(
            gif_params(levels=levels), torch.from_numpy(cur), T,
            None if st is None else tuple(map(torch.from_numpy, st)))
        assert ts.shape == (64, T, 200)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-6)


def test_gif_scan_const_is_gif_scan_of_repeated_current():
    rng = np.random.RandomState(5)
    cur = torch.from_numpy((rng.randn(16, 50) * 2).astype(np.float32))
    p = gif_params(levels=8)
    a, _ = gif_scan_const(p, cur, 4)
    b, _ = gif_scan(p, cur[:, None, :].expand(16, 4, 50))
    assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 3, 60])
def test_sparse_place_code_matches(k):
    logits = np.random.RandomState(k).randn(2, 7, 2000).astype(np.float32)
    logits[0, 0, :5] = logits[0, 0, 5]              # a tie at the threshold
    want = np.asarray(jplace.sparse_place_code(jnp.asarray(logits), k))
    got = sparse_place_code(torch.from_numpy(logits), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(-1) >= k).all()


def test_place_cell_encode_matches():
    rng = np.random.RandomState(2)
    x, wp, bp, wb, bb = (rng.randn(*s).astype(np.float32) * 0.3 for s in
                         ((2, 5, 32), (32, 128), (128,), (128, 32), (32,)))
    je, ja = jplace.place_cell_encode(*map(jnp.asarray, (x, wp, bp, wb, bb)),
                                      k=4)
    te, ta = place_cell_encode(*map(torch.from_numpy, (x, wp, bp, wb, bb)),
                               k=4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-6)


@pytest.mark.parametrize("max_seq_len", [1, 64, 512])
def test_theta_gamma_encoding_matches(max_seq_len):
    rng = np.random.RandomState(max_seq_len)
    params = [rng.randn(96).astype(np.float32) * 0.1 for _ in range(2)] + [
        (1.0 + 0.1 * rng.randn(96)).astype(np.float32)]
    positions = np.stack([np.arange(64), 64 + np.arange(64)]).astype(np.int32)
    want = np.asarray(jtg.theta_gamma_encoding(
        jtg.ThetaGammaParams(*map(jnp.asarray, params)),
        jnp.asarray(positions), max_seq_len, 8.0, 40.0))
    got = theta_gamma_encoding(
        ThetaGammaParams(*map(torch.from_numpy, params)),
        torch.from_numpy(positions).long(), max_seq_len, 8.0, 40.0).numpy()
    assert got.shape == (2, 64, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_init_theta_gamma_distribution():
    p = init_theta_gamma(torch.Generator().manual_seed(0), 20_000)
    for off in (p.theta_offsets, p.gamma_offsets):
        assert abs(off.std().item() - 0.1) < 0.005
    assert not torch.equal(p.theta_offsets, p.gamma_offsets)
    assert torch.equal(p.amplitude, torch.ones(20_000))
