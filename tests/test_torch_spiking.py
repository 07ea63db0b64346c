"""The port's spiking ops against the JAX package's: the heaviside
surrogate and the LIF, Izhikevich and AdEx neurons (mirrors of
tests/ops/test_neurons.py), the Izhikevich presets (tests/ops/
test_presets.py and test_utils_and_extras.py::TestIzhikevichPresets),
the addition-only maths with the sign straight-through estimate,
`snn_ops` and `spike_bridge`. Inputs come from numpy seeds; JAX runs
under `jax.default_matmul_precision("highest")`; f32 throughout.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.ops import izhikevich_presets as jpre
from aura_snn_rag_tpu.ops import maths as jmaths
from aura_snn_rag_tpu.ops import neurons as jn
from aura_snn_rag_tpu.ops import snn_ops as jsnn
from aura_snn_rag_tpu.ops import spike_bridge as jbridge
from aura_snn_rag_tpu.ops.surrogate import heaviside_spike as j_heaviside
from aura_snn_rag_tpu_torch.models.convert import module_from_numpy
from aura_snn_rag_tpu_torch.ops import izhikevich_presets as tpre
from aura_snn_rag_tpu_torch.ops import maths as tmaths
from aura_snn_rag_tpu_torch.ops import neurons as tn
from aura_snn_rag_tpu_torch.ops import snn_ops as tsnn
from aura_snn_rag_tpu_torch.ops import spike_bridge as tbridge
from aura_snn_rag_tpu_torch.ops.surrogate import heaviside_spike
from tests.test_torch_common import highest

torch.set_num_threads(1)

TOL = 1e-6          # f32 elementwise results, a few ulp of O(1) values
GRAD_TOL = 1e-6     # surrogate gradients (elementwise rules)
# Izhikevich dynamics amplify an ulp: XLA contracts a*b + c into one FMA
# where PyTorch rounds twice, and on the upstroke dv/dv per step is
# 1 + dt (0.08 v + 5) > 1, so on neurons whose spike trains agree v and u
# drift apart by up to 0.08 mV and 0.006 (measured at the zone's drive,
# 8192 neurons; a neuron caught mid-upstroke at the last step differs
# most), and a spike flips on ~1e-6 of the entries
IZH_FLIP_FRACTION = 1e-4
IZH_V_TOL, IZH_U_TOL = 0.25, 0.02
ADEX_TOL = 1e-4     # mV: the exp term's ulps over the scan


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _rng(seed):
    return np.random.RandomState(seed)


# --------------------------------------------------------------------------
# heaviside surrogate and LIF
# --------------------------------------------------------------------------

def test_heaviside_surrogate_gradients_match_jax_grad():
    rng = _rng(0)
    v = rng.randn(4, 16).astype(np.float32)
    slope = (5 + 20 * rng.rand(16)).astype(np.float32)
    g = rng.randn(4, 16).astype(np.float32)
    jdv, jds = jax.grad(lambda a, s: jnp.sum(j_heaviside(a, s) * g),
                        argnums=(0, 1))(jnp.asarray(v), jnp.asarray(slope))
    tv = torch.tensor(v, requires_grad=True)
    ts = torch.tensor(slope, requires_grad=True)
    spk = heaviside_spike(tv, ts)
    np.testing.assert_array_equal(_np(spk), (v >= 0).astype(np.float32))
    (spk * torch.from_numpy(g)).sum().backward()
    assert ts.grad.shape == (16,)            # summed over the batch
    np.testing.assert_allclose(_np(tv.grad), np.asarray(jdv), rtol=0,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(_np(ts.grad), np.asarray(jds), rtol=0,
                               atol=GRAD_TOL)


def _lif_inputs(seed):
    rng = _rng(seed)
    x = (rng.randn(3, 6, 16) * 1.5).astype(np.float32)
    params = [(0.3 + 0.5 * rng.rand(16)).astype(np.float32),
              (0.4 + 0.4 * rng.rand(16)).astype(np.float32),
              (5 + 20 * rng.rand(16)).astype(np.float32)]
    return x, params, rng.randn(3, 6, 16).astype(np.float32), \
        rng.randn(3, 16).astype(np.float32)


def test_lif_scan_and_its_gradients_match_jax():
    x, params, G, H = _lif_inputs(1)

    def jloss(p, cur):
        s, m = jn.lif_scan(p, cur)
        return jnp.sum(s * G) + jnp.sum(m * H)

    jp = jn.LIFParams(*(jnp.asarray(a) for a in params))
    js, jm = jn.lif_scan(jp, jnp.asarray(x))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    tp = tn.LIFParams(*(torch.tensor(a, requires_grad=True)
                        for a in params))
    tx = torch.tensor(x, requires_grad=True)
    ts, tm = tn.lif_scan(tp, tx)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=0, atol=TOL)
    ((ts * torch.from_numpy(G)).sum()
     + (tm * torch.from_numpy(H)).sum()).backward()
    # the gradients pass the surrogate back through 6 steps of the
    # membrane chain, summed in another order: within 1e-6 of each
    # gradient's largest magnitude
    for want, got in ((gx, tx.grad), (gp.beta, tp.beta.grad),
                      (gp.threshold, tp.threshold.grad),
                      (gp.slope, tp.slope.grad)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())


def test_lif_spike_and_reset():
    p = tn.lif_params(4, beta=0.5, threshold=0.6)
    spikes, mem = tn.lif_scan(p, torch.ones(1, 5, 4))
    assert (spikes[:, 0] == 1.0).all()           # mem = 1.0 > 0.6
    assert torch.isfinite(mem).all()


def test_lif_subthreshold_silent():
    p = tn.lif_params(4, beta=0.5, threshold=10.0)
    spikes, _ = tn.lif_scan(p, torch.ones(1, 5, 4) * 0.1)
    assert spikes.sum() == 0


def test_lif_surrogate_slope_grad():
    p = tn.lif_params(8)
    slope = p.slope.clone().requires_grad_(True)
    x = torch.from_numpy(_rng(2).randn(2, 6, 8).astype(np.float32))
    spikes, _ = tn.lif_scan(p._replace(slope=slope), x)
    spikes.sum().backward()
    assert slope.grad.shape == (8,)
    assert torch.isfinite(slope.grad).all()


# --------------------------------------------------------------------------
# Izhikevich and AdEx
# --------------------------------------------------------------------------

def _zone_drive(seed, B, N, scale):
    """The brain zone's drive: tanh currents held for 32 substeps."""
    cur = np.tanh(_rng(seed).randn(B, 4, N)).astype(np.float32)
    return np.repeat(cur, 32, axis=1) * scale


@pytest.mark.parametrize("B,N", [(16, 64), (64, 128)])
def test_izhikevich_scan_matches_jax_at_the_zone_drive(B, N):
    held = _zone_drive(3, B, N, 15.0)
    js, (jv, ju) = jn.izhikevich_scan(jn.izhikevich_params(),
                                      jnp.asarray(held))
    ts, (tv, tu) = tn.izhikevich_scan(tn.izhikevich_params(),
                                      torch.from_numpy(held))
    js, ts = np.asarray(js), _np(ts)
    assert ts.shape == js.shape == held.shape
    assert js.sum() > 0
    flips = js != ts
    assert flips.mean() <= IZH_FLIP_FRACTION
    agree = ~flips.any(axis=1)                   # whole spike train equal
    np.testing.assert_allclose(_np(tv)[agree], np.asarray(jv)[agree],
                               rtol=0, atol=IZH_V_TOL)
    np.testing.assert_allclose(_np(tu)[agree], np.asarray(ju)[agree],
                               rtol=0, atol=IZH_U_TOL)


def test_izhikevich_regular_spiking_fires():
    spikes, (v, u) = tn.izhikevich_scan(tn.izhikevich_params(),
                                        torch.ones(1, 400, 1) * 10.0)
    assert spikes.sum() > 1
    assert torch.isfinite(v).all()


def test_izhikevich_no_input_silent():
    spikes, _ = tn.izhikevich_scan(tn.izhikevich_params(),
                                   torch.zeros(1, 100, 2))
    assert spikes.sum() == 0


def test_izhikevich_state_threading():
    x = torch.from_numpy(_zone_drive(4, 2, 8, 15.0))
    p = tn.izhikevich_params()
    s_full, st_full = tn.izhikevich_scan(p, x)
    s1, st1 = tn.izhikevich_scan(p, x[:, :64])
    s2, st2 = tn.izhikevich_scan(p, x[:, 64:], state=st1)
    assert torch.equal(s_full, torch.cat([s1, s2], dim=1))
    assert torch.equal(st_full[0], st2[0])


def test_adex_scan_matches_jax_under_drive():
    x = np.ones((1, 500, 1), np.float32) * 40.0
    x[0, 250:] *= 0.5
    js, (jV, jw) = jn.adex_scan(jn.adex_params(a=2.0, b=5.0),
                                jnp.asarray(x))
    ts, (tV, tw) = tn.adex_scan(tn.adex_params(a=2.0, b=5.0),
                                torch.from_numpy(x))
    assert np.asarray(js).sum() > 0
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_allclose(_np(tV), np.asarray(jV), rtol=0,
                               atol=ADEX_TOL)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0,
                               atol=ADEX_TOL)


def test_adex_silent_at_the_zone_drive_as_in_jax():
    """12.8 ms of drive is shorter than tau_m = 20 ms: no spike in either
    package (the JAX package's behaviour, kept)."""
    held = _zone_drive(5, 8, 32, 40.0)
    js, (jV, _) = jn.adex_scan(jn.adex_params(), jnp.asarray(held))
    ts, (tV, _) = tn.adex_scan(tn.adex_params(), torch.from_numpy(held))
    assert np.asarray(js).sum() == 0 and ts.sum() == 0
    np.testing.assert_allclose(_np(tV), np.asarray(jV), rtol=0,
                               atol=ADEX_TOL)


def test_adex_params_match_jax():
    for kw in ({}, dict(C=281.0, g_L=30.0, a=4.0, b=80.5),
               dict(g_L=0.0)):
        want = jn.adex_params(**kw)
        got = tn.adex_params(**kw)
        for name, w, g in zip(want._fields, want, got):
            assert g.dtype == torch.float32 and g.shape == ()
            assert float(g) == float(w), name


# --------------------------------------------------------------------------
# Izhikevich presets
# --------------------------------------------------------------------------

def test_presets_match_jax():
    assert tpre.IZHIKEVICH_PRESETS == jpre.IZHIKEVICH_PRESETS
    assert len(tpre.IZHIKEVICH_PRESETS) >= 23
    for name in tpre.IZHIKEVICH_PRESETS:
        got, want = tpre.get_preset(name), jpre.get_preset(name)
        assert [float(x) for x in got] == [float(x) for x in want], name
        assert all(np.isfinite(float(x)) for x in got)
    with pytest.raises(KeyError):
        tpre.get_preset("not_a_pattern")


def test_fast_spiking_fires_more_than_regular():
    x = torch.ones(1, 500, 1) * 10.0
    rs, _ = tn.izhikevich_scan(tpre.get_preset("regular_spiking"), x)
    fs, _ = tn.izhikevich_scan(tpre.get_preset("fast_spiking"), x)
    assert float(fs.sum()) > float(rs.sum())


def test_preset_loaders_match_jax(tmp_path):
    p = tmp_path / "patterns.csv"
    p.write_text("name,a,b,c,d\ncustom_one,0.03,0.25,-60,4\n"
                 "custom_two,0.1,0.2,-65,2\n")
    out = tpre.load_presets_csv(str(p))
    assert out == jpre.load_presets_csv(str(p))
    assert out["custom_one"] == {"a": 0.03, "b": 0.25, "c": -60.0, "d": 4.0}
    q = tmp_path / "patterns.json"
    q.write_text(json.dumps({"models": {"1_izhikevich": {
        "my_pattern": {"a": 0.02, "b": 0.2, "c": -65, "d": 8,
                       "note": "extra keys ignored"}}}}))
    out = tpre.load_presets_json(str(q))
    assert out == jpre.load_presets_json(str(q))
    assert out["my_pattern"]["d"] == 8.0


# --------------------------------------------------------------------------
# addition-only maths
# --------------------------------------------------------------------------

def test_addition_linear_is_l1():
    out = tmaths.addition_linear(torch.tensor([[1.0, 2.0]]),
                                 torch.tensor([[1.0, 2.0], [0.0, 0.0]]))
    np.testing.assert_allclose(_np(out), [[0.0, -3.0]])


def test_addition_ops_match_jax():
    rng = _rng(6)
    x = rng.randn(5, 12).astype(np.float32)
    w = rng.randn(7, 12).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    for bias in (None, b):
        want = jmaths.addition_linear(
            jnp.asarray(x), jnp.asarray(w),
            None if bias is None else jnp.asarray(bias))
        got = tmaths.addition_linear(
            torch.from_numpy(x), torch.from_numpy(w),
            None if bias is None else torch.from_numpy(bias))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-5)
    want = jmaths.additive_receptance(jnp.asarray(x * 0.1),
                                      jnp.asarray(w * 0.1), 2.0)
    got = tmaths.additive_receptance(torch.from_numpy(x * 0.1),
                                     torch.from_numpy(w * 0.1), 2.0)
    assert 0 < _np(got).mean() < 1
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_sign_activation_and_its_ste_match_jax(threshold):
    x = np.concatenate([(_rng(7).randn(32) * 1.5).astype(np.float32),
                        np.float32([0.2, 5.0, threshold])])
    g = _rng(8).randn(x.size).astype(np.float32)
    jy = jmaths.sign_activation(jnp.asarray(x), threshold)
    jg = jax.grad(lambda a: jnp.sum(jmaths.sign_activation(a, threshold)
                                    * g))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tmaths.sign_activation(tx, threshold)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(_np(ty), np.asarray(jy))
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jg), rtol=0,
                               atol=GRAD_TOL)


def test_sign_activation_ste():
    x = torch.tensor([0.2, 5.0], requires_grad=True)
    tmaths.sign_activation(x).sum().backward()
    np.testing.assert_allclose(_np(x.grad), [0.8, 0.0], atol=1e-6)


@pytest.mark.parametrize("use_bias", [False, True])
def test_addition_linear_module_matches_flax(use_bias):
    x = _rng(9).randn(4, 10).astype(np.float32)
    jm = jmaths.AdditionLinearModule(6, use_bias=use_bias)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)))
    if use_bias:
        params = jax.tree.map(lambda a: a + 0.05, params)
    tm = tmaths.AdditionLinearModule(10, 6, use_bias=use_bias,
                                     device="cpu")
    module_from_numpy(tm, jax.tree.map(np.asarray, params))
    want = jm.apply(params, jnp.asarray(x))
    # sums of 10 distances of ~1 in another order: a few ulp of ~10
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))),
                               np.asarray(want), rtol=0, atol=1e-5)


def test_addition_linear_module_init_distribution():
    tm = tmaths.AdditionLinearModule(64, 256, device="cpu")
    tm.init_parameters(torch.Generator().manual_seed(0))
    w = _np(tm.weight_patterns)
    assert 0.0 <= w.min() and w.max() < 0.2
    assert abs(w.mean() - 0.1) < 0.002


def test_numpy_helpers_match_jax():
    x = _rng(10).randn(9) * 3
    np.testing.assert_array_equal(tmaths.softmax_np(x, 0.7),
                                  jmaths.softmax_np(x, 0.7))
    np.testing.assert_allclose(tmaths.softmax_np(np.asarray([1.0, 1.0])),
                               [0.5, 0.5], atol=1e-9)
    np.testing.assert_array_equal(tmaths.softplus_np(x),
                                  jmaths.softplus_np(x))
    np.testing.assert_array_equal(tmaths.sigmoid_np(x),
                                  jmaths.sigmoid_np(x))


# --------------------------------------------------------------------------
# snn_ops and spike bridges
# --------------------------------------------------------------------------

def test_snn_ops_match_jax():
    rng = _rng(11)
    spikes = (rng.rand(3, 5, 24) < 0.3).astype(np.float32)
    w = rng.randn(24, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    x = (rng.randn(3, 40) * 3).astype(np.float32)
    scale = rng.rand(40).astype(np.float32)
    with highest():
        want = [jsnn.snn_matmul(jnp.asarray(spikes), jnp.asarray(w),
                                jnp.asarray(b)),
                jsnn.snn_softmax(jnp.asarray(x), temperature=0.5),
                jsnn.snn_silu(jnp.asarray(x)),
                jsnn.piecewise_silu(jnp.asarray(x)),
                jsnn.snn_rmsnorm(jnp.asarray(x), jnp.asarray(scale))]
    got = [tsnn.snn_matmul(torch.from_numpy(spikes), torch.from_numpy(w),
                           torch.from_numpy(b)),
           tsnn.snn_softmax(torch.from_numpy(x), temperature=0.5),
           tsnn.snn_silu(torch.from_numpy(x)),
           tsnn.piecewise_silu(torch.from_numpy(x)),
           tsnn.snn_rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))]
    for g, wv in zip(got, want):
        assert g.shape == wv.shape
        np.testing.assert_allclose(_np(g), np.asarray(wv), rtol=1e-6,
                                   atol=1e-6)


def test_piecewise_silu_segments():
    x = torch.tensor([-5.0, -4.0, -2.0, -1.0, 0.0, 0.5, 1.0, 2.0, 4.0, 6.0])
    want = jsnn.piecewise_silu(jnp.asarray(_np(x)))
    np.testing.assert_array_equal(_np(tsnn.piecewise_silu(x)),
                                  np.asarray(want))


@pytest.mark.parametrize("mode", ["rate", "temporal", "phase"])
@pytest.mark.parametrize("T", [1, 6])
def test_spikes_to_continuous_matches_jax(mode, T):
    spikes = (_rng(12 + T).rand(2, 3, T, 10) < 0.4).astype(np.float32)
    want = np.asarray(jbridge.spikes_to_continuous(jnp.asarray(spikes),
                                                   mode))
    got = _np(tbridge.spikes_to_continuous(torch.from_numpy(spikes), mode))
    assert got.shape == want.shape == (2, 3, 10)
    if mode == "phase":
        # angle / pi in (-1, 1]: an imaginary part that rounds to +-0
        # gives +-1, the same phase; compare modulo 2
        d = np.abs(got - want) % 2.0
        np.testing.assert_allclose(np.minimum(d, 2.0 - d), 0.0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_temporal_spike_coding_matches_jax():
    x = (_rng(14).randn(4, 9) * 2).astype(np.float32)
    want = jbridge.continuous_to_spikes(jnp.asarray(x), 5,
                                        jax.random.PRNGKey(0), "temporal")
    got = tbridge.continuous_to_spikes(torch.from_numpy(x), 5,
                                       mode="temporal")
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_poisson_spike_coding():
    """Poisson draws cannot match JAX's PRNG bit for bit: the rate of
    each unit follows sigmoid(x), and a seeded generator repeats."""
    x = torch.from_numpy(np.linspace(-3, 3, 7, dtype=np.float32))
    spikes = tbridge.continuous_to_spikes(
        x, 20000, torch.Generator().manual_seed(0), "poisson")
    assert spikes.shape == (20000, 7)
    assert set(np.unique(_np(spikes))) <= {0.0, 1.0}
    np.testing.assert_allclose(_np(spikes.mean(0)), _np(torch.sigmoid(x)),
                               atol=0.015)
    again = tbridge.continuous_to_spikes(
        x, 20000, torch.Generator().manual_seed(0), "poisson")
    assert torch.equal(spikes, again)
    with pytest.raises(ValueError):
        tbridge.continuous_to_spikes(x, 4, mode="bogus")
    with pytest.raises(ValueError):
        tbridge.spikes_to_continuous(spikes[None], "bogus")
