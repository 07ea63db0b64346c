"""The port's prosody chain, spiking-MoE language zones and emotion head
against the JAX package's (mirrors of tests/models/test_language_zone.py's
TestProsody, TestLanguageZones, TestEmotionModulatedProsody and
TestTextProsodyChannels, and test_utils_and_extras.py's TestEmotionHead).

flax initialises the weights; `models/convert.module_from_numpy` carries
them across. Inputs come from numpy seeds; JAX runs under
`jax.default_matmul_precision("highest")`, its modules jitted. The JAX
Poisson draw (threefry bits) cannot be made in torch, so the zone tests
patch the port's `continuous_to_spikes` in `models.language_zone` to
compare JAX's uniform draw against sigmoid(x).

Tolerances: f32 expert, zone, head and logit outputs within 1e-5 on the
rows where every spike of both packages agrees (flips, where a potential
lands within an ulp of a level, held to 1e-4 of the entries); prosody
gains within 1e-6 with the winners equal in JAX's order on the rows whose
LIF spikes agree (XLA's sin and cos differ from PyTorch's in the last
bit on ~5% of ids); `topk_dispatch` bit-equal; gradients within 1e-4 of
each tensor's RMS (floored at 1e-3 of the largest tensor's RMS: a tensor
whose gradient is zero in exact arithmetic holds f32 noise); the
LayerNorms within 1e-5 (their inputs are rates in steps of 1/4, whose
one-pass variance does not cancel). Each zone runs at the defaults
(0.02-scale features: the encoder barely spikes) and driven (unit-scale
features: spike rate > 0.1, tokens reach at least two experts).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aura_snn_rag_tpu.models import emotion_head as jeh
from aura_snn_rag_tpu.models import language_zone as jlz
from aura_snn_rag_tpu.models import prosody as jp
from aura_snn_rag_tpu.ops.neurons import gif_params as jgif_params
from aura_snn_rag_tpu_torch.models import emotion_head as teh
from aura_snn_rag_tpu_torch.models import language_zone as tlz
from aura_snn_rag_tpu_torch.models import prosody as tp
from aura_snn_rag_tpu_torch.models.convert import (
    module_from_numpy, tree_to_state_dict)
from aura_snn_rag_tpu_torch.ops.neurons import gif_params as tgif_params
from tests.test_torch_common import (
    FLIP_FRACTION, Tap, highest, intermediates, jax_poisson,
    patched_poisson, zone_spike_flips)

torch.set_num_threads(1)

TOL = 1e-5          # f32 outputs where every spike agrees
GAIN_TOL = 1e-6     # prosody gains, absolute and relative
GRAD_RTOL = 1e-4    # gradients, of each tensor's RMS
D, T, E = 16, 8, 4  # zone width, sequence length, experts


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _tree(variables):
    return jax.tree.map(np.asarray, variables)


# --------------------------------------------------------------------------
# prosody
# --------------------------------------------------------------------------

def _ids(seed, B=4, L=64, high=32000):
    return np.random.RandomState(seed).randint(0, high, (B, L))


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_gains(ids, cfg):
    return jp.prosody_attention_gains(ids, cfg)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_lif_spikes(ids, cfg):
    amp, pitch, bnd = jp.prosody_channels_from_tokens(ids)
    return jnp.stack([jp._lif_chain(c, d)
                      for c, d in zip((amp, pitch, bnd), cfg.decay)])


def _port_lif_spikes(ids, cfg):
    amp, pitch, bnd = tp.prosody_channels_from_tokens(torch.from_numpy(ids))
    return tp._lif_chains(torch.stack([amp, pitch, bnd]),
                          torch.tensor(cfg.decay)[:, None]).numpy()


def _assert_gains_match(ids, cfg, tgains, tinfo):
    """Gains within GAIN_TOL and winners equal on the rows whose LIF
    spikes agree (flips rare); returns the number of rows compared."""
    jgains, jinfo = _jax_gains(jnp.asarray(ids), cfg)
    flips = np.asarray(_jax_lif_spikes(jnp.asarray(ids), cfg)) \
        != _port_lif_spikes(ids, cfg)
    assert flips.mean() <= FLIP_FRACTION
    keep = ~flips.any(axis=(0, 2))
    assert keep.any()
    np.testing.assert_allclose(_np(tgains)[keep], np.asarray(jgains)[keep],
                               rtol=GAIN_TOL, atol=GAIN_TOL)
    np.testing.assert_array_equal(_np(tinfo["winners"])[keep],
                                  np.asarray(jinfo["winners"])[keep])
    np.testing.assert_allclose(_np(tinfo["salience"])[keep],
                               np.asarray(jinfo["salience"])[keep],
                               rtol=0, atol=GAIN_TOL)
    return int(keep.sum())


def test_channels_deterministic():
    ids = torch.tensor([[1, 2, 3]])
    a1, p1, b1 = tp.prosody_channels_from_tokens(ids)
    a2, _, _ = tp.prosody_channels_from_tokens(ids)
    assert torch.equal(a1, a2) and a1.shape == (1, 3)


def test_channels_match_jax_within_an_ulp():
    ids = np.arange(32000).reshape(8, 4000)
    ja = jp.prosody_channels_from_tokens(jnp.asarray(ids))
    ta = tp.prosody_channels_from_tokens(torch.from_numpy(ids))
    for j, t in zip(ja[:2], ta[:2]):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0,
                                   atol=1.2e-7)
    np.testing.assert_array_equal(_np(ta[2]), np.asarray(ja[2]))


def test_attention_gains_bounds():
    gains, info = tp.prosody_attention_gains(torch.arange(32).reshape(1, 32))
    cfg = tp.ProsodyAttentionConfig()
    assert gains.shape == (1, 32)
    assert cfg.min_gain <= float(info["mu_scalar"][0]) <= cfg.max_gain
    assert float(gains.max()) <= cfg.max_gain * 2.0 + 1e-5


ALL_CONFIGS = dict(default=tp.ProsodyAttentionConfig(),
                   ANALYTICAL_BALANCED=tp.ANALYTICAL_BALANCED,
                   **tp.SWEEP_CONFIGS)


def test_configs_match_jax():
    assert tp.SWEEP_CONFIGS == jp.SWEEP_CONFIGS
    assert tp.ANALYTICAL_BALANCED == jp.ANALYTICAL_BALANCED
    assert tp.EMOTIONAL_BOOSTED == jp.EMOTIONAL_BOOSTED
    assert {c.smoothing for c in ALL_CONFIGS.values()} == {0, 1, 2, 3}


@pytest.mark.parametrize("name", sorted(ALL_CONFIGS))
def test_gains_and_winners_match_jax(name):
    cfg = ALL_CONFIGS[name]
    ids = _ids(sorted(ALL_CONFIGS).index(name))
    tgains, tinfo = tp.prosody_attention_gains(torch.from_numpy(ids), cfg)
    assert _assert_gains_match(ids, cfg, tgains, tinfo) >= 3


@pytest.mark.parametrize("m", [2, 3, 4])
def test_smoothing_matches_jnp_convolve(m):
    """Even windows pad m // 2 before and (m - 1) // 2 after, as
    jnp.convolve(mode="same") does; salience rows full of ties keep the
    lowest index first."""
    cfg = tp.ProsodyAttentionConfig(smoothing=m, k_winners=6)
    rng = np.random.RandomState(m)
    chans = [rng.rand(3, 24).astype(np.float32) * s for s in (1.5, 1.2, 1)]
    jr = jax.jit(jp.multi_channel_spiking_attention, static_argnums=3)(
        *map(jnp.asarray, chans), cfg)
    tr = tp.multi_channel_spiking_attention(*map(torch.from_numpy, chans),
                                            cfg)
    np.testing.assert_allclose(_np(tr["salience"]),
                               np.asarray(jr["salience"]), rtol=0,
                               atol=GAIN_TOL)
    np.testing.assert_array_equal(_np(tr["winners"]),
                                  np.asarray(jr["winners"]))
    np.testing.assert_allclose(_np(tr["mu_scalar"]),
                               np.asarray(jr["mu_scalar"]), rtol=0,
                               atol=GAIN_TOL)


def test_tied_winners_take_the_lowest_index_first():
    s = np.zeros((2, 10), np.float32)
    s[0, [1, 2, 4, 5, 8]] = 1.0        # one channel of spikes, many ties
    zero = np.zeros_like(s)
    cfg = tp.ProsodyAttentionConfig(k_winners=3, decay=(0.0, 0.0, 0.0))
    tr = tp.multi_channel_spiking_attention(
        torch.from_numpy(s), torch.from_numpy(zero), torch.from_numpy(zero),
        cfg)
    jr = jp.multi_channel_spiking_attention(
        jnp.asarray(s), jnp.asarray(zero), jnp.asarray(zero), cfg)
    np.testing.assert_array_equal(_np(tr["winners"]),
                                  np.asarray(jr["winners"]))
    assert _np(tr["winners"])[0].tolist() == [1, 2, 4]


def test_cached_bridge_lru():
    bridge = tp.CachedProsodyBridge(tp.ANALYTICAL_BALANCED, cache_size=2,
                                    device="cpu")
    ids = np.arange(16).reshape(1, 16)
    g1 = bridge(ids)
    g2 = bridge(ids)
    assert torch.equal(g1, g2)
    assert bridge.stats["hits"] == 1 and bridge.stats["misses"] == 1
    for seed in range(3):                  # evicts ids (cache of 2)
        bridge(_ids(seed, 1, 16))
    bridge(torch.from_numpy(ids))          # the same bytes as a tensor
    assert bridge.stats == {"hits": 1, "misses": 5, "hit_rate": 1 / 6}
    assert bridge.host_copies == 0


def test_cached_bridge_matches_jax():
    jb = jp.CachedProsodyBridge(jp.ANALYTICAL_BALANCED)
    tb = tp.CachedProsodyBridge(tp.ANALYTICAL_BALANCED, device="cpu")
    batches = [_ids(10 + i, 8, 32) for i in range(3)]
    for b in batches + batches:
        tg = tb(b)
        jb(b)
        _, tinfo = tp.prosody_attention_gains(torch.from_numpy(b),
                                              tp.ANALYTICAL_BALANCED)
        _assert_gains_match(b, tp.ANALYTICAL_BALANCED, tg, tinfo)
    assert tb.stats == jb.stats


def test_prosody_gif_high_gain_spikes_more():
    p = tgif_params(levels=8)
    x = torch.ones(1, 8, 16) * 0.8
    low, _ = tp.prosody_gif_scan(p, x, torch.full((1, 8), 0.5))
    high, _ = tp.prosody_gif_scan(p, x, torch.full((1, 8), 2.0))
    assert float(high.sum()) > float(low.sum())


@pytest.mark.parametrize("state", [False, True])
def test_prosody_gif_scan_matches_jax(state):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 24, 32) * 1.5).astype(np.float32)
    g = (rng.rand(4, 24) * 3).astype(np.float32)
    st = ((rng.randn(4, 32).astype(np.float32),
           (1 + rng.rand(4, 32)).astype(np.float32)) if state else None)
    js, (jv, jth) = jax.jit(jp.prosody_gif_scan)(
        jgif_params(levels=8), jnp.asarray(x), jnp.asarray(g),
        state=None if st is None else tuple(map(jnp.asarray, st)))
    ts, (tv, tth) = tp.prosody_gif_scan(
        tgif_params(levels=8), torch.from_numpy(x), torch.from_numpy(g),
        state=None if st is None else tuple(map(torch.from_numpy, st)))
    flips = _np(ts) != np.asarray(js)
    assert flips.mean() <= FLIP_FRACTION
    keep = ~flips.any(axis=(1, 2))
    assert keep.any() and float(ts.mean()) > 0.1
    for t, j in ((tv, jv), (tth, jth)):
        np.testing.assert_allclose(_np(t)[keep], np.asarray(j)[keep],
                                   rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# text-derived channels and emotion-modulated prosody
# --------------------------------------------------------------------------

def test_emphasis_drives_amplitude():
    calm = "the report covers the second quarter".split()
    loud = "WOW this is absolutely INCREDIBLE!!".split()
    amp_c, _, _ = tp.prosody_channels_from_strings(calm)
    amp_s, _, bnd_s = tp.prosody_channels_from_strings(loud)
    assert amp_s.mean() > amp_c.mean() + 0.1
    assert bnd_s.max() == 1.0 and amp_c.shape[0] == 1
    assert amp_c.dtype == np.float32
    for words in (calm, loud):
        for a, b in zip(tp.prosody_channels_from_strings(words),
                        jp.prosody_channels_from_strings(words)):
            np.testing.assert_array_equal(a, b)


def test_regimes_separate_through_attention():
    cfg = tp.SWEEP_CONFIGS["k7_aggressive"]

    def gain(text, pkg):
        chans = tp.prosody_channels_from_strings(text.split())
        if pkg is tp:
            r = tp.multi_channel_spiking_attention(
                *map(torch.from_numpy, chans), cfg)
        else:
            r = jp.multi_channel_spiking_attention(
                *map(jnp.asarray, chans), cfg)
        return float(_np(r["mu_scalar"][:, None]
                         * (1.0 + r["salience"])).mean())

    calm = "the recipe calls for two eggs and a cup of milk"
    loud = "STOP that is the most AMAZING thing I have EVER seen!!"
    assert gain(loud, tp) > gain(calm, tp) + 0.3
    for text in (calm, loud):
        assert abs(gain(text, tp) - gain(text, jp)) <= GAIN_TOL


@pytest.fixture(scope="module")
def small_head():
    cfg = jeh.EmotionHeadConfig(d_model=16, trunk_dim=8)
    head = jeh.EmotionPersonalityHead(cfg)
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 7, 16)))
    params = head.init(jax.random.PRNGKey(1), jnp.asarray(feats.mean(1)))
    port = teh.EmotionPersonalityHead(teh.EmotionHeadConfig(**cfg._asdict()),
                                      device="cpu")
    module_from_numpy(port, _tree(params))
    ids = np.random.RandomState(0).randint(1, 100, (3, 7))
    return head, params, port.requires_grad_(False), ids, feats


def test_emotion_prosody_shapes_and_parity(small_head):
    head, params, port, ids, feats = small_head
    with highest():
        jg, jpros, jinfo = jp.emotion_modulated_prosody(
            jnp.asarray(ids), jnp.asarray(feats), head, params)
    tg, tpros, tinfo = tp.emotion_modulated_prosody(
        torch.from_numpy(ids), torch.from_numpy(feats), port)
    assert tg.shape == (3, 7) and tpros.shape == (3, 7, 4)
    assert torch.isfinite(tg).all() and tinfo["emotion_probs"].shape == (3, 8)
    assert torch.equal(tpros[..., 0], tpros[..., 2])
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=0,
                               atol=GAIN_TOL)
    np.testing.assert_allclose(_np(tpros), np.asarray(jpros), rtol=0,
                               atol=GAIN_TOL)
    np.testing.assert_array_equal(_np(tinfo["winners"]),
                                  np.asarray(jinfo["winners"]))
    for key in ("emotion_probs", "arousal", "valence", "tone_gain"):
        np.testing.assert_allclose(_np(tinfo[key]), np.asarray(jinfo[key]),
                                   rtol=0, atol=GAIN_TOL)


class _FakeHead:
    """The JAX call shape `head.apply(params, x)`: one emotion forced."""

    def __init__(self, emo_idx):
        self.emo_idx = emo_idx

    def apply(self, params, x):
        B = x.shape[0]
        logits = torch.full((B, 8), -10.0)
        logits[:, self.emo_idx] = 10.0
        return {"emotion": logits, "intent": torch.zeros(B, 6),
                "tone": torch.zeros(B, 4), "personality": torch.zeros(B, 5)}


def test_arousal_raises_gains(small_head):
    _, _, _, ids, feats = small_head
    ids, feats = torch.from_numpy(ids), torch.from_numpy(feats)
    g_anger, pr_anger, _ = tp.emotion_modulated_prosody(
        ids, feats, _FakeHead(2), None)
    g_neutral, pr_neutral, _ = tp.emotion_modulated_prosody(
        ids, feats, _FakeHead(7), None)
    assert float(g_anger.mean()) > float(g_neutral.mean())
    assert float(pr_anger[..., 0].mean()) > float(pr_neutral[..., 0].mean())
    assert float(pr_anger[..., 1].mean()) < -0.5


# --------------------------------------------------------------------------
# emotion head
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def head32():
    head = jeh.EmotionPersonalityHead(jeh.EmotionHeadConfig(d_model=32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (4, 32)))
    params = head.init(jax.random.PRNGKey(42), jnp.asarray(x))
    port = teh.EmotionPersonalityHead(teh.EmotionHeadConfig(d_model=32),
                                      device="cpu")
    module_from_numpy(port, _tree(params))
    return head, params, port, x


def test_multitask_forward_and_loss(head32):
    head, params, port, x = head32
    labels = {"emotion": [0, 1, 2, -1], "intent": [0, 0, 1, 1],
              "tone": [-1, -1, -1, -1], "personality": [0, 1, 2, 3]}
    with highest():
        jlog = head.apply(params, jnp.asarray(x))
        jloss, jper = jeh.emotion_multitask_loss(
            jlog, {k: jnp.asarray(v) for k, v in labels.items()})
    tlog = port(torch.from_numpy(x))
    tloss, tper = teh.emotion_multitask_loss(
        tlog, {k: torch.tensor(v) for k, v in labels.items()})
    assert set(tlog) == {"emotion", "intent", "tone", "personality"}
    assert torch.isfinite(tloss) and float(tper["tone"]) == 0.0
    for key in tlog:
        np.testing.assert_allclose(_np(tlog[key]), np.asarray(jlog[key]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(_np(tper[key]), np.asarray(jper[key]),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), rtol=0,
                               atol=TOL)


def test_loss_masks_and_weights_match_jax():
    rng = np.random.RandomState(7)
    logits = {"emotion": rng.randn(6, 8), "intent": rng.randn(6, 6),
              "tone": rng.randn(6, 4)}
    labels = {"emotion": np.array([3, -1, 0, 7, -1, 2]),
              "intent": np.array([-1, 5, -1, -1, 0, 1]),
              "tone": np.array([0, 1, 2, 3, 0, 1])}
    weights = {"emotion": 2.0, "intent": 0.25}
    j = jeh.emotion_multitask_loss(
        {k: jnp.asarray(v, jnp.float32) for k, v in logits.items()},
        {k: jnp.asarray(v) for k, v in labels.items()}, weights)
    t = teh.emotion_multitask_loss(
        {k: torch.tensor(v, dtype=torch.float32) for k, v in logits.items()},
        {k: torch.from_numpy(v) for k, v in labels.items()}, weights)
    np.testing.assert_allclose(_np(t[0]), np.asarray(j[0]), rtol=0, atol=TOL)
    for key in logits:
        np.testing.assert_allclose(_np(t[1][key]), np.asarray(j[1][key]),
                                   rtol=0, atol=TOL)


def test_dropout_runs_only_when_asked():
    cfg = teh.EmotionHeadConfig(d_model=8, trunk_dim=64, dropout=0.5)
    gen = torch.Generator().manual_seed(0)
    head = teh.EmotionPersonalityHead(cfg, deterministic=False,
                                      device="cpu", generator=gen)
    x = torch.randn(4, 8, generator=gen)
    base = head(x)["emotion"]
    a, b = head(x, dropout_seed=1)["emotion"], head(x, dropout_seed=1)["emotion"]
    assert torch.equal(a, b) and not torch.equal(a, base)
    head.eval()
    assert torch.equal(head(x, dropout_seed=1)["emotion"], base)


def test_adam_epochs_match_optax(head32):
    """20 full-batch Adam epochs at 3e-3 (the emotion bench's optimizer):
    `torch.optim.Adam` against `optax.adam`, loss by loss, and weight by
    weight until a ReLU's gate first differs between the packages (a
    pre-activation within an ulp of 0, the head's counterpart of a spike
    flip; Adam's normalised step then moves the weights apart by up to
    lr per epoch)."""
    head, params, _, _ = head32
    rng = np.random.RandomState(5)
    X = rng.randn(40, 32).astype(np.float32)
    y = rng.randint(0, 8, 40)
    tx = optax.adam(3e-3)

    @jax.jit
    def step(p, s):
        def lf(p):
            return jeh.emotion_multitask_loss(
                head.apply(p, jnp.asarray(X)), {"emotion": jnp.asarray(y)})[0]
        loss, g = jax.value_and_grad(lf)(p)
        upd, s = tx.update(g, s)
        return optax.apply_updates(p, upd), s, loss

    capture = jax.jit(functools.partial(
        head.apply, capture_intermediates=True, mutable=["intermediates"]))
    port = teh.EmotionPersonalityHead(teh.EmotionHeadConfig(d_model=32),
                                      device="cpu")
    module_from_numpy(port, _tree(params))
    opt = torch.optim.Adam(port.parameters(), lr=3e-3)
    p, s = params, tx.init(params)
    jl, tl = [], []
    gates_agree, compared = True, 0
    with highest():
        for _ in range(20):
            _, inter = capture(p, jnp.asarray(X))
            tap = Tap(trunk1=port.trunk1, trunk2=port.trunk2)
            with torch.no_grad():
                port(torch.from_numpy(X))
            tap.remove()
            for name in ("trunk1", "trunk2"):
                gates_agree &= bool(np.array_equal(
                    np.asarray(intermediates(inter["intermediates"], name))
                    > 0, _np(tap.out[name]) > 0))
            if gates_agree:
                want = tree_to_state_dict(_tree(p))
                for name, t in port.state_dict().items():
                    np.testing.assert_allclose(
                        t.numpy(), want[name].numpy(), rtol=0, atol=TOL,
                        err_msg=name)
                compared += 1
            p, s, loss = step(p, s)
            jl.append(float(loss))
            opt.zero_grad()
            tloss, _ = teh.emotion_multitask_loss(
                port(torch.from_numpy(X)), {"emotion": torch.from_numpy(y)})
            tloss.backward()
            opt.step()
            tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    assert tl[-1] < tl[0] and compared >= 5


# --------------------------------------------------------------------------
# dispatch, experts and zones
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [2, 3, 12])
def test_topk_dispatch_is_bit_equal(capacity):
    rng = np.random.RandomState(capacity)
    idx = np.stack([rng.choice(4, 2, replace=False) for _ in range(6)])
    w = rng.rand(6, 2).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    j = jax.jit(jlz.topk_dispatch, static_argnums=(2, 3))(
        jnp.asarray(idx), jnp.asarray(w), 4, capacity)
    t = tlz.topk_dispatch(torch.from_numpy(idx), torch.from_numpy(w), 4,
                          capacity)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # 12 assignments over 4 experts: capacity 2 drops some, 12 none
    if capacity == 2:
        assert float(t[2]) > 0
    if capacity == 12:
        assert abs(float(t[2])) < 1e-7


def _scale(driven):
    return 1.0 if driven else 0.02


@pytest.fixture(scope="module")
def expert_pair():
    jm = jlz.SNNExpert(hidden_dim=16, output_dim=8)
    params = jax.jit(jm.init)(jax.random.PRNGKey(42), jnp.zeros((2, 4, 16)))
    tm = tlz.SNNExpert(16, 16, 8, device="cpu")
    module_from_numpy(tm, _tree(params))
    return jm, params, tm.requires_grad_(False)


@pytest.mark.parametrize("driven", [False, True])
def test_snn_expert_matches_jax(expert_pair, driven):
    from aura_snn_rag_tpu.ops.neurons import gif_scan as jgif_scan
    from aura_snn_rag_tpu_torch.ops.neurons import gif_scan as tgif_scan
    jm, params, tm = expert_pair
    x = (np.random.RandomState(1).randn(6, T, 16) * _scale(driven)
         ).astype(np.float32)
    with highest():
        jout, inter = jax.jit(functools.partial(
            jm.apply, capture_intermediates=True,
            mutable=["intermediates"]))(params, jnp.asarray(x))
    tap = Tap(syn1=tm.syn1, syn2=tm.syn2)
    tout = tm(torch.from_numpy(x))
    tap.remove()
    assert tout.shape == (6, 8)
    inter = inter["intermediates"]
    rows = np.zeros(6, bool)
    rate = 0.0
    for name in ("syn1", "syn2"):
        js, _ = jgif_scan(jgif_params(levels=8), intermediates(inter, name))
        ts, _ = tgif_scan(tgif_params(levels=8), tap.out[name])
        flips = np.asarray(js) != _np(ts)
        assert flips.mean() <= FLIP_FRACTION
        rows |= flips.any(axis=(1, 2))
        rate = max(rate, float(ts.mean()))
    assert not rows.all()
    np.testing.assert_allclose(_np(tout)[~rows], np.asarray(jout)[~rows],
                               rtol=0, atol=TOL)
    if driven:
        assert rate > 0.1


@pytest.fixture(scope="module")
def bank_pair():
    jm = jlz.ExpertBank(num_experts=3, hidden_dim=8, output_dim=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(42), jnp.zeros((2, 4, 8)))
    tm = tlz.ExpertBank(3, 8, 8, 4, device="cpu")
    module_from_numpy(tm, _tree(params))
    return jm, params, tm.requires_grad_(False)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("driven", [False, True])
def test_expert_bank_matches_jax(bank_pair, mode, driven):
    jm, params, tm = bank_pair
    rng = np.random.RandomState(2)
    x = (rng.randn(6, T, 8) * _scale(driven)).astype(np.float32)
    routing = None
    if mode == "sparse":
        idx = np.stack([rng.choice(3, 2, replace=False) for _ in range(6)])
        w = rng.rand(6, 2).astype(np.float32)
        routing = {"indices": idx, "weights": w / w.sum(1, keepdims=True)}
    with highest():
        jout = jax.jit(jm.apply)(params, jnp.asarray(x), None if routing is None
                                 else jax.tree.map(jnp.asarray, routing))
    tout = tm(torch.from_numpy(x), None if routing is None else
              {k: torch.from_numpy(v) for k, v in routing.items()})
    if mode == "dense":
        assert tout.shape == (6, 3, 4)
        if driven:                 # different experts, different outputs
            assert not np.allclose(_np(tout[:, 0]), _np(tout[:, 1]))
        np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0,
                                   atol=TOL)
    else:
        (ty, taux), (jy, jaux) = tout, jout
        assert taux["capacity"] == jaux["capacity"] == 6
        assert float(taux["dropped_fraction"]) == float(
            jaux["dropped_fraction"])
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=TOL)


def _zone_call(jzone, params, tzone, ids, feats, rng_seed, dense,
               monkeypatch, prefix=()):
    """Both packages' zone (or model) call on the same inputs and Poisson
    draw: (jax out, jax info, port out, port info, rows where a spike
    flipped, flips, JAX encoder spikes, dispatch plan)."""
    rng = jax.random.PRNGKey(rng_seed)
    zone_params = params["params"]
    for key in prefix:
        zone_params = zone_params[key]
    u = jax_poisson(rng, (ids.shape[0], zone_params["decoder_proj"]
                          ["kernel"].shape[0]), 4)
    fn, drawn = patched_poisson(u)
    monkeypatch.setattr(tlz, "continuous_to_spikes", fn)
    args = (jnp.asarray(ids),) + (() if feats is None
                                  else (jnp.asarray(feats),))
    with highest():
        (jout, jinfo), inter = jax.jit(functools.partial(
            jzone.apply, capture_intermediates=True,
            mutable=["intermediates"]))(params, *args, rng)
    zone = tzone
    jinter = inter["intermediates"]
    for key in prefix:
        zone = getattr(zone, key)
        jinter = jinter[key]
    tap = Tap(encoder_proj=zone.encoder_proj, syn1=zone.bank.experts.syn1,
              syn2=zone.bank.experts.syn2, decoder_proj=zone.decoder_proj)
    targs = (torch.from_numpy(ids),) + (() if feats is None
                                        else (torch.from_numpy(feats),))
    tout, tinfo = tzone(*targs)
    tap.remove()
    rows, flips, jenc, plan = zone_spike_flips(
        zone_params, jinter, tap, zone, ids, u, drawn, dense)
    return jout, jinfo, tout, tinfo, rows, flips, jenc, plan


@pytest.fixture(scope="module")
def zone_pairs():
    pairs = {}
    ids = jnp.zeros((3, T), jnp.int32)
    feats = jnp.zeros((3, T, D))
    for dense in (False, True):
        jm = jlz.FullLanguageZone(d_model=D, num_experts=E, top_k=2,
                                  dense_dispatch=dense)
        params = jax.jit(jm.init)(jax.random.PRNGKey(42), ids, feats)
        tm = tlz.FullLanguageZone(D, num_experts=E, top_k=2,
                                  dense_dispatch=dense, device="cpu")
        module_from_numpy(tm, _tree(params))
        pairs[dense] = (jm, params, tm.requires_grad_(False))
    return pairs


def _assert_zone_info(jinfo, tinfo, rows, keep):
    np.testing.assert_array_equal(_np(tinfo["routing"]["indices"])[keep],
                                  np.asarray(jinfo["routing"]["indices"])[keep])
    np.testing.assert_allclose(_np(tinfo["routing"]["weights"])[keep],
                               np.asarray(jinfo["routing"]["weights"])[keep],
                               rtol=0, atol=TOL)
    if not rows.any():
        np.testing.assert_allclose(_np(tinfo["spike_rate"]),
                                   np.asarray(jinfo["spike_rate"]), rtol=0,
                                   atol=1e-7)
        np.testing.assert_array_equal(_np(tinfo["prosody"]["winners"]),
                                      np.asarray(jinfo["prosody"]["winners"]))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("driven", [False, True])
def test_full_language_zone_matches_jax(zone_pairs, dense, driven,
                                        monkeypatch):
    jm, params, tm = zone_pairs[dense]
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 32000, (6, T))
    feats = (rng.randn(6, T, D) * _scale(driven)).astype(np.float32)
    jout, jinfo, tout, tinfo, rows, flips, jenc, plan = _zone_call(
        jm, params, tm, ids, feats, 42, dense, monkeypatch)
    assert tout.shape == (6, D) and torch.isfinite(tout).all()
    assert tinfo["routing"]["weights"].shape == (6, 2)
    keep = ~rows
    assert keep.sum() >= 4, flips
    np.testing.assert_allclose(_np(tout)[keep], np.asarray(jout)[keep],
                               rtol=0, atol=TOL)
    _assert_zone_info(jinfo, tinfo, rows, keep)
    if not dense:
        assert tinfo["capacity"] == jinfo["capacity"]
        assert float(tinfo["dropped_fraction"]) == float(
            jinfo["dropped_fraction"])
    if driven:
        assert float(tinfo["spike_rate"]) > 0.1
        used = (np.asarray(plan).sum(axis=(0, 2)) > 0).sum() if not dense \
            else len(np.unique(_np(tinfo["routing"]["indices"])))
        assert used >= 2


@pytest.fixture(scope="module")
def moe_pair():
    jm = jlz.MoELanguageZone(vocab_size=100, d_model=D, num_experts=E)
    params = jax.jit(jm.init)(jax.random.PRNGKey(42),
                              jnp.zeros((1, T), jnp.int32))
    tree = _tree(params)
    driven = jax.tree.map(np.copy, tree)
    driven["params"]["embedding"]["embedding"] = np.random.RandomState(
        9).randn(100, D).astype(np.float32)
    out = {}
    for name, t in (("defaults", tree), ("driven", driven)):
        tm = tlz.MoELanguageZone(100, d_model=D, num_experts=E, device="cpu")
        module_from_numpy(tm, t)
        out[name] = (jax.tree.map(jnp.asarray, t), tm)
    return jm, out


@pytest.mark.parametrize("case", ["defaults", "driven"])
def test_moe_language_zone_lm_matches_jax(moe_pair, case, monkeypatch):
    jm, pairs = moe_pair
    params, tm = pairs[case]
    ids = np.random.RandomState(6).randint(0, 100, (6, T))
    with torch.no_grad():
        jout, jinfo, tout, tinfo, rows, flips, _, plan = _zone_call(
            jm, params, tm, ids, None, 42, False, monkeypatch,
            prefix=("zone",))
    assert tout.shape == (6, 100)
    keep = ~rows
    assert keep.sum() >= 4, flips
    np.testing.assert_allclose(_np(tout)[keep], np.asarray(jout)[keep],
                               rtol=0, atol=TOL)
    _assert_zone_info(jinfo, tinfo, rows, keep)
    if case == "driven":
        assert float(tinfo["spike_rate"]) > 0.1
        assert (np.asarray(plan).sum(axis=(0, 2)) > 0).sum() >= 2


@pytest.mark.parametrize("case", ["defaults", "driven"])
def test_moe_language_zone_gradients_match_jax(moe_pair, case, monkeypatch):
    """jax.grad of the logits' sum through multi_bit_spike and the
    combine weights, against the port's autograd, tensor by tensor."""
    jm, pairs = moe_pair
    params, tm = pairs[case]
    ids = np.random.RandomState(6).randint(0, 100, (6, T))
    rng = jax.random.PRNGKey(42)
    u = jax_poisson(rng, (6, D), 4)
    fn, _ = patched_poisson(u)
    monkeypatch.setattr(tlz, "continuous_to_spikes", fn)

    def loss(p):
        lg, _ = jm.apply(p, jnp.asarray(ids), rng)
        return lg.sum()
    with highest():
        jgrad = tree_to_state_dict(_tree(jax.jit(jax.grad(loss))(params)))
    tm.requires_grad_(True)
    tm.zero_grad()
    logits, _ = tm(torch.from_numpy(ids))
    logits.sum().backward()
    # a parameter autograd never reached has the zero gradient JAX gives
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in tm.named_parameters()}
    assert any(float(g.abs().max()) > 0 for g in grads.values())
    rms = {n: float(np.sqrt(np.mean(g.numpy() ** 2)))
           for n, g in jgrad.items()}
    floor = 1e-3 * max(rms.values())
    for name, g in grads.items():
        np.testing.assert_allclose(
            g.numpy(), jgrad[name].numpy(), rtol=0,
            atol=GRAD_RTOL * max(rms[name], floor), err_msg=name)
    tm.zero_grad()
    tm.requires_grad_(False)
