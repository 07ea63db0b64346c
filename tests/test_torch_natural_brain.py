"""The port's NaturalBrain, limbic system and basal ganglia against the
JAX package's (mirrors of tests/models/test_brain.py::TestNaturalBrain).

flax initialises the weights; `models/convert.module_from_numpy` carries
them across. Inputs come from numpy seeds; JAX runs under
`jax.default_matmul_precision("highest")`, jitted. The temporal cortex's
Poisson draw is JAX's uniform draw, patched into the port's
`models.language_zone.continuous_to_spikes`. Logits and zone statistics
are held within 1e-5 on the rows where every spike of both packages
agrees (the temporal cortex's encoder, experts, Poisson draw and decoder,
and the other cortices' LIF populations), flips to 1e-4 of the entries.
`NaturalBrain` runs at the defaults (the embedding's normal(0.02) init:
the temporal cortex does not spike) and driven (the embedding table
replaced by N(0, 9) in the converted tree: spike rate > 0.1, tokens
reach both experts).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.models.brain import basal_ganglia as jbg
from aura_snn_rag_tpu.models.brain import limbic as jlimbic
from aura_snn_rag_tpu.models.brain import natural_brain as jnb
from aura_snn_rag_tpu_torch.models import language_zone as tlz
from aura_snn_rag_tpu_torch.models.brain import basal_ganglia as tbg
from aura_snn_rag_tpu_torch.models.brain import limbic as tlimbic
from aura_snn_rag_tpu_torch.models.brain import natural_brain as tnb
from aura_snn_rag_tpu_torch.models.convert import module_from_numpy
from aura_snn_rag_tpu_torch.zones.brain_zone import BrainZoneConfig
from tests.test_torch_common import (
    Tap, highest, intermediates, jax_poisson, patched_poisson,
    zone_flips, zone_spike_flips)

torch.set_num_threads(1)

TOL = 1e-5
VOCAB, D, NEURONS, EXPERTS, T, B = 64, 32, 16, 2, 8, 6


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _tree(variables):
    return jax.tree.map(np.asarray, variables)


# --------------------------------------------------------------------------
# limbic system and basal ganglia
# --------------------------------------------------------------------------

@pytest.mark.parametrize("place", [False, True])
def test_limbic_system_matches_jax(place):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 16).astype(np.float32)
    act = rng.rand(12).astype(np.float32) if place else None
    jm = jlimbic.LimbicSystem(16, n_place_cells=12 if place else 0)
    args = (jnp.asarray(x),) + ((jnp.asarray(act),) if place else ())
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *args)
    tm = tlimbic.LimbicSystem(16, n_place_cells=12 if place else 0,
                              device="cpu")
    module_from_numpy(tm, _tree(params))
    with highest():
        jout = jax.jit(jm.apply)(params, *args)
    tout = tm(torch.from_numpy(x),
              None if act is None else torch.from_numpy(act))
    for key in ("arousal", "valence"):
        got = tout["emotional_state"][key]
        assert got.dim() == 0            # one value for the batch
        np.testing.assert_allclose(_np(got), np.asarray(
            jout["emotional_state"][key]), rtol=0, atol=TOL)
    if place:
        np.testing.assert_allclose(_np(tout["memory_context"]),
                                   np.asarray(jout["memory_context"]),
                                   rtol=0, atol=TOL)
    else:
        assert tout["memory_context"] is None
        assert jout["memory_context"] is None
    # activity without a memory path is ignored, as in JAX
    if not place:
        assert tm(torch.from_numpy(x), torch.ones(12))[
            "memory_context"] is None


REGIONS = ("temporal_cortex", "prefrontal_cortex", "parietal_cortex")


@pytest.fixture(scope="module")
def ganglia_pair():
    rng = np.random.RandomState(2)
    outs = {r: rng.randn(4, 16).astype(np.float32) for r in REGIONS}
    jm = jbg.BasalGanglia(16, REGIONS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jax.tree.map(
        jnp.asarray, outs))
    tree = _tree(params)
    # gates other than 1.0, so the weighting is exercised
    for i, r in enumerate(REGIONS):
        tree["params"][f"gate_{r}"] = np.float32(0.5 * i - 0.3)
    tm = tbg.BasalGanglia(16, REGIONS, device="cpu")
    module_from_numpy(tm, tree)
    assert float(tbg.BasalGanglia(16, REGIONS, device="cpu").gate_parietal_cortex) == 1.0
    return jm, jax.tree.map(jnp.asarray, tree), tm, outs


@pytest.mark.parametrize("present", [REGIONS, REGIONS[1:], ("other",), ()])
def test_basal_ganglia_matches_jax(ganglia_pair, present):
    jm, params, tm, outs = ganglia_pair
    sub = {r: outs.get(r, outs[REGIONS[0]]) for r in present}
    with highest():
        jout = jm.apply(params, jax.tree.map(jnp.asarray, sub))
    tout = tm({r: torch.from_numpy(v) for r, v in sub.items()})
    if not set(present) & set(REGIONS):
        assert tout is None and jout is None
        return
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0,
                               atol=TOL)


# --------------------------------------------------------------------------
# NaturalBrain
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def brain_pairs():
    jm = jnb.NaturalBrain(vocab_size=VOCAB, d_model=D,
                          zone_neurons=NEURONS, num_experts=EXPERTS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(42),
                              jnp.zeros((1, T), jnp.int32))
    tree = _tree(params)
    driven = jax.tree.map(np.copy, tree)
    driven["params"]["embedding"]["embedding"] = (np.random.RandomState(
        8).randn(VOCAB, D) * 3).astype(np.float32)
    pairs = {}
    for name, t in (("defaults", tree), ("driven", driven)):
        tm = tnb.NaturalBrain(VOCAB, d_model=D, zone_neurons=NEURONS,
                              num_experts=EXPERTS, device="cpu")
        module_from_numpy(tm, t)
        pairs[name] = (jax.tree.map(jnp.asarray, t), tm.requires_grad_(False))
    return jm, pairs


@functools.lru_cache(maxsize=None)
def _jax_apply(jm, hormone_items):
    hormones = dict(hormone_items) or None
    return jax.jit(lambda p, ids, rng: jm.apply(
        p, ids, hormones, rng, capture_intermediates=True,
        mutable=["intermediates"]))


def _brain_call(jm, params, tm, ids, hormones, monkeypatch, seed=42):
    """Both packages' NaturalBrain on the same ids, hormones and Poisson
    draw: (jax logits, jax info, port logits, port info, rows where a
    spike flipped, the port temporal cortex's dispatch plan)."""
    rng = jax.random.PRNGKey(seed)
    u = jax_poisson(rng, (ids.shape[0], D), 4)
    fn, drawn = patched_poisson(u)
    monkeypatch.setattr(tlz, "continuous_to_spikes", fn)
    with highest():
        (jlog, jinfo), inter = _jax_apply(
            jm, tuple(sorted((hormones or {}).items())))(
            params, jnp.asarray(ids), rng)
    inter = inter["intermediates"]
    cortex = tm.cortex_temporal_cortex
    tap = Tap(encoder_proj=cortex.encoder_proj,
              syn1=cortex.bank.experts.syn1, syn2=cortex.bank.experts.syn2,
              decoder_proj=cortex.decoder_proj)
    tlog, tinfo = tm(torch.from_numpy(ids), hormones)
    tap.remove()
    rows, _, _, plan = zone_spike_flips(
        params["params"]["cortex_temporal_cortex"],
        inter["cortex_temporal_cortex"], tap, cortex, ids, u, drawn, False)
    # the other cortices: their LIF populations on the JAX input
    routed, _ = intermediates(inter, "thalamus")
    scale = 1.0 + 0.1 * float((hormones or {}).get("dopamine", 0.0))
    for region in REGIONS[1:]:
        zone_cfg = BrainZoneConfig(name=region, n_neurons=NEURONS,
                                   input_dim=D, output_dim=D)
        x = np.asarray((routed[region] * scale).mean(axis=1))
        flips, _ = zone_flips({"params": params["params"][
            f"cortex_{region}"]}, zone_cfg, getattr(tm, f"cortex_{region}"),
            x)
        rows |= flips.any(axis=(1, 2))
    return jlog, jinfo, tlog, tinfo, rows, plan


@pytest.mark.parametrize("case", ["defaults", "driven"])
@pytest.mark.parametrize("hormones", [None, {"dopamine": 5.0,
                                             "cortisol": 0.7,
                                             "norepinephrine": 0.4}])
def test_natural_brain_matches_jax(brain_pairs, case, hormones,
                                   monkeypatch):
    jm, pairs = brain_pairs
    params, tm = pairs[case]
    ids = np.random.RandomState(5).randint(0, VOCAB, (B, T))
    jlog, jinfo, tlog, tinfo, rows, plan = _brain_call(
        jm, params, tm, ids, hormones, monkeypatch)
    assert tlog.shape == (B, VOCAB) and torch.isfinite(tlog).all()
    keep = ~rows
    assert keep.sum() >= B - 2
    np.testing.assert_allclose(_np(tlog)[keep], np.asarray(jlog)[keep],
                               rtol=0, atol=TOL)
    for key in ("arousal", "valence"):
        np.testing.assert_allclose(_np(tinfo["emotion"][key]),
                                   np.asarray(jinfo["emotion"][key]),
                                   rtol=0, atol=TOL)
    for key in ("indices", "weights", "probs"):
        np.testing.assert_allclose(_np(tinfo["routing"][key]),
                                   np.asarray(jinfo["routing"][key]),
                                   rtol=0, atol=TOL)
    rate = float(tinfo["temporal_cortex_info"]["spike_rate"])
    if not rows.any():
        np.testing.assert_allclose(rate, float(jinfo[
            "temporal_cortex_info"]["spike_rate"]), rtol=0, atol=1e-7)
        for region in REGIONS[1:]:
            for key, value in tinfo[f"{region}_info"].items():
                np.testing.assert_allclose(
                    _np(value), np.asarray(jinfo[f"{region}_info"][key]),
                    rtol=1e-5, atol=TOL, err_msg=f"{region} {key}")
    if case == "driven":
        assert rate > 0.1
        assert (np.asarray(plan).sum(axis=(0, 2)) > 0).sum() >= 2
    else:
        assert rate < 0.01


def test_forward_logits_and_info(brain_pairs):
    _, pairs = brain_pairs
    _, tm = pairs["defaults"]
    logits, info = tm(torch.arange(8).reshape(1, 8))
    assert logits.shape == (1, VOCAB) and torch.isfinite(logits).all()
    assert "routing" in info and "emotion" in info
    assert 0.0 <= float(info["emotion"]["arousal"]) <= 1.0


def test_hormones_change_output(brain_pairs):
    _, pairs = brain_pairs
    _, tm = pairs["defaults"]
    ids = torch.arange(8).reshape(1, 8)
    l0, _ = tm(ids)
    l1, _ = tm(ids, hormone_levels={"dopamine": 5.0})
    assert not torch.allclose(l0, l1)


def test_generator_draws_the_poisson_spikes(brain_pairs):
    """The port draws the temporal cortex's decoder spikes from the given
    generator (seed 0 without one): the same seed, the same logits."""
    _, pairs = brain_pairs
    _, tm = pairs["driven"]
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, VOCAB,
                                                            (B, T)))
    a, _ = tm(ids, generator=torch.Generator().manual_seed(3))
    b, _ = tm(ids, generator=torch.Generator().manual_seed(3))
    c, _ = tm(ids, generator=torch.Generator().manual_seed(4))
    d, _ = tm(ids)
    e, _ = tm(ids, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e)


def test_converter_checks_the_natural_brain_tree(brain_pairs):
    jm, pairs = brain_pairs
    params, _ = pairs["defaults"]
    tree = _tree(params)
    tm = tnb.NaturalBrain(VOCAB, d_model=D, zone_neurons=NEURONS,
                          num_experts=EXPERTS, device="cpu")
    bank = tree["params"]["cortex_temporal_cortex"]["bank"]["experts"]
    assert bank["readout"]["kernel"].shape == (EXPERTS, D, D)
    missing = jax.tree.map(np.copy, tree)
    del missing["params"]["basal_ganglia"]["gate_parietal_cortex"]
    with pytest.raises(KeyError):
        module_from_numpy(tm, missing)
    extra = jax.tree.map(np.copy, tree)
    extra["params"]["basal_ganglia"]["gate_occipital"] = np.float32(1.0)
    with pytest.raises(KeyError):
        module_from_numpy(tm, extra)
    wrong = jax.tree.map(np.copy, tree)
    wrong["params"]["cortex_temporal_cortex"]["bank"]["experts"]["syn1"][
        "kernel"] = np.zeros((EXPERTS + 1, D, D), np.float32)
    with pytest.raises(RuntimeError):
        module_from_numpy(tm, wrong)


def test_entry_points_default_to_cuda():
    from aura_snn_rag_tpu_torch.encoders.dual_layer_srffn import (
        DualLayerSRFFN)
    from aura_snn_rag_tpu_torch.encoders.frequency_encoder import (
        FrequencyPatternEncoder)
    from aura_snn_rag_tpu_torch.models.emotion_head import (
        EmotionPersonalityHead)
    from aura_snn_rag_tpu_torch.models.prosody import CachedProsodyBridge
    makers = (lambda: tnb.NaturalBrain(VOCAB, d_model=D),
              lambda: tlz.MoELanguageZone(VOCAB, d_model=D),
              lambda: tlz.FullLanguageZone(D),
              lambda: tlimbic.LimbicSystem(D),
              lambda: tbg.BasalGanglia(D, REGIONS),
              EmotionPersonalityHead, CachedProsodyBridge,
              FrequencyPatternEncoder, DualLayerSRFFN)
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
