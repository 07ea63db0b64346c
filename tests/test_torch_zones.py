"""The port's spiking layers, brain zones and routing runtime against the
JAX package's (mirrors of tests/test_zones.py's layer, zone, routing and
plasticity cases and test_parity_extras.py's TestNeuronFactory and
TestMultiModal). flax initialises the weights and constants;
`models/convert.module_from_numpy` carries them across. Inputs come from
numpy seeds; JAX runs under `jax.default_matmul_precision("highest")`.
Zone outputs are compared within 1e-5 on the rows where every spike of
both packages agrees (`tests/test_torch_common.zone_flips`), and the
flips are held to 1e-4 of the entries.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.zones import brain_zone as jz
from aura_snn_rag_tpu.zones import layers as jlayers
from aura_snn_rag_tpu.zones import multimodal as jmm
from aura_snn_rag_tpu.zones import neuron_factory as jnf
from aura_snn_rag_tpu.zones import processor as jproc
from aura_snn_rag_tpu.zones import stats as jstats
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import LiquidMoERouter
from aura_snn_rag_tpu_torch.models.convert import module_from_numpy
from aura_snn_rag_tpu_torch.zones import brain_zone as tz
from aura_snn_rag_tpu_torch.zones import layers as tlayers
from aura_snn_rag_tpu_torch.zones import multimodal as tmm
from aura_snn_rag_tpu_torch.zones import neuron_factory as tnf
from aura_snn_rag_tpu_torch.zones import processor as tproc
from aura_snn_rag_tpu_torch.zones import stats as tstats
from tests.test_torch_common import (
    ZONE_TOL, assert_rows_match, highest, jax_zone_population, zone_flips)

torch.set_num_threads(1)

LAYER_TOL = 1e-5    # f32 Dense products and sums in another order


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _tree(variables):
    return jax.tree.map(np.asarray, variables)


def _configs(**kw):
    """The same zone config in both packages; neuron groups given as
    (type, percentage) pairs."""
    groups = kw.pop("groups", (("lif", 1.0),))
    return tuple(
        mod.BrainZoneConfig(neuron_configs=tuple(
            mod.SpikingNeuronConfig(t, percentage=p) for t, p in groups),
            **kw) for mod in (jz, tz))


def _apply(module):
    """The flax module's apply, jitted (eager JAX compiles each op anew),
    with its "constants" collection mutable as the JAX tests run it."""
    return jax.jit(functools.partial(module.apply, mutable=["constants"]))


def _zone_pair(jcfg, tcfg, seed=0, cls="zone"):
    jm = (jz.NeuromorphicBrainZone if cls == "zone"
          else jz.CorticalRegion)(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, jcfg.input_dim)))
    tm = (tz.NeuromorphicBrainZone if cls == "zone"
          else tz.CorticalRegion)(tcfg, device="cpu")
    module_from_numpy(tm, _tree(params))
    return jm, params, tm.requires_grad_(False)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_spiking_layer_matches_flax_with_its_constants():
    x = (np.random.RandomState(0).randn(2, 4, 8) * 2).astype(np.float32)
    jm = jlayers.SpikingLayer(features=16, beta=0.7, threshold=0.4)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    assert set(variables) == {"params", "constants"}
    tm = tlayers.SpikingLayer(8, 16, beta=0.7, threshold=0.4, device="cpu")
    module_from_numpy(tm, _tree(variables))
    assert float(tm.beta[0]) == np.float32(0.7)
    with highest():
        (js, jstat), _ = _apply(jm)(variables, jnp.asarray(x))
    ts, tstat = tm(torch.from_numpy(x))
    # 128 entries at ~1e-6 flips each: a flip would be a 1e-4 event
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    for key in ("firing_rate", "spike_count", "mem_mean"):
        np.testing.assert_allclose(_np(tstat[key]), np.asarray(jstat[key]),
                                   rtol=0, atol=LAYER_TOL)


@pytest.mark.parametrize("drive", ["strong", "random"])
def test_adaptive_layer_matches_flax(drive):
    x = (np.ones((1, 6, 4), np.float32) * 3.0 if drive == "strong" else
         np.random.RandomState(1).randn(3, 6, 4).astype(np.float32) * 2)
    jm = jlayers.AdaptiveSpikingLayer(features=8, target_rate=0.1,
                                      adapt_rate=0.5)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = tlayers.AdaptiveSpikingLayer(4, 8, target_rate=0.1, adapt_rate=0.5,
                                      device="cpu")
    module_from_numpy(tm, _tree(variables))
    with highest():
        (js, jthr, jstat), _ = _apply(jm)(variables, jnp.asarray(x))
        (js2, jthr2, _), _ = _apply(jm)(variables, jnp.asarray(x), jthr)
    ts, tthr, tstat = tm(torch.from_numpy(x))
    ts2, tthr2, _ = tm(torch.from_numpy(x), tthr)
    for got, want in ((ts, js), (tthr, jthr), (ts2, js2), (tthr2, jthr2),
                      (tstat["firing_rate"], jstat["firing_rate"]),
                      (tstat["threshold_mean"], jstat["threshold_mean"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=LAYER_TOL)
    if drive == "strong":
        assert float(_np(tstat["firing_rate"])) > 0.1
        assert float(_np(tthr).mean()) > 0.6     # thresholds rose


def test_reservoir_layer_matches_flax_with_its_constants():
    x = np.random.RandomState(2).randn(2, 10, 8).astype(np.float32)
    jm = jlayers.ReservoirLayer(features=32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = tlayers.ReservoirLayer(8, 32, device="cpu")
    module_from_numpy(tm, _tree(variables))
    state0 = np.random.RandomState(3).randn(2, 32).astype(np.float32) * 0.1
    with highest():
        (jr, jf), _ = _apply(jm)(variables, jnp.asarray(x))
        (jr0, jf0), _ = _apply(jm)(variables, jnp.asarray(x),
                                   jnp.asarray(state0))
    tr, tf = tm(torch.from_numpy(x))
    tr0, tf0 = tm(torch.from_numpy(x), torch.from_numpy(state0))
    assert tr.shape == (2, 10, 32) and tf.shape == (2, 32)
    for got, want in ((tr, jr), (tf, jf), (tr0, jr0), (tf0, jf0)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=LAYER_TOL)


def test_layer_constants_follow_flax_distributions():
    """The port's own draws (a torch.Generator) of the constants flax
    draws from PRNGKey(0) and PRNGKey(1)."""
    gen = torch.Generator().manual_seed(0)
    ad = tlayers.AdaptiveSpikingLayer(4, 64, device="cpu", generator=gen)
    inhib = _np(ad.lateral_inhibition)
    assert np.all(np.diag(inhib) == 0)
    off = inhib[~np.eye(64, dtype=bool)]
    assert abs(off.std() - 0.1) < 0.01
    res = tlayers.ReservoirLayer(4, 64, device="cpu", generator=gen)
    W = _np(res.W_rec)
    jW = np.asarray(jax.jit(jlayers.ReservoirLayer(features=64).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 4)))["constants"]["W_rec"])
    assert abs((W != 0).mean() - (jW != 0).mean()) < 0.03   # ~10% kept
    # scaled to spectral radius 0.95 by the power iteration's estimate
    v = np.ones(64) / 8.0
    for _ in range(200):
        v = W @ v
        v /= np.linalg.norm(v)
    assert abs(abs(v @ W @ v) - 0.95) < 0.05


def test_layers_run_and_factory():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 8, generator=gen) * 2
    layer = tlayers.make_layer("spiking", 8, 16, device="cpu", generator=gen)
    spikes, stats = layer(x)
    assert spikes.shape == (2, 4, 16)
    assert 0.0 <= float(stats["firing_rate"]) <= 1.0
    assert isinstance(tlayers.make_layer("reservoir", 8, 8, device="cpu"),
                      tlayers.ReservoirLayer)
    assert isinstance(tlayers.make_layer("adaptive", 8, 8, device="cpu"),
                      tlayers.AdaptiveSpikingLayer)
    with pytest.raises(ValueError):
        tlayers.make_layer("bogus", 8, 8)
    drop = tlayers.SpikingLayer(8, 16, dropout=0.5, deterministic=False,
                                device="cpu", generator=gen)
    a, _ = drop(x, generator=torch.Generator().manual_seed(3))
    b, _ = drop(x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# brain zones
# --------------------------------------------------------------------------

THIRDS = (("lif", 1 / 3), ("izhikevich", 1 / 3), ("adex", 1 / 3))


@pytest.mark.parametrize("kw,B,homeo", [
    # BrainZoneConfig's defaults (128 neurons, 64 -> 64, 4 steps), thirds
    (dict(groups=THIRDS), 8, True),
    # tests/test_zones.py's mixed zone
    (dict(n_neurons=32, input_dim=16, output_dim=8,
          groups=(("lif", 0.5), ("izhikevich", 0.5))), 2, False),
    # its telemetry zone, two steps
    (dict(n_neurons=32, input_dim=16, output_dim=16, timesteps=2,
          groups=(("lif", 0.5), ("izhikevich", 0.5))), 4, True),
    # an uneven split: 20 + 20 + the last group's 24
    (dict(n_neurons=64, input_dim=24, output_dim=12,
          groups=(("izhikevich", 0.33), ("adex", 0.33), ("lif", 0.33))),
     16, False),
])
def test_zone_matches_jax(kw, B, homeo):
    jcfg, tcfg = _configs(**kw)
    jm, params, tm = _zone_pair(jcfg, tcfg, seed=B)
    rng = np.random.RandomState(B)
    x = rng.randn(B, jcfg.input_dim).astype(np.float32)
    h = (rng.randn(jcfg.n_neurons) * 0.3).astype(np.float32) if homeo \
        else None
    with highest():
        jo, jstat = jax.jit(jm.apply)(params, jnp.asarray(x),
                                      None if h is None else jnp.asarray(h))
    to, tstat = tm(torch.from_numpy(x),
                   None if h is None else torch.from_numpy(h))
    assert to.shape == (B, jcfg.output_dim)
    flips, jsp = zone_flips(params, jcfg, tm, x, h)
    # the reconstruction of the JAX zone's spikes is the zone's own
    assert float(jstat["spike_count"]) == jsp.sum()
    assert_rows_match(_np(to), jo, flips.any(axis=(1, 2)))
    n_flip = flips.sum()
    assert abs(float(tstat["spike_count"])
               - float(jstat["spike_count"])) <= n_flip
    assert abs(float(tstat["avg_firing_rate"])
               - float(jstat["avg_firing_rate"])) <= n_flip / jsp.size + 1e-7
    # per neuron: membranes where the neuron's spike train agrees
    # (Izhikevich drifts up to 0.08 mV there, i.e. 0.003 in 30 mV units)
    _, jmem = jax_zone_population(params, jcfg, x, h)
    _, tmem = tm.population(torch.from_numpy(x),
                            None if h is None else torch.from_numpy(h))
    agree = ~flips.any(axis=1)
    np.testing.assert_allclose(_np(tmem)[agree], jmem[agree], rtol=0,
                               atol=0.25 / 30)
    if n_flip == 0 and all(t != "izhikevich" for t, _ in kw["groups"]):
        for key in ("membrane_mean", "membrane_std"):
            np.testing.assert_allclose(float(tstat[key]), float(jstat[key]),
                                       rtol=0, atol=ZONE_TOL)


def test_adex_group_of_the_zone_is_silent_as_in_jax():
    jcfg, tcfg = _configs(n_neurons=48, input_dim=16, output_dim=8,
                          groups=(("adex", 1.0),))
    jm, params, tm = _zone_pair(jcfg, tcfg, seed=5)
    x = np.random.RandomState(5).randn(6, 16).astype(np.float32) * 3
    jo, jstat = jax.jit(jm.apply)(params, jnp.asarray(x))
    to, tstat = tm(torch.from_numpy(x))
    assert float(jstat["spike_count"]) == 0 == float(tstat["spike_count"])
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=0, atol=ZONE_TOL)
    for key in ("membrane_mean", "membrane_std"):
        np.testing.assert_allclose(float(tstat[key]), float(jstat[key]),
                                   rtol=0, atol=ZONE_TOL)


def test_cortical_region_matches_jax():
    """The zone's output within 1e-5; then flax's LayerNorm takes a
    one-pass variance, which cancels on these rows (means ~ -0.3 against
    spreads ~ 0.01), so each package is held to an f64 LayerNorm of the
    JAX zone's output: the port within 1e-5 of it, and the two within
    flax's own error of it."""
    jcfg, tcfg = _configs(n_neurons=64, input_dim=32, output_dim=32,
                          groups=(("lif", 0.5), ("izhikevich", 0.5)))
    jm, params, tm = _zone_pair(jcfg, tcfg, seed=6, cls="region")
    x = np.random.RandomState(6).randn(8, 32).astype(np.float32)
    with highest():
        (jo, jstat), inter = jax.jit(functools.partial(
            jm.apply, capture_intermediates=True,
            mutable=["intermediates"]))(params, jnp.asarray(x))
    jzone = np.asarray(inter["intermediates"]["zone"]["__call__"][0][0])
    to, tstat = tm(torch.from_numpy(x))
    tzone, _ = tm.zone(torch.from_numpy(x))
    zone_params = {"params": params["params"]["zone"]}
    flips, _ = zone_flips(zone_params, jcfg, tm.zone, x)
    rows = flips.any(axis=(1, 2))
    assert_rows_match(_np(tzone), jzone, rows)
    # LayerNorm'd: per-row mean ~ 0
    np.testing.assert_allclose(_np(to).mean(-1), 0.0, atol=1e-4)
    z64 = jzone.astype(np.float64)
    scale = params["params"]["output_norm"]["scale"]
    bias = params["params"]["output_norm"]["bias"]
    ref = ((z64 - z64.mean(-1, keepdims=True))
           / np.sqrt(z64.var(-1, keepdims=True) + 1e-6) * scale + bias)
    keep = ~rows
    port_err = np.abs(_np(to)[keep] - ref[keep]).max()
    flax_err = np.abs(np.asarray(jo)[keep] - ref[keep]).max()
    assert port_err <= ZONE_TOL * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(_np(to)[keep], np.asarray(jo)[keep], rtol=0,
                               atol=flax_err + port_err + ZONE_TOL)


def test_pattern_zone_configs_match_jax():
    assert tz.create_cerebellum() == tz.BrainZoneConfig(**{
        k: getattr(jz.create_cerebellum(), k)
        for k in ("name", "n_neurons", "input_dim", "output_dim",
                  "timesteps")},
        neuron_configs=tuple(tz.SpikingNeuronConfig(**vars(n)) for n in
                             jz.create_cerebellum().neuron_configs))
    jcfg = jz.zone_config_from_pattern("z", "chattering", 24, 8, 8, 3)
    tcfg = tz.zone_config_from_pattern("z", "chattering", 24, 8, 8, 3)
    assert vars(tcfg.neuron_configs[0]) == vars(jcfg.neuron_configs[0])
    jm, params, tm = _zone_pair(jcfg, tcfg, seed=7)
    x = np.random.RandomState(7).randn(4, 8).astype(np.float32)
    jo, _ = jax.jit(jm.apply)(params, jnp.asarray(x))
    to, _ = tm(torch.from_numpy(x))
    flips, _ = zone_flips(params, jcfg, tm, x)
    assert_rows_match(_np(to), jo, flips.any(axis=(1, 2)))


def test_zone_init_and_gradients():
    cfg = tz.BrainZoneConfig(n_neurons=32, input_dim=16, output_dim=8)
    zone = tz.NeuromorphicBrainZone(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    w = _np(zone.input_proj.weight_patterns)
    assert w.shape == (32, 16) and 0 <= w.min() and w.max() < 0.2
    out, stats = zone(torch.randn(3, 16))
    out.sum().backward()
    assert zone.output_proj.weight_patterns.grad.abs().sum() > 0
    assert set(stats) == {"avg_firing_rate", "spike_count", "membrane_mean",
                          "membrane_std"}


# --------------------------------------------------------------------------
# routing, the processor and plasticity
# --------------------------------------------------------------------------

TEXTS = ("please remember this memory", "calculate the statistics",
         "analyze the visual pattern and recall the timeline",
         "I feel happy, let us create art", "", "nothing routes here",
         "grammar syntax semantic word word")
ZONES = (("prefrontal_cortex", {"reasoning", "planning"}),
         ("temporal_cortex", {"language", "audio"}),
         ("hippocampus", {"memory"}),
         ("parietal_cortex", {"spatial", "integration"}),
         ("occipital_cortex", {"visual"}),
         ("cerebellum", {"timing", "coordination"}),
         ("amygdala", {"emotion"}),
         ("insular_cortex", {"interoception"}))


def test_keyword_routing_matches_jax():
    jr, tr = jproc.ContentRouter(), tproc.ContentRouter()
    for text in TEXTS:
        assert tr.route_text_to_zones(text) == jr.route_text_to_zones(text)
        assert {k.value: v for k, v in tr.analyze_content(text).items()} \
            == {k.value: v for k, v in jr.analyze_content(text).items()}
    zones = tr.route_text_to_zones("please remember this memory")
    assert zones[0] in ("hippocampus", "temporal_cortex")
    assert "prefrontal_cortex" in tr.route_text_to_zones(
        "calculate the statistics")


def test_external_lexicon_matches_jax(tmp_path):
    d = tmp_path / "lex"
    d.mkdir()
    (d / "emotion_words.txt").write_text("joyful tearful")
    (d / "memory_terms.jsonl").write_text(
        '{"w": "reminisce nostalgia", "n": 3}\nnot json\n')
    (d / "pattern_list.csv").write_text("spiral,grid lattice\n")
    (d / "misc.txt").write_text("ignored words")
    jr, tr = jproc.ContentRouter(), tproc.ContentRouter()
    assert tr.load_lexicon_dir(str(d)) == jr.load_lexicon_dir(str(d)) == 7
    assert tr.external_lexicon == jr.external_lexicon
    assert tr.route_text_to_zones("joyful day")[0] == "amygdala"
    assert tr.load_lexicon_dir(str(tmp_path / "missing")) == 0


def _processors(jforward=None, tforward=None, **kw):
    jp = jproc.NeuromorphicProcessor(d_model=8, **kw)
    tp = tproc.NeuromorphicProcessor(d_model=8, device="cpu", **kw)
    for name, caps in ZONES:
        jp.register_zone(name, jforward or (lambda x: (x, {})), caps)
        tp.register_zone(name, tforward or (lambda x: (x, {})), caps)
    return jp, tp


@pytest.mark.parametrize("intents", [None, ["memory", "visual"],
                                     ["reasoning", "emotion", "timing"]])
@pytest.mark.parametrize("top_k", [3, 1, 0])
def test_processor_plan_matches_jax(intents, top_k):
    jp, tp = _processors()
    for text in TEXTS:
        want = jp.build_plan(text, intents, top_k)
        got = tp.build_plan(text, intents, top_k)
        assert [z for z, _ in got] == [z for z, _ in want]
        assert [float(w) for _, w in got] == [float(w) for _, w in want]


def test_processor_runs_converted_zones_like_jax():
    """Each registered zone a small LIF zone with converted weights; the
    weighted sums within 1e-5 where every zone's spikes agree."""
    jcfg, tcfg = _configs(n_neurons=24, input_dim=8, output_dim=8)
    jp = jproc.NeuromorphicProcessor(d_model=8)
    tp = tproc.NeuromorphicProcessor(d_model=8, device="cpu")
    zones = {}
    for i, (name, caps) in enumerate(ZONES):
        jm, params, tm = _zone_pair(jcfg, tcfg, seed=10 + i)
        zones[name] = (params, tm)
        jp.register_zone(name, functools.partial(jax.jit(jm.apply), params),
                         caps)
        tp.register_zone(name, tm, caps)
    rng = np.random.RandomState(11)
    for text in TEXTS:
        x = rng.randn(2, 8).astype(np.float32)
        with highest():
            jo, jinfo = jp.run_plan(jnp.asarray(x), text)
        to, tinfo = tp.run_plan(torch.from_numpy(x), text)
        assert [z for z, _ in tinfo["plan"]] == [z for z, _ in jinfo["plan"]]
        flipped = np.zeros(2, bool)
        for zone, _ in tinfo["plan"]:
            params, tm = zones[zone]
            flips, _ = zone_flips(params, jcfg, tm, x)
            flipped |= flips.any(axis=(1, 2))
        assert_rows_match(_np(to), jo, flipped)
    assert tp.stats == jp.stats
    assert tp.get_recommendations() == jp.get_recommendations()


@pytest.mark.parametrize("mode", ["liquid", "topk"])
def test_processor_liquid_modes_match_jax(mode):
    """The liquid router's weights come from JAX's PRNGKey(0) in the JAX
    package; the port's processor takes the converted router."""
    jp, tp = _processors(router_mode=mode)
    rng = np.random.RandomState(12)
    embs = rng.randn(4, 8).astype(np.float32)
    want = [jp.build_plan(embedding=e, top_k=3) for e in embs]
    router = LiquidMoERouter(8, 64, len(ZONES), top_k=3, device="cpu")
    module_from_numpy(router, _tree(jp._liquid_params))
    tp.set_liquid_router(router)
    for e, w in zip(embs, want):
        got = tp.build_plan(embedding=e, top_k=3)
        assert [z for z, _ in got] == [z for z, _ in w]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in w],
                                   rtol=0, atol=1e-6)
    # without a router set, the port builds its own from a seeded generator
    own = tproc.NeuromorphicProcessor(d_model=8, router_mode=mode,
                                      device="cpu")
    own.register_zone("a", lambda x: (x, {}))
    own.register_zone("b", lambda x: (x * 2, {}))
    plan = own.build_plan(embedding=np.ones(8, np.float32), top_k=2)
    assert len(plan) == 2
    with pytest.raises(ValueError):
        own.set_router_mode("bogus")


def test_zone_failures_are_counted_and_skipped():
    tp = tproc.NeuromorphicProcessor(d_model=4, device="cpu")

    def bad(x):
        raise RuntimeError("boom")
    tp.register_zone("prefrontal_cortex", bad)
    tp.register_zone("hippocampus", lambda x: (x, {}))
    out, _ = tp.run_plan(torch.ones(1, 4), "remember analyze")
    assert tp.stats["errors"] == 1
    assert torch.isfinite(out).all()
    # every zone failing: zeros like the input, as in the JAX package
    only_bad = tproc.NeuromorphicProcessor(d_model=4, device="cpu")
    only_bad.register_zone("hippocampus", bad)
    out, info = only_bad.run_plan(torch.ones(2, 4), "remember")
    assert torch.equal(out, torch.zeros(2, 4))
    assert only_bad.stats["errors"] == 1 and info["zone_stats"] == {}
    assert any("failures" in r for r in only_bad.get_recommendations())


def test_plasticity_engine_matches_jax():
    jb, tb = jproc.EventBus(), tproc.EventBus()
    je = jproc.NeuralPlasticityEngine(target_rate=0.1, nudge=0.1,
                                      event_bus=jb)
    te = tproc.NeuralPlasticityEngine(target_rate=0.1, nudge=0.1,
                                      event_bus=tb)
    for e in (je, te):
        e.register_zone("z", 4)
    bias = te.update("z", firing_rate=0.0)               # silent: up
    assert (bias > 0).all()
    bias = te.update("z", firing_rate=0.9)               # saturated: down
    assert (bias < 0.01).all()
    je.update("z", 0.0)
    je.update("z", 0.9)
    for bus in (jb, tb):
        bus.emit("brain_stats_updated",
                 firing_rates={"z": 0.3, "new": 0.01})
    assert set(te.homeo_i) == set(je.homeo_i) == {"z", "new"}
    for zone in te.homeo_i:
        np.testing.assert_array_equal(te.homeo_i[zone], je.homeo_i[zone])


def test_processor_feeds_collector():
    collector = tstats.StatsCollector()
    tp = tproc.NeuromorphicProcessor(d_model=8, stats_collector=collector,
                                     device="cpu")
    tp.register_zone("language", lambda x: (x, {
        "avg_firing_rate": torch.tensor(0.12), "membrane_mean": 0.01,
        "membrane_std": 0.2}))
    tp.run_plan(torch.ones(2, 8), text="hello words")
    assert collector.current.zone_firing_rates.get("language") == \
        pytest.approx(0.12)
    assert "language_mean" in collector.current.membrane_stats
    jc = jstats.StatsCollector()
    jc.update_zone_activity("language", {"avg_firing_rate": 0.12,
                                         "membrane_mean": 0.01,
                                         "membrane_std": 0.2})
    assert jc.current.membrane_stats == collector.current.membrane_stats


# --------------------------------------------------------------------------
# neuron factory and multi-modal adapters
# --------------------------------------------------------------------------

def test_neuron_factory_matches_jax_in_one_process():
    jf, tf = jnf.NeuronFactory(), tnf.NeuronFactory()
    jpop = jf.create_population(5, "lif", n_inputs=4)
    tpop = tf.create_population(5, "lif", n_inputs=4)
    tf.create("izhikevich", 3)
    jf.create("izhikevich", 3)
    assert tf.stats() == jf.stats() == {"total": 6, "lif": 5,
                                        "izhikevich": 1}
    x = np.random.RandomState(13).randn(4).astype(np.float32) * 3
    for jn_, tn_ in zip(jpop, tpop):
        np.testing.assert_array_equal(tn_.weights, jn_.weights)
        for _ in range(3):
            assert tn_.stimulate(x) == jn_.stimulate(x)
        assert tn_.state.fatigue == jn_.state.fatigue
    n = tf.create("lif", 4)
    assert n.state.maturation == tnf.MaturationStage.IMMATURE
    n.mature()
    assert n.state.maturation == tnf.MaturationStage.MATURE


def test_multimodal_matches_jax():
    zones = ("prefrontal_cortex", "occipital_cortex", "temporal_cortex",
             "hippocampus", "cerebellum", "parietal_cortex")
    jp = jproc.NeuromorphicProcessor(d_model=16)
    tp = tproc.NeuromorphicProcessor(d_model=16, device="cpu")
    for z in zones:
        jp.register_zone(z, lambda x: (x, {}))
        tp.register_zone(z, lambda x: (x, {}))
    jm, tm = jmm.MultiModalProcessor(jp), tmm.MultiModalProcessor(tp)
    image = np.random.RandomState(14).rand(8, 8)
    wave = np.sin(np.linspace(0, 50, 400))
    for name, arg in (("process_text", "remember the pattern"),
                      ("process_image", image), ("process_audio", wave)):
        jo, jinfo = getattr(jm, name)(arg)
        to, tinfo = getattr(tm, name)(arg)
        assert tinfo["plan"] == jinfo["plan"]
        assert torch.isfinite(to).all()
        np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=0,
                                   atol=1e-6)
        if name == "process_image":
            assert any(z in ("occipital_cortex", "parietal_cortex")
                       for z, _ in tinfo["plan"])


def test_event_driven_boost_matches_jax():
    jp = jproc.NeuromorphicProcessor(d_model=16)
    tp = tproc.NeuromorphicProcessor(d_model=16, device="cpu")
    for z in ("prefrontal_cortex", "parietal_cortex"):
        jp.register_zone(z, lambda x: (x, {}))
        tp.register_zone(z, lambda x: (x, {}))
    jed, ted = jmm.EventDrivenProcessor(jp), tmm.EventDrivenProcessor(tp)
    for _ in range(2):
        jed.process(jnp.ones((1, 16)), "analyze this")
        ted.process(torch.ones(1, 16), "analyze this")
    tp.event_bus.emit("content_processed")
    jp.event_bus.emit("content_processed")
    _, info = ted.process(torch.ones(1, 16), "analyze this")
    jed.process(jnp.ones((1, 16)), "analyze this")
    assert ted.zone_boost == jed.zone_boost
    assert any(v > 1.0 for v in info["zone_boost"].values())
