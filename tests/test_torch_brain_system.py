"""The port's brain orchestration and brain-system facade against the JAX
package's (mirrors of tests/models/test_brain.py's TestEnhancedBrain,
TestLiquidBrain, TestCNS, TestInterpolator, TestSpecialists and
TestBrainSystem): `EnhancedBrain` and `NeuromorphicBrainSystem` from the
same converted zone parameters (`models/convert.module_from_numpy`,
`load_brain_system`), `LiquidBrain`'s error trajectory from the same Oja
state (`load_liquid_brain`), and the CLI's `brain-demo`. Zone outputs
are compared within 1e-5 on the rows where every spike agrees
(`tests/test_torch_common.zone_flips`); plans must be equal zone for
zone and weight for weight. JAX runs under
`jax.default_matmul_precision("highest")`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from aura_snn_rag_tpu import cli as jcli
from aura_snn_rag_tpu.models.brain import brain as jbrain
from aura_snn_rag_tpu.models.brain import specialist as jspec
from aura_snn_rag_tpu.services import brain_system as jbs
from aura_snn_rag_tpu.services import continuous_learning as jcl
from aura_snn_rag_tpu.zones import brain_zone as jz
from aura_snn_rag_tpu_torch import cli as tcli
from aura_snn_rag_tpu_torch.models.brain import brain as tbrain
from aura_snn_rag_tpu_torch.models.brain import specialist as tspec
from aura_snn_rag_tpu_torch.models.convert import (
    load_brain_system, load_liquid_brain, module_from_numpy)
from aura_snn_rag_tpu_torch.services import brain_system as tbs
from aura_snn_rag_tpu_torch.services import continuous_learning as tcl
from aura_snn_rag_tpu_torch.zones import brain_zone as tz
from aura_snn_rag_tpu_torch.zones.processor import NeuralPlasticityEngine
from aura_snn_rag_tpu_torch.zones.stats import StatsCollector
from tests.test_torch_common import assert_rows_match, highest, zone_flips

torch.set_num_threads(1)

# LiquidBrain: f32 whitening and Oja products summed in another order
# feed the NLMS experts' numpy updates; the errors stay within 1e-4 over
# 40 steps
LIQUID_TOL = 1e-4
TEXTS = ("remember to analyze the pattern", "I feel sad and afraid",
         "calculate the statistical timeline", "create a novel design",
         "nothing routes here", "recall the grammar of the past")


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


# --------------------------------------------------------------------------
# EnhancedBrain
# --------------------------------------------------------------------------

@pytest.mark.parametrize("names,d,B,top_k", [
    (("a", "b", "c"), 16, 2, 2),
    (tuple(name for name, _ in tbs.DEFAULT_ZONES), 32, 6, 2),
])
def test_enhanced_brain_matches_jax(names, d, B, top_k):
    jcfgs = tuple(jz.BrainZoneConfig(name=n, n_neurons=16, input_dim=d,
                                     output_dim=d) for n in names)
    tcfgs = tuple(tz.BrainZoneConfig(name=n, n_neurons=16, input_dim=d,
                                     output_dim=d) for n in names)
    jm = jbrain.EnhancedBrain(jcfgs, d_model=d, top_k=top_k)
    x = np.random.RandomState(B).randn(B, d).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(B), jnp.zeros((1, d)))
    tm = tbrain.EnhancedBrain(tcfgs, d_model=d, top_k=top_k, device="cpu")
    module_from_numpy(tm, jax.tree.map(np.asarray, params))
    with highest():
        jo, jinfo = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        to, tinfo = tm(torch.from_numpy(x))
    assert to.shape == (B, d)
    assert set(tinfo["zone_stats"]) == set(names)
    np.testing.assert_array_equal(_np(tinfo["routing"]["indices"]),
                                  np.asarray(jinfo["routing"]["indices"]))
    np.testing.assert_allclose(_np(tinfo["routing"]["weights"]),
                               np.asarray(jinfo["routing"]["weights"]),
                               rtol=0, atol=1e-6)
    flipped = np.zeros(B, bool)
    for jc in jcfgs:
        zone_params = {"params": params["params"][f"zone_{jc.name}"]}
        flips, _ = zone_flips(zone_params, jc,
                              getattr(tm, f"zone_{jc.name}"), x)
        flipped |= flips.any(axis=(1, 2))
    assert_rows_match(_np(to), jo, flipped)


def test_enhanced_brain_alias_and_own_init():
    assert tbrain.Brain is tbrain.EnhancedBrain
    cfgs = tuple(tz.BrainZoneConfig(name=n, n_neurons=16, input_dim=16,
                                    output_dim=16) for n in "abc")
    brain = tbrain.EnhancedBrain(cfgs, d_model=16, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    out, info = brain(torch.randn(2, 16))
    assert out.shape == (2, 16) and torch.isfinite(out).all()
    assert set(info["zone_stats"]) == {"a", "b", "c"}


# --------------------------------------------------------------------------
# LiquidBrain, CNS, interpolator, specialists
# --------------------------------------------------------------------------

def test_liquid_brain_error_trajectory_matches_jax():
    jlb = jbrain.LiquidBrain(input_dim=64, n_components=8, max_components=32,
                             n_experts=2)
    tlb = tbrain.LiquidBrain(input_dim=64, n_components=8, max_components=32,
                             n_experts=2, device="cpu")
    load_liquid_brain(tlb, jax.tree.map(np.asarray, jlb.whitener),
                      jax.tree.map(np.asarray, jlb.hippocampus), jlb.cortex)
    jerr, terr = [], []
    with highest():
        for i in range(40):
            text, target = f"sample text number {i % 4}", float(i % 4)
            jr = jlb.learn_text(text, target)
            tr = tlb.learn_text(text, target)
            assert (tr["expert"], tr["K"], tr["consciousness"]) == \
                (jr["expert"], jr["K"], jr["consciousness"])
            jerr.append(jr["error"])
            terr.append(tr["error"])
        jp = jlb.predict_text("sample text number 2")
    np.testing.assert_allclose(terr, jerr, rtol=0, atol=LIQUID_TOL)
    assert abs(tlb.predict_text("sample text number 2") - jp) <= LIQUID_TOL
    errs = np.abs(terr)
    assert np.mean(errs[-10:]) < np.mean(errs[:10])
    assert tr["consciousness"] in ("calm", "alert", "stressed", "overwhelmed")


def test_liquid_brain_own_init_learns():
    lb = tbrain.LiquidBrain(input_dim=64, n_components=8, max_components=32,
                            n_experts=2, device="cpu")
    assert lb.hippocampus.W.shape == (64, 32)
    errs = [abs(lb.learn_text(f"sample text number {i % 4}",
                              float(i % 4))["error"]) for i in range(40)]
    assert np.mean(errs[-10:]) < np.mean(errs[:10])


def test_cns_matches_jax():
    jc, tc = (jbrain.CentralNervousSystem(stress_alpha=0.5),
              tbrain.CentralNervousSystem(stress_alpha=0.5))
    for err in [5.0] * 10 + [0.0] * 20 + [-30.0, 0.3, 0.05]:
        assert tc.update(err) == jc.update(err)
        assert tc.consciousness == jc.consciousness
    cns = tbrain.CentralNervousSystem(stress_alpha=0.5)
    for _ in range(10):
        h = cns.update(5.0)
    assert cns.consciousness in ("stressed", "overwhelmed")
    assert h["cortisol"] > 0
    for _ in range(20):
        cns.update(0.0)
    assert cns.consciousness in ("calm", "alert")


def test_interpolator_matches_jax():
    ji, ti = jbrain.TemporalMemoryInterpolator(), \
        tbrain.TemporalMemoryInterpolator()
    a = np.sin(np.linspace(0, 4, 64)).astype(np.float32)
    b = np.cos(np.linspace(0, 4, 64)).astype(np.float32)
    assert ti.MODES == ji.MODES
    for mode in ti.MODES:
        for t in (0.0, 0.3, 1.0):
            out = ti.interpolate(a, b, t, mode)
            assert out.shape == (64,) and np.all(np.isfinite(out))
            np.testing.assert_array_equal(out, ji.interpolate(a, b, t, mode))
    np.testing.assert_allclose(ti.interpolate(a, b, 0.0, "linear"), a)
    np.testing.assert_allclose(ti.interpolate(a, b, 1.0, "linear"), b)
    with pytest.raises(ValueError):
        ti.interpolate(a, b, 0.5, "bogus")


def test_specialists_match_jax():
    assert tspec.slugify("Quantum Physics!") == "quantum-physics" == \
        jspec.slugify("Quantum Physics!")
    assert tspec.slugify("!!!") == jspec.slugify("!!!") == "topic"
    treg, jreg = tspec.SpecialistRegistry(in_dim=4), \
        jspec.SpecialistRegistry(in_dim=4)
    for reg in (treg, jreg):
        reg.ensure_from_topics(["Math", "History", "Math"])
    assert len(treg) == 2 and "math" in treg
    assert treg.topics() == jreg.topics()
    rng = np.random.RandomState(0)
    w = rng.randn(4).astype(np.float32)
    for _ in range(300):
        x = rng.randn(4).astype(np.float32)
        for reg in (treg, jreg):
            reg.get("math").update(x, float(w @ x))
    x = rng.randn(4).astype(np.float32)
    assert treg.get("math").predict(x) == jreg.get("math").predict(x)
    assert abs(treg.get("math").predict(x) - w @ x) < 0.5
    assert treg.best_for(x).topic == jreg.best_for(x).topic == "Math"
    assert treg.get("math").rmse == jreg.get("math").rmse
    assert tspec.SpecialistRegistry(4).best_for(x) is None


def test_crisis_repair_matches_jax():
    eng = NeuralPlasticityEngine()
    sc = StatsCollector()
    sc.update_firing_rates({"hot": 0.9, "ok": 0.1, "silent": 0.0})
    sc.commit(0)
    result = tbrain.fix_neuromorphic_crisis(eng, sc)
    assert result["repaired_zones"] == ["hot", "silent"]
    assert (eng.homeo_i["hot"] < 0).all() and (eng.homeo_i["silent"] > 0).all()


# --------------------------------------------------------------------------
# the brain system
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def systems():
    """A JAX system and a port system holding its zones and biases; the
    tests below drive both with the same calls, so they stay in step."""
    jsys = jbs.NeuromorphicBrainSystem(d_model=32, n_neurons=16)
    tsys = tbs.NeuromorphicBrainSystem(d_model=32, n_neurons=16,
                                       device="cpu")
    load_brain_system(tsys, jax.tree.map(np.asarray, jsys._zone_params),
                      jsys.plasticity.homeo_i)
    return jsys, tsys


def _assert_outputs_match(jsys, tsys, x, jo, jinfo, to, tinfo):
    assert [z for z, _ in tinfo["plan"]] == [z for z, _ in jinfo["plan"]]
    assert [float(w) for _, w in tinfo["plan"]] == \
        [float(w) for _, w in jinfo["plan"]]
    flipped = np.zeros(1, bool)
    for zone, _ in tinfo["plan"]:
        flips, _ = zone_flips(
            jsys._zone_params[zone], jsys._zone_modules[zone].config,
            tsys._zone_modules[zone], x, jsys.plasticity.homeo_i[zone])
        flipped |= flips.any(axis=(1, 2))
        if not flips.any():
            assert float(tinfo["zone_stats"][zone]["avg_firing_rate"]) == \
                pytest.approx(float(jinfo["zone_stats"][zone]
                                    ["avg_firing_rate"]), abs=1e-7)
    assert torch.isfinite(to).all()
    assert_rows_match(_np(to), jo, flipped)


def test_brain_system_texts_match_jax(systems):
    jsys, tsys = systems
    assert [n for n, _ in tbs.DEFAULT_ZONES] == \
        [n for n, _ in jbs.DEFAULT_ZONES]
    for text in TEXTS:
        x = tsys.orchestrator.hash_embedder.embed(text)[:32]
        with highest():
            jo, jinfo = jsys.process_text(text)
        to, tinfo = tsys.process_text(text)
        assert to.shape == (1, 32)
        _assert_outputs_match(jsys, tsys, x, jo, jinfo, to, tinfo)
    assert tsys.processor.stats == jsys.processor.stats
    assert tsys.processor.stats["errors"] == 0
    assert tsys.stats.current.zone_firing_rates.keys() == \
        jsys.stats.current.zone_firing_rates.keys()
    th, jh = tsys.get_health(), jsys.get_health()
    assert th["zones"] == jh["zones"] and len(th["zones"]) == 8
    assert th["memory_count"] == jh["memory_count"] == 0
    assert th["processor_stats"] == jh["processor_stats"]
    assert th["recommendations"] == jh["recommendations"]


def test_brain_system_bias_and_orchestrator_match_jax(systems):
    """Nonzero homeostatic biases (the event bus's stats update), then an
    orchestrator batch through each system's zone executor."""
    jsys, tsys = systems
    rates = {name: 0.05 * i for i, (name, _) in enumerate(jbs.DEFAULT_ZONES)}
    for sys_ in (jsys, tsys):
        sys_.event_bus.emit("brain_stats_updated", firing_rates=rates)
    for name in tsys.plasticity.homeo_i:
        np.testing.assert_array_equal(tsys.plasticity.homeo_i[name],
                                      jsys.plasticity.homeo_i[name])
    outs = {}
    for key, sys_ in (("jax", jsys), ("port", tsys)):
        outs[key] = []
        inner = sys_.orchestrator.zone_executor

        def capture(features, category, inner=inner, seen=outs[key]):
            seen.append((np.array(features), inner(features, category)))
            return seen[-1][1]
        sys_.orchestrator.zone_executor = capture
    items = [("the history of memory", "memory"),
             ("a happy tune", "emotion"), ("solve it", "calculate"),
             ("an image of a cat", "visual pattern"),
             ("news of the day", "general")]
    with highest():
        jsys.orchestrator.process_batch([jcl.IngestItem(t, c)
                                         for t, c in items])
    tsys.orchestrator.process_batch([tcl.IngestItem(t, c)
                                     for t, c in items])
    assert len(outs["port"]) == len(outs["jax"]) == len(items)
    for (x, (to, tinfo)), (jx, (jo, jinfo)) in zip(outs["port"],
                                                   outs["jax"]):
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-6)
        _assert_outputs_match(jsys, tsys, x, jo, jinfo, to, tinfo)
    assert tsys.orchestrator.stats == jsys.orchestrator.stats
    assert tsys.processor.stats == jsys.processor.stats
    assert tsys.processor.stats["errors"] == 0
    assert tsys.hippocampus.memory_count == 0          # zones, not memory


def test_brain_system_own_init():
    sys_ = tbs.NeuromorphicBrainSystem(d_model=32, n_neurons=16,
                                       device="cpu")
    out, info = sys_.process_text("remember to analyze the pattern")
    assert torch.isfinite(out).all() and len(info["plan"]) >= 1
    health = sys_.get_health()
    assert health["memory_count"] == 0 and len(health["zones"]) == 8
    with pytest.raises(KeyError):
        load_brain_system(sys_, {"prefrontal_cortex": {}})


def test_brain_demo_prints_the_jax_plan(capsys):
    lines = tcli.brain_demo("remember to analyze this pattern",
                            device="cpu")
    assert capsys.readouterr().out.splitlines() == lines
    assert tcli.main(["brain-demo", "I feel sad", "--device", "cpu"]) == 0
    sad = capsys.readouterr().out.splitlines()
    result = CliRunner().invoke(jcli.main, ["brain-demo"])
    assert result.exit_code == 0, result.output
    jlines = result.output.splitlines()[-3:]
    assert lines[0] == jlines[0]
    assert lines[0] == ("plan: [('prefrontal_cortex', 0.2), "
                        "('hippocampus', 0.2), ('temporal_cortex', 0.2)]")
    assert lines[1].startswith("output norm: ")
    assert lines[2] == jlines[2]
    assert sad[0] == "plan: [('amygdala', 0.5), ('insular_cortex', 0.5)]"


def test_brain_entry_points_default_to_cuda():
    """Without a card every entry point raises unless given the CPU; the
    zone forwards run on their module's device."""
    from aura_snn_rag_tpu_torch.zones import layers as tlayers
    from aura_snn_rag_tpu_torch.zones.processor import NeuromorphicProcessor
    cfg = tz.BrainZoneConfig(n_neurons=8, input_dim=4, output_dim=4)
    makers = (lambda: tbs.NeuromorphicBrainSystem(d_model=8, n_neurons=8),
              lambda: tz.NeuromorphicBrainZone(cfg),
              lambda: tz.CorticalRegion(cfg),
              lambda: tbrain.EnhancedBrain((cfg,), d_model=4),
              lambda: tbrain.LiquidBrain(input_dim=8, n_components=2,
                                         max_components=4),
              lambda: NeuromorphicProcessor(d_model=4),
              lambda: tlayers.SpikingLayer(4, 4),
              lambda: tlayers.ReservoirLayer(4, 4))
    if torch.cuda.is_available():
        assert tz.NeuromorphicBrainZone(cfg).input_proj.weight_patterns \
            .is_cuda
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["brain-demo"])
