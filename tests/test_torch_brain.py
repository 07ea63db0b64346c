"""The trainer's modulators and telemetry against the JAX package's: the
amygdala and `build_prosody`, the liquid cell and router, the thalamus
(flax initialises the weights, `models/convert.module_from_numpy` carries
them across), the endocrine system's trajectory, the UCB bandit, the
event bus and the stats collector. JAX runs under
`jax.default_matmul_precision("highest")`; f32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.models.brain import amygdala as jamy
from aura_snn_rag_tpu.models.brain import endocrine as jendo
from aura_snn_rag_tpu.models.brain import liquid_moe as jliquid
from aura_snn_rag_tpu.models.brain import thalamus as jthal
from aura_snn_rag_tpu.zones import events as jevents
from aura_snn_rag_tpu.zones import stats as jstats
from aura_snn_rag_tpu_torch.models import brain as tbrain
from aura_snn_rag_tpu_torch.models.brain import liquid_moe as tliquid
from aura_snn_rag_tpu_torch.models.convert import module_from_numpy
from aura_snn_rag_tpu_torch.zones import events as tevents
from aura_snn_rag_tpu_torch.zones import stats as tstats
from tests.test_torch_common import highest

torch.set_num_threads(1)

TOL = 2e-6        # f32 products and means summed in another order


def _carry(jmod, tmod, *example, seed=0):
    params = jmod.init(jax.random.PRNGKey(seed), *example)
    module_from_numpy(tmod, jax.tree.map(np.asarray, params))
    return params


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def test_amygdala_and_prosody_match():
    x = np.random.RandomState(0).randn(3, 5, 32).astype(np.float32)
    jm, tm = jamy.Amygdala(32), tbrain.Amygdala(32)
    params = _carry(jm, tm, jnp.zeros((1, 4, 32)))
    with highest():
        jo = jm.apply(params, jnp.asarray(x))
        jp = jamy.build_prosody(jo["arousal"], jo["valence"], 3, 5)
    to = tm(torch.from_numpy(x))
    tp = tbrain.build_prosody(to["arousal"], to["valence"], 3, 5)
    for key in ("arousal", "valence"):
        assert to[key].shape == ()
        np.testing.assert_allclose(_np(to[key]), np.asarray(jo[key]),
                                   rtol=0, atol=TOL)
    assert tp.shape == (3, 5, 4)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=0, atol=TOL)


def test_amygdala_init_distribution_matches_flax():
    """flax's defaults: lecun_normal kernels, zero biases."""
    tm = tbrain.Amygdala(768)
    from aura_snn_rag_tpu_torch.models.layers import initialize
    initialize(tm, torch.Generator().manual_seed(0))
    params = jamy.Amygdala(768).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 4, 768)))["params"]
    jk = np.asarray(params["fc1"]["kernel"])
    tk = _np(tm.fc1.weight)
    assert abs(tk.std() - jk.std()) / jk.std() < 0.02
    assert not tm.fc1.bias.any()


@pytest.mark.parametrize("with_gain", [True, False])
def test_liquid_router_matches(with_gain):
    rng = np.random.RandomState(1)
    x = rng.randn(6, 24).astype(np.float32)
    gain = rng.rand(6).astype(np.float32) if with_gain else None
    jm = jliquid.LiquidMoERouter(16, 5, top_k=2)
    tm = tbrain.LiquidMoERouter(24, 16, 5, top_k=2)
    params = _carry(jm, tm, jnp.zeros((2, 24)))
    with highest():
        jo = jm.apply(params, jnp.asarray(x),
                      attn_gain=None if gain is None else jnp.asarray(gain))
    to = tm(torch.from_numpy(x),
            attn_gain=None if gain is None else torch.from_numpy(gain))
    np.testing.assert_allclose(_np(to["probs"]), np.asarray(jo["probs"]),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(_np(to["indices"]),
                                  np.asarray(jo["indices"]))
    np.testing.assert_allclose(_np(to["weights"]), np.asarray(jo["weights"]),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(to["usage"]), np.asarray(jo["usage"]),
                               rtol=0, atol=0)


def test_liquid_cell_with_state_matches():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 12).astype(np.float32)
    h = rng.randn(4, 8).astype(np.float32)
    jm, tm = jliquid.LiquidCell(8), tbrain.LiquidCell(12, 8)
    params = _carry(jm, tm, jnp.zeros((1, 12)))
    with highest():
        want = jm.apply(params, jnp.asarray(x), jnp.asarray(h))
    got = tm(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
    # xavier_uniform kernels: |w| <= sqrt(6 / (fan_in + fan_out))
    from aura_snn_rag_tpu_torch.models.layers import initialize
    initialize(tm, torch.Generator().manual_seed(0))
    assert tm.V.weight.abs().max() <= np.sqrt(6 / 20)


@pytest.mark.parametrize("regions,top_k,arousal", [
    (("language",), 1, 0.7),          # the trainer's wiring
    (("a", "b", "c", "d"), 2, 0.3),
    (("a", "b", "c"), 3, None),
])
def test_thalamus_matches(regions, top_k, arousal):
    x = np.random.RandomState(3).randn(2, 7, 32).astype(np.float32)
    jm = jthal.Thalamus(32, regions, top_k=top_k)
    tm = tbrain.Thalamus(32, regions, top_k=top_k)
    params = _carry(jm, tm, jnp.zeros((1, 4, 32)))
    limbic = None if arousal is None else {"arousal": arousal}
    with highest():
        jr, jroute = jm.apply(params, jnp.asarray(x), None if limbic is None
                              else {"arousal": jnp.float32(arousal)})
    tr, troute = tm(torch.from_numpy(x), None if limbic is None
                    else {"arousal": torch.tensor(arousal)})
    assert list(tr) == list(regions)
    for name in regions:
        np.testing.assert_allclose(_np(tr[name]), np.asarray(jr[name]),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(troute["probs"]),
                               np.asarray(jroute["probs"]), rtol=0, atol=TOL)


def test_endocrine_trajectory_matches():
    je, te = jendo.EndocrineSystem(), tbrain.EndocrineSystem()
    rng = np.random.RandomState(4)
    for _ in range(60):
        m = {"accuracy": float(rng.rand()), "gate_diversity": float(
            rng.rand()), "energy": float(rng.rand())}
        jl, tl = je.step(m), te.step(m)
        assert jl == tl
        assert (tbrain.EndocrineSystem.lr_scale(tl)
                == jendo.EndocrineSystem.lr_scale(jl))
        assert (tbrain.EndocrineSystem.memory_gate(tl)
                == jendo.EndocrineSystem.memory_gate(jl))
    assert vars(te.metrics) == vars(je.metrics)


def test_bandit_gating_matches():
    jb, tb = jliquid.BanditGating(6, 0.3), tliquid.BanditGating(6, 0.3)
    rng = np.random.RandomState(5)
    base = rng.rand(6)
    for _ in range(25):
        e, err = int(rng.randint(6)), float(rng.rand() * 12)
        jb.update(e, err)
        tb.update(e, err)
        jt, jg = jb.select_top_k(3, base)
        tt, tg = tb.select_top_k(3, base)
        assert jt == tt
        np.testing.assert_array_equal(tg, jg)


def test_event_bus_matches():
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", jevents), ("port", tevents)):
        bus = mod.EventBus()

        def ok(ev, key=key):
            seen[key].append((ev.type, ev.source, ev.data))

        def bad(ev):
            raise RuntimeError("handler fails")
        bus.subscribe("brain_stats_updated", ok)
        bus.subscribe("brain_stats_updated", bad)
        bus.emit("brain_stats_updated", source="trainer", step=3, loss=1.5)
        bus.unsubscribe("brain_stats_updated", bad)
        bus.unsubscribe("brain_stats_updated", bad)     # absent: no error
        bus.emit("brain_stats_updated", source="t", step=4)
        bus.emit("neuron_fired", source="z")
        seen[key].append((bus.published_count, bus.error_count))
    assert seen["port"] == seen["jax"]
    assert seen["port"][-1] == (3, 1)
    assert tevents.EVENT_TYPES == jevents.EVENT_TYPES


def test_stats_collector_snapshot_matches(tmp_path):
    rng = np.random.RandomState(6)
    tree = {"params": {"zone": {"slope": rng.rand(5).astype(np.float32),
                                "w": rng.randn(3, 2).astype(np.float32)},
                       "head": {"kernel": rng.randn(4).astype(np.float32)}}}
    named = {"zone.slope": torch.from_numpy(tree["params"]["zone"]["slope"]),
             "zone.w": torch.from_numpy(tree["params"]["zone"]["w"]),
             "head.kernel": torch.from_numpy(tree["params"]["head"]["kernel"])}
    losses = [3.0, 2.9, 2.7, 2.6, 2.6, 2.5]
    snaps = []
    for mod, params in ((jstats, tree), (tstats, named)):
        sc = mod.StatsCollector()
        sc.update_from_params(params)
        sc.update_grad_health(params)
        sc.update_zone_activity("zone", {"avg_firing_rate": 0.3,
                                         "membrane_mean": 0.1,
                                         "membrane_std": 0.05})
        sc.update_firing_rates({"other": 0.0005})
        sc.classify_stability(losses)
        sc.update_loss(losses[-1])
        d = sc.commit(7).to_dict()
        d.pop("timestamp")
        snaps.append((d, sc.health_summary(), sc.get_recommendations(),
                      list(sc.stability_history)))
        sc.save(str(tmp_path / f"{mod.__name__}.json"))
    (jd, jh, jr, js), (td, th, tr, ts) = snaps
    assert td.keys() == jd.keys()
    for key in td:
        if key == "grad_health":
            assert td[key].keys() == jd[key].keys()
            for k in td[key]:
                assert td[key][k] == pytest.approx(jd[key][k], rel=1e-6)
        elif key == "slope_stats":
            for k in td[key]:
                assert td[key][k] == pytest.approx(jd[key][k], rel=1e-6)
        else:
            assert td[key] == jd[key], key
    assert (th, tr, ts) == (jh, jr, js)
    back = tstats.StatsCollector()
    back.load(str(tmp_path / f"{tstats.__name__}.json"))
    assert back.history[-1].stability == td["stability"] == "improving"
