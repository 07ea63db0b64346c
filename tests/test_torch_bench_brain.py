"""The port's brain and emotion benchmarks (`aura_snn_rag_tpu_torch/
benchmarks/bench_prosody.py`, `bench_prosody_sweep.py`,
`bench_moe_routing.py`, `ablation_moe_routing.py`,
`bench_energy_tracking.py` and `bench_emotion_e2e.py`) against the JAX
scripts of the same names in `benchmarks/`, loaded by their paths under
the argv they parse, their `main`s run on the CPU with spies on the JAX
package's classes they import inside `main`:

- `bench_prosody`: the cold pass's gains within 1e-6 of the JAX
  bridge's on the rows whose LIF spikes agree (XLA's sin and cos differ
  from PyTorch's in the last bit), and the hit rate equal;
- `bench_prosody_sweep --json`: every row's mean gain, winner
  utilisation and attention entropy within 1e-5, its total spikes
  within 1e-4 of the entries (the GIF scan's flip bound);
- `bench_moe_routing`: from flax's init and the script's draws, the
  first 30 Adam steps' losses within 1e-5 of JAX's router under
  `optax.adam`; both `main`s' keys equal and their numbers within
  `ROUTING_TOL` after the script's 300 steps;
- `ablation_moe_routing` at 10 samples per regime: every text's gain
  within 1e-6, every sample's entropy within 1e-5 and every status
  equal, with and without `--hash-channels`;
- `bench_energy_tracking` fed JAX's threefry draws: the report within
  1e-5;
- `bench_emotion_e2e`: the split and the embeddings equal; from flax's
  head weights at `--epochs 20`, the final loss and both accuracies
  equal the JAX script's printed (rounded) values; the eight keys; the
  synthetic corpus equal;
- the flags and the device rule.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aura_snn_rag_tpu.encoders import FastHashEmbedder as JaxEmbedder
from aura_snn_rag_tpu.models import emotion_head as jeh
from aura_snn_rag_tpu.models import prosody as jp
from aura_snn_rag_tpu.models.brain import liquid_moe as jliquid
from aura_snn_rag_tpu.utils import energy as jenergy
from aura_snn_rag_tpu_torch.benchmarks import ablation_moe_routing as tab
from aura_snn_rag_tpu_torch.benchmarks import bench_emotion_e2e as tee
from aura_snn_rag_tpu_torch.benchmarks import bench_energy_tracking as tet
from aura_snn_rag_tpu_torch.benchmarks import bench_moe_routing as tmr
from aura_snn_rag_tpu_torch.benchmarks import bench_prosody as tbp
from aura_snn_rag_tpu_torch.benchmarks import bench_prosody_sweep as tps
from aura_snn_rag_tpu_torch.encoders.hash_embedder import FastHashEmbedder
from aura_snn_rag_tpu_torch.models.brain.liquid_moe import LiquidMoERouter
from aura_snn_rag_tpu_torch.models.convert import module_from_numpy
from aura_snn_rag_tpu_torch.models.emotion_head import (
    EmotionHeadConfig, EmotionPersonalityHead)
from aura_snn_rag_tpu_torch.models.prosody import ANALYTICAL_BALANCED
from tests.test_torch_common import FLIP_FRACTION, highest
from tests.test_torch_language_zone import _jax_lif_spikes, _port_lif_spikes

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAIN_TOL = 1e-6
ROW_TOL = 1e-5
LOSS_TOL = 1e-5
STEPS_HELD = 30
# bench_moe_routing after the script's 300 Adam steps from the same
# weights and draws: the printed numbers (4 places) measured equal, the
# first 30 losses within 7.2e-7; the bound is one unit of the last
# printed place, where a rounding can land either side
ROUTING_TOL = 1e-4


def load(name, argv=()):
    """The JAX script, imported under `argv`."""
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.argv = saved
    return module


def run_main(module, argv=(), patches=()):
    """The JAX script's `main` under `argv` with `patches` ((object,
    attribute, value) triples) in place: (its return, its stdout)."""
    mp = pytest.MonkeyPatch()
    buf = io.StringIO()
    try:
        mp.setattr(sys, "argv", [module.__name__, *argv])
        for obj, attr, value in patches:
            mp.setattr(obj, attr, value)
        with highest(), contextlib.redirect_stdout(buf):
            out = module.main()
    finally:
        mp.undo()
    return out, buf.getvalue()


# --------------------------------------------------------------------------
# bench_prosody
# --------------------------------------------------------------------------

def test_prosody_gains_and_hit_rate_match_jax():
    gains = []

    class Spy(jp.CachedProsodyBridge):
        def __call__(self, token_ids):
            out = super().__call__(token_ids)
            gains.append(np.asarray(out))
            return out

    _, out = run_main(load("bench_prosody"),
                      patches=[(jp, "CachedProsodyBridge", Spy)])
    jax_line = json.loads(out.strip().splitlines()[-1])
    res = tbp.run(["--device", "cpu"])
    assert list(res.line) == list(jax_line)
    assert res.line["hit_rate"] == jax_line["hit_rate"]
    assert res.bridge.stats["hit_rate"] == pytest.approx(18 / 34)
    # the JAX calls: 2 to warm up, then the cold pass
    cold = gains[2:2 + len(res.batches)]
    compared = 0
    for ids, got, want in zip(res.batches, res.gains, cold):
        flips = np.asarray(_jax_lif_spikes(jnp.asarray(ids),
                                           ANALYTICAL_BALANCED)) \
            != _port_lif_spikes(ids, ANALYTICAL_BALANCED)
        assert flips.mean() <= FLIP_FRACTION
        keep = ~flips.any(axis=(0, 2))
        np.testing.assert_allclose(got.numpy()[keep], want[keep],
                                   rtol=GAIN_TOL, atol=GAIN_TOL)
        compared += int(keep.sum())
    assert compared >= 0.9 * sum(len(b) for b in res.batches)


# --------------------------------------------------------------------------
# bench_prosody_sweep
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sweep():
    """The JAX script's rows (its `main` returns them) and table."""
    return run_main(load("bench_prosody_sweep"))


def test_prosody_sweep_rows_match_jax(jax_sweep):
    jax_rows, _ = jax_sweep
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tps.run(["--json", "--device", "cpu"])
    printed = json.loads(buf.getvalue())
    assert list(printed) == ["benchmark", "rows"]
    assert printed["benchmark"] == "prosody_sweep"
    assert [list(r) for r in res.rows] == [list(r) for r in jax_rows]
    for got, want in zip(res.rows, jax_rows):
        assert got["config"] == want["config"]
        for key in ("mean_gain", "winner_utilization", "attention_entropy"):
            if want[key] is None:
                assert got[key] is None
            else:
                assert abs(got[key] - want[key]) <= ROW_TOL, (got, want)
        entries = res.spikes[got["config"]].numel()
        assert abs(got["total_spikes"] - want["total_spikes"]) \
            <= FLIP_FRACTION * entries, (got, want)


def test_prosody_sweep_table_is_the_script_s(jax_sweep):
    _, jax_out = jax_sweep
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tps.run(["--device", "cpu"])
    got, want = buf.getvalue().splitlines(), jax_out.splitlines()
    assert got[:2] == want[:2] and len(got) == len(want) == 10
    assert [s.split()[0] for s in got[2:]] == [s.split()[0]
                                               for s in want[2:]]


# --------------------------------------------------------------------------
# bench_moe_routing and ablation_moe_routing
# --------------------------------------------------------------------------

def _router_from_jax():
    """flax's init of the scripts' router (PRNGKey(0)) in a port router."""
    params = jliquid.LiquidMoERouter(hidden_dim=64, num_experts=8,
                                     top_k=2).init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 32)))
    router = LiquidMoERouter(32, 64, 8, top_k=2, device="cpu")
    module_from_numpy(router, jax.tree.map(np.asarray, params))
    return params, router


def _jax_routing_losses(params, steps):
    """The script's training loop, driven directly for `steps` steps."""
    router = jliquid.LiquidMoERouter(hidden_dim=64, num_experts=8, top_k=2)
    rng = np.random.RandomState(0)
    centers = rng.randn(4, 32).astype(np.float32) * 3
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, x, target):
        def loss_fn(p):
            out = router.apply(p, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                jnp.log(out["probs"] + 1e-9), target).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    with highest():
        for _ in range(steps):
            cid = rng.randint(0, 4, 64)
            x = jnp.asarray(centers[cid] + 0.5 * rng.randn(64, 32)
                            .astype(np.float32))
            params, opt_state, loss = step(params, opt_state, x,
                                           jnp.asarray(cid))
            losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def routing():
    params, router = _router_from_jax()
    res = tmr.run(["--device", "cpu"], router=router)
    return params, res


def test_moe_routing_losses_follow_optax(routing):
    params, res = routing
    want = _jax_routing_losses(params, STEPS_HELD)
    np.testing.assert_allclose(res.losses[:STEPS_HELD], want, rtol=0,
                               atol=LOSS_TOL)
    assert len(res.losses) == tmr.STEPS == 300


def test_moe_routing_line_matches_the_script_s(routing):
    _, res = routing
    _, out = run_main(load("bench_moe_routing"))
    jax_line = json.loads(out.strip().splitlines()[-1])
    assert list(res.line) == list(jax_line)
    for key, want in jax_line.items():
        assert abs(res.line[key] - want) <= ROUTING_TOL, (res.line,
                                                          jax_line)


TEXTS = tab.LOW_PROSODY_TEXTS + tab.HIGH_PROSODY_TEXTS


@pytest.fixture(scope="module", params=[False, True],
                ids=["text_channels", "hash_channels"])
def jax_gains(request):
    """(--hash-channels, {text: the JAX script's `_gain_for(text)`})."""
    hash_channels = request.param
    module = load("ablation_moe_routing",
                  ["--hash-channels"] if hash_channels else [])
    assert module.HASH_CHANNELS is hash_channels
    return hash_channels, {text: module._gain_for(text) for text in TEXTS}


def test_ablation_gains_match_jax(jax_gains):
    hash_channels, gains = jax_gains
    module = load("ablation_moe_routing")
    assert (module.LOW_PROSODY_TEXTS, module.HIGH_PROSODY_TEXTS) == (
        tab.LOW_PROSODY_TEXTS, tab.HIGH_PROSODY_TEXTS)
    for text, want in gains.items():
        assert abs(tab.gain_for(text, hash_channels) - want) <= GAIN_TOL, \
            text


@pytest.fixture(scope="module")
def jax_router():
    return _router_from_jax()[1]


@pytest.mark.parametrize("config", tab.CONFIGS, ids=[c[0] for c in
                                                     tab.CONFIGS])
def test_ablation_config_matches_jax(config, jax_gains, jax_router):
    name, use_bandit, usage_beta = config
    hash_channels, gains = jax_gains
    module = load("ablation_moe_routing",
                  ["--hash-channels"] if hash_channels else [])
    seen = []
    real = np.corrcoef

    def spy(a, b):
        seen.append((list(a), list(b)))
        return real(a, b)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(np, "corrcoef", spy)
        # each text's gain from the script's `_gain_for`, computed once
        # (eager JAX traces the LIF scan at every call)
        mp.setattr(module, "_gain_for", gains.__getitem__)
        with highest():
            want = module.run_config(name, use_bandit, usage_beta,
                                     n_samples=10)
    finally:
        mp.undo()
    trace = {}
    got = tab.run_config(name, use_bandit, usage_beta, n_samples=10,
                         hash_channels=hash_channels, router=jax_router,
                         trace=trace)
    (jgains, jents), = seen
    np.testing.assert_allclose(trace["gains"], jgains, rtol=0,
                               atol=GAIN_TOL)
    np.testing.assert_allclose(trace["entropies"], jents, rtol=0,
                               atol=ROW_TOL)
    assert list(got) == list(want)
    assert got["status"] == want["status"]
    for key in ("low_entropy", "high_entropy", "gain_entropy_corr"):
        assert abs(got[key] - want[key]) <= 1e-4, (got, want)


def test_ablation_summary_keys_are_the_script_s(monkeypatch, jax_router):
    module = load("ablation_moe_routing")
    monkeypatch.setattr(module, "run_config",
                        lambda n, b, u: {"config": n,
                                         "gain_entropy_corr": -0.5})
    _, out = run_main(module)
    jax_summary = json.loads(out)
    got = tab.run(["--device", "cpu"], n_samples=2, router=jax_router)
    assert list(got) == list(jax_summary)
    assert [r["config"] for r in got["rows"]] == [
        r["config"] for r in jax_summary["rows"]]


# --------------------------------------------------------------------------
# bench_energy_tracking
# --------------------------------------------------------------------------

def test_energy_report_matches_jax_on_its_draws():
    trackers = []

    class Spy(jenergy.EnergyTracker):
        def __init__(self):
            super().__init__()
            trackers.append(self)

    _, out = run_main(load("bench_energy_tracking"),
                      patches=[(jenergy, "EnergyTracker", Spy)])
    jax_line = json.loads(out)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 16, 256)))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (8, 16, 256)))
    res = tet.run(["--device", "cpu"], currents=torch.from_numpy(x),
                  uniform=torch.from_numpy(u))
    assert json.loads(json.dumps(res.line)).keys() == jax_line.keys()
    want, got = trackers[0].energy_pj(), res.tracker.energy_pj()
    assert list(got) == list(want)
    for comp in want:
        assert list(got[comp]) == list(want[comp])
        for key in want[comp]:
            assert got[comp][key] == pytest.approx(want[comp][key],
                                                   rel=1e-5), (comp, key)
    assert res.tracker.summary() == pytest.approx(trackers[0].summary(),
                                                  rel=1e-5)


# --------------------------------------------------------------------------
# bench_emotion_e2e
# --------------------------------------------------------------------------

def test_emotion_split_and_embeddings_match_jax():
    module = load("bench_emotion_e2e")
    texts, labels, n = tee.load_curated()
    jtexts, jlabels, jn = module.load_curated()
    assert (texts, n) == (jtexts, jn) and np.array_equal(labels, jlabels)
    assert tee.GOEMOTIONS_LABELS == module.GOEMOTIONS_LABELS
    for a, b in zip(tee.stratified_split(labels),
                    module.stratified_split(jlabels)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        FastHashEmbedder(dim=tee.DIM).embed_batch(texts),
        JaxEmbedder(dim=tee.DIM).embed_batch(texts))


def test_emotion_synthetic_corpus_matches_jax():
    module = load("bench_emotion_e2e")
    texts, labels, n = tee.synthetic_corpus()
    jtexts, jlabels, jn = module.synthetic_corpus()
    assert (texts, n) == (jtexts, jn) and np.array_equal(labels, jlabels)


@pytest.mark.parametrize("synthetic", [False, True])
def test_emotion_line_matches_the_script_s(synthetic):
    argv = ["--epochs", "20"] + (["--synthetic"] if synthetic else [])
    _, out = run_main(load("bench_emotion_e2e"), argv)
    jax_line = json.loads(out.strip().splitlines()[-1])
    n_cls = jax_line["n_classes"]
    params = jeh.EmotionPersonalityHead(
        jeh.EmotionHeadConfig(d_model=tee.DIM, n_emotions=n_cls),
        deterministic=True).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, tee.DIM)))
    head = EmotionPersonalityHead(
        EmotionHeadConfig(d_model=tee.DIM, n_emotions=n_cls), device="cpu")
    module_from_numpy(head, jax.tree.map(np.asarray, params))
    res = tee.run(argv + ["--device", "cpu"], head=head)
    assert list(res.line) == list(jax_line) and len(jax_line) == 8
    for key in ("dataset", "n", "n_classes", "n_test", "chance",
                "test_accuracy", "test_top3_accuracy", "final_loss"):
        assert res.line[key] == jax_line[key], key


# --------------------------------------------------------------------------
# flags and the device rule
# --------------------------------------------------------------------------

MODULES = {"bench_prosody": (tbp, ()), "bench_prosody_sweep": (tps,
                                                               ("--json",)),
           "bench_moe_routing": (tmr, ()),
           "ablation_moe_routing": (tab, ("--hash-channels",)),
           "bench_energy_tracking": (tet, ()),
           "bench_emotion_e2e": (tee, ("--epochs", "--synthetic"))}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_flags_and_device_rule(name):
    module, flags = MODULES[name]
    src = open(os.path.join(ROOT, "benchmarks", f"{name}.py")).read()
    options = {o for a in module.parser()._actions for o in a.option_strings}
    for flag in flags:
        assert flag in src and flag in options, flag
    assert "--goemotions" not in options
    args = module.parser().parse_args([])
    assert args.device == "cuda"
    if name == "bench_emotion_e2e":
        assert args.epochs == 600
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run([])
