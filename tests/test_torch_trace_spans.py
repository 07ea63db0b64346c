"""The port's spans and counters (`utils/trace.py`) where the engine and
the trainer do their work.

- Spans off (the default): `span` hands back one shared no-op context,
  a profiler records no `aura:` event, and the always-on counters still
  rise: one `path.<name>` a retrieval, `aux_build` per aux built,
  `sync.<site>` per place where the host waits for the card.
- Spans on: the documented names appear on the profiler's host timeline
  and nest as the calls do, in retrieval and in `Trainer.train_step`.
- On the card (marked `cuda`): every synchronising call that
  `torch.cuda.set_sync_debug_mode("warn")` reports on the benchmark's
  paths lies inside a counted `host_sync` site.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.memory import engine
from aura_snn_rag_tpu_torch.utils.trace import (
    SPAN_PREFIX, count, counters, enable_spans, host_sync, span, trace)

MEM = dict(max_memories=4096, feature_dim=128, k_centroids=64,
           probe_centroids=4, n_place_cells=16, n_grid_cells=8,
           n_time_cells=4)
# retrieve_auto's paths at this bank: B * probe * capacity against M
B_IVF, B_FLAT = 2, 8


def bank(mcfg, dev="cpu", index=True, seed=0):
    """Clustered rows filling the bank, with the index built."""
    rng = np.random.RandomState(seed)
    M, D = mcfg.max_memories, mcfg.feature_dim
    centres = rng.randn(32, D).astype(np.float32) * 2
    feats = centres[rng.randint(0, 32, M)] + rng.randn(M, D).astype(
        np.float32)
    state = engine.bulk_load(mcfg, port.init_memory_state(mcfg, dev),
                             torch.from_numpy(feats).to(dev),
                             torch.zeros(M, mcfg.spatial_dims, device=dev))
    if index:
        state = engine.rebuild_centroids(mcfg, state,
                                         torch.Generator().manual_seed(1))
    return state, feats


def queries(feats, n, dev="cpu", seed=2):
    rng = np.random.RandomState(seed)
    q = feats[rng.randint(0, len(feats), n)] + 0.5 * rng.randn(
        n, feats.shape[1]).astype(np.float32)
    return torch.from_numpy(q).to(dev)


def rises(fn):
    """The counters' rise over `fn()`, without the keys that stayed."""
    before = dict(counters)
    fn()
    return {k: v - before.get(k, 0) for k, v in counters.items()
            if v != before.get(k, 0)}


def program_spans(prof):
    """(name without the prefix, start ns, end ns) of the profiler's host
    events that the program's spans recorded, in start order."""
    from torch.autograd import DeviceType
    out = [(e.name()[len(SPAN_PREFIX):], e.start_ns(),
            e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(SPAN_PREFIX)
           and e.device_type() == DeviceType.CPU]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def parent(spans, child):
    """The innermost span that holds `child` (None at the top)."""
    _, s, e = child
    holders = [p for p in spans if p != child and p[1] <= s
               and e <= p[2]]
    return min(holders, key=lambda p: p[2] - p[1])[0] if holders else None


@pytest.fixture
def spans_on():
    was = enable_spans(True)
    yield
    enable_spans(was)


def test_a_span_off_is_one_shared_no_op_and_counters_stay_on():
    assert not enable_spans(False)          # off by default
    assert span("engine.retrieve") is span("trainer.step")
    got = rises(lambda: (count("path.x"), count("path.x", 2),
                         host_sync("site")))
    assert got == {"path.x": 3, "sync.site": 1}
    assert host_sync("site") is span("engine.retrieve")


@pytest.mark.parametrize("case, want", [
    ("ivf", {"path.ivf_v3r": 1, "aux_build": 1,
             "sync.retrieve_auto.dispatch": 1}),
    ("flat", {"path.flat_scan": 1, "sync.flat_scan.mask_constant": 1}),
    ("bruteforce", {"path.bruteforce": 1,
                    "sync.retrieve_auto.dispatch": 1}),
])
def test_retrieve_auto_counts_its_path_with_spans_off(case, want):
    """One request on each path under a profiler: no `aura:` event, and
    the counters rise by one path, the aux built per IVF call and the
    dispatch's read wherever it runs."""
    mcfg = port.MemoryConfig(**MEM)
    state, feats = bank(mcfg, index=case != "bruteforce")
    q = queries(feats, B_FLAT if case == "flat" else B_IVF)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = rises(lambda: engine.retrieve_auto(mcfg, state, q, None, 5))
    assert got == want
    assert program_spans(prof) == []


@pytest.mark.parametrize("kernel, path", [("v3r", "path.ivf_v3r"),
                                          ("v3", "path.ivf_v3"),
                                          ("v2", "path.ivf_v2")])
def test_retrieval_spans_nest(spans_on, kernel, path):
    """retrieve_auto > retrieve > {probe, build_ivf_aux, scan, annex,
    rerank}, and the dispatch's read inside retrieve_auto, in order."""
    mcfg = port.MemoryConfig(**MEM, ivf_kernel=kernel)
    state, feats = bank(mcfg)
    q = queries(feats, B_IVF)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = rises(lambda: engine.retrieve_auto(mcfg, state, q, None, 5))
    assert got[path] == 1
    spans = program_spans(prof)
    names = [n for n, _, _ in spans]
    assert names == ["engine.retrieve_auto", "sync.retrieve_auto.dispatch",
                     "engine.retrieve", "engine.probe",
                     "engine.build_ivf_aux", "engine.scan", "engine.annex",
                     "engine.rerank"]
    want_parent = {"engine.retrieve_auto": None,
                   "sync.retrieve_auto.dispatch": "engine.retrieve_auto",
                   "engine.retrieve": "engine.retrieve_auto"}
    for sp in spans:
        assert parent(spans, sp) == want_parent.get(sp[0],
                                                    "engine.retrieve")


@pytest.mark.parametrize("strategy", ["scan", "blockmax"])
def test_flat_spans_nest(spans_on, strategy):
    mcfg = port.MemoryConfig(**MEM, flat_strategy=strategy)
    state, feats = bank(mcfg)
    q = queries(feats, B_FLAT)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = rises(lambda: engine.retrieve_auto(mcfg, state, q, None, 5))
    scan = strategy == "scan"
    assert got == {f"path.flat_{strategy}": 1,
                   **({"sync.flat_scan.mask_constant": 1} if scan else {})}
    spans = program_spans(prof)
    assert [(n, parent(spans, (n, s, e))) for n, s, e in spans] == [
        ("engine.retrieve_auto", None),
        ("engine.retrieve_flat", "engine.retrieve_auto"),
        ("engine.flat_scores", "engine.retrieve_flat"),
        *([("sync.flat_scan.mask_constant", "engine.flat_scores")]
          if scan else []),
        ("engine.rerank", "engine.retrieve_flat")]


def test_write_memories_counts_its_cursor_read(spans_on):
    mcfg = port.MemoryConfig(**MEM)
    state, feats = bank(mcfg)
    rows = torch.from_numpy(feats[:3])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = rises(lambda: engine.write_memories(
            mcfg, state, rows, torch.zeros(3, mcfg.spatial_dims)))
    assert got == {"sync.write_memories.cursor": 1,
                   "sync.write_memories.strength": 1}
    assert [n for n, _, _ in program_spans(prof)] == [
        "engine.write_memories", "sync.write_memories.cursor",
        "sync.write_memories.strength"]


def test_trace_records_the_program_s_spans_for_its_block(tmp_path):
    """`trace` turns spans on for its block only; its Chrome trace holds
    the engine's stages."""
    mcfg = port.MemoryConfig(**MEM)
    state, feats = bank(mcfg)
    q = queries(feats, B_IVF)
    with trace(str(tmp_path)):
        assert span("x") is not span("x")
        engine.retrieve_auto(mcfg, state, q, None, 5)
    assert span("x") is span("x")
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"aura:engine.retrieve_auto", "aura:engine.retrieve",
            "aura:engine.scan"} <= names


def test_trainer_step_spans_in_order_and_its_host_reads(spans_on):
    """One `train_step` at `get_test_config()` with its memory layers on
    from step 0 (a short batch): the step's phases in order under
    `trainer.step`, each memory layer's retrieval under `layer.memory`
    inside the forward, and three counted host reads: the metrics and
    the replay's two copies."""
    cfg = port.get_test_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, use_rag=True),
        training=dataclasses.replace(cfg.training, memory_warmup_steps=0))
    trainer = port.Trainer(cfg, seed=0, device="cpu")
    ids = torch.randint(0, cfg.model.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = rises(lambda: trainer.train_step(ids, ids))
    assert {k: v for k, v in got.items() if k.startswith("sync.trainer")} \
        == {"sync.trainer.metrics": 1, "sync.trainer.replay": 2}
    spans = program_spans(prof)
    top = [n for n, s, e in spans if parent(spans, (n, s, e))
           == "trainer.step"]
    assert top == ["trainer.modulate", "model.forward", "trainer.backward",
                   "optim.step", "trainer.store", "trainer.host"]
    n_memory = sum(1 for n, _, _ in spans if n == "layer.memory")
    assert n_memory == cfg.model.num_layers
    assert all(parent(spans, sp) == "model.forward" for sp in spans
               if sp[0] == "layer.memory")
    assert all(parent(spans, sp) == "layer.memory" for sp in spans
               if sp[0] == "engine.retrieve_auto")
    host = [n for n, s, e in spans if parent(spans, (n, s, e))
            == "trainer.host"]
    assert host == ["sync.trainer.metrics", "sync.trainer.replay",
                    "sync.trainer.replay"]


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

SYNC_WARNING = "called a synchronizing CUDA operation"


def synchronising_calls(fn):
    """(the calls `set_sync_debug_mode("warn")` reports over `fn()`, the
    counters' rise)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = rises(fn)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [w for w in seen if SYNC_WARNING in str(w.message)], got


def seen_syncs(got):
    """The counted waits of the kinds the sync debug mode reports (copies
    between the device and pageable host memory, `.item()`, `.tolist()`,
    `bool()`): every site but the trainer's metrics, which waits on an
    event."""
    return sum(v for k, v in got.items()
               if k.startswith("sync.") and k != "sync.trainer.metrics")


@pytest.mark.cuda
def test_every_synchronising_call_is_a_counted_site():
    """The engine cells' paths (retrieve_auto at B = 1 and 8, retrieve at
    B = 1024 with aux passed) and two training steps (a store step and a
    plain one) of a small bf16 model with memory live and the cell's
    flat scan: the sync debug mode reports exactly the counted waits.
    A training step waits in each memory layer's flat scan (its mask's
    constant), twice for the replay's copies and, in a store step, twice
    in the write (its cursor, the written strength)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    mem = dict(max_memories=16384, feature_dim=128, k_centroids=128,
               probe_centroids=4)
    mcfg = port.MemoryConfig(**mem)
    state, feats = bank(mcfg, dev)
    aux = engine.build_ivf_aux(mcfg, state)
    q = queries(feats, 1024, dev)
    engine.retrieve(mcfg, state, q, None, 10, aux=aux)
    for B in (1, 8):
        engine.retrieve_auto(mcfg, state, q[:B], None, 10)
        seen, got = synchronising_calls(
            lambda: engine.retrieve_auto(mcfg, state, q[:B], None, 10))
        assert got["path.ivf_v3r"] == 1
        assert len(seen) == seen_syncs(got) == 1, [str(w.message)
                                                   for w in seen]
    seen, got = synchronising_calls(
        lambda: engine.retrieve(mcfg, state, q, None, 10, aux=aux))
    assert len(seen) == seen_syncs(got) == 0, [str(w.message) for w in seen]

    model = dict(vocab_size=512, embedding_dim=128, num_layers=4,
                 num_heads=4, intermediate_size=256, max_seq_len=64,
                 n_place_cells=128, snn_layers=(0, 2), dtype="bfloat16",
                 memory_injection="gate", use_rag=True)
    cfg = port.AuraConfig(
        model=port.ModelConfig(**model), memory=mcfg,
        training=port.TrainingConfig(
            batch_size=16, memory_warmup_steps=0, enable_thalamus=False,
            endocrine_memory_gating=False, memory_store_interval=2))
    trainer = port.Trainer(cfg, seed=0, device=dev)
    trainer.hippocampus.state = bank(mcfg, dev, seed=3)[0]
    ids = torch.randint(0, 512, (4, 16, 64), device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    trainer.train_step(ids[0], ids[0])            # steps 0 (store), 1
    trainer.train_step(ids[1], ids[1])
    for s in (2, 3):                              # a store step, a plain one
        seen, got = synchronising_calls(
            lambda: trainer.train_step(ids[s], ids[s]))
        assert got["path.flat_scan"] == cfg.model.num_layers
        assert got["sync.trainer.metrics"] == 1
        want = cfg.model.num_layers + 2 + (2 if s == 2 else 0)
        assert len(seen) == seen_syncs(got) == want, [str(w.message)
                                                      for w in seen]
