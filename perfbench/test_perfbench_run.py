"""Whole runs on the CPU at small sizes: the result line, the traffic's
determinism, a path without a card failing, the controls coming out not
correct, and faults planted under the timed path turning `correct`
false. The card's own checks are in `test_perfbench_cuda.py`."""

import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import calibrate, core, data, run

# small enough for the plain versions of the kernels on the host (they
# gather every probed row of every query); probe 48 of 64, as the small
# bank's clusters overlap far more than the cell's and its recall at
# probe 16 falls under the cell's limit
ENGINE = {"memory": {"max_memories": 16384, "feature_dim": 64,
                     "k_centroids": 64, "probe_centroids": 48,
                     "overflow_buckets": 4},
          "pool_requests": 8, "check_requests": 4}
TRAIN = {"model": {"vocab_size": 512, "embedding_dim": 64, "num_layers": 2,
                   "num_heads": 4, "intermediate_size": 128,
                   "n_place_cells": 128, "snn_layers": [0]},
         # probe 8: batch x probe x bucket (4 x 8 x 128) reaches the bank's
         # rows, so retrieval takes the flat scan, as at the cell's size
         "memory": {"max_memories": 4096, "feature_dim": 64,
                    "k_centroids": 64, "probe_centroids": 8},
         "traffic": {"batch": 4, "seq": 32}, "feed_steps": 8,
         "trace_steps": 2}
SIZES = {"engine-1m.ivf-b1024": dict(ENGINE, pool_requests=4, traffic={
    "batch_min": 64, "batch_max": 64}),
         "engine-1m.auto-small": ENGINE,
         "lm-full-rag.train-b16": TRAIN}
# the training cell's control shows in its retrieval, where TF32 swaps
# rows only at near-ties: a larger bank and batch than a run test's
# (every retrieval still takes the flat scan)
CONTROL_SIZES = dict(SIZES, **{"lm-full-rag.train-b16": dict(
    TRAIN, memory=dict(TRAIN["memory"], max_memories=131072),
    traffic={"batch": 32, "seq": 32})})
CELLS = sorted(SIZES)
SEED = 2 ** 31 + 12345                  # more than 32 signed bits


def one_run(capsys, cell, trace=0, seed=SEED, seconds=0.5):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  sizes=SIZES[cell], t_start=time.perf_counter())
    out, err = capsys.readouterr()
    return rc, out, err


def last_line(out):
    return json.loads(out.strip().splitlines()[-1])


def test_every_cell_of_the_spec_is_exercised_here():
    assert {w["name"] for w in core.load_spec()["workloads"]} == set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(capsys, cell, trace):
    rc, out, err = one_run(capsys, cell, trace)
    assert rc == 0, err
    line = last_line(out)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    c = core.load_cell(core.load_spec(), cell)
    if trace:
        assert "busy_s" in line["device"] and "breakdown" in line
    else:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    # the compared numbers close standard error, beside their limits
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, text in zip(line["checks"], tail):
        assert text.startswith(f"check {name}: ")


def test_no_card_fails_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "engine-1m.ivf-b1024", "--seed", "1",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "cuda" in err


def test_no_result_in_a_directory_without_the_port(tmp_path):
    import shutil
    shutil.copy(core.SPEC_FILE, tmp_path / "BENCHMARK.json")
    shutil.copytree(core.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "engine-1m.ivf-b1024", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_inputs_are_the_same_for_a_seed():
    a = data.rows("cpu", SEED, 64, 8, 4, 2.0)
    b = data.rows("cpu", SEED, 64, 8, 4, 2.0)
    assert torch.equal(a, b)
    assert not torch.equal(a, data.rows("cpu", SEED + 1, 64, 8, 4, 2.0))
    g1, g2 = data.generator("cpu", 3), data.generator("cpu", 3)
    assert torch.equal(data.queries_near(a, g1, 5, 0.5),
                       data.queries_near(a, g2, 5, 0.5))
    s1 = data.balanced_sizes(1, 8, 64, data.generator("cpu", 4))
    s2 = data.balanced_sizes(1, 8, 64, data.generator("cpu", 4))
    s3 = data.balanced_sizes(1, 8, 64, data.generator("cpu", 5))
    assert s1 == s2 and s1 != s3 and sorted(s1) == sorted(s3)
    spec = [("w", (3, 4), "normal", 0.5), ("b", (4,), "const", 0.0)]
    p1, p2 = data.params(spec, "cpu", 9), data.params(spec, "cpu", 9)
    assert torch.equal(p1["w"], p2["w"]) and not p1["b"].any()


def test_train_feed_is_the_same_for_a_seed():
    from perfbench.drivers import lm_train
    cell = core.load_cell(core.load_spec(), "lm-full-rag.train-b16")
    m = dict(cell.config["model"], **TRAIN["model"])

    def feed(seed):
        r = core.Run(cell, seed, 1.0, False, torch.device("cpu"), 0.0, TRAIN)
        return lm_train.feed(r, m, r.traffic, 3)

    a, b, c = feed(SEED), feed(SEED), feed(SEED + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, TRAIN["traffic"]["batch"], TRAIN["traffic"]["seq"])
    assert len({tuple(row.tolist()) for row in a.flatten(0, 1)}) == 12


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference one precision down, in the program's place, fails
    one of the cell's numbers; so does each fault a training step can
    have, in the reference put in the program's place."""
    line = calibrate.readings(cell, 7, 0.5, True, device="cpu",
                              sizes=CONTROL_SIZES[cell])
    assert line["correct"] is True
    limits = core.load_cell(core.load_spec(), cell).config["limits"]
    for who in ("control", "half_batch", "altered_answer"):
        if who not in line:
            continue
        checks = [core.Check(n, v, limits[n], "min" if "recall" in n
                             else "max") for n, v in line[who].items()]
        assert not all(c.ok for c in checks), (who, line)


def _altered(real, field, rows=16384):
    """`real` with the first answer of each call changed where it is
    produced (a slot moved to the next of the bank's `rows`)."""
    def call(*a, **kw):
        res = real(*a, **kw)
        x = getattr(res, field).clone()
        x[0, 0] = (x[0, 0] + 1) % rows
        return res._replace(**{field: x})
    return call


@pytest.mark.parametrize("cell,entry", [("engine-1m.ivf-b1024", "retrieve"),
                                        ("engine-1m.auto-small",
                                         "retrieve_auto")])
@pytest.mark.parametrize("field", ["indices", "scores"])
def test_altered_answer_is_not_correct(capsys, monkeypatch, cell, entry,
                                       field):
    from aura_snn_rag_tpu_torch.memory import engine
    monkeypatch.setattr(engine, entry, _altered(getattr(engine, entry),
                                                field))
    rc, out, err = one_run(capsys, cell)
    assert rc == 0 and last_line(out)["correct"] is False


def test_altered_retrieval_is_not_correct(capsys, monkeypatch):
    """Rows changed in the engine's answer inside the LM's training step:
    the retrieval's numbers catch them, as the reference injects the rows
    the program did."""
    from aura_snn_rag_tpu_torch.memory import engine
    monkeypatch.setattr(engine, "retrieve_auto",
                        _altered(engine.retrieve_auto, "indices",
                                 TRAIN["memory"]["max_memories"]))
    rc, out, err = one_run(capsys, "lm-full-rag.train-b16")
    assert rc == 0
    assert last_line(out)["checks"]["ret_gap"]["ok"] is False


def test_unchanged_state_is_not_correct(capsys, monkeypatch):
    """A training step that returns its state unchanged."""
    from aura_snn_rag_tpu_torch.training import optim
    monkeypatch.setattr(optim.ClippedAdamW, "step",
                        lambda self, loss, lr_scale=1.0: None)
    rc, out, err = one_run(capsys, "lm-full-rag.train-b16")
    assert rc == 0
    line = last_line(out)
    assert line["correct"] is False
    assert line["checks"]["change_err"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct(capsys, monkeypatch):
    """Half of the batch left out, the loss's mean taken over the rest."""
    from aura_snn_rag_tpu_torch.training import trainer
    real = trainer.hippocampal_loss

    def half(logits, labels, place_activity=None, **kw):
        n = logits.shape[0] // 2
        act = None if place_activity is None else place_activity[:n]
        return real(logits[:n], labels[:n], act, **kw)

    monkeypatch.setattr(trainer, "hippocampal_loss", half)
    rc, out, err = one_run(capsys, "lm-full-rag.train-b16")
    assert rc == 0 and last_line(out)["correct"] is False
