"""The Moonlight cell (`moonlight-ep8-rag.train-8k-b4`): its configuration
against the published config, `counts/moonlight.py` against FLOPs worked
out by hand, the benchmark's copy of the reference against the port's,
and whole runs on the CPU at a small size: the result line, and faults
planted under the timed path (routing, retrieval, a step that changes
nothing) turning `correct` false."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import core, run
from perfbench.counts import moonlight as counts

CELL = "moonlight-ep8-rag.train-8k-b4"
# the published config.json's numbers and settings (Hugging Face,
# moonshotai/Moonlight-16B-A3B)
PUBLISHED = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 11264,
    "kv_lora_rank": 512, "max_position_embeddings": 8192,
    "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": True, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27,
    "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_theta": 50000,
    "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 163840}
# hidden 64, 4 heads, kv rank 32, nope 16 / rope 8 / v 16, 16 routed
# experts of width 24 (4 held), top 3, 1 shared, 1 dense + 2 MoE layers,
# sequences of 64 in batches of 2; a bank whose batches of 2 take IVF
SIZES = {"model": {"vocab_size": 256, "embedding_dim": 64, "num_layers": 3,
                   "num_heads": 4, "intermediate_size": 96,
                   "max_seq_len": 64, "kv_lora_rank": 32,
                   "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                   "v_head_dim": 16, "n_routed_experts": 16,
                   "experts_held": 4, "num_experts_per_tok": 3,
                   "n_shared_experts": 1, "moe_intermediate_size": 24},
         "memory": {"max_memories": 4096, "feature_dim": 64,
                    "k_centroids": 64, "probe_centroids": 4},
         "traffic": {"batch": 2, "seq": 64}, "feed_steps": 4,
         "trace_steps": 2}
SEED = 2 ** 31 + 4321
WIDTHS = ("hidden_size", "intermediate_size", "moe_intermediate_size",
          "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
          "qk_rope_head_dim", "v_head_dim", "num_experts_per_tok")


@pytest.fixture(scope="module")
def spec():
    return core.load_spec()


def test_the_configuration_is_the_published_one_cut_as_reduced_says(spec):
    entry = core.find(spec["configs"], "moonlight-ep8-rag", "config")
    cfg = core.load_json(core.ROOT / entry["file"])
    assert entry["source"] == cfg["source"]
    changed = {k for k, v in PUBLISHED.items() if cfg.get(k, "gone") != v}
    assert changed <= set(entry["reduced"])
    assert changed == {"num_hidden_layers", "n_routed_experts",
                       "vocab_size"}
    assert not set(entry["reduced"]) & set(WIDTHS)
    dep = cfg["deployment"]
    assert dep["published"] == {k: PUBLISHED[k] for k in changed}
    assert dep["chips"] == dep["expert_parallel"] * dep["pipeline_stages"]
    assert cfg["n_routed_experts"] * dep["expert_parallel"] \
        == dep["router_experts"] == PUBLISHED["n_routed_experts"]
    assert cfg["vocab_size"] * dep["vocab_parallel"] \
        == PUBLISHED["vocab_size"]
    assert PUBLISHED["num_hidden_layers"] == \
        cfg["num_hidden_layers"] * dep["pipeline_stages"]
    assert set(cfg["limits"]) == set(cfg["limits_why"]) == {
        "grad_err", "change_err", "ret_gap", "route_gap", "expert_err"}


def test_the_cell_reports_training_throughput(spec):
    c = core.load_cell(spec, CELL)
    assert [m["name"] for m in c.end_to_end] == ["train_tokens_per_s",
                                                 "setup_s"]
    assert c.chips == 1 and c.traffic["batch"] * c.traffic["seq"] == 32768
    assert sorted(m["name"] for m in c.per_layer) == sorted(
        f"{n}.moonlight_train" for n in (
            "mfu", "moe_experts_roofline", "moe_route_device_ms",
            "mla_core_roofline", "idle_share", "retrieve_span_share"))


M = dict(embedding_dim=8, num_heads=2, vocab_size=10, kv_lora_rank=4,
         qk_nope_head_dim=3, qk_rope_head_dim=2, v_head_dim=3,
         intermediate_size=12, moe_intermediate_size=5, n_shared_experts=2,
         n_routed_experts=6, first_k_dense_replace=1, num_layers=3)


def test_counts_by_hand():
    D, H, V, r, n, p, v, I, Ie = 8, 2, 10, 4, 3, 2, 3, 12, 5
    rows, L, A = 2, 3, 7
    T = rows * L
    proj = D * H * (n + p) + D * (r + p) + r * H * (n + v) + H * v * D
    attended = 6                                  # 1 + 2 + 3 keys
    core_f = rows * H * 2 * (n + p + v) * attended
    layer = 2 * T * proj + 2 * rows * 2 * D * D + 2 * T * 2 * D * D
    want = (3 * layer + 3 * core_f + 2 * T * 3 * D * I
            + 2 * (2 * T * 3 * D * 2 * Ie + 2 * T * D * 6)
            + 2 * 3 * D * Ie * A + 2 * T * D * V)
    assert counts.attention_core_flops(M, rows, L) == core_f
    assert counts.expert_flops(M, A) == 2 * 3 * D * Ie * A
    assert counts.forward_flops(M, rows, L, A) == pytest.approx(want)
    assert counts.train_flops(M, rows, L, A) == pytest.approx(3 * want)


def test_the_published_step_is_4_14_gflop_a_token():
    m = dict(embedding_dim=2048, num_heads=16, vocab_size=20480,
             kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
             v_head_dim=128, intermediate_size=11264,
             moe_intermediate_size=1408, n_shared_experts=2,
             n_routed_experts=64, first_k_dense_replace=1, num_layers=9)
    # each of the 8 MoE layers' held experts see 6/64 x 8 picks a token
    A = 4 * 8192 * 6 * 8 / 64 * 8
    per_token = counts.train_flops(m, 4, 8192, A) / (4 * 8192)
    assert 4.0e9 < per_token < 4.3e9


def test_the_benchmark_copy_of_the_reference_is_the_ports():
    root = Path(core.ROOT)
    assert (root / "perfbench/reference/moonlight_plain.py").read_bytes() \
        == (root / "aura_snn_rag_tpu_torch/reference/moonlight.py") \
        .read_bytes()


def test_the_references_and_counts_import_nothing_of_the_port():
    code = (f"import json, sys; sys.path.insert(0, {str(core.ROOT)!r})\n"
            "import perfbench.reference.moonlight_plain, "
            "perfbench.reference.moonlight_train, "
            "perfbench.counts.moonlight\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(core.ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    names = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not names & (set(core.FORBIDDEN_MODULES)
                        | {"aura_snn_rag_tpu_torch"})


def one_run(capsys, trace=0):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.3", "--trace", str(trace)], device="cpu", sizes=SIZES,
                  t_start=time.perf_counter())
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(capsys, trace):
    line = one_run(capsys, trace)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"grad_err", "change_err", "ret_gap",
                                   "route_gap", "expert_err"}
    if trace:
        assert "retrieve_span_share.moonlight_train" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_routing_to_other_experts_is_not_correct(capsys, monkeypatch):
    """Each token's last pick swapped for its worst-scored expert: the
    reference follows the picks, `route_gap` catches them."""
    import torch
    from aura_snn_rag_tpu_torch.models.layers import MoEFFN
    real = MoEFFN.route

    def worst(self, x):
        top, w = real(self, x)
        s = torch.sigmoid(torch.nn.functional.linear(x.float(),
                                                     self.gate.weight))
        top = top.clone()
        top[:, -1] = s.argmin(dim=-1)
        return top, w
    monkeypatch.setattr(MoEFFN, "route", worst)
    line = one_run(capsys)
    assert line["checks"]["route_gap"]["ok"] is False


def test_altered_retrieval_is_not_correct(capsys, monkeypatch):
    """Each call's first answer moved to the next bank row."""
    from aura_snn_rag_tpu_torch.memory import engine
    real = engine.retrieve_auto

    def altered(config, state, queries, query_locations=None, k=5):
        res = real(config, state, queries, query_locations, k)
        idx = res.indices.clone()
        idx[:, 0] = (idx[:, 0] + 1) % config.max_memories
        return res._replace(indices=idx)
    monkeypatch.setattr(engine, "retrieve_auto", altered)
    line = one_run(capsys)
    assert line["checks"]["ret_gap"]["ok"] is False


def test_unchanged_state_is_not_correct(capsys, monkeypatch):
    from aura_snn_rag_tpu_torch.training import optim
    monkeypatch.setattr(optim.ClippedAdamW, "step",
                        lambda self, loss, lr_scale=1.0: None)
    line = one_run(capsys)
    assert line["correct"] is False
    assert line["checks"]["change_err"]["value"] == pytest.approx(1.0)


class _HalfGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g * 0.5


def test_a_wrong_expert_gradient_is_not_correct(capsys, monkeypatch):
    """The held experts' weights get half their gradient: the median
    leaf does not see 16 of 171 leaves, `expert_err` does."""
    from aura_snn_rag_tpu_torch.models import layers
    real = layers.held_experts_loop

    def halved(x, w13, w2, top, w, offset):
        return real(x, _HalfGrad.apply(w13), _HalfGrad.apply(w2), top, w,
                    offset)
    monkeypatch.setattr(layers, "held_experts_loop", halved)
    line = one_run(capsys)
    assert line["checks"]["expert_err"]["ok"] is False
