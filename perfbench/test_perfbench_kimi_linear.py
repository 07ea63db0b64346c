"""The Kimi-Linear cell (`kimi-linear-ep32-rag.train-32k-b1`): its
configuration against the published config, `counts/kimi_linear.py`
against FLOPs worked out by hand, the benchmark's copy of the reference
against the port's, and whole runs of `drivers/kimi_linear_train.py` on
the CPU at a small size in f32: the result line, and faults planted
under the timed path (a step that changes nothing, a wrong gradient
through the KDA gate) turning `correct` false."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import core, run
from perfbench.counts import kimi_linear as counts
from perfbench.counts import moonlight as moon_counts

CELL = "kimi-linear-ep32-rag.train-32k-b1"
# the published config.json's keys (Hugging Face,
# moonshotai/Kimi-Linear-48B-A3B-Instruct)
PUBLISHED = {
    "first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu",
    "hidden_size": 2304, "intermediate_size": 9216, "kv_lora_rank": 512,
    "linear_attn_config": {
        "full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
        "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19,
                       21, 22, 23, 25, 26],
        "num_heads": 32, "short_conv_kernel_size": 4},
    "mla_use_nope": True, "model_max_length": 1048576,
    "model_type": "kimi_linear", "moe_intermediate_size": 1024,
    "moe_layer_freq": 1, "moe_renormalize": True,
    "moe_router_activation_func": "sigmoid", "num_attention_heads": 32,
    "num_expert_group": 1, "num_experts": 256, "num_experts_per_token": 8,
    "num_hidden_layers": 27, "num_key_value_heads": 32,
    "num_nextn_predict_layers": 0, "num_shared_experts": 1,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000,
    "routed_scaling_factor": 2.446, "tie_word_embeddings": False,
    "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
    "vocab_size": 163840}
# hidden 64, 4 MLA heads, kv rank 32, nope 16 / rope 8 / v 16, 2 KDA
# heads of 16, 16 routed experts of width 24 (4 held), top 3, 1 shared;
# the pattern KDA, KDA, MLA; sequences of 80 in batches of 2 (two chunks,
# the second ragged), f32; a bank whose batches of 2 take IVF
SIZES = {"model": {"vocab_size": 256, "embedding_dim": 64, "num_layers": 3,
                   "num_heads": 4, "intermediate_size": 96,
                   "max_seq_len": 80, "kv_lora_rank": 32,
                   "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                   "v_head_dim": 16, "n_routed_experts": 16,
                   "experts_held": 4, "num_experts_per_tok": 3,
                   "n_shared_experts": 1, "moe_intermediate_size": 24,
                   "kda_layers": [0, 1], "kda_num_heads": 2,
                   "kda_head_dim": 16, "dtype": "float32"},
         "memory": {"max_memories": 4096, "feature_dim": 64,
                    "k_centroids": 64, "probe_centroids": 4},
         "traffic": {"batch": 2, "seq": 80}, "feed_steps": 4,
         "trace_steps": 2}
SEED = 2 ** 31 + 8765
WIDTHS = ("hidden_size", "intermediate_size", "moe_intermediate_size",
          "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
          "qk_rope_head_dim", "v_head_dim", "num_experts_per_token",
          "head_dim")


@pytest.fixture(scope="module")
def spec():
    return core.load_spec()


def test_the_configuration_is_the_published_one_cut_as_reduced_says(spec):
    entry = core.find(spec["configs"], "kimi-linear-ep32-rag", "config")
    cfg = core.load_json(core.ROOT / entry["file"])
    assert entry["source"] == cfg["source"]
    changed = {k for k, v in PUBLISHED.items() if cfg.get(k, "gone") != v}
    assert changed <= set(entry["reduced"])
    assert changed == {"num_hidden_layers", "num_experts", "vocab_size",
                       "linear_attn_config"}
    lin, pub = cfg["linear_attn_config"], PUBLISHED["linear_attn_config"]
    assert {k for k in pub if lin[k] != pub[k]} == {"kda_layers",
                                                    "full_attn_layers"}
    assert {f"linear_attn_config.{k}" for k in ("kda_layers",
            "full_attn_layers")} <= set(entry["reduced"])
    assert not set(entry["reduced"]) & set(WIDTHS)
    # one whole period of the pattern and more: the first 9 layers
    n = cfg["num_hidden_layers"]
    assert lin["kda_layers"] == [i for i in pub["kda_layers"] if i <= n]
    assert lin["full_attn_layers"] == [i for i in pub["full_attn_layers"]
                                       if i <= n]
    dep = cfg["deployment"]
    assert dep["chips"] == dep["expert_parallel"] * dep["pipeline_stages"]
    assert cfg["num_experts"] * dep["expert_parallel"] \
        == dep["router_experts"] == PUBLISHED["num_experts"]
    assert cfg["vocab_size"] * dep["vocab_parallel"] \
        == PUBLISHED["vocab_size"]
    assert PUBLISHED["num_hidden_layers"] == n * dep["pipeline_stages"]
    assert set(cfg["limits"]) == set(cfg["limits_why"]) == {
        "grad_err", "change_err", "ret_gap", "route_gap", "expert_err",
        "kda_err", "kda_core_err"}


def test_the_cell_reports_training_throughput(spec):
    c = core.load_cell(spec, CELL)
    assert [m["name"] for m in c.end_to_end] == ["train_tokens_per_s",
                                                 "setup_s"]
    assert c.chips == 1 and c.traffic["batch"] * c.traffic["seq"] == 32768
    assert sorted(m["name"] for m in c.per_layer) == sorted(
        f"{n}.kimi_train" for n in (
            "mfu", "kda_core_roofline", "kda_device_ms", "mla_core_roofline",
            "moe_experts_roofline", "idle_share"))


M = dict(embedding_dim=8, num_heads=2, vocab_size=10, kv_lora_rank=4,
         qk_nope_head_dim=3, qk_rope_head_dim=2, v_head_dim=3,
         intermediate_size=12, moe_intermediate_size=5, n_shared_experts=2,
         n_routed_experts=6, first_k_dense_replace=1, num_layers=3,
         kda_layers=(0, 2), kda_num_heads=2, kda_head_dim=4)


def test_counts_by_hand():
    """The KDA core at chunk 4 over 2 sequences of 6 (2 chunks each, the
    second ragged and counted whole), the projections, and the MLA
    layer's count as Moonlight's."""
    H, d, C, rows, L = 2, 4, 4, 2, 6
    per_chunk = (2 * d * C * (C + 1) + 2 * C * (C - 1) * d
                 + 3 * 2 * C * d * d + C * (C + 1) * d)
    assert counts.kda_core_flops(M, rows, L, chunk=C) == \
        rows * 2 * H * per_chunk
    D, n = 8, 8
    assert counts.kda_proj_flops(M) == 2 * (3 * D * n + 2 * (D * d + d * n)
                                            + D * H + n * D)
    T, A = rows * L, 7
    mla = dict(M, kda_layers=())
    kda_all = dict(M, kda_layers=(0, 1, 2))
    # a layer's mixer swapped: the difference is the mixers' counts
    diff = counts.forward_flops(mla, rows, L, A) \
        - counts.forward_flops(kda_all, rows, L, A)
    proj = D * 2 * 5 + D * 6 + 4 * 2 * 6 + 2 * 3 * D
    assert diff == pytest.approx(3 * (
        2 * T * proj + moon_counts.attention_core_flops(M, rows, L)
        - T * counts.kda_proj_flops(M) - counts.kda_core_flops(M, rows, L)))
    assert counts.forward_flops(mla, rows, L, A) == pytest.approx(
        moon_counts.forward_flops(M, rows, L, A))
    assert counts.train_flops(M, rows, L, A) == pytest.approx(
        3 * counts.forward_flops(M, rows, L, A))
    io = 3 * 2 * d + 4 * d + 4
    # forward: the inputs and o; backward: the inputs, do and the
    # inputs' gradients
    assert counts.kda_core_bytes(M, rows, L) == T * H * (3 * io + 8 * d)


def test_the_published_step_is_near_6_gflop_a_token():
    """The cell's step: 2 MLA layers' causal core at 32k, 7 KDA layers,
    8 MoE layers whose 8 held experts see 8/256 x 8 picks a token."""
    m = dict(embedding_dim=2304, num_heads=32, vocab_size=20480,
             kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
             v_head_dim=128, intermediate_size=9216,
             moe_intermediate_size=1024, n_shared_experts=1,
             n_routed_experts=256, first_k_dense_replace=1, num_layers=9,
             kda_layers=(0, 1, 2, 4, 5, 6, 8), kda_num_heads=32,
             kda_head_dim=128)
    A = 32768 * 8 * 8 / 256 * 8
    step = counts.train_flops(m, 1, 32768, A)
    assert 1.7e14 < step < 2.1e14
    core_share = 3 * 2 * moon_counts.attention_core_flops(m, 1, 32768) / step
    assert 0.3 < core_share < 0.4


def test_the_benchmark_copy_of_the_reference_is_the_ports():
    root = Path(core.ROOT)
    assert (root / "perfbench/reference/kimi_linear_plain.py").read_bytes() \
        == (root / "aura_snn_rag_tpu_torch/reference/kimi_linear.py") \
        .read_bytes()


def test_the_references_and_counts_import_nothing_of_the_port():
    code = (f"import json, sys; sys.path.insert(0, {str(core.ROOT)!r})\n"
            "import perfbench.reference.kimi_linear_plain, "
            "perfbench.reference.kimi_linear_train, "
            "perfbench.counts.kimi_linear\n"
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
                                   "route_gap", "expert_err", "kda_err",
                                   "kda_core_err"}
    if trace:
        assert "kda_device_ms.kimi_train" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_unchanged_state_is_not_correct(capsys, monkeypatch):
    from aura_snn_rag_tpu_torch.training import optim
    monkeypatch.setattr(optim.ClippedAdamW, "step",
                        lambda self, loss, lr_scale=1.0: None)
    line = one_run(capsys)
    assert line["correct"] is False
    assert line["checks"]["change_err"]["value"] == pytest.approx(1.0)


class _HalfGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * 0.5


def test_a_wrong_decay_gradient_is_not_correct(capsys, monkeypatch):
    """The decay g gets half its gradient: the gate's leaves (A_log,
    dt_bias, f_a, f_b) are a few of the model's, which the median leaf
    does not see; `kda_err` does."""
    from aura_snn_rag_tpu_torch.models import layers
    real = layers.kda

    def halved(q, k, v, g, beta):
        return real(q, k, v, _HalfGrad.apply(g), beta)
    monkeypatch.setattr(layers, "kda", halved)
    line = one_run(capsys)
    assert line["checks"]["kda_err"]["ok"] is False


def test_a_core_in_bf16_is_not_correct(capsys, monkeypatch):
    """The core's output rounded to bf16: under the model's other noise
    for its numbers, not for `kda_core_err`."""
    from aura_snn_rag_tpu_torch.models import layers
    real = layers.kda

    def rounded(q, k, v, g, beta):
        return real(q, k, v, g, beta).bfloat16().float()
    monkeypatch.setattr(layers, "kda", rounded)
    line = one_run(capsys)
    assert line["checks"]["kda_core_err"]["ok"] is False
