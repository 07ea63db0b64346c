"""Rank-side code of the port's model-parallel tests (tensor, sequence,
expert and pipeline parallelism), run on gloo ranks by
`tests/test_torch_ranks.spawn("tests.test_torch_mp_ranks:<name>", ...)`.
Like `test_torch_ranks`, this module imports torch, numpy and the port
alone: the ranks never load JAX. Each scenario returns a dict of numpy
arrays, which `spawn` hands back per rank."""

import dataclasses
import math
import os

import numpy as np
import torch


def _mesh(shape, names):
    from aura_snn_rag_tpu_torch.parallel.distributed import mesh_from_ranks
    return mesh_from_ranks(np.arange(math.prod(shape)).reshape(shape),
                           names)


def _coord(mesh, axis):
    from aura_snn_rag_tpu_torch.parallel.mesh import axis_index, axis_size
    if axis not in mesh.mesh_dim_names:
        return 0, 1
    return axis_index(mesh, axis), axis_size(mesh, axis)


def _part(x, dim, index, n):
    return x.chunk(n, dim=dim)[index]


# --------------------------------------------------------------------------
# ring attention
# --------------------------------------------------------------------------

def ring(inputs, tmp, cases):
    """`sequence_sharded_attention` on this rank's rows, chunk and heads of
    q, k, v [B, L, H, Dh], for each case (mesh shape, axis names, causal);
    the loss mean((out - tgt)^2) over the whole arrays, each rank's share
    its own elements' sum over the whole count, backpropagated. Returns
    each case's output and q/k/v gradients, and the rank's coordinates
    (data, seq, model)."""
    from aura_snn_rag_tpu_torch.parallel.ring_attention import (
        sequence_sharded_attention)
    q, k, v, tgt = (torch.from_numpy(inputs[n]) for n in
                    ("q", "k", "v", "tgt"))
    out = {}
    for i, (shape, names, causal) in enumerate(cases):
        mesh = _mesh(shape, names)
        (di, dn), (si, sn), (mi, mn) = (_coord(mesh, a) for a in
                                        ("data", "seq", "model"))

        def cut(x):
            return _part(_part(_part(x, 0, di, dn), 1, si, sn), 2, mi, mn)
        ql, kl, vl = (cut(x).clone().requires_grad_() for x in (q, k, v))
        o = sequence_sharded_attention(
            ql, kl, vl, mesh, batch_axes=("data",) if dn > 1 else (),
            head_axis="model" if mn > 1 else None, causal=causal)
        (((o - cut(tgt)) ** 2).sum() / tgt.numel()).backward()
        out[f"{i}/coords"] = np.asarray([di, si, mi])
        out[f"{i}/out"] = o.detach().numpy()
        for name, t in (("q", ql), ("k", kl), ("v", vl)):
            out[f"{i}/g{name}"] = t.grad.numpy()
    return out


# --------------------------------------------------------------------------
# the trainers
# --------------------------------------------------------------------------

def _trainer(config, inputs, seed=0):
    """A CPU port Trainer holding the weights in `inputs` ("flat", and
    the amygdala's "amygdala/..." state_dict entries)."""
    import aura_snn_rag_tpu_torch as port
    tt = port.Trainer(config, seed=seed, device="cpu")
    with torch.no_grad():
        tt.optimizer.flat.copy_(torch.from_numpy(inputs["flat"]))
    if tt.amygdala is not None:
        tt.amygdala.load_state_dict({
            k.split("/", 1)[1]: torch.from_numpy(v)
            for k, v in inputs.items() if k.startswith("amygdala/")})
    return tt


def trainer_steps(inputs, tmp, shape, names, config, shard_memory=False):
    """`train_step`s over `inputs["ids"]` after `shard_to_mesh` on a mesh
    of `shape` and `names`: the metrics, the first step's first moment
    and the parameters after the steps, in the unsharded layout."""
    tt = _trainer(config, inputs)
    mesh = _mesh(shape, names)
    tt.shard_to_mesh(mesh, shard_memory=shard_memory)
    out = {"seq_axis": np.asarray(str(tt._seq_axis)),
           "model_has_mesh": np.bool_(tt.model.mesh is not None),
           "eval_loss": np.float64(tt.eval_loss(inputs["ids"][0],
                                                inputs["ids"][0]))}
    metrics = []
    for i, ids in enumerate(inputs["ids"]):
        m = tt.train_step(ids, ids)
        metrics.append([m["loss"], m["ce"], m["use_memory"]])
        if i == 0:
            out["mu_first_step"] = tt.full_tensors(
                tt.optimizer.state.mu).float().numpy().copy()
    latest = tt.latest_metrics()
    out["metrics"] = np.asarray(metrics, np.float64)
    out["latest"] = np.asarray([latest["loss"], latest["ce"]], np.float64)
    out["flat"] = tt.full_tensors(tt.optimizer.flat).detach().numpy().copy()
    out["local_numel"] = np.int64(tt.optimizer.flat.numel())
    # a sequence that does not divide over the mesh's 'seq' axis
    if "seq" in names:
        import aura_snn_rag_tpu_torch as port
        bad = config.replace(model=dataclasses.replace(
            config.model, max_seq_len=config.model.max_seq_len - 1))
        try:
            port.Trainer(bad, device="cpu").shard_to_mesh(mesh)
            out["indivisible_raises"] = np.bool_(False)
        except ValueError:
            out["indivisible_raises"] = np.bool_(True)
    return out


def tp_checkpoint(inputs, tmp, config):
    """The JAX package's `test_multislice_bank_roundtrip` with 'model' = 2:
    a trainer on `multislice_mesh(2, 2)`, rows written to its sharded bank,
    saved, and restored into a fresh trainer (another seed) on the same
    mesh. Returns the bank, the parameters and moments in the unsharded
    layout before and after, and what the file holds."""
    from aura_snn_rag_tpu_torch.memory.sharded import write_memories_sharded
    from aura_snn_rag_tpu_torch.memory.state import state_to_numpy
    from aura_snn_rag_tpu_torch.parallel.distributed import multislice_mesh
    from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
    mesh = multislice_mesh(2, 2)
    tt = _trainer(config, inputs)
    tt.shard_to_mesh(mesh, shard_memory=True)
    tt.train_step(inputs["ids"], inputs["ids"])     # moments to restore
    feats = torch.from_numpy(inputs["feats"])
    tt.hippocampus._set_state(write_memories_sharded(
        config.memory, mesh, tt.hippocampus.state, feats,
        torch.zeros(len(feats), config.memory.spatial_dims),
        ("replica", "data")))
    out = {"batch_axes": np.asarray(list(tt._batch_axes)),
           "tp_size": np.int64(tt._tp.size)}
    before = [tt.full_tensors(t).float().numpy().copy() for t in
              (tt.optimizer.flat, tt.optimizer.state.mu)]
    bank = [a.copy() for a in state_to_numpy(tt.hippocampus.state)]
    ckpt = CheckpointManager(os.path.join(tmp, "ck"))
    ckpt.save(5, tt, loss=1.0)
    fresh = _trainer(config, dict(inputs, flat=inputs["other_flat"]),
                     seed=1)
    fresh.shard_to_mesh(mesh, shard_memory=True)
    out["restored_step"] = np.int64(ckpt.restore(fresh))
    after = [fresh.full_tensors(t).float().numpy() for t in
             (fresh.optimizer.flat, fresh.optimizer.state.mu)]
    out["params_equal"] = np.bool_(np.array_equal(before[0], after[0]))
    out["mu_equal"] = np.bool_(np.array_equal(before[1], after[1]))
    out["local_equal"] = np.bool_(torch.equal(tt.optimizer.flat,
                                              fresh.optimizer.flat))
    out["bank_equal"] = np.asarray([
        np.array_equal(a, b) for a, b in
        zip(bank, state_to_numpy(fresh.hippocampus.state))])
    out["count"] = np.asarray(state_to_numpy(fresh.hippocampus.state).count)
    out["flat"] = before[0]
    payload = torch.load(ckpt.path(5), map_location="cpu",
                         weights_only=True)
    out["saved_params"] = payload["params"].numpy()
    return out


# --------------------------------------------------------------------------
# tensor- and expert-parallel modules, and the server
# --------------------------------------------------------------------------

def tp_modules(inputs, tmp, lm, serve):
    """Over a ('data', 'model') mesh of (1, world): `global_mesh(2)`; the
    expert bank's sharded forward; and a tensor-parallel `BatchedGenerator`
    against the single-device one, both from `inputs`' weights."""
    import aura_snn_rag_tpu_torch as port
    import torch.distributed as dist
    from aura_snn_rag_tpu_torch.generation.serving import (
        BatchedGenerator, GenerationRequest)
    from aura_snn_rag_tpu_torch.models.language_zone import ExpertBank
    from aura_snn_rag_tpu_torch.parallel import distributed as d
    from aura_snn_rag_tpu_torch.parallel.mesh import shard_params
    world = dist.get_world_size()
    out = {"global_mesh_2": np.asarray(d.global_mesh(n_model=2).mesh.shape)}
    mesh = _mesh((1, world), ("data", "model"))

    # expert parallelism: E / world experts here
    bank = ExpertBank(int(inputs["ep/E"]), int(inputs["ep/D"]),
                      int(inputs["ep/D"]), int(inputs["ep/D"]), levels=4,
                      capacity_factor=8.0, device="cpu")
    bank.load_state_dict({k[len("ep/sd/"):]: torch.from_numpy(v)
                          for k, v in inputs.items()
                          if k.startswith("ep/sd/")})
    shard_params(bank, mesh)
    out["ep/local_experts"] = np.int64(bank.experts.syn1.kernel.shape[0])
    x = torch.from_numpy(inputs["ep/x"])
    routing = {"indices": torch.from_numpy(inputs["ep/idx"]).long(),
               "weights": torch.from_numpy(inputs["ep/w"])}
    y, aux = bank(x, routing)
    out["ep/y"] = y.detach().numpy()
    out["ep/dropped"] = np.float64(aux["dropped_fraction"])
    out["ep/dense"] = bank(x).detach().numpy()

    # tensor-parallel decode against the whole model's
    cfg = port.ModelConfig(**lm)
    model = port.HippocampalTransformer(cfg, device="cpu")
    model.load_state_dict({k[len("lm/"):]: torch.from_numpy(v)
                           for k, v in inputs.items()
                           if k.startswith("lm/")})
    model.eval()
    prompt = np.asarray(serve["prompt"])

    def request():
        return [GenerationRequest(prompt, temperature=serve["temperature"],
                                  top_p=1.0,
                                  max_new_tokens=serve["max_new_tokens"])]
    kw = dict(batch_size=serve["batch_size"], prompt_pad=serve["prompt_pad"],
              max_new_tokens=serve["max_new_tokens"])
    plain = BatchedGenerator(model, **kw).generate_batch(request())[0]
    tp = BatchedGenerator(model, mesh=mesh, **kw)
    out["serve/plain"] = np.asarray(plain)
    out["serve/tp"] = np.asarray(tp.generate_batch(request())[0])
    out["serve/local_heads"] = np.int64(
        tp.model.init_kv_caches(1, 4)[0][0].shape[1])
    out["serve/model_left_whole"] = np.bool_(
        model.layers[0].attention.tp is None)
    return out


# --------------------------------------------------------------------------
# the pipeline and the pipelined LM
# --------------------------------------------------------------------------

def _block(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


def pipeline(inputs, tmp, cases):
    """`pipeline_apply` of the JAX tests' two-matmul block over the mesh's
    'stage' axis, for each case (name, mesh shape, axis names,
    microbatches): the output, and this rank's stage's gradients of
    mean((out - tgt)^2)."""
    from aura_snn_rag_tpu_torch.parallel.mesh import axis_index, axis_size
    from aura_snn_rag_tpu_torch.parallel.pipeline import (
        pipeline_apply, split_microbatches, stack_stage_params)
    out = {}
    for name, shape, names, M in cases:
        mesh = _mesh(shape, names)
        S = axis_size(mesh, "stage")
        per_stage = [{k: torch.from_numpy(inputs[f"{name}/p{s}/{k}"])
                      .requires_grad_() for k in ("w1", "b1", "w2")}
                     for s in range(S)]
        mine = stack_stage_params(per_stage, mesh)
        x = torch.from_numpy(inputs[f"{name}/x"])
        got = pipeline_apply(_block, mine, split_microbatches(x, M), mesh)
        ((got - torch.from_numpy(inputs[f"{name}/tgt"])) ** 2).mean() \
            .backward()
        out[f"{name}/out"] = got.detach().numpy()
        out[f"{name}/stage"] = np.int64(axis_index(mesh, "stage"))
        for k, t in mine.items():
            out[f"{name}/grad/{k}"] = t.grad.numpy()
    return out


def pipeline_suite(inputs, tmp, toy, models):
    """`pipeline`'s cases and `pipelined`'s, in one group."""
    return {**pipeline(inputs, tmp, toy), **pipelined(inputs, tmp, models)}


def pipelined(inputs, tmp, cases):
    """`pipelined_lm_apply` / `pipelined_rag_apply` over a 'stage' mesh of
    every rank, for each case (name, config, RAG, prosody, microbatches,
    with a loss and gradient): logits, and for a gradient case the loss
    hippocampal_loss(logits[:, :-1], ids[:, 1:]) and every parameter's
    gradient (this rank's stage's layers and the replicated rest; the
    other stages' layers are reported as zeros)."""
    import aura_snn_rag_tpu_torch as port
    import torch.distributed as dist
    from aura_snn_rag_tpu_torch.memory.state import (
        MemoryState, init_memory_state, state_from_numpy)
    from aura_snn_rag_tpu_torch.models.pipelined import (
        pipelined_lm_apply, pipelined_rag_apply)
    from aura_snn_rag_tpu_torch.training.losses import hippocampal_loss
    mesh = _mesh((dist.get_world_size(),), ("stage",))
    out = {}
    for name, lm, mem, rag, with_prosody, M, grad in cases:
        cfg = port.ModelConfig(**lm)
        mcfg = port.MemoryConfig(**mem) if rag else None
        model = port.HippocampalTransformer(cfg, mcfg, device="cpu")
        model.load_state_dict({k[len(name) + 4:]: torch.from_numpy(v)
                               for k, v in inputs.items()
                               if k.startswith(f"{name}/sd/")})
        model.eval()
        ids = torch.from_numpy(inputs[f"{name}/ids"]).long()
        prosody = (torch.from_numpy(inputs[f"{name}/prosody"])
                   if with_prosody else None)
        kw = {}
        if rag:
            ms = state_from_numpy(
                [inputs[f"{name}/bank/{f}"] for f in MemoryState._fields],
                "cpu")
            with torch.no_grad():
                logits = pipelined_rag_apply(model, ids, ms, mesh, M,
                                             prosody)
                empty = pipelined_rag_apply(
                    model, ids, init_memory_state(mcfg, "cpu"), mesh, M,
                    prosody)
            out[f"{name}/empty_logits"] = empty.numpy()
            kw = dict(memory_state=ms)
        else:
            with torch.no_grad():
                logits = pipelined_lm_apply(model, ids, mesh, M, prosody)
        out[f"{name}/logits"] = logits.numpy()
        if grad:
            model.train()
            fn = pipelined_rag_apply if rag else pipelined_lm_apply
            args = (model, ids, kw["memory_state"]) if rag else (model, ids)
            loss = hippocampal_loss(
                fn(*args, mesh, M, prosody)[:, :-1], ids[:, 1:], None,
                label_smoothing=0.0, entropy_lambda=0.0, sparsity_lambda=0.0)
            loss.backward()
            out[f"{name}/loss"] = np.float64(loss)
            for pname, p in model.named_parameters():
                out[f"{name}/grad/{pname}"] = (
                    np.zeros(tuple(p.shape), np.float32) if p.grad is None
                    else p.grad.numpy())
    return out


def pp_xl(inputs, tmp, model):
    """`examples/dryrun_pp_xl.rank_work` on a ('stage', 'data') = (4, 2)
    mesh, this rank's stage's layers loaded from the JAX script's stacked
    per-stage trees (`s<stage>/l<layer>/<flax path>`): the record's loss,
    its repeat, the gradient norm and the trunk's parameters."""
    import torch.distributed as dist
    from aura_snn_rag_tpu_torch.config import ModelConfig
    from aura_snn_rag_tpu_torch.examples import dryrun_pp_xl
    from aura_snn_rag_tpu_torch.models.convert import tree_to_state_dict
    from aura_snn_rag_tpu_torch.models.layers import TransformerLayer
    cfg = ModelConfig(**model)
    stage = dist.get_rank() // dryrun_pp_xl.DATA
    per = cfg.num_layers // dryrun_pp_xl.STAGES
    layers = []
    for i in range(per):
        prefix = f"s{stage}/l{i}/"
        tree = {}
        for key, value in inputs.items():
            if key.startswith(prefix):
                node = tree
                *path, leaf = key[len(prefix):].split(".")
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = value
        layer = TransformerLayer(cfg, device="cpu")
        missing, unexpected = layer.load_state_dict(
            tree_to_state_dict(tree), strict=False)
        # flax makes no prosody gate for a forward without prosody
        assert not unexpected and all(k.startswith("attention.prosody_gate")
                                      for k in missing), missing
        layers.append(layer)
    rec = dryrun_pp_xl.rank_work((dryrun_pp_xl.STAGES, dryrun_pp_xl.DATA),
                                 layers=layers, cfg=cfg).record
    return {k: np.asarray(rec[k]) for k in ("loss", "loss_repeat",
                                            "grad_norm", "trunk_params")}
