"""Rank-side code of the port's multi-process tests, and the harness that
spawns it.

`spawn(scenario, world, tmp_path, inputs, **kw)` starts `world` processes
(the spawn method), each of which joins a gloo group through a `file://`
rendezvous under `tmp_path` (so parallel test workers never share a
port), runs `SCENARIOS[scenario](inputs, **kw)` (or, for a scenario
named "module:function", that function of that module, which must not
import JAX either) and writes what it returns to `out<rank>.npz`.
Inputs travel as `inputs.npz`. Every collective and the rendezvous time
out after GROUP_TIMEOUT seconds and the join after `timeout`, so a hang
fails one test. This module imports torch, numpy and the port alone: the
ranks never load JAX.
"""

import multiprocessing
import os
import time
import traceback

import numpy as np
import pytest
import torch

GROUP_TIMEOUT = 30          # seconds: the rendezvous and each collective
JOIN_TIMEOUT = 150          # seconds: the whole scenario


def spawn(scenario, world, tmp_path, inputs=None, timeout=JOIN_TIMEOUT,
          **kwargs):
    """Run `scenario` on `world` gloo ranks; returns each rank's outputs
    (a dict of numpy arrays) in rank order."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "inputs.npz"), **(inputs or {}))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_main,
                         args=(scenario, rank, world, tmp, kwargs))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for rank in range(world):
        path = os.path.join(tmp, f"error{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    if hung or errors or any(p.exitcode for p in procs):
        pytest.fail(f"{scenario} on {world} ranks: hung {hung}, exit codes "
                    f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [dict(np.load(os.path.join(tmp, f"out{rank}.npz")))
            for rank in range(world)]


def _main(scenario, rank, world, tmp, kwargs):
    torch.set_num_threads(1)
    from aura_snn_rag_tpu_torch.parallel import distributed
    try:
        if kwargs.pop("via_env", False):
            # the launcher's variables, as a job script would export them
            os.environ.update(AURA_COORDINATOR=f"file://{tmp}/rendezvous",
                              AURA_NUM_PROCESSES=str(world),
                              AURA_PROCESS_ID=str(rank))
            distributed.initialize(device="cpu", timeout=GROUP_TIMEOUT)
        else:
            distributed.initialize(f"file://{tmp}/rendezvous", world, rank,
                                   device="cpu", timeout=GROUP_TIMEOUT)
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        if ":" in scenario:
            import importlib
            module, name = scenario.split(":")
            fn = getattr(importlib.import_module(module), name)
        else:
            fn = SCENARIOS[scenario]
        out = fn(inputs, tmp=tmp, **kwargs)
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        distributed.shutdown()


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------

def mesh_of(shape):
    """(n,) -> ('data', 'model') of (n, 1); (r, d) -> the multislice
    ('replica', 'data', 'model') mesh of (r, d, 1). Returns (mesh, bank
    axes)."""
    from aura_snn_rag_tpu_torch.parallel import distributed
    if len(shape) == 1:
        return distributed.global_mesh(1), ("data",)
    return distributed.multislice_mesh(shape[0], 1), ("replica", "data")


def _state_out(prefix, state):
    from aura_snn_rag_tpu_torch.memory.state import state_to_numpy
    return {f"{prefix}/{name}": a.copy() for name, a in
            zip(state._fields, state_to_numpy(state))}


def _result_out(prefix, res):
    return {f"{prefix}/indices": res.indices.numpy().copy(),
            f"{prefix}/scores": res.scores.detach().numpy().copy(),
            f"{prefix}/features": res.features.numpy().copy()}


def sharded_bank(inputs, tmp, shape, memory, k):
    """write -> retrieve -> decay -> rebuild (from injected init rows) ->
    retrieve (IVF and flat) -> the queries' gradient through the merge.
    """
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.memory import engine, sharded
    from aura_snn_rag_tpu_torch.parallel.collectives import all_reduce_mean_
    from aura_snn_rag_tpu_torch.parallel.mesh import axes_index, axes_size

    mesh, axes = mesh_of(shape)
    cfg = port.MemoryConfig(**memory)
    s, S = axes_index(mesh, axes), axes_size(mesh, axes)
    feats = torch.from_numpy(inputs["feats"])
    locs = torch.zeros(len(feats), cfg.spatial_dims)
    out = {}
    st = sharded.init_sharded_memory(cfg, mesh, axes)
    st = sharded.write_memories_sharded(cfg, mesh, st, feats, locs, axes)
    out.update(_state_out("written", st))
    q = torch.from_numpy(inputs["queries"])
    out.update(_result_out("fresh", sharded.retrieve_sharded(
        cfg, mesh, st, q, k, axes)))
    st = sharded.decay_memories_sharded(st, float(inputs["decay"]))
    out.update(_state_out("decayed", st))

    init_idx = torch.from_numpy(inputs["init_idx"][s])

    def injected(config, state, generator=None):
        return engine._rebuild_from_init(config, state, init_idx)
    real, engine.rebuild_centroids = engine.rebuild_centroids, injected
    try:
        st = sharded.rebuild_centroids_sharded(cfg, mesh, st, 0, axes)
    finally:
        engine.rebuild_centroids = real
    out.update(_state_out("rebuilt", st))
    for name in ("ivf", "flat"):
        out.update(_result_out(name, sharded.retrieve_sharded(
            cfg, mesh, st, torch.from_numpy(inputs[f"{name}_queries"]), k,
            axes)))

    # d(sum(scores * weights))/dW with queries x @ W, replicated: every
    # rank's loss is the replicated loss over S, and W's gradient sums
    # over the ranks (data parallelism's all-reduce, times S)
    W = torch.from_numpy(inputs["W"]).requires_grad_()
    x = torch.from_numpy(inputs["x"])
    res = sharded.retrieve_sharded(cfg, mesh, st, x @ W, k, axes)
    ((res.scores * torch.from_numpy(inputs["cw"])).sum() / S).backward()
    out["grad_W"] = all_reduce_mean_(W.grad, mesh, axes).mul_(S).numpy()
    out.update(_result_out("grad_forward", res))
    return out


def _load_trainer(cfg, inputs, seed=0):
    """A CPU port Trainer holding the weights in `inputs` ("flat", and
    "amygdala/..." and "thalamus/..." state_dict entries)."""
    import aura_snn_rag_tpu_torch as port
    tt = port.Trainer(cfg, seed=seed, device="cpu")
    with torch.no_grad():
        tt.optimizer.flat.copy_(torch.from_numpy(inputs["flat"]))
    for name in ("amygdala", "thalamus"):
        module = getattr(tt, name)
        if module is not None:
            module.load_state_dict({
                k.split("/", 1)[1]: torch.from_numpy(v)
                for k, v in inputs.items() if k.startswith(name + "/")})
    return tt


def _tensors(tt):
    count, mu, nu = tt.optimizer.state
    return ([tt.optimizer.flat, count, mu, nu] + list(tt.hippocampus.state)
            + list(tt.hippocampus.cognitive_map))


def dp_trainer(inputs, tmp, shape, config, shard_memory=True):
    """`train_step`s over `inputs["ids"]` after `shard_to_mesh`, then a
    checkpoint round trip into a fresh trainer on the same mesh."""
    from aura_snn_rag_tpu_torch.memory.state import state_to_numpy
    from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager

    mesh, _ = mesh_of(shape)
    tt = _load_trainer(config, inputs)
    tt.shard_to_mesh(mesh, shard_memory=shard_memory)
    out = {"eval_loss": np.float64(tt.eval_loss(inputs["ids"][0],
                                                inputs["ids"][0]))}
    metrics = []
    for i, ids in enumerate(inputs["ids"]):
        m = tt.train_step(ids, ids)
        metrics.append([m["loss"], m["ce"], m["use_memory"]])
        if i == 0:
            out["mu_first_step"] = tt.optimizer.state.mu.float().numpy().copy()
    latest = tt.latest_metrics()
    out["metrics"] = np.asarray(metrics, np.float64)
    out["latest"] = np.asarray([latest["loss"], latest["ce"]], np.float64)
    out["flat"] = tt.optimizer.flat.detach().numpy().copy()
    out.update({f"bank/{k}": v.copy() for k, v in zip(
        tt.hippocampus.state._fields, state_to_numpy(tt.hippocampus.state))})

    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    ckpt.save(len(inputs["ids"]), tt, loss=latest["loss"])
    fresh = _load_trainer(config, inputs, seed=1)
    fresh.shard_to_mesh(mesh, shard_memory=shard_memory)
    step = ckpt.restore(fresh)
    out["restored_step"] = np.int64(step)
    out["restored_equal"] = np.asarray([
        torch.equal(a, b) for a, b in zip(_tensors(tt), _tensors(fresh))])
    payload = torch.load(ckpt.path(step), map_location="cpu",
                         weights_only=True)
    out["saved_layout"] = np.asarray(str(payload.get("memory_layout")))
    out.update({f"saved/{k}": (v.float() if v.dtype == torch.bfloat16
                               else v).numpy()
                for k, v in payload["memory_state"].items()})
    # a checkpoint of one layout does not restore into another
    try:
        ckpt.restore(_load_trainer(config, inputs, seed=2))
        out["cross_layout_raises"] = np.bool_(False)
    except ValueError:
        out["cross_layout_raises"] = np.bool_(True)
    return out


def two_process(inputs, tmp):
    """The launcher seam on two processes: `initialize` again (a no-op),
    meshes, this process's batch slice, a global array's slice and the
    collective that assembles it, the model-parallel axes that
    `shard_to_mesh` and `shard_params` take, and a data-parallel trainer
    and its checkpoint on a mesh of one of the two ranks."""
    import torch.distributed as dist
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.parallel import distributed as d
    from aura_snn_rag_tpu_torch.parallel import mesh as m

    out = {"initialize_again": np.bool_(d.initialize()),
           "multiprocess": np.bool_(d.is_multiprocess())}
    mesh = d.global_mesh(1)
    out["mesh_shape"] = np.asarray(mesh.mesh.shape)
    out["multislice_shape"] = np.asarray(d.multislice_mesh(2, 1).mesh.shape)
    out["model_mesh_shape"] = np.asarray(d.global_mesh(2).mesh.shape)
    sl = d.local_batch_slice(8)
    out["slice"] = np.asarray([sl.start, sl.stop])
    full = np.arange(8, dtype=np.float32)[:, None]
    g = d.make_global_array(full[sl], mesh)
    out["global_shape"] = np.asarray(g.global_shape)
    out["start"] = np.int64(g.start)
    parts = [torch.empty_like(g.local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, g.local)
    out["total"] = np.float64(torch.cat(parts).sum())
    out["shard_batch"] = m.shard_batch({"x": full}, mesh)["x"].numpy()
    raised = []
    for names in (("data", "model"), ("data", "seq"), ("data", "stage")):
        mp = d.mesh_from_ranks(np.arange(2).reshape(1, 2), names)
        tt = port.Trainer(port.get_debug_config(), device="cpu")
        try:
            tt.shard_to_mesh(mp)
            raised.append(False)
        except NotImplementedError:
            raised.append(True)
    try:
        m.shard_params(torch.zeros(3), d.global_mesh(2))
        raised.append(False)
    except NotImplementedError:
        raised.append(True)
    out["model_parallel_raises"] = np.asarray(raised)
    out["make_mesh_shape"] = np.asarray(m.make_mesh(1).mesh.shape)

    # data parallelism over a replicated bank (shard_memory=False)
    tt = port.Trainer(replicated_bank_config(), seed=0, device="cpu")
    tt.shard_to_mesh(mesh, shard_memory=False)
    ids = np.asarray(inputs["ids"])
    out["replicated/losses"] = np.asarray(
        [tt.train_step(x, x)["loss"] for x in ids])
    out["replicated/flat"] = tt.optimizer.flat.detach().numpy().copy()
    out["replicated/count"] = np.int64(tt.hippocampus.state.count)

    # a mesh of some of the job's ranks: rank 1 alone takes a step with a
    # sharded bank and saves and restores it; rank 0 joins none of it
    from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
    sub = m.make_mesh(1, devices=[1])
    if dist.get_rank() == 1:
        tt = port.Trainer(replicated_bank_config(), seed=0, device="cpu")
        tt.shard_to_mesh(sub)
        tt.train_step(ids[0], ids[0])
        ckpt = CheckpointManager(os.path.join(tmp, "subset_ckpt"))
        ckpt.save(1, tt)
        fresh = port.Trainer(replicated_bank_config(), seed=1, device="cpu")
        fresh.shard_to_mesh(sub)
        out["subset/restored_step"] = np.int64(ckpt.restore(fresh))
        out["subset/restored_equal"] = np.asarray([
            torch.equal(a, b) for a, b in zip(_tensors(tt), _tensors(fresh))])
    return out


def replicated_bank_config():
    """The debug preset with RAG, memory and a store at every step,
    dropout 0 and no thalamus gate."""
    import dataclasses
    import aura_snn_rag_tpu_torch as port
    cfg = port.get_debug_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, use_rag=True, dropout=0.0),
        training=dataclasses.replace(
            cfg.training, memory_warmup_steps=0, enable_thalamus=False,
            memory_store_interval=1))


SCENARIOS = {
    "two_process": two_process,
    "sharded_bank": sharded_bank,
    "dp_trainer": dp_trainer,
}
