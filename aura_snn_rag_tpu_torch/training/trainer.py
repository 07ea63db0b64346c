"""Training harness for the hippocampal transformer: wake steps with the
modulators, episodic writes, sleep-phase replay, EWC (counterpart of
`aura_snn_rag_tpu/training/trainer.py`).

A wake step (`train_step`), as in the JAX package:
- prosody from the amygdala on the token embeddings (no gradient), the
  thalamus gate |routed language signal| clamped to [0.5, 1.5];
- memory on once `memory_warmup_steps` have passed and the endocrine
  gate times the thalamus gate (both from the previous step) is at least
  0.9; a store every `memory_store_interval` steps while memory is on;
- forward, `hippocampal_loss` and backward over
  `gradient_accumulation_steps` micro-batches (each with its own labels,
  prosody slice and dropout seed; gradients accumulate in place), the
  EWC penalty's gradient added once per step;
- `ClippedAdamW` (optax's clip + adamw chain) with the endocrine LR
  scale, skipped on the device when the loss is not finite;
- the batch's `memory_summary` written to the bank on a store step, and
  the bank's clock advanced one step;
- the metrics (loss, ce, thalamus gate) read back one step late: step s
  reads step s - 1's, which finished while step s was being queued (the
  first step reads its own), and the modulators run on those;
- replay buffer, telemetry, periodic memory decay and the sleep phase
  at their intervals.

What differs from the JAX package: no jit (each step runs eagerly), the
parameters live in the optimizer's flat buffer, and the dropout masks
come from per-step seeds (`layers.Dropout`) and are not JAX's bits.

With DeepSeek-V3's stem (`config.DeepSeekV3Config`, `KimiLinearConfig`; no JAX
counterpart) the step is the same with three differences: the loss has
no place-code term (the model has no place cells), the modulators read
the plain token embedding, and after the optimizer step every MoE layer
moves its routing bias by the step's per-expert loads, which it counted
on the device (`MoEFFN.update_bias`, no host sync). It trains on one
rank (`shard_to_mesh` refuses it).

`shard_to_mesh` trains over a DeviceMesh, one process per device, on
every mesh the JAX package's `Trainer.shard_to_mesh` takes:
- data parallelism over the batch axes (every axis but 'model', 'seq'
  and 'stage'): each rank takes its rows of every batch, the batch-level
  values (the amygdala's mean sentiment, the thalamus gate, the loss
  behind the endocrine step and the finite check) and the gradient are
  all-reduced to their global values, and the bank is sharded over the
  batch axes (`memory/sharded.py`);
- tensor parallelism over 'model' (`parallel.mesh.shard_params`): the
  optimizer is rebuilt over this rank's parts, its clip takes the global
  norm, and a checkpoint holds the whole tensors;
- sequence parallelism over 'seq': each rank takes its chunk of the
  sequence, the model runs ring attention, the next-token targets cross
  the chunks' edges (the last position of a chunk predicts the first
  token of the next; the reversed replay's too), the losses are means
  over the whole sequence, and the gradient is summed over the chunks;
- 'stage' is a replicated axis, as in the JAX trainer (its pipeline is
  `models/pipelined.py`'s functions, not the trainer).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import AuraConfig
from aura_snn_rag_tpu_torch.memory import engine as memory_engine
from aura_snn_rag_tpu_torch.memory.hippocampus import HippocampalFormation
from aura_snn_rag_tpu_torch.memory.sharded import (
    init_sharded_memory, retrieve_sharded, write_memories_sharded)
from aura_snn_rag_tpu_torch.models.brain.amygdala import (
    Amygdala, build_prosody)
from aura_snn_rag_tpu_torch.models.brain.endocrine import EndocrineSystem
from aura_snn_rag_tpu_torch.models.brain.thalamus import Thalamus
from aura_snn_rag_tpu_torch.models.layers import initialize
from aura_snn_rag_tpu_torch.models.transformer import HippocampalTransformer
from aura_snn_rag_tpu_torch.parallel.collectives import (
    all_reduce_mean_, gather_dim, gather_rows)
from aura_snn_rag_tpu_torch.parallel.mesh import (
    axis_index, axis_size, batch_slice, mesh_device, param_specs,
    shard_dim, shard_params, take_shard, tensor_parallel)
from aura_snn_rag_tpu_torch.training.losses import hippocampal_loss
from aura_snn_rag_tpu_torch.training.optim import AdamWState, ClippedAdamW
from aura_snn_rag_tpu_torch.training.schedule import warmup_cosine_schedule
from aura_snn_rag_tpu_torch.utils.trace import host_sync, span
from aura_snn_rag_tpu_torch.zones.events import EventBus
from aura_snn_rag_tpu_torch.zones.stats import StatsCollector


class TrainState(NamedTuple):
    params: torch.Tensor       # [N] f32 buffer the parameters view
    opt_state: AdamWState
    step: int                  # steps taken, sleep-phase steps included


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class _ShardedRetrieve:
    """The RAG layers' `retrieve_fn` over the sharded bank: each rank
    holds its rows of the batch, and `retrieve_sharded` takes the whole
    batch on every rank, so the queries are gathered over the batch axes
    (with their gradient), retrieved, and this rank's rows kept. The
    gather's backward sums the queries' gradient over the ranks."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, axes

    def __call__(self, memory_config, memory_state, queries, k):
        grad = torch.is_grad_enabled() and queries.requires_grad
        full = gather_rows(queries, self.mesh, self.axes, grad)
        res = retrieve_sharded(memory_config, self.mesh, memory_state,
                               full, k, self.axes)
        rows = batch_slice(full.shape[0], self.mesh, self.axes)
        return memory_engine.RetrievalResult(
            res.indices[rows], res.scores[rows], res.features[rows])


class ReplayBuffer:
    """Host-side ring buffer of (input_ids, labels) batches with losses."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._items = []
        self._pos = 0

    def __len__(self):
        return len(self._items)

    def add(self, input_ids: np.ndarray, labels: np.ndarray, loss: float):
        item = (np.asarray(input_ids), np.asarray(labels), float(loss))
        if len(self._items) < self.capacity:
            self._items.append(item)
        else:
            self._items[self._pos] = item
            self._pos = (self._pos + 1) % self.capacity

    def sample(self, n: int, rng: np.random.RandomState):
        idx = rng.permutation(len(self._items))[:n]
        return [self._items[i] for i in idx]


class EWCConsolidator:
    """Elastic weight consolidation over the flat parameter buffer:
    Fisher = mean squared gradient over validation batches; penalty
    lambda * sum F (theta - theta*)^2, whose gradient 2 lambda F (theta -
    theta*) the trainer adds to each step's."""

    def __init__(self, ewc_lambda: float):
        self.ewc_lambda = ewc_lambda
        self.fisher: Optional[torch.Tensor] = None
        self.theta_star: Optional[torch.Tensor] = None

    def consolidate(self, grad_fn, params: torch.Tensor, batches,
                    max_batches: int = 50) -> None:
        """grad_fn(batch) -> the flat f32 gradient of that batch's loss."""
        sq_sum = None
        n = 0
        for batch in list(batches)[:max_batches]:
            g = grad_fn(batch).float()
            sq_sum = g * g if sq_sum is None else sq_sum.add_(g * g)
            n += 1
        if n == 0:
            return
        self.fisher = sq_sum / n
        self.theta_star = params.detach().clone()

    def penalty(self, params: torch.Tensor, total=torch.sum) -> torch.Tensor:
        """`total` sums the [N] terms (the optimizer's `global_sum` under
        tensor parallelism)."""
        if self.fisher is None:
            return torch.zeros((), device=params.device)
        return self.ewc_lambda * total(self.fisher
                                       * (params - self.theta_star) ** 2)

    def penalty_grad(self, params: torch.Tensor) -> torch.Tensor:
        return (2.0 * self.ewc_lambda) * self.fisher \
            * (params - self.theta_star)


class _Metrics:
    """A step's [loss, ce, thalamus gate] on its way to the host: on the
    card copied into pinned memory behind an event, so reading it waits
    for that step only."""

    def __init__(self, metrics: torch.Tensor):
        if metrics.is_cuda:
            self.buf = torch.empty(3, pin_memory=True)
            self.buf.copy_(metrics, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf, self.event = metrics.detach().clone(), None

    def read(self) -> np.ndarray:
        with host_sync("trainer.metrics"):
            if self.event is not None:
                self.event.synchronize()
            return self.buf.numpy().copy()


class Trainer:
    """End-to-end training harness for the hippocampal transformer. The
    model, bank and modulators live on `device` (CUDA unless the caller
    asks for the CPU, or for "meta"); their weights are drawn from
    `seed`."""

    def __init__(self, config: AuraConfig, seed: int = 0,
                 device: Union[str, torch.device, None] = "cuda"):
        self.config = config
        cfg, mcfg, tcfg = config.model, config.memory, config.training
        self.device = dev = resolve_device(device)
        # the meta device (a template: shapes and dtypes, no storage,
        # as `tools/verify_checkpoint` builds it) has no generator of its
        # own; its draws are no-ops
        gen = torch.Generator(device=dev if dev.type != "meta" else "cpu"
                              ).manual_seed(seed)
        self.model = HippocampalTransformer(
            cfg, mcfg if cfg.use_rag else None, device=dev, generator=gen)
        self.model.train()
        self._moe = self.model.moe_layers
        self.hippocampus = HippocampalFormation(mcfg, seed=seed + 1,
                                                device=dev)
        self.schedule = warmup_cosine_schedule(
            tcfg.lr, tcfg.warmup_steps, tcfg.max_steps, tcfg.min_lr_ratio)
        self.optimizer = ClippedAdamW(
            self.model.parameters(), self.schedule, tcfg.weight_decay,
            tcfg.gradient_clip, tcfg.optimizer_mu_dtype)

        # modulators (never trained, as in the JAX package)
        self.amygdala = None
        if tcfg.enable_amygdala:
            self.amygdala = Amygdala(cfg.embedding_dim, device=dev)
            initialize(self.amygdala, gen)
        self.endocrine = EndocrineSystem() if tcfg.enable_endocrine else None
        self.thalamus = None
        if tcfg.enable_thalamus:
            # single-region routing, as the reference's LM loop wires it
            self.thalamus = Thalamus(cfg.embedding_dim, ("language",),
                                     top_k=1, device=dev)
            initialize(self.thalamus, gen)

        self.replay = ReplayBuffer(tcfg.replay_buffer_size)
        self.ewc = EWCConsolidator(tcfg.ewc_lambda)
        self.stats = StatsCollector()
        self.event_bus = EventBus()
        self._np_rng = np.random.RandomState(seed)
        self._seed_rng = np.random.default_rng(seed)     # dropout seeds
        self._memory_gate_scale = 1.0
        self._thalamus_scale = 1.0
        self._hormones: Dict[str, float] = {}
        self._pending: Optional[_Metrics] = None
        self._last_fetched: Optional[np.ndarray] = None
        self._step = 0
        self.history: Dict[str, list] = {"loss": [], "step": []}
        self.mesh = None
        self._batch_axes: tuple = ()
        self._memory_mesh = None
        self._seq_axis: Optional[str] = None
        self._tp = None
        self._tp_dims: List[Optional[int]] = []

    @property
    def state(self) -> TrainState:
        return TrainState(self.optimizer.flat, self.optimizer.state,
                          self._step)

    def shard_to_mesh(self, mesh, shard_memory: bool = True) -> None:
        """Training over `mesh` (a DeviceMesh; each of its ranks calls this,
        with the trainer on its device).

        Every axis but 'model', the sequence axis and the stage axis is a
        batch axis ('data', or ('replica', 'data') on a multislice mesh).
        The parameters, the optimizer state and the modulators' weights
        are replicated by a broadcast from the mesh's first rank (the JAX
        package re-initialises the optimizer state here instead; the two
        agree on a fresh trainer). Each step then takes this rank's rows
        of the batch (`batch_slice`), all-reduces the batch-level values
        and the gradient (a mean over the batch axes, before clipping),
        and so takes the step JAX's whole-batch program takes.

        A 'model' axis larger than 1 splits the model's tensor-parallel
        weights (`shard_params`) and rebuilds the optimizer over this
        rank's parts, its moments cut from the replicated ones. A
        sequence axis larger than 1 (it must divide `max_seq_len`, as JAX
        asserts) gives each rank its chunk of every sequence and routes
        the model's attention through ring attention over it. A stage
        axis is replicated.

        With `shard_memory` the bank becomes a fresh bank sharded over the
        batch axes (per-shard capacity `memory.max_memories`; an existing
        bank is not migrated, as in the JAX package): the RAG layers
        retrieve through `retrieve_sharded` and a store step writes each
        shard's rows through `write_memories_sharded`. Without it every
        rank keeps its own whole bank, writes the whole batch's rows into
        it and retrieves its own rows through `retrieve_auto`."""
        if self._tp is not None:
            raise RuntimeError("the trainer's model is already split over "
                               "a 'model' axis; place a new trainer")
        if self.config.model.latent_stem:
            raise NotImplementedError(
                "DeepSeek-V3's stem (Moonlight's and Kimi-Linear's blocks) "
                "trains on one rank here: its expert loads and experts are "
                "not exchanged over a mesh")
        pcfg = self.config.parallel
        names = tuple(mesh.mesh_dim_names)
        seq_ax = pcfg.seq_axis_name
        n_seq = axis_size(mesh, seq_ax) if seq_ax in names else 1
        if self.config.model.max_seq_len % n_seq:
            raise ValueError(f"max_seq_len {self.config.model.max_seq_len} "
                             f"does not divide over {n_seq} {seq_ax!r} "
                             f"shards")
        here = mesh_device(mesh)
        if here.type != self.device.type or (
                self.device.index is not None
                and self.device.index != here.index):
            raise ValueError(f"mesh device {here}, trainer on "
                             f"{self.device}")
        self._batch_axes = tuple(
            a for a in names if a not in ("model", seq_ax,
                                          pcfg.stage_axis_name))
        self._seq_axis = seq_ax if n_seq > 1 else None
        count, mu, nu = self.optimizer.state
        shard_params([self.optimizer.flat, count, mu, nu], mesh)
        for module in (self.amygdala, self.thalamus):
            if module is not None:
                shard_params(module, mesh)
        self._tp = tensor_parallel(mesh)
        if self._tp is not None:
            self._split_model(mesh)
        self.model.set_mesh(mesh if n_seq > 1 else None, seq_ax)
        self._memory_mesh = None
        fn = None
        if shard_memory and self.config.model.use_rag:
            self.hippocampus._set_state(init_sharded_memory(
                self.config.memory, mesh, self._batch_axes))
            self._memory_mesh = mesh
            fn = _ShardedRetrieve(mesh, self._batch_axes)
        for layer in getattr(self.model, "layers", ()):
            if hasattr(layer, "retrieve_fn"):
                layer.retrieve_fn = fn
        self.mesh = mesh

    def _split_model(self, mesh) -> None:
        """Tensor parallelism: the model's sharded weights cut to this
        rank's parts, and a new `ClippedAdamW` over them whose moments and
        count are the old optimizer's, cut the same way."""
        old = self.optimizer
        specs = param_specs(self.model, mesh)
        self._tp_dims = [shard_dim(specs[n])
                         for n, _ in self.model.named_parameters()]
        # the parameters leave the old flat buffer before it is split
        with torch.no_grad():
            for p in old.params:
                p.data = p.data.clone()
                p.grad = None
        shard_params(self.model, mesh)
        tcfg = self.config.training
        self.optimizer = ClippedAdamW(
            self.model.parameters(), self.schedule, tcfg.weight_decay,
            tcfg.gradient_clip, tcfg.optimizer_mu_dtype,
            sharded=[d is not None for d in self._tp_dims],
            group=self._tp.group)
        with torch.no_grad():     # the old buffers: the unsharded layout
            for new, was in zip(self.optimizer.state, old.state):
                new.copy_(was if was.dim() == 0
                          else self.local_tensors(was))

    def full_tensors(self, flat: torch.Tensor) -> torch.Tensor:
        """A buffer laid out as the optimizer's (`flat`, `mu` or `nu`) as
        the unsharded trainer lays it out: each tensor-parallel part
        gathered over the 'model' axis (every rank of the axis calls
        this). The buffer itself when the trainer is not tensor-
        parallel."""
        if self._tp is None:
            return flat
        parts, off = [], 0
        for p, dim in zip(self.optimizer.params, self._tp_dims):
            k = p.numel()
            x = flat[off:off + k].view(p.shape)
            if dim is not None:
                x = gather_dim(x, self._tp.group, dim)
            parts.append(x.reshape(-1))
            off += k
        return torch.cat(parts)

    def local_tensors(self, full: torch.Tensor) -> torch.Tensor:
        """The inverse of `full_tensors`: this rank's parts of an unsharded
        buffer, laid out as the optimizer's."""
        if self._tp is None:
            return full
        parts, off = [], 0
        for p, dim in zip(self.optimizer.params, self._tp_dims):
            shape = list(p.shape)
            if dim is not None:
                shape[dim] *= self._tp.size
            k = math.prod(shape)
            x = full[off:off + k].view(shape)
            parts.append(take_shard(x, dim, self._tp).reshape(-1))
            off += k
        return torch.cat(parts)

    def _global_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A batch-level value's mean over the batch axes (itself when the
        trainer is not on a mesh)."""
        if self.mesh is None:
            return x
        return all_reduce_mean_(x.detach().clone(), self.mesh,
                                self._batch_axes)

    # ------------------------------------------------------------------
    # one optimizer step
    # ------------------------------------------------------------------
    def _batch(self, x) -> torch.Tensor:
        """The batch on the device: on a mesh, this rank's rows of it (the
        whole sequences; `_chunk` cuts a sequence-sharded rank's part)."""
        x = torch.as_tensor(x)
        if self.mesh is not None:
            x = x[batch_slice(x.shape[0], self.mesh, self._batch_axes)]
        return x.to(self.device, torch.long)

    def _chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the sequence dimension (dim 1) of `x`; all
        of it without a sequence axis."""
        if self._seq_axis is None:
            return x
        n = axis_size(self.mesh, self._seq_axis)
        if x.shape[1] % n:
            raise ValueError(f"sequence of {x.shape[1]} does not divide "
                             f"over {n} {self._seq_axis!r} shards")
        return x.chunk(n, dim=1)[axis_index(self.mesh, self._seq_axis)]

    def _lm_loss(self, logits: torch.Tensor, labels: torch.Tensor,
                 place_activity=None, **kw) -> torch.Tensor:
        """`hippocampal_loss` of next-token prediction: `logits` this rank's
        [B, Lc, V], `labels` the whole sequences [B, L]. Without a sequence
        axis, logits[:, :-1] against labels[:, 1:]. With one, position p's
        target is label p + 1 wherever it lies (the global last position
        has none) and the value is this rank's share of the loss over the
        whole sequence (the shares add up to it)."""
        if self._seq_axis is None:
            return hippocampal_loss(logits[:, :-1], labels[:, 1:],
                                    place_activity, **kw)
        targets = self._chunk(torch.nn.functional.pad(
            labels[:, 1:], (0, 1), value=-100))
        return hippocampal_loss(logits, targets, place_activity,
                                group=self.mesh.get_group(self._seq_axis),
                                **kw)

    def _seq_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """In place: the sum over the sequence axis of the ranks' shares
        (of a loss, or of a gradient); `x` itself without the axis."""
        if self._seq_axis is not None:
            torch.distributed.all_reduce(
                x, group=self.mesh.get_group(self._seq_axis))
        return x

    def _modulate(self, ids: torch.Tensor):
        """(prosody [B, L, 4] or None, thalamus gate []) from the token
        embeddings, without gradients."""
        prosody = None
        thalamus_scale = torch.ones((), device=self.device)
        if self.amygdala is None and self.thalamus is None:
            return prosody, thalamus_scale
        with torch.no_grad():
            token_embeds = self.model.token_table[ids].float()
            if self._tp is not None:      # the table holds D/n features
                token_embeds = gather_dim(token_embeds, self._tp.group, -1)
            arousal = torch.zeros((), device=self.device)
            if self.amygdala is not None:
                limbic = self.amygdala(token_embeds)
                # affine in the batch's mean sentiment: the global batch's
                arousal, valence = self._global_mean(torch.stack(
                    [limbic["arousal"], limbic["valence"]]))
                prosody = build_prosody(arousal, valence, ids.shape[0],
                                        ids.shape[1])
            if self.thalamus is not None:
                routed, _ = self.thalamus(token_embeds, {"arousal": arousal})
                thalamus_scale = torch.clamp(self._global_mean(
                    routed["language"].abs().mean()), 0.5, 1.5)
        return prosody, thalamus_scale

    def _batch_loss(self, ids, labels, prosody, use_memory, memory_state,
                    reverse_replay, dropout_seed):
        """(loss with regularisers, ce, memory_summary) of one
        (micro-)batch of whole sequences (ids, labels and prosody [B, L]);
        the EWC penalty is added once per step, not here. With a sequence
        axis the model runs this rank's chunk, and the losses are this
        rank's shares."""
        tcfg = self.config.training
        chunk = self._chunk
        prosody = None if prosody is None else chunk(prosody)
        out, _ = self.model(chunk(ids), prosody=prosody,
                            use_memory=use_memory,
                            memory_state=memory_state,
                            dropout_seed=dropout_seed)
        with torch.no_grad():
            ce = self._lm_loss(out.logits, labels, None,
                               label_smoothing=0.0, entropy_lambda=0.0,
                               sparsity_lambda=0.0)
        loss = self._lm_loss(
            out.logits, labels, out.place_activity,
            label_smoothing=tcfg.label_smoothing,
            entropy_lambda=tcfg.entropy_lambda,
            sparsity_lambda=tcfg.sparsity_lambda,
            target_sparsity=tcfg.target_sparsity)
        if reverse_replay:
            out_r, _ = self.model(chunk(ids.flip(1)), prosody=prosody,
                                  use_memory=use_memory,
                                  memory_state=memory_state,
                                  dropout_seed=dropout_seed)
            loss = loss + 0.5 * self._lm_loss(
                out_r.logits, labels.flip(1), None,
                label_smoothing=tcfg.label_smoothing,
                entropy_lambda=tcfg.entropy_lambda, sparsity_lambda=0.0)
        return loss, ce, out.memory_summary.detach()

    def _run_step(self, input_ids, labels, use_memory: bool,
                  store_memory: bool, reverse_replay: bool = False,
                  lr_scale: float = 1.0) -> torch.Tensor:
        """One optimizer step; returns its [loss, ce, thalamus gate] on
        the device without reading it."""
        cfg, tcfg = self.config.model, self.config.training
        ids, labels = self._batch(input_ids), self._batch(labels)
        memory_state = self.hippocampus.state if cfg.use_rag else None
        with span("trainer.modulate"):
            prosody, thalamus_scale = self._modulate(ids)

        accum = max(1, tcfg.gradient_accumulation_steps)
        B = ids.shape[0]
        mb = B // accum if accum > 1 else B
        opt = self.optimizer
        opt.zero_grad()
        loss = ce = None
        summaries: List[torch.Tensor] = []
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            seed = int(self._seed_rng.integers(2 ** 62))
            with span("model.forward"):
                loss_i, ce_i, summary_i = self._batch_loss(
                    ids[rows], labels[rows],
                    None if prosody is None else prosody[rows], use_memory,
                    memory_state, reverse_replay, seed)
            with span("trainer.backward"):
                loss_i.backward()
            loss = loss_i.detach() if loss is None else loss + loss_i.detach()
            ce = ce_i if ce is None else ce + ce_i
            summaries.append(summary_i)
        if accum > 1:
            opt.grad.div_(accum)
            loss, ce = loss / accum, ce / accum
        if self.mesh is not None:
            self._seq_sum_(opt.grad)
            all_reduce_mean_(opt.grad, self.mesh, self._batch_axes)
            loss = self._global_mean(self._seq_sum_(loss.clone()))
            ce = self._global_mean(self._seq_sum_(ce.clone()))
        if self.ewc.fisher is not None:
            loss = loss + self.ewc.penalty(opt.flat, opt.global_sum)
            opt.grad.add_(self.ewc.penalty_grad(opt.flat))
        with span("optim.step"):
            opt.step(loss, lr_scale)
        for moe in self._moe:
            moe.update_bias(self.config.model.router_bias_rate)

        if store_memory:
            with span("trainer.store"):
                self._store(torch.cat(summaries))
        self.hippocampus.tick(1.0)
        self._step += 1
        return torch.stack([loss.float(), ce.float(),
                            thalamus_scale.float()])

    def _store(self, summary: torch.Tensor) -> None:
        """The step's `memory_summary` rows written to the bank."""
        mcfg = self.config.memory
        if self.mesh is not None:                # the whole batch's rows
            summary = gather_rows(summary, self.mesh, self._batch_axes)
        locs = torch.zeros(summary.shape[0], mcfg.spatial_dims,
                           device=self.device)
        if self._memory_mesh is not None:
            state = write_memories_sharded(
                mcfg, self._memory_mesh, self.hippocampus.state,
                summary, locs, self._batch_axes)
        else:
            state = memory_engine.write_memories(
                mcfg, self.hippocampus.state, summary, locs)
        self.hippocampus._set_state(state)

    # ------------------------------------------------------------------
    # public stepping API
    # ------------------------------------------------------------------
    def _lr_scale(self) -> float:
        return (EndocrineSystem.lr_scale(self._hormones)
                if self.endocrine else 1.0)

    def _endocrine_step(self, loss: float) -> None:
        if self.endocrine is not None:
            levels = self.endocrine.step({
                "accuracy": max(0.0, min(1.0, float(np.exp(-loss)))),
                "gate_diversity": 0.5,
                "energy": 0.1,
            })
            self._hormones = levels
            self._memory_gate_scale = EndocrineSystem.memory_gate(levels)

    def _memory_on(self, step: int) -> bool:
        return bool(step >= self.config.training.memory_warmup_steps
                    and self._modulator_gate_on())

    def train_step(self, input_ids, labels) -> Dict[str, float]:
        """One wake step with full modulator coupling."""
        with span("trainer.step"):
            tcfg = self.config.training
            step = self._step
            use_memory = self._memory_on(step)
            store_memory = bool(use_memory
                                and step % tcfg.memory_store_interval == 0)
            metrics = self._run_step(input_ids, labels, use_memory,
                                     store_memory, False, self._lr_scale())
            with span("trainer.host"):
                return self._after_step(step, use_memory, metrics,
                                        input_ids, labels)

    def _after_step(self, step: int, use_memory: bool,
                    metrics: torch.Tensor, input_ids,
                    labels) -> Dict[str, float]:
        """A wake step's host bookkeeping once its work is queued."""
        tcfg = self.config.training
        # read the PREVIOUS step's metrics, which finished while this
        # step was queued; the modulators run on them
        pending, self._pending = self._pending, _Metrics(metrics)
        fi = max(1, tcfg.metrics_fetch_interval)
        if pending is None or step % fi == 0 or self._last_fetched is None:
            self._last_fetched = (pending if pending is not None
                                  else self._pending).read()
        loss, ce, self._thalamus_scale = (float(x)
                                          for x in self._last_fetched)
        self._endocrine_step(loss)

        with host_sync("trainer.replay"):
            input_ids = _host(input_ids)
        with host_sync("trainer.replay"):
            labels = _host(labels)
        self.replay.add(input_ids, labels, loss)
        self.history["loss"].append(loss)
        self.history["step"].append(step)

        if step > 0 and step % tcfg.logging_steps == 0:
            self.stats.update_from_params(self.model)
            self.stats.classify_stability(self.history["loss"][-20:])
            snapshot = self.stats.commit(step)
            self.event_bus.emit(
                "brain_stats_updated", source="trainer",
                step=step, loss=loss, stability=snapshot.stability)
        if step > 0 and step % tcfg.eval_steps == 0:
            self.hippocampus.decay_memories(tcfg.memory_decay_rate)
        if (step > 0 and step % tcfg.sleep_interval == 0
                and len(self.replay) > 0):
            self.sleep_phase()

        return {"loss": loss, "ce": ce,
                "use_memory": use_memory, "step": step}

    def latest_metrics(self) -> Dict[str, float]:
        """The newest step's loss, ce and thalamus gate (`train_step`
        reports each one step late); waits for that step."""
        if self._pending is None:
            raise RuntimeError("no step taken yet")
        loss, ce, thal = (float(x) for x in self._pending.read())
        return {"loss": loss, "ce": ce, "thalamus_scale": thal}

    def train_chunk(self, input_ids, labels) -> Dict[str, float]:
        """N steps over a [N, B, L] chunk with one read of the metrics at
        the end. use_memory and the LR scale are decided once per chunk;
        stores follow `memory_store_interval` within the chunk; the
        decay, sleep and telemetry hooks run once for each interval
        boundary the chunk crossed. Returns the last step's metrics (all
        losses go to `history`)."""
        tcfg = self.config.training
        input_ids, labels = _host(input_ids), _host(labels)
        N = input_ids.shape[0]
        start = self._step
        use_memory = self._memory_on(start)
        lr_scale = self._lr_scale()
        metrics = [self._run_step(
            input_ids[i], labels[i], use_memory,
            use_memory and (start + i) % tcfg.memory_store_interval == 0,
            False, lr_scale) for i in range(N)]
        fetched = torch.stack(metrics).cpu().numpy()          # one read
        for i in range(N):
            self.history["loss"].append(float(fetched[i, 0]))
            self.history["step"].append(start + i)
        loss = float(fetched[-1, 0])
        self._thalamus_scale = float(fetched[-1, 2])
        self._endocrine_step(loss)
        for i in range(N):
            self.replay.add(input_ids[i], labels[i], float(fetched[i, 0]))

        end = start + N
        if (end // tcfg.eval_steps) > (start // tcfg.eval_steps):
            self.hippocampus.decay_memories(tcfg.memory_decay_rate)
        if ((end // tcfg.sleep_interval) > (start // tcfg.sleep_interval)
                and len(self.replay) > 0):
            self.sleep_phase()
        if (end // tcfg.logging_steps) > (start // tcfg.logging_steps):
            self.stats.update_from_params(self.model)
            self.stats.classify_stability(self.history["loss"][-20:])
            self.stats.update_loss(loss)
            snapshot = self.stats.commit(end)
            self.event_bus.emit(
                "brain_stats_updated", source="trainer",
                step=end, loss=loss, stability=snapshot.stability)

        return {"loss": loss, "ce": float(fetched[-1, 1]),
                "use_memory": use_memory, "step": start + N - 1}

    def sleep_phase(self) -> None:
        """Replay + time-reversed replay consolidation: one step per
        sampled batch, memory off, LR scale 1."""
        tcfg = self.config.training
        for input_ids, labels, _ in self.replay.sample(
                tcfg.sleep_replay_batches, self._np_rng):
            self._run_step(input_ids, labels, False, False,
                           reverse_replay=True)

    def consolidate_ewc(self, val_batches,
                        use_memory: Optional[bool] = None) -> None:
        """Fisher from (input_ids, labels) validation batches, through the
        model as it now conditions on memory (the live gate, unless
        `use_memory` says otherwise), without dropout; anchors the
        current parameters."""
        cfg = self.config.model
        if use_memory is None:
            use_memory = bool(cfg.use_rag and self._memory_on(self._step))
        memory_state = self.hippocampus.state if cfg.use_rag else None
        opt = self.optimizer

        def grad_fn(batch):
            ids, labels = self._batch(batch[0]), self._batch(batch[1])
            opt.zero_grad()
            out, _ = self.model(self._chunk(ids), use_memory=use_memory,
                                memory_state=memory_state)
            self._lm_loss(out.logits, labels, entropy_lambda=0.0,
                          label_smoothing=0.0).backward()
            if self.mesh is not None:
                self._seq_sum_(opt.grad)
                all_reduce_mean_(opt.grad, self.mesh, self._batch_axes)
            return opt.grad.clone()

        self.ewc.consolidate(grad_fn, opt.flat, val_batches)
        opt.zero_grad()

    def _modulator_gate_on(self) -> bool:
        """Endocrine/thalamic memory veto: with endocrine_memory_gating
        False the hormone gate keeps scaling the LR but cannot veto
        memory."""
        gate = (self._memory_gate_scale
                if self.config.training.endocrine_memory_gating else 1.0)
        return gate * self._thalamus_scale >= 0.9

    def eval_loss(self, input_ids, labels) -> float:
        """Plain cross-entropy without memory, dropout or gradients."""
        with torch.no_grad():
            out, _ = self.model(self._chunk(self._batch(input_ids)),
                                use_memory=False)
            return float(self._global_mean(self._seq_sum_(self._lm_loss(
                out.logits, self._batch(labels), entropy_lambda=0.0,
                label_smoothing=0.0))))
