"""Generation serving: a batched request loop over the KV-cached decoder
(counterpart of `aura_snn_rag_tpu/generation/serving.py`).

Requests gather into batches of `batch_size` rows, prompts left-padded to
`prompt_pad`, and each batch decodes a power-of-2 number of tokens (the
JAX package's compile buckets; here they keep the batches' shapes few).
Episodic memory conditions every request when a bank is attached.
With a `mesh` the server decodes tensor-parallel over its 'model' axis.
"""

from __future__ import annotations

import asyncio
import copy
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


@dataclass
class GenerationRequest:
    prompt_ids: np.ndarray
    max_new_tokens: int = 64
    temperature: float = 0.8
    top_p: float = 0.9
    future: Optional[asyncio.Future] = None
    submitted_at: float = field(default_factory=time.time)


class BatchedGenerator:
    """Fixed-shape batched generation server.

    `weights_dtype="bfloat16"` serves a bf16 copy of the model, cast once
    here (the model passed in is left as it is): small-batch decode reads
    every weight once per token, and with f32 weights the compute dtype
    cast (bf16 by default) reads f32 and writes bf16 on every use. Sampled
    outputs may then differ in near-ties.

    `mesh` (a ('data', 'model') DeviceMesh; every rank of it runs the
    server) places the parameters by `parallel.mesh.shard_params`: over a
    'model' axis larger than 1 the server decodes tensor-parallel, on a
    copy of the model split into this rank's parts (the model passed in
    is left whole), with KV caches of this rank's H/n heads. The bank
    (`memory_state`) and every batch are replicated over the mesh: the
    first rank's bank is broadcast, and each rank decodes the whole
    batch, drawing the same tokens from the same generator."""

    def __init__(self, model, batch_size: int = 8, prompt_pad: int = 64,
                 max_new_tokens: int = 64, memory_state=None,
                 pad_token_id: int = 0,
                 generator: Optional[torch.Generator] = None,
                 weights_dtype: Optional[str] = None, mesh=None):
        if weights_dtype == "bfloat16":
            model = copy.deepcopy(model).to(torch.bfloat16)
        elif weights_dtype is not None:
            raise ValueError(f"weights_dtype {weights_dtype!r}")
        if mesh is not None:
            from aura_snn_rag_tpu_torch.parallel.mesh import (
                mesh_broadcast_, shard_params, tensor_parallel)
            if tensor_parallel(mesh) is not None and weights_dtype is None:
                model = copy.deepcopy(model)
            shard_params(model, mesh)
            if memory_state is not None:     # as bytes: gloo takes no bool
                for t in memory_state:
                    mesh_broadcast_(t.reshape(-1).view(torch.uint8), mesh)
        self.mesh = mesh
        self.model = model
        self.batch_size = batch_size
        self.prompt_pad = prompt_pad
        self.max_new_tokens = max_new_tokens
        self.memory_state = memory_state
        self.pad_token_id = pad_token_id
        self.generator = generator if generator is not None else \
            torch.Generator(device=model.device).manual_seed(0)
        self._queue: Optional[asyncio.Queue] = None
        self._queue_loop = None
        self.stats = {"requests": 0, "batches": 0, "tokens": 0,
                      "mean_batch_fill": 0.0}

    @property
    def queue(self) -> asyncio.Queue:
        """The request queue of the running event loop. An asyncio.Queue
        binds to the first loop that waits on it, so a server run under a
        new loop (another `asyncio.run`) gets a new queue; the old one
        would fail the server and leave every submission waiting."""
        loop = asyncio.get_running_loop()
        if self._queue is None or self._queue_loop is not loop:
            self._queue, self._queue_loop = asyncio.Queue(), loop
        return self._queue

    # ------------------------------------------------------------------
    def _pad_batch(self, requests: List[GenerationRequest]) -> np.ndarray:
        batch = np.full((self.batch_size, self.prompt_pad),
                        self.pad_token_id, np.int64)
        for i, r in enumerate(requests):
            ids = np.asarray(r.prompt_ids, np.int64)[-self.prompt_pad:]
            batch[i, -len(ids):] = ids      # left-pad: prompt ends at edge
        return batch

    def _bucket(self, n: int) -> int:
        """Round a requested token count up to a power of 2, capped at the
        server's max_new_tokens."""
        n = max(1, min(n, self.max_new_tokens))
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_new_tokens)

    def generate_batch(self, requests: List[GenerationRequest]
                       ) -> List[np.ndarray]:
        """Synchronous batched decode; returns per-request new tokens.

        Per-request temperature and top_p ride as [B] tensors; the batch
        decodes the bucket of its largest max_new_tokens and each
        request's output is trimmed to its own limit."""
        from aura_snn_rag_tpu_torch.generation.sampler import generate

        if not 0 < len(requests) <= self.batch_size:
            raise ValueError(f"{len(requests)} requests for a batch of "
                             f"{self.batch_size}")
        dev = self.model.device
        temps = torch.ones(self.batch_size)
        top_ps = torch.ones(self.batch_size)
        for i, r in enumerate(requests):
            temps[i] = r.temperature
            top_ps[i] = r.top_p
        bucket = self._bucket(max(r.max_new_tokens for r in requests))
        out = generate(self.model, torch.from_numpy(self._pad_batch(requests)),
                       bucket, self.generator, temperature=temps.to(dev),
                       top_p=top_ps.to(dev), memory_state=self.memory_state,
                       use_memory=self.memory_state is not None)
        new_tokens = out[:, self.prompt_pad:].cpu().numpy()
        self.stats["requests"] += len(requests)
        self.stats["batches"] += 1
        self.stats["tokens"] += sum(
            min(r.max_new_tokens, bucket) for r in requests)
        fill = len(requests) / self.batch_size
        n = self.stats["batches"]
        self.stats["mean_batch_fill"] += (
            fill - self.stats["mean_batch_fill"]) / n
        return [new_tokens[i][:requests[i].max_new_tokens]
                for i in range(len(requests))]

    # ------------------------------------------------------------------
    async def submit(self, prompt_ids, max_new_tokens: int = 64,
                     temperature: float = 0.8, top_p: float = 0.9
                     ) -> np.ndarray:
        loop = asyncio.get_running_loop()
        req = GenerationRequest(np.asarray(prompt_ids), max_new_tokens,
                                temperature, top_p,
                                future=loop.create_future())
        await self.queue.put(req)
        return await req.future

    async def serve_forever(self, flush_ms: float = 20.0) -> None:
        """Drain the queue: flush on a full batch or after flush_ms. The
        decode runs in a worker thread, so the loop keeps taking requests;
        a batch that fails sets its exception on each of its futures."""
        while True:
            batch: List[GenerationRequest] = [await self.queue.get()]
            deadline = time.monotonic() + flush_ms / 1000.0
            while len(batch) < self.batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self.queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            try:
                results = await asyncio.to_thread(self.generate_batch, batch)
            except Exception as exc:        # noqa: BLE001 - the server stays up
                for req in batch:
                    if req.future is not None and not req.future.done():
                        req.future.set_exception(exc)
                continue
            for req, toks in zip(batch, results):
                if req.future is not None and not req.future.done():
                    req.future.set_result(toks)
