"""Host-spilled episodic bank: a bank larger than the card's memory.

Counterpart of `aura_snn_rag_tpu/memory/host_spill.py`, with the same
names. The bank is split across the memory hierarchy:

- DEVICE: the coarse rows [M, D] of the L2-normalised features, int8
  (per-row max-abs, 127-scaled) or bf16, with the per-row dequant scale,
  strength and timestamp (`SpillDeviceState`). 10M x 768 int8 is 7.7 GB.
- HOST: the exact f32 rows [M, D] (30.7 GB at 10M x 768), their inverse
  norms, the locations, and mirrors of strength and timestamp.

A query is a two-phase funnel:

1. on the device, kernel A (`ops/cuda/flat_scan.flat_blockmax`) takes the
   8-row block maxima of the coarse combined score over the whole bank,
   `engine.select_block_candidates` expands the top blocks into [B, F]
   candidate slots and, when 0 < spill_funnel_rows < F, an exact-coarse
   rescore of those rows keeps the best spill_funnel_rows. Only the slot
   ids (-1 = dead lane) cross to the host.
2. on the host, the exact f32 rerank of those rows (cosine from the raw
   rows and their inverse norms; strength and temporal terms from the host
   mirrors), in C++ (`native/spill_rerank.cpp`, built by `_native`) or,
   for queries with locations and as the reference, in numpy.

Differences from the JAX package, by design:

- Queries are padded neither to 128 nor to the chunk: kernel A takes any
  B, so `spill_query_chunk` cuts the batch into slices.
- Blocks are contiguous, the layout of the JAX package's XLA funnel; the
  TPU kernel's strided layout is not ported.
- Writes `copy_` into slices of the preallocated device tensors straight
  from pinned host memory without waiting (PyTorch's pinned allocator
  keeps a buffer until its copy is done), so a bulk load overlaps chunk
  i's upload with chunk i+1's host half without a thread.
- A write larger than the bank keeps its last M rows at the slots the host
  mirrors give them, on the device too, and advances the ring cursor by
  the whole batch. (The JAX package writes them to the device from
  `count % M` and advances the cursor by M.)
- The native library is loaded when a bank is made, not at import.
- `retrieve_stream` enqueues every pack's funnel and its copy of the slot
  ids into pinned host memory, then reranks pack i on the host while the
  card runs the later packs, waiting on one CUDA event per pack.

Results are numpy arrays, as in the JAX package: the rows live on the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from aura_snn_rag_tpu_torch._device import resolve_device
from aura_snn_rag_tpu_torch.config import MemoryConfig
from aura_snn_rag_tpu_torch.memory.engine import (
    NEG_INF, RetrievalResult, _to_coarse_rows, select_block_candidates)
from aura_snn_rag_tpu_torch.ops.cuda.flat_scan import (
    BLOCK_R, INV_127SQ, flat_blockmax, pack_row_terms)


def _load_rerank_native() -> Optional[ctypes.CDLL]:
    """The native library with `aura_spill_rerank` declared, or None (the
    numpy path is the reference)."""
    from aura_snn_rag_tpu_torch._native import load
    lib = load()
    if lib is None:
        return None
    try:
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.aura_spill_rerank.argtypes = [
            f32p, f32p, f32p, f32p,                       # bank mirrors
            ctypes.POINTER(ctypes.c_int32), f32p,         # slots, queries
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,               # scalars
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,                               # B, F, D, k
            ctypes.POINTER(ctypes.c_int64), f32p]         # outputs
        lib.aura_spill_rerank.restype = None
        return lib
    except AttributeError:
        return None


@dataclasses.dataclass
class SpillDeviceState:
    """Device-resident half of the spilled bank (coarse rows + metadata)."""

    coarse: torch.Tensor     # [M, D] int8 (per-row max-abs scaled) or bf16,
                             #   L2-normalised rows
    scale: torch.Tensor      # [M] f32 per-row dequant scale (int8: row
                             #   max-abs, cos = acc*scale/127^2; bf16: 1.0)
    strength: torch.Tensor   # [M] f32 decayable strength
    timestamp: torch.Tensor  # [M] f32 logical write step

    @property
    def max_memories(self) -> int:
        return self.coarse.shape[0]


def _init_device(M: int, D: int, coarse_dtype: torch.dtype,
                 device: torch.device) -> SpillDeviceState:
    return SpillDeviceState(
        coarse=torch.zeros((M, D), dtype=coarse_dtype, device=device),
        scale=torch.ones((M,), dtype=torch.float32, device=device),
        strength=torch.zeros((M,), dtype=torch.float32, device=device),
        timestamp=torch.zeros((M,), dtype=torch.float32, device=device),
    )


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host queries as a tensor on `device`. To the card they go through
    pinned memory without a wait, so the host runs on."""
    t = torch.from_numpy(x)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _device_write_slice(dev: SpillDeviceState, start: int,
                        rows: torch.Tensor, scales: torch.Tensor,
                        step: float) -> None:
    """Contiguous-range write into the preallocated tensors, in place.

    Quantisation happens on the host (`_host_coarse`), so a bulk ingest
    uploads int8 rows, 4x fewer bytes than f32. The FIFO ring's writes are
    at most two contiguous slot ranges, each a block copy."""
    n = rows.shape[0]
    on_card = dev.coarse.is_cuda
    for dst, src in ((dev.coarse, rows), (dev.scale, scales)):
        # from pinned memory straight into the slice, without a wait
        dst[start:start + n].copy_(src.pin_memory() if on_card else src,
                                   non_blocking=on_card)
    dev.strength[start:start + n] = 1.0
    dev.timestamp[start:start + n] = step


def _host_coarse(feats: np.ndarray, dtype: torch.dtype):
    """numpy mirror of engine._to_coarse_rows on L2-normalised rows:
    per-row max-abs int8 quantisation -> (rows, scales [B] f32), as CPU
    tensors."""
    qn = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
    if dtype == torch.int8:
        s = np.maximum(np.max(np.abs(qn), axis=1, keepdims=True), 1e-12)
        q = np.clip(np.round(qn * (127.0 / s)), -127, 127).astype(np.int8)
        return torch.from_numpy(q), torch.from_numpy(
            s[:, 0].astype(np.float32))
    # bf16 through torch (numpy has no bf16)
    return (torch.from_numpy(qn).to(dtype),
            torch.ones(qn.shape[0], dtype=torch.float32))


def _device_decay(dev: SpillDeviceState, rate: float) -> None:
    # (1 - rate) in f32, as the JAX package computes it on the device
    dev.strength.mul_(float(np.float32(1.0) - np.float32(rate)))


def _device_funnel(dev: SpillDeviceState, q: torch.Tensor,
                   q_scale: torch.Tensor, active_count: int, step: float, *,
                   funnel_blocks: int, k: int, w_cosine: float,
                   w_temporal: float, temporal_tau: float,
                   seconds_per_step: float, row_funnel: int = 0,
                   query_chunk: int = 256) -> torch.Tensor:
    """Phase 1 on the device: coarse scan -> candidate slots [B, F'] int32,
    -1 marking dead or invalid candidates (the only device-to-host
    traffic; the host mirrors strength and timestamp).

    q: [B, D] queries in the bank's coarse dtype; q_scale: [B] f32
    per-query max-abs scales (1.0 for bf16).

    row_funnel (config.spill_funnel_rows): when 0 < row_funnel < F, a
    second stage gathers the F block-funnel candidates' coarse rows and
    keeps the top row_funnel by exact-coarse combined score, so the
    transfer and the host rerank shrink by F / row_funnel. The int8
    product is summed in f32, which is exact: |acc| <= 127^2 * D < 2^24.

    query_chunk (config.spill_query_chunk): the scan runs over slices of
    this many queries, which bounds the [chunk, M/8] f32 block-max surface
    (1.28 GB at 256 x 10M) at the price of one bank read per slice.
    """
    M = dev.coarse.shape[0]
    R = BLOCK_R
    B = q.shape[0]
    int8 = dev.coarse.dtype == torch.int8
    ages = (step - dev.timestamp) * seconds_per_step
    temporal = torch.exp(-torch.clamp(ages, min=0.0) / temporal_tau)
    active = torch.arange(M, device=q.device) < active_count
    # the per-row dequant scale folds into the cosine multiplier
    mul = torch.where(active, w_cosine * dev.strength * dev.scale, 0.0)
    add = torch.where(active, w_temporal * temporal * dev.strength, NEG_INF)
    mul_p, add_p = pack_row_terms(mul, add, M)

    def funnel_chunk(qc: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
        # kernel A on a CUDA bank, its plain version on a CPU one
        bm = flat_blockmax(dev.coarse, qc, mul_p, add_p,
                           q_scale=qs if int8 else None)         # [C, Nblk]
        cand_slots, cand_valid = select_block_candidates(
            bm, funnel_blocks, k, active_count, M, R)
        F = cand_slots.shape[1]
        if not (0 < row_funnel < F):
            return torch.where(cand_valid, cand_slots, -1).int()

        # second stage: exact-coarse rescore of the F candidates
        safe = torch.where(cand_valid, cand_slots, 0)
        rows = dev.coarse[safe]                                  # [C, F, D]
        if int8:
            acc = torch.bmm(rows.float(), qc.float()[:, :, None])[..., 0]
            cos = acc * (qs[:, None] * INV_127SQ)
        else:
            cos = torch.bmm(rows, qc[:, :, None])[..., 0].float()
        score = cos * mul[safe] + add[safe]
        score = torch.where(cand_valid, score, NEG_INF)
        top_s, top_i = torch.topk(score, row_funnel, dim=1)
        out = safe.gather(1, top_i)
        return torch.where(top_s > NEG_INF / 2, out, -1).int()

    if not 0 < query_chunk < B:
        return funnel_chunk(q, q_scale)
    # fresh copies of the scale slices keep the kernel's 16-byte alignment
    return torch.cat([funnel_chunk(q[i:i + query_chunk],
                                   q_scale[i:i + query_chunk].clone())
                      for i in range(0, B, query_chunk)])


class SpilledBank:
    """Host orchestrator of the spilled bank: the device half is a
    `SpillDeviceState` on `device` (CUDA unless device="cpu"), the host
    half numpy arrays."""

    def __init__(self, config: MemoryConfig,
                 device: Union[str, torch.device, None] = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        M, D = config.max_memories, config.feature_dim
        coarse_dtype = (torch.int8 if config.coarse_dtype == "int8"
                        else torch.bfloat16)
        self.dev = _init_device(M, D, coarse_dtype, self.device)
        # host half: exact rows + locations. Inverse row norms are taken
        # at write time, so the exact rerank is one raw-row dot + scale.
        self.host_features = np.zeros((M, D), np.float32)
        self.host_inv_norm = np.zeros((M,), np.float32)
        self.host_locations = np.zeros((M, config.spatial_dims), np.float32)
        # strength/timestamp mirrors: every mutation (write, decay) starts
        # on the host, which applies it to both copies
        self.host_strength = np.zeros((M,), np.float32)
        self.host_timestamp = np.zeros((M,), np.float32)
        self.count = 0          # total writes ever (ring cursor = count % M)
        self.step = 0.0         # logical clock
        self._native = _load_rerank_native()
        # queries served by each host rerank
        self.served = {"native": 0, "numpy": 0}

    @property
    def native(self) -> bool:
        """True when the C++ rerank is loaded (queries with locations take
        the numpy path all the same)."""
        return self._native is not None

    # -- writes ------------------------------------------------------------

    def _host_write(self, features: np.ndarray,
                    locations: Optional[np.ndarray]):
        """Host half of a write: mirrors + quantisation. Returns
        ((coarse rows, scales), slots, ring start) for `_device_write`."""
        feats = np.ascontiguousarray(features, np.float32)
        B = feats.shape[0]
        M = self.config.max_memories
        slots = (self.count + np.arange(B)) % M
        self.count += B
        # a batch larger than the bank: only the last M rows survive
        if B > M:
            feats, slots = feats[-M:], slots[-M:]
            if locations is not None:
                locations = locations[-M:]
        self.host_features[slots] = feats
        self.host_inv_norm[slots] = 1.0 / (
            np.linalg.norm(feats, axis=1) + 1e-12)
        if locations is not None:
            self.host_locations[slots] = np.asarray(locations, np.float32)
        else:
            self.host_locations[slots] = 0.0
        self.host_strength[slots] = 1.0
        self.host_timestamp[slots] = self.step
        rows = _host_coarse(feats, self.dev.coarse.dtype)
        return rows, slots, int(slots[0])

    def _device_write(self, rows_scales, start: int) -> None:
        """Device half: upload + ring write in at most two contiguous
        segments."""
        rows, scales = rows_scales
        B = rows.shape[0]
        M = self.config.max_memories
        first = min(B, M - start)
        step = float(np.float32(self.step))
        _device_write_slice(self.dev, start, rows[:first], scales[:first],
                            step)
        if first < B:
            _device_write_slice(self.dev, 0, rows[first:], scales[first:],
                                step)

    def write(self, features: np.ndarray,
              locations: Optional[np.ndarray] = None) -> np.ndarray:
        """FIFO batch write. Returns the bank slots written."""
        rows, slots, start = self._host_write(features, locations)
        self._device_write(rows, start)
        return slots

    def bulk_load_chunked(self, make_chunk, n_rows: int,
                          chunk: int = 262_144) -> None:
        """Ingest n_rows through a chunk factory `make_chunk(offset, n)`
        (never the whole f32 bank twice on the host).

        Chunk i's upload is enqueued without a wait and runs on the card
        while the host makes, mirrors and quantises chunk i+1. Later device
        work on the stream sees every write."""
        done = 0
        while done < n_rows:
            b = min(chunk, n_rows - done)
            rows, _, start = self._host_write(make_chunk(done, b), None)
            self._device_write(rows, start)
            done += b

    # -- maintenance --------------------------------------------------------

    def decay(self, rate: float = 0.01) -> None:
        _device_decay(self.dev, rate)
        self.host_strength *= np.float32(1.0 - rate)

    def tick(self, steps: float = 1.0) -> None:
        self.step += steps

    @property
    def active_count(self) -> int:
        return min(self.count, self.config.max_memories)

    # -- retrieval -----------------------------------------------------------

    def _prep_queries(self, queries: np.ndarray):
        """(qn [B, D] f32 numpy, coarse queries [B, D] and their scales [B]
        on the device, B)."""
        q = np.asarray(queries, np.float32)
        qn = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
        qc, qs = _to_coarse_rows(_upload(qn, self.device),
                                 self.dev.coarse.dtype)
        return qn, qc.contiguous(), qs, qn.shape[0]

    def _dispatch_funnel(self, queries: np.ndarray):
        """Enqueue the device funnel: (qn, B, slots [B, F'] int32 on the
        device), with no host sync."""
        qn, qc, qs, B = self._prep_queries(queries)
        cfg = self.config
        out = _device_funnel(
            self.dev, qc, qs, self.active_count, float(np.float32(self.step)),
            funnel_blocks=cfg.flat_block_funnel, k=cfg.retrieve_k,
            w_cosine=cfg.w_cosine, w_temporal=cfg.w_temporal,
            temporal_tau=cfg.temporal_tau,
            seconds_per_step=cfg.seconds_per_step,
            row_funnel=cfg.spill_funnel_rows,
            query_chunk=cfg.spill_query_chunk)
        return qn, B, out

    @staticmethod
    def _pull(funnel: torch.Tensor):
        """Enqueue the copy of funnel slot ids into pinned host memory:
        (host tensor, CUDA event to wait on, or None on the CPU)."""
        if not funnel.is_cuda:
            return funnel, None
        buf = torch.empty(funnel.shape, dtype=funnel.dtype, pin_memory=True)
        buf.copy_(funnel, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    def _host_rerank(self, qn: np.ndarray, B: int, funnel: np.ndarray,
                     k: int, query_locations: Optional[np.ndarray],
                     use_native: bool = True) -> RetrievalResult:
        slots_signed = np.asarray(funnel)[:B]            # [B, F], -1 = dead
        cfg = self.config
        if (use_native and self._native is not None
                and query_locations is None):
            return self._host_rerank_native(qn, slots_signed, k)
        self.served["numpy"] += B
        live = slots_signed >= 0
        cand_slots = np.maximum(slots_signed, 0)
        # metadata terms from the host mirrors
        strength_c = self.host_strength[cand_slots]
        ages = (np.float32(self.step) - self.host_timestamp[cand_slots]) \
            * np.float32(cfg.seconds_per_step)
        temporal = np.exp(-np.maximum(ages, 0.0)
                          / np.float32(cfg.temporal_tau))
        add_c = np.where(live,
                         np.float32(cfg.w_temporal) * temporal * strength_c,
                         np.float32(NEG_INF)).astype(np.float32)
        rows = self.host_features[cand_slots]            # [B, F, D] gather
        # batched matvec through BLAS
        cos = np.matmul(rows, qn.astype(np.float32)[:, :, None]) \
            .squeeze(-1) * self.host_inv_norm[cand_slots]
        score = cfg.w_cosine * strength_c * cos + add_c
        if query_locations is not None:
            d = np.sqrt(np.sum(
                (self.host_locations[cand_slots]
                 - np.asarray(query_locations, np.float32)[:, None]) ** 2,
                axis=-1) + 1e-12)
            score = score + np.where(
                add_c > NEG_INF / 2,
                cfg.w_spatial / (1.0 + d) * strength_c, 0.0)
        # exact top-k over the funnel (argpartition + order)
        kk = min(k, score.shape[1])
        part = np.argpartition(-score, kk - 1, axis=1)[:, :kk]
        vals = np.take_along_axis(score, part, axis=1)
        order = np.argsort(-vals, axis=1)
        pick = np.take_along_axis(part, order, axis=1)
        scores = np.take_along_axis(score, pick, axis=1)
        slots = np.take_along_axis(cand_slots, pick, axis=1).astype(np.int64)
        hit = scores > NEG_INF / 2
        slots = np.where(hit, slots, -1)
        feats = np.where(hit[..., None],
                         self.host_features[np.maximum(slots, 0)], 0.0)
        return RetrievalResult(slots, np.where(hit, scores, 0.0), feats)

    def _host_rerank_native(self, qn: np.ndarray, slots_signed: np.ndarray,
                            k: int) -> RetrievalResult:
        """Fused gather + score + top-k in C++ (native/spill_rerank.cpp):
        each candidate row streams once into a dot product, with no
        [B, F, D] gather. The same math as the numpy path; ctypes releases
        the GIL for the call."""
        cfg = self.config
        B, F = slots_signed.shape
        kk = min(k, F)
        qn32 = np.ascontiguousarray(qn, np.float32)
        slots_c = np.ascontiguousarray(slots_signed, np.int32)
        if qn32.shape != (B, cfg.feature_dim):
            raise ValueError(f"queries {qn32.shape} for {B} funnel rows")
        out_slots = np.empty((B, kk), np.int64)
        out_scores = np.empty((B, kk), np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        self._native.aura_spill_rerank(
            self.host_features.ctypes.data_as(f32p),
            self.host_inv_norm.ctypes.data_as(f32p),
            self.host_strength.ctypes.data_as(f32p),
            self.host_timestamp.ctypes.data_as(f32p),
            slots_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            qn32.ctypes.data_as(f32p),
            ctypes.c_float(self.step),
            ctypes.c_float(cfg.seconds_per_step),
            ctypes.c_float(cfg.temporal_tau),
            ctypes.c_float(cfg.w_cosine), ctypes.c_float(cfg.w_temporal),
            B, F, cfg.feature_dim, kk,
            out_slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_scores.ctypes.data_as(f32p))
        self.served["native"] += B
        hit = out_slots >= 0
        feats = np.where(hit[..., None],
                         self.host_features[np.maximum(out_slots, 0)], 0.0)
        return RetrievalResult(out_slots, out_scores, feats)

    def retrieve(self, queries: np.ndarray, k: Optional[int] = None,
                 query_locations: Optional[np.ndarray] = None
                 ) -> RetrievalResult:
        k = k or self.config.retrieve_k
        qn, B, funnel = self._dispatch_funnel(queries)
        return self._host_rerank(qn, B, funnel.cpu().numpy(), k,
                                 query_locations)

    def retrieve_stream(self, query_batches: Sequence[np.ndarray],
                        k: Optional[int] = None,
                        coalesce: int = 1024) -> List[RetrievalResult]:
        """Pipelined batch retrieval, results in the caller's batches.

        Consecutive batches are coalesced into funnel dispatches ("packs")
        of up to `coalesce` queries: each dispatch reads the whole coarse
        bank (7.7 GB at 10M rows int8) once per query chunk, so a larger
        pack amortises it. Per-query funnels are independent, so packing
        and splitting are exact. Every pack's funnel and the copy of its
        slot ids are enqueued first; then the host reranks pack i while
        the card runs packs i+1, ..."""
        k = k or self.config.retrieve_k
        sizes = [np.asarray(q).shape[0] for q in query_batches]
        packs: List[List[int]] = [[]]          # indices into query_batches
        acc = 0
        for i, s in enumerate(sizes):
            if packs[-1] and acc + s > coalesce:
                packs.append([])
                acc = 0
            packs[-1].append(i)
            acc += s
        inflight = []
        for pack in packs:
            qn, B, funnel = self._dispatch_funnel(
                np.concatenate([np.asarray(query_batches[i], np.float32)
                                for i in pack], axis=0))
            inflight.append((qn, B, self._pull(funnel)))
        out: List[RetrievalResult] = [None] * len(query_batches)  # type: ignore
        for pack, (qn, B, (buf, done)) in zip(packs, inflight):
            if done is not None:
                done.synchronize()
            res = self._host_rerank(qn, B, buf.numpy(), k, None)
            off = 0
            for i in pack:
                s = sizes[i]
                out[i] = RetrievalResult(res.indices[off:off + s],
                                         res.scores[off:off + s],
                                         res.features[off:off + s])
                off += s
        return out
