// Kernel A: flat block-max scan over the coarse bank, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `flat_blockmax`
// (aura_snn_rag_tpu/ops/pallas/flat_scan.py:172). For every query b and
// every 8-row block g of the bank it returns
//     out[b, g] = max_{r in 8g..8g+7} (cos[b, r] * mul[r] + add[r])
// with cos = q . bank^T (int8: acc * 1/127^2 * q_scale[b]); rows past M
// count as -1e30. The [B, M] score matrix never reaches device memory.
//
// Bound on the H100 (1,979 TOP/s int8, 989 TFLOP/s bf16, 3.35 TB/s): at
// int8, B = 1024, M = 1M, D = 768 the product's 2*B*M*D = 1.57e15
// operations take 0.795 ms, above the bytes (bank once 768 MB, the
// [B, M/8] f32 output 512 MB, row terms 8 MB: 0.38 ms), so the tensor
// cores set the floor. At B = 128 the bytes do (0.251 ms int8, 0.480 ms
// bf16).
//
// Design:
// - Tensor cores: wgmma.mma_async m64n256k32 (s8 x s8 -> s32, exact) and
//   m64n256k16 (bf16 x bf16 -> f32), both operands K-major in
//   128-byte-swizzled shared memory. Queries are wgmma's M (64 a
//   warpgroup), bank rows its N (256).
// - Tile 128 queries x 256 bank rows per CTA: two consumer warpgroups of
//   64 x 256, 128 accumulators a thread.
// - Pipeline: one producer thread issues TMA (cp.async.bulk.tensor.2d,
//   SWIZZLE_128B) into a ring of 4 stages, each 128 bytes of depth (16 KB
//   of queries + 32 KB of bank rows), guarded by full/empty mbarriers;
//   setmaxnreg gives the producer warpgroup 40 registers and the
//   consumers 232. TMA zero-fills the ragged edges: rows past M, queries
//   past B, depth past D in the last box (D = 192 int8).
// - Row terms: mul and add of a bank tile (2 KB) come by a bulk copy into
//   a 2-slot ring, so the epilogue reads them from shared memory.
// - Epilogue in registers: a quad of lanes holds the 8 rows of a block
//   (two adjacent columns each). Each thread dequantises and applies the
//   row terms (__fmul_rn/__fadd_rn in the plain version's order, so int8
//   is bit-exact), takes the max of its pair, and a two-step
//   reduce-scatter over the quad (shfl.xor 2, 1) leaves each lane 4
//   consecutive blocks of each of its two query rows: 16-byte streaming
//   stores, 64 contiguous bytes per row per quad. A tile wholly below M
//   skips the row mask.
// - Persistent grid of one CTA per SM walks (query tile, bank tile) pairs,
//   query tiles fastest, so the CTAs that share a bank tile run together
//   and read it from L2; the producer loads the next tile's stages during
//   a tile's epilogue. The tensor cores wait for the epilogue.
// - L2 -> SM traffic at int8, B = 1024, M = 1M, D = 768: 8 x 3,907 tiles x
//   (96 KB queries + 192 KB bank) = 9.2 GB per call. At B <= 128 there is
//   one query tile and the bank is read from HBM once.
//
// Changed from the plan of a TMA + wgmma kernel, with the reasons:
// - A warpgroup whose 64 queries all lie past B still issues its wgmmas
//   on zero rows: under a branch ptxas serialises every wgmma (C7518).
// - The accumulators start unset: zeroing them outside wgmma also
//   serialised the pipeline (C7515) once a group stayed in flight across
//   the tile loop.
// - No overlap of the epilogue with the tensor cores. Splitting each
//   warpgroup's product into two N = 128 halves, so that one half's
//   epilogue runs beside the other half's product, and starting the
//   second warpgroup a few stages behind the first, both measured no
//   faster on the H100 (PERF.md). At int8, B = 1024 the card runs at its
//   power limit and lowers its clock, even with a trivial epilogue: work
//   moved beside the tensor cores still costs power, so only less work
//   per call (fewer instructions, fewer bytes) makes this case faster.
// - Not tried: a 2-CTA cluster that multicasts the bank tile. It would
//   save L2 reads, not tensor-core or epilogue work.
//
// Blocks are contiguous (block g = rows 8g..8g+7), unlike the TPU
// kernel's strided-within-tile layout that existed for its lanes.
//
// The tensor maps are encoded on every call (the state tensors move);
// cuTensorMapEncodeTiled comes through the runtime's driver entry point,
// so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TQ = 128;                 // queries per CTA tile
constexpr int TR = 256;                 // bank rows per CTA tile (wgmma N)
constexpr int KB = 128;                 // bytes of depth per stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;            // consumer warpgroups, 64 queries each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int BLOCK_R = 8;
constexpr int BLOCKS_PER_TILE = TR / BLOCK_R;
constexpr int Q_BYTES = TQ * KB;
constexpr int R_BYTES = TR * KB;
constexpr int STAGE_BYTES = Q_BYTES + R_BYTES;
constexpr int TERM_SLOTS = 2;
constexpr int TERM_FLOATS = 2 * TR;     // mul then add of one bank tile
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES +
                           TERM_SLOTS * TERM_FLOATS * 4 +
                           (2 * STAGES + 2 * TERM_SLOTS) * 8;
constexpr float NEG_INF_F = -1e30f;
constexpr float INV_127SQ = (float)(1.0 / (127.0 * 127.0));

// ---- shared memory, barriers, TMA ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return done != 0;
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  while (!bar_try(b, parity)) {
  }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// K-major operand in 128-byte-swizzled shared memory (the layout TMA's
// SWIZZLE_128B writes): 8-row groups 1024 bytes apart; the leading offset
// is unused for this layout. Tiles sit on 1024-byte boundaries, so a step
// of 32 bytes along K is +2 in the start-address field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A consumer thread's 128 accumulators hold the fragment of one 64 x 256
// wgmma: acc[4j + 2i + c] is query row 16*warp + lane/4 + 8i and bank row
// 8j + 2*(lane%4) + c of its warpgroup's part of the tile, so the four
// lanes of a quad hold the 8 rows of block j.

// keeps the compiler from moving accumulator reads above a wgmma wait
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RW8(c, d, i)                                                         \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), \
      c(d[i + 6]), c(d[i + 7])
#define RW64(c, d, o)                                                       \
  RW8(c, d, o), RW8(c, d, o + 8), RW8(c, d, o + 16), RW8(c, d, o + 24),     \
      RW8(c, d, o + 32), RW8(c, d, o + 40), RW8(c, d, o + 48),              \
      RW8(c, d, o + 56)
#define ACC_LIST                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "    \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "    \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "    \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "  \
  "%124, %125, %126, %127}"
// D[64 x 256] (+)= A[64 x 32 bytes] . B[256 x 32 bytes]^T
__device__ __forceinline__ void mma(int (&d)[128], uint64_t a, uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " ACC_LIST
      ", %128, %129, p;\n"
      "}\n"
      : RW64("+r", d, 0), RW64("+r", d, 64)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b,
                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC_LIST
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : RW64("+f", d, 0), RW64("+f", d, 64)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <typename T> struct Traits;
template <> struct Traits<int8_t> {
  using acc_t = int;
  static constexpr CUtensorMapDataType map_type = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
template <> struct Traits<__nv_bfloat16> {
  using acc_t = float;
  static constexpr CUtensorMapDataType map_type =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

__device__ __forceinline__ float to_cos(int acc, float qs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), INV_127SQ), qs);
}
__device__ __forceinline__ float to_cos(float acc, float) { return acc; }

// bm[2jl + i] = max over this thread's column pair of block 16H + jl, row
// i, of cos * mul + add; when MASK, tile rows at or past `live` count as
// -1e30
template <int H, bool MASK, typename A>
__device__ __forceinline__ void row_terms(const A (&acc)[128], float (&bm)[32],
                                          const float* smul,
                                          const float (&qs)[2], int quad,
                                          int live) {
  const float* sadd = smul + TR;
#pragma unroll
  for (int jl = 0; jl < 16; ++jl) {
    const int j = 16 * H + jl;
    const int col = 8 * j + 2 * quad;
    const float2 m = *reinterpret_cast<const float2*>(smul + col);
    const float2 a = *reinterpret_cast<const float2*>(sadd + col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = __fadd_rn(__fmul_rn(to_cos(acc[4 * j + 2 * i], qs[i]), m.x),
                           a.x);
      float v1 = __fadd_rn(
          __fmul_rn(to_cos(acc[4 * j + 2 * i + 1], qs[i]), m.y), a.y);
      if (MASK) {
        if (col >= live) v0 = NEG_INF_F;
        if (col + 1 >= live) v1 = NEG_INF_F;
      }
      bm[2 * jl + i] = fmaxf(v0, v1);
    }
  }
}

// Epilogue of blocks 16H .. 16H+15 of a tile (half its bank rows): row
// terms, then a reduce-scatter over the quad (lane bit 1 picks block bit 3,
// lane bit 0 picks block bit 2), so lane q ends with blocks 16H + 4q ..
// 16H + 4q + 3 of both its query rows, stored as 16 bytes each. Halves keep
// the live registers at 32 beside the accumulators.
template <int H, typename A>
__device__ __forceinline__ void epilogue_half(const A (&acc)[128], long bt,
                                              int b0, const float (&qs)[2],
                                              const float* smul, long M,
                                              int B, float* out, long nb) {
  const int lane = threadIdx.x % 32;
  const int quad = lane & 3;
  const long left = M - bt * TR;
  float bm[32];
  if (left >= TR)
    row_terms<H, false>(acc, bm, smul, qs, quad, TR);
  else
    row_terms<H, true>(acc, bm, smul, qs, quad, (int)left);
  const bool up1 = lane & 2, up0 = lane & 1;
#pragma unroll
  for (int jl = 0; jl < 8; ++jl)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lo = bm[2 * jl + i], hi = bm[2 * (jl | 8) + i];
      const float got = __shfl_xor_sync(0xffffffffu, up1 ? lo : hi, 2);
      bm[2 * jl + i] = fmaxf(up1 ? hi : lo, got);
    }
#pragma unroll
  for (int jl = 0; jl < 4; ++jl)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lo = bm[2 * jl + i], hi = bm[2 * (jl | 4) + i];
      const float got = __shfl_xor_sync(0xffffffffu, up0 ? lo : hi, 1);
      bm[2 * jl + i] = fmaxf(up0 ? hi : lo, got);
    }
  const long g = bt * BLOCKS_PER_TILE + 16 * H + 4 * quad;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int b = b0 + 8 * i;
    if (b >= B || g >= nb) continue;
    float* dst = out + (long)b * nb + g;
    if (nb % 4 == 0) {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(bm[i], bm[2 + i], bm[4 + i], bm[6 + i]));
    } else {
      dst[0] = bm[i];
      if (g + 1 < nb) dst[1] = bm[2 + i];
      if (g + 2 < nb) dst[2] = bm[4 + i];
      if (g + 3 < nb) dst[3] = bm[6 + i];
    }
  }
}

// ---- the kernel ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flat_blockmax_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap bank_map,
                     const float* __restrict__ mul,
                     const float* __restrict__ add,
                     const float* __restrict__ q_scale,
                     float* __restrict__ out, long M, int B, int n_k,
                     int n_qt, long n_tiles, long nb) {
  using acc_t = typename Traits<T>::acc_t;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;                              // [STAGES][TQ][KB]
  unsigned char* sb = smem + STAGES * Q_BYTES;           // [STAGES][TR][KB]
  float* terms = reinterpret_cast<float*>(sb + STAGES * R_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(terms + TERM_SLOTS * TERM_FLOATS);
  uint64_t* empty = full + STAGES;
  uint64_t* tfull = empty + STAGES;
  uint64_t* tempty = tfull + TERM_SLOTS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS * 4);     // lane 0 of every consumer warp
    }
    for (int s = 0; s < TERM_SLOTS; ++s) {
      bar_init(&tfull[s], 1);
      bar_init(&tempty[s], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS * 128) {
      asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&q_map)
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"((uint64_t)&bank_map)
                   : "memory");
      int c = 0;                       // chunks issued so far, all tiles
      long it = 0;
      for (long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
        const int qt = (int)(t % n_qt);
        const long r0 = (t / n_qt) * TR;
        const int slot = (int)(it & 1);
        bar_wait(&tempty[slot], (uint32_t)((it >> 1) & 1) ^ 1u);
        // mul/add are padded to nb * 8 rows: copy what exists of this tile
        const long rows = nb * BLOCK_R - r0 < TR ? nb * BLOCK_R - r0 : TR;
        const uint32_t tbytes = (uint32_t)rows * 4;
        float* tdst = terms + slot * TERM_FLOATS;
        bar_expect_tx(&tfull[slot], 2 * tbytes);
        bulk_copy(tdst, mul + r0, tbytes, &tfull[slot]);
        bulk_copy(tdst + TR, add + r0, tbytes, &tfull[slot]);
        for (int k = 0; k < n_k; ++k, ++c) {
          const int s = c % STAGES;
          bar_wait(&empty[s], (uint32_t)((c / STAGES) & 1) ^ 1u);
          bar_expect_tx(&full[s], STAGE_BYTES);
          const int d0 = k * (KB / (int)sizeof(T));
          tma_2d(sq + s * Q_BYTES, &q_map, &full[s], d0, qt * TQ);
          tma_2d(sb + s * R_BYTES, &bank_map, &full[s], d0, (int)r0);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns queries 64*wg .. 64*wg+63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    // Left unset: the first wgmma of every tile overwrites it (scale-d 0),
    // and a write by any other instruction serialises the wgmma pipeline.
    acc_t acc[128];
    const uint32_t sq_wg = smem_u32(sq + wg * 64 * KB);
    const uint32_t sb_0 = smem_u32(sb);
    int c = 0;                         // chunks consumed so far, all tiles
    long it = 0;
    for (long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const long bt = t / n_qt;
      const int slot = (int)(it & 1);
      // this thread's query rows b0 and b0 + 8; a warpgroup whose rows are
      // all past B still runs the product on TMA's zero rows, because a
      // wgmma under a branch is serialised
      const int b0 = (int)(t % n_qt) * TQ + 64 * wg + 16 * warp + lane / 4;
      float qs[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        qs[i] = (q_scale != nullptr && b0 + 8 * i < B) ? q_scale[b0 + 8 * i]
                                                         : 1.0f;
      for (int k = 0; k < n_k; ++k, ++c) {
        const int s = c % STAGES;
        bar_wait(&full[s], (uint32_t)((c / STAGES) & 1));
        wg_fence();
        const uint64_t da = desc_sw128(sq_wg + s * Q_BYTES);
        const uint64_t db = desc_sw128(sb_0 + s * R_BYTES);
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          mma(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        wg_commit();
        if (k > 0) {
          wg_wait<1>();                 // chunk k-1 has been read
          if (lane == 0) bar_arrive(&empty[(c - 1) % STAGES]);
        }
      }
      wg_wait<0>();
      fence_acc(acc);
      if (lane == 0) bar_arrive(&empty[(c - 1) % STAGES]);

      // ---- epilogue: row terms, 8-row block max, all in registers ----
      bar_wait(&tfull[slot], (uint32_t)((it >> 1) & 1));
      const float* smul = terms + slot * TERM_FLOATS;
      epilogue_half<0>(acc, bt, b0, qs, smul, M, B, out, nb);
      epilogue_half<1>(acc, bt, b0, qs, smul, M, B, out, nb);
      __syncwarp();
      if (lane == 0) bar_arrive(&tempty[slot]);
    }
  }
}

// ---- host side -----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, D] row-major operand read in boxes of 128 bytes x box_rows
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, long rows, int D,
             int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(KB / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = encode(
      map, Traits<T>::map_type, 2, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* bank, const void* q, const float* mul, const float* add,
           const float* q_scale, float* out, long M, int D, int B,
           cudaStream_t stream) {
  CUtensorMap q_map, bank_map;
  int rc = make_map<T>(&q_map, q, B, D, TQ);
  if (rc == 0) rc = make_map<T>(&bank_map, bank, M, D, TR);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flat_blockmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_k = (D * (int)sizeof(T) + KB - 1) / KB;
  const int n_qt = (B + TQ - 1) / TQ;
  const long n_tiles = (long)n_qt * ((M + TR - 1) / TR);
  const long nb = (M + BLOCK_R - 1) / BLOCK_R;
  const unsigned grid = (unsigned)(n_tiles < sms ? n_tiles : sms);
  flat_blockmax_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      q_map, bank_map, mul, add, q_scale, out, M, B, n_k, n_qt, n_tiles, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flat_blockmax_launch(const void* bank, const void* q,
                                    const float* mul, const float* add,
                                    const float* q_scale, float* out, long M,
                                    int D, int B, int is_int8, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_int8)
    return launch<int8_t>(bank, q, mul, add, q_scale, out, M, D, B, s);
  return launch<__nv_bfloat16>(bank, q, mul, add, q_scale, out, M, D, B, s);
}
