// Kernel A: flat block-max scan over the coarse bank, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `flat_blockmax`
// (aura_snn_rag_tpu/ops/pallas/flat_scan.py:172). For every query b and
// every 8-row block g of the bank it returns
//     out[b, g] = max_{r in 8g..8g+7} (cos[b, r] * mul[r] + add[r])
// with cos = q . bank^T (int8: acc * 1/127^2 * q_scale[b]); rows past M
// count as -1e30. The [B, M] score matrix never reaches device memory.
//
// Bound on the H100: at B = 1024 the int8 product is 2*B*M*D operations
// at 1979 TOP/s, above the bytes (bank once, row terms, the [B, M/8]
// output) at 3.35 TB/s, so the tensor cores set the floor. This first
// version is a plain shared-memory tiled GEMM on the WMMA API (mma.sync
// on the tensor cores: s8 x s8 -> s32 exact, bf16 x bf16 -> f32) with the
// block-max reduced in the epilogue from shared memory. Query tiles vary
// fastest in the grid, so the CTAs that share a bank tile run together
// and read it from L2. No cp.async pipeline, no wgmma, no TMA yet.
//
// Blocks are contiguous (block g = rows 8g..8g+7), unlike the TPU
// kernel's strided-within-tile layout that existed for its lanes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TQ = 64;                 // queries per CTA tile
constexpr int TR = 128;                // bank rows per CTA tile
constexpr int TK = 64;                 // depth staged per step (elements)
constexpr int KS = TK / 16;            // 16-deep WMMA slices per step
constexpr int THREADS = 256;           // 8 warps: 2 along queries x 4 along rows
constexpr int BLOCK_R = 8;
constexpr int BLOCKS_PER_TILE = TR / BLOCK_R;
constexpr int LDC = TR + 4;            // epilogue row pitch (floats)
constexpr float NEG_INF_F = -1e30f;
constexpr float INV_127SQ = (float)(1.0 / (127.0 * 127.0));

template <typename T> struct Traits;
template <> struct Traits<int8_t> {
  using acc_t = int;
  using wmma_t = signed char;
};
template <> struct Traits<__nv_bfloat16> {
  using acc_t = float;
  using wmma_t = __nv_bfloat16;
};

// Shared operand layout: [KS][rows][16] elements, so every WMMA fragment
// starts on a 32-byte boundary with a 16-element leading dimension.
template <typename T, int ROWS>
__device__ __forceinline__ void stage(T* dst, const T* src, long row0,
                                      long n_rows, int D, int d0) {
  constexpr int EPC = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int CPR = TK / EPC;                // chunks per row per step
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int row = c / CPR;
    const int e = (c % CPR) * EPC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (row0 + row) * (long)D + d0 + e);
    *reinterpret_cast<uint4*>(dst + ((e / 16) * ROWS + row) * 16 + (e % 16)) = v;
  }
}

__device__ __forceinline__ float to_cos(int acc, float qs) {
  return __fmul_rn(__fmul_rn((float)acc, INV_127SQ), qs);
}
__device__ __forceinline__ float to_cos(float acc, float) { return acc; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
flat_blockmax_kernel(const T* __restrict__ bank, const T* __restrict__ q,
                     const float* __restrict__ mul,
                     const float* __restrict__ add,
                     const float* __restrict__ q_scale,
                     float* __restrict__ out, long M, int D, int B, int n_qt,
                     long nb) {
  using acc_t = typename Traits<T>::acc_t;
  using wmma_t = typename Traits<T>::wmma_t;
  constexpr int OPER_BYTES = KS * (TQ + TR) * 16 * (int)sizeof(T);
  constexpr int EPI_BYTES = TQ * LDC * 4;
  constexpr int SMEM = OPER_BYTES > EPI_BYTES ? OPER_BYTES : EPI_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sB = sQ + KS * TQ * 16;
  acc_t* sC = reinterpret_cast<acc_t*>(smem);

  const int qt = blockIdx.x % n_qt;
  const long rt = blockIdx.x / n_qt;
  const int q0 = qt * TQ;
  const long r0 = rt * TR;
  const int warp = threadIdx.x / 32;
  const int wq = warp / 4, wr = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, acc_t> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (acc_t)0);

  for (int d0 = 0; d0 < D; d0 += TK) {
    stage<T, TQ>(sQ, q, q0, B, D, d0);
    stage<T, TR>(sB, bank, r0, M, D, d0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, wmma_t, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, wmma_t, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i],
            reinterpret_cast<const wmma_t*>(sQ + (ks * TQ + wq * 32 + i * 16) * 16),
            16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j],
            reinterpret_cast<const wmma_t*>(sB + (ks * TR + wr * 32 + j * 16) * 16),
            16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wq * 32 + i * 16) * LDC + wr * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: dequantize, apply the per-row affine terms, reduce 8 rows
  for (int e = threadIdx.x; e < TQ * BLOCKS_PER_TILE; e += THREADS) {
    const int ql = e / BLOCKS_PER_TILE;
    const int bl = e % BLOCKS_PER_TILE;
    const int qi = q0 + ql;
    const long g = rt * BLOCKS_PER_TILE + bl;
    if (qi >= B || g >= nb) continue;
    const float qs = q_scale ? q_scale[qi] : 1.0f;
    float best = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_R; ++j) {
      const long r = g * BLOCK_R + j;
      float v = NEG_INF_F;
      if (r < M) {
        const float cos = to_cos(sC[ql * LDC + bl * BLOCK_R + j], qs);
        v = __fadd_rn(__fmul_rn(cos, mul[r]), add[r]);
      }
      best = fmaxf(best, v);
    }
    out[(long)qi * nb + g] = best;
  }
}

}  // namespace

extern "C" int flat_blockmax_launch(const void* bank, const void* q,
                                    const float* mul, const float* add,
                                    const float* q_scale, float* out, long M,
                                    int D, int B, int is_int8, void* stream) {
  const int n_qt = (B + TQ - 1) / TQ;
  const long n_rt = (M + TR - 1) / TR;
  const long nb = (M + BLOCK_R - 1) / BLOCK_R;
  const dim3 grid((unsigned)(n_qt * n_rt));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_int8)
    flat_blockmax_kernel<int8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(bank), static_cast<const int8_t*>(q), mul,
        add, q_scale, out, M, D, B, n_qt, nb);
  else
    flat_blockmax_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(bank),
        static_cast<const __nv_bfloat16*>(q), mul, add, q_scale, out, M, D, B,
        n_qt, nb);
  return (int)cudaGetLastError();
}
