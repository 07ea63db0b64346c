// Kernels B, C, D and E: the IVF probe scan, for Hopper (sm_90a).
//
// Kernel C replaces the Pallas `ivf_scan_scores` (v1,
// aura_snn_rag_tpu/ops/pallas/ivf_scan.py:550): bf16 cosines of each query
// against its P probed [C, D] cluster blocks -> [B, P, C] f32.
//
// Kernel B replaces the Pallas `ivf_retrieve_fused` (v3r,
// aura_snn_rag_tpu/ops/pallas/ivf_scan.py:317): coarse score
// aux0 * cos + aux1 over the probed blocks, exact top-kk across probes
// (ties to the lowest flat index p*C + c, dead lanes forced to -1e30),
// exact f32 rerank of the kk raw bank rows, and the final top-k.
//
// Kernel D replaces the Pallas `ivf_candidates` (v3,
// aura_snn_rag_tpu/ops/pallas/ivf_scan.py:186): B without the rerank, the
// coarse top-kk across probes sorted descending with its bank slots.
//
// Kernel E replaces the Pallas `ivf_topk_scores` (v2,
// aura_snn_rag_tpu/ops/pallas/ivf_scan.py:62): the same coarse score, then
// the exact top-k of each probe (ties to the lowest c), in 128 lanes.
//
// Bound on the H100: all four read the P probed bf16 blocks once per query
// (P*C*D*2 bytes, 50 MB at P=64, C=512, D=768) at 3.35 TB/s; the
// arithmetic is a matrix-vector product, so bytes bound them. The TPU
// kernels ran one program per query with [P, C] scratch in VMEM, which
// neither fits a CTA's 227 KB of shared memory at full width nor fills
// 132 SMs at B = 1. So every kernel runs in two passes:
//   1. coarse pass (shared by all four): a (row chunk, probe, query) grid,
//      one warp per clustered row, 16-byte loads, f32 accumulation; writes
//      the cosine or coarse score to a [B, P*C] scratch in device memory
//      (L2-resident at small B);
//   2. select pass: `select_topkk`, a radix select over 64-bit keys (score
//      bits, then the inverted index, which encodes the lowest-index tie
//      rule) that finds the top-kk, and a bitonic sort that orders them.
//      B and D run it on one 1024-thread CTA per query over all P*C
//      scores; B then reranks (one warp per candidate) and takes the final
//      top-k. E runs it on one 256-thread CTA per (probe, query) over C.
// The scores live in device memory, not shared memory, so C has no
// shared-memory limit (E keeps at most 128 keys; every kernel needs
// P*C < 2^31 for the 32-bit index in its keys); D's sorted keys do:
// kk <= 16384 (128 KB).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int COARSE_ROWS = 64;        // clustered rows per coarse CTA
constexpr int COARSE_THREADS = 256;
constexpr int SEL_THREADS = 1024;      // per-query select (B, D)
constexpr int TOPK_THREADS = 256;      // per-probe select (E)
constexpr int KPAD = 128;              // lanes of E's per-probe output
constexpr float NEG_INF_F = -1e30f;
constexpr float DEAD = -5e29f;         // scores at or below are dead lanes

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool WITH_AUX>
__global__ void __launch_bounds__(COARSE_THREADS)
ivf_coarse_kernel(const __nv_bfloat16* __restrict__ clustered,
                  const float* __restrict__ aux, const float* __restrict__ qn,
                  const int* __restrict__ top_c, float* __restrict__ out,
                  int C, int D, int P) {
  extern __shared__ float sq[];        // [D] query, rounded to bf16
  const int b = blockIdx.z, p = blockIdx.y;
  const int c0 = blockIdx.x * COARSE_ROWS;
  for (int d = threadIdx.x; d < D; d += COARSE_THREADS)
    sq[d] = __bfloat162float(__float2bfloat16_rn(qn[(long)b * D + d]));
  __syncthreads();
  const long cid = top_c[b * P + p];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* blk = clustered + cid * C * (long)D;
  for (int r = warp; r < COARSE_ROWS; r += COARSE_THREADS / 32) {
    const int c = c0 + r;
    if (c >= C) break;
    const uint4* row = reinterpret_cast<const uint4*>(blk + (long)c * D);
    float acc = 0.f;
    for (int ch = lane; ch < D / 8; ch += 32) {
      const uint4 v = row[ch];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(h[t]);
        acc = fmaf(f.x, sq[ch * 8 + 2 * t], acc);
        acc = fmaf(f.y, sq[ch * 8 + 2 * t + 1], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      float v = acc;
      if (WITH_AUX) {
        const float* a = aux + cid * 8 * C;
        v = __fadd_rn(__fmul_rn(a[c], acc), a[C + c]);
      }
      out[((long)b * P + p) * C + c] = v;
    }
  }
}

// Orders (score desc, index asc) as one unsigned 64-bit key.
__device__ __forceinline__ unsigned long long sort_key(float s, unsigned idx) {
  const unsigned u = __float_as_uint(s + 0.0f);    // -0 sorts as +0
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)k << 32) | (0xFFFFFFFFu - idx);
}

__device__ __forceinline__ unsigned key_index(unsigned long long key) {
  return 0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull);
}

struct SelectShared {
  unsigned hist[256];
  unsigned long long prefix, mask;
  int need, done, count;
};

// Leaves the kk largest keys sort_key(sc[i], i), i < N, in ckey[0, kk)
// sorted descending, and zeros (which sort last) in ckey[kk, kkp).
// Requires 0 < kk <= N and kkp the power of two >= kk; every thread of
// the CTA (NT of them) calls it, and it ends on a barrier. Inlined, so
// the compiler sees that `st` and `ckey` are shared memory.
template <int NT>
__device__ __forceinline__ void select_topkk(const float* __restrict__ sc, int N, int kk,
                             int kkp, unsigned long long* ckey,
                             SelectShared& st) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    st.prefix = 0ull; st.mask = 0ull; st.need = kk; st.done = 0;
    st.count = 0;
  }
  for (int i = tid; i < kkp; i += NT) ckey[i] = 0ull;
  __syncthreads();

  // ---- radix select of the kk-th largest key, 8 bits per pass ----------
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += NT) st.hist[i] = 0u;
    __syncthreads();
    const unsigned long long prefix = st.prefix, mask = st.mask;
    for (int i = tid; i < N; i += NT) {
      const unsigned long long key = sort_key(sc[i], (unsigned)i);
      if ((key & mask) == prefix)
        atomicAdd(&st.hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      int need = st.need;
      int d = 255;
      for (; d > 0; --d) {
        if ((int)st.hist[d] >= need) break;
        need -= (int)st.hist[d];
      }
      st.prefix = prefix | ((unsigned long long)d << shift);
      st.mask = mask | (255ull << shift);
      st.need = need;
      st.done = ((int)st.hist[d] == need);
    }
    __syncthreads();
    if (st.done) break;
  }

  // ---- collect exactly kk keys, then sort them descending --------------
  {
    const unsigned long long prefix = st.prefix, mask = st.mask;
    for (int i = tid; i < N; i += NT) {
      const unsigned long long key = sort_key(sc[i], (unsigned)i);
      if ((key & mask) >= prefix) {
        const int pos = atomicAdd(&st.count, 1);
        if (pos < kkp) ckey[pos] = key;
      }
    }
  }
  __syncthreads();
  for (int size = 2; size <= kkp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < kkp; i += NT) {
        const int j = i ^ stride;
        if (j > i) {
          const bool desc = (i & size) == 0;
          const unsigned long long a = ckey[i], c = ckey[j];
          if (desc ? (a < c) : (a > c)) { ckey[i] = c; ckey[j] = a; }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(SEL_THREADS)
ivf_select_rerank_kernel(const float* __restrict__ scores,
                         const float* __restrict__ aux,
                         const int* __restrict__ top_c,
                         const float* __restrict__ features,
                         const float* __restrict__ qn,
                         float* __restrict__ out_s, int* __restrict__ out_slot,
                         int C, int P, int D, long M, int kk, int kkp, int k,
                         int kpad) {
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned long long* ckey = reinterpret_cast<unsigned long long*>(dyn);  // [kkp]
  float* sq = reinterpret_cast<float*>(ckey + kkp);                       // [D]
  float* ca0 = sq + D;                                                    // [kk]
  float* ca1 = ca0 + kk;
  float* cex = ca1 + kk;
  int* cslot = reinterpret_cast<int*>(cex + kk);
  int* ctaken = cslot + kk;
  __shared__ SelectShared st;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* sc = scores + (long)b * P * C;
  for (int d = tid; d < D; d += SEL_THREADS) sq[d] = qn[(long)b * D + d];
  select_topkk<SEL_THREADS>(sc, P * C, kk, kkp, ckey, st);

  // ---- candidate metadata; dead lanes get a0 = 0, a1 = -1e30 -----------
  for (int j = tid; j < kk; j += SEL_THREADS) {
    const unsigned idx = key_index(ckey[j]);
    const float s = sc[idx];
    const int p = idx / C, c = idx % C;
    const float* a = aux + (long)top_c[b * P + p] * 8 * C;
    const bool live = s > DEAD;
    ca0[j] = live ? a[c] : 0.f;
    ca1[j] = live ? a[C + c] : NEG_INF_F;
    cslot[j] = live ? (int)a[2 * C + c] : -1;
    ctaken[j] = 0;
  }
  __syncthreads();

  // ---- exact f32 rerank, one warp per candidate ------------------------
  const int warp = tid / 32, lane = tid % 32;
  for (int j = warp; j < kk; j += SEL_THREADS / 32) {
    const int slot = cslot[j];
    float ex = NEG_INF_F;
    if (slot >= 0) {
      const long r = slot < M ? slot : M - 1;
      const float4* row = reinterpret_cast<const float4*>(features + r * D);
      float dot = 0.f, n2 = 0.f;
      for (int ch = lane; ch < D / 4; ch += 32) {
        const float4 v = row[ch];
        dot = fmaf(v.x, sq[4 * ch], dot);
        dot = fmaf(v.y, sq[4 * ch + 1], dot);
        dot = fmaf(v.z, sq[4 * ch + 2], dot);
        dot = fmaf(v.w, sq[4 * ch + 3], dot);
        n2 = fmaf(v.x, v.x, n2);
        n2 = fmaf(v.y, v.y, n2);
        n2 = fmaf(v.z, v.z, n2);
        n2 = fmaf(v.w, v.w, n2);
      }
      dot = warp_sum(dot);
      n2 = warp_sum(n2);
      const float cos = __fmul_rn(dot, rsqrtf(__fadd_rn(n2, 1e-12f)));
      ex = __fadd_rn(__fmul_rn(ca0[j], cos), ca1[j]);
    }
    if (lane == 0) cex[j] = ex;
  }
  __syncthreads();

  // ---- final top-k, ties to the lower funnel lane ----------------------
  if (warp == 0) {
    for (int t = 0; t < k; ++t) {
      float bv = -INFINITY;
      int bj = INT_MAX;
      for (int j = lane; j < kk; j += 32) {
        const float v = cex[j];
        if (!ctaken[j] && (v > bv || (v == bv && j < bj))) { bv = v; bj = j; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
        if (ov > bv || (ov == bv && oj < bj)) { bv = ov; bj = oj; }
      }
      if (lane == 0) {
        const bool hit = bj < kk && bv > DEAD;
        if (bj < kk) ctaken[bj] = 1;
        out_s[(long)b * kpad + t] = hit ? bv : NEG_INF_F;
        out_slot[(long)b * kpad + t] = hit ? cslot[bj] : -1;
      }
      __syncwarp();
    }
    for (int t = k + lane; t < kpad; t += 32) {
      out_s[(long)b * kpad + t] = NEG_INF_F;
      out_slot[(long)b * kpad + t] = -1;
    }
  }
}

// Kernel D's select pass: one CTA per query. Every lane holds its entry's
// coarse score and bank slot as they are; a dead entry (score <= -5e29)
// fills lanes once the live ones run out, and the caller masks it.
__global__ void __launch_bounds__(SEL_THREADS)
ivf_candidates_select_kernel(const float* __restrict__ scores,
                             const float* __restrict__ aux,
                             const int* __restrict__ top_c,
                             float* __restrict__ out_s,
                             int* __restrict__ out_slot, int C, int P, int kk,
                             int kkp) {
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned long long* ckey = reinterpret_cast<unsigned long long*>(dyn);  // [kkp]
  __shared__ SelectShared st;
  const int b = blockIdx.x;
  const float* sc = scores + (long)b * P * C;
  select_topkk<SEL_THREADS>(sc, P * C, kk, kkp, ckey, st);
  for (int j = threadIdx.x; j < kk; j += SEL_THREADS) {
    const unsigned idx = key_index(ckey[j]);
    const int p = idx / C, c = idx % C;
    out_s[(long)b * kk + j] = sc[idx];
    out_slot[(long)b * kk + j] =
        (int)aux[((long)top_c[b * P + p] * 8 + 2) * C + c];
  }
}

// Kernel E's select pass: one CTA per (probe, query). Lanes < k as in D,
// within the probe; lanes k..127 hold -1e30 and slot 0.
__global__ void __launch_bounds__(TOPK_THREADS)
ivf_topk_select_kernel(const float* __restrict__ scores,
                       const float* __restrict__ aux,
                       const int* __restrict__ top_c,
                       float* __restrict__ out_s, int* __restrict__ out_slot,
                       int C, int P, int k, int kp) {
  __shared__ unsigned long long ckey[KPAD];        // [kp], kp <= KPAD
  __shared__ SelectShared st;
  const long row = (long)blockIdx.y * P + blockIdx.x;
  const float* sc = scores + row * C;
  select_topkk<TOPK_THREADS>(sc, C, k, kp, ckey, st);
  const float* a = aux + (long)top_c[row] * 8 * C;
  for (int j = threadIdx.x; j < KPAD; j += TOPK_THREADS) {
    float s = NEG_INF_F;
    int slot = 0;
    if (j < k) {
      const unsigned c = key_index(ckey[j]);
      s = sc[c];
      slot = (int)a[2 * C + c];
    }
    out_s[row * KPAD + j] = s;
    out_slot[row * KPAD + j] = slot;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Opts in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool WITH_AUX>
cudaError_t launch_coarse(const void* clustered, const float* aux,
                          const float* qn, const int* top_c, float* out,
                          int C, int D, int B, int P, cudaStream_t s) {
  const dim3 grid((C + COARSE_ROWS - 1) / COARSE_ROWS, P, B);
  ivf_coarse_kernel<WITH_AUX><<<grid, COARSE_THREADS, D * sizeof(float), s>>>(
      static_cast<const __nv_bfloat16*>(clustered), aux, qn, top_c, out, C,
      D, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ivf_scan_scores_launch(const void* clustered, const float* qn,
                                      const int* top_c, float* out, int C,
                                      int D, int B, int P, void* stream) {
  return (int)launch_coarse<false>(clustered, nullptr, qn, top_c, out, C, D,
                                   B, P,
                                   reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int ivf_retrieve_fused_launch(
    const void* clustered, const float* aux, const float* features,
    const float* qn, const int* top_c, float* scratch, float* out_s,
    int* out_slot, int C, int D, long M, int B, int P, int kk, int k,
    int kpad, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_coarse<true>(clustered, aux, qn, top_c, scratch, C,
                                        D, B, P, s);
  if (err != cudaSuccess) return (int)err;
  const int kkp = pow2_at_least(kk);
  const size_t smem = (size_t)kkp * 8 + (size_t)D * 4 + (size_t)kk * 4 * 5;
  err = allow_smem(ivf_select_rerank_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ivf_select_rerank_kernel<<<B, SEL_THREADS, smem, s>>>(
      scratch, aux, top_c, features, qn, out_s, out_slot, C, P, D, M, kk, kkp,
      k, kpad);
  return (int)cudaGetLastError();
}

extern "C" int ivf_candidates_launch(const void* clustered, const float* aux,
                                     const float* qn, const int* top_c,
                                     float* scratch, float* out_s,
                                     int* out_slot, int C, int D, int B,
                                     int P, int kk, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_coarse<true>(clustered, aux, qn, top_c, scratch, C,
                                        D, B, P, s);
  if (err != cudaSuccess) return (int)err;
  const int kkp = pow2_at_least(kk);
  const size_t smem = (size_t)kkp * 8;
  err = allow_smem(ivf_candidates_select_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ivf_candidates_select_kernel<<<B, SEL_THREADS, smem, s>>>(
      scratch, aux, top_c, out_s, out_slot, C, P, kk, kkp);
  return (int)cudaGetLastError();
}

extern "C" int ivf_topk_scores_launch(const void* clustered, const float* aux,
                                      const float* qn, const int* top_c,
                                      float* scratch, float* out_s,
                                      int* out_slot, int C, int D, int B,
                                      int P, int k, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_coarse<true>(clustered, aux, qn, top_c, scratch, C,
                                        D, B, P, s);
  if (err != cudaSuccess) return (int)err;
  ivf_topk_select_kernel<<<dim3(P, B), TOPK_THREADS, 0, s>>>(
      scratch, aux, top_c, out_s, out_slot, C, P, k, pow2_at_least(k));
  return (int)cudaGetLastError();
}
