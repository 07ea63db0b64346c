// Kimi Delta Attention's chunked core, for Hopper (sm_90a): the passes of
// `ops/kda.py`'s card path (the wrapper, `ops/cuda/kda.py`, keeps the
// plain versions, which the CPU runs and the tests hold these to).
//
// They replace no TPU kernel: the JAX package has no linear attention.
// Per head the recurrence is S_t = (I - b_t k_t k_t^T) Diag(exp g_t)
// S_{t-1} + b_t k_t v_t^T, o_t = S_t^T q_t, with a log decay g <= 0 per
// key channel. In chunks of C = 64 positions (G the decay's running sum
// inside the chunk, E_ti = exp(G_t - G_i) per channel) the card path
// computes, for every chunk at once, the intra-chunk matrices
//   A_ti = b_t sum_c k_t k_i E_ti (i < t),  P_ti = sum_c q_t k_i E_ti
//   (i <= t)
// (these two kernels), the WY factors W = (I + A)^-1 diag(b) (k exp G)
// and Ubar = (I + A)^-1 diag(b) v (batched products in PyTorch), and then
// carries the state from chunk to chunk (the two state kernels):
//   h_0 = 0;  U_n = Ubar_n - W_n h_n;  h_{n+1} = D_n h_n + Khat_n^T U_n
// with D_n = exp(G_last) and Khat = k exp(G_last - G); the output is
// (q exp G) h_n + P_n U_n (batched products again).
//
// Every exponent is <= 0: each E_ti is taken pairwise as one exp of
// G_t - G_i with i <= t (no factor exp(+G) of a running sum, which
// overflows f32 within a chunk at the published gate's ~16 nats a token).
//
// - intra_fwd: a block per (chunk, head), 256 threads; the chunk's q, k,
//   G in 32-channel tiles in shared memory; a thread owns one row t and
//   16 columns i, and sums both A and P over the channels (one exp a
//   pair and channel serves both). Bound: the 2080 pairs x 128 channels
//   of exps (the special-function units), not bytes.
// - intra_bwd: the same pairs again, from dA and dP: per (t, c) the row
//   sums dq and R = sum_{i<t} dA_ti k_i E_ti, per (i, c) the column sums
//   of (dP_ti q_t + dA_ti b_t k_t) E_ti; then dk = b R + colsum, dG =
//   q dq + k b R - k colsum, db_t = sum_c k_t R_t.
// - state_fwd: a block per (head, 32 value columns) walks the chunks in
//   order; the state's [128, 32] slice stays in registers (a copy in
//   shared memory for the product W_n h_n); W_n and Khat_n are read once
//   a block, fetched into registers a chunk ahead; the shared rows are
//   read as float4s. Writes h_n (each chunk's start state) and U_n.
// - state_bwd: the reverse walk: with dS the gradient of the chunk's end
//   state, dU_n = dU_ext_n + Khat_n dS and the gradient of h_n is dh_n +
//   D_n dS - W_n^T dU_n. Writes dS (each chunk's end-state gradient) and
//   dU_n.
// The state passes are latency-bound: one block of 8 warps an SM, a
// chunk's three products (~0.8 MFLOP a block) between two barriers. All
// arithmetic is f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // positions a chunk
constexpr int K = 128;         // key and value channels a head
constexpr int THREADS = 256;
constexpr int TILE = 32;       // channels a tile of the intra kernels
constexpr int BV = 32;         // value columns a block of the state passes
constexpr int KP = K + 1;      // padded rows: no bank conflicts
constexpr int BVP = BV + 4;     // 16-byte rows for float4 accesses

// ---------------------------------------------------------------------
// intra-chunk matrices
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
intra_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ G, const float* __restrict__ beta,
                 float* __restrict__ A, float* __restrict__ P) {
  __shared__ float qs[C][TILE + 1], ks[C][TILE + 1], gs[C][TILE + 1];
  const long base = (long)blockIdx.x * C * K;
  const int tid = threadIdx.x;
  const int t = tid / 4, j = tid % 4;      // row t, columns j, j+4, ...
  float a[16], p[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) a[u] = p[u] = 0.f;
  for (int c0 = 0; c0 < K; c0 += TILE) {
    __syncthreads();
    for (int e = tid; e < C * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE;
      const long at = base + (long)r * K + c0 + c;
      qs[r][c] = q[at];
      ks[r][c] = k[at];
      gs[r][c] = G[at];
    }
    __syncthreads();
    for (int c = 0; c < TILE; ++c) {
      const float qt = qs[t][c], kt = ks[t][c], gt = gs[t][c];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = j + 4 * u;
        if (i <= t) {
          const float ki = ks[i][c] * __expf(gt - gs[i][c]);
          a[u] += kt * ki;
          p[u] += qt * ki;
        }
      }
    }
  }
  const float bt = beta[(long)blockIdx.x * C + t];
  const long out = (long)blockIdx.x * C * C + (long)t * C;
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int i = j + 4 * u;
    A[out + i] = i < t ? bt * a[u] : 0.f;
    P[out + i] = i <= t ? p[u] : 0.f;
  }
}

// shared memory of intra_bwd: dA and dP [C][C], then the tiles of q, k,
// G, dq and R [C][TILE]
constexpr int BWD_INTRA_SMEM = (2 * C * C + 5 * C * TILE) * 4;

__global__ void __launch_bounds__(THREADS)
intra_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ G, const float* __restrict__ beta,
                 const float* __restrict__ dA, const float* __restrict__ dP,
                 float* __restrict__ dq, float* __restrict__ dk,
                 float* __restrict__ dG, float* __restrict__ dbeta) {
  extern __shared__ float sm[];
  float (*da)[C] = (float (*)[C])sm;
  float (*dp)[C] = (float (*)[C])(sm + C * C);
  float (*qs)[TILE] = (float (*)[TILE])(sm + 2 * C * C);
  float (*ks)[TILE] = qs + C;
  float (*gs)[TILE] = ks + C;
  float (*dqs)[TILE] = gs + C;
  float (*rs)[TILE] = dqs + C;
  __shared__ float bs[C], dbs[C];
  const long mat = (long)blockIdx.x * C * C;
  const long base = (long)blockIdx.x * C * K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int e = tid; e < C * C; e += THREADS) {
    const int t = e / C, i = e % C;
    da[t][i] = i < t ? dA[mat + e] : 0.f;
    dp[t][i] = i <= t ? dP[mat + e] : 0.f;
  }
  if (tid < C) {
    bs[tid] = beta[(long)blockIdx.x * C + tid];
    dbs[tid] = 0.f;
  }
  for (int c0 = 0; c0 < K; c0 += TILE) {
    __syncthreads();
    for (int e = tid; e < C * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE;
      const long at = base + (long)r * K + c0 + c;
      qs[r][c] = q[at];
      ks[r][c] = k[at];
      gs[r][c] = G[at];
    }
    __syncthreads();
    // row sums: warp w owns rows w, w + 8, ...; lane the channel
    for (int t = warp; t < C; t += THREADS / 32) {
      const float gt = gs[t][lane];
      float sq = 0.f, sr = 0.f;
      for (int i = 0; i <= t; ++i) {
        const float ki = ks[i][lane] * __expf(gt - gs[i][lane]);
        sq += dp[t][i] * ki;
        sr += da[t][i] * ki;
      }
      dqs[t][lane] = sq;
      rs[t][lane] = sr;
      float kr = ks[t][lane] * sr;
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        kr += __shfl_xor_sync(0xffffffffu, kr, o);
      if (lane == 0) dbs[t] += kr;          // the same warp every tile
    }
    __syncthreads();
    // column sums and the outputs of (i, channel)
    for (int i = warp; i < C; i += THREADS / 32) {
      const float gi = gs[i][lane];
      float sc = 0.f;
      for (int t = i; t < C; ++t) {
        const float e = __expf(gs[t][lane] - gi);
        sc += (dp[t][i] * qs[t][lane] + da[t][i] * bs[t] * ks[t][lane]) * e;
      }
      const float ki = ks[i][lane], dqi = dqs[i][lane];
      const float kr = bs[i] * rs[i][lane];
      const long at = base + (long)i * K + c0 + lane;
      dq[at] = dqi;
      dk[at] = kr + sc;
      dG[at] = qs[i][lane] * dqi + ki * kr - ki * sc;
    }
  }
  __syncthreads();
  if (tid < C) dbeta[(long)blockIdx.x * C + tid] = dbs[tid];
}

// ---------------------------------------------------------------------
// the state carried from chunk to chunk
// ---------------------------------------------------------------------

// shared memory of the state passes: two [C][KP] matrices, the state or
// its gradient [K][BVP], and U or dU [C][BVP]; BVP keeps every row's
// float4s 16-byte aligned and the float4 stores free of bank conflicts
constexpr int STATE_SMEM = (2 * C * KP + K * BVP + C * BVP) * 4;

// a chunk's [C][K] rows in float4s a thread: fetched into registers one
// chunk ahead (the loads land while the block computes), then stored into
// padded shared rows
constexpr int ROWS4 = C * K / 4 / THREADS;

__device__ __forceinline__ void fetch(float4* dst,
                                      const float* __restrict__ src,
                                      int tid) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int m = 0; m < ROWS4; ++m) dst[m] = __ldg(s4 + tid + m * THREADS);
}

__device__ __forceinline__ void stash(float (*dst)[KP], const float4* v,
                                      int tid) {
#pragma unroll
  for (int m = 0; m < ROWS4; ++m) {
    const int e = (tid + m * THREADS) * 4, r = e / K, c = e % K;
    dst[r][c] = v[m].x;
    dst[r][c + 1] = v[m].y;
    dst[r][c + 2] = v[m].z;
    dst[r][c + 3] = v[m].w;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[0..7] += w * row[0..7], the row read as two float4s
__device__ __forceinline__ void axpy8(float* acc, float w, const float* row) {
  const float4 a = ld4(row), b = ld4(row + 4);
  acc[0] += w * a.x; acc[1] += w * a.y; acc[2] += w * a.z; acc[3] += w * a.w;
  acc[4] += w * b.x; acc[5] += w * b.y; acc[6] += w * b.z; acc[7] += w * b.w;
}

__global__ void __launch_bounds__(THREADS)
state_fwd_kernel(const float* __restrict__ W, const float* __restrict__ Ubar,
                 const float* __restrict__ Khat, const float* __restrict__ D,
                 float* __restrict__ h, float* __restrict__ U, int chunks) {
  extern __shared__ float sm[];
  float (*ws)[KP] = (float (*)[KP])sm;
  float (*kh)[KP] = ws + C;
  float (*ss)[BVP] = (float (*)[BVP])(sm + 2 * C * KP);
  float (*us)[BVP] = ss + K;
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * BV;
  const long head = blockIdx.y;
  // U phase: row t, value columns vq .. vq + 7; state phase: channel c,
  // value columns vh .. vh + 15
  const int t = tid / 4, vq = (tid % 4) * 8;
  const int c = tid % K, vh = (tid / K) * 16;
  float s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; j += 4) st4(&ss[c][vh + j], 0.f, 0.f, 0.f, 0.f);
  float4 nw[ROWS4], nk[ROWS4];
  fetch(nw, W + head * chunks * C * K, tid);
  fetch(nk, Khat + head * chunks * C * K, tid);
  for (int n = 0; n < chunks; ++n) {
    const long chunk = head * chunks + n;
    __syncthreads();
    stash(ws, nw, tid);
    stash(kh, nk, tid);
    if (n + 1 < chunks) {
      fetch(nw, W + (chunk + 1) * C * K, tid);
      fetch(nk, Khat + (chunk + 1) * C * K, tid);
    }
    __syncthreads();
    // U = Ubar - W h
    float acc[8];
    const float* ub = Ubar + (chunk * C + t) * K + v0 + vq;
    const float4 u0 = ld4(ub), u1 = ld4(ub + 4);
    acc[0] = u0.x; acc[1] = u0.y; acc[2] = u0.z; acc[3] = u0.w;
    acc[4] = u1.x; acc[5] = u1.y; acc[6] = u1.z; acc[7] = u1.w;
    for (int cc = 0; cc < K; ++cc) axpy8(acc, -ws[t][cc], &ss[cc][vq]);
    float* uo = U + (chunk * C + t) * K + v0 + vq;
    st4(&us[t][vq], acc[0], acc[1], acc[2], acc[3]);
    st4(&us[t][vq + 4], acc[4], acc[5], acc[6], acc[7]);
    st4(uo, acc[0], acc[1], acc[2], acc[3]);
    st4(uo + 4, acc[4], acc[5], acc[6], acc[7]);
    __syncthreads();
    // h_n out, then h_{n+1} = D h_n + Khat^T U
    float* ho = h + (chunk * K + c) * K + v0 + vh;
#pragma unroll
    for (int j = 0; j < 16; j += 4) st4(ho + j, s[j], s[j + 1], s[j + 2],
                                        s[j + 3]);
    const float d = D[chunk * K + c];
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] *= d;
    for (int tt = 0; tt < C; ++tt) {
      const float kv = kh[tt][c];
      axpy8(s, kv, &us[tt][vh]);
      axpy8(s + 8, kv, &us[tt][vh + 8]);
    }
#pragma unroll
    for (int j = 0; j < 16; j += 4) st4(&ss[c][vh + j], s[j], s[j + 1],
                                        s[j + 2], s[j + 3]);
  }
}

__global__ void __launch_bounds__(THREADS)
state_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ dUext,
                 const float* __restrict__ W, const float* __restrict__ Khat,
                 const float* __restrict__ D, float* __restrict__ dS,
                 float* __restrict__ dU, int chunks) {
  extern __shared__ float sm[];
  float (*ws)[KP] = (float (*)[KP])sm;
  float (*kh)[KP] = ws + C;
  float (*ss)[BVP] = (float (*)[BVP])(sm + 2 * C * KP);
  float (*us)[BVP] = ss + K;
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * BV;
  const long head = blockIdx.y;
  const int t = tid / 4, vq = (tid % 4) * 8;
  const int c = tid % K, vh = (tid / K) * 16;
  float s[16];                 // the gradient of the chunk's end state
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; j += 4) st4(&ss[c][vh + j], 0.f, 0.f, 0.f, 0.f);
  float4 nw[ROWS4], nk[ROWS4];
  fetch(nw, W + (head * chunks + chunks - 1) * C * K, tid);
  fetch(nk, Khat + (head * chunks + chunks - 1) * C * K, tid);
  for (int n = chunks - 1; n >= 0; --n) {
    const long chunk = head * chunks + n;
    __syncthreads();
    stash(ws, nw, tid);
    stash(kh, nk, tid);
    if (n > 0) {
      fetch(nw, W + (chunk - 1) * C * K, tid);
      fetch(nk, Khat + (chunk - 1) * C * K, tid);
    }
    float* so = dS + (chunk * K + c) * K + v0 + vh;
#pragma unroll
    for (int j = 0; j < 16; j += 4) st4(so + j, s[j], s[j + 1], s[j + 2],
                                        s[j + 3]);
    __syncthreads();
    // dU = dU_ext + Khat dS
    float acc[8];
    const float* ue = dUext + (chunk * C + t) * K + v0 + vq;
    const float4 e0 = ld4(ue), e1 = ld4(ue + 4);
    acc[0] = e0.x; acc[1] = e0.y; acc[2] = e0.z; acc[3] = e0.w;
    acc[4] = e1.x; acc[5] = e1.y; acc[6] = e1.z; acc[7] = e1.w;
    for (int cc = 0; cc < K; ++cc) axpy8(acc, kh[t][cc], &ss[cc][vq]);
    float* uo = dU + (chunk * C + t) * K + v0 + vq;
    st4(&us[t][vq], acc[0], acc[1], acc[2], acc[3]);
    st4(&us[t][vq + 4], acc[4], acc[5], acc[6], acc[7]);
    st4(uo, acc[0], acc[1], acc[2], acc[3]);
    st4(uo + 4, acc[4], acc[5], acc[6], acc[7]);
    __syncthreads();
    // the gradient of h_n: dh_n + D dS - W^T dU
    const float d = D[chunk * K + c];
    const float* hi = dh + (chunk * K + c) * K + v0 + vh;
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      const float4 x = ld4(hi + j);
      s[j] = x.x + d * s[j];
      s[j + 1] = x.y + d * s[j + 1];
      s[j + 2] = x.z + d * s[j + 2];
      s[j + 3] = x.w + d * s[j + 3];
    }
    for (int tt = 0; tt < C; ++tt) {
      const float w = -ws[tt][c];
      axpy8(s, w, &us[tt][vh]);
      axpy8(s + 8, w, &us[tt][vh + 8]);
    }
#pragma unroll
    for (int j = 0; j < 16; j += 4) st4(&ss[c][vh + j], s[j], s[j + 1],
                                        s[j + 2], s[j + 3]);
  }
}

int allow_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// A, P [n, C, C] of q, k, G [n, C, K] and beta [n, C] (n chunks x heads).
extern "C" int kda_intra_fwd_launch(const float* q, const float* k,
                                    const float* G, const float* beta,
                                    float* A, float* P, long n,
                                    void* stream) {
  if (n <= 0) return 0;
  intra_fwd_kernel<<<(unsigned)n, THREADS, 0, (cudaStream_t)stream>>>(
      q, k, G, beta, A, P);
  return (int)cudaGetLastError();
}

// dq, dk, dG [n, C, K] and dbeta [n, C] from dA, dP [n, C, C].
extern "C" int kda_intra_bwd_launch(const float* q, const float* k,
                                    const float* G, const float* beta,
                                    const float* dA, const float* dP,
                                    float* dq, float* dk, float* dG,
                                    float* dbeta, long n, void* stream) {
  if (n <= 0) return 0;
  int rc = allow_smem((const void*)intra_bwd_kernel, BWD_INTRA_SMEM);
  if (rc) return rc;
  intra_bwd_kernel<<<(unsigned)n, THREADS, BWD_INTRA_SMEM,
                     (cudaStream_t)stream>>>(q, k, G, beta, dA, dP, dq, dk,
                                             dG, dbeta);
  return (int)cudaGetLastError();
}

// h [heads, chunks, K, K] (each chunk's start state) and U [heads,
// chunks, C, K] from W, Ubar, Khat [heads, chunks, C, K], D [heads,
// chunks, K].
extern "C" int kda_state_fwd_launch(const float* W, const float* Ubar,
                                    const float* Khat, const float* D,
                                    float* h, float* U, int heads,
                                    int chunks, void* stream) {
  if (heads <= 0 || chunks <= 0) return 0;
  int rc = allow_smem((const void*)state_fwd_kernel, STATE_SMEM);
  if (rc) return rc;
  state_fwd_kernel<<<dim3(K / BV, heads), THREADS, STATE_SMEM,
                     (cudaStream_t)stream>>>(W, Ubar, Khat, D, h, U, chunks);
  return (int)cudaGetLastError();
}

// dS [heads, chunks, K, K] (each chunk's end-state gradient) and dU
// [heads, chunks, C, K] from dh (the start states' gradient from
// elsewhere), dUext, W, Khat and D.
extern "C" int kda_state_bwd_launch(const float* dh, const float* dUext,
                                    const float* W, const float* Khat,
                                    const float* D, float* dS, float* dU,
                                    int heads, int chunks, void* stream) {
  if (heads <= 0 || chunks <= 0) return 0;
  int rc = allow_smem((const void*)state_bwd_kernel, STATE_SMEM);
  if (rc) return rc;
  state_bwd_kernel<<<dim3(K / BV, heads), THREADS, STATE_SMEM,
                     (cudaStream_t)stream>>>(dh, dUext, W, Khat, D, dS, dU,
                                             chunks);
  return (int)cudaGetLastError();
}
