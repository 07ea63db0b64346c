// The held experts' row passes around torch._grouped_mm, for Hopper
// (sm_90a): the gather, the SwiGLU and the weighted combine of
// `ops/experts.py` `_HeldExperts`, forward and backward.
//
// They replace no TPU kernel: the JAX package has no Pallas kernel for
// DeepSeek-V3's experts. They exist because the row buffer is sized for
// the most the picks can bring (T * min(k, held) rows and each group's
// padding), so that routing needs no host sync and drops no token, while
// routing fills about an eighth of it; a PyTorch op runs over the whole
// buffer, and only the grouped products stop at the groups' ends.
//
// Each kernel reads the groups' end offs[held - 1] on the device and
// touches only the rows below it (the combines gather the rows of the
// picks that lie below it). Rows from the end up to R are neither read
// nor written. The grids are fixed on the host (a grid-stride loop over
// warps, at most 8 blocks of 256 threads an SM), so a launch needs
// nothing from the device and stays capturable in a CUDA graph; a warp
// whose first row lies past the end returns at once.
//
// Bound on the H100: bytes. Every pass is elementwise over the filled
// rows, or a k-term sum per token, at under one operation per byte. At
// the Moonlight cell's shape (T = 32,768, D = 2048, I = 1408, 8 held, k =
// 6, ~24,700 filled rows) each moves 0.2-0.42 GB, 60-125 us at 3.35 TB/s.
// A warp takes one row (or one token): 16-byte loads and stores, lanes on
// neighbouring addresses, f32 arithmetic, one rounding to bf16.
//
// - gather: xs[r] = x[src[r] / k], 0 for a padding row (src < 0).
// - swiglu: a[r] = silu(g) * u of h[r] = [g | u].
// - combine: y[t] = sum over picks p held here (pos < end) of
//   w[t, p] * o[pos[t * k + p]], in f32, in pick order; unweighted for the
//   gradient combine (gx[t] = sum of gxs[pos]). A gather by token: no
//   atomics, one fixed order, every token written.
// - grad_gather: gyr[r] = gy[src[r] / k], go[r] = w[src[r]] * gyr[r];
//   zeros for a padding row.
// - swiglu_bwd: from g, u, ga0 and the row's weight wt (0 for padding):
//   a = silu(g) * u (as the forward rounded it), gw[src[r]] = sum_i a *
//   ga0 (f32), ga = wt * ga0, dh = [ga * u * silu'(g) | ga * silu(g)].
//
// src[r] is the flat pick t * k + p of row r (-1: padding), pos[t * k +
// p] the row of pick p of token t (R: not held here).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 8;

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) {
    cudaGetLastError();
    return fallback;
  }
  return v;
}

// Blocks for `rows` rows of one warp each, at most BLOCKS_PER_SM an SM.
int grid_for(long rows) {
  static const int n_sm = device_attr(cudaDevAttrMultiProcessorCount, 132);
  long blocks = (rows + WARPS - 1) / WARPS;
  long cap = (long)n_sm * BLOCKS_PER_SM;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

__device__ __forceinline__ long first_warp() {
  return (long)blockIdx.x * WARPS + threadIdx.x / 32;
}

__device__ __forceinline__ long warp_stride() {
  return (long)gridDim.x * WARPS;
}

__device__ __forceinline__ void unpack(const uint4& q, float f[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[8]) {
  uint4 q;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return q;
}

__device__ __forceinline__ float sigmoid(float g) {
  return 1.0f / (1.0f + expf(-g));
}

// xs[r] = x[src[r] / k] (zeros where src[r] < 0), r < end; `chunks` 16-byte
// chunks a row.
__global__ void __launch_bounds__(THREADS)
gather_kernel(const uint4* __restrict__ x, const long long* __restrict__ src,
              const int* __restrict__ offs, int held, int k, int chunks,
              uint4* __restrict__ xs) {
  const long end = offs[held - 1];
  const int lane = threadIdx.x % 32;
  for (long r = first_warp(); r < end; r += warp_stride()) {
    const long long s = src[r];
    uint4* out = xs + r * chunks;
    if (s < 0) {
      for (int c = lane; c < chunks; c += 32) out[c] = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint4* in = x + (s / k) * chunks;
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) out[c] = __ldg(in + c);
  }
}

// a[r] = silu(g) * u of h[r] = [g | u], r < end; `chunks` 16-byte chunks of
// a row of a (I / 8).
__global__ void __launch_bounds__(THREADS)
swiglu_kernel(const uint4* __restrict__ h, const int* __restrict__ offs,
              int held, int chunks, uint4* __restrict__ a) {
  const long end = offs[held - 1];
  const int lane = threadIdx.x % 32;
  for (long r = first_warp(); r < end; r += warp_stride()) {
    const uint4* g_row = h + r * 2 * chunks;
    const uint4* u_row = g_row + chunks;
    uint4* out = a + r * chunks;
#pragma unroll 2
    for (int c = lane; c < chunks; c += 32) {
      float g[8], u[8], y[8];
      unpack(__ldg(g_row + c), g);
      unpack(__ldg(u_row + c), u);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = g[j] * sigmoid(g[j]) * u[j];
      out[c] = pack(y);
    }
  }
}

// y[t] = sum over p < k with pos[t * k + p] < end of w[t * k + p] (1 when
// w is null) * rows[pos[t * k + p]], in f32 in pick order, rounded once;
// every token t < T is written. k <= 32.
template <bool WEIGHTED>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const uint4* __restrict__ rows, const float* __restrict__ w,
               const long long* __restrict__ pos,
               const int* __restrict__ offs, int held, long T, int k,
               int chunks, uint4* __restrict__ y) {
  const long end = offs[held - 1];
  const int lane = threadIdx.x % 32;
  for (long t = first_warp(); t < T; t += warp_stride()) {
    // lane p holds pick p's row (-1: not held here) and weight
    long long q = -1;
    float wv = 0.0f;
    if (lane < k) {
      q = pos[t * k + lane];
      if (q >= end) q = -1;
      wv = WEIGHTED ? w[t * k + lane] : 1.0f;
    }
    for (int c = lane; c < chunks; c += 32) {
      float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int p = 0; p < k; ++p) {
        const long long qp = __shfl_sync(0xffffffffu, q, p);
        const float wp = __shfl_sync(0xffffffffu, wv, p);
        if (qp < 0) continue;
        float v[8];
        unpack(__ldg(rows + qp * chunks + c), v);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(wp, v[j], acc[j]);
      }
      y[t * chunks + c] = pack(acc);
    }
  }
}

// gyr[r] = gy[src[r] / k] and go[r] = w[src[r]] * gyr[r] (zeros where
// src[r] < 0), r < end.
__global__ void __launch_bounds__(THREADS)
grad_gather_kernel(const uint4* __restrict__ gy, const float* __restrict__ w,
                   const long long* __restrict__ src,
                   const int* __restrict__ offs, int held, int k, int chunks,
                   uint4* __restrict__ gyr, uint4* __restrict__ go) {
  const long end = offs[held - 1];
  const int lane = threadIdx.x % 32;
  for (long r = first_warp(); r < end; r += warp_stride()) {
    const long long s = src[r];
    uint4* out_r = gyr + r * chunks;
    uint4* out_o = go + r * chunks;
    if (s < 0) {
      for (int c = lane; c < chunks; c += 32) {
        out_r[c] = make_uint4(0, 0, 0, 0);
        out_o[c] = make_uint4(0, 0, 0, 0);
      }
      continue;
    }
    const uint4* in = gy + (s / k) * chunks;
    const float wv = w[s];
#pragma unroll 2
    for (int c = lane; c < chunks; c += 32) {
      const uint4 v = __ldg(in + c);
      float f[8];
      unpack(v, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] *= wv;
      out_r[c] = v;
      out_o[c] = pack(f);
    }
  }
}

// From h[r] = [g | u], ga0[r] and the row's weight: a[r], dh[r] and, for
// a pick's row, gw[src[r]] = sum_i a * ga0 (f32), r < end; `chunks`
// 16-byte chunks of a row of a (I / 8).
__global__ void __launch_bounds__(THREADS)
swiglu_bwd_kernel(const uint4* __restrict__ h, const uint4* __restrict__ ga0,
                  const float* __restrict__ w,
                  const long long* __restrict__ src,
                  const int* __restrict__ offs, int held, int chunks,
                  uint4* __restrict__ a, uint4* __restrict__ dh,
                  float* __restrict__ gw) {
  const long end = offs[held - 1];
  const int lane = threadIdx.x % 32;
  for (long r = first_warp(); r < end; r += warp_stride()) {
    const long long s = src[r];
    const float wv = s >= 0 ? w[s] : 0.0f;
    const uint4* g_row = h + r * 2 * chunks;
    const uint4* u_row = g_row + chunks;
    const uint4* ga_row = ga0 + r * chunks;
    uint4* a_row = a + r * chunks;
    uint4* dg_row = dh + r * 2 * chunks;
    uint4* du_row = dg_row + chunks;
    float dot = 0.0f;
#pragma unroll 2
    for (int c = lane; c < chunks; c += 32) {
      float g[8], u[8], ga[8], av[8], dg[8], du[8];
      unpack(__ldg(g_row + c), g);
      unpack(__ldg(u_row + c), u);
      unpack(__ldg(ga_row + c), ga);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sg = sigmoid(g[j]);
        const float silu = g[j] * sg;
        av[j] = silu * u[j];
        const float gaw = wv * ga[j];
        dg[j] = gaw * u[j] * (sg * (1.0f + g[j] * (1.0f - sg)));
        du[j] = gaw * silu;
      }
      const uint4 ab = pack(av);
      unpack(ab, av);                   // the forward's rounded a
#pragma unroll
      for (int j = 0; j < 8; ++j) dot = fmaf(av[j], ga[j], dot);
      a_row[c] = ab;
      dg_row[c] = pack(dg);
      du_row[c] = pack(du);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0 && s >= 0) gw[s] = dot;
  }
}

}  // namespace

extern "C" int experts_gather_launch(const void* x, const void* src,
                                     const void* offs, void* xs, long R,
                                     int D, int held, int k, void* stream) {
  gather_kernel<<<grid_for(R), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (const long long*)src, (const int*)offs, held, k,
      D / 8, (uint4*)xs);
  return (int)cudaGetLastError();
}

extern "C" int experts_swiglu_launch(const void* h, const void* offs,
                                     void* a, long R, int I, int held,
                                     void* stream) {
  swiglu_kernel<<<grid_for(R), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)h, (const int*)offs, held, I / 8, (uint4*)a);
  return (int)cudaGetLastError();
}

// w null: the unweighted sum (the gradient combine).
extern "C" int experts_combine_launch(const void* rows, const float* w,
                                      const void* pos, const void* offs,
                                      void* y, long T, int D, int held,
                                      int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w)
    combine_kernel<true><<<grid_for(T), THREADS, 0, s>>>(
        (const uint4*)rows, w, (const long long*)pos, (const int*)offs,
        held, T, k, D / 8, (uint4*)y);
  else
    combine_kernel<false><<<grid_for(T), THREADS, 0, s>>>(
        (const uint4*)rows, nullptr, (const long long*)pos,
        (const int*)offs, held, T, k, D / 8, (uint4*)y);
  return (int)cudaGetLastError();
}

extern "C" int experts_grad_gather_launch(const void* gy, const float* w,
                                          const void* src, const void* offs,
                                          void* gyr, void* go, long R, int D,
                                          int held, int k, void* stream) {
  grad_gather_kernel<<<grid_for(R), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)gy, w, (const long long*)src, (const int*)offs, held, k,
      D / 8, (uint4*)gyr, (uint4*)go);
  return (int)cudaGetLastError();
}

extern "C" int experts_swiglu_bwd_launch(const void* h, const void* ga0,
                                         const float* w, const void* src,
                                         const void* offs, void* a, void* dh,
                                         float* gw, long R, int I, int held,
                                         void* stream) {
  swiglu_bwd_kernel<<<grid_for(R), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)h, (const uint4*)ga0, w, (const long long*)src,
      (const int*)offs, held, I / 8, (uint4*)a, (uint4*)dh, gw);
  return (int)cudaGetLastError();
}
