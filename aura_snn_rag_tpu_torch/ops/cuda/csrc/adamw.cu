// AdamW's update over the trainer's flat buffers, for Hopper (sm_90a):
// the clip's sum of squares and the update of `training/optim.py`
// `ClippedAdamW.step`, in two passes (the wrapper, `ops/cuda/adamw.py`,
// keeps the plain versions).
//
// They replace no TPU kernel: the JAX package's trainer runs optax's
// clip + adamw chain, which XLA fuses; PyTorch runs the same chain as
// ~30 elementwise passes over the four [N] f32 buffers, with temporaries
// of N floats each.
//
// Bound on the H100: bytes. The sum reads g once (4N bytes); the update
// reads p, g, mu and nu once and writes p, mu and nu once (28N bytes with
// an f32 mu, 24N with a bf16 one), at a few dozen operations an entry.
// At the Moonlight cell's N = 1.121B that is 4.48 + 31.4 GB, 10.7 ms at
// 3.35 TB/s.
//
// - sumsq: sum over i of g[i]^2 in f64 (each square exact in f64), with
//   a mask (one byte an entry, nonzero: sharded) into two sums, sharded
//   and replicated. 16-byte streaming loads, a grid-stride loop over a
//   grid fixed by N and the card, each block's sums into `partial`, then
//   one block adds the partials in a fixed order: no atomics, the same
//   bits on every run. The sums leave as f32.
// - update: one grid-stride pass, 16-byte streaming loads and stores (8
//   bytes for 4 entries of a bf16 mu), two vectors in flight a thread, a
//   scalar loop for the last N % 4 entries. Each block reads the step's
//   scalars from `scalars` (see SCALARS) once; when the loss was not
//   finite it writes nothing. Per entry the plain step's operations in
//   its order, each rounded as PyTorch rounds it (no contraction into
//   FMAs; true divisions and square root): g / norm * clip unless norm <
//   clip; mu' = c1 * g + b1 * mu (for a bf16 mu, b1 * mu rounded to bf16
//   first, mu' stored rounded to bf16); nu' = c2 * (g * g) + b2 * nu;
//   u = (mu' / d1) / (sqrt(nu' / d2) + eps); u = u + wd * p;
//   u = (-lr * u) * scale; p = p + u. The constants arrive rounded to f32
//   (b1 to mu's dtype) as PyTorch rounds a Python number.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 4;

// scalars[]: the step's values on the device
enum { S_NORM, S_D1, S_D2, S_NEG_LR, S_SCALE, S_FINITE, SCALARS };

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) {
    cudaGetLastError();
    return fallback;
  }
  return v;
}

// Blocks for `items` items of one thread each, at most BLOCKS_PER_SM an
// SM and `cap` in all.
int grid_for(long items, long cap) {
  static const int n_sm = device_attr(cudaDevAttrMultiProcessorCount, 132);
  long blocks = (items + THREADS - 1) / THREADS;
  long most = (long)n_sm * BLOCKS_PER_SM;
  if (most > cap) most = cap;
  return (int)(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

// The block's sum of `v` in a fixed order, in thread 0.
__device__ __forceinline__ double block_sum(double v, double* shared) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) shared[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += shared[w];
  __syncthreads();
  return s;
}

template <bool MASKED>
__device__ __forceinline__ void add_squares(const float4& v, uint32_t m,
                                            double& sh, double& rep) {
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const double sq = (double)f[j] * (double)f[j];
    if (MASKED && ((m >> (8 * j)) & 0xffu) == 0) rep += sq;
    else sh += sq;
  }
}

// partial[2 b], partial[2 b + 1]: block b's sums (sharded or all,
// replicated) over its share of the n entries.
template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
sumsq_kernel(const float* __restrict__ g, const uint8_t* __restrict__ mask,
             long n, double* __restrict__ partial) {
  __shared__ double shared[WARPS];
  const long n4 = n / 4;
  const long stride = (long)gridDim.x * THREADS;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const uint32_t* m4 = reinterpret_cast<const uint32_t*>(mask);
  double sh = 0.0, rep = 0.0;
  long i = (long)blockIdx.x * THREADS + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    float4 v[4];
    uint32_t m[4] = {0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = __ldcs(g4 + i + u * stride);
      if (MASKED) m[u] = __ldcs(m4 + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) add_squares<MASKED>(v[u], m[u], sh, rep);
  }
  for (; i < n4; i += stride)
    add_squares<MASKED>(__ldcs(g4 + i), MASKED ? __ldcs(m4 + i) : 0u, sh,
                        rep);
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long t = 4 * n4 + threadIdx.x;
    const double sq = (double)g[t] * (double)g[t];
    if (MASKED && mask[t] == 0) rep += sq;
    else sh += sq;
  }
  sh = block_sum(sh, shared);
  rep = block_sum(rep, shared);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = sh;
    partial[2 * blockIdx.x + 1] = rep;
  }
}

// out[0] (and out[1] when `outs` is 2): the blocks' partials summed in a
// fixed order, rounded to f32.
__global__ void __launch_bounds__(THREADS)
sumsq_final_kernel(const double* __restrict__ partial, int blocks, int outs,
                   float* __restrict__ out) {
  __shared__ double shared[WARPS];
  for (int k = 0; k < outs; ++k) {
    double s = 0.0;
    for (int b = threadIdx.x; b < blocks; b += THREADS)
      s += partial[2 * b + k];
    s = block_sum(s, shared);
    if (threadIdx.x == 0) out[k] = (float)s;
  }
}

struct Consts {
  float clip, wd, c1, b1, c2, b2, eps;
};

// The step's values a block reads from `scalars` once.
struct Step {
  float norm, d1, d2, neg_lr, scale;
};

// One entry of the update (see the note at the top); `m` and `v` become
// the new moments, m in f32 (the caller rounds a bf16 one on store).
template <bool MU_BF16>
__device__ __forceinline__ void update_one(float& p, float g, float& m,
                                           float& v, const Step& s,
                                           const Consts& k, bool clipped) {
  if (clipped) g = __fmul_rn(__fdiv_rn(g, s.norm), k.clip);
  float b = __fmul_rn(k.b1, m);
  if (MU_BF16) b = __bfloat162float(__float2bfloat16_rn(b));
  m = __fadd_rn(__fmul_rn(k.c1, g), b);
  v = __fadd_rn(__fmul_rn(k.c2, __fmul_rn(g, g)), __fmul_rn(k.b2, v));
  const float mh = __fdiv_rn(m, s.d1);
  const float vh = __fdiv_rn(v, s.d2);
  float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), k.eps));
  u = __fadd_rn(u, __fmul_rn(k.wd, p));
  u = __fmul_rn(s.neg_lr, u);
  u = __fmul_rn(u, s.scale);
  p = __fadd_rn(p, u);
}

// 4 entries of mu: 16 bytes of f32 or 8 of bf16, streamed.
template <bool MU_BF16> struct Mu4;

template <> struct Mu4<false> {
  static __device__ __forceinline__ void load(const void* mu, long i,
                                              float f[4]) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(mu) + i);
    f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
  }
  static __device__ __forceinline__ void store(void* mu, long i,
                                               const float f[4]) {
    __stcs(reinterpret_cast<float4*>(mu) + i,
           make_float4(f[0], f[1], f[2], f[3]));
  }
  static __device__ __forceinline__ float load1(const void* mu, long t) {
    return reinterpret_cast<const float*>(mu)[t];
  }
  static __device__ __forceinline__ void store1(void* mu, long t, float f) {
    reinterpret_cast<float*>(mu)[t] = f;
  }
};

template <> struct Mu4<true> {
  static __device__ __forceinline__ void load(const void* mu, long i,
                                              float f[4]) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(mu) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  static __device__ __forceinline__ void store(void* mu, long i,
                                               const float f[4]) {
    uint2 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(f[0], f[1]);
    h[1] = __floats2bfloat162_rn(f[2], f[3]);
    __stcs(reinterpret_cast<uint2*>(mu) + i, q);
  }
  static __device__ __forceinline__ float load1(const void* mu, long t) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(mu)[t]);
  }
  static __device__ __forceinline__ void store1(void* mu, long t, float f) {
    reinterpret_cast<__nv_bfloat16*>(mu)[t] = __float2bfloat16_rn(f);
  }
};

template <bool MU_BF16>
__device__ __forceinline__ void update_vec(float* __restrict__ p,
                                           const float* __restrict__ g,
                                           void* __restrict__ mu,
                                           float* __restrict__ nu, long i,
                                           const Step& s, const Consts& k,
                                           bool clipped, float4& pv,
                                           const float4& gv, float m[4],
                                           float4& vv) {
  float pf[4] = {pv.x, pv.y, pv.z, pv.w};
  const float gf[4] = {gv.x, gv.y, gv.z, gv.w};
  float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    update_one<MU_BF16>(pf[j], gf[j], m[j], vf[j], s, k, clipped);
  __stcs(reinterpret_cast<float4*>(p) + i,
         make_float4(pf[0], pf[1], pf[2], pf[3]));
  Mu4<MU_BF16>::store(mu, i, m);
  __stcs(reinterpret_cast<float4*>(nu) + i,
         make_float4(vf[0], vf[1], vf[2], vf[3]));
}

template <bool MU_BF16>
__global__ void __launch_bounds__(THREADS)
update_kernel(float* __restrict__ p, const float* __restrict__ g,
              void* __restrict__ mu, float* __restrict__ nu,
              const float* __restrict__ scalars, long n, Consts k) {
  __shared__ float sh[SCALARS];
  if (threadIdx.x < SCALARS) sh[threadIdx.x] = scalars[threadIdx.x];
  __syncthreads();
  if (sh[S_FINITE] == 0.0f) return;         // a non-finite loss: no write
  const Step s{sh[S_NORM], sh[S_D1], sh[S_D2], sh[S_NEG_LR], sh[S_SCALE]};
  const bool clipped = !(s.norm < k.clip);
  const long n4 = n / 4;
  const long stride = (long)gridDim.x * THREADS;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* v4 = reinterpret_cast<const float4*>(nu);
  long i = (long)blockIdx.x * THREADS + threadIdx.x;
  for (; i + stride < n4; i += 2 * stride) {
    float4 pv[2], gv[2], vv[2];
    float m[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long j = i + u * stride;
      pv[u] = __ldcs(p4 + j);
      gv[u] = __ldcs(g4 + j);
      Mu4<MU_BF16>::load(mu, j, m[u]);
      vv[u] = __ldcs(v4 + j);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      update_vec<MU_BF16>(p, g, mu, nu, i + u * stride, s, k, clipped, pv[u],
                          gv[u], m[u], vv[u]);
  }
  if (i < n4) {
    float4 pv = __ldcs(p4 + i), gv = __ldcs(g4 + i), vv = __ldcs(v4 + i);
    float m[4];
    Mu4<MU_BF16>::load(mu, i, m);
    update_vec<MU_BF16>(p, g, mu, nu, i, s, k, clipped, pv, gv, m, vv);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long t = 4 * n4 + threadIdx.x;
    float pt = p[t], m = Mu4<MU_BF16>::load1(mu, t), v = nu[t];
    update_one<MU_BF16>(pt, g[t], m, v, s, k, clipped);
    p[t] = pt;
    Mu4<MU_BF16>::store1(mu, t, m);
    nu[t] = v;
  }
}

}  // namespace

// mask null: one sum into out[0]; else out[0] the sharded entries' (mask
// nonzero), out[1] the others'. `partial` holds 2 * max_blocks doubles.
extern "C" int adamw_sumsq_launch(const float* g, const void* mask,
                                  void* partial, float* out, long n,
                                  int max_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = grid_for((n / 4 + 3) / 4, max_blocks);
  if (mask)
    sumsq_kernel<true><<<blocks, THREADS, 0, st>>>(
        g, (const uint8_t*)mask, n, (double*)partial);
  else
    sumsq_kernel<false><<<blocks, THREADS, 0, st>>>(
        g, nullptr, n, (double*)partial);
  sumsq_final_kernel<<<1, THREADS, 0, st>>>((const double*)partial, blocks,
                                            mask ? 2 : 1, out);
  return (int)cudaGetLastError();
}

// scalars: [norm, 1 - b1^count, 1 - b2^count, -lr, lr_scale, finite (0 or
// 1)] f32 on the device; mu f32, or bf16 when mu_bf16.
extern "C" int adamw_update_launch(float* p, const float* g, void* mu,
                                   float* nu, const float* scalars, long n,
                                   int mu_bf16, float clip, float wd,
                                   float c1, float b1, float c2, float b2,
                                   float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Consts k{clip, wd, c1, b1, c2, b2, eps};
  const int blocks = grid_for((n / 4 + 1) / 2, 1L << 30);
  if (mu_bf16)
    update_kernel<true><<<blocks, THREADS, 0, st>>>(p, g, mu, nu, scalars,
                                                    n, k);
  else
    update_kernel<false><<<blocks, THREADS, 0, st>>>(p, g, mu, nu, scalars,
                                                     n, k);
  return (int)cudaGetLastError();
}
