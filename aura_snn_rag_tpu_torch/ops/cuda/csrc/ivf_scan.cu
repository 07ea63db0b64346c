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
// Bound on the H100: at a small batch all four read the P probed bf16
// blocks once per query (P*C*D*2 bytes, 50 MB at P=64, C=512, D=768) at
// 3.35 TB/s; the arithmetic is a matrix-vector product, so bytes bound
// them. At a large batch the queries share clusters (bench.py's B = 1024
// probes nearly all K = 4096 clusters, 16 pairs each), and the bound is
// each probed block read once: 3.22 GB where per-pair reads move 51.5 GB.
// Even then the product is 16 operations per byte, far below the ~295 at
// which the tensor cores would bound it. The TPU kernels ran one program
// per query with [P, C] scratch in VMEM, which neither fits a CTA's 227 KB
// of shared memory at full width nor fills 132 SMs at B = 1.
// Below the crossover (`cluster_major`) all four score a row the same way
// (`row_dot`: one warp per clustered row, 16-byte loads, f32 accumulation
// in one fixed order), so C's cosines and B, D and E's coarse scores agree
// bit for bit there; above it B and D sum on the tensor cores, in another
// fixed order. Keys are 64 bits: the score's bits, then the inverted
// index, which encodes the lowest-index tie rule.
// C is the coarse pass alone. B and D, whose top-kk spans all P*C entries
// of a query, run in two passes:
//   1. coarse pass, which writes the coarse score of pair (b, p) and row c
//      to a [B, P*C] scratch in device memory at (b, p*C + c), one of two
//      ways, chosen on the host from (B, P, K):
//      - per pair, below the crossover: a (row chunk, probe, query) grid
//        of `row_dot` (the scratch is L2-resident at small B);
//      - cluster-major, at and above it: the B*P pairs are bucketed by
//        cluster on the device (a histogram with atomics, one scan, a
//        scatter; no host sync, so the call stays capturable in a CUDA
//        graph), then each (cluster, tile of up to 64 of its pairs, 128
//        rows) reads its rows from device memory once and scores them
//        against the tile's queries with bf16 `mma.sync` (f32
//        accumulation), both operands streamed through a 4-stage
//        `cp.async` ring of 64-deep tiles (zero-filled past C and D);
//        a hot cluster gets one tile per 64 pairs, an unprobed one none;
//   2. select pass: a radix select that finds the top-kk keys, which are
//      then put in order.
//      B and D run it on a thread-block cluster of G CTAs per query
//      (`cluster_select`): each CTA copies its contiguous share of the
//      query's P*C scores into shared memory once, builds 256-bin
//      histograms (8 per CTA, so the few hot bins of the top key byte
//      contend less), pushes its sum into every CTA of the cluster
//      through distributed shared memory (DSMEM), and every CTA finds the
//      same digit from the G histograms with a warp suffix scan. The
//      selected keys go into rank 0's shared memory through DSMEM (one
//      remote atomic per warp).
//      Up to 512 of them are put in order by counting, each key's lane
//      its rank (one step, where a bitonic sort of 128 keys takes 28
//      barriers); more are sorted by rank 0 (bitonic). D writes the lanes
//      out; B reranks its kk candidates split over the G CTAs (one warp
//      per candidate, every row load issued before the FMAs), sends the
//      exact scores back to rank 0 through DSMEM, and rank 0 takes the
//      final top-k by the same count over (exact score, funnel lane).
//      G = 8 (CLUSTER), and the select launches with programmatic
//      stream serialisation (its prologue overlaps the coarse pass's
//      tail): on the H100 that measured faster than G = 16 and than the
//      launch without it (PERF.md).
//      A share too large for shared memory is read from the L2-resident
//      scratch on every radix pass instead (the same kernel, instantiated
//      with SMEM = false), so C and P put no shared-memory limit on B and
//      D; the keys' 32-bit index does (P*C < 2^31). Rank 0's sorted keys
//      bound kk: B <= 4096, D <= 16384 (128 KB).
// E needs only each probe's top-k (k <= 128), so it runs in one launch
// with no scratch (`ivf_topk_kernel`): a cluster of G CTAs per (probe,
// query). CTA r scores its contiguous share of the probe's C rows,
// [r*ceil(C/G), (r+1)*ceil(C/G)) (64 rows at C = 512: the coarse pass's
// CTA, so the same byte stream), into keys in its shared memory,
// TOPK_PIECE rows at a time. It ranks them by counting (each key's rank
// is the number of keys above it), together with the top-k kept from
// earlier pieces, so a share of any size keeps only its top-k. Each CTA
// stores its top min(k, share) keys into rank 0 through DSMEM; rank 0
// ranks those G*k keys by counting and writes each key's score and slot
// to the lane of its rank.
// A cluster launch that the card refuses (cudaErrorClusterOutOfResources)
// returns its error; nothing falls back to another launch.

#include <algorithm>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COARSE_ROWS = 64;        // clustered rows per coarse CTA
constexpr int COARSE_THREADS = 256;
constexpr int SEL_THREADS = 512;       // per CTA of a query's cluster (B, D)
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int WHIST = 8;               // sub-histograms per CTA (B, D)
constexpr int SEL_UNROLL = 4;          // scores per thread per batch (B, D)
constexpr int CLUSTER = 8;            // CTAs per query's select (B, D) and
                                       // per (probe, query) (E)
constexpr int SMEM_PROBES = 1024;      // probe ids kept in shared memory
constexpr int ROW_UNROLL = 8;          // float4 loads in flight per lane (B)
constexpr int ROW_LOADS = 4;           // bf16 16-byte loads in flight per lane
constexpr int KPAD = 128;              // lanes of E's per-probe output
constexpr int TOPK_PIECE = 128;        // rows E's CTA scores per selection
constexpr float NEG_INF_F = -1e30f;
constexpr float DEAD = -5e29f;         // scores at or below are dead lanes
// E ranks its kept keys and a piece's keys with one thread (group) each
static_assert(KPAD + TOPK_PIECE <= COARSE_THREADS, "E's candidates");

// The cluster-major coarse pass of B and D (`ivf_coarse_cm_kernel`)
constexpr int CM_ROWS = 128;           // clustered rows per CTA, 16 per warp
constexpr int CM_N = 64;               // pairs (queries) per tile
constexpr int CM_KC = 64;              // depth of a ring stage, bf16 values
constexpr int CM_STAGES = 4;
constexpr int CM_THREADS = 256;
constexpr int CM_X_BYTES = CM_ROWS * CM_KC * 2;
constexpr int CM_STAGE_BYTES = CM_X_BYTES + CM_N * CM_KC * 2;
constexpr int CM_SMEM = CM_STAGES * CM_STAGE_BYTES;     // 96 KB: 2 CTAs/SM
constexpr int BUCKET_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
static_assert(CM_ROWS == 16 * (CM_THREADS / 32), "one m16 tile per warp");
static_assert(CM_ROWS * 8 % CM_THREADS == 0 && CM_N * 8 % CM_THREADS == 0,
              "whole 16-byte copies per thread");
// Pairs per cluster, B*P / K, at and above which B and D take the
// cluster-major pass. Set from both passes' graph times on the H100
// (tools/ivf_coarse_crossover.py; PERF.md): at the engine's shape (K =
// 4096, C = 512, D = 768, P = 64) kernel B took 0.160 / 0.153 ms
// (cluster-major / per pair) at B = 8 (1/8 pair per cluster), 0.271 /
// 0.284 at 16 (1/4), 0.464 / 0.552 at 32 (1/2), 0.740 / 1.083 at 64, 1.75
// / 17.02 at 1024; at the LM's (K = 256, C = 896, P = 8, B = 8: 1/4)
// 0.056 / 0.051. So 1/2: the engine's B = 32 and up.
constexpr double CLUSTER_MAJOR_PAIRS = 0.5;

bool cluster_major(int B, int P, int K) {
  return (double)B * P >= CLUSTER_MAJOR_PAIRS * K;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The query's dot product with one clustered bf16 row of D values, the
// query sq in shared memory (rounded to bf16): one warp per row, 16-byte
// loads (ROW_LOADS of them issued before their FMAs: all of a row's at
// D = 768), f32 FMAs in the per-lane order ch = lane + 32 t, then
// warp_sum; every lane gets the sum. C, E and the per-pair coarse pass of
// B and D score a row through it, so their scores of one entry are the
// same bits (B and D's cluster-major pass, above the crossover, sums in
// another order). The second loop guards with `if`: with `break` instead,
// E ran far slower on the H100 (PERF.md).
__device__ __forceinline__ float row_dot(const __nv_bfloat16* __restrict__ row,
                                         const float* sq, int D, int lane) {
  const uint4* v4 = reinterpret_cast<const uint4*>(row);
  const int nch = D / 8;
  float acc = 0.f;
  for (int ch0 = lane; ch0 < nch; ch0 += 32 * ROW_LOADS) {
    uint4 v[ROW_LOADS];
#pragma unroll
    for (int u = 0; u < ROW_LOADS; ++u)
      if (ch0 + 32 * u < nch) v[u] = __ldg(v4 + ch0 + 32 * u);
#pragma unroll
    for (int u = 0; u < ROW_LOADS; ++u) {
      const int ch = ch0 + 32 * u;
      if (ch < nch) {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&v[u]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(h[t]);
          acc = fmaf(f.x, sq[ch * 8 + 2 * t], acc);
          acc = fmaf(f.y, sq[ch * 8 + 2 * t + 1], acc);
        }
      }
    }
  }
  return warp_sum(acc);
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
    const float acc = row_dot(blk + (long)c * D, sq, D, lane);
    if (lane == 0) {
      float v = acc;
      if (WITH_AUX) {
        const float* a = aux + cid * 8 * C;
        v = __fadd_rn(__fmul_rn(a[c], acc), a[C + c]);
      }
      out[((long)b * P + p) * C + c] = v;
    }
  }
  // a select pass launched with programmatic stream serialisation may
  // start once every CTA got here; it waits for the whole grid before it
  // reads the scores
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ---- the cluster-major coarse pass ---------------------------------------

// The workspace of the cluster-major pass, in 4-byte words after the
// [B, P*C] scores, 16-byte aligned: the queries rounded to bf16 [B, D],
// the pairs per cluster [K], the bucket cursors [K], the pair ids bucketed
// by cluster [B*P], the tiles [max_tiles] as (cluster, first pair in
// `list`, pairs), and the number of tiles.
struct Workspace {
  __nv_bfloat16* q16;
  int *count, *cursor, *list, *tiles, *n_tiles;
  long max_tiles;
};

// Tiles of up to CM_N pairs: at most one partial tile per probed cluster.
long max_cm_tiles(int B, int P, int K) {
  const long pairs = (long)B * P;
  return pairs / CM_N + (pairs < K ? pairs : (long)K);
}

long workspace_words(int B, int P, int K, int D) {
  if (!cluster_major(B, P, K)) return 0;
  // + 4: room to align the start to 16 bytes
  return 4 + (long)B * D / 2 + 2L * K + (long)B * P +
         3 * max_cm_tiles(B, P, K) + 1;
}

Workspace workspace(float* scores, int C, int B, int P, int K, int D) {
  uintptr_t at = reinterpret_cast<uintptr_t>(scores + (long)B * P * C);
  at = (at + 15) & ~uintptr_t(15);
  Workspace w;
  w.q16 = reinterpret_cast<__nv_bfloat16*>(at);
  w.count = reinterpret_cast<int*>(w.q16 + (long)B * D);
  w.cursor = w.count + K;
  w.list = w.cursor + K;
  w.tiles = w.list + (long)B * P;
  w.max_tiles = max_cm_tiles(B, P, K);
  w.n_tiles = w.tiles + 3 * w.max_tiles;
  return w;
}

// Two floats rounded to bf16 (to nearest even), a first, as 32 bits.
__device__ __forceinline__ unsigned bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Bucketing, pass 1: pairs per cluster (count zeroed before), and the
// queries rounded to bf16 once, as the per-pair pass rounds them. A
// cluster id outside [0, K) is bucketed nowhere (its scores are not
// written), so that no atomic lands outside the workspace.
__global__ void __launch_bounds__(BUCKET_THREADS)
ivf_bucket_count_kernel(const int* __restrict__ top_c,
                        const float* __restrict__ qn, int* __restrict__ count,
                        __nv_bfloat16* __restrict__ q16, long n_pairs,
                        long n_q8, int K) {
  const long stride = (long)gridDim.x * BUCKET_THREADS;
  const long i0 = (long)blockIdx.x * BUCKET_THREADS + threadIdx.x;
  for (long i = i0; i < n_pairs; i += stride) {
    const int c = top_c[i];
    if ((unsigned)c < (unsigned)K) atomicAdd(&count[c], 1);
  }
  const float4* q4 = reinterpret_cast<const float4*>(qn);
  for (long i = i0; i < n_q8; i += stride) {
    const float4 u = q4[2 * i], v = q4[2 * i + 1];
    reinterpret_cast<uint4*>(q16)[i] =
        make_uint4(bf16x2(u.x, u.y), bf16x2(u.z, u.w), bf16x2(v.x, v.y),
                   bf16x2(v.z, v.w));
  }
}

// Bucketing, pass 2, one CTA: the exclusive scan of the K counts (each
// bucket's cursor starts at its first place in `list`) and of their tiles,
// and the tiles of every probed cluster.
__global__ void __launch_bounds__(SCAN_THREADS)
ivf_bucket_scan_kernel(const int* __restrict__ count, int* __restrict__ cursor,
                       int* __restrict__ tiles, int* __restrict__ n_tiles,
                       int K) {
  __shared__ int wsum[2][SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (K + SCAN_THREADS - 1) / SCAN_THREADS;
  const int k0 = min(K, tid * per), k1 = min(K, k0 + per);
  int pairs = 0, ntile = 0;
  for (int k = k0; k < k1; ++k) {
    pairs += count[k];
    ntile += (count[k] + CM_N - 1) / CM_N;
  }
  int ip = pairs, it = ntile;                     // inclusive, in the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int vp = __shfl_up_sync(0xffffffffu, ip, o);
    const int vt = __shfl_up_sync(0xffffffffu, it, o);
    if (lane >= o) { ip += vp; it += vt; }
  }
  if (lane == 31) { wsum[0][warp] = ip; wsum[1][warp] = it; }
  __syncthreads();
  if (warp == 0) {
    int vp = wsum[0][lane], vt = wsum[1][lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, vp, o);
      const int ut = __shfl_up_sync(0xffffffffu, vt, o);
      if (lane >= o) { vp += up; vt += ut; }
    }
    wsum[0][lane] = vp;
    wsum[1][lane] = vt;
  }
  __syncthreads();
  int op = ip - pairs + (warp ? wsum[0][warp - 1] : 0);
  int ot = it - ntile + (warp ? wsum[1][warp - 1] : 0);
  for (int k = k0; k < k1; ++k) {
    const int n = count[k];
    cursor[k] = op;
    for (int t = 0; t * CM_N < n; ++t, ++ot) {
      tiles[3 * ot] = k;
      tiles[3 * ot + 1] = op + t * CM_N;
      tiles[3 * ot + 2] = min(CM_N, n - t * CM_N);
    }
    op += n;
  }
  if (tid == SCAN_THREADS - 1) *n_tiles = ot;
}

// Bucketing, pass 3: each pair id b*P + p into its cluster's bucket. The
// order within a bucket follows the atomics; a pair's scores do not
// depend on its place in a tile (below).
__global__ void __launch_bounds__(BUCKET_THREADS)
ivf_bucket_scatter_kernel(const int* __restrict__ top_c,
                          int* __restrict__ cursor, int* __restrict__ list,
                          long n_pairs, int K) {
  const long stride = (long)gridDim.x * BUCKET_THREADS;
  for (long i = (long)blockIdx.x * BUCKET_THREADS + threadIdx.x; i < n_pairs;
       i += stride) {
    const int c = top_c[i];
    if ((unsigned)c < (unsigned)K) list[atomicAdd(&cursor[c], 1)] = (int)i;
  }
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read)
// unless `ok`.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A [rows][CM_KC] bf16 tile in shared memory, one 128-byte line per row,
// its 16-byte chunk ch stored at ch ^ (row % 8): the eight rows an
// ldmatrix reads at one chunk fall on eight different bank groups.
__device__ __forceinline__ unsigned swz(int row, int ch) {
  return row * 128 + ((ch ^ (row & 7)) << 4);
}

// The cluster-major coarse pass: CTA (tile, row tile) scores CM_ROWS rows
// of the tile's cluster against the tile's n <= CM_N queries,
// [CM_ROWS, D] . [D, n] on the tensor cores, and writes aux0 * cos + aux1
// of pair (b, p) and row c to out[(b*P + p)*C + c]. Warp w owns rows
// 16w..16w+15 and every pair; n8 tiles past n are skipped. A score is the
// f32 sum over the CM_KC-deep stages in order of the same mma sequence
// whatever its column, so it does not depend on where the bucketing put
// its pair. Grid: max_tiles * row_tiles; CTAs past the batch's tiles exit.
__global__ void __launch_bounds__(CM_THREADS, 2)
ivf_coarse_cm_kernel(const __nv_bfloat16* __restrict__ clustered,
                     const float* __restrict__ aux,
                     const __nv_bfloat16* __restrict__ q16,
                     const int* __restrict__ list,
                     const int* __restrict__ tiles,
                     const int* __restrict__ n_tiles, float* __restrict__ out,
                     int C, int D, int P, int row_tiles) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ int pair_s[CM_N];         // the tile's pair ids b*P + p
  __shared__ int query_s[CM_N];        // and their queries b
  const int tile = blockIdx.x / row_tiles;
  // an exited CTA counts as launching the dependent select pass
  if (tile >= *n_tiles) return;
  const int rt = blockIdx.x - tile * row_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = tiles[3 * tile], n = tiles[3 * tile + 2];
  const int r0 = rt * CM_ROWS, rows = min(CM_ROWS, C - r0);
  if (tid < CM_N) {
    const int pair = tid < n ? list[tiles[3 * tile + 1] + tid] : 0;
    pair_s[tid] = pair;
    query_s[tid] = pair / P;
  }
  __syncthreads();
  const __nv_bfloat16* blk = clustered + ((long)k * C + r0) * D;
  const int nk = (D + CM_KC - 1) / CM_KC, dch = D / 8;
  const unsigned ring0 = (unsigned)__cvta_generic_to_shared(ring);

  // stage s <- depth chunk kc of the rows and of the tile's queries
  auto load = [&](int s, int kc) {
    const unsigned xs = ring0 + s * CM_STAGE_BYTES, qs = xs + CM_X_BYTES;
    const int ch0 = kc * (CM_KC / 8);
#pragma unroll
    for (int j = 0; j < CM_ROWS * 8 / CM_THREADS; ++j) {
      const int i = tid + j * CM_THREADS, row = i >> 3, ch = i & 7;
      const bool ok = row < rows && ch0 + ch < dch;
      cp_async16(xs + swz(row, ch),
                 ok ? blk + (long)row * D + (ch0 + ch) * 8 : clustered, ok);
    }
#pragma unroll
    for (int j = 0; j < CM_N * 8 / CM_THREADS; ++j) {
      const int i = tid + j * CM_THREADS, row = i >> 3, ch = i & 7;
      const bool ok = row < n && ch0 + ch < dch;
      cp_async16(qs + swz(row, ch),
                 ok ? q16 + (long)query_s[row] * D + (ch0 + ch) * 8 : q16,
                 ok);
    }
  };

  float acc[CM_N / 8][4];
#pragma unroll
  for (int j = 0; j < CM_N / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int s = 0; s < CM_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const int a_row = warp * 16 + (lane & 15);
  for (int kc = 0; kc < nk; ++kc) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(CM_STAGES - 2) : "memory");
    __syncthreads();          // stage kc landed; stage kc - 1 was consumed
    if (kc + CM_STAGES - 1 < nk)
      load((kc + CM_STAGES - 1) % CM_STAGES, kc + CM_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const unsigned xs = ring0 + (kc % CM_STAGES) * CM_STAGE_BYTES;
    const unsigned qs = xs + CM_X_BYTES;
#pragma unroll
    for (int ks = 0; ks < CM_KC / 16; ++ks) {
      unsigned a[4];
      ldsm_x4(a, xs + swz(a_row, 2 * ks + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < CM_N / 16; ++jp) {
        if (16 * jp < n) {                          // the same in the warp
          const int brow = 16 * jp + ((lane >> 4) << 3) + (lane & 7);
          unsigned b[4];
          ldsm_x4(b, qs + swz(brow, 2 * ks + ((lane >> 3) & 1)));
          mma_bf16(acc[2 * jp], a, b[0], b[1]);
          if (16 * jp + 8 < n) mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // acc[j][2h + e]: row 16w + g + 8h, pair 8j + 2t + e (g = lane / 4,
  // t = lane % 4); one rounding per operation, as in the per-pair pass
  const int g = lane >> 2, t = lane & 3;
  const float* a0p = aux + (long)k * 8 * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    if (r < rows) {
      const int c = r0 + r;
      const float a0 = a0p[c], a1 = a0p[C + c];
#pragma unroll
      for (int j = 0; j < CM_N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          if (col < n)
            out[(long)pair_s[col] * C + c] =
                __fadd_rn(__fmul_rn(a0, acc[j][2 * h + e]), a1);
        }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
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

// The score a key was made from (-0 comes back as +0).
__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned k = (unsigned)(key >> 32);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Sorts a[0, n) descending in place; n a power of two. Every thread of
// the CTA calls it; it ends on a barrier.
__device__ __forceinline__ void bitonic_desc(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool desc = (i & size) == 0;
          const unsigned long long x = a[i], y = a[j];
          if (desc ? (x < y) : (x > y)) { a[i] = y; a[j] = x; }
        }
      }
      __syncthreads();
    }
  }
}

// How many of n entries come before entry j = threadIdx.x / T in a strict
// order where before(i) says entry i does. The T consecutive threads of
// entry j (T a power of two <= 32) split the count; every thread of the
// warp calls it. With n <= blockDim.x / T entries this ranks them all in
// one step, where a bitonic sort takes log2(n) (log2(n) + 1) / 2 barriers.
template <typename Before>
__device__ __forceinline__ int rank_desc(int n, int T, Before before) {
  int r = 0;
#pragma unroll 8
  for (int i = (int)threadIdx.x % T; i < n; i += T) r += before(i) ? 1 : 0;
  for (int o = 1; o < T; o <<= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

struct ClusterShared {
  unsigned whist[WHIST][256];          // histograms of one pass, a pair of
                                       // warps to each, zero between passes
  // every CTA's histogram of a pass, pushed here by its owner (two
  // buffers: passes alternate)
  unsigned hist[2][CLUSTER][256];
  unsigned wsum[8];                    // suffix-scan totals of warps 0-7
  int probe[SMEM_PROBES];              // the query's cluster ids, P small
  unsigned long long prefix, mask;
  int need, done, count;               // count: rank 0's collect cursor
};

// Leaves the kk largest keys sort_key(sc[i], i), i < N, in rank 0's
// ckey[0, kk) in no set order, and zeros in ckey[kk, kkp). Every thread of
// every CTA of the query's cluster calls it; it ends on a cluster
// barrier. CTA r owns scores [r*chunk, (r+1)*chunk), chunk = ceil(N/G),
// copied into sc_s when SMEM, else read from the scratch on every pass.
// Returns the query's P cluster ids: st.probe when P <= SMEM_PROBES
// (loaded before the wait on the coarse pass), else top_c in device memory.
template <bool SMEM>
__device__ __forceinline__ const int* cluster_select(
    const float* __restrict__ sc, float* sc_s, int N, int kk, int kkp,
    const int* __restrict__ top_c, int P, unsigned long long* ckey,
    ClusterShared& st, cg::cluster_group& cluster) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned rank = cluster.block_rank();
  const int chunk = (N + CLUSTER - 1) / CLUSTER;
  const int lo = min(N, (int)rank * chunk);
  const int n = min(N, lo + chunk) - lo;
  // every CTA of the cluster must have started before distributed shared
  // memory is touched: arrive now, wait just before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (tid == 0) {
    st.prefix = 0ull; st.mask = 0ull; st.need = kk; st.done = 0;
    st.count = 0;
  }
  if (rank == 0)
    for (int i = tid; i < kkp; i += SEL_THREADS) ckey[i] = 0ull;
  const bool probes_in_smem = P <= SMEM_PROBES;
  if (probes_in_smem)
    for (int i = tid; i < P; i += SEL_THREADS) st.probe[i] = top_c[i];
  // the coarse pass must have finished before its scores are read
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (SMEM)
    for (int i = tid; i < n; i += SEL_THREADS) sc_s[i] = sc[lo + i];
  const float* src = SMEM ? sc_s : sc + lo;
  for (int i = tid; i < WHIST * 256; i += SEL_THREADS)
    (&st.whist[0][0])[i] = 0u;
  __syncthreads();

  // ---- radix select of the kk-th largest key, 8 bits per pass ----------
  unsigned* wh = st.whist[warp % WHIST];
  int buf = 0;
  for (int shift = 56; shift >= 0; shift -= 8, buf ^= 1) {
    const unsigned long long prefix = st.prefix, mask = st.mask;
    const unsigned need = (unsigned)st.need;
    // all loads of a batch before its atomics, which the compiler must
    // otherwise order after each other (both are shared memory)
    for (int i0 = tid; i0 < n; i0 += SEL_UNROLL * SEL_THREADS) {
      float v[SEL_UNROLL];
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u) {
        const int i = i0 + u * SEL_THREADS;
        v[u] = i < n ? src[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u) {
        const int i = i0 + u * SEL_THREADS;
        const unsigned long long key = sort_key(v[u], (unsigned)(lo + i));
        if (i < n && (key & mask) == prefix)
          atomicAdd(&wh[(unsigned)(key >> shift) & 255u], 1u);
      }
    }
    __syncthreads();
    if (shift == 56)                    // every CTA arrived at the top
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (tid < 256) {
      unsigned s = 0u;
#pragma unroll
      for (int w = 0; w < WHIST; ++w) {
        s += st.whist[w][tid];
        st.whist[w][tid] = 0u;
      }
      // push this CTA's bin to every CTA: remote stores do not wait, where
      // G remote loads after the barrier would, one after another
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r)
        *cluster.map_shared_rank(&st.hist[buf][rank][tid], r) = s;
    }
    // hist[buf] is complete in every CTA; the other buffer may be reused,
    // since every CTA finished reading it before arriving here
    cluster.sync();
    unsigned h = 0u, suf = 0u;
    if (tid < 256) {
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) h += st.hist[buf][r][tid];
      // suffix sums over bins tid..255: within the warp, then across
      suf = h;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += v;
      }
      if (lane == 0) st.wsum[warp] = suf;
    }
    __syncthreads();
    if (tid < 256) {
      for (int w = warp + 1; w < 8; ++w) suf += st.wsum[w];
      // the one bin where the running count crosses `need`
      if (suf >= need && suf - h < need) {
        const unsigned rest = need - (suf - h);
        st.prefix = prefix | ((unsigned long long)tid << shift);
        st.mask = mask | (255ull << shift);
        st.need = (int)rest;
        st.done = (h == rest);
      }
    }
    __syncthreads();
    if (st.done) break;                 // the same in every CTA
  }

  // ---- collect exactly kk keys into rank 0 ------------------------------
  {
    const unsigned long long prefix = st.prefix, mask = st.mask;
    int* count0 = cluster.map_shared_rank(&st.count, 0);
    unsigned long long* key0 = cluster.map_shared_rank(ckey, 0);
    // one remote atomic per warp and batch reserves the places
    const unsigned below = (1u << lane) - 1u;
    for (int i0 = warp * 32 + lane; i0 - lane < n;
         i0 += SEL_UNROLL * SEL_THREADS) {
      unsigned long long key[SEL_UNROLL];
      unsigned ball[SEL_UNROLL];
      int total = 0;
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u) {
        const int i = i0 + u * SEL_THREADS;
        key[u] = i < n ? sort_key(src[i], (unsigned)(lo + i)) : 0ull;
        ball[u] = __ballot_sync(0xffffffffu,
                                i < n && (key[u] & mask) >= prefix);
        total += __popc(ball[u]);
      }
      if (total) {
        int pos = 0;
        if (lane == 0) pos = atomicAdd(count0, total);
        pos = __shfl_sync(0xffffffffu, pos, 0);
#pragma unroll
        for (int u = 0; u < SEL_UNROLL; ++u) {
          const int at = pos + __popc(ball[u] & below);
          if (((ball[u] >> lane) & 1u) && at < kkp) key0[at] = key[u];
          pos += __popc(ball[u]);
        }
      }
    }
  }
  cluster.sync();
  return probes_in_smem ? st.probe : top_c;
}

// Kernel B's select pass: a cluster of G CTAs per query (grid B*G).
template <bool SMEM>
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
  float* cex = sq + D;                                                    // [kk]
  int* cslot = reinterpret_cast<int*>(cex + kk);                          // [kk]
  float* sc_s = reinterpret_cast<float*>(cslot + kk);                     // [chunk]
  __shared__ ClusterShared st;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / CLUSTER;
  const float* sc = scores + (long)b * P * C;
  for (int d = tid; d < D; d += SEL_THREADS) sq[d] = qn[(long)b * D + d];
  const int* probe = cluster_select<SMEM>(sc, sc_s, P * C, kk, kkp,
                                         top_c + (long)b * P, P, ckey, st,
                                         cluster);
  // up to SEL_THREADS candidates are ranked at the end without a sort;
  // more are sorted first, so that their index j is their funnel lane
  const bool by_rank = kkp <= SEL_THREADS;
  if (!by_rank) {
    if (rank == 0) bitonic_desc(ckey, kkp);
    cluster.sync();
  }

  // ---- exact f32 rerank of this CTA's share, one warp per candidate ----
  // dead lanes get a0 = 0, a1 = -1e30, slot -1 and are not reranked
  const unsigned long long* key0 = cluster.map_shared_rank(ckey, 0);
  float* cex0 = cluster.map_shared_rank(cex, 0);
  int* cslot0 = cluster.map_shared_rank(cslot, 0);
  const int per = (kk + CLUSTER - 1) / CLUSTER;
  const int j1 = min(kk, (rank + 1) * per);
  const int nch = D / 4;
  for (int j = rank * per + warp; j < j1; j += SEL_WARPS) {
    // the score from the key and the three aux rows at once: the chain of
    // dependent loads is the key, the probe's cluster id, aux, the row
    const unsigned long long key = key0[j];
    const unsigned idx = key_index(key);
    const int p = idx / C, c = idx % C;
    const float* a = aux + (long)probe[p] * 8 * C;
    const float a0 = a[c], a1 = a[C + c], a2 = a[2 * C + c];
    const int slot = key_score(key) > DEAD ? (int)a2 : -1;
    float ex = NEG_INF_F;
    if (slot >= 0) {
      const long r = slot < M ? slot : M - 1;
      const float4* row = reinterpret_cast<const float4*>(features + r * D);
      float dot = 0.f, n2 = 0.f;
      // the same per-lane order as one load at a time: ch = lane + 32 t
      for (int ch0 = lane; ch0 < nch; ch0 += 32 * ROW_UNROLL) {
        float4 v[ROW_UNROLL];
#pragma unroll
        for (int u = 0; u < ROW_UNROLL; ++u) {
          const int ch = ch0 + 32 * u;
          if (ch < nch) v[u] = __ldg(row + ch);
        }
#pragma unroll
        for (int u = 0; u < ROW_UNROLL; ++u) {
          const int ch = ch0 + 32 * u;
          if (ch < nch) {
            dot = fmaf(v[u].x, sq[4 * ch], dot);
            dot = fmaf(v[u].y, sq[4 * ch + 1], dot);
            dot = fmaf(v[u].z, sq[4 * ch + 2], dot);
            dot = fmaf(v[u].w, sq[4 * ch + 3], dot);
            n2 = fmaf(v[u].x, v[u].x, n2);
            n2 = fmaf(v[u].y, v[u].y, n2);
            n2 = fmaf(v[u].z, v[u].z, n2);
            n2 = fmaf(v[u].w, v[u].w, n2);
          }
        }
      }
      dot = warp_sum(dot);
      n2 = warp_sum(n2);
      const float cos = __fmul_rn(dot, rsqrtf(__fadd_rn(n2, 1e-12f)));
      ex = __fadd_rn(__fmul_rn(a0, cos), a1);
    }
    if (lane == 0) {
      cex0[j] = ex;
      cslot0[j] = slot;
    }
  }
  cluster.sync();
  if (rank != 0) return;

  // ---- final top-k on rank 0, ties to the lower funnel lane ------------
  if (by_rank) {
    // the lower funnel lane is the larger coarse key
    const int T = min(32, SEL_THREADS / kkp);
    const int j = tid / T;
    const bool valid = j < kk;
    const float ej = valid ? cex[j] : 0.f;
    const unsigned long long kj = valid ? ckey[j] : 0ull;
    const int r = rank_desc(kk, T, [&](int i) {
      const float ei = cex[i];
      const unsigned long long ki = ckey[i];
      return (ei > ej) | ((ei == ej) & (ki > kj));
    });
    if (valid && tid % T == 0 && r < k) {
      const bool hit = ej > DEAD;
      out_s[(long)b * kpad + r] = hit ? ej : NEG_INF_F;
      out_slot[(long)b * kpad + r] = hit ? cslot[j] : -1;
    }
    for (int t = k + tid; t < kpad; t += SEL_THREADS) {
      out_s[(long)b * kpad + t] = NEG_INF_F;
      out_slot[(long)b * kpad + t] = -1;
    }
    return;
  }
  for (int j = tid; j < kkp; j += SEL_THREADS)
    ckey[j] = j < kk ? sort_key(cex[j], (unsigned)j) : 0ull;
  __syncthreads();
  bitonic_desc(ckey, kkp);
  for (int t = tid; t < kpad; t += SEL_THREADS) {
    float s = NEG_INF_F;
    int slot = -1;
    if (t < k) {
      const unsigned j = key_index(ckey[t]);
      if (cex[j] > DEAD) { s = cex[j]; slot = cslot[j]; }
    }
    out_s[(long)b * kpad + t] = s;
    out_slot[(long)b * kpad + t] = slot;
  }
}

// Kernel D's select pass: a cluster of G CTAs per query. Every lane holds
// its entry's coarse score and bank slot as they are; a dead entry
// (score <= -5e29) fills lanes once the live ones run out, and the caller
// masks it.
template <bool SMEM>
__global__ void __launch_bounds__(SEL_THREADS)
ivf_candidates_select_kernel(const float* __restrict__ scores,
                             const float* __restrict__ aux,
                             const int* __restrict__ top_c,
                             float* __restrict__ out_s,
                             int* __restrict__ out_slot, int C, int P, int kk,
                             int kkp) {
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned long long* ckey = reinterpret_cast<unsigned long long*>(dyn);  // [kkp]
  float* sc_s = reinterpret_cast<float*>(ckey + kkp);                     // [chunk]
  __shared__ ClusterShared st;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CLUSTER;
  const float* sc = scores + (long)b * P * C;
  const int* probe = cluster_select<SMEM>(sc, sc_s, P * C, kk, kkp,
                                         top_c + (long)b * P, P, ckey, st,
                                         cluster);
  auto write_lane = [&](int lane, unsigned long long key) {
    const unsigned idx = key_index(key);
    const int p = idx / C, c = idx % C;
    out_s[(long)b * kk + lane] = sc[idx];
    out_slot[(long)b * kk + lane] =
        (int)aux[((long)probe[p] * 8 + 2) * C + c];
  };
  if (kkp <= SEL_THREADS) {
    // rank 0 alone: each key's lane is its rank, with no sort and no
    // further cluster barrier
    if (rank != 0) return;
    const int T = min(32, SEL_THREADS / kkp);
    const int j = threadIdx.x / T;
    const bool valid = j < kk;
    const unsigned long long kj = valid ? ckey[j] : 0ull;
    const int r = rank_desc(kk, T, [&](int i) { return ckey[i] > kj; });
    if (valid && threadIdx.x % T == 0) write_lane(r, kj);
    return;
  }
  if (rank == 0) bitonic_desc(ckey, kkp);
  cluster.sync();
  const unsigned long long* key0 = cluster.map_shared_rank(ckey, 0);
  for (int j = rank * SEL_THREADS + threadIdx.x; j < kk;
       j += CLUSTER * SEL_THREADS)
    write_lane(j, key0[j]);
  cluster.sync();                 // rank 0's keys outlive every reader
}

// How many keys CTA r of E's cluster hands to rank 0: the top min(k, n)
// of its share of n rows.
__device__ __forceinline__ int share_keys(int r, int C, int chunk, int k) {
  const int lo = min(C, r * chunk);
  return min(k, min(C, lo + chunk) - lo);
}

// Kernel E: the exact top-k of each probe (0 < k <= min(KPAD, C)) on a
// cluster of CLUSTER CTAs per (probe, query), grid (CLUSTER, P, B). Lanes
// < k hold the keys sort_key(score, c) in descending order (ties to the
// lowest c; dead entries fill in once the live ones run out, as in the
// plain version), with their bank slots; lanes k..KPAD-1 hold -1e30 and
// slot 0.
__global__ void __launch_bounds__(COARSE_THREADS)
ivf_topk_kernel(const __nv_bfloat16* __restrict__ clustered,
                const float* __restrict__ aux, const float* __restrict__ qn,
                const int* __restrict__ top_c, float* __restrict__ out_s,
                int* __restrict__ out_slot, int C, int D, int P, int k) {
  constexpr int NT = COARSE_THREADS;
  extern __shared__ __align__(16) unsigned char dyn[];
  // keys[0, KPAD): the top-k of the share's earlier pieces; keys[KPAD,
  // KPAD + TOPK_PIECE): the piece being scored; merged: rank 0's, every
  // CTA's top-k
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(dyn);
  unsigned long long* merged = keys + KPAD + TOPK_PIECE;    // [CLUSTER * k]
  float* sq = reinterpret_cast<float*>(merged + CLUSTER * k);       // [D]
  cg::cluster_group cluster = cg::this_cluster();
  // every CTA of the cluster must have started before rank 0's shared
  // memory is written: arrive now, wait just before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long row = (long)blockIdx.z * P + blockIdx.y;        // (query, probe)
  const int chunk = (C + CLUSTER - 1) / CLUSTER;
  const int lo = min(C, rank * chunk);
  const int n = min(C, lo + chunk) - lo;
  for (int d = tid; d < D; d += NT)
    sq[d] = __bfloat162float(
        __float2bfloat16_rn(qn[(long)blockIdx.z * D + d]));
  const long cid = top_c[row];
  const __nv_bfloat16* blk = clustered + cid * C * (long)D;
  const float* a = aux + cid * 8 * C;
  // this CTA's keys go to merged[at, at + share_keys(rank)) in rank 0
  int at = 0;
  for (int r = 0; r < rank; ++r) at += share_keys(r, C, chunk, k);
  unsigned long long* dst = cluster.map_shared_rank(merged, 0) + at;
  __syncthreads();

  int kept = 0;                  // keys[0, kept): top of the earlier pieces
  for (int i0 = 0;; i0 += TOPK_PIECE) {
    const int m = max(0, min(TOPK_PIECE, n - i0));
    for (int i = warp; i < m; i += NT / 32) {
      const int c = lo + i0 + i;
      float a0 = 0.f, a1 = 0.f;
      if (lane == 0) { a0 = a[c]; a1 = a[C + c]; }
      const float cos = row_dot(blk + (long)c * D, sq, D, lane);
      if (lane == 0)
        keys[KPAD + i] = sort_key(__fadd_rn(__fmul_rn(a0, cos), a1),
                                  (unsigned)c);
    }
    __syncthreads();
    // rank the nc candidates, keys[0, kept) then keys[KPAD, KPAD + m), by
    // counting: candidate j's T threads count the candidates above it
    const int nc = kept + m;
    auto cand = [&](int j) { return keys[j < kept ? j : KPAD + j - kept]; };
    int T = 32;
    while (T > 1 && T * nc > NT) T >>= 1;
    const int j = tid / T;
    const unsigned long long kj = j < nc ? cand(j) : 0ull;
    const int r = rank_desc(nc, T, [&](int i) { return cand(i) > kj; });
    const bool keep = j < nc && tid % T == 0 && r < k;
    if (i0 + TOPK_PIECE >= n) {                       // the share's last piece
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      if (keep) dst[r] = kj;
      break;
    }
    __syncthreads();                    // every count has read keys[0, kept)
    if (keep) keys[r] = kj;
    kept = min(k, nc);
    __syncthreads();
  }
  cluster.sync();                       // every CTA's keys are in rank 0
  if (rank != 0) return;

  // ---- rank 0: the n0 >= k keys ranked by counting; a key's rank is its
  // lane ------------------------------------------------------------------
  int n0 = 0;
  for (int r = 0; r < CLUSTER; ++r) n0 += share_keys(r, C, chunk, k);
  int T = 32;
  while (T > 1 && T * n0 > NT) T >>= 1;
  for (int j0 = 0; j0 < n0; j0 += NT / T) {
    const int j = j0 + tid / T;
    const unsigned long long kj = j < n0 ? merged[j] : 0ull;
    const int r = rank_desc(n0, T, [&](int i) { return merged[i] > kj; });
    if (j < n0 && tid % T == 0 && r < k) {
      out_s[row * KPAD + r] = key_score(kj);
      out_slot[row * KPAD + r] = (int)a[2 * C + key_index(kj)];
    }
  }
  for (int t = k + tid; t < KPAD; t += NT) {
    out_s[row * KPAD + t] = NEG_INF_F;
    out_slot[row * KPAD + t] = 0;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
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

// Raises `kernel`'s limit of dynamic shared memory to `smem` bytes when a
// launch needs more than `*done`, the limit set so far (the 48 KB default
// counts static shared memory too), so the attribute is set once per
// kernel and size, not on every call. Returns the error, cleared.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t* done) {
  if (smem <= *done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) { cudaGetLastError(); return err; }
  *done = smem;
  return cudaSuccess;
}

int grid_for(long n, int threads) {
  return (int)std::min<long>((n + threads - 1) / threads, 4096L);
}

// The coarse pass of B and D: cluster-major at and above the crossover
// (bucketing in three launches, then the pass), per pair below it. The
// last launch is the coarse kernel, which releases the select launched
// after it with programmatic stream serialisation. Each launch's error is
// returned; nothing falls back to the other pass.
cudaError_t launch_coarse_aux(const void* clustered, const float* aux,
                              const float* qn, const int* top_c,
                              float* scratch, int C, int D, int K, int B,
                              int P, cudaStream_t s) {
  if (!cluster_major(B, P, K))
    return launch_coarse<true>(clustered, aux, qn, top_c, scratch, C, D, B,
                               P, s);
  static size_t done = 0;
  cudaError_t err = opt_in(ivf_coarse_cm_kernel, CM_SMEM, &done);
  if (err != cudaSuccess) return err;
  const Workspace w = workspace(scratch, C, B, P, K, D);
  const long n_pairs = (long)B * P, n_q8 = (long)B * D / 8;
  const int row_tiles = (C + CM_ROWS - 1) / CM_ROWS;
  const long grid = w.max_tiles * row_tiles;
  if (grid > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(w.count, 0, (size_t)K * sizeof(int), s);
  if (err != cudaSuccess) return err;
  ivf_bucket_count_kernel<<<grid_for(std::max(n_pairs, n_q8),
                                     BUCKET_THREADS),
                            BUCKET_THREADS, 0, s>>>(top_c, qn, w.count,
                                                    w.q16, n_pairs, n_q8, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ivf_bucket_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(w.count, w.cursor,
                                                     w.tiles, w.n_tiles, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ivf_bucket_scatter_kernel<<<grid_for(n_pairs, BUCKET_THREADS),
                              BUCKET_THREADS, 0, s>>>(top_c, w.cursor,
                                                      w.list, n_pairs, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ivf_coarse_cm_kernel<<<(unsigned)grid, CM_THREADS, CM_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(clustered), aux, w.q16, w.list,
      w.tiles, w.n_tiles, scratch, C, D, P, row_tiles);
  return cudaGetLastError();
}

// Launches `kernel` on clusters of CLUSTER CTAs along x, after the
// previous kernel with programmatic stream serialisation when `pdl`.
// Returns the launch's error, read and cleared so the next launch does not
// see it; nothing retries another way.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, size_t smem,
                           bool pdl, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// Launches a select kernel on a cluster of CLUSTER CTAs per query (grid
// B * CLUSTER), with programmatic stream serialisation after the coarse
// pass: `in_smem` when a CTA's share of the N scores fits in shared memory
// beside `fixed` bytes, else `in_l2`, which reads them from the scratch.
template <typename Kernel, typename... Args>
cudaError_t launch_select(Kernel in_smem, Kernel in_l2, size_t fixed, int N,
                          int B, cudaStream_t s, Args... args) {
  static int optin = 0;                // per-block limit, static + dynamic
  static size_t static_smem = 0;
  static size_t done[2] = {0, 0};      // opt-in set: in_smem, in_l2
  cudaError_t err = cudaSuccess;
  if (optin == 0) {
    int dev = 0;
    cudaFuncAttributes fa;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, in_smem);
    if (err != cudaSuccess) { optin = 0; cudaGetLastError(); return err; }
    static_smem = fa.sharedSizeBytes;
  }
  const size_t share = (size_t)((N + CLUSTER - 1) / CLUSTER) * sizeof(float);
  const bool fits = static_smem + fixed + share <= (size_t)optin;
  const Kernel kernel = fits ? in_smem : in_l2;
  const size_t smem = fixed + (fits ? share : 0);
  // the static ClusterShared alone is ~28 KB: every size opts in
  err = opt_in(kernel, smem, &done[fits ? 0 : 1]);
  if (err != cudaSuccess) return err;
  return launch_cluster(kernel, dim3(B * CLUSTER), SEL_THREADS, smem, true,
                        s, args...);
}

}  // namespace

extern "C" int ivf_scan_scores_launch(const void* clustered, const float* qn,
                                      const int* top_c, float* out, int C,
                                      int D, int B, int P, void* stream) {
  return (int)launch_coarse<false>(clustered, nullptr, qn, top_c, out, C, D,
                                   B, P,
                                   reinterpret_cast<cudaStream_t>(stream));
}

// Words of workspace that B and D need after their [B, P*C] scratch: 0
// below the crossover, where they take the per-pair coarse pass.
extern "C" long ivf_coarse_workspace_words(int B, int P, int K, int D) {
  return workspace_words(B, P, K, D);
}

extern "C" int ivf_retrieve_fused_launch(
    const void* clustered, const float* aux, const float* features,
    const float* qn, const int* top_c, float* scratch, float* out_s,
    int* out_slot, int C, int D, int K, long M, int B, int P, int kk, int k,
    int kpad, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_coarse_aux(clustered, aux, qn, top_c, scratch, C,
                                      D, K, B, P, s);
  if (err != cudaSuccess) return (int)err;
  const int kkp = pow2_at_least(kk);
  // rank 0's keys, the query, the exact scores and slots of the kk lanes
  const size_t fixed = (size_t)kkp * 8 + (size_t)D * 4 + (size_t)kk * 8;
  return (int)launch_select(ivf_select_rerank_kernel<true>,
                            ivf_select_rerank_kernel<false>, fixed, P * C, B,
                            s, (const float*)scratch, aux, top_c, features,
                            qn, out_s, out_slot, C, P, D, M, kk, kkp, k,
                            kpad);
}

extern "C" int ivf_candidates_launch(const void* clustered, const float* aux,
                                     const float* qn, const int* top_c,
                                     float* scratch, float* out_s,
                                     int* out_slot, int C, int D, int K,
                                     int B, int P, int kk, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_coarse_aux(clustered, aux, qn, top_c, scratch, C,
                                      D, K, B, P, s);
  if (err != cudaSuccess) return (int)err;
  const int kkp = pow2_at_least(kk);
  return (int)launch_select(ivf_candidates_select_kernel<true>,
                            ivf_candidates_select_kernel<false>,
                            (size_t)kkp * 8, P * C, B, s,
                            (const float*)scratch, aux, top_c, out_s,
                            out_slot, C, P, kk, kkp);
}

extern "C" int ivf_topk_scores_launch(const void* clustered, const float* aux,
                                      const float* qn, const int* top_c,
                                      float* out_s, int* out_slot, int C,
                                      int D, int B, int P, int k,
                                      void* stream) {
  static size_t done = 0;
  // the kept keys, a piece's keys and rank 0's merged keys, then the query
  const size_t smem =
      (size_t)(KPAD + TOPK_PIECE + CLUSTER * k) * 8 + (size_t)D * 4;
  const cudaError_t err = opt_in(ivf_topk_kernel, smem, &done);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster(
      ivf_topk_kernel, dim3(CLUSTER, P, B), COARSE_THREADS, smem, false,
      reinterpret_cast<cudaStream_t>(stream),
      static_cast<const __nv_bfloat16*>(clustered), aux, qn, top_c, out_s,
      out_slot, C, D, P, k);
}
