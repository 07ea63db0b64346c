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
//
// The overflow annex's pass on kernel B's path (`annex_merge_launch`, two
// launches after B) follows the four kernels; its note is there.

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

// ---- the overflow annex on kernel B's path -------------------------------
//
// Replaces the JAX package's XLA annex after its v3r kernel
// (aura_snn_rag_tpu/memory/engine.py:385-404; no Pallas kernel). The annex
// is the last G clusters of C slots, N = G*C rows (32,768 at the engine's
// shape), which every query scores: a [B, D] x [N, D] product where XLA
// and PyTorch write the [B, N] f32 scores, mask them elementwise, take a
// top-kk, gather, rerank and merge (~55 launches). Two launches here:
//
// 1. `annex_select_kernel`: CTA (tile of 64 queries, row chunk) holds its
//    queries in shared memory as bf16 (zero past B) and streams its
//    chunk's row tiles (128 rows) through a `cp.async` ring, 64 deep a
//    stage, into `wgmma` (two warpgroups of 64 queries x 64 rows, f32
//    accumulation, both operands K-major in 128-byte-swizzled shared
//    memory). A chunk's tiles are strided over the annex, so the CTAs that
//    run together read the same tiles, from L2 for all but the first
//    query tile. The epilogue rounds each cosine to bf16 (the plain
//    version's bf16 product) and gives `annex_coarse`'s score, ((w_cos *
//    cos + 0) + w_t * temporal) * strength, from the rows' decay, time
//    and generation and the state's scalars (read on the device), one
//    rounding per operation as PyTorch's elementwise kernels round. A
//    row is kept when its score reaches the query's threshold: kept rows
//    go to the (query, chunk) list as 64-bit keys (`sort_key`: score,
//    then the lower row first), staged per warp so that each query's run
//    is written with coalesced stores. The threshold is a lower bound of
//    the chunk's kk-th best key, from a histogram of the kept keys' bins
//    (a key's top 14 bits, 32 bins an octave; 64 bins from two octaves
//    below the query's first best score, one count above), raised after
//    every tile: no row it drops can be in the query's top-kk, so the
//    lists hold every row of the exact top-kk (~4-5k keys a query at
//    B = 1024, 8 chunks; every row at B = 1-8, 2 tiles a chunk).
// 2. `annex_rerank_kernel`: G2 CTAs per query, a cluster of 8 below one
//    query per SM (at B = 1-8, as kernel B's select) and one CTA a query
//    above: the CTAs take the query's lists (in shared memory when they
//    fit), find the kk largest keys by an 8-bit radix select (histograms
//    pushed through DSMEM in a cluster), rerank them in f32 from
//    `features` (half a warp a candidate, |row|^-1/2 from the row, as
//    `_combined_score` with the slot's strength and time), and rank 0
//    merges them with kernel B's k lanes into the final top-k: on equal
//    scores B's lanes first, then the annex in coarse order, which is
//    what concatenating the two and a stable top-k give.
//
// Bound on the H100: the annex's bf16 rows read once (N*D*2 bytes, 50 MB
// at the engine's shape) and the f32 rows of each query's kk candidates,
// or the products, 2*B*N*D operations (51.5 GFLOP at B = 1024: 52 us at
// 989 TFLOP/s). At B = 1-8 the rows bound it, so they are split over
// about one CTA per SM (`annex_plan`); at B = 1024 the 16 query tiles
// take the SMs and each row tile is read from L2 once per query tile
// (805 MB), which with the epilogue bounds launch 1 on this design. The
// shape follows from B and N alone. The scores never reach device memory
// as a [B, N] matrix: only the kept keys are written. The workspace that
// holds them (`annex_workspace_bytes`) is reserved for the worst case,
// every row kept: about B*N*8 bytes, 268 MB at B = 1024 and N = 32,768,
// twice the f32 matrix of the plain version, though a batch of 1024
// writes ~4-5k keys a query. Sizing the lists by a bound the threshold
// guarantees would take an overflow check; PyTorch's caching allocator
// keeps the reservation between calls.
//
// Above D = 768 the tile's queries (64 x D bf16, 256 KB at D = 2048) no
// longer fit in shared memory beside the ring: `annex_select_kernel<true>`
// then rounds each stage's 64-deep slice of them into the stage beside its
// rows (8 KB more a stage), from the f32 queries in L2, once per row tile;
// the rest is the same.

constexpr int AX_ROWS = 128;           // annex rows per tile (wgmma N: 2 x 64)
constexpr int AX_NQ = 64;              // queries per launch-1 CTA (wgmma M)
constexpr int AX_THREADS = 256;        // two warpgroups
constexpr int AX_SUB_BYTES = AX_ROWS * 64 * 2;  // a stage: [128 rows][64]
constexpr int AX_STAGES = 4;           // ring slots
constexpr int AX_AHEAD = 2;            // stages loaded ahead of the product
constexpr int AX_BINS = 64;            // threshold histogram bins a query
constexpr int AX_HSTRIDE = AX_BINS + 1;
constexpr int AX_BPL = AX_BINS / 4;    // bins a lane of 4 in the update
constexpr int AX_SHIFT = 18;           // a key's bin: its top 14 bits (32
                                       // bins an octave)
constexpr int AX_SHARE = 6144;         // keys a launch-2 CTA keeps in
                                       // shared memory (more: read from L2)
static_assert(AX_ROWS * 8 % AX_THREADS == 0, "whole 16-byte copies");

struct AnnexArgs {
  const __nv_bfloat16* rows;           // [N, D] the annex's clustered rows
  const float* cdecay;                 // [N] cluster_decay of the annex
  const float* cts;                    // [N] cluster_ts
  const int* cgen;                     // [N] cluster_gen
  const int* cslot;                    // [N] cluster_slot
  const float* features;               // [M, D]
  const float* strength;               // [M]
  const float* timestamp;              // [M]
  const float* step;                   // state scalars, on the device
  const float* decay_accum;
  const int* count;
  const float* qn;                     // [B, D] f32, L2-normalised
  const float* b_s;                    // [B, kpad] kernel B's scores
  const int* b_slot;                   // [B, kpad] and slots
  unsigned long long* keys;            // [B, nc, R] kept keys
  int* n_keys;                         // [B, nc]
  float* out_s;                        // [B, k]
  long long* out_slot;                 // [B, k]
  long M;
  int N, D, B, kk, kkp, k, kpad, nc, tiles, max_memories;
  float w_cos, w_t, sps, inv_tau;
};

// PyTorch's exp(-clamp((step - ts) * sps, min=0) / tau): a CPU scalar
// divisor reaches a CUDA kernel as a multiply by its f32 reciprocal.
__device__ __forceinline__ float temporal_term(float step, float ts, float sps,
                                               float inv_tau) {
  const float age = __fmul_rn(__fsub_rn(step, ts), sps);
  return expf(__fmul_rn(-fmaxf(age, 0.f), inv_tau));
}

// ((w_cos * cos + 0) + tt) * strength, one rounding per operation, as the
// plain version's elementwise ops (the 0 is its spatial term).
__device__ __forceinline__ float combined_score(float w_cos, float cos,
                                                float tt, float st) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(w_cos, cos), 0.f), tt), st);
}

// The high word of sort_key(s, .): the score's order as an unsigned.
__device__ __forceinline__ unsigned ord32(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The least score whose top bits (AX_SHIFT on) are `bin`: a score s is at
// or above it exactly when ord32(s) >> AX_SHIFT >= bin.
__device__ __forceinline__ float bin_floor(unsigned bin) {
  const unsigned k = bin << AX_SHIFT;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// wgmma: D[64 queries x 64 rows] (+)= A[64 x 16] . B[64 x 16]^T, both
// K-major in 128-byte-swizzled shared memory (`swz`'s layout on 1024-byte
// boundaries). acc[4j + 2h + e] is query 16 * warp + g + 8h and row
// 8j + 2t + e of the warpgroup's 64 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define AX_ACC8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : AX_ACC8(d, 0), AX_ACC8(d, 8), AX_ACC8(d, 16), AX_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving accumulator reads above a wgmma wait
__device__ __forceinline__ void fence_acc32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Launch 1. Grid (query tiles of 64, row chunks); chunk c holds the row
// tiles c, c + nc, c + 2 nc, ... (at most `tiles` of them, so a list
// holds R = tiles * AX_ROWS keys): the CTAs that run together read the
// same few tiles, which stay in L2 for every query tile. Two warpgroups:
// warpgroup wr multiplies the 64 queries by rows 64 wr .. 64 wr + 63 of
// a tile, 64 deep a stage, on `wgmma` (issued on every query tile, also
// past B: a wgmma under a branch is serialised). QSTREAM: the queries'
// slice of each stage rides in the stage (`AX_QSUB_BYTES` after its
// rows) instead of all of them being held for the whole launch.
constexpr int AX_QSUB_BYTES = AX_NQ * 128;   // a stage's [64 queries][64]

// Queries q0 .. q0 + 63's depth chunk kb, rounded to bf16 (to nearest
// even), zero past B and past D, into a [64][64] swizzled block: a
// stage's slice when the queries stream.
__device__ __forceinline__ void round_queries(unsigned char* dst,
                                              const AnnexArgs& a, int q0,
                                              int nq, int kb, int tid) {
  const int dch = a.D / 8;
  for (int i = tid; i < AX_NQ * 8; i += AX_THREADS) {
    const int q = i / 8, ch = i % 8, c8 = kb * 8 + ch;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q < nq && c8 < dch) {
      const float4* src =
          reinterpret_cast<const float4*>(a.qn + (long)(q0 + q) * a.D) +
          2 * c8;
      const float4 u = src[0], w = src[1];
      v = make_uint4(bf16x2(u.x, u.y), bf16x2(u.z, u.w), bf16x2(w.x, w.y),
                     bf16x2(w.z, w.w));
    }
    *reinterpret_cast<uint4*>(dst + swz(q, ch)) = v;
  }
}

template <bool QSTREAM>
__global__ void __launch_bounds__(AX_THREADS)
annex_select_kernel(const AnnexArgs a) {
  constexpr int STAGE = AX_SUB_BYTES + (QSTREAM ? AX_QSUB_BYTES : 0);
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp % 4, wr = warp / 4, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * AX_NQ, nq = min(AX_NQ, a.B - q0);
  const int chunk = blockIdx.y, D = a.D, dch = D / 8;
  const int nkb = (D + 63) / 64;
  const int R = a.tiles * AX_ROWS;
  const int ntile = ((a.N + AX_ROWS - 1) / AX_ROWS - chunk + a.nc - 1) / a.nc;
  unsigned char* qsm = smem + AX_STAGES * STAGE;    // [nkb][64][64]
  unsigned long long* stage_all =       // [warps][8 queries][64] kept keys
      reinterpret_cast<unsigned long long*>(
          qsm + (QSTREAM ? 0 : nkb * AX_NQ * 128));
  float* rt_tt =
      reinterpret_cast<float*>(stage_all + AX_THREADS / 32 * 8 * 64);
  float* rt_st = rt_tt + AX_ROWS;
  int* rt_ok = reinterpret_cast<int*>(rt_st + AX_ROWS);
  unsigned* thr = reinterpret_cast<unsigned*>(rt_ok + AX_ROWS);  // [NQ]
  unsigned* base = thr + AX_NQ;        // [NQ] the histogram's first bin
  unsigned* high = base + AX_NQ;       // [NQ] counted keys above the bins
  int* cnt = reinterpret_cast<int*>(high + AX_NQ);    // [NQ] kept so far
  int* state = cnt + AX_NQ;            // [NQ] 0 no bins yet, 1 bins, 2 dirty
  float* thr_lo = reinterpret_cast<float*>(state + AX_NQ);   // [NQ]
  // [NQ][BINS + 1]: the odd stride puts a bin of the queries a warp
  // handles at once in different banks
  unsigned* hist = reinterpret_cast<unsigned*>(thr_lo + AX_NQ);
  __shared__ int unbased;              // queries without bins yet

  const float step = *a.step, dacc = *a.decay_accum;
  const int live_from = (int)((unsigned)*a.count - (unsigned)a.max_memories);
  for (int i = tid; i < AX_NQ; i += AX_THREADS) {
    thr[i] = 0u; base[i] = 0u; high[i] = 0u; cnt[i] = 0; state[i] = 0;
    thr_lo[i] = -INFINITY;
  }
  for (int i = tid; i < AX_NQ * AX_HSTRIDE; i += AX_THREADS) hist[i] = 0u;
  if (tid == 0) unbased = nq;
  // the tile's queries, rounded to bf16 (to nearest even), zero past B
  if constexpr (!QSTREAM)
    for (int i = tid; i < nkb * AX_NQ * 8; i += AX_THREADS) {
      const int kb = i / (AX_NQ * 8), q = (i / 8) % AX_NQ, ch = i % 8;
      const int c8 = kb * 8 + ch;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q < nq && c8 < dch) {
        const float4* src =
            reinterpret_cast<const float4*>(a.qn + (long)(q0 + q) * D) +
            2 * c8;
        const float4 u = src[0], w = src[1];
        v = make_uint4(bf16x2(u.x, u.y), bf16x2(u.z, u.w), bf16x2(w.x, w.y),
                       bf16x2(w.z, w.w));
      }
      *reinterpret_cast<uint4*>(qsm + kb * AX_NQ * 128 + swz(q, ch)) = v;
    }

  const unsigned ring0 = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned q_s = (unsigned)__cvta_generic_to_shared(qsm);
  const int nst = ntile * nkb;
  // stage s <- depth chunk s % nkb of the chunk's tile s / nkb
  auto load = [&](int s) {
    const int tile = s / nkb, kb = s - tile * nkb;
    const unsigned xs = ring0 + (s % AX_STAGES) * STAGE;
    const int r0 = (tile * a.nc + chunk) * AX_ROWS;
#pragma unroll
    for (int j = 0; j < AX_ROWS * 8 / AX_THREADS; ++j) {
      const int i = tid + j * AX_THREADS, row = i >> 3, ch = i & 7;
      const int c8 = kb * 8 + ch;
      const bool ok = r0 + row < a.N && c8 < dch;
      cp_async16(xs + swz(row, ch),
                 ok ? a.rows + (long)(r0 + row) * D + c8 * 8 : a.rows, ok);
    }
    if constexpr (QSTREAM)
      round_queries(smem + (s % AX_STAGES) * STAGE + AX_SUB_BYTES, a, q0, nq,
                    kb, tid);
  };
  // stages s + 1 and s + 2 load while stage s multiplies; slot s - 1 may
  // still be read by the wgmma group left in flight
#pragma unroll
  for (int s = 0; s < AX_AHEAD; ++s) {
    if (s < nst) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float acc[32];   // left unset: the first wgmma of a tile overwrites it
  const uint64_t da0 = desc_sw128(q_s);
  for (int tile = 0; tile < ntile; ++tile) {
    const int r0 = (tile * a.nc + chunk) * AX_ROWS;
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = tile * nkb + kb;
      asm volatile("cp.async.wait_group %0;\n" ::"n"(AX_AHEAD - 1)
                   : "memory");
      // the copies (and the queries' stores) before the tensor cores'
      // reads of shared memory
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();        // stage s landed; stage s - 2 was consumed
      if (s + AX_AHEAD < nst) load(s + AX_AHEAD);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (kb == 0 && tid < AX_ROWS) {
        // the tile's per-row terms, as `annex_coarse` computes them
        const int r = r0 + tid;
        int ok = 0;
        float tt = 0.f, st = 0.f;
        if (r < a.N) {
          const int gen = a.cgen[r];
          ok = gen >= 0 && gen >= live_from;
          st = expf(__fsub_rn(dacc, a.cdecay[r]));
          tt = __fmul_rn(a.w_t, temporal_term(step, a.cts[r], a.sps,
                                              a.inv_tau));
        }
        rt_ok[tid] = ok; rt_tt[tid] = tt; rt_st[tid] = st;
      }
      uint64_t da;
      if constexpr (QSTREAM)
        da = desc_sw128(ring0 + (s % AX_STAGES) * STAGE + AX_SUB_BYTES);
      else
        da = da0 + ((kb * AX_NQ * 128) >> 4);
      const uint64_t db = desc_sw128(ring0 + (s % AX_STAGES) * STAGE +
                                     wr * 64 * 128);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
        wgmma_64x64(acc, da + 2 * k16, db + 2 * k16, (kb | k16) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // the group before this one has read its slot
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc32(acc);

    // ---- the tile's epilogue ----------------------------------------------
    __syncthreads();                    // the per-row terms are written
    // sc[4j + 2h + e], from acc[4j + 2h + e]: query 16 wq + g + 8h, row
    // 64 wr + 8j + 2t + e; a dropped entry (dead row, row past N, query
    // past B) is NaN, which no threshold passes. Warps whose 16 queries
    // all lie past B skip the epilogue's work.
    const bool live = 16 * wq < nq;     // the same in the warp
    const bool q_lo = g < nq - 16 * wq, q_hi = g + 8 < nq - 16 * wq;
    float sc[32];
    if (live) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ri = 64 * wr + 8 * j + 2 * t + e;
          const bool ok = rt_ok[ri] != 0;
          const float tt = rt_tt[ri], st = rt_st[ri];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float cos = __bfloat162float(
                __float2bfloat16_rn(acc[4 * j + 2 * h + e]));
            sc[4 * j + 2 * h + e] = (ok && (h ? q_hi : q_lo))
                                        ? combined_score(a.w_cos, cos, tt, st)
                                        : __int_as_float(0x7fffffff);
          }
        }
    }
    if (unbased > 0) {                  // the same in the CTA
      // bins for a query without them: the top one at its largest score
      if (live) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * wq + g + 8 * h;
          float m = __int_as_float(0x7fffffff);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            m = fmaxf(m, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
          if (q < nq && state[q] == 0 && m == m)
            atomicMax(&base[q], ord32(m) >> AX_SHIFT);
        }
      }
      __syncthreads();
      if (tid < nq && state[tid] == 0 && base[tid] > 0u) {
        base[tid] = base[tid] >= AX_BINS - 1 ? base[tid] - (AX_BINS - 1) : 0u;
        state[tid] = 1;
        atomicSub(&unbased, 1);
      }
      __syncthreads();
    }
    // keep what reaches the threshold (thr_lo: the least score in the
    // threshold's bin, -inf before it has one). A quad stages its query's
    // kept keys in the warp's buffer; then the warp writes each query's
    // run to its list with coalesced stores and counts the run's keys in
    // the query's histogram, a lane a key.
    unsigned long long* stage = stage_all + warp * 8 * 64;   // [8][64]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live) continue;              // the same in the warp
      const int q = 16 * wq + g + 8 * h;
      const bool qok = q < nq;
      const float lo = qok ? thr_lo[q] : 0.f;
      int n = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        n += qok && sc[4 * (i >> 1) + 2 * h + (i & 1)] >= lo;
      if (!__any_sync(0xffffffffu, n > 0)) continue;
      int incl = n;                     // inclusive scan over the quad
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o, 4);
        if (t >= o) incl += v;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
      int at = g * 64 + incl - n;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = sc[4 * j + 2 * h + e];
          if (qok && v >= lo) {
            const unsigned col =
                (unsigned)(r0 + 64 * wr + 8 * j + 2 * t + e);
            stage[at++] = ((unsigned long long)ord32(v) << 32) |
                          (0xFFFFFFFFu - col);
          }
        }
      int pos = 0;                      // the run's place in the list
      if (t == 3 && total > 0) pos = atomicAdd(&cnt[q], total);
      __syncwarp();
      // the warp's runs laid end to end, a lane a key: run i (quad i's
      // query) starts at from[i] and goes to list place pos_i
      int from[8], to[8], n_all = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        from[i] = n_all;
        n_all += __shfl_sync(0xffffffffu, total, 4 * i);
        to[i] = __shfl_sync(0xffffffffu, pos, 4 * i + 3);
      }
      for (int f = lane; f < n_all; f += 32) {
        int i = 0;
#pragma unroll
        for (int ii = 1; ii < 8; ++ii) i = f >= from[ii] ? ii : i;
        int k = f, p_i = 0;
#pragma unroll
        for (int ii = 0; ii < 8; ++ii)
          if (ii == i) { k = f - from[ii]; p_i = to[ii]; }
        const int qi = 16 * wq + i + 8 * h;
        const unsigned long long key = stage[i * 64 + k];
        a.keys[((long)(q0 + qi) * a.nc + chunk) * R + p_i + k] = key;
        if (state[qi] != 0) {
          const unsigned bin = (unsigned)(key >> 32) >> AX_SHIFT;
          const unsigned b0 = base[qi];
          if (bin >= b0) {
            if (bin - b0 < AX_BINS)
              atomicAdd(&hist[qi * AX_HSTRIDE + (bin - b0)], 1u);
            else
              atomicAdd(&high[qi], 1u);
          }
          if (k == 0) state[qi] = 2;
        }
      }
      __syncwarp();                     // the buffer is free for h = 1
    }
    __syncthreads();
    // raise each dirty query's threshold to the largest bin b with
    // (counted keys in bins >= b) + above >= kk, and move the bins up to
    // start there: 4 lanes a query, part p holding bins [16p, 16p + 16)
    for (int qb = warp * 8; qb < nq; qb += AX_THREADS / 4) {
      const int part = lane & 3, q = qb + (lane >> 2);
      const bool dirty = q < nq && state[q] == 2;
      if (!__any_sync(0xffffffffu, dirty)) continue;
      unsigned* hq = hist + q * AX_HSTRIDE + AX_BPL * part;
      const unsigned b0 = base[q], hi = high[q], need = (unsigned)a.kk;
      unsigned hv[AX_BPL], tot = 0u;
#pragma unroll
      for (int i = 0; i < AX_BPL; ++i) tot += (hv[i] = hq[i]);
      unsigned suf = tot;               // bins of parts >= p
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const unsigned v = __shfl_down_sync(0xffffffffu, suf, o, 4);
        if (part + o < 4) suf += v;
      }
      int best = -1;                    // this part's largest such bin
      unsigned ge = hi + suf - tot;
#pragma unroll
      for (int i = AX_BPL - 1; i >= 0; --i) {
        ge += hv[i];
        if (best < 0 && ge >= need) best = i;
      }
      const unsigned parts =
          (__ballot_sync(0xffffffffu, best >= 0) >> (lane & ~3)) & 15u;
      const int top = parts ? 31 - __clz(parts) : 0;
      const int top_best = __shfl_sync(0xffffffffu, best, (lane & ~3) + top);
      int nb = parts ? AX_BPL * top + top_best : -1;
      if (hi >= need) nb = AX_BINS;
      if (dirty && nb > 0) {
        unsigned nv[AX_BPL];
#pragma unroll
        for (int i = 0; i < AX_BPL; ++i) {
          const int b = AX_BPL * part + i;
          nv[i] = b + nb < AX_BINS ? hq[i + nb] : 0u;
          // the keys above the bins lie at or above the old top
          if (b == AX_BINS - nb) nv[i] += hi;
        }
        __syncwarp(0xffffffffu & (0xFu << (lane & ~3)));
#pragma unroll
        for (int i = 0; i < AX_BPL; ++i) hq[i] = nv[i];
        if (part == 0) {
          base[q] = b0 + (unsigned)nb;
          thr[q] = max(thr[q], b0 + (unsigned)nb);
          thr_lo[q] = bin_floor(thr[q]);
          high[q] = 0u;
        }
      } else if (dirty && nb == 0 && part == 0) {
        thr[q] = max(thr[q], b0);
        thr_lo[q] = bin_floor(thr[q]);
      }
      if (dirty && part == 0) state[q] = 1;
    }
    __syncthreads();
  }
  if (tid < nq) a.n_keys[(long)(q0 + tid) * a.nc + chunk] = cnt[tid];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launch 2's shared state: the radix select's histograms (WHIST per CTA,
// then every CTA's sum, two buffers as passes alternate) and its digits.
template <int G2>
struct AnnexShared {
  unsigned whist[WHIST][256];
  unsigned hist[2][G2][256];
  unsigned wsum[8];
  unsigned long long prefix, mask;
  int need, done, count;
};

// Launch 2: G2 CTAs per query (grid B * G2; a thread-block cluster when
// G2 > 1). CTA r takes the lists of chunks [r*nc/G2, (r+1)*nc/G2), read
// from device memory (L2, where launch 1 just wrote them) on each pass.
template <int G2>
__global__ void __launch_bounds__(SEL_THREADS)
annex_rerank_kernel(const AnnexArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int kk = a.kk, kkp = a.kkp, k = a.k, m = k + kk;
  const int c0 = (int)(blockIdx.x % G2) * a.nc / G2;
  const int c1 = ((int)(blockIdx.x % G2) + 1) * a.nc / G2;
  unsigned long long* ckey =                    // [kkp] rank 0's keys
      reinterpret_cast<unsigned long long*>(dyn);
  unsigned long long* mkey = ckey + kkp;        // [m] merge tie keys
  unsigned long long* share = mkey + m;         // [AX_SHARE] this CTA's keys
  float* sq = reinterpret_cast<float*>(share + AX_SHARE);     // [D]
  float* cex = sq + a.D;                        // [kk] exact scores
  int* cslot = reinterpret_cast<int*>(cex + kk);             // [kk]
  float* mex = reinterpret_cast<float*>(cslot + kk);         // [m]
  int* mslot = reinterpret_cast<int*>(mex + m);              // [m]
  int* ccount = mslot + m;                      // [c1 - c0] list lengths
  __shared__ AnnexShared<G2> st;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / G2, D = a.D;
  unsigned rank = 0;
  if constexpr (G2 > 1) {
    rank = cg::this_cluster().block_rank();
    // every CTA of the cluster must have started before distributed
    // shared memory is touched: arrive now, wait before the first store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
  if (tid == 0) {
    st.prefix = 0ull; st.mask = 0ull; st.need = kk; st.done = 0;
    st.count = 0;
  }
  if (rank == 0)
    for (int i = tid; i < kkp; i += SEL_THREADS) ckey[i] = 0ull;
  for (int d = tid; d < D; d += SEL_THREADS) sq[d] = a.qn[(long)b * D + d];
  for (int i = tid; i < WHIST * 256; i += SEL_THREADS)
    (&st.whist[0][0])[i] = 0u;
  // the select pass must have finished before its lists are read
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int c = c0 + tid; c < c1; c += SEL_THREADS)
    ccount[c - c0] = a.n_keys[(long)b * a.nc + c];
  __syncthreads();
  const long R = (long)a.tiles * AX_ROWS;
  const unsigned long long* lists = a.keys + (long)b * a.nc * R;
  int n_share = 0;
  for (int c = c0; c < c1; ++c) n_share += ccount[c - c0];
  // a share that fits is copied into shared memory once; a larger one is
  // read from the lists on every pass
  const bool in_smem = n_share <= AX_SHARE;
  if (in_smem) {
    // many short lists (small B): a warp a list; few long ones: the CTA
    const bool by_warp = c1 - c0 >= SEL_WARPS / 2;
    const int step = by_warp ? 32 : SEL_THREADS, me = by_warp ? lane : tid;
    for (int c = c0, at = 0; c < c1; at += ccount[c - c0], ++c) {
      if (by_warp && (c - c0) % SEL_WARPS != warp) continue;
      const int n = ccount[c - c0];
      const unsigned long long* src = lists + c * R;
      for (int i = me; i < n; i += 4 * step) {
        unsigned long long v[4];        // the loads before the stores
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i + u * step < n) v[u] = src[i + u * step];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i + u * step < n) share[at + i + u * step] = v[u];
      }
    }
    __syncthreads();
  }
  // f(key, in) over this CTA's keys, a warp at a time: every lane of the
  // warp calls f, `in` says whether its key is one
  auto each_key = [&](auto&& f) {
    if (in_smem) {
      for (int i0 = warp * 32; i0 < n_share; i0 += SEL_THREADS) {
        const int i = i0 + lane;
        f(i < n_share ? share[i] : 0ull, i < n_share);
      }
      return;
    }
    for (int c = c0; c < c1; ++c) {
      const unsigned long long* lst = lists + c * R;
      const int n = ccount[c - c0];
      for (int i0 = warp * 32; i0 < n; i0 += SEL_THREADS) {
        const int i = i0 + lane;
        f(i < n ? lst[i] : 0ull, i < n);
      }
    }
  };

  // ---- radix select of the kk-th largest key, 8 bits per pass ----------
  unsigned* wh = st.whist[warp % WHIST];
  int buf = 0;
  for (int shift = 56; shift >= 0; shift -= 8, buf ^= 1) {
    const unsigned long long prefix = st.prefix, mask = st.mask;
    const unsigned need = (unsigned)st.need;
    // one atomic per distinct digit in the warp: most keys share the top
    // digits
    each_key([&](unsigned long long key, bool in) {
      in = in && (key & mask) == prefix;
      const unsigned digit = in ? (unsigned)(key >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&wh[digit], __popc(peers));
    });
    __syncthreads();
    if constexpr (G2 > 1) {
      if (shift == 56)                  // every CTA arrived at the top
        asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    }
    if (tid < 256) {
      unsigned s = 0u;
#pragma unroll
      for (int w = 0; w < WHIST; ++w) {
        s += st.whist[w][tid];
        st.whist[w][tid] = 0u;
      }
      if constexpr (G2 > 1) {
        cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
        for (int r = 0; r < G2; ++r)
          *cluster.map_shared_rank(&st.hist[buf][rank][tid], r) = s;
      } else {
        st.hist[buf][0][tid] = s;
      }
    }
    if constexpr (G2 > 1) cg::this_cluster().sync();
    else __syncthreads();
    unsigned h = 0u, suf = 0u;
    if (tid < 256) {
#pragma unroll
      for (int r = 0; r < G2; ++r) h += st.hist[buf][r][tid];
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
      if (suf >= need && suf - h < need) {
        const unsigned rest = need - (suf - h);
        st.prefix = prefix | ((unsigned long long)tid << shift);
        st.mask = mask | (255ull << shift);
        st.need = (int)rest;
        st.done = (h == rest);
      }
      // fewer keys than kk in all: every key is selected
      if (tid == 0 && shift == 56 && suf < need) st.done = 1;
    }
    __syncthreads();
    if (st.done) break;                 // the same in every CTA
  }

  // ---- collect the selected keys into rank 0 -----------------------------
  {
    const unsigned long long prefix = st.prefix, mask = st.mask;
    int* count0 = &st.count;
    unsigned long long* key0 = ckey;
    if constexpr (G2 > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      count0 = cluster.map_shared_rank(&st.count, 0);
      key0 = cluster.map_shared_rank(ckey, 0);
    }
    const unsigned below = (1u << lane) - 1u;
    each_key([&](unsigned long long key, bool in) {
      const bool take = in && (key & mask) >= prefix;
      const unsigned ball = __ballot_sync(0xffffffffu, take);
      if (ball) {
        int pos = 0;
        if (lane == 0) pos = atomicAdd(count0, __popc(ball));
        pos = __shfl_sync(0xffffffffu, pos, 0) + __popc(ball & below);
        if (take && pos < kkp) key0[pos] = key;
      }
    });
  }
  if constexpr (G2 > 1) cg::this_cluster().sync();
  else __syncthreads();

  // ---- exact f32 rerank of this CTA's share of the kk, half a warp each --
  {
    const unsigned long long* key0 = ckey;
    float* cex0 = cex;
    int* cslot0 = cslot;
    if constexpr (G2 > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      key0 = cluster.map_shared_rank(ckey, 0);
      cex0 = cluster.map_shared_rank(cex, 0);
      cslot0 = cluster.map_shared_rank(cslot, 0);
    }
    const int per = (kk + G2 - 1) / G2;
    const int j0 = (int)rank * per, j1 = min(kk, j0 + per);
    const int half = lane >> 4, hl = lane & 15;
    const int nch = D / 4;
    for (int jb = j0 + 2 * warp; jb < j1; jb += 2 * SEL_WARPS) {
      const int j = jb + half;
      const unsigned long long key = j < j1 ? key0[j] : 0ull;
      float dot = 0.f, n2 = 0.f;
      long r = 0;
      int slot = -1;
      if (key != 0ull) {
        slot = max(a.cslot[key_index(key)], 0);
        r = slot < a.M ? slot : a.M - 1;
        const float4* row =
            reinterpret_cast<const float4*>(a.features + r * D);
        for (int ch0 = hl; ch0 < nch; ch0 += 16 * ROW_UNROLL) {
          float4 v[ROW_UNROLL];
#pragma unroll
          for (int u = 0; u < ROW_UNROLL; ++u) {
            const int ch = ch0 + 16 * u;
            if (ch < nch) v[u] = __ldg(row + ch);
          }
#pragma unroll
          for (int u = 0; u < ROW_UNROLL; ++u) {
            const int ch = ch0 + 16 * u;
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
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {   // within each half of the warp
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
        n2 += __shfl_xor_sync(0xffffffffu, n2, o);
      }
      if (hl == 0 && j < j1) {
        float ex = NEG_INF_F;
        if (key != 0ull) {
          const float cos = __fmul_rn(dot, rsqrtf(__fadd_rn(n2, 1e-12f)));
          const float tt = __fmul_rn(
              a.w_t, temporal_term(*a.step, a.timestamp[r], a.sps,
                                   a.inv_tau));
          ex = combined_score(a.w_cos, cos, tt, a.strength[r]);
        }
        cex0[j] = ex;
        cslot0[j] = slot;
      }
    }
  }
  if constexpr (G2 > 1) cg::this_cluster().sync();
  else __syncthreads();
  if (rank != 0) return;

  // ---- rank 0: merge B's k lanes and the annex's kk by counting ----------
  // entry i < k is B's lane i, entry k + j the annex's lane j; on equal
  // scores the larger tie key first: B's lanes (in lane order) above the
  // annex's coarse keys, a dead annex lane last (each tie key distinct)
  for (int i = tid; i < m; i += SEL_THREADS) {
    if (i < k) {
      mex[i] = a.b_s[(long)b * a.kpad + i];
      mslot[i] = a.b_slot[(long)b * a.kpad + i];
      mkey[i] = ~0ull - (unsigned long long)i;
    } else {
      const int j = i - k;
      mex[i] = cex[j];
      mslot[i] = cslot[j];
      mkey[i] = ckey[j] != 0ull ? ckey[j] : (unsigned long long)(kk - j);
    }
  }
  __syncthreads();
  int T = 32;
  while (T > 1 && T * m > SEL_THREADS) T >>= 1;
  for (int j0 = 0; j0 < m; j0 += SEL_THREADS / T) {
    const int j = j0 + tid / T;
    const bool valid = j < m;
    const float ej = valid ? mex[j] : 0.f;
    const unsigned long long kj = valid ? mkey[j] : 0ull;
    const int r = rank_desc(m, T, [&](int i) {
      const float ei = mex[i];
      return (ei > ej) | ((ei == ej) & (mkey[i] > kj));
    });
    if (valid && tid % T == 0 && r < k) {
      const bool hit = ej > DEAD;
      a.out_s[(long)b * k + r] = hit ? ej : NEG_INF_F;
      a.out_slot[(long)b * k + r] = hit ? mslot[j] : -1;
    }
  }
}

// Launch 1's dynamic shared memory: 1 KB to align it for the swizzle,
// the ring (with the queries' slices when they stream), the queries
// (when they do not), the warps' staged keys, the tile's row terms, each
// query's threshold state and histogram.
size_t annex_select_smem(int D, bool qstream) {
  return 1024 +
         (size_t)AX_STAGES * (AX_SUB_BYTES + (qstream ? AX_QSUB_BYTES : 0)) +
         (qstream ? 0 : (size_t)((D + 63) / 64) * AX_QSUB_BYTES) +
         AX_THREADS / 32 * 8 * 64 * 8 + 3 * AX_ROWS * 4 +
         (size_t)AX_NQ * (6 * 4 + AX_HSTRIDE * 4);
}

// The launch shape from B and N: tiles of 64 queries, then tiles per row
// chunk so that the grid holds about one CTA per SM: at B = 1-8 the rows
// are split over the SMs and bound the pass; at B = 1024 the 16 query
// tiles take the SMs, each chunk is long, so its threshold prunes most
// rows, and the products bound it.
struct AnnexPlan {
  int qtiles, tiles, nc;
};

AnnexPlan annex_plan(int B, int N, int n_sm) {
  AnnexPlan p;
  p.qtiles = (B + AX_NQ - 1) / AX_NQ;
  const long total = (N + AX_ROWS - 1) / AX_ROWS;
  p.tiles = (int)std::max(1L, (total * p.qtiles + n_sm - 1) / n_sm);
  p.nc = (int)((total + p.tiles - 1) / p.tiles);
  return p;
}

// The card's SM count and per-block shared memory limit (opt-in), read
// once.
int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) {
    cudaGetLastError();
    return fallback;
  }
  return v;
}

AnnexPlan plan_for(int B, int N) {
  static const int n_sm = device_attr(cudaDevAttrMultiProcessorCount, 132);
  return annex_plan(B, N, n_sm);
}


// Launches `kernel` after the previous one with programmatic stream
// serialisation (no cluster). Returns the launch's error, cleared.
template <typename Kernel, typename... Args>
cudaError_t launch_after(Kernel kernel, dim3 grid, int threads, size_t smem,
                         cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The queries stay in shared memory for the whole launch where they fit
// (D <= 768 on the H100), else they stream through the ring.
cudaError_t launch_annex_select(const AnnexArgs& a, dim3 grid,
                                cudaStream_t s) {
  static const size_t limit =
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 232448);
  const size_t held = annex_select_smem(a.D, false);
  if (held <= limit) {
    static size_t done = 0;
    const cudaError_t err = opt_in(annex_select_kernel<false>, held, &done);
    if (err != cudaSuccess) return err;
    annex_select_kernel<false><<<grid, AX_THREADS, held, s>>>(a);
    return cudaGetLastError();
  }
  static size_t done = 0;
  const size_t smem = annex_select_smem(a.D, true);
  const cudaError_t err = opt_in(annex_select_kernel<true>, smem, &done);
  if (err != cudaSuccess) return err;
  annex_select_kernel<true><<<grid, AX_THREADS, smem, s>>>(a);
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

// Bytes of workspace `annex_merge_launch` needs at (B, N): the kept keys of
// every (query, row chunk), R = tiles * 128 a list, then their counts.
extern "C" long annex_workspace_bytes(int B, int N) {
  const AnnexPlan p = plan_for(B, N);
  const long lists = (long)B * p.nc;
  return lists * p.tiles * AX_ROWS * 8 + lists * 4;
}

extern "C" int annex_merge_launch(
    const void* rows, const float* cdecay, const float* cts, const int* cgen,
    const int* cslot, const float* features, const float* strength,
    const float* timestamp, const float* step, const float* decay_accum,
    const int* count, const float* qn, const float* b_s, const int* b_slot,
    void* workspace, float* out_s, long long* out_slot, long M, int N,
    int D, int B,
    int kk, int k, int kpad, int max_memories, float w_cos, float w_t,
    float sps, float inv_tau, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const AnnexPlan p = plan_for(B, N);
  const long R = (long)p.tiles * AX_ROWS;
  AnnexArgs a;
  a.rows = static_cast<const __nv_bfloat16*>(rows);
  a.cdecay = cdecay; a.cts = cts; a.cgen = cgen; a.cslot = cslot;
  a.features = features; a.strength = strength; a.timestamp = timestamp;
  a.step = step; a.decay_accum = decay_accum; a.count = count;
  a.qn = qn; a.b_s = b_s; a.b_slot = b_slot;
  a.keys = static_cast<unsigned long long*>(workspace);
  a.n_keys = reinterpret_cast<int*>(a.keys + (long)B * p.nc * R);
  a.out_s = out_s; a.out_slot = out_slot;
  a.M = M; a.N = N; a.D = D; a.B = B; a.kk = kk; a.kkp = pow2_at_least(kk);
  a.k = k; a.kpad = kpad; a.nc = p.nc; a.tiles = p.tiles;
  a.max_memories = max_memories;
  a.w_cos = w_cos; a.w_t = w_t; a.sps = sps; a.inv_tau = inv_tau;
  const dim3 grid(p.qtiles, p.nc);
  cudaError_t err = launch_annex_select(a, grid, s);
  if (err != cudaSuccess) return (int)err;
  // rank 0's keys, the merge's tie keys, the CTA's keys, then the query,
  // the exact scores and slots, the merge's scores and slots, the CTA's
  // list lengths
  const int m = k + kk;
  static const int n_sm = device_attr(cudaDevAttrMultiProcessorCount, 132);
  const int g2 = B >= n_sm ? 1 : CLUSTER;
  const size_t smem2 = (size_t)(a.kkp + m + AX_SHARE) * 8 +
                       (size_t)(D + 2 * kk + 2 * m + (p.nc + g2 - 1) / g2) * 4;
  if (g2 == 1) {
    static size_t done = 0;
    err = opt_in(annex_rerank_kernel<1>, smem2, &done);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_after(annex_rerank_kernel<1>, dim3(B), SEL_THREADS,
                             smem2, s, a);
  }
  static size_t done = 0;
  err = opt_in(annex_rerank_kernel<CLUSTER>, smem2, &done);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster(annex_rerank_kernel<CLUSTER>,
                             dim3(B * CLUSTER), SEL_THREADS, smem2, true, s,
                             a);
}
