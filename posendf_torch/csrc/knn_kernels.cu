// Hand-written Hopper kernels for geodesic k-nearest-neighbour search (sm_90a).
//
// Replaces posendf_tpu/ops/fused_knn.py::_knn_kernel: for every query q the k
// corpus rows c with the smallest distance, ascending, with
//
//   engine 0 (exact)  d = sum_j w_j (1 - |<q_j, c_j>|)        fp32
//   engine 1 (bf16)   the same with q and c rounded to bf16    (TPU 'mxu_bf16')
//   engine 2 (bound)  d = W - sum_r q_r c_r over the 84 values (TPU 'mxu_fast')
//                     as the 3-pass bf16 split hi.hi' + hi.lo' + lo.hi'
//
// over (Q, 84) queries and (N, 84) corpus rows, row-major fp32 (21 joints x 4).
// The wrapper (ops/fused_knn.py) canonicalizes and folds the joint weights into
// the corpus for the bound engine, and passes w_j = 1/21 when unweighted.
//
// On the TPU the corpus axis was a sequential grid axis with the running
// best-k carried in VMEM; blocks on Hopper run in parallel and carry nothing,
// so each engine writes best-k lists of parts of the corpus to a (S', Q, KPAD)
// partial buffer (KPAD in {8, 16, 24, 32}, as the TPU kernel rounds k; a part
// that holds no row writes sentinels (FLT_MAX, INT_MAX)), and
// posendf_knn_merge, one thread per query, merges each query's S' sorted
// lists into the first k, writing fp32 distances and int64 indices. Every
// comparison orders by (distance, index), so the result is the same for any
// split and any run, with no atomics, and exact ties come lowest index first,
// as lax.top_k orders them in ops/knn.py::geodesic_topk.
//
// ---- the exact and bf16 engines (posendf_knn_partial) ----
// A block owns 128 queries, one thread each, and one of S contiguous ranges
// of the corpus (blockIdx.y); S' = S. It streams its range through shared
// memory in slabs of 64 rows (every thread reads the same row: broadcast
// reads) and keeps a sorted best-KPAD list in registers. They use
// __fmul_rn / __fadd_rn (no FMA contraction) in the TPU kernel's order: per
// joint the 4 products in d order, then 1 - |.|, then the weighted sum in
// joint order. Their distances are therefore the bits of the plain version
// (knn_topk_ref), on the card and on the CPU.
//
// What bounds them on an H100: the distance arithmetic on the fp32 CUDA
// cores, not memory. The function needs 8 operations per joint and pair (4
// products, 3 sums, |.| summed into the pair's total) and 2 per pair
// (1 - total / 21 as an FMA); without FMA contraction they issue 10
// instructions per joint and pair, each one slot of the pipe that an FMA
// would fill with two operations. The corpus is read once per query tile,
// mostly from L2.
//
// ---- the bound engine on the tensor cores (posendf_knn_pack, posendf_knn_bound) ----
// Bound on an H100 SXM at Q = 4,096, N = 2^20: three bf16 passes of the
// K = 84 product, 2.2e12 operations at 989 TFLOP/s: 2.19 ms (3 x 96 K
// padded: 2.5 ms); reading the corpus once 0.11 ms. So:
//  * posendf_knn_pack splits each corpus row once a call into bf16 hi =
//    bf16(x) and lo = bf16(x - hi), each padded from K = 84 to 96, and
//    stores [hi | lo] (192 bf16, 384 bytes: three 128-byte lines) in slabs
//    of 128 rows, each slab three K-major 128-byte-swizzled tiles
//    (hopper.cuh), 48 KB of contiguous bytes; rows past N are zeros. It
//    also takes the largest row norm, max |c|, for the filter's margin.
//  * posendf_knn_bound: a CTA owns 128 queries (two consumer warpgroups of
//    64) and one of S ranges of the corpus, a whole number of slabs. It
//    splits its queries into the same [hi | lo] layout in shared memory; its
//    first thread fills a 3-slot ring of slabs with cp.async.bulk under
//    full / empty mbarriers (each warp frees a slot once it has read the
//    slab). For each slab a warpgroup issues 18 wgmma
//    m64n128k16 bf16 products with fp32 accumulators, for s = 0..5 (k16
//    steps of K): q_hi[s].c_hi[s] + q_lo[s].c_hi[s] + q_hi[s].c_lo[s]; then
//    d = W - acc. The grid runs the query tiles fastest, so the 32 CTAs that
//    read one corpus range at Q = 4,096 run in one wave and share its slabs
//    in L2.
//  * Selection stays in registers: thread t of a warpgroup holds rows
//    (t % 32) / 4 + 16 (t / 32) and + 8 of its 64 queries and the columns
//    8 j + 2 (t % 4) + {0, 1} of each slab, and keeps a best-KPAD list per
//    row over its own columns, taken in ascending index order (so an equal
//    distance never displaces). Each thread's lists are one part: S' = 4 S.
//  * The tensor cores' sums filter; the lists hold the plain arithmetic.
//    bf16 products are exact in fp32, but the tensor cores accumulate in
//    another order and round otherwise than IEEE adds (a few units in the
//    last place of W), and a top-k of values that differ from the plain
//    version's can take another row wherever two rows lie that close. So a
//    first pass marks, without branches, the columns whose tensor-core d
//    lies below the list's last entry plus a margin, 2e-5 |q| max |c| +
//    2^-20 W: twice what the two sums can differ by (252 exact products whose
//    absolute values sum to at most ~|q| |c|, summed in 18 tensor-core
//    accumulations or 3 chains of 84 fp32 FMAs, each step off by at most
//    ~2 units in the last place); most slabs mark none. For a marked column
//    the thread recomputes d from its query and the slab in shared memory in
//    the plain version's arithmetic (three fp32 FMA chains over K in order,
//    then W - ((hh + hl) + lh)), and that value enters the list: the engine
//    returns the plain version's bits.
//  * Two accumulators: slab g + 1's products run on the tensor cores while
//    slab g is selected (for KPAD <= 16; the lists of KPAD 24 and 32 leave
//    registers for one). That needs more than the 168 registers a thread
//    that a block with a producer warp leaves, so there is none: the CTA's
//    first thread refills a slot once every warp has freed it.
//
// Each launcher returns cudaGetLastError(); no launcher synchronizes or
// allocates.

#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kJ = 21;         // joints
constexpr int kD = 4 * kJ;     // floats of one pose
constexpr int kQTile = 128;    // queries per block, one thread each
constexpr int kSlab = 64;      // corpus rows per shared-memory slab
constexpr float kBig = FLT_MAX;
constexpr int kIBig = INT_MAX;

enum Engine { kExact = 0, kBf16 = 1 };   // posendf_knn_partial's; the bound engine has its own kernel

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (d, i) before (e, j) in the result's order
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Put (d, i) into the sorted list in place of its last entry (which the caller
// has checked it comes before) and bubble it up. Indices stay compile-time
// constants after unrolling, so the list stays in registers.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (before(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
      const float td = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = td;
      const int ti = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = ti;
    }
  }
}

struct PartialArgs {
  const float* q;   // (Q, 84)
  int Q;
  const float* c;   // (N, 84)
  int N;
  const float* w;   // (21,) joint weights
  int range;        // corpus rows per blockIdx.y, a multiple of kSlab
  float* part_d;    // (S, Q, K)
  int* part_i;
};

template <int E, int K>
__global__ void __launch_bounds__(kQTile) knn_partial_kernel(PartialArgs a) {
  __shared__ __align__(16) float slab[kSlab * kD];
  __shared__ float ws[kJ];

  const int t = threadIdx.x;
  const int qi = blockIdx.x * kQTile + t;
  const bool active = qi < a.Q;
  if (t < kJ) ws[t] = a.w[t];

  // the query: fp32 values or bf16-rounded values
  float qv[kD];
  if (active) {
    const float4* q4 = reinterpret_cast<const float4*>(a.q + static_cast<size_t>(qi) * kD);
#pragma unroll
    for (int v = 0; v < kJ; ++v) {
      const float4 f = __ldg(q4 + v);
      const float x[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        qv[4 * v + d] = E == kBf16 ? bf16_round(x[d]) : x[d];
      }
    }
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = kIBig;
  }

  const int start = blockIdx.y * a.range;
  const int stop = min(a.N, start + a.range);
  for (int r0 = start; r0 < stop; r0 += kSlab) {
    const int rows = min(kSlab, stop - r0);
    __syncthreads();  // the previous slab is no longer read
    const float4* c4 = reinterpret_cast<const float4*>(a.c + static_cast<size_t>(r0) * kD);
    for (int e = t; e < rows * kJ; e += kQTile) {
      float4 f = __ldg(c4 + e);
      if constexpr (E == kBf16)
        f = make_float4(bf16_round(f.x), bf16_round(f.y), bf16_round(f.z), bf16_round(f.w));
      reinterpret_cast<float4*>(slab)[e] = f;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < rows; ++r) {
      const float4* row = reinterpret_cast<const float4*>(slab + r * kD);
      float dist = 0.f;
#pragma unroll
      for (int v = 0; v < kJ; ++v) {
        const float4 f = row[v];
        float dot = __fmul_rn(qv[4 * v], f.x);
        dot = __fadd_rn(dot, __fmul_rn(qv[4 * v + 1], f.y));
        dot = __fadd_rn(dot, __fmul_rn(qv[4 * v + 2], f.z));
        dot = __fadd_rn(dot, __fmul_rn(qv[4 * v + 3], f.w));
        const float term = __fmul_rn(ws[v], __fsub_rn(1.f, fabsf(dot)));
        dist = v == 0 ? term : __fadd_rn(dist, term);
      }
      // rows come in ascending index order, so an equal distance never displaces
      if (dist < bd[K - 1]) insert<K>(bd, bi, dist, r0 + r);
    }
  }
  if (!active) return;
  const size_t base = (static_cast<size_t>(blockIdx.y) * a.Q + qi) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    a.part_d[base + s] = bd[s];
    a.part_i[base + s] = bi[s];
  }
}

template <int K>
__global__ void __launch_bounds__(kQTile)
    knn_merge_kernel(const float* part_d, const int* part_i, int S, int Q, int k,
                     float* d_out, long long* i_out) {
  const int qi = blockIdx.x * kQTile + threadIdx.x;
  if (qi >= Q) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = kIBig;
  }
  for (int sp = 0; sp < S; ++sp) {
    const size_t base = (static_cast<size_t>(sp) * Q + qi) * K;
    for (int s = 0; s < K; ++s) {
      const float d = part_d[base + s];
      const int i = part_i[base + s];
      if (!before(d, i, bd[K - 1], bi[K - 1])) break;  // each list is sorted
      insert<K>(bd, bi, d, i);
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      d_out[static_cast<size_t>(qi) * k + s] = bd[s];
      i_out[static_cast<size_t>(qi) * k + s] = bi[s];
    }
  }
}

// ---- the bound engine ----

constexpr int kBQ = 128;                        // queries a CTA: two warpgroups x 64
constexpr int kBN = 128;                        // corpus rows a slab: the wgmma N
constexpr int kBChunks = 12;                    // 8-value chunks of K = 84 padded to 96
constexpr int kBTile = kBN * 128;               // one 128-byte K line of 128 rows: 16 KB
constexpr int kBSlab = 3 * kBTile;              // [hi | lo] of 128 rows: 48 KB
constexpr int kBStages = 3;
constexpr int kBThreads = 256;                  // two warpgroups: 255 registers a thread
constexpr int kBPackThreads = 256;
constexpr int kBPackBlocks = 2048;              // the pack's blocks stride over the rows
// queries | ring | barriers; 1024 to align
constexpr size_t kBoundSmem = 1024 + static_cast<size_t>(kBSlab) * (1 + kBStages) +
                              2 * kBStages * sizeof(uint64_t);

// byte offset of 8-value chunk ch (0..11: hi of K = 8 ch..; 12..23: lo) of
// row r in a 128-row tile of three swizzled 128-byte lines of K
__device__ __forceinline__ int bound_offset(int r, int ch) {
  return (ch >> 3) * kBTile + sw128_offset(r, (ch & 7) * 16);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// the hi and lo chunks (8 bf16 each, the first value in the low half) of
// values K = 8 c .. 8 c + 7 of a row (zeros past K = 84, or for row ==
// nullptr); returns the sum of their squares
__device__ __forceinline__ float split_chunk(const float* row, int c, uint4& hi, uint4& lo) {
  float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (row != nullptr && 8 * c < kD) {
    const float4 f0 = __ldg(reinterpret_cast<const float4*>(row + 8 * c));
    x[0] = f0.x; x[1] = f0.y; x[2] = f0.z; x[3] = f0.w;
    if (8 * c + 4 < kD) {
      const float4 f1 = __ldg(reinterpret_cast<const float4*>(row + 8 * c + 4));
      x[4] = f1.x; x[5] = f1.y; x[6] = f1.z; x[7] = f1.w;
    }
  }
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float h0 = bf16_round(x[2 * j]), h1 = bf16_round(x[2 * j + 1]);
    h[j] = bf16_bits(h0) | (bf16_bits(h1) << 16);
    l[j] = bf16_bits(x[2 * j] - h0) | (bf16_bits(x[2 * j + 1] - h1) << 16);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = fmaf(x[j], x[j], ss);
  return ss;
}

// Sixteen threads per row of the corpus padded to whole slabs, one per
// chunk (12 of them busy), so that neighbouring threads read neighbouring
// bytes, the warps striding over the rows; the largest row norm goes to
// *cmax (non-negative floats order as their bits), one atomic a warp.
__global__ void __launch_bounds__(kBPackThreads) knn_pack_kernel(const float* c, int N, int slabs,
                                                                 unsigned char* out, float* cmax) {
  const int lane = threadIdx.x % 32, total = slabs * kBN * 16;
  float norm = 0.f;
  for (int w0 = blockIdx.x * kBPackThreads + threadIdx.x - lane; w0 < total;
       w0 += gridDim.x * kBPackThreads) {
    const int row = (w0 + lane) / 16, ch = lane % 16;
    float ss = 0.f;
    if (ch < kBChunks) {
      uint4 hi, lo;
      ss = split_chunk(row < N ? c + static_cast<size_t>(row) * kD : nullptr, ch, hi, lo);
      unsigned char* slab = out + static_cast<size_t>(row / kBN) * kBSlab;
      *reinterpret_cast<uint4*>(slab + bound_offset(row % kBN, ch)) = hi;
      *reinterpret_cast<uint4*>(slab + bound_offset(row % kBN, kBChunks + ch)) = lo;
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);   // the row's sum
    norm = fmaxf(norm, sqrtf(ss));
  }
  norm = fmaxf(norm, __shfl_xor_sync(0xffffffffu, norm, 16));
  if (lane == 0) atomicMax(reinterpret_cast<int*>(cmax), __float_as_int(norm));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// d of query row r (of the CTA's tile qs) and corpus row c (of the slab) in
// the plain version's arithmetic: the three products' fp32 FMA chains over
// K in order (exact products of bf16 values), then W - ((hh + hl) + lh)
__device__ __forceinline__ float bound_exact(const unsigned char* qs, int r,
                                             const unsigned char* slab, int c, float w) {
  float hh = 0.f, hl = 0.f, lh = 0.f;
#pragma unroll 1
  for (int ch = 0; ch * 8 < kD; ++ch) {
    const uint4 qh4 = *reinterpret_cast<const uint4*>(qs + bound_offset(r, ch));
    const uint4 ql4 = *reinterpret_cast<const uint4*>(qs + bound_offset(r, kBChunks + ch));
    const uint4 ch4 = *reinterpret_cast<const uint4*>(slab + bound_offset(c, ch));
    const uint4 cl4 = *reinterpret_cast<const uint4*>(slab + bound_offset(c, kBChunks + ch));
    const uint32_t qh[4] = {qh4.x, qh4.y, qh4.z, qh4.w}, ql[4] = {ql4.x, ql4.y, ql4.z, ql4.w};
    const uint32_t chh[4] = {ch4.x, ch4.y, ch4.z, ch4.w}, cl[4] = {cl4.x, cl4.y, cl4.z, cl4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (8 * ch + 2 * u < kD) {   // K = 84 is even: both values of a pair, or neither
        hh = fmaf(bf16_lo(qh[u]), bf16_lo(chh[u]), hh);
        hl = fmaf(bf16_lo(qh[u]), bf16_lo(cl[u]), hl);
        lh = fmaf(bf16_lo(ql[u]), bf16_lo(chh[u]), lh);
        hh = fmaf(bf16_hi(qh[u]), bf16_hi(chh[u]), hh);
        hl = fmaf(bf16_hi(qh[u]), bf16_hi(cl[u]), hl);
        lh = fmaf(bf16_hi(ql[u]), bf16_hi(chh[u]), lh);
      }
    }
  }
  return __fsub_rn(w, __fadd_rn(__fadd_rn(hh, hl), lh));
}

// One of the thread's two rows (query row r of the tile): the marked
// columns (bits of m, those whose tensor-core d fell below the list's last
// entry plus the margin when the slab began) enter the list in ascending
// column order, each with d in the plain arithmetic.
template <int K>
__device__ __forceinline__ void select_row(uint32_t m, const unsigned char* qs, int r,
                                           const unsigned char* slab, int c0, int base, float w,
                                           float (&bd)[K], int (&bi)[K]) {
  while (m) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    const int c = c0 + 8 * (j / 2) + j % 2;
    const float d = bound_exact(qs, r, slab, c, w);
    if (d < bd[K - 1]) insert<K>(bd, bi, d, base + c);
  }
}

struct BoundArgs {
  const float* q;                // (Q, 84)
  int Q;
  const unsigned char* packed;   // knn_pack_kernel's slabs
  const float* cmax;             // the corpus's largest row norm
  int N;
  float w_total;                 // W
  int range;                     // corpus rows per blockIdx.y, a multiple of kBN
  float* part_d;                 // (4 S, Q, K)
  int* part_i;
};

template <int K>
__global__ void __launch_bounds__(kBThreads, 1) knn_bound_kernel(const BoundArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + kBSlab;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kBStages * kBSlab);
  const int start = blockIdx.y * a.range;
  const int stop = min(a.N, start + a.range);
  const int slabs = start < stop ? (stop - start + kBN - 1) / kBN : 0;
  init_ring(bars, kBStages, 1, kBThreads / 32);
  auto refill = [&](int g) {   // slab g into its slot, once every warp has freed it
    if (threadIdx.x == 0 && g < slabs)
      produce(bars, kBStages, ring, kBSlab, g,
              a.packed + static_cast<size_t>(start / kBN + g) * kBSlab, kBSlab);
  };
  for (int g = 0; g < kBStages; ++g) refill(g);
  const int t = threadIdx.x, wg = t / 128, tw = t % 128;
  const int q0 = blockIdx.x * kBQ;
  for (int v = t; v < kBQ * kBChunks; v += kBThreads) {
    const int r = v / kBChunks, c = v % kBChunks;
    uint4 hi, lo;
    split_chunk(q0 + r < a.Q ? a.q + static_cast<size_t>(q0 + r) * kD : nullptr, c, hi, lo);
    *reinterpret_cast<uint4*>(qs + bound_offset(r, c)) = hi;
    *reinterpret_cast<uint4*>(qs + bound_offset(r, kBChunks + c)) = lo;
  }
  fence_proxy_async();
  __syncthreads();

  // the thread's two rows of the tile and their filter margins
  const int r0 = 64 * wg + 16 * (tw / 32) + (tw % 32) / 4, r1 = r0 + 8;
  float margin0, margin1;
  {
    float ss0 = 0.f, ss1 = 0.f;
    uint4 hi, lo;
    for (int c = 0; c < kBChunks; ++c) {
      ss0 += split_chunk(q0 + r0 < a.Q ? a.q + static_cast<size_t>(q0 + r0) * kD : nullptr, c, hi, lo);
      ss1 += split_chunk(q0 + r1 < a.Q ? a.q + static_cast<size_t>(q0 + r1) * kD : nullptr, c, hi, lo);
    }
    const float cmax = *a.cmax, wpart = ldexpf(fabsf(a.w_total), -20);
    margin0 = 2e-5f * sqrtf(ss0) * cmax + wpart;
    margin1 = 2e-5f * sqrtf(ss1) * cmax + wpart;
  }
  float d0[K], d1[K];   // the lists of the thread's two rows
  int i0[K], i1[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d0[s] = d1[s] = kBig;
    i0[s] = i1[s] = kIBig;
  }
  // this warpgroup's 64 rows start 64 x 128 bytes into each line of the tile
  const uint32_t qa = smem_u32(qs) + wg * (64 * 128);

  // slab g's 18 products into acc, committed as one group
  auto issue = [&](float(&acc)[64], int g) {
    const uint32_t cb = smem_u32(ring + await_slab(bars, kBStages, g) * kBSlab);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 6; ++st) {
      // k16 step st: chunk pair 2 st of the hi part, chunk pair 12 + 2 st of the lo part
      const uint32_t hi_off = (st >> 2) * kBTile + (st & 3) * 32;
      const uint32_t lo_off = ((st + 6) >> 2) * kBTile + ((st + 6) & 3) * 32;
      wgmma_m64n128k16_bf16(acc, desc_sw128(qa + hi_off), desc_sw128(cb + hi_off), st != 0);
      wgmma_m64n128k16_bf16(acc, desc_sw128(qa + lo_off), desc_sw128(cb + hi_off), 1);
      wgmma_m64n128k16_bf16(acc, desc_sw128(qa + hi_off), desc_sw128(cb + lo_off), 1);
    }
    wgmma_commit();
  };
  // slab g (its products done) into the lists; then the warp frees its slot
  auto take = [&](float(&acc)[64], int g) {
    fence_regs(acc);
    const int s = g % kBStages;
    const unsigned char* slab = ring + s * kBSlab;
    // register i: row (i / 2) % 2 of the thread's two, column 8 (i / 4) + 2 (tw % 4) + i % 2
    const int base = start + g * kBN;
    if (base + kBN > stop) {   // the corpus's last slab: rows past N never enter a list
      const int lim = stop - base - 2 * (tw % 4);
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + i % 2 >= lim) acc[i] = -INFINITY;   // d = +inf
    }
    const float t0 = d0[K - 1] + margin0, t1 = d1[K - 1] + margin1;
    uint32_t m0 = 0, m1 = 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float d = __fsub_rn(a.w_total, acc[i]);
      const int j = (i / 4) * 2 + i % 2;
      if ((i / 2) % 2 == 0)
        m0 |= static_cast<uint32_t>(d < t0) << j;
      else
        m1 |= static_cast<uint32_t>(d < t1) << j;
    }
    if (m0) select_row<K>(m0, qs, r0, slab, 2 * (tw % 4), base, a.w_total, d0, i0);
    if (m1) select_row<K>(m1, qs, r1, slab, 2 * (tw % 4), base, a.w_total, d1, i1);
    __syncwarp();
    if (t % 32 == 0) mbar_arrive(smem_u32(bars + kBStages + s));
    refill(g + kBStages);
  };
  float acc0[64];
  if constexpr (K <= 16) {
    float acc1[64];
    if (slabs > 0) issue(acc0, 0);
    for (int g = 0; g < slabs; g += 2) {
      if (g + 1 < slabs) {
        issue(acc1, g + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      take(acc0, g);
      if (g + 1 < slabs) {
        if (g + 2 < slabs) {
          issue(acc0, g + 2);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        take(acc1, g + 1);
      }
    }
  } else {
    for (int g = 0; g < slabs; ++g) {
      issue(acc0, g);
      wgmma_wait<0>();
      take(acc0, g);
    }
  }
  const int row = q0 + r0;
  const size_t part = static_cast<size_t>(blockIdx.y) * 4 + tw % 4;
  if (row < a.Q) {
    const size_t b = (part * a.Q + row) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      a.part_d[b + s] = d0[s];
      a.part_i[b + s] = i0[s];
    }
  }
  if (row + 8 < a.Q) {
    const size_t b = (part * a.Q + row + 8) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      a.part_d[b + s] = d1[s];
      a.part_i[b + s] = i1[s];
    }
  }
}

template <int K>
int launch_bound(const BoundArgs& a, int S, cudaStream_t stream) {
  return launch_wgmma(knn_bound_kernel<K>, dim3((a.Q + kBQ - 1) / kBQ, S), kBThreads, kBoundSmem,
                      stream, a);
}

template <int E, int K>
int launch_partial(const PartialArgs& a, int S, cudaStream_t stream) {
  const dim3 grid((a.Q + kQTile - 1) / kQTile, S);
  knn_partial_kernel<E, K><<<grid, kQTile, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int E>
int partial_for_kpad(const PartialArgs& a, int kpad, int S, cudaStream_t stream) {
  switch (kpad) {
    case 8: return launch_partial<E, 8>(a, S, stream);
    case 16: return launch_partial<E, 16>(a, S, stream);
    case 24: return launch_partial<E, 24>(a, S, stream);
    case 32: return launch_partial<E, 32>(a, S, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows of the corpus per split: ceil(N / S) rounded up to whole slabs.
int split_rows(int N, int S) {
  const int per = (N + S - 1) / S;
  return (per + kSlab - 1) / kSlab * kSlab;
}

}  // namespace

extern "C" {

// The top-k launch of the exact and bf16 engines: part_d / part_i are
// (S, Q, kpad).
int posendf_knn_partial(const float* q, int Q, const float* c, int N, const float* w,
                        int engine, int kpad, int S, float* part_d, int* part_i, void* stream) {
  if (Q <= 0) return 0;
  PartialArgs a{q, Q, c, N, w, split_rows(N, S), part_d, part_i};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case kExact: return partial_for_kpad<kExact>(a, kpad, S, s);
    case kBf16: return partial_for_kpad<kBf16>(a, kpad, S, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bound engine's corpus, (N, 84) fp32 -> ceil(N / 128) slabs of 48 KB
// (posendf_knn_bound_bytes), and its largest row norm into *cmax (which the
// caller sets to 0).
int posendf_knn_pack(const float* c, int N, void* packed, float* cmax, void* stream) {
  if (N <= 0) return 0;
  const int rows = (N + kBN - 1) / kBN * kBN;
  const int blocks = min((16 * rows + kBPackThreads - 1) / kBPackThreads, kBPackBlocks);
  knn_pack_kernel<<<blocks, kBPackThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(c, N, rows / kBN,
                                                         static_cast<unsigned char*>(packed), cmax);
  return static_cast<int>(cudaGetLastError());
}

int posendf_knn_bound_bytes(int N) { return (N + kBN - 1) / kBN * kBSlab; }

// The bound engine's top-k launch over the packed corpus: part_d / part_i are
// (4 S, Q, kpad).
int posendf_knn_bound(const float* q, int Q, const void* packed, const float* cmax, int N,
                      float w_total, int kpad, int S, float* part_d, int* part_i, void* stream) {
  if (Q <= 0) return 0;
  const int per = (N + S - 1) / S;
  BoundArgs a{q, Q, static_cast<const unsigned char*>(packed), cmax, N, w_total,
              (per + kBN - 1) / kBN * kBN, part_d, part_i};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kpad) {
    case 8: return launch_bound<8>(a, S, s);
    case 16: return launch_bound<16>(a, S, s);
    case 24: return launch_bound<24>(a, S, s);
    case 32: return launch_bound<32>(a, S, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The merge launch: the first k of each query's S sorted lists, ascending.
int posendf_knn_merge(const float* part_d, const int* part_i, int S, int Q, int kpad, int k,
                      float* d_out, long long* i_out, void* stream) {
  if (Q <= 0) return 0;
  const int blocks = (Q + kQTile - 1) / kQTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kpad) {
    case 8: knn_merge_kernel<8><<<blocks, kQTile, 0, s>>>(part_d, part_i, S, Q, k, d_out, i_out); break;
    case 16: knn_merge_kernel<16><<<blocks, kQTile, 0, s>>>(part_d, part_i, S, Q, k, d_out, i_out); break;
    case 24: knn_merge_kernel<24><<<blocks, kQTile, 0, s>>>(part_d, part_i, S, Q, k, d_out, i_out); break;
    case 32: knn_merge_kernel<32><<<blocks, kQTile, 0, s>>>(part_d, part_i, S, Q, k, d_out, i_out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* posendf_knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
