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
// ---- the exact and bf16 engines on the tensor cores (posendf_knn_pack_joint, posendf_knn_joint) ----
// The function: per pair 21 per-joint dots of 4 products, |.|, the weighted
// sum; the plain version (knn_topk_ref) rounds every product and sum on its
// own (no FMA) in that order, and the engines must return its bits. On the
// fp32 CUDA cores, a thread a query, that is ~10 issue slots a joint and
// pair (47 ms at Q = 4,096 x N = 2^20 on an H100). Bound on an H100 SXM on
// the tensor cores at that shape: the split products the exact engine needs,
// 3 x 2 x 84 bf16 operations a pair at 989 TFLOP/s, 2.19 ms (the bf16
// engine's one product 0.73 ms); the epilogue d -= w_j |dot_j|, 21 FFMA a
// pair at 67 TFLOP/s, 2.69 ms, which bounds both; the fp32 operands once,
// 0.11 ms. Measured (ops/breakdown.py; PERF.md section 5): the products hide
// under the slabs' intake from L2, and the epilogue with its per-slab tests
// sets the pace, then the recomputes of the marked columns. So:
//  * posendf_knn_pack_joint splits each corpus row once a call, per joint j,
//    into one bf16 k16 group [ch_j | ch_j | cl_j | 0] (ch = bf16(c), cl =
//    bf16(c - ch); 32 bytes a joint, 672 a row) in slabs of 64 rows, each
//    slab 21 K-major 32-byte-swizzled tiles of 2 KB, one a joint
//    (hopper.cuh), 43,008 contiguous bytes; rows past N are zeros. It also
//    takes the largest |c_j| of each joint, for the filter's margin. The
//    bf16 engine's operand bf16(c) is ch, so one pack serves both engines.
//  * posendf_knn_joint: a CTA owns 128 queries (two consumer warpgroups of
//    64) and one of S ranges of the corpus, a whole number of slabs. It
//    stores its queries' A groups in the same layout: [qh | ql | qh | 0]
//    (exact: one k16 step gives qh.ch + ql.ch + qh.cl) or [qh | 0 | 0 | 0]
//    (bf16: qh.ch, the bf16 engine's products, exact in fp32). Its first
//    thread keeps a 3-slot ring of slabs filled by cp.async.bulk under full /
//    empty mbarriers (each warp frees a slot once its products are done;
//    slab g + 2 goes into the slot of slab g - 1 as soon as slab g has
//    landed, so a copy has two slabs' compute to arrive, and a warpgroup
//    may lag the other by a slab before the producer waits). Shared memory:
//    the A groups of 128 queries 84 KB + 3 slabs of 64 rows 126 KB + the
//    held-back columns 12 KB; 128-row slabs (84 KB) would leave room for
//    one stage.
//  * Per slab a warpgroup issues 21 wgmma m64n64k16, one a joint, each into
//    a fresh accumulator, joint j + 1 before joint j's epilogue (two
//    accumulators, wgmma_wait<1>), so the tensor cores and the FFMA pipe
//    overlap; the epilogue is d = fmaf(-w_j, |acc|, d) from d = W (the
//    weights are kernel parameters, FFMA operands from the constant bank).
//  * Selection as in the bound engine: thread t of a warpgroup holds rows
//    (t % 32) / 4 + 16 (t / 32) and + 8 of its 64 queries and the columns
//    8 j + 2 (t % 4) + {0, 1} of each slab, and keeps a best-KPAD list per
//    row over its own columns, taken in ascending index order (an equal
//    distance never displaces); each thread's lists are one part: S' = 4 S.
//    The filter's threshold is the k-th smallest distance in the four lists
//    of the row's quad (lanes 4 i .. 4 i + 3 hold the same rows): k entries
//    lie at or below it, so a column above it is not in the top k. It is
//    recomputed (a k-step merge of the lists' heads by shuffles) only when
//    the warp has entered columns; a list may then hold fewer than its
//    part's best rows, and the merge is unchanged.
//  * The tensor cores' value filters; the lists hold the plain arithmetic.
//    A column is marked when its tensor-core d <= threshold + margin, the
//    margin at least twice the largest |d_tc - d_plain|; a column that is
//    not marked has d_plain > threshold, so it is not in the top k. Each
//    marked column is recomputed in the plain version's order (__fmul_rn /
//    __fadd_rn) from the fp32 query and corpus rows in global memory
//    (rounded to bf16 for the bf16 engine), and only that value enters a
//    list, so the engines return the plain version's bits.
//  * Held back: a warpgroup's four warps meet at every wgmma, so a lone
//    recompute in one lane stalls 128 threads. The marked columns wait in
//    a queue of 12 a thread, in the order they were marked, until some
//    lane's would overflow (or the range ends); then the warp enters them
//    all, its lanes' recomputes side by side. The thresholds lag by the
//    held columns, so the marks are a superset, and each list still takes
//    its columns in ascending order. A slab that marks more than 12 of a
//    thread's columns (a list still filling) enters them at once.
//  * The margin. u = 2^-24, b = 2^-8 (bf16's unit roundoff), per joint
//    P_j = sum_d |q_d c_d|. (1) The split: q = qh + ql + eq with |q - qh| <=
//    b|q|, |ql| <= (1 + b) b |q|, |eq| <= b^2 |q|; q c - (qh ch + ql ch +
//    qh cl) = ql cl + qh ec + eq ch + (terms of b^3), at most 3.03 b^2 |q c|,
//    so 3.03 2^-16 P_j (the exact engine; 0 for bf16, whose products are the
//    plain version's). (2) The tensor cores' sum of 16 exact products: at
//    most 15 steps of one unit in the last place (2u, truncation) of sums
//    bounded by 1.03 P_j: below 2^-18 P_j. (3) The plain dot: gamma_4 P_j
//    <= 2^-22 P_j. (4) The epilogues: the plain 1 - |.|, w_j x and 20 sums
//    are at most 22.1 u sum_j |w_j| (1 + |dot_j|); W rounded once and 21
//    FMAs at most 22 u (Wa + 1.001 sum_j |w_j| P_j); the reassociation
//    W - sum_j w_j |dot_j| = sum_j w_j (1 - |dot_j|) is exact in real
//    arithmetic. With S = sum_j |w_j| |q_j| max|c_j| >= sum_j |w_j| P_j
//    (Cauchy-Schwarz) and Wa = sum_j |w_j|:
//      |d_tc - d_plain| <= (3.03 2^-16 + 2^-18 + 2^-22 + 44.3 u) S + 44.2 u Wa
//                        =  5.30e-5 S + 2.64e-6 Wa      (exact engine)
//                        =  6.69e-6 S + 2.64e-6 Wa      (bf16; S of qh, (1 + b) max|c_j|)
//    and the margin is 1.1e-4 S + 6e-6 Wa (exact), 1.5e-5 S + 6e-6 Wa (bf16),
//    more than twice that (fused_knn.joint_margin is its plain version;
//    tests/test_torch_knn_joint.py holds a float64 model to half of it).
//  * The corpus's last slab: rows past N get d = NaN and are never marked.
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
constexpr int kQTile = 128;    // queries per block of the merge, one thread each
constexpr float kBig = FLT_MAX;
constexpr int kIBig = INT_MAX;

enum Engine { kExact = 0, kBf16 = 1 };   // posendf_knn_joint's; the bound engine has its own kernel

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

// ---- the exact and bf16 engines ----

constexpr int kJQ = 128;                        // queries a CTA: two warpgroups x 64
constexpr int kJN = 64;                         // corpus rows a slab: the wgmma N
constexpr int kJTile = kJN * 32;                // one joint's k16 groups of a slab: 2 KB
constexpr int kJSlab = kJ * kJTile;             // a slab, 21 joints: 43,008 bytes
constexpr int kJQTile = kJQ * 32;               // one joint's k16 groups of the CTA's queries: 4 KB
constexpr int kJStages = 3;
constexpr int kJPend = 12;                      // marked columns a thread holds back
constexpr int kJThreads = 256;                  // two warpgroups: 255 registers a thread
constexpr int kJPackThreads = 256;
constexpr int kJPackBlocks = 4096;              // the pack's blocks stride over the slabs
// queries | ring | held-back columns | barriers; 1024 to align
constexpr size_t kJointSmem = 1024 + static_cast<size_t>(kJ) * kJQTile +
                              static_cast<size_t>(kJStages) * kJSlab +
                              static_cast<size_t>(kJPend) * kJThreads * sizeof(uint32_t) +
                              2 * kJStages * sizeof(uint64_t);
// the filter's margin, kMargin S + kMarginW Wa (derived in the comment at the top)
constexpr float kMarginExact = 1.1e-4f;
constexpr float kMarginBf16 = 1.5e-5f;
constexpr float kMarginW = 6e-6f;

// bf16 bits of 4 values, two a word, the first in the low half
__device__ __forceinline__ uint2 bf16x4(float a, float b, float c, float d) {
  return make_uint2(bf16_bits(a) | (bf16_bits(b) << 16), bf16_bits(c) | (bf16_bits(d) << 16));
}

// One block a slab (the blocks stride over the slabs): the slab's 64 rows
// into shared memory with 16-byte loads, then each thread writes the group
// [ch | ch | cl | 0] (two 16-byte chunks) of consecutive rows of one joint,
// so that both the reads and the writes are contiguous; rows past N are
// zeros. A thread's pairs p = threadIdx.x + 256 i are joint p / 64 of row
// p % 64, the same joints in every slab, so it keeps their largest |c_j|
// in registers; each joint's goes into cmax[j] (non-negative floats order
// as their bits), one atomic a joint and block.
__global__ void __launch_bounds__(kJPackThreads) knn_pack_joint_kernel(const float* c, int N, int slabs,
                                                                       unsigned char* out, float* cmax) {
  constexpr int kPairs = kJN * kJ, kEach = (kPairs + kJPackThreads - 1) / kJPackThreads;
  __shared__ float4 rows[kPairs];   // 21,504 bytes
  __shared__ int cm[kJ];
  if (threadIdx.x < kJ) cm[threadIdx.x] = 0;
  float norm[kEach];
#pragma unroll
  for (int e = 0; e < kEach; ++e) norm[e] = 0.f;
  for (int sl = blockIdx.x; sl < slabs; sl += gridDim.x) {
    const int r0 = sl * kJN;
    __syncthreads();   // the previous slab's rows are read
    for (int v = threadIdx.x; v < kPairs; v += kJPackThreads)
      rows[v] = r0 + v / kJ < N
                    ? __ldg(reinterpret_cast<const float4*>(c) + static_cast<size_t>(r0) * kJ + v)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    unsigned char* slab = out + static_cast<size_t>(sl) * kJSlab;
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int p = threadIdx.x + e * kJPackThreads;
      if (p < kPairs) {
        const int j = p / kJN, r = p % kJN;
        const float4 f = rows[r * kJ + j];
        const float h0 = bf16_round(f.x), h1 = bf16_round(f.y), h2 = bf16_round(f.z),
                    h3 = bf16_round(f.w);
        const uint2 hi = bf16x4(h0, h1, h2, h3);
        const uint2 lo = bf16x4(f.x - h0, f.y - h1, f.z - h2, f.w - h3);
        unsigned char* tile = slab + j * kJTile;
        *reinterpret_cast<uint4*>(tile + sw32_offset(r, 0)) = make_uint4(hi.x, hi.y, hi.x, hi.y);
        *reinterpret_cast<uint4*>(tile + sw32_offset(r, 16)) = make_uint4(lo.x, lo.y, 0u, 0u);
        norm[e] = fmaxf(norm[e], sqrtf(fmaf(f.w, f.w, fmaf(f.z, f.z, fmaf(f.y, f.y, f.x * f.x)))));
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kEach; ++e) {
    const int p = threadIdx.x + e * kJPackThreads;
    if (p < kPairs) atomicMax(&cm[p / kJN], __float_as_int(norm[e]));
  }
  __syncthreads();
  if (threadIdx.x < kJ) atomicMax(reinterpret_cast<int*>(cmax) + threadIdx.x, cm[threadIdx.x]);
}

struct JointArgs {
  const float* q;                // (Q, 84)
  int Q;
  const float* c;                // (N, 84): the exact engine's recomputes
  const unsigned char* packed;   // knn_pack_joint_kernel's slabs
  const float* cmax;             // (21,) the corpus's largest |c_j| of each joint
  int N;
  int k;                         // the filter's rank: the k-th entry of a list
  int range;                     // corpus rows per blockIdx.y, a multiple of kJN
  float w_total;                 // W = sum_j w_j, rounded once
  float w_abs;                   // Wa = sum_j |w_j|
  float w[kJ];                   // w_j
  float nw[kJ];                  // -w_j
  float* part_d;                 // (4 S, Q, K)
  int* part_i;
};

// d of query row q and corpus row c (fp32, global memory) in the plain
// version's arithmetic: per joint the 4 products in d order, then 1 - |.|,
// then w_j x, summed in joint order, each operation rounded on its own; the
// bf16 engine's on the values rounded to bf16, whose products are exact
template <int E>
__device__ __forceinline__ float plain_dist(const float* q, const float* c, const JointArgs& a) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* c4 = reinterpret_cast<const float4*>(c);
  float dist = 0.f;
#pragma unroll
  for (int v = 0; v < kJ; ++v) {
    float4 g = __ldg(q4 + v), f = __ldg(c4 + v);
    if constexpr (E == kBf16) {
      g = make_float4(bf16_round(g.x), bf16_round(g.y), bf16_round(g.z), bf16_round(g.w));
      f = make_float4(bf16_round(f.x), bf16_round(f.y), bf16_round(f.z), bf16_round(f.w));
    }
    float dot = __fmul_rn(g.x, f.x);
    dot = __fadd_rn(dot, __fmul_rn(g.y, f.y));
    dot = __fadd_rn(dot, __fmul_rn(g.z, f.z));
    dot = __fadd_rn(dot, __fmul_rn(g.w, f.w));
    const float term = __fmul_rn(a.w[v], __fsub_rn(1.f, fabsf(dot)));
    dist = v == 0 ? term : __fadd_rn(dist, term);
  }
  return dist;
}

// the filter's margin of query row q (nullptr: a row past Q)
template <int E>
__device__ __forceinline__ float joint_margin(const float* q, const JointArgs& a) {
  if (q == nullptr) return 0.f;
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < kJ; ++v) {
    float4 f = __ldg(reinterpret_cast<const float4*>(q) + v);
    if constexpr (E == kBf16)
      f = make_float4(bf16_round(f.x), bf16_round(f.y), bf16_round(f.z), bf16_round(f.w));
    const float n = sqrtf(fmaf(f.w, f.w, fmaf(f.z, f.z, fmaf(f.y, f.y, f.x * f.x))));
    s = fmaf(fabsf(a.w[v]) * n, __ldg(a.cmax + v), s);
  }
  return (E == kExact ? kMarginExact : kMarginBf16) * s + kMarginW * a.w_abs;
}

template <int E, int K>
__global__ void __launch_bounds__(kJThreads, 1) knn_joint_kernel(const JointArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + kJ * kJQTile;
  uint32_t* held_cols = reinterpret_cast<uint32_t*>(ring + kJStages * kJSlab);
  uint64_t* bars = reinterpret_cast<uint64_t*>(held_cols + kJPend * kJThreads);
  const int start = blockIdx.y * a.range;
  const int stop = min(a.N, start + a.range);
  const int slabs = start < stop ? (stop - start + kJN - 1) / kJN : 0;
  init_ring(bars, kJStages, 1, kJThreads / 32);
  auto refill = [&](int g) {   // slab g into its slot, once every warp has freed it
    if (threadIdx.x == 0 && g < slabs)
      produce(bars, kJStages, ring, kJSlab, g,
              a.packed + static_cast<size_t>(start / kJN + g) * kJSlab, kJSlab);
  };
  for (int g = 0; g < kJStages - 1; ++g) refill(g);
  const int t = threadIdx.x, wg = t / 128, tw = t % 128;
  const int q0 = blockIdx.x * kJQ;
  // the CTA's A groups: [qh | ql | qh | 0] (exact) or [qh | 0 | 0 | 0] (bf16)
  for (int v = t; v < kJQ * kJ; v += kJThreads) {
    const int r = v / kJ, j = v % kJ;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < a.Q) f = __ldg(reinterpret_cast<const float4*>(a.q + static_cast<size_t>(q0 + r) * kD) + j);
    const float h0 = bf16_round(f.x), h1 = bf16_round(f.y), h2 = bf16_round(f.z), h3 = bf16_round(f.w);
    const uint2 hi = bf16x4(h0, h1, h2, h3);
    uint4 chunk0 = make_uint4(hi.x, hi.y, 0u, 0u), chunk1 = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (E == kExact) {
      const uint2 lo = bf16x4(f.x - h0, f.y - h1, f.z - h2, f.w - h3);
      chunk0.z = lo.x;
      chunk0.w = lo.y;
      chunk1 = make_uint4(hi.x, hi.y, 0u, 0u);
    }
    unsigned char* tile = qs + j * kJQTile;
    *reinterpret_cast<uint4*>(tile + sw32_offset(r, 0)) = chunk0;
    *reinterpret_cast<uint4*>(tile + sw32_offset(r, 16)) = chunk1;
  }
  fence_proxy_async();
  __syncthreads();

  // the thread's two rows of the CTA, their fp32 rows and filter margins
  const int r0 = 64 * wg + 16 * (tw / 32) + (tw % 32) / 4, r1 = r0 + 8;
  const float* q_r0 = q0 + r0 < a.Q ? a.q + static_cast<size_t>(q0 + r0) * kD : nullptr;
  const float* q_r1 = q0 + r1 < a.Q ? a.q + static_cast<size_t>(q0 + r1) * kD : nullptr;
  const float margin0 = joint_margin<E>(q_r0, a), margin1 = joint_margin<E>(q_r1, a);
  float d0[K], d1[K];   // the lists of the thread's two rows
  int i0[K], i1[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d0[s] = d1[s] = kBig;
    i0[s] = i1[s] = kIBig;
  }
  // The k-th smallest distance in the four lists of a row's quad (lanes
  // 4 i .. 4 i + 3 hold the same rows): k entries lie at or below it, so a
  // column above it is not in the top k. A k-step merge of the lists' heads.
  auto quad_kth = [&](const float(&bd)[K]) {
    const unsigned quad = 0xfu << (t % 32 & ~3);
    int pos = 0;   // this lane's next entry
    float v = kBig;
    for (int r = 0; r < a.k; ++r) {
      float head = kBig;
#pragma unroll
      for (int e = 0; e < K; ++e) head = e == pos ? bd[e] : head;
      v = fminf(head, __shfl_xor_sync(0xffffffffu, head, 1));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const unsigned holds = __ballot_sync(0xffffffffu, head == v) & quad;
      if (__ffs(holds) - 1 == t % 32) ++pos;   // one lane of those at v steps on
    }
    return v;
  };
  // the filter's thresholds of the two rows, plus the margins; recomputed
  // only after the warp entered columns, the only time a list changes (a
  // stale threshold is higher: the marks a superset); every lane shuffles,
  // and rows past Q mark nothing
  float t0, t1;
  auto thresholds = [&] {
    t0 = quad_kth(d0) + margin0;
    t1 = quad_kth(d1) + margin1;
    if (q_r0 == nullptr) t0 = -INFINITY;
    if (q_r1 == nullptr) t1 = -INFINITY;
  };
  thresholds();
  // column e (bit 31: of the thread's second row) into its row's list, with d
  // in the plain arithmetic
  auto enter = [&](uint32_t e) {
    const int c = static_cast<int>(e & 0x7fffffffu);
    const bool second = e >> 31;
    const float d = plain_dist<E>(second ? q_r1 : q_r0, a.c + static_cast<size_t>(c) * kD, a);
    if (second) {
      if (d < d1[K - 1]) insert<K>(d1, i1, d, c);
    } else if (d < d0[K - 1]) {
      insert<K>(d0, i0, d, c);
    }
  };
  // The marked columns wait in this thread's queue (column-major in shared
  // memory) until some lane's would overflow; then the warp enters them all,
  // in the order they were marked, its lanes' recomputes side by side.
  int held = 0;
  auto flush = [&] {
    for (int h = 0; __any_sync(0xffffffffu, h < held); ++h)
      if (h < held) enter(held_cols[h * kJThreads + t]);
    held = 0;
  };
  // this warpgroup's 64 rows start 64 x 32 bytes into each joint's tile
  const uint32_t qa = smem_u32(qs) + wg * (64 * 32);
  const int c0 = 2 * (tw % 4);
  float acc0[32], acc1[32], dist[32];
  for (int g = 0; g < slabs; ++g) {
    const int s = await_slab(bars, kJStages, g);
    // slab g + 2 into the slot of slab g - 1, which every warp has freed
    // unless the other warpgroup lags a slab: a copy takes about two slabs'
    // compute, so it starts as early as it can
    refill(g + kJStages - 1);
    const uint32_t cb = smem_u32(ring + s * kJSlab);
    // joint j's products into a fresh accumulator (acc0 for even j, acc1 for
    // odd), joint j + 1's issued before joint j's epilogue
    wgmma_fence();
    wgmma_m64n64k16_bf16(acc0, desc_sw32(qa), desc_sw32(cb), 0);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      float(&cur)[32] = (j & 1) ? acc1 : acc0;
      if (j + 1 < kJ) {
        float(&nxt)[32] = (j & 1) ? acc0 : acc1;
        wgmma_fence();
        wgmma_m64n64k16_bf16(nxt, desc_sw32(qa + (j + 1) * kJQTile),
                             desc_sw32(cb + (j + 1) * kJTile), 0);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(cur);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dist[i] = fmaf(a.nw[j], fabsf(cur[i]), j == 0 ? a.w_total : dist[i]);
    }
    // the warp no longer reads the slab: its wait<0> saw the warpgroup's
    // products done
    if (t % 32 == 0) mbar_arrive(smem_u32(bars + kJStages + s));
    // register i: row (i / 2) % 2 of the thread's two, column 8 (i / 4) + c0 + i % 2
    const int base = start + g * kJN;
    if (base + kJN > stop) {   // the corpus's last slab: rows past N are never marked
      const int lim = stop - base - c0;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i / 4) + i % 2 >= lim) dist[i] = __int_as_float(0x7fffffff);
    }
    // most slabs mark nothing in a warp: each row's smallest distance first
    // (fminf passes over the NaNs of rows past N)
    float lo0 = dist[0], lo1 = dist[2];
#pragma unroll
    for (int i = 1; i < 32; ++i) {
      if ((i / 2) % 2 == 0)
        lo0 = fminf(lo0, dist[i]);
      else
        lo1 = fminf(lo1, dist[i]);
    }
    if (__any_sync(0xffffffffu, lo0 <= t0 || lo1 <= t1)) {
      uint32_t m0 = 0, m1 = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int jb = (i / 4) * 2 + i % 2;
        if ((i / 2) % 2 == 0)
          m0 |= static_cast<uint32_t>(dist[i] <= t0) << jb;
        else
          m1 |= static_cast<uint32_t>(dist[i] <= t1) << jb;
      }
      const int marked = __popc(m0) + __popc(m1);
      const bool flushing = __any_sync(0xffffffffu, held + marked > kJPend);
      if (flushing) flush();
      const bool now = marked > kJPend;   // more than the queue holds (a list is filling)
      for (int r = 0; r < 2; ++r) {       // each row's columns in ascending order
        uint32_t m = r == 0 ? m0 : m1;
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          const uint32_t e = static_cast<uint32_t>(base + c0 + 8 * (j / 2) + j % 2) |
                             (static_cast<uint32_t>(r) << 31);
          if (now)
            enter(e);
          else
            held_cols[held++ * kJThreads + t] = e;
        }
      }
      if (__any_sync(0xffffffffu, flushing || now)) thresholds();
    }
  }
  flush();
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

template <int E, int K>
int launch_joint(const JointArgs& a, int S, cudaStream_t stream) {
  return launch_wgmma(knn_joint_kernel<E, K>, dim3((a.Q + kJQ - 1) / kJQ, S), kJThreads, kJointSmem,
                      stream, a);
}

template <int E>
int joint_for_kpad(const JointArgs& a, int kpad, int S, cudaStream_t stream) {
  switch (kpad) {
    case 8: return launch_joint<E, 8>(a, S, stream);
    case 16: return launch_joint<E, 16>(a, S, stream);
    case 24: return launch_joint<E, 24>(a, S, stream);
    case 32: return launch_joint<E, 32>(a, S, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The exact and bf16 engines' corpus, (N, 84) fp32 -> ceil(N / 64) slabs of
// 43,008 bytes (posendf_knn_joint_bytes), and each joint's largest |c_j|
// into cmax[0..20] (which the caller sets to 0).
int posendf_knn_pack_joint(const float* c, int N, void* packed, float* cmax, void* stream) {
  if (N <= 0) return 0;
  const int slabs = (N + kJN - 1) / kJN;
  knn_pack_joint_kernel<<<slabs < kJPackBlocks ? slabs : kJPackBlocks, kJPackThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      c, N, slabs, static_cast<unsigned char*>(packed), cmax);
  return static_cast<int>(cudaGetLastError());
}

long long posendf_knn_joint_bytes(int N) {
  return static_cast<long long>((N + kJN - 1) / kJN) * kJSlab;
}

// The top-k launch of the exact (engine 0) and bf16 (engine 1) engines over
// the packed corpus: part_d / part_i are (4 S, Q, kpad); w: the 21 joint
// weights in host memory, w_total their sum rounded once; k <= kpad.
int posendf_knn_joint(const float* q, int Q, const float* c, const void* packed, const float* cmax,
                      int N, const float* w, float w_total, int engine, int k, int kpad, int S,
                      float* part_d, int* part_i, void* stream) {
  if (Q <= 0) return 0;
  if (k < 1 || k > kpad) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (N + S - 1) / S;
  JointArgs a{};
  a.q = q;
  a.Q = Q;
  a.c = c;
  a.packed = static_cast<const unsigned char*>(packed);
  a.cmax = cmax;
  a.N = N;
  a.k = k;
  a.range = (per + kJN - 1) / kJN * kJN;
  a.w_total = w_total;
  a.w_abs = 0.f;
  for (int j = 0; j < kJ; ++j) {
    a.w[j] = w[j];
    a.nw[j] = -w[j];
    a.w_abs += fabsf(w[j]);
  }
  a.part_d = part_d;
  a.part_i = part_i;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case kExact: return joint_for_kpad<kExact>(a, kpad, S, s);
    case kBf16: return joint_for_kpad<kBf16>(a, kpad, S, s);
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
