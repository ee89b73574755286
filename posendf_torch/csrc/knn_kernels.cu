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
// Two launches. On the TPU the corpus axis was a sequential grid axis with the
// running best-k carried in VMEM; blocks on Hopper run in parallel and carry
// nothing, so:
//   * posendf_knn_partial: a block owns 128 queries, one thread each, and one
//     of S contiguous ranges of the corpus (blockIdx.y). It streams its range
//     through shared memory in slabs of 64 rows (every thread reads the same
//     row: broadcast reads) and keeps a sorted best-KPAD list in registers,
//     KPAD in {8, 16, 24, 32} as the TPU kernel rounds k. It writes the list
//     to a (S, Q, KPAD) partial buffer; a range that holds no row writes
//     sentinels (FLT_MAX, INT_MAX).
//   * posendf_knn_merge: one thread per query merges its S sorted lists into
//     the first k, writing fp32 distances and int64 indices.
// Every comparison orders by (distance, index), so the result is the same for
// any S and any run, with no atomics, and exact ties come lowest index first,
// as lax.top_k orders them in ops/knn.py::geodesic_topk.
//
// The exact and bf16 engines use __fmul_rn / __fadd_rn (no FMA contraction) in
// the TPU kernel's order: per joint the 4 products in d order, then 1 - |.|,
// then the weighted sum in joint order. Their distances are therefore the bits
// of the plain version (knn_topk_ref), on the card and on the CPU. The bound
// engine's products are of bf16 values and exact in fp32, so its FMAs equal
// mul + add; only the order of its 84-term sums differs from the plain
// version's matrix products.
//
// What bounds it on an H100: the distance arithmetic on the fp32 CUDA cores,
// not memory. The function needs 8 operations per joint and pair (4 products,
// 3 sums, |.| summed into the pair's total) and 2 per pair (1 - total / 21 as
// an FMA); without FMA contraction this kernel issues 10 instructions per
// joint and pair (4 mul, 3 add, 1 - |.|, the weighted sum's mul and add),
// each one slot of the pipe that an FMA would fill with two operations. The
// corpus is read once per query tile, 352 MB x 32 tiles at Q = 4096 and
// N = 2^20, mostly from L2. The design keeps the query (84 floats, or 84
// packed bf16 hi/lo pairs for the bound engine) and the best-k list in
// registers, the corpus slab in shared memory read as float4 broadcasts, and
// splits the corpus over blockIdx.y so that ceil(Q / 128) x S blocks fill the
// 132 SMs a few times over. Tensor cores for the bound engine's K = 84
// product, asynchronous slab copies and a warp-wide candidate list are later
// work.

#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kJ = 21;         // joints
constexpr int kD = 4 * kJ;     // floats of one pose
constexpr int kQTile = 128;    // queries per block, one thread each
constexpr int kSlab = 64;      // corpus rows per shared-memory slab
constexpr float kBig = FLT_MAX;
constexpr int kIBig = INT_MAX;

enum Engine { kExact = 0, kBf16 = 1, kBound = 2 };

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
  const float* w;   // (21,) joint weights (exact and bf16 engines)
  float w_total;    // W of the bound engine
  int range;        // corpus rows per blockIdx.y, a multiple of kSlab
  float* part_d;    // (S, Q, K)
  int* part_i;
};

template <int E, int K>
__global__ void __launch_bounds__(kQTile) knn_partial_kernel(PartialArgs a) {
  __shared__ __align__(16) float slab[kSlab * kD];
  __shared__ __align__(16) float slab_lo[E == kBound ? kSlab * kD : 4];
  __shared__ float ws[kJ];

  const int t = threadIdx.x;
  const int qi = blockIdx.x * kQTile + t;
  const bool active = qi < a.Q;
  if (t < kJ) ws[t] = a.w[t];

  // the query: fp32 values, bf16-rounded values, or packed bf16 (hi, lo) pairs
  float qv[kD];
  if (active) {
    const float4* q4 = reinterpret_cast<const float4*>(a.q + static_cast<size_t>(qi) * kD);
#pragma unroll
    for (int v = 0; v < kJ; ++v) {
      const float4 f = __ldg(q4 + v);
      const float x[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if constexpr (E == kExact) {
          qv[4 * v + d] = x[d];
        } else if constexpr (E == kBf16) {
          qv[4 * v + d] = bf16_round(x[d]);
        } else {
          const float hi = bf16_round(x[d]);
          const float lo = bf16_round(x[d] - hi);
          qv[4 * v + d] = __uint_as_float((__float_as_uint(hi) & 0xffff0000u) |
                                          (__float_as_uint(lo) >> 16));
        }
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
      if constexpr (E == kBf16) {
        f = make_float4(bf16_round(f.x), bf16_round(f.y), bf16_round(f.z), bf16_round(f.w));
      } else if constexpr (E == kBound) {
        const float4 hi =
            make_float4(bf16_round(f.x), bf16_round(f.y), bf16_round(f.z), bf16_round(f.w));
        reinterpret_cast<float4*>(slab_lo)[e] =
            make_float4(bf16_round(f.x - hi.x), bf16_round(f.y - hi.y), bf16_round(f.z - hi.z),
                        bf16_round(f.w - hi.w));
        f = hi;
      }
      reinterpret_cast<float4*>(slab)[e] = f;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < rows; ++r) {
      const float4* row = reinterpret_cast<const float4*>(slab + r * kD);
      float dist;
      if constexpr (E == kBound) {
        const float4* row_lo = reinterpret_cast<const float4*>(slab_lo + r * kD);
        float hh = 0.f, hl = 0.f, lh = 0.f;
#pragma unroll
        for (int v = 0; v < kJ; ++v) {
          const float4 h4 = row[v], l4 = row_lo[v];
          const float ch[4] = {h4.x, h4.y, h4.z, h4.w};
          const float cl[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const uint32_t p = __float_as_uint(qv[4 * v + d]);
            const float qh = __uint_as_float(p & 0xffff0000u);
            const float ql = __uint_as_float(p << 16);
            hh = fmaf(qh, ch[d], hh);
            hl = fmaf(qh, cl[d], hl);
            lh = fmaf(ql, ch[d], lh);
          }
        }
        dist = __fsub_rn(a.w_total, __fadd_rn(__fadd_rn(hh, hl), lh));
      } else {
        dist = 0.f;
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

// The top-k launch: part_d / part_i are (S, Q, kpad).
int posendf_knn_partial(const float* q, int Q, const float* c, int N, const float* w,
                        float w_total, int engine, int kpad, int S, float* part_d, int* part_i,
                        void* stream) {
  if (Q <= 0) return 0;
  PartialArgs a{q, Q, c, N, w, w_total, split_rows(N, S), part_d, part_i};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case kExact: return partial_for_kpad<kExact>(a, kpad, S, s);
    case kBf16: return partial_for_kpad<kBf16>(a, kpad, S, s);
    case kBound: return partial_for_kpad<kBound>(a, kpad, S, s);
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
