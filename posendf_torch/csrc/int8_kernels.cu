// Hand-written Hopper kernels of the int8 serving path (sm_90a):
//
//   posendf_forward_int8  replaces posendf_tpu/ops/fused_int8.py::_int8_kernel
//                         (whole forward: encoder walk + DFNet with its
//                         128-aligned window of layers in int8)
//   probe_bf16_chain      replaces scripts/int8_probe.py::_bf16_kernel
//   probe_int8_chain      replaces scripts/int8_probe.py::_int8_kernel
//                         (the measurement probe: a chain of 512 x 512
//                         products in bf16 or int8 on the tensor cores)
//
// ---- posendf_forward_int8 ----
// A block owns kTile = 16 poses, as posendf_forward does, and reuses its
// pieces: common.cuh's encode_pose (normalization and encoder walk, one
// thread per pose) and tile_matmul for the fp32 layers (layer 0, the 64-wide
// tail and the output). Activations ping-pong in shared memory as (width,
// kTile) fp32 columns. An int8 layer l first requantizes its input with the
// per-input-channel inverse scale row: x_q = clip(rint(x * inv_sa), +-127)
// (rintf rounds half to even, as jnp.round; __fmul_rn keeps nvcc from
// contracting the product into anything else). x_q, (K, kTile) int8 in
// shared memory, is the wmma matrix A (16 x 16 x 16 signed char fragments,
// int accumulators); each of the 16 warps owns N / 16 / 16 output column
// tiles and streams its packed weight tiles (the wrapper stores wq as
// [N/16][K/16][16 x 16], 256 contiguous bytes a fragment) from L2, loading
// kChunk fragments before it multiplies them so that many loads are in
// flight. The int32 sums are exact in any order (|acc| <= K * 127^2 < 2^24
// for K <= 1040, so the int -> float conversion is exact too), and are
// dequantized as JAX does, acc * dq + b, in two roundings
// (__fmul_rn, __fadd_rn: no FMA). The accumulator tile is stored straight
// into the next fp32 buffer in column-major order, which is the (width,
// kTile) layout, and converted in place.
//
// Bound at the serving batch of 131,072 poses (an H100 SXM's peaks): the
// int8 products, 96% of the DFNet's multiply-adds, at 1,979 TOPS (0.17 ms),
// plus the fp32 encoder and layers 0, 5, 6 at 67 TFLOP/s (0.20 ms); bytes
// (poses in, d out, 1.5 MB of weights) are 0.014 ms. The design leaves most
// of that on the table, knowingly: with 16 poses a tile the tensor cores
// take M = 16, each weight fragment is used once per block and read from L2
// 8,192 times at that batch, the encoder walk keeps 16 of 512 threads busy,
// and no wgmma or TMA is used. Simple and right first.
//
// ---- probe chains ----
// A block keeps a tile of kPT = 64 rows of x in shared memory for all the
// layers (as the TPU kernel keeps its row tile in VMEM) and streams each
// layer's weights through shared memory in slabs of KC rows, stored as
// 16 x 16 fragment tiles. Each warp owns two output column tiles of all four
// row tiles, so a B fragment serves four products. After a layer the block
// waits until every warp has read x, then writes the converted outputs over
// it: bf16: the fp32 sums rounded to bf16 (__float2bfloat16_rn, nearest
// even); int8: clip(rint(acc * s_l), +-127) (s is a power of two in the
// probe, so the chain is exact). Bound at (131,072, 512) x 8 layers: the
// products, 5.5e11 operations, at 989 TFLOP/s bf16 (0.56 ms) or 1,979 TOPS
// int8 (0.28 ms); bytes 0.08 / 0.10 ms. wmma's mma.sync path reaches only a
// part of Hopper's tensor-core rate (the full rate needs wgmma), so the
// probe measures what this route gives, not the card's ceiling.
//
// Each launcher returns cudaGetLastError(); the Python wrapper raises on a
// nonzero value. No launcher synchronizes or allocates.

#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace posendf;
using namespace nvcuda;

constexpr int kMeta8 = 7;    // per layer: in, out, kind, off W, off b, off dq, off inv_sa
enum Kind { kF32 = 0, kI8 = 1 };
constexpr int kFrag = 16;    // wmma m = n = k
constexpr int kFragElems = kFrag * kFrag;
constexpr int kChunk = 8;    // k-steps whose fragments are loaded before their products
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

struct Int8Args {
  const float* pose;        // (B, J, 4)
  int B;
  const float* enc;         // w1 | b1 | w2 | b2
  const int* parents;       // (J,)
  int J, F;
  const float* fw;          // fp32 layers' W (in, out) and b; int8 layers' b, dq, inv_sa
  const signed char* qw;    // int8 layers' wq as [N/16][K/16][16 x 16] tiles
  const int* meta;          // (L, kMeta8)
  int L, maxw, maxq;        // layers, widest activation, widest int8 layer input
  int act;
  float beta;
  float* d_out;             // (B,)
};

// Shared memory, in floats (regions 32-byte aligned for wmma): encoder weights
// | meta (int) | parents (int) | activations A | activations B | s and n of the
// normalization | d | then maxq x kTile bytes of requantized input.
__host__ __device__ inline size_t int8_smem_bytes(int J, int F, int L, int maxw, int maxq) {
  const size_t floats = static_cast<size_t>(round8(enc_floats(J, F))) + round8(kMeta8 * L) +
                        round8(J) + 2 * static_cast<size_t>(maxw) * kTile + 8 * kTile +
                        round8(kTile);
  return floats * sizeof(float) + static_cast<size_t>(maxq) * kTile;
}

__global__ void __launch_bounds__(kThreads) int8_forward_kernel(const Int8Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int J = a.J, F = a.F, L = a.L;
  const int encn = enc_floats(J, F);

  float* encw = smem;
  int* meta = reinterpret_cast<int*>(encw + round8(encn));
  int* par = meta + round8(kMeta8 * L);
  float* bufA = reinterpret_cast<float*>(par + round8(J));
  float* bufB = bufA + a.maxw * kTile;
  float* norm = bufB + a.maxw * kTile;          // s (4, kTile) then n (4, kTile)
  float* dval = norm + 8 * kTile;               // (kTile,)
  signed char* aq = reinterpret_cast<signed char*>(dval + round8(kTile));  // (K, kTile)

  for (int i = threadIdx.x; i < encn; i += kThreads) encw[i] = a.enc[i];
  for (int i = threadIdx.x; i < kMeta8 * L; i += kThreads) meta[i] = a.meta[i];
  for (int i = threadIdx.x; i < J; i += kThreads) par[i] = a.parents[i];
  __syncthreads();

  const int t = threadIdx.x;
  const int b = blockIdx.x * kTile + t;
  const bool valid = t < kTile && b < a.B;
  const float4* q4 = reinterpret_cast<const float4*>(a.pose) + static_cast<size_t>(b) * J;
  if (t < kTile) encode_pose<false>(q4, valid, t, J, F, encw, par, a.act, a.beta, bufA, norm, nullptr);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cur = bufA;
  float* nxt = bufB;
  for (int l = 0; l < L; ++l) {
    const int* m = meta + kMeta8 * l;
    const int K = m[0], N = m[1];
    const float* bias = a.fw + m[4];
    if (m[2] == kF32) {
      const float* W = a.fw + m[3];
      if (l < L - 1) {
        float* y = nxt;
        tile_matmul(W, K, N, cur, [&](int col, const float(&acc)[kTile]) {
          const float bn = __ldg(bias + col);
          float v[kTile];
#pragma unroll
          for (int tt = 0; tt < kTile; ++tt) v[tt] = act_fwd(a.act, a.beta, acc[tt] + bn);
          store_tile_column(y + col * kTile, v);
        });
      } else {
        tile_matmul(W, K, N, cur, [&](int col, const float(&acc)[kTile]) {
          const float bn = __ldg(bias + col);
#pragma unroll
          for (int tt = 0; tt < kTile; ++tt) dval[tt] = out_act_fwd(a.act, a.beta, acc[tt] + bn);
        });
      }
    } else {
      // requantize: x_q[k][t] = clip(rint(x[k][t] * inv_sa[k]), -127, 127)
      const float* dq = a.fw + m[5];
      const float* inv_sa = a.fw + m[6];
      for (int i = threadIdx.x; i < K * kTile; i += kThreads) {
        const float v = rintf(__fmul_rn(cur[i], __ldg(inv_sa + i / kTile)));
        aq[i] = static_cast<signed char>(fminf(fmaxf(v, -127.f), 127.f));
      }
      __syncthreads();
      const int KT = K / kFrag;
      const signed char* Wq = a.qw + m[3];
      for (int nt = warp; nt < N / kFrag; nt += kWarps) {
        wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, int> acc;
        wmma::fill_fragment(acc, 0);
        const signed char* wt = Wq + static_cast<size_t>(nt) * KT * kFragElems;
        for (int k0 = 0; k0 < KT; k0 += kChunk) {
          wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, signed char, wmma::col_major> fa[kChunk];
          wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, signed char, wmma::row_major> fb[kChunk];
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            wmma::load_matrix_sync(fb[c], wt + (k0 + c) * kFragElems, kFrag);
            wmma::load_matrix_sync(fa[c], aq + (k0 + c) * kFragElems, kFrag);
          }
#pragma unroll
          for (int c = 0; c < kChunk; ++c) wmma::mma_sync(acc, fa[c], fb[c], acc);
        }
        // column-major with ldm 16 is the (width, kTile) layout of the next buffer
        int* tile = reinterpret_cast<int*>(nxt + nt * kFragElems);
        wmma::store_matrix_sync(tile, acc, kFrag, wmma::mem_col_major);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kFragElems / 32; ++r) {
          const int i = lane + 32 * r;
          const int col = nt * kFrag + i / kTile;
          const float z = __fadd_rn(__fmul_rn(__int2float_rn(tile[i]), __ldg(dq + col)),
                                    __ldg(bias + col));
          nxt[nt * kFragElems + i] = act_fwd(a.act, a.beta, z);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (valid) a.d_out[b] = dval[t];
}

// ---- probe chains ----

constexpr int kPW = 512;   // the probe's width
constexpr int kPT = 64;    // rows of x per block
constexpr int kPMT = kPT / kFrag;
constexpr int kPNT = kPW / kFrag;
static_assert(kPNT == 2 * kWarps, "each warp owns two output column tiles");

template <typename T> struct ProbeKC;
template <> struct ProbeKC<__nv_bfloat16> { static constexpr int value = 32; };
template <> struct ProbeKC<signed char> { static constexpr int value = 64; };

template <typename T, typename Acc>
__host__ __device__ constexpr size_t probe_smem_bytes() {
  return sizeof(T) * (static_cast<size_t>(kPW) * kPT + static_cast<size_t>(kPW) * ProbeKC<T>::value) +
         sizeof(Acc) * kWarps * kFragElems;
}

// element (m, k) of a row-major (rows, width) matrix kept as 16 x 16 tiles,
// tile (k / 16, m / 16) of kPMT row tiles, row-major inside
__device__ __forceinline__ int x_tile_off(int m, int k) {
  return ((k >> 4) * kPMT + (m >> 4)) * kFragElems + (m & 15) * kFrag + (k & 15);
}

__device__ __forceinline__ __nv_bfloat16 probe_convert(float acc, float) {
  return __float2bfloat16_rn(acc);
}
__device__ __forceinline__ signed char probe_convert(int acc, float s) {
  const float v = rintf(__fmul_rn(__int2float_rn(acc), s));
  return static_cast<signed char>(fminf(fmaxf(v, -127.f), 127.f));
}
__device__ __forceinline__ __nv_bfloat16 probe_out(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ float probe_out(signed char v) { return static_cast<float>(v); }

template <typename T, typename Acc, typename Out>
__global__ void __launch_bounds__(kThreads)
    probe_chain_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* s, int B,
                       int layers, Out* out) {
  constexpr int KC = ProbeKC<T>::value;
  constexpr int V = 16 / sizeof(T);   // elements of one 16-byte vector
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);              // kPT x kPW as tiles
  T* ws = xs + kPW * kPT;                              // KC x kPW as tiles [n/16][k/16]
  Acc* stage = reinterpret_cast<Acc*>(ws + kPW * KC);  // one 16 x 16 tile a warp
  const int row0 = blockIdx.x * kPT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int v = threadIdx.x; v < kPT * kPW / V; v += kThreads) {
    const int m = v / (kPW / V), k = (v % (kPW / V)) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + m < B) val = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + m) * kPW + k);
    *reinterpret_cast<uint4*>(xs + x_tile_off(m, k)) = val;
  }

  for (int l = 0; l < layers; ++l) {
    wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, Acc> acc[2][kPMT];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int mt = 0; mt < kPMT; ++mt) wmma::fill_fragment(acc[j][mt], static_cast<Acc>(0));
    for (int k0 = 0; k0 < kPW; k0 += KC) {
      __syncthreads();   // the previous slab is consumed, x is written
      for (int v = threadIdx.x; v < KC * kPW / V; v += kThreads) {
        const int r = v / (kPW / V), n = (v % (kPW / V)) * V;
        *reinterpret_cast<uint4*>(ws + ((n >> 4) * (KC / kFrag) + (r >> 4)) * kFragElems +
                                  (r & 15) * kFrag + (n & 15)) =
            *reinterpret_cast<const uint4*>(w + (static_cast<size_t>(l) * kPW + k0 + r) * kPW + n);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC / kFrag; ++kk) {
        wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, T, wmma::row_major> fb[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], ws + ((2 * warp + j) * (KC / kFrag) + kk) * kFragElems, kFrag);
#pragma unroll
        for (int mt = 0; mt < kPMT; ++mt) {
          wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, T, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, xs + ((k0 / kFrag + kk) * kPMT + mt) * kFragElems, kFrag);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[j][mt], fa, fb[j], acc[j][mt]);
        }
      }
    }
    __syncthreads();   // every warp has read all of x: the outputs replace it
    const float sl = s != nullptr ? s[l] : 1.f;
    Acc* st = stage + warp * kFragElems;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int mt = 0; mt < kPMT; ++mt) {
        wmma::store_matrix_sync(st, acc[j][mt], kFrag, wmma::mem_row_major);
        __syncwarp();
        // output (m, n) is the next layer's input (m, k = n): tile (n / 16, m / 16),
        // at the same place inside the tile as in the row-major stage
        T* dst = xs + ((2 * warp + j) * kPMT + mt) * kFragElems;
#pragma unroll
        for (int r = 0; r < kFragElems / 32; ++r) dst[lane + 32 * r] = probe_convert(st[lane + 32 * r], sl);
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kPT * kPW; e += kThreads) {
    const int m = e / kPW, n = e % kPW;
    if (row0 + m < B) out[static_cast<size_t>(row0 + m) * kPW + n] = probe_out(xs[x_tile_off(m, n)]);
  }
}

template <typename T, typename Acc, typename Out>
int launch_probe(const T* x, const T* w, const float* s, int B, int layers, Out* out, void* stream) {
  if (layers < 1 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  constexpr size_t smem = probe_smem_bytes<T, Acc>();
  cudaError_t err = cudaFuncSetAttribute(probe_chain_kernel<T, Acc, Out>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_chain_kernel<T, Acc, Out><<<(B + kPT - 1) / kPT, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(x, w, s, B, layers, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int posendf_forward_int8(const float* pose, int B, const float* enc, const int* parents, int J,
                         int F, const float* fw, const signed char* qw, const int* meta, int L,
                         int maxw, int maxq, int act, float beta, float* d_out, void* stream) {
  if (J < 1 || J > kMaxJ || F < 1 || F > kMaxF || L < 1 || L > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Int8Args a{pose, B, enc, parents, J, F, fw, qw, meta, L, maxw, maxq, act, beta, d_out};
  const size_t smem = int8_smem_bytes(J, F, L, maxw, maxq);
  cudaError_t err = cudaFuncSetAttribute(int8_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_forward_kernel<<<(B + kTile - 1) / kTile, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one block of posendf_forward_int8 needs.
int posendf_int8_smem_bytes(int J, int F, int L, int maxw, int maxq) {
  return static_cast<int>(int8_smem_bytes(J, F, L, maxw, maxq));
}

// x (B, 512) bf16, w (>= layers, 512, 512) bf16 -> out (B, 512) bf16
int probe_bf16_chain(const void* x, const void* w, int B, int layers, void* out, void* stream) {
  return launch_probe<__nv_bfloat16, float, __nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), nullptr, B,
      layers, static_cast<__nv_bfloat16*>(out), stream);
}

// x (B, 512) int8, w (>= layers, 512, 512) int8, s (>= layers,) fp32 -> out (B, 512) fp32
int probe_int8_chain(const void* x, const void* w, const float* s, int B, int layers, float* out,
                     void* stream) {
  return launch_probe<signed char, int, float>(static_cast<const signed char*>(x),
                                               static_cast<const signed char*>(w), s, B, layers,
                                               out, stream);
}

const char* posendf_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
