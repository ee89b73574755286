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
// The three share one shape (hopper.cuh has the PTX): consumer warpgroups
// (two in the bf16 chain, three in the int8 chain, four in the int8
// forward) issue wgmma.mma_async with both operands in shared memory in the
// K-major 128-byte-swizzled layout; a producer warp fills a ring of weight
// slabs with cp.async.bulk, guarded by full / empty mbarrier pairs, so that
// copies overlap products; a consumer warpgroup frees a slot (one arrival
// on its empty barrier) as soon as its products of it are done. The
// wrappers store the weights in that layout already
// (fused_int8.sw128_kmajor_offsets), one slab one contiguous run of bytes.
// Every CTA copies its own slabs: thread-block clusters that multicast each
// slab to 2 or 4 CTAs were measured on an H100 and gained nothing in the
// int8 forward or the bf16 chain (PERF.md), so the kernels launch without
// them. Before products read what the consumers stored in shared memory,
// the writers pass fence.proxy.async and a named barrier.
//
// ---- posendf_forward_int8 ----
// Bound at the serving batch of 131,072 poses (an H100 SXM's peaks): the int8
// products, 96% of the DFNet's multiply-adds, at 1,979 TOPS (0.17 ms), plus the
// fp32 encoder and layers 0, 5, 6 at 67 TFLOP/s (0.20 ms); bytes (poses in, d
// out, 1.5 MB of weights) 0.014 ms. Each 64-pose CTA reads the weights from
// L2 (1.3 MB): 2.7 GB a call. A CTA owns 64 poses (one wgmma M): 544
// threads, four consumer warpgroups and a producer warp; the int8 products
// need only two, but the CUDA-core phases (encoder, fp32 layers, epilogues)
// need the warps to hide their latency, as one 213 KB CTA fills an SM.
// * Encoder: the CTA's poses and the encoder's weights copied to shared
//   memory with coalesced loads, then one thread per pose and eighth of the
//   hidden units (512 threads, 64 poses), two named barriers per joint; the
//   joint-axis normalization as field_kernels.cu's encode computes it. The
//   code is (J * F, 64) fp32.
// * fp32 layers (0 and the tail) on the CUDA cores in fp32 (not TF32: it
//   would move layer-1 levels): a thread owns one output column of 32
//   poses (8, or 1, where N is too small to give every thread a task), FMA
//   chains over K in order, the weights of the next 8 rows loaded from L2
//   while the current ones multiply.
// * int8 layers: A is the requantized input, (64 poses, K) int8; B the
//   packed wq^T, N in chunks of NC = 256 (128 where N is not a multiple of
//   256), each chunk's K in slabs of 128 bytes (NC x 128 bytes, one ring
//   slot); each warpgroup runs m64n(NC/4)k32 s8 products into s32
//   accumulators, 4 per slab. The sums are exact integers (|acc| <= K 127^2
//   < 2^24, K <= 1024), so the order does not matter and the int -> float
//   conversion is exact.
// * Epilogues: dq, b and the next layer's inv_sa staged in shared memory at
//   the start of the layer; z = acc * dq + b in two roundings (__fmul_rn,
//   __fadd_rn: no FMA), as JAX; the activation; where the next layer is int8, its input
//   requantized at once, clip(rint(x * inv_sa), +-127) (rintf rounds half
//   to even, as jnp.round), and stored as int8 straight into the next A
//   buffer; else fp32 (width, 64). Two buffers ping-pong: the input of layer l
//   lives in buffer l % 2, each sized for the largest activation of its
//   parity (96 KB for the trained field), beside a 3-slot ring of 32 KB.
//
// ---- probe_bf16_chain ----
// Bound at (131,072, 512) x 8 layers: the products, 5.5e11 operations, at
// 989 TFLOP/s bf16 (0.56 ms); bytes 0.08 ms. A CTA keeps 128 rows of x (128 KB
// of bf16, swizzled) in shared memory for all the layers, as the TPU kernel
// keeps its row tile in VMEM, and every layer reads all 512 KB of its weights
// through a 3-slot ring of 32 KB slabs (256 output channels x 64 of K): the
// SM takes in 32 KB of weights per 4.2 MFLOP, about 58 GB/s an SM at the
// tensor-core rate. (At 64 rows a CTA it would be twice that, more than the
// L2-to-SM path delivered on an H100.) A layer's output has to be complete
// before it overwrites x, and 128 x 512 fp32 sums do not fit the registers:
// each consumer warpgroup owns 64 rows, sums output channels 0-255
// (m64n256k16, 128 accumulators a thread), keeps them rounded to bf16 (64
// registers of pairs), then sums 256-511. With the producer warpgroup at 24
// registers (setmaxnreg) the consumers get 240. Then both warpgroups pass a
// named barrier (every product has read x), write the fp32 sums rounded to
// bf16 (__float2bfloat16_rn, nearest even) over x, fence, and pass it again;
// the last layer writes out row-major, rows past B masked.
//
// ---- probe_int8_chain ----
// Bound at (131,072, 512) x 8 layers: 5.5e11 int8 operations at 1,979 TOPS
// (0.28 ms); bytes 0.1 ms. The bf16 chain's shape with int8 operands
// (wgmma.mma_async s32.s8.s8, both operands in shared memory; one 128-byte
// swizzle line holds 128 int8 of K). A CTA keeps kQRows = 192 rows of x
// (three consumer warpgroups of 64; 96 KB: the int8 tile is half the bf16
// one, and more rows a CTA mean fewer weight bytes into the SM an
// operation) beside an 8-slot ring of 16 KB slabs, 128 output channels x
// 128 bytes of K: the layer's outputs in quarters (m64n128k32, 64 s32
// accumulators a thread), slabs (quarter, K block) in that order, every
// slab one bulk copy of the packed weights (fused_int8.sw128_kmajor_offsets,
// nc = 128). The sums are exact integers (|acc| <= 512 x 127^2 < 2^24), so
// the order does not matter and the chain is bitwise the plain one's.
// The requantization (probe_convert: no FMA, rint, clamps without branches)
// takes about as many issue slots as a third of the products take on the
// tensor cores, so it runs beside other warpgroups' products: the turn at
// the tensor cores goes round the consumer warpgroups, a quarter each, by
// named barriers (a ping-pong schedule's): a warpgroup waits for its turn,
// issues its quarter's 16 products (keeping one slab in flight, wgmma wait
// 1, which frees the slot of the slab before), passes the turn on, and
// requantizes its quarter while the next warpgroup's products run. A
// warpgroup's products read only its own 64 rows of x and its epilogues
// write only them, so beyond the turn the warpgroups share only the ring
// (where a slab stays until the third warpgroup has had it). Quarters 0-2
// are held, four int8 a register, until the warpgroup's quarter 3 has read
// its rows; then it stores all four over them (a quarter of outputs is one
// K block of the next layer's A) and passes fence.proxy.async and a barrier
// of its own. The last layer writes fp32 rows, rows past B masked; they
// read zeros. Registers: the producer warpgroup drops to 24, the consumers
// take kQRegs (160) for 64 accumulators and 48 held words.
// ops/breakdown.py times 128 rows a CTA (two consumer warpgroups) as
// rows128.

// Each launcher returns the launch's error (cudaFuncSetAttribute's, then
// cudaGetLastError's); the Python wrapper raises on a nonzero value. No
// launcher synchronizes or allocates.

#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace posendf;
using namespace hopper;

// ---- the wgmma kernels' common shape ----

constexpr int kRows = 64;                     // rows (poses) a CTA: one wgmma M
constexpr int kConsumers = 256;               // the bf16 chain's two consumer warpgroups
constexpr int kSlabK = 128;                   // bytes of K a slab row (one swizzle line)
constexpr int kAtomBytes = kRows * kSlabK;    // 64 rows x 128 bytes of A
constexpr uint32_t kBarConsumers = 1;         // named barrier of the consumer warpgroups

// ---- posendf_forward_int8 ----

constexpr int kMeta8 = 8;   // per layer: in, out, kind, off W / wq, off b, off dq, off inv_sa, NC
enum Kind { kF32 = 0, kI8 = 1 };
constexpr int kStages8 = 3;
constexpr int kConsumers8 = 512;               // four consumer warpgroups
constexpr int kThreads8 = kConsumers8 + 32;    // and one producer warp
constexpr int kParts = kConsumers8 / kRows;    // encoder threads a pose
constexpr int kPre = 8;                        // fp32 weight rows loaded ahead
constexpr int kSlot8 = 256 * kSlabK;   // one slab: NC <= 256 rows x 128 bytes of K

struct Int8Args {
  const float* pose;        // (B, J, 4)
  int B;
  const float* enc;         // w1 | b1 | w2 | b2
  const int* parents;       // (J,)
  int J, F;
  const float* fw;          // fp32 layers' W (in, out) and b; int8 layers' b, dq, inv_sa
  const unsigned char* qw;  // int8 layers' wq^T in slabs (fused_int8.sw128_kmajor_offsets)
  const int* meta;          // (L, kMeta8)
  int L;
  int x0_bytes, x1_bytes;   // activation buffers: inputs of the even / odd layers
  int maxn8;                // widest int8 layer output
  int act;
  float beta;
  float* d_out;             // (B,)
};

// ring | x0 | x1 | an int8 layer's dq, b and next inv_sa (3, maxn8) fp32 |
// encoder hidden units (kMaxE, 64) fp32 | barriers; 1024 to align
__host__ __device__ inline size_t int8_smem_bytes(int x0_bytes, int x1_bytes, int maxn8) {
  return 1024 + static_cast<size_t>(kStages8) * kSlot8 + round1024(x0_bytes) + round1024(x1_bytes) +
         (3 * static_cast<size_t>(maxn8) + kMaxE * kRows) * sizeof(float) +
         2 * kStages8 * sizeof(uint64_t);
}

// element (row, k) of a (64, K) int8 A buffer: K in 128-byte swizzled blocks
__device__ __forceinline__ int a_offset(int row, int k) {
  return (k >> 7) * kAtomBytes + sw128_offset(row, k & 127);
}

// clip(rint(v * inv_sa), +-127) as int8
__device__ __forceinline__ signed char requant(float v, float inv_sa) {
  return static_cast<signed char>(fminf(fmaxf(rintf(__fmul_rn(v, inv_sa)), -127.f), 127.f));
}

// Encoder walk of the CTA's 64 poses into code (J * F, 64) fp32. The poses
// ((64, J) float4, zeros past B) and the encoder's weights are first copied
// to `stage` (the odd layers' buffer, free until layer 0 writes it) with
// coalesced loads; then thread t owns pose t % 64 and the hidden units /
// features r, r + 4, ... (r = t / 64), two named barriers a joint.
__device__ __forceinline__ void encode_tile(const Int8Args& a, int row0, float* code, float* hid, float* stage) {
  const int t = threadIdx.x, p = t % kRows, r = t / kRows;
  const int J = a.J, F = a.F, E = 4 + F;
  float4* qs = reinterpret_cast<float4*>(stage);
  float* w1 = stage + 4 * kRows * J;
  const int rows = min(kRows, a.B - row0);
  const float4* qg = reinterpret_cast<const float4*>(a.pose) + static_cast<size_t>(row0) * J;
  for (int v = t; v < kRows * J; v += kConsumers8)
    qs[v] = v < rows * J ? __ldg(qg + v) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = t; i < enc_floats(J, F); i += kConsumers8) w1[i] = __ldg(a.enc + i);
  named_bar_sync(kBarConsumers, kConsumers8);
  const float* b1 = w1 + J * E * E;
  const float* w2 = b1 + J * E;
  const float* b2 = w2 + J * E * F;
  const float4* q4 = qs + p * J;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, n[4];
  for (int j = 0; j < J; ++j) {
    const float4 q = q4[j];
    s[0] = fmaf(q.x, q.x, s[0]);
    s[1] = fmaf(q.y, q.y, s[1]);
    s[2] = fmaf(q.z, q.z, s[2]);
    s[3] = fmaf(q.w, q.w, s[3]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) n[c] = sqrtf(fmaxf(s[c], kEps2));
  for (int j = 0; j < J; ++j) {
    const float4 q = q4[j];
    const int par = __ldg(a.parents + j);
    float in[kMaxE];
    in[0] = q.x / n[0];
    in[1] = q.y / n[1];
    in[2] = q.z / n[2];
    in[3] = q.w / n[3];
#pragma unroll
    for (int k = 0; k < kMaxF; ++k) in[4 + k] = (k < F && par >= 0) ? code[(par * F + k) * kRows + p] : 0.f;
    const float* w1j = w1 + j * E * E;
#pragma unroll
    for (int oi = 0; oi < (kMaxE + kParts - 1) / kParts; ++oi) {   // independent sums
      const int o = r + kParts * oi;
      if (o < E) {
        float z = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxE; ++i)
          if (i < E) z = fmaf(in[i], w1j[i * E + o], z);
        z += b1[j * E + o];
        hid[o * kRows + p] = act_fwd(a.act, a.beta, z);
      }
    }
    named_bar_sync(kBarConsumers, kConsumers8);
    const float* w2j = w2 + j * E * F;
#pragma unroll
    for (int ki = 0; ki < (kMaxF + kParts - 1) / kParts; ++ki) {
      const int k = r + kParts * ki;
      if (k < F) {
        float z = 0.f;
#pragma unroll
        for (int o = 0; o < kMaxE; ++o)
          if (o < E) z = fmaf(hid[o * kRows + p], w2j[o * F + k], z);
        z += b2[j * F + k];
        code[(j * F + k) * kRows + p] = act_fwd(a.act, a.beta, z);
      }
    }
    named_bar_sync(kBarConsumers, kConsumers8);
  }
}

// acc[i] += w * x[i] over a task's P poses of input row xk
template <int P>
__device__ __forceinline__ void fma_row(float (&acc)[P], float w, const float* xk) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int v = 0; v < P / 4; ++v) {
      const float4 f = reinterpret_cast<const float4*>(xk)[v];
      acc[4 * v] = fmaf(w, f.x, acc[4 * v]);
      acc[4 * v + 1] = fmaf(w, f.y, acc[4 * v + 1]);
      acc[4 * v + 2] = fmaf(w, f.z, acc[4 * v + 2]);
      acc[4 * v + 3] = fmaf(w, f.w, acc[4 * v + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = fmaf(w, xk[i], acc[i]);
  }
}

// An fp32 layer on the CUDA cores: x (K, 64) fp32 -> the next layer's input,
// or d for the last layer. A task is one output column of P poses; its sums
// run over k in order. Weights come from L2 kPre rows at a time, the next
// block loaded while the current one multiplies.
template <int P>
__device__ __forceinline__ void fp32_layer(const Int8Args& a, const int* m, bool last, const float* inv_next,
                           const float* x, unsigned char* out, int row0) {
  const int K = m[0], N = m[1];
  const float* W = a.fw + m[3];
  const float* bias = a.fw + m[4];
  const int Kb = K - K % kPre;   // rows in whole blocks
  for (int task = threadIdx.x; task < N * (kRows / P); task += kConsumers8) {
    const int col = task % N, p0 = (task / N) * P;
    const float* Wc = W + col;
    float acc[P];
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = 0.f;
    float wa[kPre], wb[kPre];
    auto load = [&](int k0, float(&w)[kPre]) {
#pragma unroll
      for (int u = 0; u < kPre; ++u) w[u] = __ldg(Wc + static_cast<size_t>(k0 + u) * N);
    };
    auto block = [&](int k0, const float(&w)[kPre]) {
#pragma unroll
      for (int u = 0; u < kPre; ++u) fma_row<P>(acc, w[u], x + (k0 + u) * kRows + p0);
    };
    if (Kb > 0) load(0, wa);
    for (int k0 = 0; k0 < Kb; k0 += 2 * kPre) {
      if (k0 + kPre < Kb) load(k0 + kPre, wb);
      block(k0, wa);
      if (k0 + kPre >= Kb) break;
      if (k0 + 2 * kPre < Kb) load(k0 + 2 * kPre, wa);
      block(k0 + kPre, wb);
    }
    for (int k = Kb; k < K; ++k) fma_row<P>(acc, __ldg(Wc + static_cast<size_t>(k) * N), x + k * kRows + p0);
    // the outputs as the next layer reads them: requantized int8 (64, N) or
    // fp32 (N, 64); or d
    const float bn = __ldg(bias + col);
    const float sc = inv_next != nullptr ? __ldg(inv_next + col) : 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float z = acc[i] + bn;
      if (last) {
        if (row0 + p0 + i < a.B) a.d_out[row0 + p0 + i] = out_act_fwd(a.act, a.beta, z);
      } else if (inv_next != nullptr) {
        out[a_offset(p0 + i, col)] = static_cast<unsigned char>(requant(act_fwd(a.act, a.beta, z), sc));
      } else {
        reinterpret_cast<float*>(out)[col * kRows + p0 + i] = act_fwd(a.act, a.beta, z);
      }
    }
  }
}

// An int8 layer on the tensor cores: A (64, K) int8 in `in`, B from the ring,
// slab counter g shared with the producer. WN = NC / 4 columns a warpgroup.
template <int WN>
__device__ __forceinline__ void int8_layer(const Int8Args& a, const int* m, const float* inv_next,
                           const unsigned char* in, unsigned char* out, unsigned char* ring,
                           uint64_t* bars, float* par, int& g) {
  const int K = m[0], N = m[1], NC = 4 * WN, KB = K / kSlabK;
  const int t = threadIdx.x, wg = t / 128, tw = t % 128;
  // the epilogue's per-column dq, b and inv_sa, staged in shared memory
  float* dq = par;
  float* bias = par + N;
  float* inv = inv_next != nullptr ? par + 2 * N : nullptr;
  for (int i = t; i < N; i += kConsumers8) {
    dq[i] = __ldg(a.fw + m[5] + i);
    bias[i] = __ldg(a.fw + m[4] + i);
    if (inv != nullptr) inv[i] = __ldg(inv_next + i);
  }
  named_bar_sync(kBarConsumers, kConsumers8);
  const uint32_t a_base = smem_u32(in);
  int acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
  for (int c = 0; c < N / NC; ++c) {
    for (int kb = 0; kb < KB; ++kb, ++g) {
      const int s = await_slab(bars, kStages8, g);
      const uint32_t b_base = smem_u32(ring + s * kSlot8) + wg * WN * kSlabK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_sw128(a_base + kb * kAtomBytes + kk * 32);
        const uint64_t db = desc_sw128(b_base + kk * 32);
        if constexpr (WN == 64)
          wgmma_m64n64k32_s8(acc, da, db, (kb | kk) != 0);
        else
          wgmma_m64n32k32_s8(acc, da, db, (kb | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();   // free the slot at once: two of the three stay in flight
      release(bars, kStages8, s, tw);
    }
    fence_regs(acc);
    // register 4 g + 2 h + e: row + 8 h, column col0 + 8 g + e; the column
    // pair's dq, b and the next layer's inv_sa are loaded once for its 4 sums
    const int row = 16 * (tw / 32) + (tw % 32) / 4;
    const int col0 = c * NC + wg * WN + 2 * (tw % 4);
#pragma unroll
    for (int g = 0; g < WN / 8; ++g) {
      const int col = col0 + 8 * g;
      const float2 d2 = *reinterpret_cast<const float2*>(dq + col);
      const float2 b2 = *reinterpret_cast<const float2*>(bias + col);
      const float2 s2 = inv != nullptr ? *reinterpret_cast<const float2*>(inv + col)
                                       : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * g + 2 * h;
        const float v0 = act_fwd(a.act, a.beta,
                                 __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), d2.x), b2.x));
        const float v1 = act_fwd(a.act, a.beta,
                                 __fadd_rn(__fmul_rn(__int2float_rn(acc[i + 1]), d2.y), b2.y));
        if (inv != nullptr) {
          const unsigned lo = static_cast<unsigned char>(requant(v0, s2.x));
          const unsigned hi = static_cast<unsigned char>(requant(v1, s2.y));
          *reinterpret_cast<unsigned short*>(out + a_offset(row + 8 * h, col)) =
              static_cast<unsigned short>(lo | (hi << 8));
        } else {
          float* o = reinterpret_cast<float*>(out);
          o[col * kRows + row + 8 * h] = v0;
          o[(col + 1) * kRows + row + 8 * h] = v1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads8, 1) int8_forward_kernel(const __grid_constant__ Int8Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* x0 = ring + kStages8 * kSlot8;
  unsigned char* x1 = x0 + round1024(a.x0_bytes);
  float* par = reinterpret_cast<float*>(x1 + round1024(a.x1_bytes));
  float* hid = par + 3 * a.maxn8;
  uint64_t* bars = reinterpret_cast<uint64_t*>(hid + kMaxE * kRows);
  init_ring(bars, kStages8, 1, kConsumers8 / 128);

  if (threadIdx.x >= kConsumers8) {
    // producer: every int8 layer's slabs, in the order the consumers take them
    if (threadIdx.x == kConsumers8) {
      int g = 0;
      for (int l = 0; l < a.L; ++l) {
        const int* m = a.meta + kMeta8 * l;
        if (m[2] != kI8) continue;
        const uint32_t bytes = static_cast<uint32_t>(m[7]) * kSlabK;
        const int slabs = (m[1] / m[7]) * (m[0] / kSlabK);
        for (int i = 0; i < slabs; ++i, ++g)
          produce(bars, kStages8, ring, kSlot8, g, a.qw + m[3] + static_cast<size_t>(i) * bytes, bytes);
      }
    }
    __syncwarp();
  } else {
    const int row0 = blockIdx.x * kRows;
    encode_tile(a, row0, reinterpret_cast<float*>(x0), hid, reinterpret_cast<float*>(x1));
    int g = 0;
    for (int l = 0; l < a.L; ++l) {
      const int* m = a.meta + kMeta8 * l;
      // the previous layer's stores are done and visible to wgmma, and its reads too
      fence_proxy_async();
      named_bar_sync(kBarConsumers, kConsumers8);
      const unsigned char* in = (l & 1) ? x1 : x0;
      unsigned char* out = (l & 1) ? x0 : x1;
      const bool last = l == a.L - 1;
      const int* mn = a.meta + kMeta8 * (l + 1);
      const float* inv_next = (!last && mn[2] == kI8) ? a.fw + mn[6] : nullptr;
      if (m[2] == kF32) {
        // as many poses a task as leave every consumer thread a task
        const float* x = reinterpret_cast<const float*>(in);
        if (m[1] * (kRows / 32) >= kConsumers8)
          fp32_layer<32>(a, m, last, inv_next, x, out, row0);
        else if (m[1] * (kRows / 8) >= kConsumers8)
          fp32_layer<8>(a, m, last, inv_next, x, out, row0);
        else
          fp32_layer<1>(a, m, last, inv_next, x, out, row0);
      } else if (m[7] == 256) {
        int8_layer<64>(a, m, inv_next, in, out, ring, bars, par, g);
      } else {
        int8_layer<32>(a, m, inv_next, in, out, ring, bars, par, g);
      }
    }
  }
}

// ---- probe_bf16_chain ----

constexpr int kPW = 512;                      // the probe's width
constexpr int kPRows = 128;                   // rows of x a CTA: 64 a consumer warpgroup
constexpr int kPThreads = 384;                // two consumer warpgroups and a producer one
constexpr int kPStages = 3;
constexpr int kPSlot = 256 * kSlabK;          // 256 output channels x 64 bf16 of K: 32 KB
constexpr int kPKBlocks = kPW * 2 / kSlabK;   // 128-byte K blocks of a row: 8
constexpr int kPBlock = kPRows * kSlabK;      // one K block of the x tile: 16 KB

__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return 1024 + static_cast<size_t>(kPStages) * kPSlot + static_cast<size_t>(kPRows) * kPW * 2 +
         2 * kPStages * sizeof(uint64_t);
}

// the 128 sums of a thread's half-layer fragment as 64 bf16 pairs
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(kPThreads, 1)
    probe_bf16_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ wp,
                      int B, int layers, __nv_bfloat16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* xs = ring + kPStages * kPSlot;   // (128, 512) bf16: 8 swizzled K blocks
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + kPRows * kPW * 2);
  init_ring(bars, kPStages, 1, kConsumers / 128);

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<24>();
    // per layer: output channels 0-255, K block by K block, then 256-511
    if (threadIdx.x == kConsumers)
      for (int g = 0; g < layers * 2 * kPKBlocks; ++g)
        produce(bars, kPStages, ring, kPSlot, g, wp + static_cast<size_t>(g) * kPSlot, kPSlot);
    __syncwarp();
  } else {
    setmaxnreg_inc<240>();
    const int t = threadIdx.x, wg = t / 128, tw = t % 128;
    const int row0 = blockIdx.x * kPRows;
    // x tile: row m's 16-byte chunk ch (8 bf16) to K block ch / 8, chunk ch % 8
    for (int v = t; v < kPRows * kPW / 8; v += kConsumers) {
      const int m = v / (kPW / 8), ch = v % (kPW / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + m < B) val = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + m) * kPW)[ch];
      *reinterpret_cast<uint4*>(xs + (ch / 8) * kPBlock + sw128_offset(m, (ch % 8) * 16)) = val;
    }
    fence_proxy_async();
    named_bar_sync(kBarConsumers, kConsumers);
    // this warpgroup's 64 rows of each K block start 64 * 128 bytes in
    const uint32_t a_base = smem_u32(xs) + wg * kAtomBytes;
    const int row = 64 * wg + 16 * (tw / 32) + (tw % 32) / 4;
    float acc[128];
    uint32_t low[64];   // output channels 0-255, rounded to bf16, while 256-511 are summed
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int g = 0;
    for (int l = 0; l < layers; ++l) {
      for (int h = 0; h < 2; ++h) {
        for (int kb = 0; kb < kPKBlocks; ++kb, ++g) {
          const int s = await_slab(bars, kPStages, g);
          const uint32_t b_base = smem_u32(ring + s * kPSlot);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n256k16_bf16(acc, desc_sw128(a_base + kb * kPBlock + kk * 32),
                                  desc_sw128(b_base + kk * 32), (kb | kk) != 0);
          wgmma_commit();
          wgmma_wait<0>();
          release(bars, kPStages, s, tw);
        }
        fence_regs(acc);
        if (h == 0) {
#pragma unroll
          for (int j = 0; j < 64; ++j) low[j] = bf16_pair(acc[2 * j], acc[2 * j + 1]);
        }
      }
      // column of register pair j: 8 (j / 2) + 2 (t % 4) (+ 256 for the high half), row + 8 (j % 2)
      if (l < layers - 1) {
        named_bar_sync(kBarConsumers, kConsumers);   // every product has read x
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          const int col = 8 * (j / 2) + 2 * (tw % 4);
          const int r = row + 8 * (j % 2);
          *reinterpret_cast<uint32_t*>(xs + (col / 64) * kPBlock + sw128_offset(r, (col % 64) * 2)) = low[j];
          *reinterpret_cast<uint32_t*>(xs + (col / 64 + 4) * kPBlock + sw128_offset(r, (col % 64) * 2)) =
              bf16_pair(acc[2 * j], acc[2 * j + 1]);
        }
        fence_proxy_async();
        named_bar_sync(kBarConsumers, kConsumers);
      } else {
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          const int col = 8 * (j / 2) + 2 * (tw % 4);
          const int r = row + 8 * (j % 2);
          if (row0 + r < B) {
            uint32_t* o = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row0 + r) * kPW + col);
            o[0] = low[j];
            o[256 / 2] = bf16_pair(acc[2 * j], acc[2 * j + 1]);
          }
        }
      }
    }
  }
}

// ---- probe_int8_chain ----

constexpr int kQCW = 3;                          // consumer warpgroups, 64 rows of x each
constexpr int kQRows = 64 * kQCW;                // rows of x a CTA
constexpr int kQConsumers = 128 * kQCW;
constexpr int kQThreads = kQConsumers + 128;     // and a producer warpgroup
// registers a consumer thread takes (setmaxnreg) from what the launch gives
// the CTA once the producer warpgroup has dropped to 24
constexpr int kQRegs = (((65536 / kQThreads) / 8 * 8) * kQThreads - 128 * 24) / kQConsumers / 8 * 8;
constexpr int kQNC = 128;                        // output channels a slab: a quarter of 512
constexpr int kQParts = kPW / kQNC;              // quarters of a layer's outputs
constexpr int kQKBlocks = kPW / kSlabK;          // 128-byte K blocks of an int8 row: 4
constexpr int kQSlot = kQNC * kSlabK;            // 128 output channels x 128 of K: 16 KB
constexpr int kQStages = 8;
constexpr int kQBlock = kQRows * kSlabK;         // one K block of the x tile
constexpr uint32_t kBarTurn = 2;                 // named barriers: a warpgroup's turn at the tensor cores,
constexpr uint32_t kBarOwn = kBarTurn + kQCW;    // and its own stores, one each a warpgroup
static_assert(kQNC == kSlabK, "a quarter of the outputs is one K block of the next layer's A");
static_assert(kBarOwn + kQCW <= 16, "named barriers");

__host__ __device__ constexpr size_t int8_chain_smem_bytes() {
  return 1024 + static_cast<size_t>(kQStages) * kQSlot + static_cast<size_t>(kQRows) * kPW +
         2 * kQStages * sizeof(uint64_t);
}

// clip(rint(acc * s), +-127) as the plain chain computes it: the int32 sum
// converted exactly (|acc| < 2^24), one rounded product (no FMA), rint
// (half to even, as torch.round), the clamps branch-free
__device__ __forceinline__ signed char probe_convert(int acc, float s) {
  const float v = rintf(__fmul_rn(__int2float_rn(acc), s));
  return static_cast<signed char>(fminf(fmaxf(v, -127.f), 127.f));
}

// the four sums of register group q (4 q .. 4 q + 3 of an m64n128 fragment:
// row, columns c and c + 1; row + 8, the same columns) requantized, one byte
// each, in register order
__device__ __forceinline__ uint32_t quant4(const int (&acc)[64], int q, float s) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w |= static_cast<uint32_t>(static_cast<unsigned char>(probe_convert(acc[4 * q + e], s))) << (8 * e);
  return w;
}

// a quarter's words into the x tile: K block `part` (the quarter's 128
// output channels are the next layer's K), bytes c and c + 1 of rows `row`
// and `row` + 8
__device__ __forceinline__ void store_quarter(unsigned char* xs, int part, int row, int cq,
                                              const uint32_t (&w)[16]) {
  unsigned char* blk = xs + part * kQBlock;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int c = 8 * q + cq;
    *reinterpret_cast<unsigned short*>(blk + sw128_offset(row, c)) = static_cast<unsigned short>(w[q]);
    *reinterpret_cast<unsigned short*>(blk + sw128_offset(row + 8, c)) =
        static_cast<unsigned short>(w[q] >> 16);
  }
}

__global__ void __launch_bounds__(kQThreads, 1)
    probe_int8_kernel(const signed char* __restrict__ x, const unsigned char* __restrict__ wp,
                      const float* __restrict__ s, int B, int layers, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* xs = ring + kQStages * kQSlot;   // (kQRows, 512) int8: 4 swizzled K blocks
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + kQRows * kPW);
  init_ring(bars, kQStages, 1, kQCW);

  if (threadIdx.x >= kQConsumers) {
    setmaxnreg_dec<24>();
    // per layer: output channels 0-127, K block by K block, then 128-255, ...
    if (threadIdx.x == kQConsumers)
      for (int g = 0; g < layers * kQParts * kQKBlocks; ++g)
        produce(bars, kQStages, ring, kQSlot, g, wp + static_cast<size_t>(g) * kQSlot, kQSlot);
    __syncwarp();
  } else {
    setmaxnreg_inc<kQRegs>();
    const int t = threadIdx.x, wg = t / 128, tw = t % 128;
    const int row0 = blockIdx.x * kQRows;
    // this warpgroup's 64 rows of x: row m's 16-byte chunk ch (16 int8) to K
    // block ch / 8, chunk ch % 8; zeros past B
    for (int v = tw; v < 64 * kPW / 16; v += 128) {
      const int m = 64 * wg + v / (kPW / 16), ch = v % (kPW / 16);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + m < B) val = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + m) * kPW)[ch];
      *reinterpret_cast<uint4*>(xs + (ch / 8) * kQBlock + sw128_offset(m, (ch % 8) * 16)) = val;
    }
    fence_proxy_async();
    named_bar_sync(kBarOwn + wg, 128);
    // the turn at the tensor cores goes round the warpgroups, a quarter each:
    // warpgroup 0 starts
    const uint32_t my_turn = kBarTurn + wg, next_turn = kBarTurn + (wg + 1) % kQCW;
    if (wg == kQCW - 1) named_bar_arrive(kBarTurn, 256);
    const uint32_t a_base = smem_u32(xs) + wg * kAtomBytes;   // 64 rows x 128 bytes a warpgroup
    const int row = 64 * wg + 16 * (tw / 32) + (tw % 32) / 4;
    const int cq = 2 * (tw % 4);
    int acc[64];
    uint32_t held[kQParts - 1][16];   // quarters 0-2 requantized while the rest are summed
    int g = 0;
    for (int l = 0; l < layers; ++l) {
      const float sl = __ldg(s + l);
      const bool last = l == layers - 1;
#pragma unroll
      for (int part = 0; part < kQParts; ++part) {
        named_bar_sync(my_turn, 256);
        int prev = 0;
        for (int kb = 0; kb < kQKBlocks; ++kb, ++g) {
          const int st = await_slab(bars, kQStages, g);
          const uint32_t b_base = smem_u32(ring + st * kQSlot);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n128k32_s8(acc, desc_sw128(a_base + kb * kQBlock + kk * 32),
                                desc_sw128(b_base + kk * 32), (kb | kk) != 0);
          wgmma_commit();
          if (kb > 0) {   // the previous slab's products are done: free its slot
            wgmma_wait<1>();
            release(bars, kQStages, prev, tw);
          }
          prev = st;
        }
        // the next warpgroup's products queue behind these while this one's
        // epilogue runs (the last warpgroup passes no turn after its last quarter)
        if (!(last && part == kQParts - 1 && wg == kQCW - 1)) named_bar_arrive(next_turn, 256);
        wgmma_wait<0>();
        release(bars, kQStages, prev, tw);
        fence_regs(acc);
        // register 4 q + e: row + 8 (e / 2), column 128 part + 8 q + cq + e % 2
        if (last) {
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const int c = kQNC * part + 8 * q + cq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (row0 + row + 8 * h < B)
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row0 + row + 8 * h) * kPW + c) =
                    make_float2(static_cast<float>(probe_convert(acc[4 * q + 2 * h], sl)),
                                static_cast<float>(probe_convert(acc[4 * q + 2 * h + 1], sl)));
            }
          }
        } else if (part < kQParts - 1) {
#pragma unroll
          for (int q = 0; q < 16; ++q) held[part][q] = quant4(acc, q, sl);
        } else {
          // every product of the layer has read this warpgroup's rows of x
          uint32_t w[16];
#pragma unroll
          for (int q = 0; q < 16; ++q) w[q] = quant4(acc, q, sl);
#pragma unroll
          for (int p = 0; p < kQParts - 1; ++p) store_quarter(xs, p, row, cq, held[p]);
          store_quarter(xs, kQParts - 1, row, cq, w);
          fence_proxy_async();
          named_bar_sync(kBarOwn + wg, 128);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int posendf_forward_int8(const float* pose, int B, const float* enc, const int* parents, int J,
                         int F, const float* fw, const void* qw, const int* meta, int L,
                         int x0_bytes, int x1_bytes, int maxn8, int act, float beta,
                         float* d_out, void* stream) {
  if (J < 1 || J > kMaxJ || F < 1 || F > kMaxF || L < 1 || L > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Int8Args a{pose, B, enc, parents, J, F, fw, static_cast<const unsigned char*>(qw), meta, L,
             x0_bytes, x1_bytes, maxn8, act, beta, d_out};
  return launch_wgmma(int8_forward_kernel, (B + kRows - 1) / kRows, kThreads8,
                      int8_smem_bytes(x0_bytes, x1_bytes, maxn8), stream, a);
}

// Bytes of dynamic shared memory one CTA of posendf_forward_int8 needs.
int posendf_int8_smem_bytes(int x0_bytes, int x1_bytes, int maxn8) {
  return static_cast<int>(int8_smem_bytes(x0_bytes, x1_bytes, maxn8));
}

// x (B, 512) bf16, wp the packed weights (>= layers x 512 KB,
// fused_int8.sw128_kmajor_offsets) -> out (B, 512) bf16
int probe_bf16_chain(const void* x, const void* wp, int B, int layers, void* out, void* stream) {
  if (layers < 1 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  return launch_wgmma(probe_bf16_kernel, (B + kPRows - 1) / kPRows, kPThreads, bf16_smem_bytes(),
                      stream, static_cast<const __nv_bfloat16*>(x),
                      static_cast<const unsigned char*>(wp), B, layers,
                      static_cast<__nv_bfloat16*>(out));
}

// x (B, 512) int8, wp the packed weights (>= layers x 256 KB,
// fused_int8.sw128_kmajor_offsets with nc = 128), s (>= layers,) fp32 ->
// out (B, 512) fp32
int probe_int8_chain(const void* x, const void* wp, const float* s, int B, int layers, float* out,
                     void* stream) {
  if (layers < 1 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  return launch_wgmma(probe_int8_kernel, (B + kQRows - 1) / kQRows, kQThreads, int8_chain_smem_bytes(),
                      stream, static_cast<const signed char*>(x), static_cast<const unsigned char*>(wp),
                      s, B, layers, out);
}

const char* posendf_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
