// Device helpers shared by the port's kernels (field_kernels.cu, train_kernels.cu,
// int8_kernels.cu): the activations with JAX's derivative conventions, the
// input normalization and encoder walk of the forward kernels, and the tile
// product that every fp32 DFNet layer of every kernel runs.
//
// Derivatives at z == 0 follow JAX's autodiff: lrelu'(0) = 1, relu'(0) = 0.
// Softplus is (max(bz, 0) + log1p(exp(-|bz|))) / b everywhere.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace posendf {

constexpr int kTile = 16;      // poses per block of the tile kernels
constexpr int kThreads = 512;  // threads per block of the tile kernels
constexpr int kLoads = 16;     // weight reads a thread keeps in flight
constexpr int kMaxF = 8;       // encoder feature width limit
constexpr int kMaxE = 4 + kMaxF;
constexpr int kMaxJ = 32;
constexpr int kMaxL = 16;
constexpr int kMeta = 6;       // per layer: in, out, off W, off b, off W^T, off z
constexpr float kEps2 = 1e-24f;  // eps^2 of the normalizations (eps = 1e-12)

enum Act { kLRelu = 0, kRelu = 1, kSoftplus = 2 };

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// floats of the encoder's packed weights: w1 (J,E,E) | b1 (J,E) | w2 (J,E,F) | b2 (J,F)
__host__ __device__ constexpr int enc_floats(int J, int F) {
  return J * ((4 + F) * (4 + F) + (4 + F) + (4 + F) * F + F);
}

__device__ __forceinline__ float softplus(float beta, float z) {
  const float bz = beta * z;
  return (fmaxf(bz, 0.f) + log1pf(expf(-fabsf(bz)))) / beta;
}

__device__ __forceinline__ float act_fwd(int act, float beta, float z) {
  if (act == kLRelu) return z >= 0.f ? z : 0.01f * z;
  if (act == kRelu) return z > 0.f ? z : 0.f;
  return softplus(beta, z);
}

__device__ __forceinline__ float out_act_fwd(int act, float beta, float z) {
  if (act == kSoftplus) return softplus(beta, z);
  return z > 0.f ? z : 0.f;
}

__device__ __forceinline__ float act_grad(int act, float beta, float z) {
  if (act == kLRelu) return z >= 0.f ? 1.f : 0.01f;
  if (act == kRelu) return z > 0.f ? 1.f : 0.f;
  return 1.f / (1.f + expf(-beta * z));
}

// relu'(z) = [relu(z) > 0]; softplus: sigmoid(beta z) = 1 - exp(-beta d)
__device__ __forceinline__ float out_act_grad_from_value(int act, float beta, float d) {
  if (act == kSoftplus) return 1.f - expf(-beta * d);
  return d > 0.f ? 1.f : 0.f;
}

// For the block's kTile poses: acc(n, t) = sum_k x[k][t] * W[k][n], with x a
// (K, kTile) tile in shared memory and W (K, N) row-major in global memory.
// Thread i owns the C columns base + r * kThreads + i; `epi(n, acc)` receives
// each finished column's kTile sums. The weights of the next kLoads / C rows
// are loaded while the current rows are multiplied, so kLoads L2 reads stay
// in flight per thread.
template <int C, class Epilogue>
__device__ __forceinline__ void tile_matmul_cols(const float* __restrict__ W, int K, int N,
                                                 const float* x, Epilogue epi) {
  constexpr int kRows = kLoads / C;
  for (int base = 0; base < N; base += kThreads * C) {
    int col[C];
    bool ok[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      col[r] = base + r * kThreads + static_cast<int>(threadIdx.x);
      ok[r] = col[r] < N;
    }
    if (!ok[0]) break;  // this thread's columns lie beyond N from here on
    float acc[C][kTile];
#pragma unroll
    for (int r = 0; r < C; ++r)
#pragma unroll
      for (int t = 0; t < kTile; ++t) acc[r][t] = 0.f;
    float wcur[kRows][C], wnext[kRows][C];
    auto load_rows = [&](int k0, float(&w)[kRows][C]) {
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk)
#pragma unroll
        for (int r = 0; r < C; ++r)
          w[kk][r] = (k0 + kk < K && ok[r])
                         ? __ldg(W + static_cast<size_t>(k0 + kk) * N + col[r])
                         : 0.f;
    };
    load_rows(0, wcur);
    for (int k0 = 0; k0 < K; k0 += kRows) {
      if (k0 + kRows < K) load_rows(k0 + kRows, wnext);
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
        if (k0 + kk < K) {
          const float4* xk = reinterpret_cast<const float4*>(x + (k0 + kk) * kTile);
          float xv[kTile];
#pragma unroll
          for (int v = 0; v < kTile / 4; ++v) {
            const float4 f = xk[v];
            xv[4 * v] = f.x;
            xv[4 * v + 1] = f.y;
            xv[4 * v + 2] = f.z;
            xv[4 * v + 3] = f.w;
          }
#pragma unroll
          for (int r = 0; r < C; ++r)
#pragma unroll
            for (int t = 0; t < kTile; ++t) acc[r][t] = fmaf(wcur[kk][r], xv[t], acc[r][t]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk)
#pragma unroll
        for (int r = 0; r < C; ++r) wcur[kk][r] = wnext[kk][r];
    }
#pragma unroll
    for (int r = 0; r < C; ++r)
      if (ok[r]) epi(col[r], acc[r]);
  }
}

// Columns per thread follow N, so the widest layer keeps every thread busy:
// 2 for N = 1024, 1 below.
template <class Epilogue>
__device__ __forceinline__ void tile_matmul(const float* __restrict__ W, int K, int N,
                                            const float* x, Epilogue epi) {
  if (N > kThreads)
    tile_matmul_cols<2>(W, K, N, x, epi);
  else
    tile_matmul_cols<1>(W, K, N, x, epi);
}

// Joint-axis input normalization and the encoder walk of one pose, slot t of
// the block's tile (one thread per pose). Reads the pose's J quaternions q4
// (zeros when !valid), the encoder's weights w1 (J,E,E) | b1 (J,E) | w2 (J,E,F)
// | b2 (J,F), E = 4 + F, and the parent table from shared memory; writes the
// features to feats[(j * F + k) * kTile + t], the squared column sums s and
// norms n to norm[c * kTile + t] and norm[(4 + c) * kTile + t], and, with
// kKeep, the pre-activations to encz[(j * (E + F) + o) * kTile + t]. Joints
// are walked in index order (a parent's index is below its child's); a root
// reads a zero parent feature.
template <bool kKeep>
__device__ __forceinline__ void encode_pose(const float4* q4, bool valid, int t, int J, int F,
                                            const float* encw, const int* par, int act,
                                            float beta, float* feats, float* norm, float* encz) {
  const int E = 4 + F;
  const float* w1 = encw;
  const float* b1 = w1 + J * E * E;
  const float* w2 = b1 + J * E;
  const float* b2 = w2 + J * E * F;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float s[4] = {0.f, 0.f, 0.f, 0.f}, n[4];
  for (int j = 0; j < J; ++j) {
    const float4 q = valid ? q4[j] : zero4;
    s[0] = fmaf(q.x, q.x, s[0]);
    s[1] = fmaf(q.y, q.y, s[1]);
    s[2] = fmaf(q.z, q.z, s[2]);
    s[3] = fmaf(q.w, q.w, s[3]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) n[c] = sqrtf(fmaxf(s[c], kEps2));
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    norm[c * kTile + t] = s[c];
    norm[(4 + c) * kTile + t] = n[c];
  }
  for (int j = 0; j < J; ++j) {
    const float4 q = valid ? q4[j] : zero4;
    const int p = par[j];
    float in[kMaxE];
    in[0] = q.x / n[0];
    in[1] = q.y / n[1];
    in[2] = q.z / n[2];
    in[3] = q.w / n[3];
#pragma unroll
    for (int k = 0; k < kMaxF; ++k)
      in[4 + k] = (k < F && p >= 0) ? feats[(p * F + k) * kTile + t] : 0.f;
    const float* w1j = w1 + j * E * E;
    const float* w2j = w2 + j * E * F;
    float* zj = kKeep ? encz + j * (E + F) * kTile : nullptr;
    float h[kMaxE];
#pragma unroll
    for (int o = 0; o < kMaxE; ++o) {
      if (o < E) {
        float z = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxE; ++i)
          if (i < E) z = fmaf(in[i], w1j[i * E + o], z);
        z += b1[j * E + o];
        if (kKeep) zj[o * kTile + t] = z;
        h[o] = act_fwd(act, beta, z);
      } else {
        h[o] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxF; ++k) {
      if (k < F) {
        float z = 0.f;
#pragma unroll
        for (int o = 0; o < kMaxE; ++o)
          if (o < E) z = fmaf(h[o], w2j[o * F + k], z);
        z += b2[j * F + k];
        if (kKeep) zj[(E + k) * kTile + t] = z;
        feats[(j * F + k) * kTile + t] = act_fwd(act, beta, z);
      }
    }
  }
}

__device__ __forceinline__ void store_tile_column(float* dst, const float (&v)[kTile]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < kTile / 4; ++i)
    d4[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void load_tile_column(const float* src, float (&v)[kTile]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kTile / 4; ++i) {
    const float4 f = s4[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

}  // namespace posendf
