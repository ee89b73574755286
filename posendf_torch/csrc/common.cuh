// Device helpers shared by the port's kernels (field_kernels.cu, train_kernels.cu,
// int8_kernels.cu, knn_kernels.cu): the activations with JAX's derivative
// conventions and the limits and table layouts the kernels share.
//
// Derivatives at z == 0 follow JAX's autodiff: lrelu'(0) = 1, relu'(0) = 0.
// Softplus is (max(bz, 0) + log1p(exp(-|bz|))) / b everywhere.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace posendf {

constexpr int kMaxF = 8;       // encoder feature width limit
constexpr int kMaxE = 4 + kMaxF;
constexpr int kMaxJ = 32;
constexpr int kMaxL = 16;
constexpr int kMeta = 2;       // per layer of the layer table: in, out
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

// softplus(beta, z), to the bit, and with `slope` its slope act'(z) =
// sigmoid(bz) into s, from the same exp t = exp(-|bz|): s = 1 / (1 + t) for
// bz >= 0, which is 1 / (1 + exp(-bz)) to the bit, and t / (1 + t) below,
// where that form's exp(|bz|) overflows past |bz| = 88.7. The field kernels
// keep s as softplus's derivative state, so that their backward multiplies
// by it as by lrelu's bit's slope.
__device__ __forceinline__ float softplus_slope(float beta, float z, bool slope, float& s) {
  const float bz = beta * z;
  const float t = expf(-fabsf(bz));
  if (slope) s = (bz >= 0.f ? 1.f : t) / (1.f + t);
  return (fmaxf(bz, 0.f) + log1pf(t)) / beta;
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

// lrelu's and relu's act'(z) takes two values, so the field kernels keep it
// as one bit: act_grad_bit(act, act_bit(act, z)) is act'(z) for every z (z
// == 0 and NaN included)
__device__ __forceinline__ uint32_t act_bit(int act, float z) {
  return act == kLRelu ? (z >= 0.f ? 1u : 0u) : (z > 0.f ? 1u : 0u);
}

__device__ __forceinline__ float act_grad_bit(int act, uint32_t bit) {
  return bit ? 1.f : (act == kLRelu ? 0.01f : 0.f);
}

// relu'(z) = [relu(z) > 0]; softplus: sigmoid(beta z) = 1 - exp(-beta d)
__device__ __forceinline__ float out_act_grad_from_value(int act, float beta, float d) {
  if (act == kSoftplus) return 1.f - expf(-beta * d);
  return d > 0.f ? 1.f : 0.f;
}

}  // namespace posendf
