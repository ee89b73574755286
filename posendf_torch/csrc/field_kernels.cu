// Hand-written Hopper kernels for the PoseNDF distance field (sm_90a, fp32).
//
// Three kernels share one body, `field_kernel<Mode>`:
//
//   posendf_forward         replaces posendf_tpu/ops/fused_model.py::_model_kernel
//                           (whole forward: encoder walk + DFNet + output act)
//   posendf_value_and_grad  replaces posendf_tpu/ops/fused_grad.py::_vag_kernel
//                           (d and the input gradient in one program)
//   posendf_project_step    replaces posendf_tpu/ops/fused_grad.py::_proj_kernel
//                           (one whole projection step)
//
// Every kernel reads the caller's (B, 21, 4) fp32 poses directly (one pose is
// 84 consecutive floats; the TPU kernels' (J, 4, B) layout was a lane trick)
// and folds the reference's joint-axis input normalization in, so all three
// take raw poses. In the value-and-grad kernel this also folds in the
// normalization's VJP, which the TPU kernel left to XLA outside the call.
// The ragged last tile is masked, not padded.
//
// What bounds them on an H100: the DFNet's ~1.37M multiply-adds per pose
// (twice that with the input-only backward) on the fp32 CUDA cores, and the
// weight reads. A block owns a tile of kTile = 16 poses, and the 5.5 MB of
// fp32 DFNet weights (11 MB with the transposes the backward reads) do not
// fit in a block's 227 KB of shared memory as they fit in a TPU core's VMEM,
// so every tile streams the whole set from the 50 MB L2. Each weight read is
// used for 16 poses, i.e. 8 FLOP per byte of L2 traffic, which is why the
// tile is as large as the activations allow: the inter-layer activations of
// a tile ping-pong in shared memory (2 x 1024 x 16 floats), and only the
// poses come in and d (and g or the next pose) go out through device memory.
// Everything is fp32 on the CUDA cores with no tensor cores, TMA or wgmma:
// simple and right first.
//
// Work split inside a block (512 threads):
//   * encoder (forward and backward): one thread per pose walks the 21
//     joints in index order (every parent index is smaller than its child's),
//     with the encoder's 3.7k weights in shared memory (the forward walk is
//     common.cuh's encode_pose, shared with int8_kernels.cu). Roots read a zero
//     parent feature. The backward walks in reverse and adds W1b^T gh into
//     the parent's feature gradient.
//   * DFNet layers: each thread owns 1 or 2 output columns (2 only for the
//     1024-wide layer) and keeps kTile accumulators per column; the tile's
//     input row is a broadcast read from shared memory and the weight row is
//     read coalesced from L2. A thread loads the weights of its next rows
//     while it multiplies the current ones, so 16 L2 reads stay in flight:
//     with one block per SM, L2 latency and not bandwidth is what the 16
//     warps have to hide (more warps with fewer columns each beat fewer
//     warps with more columns and more registers, measured on the card).
//     The backward g_in = (g_out W^T) * act'(z) runs the same routine on W^T,
//     packed once per field beside W.
//   * The forward's pre-activations (needed for act' in the backward) go to
//     a global scratch buffer the caller allocates; the output activation's
//     derivative is recovered from d, as on the TPU.
//
// The activations and the tile product live in common.cuh, shared with
// train_kernels.cu.
//
// Each launcher returns cudaGetLastError(); the Python wrapper raises on a
// nonzero value. No launcher synchronizes or allocates.

#include "common.cuh"

namespace {

using namespace posendf;

enum Mode { kForward = 0, kValueAndGrad = 1, kProjectStep = 2 };

struct Args {
  const float* pose;   // (B, J, 4)
  int B;
  const float* enc;    // w1 (J,E,E) | b1 (J,E) | w2 (J,E,F) | b2 (J,F), E = 4 + F
  const int* parents;  // (J,), -1 = root
  int J, F;
  const float* dfw;    // packed DFNet: per layer W (in,out), b (out), W^T (out,in)
  const int* meta;     // (L, kMeta)
  int L, maxw, zsum;   // layers, widest activation, sum of hidden widths
  int act;
  float beta;
  float* d_out;        // (B,)
  float* g_out;        // (B, J, 4) value-and-grad
  float* q_out;        // (B, J, 4) projection step
  float* zscratch;     // (tiles, zsum, kTile) hidden pre-activations
  float step_scale;
  int tangent, renormalize;
};

// Shared memory layout, in floats (every region a multiple of 4):
//   encoder weights | meta (int) | parents (int) | activations A | activations B |
//   encoder pre-activations | gx | s and n of the normalization | d
__host__ __device__ inline size_t smem_floats(int J, int F, int L, int maxw) {
  const int E = 4 + F;
  return static_cast<size_t>(round4(J * (E * E + E + E * F + F))) + round4(kMeta * L) +
         round4(J) + 2 * static_cast<size_t>(maxw) * kTile + J * (E + F) * kTile +
         J * 4 * kTile + 8 * kTile + kTile;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) field_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int J = a.J, F = a.F, E = 4 + F, L = a.L;
  const int enc_floats = J * (E * E + E + E * F + F);

  float* encw = smem;
  int* meta = reinterpret_cast<int*>(encw + round4(enc_floats));
  int* par = meta + round4(kMeta * L);
  float* bufA = reinterpret_cast<float*>(par + round4(J));
  float* bufB = bufA + a.maxw * kTile;
  float* encz = bufB + a.maxw * kTile;         // (J, E + F, kTile)
  float* gx = encz + J * (E + F) * kTile;      // (J, 4, kTile)
  float* norm = gx + J * 4 * kTile;            // s (4, kTile) then n (4, kTile)
  float* dval = norm + 8 * kTile;              // (kTile,)

  for (int i = threadIdx.x; i < enc_floats; i += kThreads) encw[i] = a.enc[i];
  for (int i = threadIdx.x; i < kMeta * L; i += kThreads) meta[i] = a.meta[i];
  for (int i = threadIdx.x; i < J; i += kThreads) par[i] = a.parents[i];
  __syncthreads();

  const float* w1 = encw;                      // (J, E, E), then b1 (J, E)
  const float* w2 = w1 + J * E * E + J * E;    // (J, E, F), then b2 (J, F)

  const int t = threadIdx.x;              // pose slot in the per-pose phases
  const int b = blockIdx.x * kTile + t;
  const bool valid = t < kTile && b < a.B;
  const float4* q4 = reinterpret_cast<const float4*>(a.pose) + static_cast<size_t>(b) * J;

  // ---- input normalization and encoder forward: one thread per pose ----
  if (t < kTile)
    encode_pose<kMode != kForward>(q4, valid, t, J, F, encw, par, a.act, a.beta, bufA, norm, encz);
  __syncthreads();

  // ---- DFNet forward: activations ping-pong between A and B ----
  float* cur = bufA;
  float* nxt = bufB;
  float* zbase = kMode != kForward
                     ? a.zscratch + static_cast<size_t>(blockIdx.x) * a.zsum * kTile
                     : nullptr;
  for (int l = 0; l < L; ++l) {
    const int* m = meta + kMeta * l;
    const float* W = a.dfw + m[2];
    const float* bias = a.dfw + m[3];
    if (l < L - 1) {
      float* zs = zbase ? zbase + static_cast<size_t>(m[5]) * kTile : nullptr;
      float* y = nxt;
      tile_matmul(W, m[0], m[1], cur, [&](int col, const float(&acc)[kTile]) {
        const float bn = __ldg(bias + col);
        float z[kTile], v[kTile];
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt) {
          z[tt] = acc[tt] + bn;
          v[tt] = act_fwd(a.act, a.beta, z[tt]);
        }
        if (zs) store_tile_column(zs + col * kTile, z);
        store_tile_column(y + col * kTile, v);
      });
    } else {
      tile_matmul(W, m[0], m[1], cur, [&](int col, const float(&acc)[kTile]) {
        const float bn = __ldg(bias + col);
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt) dval[tt] = out_act_fwd(a.act, a.beta, acc[tt] + bn);
      });
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (kMode == kForward) {
    if (valid) a.d_out[b] = dval[t];
    return;
  }

  // ---- DFNet backward (unit cotangent, input gradient only) ----
  if (t < kTile) cur[t] = out_act_grad_from_value(a.act, a.beta, dval[t]);
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const int* m = meta + kMeta * l;
    const float* Wt = a.dfw + m[4];  // (out, in)
    const float* zprev = l > 0 ? zbase + static_cast<size_t>(meta[kMeta * (l - 1) + 5]) * kTile
                               : nullptr;
    float* y = nxt;
    tile_matmul(Wt, m[1], m[0], cur, [&](int col, const float(&acc)[kTile]) {
      float g[kTile];
      if (zprev) {
        float z[kTile];
        load_tile_column(zprev + col * kTile, z);
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt) g[tt] = acc[tt] * act_grad(a.act, a.beta, z[tt]);
      } else {
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt) g[tt] = acc[tt];
      }
      store_tile_column(y + col * kTile, g);
    });
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // cur now holds the code gradient (J * F, kTile)

  if (t >= kTile) return;

  // ---- encoder backward: reverse joint walk, one thread per pose ----
  for (int j = J - 1; j >= 0; --j) {
    const int p = par[j];
    const float* w1j = w1 + j * E * E;
    const float* w2j = w2 + j * E * F;
    const float* zj = encz + j * (E + F) * kTile;
    float gf[kMaxF];
#pragma unroll
    for (int k = 0; k < kMaxF; ++k)
      gf[k] = k < F ? cur[(j * F + k) * kTile + t] *
                          act_grad(a.act, a.beta, zj[(E + k) * kTile + t])
                    : 0.f;
    float gh[kMaxE];
#pragma unroll
    for (int o = 0; o < kMaxE; ++o) {
      float s = 0.f;
      if (o < E) {
#pragma unroll
        for (int k = 0; k < kMaxF; ++k)
          if (k < F) s = fmaf(w2j[o * F + k], gf[k], s);
        s *= act_grad(a.act, a.beta, zj[o * kTile + t]);
      }
      gh[o] = s;
    }
#pragma unroll
    for (int i = 0; i < kMaxE; ++i) {
      if (i < E && (i < 4 || p >= 0)) {
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < kMaxE; ++o)
          if (o < E) s = fmaf(w1j[i * E + o], gh[o], s);
        if (i < 4)
          gx[(j * 4 + i) * kTile + t] = s;
        else
          cur[(p * F + i - 4) * kTile + t] += s;
      }
    }
  }

  if (!valid) return;

  // ---- normalization VJP, then write g or take the projection step ----
  // x = q / n  =>  g_q = gx / n - q * [s >= eps^2] <gx, q>_J / n^3
  float s[4], n[4], scale[4], dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < J; ++j) {
    const float4 q = q4[j];
    dot[0] = fmaf(gx[(j * 4 + 0) * kTile + t], q.x, dot[0]);
    dot[1] = fmaf(gx[(j * 4 + 1) * kTile + t], q.y, dot[1]);
    dot[2] = fmaf(gx[(j * 4 + 2) * kTile + t], q.z, dot[2]);
    dot[3] = fmaf(gx[(j * 4 + 3) * kTile + t], q.w, dot[3]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[c] = norm[c * kTile + t];
    n[c] = norm[(4 + c) * kTile + t];
    scale[c] = s[c] >= kEps2 ? dot[c] / (n[c] * n[c] * n[c]) : 0.f;
  }
  const float d = dval[t];
  a.d_out[b] = d;
  const float sd = a.step_scale * d;
  for (int j = 0; j < J; ++j) {
    const float4 q4j = q4[j];
    const float q[4] = {q4j.x, q4j.y, q4j.z, q4j.w};
    float g[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float gxc = gx[(j * 4 + c) * kTile + t];
      g[c] = gxc / n[c] - q[c] * scale[c];
    }
    if (kMode == kValueAndGrad) {
      reinterpret_cast<float4*>(a.g_out)[static_cast<size_t>(b) * J + j] =
          make_float4(g[0], g[1], g[2], g[3]);
      continue;
    }
    if (a.tangent) {
      const float r = g[0] * q[0] + g[1] * q[1] + g[2] * q[2] + g[3] * q[3];
#pragma unroll
      for (int c = 0; c < 4; ++c) g[c] -= r * q[c];
    }
    float qn[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) qn[c] = q[c] - sd * g[c];
    if (a.renormalize) {
      const float nn = sqrtf(fmaxf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3],
                                   kEps2));
#pragma unroll
      for (int c = 0; c < 4; ++c) qn[c] /= nn;
    }
    reinterpret_cast<float4*>(a.q_out)[static_cast<size_t>(b) * J + j] =
        make_float4(qn[0], qn[1], qn[2], qn[3]);
  }
}

template <int kMode>
int launch(const Args& a, void* stream) {
  if (a.J < 1 || a.J > kMaxJ || a.F < 1 || a.F > kMaxF || a.L < 1 || a.L > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return 0;
  const size_t smem = smem_floats(a.J, a.F, a.L, a.maxw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(field_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.B + kTile - 1) / kTile;
  field_kernel<kMode><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args common_args(const float* pose, int B, const float* enc, const int* parents, int J, int F,
                 const float* dfw, const int* meta, int L, int maxw, int zsum, int act,
                 float beta) {
  Args a{};
  a.pose = pose;
  a.B = B;
  a.enc = enc;
  a.parents = parents;
  a.J = J;
  a.F = F;
  a.dfw = dfw;
  a.meta = meta;
  a.L = L;
  a.maxw = maxw;
  a.zsum = zsum;
  a.act = act;
  a.beta = beta;
  a.step_scale = 1.f;
  return a;
}

}  // namespace

extern "C" {

int posendf_forward(const float* pose, int B, const float* enc, const int* parents, int J, int F,
                    const float* dfw, const int* meta, int L, int maxw, int zsum, int act,
                    float beta, float* d_out, void* stream) {
  Args a = common_args(pose, B, enc, parents, J, F, dfw, meta, L, maxw, zsum, act, beta);
  a.d_out = d_out;
  return launch<kForward>(a, stream);
}

int posendf_value_and_grad(const float* pose, int B, const float* enc, const int* parents, int J,
                           int F, const float* dfw, const int* meta, int L, int maxw, int zsum,
                           int act, float beta, float* d_out, float* g_out,
                           float* zscratch, void* stream) {
  Args a = common_args(pose, B, enc, parents, J, F, dfw, meta, L, maxw, zsum, act, beta);
  a.d_out = d_out;
  a.g_out = g_out;
  a.zscratch = zscratch;
  return launch<kValueAndGrad>(a, stream);
}

int posendf_project_step(const float* pose, int B, const float* enc, const int* parents, int J,
                         int F, const float* dfw, const int* meta, int L, int maxw, int zsum,
                         int act, float beta, float* d_out, float* q_out,
                         float* zscratch, float step_scale, int tangent, int renormalize,
                         void* stream) {
  Args a = common_args(pose, B, enc, parents, J, F, dfw, meta, L, maxw, zsum, act, beta);
  a.d_out = d_out;
  a.q_out = q_out;
  a.zscratch = zscratch;
  a.step_scale = step_scale;
  a.tangent = tangent;
  a.renormalize = renormalize;
  return launch<kProjectStep>(a, stream);
}

// Bytes of dynamic shared memory one block needs, for the wrapper's check.
int posendf_smem_bytes(int J, int F, int L, int maxw) {
  return static_cast<int>(smem_floats(J, F, L, maxw) * sizeof(float));
}

const char* posendf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
