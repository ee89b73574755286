// Hand-written Hopper kernels of the training path (sm_90a, fp32; the
// reduction's products on the tensor cores in 3xTF32).
//
//   posendf_encoder       replaces posendf_tpu/ops/fused_encoder.py::_encoder_kernel
//                         (the 21-joint structure encoder alone, forward only)
//   posendf_train_tile    \  together replace posendf_tpu/ops/fused_train.py::_train_kernel
//   posendf_train_reduce  /  (the full parameter gradient of losses.training_loss)
//
// ---- The encoder ----
// One thread per pose walks the joints in index order (every parent index is
// smaller than its child's) with the encoder's 3.7k weights in shared memory;
// the block's features live in shared memory too, indexed by the parent
// table, and leave in one coalesced copy of the block's run of the (B, J*F)
// output (the JAX layout). At 131,072 poses it moves 110 MB and does 0.88
// GFLOP, so it is bound by bytes.
//
// ---- The training gradient ----
// What it computes is manual_train_grads (ops/train_grad.py) for lrelu/relu,
// where act'' = 0. On the TPU one kernel per branch kept the 1.37M gradient
// accumulators in VMEM across a sequential grid. Blocks here run in parallel,
// and a private copy of the gradient per 16-pose block would be 6.8 GB at the
// reference batch, so the work is split in two launches:
//
//   posendf_train_tile, one block per 16-pose tile, for one branch:
//     A. normalize (noisy branch), encoder and DFNet forward; the layer
//        inputs x_l go to global scratch, act'(z_l) stays in shared memory
//        as one bit per pose and unit; the distance loss and its d-cotangent
//        dd (weight / B times sign(r) or 2r, 0 on the ragged tail);
//        inner pullback with a unit cotangent: c_l to global scratch, then
//        the encoder's reverse walk (gh_j, gf_j, gx_j).
//     B. (noisy) the normalization VJP, the eikonal term and its cotangent,
//        through the VJP's symmetric adjoint (Ggx).
//     C. (noisy) the e-chain: the encoder half walks parents before
//        children, the DFNet half goes upward; each layer's e-cotangent
//        ecx_l is folded into the scratch in place: a_l = ecx_l + dd x_l.
//     The encoder's weight gradient of the tile and its loss sums go to a
//     per-block slot, summed over the tile's poses in a fixed order.
//   posendf_train_reduce, one CTA per 128 x 128 output tile of every layer
//   and range of 2,048 rows of one branch (wgmma, 3xTF32: see the section's
//   note), then one kernel that adds the ranges:
//     dW_l = a_l^T c_l over the noisy rows + (dd x_l)^T c_l over the manifold
//     rows, and db_l = dd^T c_l; and the per-block encoder and loss slots,
//     summed in block order.
//
// Why one product per branch suffices: with act'' = 0 the downward backward
// of phase D is linear in its start dd * c_{L-1}, so its cotangents are
// exactly dd * c_l, and x_l^T (dd c_l) + ecx_l^T c_l = (dd x_l + ecx_l)^T c_l.
// The same holds for the encoder (czh = dd gh, czf = dd gf). So the noisy
// branch runs 3 traversals of the network per pose in the tile kernel and 1
// in the reduction, the manifold branch 2 and 1, where the TPU kernel's phase
// list runs 4 + 2. Every sum runs in a fixed order and no float atomics are
// used, so two runs give the same bits.
//
// What bounds it on an H100: the tile kernel's fp32 FMAs (6 traversals of
// 1.36M multiply-adds per pose pair) on the CUDA cores; the reduction's one
// traversal runs on the tensor cores; the scratch (21.5 KB per pose) is
// written once and read once, ~0.3 ms at the reference batch.
//
// Each launcher returns cudaGetLastError(); no launcher synchronizes or
// allocates (the wrapper allocates the scratch and slots with torch.empty).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace posendf;
using namespace hopper;

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------

constexpr int kEncThreads = 64;  // poses per block, one thread each

// Shared memory, in floats: encoder weights | parents | features (J*F rows of
// kEncThreads + 1: the pad keeps the output copy free of bank conflicts).
__host__ __device__ inline size_t encoder_smem_floats(int J, int F) {
  return static_cast<size_t>(round4(enc_floats(J, F))) + round4(J) +
         static_cast<size_t>(J) * F * (kEncThreads + 1);
}

__global__ void __launch_bounds__(kEncThreads) encoder_kernel(
    const float* __restrict__ quat, int B, const float* __restrict__ enc,
    const int* __restrict__ parents, int J, int F, int act, float beta,
    float* __restrict__ out) {
  extern __shared__ float4 enc_smem4[];
  float* w = reinterpret_cast<float*>(enc_smem4);
  const int E = 4 + F, JF = J * F, ld = kEncThreads + 1;
  const int nw = enc_floats(J, F);
  int* par = reinterpret_cast<int*>(w + round4(nw));
  float* feats = reinterpret_cast<float*>(par + round4(J));  // (J*F, ld)
  for (int i = threadIdx.x; i < nw; i += kEncThreads) w[i] = enc[i];
  for (int i = threadIdx.x; i < J; i += kEncThreads) par[i] = parents[i];
  __syncthreads();
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kEncThreads;
  const int b = b0 + t;

  const float* w1 = w;                 // (J, E, E)
  const float* b1 = w1 + J * E * E;    // (J, E)
  const float* w2 = b1 + J * E;        // (J, E, F)
  const float* b2 = w2 + J * E * F;    // (J, F)
  if (b < B) {
    const float4* q4 = reinterpret_cast<const float4*>(quat) + static_cast<size_t>(b) * J;
    for (int j = 0; j < J; ++j) {
      const float4 q = q4[j];
      const int p = par[j];
      float in[kMaxE];
      in[0] = q.x;
      in[1] = q.y;
      in[2] = q.z;
      in[3] = q.w;
#pragma unroll
      for (int k = 0; k < kMaxF; ++k)
        in[4 + k] = (k < F && p >= 0) ? feats[(p * F + k) * ld + t] : 0.f;
      const float* w1j = w1 + j * E * E;
      const float* w2j = w2 + j * E * F;
      float h[kMaxE];
#pragma unroll
      for (int u = 0; u < kMaxE; ++u) {
        float z = 0.f;
        if (u < E) {
#pragma unroll
          for (int i = 0; i < kMaxE; ++i)
            if (i < E) z = fmaf(in[i], w1j[i * E + u], z);
          z = act_fwd(act, beta, z + b1[j * E + u]);
        }
        h[u] = z;
      }
#pragma unroll
      for (int k = 0; k < kMaxF; ++k) {
        if (k < F) {
          float z = 0.f;
#pragma unroll
          for (int u = 0; u < kMaxE; ++u)
            if (u < E) z = fmaf(h[u], w2j[u * F + k], z);
          feats[(j * F + k) * ld + t] = act_fwd(act, beta, z + b2[j * F + k]);
        }
      }
    }
  }
  __syncthreads();
  // the block's poses are one contiguous run of the (B, J*F) output
  const int n = min(kEncThreads, B - b0) * JF;
  float* o = out + static_cast<size_t>(b0) * JF;
  for (int e = t; e < n; e += kEncThreads) {
    const int tt = e / JF;
    o[e] = feats[(e - tt * JF) * ld + tt];
  }
}

// ---------------------------------------------------------------------------
// training gradient, per-tile kernel
// ---------------------------------------------------------------------------

struct TrainArgs {
  const float* pose;   // (B, J, 4) rows of this branch
  int B;
  const float* gt;     // (B,) distance labels; nullptr on the manifold branch (0)
  const float* enc;    // packed encoder weights (common.cuh enc_floats)
  const int* parents;  // (J,)
  int J, F;
  const float* dfw;    // packed DFNet: per layer W (in,out), b (out), W^T (out,in)
  const int* meta;     // (L, kMeta)
  int L, maxw, zsum;
  int act;             // kLRelu or kRelu (act'' = 0)
  int eikonal;         // 1: noisy branch (normalized input, eikonal term); 0: manifold
  int l2;              // distance loss: 0 = L1, 1 = L2
  float dd_coef;       // weight of the distance term / B
  float eik_coef;      // 2 * weight of the eikonal term / (B * J)
  float* a_scr;        // per layer l a (B, in_l) block: x_l, then dd x_l + ecx_l (noisy)
  float* c_scr;        // per layer l a (B, out_l) block: c_l
  float* dd_out;       // (B,)
  float* enc_slot;     // (blocks, enc_floats)
  float* loss_slot;    // (blocks, 2): sum of the distance term, of the eikonal term
};

// the ping-pong buffers must also hold the encoder's per-joint vectors of phase C
__host__ __device__ inline int train_buf_width(int J, int F, int maxw) {
  const int need = J * (3 * (4 + F) + F);
  return need > maxw ? need : maxw;
}

// Shared memory, in floats: encoder weights | meta | parents | buffer A |
// buffer B | encoder pre-activations (J, E+F, kTile) | act' bits (zsum) |
// gx (J, 4, kTile) | per-pose scalars (12, kTile)
__host__ __device__ inline size_t train_smem_floats(int J, int F, int L, int maxw, int zsum) {
  const int E = 4 + F;
  return static_cast<size_t>(round4(enc_floats(J, F))) + round4(kMeta * L) + round4(J) +
         2 * static_cast<size_t>(train_buf_width(J, F, maxw)) * kTile + J * (E + F) * kTile +
         round4(zsum) + J * 4 * kTile + 12 * kTile;
}

// per-pose scalars
enum { kS = 0, kN = 4, kD = 8, kDD = 9, kLSum = 10, kESum = 11 };

__device__ __forceinline__ float act_grad_bit(int act, uint32_t bits, int t) {
  const bool on = (bits >> t) & 1u;
  return on ? 1.f : (act == kLRelu ? 0.01f : 0.f);
}

__global__ void __launch_bounds__(kThreads) train_tile_kernel(const TrainArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int J = a.J, F = a.F, E = 4 + F, L = a.L;
  const int nenc = enc_floats(J, F);
  const int bw = train_buf_width(J, F, a.maxw);

  float* encw = smem;
  int* meta = reinterpret_cast<int*>(encw + round4(nenc));
  int* par = meta + round4(kMeta * L);
  float* bufA = reinterpret_cast<float*>(par + round4(J));
  float* bufB = bufA + static_cast<size_t>(bw) * kTile;
  float* encz = bufB + static_cast<size_t>(bw) * kTile;  // (J, E + F, kTile): zh then zf
  uint32_t* mask = reinterpret_cast<uint32_t*>(encz + J * (E + F) * kTile);  // (zsum,)
  float* gx = reinterpret_cast<float*>(mask + round4(a.zsum));                // (J, 4, kTile)
  float* ps = gx + J * 4 * kTile;                                             // (12, kTile)

  for (int i = threadIdx.x; i < nenc; i += kThreads) encw[i] = a.enc[i];
  for (int i = threadIdx.x; i < kMeta * L; i += kThreads) meta[i] = a.meta[i];
  for (int i = threadIdx.x; i < J; i += kThreads) par[i] = a.parents[i];
  __syncthreads();

  const float* w1 = encw;                 // (J, E, E)
  const float* b1 = w1 + J * E * E;       // (J, E)
  const float* w2 = b1 + J * E;           // (J, E, F)
  const float* b2 = w2 + J * E * F;       // (J, F)

  const int tid = threadIdx.x;
  const int t = tid;                      // pose slot in the per-pose phases
  const int b0 = blockIdx.x * kTile;
  const int b = b0 + t;
  const bool valid = t < kTile && b < a.B;
  const int nvalid = min(kTile, a.B - b0);
  const float4* q4 = reinterpret_cast<const float4*>(a.pose) + static_cast<size_t>(b) * J;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int in0 = meta[0];

  // scratch offsets of layer l: a block at B * sum_{m<l} in_m, c block at B * sum_{m<l} out_m
  auto a_layer = [&](int l) {
    size_t off = 0;
    for (int m = 0; m < l; ++m) off += meta[kMeta * m];
    return a.a_scr + off * a.B;
  };
  auto c_layer = [&](int l) {
    size_t off = 0;
    for (int m = 0; m < l; ++m) off += meta[kMeta * m + 1];
    return a.c_scr + off * a.B;
  };

  // ---- A. normalization and encoder forward: one thread per pose ----
  if (t < kTile) {
    float n[4] = {1.f, 1.f, 1.f, 1.f}, s[4] = {1.f, 1.f, 1.f, 1.f};
    if (a.eikonal) {
      s[0] = s[1] = s[2] = s[3] = 0.f;
      for (int j = 0; j < J; ++j) {
        const float4 q = valid ? q4[j] : zero4;
        s[0] = fmaf(q.x, q.x, s[0]);
        s[1] = fmaf(q.y, q.y, s[1]);
        s[2] = fmaf(q.z, q.z, s[2]);
        s[3] = fmaf(q.w, q.w, s[3]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) n[c] = sqrtf(fmaxf(s[c], kEps2));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ps[(kS + c) * kTile + t] = s[c];
      ps[(kN + c) * kTile + t] = n[c];
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
        in[4 + k] = (k < F && p >= 0) ? bufA[(p * F + k) * kTile + t] : 0.f;
      const float* w1j = w1 + j * E * E;
      const float* w2j = w2 + j * E * F;
      float* zj = encz + j * (E + F) * kTile;
      float h[kMaxE];
#pragma unroll
      for (int u = 0; u < kMaxE; ++u) {
        h[u] = 0.f;
        if (u < E) {
          float z = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxE; ++i)
            if (i < E) z = fmaf(in[i], w1j[i * E + u], z);
          z += b1[j * E + u];
          zj[u * kTile + t] = z;
          h[u] = act_fwd(a.act, 0.f, z);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxF; ++k) {
        if (k < F) {
          float z = 0.f;
#pragma unroll
          for (int u = 0; u < kMaxE; ++u)
            if (u < E) z = fmaf(h[u], w2j[u * F + k], z);
          z += b2[j * F + k];
          zj[(E + k) * kTile + t] = z;
          bufA[(j * F + k) * kTile + t] = act_fwd(a.act, 0.f, z);
        }
      }
    }
  }
  __syncthreads();

  // ---- A. DFNet forward; x_0 (the code) and every hidden x_l to the scratch ----
  {
    float* x0 = a.a_scr;
    for (int e = tid; e < nvalid * in0; e += kThreads) {
      const int tt = e / in0, k = e - tt * in0;
      x0[static_cast<size_t>(b0 + tt) * in0 + k] = bufA[k * kTile + tt];
    }
  }
  float* cur = bufA;
  float* nxt = bufB;
  for (int l = 0; l < L; ++l) {
    const int* m = meta + kMeta * l;
    const float* W = a.dfw + m[2];
    const float* bias = a.dfw + m[3];
    const int out = m[1];
    if (l < L - 1) {
      uint32_t* ml = mask + m[5];
      float* xg = a_layer(l + 1);
      tile_matmul(W, m[0], out, cur, [&](int col, const float(&acc)[kTile]) {
        const float bn = __ldg(bias + col);
        float v[kTile];
        uint32_t bits = 0;
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt) {
          const float z = acc[tt] + bn;
          v[tt] = act_fwd(a.act, 0.f, z);
          const bool on = a.act == kLRelu ? z >= 0.f : z > 0.f;
          bits |= static_cast<uint32_t>(on) << tt;
        }
        ml[col] = bits;
        store_tile_column(nxt + col * kTile, v);
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt)
          if (tt < nvalid) xg[static_cast<size_t>(b0 + tt) * out + col] = v[tt];
      });
    } else {
      tile_matmul(W, m[0], out, cur, [&](int col, const float(&acc)[kTile]) {
        const float bn = __ldg(bias + col);
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt)
          ps[kD * kTile + tt] = out_act_fwd(a.act, 0.f, acc[tt] + bn);
      });
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // ---- A/B. distance loss, its cotangent dd, and c_{L-1} = out_act'(z) ----
  if (t < kTile) {
    const float d = ps[kD * kTile + t];
    float lsum = 0.f, dd = 0.f;
    if (valid) {
      const float r = d - (a.gt ? a.gt[b] : 0.f);
      if (a.l2) {
        lsum = r * r;
        dd = a.dd_coef * 2.f * r;
      } else {
        lsum = fabsf(r);
        dd = a.dd_coef * static_cast<float>((r > 0.f) - (r < 0.f));
      }
      a.dd_out[b] = dd;
    }
    ps[kLSum * kTile + t] = lsum;
    ps[kDD * kTile + t] = dd;
    ps[kESum * kTile + t] = 0.f;
    const float c = d > 0.f ? 1.f : 0.f;
    cur[t] = c;
    if (valid) c_layer(L - 1)[b] = c;
  }
  __syncthreads();

  // ---- A. inner pullback: c_{l-1} = (c_l W_l^T) act'(z_{l-1}); the code gradient last ----
  for (int l = L - 1; l >= 0; --l) {
    const int* m = meta + kMeta * l;
    const float* Wt = a.dfw + m[4];  // (out, in)
    const int in = m[0];
    if (l > 0) {
      const uint32_t* ml = mask + meta[kMeta * (l - 1) + 5];
      float* cg = c_layer(l - 1);
      tile_matmul(Wt, m[1], in, cur, [&](int col, const float(&acc)[kTile]) {
        const uint32_t bits = ml[col];
        float g[kTile];
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt) g[tt] = acc[tt] * act_grad_bit(a.act, bits, tt);
        store_tile_column(nxt + col * kTile, g);
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt)
          if (tt < nvalid) cg[static_cast<size_t>(b0 + tt) * in + col] = g[tt];
      });
    } else {
      tile_matmul(Wt, m[1], in, cur, [&](int col, const float(&acc)[kTile]) {
        store_tile_column(nxt + col * kTile, acc);
      });
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  float* gw = cur;    // (J*F, kTile): the code gradient, then the e-chain's efeat
  float* ebuf = nxt;  // per joint: L1 (E) | R1 = gh (E) | L2 (E) | R2 = gf (F), each x kTile
  const int jstride = (3 * E + F) * kTile;

  if (t < kTile) {
    // ---- A. encoder pullback: reverse joint walk ----
    for (int j = J - 1; j >= 0; --j) {
      const int p = par[j];
      const float* w1j = w1 + j * E * E;
      const float* w2j = w2 + j * E * F;
      const float* zj = encz + j * (E + F) * kTile;
      float* ej = ebuf + j * jstride;
      float gf[kMaxF];
#pragma unroll
      for (int k = 0; k < kMaxF; ++k) {
        gf[k] = 0.f;
        if (k < F) {
          gf[k] = gw[(j * F + k) * kTile + t] * act_grad(a.act, 0.f, zj[(E + k) * kTile + t]);
          ej[(3 * E + k) * kTile + t] = valid ? gf[k] : 0.f;
        }
      }
      float gh[kMaxE];
#pragma unroll
      for (int u = 0; u < kMaxE; ++u) {
        float s = 0.f;
        if (u < E) {
#pragma unroll
          for (int k = 0; k < kMaxF; ++k)
            if (k < F) s = fmaf(w2j[u * F + k], gf[k], s);
          s *= act_grad(a.act, 0.f, zj[u * kTile + t]);
          ej[(E + u) * kTile + t] = valid ? s : 0.f;
        }
        gh[u] = s;
      }
#pragma unroll
      for (int i = 0; i < kMaxE; ++i) {
        if (i < E && (i < 4 || p >= 0)) {
          float s = 0.f;
#pragma unroll
          for (int u = 0; u < kMaxE; ++u)
            if (u < E) s = fmaf(w1j[i * E + u], gh[u], s);
          if (i < 4)
            gx[(j * 4 + i) * kTile + t] = s;
          else
            gw[(p * F + i - 4) * kTile + t] += s;
        }
      }
    }

    float n[4], coef[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      n[c] = ps[(kN + c) * kTile + t];
      const float s = ps[(kS + c) * kTile + t];
      coef[c] = s >= kEps2 ? 1.f / (n[c] * n[c] * n[c]) : 0.f;
    }
    const float dd = ps[kDD * kTile + t];

    // ---- B. normalization VJP, eikonal term and its cotangent (noisy branch) ----
    // gq = gx / n - q <gx, q>_J [s >= eps^2] / n^3; the cotangent Ggq goes back
    // through the same (symmetric) operator to Ggx, stored over gx.
    if (a.eikonal) {
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < J; ++j) {
        const float4 q = valid ? q4[j] : zero4;
        dot[0] = fmaf(gx[(j * 4 + 0) * kTile + t], q.x, dot[0]);
        dot[1] = fmaf(gx[(j * 4 + 1) * kTile + t], q.y, dot[1]);
        dot[2] = fmaf(gx[(j * 4 + 2) * kTile + t], q.z, dot[2]);
        dot[3] = fmaf(gx[(j * 4 + 3) * kTile + t], q.w, dot[3]);
      }
      float dotg[4] = {0.f, 0.f, 0.f, 0.f}, esum = 0.f;
      for (int j = 0; j < J; ++j) {
        const float4 q4j = valid ? q4[j] : zero4;
        const float q[4] = {q4j.x, q4j.y, q4j.z, q4j.w};
        float gq[4], sq = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          gq[c] = gx[(j * 4 + c) * kTile + t] / n[c] - q[c] * (dot[c] * coef[c]);
          sq = fmaf(gq[c], gq[c], sq);
        }
        const float gn = sqrtf(sq + 1e-12f);
        const float dif = gn - 1.f;
        esum = fmaf(dif, dif, esum);
        const float sc = valid ? a.eik_coef * (dif / gn) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float g = valid ? sc * gq[c] : 0.f;  // a padded row's gq may be inf
          gx[(j * 4 + c) * kTile + t] = g;
          dotg[c] = fmaf(g, q[c], dotg[c]);
        }
      }
      ps[kESum * kTile + t] = valid ? esum : 0.f;
      for (int j = 0; j < J; ++j) {
        const float4 q4j = valid ? q4[j] : zero4;
        const float q[4] = {q4j.x, q4j.y, q4j.z, q4j.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* g = gx + (j * 4 + c) * kTile + t;
          *g = *g / n[c] - q[c] * (dotg[c] * coef[c]);
        }
      }
    }

    // ---- C. e-chain, encoder half (parents before children), and the
    //      encoder's weight-gradient vectors L1 = egin + dd inp, L2 = ea + dd h ----
    for (int j = 0; j < J; ++j) {
      const int p = par[j];
      const float4 q = valid ? q4[j] : zero4;
      const float* w1j = w1 + j * E * E;
      const float* w2j = w2 + j * E * F;
      const float* zj = encz + j * (E + F) * kTile;
      const float* zp = encz + (p >= 0 ? p : 0) * (E + F) * kTile;
      float* ej = ebuf + j * jstride;
      float inp[kMaxE], egin[kMaxE];
      inp[0] = q.x / n[0];
      inp[1] = q.y / n[1];
      inp[2] = q.z / n[2];
      inp[3] = q.w / n[3];
#pragma unroll
      for (int i = 0; i < 4; ++i) egin[i] = a.eikonal ? gx[(j * 4 + i) * kTile + t] : 0.f;
#pragma unroll
      for (int k = 0; k < kMaxF; ++k) {
        const bool live = k < F && p >= 0;
        inp[4 + k] = live ? act_fwd(a.act, 0.f, zp[(E + k) * kTile + t]) : 0.f;
        egin[4 + k] = live && a.eikonal ? gw[(p * F + k) * kTile + t] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxE; ++i)
        if (i < E) ej[i * kTile + t] = valid ? fmaf(dd, inp[i], egin[i]) : 0.f;
      float ea[kMaxE];
#pragma unroll
      for (int u = 0; u < kMaxE; ++u) {
        ea[u] = 0.f;
        if (u < E) {
          const float zh = zj[u * kTile + t];
          if (a.eikonal) {
            float s = 0.f;
#pragma unroll
            for (int i = 0; i < kMaxE; ++i)
              if (i < E) s = fmaf(egin[i], w1j[i * E + u], s);
            ea[u] = s * act_grad(a.act, 0.f, zh);
          }
          ej[(2 * E + u) * kTile + t] = valid ? fmaf(dd, act_fwd(a.act, 0.f, zh), ea[u]) : 0.f;
        }
      }
      if (a.eikonal) {
#pragma unroll
        for (int k = 0; k < kMaxF; ++k) {
          if (k < F) {
            float s = 0.f;
#pragma unroll
            for (int u = 0; u < kMaxE; ++u)
              if (u < E) s = fmaf(ea[u], w2j[u * F + k], s);
            gw[(j * F + k) * kTile + t] = s * act_grad(a.act, 0.f, zj[(E + k) * kTile + t]);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- the tile's encoder gradient and loss sums, over its poses in order ----
  {
    float* slot = a.enc_slot + static_cast<size_t>(blockIdx.x) * nenc;
    const float* ddv = ps + kDD * kTile;
    const int n_w1 = J * E * E, n_b1 = J * E, n_w2 = J * E * F;
    for (int e = tid; e < nenc; e += kThreads) {
      const float* lv;
      const float* rv;
      if (e < n_w1) {                                  // w1[j][i][u] += L1_i gh_u
        const int j = e / (E * E), r = e - j * E * E, i = r / E, u = r - i * E;
        lv = ebuf + j * jstride + i * kTile;
        rv = ebuf + j * jstride + (E + u) * kTile;
      } else if (e < n_w1 + n_b1) {                    // b1[j][u] += dd gh_u
        const int r = e - n_w1, j = r / E, u = r - j * E;
        lv = ddv;
        rv = ebuf + j * jstride + (E + u) * kTile;
      } else if (e < n_w1 + n_b1 + n_w2) {             // w2[j][u][k] += L2_u gf_k
        const int r = e - n_w1 - n_b1, j = r / (E * F), r2 = r - j * E * F, u = r2 / F,
                  k = r2 - u * F;
        lv = ebuf + j * jstride + (2 * E + u) * kTile;
        rv = ebuf + j * jstride + (3 * E + k) * kTile;
      } else {                                         // b2[j][k] += dd gf_k
        const int r = e - n_w1 - n_b1 - n_w2, j = r / F, k = r - j * F;
        lv = ddv;
        rv = ebuf + j * jstride + (3 * E + k) * kTile;
      }
      float s = 0.f;
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt) s = fmaf(lv[tt], rv[tt], s);
      slot[e] = s;
    }
    if (tid == 0) {
      float ls = 0.f, es = 0.f;
      for (int tt = 0; tt < kTile; ++tt) {
        ls += ps[kLSum * kTile + tt];
        es += ps[kESum * kTile + tt];
      }
      a.loss_slot[2 * blockIdx.x] = ls;
      a.loss_slot[2 * blockIdx.x + 1] = es;
    }
  }
  if (!a.eikonal) return;
  __syncthreads();

  // ---- C. e-chain, DFNet half (upward): a_l = dd x_l + ecx_l in place ----
  cur = gw;   // ecx_0 = the code's e-cotangent
  nxt = ebuf;
  {
    const float* ddv = ps + kDD * kTile;
    float* a0 = a.a_scr;
    for (int e = tid; e < nvalid * in0; e += kThreads) {
      const int tt = e / in0, k = e - tt * in0;
      float* x = a0 + static_cast<size_t>(b0 + tt) * in0 + k;
      *x = fmaf(ddv[tt], *x, cur[k * kTile + tt]);
    }
  }
  for (int l = 0; l < L - 1; ++l) {
    const int* m = meta + kMeta * l;
    const float* W = a.dfw + m[2];
    const int out = m[1];
    const uint32_t* ml = mask + m[5];
    float* ag = a_layer(l + 1);
    const float* ddv = ps + kDD * kTile;
    tile_matmul(W, m[0], out, cur, [&](int col, const float(&acc)[kTile]) {
      const uint32_t bits = ml[col];
      float e[kTile];
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt) e[tt] = acc[tt] * act_grad_bit(a.act, bits, tt);
      store_tile_column(nxt + col * kTile, e);
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt) {
        if (tt < nvalid) {
          float* x = ag + static_cast<size_t>(b0 + tt) * out + col;
          *x = fmaf(ddv[tt], *x, e[tt]);
        }
      }
    });
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

// ---------------------------------------------------------------------------
// training gradient, batch reduction
// ---------------------------------------------------------------------------

// The products dW_l = A_l^T C_l and db_l = dd^T C_l, with A_l the rows
// [a_l (noisy); dd x_l (manifold)] and C_l the rows [c_l; c_l]: a product
// whose depth K is the batch (40,000 rows at the reference batch).
//
// Bound on an H100 SXM: 2 x 40,000 x sum_l (in_l + 1) out_l = 1.09e11
// operations, which at fp32-grade accuracy on the tensor cores are three
// TF32 passes, 3.27e11 at 494.7 TFLOP/s: 0.66 ms; the 860 MB of scratch
// read once at 3.35 TB/s: 0.26 ms. The design:
//  * 3xTF32. Each operand x = hi + lo with hi = tf32(x) and lo = tf32(x - hi)
//    (cvt.rna); the products lo.hi' + hi.lo' + hi.hi' go to wgmma
//    m64nNk8.f32.tf32.tf32 with fp32 accumulators. A product keeps ~21
//    significant bits (the dropped terms are at most ~3 x 2^-22 |x x'|).
//  * The layout. TF32 wgmma has no transposed (M- or N-major) shared-memory
//    operand, and the scratch is (rows, in) and (rows, out): M- and N-major,
//    K = the row. So every step of kRK = 32 rows (one 128-byte line of tf32
//    K) goes through the CTA twice. Its rows of the tile's A and B columns
//    and of dd are copied into a raw fp32 ring with cp.async (16-byte copies
//    where the rows allow, zero-filled past the edges), kRaw - 1 steps
//    ahead, so that many steps' loads are in flight without registers.
//    Then A goes to the products from registers (wgmma's RS form, which
//    takes any layout): each thread loads its fragment's 16 values of the
//    step from the raw ring (its rows padded so that the loads meet no bank
//    conflict), scales them by dd on the manifold branch and splits them;
//    and B is split by all 256 threads, column t % 128 and half the rows a
//    thread, and stored transposed into the K-major 128-byte swizzle
//    (16-byte stores, no bank conflicts), then fenced for the async proxy.
//    A from registers also halves what the products read from shared
//    memory, which, with the split's loads and stores, bounds a step.
//  * A CTA owns a kRM x NT output tile of one layer (NT = 128, or 64 / 8
//    where the layer is that narrow; in = 126 and out = 1 are zero-padded)
//    over one range of kSplitRows rows of one branch. Its two warpgroups
//    each own 64 rows of the tile, copy, split and issue 12 wgmmas a step
//    (a producer warpgroup of its own, with both operands split into shared
//    memory, was measured slower on an H100: PERF.md). Step g's products
//    read one of two B slots and one of two register fragments, so step
//    g + 1's copies and splits overlap them. The accumulators start anew
//    every kFold steps and are then added to totals in registers with IEEE
//    adds: the tensor cores' fp32 accumulation rounds otherwise than an IEEE
//    add, so its error spans kFold steps only.
//  * The bias row db = dd^T C: the threads that split B in a layer's first
//    row tile sum dd[r] c[r][o] for their column and half of each step's
//    rows on the CUDA cores (fp32 FMAs), the two halves added in order at
//    the end.
//  * Split-K without atomics: each range's totals go to its own slot of a
//    partial buffer, and a second kernel adds the ranges in order (the noisy
//    rows' first) and sums the tile kernel's encoder and loss slots; two calls
//    give the same bits. The CTAs of one range are consecutive, so the tiles
//    of one layer read its rows from L2 at about the same time.
constexpr int kRM = 128;                       // output rows (layer inputs) a CTA
constexpr int kRK = 32;                        // batch rows a step: 128 bytes of tf32
constexpr int kROp = kRM * 128;                // B hi or lo: 128 columns x 128 bytes of K
constexpr int kRSlot = 2 * kROp;               // B hi | B lo: 32 KB
constexpr int kRStages = 2;                    // B slots
constexpr int kRaw = 4;                        // raw steps: copies kRaw - 1 steps ahead
constexpr int kRawA = kRM + 8;                 // a raw A row: 136 floats, so that the
                                               // fragment loads hit 32 banks
constexpr int kRawFloats = kRK * kRawA + kRK * kRM + kRK;  // A (32, 136) | B (32, 128) | dd (32)
constexpr int kRThreads = 256;                 // two warpgroups
constexpr int kSplitRows = 2048;               // batch rows a CTA (a multiple of kRK)
constexpr int kFold = 4;                       // steps a fresh accumulator sums
constexpr int kSumThreads = 256;               // threads a block of the range sums
// B slots | raw ring | bias halves; 1024 to align the B slots
constexpr size_t kReduceSmem = 1024 + static_cast<size_t>(kRStages) * kRSlot +
                               (static_cast<size_t>(kRaw) * kRawFloats + kRM) * sizeof(float);

// N of a layer's output tiles: 128, or 64 / 8 for a layer that narrow
__host__ __device__ inline int tile_n(int out) { return out > 64 ? 128 : (out > 8 ? 64 : 8); }

__host__ __device__ inline int layer_tiles(int in, int out) {
  return ((in + kRM - 1) / kRM) * ((out + tile_n(out) - 1) / tile_n(out));
}

struct ReduceArgs {
  const int* meta;     // (L, kMeta)
  int L;
  // segment 0: the noisy rows, segment 1: the manifold rows
  const float* a_scr[2];
  const float* c_scr[2];
  const float* dd[2];
  int rows[2];
  int ranges0;         // row ranges of the noisy rows; the manifold rows' follow
  int tiles;           // output tiles of one row range, over all layers
  int ndf;             // DFNet gradient floats: per layer W (in, out) | b (out)
  float* partial;      // (ranges, ndf)
};

// Copies of the step's kRK rows x `cols` columns (row stride `ld` floats)
// from `src` into a raw (kRK, ldr) fp32 tile, zeros where a row is past
// nrows or a column past cols; 16-byte copies where `vec` (cols and ld
// multiples of 4, src 16-byte aligned), else 4-byte copies. Thread t of the
// CTA's kRThreads.
__device__ __forceinline__ void copy_raw(uint32_t dst, int ldr, const float* src, int ld, int cols,
                                         int k0, int nrows, bool vec, int t) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < kRK * kRM / 4 / kRThreads; ++j) {
      const int e = t + kRThreads * j, row = e / (kRM / 4), c = 4 * (e % (kRM / 4));
      const bool ok = k0 + row < nrows && c < cols;
      cp_async16(dst + (row * ldr + c) * 4,
                 ok ? src + static_cast<size_t>(k0 + row) * ld + c : src, ok ? 16 : 0);
    }
  } else {
    const int col = t % kRM;
#pragma unroll 4
    for (int row = t / kRM; row < kRK; row += kRThreads / kRM) {
      const bool ok = k0 + row < nrows && col < cols;
      cp_async4(dst + (row * ldr + col) * 4,
                ok ? src + static_cast<size_t>(k0 + row) * ld + col : src, ok ? 4 : 0);
    }
  }
}

// The CTA's tile: A and C point at the range's first row, at the tile's
// first column (acols / ccols of them are in the layer); dd at the range's
// first row; `scale`: A's rows times dd (the manifold branch); `bias`: the
// tile's column block of db into bias_dst.
template <int NT>
__device__ __forceinline__ void reduce_tile(unsigned char* ring, float* raw, float* bsum,
                                            int steps, int nrows, const float* A, int in,
                                            int acols, const float* C, int out, int ccols,
                                            const float* dd, bool scale, bool bias, float* dst,
                                            float* bias_dst, int i0, int o0) {
  const int t = threadIdx.x, wg = t / 128, tw = t % 128, half = t / 128;
  const bool vec_a = in % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool vec_c = out % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const bool vec_d = reinterpret_cast<uintptr_t>(dd) % 16 == 0;
  const uint32_t raw_u = smem_u32(raw);
  auto issue = [&](int g) {
    if (g < steps) {
      const uint32_t dst_u = raw_u + (g % kRaw) * kRawFloats * 4;
      const int k0 = g * kRK;
      copy_raw(dst_u, kRawA, A, in, acols, k0, nrows, vec_a, t);
      copy_raw(dst_u + kRK * kRawA * 4, kRM, C, out, ccols, k0, nrows, vec_c, t);
      if (t < kRK / 4) {
        const int k = k0 + 4 * t;
        const int n = max(0, min(4, nrows - k));
        const uint32_t d_u = dst_u + (kRK * kRawA + kRK * kRM + 4 * t) * 4;
        if (vec_d) {
          cp_async16(d_u, n > 0 ? dd + k : dd, 4 * n);
        } else {
          for (int u = 0; u < 4; ++u) cp_async4(d_u + 4 * u, u < n ? dd + k + u : dd, u < n ? 4 : 0);
        }
      }
    }
    cp_async_commit();   // one group a step, empty past the last
  };

  float acc[NT / 2], tot[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = tot[i] = 0.f;
  float btot = 0.f;
  const bool sums_bias = bias && tw < ccols;
  // the thread's A fragment rows (of the tile) and K offsets within a k8 step
  const int fm = 64 * wg + 16 * ((t % 128) / 32) + (t % 32) / 4, fk = t % 4;

  // step g: A fragments into af (hi and lo of 4 k8 steps), B into its slot,
  // then the 12 products
  auto step = [&](int g, uint32_t(&af)[4][2][4]) {
    cp_async_wait<kRaw - 2>();
    // step g's rows have landed (every thread's copies); step g - 1's raw
    // rows are read, and the products of step g - 2 (B slot g % 2, these
    // registers) are done
    __syncthreads();
    issue(g + kRaw - 1);
    const float* ra = raw + (g % kRaw) * kRawFloats;
    const float* rc = ra + kRK * kRawA;
    const float* rd = rc + kRK * kRM;
    unsigned char* hi = ring + (g % kRStages) * kRSlot;
    float b = 0.f;
#pragma unroll
    for (int q = 4 * half; q < 4 * half + 4; ++q) {   // B: column tw, rows 4 q .. 4 q + 3
      const float4 d4 = reinterpret_cast<const float4*>(rd)[q];
      const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = rc[(4 * q + u) * kRM + tw];
        if (sums_bias) b = fmaf(dq[u], v[u], b);
      }
      const int off = sw128_offset(tw, 16 * q);
      const float h0 = tf32_round(v[0]), h1 = tf32_round(v[1]), h2 = tf32_round(v[2]),
                  h3 = tf32_round(v[3]);
      *reinterpret_cast<float4*>(hi + off) = make_float4(h0, h1, h2, h3);
      *reinterpret_cast<float4*>(hi + kROp + off) =
          make_float4(tf32_round(v[0] - h0), tf32_round(v[1] - h1), tf32_round(v[2] - h2),
                      tf32_round(v[3] - h3));
    }
    btot += b;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // A: register j is (fm + 8 (j % 2), 8 kk + fk + 4 (j / 2))
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 8 * kk + fk + 4 * (j / 2);
        float v = ra[k * kRawA + fm + 8 * (j % 2)];
        if (scale) v *= rd[k];
        const float h = tf32_round(v);
        af[kk][0][j] = __float_as_uint(h);
        af[kk][1][j] = __float_as_uint(tf32_round(v - h));
      }
    }
    fence_proxy_async();
    __syncthreads();   // B slot g % 2 holds step g's B
    const uint32_t b_hi = smem_u32(hi), b_lo = b_hi + kROp;
    const bool fresh = g % kFold == 0;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // the small terms first
      wgmma_tf32_rs<NT>(acc, af[kk][1], desc_sw128(b_hi + kk * 32), !(fresh && kk == 0));
      wgmma_tf32_rs<NT>(acc, af[kk][0], desc_sw128(b_lo + kk * 32), 1);
      wgmma_tf32_rs<NT>(acc, af[kk][0], desc_sw128(b_hi + kk * 32), 1);
    }
    wgmma_commit();
    if (g % kFold == kFold - 1 || g == steps - 1) {
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) tot[i] += acc[i];
    } else {
      wgmma_wait<1>();   // step g's products run on while step g + 1 is staged
    }
  };
  uint32_t af0[4][2][4], af1[4][2][4];   // the register fragments of even and odd steps
  for (int g = 0; g < kRaw - 1; ++g) issue(g);
  for (int g = 0; g < steps; g += 2) {
    step(g, af0);
    if (g + 1 < steps) step(g + 1, af1);
  }
  // db: the second half's sums to shared memory, then the first half adds them
  if (half == 1) bsum[tw] = btot;
  __syncthreads();
  if (half == 0 && sums_bias) *bias_dst = btot + bsum[tw];
  // register i: row 16 (tw / 32) + (tw % 32) / 4 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 (tw % 4) + i % 2 of the warpgroup's 64 x NT block
  const int row = i0 + 64 * wg + 16 * (tw / 32) + (tw % 32) / 4;
  const int col = o0 + 2 * (tw % 4);
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int m = row + 8 * ((i / 2) % 2), o = col + 8 * (i / 4) + i % 2;
    if (m < in && o < out) dst[static_cast<size_t>(m) * out + o] = tot[i];
  }
}

__global__ void __launch_bounds__(kRThreads, 1) train_reduce_kernel(const ReduceArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* raw = reinterpret_cast<float*>(ring + kRStages * kRSlot);
  float* bsum = raw + kRaw * kRawFloats;

  // this CTA's row range (branch and rows) and output tile (layer, i0, o0)
  const int range = blockIdx.x / a.tiles;
  int tile = blockIdx.x - range * a.tiles;
  int l = 0, in = 0, out = 0;
  size_t woff = 0, aoff = 0, coff = 0;
  for (; l < a.L; ++l) {
    in = a.meta[kMeta * l];
    out = a.meta[kMeta * l + 1];
    const int tiles = layer_tiles(in, out);
    if (tile < tiles) break;
    tile -= tiles;
    woff += static_cast<size_t>(in) * out + out;
    aoff += in;
    coff += out;
  }
  const int nt = tile_n(out);
  const int tiles_o = (out + nt - 1) / nt;
  const int i0 = (tile / tiles_o) * kRM;
  const int o0 = (tile % tiles_o) * nt;
  const int seg = range < a.ranges0 ? 0 : 1;
  const int r_begin = (range - (seg ? a.ranges0 : 0)) * kSplitRows;
  const int nrows = min(kSplitRows, a.rows[seg] - r_begin);
  const int steps = (nrows + kRK - 1) / kRK;
  const size_t rows = a.rows[seg];
  const float* A = a.a_scr[seg] + aoff * rows + static_cast<size_t>(r_begin) * in + i0;
  const float* C = a.c_scr[seg] + coff * rows + static_cast<size_t>(r_begin) * out + o0;
  float* dst = a.partial + static_cast<size_t>(range) * a.ndf + woff;
  float* bias_dst = dst + static_cast<size_t>(in) * out + o0 + threadIdx.x % 128;
  // B columns past out are zeros; past nt they are not read
  const int acols = min(kRM, in - i0), ccols = min(nt, out - o0);
  if (nt == 128)
    reduce_tile<128>(ring, raw, bsum, steps, nrows, A, in, acols, C, out, ccols,
                     a.dd[seg] + r_begin, seg == 1, i0 == 0, dst, bias_dst, i0, o0);
  else if (nt == 64)
    reduce_tile<64>(ring, raw, bsum, steps, nrows, A, in, acols, C, out, ccols,
                    a.dd[seg] + r_begin, seg == 1, i0 == 0, dst, bias_dst, i0, o0);
  else
    reduce_tile<8>(ring, raw, bsum, steps, nrows, A, in, acols, C, out, ccols,
                   a.dd[seg] + r_begin, seg == 1, i0 == 0, dst, bias_dst, i0, o0);
}

struct SumArgs {
  const float* enc_slot;   // (nslots, nenc), the noisy blocks first
  const float* loss_slot;  // (nslots, 2)
  int nslots, nslots_noisy, nenc;
  const float* partial;    // (ranges, ndf)
  int ranges, ndf;
  float* grads;            // enc (nenc) | the DFNet gradient (ndf)
  float* loss;             // (3,): noisy distance sum, noisy eikonal sum, manifold distance sum
};

// One thread per output, each summing in a fixed order: the encoder slots
// (block order), the three loss sums, the DFNet gradient's row ranges
// (range order).
__global__ void __launch_bounds__(kSumThreads) train_reduce_sum_kernel(const SumArgs a) {
  const int e = blockIdx.x * kSumThreads + threadIdx.x;
  float s = 0.f;
  if (e < a.nenc) {
    for (int k = 0; k < a.nslots; ++k) s += a.enc_slot[static_cast<size_t>(k) * a.nenc + e];
    a.grads[e] = s;
  } else if (e < a.nenc + 3) {
    const int which = e - a.nenc;
    const int k0 = which == 2 ? a.nslots_noisy : 0;
    const int k1 = which == 2 ? a.nslots : a.nslots_noisy;
    const int col = which == 1 ? 1 : 0;
    for (int k = k0; k < k1; ++k) s += a.loss_slot[2 * k + col];
    a.loss[which] = s;
  } else if (e < a.nenc + 3 + a.ndf) {
    const int d = e - a.nenc - 3;
    for (int k = 0; k < a.ranges; ++k) s += a.partial[static_cast<size_t>(k) * a.ndf + d];
    a.grads[a.nenc + d] = s;
  }
}

int reduce_tiles(const int* meta_host, int L) {
  int n = 0;
  for (int l = 0; l < L; ++l) n += layer_tiles(meta_host[kMeta * l], meta_host[kMeta * l + 1]);
  return n;
}

int dfnet_floats(const int* meta_host, int L) {
  int n = 0;
  for (int l = 0; l < L; ++l) {
    const int in = meta_host[kMeta * l], out = meta_host[kMeta * l + 1];
    n += in * out + out;
  }
  return n;
}

int row_ranges(int rows) { return (rows + kSplitRows - 1) / kSplitRows; }

}  // namespace

extern "C" {

int posendf_encoder(const float* quat, int B, const float* enc, const int* parents, int J, int F,
                    int act, float beta, float* out, void* stream) {
  if (J < 1 || J > kMaxJ || F < 1 || F > kMaxF) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const size_t smem = encoder_smem_floats(J, F) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(encoder_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kEncThreads - 1) / kEncThreads;
  encoder_kernel<<<blocks, kEncThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      quat, B, enc, parents, J, F, act, beta, out);
  return static_cast<int>(cudaGetLastError());
}

// One branch of the training gradient: grid ceil(B / 16) blocks.
int posendf_train_tile(const float* pose, int B, const float* gt, const float* enc,
                       const int* parents, int J, int F, const float* dfw, const int* meta, int L,
                       int maxw, int zsum, int act, int eikonal, int l2, float dd_coef,
                       float eik_coef, float* a_scr, float* c_scr, float* dd_out, float* enc_slot,
                       float* loss_slot, void* stream) {
  if (J < 1 || J > kMaxJ || F < 1 || F > kMaxF || L < 1 || L > kMaxL ||
      (act != kLRelu && act != kRelu))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  TrainArgs a{};
  a.pose = pose;
  a.B = B;
  a.gt = gt;
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
  a.eikonal = eikonal;
  a.l2 = l2;
  a.dd_coef = dd_coef;
  a.eik_coef = eik_coef;
  a.a_scr = a_scr;
  a.c_scr = c_scr;
  a.dd_out = dd_out;
  a.enc_slot = enc_slot;
  a.loss_slot = loss_slot;
  const size_t smem = train_smem_floats(J, F, L, maxw, zsum) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(train_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTile - 1) / kTile;
  train_tile_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The reduction over both branches, two launches. meta_host is the host copy
// of meta; partial holds posendf_train_reduce_partial_floats floats.
int posendf_train_reduce(const int* meta, const int* meta_host, int L, const float* a_n,
                         const float* c_n, const float* dd_n, int rows_n, const float* a_m,
                         const float* c_m, const float* dd_m, int rows_m, const float* enc_slot,
                         const float* loss_slot, int nslots_n, int nslots_m, int J, int F,
                         float* partial, float* grads, float* loss, void* stream) {
  if (L < 1 || L > kMaxL || rows_n <= 0 || rows_m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ReduceArgs a{};
  a.meta = meta;
  a.L = L;
  a.a_scr[0] = a_n;
  a.a_scr[1] = a_m;
  a.c_scr[0] = c_n;
  a.c_scr[1] = c_m;
  a.dd[0] = dd_n;
  a.dd[1] = dd_m;
  a.rows[0] = rows_n;
  a.rows[1] = rows_m;
  a.ranges0 = row_ranges(rows_n);
  a.tiles = reduce_tiles(meta_host, L);
  a.ndf = dfnet_floats(meta_host, L);
  a.partial = partial;
  const int ranges = a.ranges0 + row_ranges(rows_m);
  const int err = launch_wgmma(train_reduce_kernel, a.tiles * ranges, kRThreads, kReduceSmem,
                               stream, a);
  if (err != 0) return err;
  SumArgs b{enc_slot, loss_slot, nslots_n + nslots_m, nslots_n, enc_floats(J, F),
            partial, ranges, a.ndf, grads, loss};
  const int n = b.nenc + 3 + b.ndf;
  train_reduce_sum_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(b);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the reduction's partial buffer for rows_n noisy and rows_m
// manifold rows.
int posendf_train_reduce_partial_floats(const int* meta_host, int L, int rows_n, int rows_m) {
  return (row_ranges(rows_n) + row_ranges(rows_m)) * dfnet_floats(meta_host, L);
}

const char* posendf_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
