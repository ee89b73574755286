// Hand-written Hopper kernels of the training path (sm_90a, fp32).
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
//   posendf_train_reduce, one block per 128 x 128 output tile of every layer
//   and range of 2,048 batch rows, then one kernel that adds the ranges:
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
// What bounds it on an H100: the fp32 FMAs (7 traversals of 1.36M
// multiply-adds per pose pair) on the CUDA cores; the scratch (21.5 KB per
// pose) is written once and read once, ~0.3 ms at the reference batch.
//
// Each launcher returns cudaGetLastError(); no launcher synchronizes or
// allocates (the wrapper allocates the scratch and slots with torch.empty).

#include "common.cuh"

namespace {

using namespace posendf;

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
// whose depth is the batch (40,000 rows at the reference batch). One block
// computes a kBM x kBN output tile of one layer over one range of
// kSplitRows rows (8 x 8 outputs a thread, kBK rows a step, the next step's
// operands loaded into registers while the current step multiplies); the
// blocks of one row range run together, so its rows are read from L2 by all
// the layer's tiles. The blocks of the first row tile of a layer also sum
// the bias row. A thread's sums over kFold steps are added to its running
// totals in shared memory, each range's totals go to its own slot of a
// partial buffer, and a second kernel adds the ranges in order: no atomics,
// and sums in three levels (kFold * kBK rows, a range, the ranges) whose
// rounding does not grow with the batch.
constexpr int kBM = 128;          // output rows (layer inputs) per block
constexpr int kBN = 128;          // output columns (layer outputs) per block
constexpr int kBK = 8;            // batch rows per step
constexpr int kRThreads = 256;    // 16 x 16 threads, 8 x 8 outputs each
constexpr int kSplitRows = 2048;  // batch rows per block
constexpr int kFold = 32;         // steps summed in registers before they join the totals
// dynamic shared memory of a product block: the running totals, (64, kRThreads)
constexpr size_t kReduceSmem = 64 * kRThreads * sizeof(float);

struct ReduceArgs {
  const int* meta;     // (L, kMeta)
  int L;
  // segment 0: the noisy rows, segment 1: the manifold rows
  const float* a_scr[2];
  const float* c_scr[2];
  const float* dd[2];
  int rows[2];
  int scale_a[2];      // multiply the a rows by dd (the manifold branch keeps plain x_l)
  const float* enc_slot;   // (nslots, nenc), the noisy blocks first
  const float* loss_slot;  // (nslots, 2)
  int nslots, nslots_noisy, nenc;
  int slot_blocks;     // blocks [0, slot_blocks) sum the slots; the rest are product tiles
  int tiles;           // product tiles of one row range, over all layers
  int ndf;             // DFNet gradient floats: per layer W (in, out) | b (out)
  float* partial;      // (ranges, ndf)
  float* grads;        // enc (nenc) | the DFNet gradient (ndf)
  float* loss;         // (3,): noisy distance sum, noisy eikonal sum, manifold distance sum
};

__global__ void __launch_bounds__(kRThreads, 2) train_reduce_kernel(const ReduceArgs a) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < a.slot_blocks) {
    const int e = blockIdx.x * kRThreads + tid;
    if (e < a.nenc) {
      float s = 0.f;
      for (int k = 0; k < a.nslots; ++k) s += a.enc_slot[static_cast<size_t>(k) * a.nenc + e];
      a.grads[e] = s;
    } else if (e < a.nenc + 3) {
      const int which = e - a.nenc;
      const int k0 = which == 2 ? a.nslots_noisy : 0;
      const int k1 = which == 2 ? a.nslots : a.nslots_noisy;
      const int col = which == 1 ? 1 : 0;
      float s = 0.f;
      for (int k = k0; k < k1; ++k) s += a.loss_slot[2 * k + col];
      a.loss[which] = s;
    }
    return;
  }

  // this block's row range, layer and output tile
  const int t = blockIdx.x - a.slot_blocks;
  const int range = t / a.tiles;
  int tile = t - range * a.tiles;
  int l = 0, in = 0, out = 0;
  size_t woff = 0, aoff = 0, coff = 0;
  for (; l < a.L; ++l) {
    in = a.meta[kMeta * l];
    out = a.meta[kMeta * l + 1];
    const int tiles = ((in + kBM - 1) / kBM) * ((out + kBN - 1) / kBN);
    if (tile < tiles) break;
    tile -= tiles;
    woff += static_cast<size_t>(in) * out + out;
    aoff += in;
    coff += out;
  }
  if (l >= a.L) return;
  const int tiles_o = (out + kBN - 1) / kBN;
  const int i0 = (tile / tiles_o) * kBM;
  const int o0 = (tile % tiles_o) * kBN;
  const bool bias = i0 == 0;
  const int total = a.rows[0] + a.rows[1];
  const int r_begin = range * kSplitRows;
  const int r_end = min(total, r_begin + kSplitRows);

  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Cs[2][kBK][kBN];
  __shared__ float Ds[2][kBK];
  __shared__ float bias_tot[8][16];
  extern __shared__ float tot[];  // (64, kRThreads): thread tid's totals at [m][tid]
  const int ty = tid / 16, tx = tid % 16;

  // each thread loads 4 consecutive values of one row of each operand a step
  const int lk = tid / 32, lc = (tid % 32) * 4;
  float ra[4], rc[4], rd = 0.f;
  auto load = [&](int r0) {
    const int r = r0 + lk;
#pragma unroll
    for (int m = 0; m < 4; ++m) ra[m] = rc[m] = 0.f;
    if (r < r_end) {
      const int s = r < a.rows[0] ? 0 : 1;
      const int rr = s == 0 ? r : r - a.rows[0];
      const size_t rows = a.rows[s];
      const float ddr = a.dd[s][rr];
      const float scale = a.scale_a[s] ? ddr : 1.f;
      const float* arow = a.a_scr[s] + aoff * rows + static_cast<size_t>(rr) * in;
      const float* crow = a.c_scr[s] + coff * rows + static_cast<size_t>(rr) * out;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (i0 + lc + m < in) ra[m] = arow[i0 + lc + m] * scale;
        if (o0 + lc + m < out) rc[m] = crow[o0 + lc + m];
      }
      if (lc == 0) rd = ddr;
    } else if (lc == 0) {
      rd = 0.f;
    }
  };
  auto store = [&](int buf) {
    *reinterpret_cast<float4*>(&As[buf][lk][lc]) = make_float4(ra[0], ra[1], ra[2], ra[3]);
    *reinterpret_cast<float4*>(&Cs[buf][lk][lc]) = make_float4(rc[0], rc[1], rc[2], rc[3]);
    if (lc == 0) Ds[buf][lk] = rd;
  };

  float acc[8][8], bacc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bacc[i] = 0.f;
    if (tid < 16) bias_tot[i][tid] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      tot[(i * 8 + j) * kRThreads + tid] = 0.f;
    }
  }
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (bias && ty == 0) {
        bias_tot[i][tx] += bacc[i];
        bacc[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tot[(i * 8 + j) * kRThreads + tid] += acc[i][j];
        acc[i][j] = 0.f;
      }
    }
  };
  int steps = 0;
  load(r_begin);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
    const bool more = r0 + kBK < r_end;
    if (more) load(r0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&Cs[buf][kk][tx * 4]);
      const float4 c1 = *reinterpret_cast<const float4*>(&Cs[buf][kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], cr[j], acc[i][j]);
      if (bias && ty == 0) {
        const float d = Ds[buf][kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) bacc[j] = fmaf(d, cr[j], bacc[j]);
      }
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
    if (++steps == kFold) {
      steps = 0;
      fold();
    }
  }
  fold();

  float* dst = a.partial + static_cast<size_t>(range) * a.ndf + woff;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= in) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (o < out) dst[static_cast<size_t>(row) * out + o] = tot[(i * 8 + j) * kRThreads + tid];
    }
  }
  if (bias && ty == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (o < out) dst[static_cast<size_t>(in) * out + o] = bias_tot[j][tx];
    }
  }
}

// grads[nenc + e] = the sum of the row ranges' partials, in range order
__global__ void __launch_bounds__(kRThreads) train_reduce_ranges_kernel(
    const float* __restrict__ partial, int ranges, int ndf, float* __restrict__ out) {
  const int e = blockIdx.x * kRThreads + threadIdx.x;
  if (e >= ndf) return;
  float s = 0.f;
  for (int k = 0; k < ranges; ++k) s += partial[static_cast<size_t>(k) * ndf + e];
  out[e] = s;
}

int reduce_tiles(const int* meta_host, int L) {
  int n = 0;
  for (int l = 0; l < L; ++l) {
    const int in = meta_host[kMeta * l], out = meta_host[kMeta * l + 1];
    n += ((in + kBM - 1) / kBM) * ((out + kBN - 1) / kBN);
  }
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
  a.scale_a[0] = 0;
  a.scale_a[1] = 1;
  a.enc_slot = enc_slot;
  a.loss_slot = loss_slot;
  a.nslots = nslots_n + nslots_m;
  a.nslots_noisy = nslots_n;
  a.nenc = enc_floats(J, F);
  a.slot_blocks = (a.nenc + 3 + kRThreads - 1) / kRThreads;
  a.tiles = reduce_tiles(meta_host, L);
  a.ndf = dfnet_floats(meta_host, L);
  a.partial = partial;
  a.grads = grads;
  a.loss = loss;
  const int ranges = row_ranges(rows_n + rows_m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(train_reduce_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kReduceSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  train_reduce_kernel<<<a.slot_blocks + a.tiles * ranges, kRThreads, kReduceSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  train_reduce_ranges_kernel<<<(a.ndf + kRThreads - 1) / kRThreads, kRThreads, 0, s>>>(
      partial, ranges, a.ndf, grads + a.nenc);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the reduction's partial buffer for `rows` batch rows in all.
int posendf_train_reduce_partial_floats(const int* meta_host, int L, int rows) {
  return row_ranges(rows) * dfnet_floats(meta_host, L);
}

const char* posendf_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
