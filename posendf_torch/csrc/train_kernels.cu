// Hand-written Hopper kernels of the training path (sm_90a, fp32; the tile
// kernel's and the reduction's products on the tensor cores in 3xTF32).
//
//   posendf_encoder       replaces posendf_tpu/ops/fused_encoder.py::_encoder_kernel
//                         (the 21-joint structure encoder alone, forward only)
//   posendf_train_tile    \  together replace posendf_tpu/ops/fused_train.py::_train_kernel
//   posendf_train_reduce  /  (the full parameter gradient of losses.training_loss)
//
// ---- The encoder ----
// At 131,072 poses it moves 110 MB (poses in, features out) and does 0.88
// GFLOP, so it is bound by bytes (0.033 ms at 3.35 TB/s). A CTA owns 64
// poses and 70 KB of shared memory at J = 21, F = 6, so that three CTAs fit
// an SM. Its poses (one contiguous run of the (B, J, 4) input) and the
// packed weights (fused_encoder.pack_encoder: a row of float4s a hidden
// unit or feature, E weights, the bias, zeros) come in with coalesced
// 16-byte cp.async. The walk goes over the joints in index order (every
// parent index is smaller than its child's); two neighbouring lanes share a
// pose, lane r summing the hidden units r, r + 2, ... and then the features
// r, r + 2, ... (one FMA a term in index order, then the bias, as the
// one-thread-a-pose kernel before it), and trade hidden units by shuffles,
// so a joint needs no CTA barrier, only __syncwarp before the children read
// its features. What the walk waits on is the shared-memory pipe, and most
// of its traffic is the weights: each load is a 128-bit broadcast feeding
// four FMAs, and a hidden unit crosses to the other lane in one shuffle.
// The activation is a template parameter (no branch a unit). The features stay in shared
// memory in the output's order (pose-major rows of J * F floats), and the
// CTA's output, one contiguous run of the (B, J * F) output (the JAX
// layout), leaves in coalesced 16-byte stores.

// ---- The training gradient ----
// What it computes is manual_train_grads (ops/train_grad.py) for lrelu/relu,
// where act'' = 0. On the TPU one kernel per branch kept the 1.37M gradient
// accumulators in VMEM across a sequential grid. Blocks here run in parallel,
// and a private copy of the gradient per CTA would be gigabytes at the
// reference batch, so the work is split in two launches:
//
//   posendf_train_tile, one CTA per 64 poses of either branch, both branches
//   in one launch (the noisy CTAs first: they take longer):
//     A. normalize (noisy branch), encoder and DFNet forward; the layer
//        inputs x_l go to global scratch, act'(z_l) to the CTA's scratch as
//        one bit per pose and unit; the distance loss and its d-cotangent
//        dd (weight / B times sign(r) or 2r, 0 on the ragged tail);
//        inner pullback with a unit cotangent: c_l to global scratch, then
//        the encoder's reverse walk (gh_j, gf_j, gx_j).
//     B. (noisy) the normalization VJP, the eikonal term and its cotangent,
//        through the VJP's symmetric adjoint (Ggx).
//     C. (noisy) the e-chain: the encoder half walks parents before
//        children, the DFNet half goes upward; each layer's e-cotangent
//        ecx_l is folded into the scratch in place: a_l = ecx_l + dd x_l.
//     The encoder's weight gradient of the CTA and its loss sums go to a
//     per-CTA slot, summed over the CTA's poses in a fixed order.
//   posendf_train_reduce, one CTA per 128 x 128 output tile of every layer
//   and range of 2,048 rows of one branch (wgmma, 3xTF32: see the section's
//   note), then one kernel that adds the ranges:
//     dW_l = a_l^T c_l over the noisy rows + (dd x_l)^T c_l over the manifold
//     rows, and db_l = dd^T c_l; and the per-CTA encoder and loss slots,
//     summed in CTA order.
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
// What bounds the tile kernel on an H100 SXM: the DFNet's products, 1.36M
// multiply-adds a pose a traversal, 5 traversals a noisy + manifold pair;
// at fp32 accuracy on the tensor cores each is three TF32 passes (3xTF32),
// 1.65 ms at 20,000 + 20,000 poses and 494.7 TFLOP/s. The scratch (21.5 KB a
// pose) is written once and read once by the reduction, ~0.26 ms. The tile
// kernel's design is the field kernels' (field_kernels.cu), a copy of its
// product machinery kept apart so that neither kernel's registers move with
// the other's:
//  * A CTA owns 64 poses (one wgmma M) and two warpgroups. The weights are
//    the field kernels' (fused_model.pack_tc, packed once a step): 32 KB
//    slabs of TF32 hi | lo halves in the K-major 128-byte swizzle, streamed
//    through a ring of two by cp.async.bulk under mbarriers, thread 0
//    refilling a slot once both warpgroups have passed a named barrier
//    after its products. The forward reads the forward's slabs (W^T), the
//    pullback the backward's (W), the e-chain the forward's again: 3 x 336
//    slabs (11 MB a traversal) for a noisy CTA, 2 x 336 for a manifold one.
//  * Products in 3xTF32 wgmma (m64nNk8, A split in registers: lo.hi' +
//    hi.lo' + hi.hi'), each slab's sums in a fresh accumulator folded into
//    IEEE fp32 totals; the 1024-wide layer chained with the next 64 columns
//    at a time (fused_model.tc_schedule's program).
//  * Epilogues from the accumulator fragments: forward bias and act into
//    the fp32 activation tile in shared memory (XOR-swizzled), act'(z) as
//    one bit a pose and unit (a 32-bit word a thread and column group, the
//    same thread reading it back in the pullback and the e-chain, so a kink
//    is taken on the side the forward took it: z >= 0 for lrelu, z > 0 for
//    relu); pullback acc act'(z); e-chain acc act'(z). Each output then goes
//    from the tile to its scratch rows, all threads on neighbouring
//    addresses: x_{l+1} stored, c_{l-1} stored, a_{l+1} = dd x_{l+1} + e
//    read and written in place.
//  * On the CUDA cores: the encoder's walks (forward, reverse, the e-chain's
//    encoder half: four neighbouring lanes a pose, the weights' rows staged
//    in the ring's space, no CTA barrier a joint; see "the encoder walks"),
//    the output layer and the loss, the normalization VJP and the eikonal
//    term; the encoder's pre-activations, the reverse walk's gh | gf and the
//    e-chain's L1 | L2 rows go to the CTA's global scratch, and after the
//    e-chain's walk the encoder's weight gradient is summed over the CTA's
//    64 poses into its slot in one pass.
//
// Each launcher returns cudaGetLastError(); no launcher synchronizes or
// allocates (the wrapper allocates the scratch and slots with torch.empty).

#include "common.cuh"
#include "hopper.cuh"
#include "tc_tile.cuh"

#include <type_traits>

namespace {

using namespace posendf;
using namespace hopper;

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------

constexpr int kEncPoses = 64;                    // poses a CTA
constexpr int kEncParts = 2;                     // threads a pose, neighbouring lanes of a warp
static_assert(kEncParts == 2, "the walk exchanges hidden units between lane pairs");
constexpr int kEncThreads = kEncPoses * kEncParts;

// a packed weight row: E weights, the bias, zeros to a whole float4
__host__ __device__ constexpr int enc_row(int F) { return round4(4 + F + 1); }

// floats of the packed weights (fused_encoder.pack_encoder): per joint E
// hidden rows, then F feature rows
__host__ __device__ constexpr int enc_packed_floats(int J, int F) { return J * (4 + F + F) * enc_row(F); }

// Shared memory, in floats: packed weights | poses (64, J, 4) | features
// (64, J * F), the output's order | parents
__host__ __device__ inline size_t encoder_smem_floats(int J, int F) {
  return static_cast<size_t>(enc_packed_floats(J, F)) + kEncPoses * J * 4 +
         round4(kEncPoses * J * F) + round4(J);
}

// z = sum_i in[i] w[i] in order from 0 (one FMA a term), then + w[E] (the
// bias), w one packed row read as float4
template <int E>
__device__ __forceinline__ float enc_unit(const float (&in)[E], const float* w) {
  float z = 0.f;
#pragma unroll
  for (int c = 0; c < round4(E + 1) / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(w + 4 * c);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      if (i < E) z = fmaf(in[i], f[e], z);
      else if (i == E) z = z + f[e];
    }
  }
  return z;
}

template <int F, int ACT>
__global__ void __launch_bounds__(kEncThreads) encoder_kernel(
    const float* __restrict__ quat, int B, const float* __restrict__ wp,
    const int* __restrict__ parents, int J, float beta, float* __restrict__ out) {
  constexpr int E = 4 + F, RW = enc_row(F), NH = (E + kEncParts - 1) / kEncParts,
                NF = (F + kEncParts - 1) / kEncParts;
  extern __shared__ float4 enc_smem4[];
  float* w = reinterpret_cast<float*>(enc_smem4);
  float* qs = w + enc_packed_floats(J, F);
  float* feats = qs + kEncPoses * J * 4;
  int* par = reinterpret_cast<int*>(feats + round4(kEncPoses * J * F));
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kEncPoses, rows = min(kEncPoses, B - b0);
  // the packed weights and the CTA's poses (one contiguous run) in 16-byte
  // copies, neighbouring threads on neighbouring addresses; zeros past B
  for (int i = t; i < enc_packed_floats(J, F) / 4; i += kEncThreads)
    cp_async16(smem_u32(w + 4 * i), wp + 4 * i, 16);
  const float* q0 = quat + static_cast<size_t>(b0) * J * 4;
  for (int i = t; i < kEncPoses * J; i += kEncThreads)
    cp_async16(smem_u32(qs + 4 * i), i < rows * J ? q0 + 4 * i : quat, i < rows * J ? 16 : 0);
  cp_async_commit();
  for (int i = t; i < J; i += kEncThreads) par[i] = parents[i];
  cp_async_wait<0>();
  __syncthreads();

  // thread r of a pose sums the hidden units r, r + 2, ... and then the
  // features likewise; the pose's two threads trade their hidden units by
  // shuffles, and a joint's features, in shared memory, are read by its
  // children: all within the warp
  const int p = t / kEncParts, r = t % kEncParts;
  const float* qp = qs + p * J * 4;
  float* fp = feats + p * J * F;
  for (int j = 0; j < J; ++j) {
    const int pj = par[j];
    const float* wj = w + j * (E + F) * RW;
    float in[E];
    const float4 q = *reinterpret_cast<const float4*>(qp + 4 * j);
    in[0] = q.x;
    in[1] = q.y;
    in[2] = q.z;
    in[3] = q.w;
    if constexpr (F % 2 == 0) {
#pragma unroll
      for (int k = 0; k < F; k += 2) {
        const float2 v = pj >= 0 ? *reinterpret_cast<const float2*>(fp + pj * F + k) : make_float2(0.f, 0.f);
        in[4 + k] = v.x;
        in[5 + k] = v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < F; ++k) in[4 + k] = pj >= 0 ? fp[pj * F + k] : 0.f;
    }
    float h[E];
#pragma unroll
    for (int i = 0; i < NH; ++i) {   // unit 2 i + r here, 2 i + 1 - r in the other thread
      const int u = r + kEncParts * i;
      const float mine = u < E ? act_fwd(ACT, beta, enc_unit<E>(in, wj + u * RW)) : 0.f;
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      if (2 * i < E) h[2 * i] = r ? other : mine;
      if (2 * i + 1 < E) h[2 * i + 1] = r ? mine : other;
    }
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int k = r + kEncParts * i;
      if (k < F) fp[j * F + k] = act_fwd(ACT, beta, enc_unit<E>(h, wj + (E + k) * RW));
    }
    __syncwarp();
  }
  __syncthreads();
  // the CTA's poses are one contiguous run of the (B, J*F) output
  const int n = rows * J * F;
  float* o = out + static_cast<size_t>(b0) * J * F;
  for (int i = t; i < n / 4; i += kEncThreads)
    reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(feats)[i];
  for (int i = 4 * (n / 4) + t; i < n; i += kEncThreads) o[i] = feats[i];
}

template <int F, int ACT>
int launch_encoder(const float* quat, int B, const float* wp, const int* parents, int J, float beta,
                   float* out, void* stream) {
  const size_t smem = encoder_smem_floats(J, F) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(encoder_kernel<F, ACT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  encoder_kernel<F, ACT><<<(B + kEncPoses - 1) / kEncPoses, kEncThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(quat, B, wp, parents, J, beta, out);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int dispatch_encoder(const float* quat, int B, const float* wp, const int* parents, int J, int act,
                     float beta, float* out, void* stream) {
  if (act == kLRelu) return launch_encoder<F, kLRelu>(quat, B, wp, parents, J, beta, out, stream);
  if (act == kRelu) return launch_encoder<F, kRelu>(quat, B, wp, parents, J, beta, out, stream);
  return launch_encoder<F, kSoftplus>(quat, B, wp, parents, J, beta, out, stream);
}

// ---------------------------------------------------------------------------
// training gradient, per-CTA tile kernel (3xTF32 wgmma)
// ---------------------------------------------------------------------------

namespace tile {

using namespace tc_tile;

constexpr int kTileThreads = 256;                // two warpgroups; thread 0 also fills the ring
constexpr int kSlabK = 32;                       // K a slab: a 128-byte line of tf32
constexpr int kHalfBytes = kSlabN * kSlabK * 4;  // the hi (or lo) half: 16 KB
constexpr int kSlabBytes = 2 * kHalfBytes;
constexpr int kStages = 2;
static_assert(kStages * kSlabBytes == 4 * kRingFloats, "the ring's space");
// per-pose scalars (rows of kRows): norms (4), squared sums (4), d, dd, distance term, eikonal term
enum { kPN = 0, kPS = 4, kPD = 8, kPDD = 9, kPL = 10, kPE = 11, kScalars = 12 };
constexpr int kMaxU = kMaxE + kMaxF;             // encoder units a joint: hidden, then features
// ring | activations (64, 512) | chunk (64, 64) | scalars | layer table (4 x kMaxL) | parents
// (kMaxJ) | encoder act' bits | barriers
constexpr size_t kTileSmem = 1024 + static_cast<size_t>(kStages) * kSlabBytes +
                             static_cast<size_t>(kRows) * (kXMax + kChunk) * sizeof(float) +
                             kScalars * kRows * sizeof(float) + (4 * kMaxL + kMaxJ) * sizeof(int) +
                             kEncBitBytes + 2 * kStages * sizeof(uint64_t);

// One branch's arguments (the shared ones repeated in each).
struct Args {
  const float* pose;           // (B, J, 4) rows of this branch
  int B;
  const float* gt;             // (B,) distance labels; nullptr on the manifold branch (0)
  const float* enc;            // w1 (J,E,E) | b1 (J,E) | w2 (J,E,F) | b2 (J,F), E = 4 + F
  const int* parents;          // (J,), -1 = root
  int J, F;
  const unsigned char* slabs;  // fused_model.pack_tc: the forward's slabs, then the backward's
  const float* vec;            // padded biases | output layer's w (padded) | its b
  const int* prog;             // header (kHead), the forward's steps, the backward's (kStep each)
  int nfwd, nbwd;              // slabs of each pass
  const int* meta;             // (L, kMeta): each layer's (in, out)
  int L;
  int eikonal;                 // 1: noisy branch (normalized input, eikonal term); 0: manifold
  int l2;                      // distance loss: 0 = L1, 1 = L2
  float dd_coef;               // weight of the distance term / B
  float eik_coef;              // 2 * weight of the eikonal term / (B * J)
  float* a_scr;                // per layer l a (B, in_l) block: x_l, then dd x_l + ecx_l (noisy)
  float* c_scr;                // per layer l a (B, out_l) block: c_l
  float* dd_out;               // (B,)
  float* enc_slot;             // (CTAs, enc_floats)
  float* loss_slot;            // (CTAs, 2): sum of the distance term, of the eikonal term
  float* scratch;              // per CTA: act' bits (4 zsum words) | encoder z | gh, gf | L1, L2
};

// One launch runs both branches: CTAs 0 .. ctas0 - 1 the noisy rows (the
// longer ones, three traversals a pose, first), the rest the manifold rows,
// which fill the last waves.
struct Launch {
  Args br[2];
  int ctas0;
};

// floats of one CTA's scratch: the act' bits (4 words a padded unit: 16 or
// 32 bits a 64-pose column, see epilogue), the encoder's pre-activations
// and its reverse walk's gh | gf, each J (E + F) x 64, and the e-chain's
// rows of the encoder's weight gradient, L1 | L2, each J E x 64
__host__ __device__ inline size_t scratch_floats(int J, int F, int zsum) {
  return 4 * static_cast<size_t>(zsum) +
         2 * static_cast<size_t>(J) * ((4 + 2 * F) + (4 + F)) * kRows;
}

// An epilogue: forward (bias set) z = acc + b, act'(z) kept as bits where
// `bits` is set, then act(z); else acc times act'(z) read from the bits
// where set. The result goes to dst, column c - col0.
struct Epi {
  const float* bias;
  uint32_t* bits;
  Buf dst;
  int col0;
};

// Where an output goes after its epilogue: rows of a scratch block (the
// CTA's first row, row stride ld = the layer's real width), stored or
// (fold) folded as dst = dd dst + value; dst null: nowhere.
struct Sink {
  float* dst;
  int ld;
  bool fold;
};

// What a thread carries through the products.
struct Ctx {
  uint64_t* bars;
  unsigned char* ring;
  const unsigned char* src;   // the slabs in global memory
  int nsrc;                   // slabs in src: slab g >= nsrc is slab g - nsrc (the e-chain)
  int lim;                    // slabs that may be filled so far
  int g;                      // the next slab
  int w, tw;                  // warpgroup, thread in it
};

// The ring, with no branch near the wgmma that the compiler could take for
// a divergent path (ptxas then serializes the wgmma): a slab's waiters spin
// inside one asm block, and once both warpgroups have passed a named
// barrier after a slab's products, thread 0 refills the slot through a
// predicated asm block (full barriers count that one arrival and the
// slab's bytes; no empty barriers).

// slab g has landed; returns its slot
__device__ __forceinline__ int wait_slab(const Ctx& cx, int g) {
  const int s = g % kStages;
  spin_wait(smem_u32(cx.bars + s), static_cast<uint32_t>(g / kStages) & 1);
  return s;
}

// thread 0 copies slab g into its slot (every thread runs the asm; its
// predicate holds on thread 0 alone, and only while g < lim)
__device__ __forceinline__ void fill(const Ctx& cx, int g) {
  const int s = g % kStages;
  const uint32_t go = threadIdx.x == 0 && g < cx.lim;
  const uint32_t full = smem_u32(cx.bars + s);
  const int k = g < cx.lim ? (g < cx.nsrc ? g : g - cx.nsrc) : 0;
  const unsigned char* src = cx.src + static_cast<size_t>(k) * kSlabBytes;
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %0, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%3], [%4], %2, [%1];\n"
      "}\n" ::"r"(go),
      "r"(full), "r"(kSlabBytes), "r"(smem_u32(cx.ring + s * kSlabBytes)), "l"(src)
      : "memory");
}

// both warpgroups are done with slab g's slot: refill it with slab g + kStages
__device__ __forceinline__ void release_slab(const Ctx& cx, int g) {
  named_bar_sync(kBar, kTileThreads);
  fill(cx, g + kStages);
}

// tot[cg] += A . B for nkb K-blocks of A (from `a`) and, per K-block, the
// NG slabs of column groups 0..NG-1, in the ring's order. Each slab's 12
// products sum into a fresh accumulator that is then added to tot in fp32
// (IEEE adds): the tensor cores' own fp32 accumulation does not round to
// nearest, so its error then spans 32 of K and not all of it.
template <int NG>
__device__ __forceinline__ void product(float (&tot)[NG][32], const Buf& a, int nkb, Ctx& cx) {
  const int r = 16 * (cx.tw / 32) + (cx.tw % 32) / 4, c = 2 * (cx.tw % 4);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nkb; ++kb) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a(a, r, 32 * kb + 8 * kk + c, ah[kk], al[kk]);
#pragma unroll
    for (int cg = 0; cg < NG; ++cg) {
      const int g = cx.g++;
      const int s = wait_slab(cx, g);
      const uint32_t hi = smem_u32(cx.ring + s * kSlabBytes) + cx.w * (kHalfBytes / 2);
      const uint32_t lo = hi + kHalfBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // the small terms first
        wgmma_tf32_rs<64>(acc, al[kk], desc_sw128(hi + kk * 32), kk > 0);
        wgmma_tf32_rs<64>(acc, ah[kk], desc_sw128(lo + kk * 32), 1);
        wgmma_tf32_rs<64>(acc, ah[kk], desc_sw128(hi + kk * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      release_slab(cx, g);
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[cg][i] += acc[i];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      keep_regs(ah[kk]);
      keep_regs(al[kk]);
    }
  }
}

// h += A . B for the first product of a chain: a slab is 64 columns x 64 of
// K, the hi | lo halves of its first 32 of K, then of its second (16 KB
// each); warpgroup w takes columns 32w..32w+31 (m64n32k8). Each 32 of K
// folds into h as in product.
__device__ __forceinline__ void product_chunk(float (&tot)[1][16], const Buf& a, int nkp, Ctx& cx) {
  const int r = 16 * (cx.tw / 32) + (cx.tw % 32) / 4, c = 2 * (cx.tw % 4);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int kp = 0; kp < nkp; ++kp) {
    const int g = cx.g++;
    const int s = wait_slab(cx, g);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        load_a(a, r, 2 * kSlabK * kp + kSlabK * h + 8 * kk + c, ah[kk], al[kk]);
      const uint32_t hi =
          smem_u32(cx.ring + s * kSlabBytes) + h * kHalfBytes + cx.w * (kHalfBytes / 4);
      const uint32_t lo = hi + kHalfBytes / 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32_rs<32>(acc, al[kk], desc_sw128(hi + kk * 32), kk > 0);
        wgmma_tf32_rs<32>(acc, ah[kk], desc_sw128(lo + kk * 32), 1);
        wgmma_tf32_rs<32>(acc, ah[kk], desc_sw128(hi + kk * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 16; ++i) tot[0][i] += acc[i];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        keep_regs(ah[kk]);
        keep_regs(al[kk]);
      }
    }
    release_slab(cx, g);
  }
}

// act'(z) of the activation from its bit (1: z >= 0 for lrelu, z > 0 for relu)
template <int kAct>
__device__ __forceinline__ float act_slope(uint32_t word, int bit) {
  return (word >> bit) & 1u ? 1.f : (kAct == kLRelu ? 0.01f : 0.f);
}

// The epilogue of column groups cg0..cg0+NG-1, each 16 NJ columns wide (8
// NJ a warpgroup: NJ = 8 after m64n64 products, 4 after m64n32). Register
// 4j + i of group cg is row r + 8 (i / 2), column 16 NJ cg + 8 NJ w + 8 j +
// 2 (t % 4) + i % 2; its act' is bit 4j + i of word ((cg * 2 + w) 128 + t)
// of the layer's bits: the same thread writes it in the forward and reads
// it in the pullback and the e-chain.
template <int kAct, int NG, int NJ>
__device__ __forceinline__ void epilogue(const float (&acc)[NG][4 * NJ], int cg0, const Epi& e,
                                         const Ctx& cx) {
  const int r = 16 * (cx.tw / 32) + (cx.tw % 32) / 4;
#pragma unroll
  for (int cg = 0; cg < NG; ++cg) {
    const int c0 = (cg0 + cg) * 16 * NJ + 8 * NJ * cx.w + 2 * (cx.tw % 4);
    uint32_t* bp = e.bits != nullptr ? e.bits + ((cg0 + cg) * 2 + cx.w) * 128 + cx.tw : nullptr;
    uint32_t word = 0;
    float2 bias[NJ];
    if (e.bias != nullptr) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bias[j] = __ldg(reinterpret_cast<const float2*>(e.bias + c0 + 8 * j));
    } else if (bp != nullptr) {
      word = *bp;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float v[4] = {acc[cg][4 * j], acc[cg][4 * j + 1], acc[cg][4 * j + 2], acc[cg][4 * j + 3]};
      if (e.bias != nullptr) {
        v[0] += bias[j].x;
        v[1] += bias[j].y;
        v[2] += bias[j].x;
        v[3] += bias[j].y;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool on = kAct == kLRelu ? v[i] >= 0.f : v[i] > 0.f;
          word |= static_cast<uint32_t>(on) << (4 * j + i);
          v[i] = act_fwd(kAct, 0.f, v[i]);
        }
      } else if (bp != nullptr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] *= act_slope<kAct>(word, 4 * j + i);
      }
      const int c = c0 + 8 * j - e.col0;
      *reinterpret_cast<float2*>(at(e.dst, r, c)) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(at(e.dst, r + 8, c)) = make_float2(v[2], v[3]);
    }
    if (e.bias != nullptr && bp != nullptr) *bp = word;
  }
}

// Columns col0 .. col0 + n - 1 of the tile's first nv rows to a sink (n cut
// to the layer's real width), all threads, neighbours on neighbouring
// addresses: 16-byte accesses where the rows allow, else 4-byte ones.
__device__ __forceinline__ void to_sink(const Sink& s, int col0, const Buf& src, int n, int nv,
                                        const float* dd) {
  if (s.dst == nullptr) return;
  n = min(n, s.ld - col0);
  const int t = threadIdx.x;
  float* base = s.dst + col0;
  if (n % 4 == 0 && s.ld % 4 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0) {
    const int q = n / 4;
    for (int e = t; e < nv * q; e += kTileThreads) {
      const int r = e / q, c = 4 * (e - r * q);
      const float4 v = *reinterpret_cast<const float4*>(at(src, r, c));
      float4* d = reinterpret_cast<float4*>(base + static_cast<size_t>(r) * s.ld + c);
      if (s.fold) {
        const float4 x = *d;
        const float m = dd[r];
        *d = make_float4(fmaf(m, x.x, v.x), fmaf(m, x.y, v.y), fmaf(m, x.z, v.z),
                         fmaf(m, x.w, v.w));
      } else {
        *d = v;
      }
    }
  } else {
    for (int e = t; e < nv * n; e += kTileThreads) {
      const int r = e / n, c = e - r * n;
      float* d = base + static_cast<size_t>(r) * s.ld + c;
      *d = s.fold ? fmaf(dd[r], *d, *at(src, r, c)) : *at(src, r, c);
    }
  }
}

// One layer, K -> N = 128 NG, in place in x, then to its sink.
template <int kAct, int NG>
__device__ __forceinline__ void layer(const Buf& x, int K, const Epi& e, const Sink& sk, int nv,
                                      const float* dd, Ctx& cx) {
  float tot[NG][32];
#pragma unroll
  for (int cg = 0; cg < NG; ++cg)
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[cg][i] = 0.f;
  product<NG>(tot, x, K / kSlabK, cx);
  named_bar_sync(kBar, kTileThreads);   // both warpgroups have read x
  epilogue<kAct, NG, 8>(tot, 0, e, cx);
  named_bar_sync(kBar, kTileThreads);   // x holds the output
  to_sink(sk, 0, x, NG * kSlabN, nv, dd);
}

// Two layers, K -> N -> 512, in place in x: the N columns a chunk of 64 at a
// time through cb (each chunk to sink s1), each chunk at once 64 of the
// second product's K; the second product's output to s2.
template <int kAct>
__device__ __forceinline__ void chain(const Buf& x, const Buf& cb, int K, int N, Epi e1,
                                      const Epi& e2, const Sink& s1, const Sink& s2, int nv,
                                      const float* dd, Ctx& cx) {
  constexpr int NG2 = kXMax / kSlabN;
  float y[NG2][32];
#pragma unroll
  for (int cg = 0; cg < NG2; ++cg)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[cg][i] = 0.f;
  for (int c = 0; c < N / kChunk; ++c) {
    float h[1][16];
#pragma unroll
    for (int i = 0; i < 16; ++i) h[0][i] = 0.f;
    product_chunk(h, x, K / kChunk, cx);
    named_bar_sync(kBar, kTileThreads);   // both warpgroups have read the last chunk
    e1.col0 = c * kChunk;
    epilogue<kAct, 1, 4>(h, c, e1, cx);
    named_bar_sync(kBar, kTileThreads);   // cb holds chunk c
    to_sink(s1, c * kChunk, cb, kChunk, nv, dd);
    product<NG2>(y, cb, kChunk / kSlabK, cx);
  }
  named_bar_sync(kBar, kTileThreads);     // both warpgroups have read x
  epilogue<kAct, NG2, 8>(y, 0, e2, cx);
  named_bar_sync(kBar, kTileThreads);
  to_sink(s2, 0, x, kXMax, nv, dd);
}

enum Pass { kForward = 0, kPullback = 1, kEChain = 2 };

// The CTA's scratch rows: layer l's a block and c block from its first row.
struct Rows {
  const Args* a;
  const int* in;    // real widths, (kMaxL,) each
  const int* out;
  const int* aoff;  // sum of the earlier layers' widths
  const int* coff;
  int row0;
  __device__ float* a_rows(int l) const {
    return a->a_scr + static_cast<size_t>(a->B) * aoff[l] + static_cast<size_t>(row0) * in[l];
  }
  __device__ float* c_rows(int l) const {
    return a->c_scr + static_cast<size_t>(a->B) * coff[l] + static_cast<size_t>(row0) * out[l];
  }
  // the sink of the output of DFNet layer l: in the forward and the e-chain
  // x_{l+1} (a block l + 1), in the pullback c_{l-1} (c block l - 1; none
  // for l = 0, the code's gradient)
  __device__ Sink of(int pass, int l) const {
    if (pass == kPullback)
      return l >= 1 ? Sink{c_rows(l - 1), out[l - 1], false} : Sink{nullptr, 0, false};
    return Sink{a_rows(l + 1), in[l + 1], pass == kEChain};
  }
};

// One step of the program (fused_model.tc_schedule): [chain, K, N, N2,
// bias1, z1, bias2, z2], its first layer l (a chain: l and l + 1 forward,
// l and l - 1 in the pullback). The forward sets the biases and writes the
// act' bits; the pullback and the e-chain read them.
template <int kAct>
__device__ __forceinline__ void run_step(const int* st, int pass, int l, const Rows& rows,
                                         const Buf& x, const Buf& cb, const float* vec,
                                         uint32_t* bits, int nv, const float* dd, Ctx& cx) {
  int s[kStep];
#pragma unroll
  for (int i = 0; i < kStep; ++i) s[i] = __ldg(st + i);
  const bool fwd = pass == kForward;
  const Epi e1{fwd ? vec + s[4] : nullptr, s[5] >= 0 ? bits + 4 * s[5] : nullptr, s[0] ? cb : x, 0};
  if (s[0]) {
    const int l2 = pass == kPullback ? l - 1 : l + 1;
    const Epi e2{fwd ? vec + s[6] : nullptr, s[7] >= 0 ? bits + 4 * s[7] : nullptr, x, 0};
    chain<kAct>(x, cb, s[1], s[2], e1, e2, rows.of(pass, l), rows.of(pass, l2), nv, dd, cx);
  } else {
    const Sink sk = rows.of(pass, l);
    switch (s[2] / kSlabN) {
      case 1: layer<kAct, 1>(x, s[1], e1, sk, nv, dd, cx); break;
      case 2: layer<kAct, 2>(x, s[1], e1, sk, nv, dd, cx); break;
      default: layer<kAct, 4>(x, s[1], e1, sk, nv, dd, cx); break;
    }
  }
}

// ---- the encoder walks ----
// Four threads a pose (tc_tile.cuh), as the field kernels' walks: a joint's
// features (in the reverse walk its parent's code gradient, in the e-chain
// its code e-cotangent) stay in the pose's row of x, read by the same warp
// after a __syncwarp. Each walk first stages the rows it reads from the
// encoder's weights (Args::enc) into the ring's space: the forward walk
// runs before the ring's first copy, the reverse walk and the e-chain's
// encoder half after the pullback's last slab, beside gx. The rows of every
// width fit there (static_asserts below), so no walk reads its weights from
// global memory. The pre-activations ez, gh | gf and the e-chain's L1 | L2
// rows stay in the CTA's global scratch, each pose's written and read by its
// own lanes, the loads of the joint two ahead issued before this joint's
// arithmetic; act'(z) of every unit also stays in shared memory as one bit
// a pose (enc_keep_bits), which the reverse walk and the e-chain read, so
// only the e-chain reads pre-activations back, for the values act(z).
// The encoder's weight gradient is summed after the e-chain's walk, behind
// one barrier. The staged rows are tc_tile::Walk's: the forward's R wide,
// the reverse walk's W2 and W1 rows RF and RE, the e-chain's forward rows
// without the bias RE.

// the rows of each walk, and the reverse and the e-chain's beside gx, fit
// the ring's space at the widest J and F
static_assert(kMaxJ * kMaxU * round4(kMaxE + 1) <= kRingFloats, "forward rows");
static_assert(kMaxJ * 4 * kRows + kMaxJ * kMaxE * (round4(kMaxF) + round4(kMaxE)) <= kRingFloats,
              "reverse rows beside gx");
static_assert(kMaxJ * 4 * kRows + kMaxJ * kMaxU * round4(kMaxE) <= kRingFloats,
              "e-chain rows beside gx");

// n floats to dst, float i being src(i) (every thread): kStageBatch loads a
// thread in flight before their stores, so a staging waits on L2 a few
// times, not once a float
constexpr int kStageBatch = 8;

template <typename Src>
__device__ __forceinline__ void stage(float* dst, int n, const Src& src) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kStageBatch * kTileThreads) {
    float v[kStageBatch];
#pragma unroll
    for (int q = 0; q < kStageBatch; ++q) {
      const int i = i0 + q * kTileThreads;
      v[q] = i < n ? src(i) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kStageBatch; ++q)
      if (i0 + q * kTileThreads < n) dst[i0 + q * kTileThreads] = v[q];
  }
}

// the forward's rows, `width` floats each, to dst: per joint E hidden rows
// (unit u: W1[j][:, u]) and F feature rows (feature k: W2[j][:, k]), then
// with `bias` the unit's bias, then zeros (every thread)
template <int kF>
__device__ __forceinline__ void stage_columns(float* dst, const Args& a, const Walk<kF>& w,
                                              int width, bool bias) {
  const int E = w.E, F = w.F, U = w.U, J = a.J;
  const float* w1 = a.enc;
  const float* b1 = w1 + J * E * E;
  const float* w2 = b1 + J * E;
  const float* b2 = w2 + J * E * F;
  stage(dst, J * U * width, [&](int i) {
    const int row = i / width, c = i - row * width, j = row / U, v = row - j * U;
    if (c < E) return v < E ? __ldg(w1 + (j * E + c) * E + v) : __ldg(w2 + (j * E + c) * F + v - E);
    if (c == E && bias) return v < E ? __ldg(b1 + j * E + v) : __ldg(b2 + j * F + v - E);
    return 0.f;
  });
}

// the reverse walk's rows to dst: W2's rows (J, E, RF), then W1's (J, E, RE),
// zeros past each row's weights (every thread)
template <int kF>
__device__ __forceinline__ void stage_rows(float* dst, const Args& a, const Walk<kF>& w) {
  const int E = w.E, F = w.F, J = a.J;
  const float* w1 = a.enc;
  const float* w2 = w1 + J * E * E + J * E;
  const int n2 = J * E * w.RF;
  stage(dst, n2 + J * E * w.RE, [&](int i) {
    if (i < n2) {
      const int row = i / w.RF, c = i - row * w.RF;
      return c < F ? __ldg(w2 + row * F + c) : 0.f;
    }
    const int row = (i - n2) / w.RE, c = i - n2 - row * w.RE;
    return c < E ? __ldg(w1 + row * E + c) : 0.f;
  });
}

// Input normalization (noisy branch; the manifold rows go in as they are)
// and encoder walk of the CTA's 64 poses into the code x (64, D0), four
// threads a pose (above), from the forward's rows (and the CTA's poses,
// where they fit) staged in the ring's space wr. The pre-activations go to
// ez[(j (E + F) + o) 64 + pose] and their act' to ezb (enc_keep_bits), the
// norms and squared sums to the scalars. Ends with a named barrier after an
// async-proxy fence: x holds the code, and the ring's copies may overwrite
// wr.
template <int kAct, int kF>
__device__ __forceinline__ void encode(const Args& a, int row0, const Buf& x, int D0, float* scal,
                                       float* ez, unsigned char* ezb, const int* parents,
                                       float* wr) {
  const int t = threadIdx.x, p = t / 4, r = t % 4;
  const int J = a.J;
  const Walk<kF> w(a);
  const int E = w.E, F = w.F, U = w.U;
  // the rows, then the CTA's poses (p, j) as float4 nf / 4 + p J + j, zeros
  // past B, where they fit
  const int nf = J * U * w.R;   // w.nf here changes the tile's SASS
  stage_columns(wr, a, w, w.R, true);
  const bool staged = nf + kRows * J * 4 <= kRingFloats;
  float* qs = wr + nf;
  if (staged) {   // at most kMaxJ / 4 float4s a thread, all in flight at once
    const float4* src = reinterpret_cast<const float4*>(a.pose) + static_cast<size_t>(row0) * J;
    const int n = min(kRows, a.B - row0) * J;
    float4 v[kMaxJ * kRows / kTileThreads];
#pragma unroll
    for (int q = 0; q < kMaxJ * kRows / kTileThreads; ++q) {
      const int i = t + q * kTileThreads;
      v[q] = i < n ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kMaxJ * kRows / kTileThreads; ++q)
      if (t + q * kTileThreads < kRows * J) reinterpret_cast<float4*>(qs)[t + q * kTileThreads] = v[q];
  }
  const bool valid = row0 + p < a.B;
  const float4* q4 =
      reinterpret_cast<const float4*>(a.pose) + static_cast<size_t>(valid ? row0 + p : 0) * J;
  auto pose = [&](int j) {
    return staged ? reinterpret_cast<const float4*>(qs)[p * J + j]
                  : (valid ? __ldg(q4 + j) : make_float4(0.f, 0.f, 0.f, 0.f));
  };
  const int JF = J * F, pad = D0 - JF;   // the code's padding columns are zeros
  if (pad > 0)
    for (int i = t; i < kRows * pad; i += kTileThreads) *at(x, i / pad, JF + i % pad) = 0.f;
  named_bar_sync(kBar, kTileThreads);   // the rows (and the poses) are staged
  float n[4];
  {
    float s = 1.f, nr = 1.f;   // component r: the normalization's sum over the joints
    if (a.eikonal) {
      s = 0.f;
      for (int j = 0; j < J; ++j) {
        const float4 q = pose(j);
        const float v = r == 0 ? q.x : r == 1 ? q.y : r == 2 ? q.z : q.w;
        s = fmaf(v, v, s);
      }
      nr = sqrtf(fmaxf(s, kEps2));
    }
    scal[(kPS + r) * kRows + p] = s;
    scal[(kPN + r) * kRows + p] = nr;
#pragma unroll
    for (int c = 0; c < 4; ++c) n[c] = __shfl_sync(0xffffffffu, nr, (t & 28) | c);
  }
  for (int j = 0; j < J; ++j) {
    const float4 q = pose(j);
    const int par = parents[j];
    float in[kMaxE];
    in[0] = q.x / n[0];
    in[1] = q.y / n[1];
    in[2] = q.z / n[2];
    in[3] = q.w / n[3];
#pragma unroll
    for (int k = 0; k < kMaxF; ++k) in[4 + k] = (k < F && par >= 0) ? *at(x, p, par * F + k) : 0.f;
    const float* rows = wr + j * U * w.R;
    float* zj = ez + j * U * kRows + p;
    float z[kMaxE / 4], mine[kMaxE / 4];
#pragma unroll
    for (int i = 0; i < kMaxE / 4; ++i) {
      const int u = r + 4 * i;
      z[i] = u < E ? walk_dot(in, rows + u * w.R, E, true) : 0.f;
      if (u < E) zj[u * kRows] = z[i];
      mine[i] = act_fwd(kAct, 0.f, z[i]);
    }
    enc_keep_bits<kAct>(ezb, j * U, E, z);
    float h[kMaxE];
#pragma unroll
    for (int u = 0; u < kMaxE; ++u) h[u] = u < E ? from_part(mine, u) : 0.f;
    float zf[kMaxF / 4];
#pragma unroll
    for (int i = 0; i < kMaxF / 4; ++i) {
      const int k = r + 4 * i;
      zf[i] = k < F ? walk_dot(h, rows + (E + k) * w.R, E, true) : 0.f;
      if (k < F) {
        zj[(E + k) * kRows] = zf[i];
        *at(x, p, j * F + k) = act_fwd(kAct, 0.f, zf[i]);
      }
    }
    enc_keep_bits<kAct>(ezb, j * U + E, F, zf);
    __syncwarp();
  }
  fence_proxy_async();   // the staged rows and poses, before the ring's copies overwrite them
  named_bar_sync(kBar, kTileThreads);
}

// The output layer (K -> 1) on the CUDA cores, four threads a pose each
// summing a quarter of K into part (4, 64); then d = relu(sum + b), the
// distance loss and its cotangent dd (dd_coef times sign(r) or 2r; 0 on the
// ragged tail) and c_{L-1} = [d > 0] to its scratch row.
__device__ __forceinline__ void output_layer(const Args& a, int row0, const Buf& x, int K,
                                             const float* wl, float bl, float* part, float* scal,
                                             float* c_last) {
  const int t = threadIdx.x, p = t % kRows, r = t / kRows, n = K / 4;
  float s = 0.f;
  for (int c = r * n; c < (r + 1) * n; ++c) s = fmaf(*at(x, p, c), __ldg(wl + c), s);
  part[r * kRows + p] = s;
  named_bar_sync(kBar, kTileThreads);
  if (t < kRows) {
    const float z = (part[p] + part[kRows + p]) + (part[2 * kRows + p] + part[3 * kRows + p]) + bl;
    const float d = z > 0.f ? z : 0.f;
    const int b = row0 + p;
    float lsum = 0.f, dd = 0.f;
    if (b < a.B) {
      const float res = d - (a.gt != nullptr ? __ldg(a.gt + b) : 0.f);
      if (a.l2) {
        lsum = res * res;
        dd = a.dd_coef * 2.f * res;
      } else {
        lsum = fabsf(res);
        dd = a.dd_coef * static_cast<float>((res > 0.f) - (res < 0.f));
      }
      a.dd_out[b] = dd;
      c_last[p] = d > 0.f ? 1.f : 0.f;
    }
    scal[kPD * kRows + p] = d;
    scal[kPDD * kRows + p] = dd;
    scal[kPL * kRows + p] = lsum;
    scal[kPE * kRows + p] = 0.f;
  }
  named_bar_sync(kBar, kTileThreads);
}

// The pullback's start: c_{L-2} = [d > 0] w act'(z_{L-2}), written to x
// (64, K) in the fragments' layout.
template <int kAct>
__device__ __forceinline__ void pullback_start(const Buf& x, int K, const float* wl,
                                               const uint32_t* bits, const float* scal,
                                               const Ctx& cx) {
  const int r = 16 * (cx.tw / 32) + (cx.tw % 32) / 4;
  const float go0 = scal[kPD * kRows + r] > 0.f ? 1.f : 0.f;
  const float go1 = scal[kPD * kRows + r + 8] > 0.f ? 1.f : 0.f;
  for (int cg = 0; cg < K / kSlabN; ++cg) {
    const uint32_t word = bits[(cg * 2 + cx.w) * 128 + cx.tw];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg * kSlabN + 64 * cx.w + 8 * j + 2 * (cx.tw % 4);
      const float2 wv = __ldg(reinterpret_cast<const float2*>(wl + c));
      *reinterpret_cast<float2*>(at(x, r, c)) =
          make_float2(go0 * wv.x * act_slope<kAct>(word, 4 * j),
                      go0 * wv.y * act_slope<kAct>(word, 4 * j + 1));
      *reinterpret_cast<float2*>(at(x, r + 8, c)) =
          make_float2(go1 * wv.x * act_slope<kAct>(word, 4 * j + 2),
                      go1 * wv.y * act_slope<kAct>(word, 4 * j + 3));
    }
  }
  named_bar_sync(kBar, kTileThreads);
}

// The encoder's reverse walk, j = J-1 .. 0, from the code gradient in x,
// four threads a pose (above): gf = gx_code[j] act'(f_pre) (every part, all
// F); gh = (W2[j] gf) act'(h_pre) (part r: units r + 4i, then traded); then
// W1[j] gh (part r: rows r + 4i): its first 4 rows to gx (J, 4, 64, at the
// ring's start), the rest added into the parent's code gradient. Each
// joint's gh | gf go to gg (as ez; zeros on the ragged tail) for the
// encoder's weight gradient. act' from the forward's bits (ezb). The rows
// staged after gx. Ends with a named barrier: gx is whole.
template <int kAct, int kF>
__device__ __forceinline__ void encode_backward(const Args& a, int row0, const Buf& x,
                                                const unsigned char* ezb, float* gg, float* gx,
                                                const int* parents) {
  const int t = threadIdx.x, p = t / 4, r = t % 4;
  const int J = a.J;
  const Walk<kF> w(a);
  const int E = w.E, F = w.F, U = w.U;
  const bool valid = row0 + p < a.B;
  float* w2 = gx + J * 4 * kRows;   // W2's rows, then W1's
  float* w1 = w2 + J * E * w.RF;
  stage_rows(w2, a, w);
  named_bar_sync(kBar, kTileThreads);
  for (int j = J - 1; j >= 0; --j) {
    const int par = parents[j];
    float* gj = gg + j * U * kRows + p;
    float gf[kMaxF];
#pragma unroll
    for (int k = 0; k < kMaxF; ++k)
      gf[k] = k < F ? *at(x, p, j * F + k) * enc_slope<kAct>(ezb, j * U + E + k, p) : 0.f;
#pragma unroll
    for (int ki = 0; ki < kMaxF / 4; ++ki) {
      const int k = r + 4 * ki;
      if (k < F) gj[(E + k) * kRows] = valid ? gf[k] : 0.f;
    }
    float mine[kMaxE / 4];
#pragma unroll
    for (int i = 0; i < kMaxE / 4; ++i) {
      const int o = r + 4 * i;
      mine[i] = o < E ? walk_dot(gf, w2 + (j * E + o) * w.RF, F, false) *
                            enc_slope<kAct>(ezb, j * U + o, p)
                      : 0.f;
      if (o < E) gj[o * kRows] = valid ? mine[i] : 0.f;
    }
    float gh[kMaxE];
#pragma unroll
    for (int o = 0; o < kMaxE; ++o) gh[o] = o < E ? from_part(mine, o) : 0.f;
#pragma unroll
    for (int ii = 0; ii < kMaxE / 4; ++ii) {
      const int i = r + 4 * ii;
      if (i < E && (i < 4 || par >= 0)) {
        const float s = walk_dot(gh, w1 + (j * E + i) * w.RE, E, false);
        if (i < 4)
          gx[(j * 4 + i) * kRows + p] = s;
        else
          *at(x, p, par * F + i - 4) += s;
      }
    }
    __syncwarp();
  }
  named_bar_sync(kBar, kTileThreads);
}

// The noisy branch's normalization VJP, eikonal term and its cotangent:
// gq = gx / n - q <gx, q>_J [s >= eps^2] / n^3; the term sums (|gq_j| - 1)^2
// over the joints; its cotangent Ggq = eik_coef (|gq_j| - 1) / |gq_j| gq_j
// goes back through the same (symmetric) operator to Ggx, over gx. Thread
// t: component t / 64 of pose t % 64; gn (J, 64) holds |gq_j|.
__device__ __forceinline__ void eikonal(const Args& a, int row0, float* gx, float* gn,
                                        float* scal) {
  const int t = threadIdx.x, p = t % kRows, c = t / kRows, J = a.J;
  const bool valid = row0 + p < a.B;
  const float* qc = a.pose + static_cast<size_t>(valid ? row0 + p : 0) * J * 4 + c;
  const float n = scal[(kPN + c) * kRows + p], s = scal[(kPS + c) * kRows + p];
  const float coef = s >= kEps2 ? 1.f / (n * n * n) : 0.f;
  float dot = 0.f;
  for (int j = 0; j < J; ++j)
    dot = fmaf(gx[(j * 4 + c) * kRows + p], valid ? __ldg(qc + 4 * j) : 0.f, dot);
  for (int j = 0; j < J; ++j) {
    float* g = gx + (j * 4 + c) * kRows + p;
    *g = *g / n - (valid ? __ldg(qc + 4 * j) : 0.f) * (dot * coef);
  }
  named_bar_sync(kBar, kTileThreads);
  for (int j = c; j < J; j += 4) {
    float sq = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float g = gx[(j * 4 + cc) * kRows + p];
      sq = fmaf(g, g, sq);
    }
    gn[j * kRows + p] = sqrtf(sq + 1e-12f);
  }
  named_bar_sync(kBar, kTileThreads);
  float dotg = 0.f, esum = 0.f;
  for (int j = 0; j < J; ++j) {
    const float norm = gn[j * kRows + p], dif = norm - 1.f;
    esum = fmaf(dif, dif, esum);
    const float q = valid ? __ldg(qc + 4 * j) : 0.f;
    float* g = gx + (j * 4 + c) * kRows + p;
    const float v = valid ? a.eik_coef * (dif / norm) * *g : 0.f;   // a padded row's gq may be huge
    *g = v;
    dotg = fmaf(v, q, dotg);
  }
  for (int j = 0; j < J; ++j) {
    float* g = gx + (j * 4 + c) * kRows + p;
    *g = *g / n - (valid ? __ldg(qc + 4 * j) : 0.f) * (dotg * coef);
  }
  if (c == 0) scal[kPE * kRows + p] = valid ? esum : 0.f;
  named_bar_sync(kBar, kTileThreads);
}

// The e-chain's encoder half (parents before children; the manifold branch
// has no e-cotangent) and the encoder's weight gradient. The walk, four
// threads a pose (above), from the forward's rows without their biases
// (noisy branch), staged after gx: per joint L1 = dd inp + egin and L2 = dd
// h + ea (part r: rows r + 4i; zeros on the ragged tail) to lr, and the
// code's e-cotangent efeat over the code gradient in x (a joint's columns
// once its own inputs are read; its children read them). Then, behind one
// barrier, the CTA's sums over its 64 poses in order, w1[j] = L1^T gh,
// b1[j] = dd^T gh, w2[j] = L2^T gf, b2[j] = dd^T gf, to its slot: a thread
// a joint and L1 (L2) row or dd, all of that row's sums at once. act' from
// the forward's bits (ezb); the values h and the parent's features from ez.
template <int kAct, int kF>
__device__ __forceinline__ void encoder_grad(const Args& a, int cta, const Buf& x,
                                             const float* ez, const unsigned char* ezb,
                                             const float* gg, float* lr, const float* gx,
                                             const float* scal, const int* parents, float* wr) {
  const int row0 = cta * kRows;
  const int t = threadIdx.x, p = t / 4, r = t % 4;
  const int J = a.J;
  const Walk<kF> w(a);
  const int E = w.E, F = w.F, U = w.U;
  const bool valid = row0 + p < a.B, eik = a.eikonal != 0;
  const float* qr = a.pose + static_cast<size_t>(valid ? row0 + p : 0) * J * 4 + r;
  float* L1 = lr;
  float* L2 = lr + J * E * kRows;
  const float* ddv = scal + kPDD * kRows;
  const float dd = ddv[p];
  const float nr = scal[(kPN + r) * kRows + p];   // the norm of component r
  if (eik) {
    stage_columns(wr, a, w, w.RE, false);
    named_bar_sync(kBar, kTileThreads);
  }
  // what joint j reads from global memory: the pre-activations of the
  // pose's hidden units r + 4i and of its parent's features r + 4i, and
  // component r of the joint
  struct Ahead {
    float zh[kMaxE / 4], zp[kMaxF / 4], q;
  };
  auto load = [&](int j) {
    Ahead n;
    const int par = parents[j];
    const float* zj = ez + j * U * kRows + p;
    const float* zq = ez + (par >= 0 ? par : 0) * U * kRows + p;
#pragma unroll
    for (int i = 0; i < kMaxE / 4; ++i) n.zh[i] = r + 4 * i < E ? zj[(r + 4 * i) * kRows] : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxF / 4; ++i)
      n.zp[i] = par >= 0 && r + 4 * i < F ? zq[(E + r + 4 * i) * kRows] : 0.f;
    n.q = valid ? __ldg(qr + 4 * j) : 0.f;
    return n;
  };
  Ahead cur = load(0), nxt = load(J > 1 ? 1 : 0);   // joints j and j + 1
  for (int j = 0; j < J; ++j) {
    const Ahead far = load(j + 2 < J ? j + 2 : j);   // joint j + 2's, in flight
    const int par = parents[j];
    float egin[kMaxE];
#pragma unroll
    for (int c = 0; c < 4; ++c) egin[c] = eik ? gx[(j * 4 + c) * kRows + p] : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxF; ++k)
      egin[4 + k] = eik && k < F && par >= 0 ? *at(x, p, par * F + k) : 0.f;
    // L1's rows r (the pose) and 4 + r + 4i (the parent's features)
    L1[(j * E + r) * kRows + p] =
        valid ? fmaf(dd, cur.q / nr, eik ? gx[(j * 4 + r) * kRows + p] : 0.f) : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxF / 4; ++i) {
      const int k = r + 4 * i;
      if (k < F) {
        const bool live = par >= 0;
        const float in = live ? act_fwd(kAct, 0.f, cur.zp[i]) : 0.f;
        const float eg = live && eik ? *at(x, p, par * F + k) : 0.f;
        L1[(j * E + 4 + k) * kRows + p] = valid ? fmaf(dd, in, eg) : 0.f;
      }
    }
    const float* rows = wr + j * U * w.RE;
    float mine[kMaxE / 4];
#pragma unroll
    for (int i = 0; i < kMaxE / 4; ++i) {
      const int u = r + 4 * i;
      float ea = 0.f;
      if (eik && u < E)
        ea = walk_dot(egin, rows + u * w.RE, E, false) * enc_slope<kAct>(ezb, j * U + u, p);
      mine[i] = ea;
      if (u < E)
        L2[(j * E + u) * kRows + p] = valid ? fmaf(dd, act_fwd(kAct, 0.f, cur.zh[i]), ea) : 0.f;
    }
    if (eik) {
      float ea[kMaxE];
#pragma unroll
      for (int u = 0; u < kMaxE; ++u) ea[u] = u < E ? from_part(mine, u) : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxF / 4; ++i) {
        const int k = r + 4 * i;
        if (k < F)
          *at(x, p, j * F + k) = walk_dot(ea, rows + (E + k) * w.RE, E, false) *
                                 enc_slope<kAct>(ezb, j * U + E + k, p);
      }
    }
    __syncwarp();
    cur = nxt;
    nxt = far;
  }
  named_bar_sync(kBar, kTileThreads);   // every pose's rows are written, x holds efeat
  float* slot = a.enc_slot + static_cast<size_t>(cta) * enc_floats(J, F);
  const int nw1 = E * E, nb1 = E, nw2 = E * F;
  for (int it = t; it < J * (E + 1); it += kTileThreads) {
    const int j = it / (E + 1), i = it - j * (E + 1);   // i == E: the biases' row, dd
    const float4* l1 = reinterpret_cast<const float4*>(i < E ? L1 + (j * E + i) * kRows : ddv);
    const float4* l2 = reinterpret_cast<const float4*>(i < E ? L2 + (j * E + i) * kRows : ddv);
    const float* gh = gg + j * U * kRows;
    const float* gf = gh + E * kRows;
    float s1[kMaxE], s2[kMaxF];
#pragma unroll
    for (int u = 0; u < kMaxE; ++u) s1[u] = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxF; ++k) s2[k] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kRows / 4; ++c) {   // poses 4c .. 4c + 3, in order
      const float4 v1 = l1[c], v2 = l2[c];
#pragma unroll
      for (int u = 0; u < kMaxE; ++u) {
        if (u < E) {
          const float4 g = reinterpret_cast<const float4*>(gh + u * kRows)[c];
          s1[u] = fmaf(v1.w, g.w, fmaf(v1.z, g.z, fmaf(v1.y, g.y, fmaf(v1.x, g.x, s1[u]))));
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxF; ++k) {
        if (k < F) {
          const float4 g = reinterpret_cast<const float4*>(gf + k * kRows)[c];
          s2[k] = fmaf(v2.w, g.w, fmaf(v2.z, g.z, fmaf(v2.y, g.y, fmaf(v2.x, g.x, s2[k]))));
        }
      }
    }
    float* o1 = slot + (i < E ? j * nw1 + i * E : J * nw1 + j * E);
    float* o2 = slot + (i < E ? J * (nw1 + nb1) + j * nw2 + i * F : J * (nw1 + nb1 + nw2) + j * F);
#pragma unroll
    for (int u = 0; u < kMaxE; ++u)
      if (u < E) o1[u] = s1[u];
#pragma unroll
    for (int k = 0; k < kMaxF; ++k)
      if (k < F) o2[k] = s2[k];
  }
  if (t == 0) {
    float ls = 0.f, es = 0.f;
    for (int pp = 0; pp < kRows; ++pp) {
      ls += scal[kPL * kRows + pp];
      es += scal[kPE * kRows + pp];
    }
    a.loss_slot[2 * cta] = ls;
    a.loss_slot[2 * cta + 1] = es;
  }
}

// The walks, with the SMPL fields' feature width at compile time (kWalkF)
// and any other at run time: at F = 6 the run-time walk alone makes the
// tile 4.3% slower (6.16 against 5.90 ms at 20,000 + 20,000 poses, H100 80GB
// HBM3 at 700 W).
template <int kAct>
__device__ __forceinline__ void walk_forward(const Args& a, int row0, const Buf& x, int D0,
                                             float* scal, float* ez, unsigned char* ezb,
                                             const int* parents, float* wr) {
  if (a.F == kWalkF)
    encode<kAct, kWalkF>(a, row0, x, D0, scal, ez, ezb, parents, wr);
  else
    encode<kAct, 0>(a, row0, x, D0, scal, ez, ezb, parents, wr);
}

template <int kAct>
__device__ __forceinline__ void walk_backward(const Args& a, int row0, const Buf& x,
                                              const unsigned char* ezb, float* gg, float* gx,
                                              const int* parents) {
  if (a.F == kWalkF)
    encode_backward<kAct, kWalkF>(a, row0, x, ezb, gg, gx, parents);
  else
    encode_backward<kAct, 0>(a, row0, x, ezb, gg, gx, parents);
}

template <int kAct>
__device__ __forceinline__ void walk_echain(const Args& a, int cta, const Buf& x, const float* ez,
                                            const unsigned char* ezb, const float* gg, float* lr,
                                            const float* gx, const float* scal,
                                            const int* parents, float* wr) {
  if (a.F == kWalkF)
    encoder_grad<kAct, kWalkF>(a, cta, x, ez, ezb, gg, lr, gx, scal, parents, wr);
  else
    encoder_grad<kAct, 0>(a, cta, x, ez, ezb, gg, lr, gx, scal, parents, wr);
}

template <int kAct>
__global__ void __launch_bounds__(kTileThreads, 1)
    train_tile_kernel(const __grid_constant__ Launch la) {
  const int branch = static_cast<int>(blockIdx.x) < la.ctas0 ? 0 : 1;
  const Args& a = la.br[branch];
  const int cta = static_cast<int>(blockIdx.x) - branch * la.ctas0;   // within the branch
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* xs = reinterpret_cast<float*>(ring + kStages * kSlabBytes);
  float* cs = xs + kRows * kXMax;
  float* scal = cs + kRows * kChunk;
  int* lay = reinterpret_cast<int*>(scal + kScalars * kRows);   // in | out | aoff | coff
  int* parents = lay + 4 * kMaxL;
  unsigned char* ezb = reinterpret_cast<unsigned char*>(parents + kMaxJ);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ezb + kEncBitBytes);
  if (threadIdx.x == 0) {
    int sa = 0, sc = 0;
    for (int l = 0; l < a.L; ++l) {
      lay[l] = __ldg(a.meta + kMeta * l);
      lay[kMaxL + l] = __ldg(a.meta + kMeta * l + 1);
      lay[2 * kMaxL + l] = sa;
      lay[3 * kMaxL + l] = sc;
      sa += lay[l];
      sc += lay[kMaxL + l];
    }
  }
  for (int j = threadIdx.x; j < a.J; j += kTileThreads) parents[j] = __ldg(a.parents + j);
  init_ring(bars, kStages, 1, 1);   // full barriers; the empty ones go unused (syncs the CTA)

  // the forward and the pullback stream every slab once, from the end of the
  // forward walk, whose rows the ring's space holds until then; the e-chain's
  // pass (the forward's slabs again) is filled once the ring's space is free
  const int nfb = a.nfwd + a.nbwd;
  Ctx cx{bars, ring, a.slabs, nfb, nfb, 0, static_cast<int>(threadIdx.x) / 128,
         static_cast<int>(threadIdx.x) % 128};

  const int row0 = cta * kRows;
  const int nv = min(kRows, a.B - row0);
  const int J = a.J, F = a.F, E = 4 + F;
  const int* head = a.prog;
  const int nfwd_steps = prog_nfwd(head), nbwd_steps = prog_nbwd(head);
  const int zsum = prog_zsum(head);
  const int n = a.L - 1;   // DFNet products on the tensor cores: layers 0 .. n - 1
  const Buf x{xs, kXMax}, cb{cs, kChunk};
  const Rows rows{&a, lay, lay + kMaxL, lay + 2 * kMaxL, lay + 3 * kMaxL, row0};
  uint32_t* bits = reinterpret_cast<uint32_t*>(a.scratch + cta * scratch_floats(J, F, zsum));
  float* ez = reinterpret_cast<float*>(bits + 4 * zsum);
  float* gg = ez + J * (E + F) * kRows;
  float* lr = gg + J * (E + F) * kRows;
  const float* dd = scal + kPDD * kRows;

  // ---- forward: x_0 (the code) and every hidden x_l to the scratch ----
  walk_forward<kAct>(a, row0, x, __ldg(head + 2), scal, ez, ezb, parents, reinterpret_cast<float*>(ring));
  for (int g = 0; g < kStages; ++g) fill(cx, g);
  to_sink(Sink{rows.a_rows(0), rows.in[0], false}, 0, x, rows.in[0], nv, dd);
  const int* step = head + kHead;
  for (int i = 0, l = 0; i < nfwd_steps; ++i, step += kStep) {
    run_step<kAct>(step, kForward, l, rows, x, cb, a.vec, bits, nv, dd, cx);
    l += __ldg(step) ? 2 : 1;
  }
  const int K = prog_K(head);
  const float* wl = a.vec + prog_w_out(head);
  output_layer(a, row0, x, K, wl, __ldg(a.vec + prog_b_out(head)), cs, scal,
               rows.c_rows(a.L - 1));
  // ---- inner pullback with a unit cotangent: every c_l to the scratch ----
  pullback_start<kAct>(x, K, wl, bits + 4 * prog_z_last(head), scal, cx);
  to_sink(Sink{rows.c_rows(n - 1), rows.out[n - 1], false}, 0, x, K, nv, dd);
  for (int i = 0, l = n - 1; i < nbwd_steps; ++i, step += kStep) {
    run_step<kAct>(step, kPullback, l, rows, x, cb, a.vec, bits, nv, dd, cx);
    l -= __ldg(step) ? 2 : 1;
  }
  // ---- the encoder's reverse walk, the eikonal term, the encoder's
  //      gradient; every slab so far is read: the ring's space holds gx
  //      and each walk's rows ----
  float* gx = reinterpret_cast<float*>(ring);
  walk_backward<kAct>(a, row0, x, ezb, gg, gx, parents);
  if (a.eikonal) eikonal(a, row0, gx, gx + J * 4 * kRows, scal);
  walk_echain<kAct>(a, cta, x, ez, ezb, gg, lr, gx, scal, parents, gx + J * 4 * kRows);
  if (!a.eikonal) return;

  // ---- the e-chain, DFNet half (upward): a_l = dd x_l + ecx_l in place ----
  to_sink(Sink{rows.a_rows(0), rows.in[0], true}, 0, x, rows.in[0], nv, dd);
  fence_proxy_async();                   // the ring's space was written as gx
  named_bar_sync(kBar, kTileThreads);
  cx.lim = nfb + a.nfwd;
  for (int g = 0; g < kStages; ++g) fill(cx, cx.g + g);
  step = head + kHead;
  for (int i = 0, l = 0; i < nfwd_steps; ++i, step += kStep) {
    run_step<kAct>(step, kEChain, l, rows, x, cb, a.vec, bits, nv, dd, cx);
    l += __ldg(step) ? 2 : 1;
  }
}

}  // namespace tile

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
//    read one of two B slots, so step g + 1's B split overlaps them, and A's
//    split waits for them (reduce_tile). The accumulators start anew every
//    kFold steps and are then added to totals in registers with IEEE adds:
//    the tensor cores' fp32 accumulation rounds otherwise than an IEEE add,
//    so its error spans kFold steps only.
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
// nrows or a column past cols. Thread t of the CTA's kRThreads. kVec
// (cols and ld multiples of 4, src 16-byte aligned): 16-byte copies, thread
// t the 16-byte chunks t % 8 + 8 j of row t / 8, so a thread's four copies
// share one row address (a past-the-end row reads row nrows - 1's address
// for no bytes); else 4-byte copies, thread t column t % kRM of every other
// row.
template <bool kVec>
__device__ __forceinline__ void copy_raw(uint32_t dst, int ldr, const float* src, int ld, int cols,
                                         int k0, int nrows, int t) {
  if constexpr (kVec) {
    constexpr int kChunks = kRM / 4 / 8;   // a thread's chunks of its row
    static_assert(kRK * 8 == kRThreads && kChunks == 4, "a row a group of 8 threads");
    const int row = t / 8, c = 4 * (t % 8);
    const bool ok = k0 + row < nrows;
    const float* s = src + static_cast<size_t>(min(k0 + row, nrows - 1)) * ld + c;
    const uint32_t d = dst + (row * ldr + c) * 4;
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      cp_async16(d + 128 * j, s + 32 * j, ok && c + 32 * j < cols ? 16 : 0);
  } else {
    const int col = t % kRM;
#pragma unroll
    for (int j = 0; j < kRK * kRM / kRThreads; ++j) {
      const int row = t / kRM + (kRThreads / kRM) * j;
      const bool ok = k0 + row < nrows && col < cols;
      cp_async4(dst + (row * ldr + col) * 4,
                ok ? src + static_cast<size_t>(k0 + row) * ld + col : src, ok ? 4 : 0);
    }
  }
}

// B: column tw of the step's rows 16 half .. 16 half + 15, split into the
// slot at `hi` (hi | lo, kROp bytes apart) in the K-major 128-byte swizzle;
// returns the column's sum of dd[r] c[r] over those rows (fp32 FMAs in row
// order).
__device__ __forceinline__ float split_b(const float* rc, const float* rd, unsigned char* hi,
                                         int tw, int half) {
  float b = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // rows 4 q .. 4 q + 3
    const int q = 4 * half + i;
    const float4 d4 = reinterpret_cast<const float4*>(rd)[q];
    const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = rc[(4 * q + u) * kRM + tw];
      b = fmaf(dq[u], v[u], b);
    }
    const int off = sw128_offset(tw, 16 * q);
    const float h0 = tf32_round(v[0]), h1 = tf32_round(v[1]), h2 = tf32_round(v[2]),
                h3 = tf32_round(v[3]);
    *reinterpret_cast<float4*>(hi + off) = make_float4(h0, h1, h2, h3);
    *reinterpret_cast<float4*>(hi + kROp + off) =
        make_float4(tf32_round(v[0] - h0), tf32_round(v[1] - h1), tf32_round(v[2] - h2),
                    tf32_round(v[3] - h3));
  }
  return b;
}

// A: the thread's 16 values of the step's rows, times dd where `scale` (the
// manifold branch); x[kk][j] is (fm + 8 (j % 2), 8 kk + fk + 4 (j / 2)),
// register j of k8 step kk's fragment.
__device__ __forceinline__ void load_a(const float* ra, const float* rd, bool scale, int fm, int fk,
                                       float (&x)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // rows k = 8 kk + fk + 4 h: registers 2 h, 2 h + 1
      const int k = 8 * kk + fk + 4 * h;
      float v0 = ra[k * kRawA + fm], v1 = ra[k * kRawA + fm + 8];
      if (scale) {
        const float d = rd[k];
        v0 *= d;
        v1 *= d;
      }
      x[kk][2 * h] = v0;
      x[kk][2 * h + 1] = v1;
    }
  }
}

// k8 step KK of A split into its fragment registers (hi, lo), once the
// previous step's products of k8 step KK, which read them, are done (a step
// commits one wgmma group a k8 step, so wgmma_wait<3 - KK>), and before the
// next k8 step's wait.
template <int KK>
__device__ __forceinline__ void split_a(float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  wgmma_wait<3 - KK>();
  fence_regs(x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float h = tf32_round(x[j]);
    hi[j] = __float_as_uint(h);
    lo[j] = __float_as_uint(tf32_round(x[j] - h));
  }
  tc_tile::keep_regs(hi);
  tc_tile::keep_regs(lo);
}

// The step's 12 products into acc, one commit group a k8 step: B hi | lo
// at b_hi | b_lo, the small terms first; `fresh`: the first product
// overwrites acc.
template <int NT>
__device__ __forceinline__ void step_products(float (&acc)[NT / 2], const uint32_t (&af)[4][2][4],
                                              uint32_t b_hi, uint32_t b_lo, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_rs<NT>(acc, af[kk][1], desc_sw128(b_hi + kk * 32), !(fresh && kk == 0));
    wgmma_tf32_rs<NT>(acc, af[kk][0], desc_sw128(b_lo + kk * 32), 1);
    wgmma_tf32_rs<NT>(acc, af[kk][0], desc_sw128(b_hi + kk * 32), 1);
    wgmma_commit();
  }
}

// The CTA's tile: A and C point at the range's first row, at the tile's
// first column (acols / ccols of them are in the layer); dd at the range's
// first row; `scale`: A's rows times dd (the manifold branch); `bias`: the
// tile's column block of db into bias_dst. kVec: A's, C's and dd's rows take
// 16-byte copies.
//
// The pipeline, one CTA barrier a step: step g splits A into the fragment
// registers k8 step by k8 step, each once step g - 1's products of that k8
// step are done (one wgmma commit group a k8 step); after the barrier it
// issues its 12 products and, while they run, splits step g + 1's B into the
// other B slot. Nothing branches while products are in flight and every
// wgmma wait's depth is fixed when the code is compiled: ptxas serializes
// the products of a pipeline it cannot follow. The steps go in fold groups
// of kFold, unrolled, so that every slot is fixed by the step's position p in
// its group (raw slots p % kRaw and (p + 1) % kRaw, B slots p % kRStages and
// (p + 1) % kRStages); a group's last step waits for its products and folds
// the accumulator into the totals (IEEE adds). A range's last group runs
// whole: its steps past `steps` (and the one B split past it) read rows that
// the copies zero-fill, whose products add exact zeros to the group's
// accumulator and whose bias terms are zeros, so every sum is that of the
// steps alone.
template <int NT, bool kVec>
__device__ __forceinline__ void reduce_tile(unsigned char* ring, float* raw, float* bsum,
                                            int steps, int nrows, const float* A, int in,
                                            int acols, const float* C, int out, int ccols,
                                            const float* dd, bool scale, bool bias, float* dst,
                                            float* bias_dst, int i0, int o0) {
  static_assert(kFold % kRaw == 0 && kFold % kRStages == 0 && kRaw == 4,
                "a fold group's slots are fixed by its positions; rows of steps g .. g + 3");
  const int t = threadIdx.x, wg = t / 128, tw = t % 128, half = t / 128;
  const uint32_t raw_u = smem_u32(raw);
  // step g's rows into raw slot `slot` (g % kRaw), one commit group
  auto issue = [&](int g, int slot) {
    const uint32_t dst_u = raw_u + slot * kRawFloats * 4;
    const int k0 = g * kRK;
    copy_raw<kVec>(dst_u, kRawA, A, in, acols, k0, nrows, t);
    copy_raw<kVec>(dst_u + kRK * kRawA * 4, kRM, C, out, ccols, k0, nrows, t);
    const int q = t % (kRK / 4), k = k0 + 4 * q;   // dd: kRK / 4 threads, 4 rows each
    const int n = max(0, min(4, nrows - k));
    const uint32_t d_u = dst_u + (kRK * kRawA + kRK * kRM + 4 * q) * 4;
    const bool gd = t < kRK / 4;
    if constexpr (kVec) {
      cp_async16_if(d_u, n > 0 ? dd + k : dd, 4 * n, gd);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        cp_async4_if(d_u + 4 * u, u < n ? dd + k + u : dd, u < n ? 4 : 0, gd);
    }
    cp_async_commit();
  };
  auto rows = [&](int slot) { return raw + slot * kRawFloats; };   // A (32, kRawA) | C | dd
  auto bslot = [&](int s) { return ring + s * kRSlot; };

  float acc[NT / 2], tot[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = tot[i] = 0.f;
  float btot = 0.f;
  const bool sums_bias = bias && tw < ccols;
  // the thread's A fragment rows (of the tile) and K offsets within a k8 step
  const int fm = 64 * wg + 16 * ((t % 128) / 32) + (t % 32) / 4, fk = t % 4;
  uint32_t af[4][2][4];   // A fragments: hi and lo of 4 k8 steps

  // step g = g0 + P (P = pos, its place in the fold group)
  auto step = [&](auto pos, int g0) {
    constexpr int P = decltype(pos)::value;
    cp_async_wait<kRaw - 3>();   // this thread's copies of step g + 1's rows have landed
    const float* ra = rows(P % kRaw);
    float x[4][4];
    load_a(ra, ra + kRK * kRawA + kRK * kRM, scale, fm, fk, x);
    split_a<0>(x[0], af[0][0], af[0][1]);
    split_a<1>(x[1], af[1][0], af[1][1]);
    split_a<2>(x[2], af[2][0], af[2][1]);
    split_a<3>(x[3], af[3][0], af[3][1]);
    // step g's B is in its slot (every thread's split, fenced); step g - 1's
    // products are done (B slot (P + 1) % 2 free) and its rows read (raw slot
    // (P + 3) % 4 free); step g + 1's rows have landed
    __syncthreads();
    issue(g0 + P + kRaw - 1, (P + kRaw - 1) % kRaw);
    const uint32_t b_hi = smem_u32(bslot(P % kRStages)), b_lo = b_hi + kROp;
    wgmma_fence();
    step_products<NT>(acc, af, b_hi, b_lo, P == 0);
    // step g + 1's B while step g's products run
    const float* rn = rows((P + 1) % kRaw);
    btot += split_b(rn + kRK * kRawA, rn + kRK * kRawA + kRK * kRM, bslot((P + 1) % kRStages),
                    tw, half);
    fence_proxy_async();
    if constexpr (P == kFold - 1) {   // the group's sums into tot
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) tot[i] += acc[i];
    }
  };
  for (int g = 0; g < kRaw - 1; ++g) issue(g, g);
  cp_async_wait<kRaw - 2>();   // step 0's rows
  __syncthreads();
  btot += split_b(rows(0) + kRK * kRawA, rows(0) + kRK * kRawA + kRK * kRM, bslot(0), tw, half);
  fence_proxy_async();
  for (int g0 = 0; g0 < steps; g0 += kFold) {
    step(std::integral_constant<int, 0>(), g0);
    step(std::integral_constant<int, 1>(), g0);
    step(std::integral_constant<int, 2>(), g0);
    step(std::integral_constant<int, 3>(), g0);
  }
  static_assert(kFold == 4, "the group above is written out for kFold = 4");
  cp_async_wait<0>();   // the zero rows copied past the last group
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

// reduce_tile with its copies chosen: 16-byte where A's, C's and dd's rows
// allow them (their widths multiples of 4, their rows 16-byte aligned)
template <int NT>
__device__ __forceinline__ void reduce_tile_any(unsigned char* ring, float* raw, float* bsum,
                                                int steps, int nrows, const float* A, int in,
                                                int acols, const float* C, int out, int ccols,
                                                const float* dd, bool scale, bool bias,
                                                float* dst, float* bias_dst, int i0, int o0) {
  const bool vec = in % 4 == 0 && out % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(C) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dd) % 16 == 0;
  if (vec)
    reduce_tile<NT, true>(ring, raw, bsum, steps, nrows, A, in, acols, C, out, ccols, dd, scale,
                          bias, dst, bias_dst, i0, o0);
  else
    reduce_tile<NT, false>(ring, raw, bsum, steps, nrows, A, in, acols, C, out, ccols, dd, scale,
                           bias, dst, bias_dst, i0, o0);
}

__global__ void __launch_bounds__(kRThreads, 1) train_reduce_kernel(const ReduceArgs a) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned as align1024 would, but as an offset into smem_raw, so that
  // the compiler keeps the shared window (LDS / STS, 32-bit addresses)
  unsigned char* ring = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
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
    reduce_tile_any<128>(ring, raw, bsum, steps, nrows, A, in, acols, C, out, ccols,
                         a.dd[seg] + r_begin, seg == 1, i0 == 0, dst, bias_dst, i0, o0);
  else if (nt == 64)
    reduce_tile_any<64>(ring, raw, bsum, steps, nrows, A, in, acols, C, out, ccols,
                        a.dd[seg] + r_begin, seg == 1, i0 == 0, dst, bias_dst, i0, o0);
  else
    reduce_tile_any<8>(ring, raw, bsum, steps, nrows, A, in, acols, C, out, ccols,
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

// quat (B, J, 4) fp32, contiguous and 16-byte aligned; wp the packed weights
// (fused_encoder.pack_encoder) -> out (B, J * F) fp32
int posendf_encoder(const float* quat, int B, const float* wp, const int* parents, int J, int F,
                    int act, float beta, float* out, void* stream) {
  if (J < 1 || J > kMaxJ || F < 1 || F > kMaxF) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  switch (F) {
    case 1: return dispatch_encoder<1>(quat, B, wp, parents, J, act, beta, out, stream);
    case 2: return dispatch_encoder<2>(quat, B, wp, parents, J, act, beta, out, stream);
    case 3: return dispatch_encoder<3>(quat, B, wp, parents, J, act, beta, out, stream);
    case 4: return dispatch_encoder<4>(quat, B, wp, parents, J, act, beta, out, stream);
    case 5: return dispatch_encoder<5>(quat, B, wp, parents, J, act, beta, out, stream);
    case 6: return dispatch_encoder<6>(quat, B, wp, parents, J, act, beta, out, stream);
    case 7: return dispatch_encoder<7>(quat, B, wp, parents, J, act, beta, out, stream);
    default: return dispatch_encoder<8>(quat, B, wp, parents, J, act, beta, out, stream);
  }
}

// Both branches of the training gradient in one launch: ceil(B / 64) CTAs a
// branch (posendf_train_tile_ctas), the noisy ones first. slabs, vec, prog,
// nfwd, nbwd: fused_model.pack_tc; meta (L, kMeta): each layer's (in, out).
// A branch's arguments: pose, B, gt (null on the manifold branch), dd_coef,
// a_scr, c_scr, dd_out, enc_slot, loss_slot and scratch
// (posendf_train_tile_scratch_floats floats).
int posendf_train_tile(const float* enc, const int* parents, int J, int F, const void* slabs,
                       const float* vec, const int* prog, int nfwd, int nbwd, const int* meta,
                       int L, int act, int l2, float eik_coef,
                       const float* pose_n, int B_n, const float* gt_n, float dd_coef_n,
                       float* a_n, float* c_n, float* dd_n, float* enc_slot_n,
                       float* loss_slot_n, float* scratch_n,
                       const float* pose_m, int B_m, const float* gt_m, float dd_coef_m,
                       float* a_m, float* c_m, float* dd_m, float* enc_slot_m,
                       float* loss_slot_m, float* scratch_m, void* stream) {
  if (J < 1 || J > kMaxJ || F < 1 || F > kMaxF || L < 2 || L > kMaxL || B_n < 0 || B_m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B_n + B_m == 0) return 0;
  const float* pose[2] = {pose_n, pose_m};
  const float* gt[2] = {gt_n, gt_m};
  const int B[2] = {B_n, B_m};
  const float dd_coef[2] = {dd_coef_n, dd_coef_m};
  float* out[2][6] = {{a_n, c_n, dd_n, enc_slot_n, loss_slot_n, scratch_n},
                      {a_m, c_m, dd_m, enc_slot_m, loss_slot_m, scratch_m}};
  tile::Launch la{};
  for (int b = 0; b < 2; ++b) {
    tile::Args& a = la.br[b];
    a.pose = pose[b];
    a.B = B[b];
    a.gt = gt[b];
    a.enc = enc;
    a.parents = parents;
    a.J = J;
    a.F = F;
    a.slabs = static_cast<const unsigned char*>(slabs);
    a.vec = vec;
    a.prog = prog;
    a.nfwd = nfwd;
    a.nbwd = nbwd;
    a.meta = meta;
    a.L = L;
    a.eikonal = b == 0;
    a.l2 = b == 0 ? l2 : 0;
    a.dd_coef = dd_coef[b];
    a.eik_coef = b == 0 ? eik_coef : 0.f;
    a.a_scr = out[b][0];
    a.c_scr = out[b][1];
    a.dd_out = out[b][2];
    a.enc_slot = out[b][3];
    a.loss_slot = out[b][4];
    a.scratch = out[b][5];
  }
  la.ctas0 = (B_n + tile::kRows - 1) / tile::kRows;
  const dim3 ctas(la.ctas0 + (B_m + tile::kRows - 1) / tile::kRows);
  switch (act) {   // one kernel an activation (act'' = 0 for both)
    case kLRelu:
      return launch_wgmma(tile::train_tile_kernel<kLRelu>, ctas, tile::kTileThreads,
                          tile::kTileSmem, stream, la);
    case kRelu:
      return launch_wgmma(tile::train_tile_kernel<kRelu>, ctas, tile::kTileThreads,
                          tile::kTileSmem, stream, la);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs (and encoder / loss slots) of a branch of B rows.
int posendf_train_tile_ctas(int B) { return (B + tile::kRows - 1) / tile::kRows; }

// Which walk the tile kernel's encoder phases take for feature width F: 1
// the compiled one (kWalkF), 0 the run-time one, -1 where the tile takes no
// such width.
int posendf_train_tile_walk(int F) {
  return F < 1 || F > kMaxF ? -1 : F == tile::kWalkF ? 1 : 0;
}

// Floats of the tile kernel's scratch for a branch of B rows (zsum: fused_model.pack_tc's).
long long posendf_train_tile_scratch_floats(int B, int J, int F, int zsum) {
  return static_cast<long long>(posendf_train_tile_ctas(B)) * tile::scratch_floats(J, F, zsum);
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
