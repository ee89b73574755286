// Hand-written Hopper kernels for the PoseNDF distance field (sm_90a).
//
// Three entry points share one kernel, `field_kernel<Act, Bf16>` (the mode
// is a launch argument; one instance an activation, so that an epilogue is a
// few instructions, which made the kernels faster on an H100 than one body
// choosing the activation at run time; and one a route, 3xTF32 or bf16):
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
// take raw poses. The value-and-grad kernel also folds in the
// normalization's VJP, which the TPU kernel left to XLA outside the call.
//
// What bounds them on an H100 SXM: the DFNet's 1.36M multiply-adds a pose a
// pass. At fp32 accuracy on the tensor cores each product is three TF32
// passes (3xTF32): 8.2 MFLOP a pose a pass at 494.7 TFLOP/s, 2.16 ms for
// the forward of 131,072 poses and 0.33 ms for a value-and-grad or
// projection step of 10,000. The design:
//  * A CTA owns 64 poses (one wgmma M) and two consumer warpgroups. The
//    weights stream through a ring of two 32 KB slabs in shared memory,
//    copied by cp.async.bulk under mbarriers; thread 0 refills a slot once
//    both warpgroups have passed a named barrier after its products, with
//    no divergent branch near the wgmma (ptxas serializes them otherwise).
//    Every CTA reads the whole network from L2 (11 MB a pass, pre-split,
//    see below). 256 threads leave 255 registers a thread (a separate
//    producer warp would leave 168: registers go to warps in fours; the
//    bf16 route below, whose A fragments take a quarter of the registers,
//    has one and gives its registers to the consumers with setmaxnreg).
//  * Products: D = A . B with A the activations (64, K) and B the weights.
//    A comes from registers (TF32 has no transposed shared-memory operand,
//    and the split of A would double its shared memory): each thread loads
//    its fragment from the fp32 activations in shared memory and splits it,
//    a = hi + lo, hi = tf32(a), lo = tf32(a - hi) (cvt.rna, hopper.cuh's
//    tf32_round). B is split once per field by the wrapper
//    (fused_model.pack_tc): a slab is 128 output columns x 32 of K, its
//    hi half and its lo half in the K-major 128-byte swizzle; warpgroup w
//    takes columns 64w..64w+63. Each k8 step issues lo.hi' + hi.lo' +
//    hi.hi' (m64n64k8 tf32, fp32 accumulators): ~21 significant bits a
//    product. A K-block's A fragments serve every slab of that K-block.
//  * The sums. The tensor cores' fp32 accumulation does not round to
//    nearest (it behaves as rounding toward zero: tests/test_torch_field_tc.py
//    models it), so a sum that runs over all of K in one accumulator, up to
//    384 accumulations, put g past its bar of 1e-5. So each slab's 12
//    products go to a fresh accumulator that is then added in fp32 (IEEE)
//    to the layer's sums, which stay in registers (at most 4 x 32 a thread,
//    and 16 more in a chain, below).
//  * The fragment layouts meet without a shuffle: within each 8-group of K
//    the packed weights hold, at K position p, feature 2p (p < 4) or
//    2(p - 4) + 1, so a thread's A registers (positions t%4, t%4 + 4) are
//    the adjacent features 2(t%4), 2(t%4) + 1 that its accumulator
//    fragment holds: one 8-byte load per row and k8 step, one 8-byte
//    store per row and 8 columns in the epilogue.
//  * Activations live in shared memory in fp32 (64 x 512 at most, 128 KB,
//    each row's 8-column groups XOR-swizzled by row % 4 so that the 8-byte
//    fragment loads and stores meet no bank conflict). A layer's output
//    stays in the accumulators (at most 4 x 32 registers a thread, 512
//    columns) until both warpgroups have read the input, then overwrites
//    it. A wider layer (the 1024-wide one) is chained with the next: its
//    output is made 64 columns at a time (m64n32, slabs of 64 columns x
//    twice a slab's K) into a 16 KB chunk buffer and at once taken as 64 of the next
//    layer's K, so it never exists whole.
//  * Epilogues in the accumulators' registers: bias, activation, and for
//    the backward the derivative state (below), kept in a global scratch
//    buffer in the fragments' own order. The backward runs the transposed
//    products with act'(z) from that scratch; the encoder's goes there too.
//  * On the CUDA cores: the input normalization, the encoder walk and its
//    reverse (four neighbouring lanes a pose trading hidden units by
//    shuffles, float4 weight rows staged in the ring's space, no CTA
//    barrier a joint: see "the encoder walks" below), the 64 -> 1 output layer (four
//    threads a pose and a sum), the normalization VJP and the projection
//    step (four threads a pose). The biases and the output layer's weights
//    are copied to shared memory once a CTA (where they fit, kVecSmem), so
//    no epilogue waits on L2, which the weight ring keeps busy.
//  * The bf16 route (Bf16 = true: a field whose compute_dtype is bfloat16,
//    the TPU kernels' compute_dtype="bfloat16") computes what the TPU
//    kernels compute in that mode: every product, encoder, DFNet and output
//    layer, forward and backward, on operands rounded to bf16 to nearest
//    even (cvt.rn.bf16x2.f32, JAX's astype), summed in fp32; biases,
//    activations, derivative state, the normalization and its VJP and the
//    projection update in fp32. Bound: the DFNet's products in one bf16
//    pass at 989 TFLOP/s, 0.36 ms for the 131,072-pose forward, 0.055 ms
//    for a value-and-grad or projection step of 10,000. One bf16 wgmma k16
//    step does what 3xTF32 takes three k8 passes of one TF32 step each for,
//    so what bounds this route is taking the weights in: its design is
//    about the ring.
//     - Slabs of weights only (fused_model.pack_bf16): 16 KB, 128 output
//       columns x 64 of K, one 128-byte line of bf16 a column in the
//       128-byte swizzle (a chain's first product: 64 columns x 128 of K,
//       two tiles of 64 lines), so a pass takes 168 slabs of the trained
//       field where the 3xTF32 route takes 336 of 32 KB.
//     - A ring of four 16 KB stages (64 KB, the 3xTF32 route's two slots)
//       kept full by a producer warpgroup (setmaxnreg: 24 registers, the
//       two consumer warpgroups 240): its thread 0 copies the slabs in
//       reading order, waiting only for a slot's empty barrier, so copies
//       stay in flight across layers and through the epilogues. Each
//       consumer warpgroup frees a slot with one arrival on that barrier
//       (a predicated asm block: no branch near the wgmma), so the two
//       warpgroups do not move in lockstep between layers' barriers.
//     - Products: bf16 wgmma m64n64k16 (m64n32k16 in a chain's first
//       product), A from registers, rounded from the fp32 activations as
//       they are loaded (the activations stay fp32 in shared memory: they
//       are rounded at the next product anyway). A thread's bf16 A
//       registers hold K columns 2(t%4), +1, +8, +9 of a k16 step, the
//       columns its accumulator holds in two adjacent 8-column groups, so K
//       needs no permutation. Each slab's four k16 steps (64 of K) go to a
//       fresh accumulator added to the layer's sums in fp32.
//    The encoder walks, the output layer and the backward's start round
//    their operands on the CUDA cores; the weights come rounded (the
//    encoder's buffer and the output layer's w, by the wrapper).
//  * Derivative state, in both routes, as the TPU kernels keep it
//    (fused_grad.py's _act_store): for lrelu and relu, whose act' takes two
//    values, one bit a unit and pose (act_bit, act_grad_bit in common.cuh:
//    act'(z) exactly, z == 0 included): the DFNet's 64 bits a unit in a
//    global scratch per CTA (posendf_field_scratch_floats; 22 KB a CTA of
//    the trained field) in the fragments' own order, a thread storing one
//    word of its 32 (16 in a chain's chunk) bits a column group and the
//    backward loading it before the layer's products; the encoder's in
//    shared memory, a byte a unit and warp (8 poses). For softplus the fp32
//    pre-activations, all in the global scratch (806 KB a CTA).
//  * The wrapper turns the layer list into a program (fused_model.
//    tc_schedule): per pass a list of steps, a layer or a chain of two,
//    and the slabs in the order the steps read them, so the ring's filler
//    only counts slabs. Widths are zero-padded to 128, 256, 512 (or a
//    multiple of 128 above, chained): a padded column's weights and bias
//    are zero, so it adds nothing downstream. The ragged last tile
//    computes zero poses and writes nothing for them.
//
// Each launcher returns cudaGetLastError(); the Python wrapper raises on a
// nonzero value. No launcher synchronizes or allocates.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace posendf;
using namespace hopper;

enum Mode { kForward = 0, kValueAndGrad = 1, kProjectStep = 2 };

constexpr int kRows = 64;                        // poses a CTA: one wgmma M
constexpr int kConsumers = 256;                  // two consumer warpgroups
constexpr int kSlabN = 128;                      // output columns a slab: 64 a warpgroup
constexpr int kHalfBytes = 16384;                // 3xTF32: a slab's hi (or lo) half, 128 x 32 tf32
constexpr int kXMax = 512;                       // widest activation kept whole
constexpr int kChunk = 64;                       // a chained layer's output, a chunk at a time
constexpr int kHead = 8, kStep = 8;              // ints of the program's header and of a step
constexpr uint32_t kBar = 1;                     // named barrier of the consumers

// The two routes' slabs and rings.
template <bool kBf16>
struct Route;
template <>
struct Route<false> {                             // 3xTF32
  static constexpr int kSlabK = 32;               // K a slab: a 128-byte line of tf32
  static constexpr int kSlot = 2 * kHalfBytes;    // hi | lo: 32 KB
  static constexpr int kStages = 2;
  static constexpr int kThreads = kConsumers;     // thread 0 also fills the ring
};
template <>
struct Route<true> {                              // bf16
  static constexpr int kSlabK = 64;               // K a slab: a 128-byte line of bf16
  static constexpr int kSlot = kSlabN * kSlabK * 2;   // 16 KB
  static constexpr int kStages = 4;
  static constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
};

constexpr int kVecSmem = 3072;                  // floats of vec kept in shared memory, if it fits
constexpr int kEzSmem = 8 * kMaxJ * (kMaxE + kMaxF);   // bytes: the encoder's act' bits (lrelu, relu)

// ring | activations (64, 512) | chunk (64, 64) | vec | encoder bits |
// parents | barriers; 1024 to align the ring
template <bool kBf16>
constexpr size_t field_smem() {
  return 1024 + static_cast<size_t>(Route<kBf16>::kStages) * Route<kBf16>::kSlot +
         static_cast<size_t>(kRows) * (kXMax + kChunk) * sizeof(float) + kVecSmem * sizeof(float) +
         kEzSmem + kMaxJ * sizeof(int) + 2 * Route<kBf16>::kStages * sizeof(uint64_t);
}

// Bytes of derivative state a unit (a hidden column or an encoder unit) of
// a CTA's 64 poses: one bit a pose (lrelu, relu) or the fp32 pre-activation
// (softplus).
template <int kAct>
constexpr int kZUnit = kAct == kSoftplus ? kRows * 4 : kRows / 8;

struct Args {
  const float* pose;           // (B, J, 4)
  int B;
  const float* enc;            // w1 (J,E,E) | b1 (J,E) | w2 (J,E,F) | b2 (J,F), E = 4 + F
  const int* parents;          // (J,), -1 = root
  int J, F;
  const unsigned char* slabs;  // the forward's slabs, then the backward's (a ring slot each)
  const float* vec;            // padded biases | output layer's w (padded) | its b
  const int* prog;             // header (kHead), the forward's steps, the backward's (kStep each)
  int nfwd, nbwd;              // slabs of each pass
  int mode;                    // kForward, kValueAndGrad or kProjectStep
  int act;
  float beta;
  int bf16;                    // the route: 0 3xTF32, 1 bf16
  float* d_out;                // (B,)
  float* g_out;                // (B, J, 4) value-and-grad
  float* q_out;                // (B, J, 4) projection step
  unsigned char* zscratch;     // per CTA: (zsum + J (E + F)) units of derivative state (kZUnit)
  float step_scale;
  int tangent, renormalize;
};

// A (64, ld) fp32 activation tile in shared memory; column c of row r sits
// at c ^ (8 (r % 4)), which spreads a warp's 8-byte fragment accesses over
// all 32 banks.
struct Buf {
  float* p;
  int ld;
};

__device__ __forceinline__ float* at(const Buf& b, int r, int c) {
  return b.p + r * b.ld + (c ^ ((r & 3) << 3));
}

// An epilogue: forward (bias set) z = acc + b, its derivative state kept at
// z where set, then act(z); backward (bias null) acc times act'(z) read from
// z where set. The result goes to dst, column c - col0.
struct Epi {
  const float* bias;
  unsigned char* z;
  Buf dst;
  int col0;
};

// What a thread carries through the products.
struct Ctx {
  uint64_t* bars;             // full barriers, then empty ones (bf16)
  unsigned char* ring;
  const unsigned char* src;   // the slabs in global memory
  int n;                      // slabs of the launch
  int g;                      // the next slab
  int w, tw;                  // warpgroup, thread in it
  float beta;
};

// x rounded to bf16 (to nearest even, as JAX's astype), as the fp32 of that
// value
__device__ __forceinline__ float rn_bf16(float x) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(0.f), "f"(x));
  return __uint_as_float(r << 16);
}

// lo and hi rounded to bf16 in one register, lo in the low half (the lower K
// column of a bf16 A fragment register)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a product's operand on the CUDA cores: as it is, or rounded to bf16
template <bool kBf16>
__device__ __forceinline__ float op(float x) {
  if constexpr (kBf16) return rn_bf16(x);
  return x;
}

// The rings, with no branch near the wgmma that the compiler could take for
// a divergent path (ptxas then serializes the wgmma): a slab's waiters spin
// inside one asm block; the 3xTF32 route's thread 0 refills a slot, once
// both warpgroups have passed a named barrier after its products, through a
// predicated asm block (full barriers count that one arrival and the slab's
// bytes; no empty barriers); in the bf16 route thread 0 of each consumer
// warpgroup arrives on the slot's empty barrier through a predicated asm
// block and the producer warpgroup refills it.

// wait until the phase of `parity` of barrier `bar` has completed; a wait
// of more than 2^35 clocks (about 20 s) is a lost arrival and traps
__device__ __forceinline__ void spin_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 34359738368;\n"
      "@p trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// slab g has landed; returns its slot
template <bool kBf16>
__device__ __forceinline__ int wait_slab(const Ctx& cx, int g) {
  constexpr int S = Route<kBf16>::kStages;
  const int s = g % S;
  spin_wait(smem_u32(cx.bars + s), static_cast<uint32_t>(g / S) & 1);
  return s;
}

// 3xTF32: thread 0 copies slab g into its slot (every thread runs the asm;
// its predicate holds on thread 0 alone, and only while g < n)
__device__ __forceinline__ void fill(const Ctx& cx, int g) {
  constexpr int S = Route<false>::kStages, kSlot = Route<false>::kSlot;
  const int s = g % S;
  const uint32_t go = threadIdx.x == 0 && g < cx.n;
  const uint32_t full = smem_u32(cx.bars + s);
  const unsigned char* src = cx.src + static_cast<size_t>(g < cx.n ? g : 0) * kSlot;
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %0, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%3], [%4], %2, [%1];\n"
      "}\n" ::"r"(go),
      "r"(full), "r"(kSlot), "r"(smem_u32(cx.ring + s * kSlot)), "l"(src)
      : "memory");
}

// this warpgroup is done with slab g's slot. 3xTF32: once both are, refill
// it with slab g + 2; bf16: thread 0 of the warpgroup arrives on its empty
// barrier (two arrivals free it for the producer).
template <bool kBf16>
__device__ __forceinline__ void release_slab(const Ctx& cx, int g) {
  constexpr int S = Route<kBf16>::kStages;
  if constexpr (kBf16) {
    const uint32_t go = cx.tw == 0;
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.u32 p, %0, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%1];\n"
        "}\n" ::"r"(go),
        "r"(smem_u32(cx.bars + S + g % S))
        : "memory");
  } else {
    named_bar_sync(kBar, kConsumers);
    fill(cx, g + S);
  }
}

template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The A fragment of one k8 step, split: register j holds row r + 8 (j % 2)
// at K position t%4 + 4 (j / 2), i.e. feature c (j < 2) or c + 1, c = the
// 8-group's 2 (t % 4).
__device__ __forceinline__ void load_a(const Buf& b, int r, int c, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float2 u = *reinterpret_cast<const float2*>(at(b, r, c));
  const float2 v = *reinterpret_cast<const float2*>(at(b, r + 8, c));
  const float x[4] = {u.x, v.x, u.y, v.y};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float h = tf32_round(x[j]);
    hi[j] = __float_as_uint(h);
    lo[j] = __float_as_uint(tf32_round(x[j] - h));
  }
}

// The bf16 A fragment of one k16 step at K column k (a multiple of 16) plus
// 2 (t % 4): register j holds row r + 8 (j % 2), columns k + 8 (j / 2) and
// the next one, rounded to bf16 from the fp32 activations.
__device__ __forceinline__ void load_a_bf16(const Buf& b, int r, int k, uint32_t (&a)[4]) {
  const float2 u0 = *reinterpret_cast<const float2*>(at(b, r, k));
  const float2 v0 = *reinterpret_cast<const float2*>(at(b, r + 8, k));
  const float2 u1 = *reinterpret_cast<const float2*>(at(b, r, k + 8));
  const float2 v1 = *reinterpret_cast<const float2*>(at(b, r + 8, k + 8));
  a[0] = pack_bf16x2(u0.x, u0.y);
  a[1] = pack_bf16x2(v0.x, v0.y);
  a[2] = pack_bf16x2(u1.x, u1.y);
  a[3] = pack_bf16x2(v1.x, v1.y);
}

// The A fragments of a slab's K (Route::kSlabK), from column k (a multiple
// of 8 plus 2 (t % 4)): four k8 steps split into TF32 hi | lo (3xTF32, 32
// of K), or four k16 steps rounded to bf16 (hi only, 64 of K).
template <bool kBf16>
struct AFrag {
  static constexpr int kSteps = 4;
  uint32_t hi[kSteps][4], lo[kBf16 ? 1 : kSteps][4];

  __device__ __forceinline__ void load(const Buf& b, int r, int k) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if constexpr (kBf16)
        load_a_bf16(b, r, k + 16 * kk, hi[kk]);
      else
        load_a(b, r, k + 8 * kk, hi[kk], lo[kk]);
    }
  }

  // acc = A . B over this K, into a fresh accumulator: B's lines at shared
  // address bh (3xTF32: its hi half; its lo half at bl), a step's 32 bytes
  // of each line kk * 32 bytes in.
  template <int N>
  __device__ __forceinline__ void mma(float (&acc)[N / 2], uint32_t bh, uint32_t bl) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if constexpr (kBf16) {
        wgmma_bf16_rs<N>(acc, hi[kk], desc_sw128(bh + kk * 32), kk > 0);
      } else {   // the small terms first
        wgmma_tf32_rs<N>(acc, lo[kk], desc_sw128(bh + kk * 32), kk > 0);
        wgmma_tf32_rs<N>(acc, hi[kk], desc_sw128(bl + kk * 32), 1);
        wgmma_tf32_rs<N>(acc, hi[kk], desc_sw128(bh + kk * 32), 1);
      }
    }
  }

  __device__ __forceinline__ void keep() {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      keep_regs(hi[kk]);
      if constexpr (!kBf16) keep_regs(lo[kk]);
    }
  }
};

// tot[cg] += A . B for nkb K-blocks of A (from `a`) and, per K-block, the
// NG slabs of column groups 0..NG-1, in the ring's order. Each slab's
// products (12 TF32 or 4 bf16 wgmma) sum into a fresh accumulator that is
// then added to tot in fp32 (IEEE adds): the tensor cores' own fp32
// accumulation does not round to nearest, so its error then spans a slab's
// K (32, or 64 in bf16) and not all of it. A 3xTF32 slab is its hi half
// then its lo half, warpgroup w in the lines of columns 64w..64w+63 of each;
// a bf16 slab (fused_model.pack_bf16) is 128 lines, one output column of 64
// bf16 of K each, warpgroup w in lines 64w..64w+63: w's B is 8 KB in, in
// both routes.
template <bool kBf16, int NG>
__device__ __forceinline__ void product(float (&tot)[NG][32], const Buf& a, int nkb, Ctx& cx) {
  constexpr int kSlot = Route<kBf16>::kSlot, kSlabK = Route<kBf16>::kSlabK;
  const int r = 16 * (cx.tw / 32) + (cx.tw % 32) / 4, c = 2 * (cx.tw % 4);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nkb; ++kb) {
    AFrag<kBf16> f;
    f.load(a, r, kSlabK * kb + c);
#pragma unroll
    for (int cg = 0; cg < NG; ++cg) {
      const int g = cx.g++;
      const int s = wait_slab<kBf16>(cx, g);
      const uint32_t bh = smem_u32(cx.ring + s * kSlot) + cx.w * 8192;
      wgmma_fence();
      f.template mma<64>(acc, bh, bh + kHalfBytes);
      wgmma_commit();
      wgmma_wait<0>();
      release_slab<kBf16>(cx, g);
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[cg][i] += acc[i];
    }
    f.keep();
  }
}

// h += A . B for the first product of a chain: a slab is 64 columns x 2
// kSlabK of K, warpgroup w taking columns 32w..32w+31 (m64n32); each half
// of its K folds into h as in product. 3xTF32: the hi | lo halves of the
// slab's first 32 of K, then of its second (16 KB each). bf16: two tiles of
// 64 lines (columns) of 64 bf16 of K (8 KB each), the second 64 of K in the
// second. A chunk of 64 columns keeps the chain's sums a thread at 4 x 32
// + 16 registers.
template <bool kBf16>
__device__ __forceinline__ void product_chunk(float (&tot)[1][16], const Buf& a, int nkp, Ctx& cx) {
  constexpr int kSlot = Route<kBf16>::kSlot, kSlabK = Route<kBf16>::kSlabK;
  constexpr int kPart = kBf16 ? 8192 : kHalfBytes;   // bytes of one half of K
  const int r = 16 * (cx.tw / 32) + (cx.tw % 32) / 4, c = 2 * (cx.tw % 4);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int kp = 0; kp < nkp; ++kp) {
    const int g = cx.g++;
    const int s = wait_slab<kBf16>(cx, g);
    const uint32_t slab = smem_u32(cx.ring + s * kSlot);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      AFrag<kBf16> f;
      f.load(a, r, 2 * kSlabK * kp + kSlabK * h + c);
      const uint32_t bh = slab + h * kPart + cx.w * 4096;
      wgmma_fence();
      f.template mma<32>(acc, bh, bh + kHalfBytes / 2);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 16; ++i) tot[0][i] += acc[i];
      f.keep();
    }
    release_slab<kBf16>(cx, g);
  }
}

// The epilogue of column groups cg0..cg0+NG-1, each 16 NJ columns wide (8
// NJ a warpgroup: NJ = 8 after m64n64 products, 4 after m64n32). Register
// 4j + i of group cg is row r + 8 (i / 2), column 16 NJ cg + 8 NJ w + 8 j +
// 2 (t % 4) + i % 2. Its derivative state: softplus, the pre-activations,
// float4 (((cg * 2 + w) NJ + j) 128 + t) of z; lrelu and relu, bit 4j + i
// of word ((cg * 2 + w) 128 + t) of z (32-bit words for NJ = 8, 16-bit for
// 4). A group's loads (bias or z) are issued before its stores, which the
// compiler could not move them past.
template <int kAct, int NG, int NJ>
__device__ __forceinline__ void epilogue(const float (&acc)[NG][4 * NJ], int cg0, const Epi& e,
                                         const Ctx& cx, const uint32_t (&zbits)[NG]) {
  constexpr bool kSel = kAct != kSoftplus;
  using Word = std::conditional_t<NJ == 8, uint32_t, uint16_t>;
  static_assert(NJ == 8 || NJ == 4, "epilogue widths: 8 or 4 columns a j");
  const int r = 16 * (cx.tw / 32) + (cx.tw % 32) / 4;
#pragma unroll
  for (int cg = 0; cg < NG; ++cg) {
    const int blk = (cg0 + cg) * 2 + cx.w;
    const int c0 = blk * 8 * NJ + 2 * (cx.tw % 4);
    float4* zp = !kSel && e.z != nullptr ? reinterpret_cast<float4*>(e.z) + blk * NJ * 128 + cx.tw
                                         : nullptr;
    Word* zw = kSel && e.z != nullptr ? reinterpret_cast<Word*>(e.z) + blk * 128 + cx.tw : nullptr;
    float4 in[NJ];   // the bias pair (forward) or z (backward, softplus) of each j
    // lrelu, relu: act'(z) a bit (backward: loaded by the caller before the
    // products, off this path), or the forward's bits
    uint32_t bits = e.bias == nullptr ? zbits[cg] : 0u;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (e.bias != nullptr) {   // vec, in shared memory where it fits
        const float2 b = *reinterpret_cast<const float2*>(e.bias + c0 + 8 * j);
        in[j] = make_float4(b.x, b.y, b.x, b.y);
      } else if (zp != nullptr) {
        in[j] = zp[j * 128];
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float v[4] = {acc[cg][4 * j], acc[cg][4 * j + 1], acc[cg][4 * j + 2], acc[cg][4 * j + 3]};
      if (e.bias != nullptr) {
        v[0] += in[j].x;
        v[1] += in[j].y;
        v[2] += in[j].z;
        v[3] += in[j].w;
        if (zp != nullptr) zp[j * 128] = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kSel)
            if (zw != nullptr) bits |= act_bit(kAct, v[i]) << (4 * j + i);
          v[i] = act_fwd(kAct, cx.beta, v[i]);
        }
      } else if (zp != nullptr) {
        v[0] *= act_grad(kAct, cx.beta, in[j].x);
        v[1] *= act_grad(kAct, cx.beta, in[j].y);
        v[2] *= act_grad(kAct, cx.beta, in[j].z);
        v[3] *= act_grad(kAct, cx.beta, in[j].w);
      } else if (zw != nullptr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] *= act_grad_bit(kAct, (bits >> (4 * j + i)) & 1u);
      }
      const int c = c0 + 8 * j - e.col0;
      *reinterpret_cast<float2*>(at(e.dst, r, c)) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(at(e.dst, r + 8, c)) = make_float2(v[2], v[3]);
    }
    if (e.bias != nullptr && zw != nullptr) *zw = static_cast<Word>(bits);
  }
}

// The backward's act' bits (lrelu, relu) of column groups cg0..cg0+NG-1
// of an epilogue (NJ = 8: 32-bit words, 4: 16-bit), loaded before the
// products so that their latency stays off the epilogue's path; zeros
// elsewhere.
template <int kAct, int NG, int NJ>
__device__ __forceinline__ void load_bits(uint32_t (&zbits)[NG], int cg0, const Epi& e,
                                          const Ctx& cx) {
#pragma unroll
  for (int cg = 0; cg < NG; ++cg) {
    zbits[cg] = 0u;
    if (kAct != kSoftplus && e.bias == nullptr && e.z != nullptr) {
      const int i = ((cg0 + cg) * 2 + cx.w) * 128 + cx.tw;
      zbits[cg] = NJ == 8 ? reinterpret_cast<const uint32_t*>(e.z)[i]
                          : reinterpret_cast<const uint16_t*>(e.z)[i];
    }
  }
}

// One layer, K -> N = 128 NG, in place in x.
template <int kAct, bool kBf16, int NG>
__device__ __forceinline__ void layer(const Buf& x, int K, const Epi& e, Ctx& cx) {
  float tot[NG][32];
#pragma unroll
  for (int cg = 0; cg < NG; ++cg)
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[cg][i] = 0.f;
  uint32_t zbits[NG];
  load_bits<kAct, NG, 8>(zbits, 0, e, cx);
  product<kBf16, NG>(tot, x, K / Route<kBf16>::kSlabK, cx);
  named_bar_sync(kBar, kConsumers);   // both warpgroups have read x
  epilogue<kAct, NG, 8>(tot, 0, e, cx, zbits);
  named_bar_sync(kBar, kConsumers);   // x holds the output
}

// Two layers, K -> N -> 512, in place in x: the N columns a chunk of 64 at a
// time through cb, each chunk at once 64 of the second product's K. The
// second product's 4 x 32 sums a thread stay in registers through the
// chunks.
template <int kAct, bool kBf16>
__device__ __forceinline__ void chain(const Buf& x, const Buf& cb, int K, int N, Epi e1,
                                      const Epi& e2, Ctx& cx) {
  constexpr int NG2 = kXMax / kSlabN, kSlabK = Route<kBf16>::kSlabK;
  float y[NG2][32];
#pragma unroll
  for (int cg = 0; cg < NG2; ++cg)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[cg][i] = 0.f;
  uint32_t z2[NG2];
  load_bits<kAct, NG2, 8>(z2, 0, e2, cx);
  for (int c = 0; c < N / kChunk; ++c) {
    float h[1][16];
#pragma unroll
    for (int i = 0; i < 16; ++i) h[0][i] = 0.f;
    uint32_t z1[1];
    load_bits<kAct, 1, 4>(z1, c, e1, cx);
    product_chunk<kBf16>(h, x, K / (2 * kSlabK), cx);
    named_bar_sync(kBar, kConsumers);   // both warpgroups have read the last chunk
    e1.col0 = c * kChunk;
    epilogue<kAct, 1, 4>(h, c, e1, cx, z1);
    named_bar_sync(kBar, kConsumers);   // cb holds chunk c
    product<kBf16, NG2>(y, cb, kChunk / kSlabK, cx);
  }
  named_bar_sync(kBar, kConsumers);     // both warpgroups have read x
  epilogue<kAct, NG2, 8>(y, 0, e2, cx, z2);
  named_bar_sync(kBar, kConsumers);
}

// One step of the program (fused_model.tc_schedule): [chain, K, N, N2,
// bias1, z1, bias2, z2]; z in units (columns) of derivative state from zb.
template <int kAct, bool kBf16>
__device__ __forceinline__ void run_step(const int* st, const Buf& x, const Buf& cb,
                                         const float* vec, unsigned char* zb, Ctx& cx) {
  int s[kStep];
#pragma unroll
  for (int i = 0; i < kStep; ++i) s[i] = __ldg(st + i);
  const Epi e1{s[4] >= 0 ? vec + s[4] : nullptr,
               zb != nullptr && s[5] >= 0 ? zb + static_cast<size_t>(kZUnit<kAct>) * s[5] : nullptr,
               s[0] ? cb : x, 0};
  if (s[0]) {
    const Epi e2{s[6] >= 0 ? vec + s[6] : nullptr,
                 zb != nullptr && s[7] >= 0 ? zb + static_cast<size_t>(kZUnit<kAct>) * s[7] : nullptr,
                 x, 0};
    chain<kAct, kBf16>(x, cb, s[1], s[2], e1, e2, cx);
  } else {
    switch (s[2] / kSlabN) {
      case 1: layer<kAct, kBf16, 1>(x, s[1], e1, cx); break;
      case 2: layer<kAct, kBf16, 2>(x, s[1], e1, cx); break;
      default: layer<kAct, kBf16, 4>(x, s[1], e1, cx); break;
    }
  }
}

// ---- the encoder walks ----
// Four threads a pose, its four neighbouring lanes of a warp (pose t / 4,
// part r = t % 4; a warp holds 8 poses): part r sums the hidden units (and
// then the features, and in the reverse walk the rows) r, r + 4, ..., one
// FMA a term in index order from the packed rows of fused_model.pack_walk
// (float4 loads, each feeding four FMAs), and the pose's four parts trade
// hidden units by shuffles, so a joint needs no CTA barrier: its features
// (or its parent's code gradient) stay in the pose's row of x, read by the
// same warp after a __syncwarp. A walk first copies its rows (and the
// forward walk the CTA's poses, where they fit) into the ring's space, which
// the walks have to themselves: the forward walk runs before the ring's
// first copy (the bf16 producer waits on kBarRing), the reverse walk after
// its last slab. So no joint waits on L2. kF: the feature width at compile
// time (6, the SMPL fields'), or 0 for any width at run time.

// the packed walk rows (fused_model.pack_walk): per joint E hidden rows and
// F feature rows of E weights, the bias and zeros to R = 4 ceil((E + 1) / 4)
// floats; then W2's rows (J, E, 4 ceil(F / 4)) and W1's (J, E, 4 ceil(E / 4)).
// nf, nb: the floats of each walk's rows.
template <int kF>
struct Walk {
  int F, E, R, RF, RE, nf, nb;
  __device__ __forceinline__ explicit Walk(const Args& a) {
    F = kF > 0 ? kF : a.F;
    E = 4 + F;
    R = round4(E + 1);
    RF = round4(F);
    RE = round4(E);
    nf = a.J * (E + F) * R;
    nb = a.J * E * (RF + RE);
  }
};

constexpr int kRingFloats = 16384;   // the ring's space in floats (64 KB in both routes)
constexpr uint32_t kBarRing = 2;     // the consumers' arrival: the forward walk is done with the ring

// copy n floats from global `src` to shared `dst` in float4s (every
// consumer thread)
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kConsumers)
    reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
}

// z = sum_{i < n} in[i] row[i] in order from 0 (one FMA a term), then, with
// `bias`, + row[n]; the row (in shared memory) read as float4
template <int N>
__device__ __forceinline__ float walk_dot(const float (&in)[N], const float* row, int n, bool bias) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float z = 0.f;
#pragma unroll
  for (int c = 0; c < (N + 4) / 4; ++c) {
    if (4 * c < n + (bias ? 1 : 0)) {   // a float4 the row holds
      const float4 v = r4[c];
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        if (i < N && i < n) z = fmaf(in[i], f[e], z);
        else if (bias && i == n) z += f[e];
      }
    }
  }
  return z;
}

// the value of unit u from the pose's part u % 4 (each part passing its slot
// u / 4); every lane of the warp calls this
template <int kSlots>
__device__ __forceinline__ float from_part(const float (&mine)[kSlots], int u) {
  return __shfl_sync(0xffffffffu, mine[u / 4], (threadIdx.x & 28) | (u & 3));
}

// The encoder's derivative state, unit u of J (E + F) (joint j's hidden
// units, then its features) of pose p: softplus, the pre-activation at float
// u 64 + p of ez; lrelu and relu, bit p % 8 of byte 8u + p / 8 (a warp's 8
// poses).
template <int kAct>
__device__ __forceinline__ float enc_grad(const unsigned char* ez, int u, int p, float beta) {
  if constexpr (kAct == kSoftplus)
    return act_grad(kAct, beta, reinterpret_cast<const float*>(ez)[u * kRows + p]);
  return act_grad_bit(kAct, (ez[8 * u + p / 8] >> (p % 8)) & 1u);
}

// keep the derivative state of units u0 + 4 i + r (r the part, i < kSlots,
// those below n) of the pose, pre-activations z[i]: softplus as they are;
// lrelu and relu a ballot of the warp a slot, its lanes 0-3 each storing
// the byte of one unit. Every lane of the warp calls this.
template <int kAct, int kSlots>
__device__ __forceinline__ void enc_keep(unsigned char* ez, int u0, int n, const float (&z)[kSlots]) {
  const int t = threadIdx.x, p = t / 4, r = t % 4, lane = t % 32;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int k = r + 4 * i;
    if constexpr (kAct == kSoftplus) {
      if (k < n) reinterpret_cast<float*>(ez)[(u0 + k) * kRows + p] = z[i];
    } else {
      const uint32_t bits = __ballot_sync(0xffffffffu, k < n && act_bit(kAct, z[i]));
      uint32_t b = 0;   // lane l < 4: bit 4 pp + l of each pose pp of the warp
#pragma unroll
      for (int pp = 0; pp < 8; ++pp) b |= ((bits >> (4 * pp + lane)) & 1u) << pp;
      if (lane < 4 && 4 * i + lane < n) ez[8 * (u0 + 4 * i + lane) + t / 32] = static_cast<unsigned char>(b);
    }
  }
}

// Input normalization and encoder walk of the CTA's 64 poses into the code
// x (64, D0), four threads a pose (above), from rows and poses staged in the
// ring's space `wr`. With ez, the derivative state (enc_keep). In bf16 the
// products' operands are rounded: the normalized pose, the parent's feature
// and h (the weights come rounded). Ends with a named barrier: x holds the
// code.
template <int kAct, bool kBf16, int kF>
__device__ __forceinline__ void encode(const Args& a, int row0, const Buf& x, int D0,
                                       unsigned char* ez, const int* parents, float* wr) {
  const int t = threadIdx.x, p = t / 4, r = t % 4;
  const int J = a.J;
  const Walk<kF> w(a);
  const int E = w.E, F = w.F;
  // the rows, then the CTA's poses (p, j) as float4 nf / 4 + p J + j, zeros
  // past B, where they fit
  stage(wr, a.enc, w.nf);
  const bool staged = w.nf + kRows * J * 4 <= kRingFloats;
  float* qs = wr + w.nf;
  if (staged) {
    const float4* src = reinterpret_cast<const float4*>(a.pose) + static_cast<size_t>(row0) * J;
    const int n = min(kRows, a.B - row0) * J;
    for (int i = t; i < kRows * J; i += kConsumers)
      reinterpret_cast<float4*>(qs)[i] = i < n ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
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
    for (int i = t; i < kRows * pad; i += kConsumers) *at(x, i / pad, JF + i % pad) = 0.f;
  named_bar_sync(kBar, kConsumers);   // the rows (and the poses) are staged
  float n[4];
  {
    float s = 0.f;   // component r: the normalization's sum over the joints
    for (int j = 0; j < J; ++j) {
      const float4 q = pose(j);
      const float v = r == 0 ? q.x : r == 1 ? q.y : r == 2 ? q.z : q.w;
      s = fmaf(v, v, s);
    }
    const float nr = sqrtf(fmaxf(s, kEps2));
#pragma unroll
    for (int c = 0; c < 4; ++c) n[c] = __shfl_sync(0xffffffffu, nr, (t & 28) | c);
  }
  for (int j = 0; j < J; ++j) {
    const float4 q = pose(j);
    const int par = parents[j];
    float in[kMaxE];
    in[0] = op<kBf16>(q.x / n[0]);
    in[1] = op<kBf16>(q.y / n[1]);
    in[2] = op<kBf16>(q.z / n[2]);
    in[3] = op<kBf16>(q.w / n[3]);
#pragma unroll
    for (int k = 0; k < kMaxF; ++k)
      in[4 + k] = (k < F && par >= 0) ? op<kBf16>(*at(x, p, par * F + k)) : 0.f;
    const float* rows = wr + j * (E + F) * w.R;
    float z[kMaxE / 4], mine[kMaxE / 4];
#pragma unroll
    for (int i = 0; i < kMaxE / 4; ++i) {
      const int u = r + 4 * i;
      z[i] = u < E ? walk_dot(in, rows + u * w.R, E, true) : 0.f;
      mine[i] = op<kBf16>(act_fwd(kAct, a.beta, z[i]));
    }
    if (ez != nullptr) enc_keep<kAct>(ez, j * (E + F), E, z);
    float h[kMaxE];
#pragma unroll
    for (int u = 0; u < kMaxE; ++u) h[u] = u < E ? from_part(mine, u) : 0.f;
    float zf[kMaxF / 4];
#pragma unroll
    for (int i = 0; i < kMaxF / 4; ++i) {
      const int k = r + 4 * i;
      zf[i] = k < F ? walk_dot(h, rows + (E + k) * w.R, E, true) : 0.f;
      if (k < F) *at(x, p, j * F + k) = act_fwd(kAct, a.beta, zf[i]);
    }
    if (ez != nullptr) enc_keep<kAct>(ez, j * (E + F) + E, F, zf);
    __syncwarp();
  }
  fence_proxy_async();   // the staged rows and poses, before the ring's copies overwrite them
  named_bar_sync(kBar, kConsumers);
}

// The output layer (K -> 1) on the CUDA cores: four threads a pose each sum
// a quarter of K into part (4, 64); then d = out_act(sum + b) to dval (64)
// and to d_out. In bf16 x is rounded (w comes rounded).
template <int kAct, bool kBf16>
__device__ __forceinline__ void output_layer(const Args& a, int row0, const Buf& x, int K,
                                             const float* wl, float bl, float* part, float* dval) {
  const int t = threadIdx.x, p = t % kRows, r = t / kRows, n = K / 4;
  float s = 0.f;
  for (int c = r * n; c < (r + 1) * n; ++c) s = fmaf(op<kBf16>(*at(x, p, c)), wl[c], s);
  part[r * kRows + p] = s;
  named_bar_sync(kBar, kConsumers);
  if (t < kRows) {
    const float sum = (part[p] + part[kRows + p]) + (part[2 * kRows + p] + part[3 * kRows + p]);
    const float d = out_act_fwd(kAct, a.beta, sum + bl);
    dval[p] = d;
    if (row0 + p < a.B) a.d_out[row0 + p] = d;
  }
  named_bar_sync(kBar, kConsumers);
}

// The backward's start: the gradient at the last hidden layer's output,
// out_act'(d) w act'(z), written to x (64, K) in the fragments' layout (in
// bf16 out_act'(d) rounded, the operand of the output layer's product); z
// is that layer's derivative state (epilogue's layout, NJ = 8).
template <int kAct, bool kBf16>
__device__ __forceinline__ void backward_start(const Buf& x, int K, const float* wl,
                                               const unsigned char* z, const float* dval,
                                               const Ctx& cx) {
  const int r = 16 * (cx.tw / 32) + (cx.tw % 32) / 4;
  const float go0 = op<kBf16>(out_act_grad_from_value(kAct, cx.beta, dval[r]));
  const float go1 = op<kBf16>(out_act_grad_from_value(kAct, cx.beta, dval[r + 8]));
  for (int cg = 0; cg < K / kSlabN; ++cg) {
    const int blk = cg * 2 + cx.w;
    uint32_t bits = 0;
    if constexpr (kAct != kSoftplus) bits = reinterpret_cast<const uint32_t*>(z)[blk * 128 + cx.tw];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = blk * 64 + 8 * j + 2 * (cx.tw % 4);
      float4 gz;   // act'(z) of the thread's four values
      if constexpr (kAct == kSoftplus) {
        const float4 zz = reinterpret_cast<const float4*>(z)[(blk * 8 + j) * 128 + cx.tw];
        gz = make_float4(act_grad(kAct, cx.beta, zz.x), act_grad(kAct, cx.beta, zz.y),
                         act_grad(kAct, cx.beta, zz.z), act_grad(kAct, cx.beta, zz.w));
      } else {
        gz = make_float4(act_grad_bit(kAct, (bits >> (4 * j)) & 1u),
                         act_grad_bit(kAct, (bits >> (4 * j + 1)) & 1u),
                         act_grad_bit(kAct, (bits >> (4 * j + 2)) & 1u),
                         act_grad_bit(kAct, (bits >> (4 * j + 3)) & 1u));
      }
      const float2 wv = *reinterpret_cast<const float2*>(wl + c);
      *reinterpret_cast<float2*>(at(x, r, c)) = make_float2(go0 * wv.x * gz.x, go0 * wv.y * gz.y);
      *reinterpret_cast<float2*>(at(x, r + 8, c)) =
          make_float2(go1 * wv.x * gz.z, go1 * wv.y * gz.w);
    }
  }
  named_bar_sync(kBar, kConsumers);
}

// The encoder's reverse walk, j = J-1 .. 0, from the code gradient in x,
// four threads a pose (above): gf = gx_code[j] act'(f_pre) (every part, all
// F); gh = (W2[j] gf) act'(h_pre) (part r: units r + 4i, then traded); then
// W1[j] gh (part r: rows r + 4i): its first 4 rows to gx (J, 4, 64, at the
// ring's start), the rest added into the parent's code gradient. The rows
// staged after gx. act' from ez (enc_grad). In bf16 gf and gh, the
// products' operands, are rounded. Ends with a named barrier: gx is whole.
template <int kAct, bool kBf16, int kF>
__device__ __forceinline__ void encode_backward(const Args& a, const Buf& x,
                                                const unsigned char* ez, float* gx,
                                                const int* parents) {
  const int t = threadIdx.x, p = t / 4, r = t % 4;
  const int J = a.J;
  const Walk<kF> w(a);
  const int E = w.E, F = w.F;
  float* w2 = gx + J * 4 * kRows;    // W2's rows, then W1's
  float* w1 = w2 + J * E * w.RF;
  stage(w2, a.enc + w.nf, w.nb);
  named_bar_sync(kBar, kConsumers);
  for (int j = J - 1; j >= 0; --j) {
    const int par = parents[j];
    const int u0 = j * (E + F);
    float gf[kMaxF];
#pragma unroll
    for (int k = 0; k < kMaxF; ++k)
      gf[k] = k < F ? op<kBf16>(*at(x, p, j * F + k) * enc_grad<kAct>(ez, u0 + E + k, p, a.beta))
                    : 0.f;
    float mine[kMaxE / 4];
#pragma unroll
    for (int i = 0; i < kMaxE / 4; ++i) {
      const int o = r + 4 * i;
      mine[i] = o < E ? op<kBf16>(walk_dot(gf, w2 + (j * E + o) * w.RF, F, false) *
                                  enc_grad<kAct>(ez, u0 + o, p, a.beta))
                      : 0.f;
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
  named_bar_sync(kBar, kConsumers);
}

// The normalization's VJP (x = q / n  =>  g = gx / n - q [s >= eps^2]
// <gx, q>_J / n^3), then g out, or the projection step. Thread t: first
// component t / 64 of pose t % 64 (norm and scale to nrm, scl), then the
// joints t / 64, t / 64 + 4, ...
__device__ __forceinline__ void finish(const Args& a, int row0, const float* gx, float* nrm,
                                       float* scl) {
  const int t = threadIdx.x, p = t % kRows, r = t / kRows;
  const int J = a.J;
  const bool valid = row0 + p < a.B;
  const int b = valid ? row0 + p : 0;
  const float4* q4 = reinterpret_cast<const float4*>(a.pose) + static_cast<size_t>(b) * J;
  {
    float s = 0.f, dot = 0.f;
    for (int j = 0; j < J; ++j) {
      const float4 q = valid ? __ldg(q4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float v = r == 0 ? q.x : r == 1 ? q.y : r == 2 ? q.z : q.w;
      s = fmaf(v, v, s);
      dot = fmaf(gx[(j * 4 + r) * kRows + p], v, dot);
    }
    const float n = sqrtf(fmaxf(s, kEps2));
    nrm[r * kRows + p] = n;
    scl[r * kRows + p] = s >= kEps2 ? dot / (n * n * n) : 0.f;
  }
  named_bar_sync(kBar, kConsumers);
  if (!valid) return;
  float n[4], scale[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    n[c] = nrm[c * kRows + p];
    scale[c] = scl[c * kRows + p];
  }
  const float sd = a.step_scale * a.d_out[b];   // written by this CTA, before a barrier
  for (int j = r; j < J; j += 4) {
    const float4 q4j = __ldg(q4 + j);
    const float q[4] = {q4j.x, q4j.y, q4j.z, q4j.w};
    float g[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) g[c] = gx[(j * 4 + c) * kRows + p] / n[c] - q[c] * scale[c];
    if (a.mode == kValueAndGrad) {
      reinterpret_cast<float4*>(a.g_out)[static_cast<size_t>(b) * J + j] =
          make_float4(g[0], g[1], g[2], g[3]);
    } else {
      if (a.tangent) {
        const float rr = g[0] * q[0] + g[1] * q[1] + g[2] * q[2] + g[3] * q[3];
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] -= rr * q[c];
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
}

// The walks, with the SMPL fields' feature width at compile time.
template <int kAct, bool kBf16>
__device__ __forceinline__ void walk_forward(const Args& a, int row0, const Buf& x, int D0,
                                             unsigned char* ez, const int* parents, float* wr) {
  if (a.F == 6)
    encode<kAct, kBf16, 6>(a, row0, x, D0, ez, parents, wr);
  else
    encode<kAct, kBf16, 0>(a, row0, x, D0, ez, parents, wr);
}

template <int kAct, bool kBf16>
__device__ __forceinline__ void walk_backward(const Args& a, const Buf& x, const unsigned char* ez,
                                              float* gx, const int* parents) {
  if (a.F == 6)
    encode_backward<kAct, kBf16, 6>(a, x, ez, gx, parents);
  else
    encode_backward<kAct, kBf16, 0>(a, x, ez, gx, parents);
}

// The consumers' program (threads 0..255): vec to shared memory where it
// fits, the encoder walk, the forward's steps, the output layer and, with a
// gradient, the backward's start and steps, the encoder's reverse walk and
// finish. The derivative state: the DFNet's in the CTA's global scratch;
// the encoder's in shared memory (ezs, lrelu and relu) or after the DFNet's
// (softplus).
template <int kAct, bool kBf16>
__device__ __forceinline__ void consume(const Args& a, Ctx& cx, unsigned char* ring, float* xs,
                                        float* cs, float* vs, unsigned char* ezs, int* ps) {
  const bool grad = a.mode != kForward;
  const int row0 = blockIdx.x * kRows;
  const int E = 4 + a.F;
  const int* head = a.prog;
  const int nfwd_steps = __ldg(head), nbwd_steps = __ldg(head + 1);
  const int zsum = __ldg(head + 7);
  const Buf x{xs, kXMax}, cb{cs, kChunk};
  // vec: the biases, the output layer's w and (last) its b
  const int nvec = __ldg(head + 5) + 1;
  const float* vec = a.vec;
  if (nvec <= kVecSmem) {   // read before the first epilogue, after encode's barriers
    for (int i = threadIdx.x; i < nvec; i += kConsumers) vs[i] = __ldg(a.vec + i);
    vec = vs;
  }
  if (static_cast<int>(threadIdx.x) < a.J)   // read after encode's barriers
    ps[threadIdx.x] = __ldg(a.parents + threadIdx.x);
  const size_t enc_bytes = kAct == kSoftplus ? static_cast<size_t>(a.J) * (E + a.F) * kRows * 4 : 0;
  unsigned char* zb =
      grad ? a.zscratch + static_cast<size_t>(blockIdx.x) * (kZUnit<kAct> * static_cast<size_t>(zsum) + enc_bytes)
           : nullptr;
  unsigned char* ez = !grad ? nullptr
                      : kAct == kSoftplus ? zb + static_cast<size_t>(kZUnit<kAct>) * zsum
                                          : ezs;

  // the forward walk has the ring's space; then the ring's first copies
  walk_forward<kAct, kBf16>(a, row0, x, __ldg(head + 2), ez, ps, reinterpret_cast<float*>(ring));
  if constexpr (kBf16)
    named_bar_arrive(kBarRing, kConsumers + 32);   // the producer's warp waits on it
  else
    for (int g = 0; g < Route<false>::kStages; ++g) fill(cx, g);
  const int* step = head + kHead;
  for (int i = 0; i < nfwd_steps; ++i, step += kStep) run_step<kAct, kBf16>(step, x, cb, vec, zb, cx);
  // the output layer: d
  const int K = __ldg(head + 3);
  const float* wl = vec + __ldg(head + 4);
  output_layer<kAct, kBf16>(a, row0, x, K, wl, vec[nvec - 1], cs, cs + 4 * kRows);
  if (!grad) return;
  backward_start<kAct, kBf16>(x, K, wl, zb + static_cast<size_t>(kZUnit<kAct>) * __ldg(head + 6),
                              cs + 4 * kRows, cx);
  for (int i = 0; i < nbwd_steps; ++i, step += kStep) run_step<kAct, kBf16>(step, x, cb, vec, zb, cx);
  // every slab is read: the ring's space holds gx
  float* gx = reinterpret_cast<float*>(ring);
  walk_backward<kAct, kBf16>(a, x, ez, gx, ps);
  finish(a, row0, gx, cs + kMaxE * kRows, cs + (kMaxE + 4) * kRows);
}

template <int kAct, bool kBf16>
__global__ void __launch_bounds__(Route<kBf16>::kThreads, 1)
    field_kernel(const __grid_constant__ Args a) {
  constexpr int S = Route<kBf16>::kStages, kSlot = Route<kBf16>::kSlot;
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic on the shared array, so that the compiler
  // keeps every access below a shared-memory one
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* xs = reinterpret_cast<float*>(ring + S * kSlot);
  float* cs = xs + kRows * kXMax;
  float* vs = cs + kRows * kChunk;
  unsigned char* ezs = reinterpret_cast<unsigned char*>(vs + kVecSmem);
  int* ps = reinterpret_cast<int*>(ezs + kEzSmem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ps + kMaxJ);
  // full barriers (one arrival, the slab's bytes); bf16: empty ones (an
  // arrival of each consumer warpgroup)
  init_ring(bars, S, 1, kConsumers / 128);

  const int n = a.mode != kForward ? a.nfwd + a.nbwd : a.nfwd;
  Ctx cx{bars,
         ring,
         a.slabs,
         n,
         0,
         static_cast<int>(threadIdx.x) / 128,
         static_cast<int>(threadIdx.x) % 128,
         a.beta};
  if constexpr (kBf16) {
    if (threadIdx.x >= kConsumers) {   // the producer warpgroup: its thread 0 copies every slab
      setmaxnreg_dec<24>();
      if (threadIdx.x < kConsumers + 32) {
        named_bar_sync(kBarRing, kConsumers + 32);   // once the forward walk is done with the ring
        if (threadIdx.x == kConsumers)
          for (int g = 0; g < n; ++g)
            produce(bars, S, ring, kSlot, g, a.slabs + static_cast<size_t>(g) * kSlot, kSlot);
      }
      return;
    }
    setmaxnreg_inc<240>();
  }
  consume<kAct, kBf16>(a, cx, ring, xs, cs, vs, ezs, ps);
}

template <bool kBf16>
int launch_route(const Args& a, dim3 ctas, void* stream) {
  constexpr int kThreads = Route<kBf16>::kThreads;
  constexpr size_t kSmem = field_smem<kBf16>();
  switch (a.act) {   // one kernel an activation, so each epilogue is a few instructions
    case kLRelu:
      return launch_wgmma(field_kernel<kLRelu, kBf16>, ctas, kThreads, kSmem, stream, a);
    case kRelu:
      return launch_wgmma(field_kernel<kRelu, kBf16>, ctas, kThreads, kSmem, stream, a);
    case kSoftplus:
      return launch_wgmma(field_kernel<kSoftplus, kBf16>, ctas, kThreads, kSmem, stream, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(Args a, int mode, void* stream) {
  if (a.J < 1 || a.J > kMaxJ || a.F < 1 || a.F > kMaxF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return 0;
  a.mode = mode;
  const dim3 ctas((a.B + kRows - 1) / kRows);
  if (a.bf16)
    return launch_route<true>(a, ctas, stream);
  return launch_route<false>(a, ctas, stream);
}

Args common_args(const float* pose, int B, const float* enc, const int* parents, int J, int F,
                 const void* slabs, const float* vec, const int* prog, int nfwd, int nbwd, int act,
                 float beta, int bf16) {
  Args a{};
  a.pose = pose;
  a.B = B;
  a.enc = enc;
  a.parents = parents;
  a.J = J;
  a.F = F;
  a.slabs = static_cast<const unsigned char*>(slabs);
  a.vec = vec;
  a.prog = prog;
  a.nfwd = nfwd;
  a.nbwd = nbwd;
  a.act = act;
  a.beta = beta;
  a.bf16 = bf16;
  a.step_scale = 1.f;
  return a;
}

}  // namespace

extern "C" {

int posendf_forward(const float* pose, int B, const float* enc, const int* parents, int J, int F,
                    const void* slabs, const float* vec, const int* prog, int nfwd, int nbwd,
                    int act, float beta, int bf16, float* d_out, void* stream) {
  Args a = common_args(pose, B, enc, parents, J, F, slabs, vec, prog, nfwd, nbwd, act, beta, bf16);
  a.d_out = d_out;
  return launch(a, kForward, stream);
}

int posendf_value_and_grad(const float* pose, int B, const float* enc, const int* parents, int J,
                           int F, const void* slabs, const float* vec, const int* prog, int nfwd,
                           int nbwd, int act, float beta, int bf16, float* d_out, float* g_out,
                           void* zscratch, void* stream) {
  Args a = common_args(pose, B, enc, parents, J, F, slabs, vec, prog, nfwd, nbwd, act, beta, bf16);
  a.d_out = d_out;
  a.g_out = g_out;
  a.zscratch = static_cast<unsigned char*>(zscratch);
  return launch(a, kValueAndGrad, stream);
}

int posendf_project_step(const float* pose, int B, const float* enc, const int* parents, int J,
                         int F, const void* slabs, const float* vec, const int* prog, int nfwd,
                         int nbwd, int act, float beta, int bf16, float* d_out, float* q_out,
                         void* zscratch, float step_scale, int tangent, int renormalize,
                         void* stream) {
  Args a = common_args(pose, B, enc, parents, J, F, slabs, vec, prog, nfwd, nbwd, act, beta, bf16);
  a.d_out = d_out;
  a.q_out = q_out;
  a.zscratch = static_cast<unsigned char*>(zscratch);
  a.step_scale = step_scale;
  a.tangent = tangent;
  a.renormalize = renormalize;
  return launch(a, kProjectStep, stream);
}

// Floats (4-byte words) of the derivative-state scratch of a value-and-grad
// or projection launch over B poses with activation act: per 64-pose CTA,
// the DFNet's zsum units of 64 bits (lrelu, relu: two words; the encoder's
// bits stay in shared memory) or of 64 fp32 pre-activations, then the
// encoder's J (E + F) units of those (softplus).
long long posendf_field_scratch_floats(int B, int J, int F, int zsum, int act) {
  const long long ctas = (B + kRows - 1) / kRows;
  return act == kSoftplus ? ctas * kRows * (zsum + J * (2 * F + 4)) : ctas * (kRows / 32) * zsum;
}

// Bytes of dynamic shared memory one CTA takes (the larger route's).
int posendf_smem_bytes() {
  return static_cast<int>(field_smem<true>() > field_smem<false>() ? field_smem<true>()
                                                                   : field_smem<false>());
}

const char* posendf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
