// Device code of the two kernels that run the DFNet's products as 3xTF32
// wgmma on a 64-pose tile: the field kernels (field_kernels.cu) and the
// training tile (train_kernels.cu). Each decision here is one format both
// kernels read: the tile and its activations, the program's header that
// fused_model.tc_schedule writes, the wait on the ring of slabs, the split
// of A into TF32 hi | lo, and the encoder walk, four lanes a pose, with its
// act' bits. Only those two sources include this header (its kRows is not
// int8_kernels.cu's, so it stays out of common.cuh).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace tc_tile {

constexpr int kRows = 64;                        // poses a CTA: one wgmma M
constexpr int kSlabN = 128;                      // output columns a slab: 64 a warpgroup
constexpr int kXMax = 512;                       // widest activation kept whole
constexpr int kChunk = 64;                       // a chained layer's output, a chunk at a time
constexpr int kHead = 8, kStep = 8;              // ints of the program's header and of a step
constexpr uint32_t kBar = 1;                     // named barrier of the two warpgroups of products
constexpr int kRingFloats = 16384;               // the ring's space in floats (64 KB)

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

// The program's header (fused_model.tc_schedule): [forward steps, backward
// steps, D[0], D[L-1], offset in vec of the output layer's w, of its b,
// derivative-state offset of layer L-2, zsum], a field an accessor. D[0],
// the code's width, is read where the forward walk is called, as
// __ldg(head + 2): ops/breakdown.py's `noenc` cuts match those statements.
__device__ __forceinline__ int prog_nfwd(const int* head) { return __ldg(head); }
__device__ __forceinline__ int prog_nbwd(const int* head) { return __ldg(head + 1); }
__device__ __forceinline__ int prog_K(const int* head) { return __ldg(head + 3); }
__device__ __forceinline__ int prog_w_out(const int* head) { return __ldg(head + 4); }
__device__ __forceinline__ int prog_b_out(const int* head) { return __ldg(head + 5); }
__device__ __forceinline__ int prog_z_last(const int* head) { return __ldg(head + 6); }
__device__ __forceinline__ int prog_zsum(const int* head) { return __ldg(head + 7); }

// wait until the phase of `parity` of barrier `bar` has completed; a wait
// of more than 2^35 clocks (about 20 s) is a lost arrival and traps. The
// whole loop is one asm block, unlike hopper.cuh's mbar_wait: a branch near
// the wgmma that the compiler could take for a divergent path makes ptxas
// serialize the wgmma.
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

// the A fragments stay in their registers, unchanged, up to here (an empty
// asm that reads and writes each)
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
    const float h = hopper::tf32_round(x[j]);
    hi[j] = __float_as_uint(h);
    lo[j] = __float_as_uint(hopper::tf32_round(x[j] - h));
  }
}

// ---- the encoder walk, four lanes a pose ----
// Pose t / 4, part r = t % 4 (a warp holds 8 poses): part r sums the hidden
// units (then the features, and in the reverse walk the rows) r, r + 4, ...,
// one FMA a term in index order from rows in shared memory read as float4,
// and the pose's four parts trade units by shuffles (from_part), so a joint
// needs no CTA barrier.

constexpr int kWalkF = 6;   // the feature width the walks take at compile time (the SMPL fields')

// The walk's widths, from a kernel's Args (J, F): F features, E = 4 + F
// hidden units, U = E + F units a joint; a forward row R = 4 ceil((E + 1) /
// 4) floats (E weights, the bias, zeros); the reverse walk's W2 and W1 rows
// RF = 4 ceil(F / 4) and RE = 4 ceil(E / 4); nf, nb: the floats of all
// joints' forward rows and of their reverse rows. kF: the feature width at
// compile time (kWalkF), or 0 for a.F at run time.
template <int kF>
struct Walk {
  int F, E, U, R, RF, RE, nf, nb;
  template <class Args>
  __device__ __forceinline__ explicit Walk(const Args& a) {
    F = kF > 0 ? kF : a.F;
    E = 4 + F;
    U = E + F;
    R = posendf::round4(E + 1);
    RF = posendf::round4(F);
    RE = posendf::round4(E);
    nf = a.J * (E + F) * R;   // not U: so written, the field kernels' SASS is unchanged
    nb = a.J * E * (RF + RE);
  }
};

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

// The walk's act' bits (lrelu, relu) in shared memory: unit u of J (E + F)
// (joint j's hidden units, then its features) of pose p at bit p % 8 of
// byte 8u + p / 8, a byte a unit and warp (8 poses). act_grad_bit of the bit
// is act'(z) of the pre-activation, for every z.
constexpr int kEncBitBytes = 8 * posendf::kMaxJ * (posendf::kMaxE + posendf::kMaxF);

template <int kAct>
__device__ __forceinline__ float enc_slope(const unsigned char* bits, int u, int p) {
  return posendf::act_grad_bit(kAct, (bits[8 * u + p / 8] >> (p % 8)) & 1u);
}

// keep act'(z) of units u0 + 4 i + r (r the part, i < kSlots, those below n)
// of the pose, pre-activations z[i]: a ballot of the warp a slot, its lanes
// 0-3 each storing the byte of one unit. Every lane of the warp calls this.
template <int kAct, int kSlots>
__device__ __forceinline__ void enc_keep_bits(unsigned char* bits, int u0, int n,
                                              const float (&z)[kSlots]) {
  const int t = threadIdx.x, r = t % 4, lane = t % 32;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const uint32_t b = __ballot_sync(0xffffffffu, r + 4 * i < n && posendf::act_bit(kAct, z[i]));
    uint32_t v = 0;   // lane l < 4: bit 4 pp + l of each pose pp of the warp
#pragma unroll
    for (int pp = 0; pp < 8; ++pp) v |= ((b >> (4 * pp + (lane & 3))) & 1u) << pp;
    if (lane < 4 && 4 * i + lane < n) bits[8 * (u0 + 4 * i + lane) + t / 32] = static_cast<unsigned char>(v);
  }
}

}  // namespace tc_tile
