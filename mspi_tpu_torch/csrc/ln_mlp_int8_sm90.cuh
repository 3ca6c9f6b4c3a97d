// Int8 LayerNorm + MLP forward (inference only): y = deq(q(gelu(deq(q(LN(x))
// W1q^T) + b1)) W2q^T) + b2 on token-major rows x [M, C].
//
// Replaces: mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp_int8 (kernel
// _ln_fwd_kernel_q), which the JAX package runs with MSPI_QUANT=int8 for
// every transformer LN+MLP with C >= 256 at inference (the MViT and
// VideoSwin stage-3/4 blocks and the SyncBlock).
//
// Numerics follow the TPU kernel, in its order of operations:
//   LayerNorm statistics in fp32 with var = E[x^2] - mu^2, z kept in fp32;
//   z quantised per row: amax = max(max|z|, 1e-6), code = round(z * (127 /
//   amax)) half to even, scale sz = amax * (1/127);
//   u = fp32(int32 sum of zq * w1q) * (sz * s1) + b1 (the int32 -> fp32
//   conversion rounds to nearest);
//   h = gelu(u) with the degree-8 fast-erf polynomial (_ERF_COEF_FAST,
//   clamped at |z| = 4), whatever the storage type, as the TPU kernel does;
//   h quantised per row over the whole hidden width, as z;
//   y = fp32(int32 sum of hq * w2q) * (sh * s2) + b2, one cast to T.
// Every product and sum of the epilogues is rounded on its own
// (__fmul_rn / __fadd_rn, no contraction into FMAs), as the plain PyTorch
// version computes them. What still differs from it: the order of the LN
// sums and the square root (1/sqrtf), which may move an element across a
// rounding boundary and flip one int8 code on rare elements. Products over
// int32 are exact in any order, so u, h and the codes depend on z alone.
//
// What bounds it on the card: 4*C*H int8 operations per row against 2*C
// values read and written per row -- the tensor cores (int8 peak 1979 TOPS).
//
// h has to be quantised per row over all H hidden units before fc2 can
// start, and no body holds a whole [rows, H] hidden tile. So fc1 runs twice:
// pass 1 computes u chunk by chunk (64 hidden units) and keeps one running
// maximum per row; pass 2 recomputes the same u (integer products are exact,
// so h is bit-identical), quantises each chunk of h with the row's scale,
// and accumulates fc2 from it: 1.5x the work of the two products.
//
// Row 12, both x dtypes (i8sm90::ln_mlp_int8_sm90_kernel, the Hopper body):
// - s8 wgmma (m64nNk32, s32 accumulate) on operands that TMA brings into
//   shared memory in the 128-byte swizzle (sm90_wgmma.cuh). The int8 weights
//   in nn.Linear layout, w1q [H, C] and w2q [C, H], are both K-major B
//   operands as stored, the only form int8 wgmma takes.
// - Two consumer warpgroups and a producer warpgroup a block. Up to C = 512
//   the consumers share the block's 64 rows: per step of 128 hidden units
//   consumer w runs fc1 and the GELU on units 64 w .. 64 w + 63 and fc2 on
//   y's columns w C / 2 .. (w + 1) C / 2 - 1, over both consumers' codes, so
//   nothing is computed twice. At C = 768 a [64, 384] s32 accumulator would
//   take 192 registers a thread: each consumer owns 64 of 128 rows, and y's
//   columns come in parts of 256 over the grid, each part recomputing fc1
//   and the GELU (Form<C>).
// - One thread of the producer keeps two TMA rings full in the order the
//   consumers read them: W1 boxes [128 or 64 units, 128 k] (3-12 slots, what
//   shared memory leaves) for every step of pass 1, then each step of pass 2
//   with, after every 128 units, W2's [C or 256, 128 units] (2 slots). The
//   producer drops to 24 registers (setmaxnreg) and the consumers rise to
//   240.
// - The consumers normalise the block's rows, one warp per row as the first
//   body did (the same sums in the same order), into the swizzled z tile:
//   fc1's A from shared memory, u [64, 64] s32 in registers, one commit per
//   W1 box.
// - An s32 accumulator is not laid out as an s8 A fragment, so pass 2 writes
//   h's codes as byte pairs into a swizzled [64, 128] int8 tile (two, by
//   step) and fc2 reads it as its A from shared memory, in flight while the
//   next step's fc1 is issued (whose first wait retires it).
// - The GELU runs once per hidden element, in pass 2: pass 1 keeps each
//   row's largest u and takes amax = |gelu(u_max)|, the row's max |h|
//   wherever the GELU grows with u and no negative u's |h| is larger (a row
//   whose hidden pre-activations all lie below ~0.3 breaks it). Pass 2 also
//   takes the true max |h| of each row; if a row's differs, the block runs
//   pass 2 again with the true maxima (the consumers' verdict, an OR over a
//   barrier, tells the producer to stream it again), so the codes and y are
//   always those of the exact row maxima, as the first body computed them.
//   Row maxima meet in shared memory where the consumers share rows.
// - Measured on the way (PERF.md): a 4-slot W1 ring ran as fast as 12; the
//   GELU (the fast-erf polynomial, each product and sum rounded alone, ~30
//   FP32 instructions) took a third of the time at C = 384 when both passes
//   ran it and every column part recomputed it.
// Every output element has one writer and one summation order: two runs are
// bit-identical.
//
// Also replaces the int8 body of tools/bench_int8.py::_mlp_call
// (_mlp_int8w_kernel, the int8 lab's mlp_int8w, bf16; entered in
// mlp_int8_lab.cu at the lab's C = 96 and at row 12's widths, each in row
// 12's form, H % 64 == 0): row 12's body in its lab variant (LAB), at C =
// 96 Form<96> below: without the LayerNorm,
// the biases and the GELU, and with the lab's own quantisation, in its order
// of operations: per row scale = max(amax, 1e-6) * (1/127) and code =
// round(v / scale) half to even (a true division, where row 12 multiplies by
// 127 / amax); uf = fp32(acc) * sx * s1 (left to right), h = uf; y =
// fp32(acc) * sh * s2, one cast to bf16. Without the GELU pass 1 keeps each
// row's exact max |h|, so pass 2 runs once. x's 96 codes a row fill a
// 128-byte z row to k = 96, and fc1 runs the three k-steps of 32 that cover
// them over W1 boxes that TMA fills with zeros past k = 96. Three consumers
// of 160 registers each own 64 of a block's 192 rows and all 96 columns of
// y, and the grid is persistent, so the consumers' timelines (x's loads, the
// divisions, the barriers) overlap and a block's setup is paid once per SM.
// Measured at the lab's shape (PERF.md): both consumers on one 64-row tile,
// 48 columns each, 1.2 ms; two consumers of 64 rows, persistent, 0.82;
// three, 0.65; the first body 0.88-0.90. The weight codes and per-channel
// scales are the lab's host quantisation (amax / 127, no floor).

#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90_wgmma.cuh"

namespace mspi {
namespace {

// Constants rounded from their decimal through double to float, as Python
// floats reach the JAX kernel's fp32 arithmetic.
__constant__ float kErfFast[9] = {
    static_cast<float>(3.536022699613e-01), static_cast<float>(-1.745360228158e-01),
    static_cast<float>(1.282262975445e-01), static_cast<float>(-1.335568183591e-01),
    static_cast<float>(1.164849409594e-01), static_cast<float>(1.073632742169e-02),
    static_cast<float>(-7.948334927669e-03), static_cast<float>(-1.415578021638e-01),
    static_cast<float>(9.874117476355e-02)};
constexpr float kInvSqrt2 = static_cast<float>(0.70710678118654752440);
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kAmaxFloor = static_cast<float>(1e-6);

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float erf_fast(float x) {
  const float z = fminf(fmaxf(x, -4.f), 4.f);
  const float u = __fadd_rn(__fmul_rn(__fmul_rn(z, z), 0.125f), -1.f);
  float r = kErfFast[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) r = __fadd_rn(__fmul_rn(r, u), kErfFast[i]);
  return __fmul_rn(z, r);
}

__device__ __forceinline__ float gelu_fast(float u) {
  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, erf_fast(__fmul_rn(u, kInvSqrt2))));
}

// u = fp32(acc) * (sz * s1) + b1
__device__ __forceinline__ float pre_gelu(int acc, float sz, float s1, float b1) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sz, s1)), b1);
}

// h = gelu(u) of that u
__device__ __forceinline__ float hidden(int acc, float sz, float s1, float b1) {
  return gelu_fast(pre_gelu(acc, sz, s1, b1));
}

// The lab's hidden value: uf = fp32(acc) * sx * s1, left to right.
__device__ __forceinline__ float hidden_lab(int acc, float sx, float s1) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), s1);
}

// The lab's per-row scale of a row with max |v| = amax.
__device__ __forceinline__ float lab_scale(float amax) {
  return __fmul_rn(fmaxf(amax, kAmaxFloor), kInv127);
}

__device__ __forceinline__ int8_t lab_code(float v, float scale) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(v, scale)));
}

// v / scale as q = v * inv (inv = 1 / scale, rounded), and whether q may round
// to another code than the true quotient: q lies within 2^-23 |q| of the
// quotient and the rounded quotient within 2^-24 of it, so only where a
// half-integer lies within 2^-21 |q| of q. Where any lane's q of a batch is
// so near, the warp takes lab_code's divisions for the batch (the division
// took 40% of the lab's time, PERF.md); the codes are the division's.
__device__ __forceinline__ float lab_quotient(float v, float inv, bool& near) {
  const float q = __fmul_rn(v, inv);
  near |= fabsf(__fsub_rn(q, __fadd_rn(floorf(q), 0.5f))) <= __fmul_rn(fabsf(q), 0x1p-21f);
  return q;
}

// two codes as the byte pair an int8 tile row takes
__device__ __forceinline__ uint16_t code_pair(int c0, int c1) {
  return static_cast<uint16_t>((c0 & 0xff) | (c1 & 0xff) << 8);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- row 12 on Hopper: s8 wgmma fed by TMA -------------------------------------

namespace i8sm90 {
constexpr int kHC = 64;          // hidden units of one fc1 product (a consumer's step)
constexpr int kBox = 128;        // k per box: one 128-byte swizzle row of int8
constexpr int kW2Stages = 2;     // W2 ring slots
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
// the static barriers, row scales and maxima (1264 B at 128 rows a block)
constexpr int kStatic = 1280;

// The launch form at width C; ops/kernels/ln_mlp.py::int8_sm90_form mirrors it.
//   SHARED (C <= 512): the two consumer warpgroups share a block's 64 rows.
//     Per step of 128 hidden units consumer w takes units 64 w .. 64 w + 63
//     of fc1 (and of the GELU) and y's columns w C / 2 .. (w + 1) C / 2 - 1
//     of fc2, over the h codes of both: nothing is computed twice.
//   parts (C = 768, where a [64, C / 2] s32 accumulator would take 192
//     registers): each consumer owns 64 of a block's 128 rows, steps are 64
//     units, and y's columns come in parts of 256 over the grid's y, each
//     part recomputing fc1 and the GELU.
//   C = 320 (UniFormer-B's stage 3) is a SHARED form: y's 160 columns a
//     consumer by one s8 wgmma n160 per k-step of fc2; the z codes fill three
//     k boxes to k = 320, fc1 runs the 10 k-steps of 32 that cover them, over
//     W1 boxes that TMA fills with zeros past k = 320; 6 W1 slots.
//   C = 96 (the int8 lab): as the parts form with three consumers, each
//     owning 64 of a block's 192 rows and all 96 columns of y (s8 wgmma
//     n96), so that the consumers' timelines run apart; one z box of 128 k
//     of which x fills 96; the grid is persistent (a block per SM walks the
//     row tiles).
template <int C>
struct Form {
  static constexpr bool SHARED = C > 96 && C <= 512;
  static constexpr int NC = C == 96 ? 3 : 2;             // consumer warpgroups
  static constexpr int BM = SHARED ? 64 : 64 * NC;       // rows per block
  static constexpr int CN = SHARED ? C / 2 : C < 256 ? C : 256;  // y columns per consumer
  static constexpr int PARTS = SHARED ? 1 : C / CN;      // column parts (grid y)
  static constexpr int UNITS = SHARED ? 2 * kHC : kHC;   // hidden units per step
  static constexpr int KB = (C + kBox - 1) / kBox;       // k boxes of z and of a step's W1
  static constexpr uint32_t kZBox = BM * kBox;           // one k box of the z codes
  static constexpr uint32_t kW1Box = UNITS * kBox;       // one [UNITS, 128 k] box of W1
  static constexpr int kW2Rows = SHARED ? C / 2 : CN;    // rows of one W2 box
  static constexpr uint32_t kW2Slot = (SHARED ? C : CN) * kBox;  // W2 of 128 units
  static constexpr uint32_t kHq = 64 * kBox;  // h codes of 128 units: one tile
  static constexpr int HQ = SHARED ? 2 : NC;   // h code tiles: by step parity, or a consumer's
  static constexpr int kFixed = KB * kZBox + kW2Stages * kW2Slot + HQ * kHq + 1024;  // + alignment
  // W1 ring slots: what shared memory leaves, at most 12
  static constexpr int W1S = (kSmemLimit - kStatic - kFixed) / kW1Box < 12
                                 ? (kSmemLimit - kStatic - kFixed) / kW1Box
                                 : 12;
  static constexpr int kSmem = kFixed + W1S * kW1Box;
  static constexpr int kThreads = 128 * (NC + 1);
  // the consumers' registers by setmaxnreg, the producer's 24 beside them
  // within the launch's share: 2 x 240 + 24 = 3 x 168; 3 x 160 + 24 <= 4 x 128
  static constexpr int kConsumerRegs = NC == 2 ? 240 : 160;
  static_assert((C % kBox == 0 || C == 96 || C == 320) && C % CN == 0 && CN % 16 == 0 &&
                    CN <= 256,
                "widths");
  static_assert(W1S >= 3 && kSmem + kStatic <= kSmemLimit, "shared memory");
  static_assert(kZBox % 1024 == 0 && kW1Box % 1024 == 0 && kW2Slot % 1024 == 0,
                "swizzle atoms stay aligned");
};

// y[64 x CN] += hq[64 x 32] W2[CN x 32]^T: one k-step of fc2 in pieces of
// 128 columns and a 64- or 96-column rest, each reading hq's descriptor again. y's
// registers stay in the m64nN layout (y[4 j + e]: column 8 j + 2 (t % 4) +
// (e % 2) of the consumer's columns, row + 8 (e / 2)).
// At CN = 160 (C = 320) one s8 wgmma n160 takes all the consumer's columns.
template <int CN>
__device__ __forceinline__ void fc2_kstep(int (&y)[CN / 2], uint64_t da,
                                          const unsigned char* w2k) {
  if constexpr (CN == 160) {
    wg::wgmma_m64n160k32_s8(y, da, wg::desc_sw128(w2k, 16, 1024));
  } else {
#pragma unroll
    for (int p = 0; p < CN / 128; ++p)
      wg::wgmma_m64n128k32_s8(*reinterpret_cast<int(*)[64]>(&y[64 * p]), da,
                              wg::desc_sw128(w2k + p * 128 * kBox, 16, 1024));
    if constexpr (CN % 128 == 64)
      wg::wgmma_m64n64k32_s8(*reinterpret_cast<int(*)[32]>(&y[64 * (CN / 128)]), da,
                             wg::desc_sw128(w2k + (CN / 128) * 128 * kBox, 16, 1024));
    else if constexpr (CN % 128 == 96)
      wg::wgmma_m64n96k32_s8(*reinterpret_cast<int(*)[48]>(&y[64 * (CN / 128)]), da,
                             wg::desc_sw128(w2k + (CN / 128) * 128 * kBox, 16, 1024));
    else
      static_assert(CN % 128 == 0, "fc2's rest: 64 or 96 columns");
  }
}

// Byte (r, k) of a swizzled K-major int8 tile of 128-byte rows: chunk k / 16
// of row r at chunk (k / 16) ^ (r % 8).
__device__ __forceinline__ int swz8(int r, int k) {
  return r * kBox + ((((k >> 4) ^ r) & 7) << 4) + (k & 15);
}

// Grid (row tiles of BM, column parts). tw1: w1q [H, C] in [UNITS, 128]
// boxes; tw2: w2q [C, H] in [kW2Rows, 128] boxes. LAB: the int8 lab's
// mlp_int8w (no LayerNorm, biases or GELU; the lab's quantisation; gamma,
// beta, b1 and b2 unread) on a persistent grid: each block takes row tiles
// blockIdx.x, + gridDim.x, ..., its producer streaming every tile's boxes in
// turn through the same rings.
template <typename T, int C, bool LAB = false>
__global__ void __launch_bounds__(Form<C>::kThreads, 1)
    ln_mlp_int8_sm90_kernel(const __grid_constant__ CUtensorMap tw1,
                            const __grid_constant__ CUtensorMap tw2, const T* __restrict__ x,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            const float* __restrict__ s1, const float* __restrict__ b1,
                            const float* __restrict__ s2, const float* __restrict__ b2,
                            T* __restrict__ y, int M, int H, float eps) {
  using F = Form<C>;
  constexpr bool SHARED = F::SHARED;
  constexpr int CN = F::CN, KB = F::KB, PER = C / 32, W1S = F::W1S;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full1[W1S], empty1[W1S], full2[kW2Stages], empty2[kW2Stages];
  __shared__ float zscale[F::BM];   // the rows' z scales
  __shared__ float hmax[2][64];     // SHARED: each consumer's rows' maxima over its units
  __shared__ __align__(8) uint64_t verdict_bar;  // a pass 2 is done: its verdict is set
  __shared__ int verdict;                         // pass 2 again, with the true maxima
  unsigned char* zs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* w1s = zs + KB * F::kZBox;
  unsigned char* w2s = w1s + W1S * F::kW1Box;
  unsigned char* hqs = w2s + kW2Stages * F::kW2Slot;
  // steps per pass (LAB SHARED, H % 128 == 64: the last step's second
  // consumer's units lie past H)
  const int n_s = LAB ? (H + F::UNITS - 1) / F::UNITS : H / F::UNITS;
  const int n_tiles = static_cast<int>((static_cast<int64_t>(M) + F::BM - 1) / F::BM);
  if (threadIdx.x == 0) {
    for (int s = 0; s < W1S; ++s) {
      wg::mbar_init(&full1[s], 1);
      wg::mbar_init(&empty1[s], 4 * F::NC);  // one arrival per consumer warp
    }
    for (int s = 0; s < kW2Stages; ++s) {
      wg::mbar_init(&full2[s], 1);
      wg::mbar_init(&empty2[s], 4 * F::NC);
    }
    wg::mbar_init(&verdict_bar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  // after pass 2's step s, fc2 over the last 128 units' codes: every step
  // (SHARED), every second one (parts); LAB also after an odd count's last
  // step, its 64 units' codes beside a W2 box that TMA zero-fills past H
  auto fc2_after = [n_s](int s) {
    if constexpr (LAB) return SHARED || s % 2 == 1 || s == n_s - 1;
    else return SHARED || s % 2 == 1;
  };
  if (threadIdx.x >= 128 * F::NC) {  // the producer warpgroup; one thread issues
    wg::setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * F::NC) {
      int i1 = 0, i2 = 0;  // W1 boxes and W2 slots issued
      auto w1_step = [&](int st) {
        for (int kb = 0; kb < KB; ++kb, ++i1) {
          const int sl = i1 % W1S;
          if (i1 >= W1S) wg::mbar_wait(&empty1[sl], ((i1 / W1S) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(&full1[sl], F::kW1Box);
          wg::tma_load_2d(w1s + sl * F::kW1Box, &tw1, &full1[sl], kb * kBox, st * F::UNITS);
        }
      };
      auto produce = [&]() {  // one row tile's boxes
        for (int st = 0; st < n_s; ++st) w1_step(st);  // pass 1
        // pass 2 (a step, then its W2), again while the consumers' verdict asks
        for (int attempt = 0, st = 0;; ++st) {
          if (st == n_s) {
            if constexpr (LAB) break;  // no GELU: pass 1's maxima are exact
            wg::mbar_wait(&verdict_bar, attempt & 1);
            if (!*static_cast<volatile int*>(&verdict)) break;
            ++attempt;
            st = 0;
          }
          w1_step(st);
          if (!fc2_after(st)) continue;
          // the first of the 128 units of this fc2 (LAB parts: an odd count's
          // last step is the first half of its pair)
          const int sl = i2 % kW2Stages;
          const int u0 = LAB && !SHARED ? (st / 2) * 2 * kHC : (st + 1) * F::UNITS - 2 * kHC;
          if (i2 >= kW2Stages) wg::mbar_wait(&empty2[sl], ((i2 / kW2Stages) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(&full2[sl], F::kW2Slot);
          unsigned char* dst = w2s + sl * F::kW2Slot;
          if constexpr (SHARED) {
            wg::tma_load_2d(dst, &tw2, &full2[sl], u0, 0);
            wg::tma_load_2d(dst + F::kW2Rows * kBox, &tw2, &full2[sl], u0, F::kW2Rows);
          } else {
            wg::tma_load_2d(dst, &tw2, &full2[sl], u0, blockIdx.y * CN);
          }
          ++i2;
        }
      };
      if constexpr (LAB) {
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) produce();
      } else {
        produce();
      }
    }
    return;
  }
  wg::setmaxnreg_inc<F::kConsumerRegs>();

  const int wgi = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4, g = lane / 4, t4 = lane % 4;

  int i1 = 0, i2 = 0;  // W1 boxes and W2 slots taken, over the block's row tiles
  // one row tile, rows [m0, m0 + BM)
  auto tile = [&](const int64_t m0) {
    // 1. LayerNorm in fp32 and the per-row quantisation of z, one warp per row
    //    (the first body's arithmetic, in its order), BM / 8 rows per warp, the
    //    codes into the swizzled K-major tile that wgmma reads as fc1's A
    //    (byte (r, c) in box c / 128 at swz8(r, c % 128)).
    constexpr int RPW = F::BM / (4 * F::NC);
    if constexpr (LAB && C == 96) {  // x: scale = max(amax, 1e-6) / 127, code = v / scale
      float v[RPW][PER];  // the warp's rows, all loads in flight at once
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int64_t m = m0 + (threadIdx.x / 32) * RPW + i;
#pragma unroll
        for (int k = 0; k < PER; ++k) v[i][k] = m < M ? to_f(x[m * C + lane + 32 * k]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = (threadIdx.x / 32) * RPW + i;
        float amax = 0.f;
#pragma unroll
        for (int k = 0; k < PER; ++k) amax = fmaxf(amax, fabsf(v[i][k]));
        const float scale = lab_scale(warp_max(amax)), inv = __frcp_rn(scale);
        bool near = false;
        int code[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) code[k] = __float2int_rn(lab_quotient(v[i][k], inv, near));
        if (__any_sync(0xffffffffu, near)) {
#pragma unroll
          for (int k = 0; k < PER; ++k) code[k] = lab_code(v[i][k], scale);
        }
#pragma unroll
        for (int k = 0; k < PER; ++k)
          zs[swz8(r, lane + 32 * k)] = static_cast<unsigned char>(code[k]);
        if (lane == 0) zscale[r] = m0 + r < M ? scale : 0.f;
      }
    } else if constexpr (LAB) {  // the same a row at a time, into KB boxes
#pragma unroll 1
      for (int i = 0; i < RPW; ++i) {
        const int r = (threadIdx.x / 32) * RPW + i;  // the block's row
        const int64_t m = m0 + r;
        float v[PER];
        float amax = 0.f;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          v[k] = m < M ? to_f(x[m * C + lane + 32 * k]) : 0.f;
          amax = fmaxf(amax, fabsf(v[k]));
        }
        const float scale = lab_scale(warp_max(amax)), inv = __frcp_rn(scale);
        bool near = false;
        int code[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) code[k] = __float2int_rn(lab_quotient(v[k], inv, near));
        if (__any_sync(0xffffffffu, near)) {
#pragma unroll
          for (int k = 0; k < PER; ++k) code[k] = lab_code(v[k], scale);
        }
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int c = lane + 32 * k;
          zs[(c / kBox) * F::kZBox + swz8(r, c % kBox)] = static_cast<unsigned char>(code[k]);
        }
        if (lane == 0) zscale[r] = m < M ? scale : 0.f;
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < RPW; ++i) {
        const int r = (threadIdx.x / 32) * RPW + i;  // the block's row
        const int64_t m = m0 + r;
        float scale = 0.f;
        int8_t code[PER];
        if (m >= M) {
#pragma unroll
          for (int k = 0; k < PER; ++k) code[k] = 0;
        } else {
          const T* xr = x + m * C;
          float v[PER];
          float s = 0.f, q = 0.f;
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            v[k] = to_f(xr[lane + 32 * k]);
            s = __fadd_rn(s, v[k]);
            q = __fadd_rn(q, __fmul_rn(v[k], v[k]));
          }
          const float mu = warp_sum(s) / C;
          const float var = __fsub_rn(warp_sum(q) / C, __fmul_rn(mu, mu));
          const float rstd = 1.f / sqrtf(__fadd_rn(var, eps));
          float amax = 0.f;
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int c = lane + 32 * k;
            v[k] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[k], mu), rstd), gamma[c]), beta[c]);
            amax = fmaxf(amax, fabsf(v[k]));
          }
          amax = fmaxf(warp_max(amax), kAmaxFloor);
          const float inv = 127.f / amax;
#pragma unroll
          for (int k = 0; k < PER; ++k)
            code[k] = static_cast<int8_t>(__float2int_rn(__fmul_rn(v[k], inv)));
          scale = __fmul_rn(amax, kInv127);
        }
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int c = lane + 32 * k;
          zs[(c / kBox) * F::kZBox + swz8(r, c % kBox)] = static_cast<unsigned char>(code[k]);
        }
        if (lane == 0) zscale[r] = scale;
      }
    }
    wg::fence_proxy_async();  // z's stores, seen by wgmma
    // every row is in place (LAB parts: the consumer's own, its warps wrote
    // them)
    wg::named_barrier(LAB && !SHARED ? 2 + wgi : 1, LAB && !SHARED ? 128 : 128 * F::NC);
    // the thread's accumulator rows arow, arow + 8 of the block
    const int arow = (SHARED ? 0 : 64 * wgi) + 16 * warp + g;
    const float sz[2] = {zscale[arow], zscale[arow + 8]};

    const unsigned char* za = zs + (SHARED ? 0 : wgi * 64 * kBox);  // fc1's A rows
    const int w1_off = SHARED ? wgi * kHC * kBox : 0;  // this consumer's units of a W1 box
    int fc2_pending = -1;    // the W2 slot of the fc2 in flight
    // u = zq W1[this consumer's 64 units of step st]^T: one commit per W1
    // box, released once the next box's products are queued; box 0's wait
    // also retires the fc2 in flight
    auto fc1 = [&](int (&u)[kHC / 2]) {
#pragma unroll
      for (int i = 0; i < kHC / 2; ++i) u[i] = 0;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb, ++i1) {
        const int sl = i1 % W1S;
        wg::mbar_wait(&full1[sl], (i1 / W1S) & 1);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBox / 32; ++kk)
          if (kb * kBox + kk * 32 < C)  // C = 96, 320: the last box's first k-steps
            wg::wgmma_m64n64k32_s8(
                u, wg::desc_sw128(za + kb * F::kZBox + kk * 32, 16, 1024),
                wg::desc_sw128(w1s + sl * F::kW1Box + w1_off + kk * 32, 16, 1024));
        wg::wgmma_commit();
        wg::wgmma_wait<1>();  // all but this box's products are done
        if (kb > 0) {
          if (lane == 0) wg::mbar_arrive(&empty1[(i1 - 1) % W1S]);
        } else if (fc2_pending >= 0) {
          if (lane == 0) wg::mbar_arrive(&empty2[fc2_pending % kW2Stages]);
          fc2_pending = -1;
        }
      }
      wg::wgmma_wait<0>();
      wg::fence_regs(u);
      if (lane == 0) wg::mbar_arrive(&empty1[(i1 - 1) % W1S]);
    };
    // the first of this consumer's 64 units at step st
    auto unit0 = [&](int st) { return st * F::UNITS + (SHARED ? wgi * kHC : 0); };

    // the maxima of the thread's two rows over the block's units: over the
    // quad, then (SHARED) over both consumers; hmax is free again once every
    // consumer has passed a later barrier
    auto row_max = [&](float (&mx)[2]) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      }
      if constexpr (SHARED) {
        if (t4 == 0) {
          hmax[wgi][arow] = mx[0];
          hmax[wgi][arow + 8] = mx[1];
        }
        wg::named_barrier(1, 128 * F::NC);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          mx[hr] = fmaxf(hmax[0][arow + 8 * hr], hmax[1][arow + 8 * hr]);
      }
    };

    // 2. Pass 1: each row's largest u over the whole hidden width (a row's
    //    columns of a product lie on one quad). Its h, |gelu(u_max)|, is the
    //    row's max |h| wherever the GELU grows with u and no negative u's
    //    |h| is larger, which pass 2 checks: the GELU once per hidden element,
    //    in pass 2, and not in both passes.
    //    LAB: each row's max |h| itself (h = uf, no GELU), exact.
    int u[kHC / 2];
    float amax[2] = {LAB ? 0.f : -INFINITY, LAB ? 0.f : -INFINITY};
#pragma unroll 1
    for (int st = 0; st < n_s; ++st) {
      fc1(u);
      const float2* s1p = reinterpret_cast<const float2*>(s1 + unit0(st) + 2 * t4);
      // LAB SHARED, H % 128 == 64: the second consumer's units of the last
      // step lie past H (u = 0 there); their scales are not read
      const bool live = !(LAB && SHARED) || unit0(st) < H;
#pragma unroll
      for (int jj = 0; jj < kHC / 8; ++jj) {
        const float2 sc = live ? __ldg(s1p + 4 * jj) : make_float2(0.f, 0.f);
        if constexpr (LAB) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            amax[hr] = fmaxf(amax[hr], fmaxf(fabsf(hidden_lab(u[4 * jj + 2 * hr], sz[hr], sc.x)),
                                             fabsf(hidden_lab(u[4 * jj + 2 * hr + 1], sz[hr],
                                                              sc.y))));
        } else {
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(b1 + unit0(st) + 2 * t4) + 4 * jj);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            amax[hr] = fmaxf(amax[hr], pre_gelu(u[4 * jj + 2 * hr], sz[hr], sc.x, bb.x));
            amax[hr] = fmaxf(amax[hr], pre_gelu(u[4 * jj + 2 * hr + 1], sz[hr], sc.y, bb.y));
          }
        }
      }
    }
    row_max(amax);
    if constexpr (!LAB) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) amax[hr] = fmaxf(fabsf(gelu_fast(amax[hr])), kAmaxFloor);
    }

    // 3. Pass 2: u again (integer products are exact: the same h), h's codes
    //    with the rows' scales into a swizzled [64, 128] int8 tile (the 128
    //    units of an fc2 step; SHARED: consumer w's 64 at bytes 64 w-, two
    //    tiles by step parity; parts: the consumer's own tile, a step's 64 at
    //    bytes 64 (st % 2)-), then fc2 over its 128 units from W2's slot, in
    //    flight while the next step's fc1 is issued. Then the verdict: if a
    //    row's max |h| is not the amax its codes took, the block runs pass 2
    //    again with the true maxima (the producer streams it again), which
    //    then hold: the codes and y are those of the exact row maxima.
    int yacc[CN / 2];
    float inv[2], sh[2];
#pragma unroll 1
    for (;;) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sh[hr] = LAB ? lab_scale(amax[hr]) : __fmul_rn(amax[hr], kInv127);
        inv[hr] = LAB ? __frcp_rn(sh[hr]) : 127.f / amax[hr];
      }
#pragma unroll
      for (int i = 0; i < CN / 2; ++i) yacc[i] = 0;
      float hmx[2] = {0.f, 0.f};  // the rows' true max |h|
#pragma unroll 1
      for (int st = 0; st < n_s; ++st) {
        fc1(u);  // retires the fc2 in flight, which read its tile
        unsigned char* hq = hqs + (SHARED ? (st % 2) : wgi) * F::kHq;
        const int k0 = SHARED ? wgi * kHC : (st % 2) * kHC;
        const float2* s1p = reinterpret_cast<const float2*>(s1 + unit0(st) + 2 * t4);
        if constexpr (LAB) {  // h = uf; codes from lab_quotient, or the divisions
          uint16_t pk[kHC / 8][2];  // the step's codes, byte pairs of the thread's two rows
          bool near = false;
          const bool live = !SHARED || unit0(st) < H;  // as in pass 1
#pragma unroll
          for (int jj = 0; jj < kHC / 8; ++jj) {
            const float2 sc = live ? __ldg(s1p + 4 * jj) : make_float2(0.f, 0.f);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              pk[jj][hr] = code_pair(
                  __float2int_rn(lab_quotient(hidden_lab(u[4 * jj + 2 * hr], sz[hr], sc.x),
                                              inv[hr], near)),
                  __float2int_rn(lab_quotient(hidden_lab(u[4 * jj + 2 * hr + 1], sz[hr], sc.y),
                                              inv[hr], near)));
          }
          if (__any_sync(0xffffffffu, near)) {
#pragma unroll
            for (int jj = 0; jj < kHC / 8; ++jj) {
              const float2 sc = live ? __ldg(s1p + 4 * jj) : make_float2(0.f, 0.f);
#pragma unroll
              for (int hr = 0; hr < 2; ++hr)
                pk[jj][hr] =
                    code_pair(lab_code(hidden_lab(u[4 * jj + 2 * hr], sz[hr], sc.x), sh[hr]),
                              lab_code(hidden_lab(u[4 * jj + 2 * hr + 1], sz[hr], sc.y), sh[hr]));
            }
          }
#pragma unroll
          for (int jj = 0; jj < kHC / 8; ++jj)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              *reinterpret_cast<uint16_t*>(
                  hq + swz8(16 * warp + g + 8 * hr, k0 + 8 * jj + 2 * t4)) = pk[jj][hr];
        } else {
#pragma unroll
          for (int jj = 0; jj < kHC / 8; ++jj) {
            const float2 sc = __ldg(s1p + 4 * jj);
            const float2 bb =
                __ldg(reinterpret_cast<const float2*>(b1 + unit0(st) + 2 * t4) + 4 * jj);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const float h0 = hidden(u[4 * jj + 2 * hr], sz[hr], sc.x, bb.x);
              const float h1 = hidden(u[4 * jj + 2 * hr + 1], sz[hr], sc.y, bb.y);
              hmx[hr] = fmaxf(hmx[hr], fmaxf(fabsf(h0), fabsf(h1)));
              *reinterpret_cast<uint16_t*>(
                  hq + swz8(16 * warp + g + 8 * hr, k0 + 8 * jj + 2 * t4)) =
                  code_pair(__float2int_rn(__fmul_rn(h0, inv[hr])),
                            __float2int_rn(__fmul_rn(h1, inv[hr])));
            }
          }
        }
        if (!fc2_after(st)) continue;
        wg::fence_proxy_async();  // hq's stores, seen by wgmma
        // SHARED: both consumers' codes in place (and, with it, both consumers'
        // fc2 two steps back done: the tile rewritten next step is free)
        wg::named_barrier(SHARED ? 1 : 2 + wgi, SHARED ? 256 : 128);
        const int sl = i2 % kW2Stages;
        wg::mbar_wait(&full2[sl], (i2 / kW2Stages) & 1);
        wg::wgmma_fence();
        const unsigned char* w2c = w2s + sl * F::kW2Slot + (SHARED ? wgi * CN * kBox : 0);
#pragma unroll
        for (int kk = 0; kk < kBox / 32; ++kk)
          fc2_kstep<CN>(yacc, wg::desc_sw128(hq + kk * 32, 16, 1024), w2c + kk * 32);
        wg::wgmma_commit();
        fc2_pending = i2++;
      }
      wg::wgmma_wait<0>();
      wg::fence_regs(yacc);
      if (lane == 0) wg::mbar_arrive(&empty2[fc2_pending % kW2Stages]);  // the last fc2's W2
      fc2_pending = -1;
      if constexpr (LAB) break;
      row_max(hmx);
      bool off = false;  // a row of this thread whose codes took another amax
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        hmx[hr] = fmaxf(hmx[hr], kAmaxFloor);
        off = off || (m0 + arow + 8 * hr < M && hmx[hr] != amax[hr]);
        amax[hr] = hmx[hr];
      }
      const bool again = wg::named_barrier_or(1, 128 * F::NC, off);
      if (threadIdx.x == 0) {
        verdict = again;
        wg::mbar_arrive(&verdict_bar);
      }
      if (!again) break;
    }

    // 4. y = fp32(acc) * (sh * s2) + b2, one cast to T, the thread's rows and
    //    the consumer's columns
    const int n0 = SHARED ? wgi * CN : blockIdx.y * CN;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t m = m0 + arow + 8 * hr;
      if (m >= M) continue;
#pragma unroll
      for (int jj = 0; jj < CN / 8; ++jj) {
        const int c = n0 + 8 * jj + 2 * t4;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(s2 + c));
        float v0, v1;
        if constexpr (LAB) {  // y = fp32(acc) * sh * s2, left to right
          v0 = __fmul_rn(__fmul_rn(__int2float_rn(yacc[4 * jj + 2 * hr]), sh[hr]), sc.x);
          v1 = __fmul_rn(__fmul_rn(__int2float_rn(yacc[4 * jj + 2 * hr + 1]), sh[hr]), sc.y);
        } else {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c));
          v0 = __fadd_rn(
              __fmul_rn(__int2float_rn(yacc[4 * jj + 2 * hr]), __fmul_rn(sh[hr], sc.x)), bb.x);
          v1 = __fadd_rn(
              __fmul_rn(__int2float_rn(yacc[4 * jj + 2 * hr + 1]), __fmul_rn(sh[hr], sc.y)),
              bb.y);
        }
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(y + m * C + c) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(y + m * C + c) = pack_bf16(v0, v1);
      }
    }
    // LAB SHARED: both consumers are done with the tile's z rows before
    // either writes the next tile's
    if constexpr (LAB && SHARED) wg::named_barrier(1, 128 * F::NC);
  };
  if constexpr (LAB) {
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) tile(static_cast<int64_t>(t) * F::BM);
  } else {
    tile(static_cast<int64_t>(blockIdx.x) * F::BM);
  }
}

}  // namespace i8sm90

// Row 12 (and LAB, the int8 lab): x, y, the codes (16-byte aligned) and the
// fp32 vectors; H % 128 == 0 (LAB: H % 64 == 0).
template <typename T, int C, bool LAB = false>
cudaError_t launch_int8_sm90(const void* x, const float* g, const float* be, const int8_t* w1q,
                             const float* s1, const float* b1, const int8_t* w2q,
                             const float* s2, const float* b2, void* y, int M, int H, float eps,
                             cudaStream_t stream) {
  using F = i8sm90::Form<C>;
  if (H % ((LAB ? 1 : 2) * i8sm90::kHC) != 0) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  constexpr CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap tw1, tw2;
  cudaError_t err = wg::make_tma_2d(&tw1, kU8, w1q, H, C, C, F::UNITS, i8sm90::kBox);
  if (err == cudaSuccess)
    err = wg::make_tma_2d(&tw2, kU8, w2q, C, H, H, F::kW2Rows, i8sm90::kBox);
  auto kernel = i8sm90::ln_mlp_int8_sm90_kernel<T, C, LAB>;
  if (err == cudaSuccess) err = allow_smem(kernel, F::kSmem);
  if (err != cudaSuccess) return err;
  unsigned tiles = static_cast<unsigned>((static_cast<int64_t>(M) + F::BM - 1) / F::BM);
  if constexpr (LAB) {  // persistent: a block per SM at most
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    tiles = tiles < static_cast<unsigned>(sms) ? tiles : static_cast<unsigned>(sms);
  }
  kernel<<<dim3(tiles, F::PARTS), F::kThreads, F::kSmem, stream>>>(
      tw1, tw2, static_cast<const T*>(x), g, be, s1, b1, s2, b2, static_cast<T*>(y), M, H, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mspi
