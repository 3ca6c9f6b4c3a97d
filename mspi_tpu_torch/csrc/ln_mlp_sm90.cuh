// The bf16 fused LayerNorm + MLP forward on Hopper's wgmma and TMA, y =
// fc2(gelu(fc1(LN(x)))) on token-major rows x [M, C], the 4C hidden never in
// device memory: K2, the call site of K3, row 10's folded residual and row
// 13's MLP without the LayerNorm (ln_mlp.cu routes their bf16 calls here; fp32
// keeps ln_mlp.cuh's FMA body), and the kernel labs' bf16 bodies at K2's
// widths (lnmlp_lab.cuh: row 20's six and row 21's mlp_bf16).
//
// Replaces, in bf16: mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp (_ln_fwd_kernel),
// ::fused_ln_mlp_t (_ln_fwd_kernel_t), ::fused_ln_mlp_t_res
// (_ln_fwd_kernel_t_res) and ::fused_mlp (_fwd_kernel); see ln_mlp.cu. And
// tools/bench_lnmlp.py::_call's bodies and tools/bench_int8.py's
// _mlp_bf16_kernel; see lnmlp_lab.cu.
//
// What a launch computes is a variant (ln_mlp.cuh's MlpVariant): the
// LayerNorm (none; K2's, the mean and then the centred second moment; the
// labs' var = E[x^2] - mu^2 from one pass; or that with the row sums taken
// on the tensor cores), the GELU or none, the biases or neither, the folded
// residual, and how finely a chunk's GELU is sliced between the next chunk's
// fc1 products (PIPE; 0: the form's own schedule, below).
//
// Numerics are ln_mlp.cuh's: LayerNorm statistics in fp32, z rounded to bf16
// before fc1, fc1 accumulated in fp32, h = gelu(u + b1) (the exact erff)
// rounded to bf16 before fc2, fc2 accumulated in fp32, y rounded once (row
// 10: shortcut + res_gamma * y in fp32, the product and the sum rounded
// separately, then one rounding).
//
// What bounds it on the card: 16 C^2 flops per row (fc1 and fc2 at H = 4C)
// on the tensor cores, against 4 C bytes of x and y: the products. Each block
// also streams the weights it multiplies from L2, 8 C (C + CN) bytes per
// block, so rows per block set the flops per L2 byte; and each hidden
// element costs an erff GELU of some 20 FP32 instructions beside its 4 C
// tensor flops, which at C = 96 take about as long as the products.
//
// Design (Form<C> below):
// - A block owns BM = 64 NC rows (NC consumer warpgroups of 64 rows each:
//   2 up to C = 512, 1 at C = 768, where one 128-row z tile would not fit in
//   shared memory) and CN columns of y: all C up to 192, else C / CN column
//   parts of 160 (C = 320, UniFormer-B's stage 3: 256 does not divide it),
//   192 or 256 (a 64-row fp32 y of C = 384 columns would take 192 of a
//   thread's registers beside u and h). Each part recomputes fc1: 1.5x the
//   products at C = 320, 384 and 512, 2x at C = 768.
// - The consumers normalise their own 64 rows straight into the z tile in
//   shared memory, written in the 128-byte swizzle that wgmma reads as its
//   K-major A operand (sm90_wgmma.cuh), 4 or 8 lanes a row with 16-byte
//   loads; rows past M are zeros.
// - One thread of a producer warpgroup keeps two TMA rings full in the order
//   the consumers read them: per 64-unit hidden chunk, W1's [64, 64] boxes
//   along C (4 slots, 8 KiB each) and one [CN, 64] box of W2 (2 slots). Both
//   weights are K-major as stored (w1 [H, C], w2 [C, H]), so wgmma reads them
//   without the transpose bit. The producer drops to 24 registers
//   (setmaxnreg) and the two consumers rise to 240, FlashAttention-3's split
//   (2 x 240 + 24 = 3 x 168, the launch's share).
// - Per chunk each consumer runs fc1 as wgmma m64n64k16 (A = z from shared
//   memory) into u [64, 64] in fp32 registers, one commit per W1 box,
//   releasing a box once the next one's products are queued; adds b1,
//   applies the GELU and repacks h as the A fragments of fc2 in registers
//   (an m64 accumulator's rows are laid out as mma.sync's A fragment, as
//   FlashAttention-3 feeds P to P V); then fc2 as wgmma m64nCNk16 with A from
//   registers into y [64, CN], left in flight while the next chunk's fc1 is
//   issued. Up to C = 192 (Form::PIPE), where the GELU costs as much as the
//   products, chunk j's GELU runs in slices between the W1 boxes of chunk
//   j + 1's fc1 (u in two register sets), so one warpgroup keeps the FP32
//   pipes and the tensor cores busy at once; above, one u. Two consumers on
//   one SM also overlap one's GELU with the other's products. The W1 box
//   loop is unrolled: a wgmma under a run-time branch (C = 96's half box)
//   made ptxas serialise every wgmma of the warpgroup. A variant may slice
//   finer (the lab's pipe4: each W1 box's products in two commit groups, a
//   GELU slice after each).
// - The labs' mxu_stats LayerNorm: the raw rows go into the z tile, their
//   sums come from two wgmma products on it (X X^T's diagonal and X 1 against
//   a ones box), and each thread normalises its chunks in place.
// - Epilogue: y + b2 (or the folded residual) rounded to bf16 in registers
//   and stored as 4-byte pairs, guarded past M.
// Every output element has one writer and one summation order: two runs are
// bit-identical.
#pragma once

#include <type_traits>

#include "ln_mlp.cuh"
#include "sm90_wgmma.cuh"

namespace mspi {
namespace {

namespace lnsm90 {
constexpr int kHC = 64;            // hidden units per chunk
constexpr int kBox = 64;           // k per box: one 128-byte swizzle row of bf16
constexpr int kW2Stages = 2;       // W2 ring slots
constexpr uint32_t kW1Box = kHC * 128;  // one [64 units, 64 k] box of W1
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr int kStatic = 256;        // the barriers' static shared memory, rounded up
constexpr uint32_t kOnesBox = 8 * 128;  // kLnTensorStats: [8, 64] bf16 ones, X 1's B

// The launch form at width C; ops/kernels/ln_mlp.py::sm90_form mirrors it
// (lab.py::lab_sm90_form for the labs' variants).
template <int C, int LN = kLnTwoPass>
struct Form {
  static constexpr int CN = C <= 192 ? C : C == 320 ? 160 : C == 384 ? 192 : 256;  // y columns
  static constexpr int PARTS = C / CN;                             // column parts
  static constexpr int NC = C <= 512 ? 2 : 1;  // consumer warpgroups, 64 rows each
  static constexpr int BM = 64 * NC;           // rows per block
  static constexpr int KB = (C + kBox - 1) / kBox;  // k boxes of z and of a W1 chunk
  static constexpr int KSTEPS = C / 16;
  static constexpr uint32_t kZBox = BM * 128;  // one k box of the z tile
  static constexpr uint32_t kW2Box = CN * 128;  // one [CN, 64 units] box of W2
  static constexpr uint32_t kOnes = LN == kLnTensorStats ? kOnesBox : 0;
  static constexpr int kFixed = KB * kZBox + kW2Stages * kW2Box + kOnes + 1024;  // + alignment
  // W1 ring slots: 4, or what shared memory leaves (C = 512: 4). Rings of
  // up to 12 slots ran no faster, and 8 at C = 768 18% slower (PERF.md).
  static constexpr int W1S = (kSmemLimit - kStatic - kFixed) / kW1Box < 4
                                 ? (kSmemLimit - kStatic - kFixed) / kW1Box
                                 : 4;
  static constexpr int kSmem = kFixed + W1S * kW1Box;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kConsumerRegs = 240;  // NC = 2: 2 x 240 + 24 (producer) per 128 threads
  // chunk j's GELU and fc2 overlap chunk j + 1's fc1 (two u register sets)
  // up to C = 192; at C = 384 that form spilled 16 bytes at 240 registers
  // and ran 9% slower than one u (PERF.md)
  static constexpr bool PIPE = C <= 192;
  static_assert(C % 32 == 0 && C % CN == 0 && CN % 8 == 0 && CN <= 256, "widths");
  static_assert(W1S >= 2, "the W1 ring needs two slots");
  static_assert(kZBox % 1024 == 0 && kW2Box % 1024 == 0, "swizzle atoms stay aligned");
};

// The GELU slices of a chunk that run between the next chunk's fc1 products:
// PIPE, or the form's own (one a W1 box where Form::PIPE); 0: one u, the
// GELU after its own fc1.
template <int C, int PIPE>
__host__ __device__ constexpr int gelu_slices() {
  return PIPE ? PIPE : Form<C>::PIPE ? Form<C>::KB : 0;
}

// fc2's product at y's width
template <int CN>
__device__ __forceinline__ void fc2_wgmma(float (&y)[CN / 2], const uint32_t (&a)[4],
                                          uint64_t db) {
  if constexpr (CN == 96) wg::wgmma_m64n96k16_bf16_rs(y, a, db);
  else if constexpr (CN == 160) wg::wgmma_m64n160k16_bf16_rs(y, a, db);
  else if constexpr (CN == 192) wg::wgmma_m64n192k16_bf16_rs(y, a, db);
  else wg::wgmma_m64n256k16_bf16_rs(y, a, db);
}

// Rows [r0, r0 + 64) of the block's tile (its rows m0 + r) into the swizzled
// z tile: LN(x) with fp32 statistics (kLnTwoPass, kLnFastVar), or x itself
// (kLnNone, and kLnTensorStats, which tensor_stats_ln normalises after),
// rounded to bf16; zeros past M. LPR lanes take a row, each CH 16-byte
// chunks c = t + LPR i.
template <int C, int LN>
__device__ __forceinline__ void z_rows(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                                       const bf16* __restrict__ beta, unsigned char* zs,
                                       uint32_t zbox, int r0, int64_t m0, int M, float eps) {
  constexpr int LPR = C <= 384 ? 4 : 8;  // lanes per row
  constexpr int CH = C / 8 / LPR;        // 16-byte chunks per lane
  constexpr int RPI = 32 / LPR;          // rows per warp step
  static_assert(C % (8 * LPR) == 0, "whole chunks per lane");
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane % LPR;
#pragma unroll 1
  for (int it = 0; it < 16 / RPI; ++it) {
    const int r = r0 + warp * 16 + it * RPI + lane / LPR;
    const int64_t m = m0 + r;
    uint4 v[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      v[i] = m < M ? __ldg(reinterpret_cast<const uint4*>(x + m * C) + t + LPR * i)
                   : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (LN == kLnTwoPass || LN == kLnFastVar) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = __low2float(p[e]), b = __high2float(p[e]);
          s += a + b;
          if constexpr (LN == kLnFastVar) q += a * a + b * b;
        }
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        if constexpr (LN == kLnFastVar) q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      const float mu = s / C;
      float var;
      if constexpr (LN == kLnFastVar) {
        var = q / C - mu * mu;
      } else {
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d0 = __low2float(p[e]) - mu, d1 = __high2float(p[e]) - mu;
            q += d0 * d0 + d1 * d1;
          }
        }
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
        var = q / C;
      }
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gamma) + t + LPR * i);
        const uint4 bv = __ldg(reinterpret_cast<const uint4*>(beta) + t + LPR * i);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bv);
        uint32_t z[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          z[e] = pack_bf16(
              (__low2float(p[e]) - mu) * rstd * __low2float(gp[e]) + __low2float(bp[e]),
              (__high2float(p[e]) - mu) * rstd * __high2float(gp[e]) + __high2float(bp[e]));
        v[i] = m < M ? make_uint4(z[0], z[1], z[2], z[3]) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {  // chunk c of row r: box c / 8, chunk (c % 8) ^ (r % 8)
      const int c = t + LPR * i;
      *reinterpret_cast<uint4*>(zs + (c / 8) * zbox + r * 128 + (((c % 8) ^ (r % 8)) << 4)) =
          v[i];
    }
  }
}

// kLnTensorStats, once z_rows put the warpgroup's raw rows [r0, r0 + 64)
// into the z tile: their sums on the tensor cores, bf16 x bf16 products
// exact in fp32 (the lab's _k_mxu_stats takes both means as products with a
// 1/C column): sum x^2 on the diagonal of X X^T (m64n64k16 with the tile as
// A and, K-major as a W1 box is read, as B) and sum x in X 1 (m64n8k16
// against the ones box). Then var = E[x^2] - mu^2, and each thread
// normalises in place chunks t, t + 4, ... of its accumulator rows 16 warp +
// g and + 8 (4 lanes a row, as z_rows gives them up to C = 384; above, z_rows
// gives each row 8 lanes, and its stores are complete at the barrier before
// this). bar: the warpgroup's named barrier.
template <int C>
__device__ __forceinline__ void tensor_stats_ln(const bf16* __restrict__ gamma,
                                                const bf16* __restrict__ beta, unsigned char* zs,
                                                uint32_t zbox, const unsigned char* ones, int r0,
                                                int64_t m0, int M, float eps, int bar) {
  constexpr int KSTEPS = C / 16, CH = C / 32;  // k-steps; 16-byte chunks a lane
  static_assert(C % 32 == 0, "whole 16-byte chunks on the accumulator's quad");
  // the normalisation's chunks: all in flight up to C = 192; above, two at a
  // time (every chunk's x, gamma and beta loads at once spilled at C = 384)
  constexpr int UNROLL = C <= 192 ? CH : 2;
  constexpr int KG = C <= 384 ? KSTEPS : 8;  // whole 64-k boxes a group
  static_assert(KSTEPS % KG == 0, "whole commit groups");
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane / 4, t = lane % 4;
  const unsigned char* za = zs + r0 * 128;
  float q[32], s[4];
  // the k-steps in commit groups of KG, each waited for: up to C = 384 one
  // group; above, ptxas computed every k-step's descriptor ahead of the
  // products and spilled, so each group's tile address passes through an
  // opaque move after the previous group's wait
#pragma unroll
  for (int k0 = 0; k0 < KSTEPS; k0 += KG) {
    const unsigned char* zg = za + (k0 / 4) * zbox;
    if constexpr (KG < KSTEPS) {
      uint64_t v = reinterpret_cast<uint64_t>(zg);
      asm volatile("mov.b64 %0, %0;\n" : "+l"(v));
      zg = reinterpret_cast<const unsigned char*>(v);
    }
    wg::wgmma_fence();
#pragma unroll
    for (int k = k0; k < k0 + KG; ++k) {
      const uint64_t a = wg::desc_sw128(zg + ((k - k0) / 4) * zbox + (k % 4) * 32, 16, 1024);
      wg::wgmma_m64n64k16_bf16_ss(q, a, a, k > 0);
      wg::wgmma_m64n8k16_bf16_ss(s, a, wg::desc_sw128(ones + (k % 4) * 32, 16, 1024), k > 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
  }
  wg::fence_regs(q);
  wg::fence_regs(s);
  wg::named_barrier(bar, 128);  // every warp's products read the tile: rewrite it
  // X X^T[R][R] of rows R = 16 warp + g (+ 8): column R lies on the quad's
  // lane g / 2, element g % 2 of column tile 2 warp (+ 1)
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w)
    if (w == warp) {
      d0 = (g & 1) ? q[8 * w + 1] : q[8 * w];
      d1 = (g & 1) ? q[8 * w + 7] : q[8 * w + 6];
    }
  const int src = (lane & ~3) | (g >> 1);
  const float sq[2] = {__shfl_sync(0xffffffffu, d0, src), __shfl_sync(0xffffffffu, d1, src)};
  const float sx[2] = {s[0], s[2]};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + warp * 16 + 8 * hr + g;
    const float mu = sx[hr] * (1.f / C);
    const float rstd = rsqrtf(sq[hr] * (1.f / C) - mu * mu + eps);
    const bool live = m0 + r < M;
#pragma unroll UNROLL
    for (int i = 0; i < CH; ++i) {
      const int c = t + 4 * i;
      uint4* p =
          reinterpret_cast<uint4*>(zs + (c / 8) * zbox + r * 128 + (((c % 8) ^ (r % 8)) << 4));
      const uint4 xv = *p;
      const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gamma) + c);
      const uint4 bv = __ldg(reinterpret_cast<const uint4*>(beta) + c);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bv);
      uint32_t z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        z[e] = pack_bf16(
            (__low2float(xp[e]) - mu) * rstd * __low2float(gp[e]) + __low2float(bp[e]),
            (__high2float(xp[e]) - mu) * rstd * __high2float(gp[e]) + __high2float(bp[e]));
      *p = live ? make_uint4(z[0], z[1], z[2], z[3]) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Grid (row tiles of BM, column parts). tw1: w1 [H, C] in [64, 64] boxes;
// tw2: w2 [C, H] in [CN, 64] boxes. LN, GELU, BIAS, RES, PIPE: the variant.
template <int C, int LN, bool GELU, bool BIAS, bool RES, int PIPE>
__global__ void __launch_bounds__(Form<C, LN>::kThreads, 1)
    ln_mlp_sm90_kernel(const __grid_constant__ CUtensorMap tw1,
                       const __grid_constant__ CUtensorMap tw2, const bf16* __restrict__ x,
                       const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                       const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                       const bf16* __restrict__ shortcut, const bf16* __restrict__ res_gamma,
                       bf16* __restrict__ y, int M, int H, float eps) {
  using F = Form<C, LN>;
  constexpr int W1S = F::W1S, CN = F::CN;
  constexpr int SL = gelu_slices<C, PIPE>();  // GELU slices a chunk beside fc1
  constexpr int G = SL ? SL / F::KB : 1;      // fc1 commit groups a W1 box
  static_assert(PIPE == 0 || (F::PIPE && PIPE % F::KB == 0 && PIPE <= kHC / 8),
                "a finer overlap: two u register sets, whole groups a box");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full1[W1S], empty1[W1S], full2[kW2Stages],
      empty2[kW2Stages];
  unsigned char* zs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* w1s = zs + F::KB * F::kZBox;
  unsigned char* w2s = w1s + W1S * kW1Box;
  unsigned char* ones = w2s + kW2Stages * F::kW2Box;  // kLnTensorStats
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * F::BM;
  const int n0 = blockIdx.y * CN;
  const int n_h = H / kHC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W1S; ++s) {
      wg::mbar_init(&full1[s], 1);
      wg::mbar_init(&empty1[s], 4 * F::NC);  // one arrival per consumer warp
    }
    for (int s = 0; s < kW2Stages; ++s) {
      wg::mbar_init(&full2[s], 1);
      wg::mbar_init(&empty2[s], 4 * F::NC);
    }
    wg::mbar_fence_init();
  }
  if constexpr (LN == kLnTensorStats) {  // bf16 ones (0x3F80), seen by wgmma
    if (threadIdx.x < kOnesBox / 16)
      reinterpret_cast<uint4*>(ones)[threadIdx.x] =
          make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    wg::fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * F::NC) {  // the producer warpgroup; one thread issues
    if constexpr (F::NC > 1) wg::setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * F::NC) {
      for (int j = 0, i1 = 0; j < n_h; ++j) {
        for (int kb = 0; kb < F::KB; ++kb, ++i1) {
          const int s = i1 % W1S;
          if (i1 >= W1S) wg::mbar_wait(&empty1[s], ((i1 / W1S) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(&full1[s], kW1Box);
          wg::tma_load_2d(w1s + s * kW1Box, &tw1, &full1[s], kb * kBox, j * kHC);
        }
        const int s = j % kW2Stages;
        if (j >= kW2Stages) wg::mbar_wait(&empty2[s], ((j / kW2Stages) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(&full2[s], F::kW2Box);
        wg::tma_load_2d(w2s + s * F::kW2Box, &tw2, &full2[s], j * kHC, n0);
      }
    }
    return;
  }
  if constexpr (F::NC > 1) wg::setmaxnreg_inc<F::kConsumerRegs>();

  const int wgi = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4, g = lane / 4, t4 = lane % 4;
  z_rows<C, LN>(x, gamma, beta, zs, F::kZBox, wgi * 64, m0, M, eps);
  wg::fence_proxy_async();              // z's stores, seen by wgmma
  wg::named_barrier(1 + wgi, 128);      // the warpgroup's 64 rows are in place
  if constexpr (LN == kLnTensorStats) {
    tensor_stats_ln<C>(gamma, beta, zs, F::kZBox, ones, wgi * 64, m0, M, eps, 1 + wgi);
    wg::fence_proxy_async();
    wg::named_barrier(1 + wgi, 128);
  }

  float yacc[CN / 2];
#pragma unroll
  for (int i = 0; i < CN / 2; ++i) yacc[i] = 0.f;
  const unsigned char* za = zs + wgi * 64 * 128;  // this warpgroup's rows of each z box
  uint32_t hf[kHC / 16][4];  // h of one chunk as fc2's A fragments
  int i1 = 0;                // W1 boxes taken from the ring
  int fc2_issued = 0, fc2_retired = 0;
  // after a wait that completed every fc2 issued so far: release the W2 box
  // of the one in flight, if any
  auto retire_fc2 = [&]() {
    if (fc2_retired < fc2_issued) {
      if (lane == 0) wg::mbar_arrive(&empty2[fc2_retired % kW2Stages]);
      ++fc2_retired;
    }
  };

  // h = act(u + b1) in bf16 (the GELU and b1 as the variant has them) for
  // u's column tiles [jj0, jj1) of chunk j, repacked as fc2's A fragments:
  // k-step kk takes column tiles 2 kk (a0, a1) and 2 kk + 1 (a2, a3)
  auto act = [&](const float(&u)[kHC / 2], int j, int jj0, int jj1) {
    auto f = [](float v, float b) {
      if constexpr (BIAS) v += b;
      if constexpr (GELU) v = gelu_erf(v);
      return v;
    };
#pragma unroll
    for (int jj = jj0; jj < jj1; ++jj) {
      float2 bb = make_float2(0.f, 0.f);
      if constexpr (BIAS)
        bb = __bfloat1622float2(
            __ldg(reinterpret_cast<const __nv_bfloat162*>(b1 + j * kHC + 2 * t4) + 4 * jj));
      hf[jj / 2][2 * (jj % 2)] = pack_bf16(f(u[4 * jj], bb.x), f(u[4 * jj + 1], bb.y));
      hf[jj / 2][2 * (jj % 2) + 1] = pack_bf16(f(u[4 * jj + 2], bb.x), f(u[4 * jj + 3], bb.y));
    }
  };
  // y += h W2[n0 : n0 + CN, chunk j]^T, left in flight
  auto fc2 = [&](int j) {
    const int s2 = j % kW2Stages;
    wg::mbar_wait(&full2[s2], (j / kW2Stages) & 1);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHC / 16; ++kk)
      fc2_wgmma<CN>(yacc, hf[kk], wg::desc_sw128(w2s + s2 * F::kW2Box + kk * 32, 16, 1024));
    wg::wgmma_commit();
    ++fc2_issued;
  };
  // One step: fc1 of chunk jn into un (FC1), a W1 box's products in G
  // commit groups, and with it the activation of chunk jc from uc in SL
  // slices, one after each group (ACT), each slice running on the FP32 pipes
  // while the group's products are on the tensor cores; then fc2 of chunk
  // jc (ACT). The first group's wait retires the fc2 in flight, whose h
  // registers the activation rewrites; a box is released once the next
  // box's first group is queued. FC1 and ACT are compile-time
  // (std::bool_constant), and so is every branch around a wgmma once the
  // loops unroll: a wgmma under a run-time branch makes ptxas serialise the
  // warpgroup's wgmma.
  auto step = [&](float(&un)[kHC / 2], int jn, const float(&uc)[kHC / 2], int jc, auto fc1,
                  auto act_cur) {
    constexpr bool FC1 = decltype(fc1)::value, ACT = decltype(act_cur)::value;
    if constexpr (ACT && !FC1) {  // the last chunk: retire the fc2 in flight first
      wg::wgmma_wait<0>();
      retire_fc2();
    }
#pragma unroll
    for (int kb = 0; kb < F::KB; ++kb) {
      const int s = i1 % W1S;
      if constexpr (FC1) wg::mbar_wait(&full1[s], (i1 / W1S) & 1);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if constexpr (FC1) {
          // the box's k-steps [gi n / G, (gi + 1) n / G) (C = 96: a half last box)
          const int n = min(kBox / 16, F::KSTEPS - kb * (kBox / 16));
          wg::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBox / 16; ++kk)
            if (kk >= gi * n / G && kk < (gi + 1) * n / G)
              wg::wgmma_m64n64k16_bf16_ss(
                  un, wg::desc_sw128(za + kb * F::kZBox + kk * 32, 16, 1024),
                  wg::desc_sw128(w1s + s * kW1Box + kk * 32, 16, 1024), kb + kk > 0);
          wg::wgmma_commit();
          wg::wgmma_wait<1>();  // all but this group's products are done
          if (kb == 0 && gi == 0) retire_fc2();
          else if (gi == 0 && lane == 0) wg::mbar_arrive(&empty1[(i1 - 1) % W1S]);
        }
        if constexpr (ACT) {
          const int sl = kb * G + gi;
          act(uc, jc, sl * (kHC / 8) / SL, (sl + 1) * (kHC / 8) / SL);
        }
      }
      if constexpr (FC1) ++i1;
    }
    if constexpr (FC1) {
      wg::wgmma_wait<0>();
      wg::fence_regs(un);
      if (lane == 0) wg::mbar_arrive(&empty1[(i1 - 1) % W1S]);
    }
    if constexpr (ACT) fc2(jc);
  };
  constexpr std::true_type kYes{};
  constexpr std::false_type kNo{};

  float ua[kHC / 2];
  if constexpr (SL > 0) {
    // chunk j's activation and fc2 overlap chunk j + 1's fc1: u in two
    // register sets
    float ub[kHC / 2];
    step(ua, 0, ub, 0, kYes, kNo);
    int j = 0;
#pragma unroll 1
    for (; j + 2 < n_h; j += 2) {
      step(ub, j + 1, ua, j, kYes, kYes);
      step(ua, j + 2, ub, j + 1, kYes, kYes);
    }
    if (j + 1 < n_h) {  // chunks j (in ua) and j + 1 left
      step(ub, j + 1, ua, j, kYes, kYes);
      step(ua, 0, ub, j + 1, kNo, kYes);
    } else {  // chunk j left
      step(ub, 0, ua, j, kNo, kYes);
    }
  } else {
    // one u: fc1, then its activation and fc2
#pragma unroll 1
    for (int j = 0; j < n_h; ++j) {
      step(ua, j, ua, j, kYes, kNo);
      act(ua, j, 0, kHC / 8);
      fc2(j);
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(yacc);

  // y = acc + b2 (or shortcut + res_gamma * y), rows g and g + 8 of the warp's 16
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t m = m0 + wgi * 64 + warp * 16 + g + 8 * hr;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < CN / 8; ++jj) {
      const int c = n0 + 8 * jj + 2 * t4;
      float v0 = yacc[4 * jj + 2 * hr], v1 = yacc[4 * jj + 2 * hr + 1];
      if constexpr (BIAS) {
        const float2 bb =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + c));
        v0 += bb.x;
        v1 += bb.y;
      }
      if constexpr (RES) {
        const float2 sc =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(shortcut + m * C + c));
        const float2 rg =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res_gamma + c));
        v0 = __fadd_rn(sc.x, __fmul_rn(rg.x, v0));
        v1 = __fadd_rn(sc.y, __fmul_rn(rg.y, v1));
      }
      *reinterpret_cast<uint32_t*>(y + m * C + c) = pack_bf16(v0, v1);
    }
  }
}

}  // namespace lnsm90

// The bf16 launch of variant V (MlpVariant): K2 (kLnTwoPass), row 13
// (kLnNone), row 10 (RES) and the labs' bodies; x, y, the weights and (RES)
// shortcut and res_gamma 16-byte aligned, H % 64 == 0.
template <int C, class V>
cudaError_t launch_ln_mlp_sm90(const MlpArgs& a, cudaStream_t stream) {
  using F = lnsm90::Form<C, V::LN>;
  if (a.H % lnsm90::kHC) return cudaErrorInvalidValue;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tw1, tw2;
  cudaError_t err = wg::make_tma_2d(&tw1, kBf16, a.w1, a.H, C, 2ull * C, lnsm90::kHC,
                                    lnsm90::kBox);
  if (err == cudaSuccess)
    err = wg::make_tma_2d(&tw2, kBf16, a.w2, C, a.H, 2ull * a.H, F::CN, lnsm90::kBox);
  auto kernel = lnsm90::ln_mlp_sm90_kernel<C, V::LN, V::GELU, V::BIAS, V::RES, V::PIPE>;
  if (err == cudaSuccess) err = allow_smem(kernel, F::kSmem);
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>((static_cast<int64_t>(a.M) + F::BM - 1) / F::BM);
  kernel<<<dim3(tiles, F::PARTS), F::kThreads, F::kSmem, stream>>>(
      tw1, tw2, static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.g),
      static_cast<const bf16*>(a.be), static_cast<const bf16*>(a.b1),
      static_cast<const bf16*>(a.b2), static_cast<const bf16*>(a.sc),
      static_cast<const bf16*>(a.rg), static_cast<bf16*>(a.y), a.M, a.H, a.eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mspi
