// The bf16 fused LayerNorm + MLP backward (row 9, and row 14 with the
// LayerNorm compiled out) on Hopper's wgmma and TMA: the gradients of y =
// fc2(gelu(fc1(LN(x)))) on token-major rows x [M, C], for dy [M, C], with w1
// [H, C], w2 [C, H] (H = 4C, a multiple of 64). ln_mlp_bwd.cu routes its bf16
// calls here; fp32 keeps its FMA passes.
//
// Replaces, in bf16: mspi_tpu/ops/pallas/mlp.py::_ln_bwd_impl (kernel
// _ln_bwd_kernel) and ::_bwd_impl (kernel _bwd_kernel); see ln_mlp_bwd.cu.
//
// Numerics are ln_mlp_bwd.cu's: LayerNorm statistics in fp32 with the fast
// variance E[x^2] - mu^2; z rounded to bf16; u = z W1^T + b1 and dh = dy W2
// summed in fp32; exact erf GELU and GELU'; h and du rounded to bf16 where
// they enter a product; dz = du W1 summed in fp32 and the LayerNorm backward
// in fp32; dW1 = du^T z, dW2 = dy^T h, db1 (from the fp32 du), db2, dgamma and
// dbeta summed in fp32.
//
// What bounds it on the card: 10 C H flops per row (u, dh, dz and the two
// weight products) on the tensor cores against ~4 C + 4 H bytes a row of
// operands and the h and du rows the weight products read back: the
// products.
//
// Design: five wgmma products in three kernels and two fixed-order sums.
// A. ln_mlp_bwd_rows_sm90_kernel<C, LN>: BM = 64 NC rows a block (NC = 2
//    consumer warpgroups of 64 rows up to C = 384, 1 above, where two
//    128-row z and dy tiles would not fit in shared memory) and a producer
//    warpgroup, one thread of which streams [64, 64] weight boxes by TMA
//    through a ring of up to 16 slots (3 at C = 384 and 768, where the z and
//    dy tiles fill shared memory) in the order the consumers read them: per
//    64-unit hidden chunk j, W1's boxes along C (K-major, as the forward reads
//    them), then W2's (MN-major: w2 [C, H] read in place through wgmma's
//    transpose bit). The consumers normalise their rows into a swizzled z
//    tile (written out too, for dW1) and copy dy into a second one, then per
//    chunk run u = z W1^T and dh = dy W2 as wgmma m64n64k16 from shared
//    memory into 2 x 32 fp32 registers, and in registers take h = gelu(u +
//    b1) and du = dh gelu'(u + b1), written out in bf16 for the products
//    below, and the chunk's db1 column sums from the fp32 du (shuffles
//    across a warp's rows, then the warpgroup's four warps in order through
//    shared memory). Where the row tiles alone would leave SMs idle (M of
//    a few thousand rows), the hidden chunks are split into parts, a block
//    per (row tile, part) (ops/kernels/ln_mlp.py::bwd_parts). dz does not
//    stay in registers: a 64-row fp32 dz is C / 2
//    registers a thread, 192 at C = 384 beside u and dh (option (ii) of
//    PERF.md: du once to device memory, dz as its own product).
// B. wgemm_f32_sm90_kernel<false>: dz [M, C] (fp32) = du W1, du K-major and w1
//    MN-major, 64 x 128 tiles; then ln_bwd_rows_kernel<C, LN>: per row the
//    LayerNorm backward (dx = (dz g - mean(dz g) - xhat mean(dz g xhat)) rstd,
//    the statistics recomputed from x), and per 64 rows the partial column
//    sums of dgamma, dbeta and db2.
// C. wgemm_f32_sm90_kernel<true>: dW1 = du^T z and dW2 = dy^T h as fp32 partials
//    per segment of 64-row multiples (both operands MN-major through the
//    transpose bits, no transposing copy), then ln_mlp_bwd.cu's
//    sum_segments_kernel over the segments and colsum_kernel over the row
//    tiles' column partials, each in a fixed order.
// No atomics: every output element has one writer and one summation order,
// so two runs are bit-identical.
#pragma once

#include <type_traits>

#include "sm90_wgmma.cuh"

namespace mspi {
namespace {

namespace lnbwd {
using bf16 = __nv_bfloat16;
constexpr int kHC = 64;             // hidden units per chunk
constexpr uint32_t kBox = 64 * 128;  // one [64, 64] bf16 box, 128-byte rows
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

// The row pass's form at width C; ops/kernels/ln_mlp.py::bwd_sm90_form
// mirrors it.
template <int C>
struct Form {
  static constexpr int NC = C <= 384 ? 2 : 1;  // consumer warpgroups of 64 rows
  static constexpr int BM = 64 * NC;
  static constexpr int KB = (C + 63) / 64;     // k boxes of the z and dy tiles
  static constexpr int KSTEPS = C / 16;
  static constexpr uint32_t kTileBox = BM * 128;  // one k box of the z or dy tile
  // the barriers' and the db1 sums' static shared memory
  static constexpr int kStatic = 2 * NC * 4 * kHC * 4 + 128;
  static constexpr int kFixed = 2 * KB * kTileBox + 1024;  // z, dy + alignment slack
  // weight box slots: what shared memory leaves, at most 16 (C = 96: 16, 192:
  // 15, 320: 7, 384: 3, 512: 11, 768: 3). Two chunks' boxes (4 KB of them) let the
  // two consumers drift a chunk apart, one's GELU beside the other's
  // products; a ring of one chunk held them in step.
  static constexpr int kFit = (kSmemLimit - kFixed - kStatic) / static_cast<int>(kBox);
  static constexpr int RING = kFit < 16 ? kFit : 16;
  static constexpr int kSmem = kFixed + RING * kBox;
  static constexpr int kThreads = 128 * (NC + 1);
  // lanes that normalise a row: a lane's 16-byte chunks of x stay at 6 or fewer
  static constexpr int LPR = C <= 192 ? 4 : C <= 384 ? 8 : 16;
  static_assert(RING >= 3 && kSmem + kStatic <= kSmemLimit, "z, dy and the ring fit");
  static_assert(C % (8 * LPR) == 0, "whole 16-byte chunks per lane");
};

// Rows [r0, r0 + 64) of the block's tile (its rows m0 + r) into the swizzled
// tiles: LN(x) with the fast variance (LN; also written to zc unless it is
// null) or x itself
// into zs, dy into ds, both rounded to bf16; zeros past M. LPR lanes take a
// row, each C / (8 LPR) chunks of 16 bytes, c = t + LPR i.
template <int C, bool LN, int LPR>
__device__ __forceinline__ void zdy_rows(const bf16* __restrict__ x,
                                         const bf16* __restrict__ gamma,
                                         const bf16* __restrict__ beta,
                                         const bf16* __restrict__ dy, bf16* __restrict__ zc,
                                         unsigned char* zs, unsigned char* ds, uint32_t box,
                                         int r0, int64_t m0, int M, float eps) {
  constexpr int CH = C / 8 / LPR;        // 16-byte chunks per lane
  constexpr int RPI = 32 / LPR;          // rows per warp step
  static_assert(C % (8 * LPR) == 0, "whole chunks per lane");
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane % LPR;
#pragma unroll 1
  for (int it = 0; it < 16 / RPI; ++it) {
    const int r = r0 + warp * 16 + it * RPI + lane / LPR;
    const int64_t m = m0 + r;
    // chunk c of row r: box c / 8, chunk (c % 8) ^ (r % 8)
    auto at = [&](int c) { return (c / 8) * box + r * 128 + (((c % 8) ^ (r % 8)) << 4); };
#pragma unroll
    for (int i = 0; i < CH; ++i)  // dy as it is, before x's chunks take the registers
      *reinterpret_cast<uint4*>(ds + at(t + LPR * i)) =
          m < M ? __ldg(reinterpret_cast<const uint4*>(dy + m * C) + t + LPR * i)
                : make_uint4(0u, 0u, 0u, 0u);
    uint4 v[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      v[i] = m < M ? __ldg(reinterpret_cast<const uint4*>(x + m * C) + t + LPR * i)
                   : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (LN) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = __low2float(p[e]), b = __high2float(p[e]);
          s += a + b;
          q += a * a + b * b;
        }
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) {  // the row's lanes are LPR neighbours
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      const float mu = s / C;
      const float rstd = rsqrtf(q / C - mu * mu + eps);
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
        if (zc != nullptr && m < M) *(reinterpret_cast<uint4*>(zc + m * C) + t + LPR * i) = v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) *reinterpret_cast<uint4*>(zs + at(t + LPR * i)) = v[i];
  }
}

__device__ __forceinline__ float phi_erf(float v) {  // the normal CDF by the exact erff
  return 0.5f * (1.f + erff(v * 0.70710678118654752f));
}

// Grid (row tiles of BM, parts of the hidden chunks): block (t, p) takes
// chunks [p n_h / P, (p + 1) n_h / P) of its rows (part 0 also writes zc).
// tw1: w1 [H, C] in [64 units, 64 k] boxes; tw2: w2 [C, H] in [64 k, 64
// units] boxes. hc, duc [M, H]; part [ceil(M / 64), 3C + H], this pass
// writing the db1 columns [3C, 3C + H).
template <int C, bool LN>
__global__ void __launch_bounds__(Form<C>::kThreads, 1)
    ln_mlp_bwd_rows_sm90_kernel(const __grid_constant__ CUtensorMap tw1,
                                const __grid_constant__ CUtensorMap tw2,
                                const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                                const bf16* __restrict__ beta, const bf16* __restrict__ b1,
                                const bf16* __restrict__ dy, bf16* __restrict__ zc,
                                bf16* __restrict__ hc, bf16* __restrict__ duc,
                                float* __restrict__ part, int M, int H, float eps) {
  using F = Form<C>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int kRing = F::RING;
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing];
  __shared__ float red[2][F::NC][4][kHC];  // db1: warp sums of a chunk, by chunk parity
  unsigned char* zs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ds = zs + F::KB * F::kTileBox;
  unsigned char* ws = ds + F::KB * F::kTileBox;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * F::BM;
  const int n_h = H / kHC;
  const int j0 = blockIdx.y * n_h / gridDim.y, j1 = (blockIdx.y + 1) * n_h / gridDim.y;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * F::NC);  // one arrival per consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * F::NC) {  // the producer warpgroup; one thread issues
    if (threadIdx.x == 128 * F::NC) {
      for (int j = j0, i = 0; j < j1; ++j) {
        for (int kb = 0; kb < 2 * F::KB; ++kb, ++i) {  // W1's k boxes, then W2's
          const int s = i % kRing;
          if (i >= kRing) wg::mbar_wait(&empty[s], ((i / kRing) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(&full[s], kBox);
          if (kb < F::KB) wg::tma_load_2d(ws + s * kBox, &tw1, &full[s], kb * 64, j * kHC);
          else wg::tma_load_2d(ws + s * kBox, &tw2, &full[s], j * kHC, (kb - F::KB) * 64);
        }
      }
    }
    return;
  }

  const int wgi = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4, g = lane / 4, t4 = lane % 4;
  zdy_rows<C, LN, F::LPR>(x, gamma, beta, dy, blockIdx.y == 0 ? zc : nullptr, zs, ds,
                          F::kTileBox, wgi * 64, m0, M, eps);
  wg::fence_proxy_async();          // the tiles' stores, seen by wgmma
  wg::named_barrier(1 + wgi, 128);  // the warpgroup's 64 rows are in place
  const unsigned char* za = zs + wgi * 64 * 128;  // this warpgroup's rows of each box
  const unsigned char* da = ds + wgi * 64 * 128;
  const int64_t row0 = m0 + wgi * 64 + warp * 16 + g;  // the thread's rows row0, row0 + 8
  float* prow = part + (m0 / 64 + wgi) * static_cast<int64_t>(3 * C + H) + 3 * C;

  const bool rows_in = m0 + wgi * 64 < M;  // the warpgroup has a row to sum for db1

  float u[kHC / 2], dh[kHC / 2];
  int i = 0;          // boxes taken from the ring
  bool held = false;  // box i - 1 is not released yet
  // acc (+)= tile . box over the KB boxes of one product, a commit per box,
  // each box released once the next one's products are queued
  auto product = [&](float(&acc)[kHC / 2], const unsigned char* tile, auto mn_major) {
    constexpr int TB = decltype(mn_major)::value;
#pragma unroll
    for (int kb = 0; kb < F::KB; ++kb, ++i) {
      const int s = i % kRing;
      wg::mbar_wait(&full[s], (i / kRing) & 1);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kb * 4 + kk < F::KSTEPS)  // C = 96: a half last box
          wg::wgmma_m64n64k16_bf16_ss<TB>(
              acc, wg::desc_sw128(tile + kb * F::kTileBox + kk * 32, 16, 1024),
              wg::desc_sw128(ws + s * kBox + (TB ? kk * 2048 : kk * 32), kBox, 1024),
              kb + kk > 0);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();  // all but this box's products are done
      if (held && lane == 0) wg::mbar_arrive(&empty[(i - 1) % kRing]);
      held = true;
    }
  };

#pragma unroll 1
  for (int j = j0; j < j1; ++j) {
    product(u, za, std::integral_constant<int, 0>{});   // u = z W1[chunk]^T
    product(dh, da, std::integral_constant<int, 1>{});  // dh = dy W2[:, chunk]
    wg::wgmma_wait<0>();
    wg::fence_regs(u);
    wg::fence_regs(dh);
    if (lane == 0) wg::mbar_arrive(&empty[(i - 1) % kRing]);
    held = false;
    // h = gelu(u + b1), du = dh gelu'(u + b1); h and du out in bf16; the
    // column sums of the fp32 du over the thread's two rows
    float cs[kHC / 4];
    const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(b1 + j * kHC + 2 * t4);
#pragma unroll
    for (int jj = 0; jj < kHC / 8; ++jj) {
      const float2 bb = __bfloat1622float2(__ldg(bp + 4 * jj));
      cs[2 * jj] = cs[2 * jj + 1] = 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float h2[2], du2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = u[4 * jj + 2 * hr + e] + (e ? bb.y : bb.x);
          const float p = phi_erf(v);
          h2[e] = v * p;
          du2[e] = dh[4 * jj + 2 * hr + e] *
                   (p + v * 0.39894228040143268f * expf(-0.5f * v * v));
          cs[2 * jj + e] += du2[e];  // rows past M: dy = 0, so du = 0
        }
        const int64_t m = row0 + 8 * hr;
        if (m < M) {
          const int64_t at = m * H + j * kHC + 8 * jj + 2 * t4;
          *reinterpret_cast<uint32_t*>(hc + at) = pack_bf16(h2[0], h2[1]);
          *reinterpret_cast<uint32_t*>(duc + at) = pack_bf16(du2[0], du2[1]);
        }
      }
    }
    // db1: the warp's 16 rows (lanes of one t4 differ in g), then the four
    // warps in order
#pragma unroll
    for (int c = 0; c < kHC / 4; ++c) {
      cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], 4);
      cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], 8);
      cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], 16);
    }
    float* rw = red[j & 1][wgi][warp];
    if (g == 0) {
#pragma unroll
      for (int jj = 0; jj < kHC / 8; ++jj) {
        rw[8 * jj + 2 * t4] = cs[2 * jj];
        rw[8 * jj + 2 * t4 + 1] = cs[2 * jj + 1];
      }
    }
    wg::named_barrier(1 + wgi, 128);
    const int c = threadIdx.x % 128;
    if (c < kHC && rows_in) {
      const float(*r)[kHC] = red[j & 1][wgi];
      prow[j * kHC + c] = ((r[0][c] + r[1][c]) + r[2][c]) + r[3][c];
    }
  }
}

// out [seg][Ma, Nb] = the sum over rows k of segment seg of A'[m, k] B[k, n]
// in fp32, one 64 x 128 tile a block: TA, A^T B with A [K, Ma] (MN-major,
// through the transpose bit); else A B with A [Ma, K] (K-major). B [K, Nb]
// row-major (MN-major) either way. Segments are whole 64-row k tiles
// (rows_per_seg % 64 == 0); past K the boxes read zeros. Grid (ceil(Nb /
// 128), ceil(Ma / 64), segments); a producer warpgroup keeps a 4-stage ring
// of [64, 64] A boxes and two [64, 64] B boxes in flight, as
// gemm_bf16_sm90_kernel's.
namespace wgemm {
constexpr int kBM = 64, kBN = 128, kBK = 64, kStages = 4, kThreads = 256;
constexpr uint32_t kStageBytes = 3 * kBox;
constexpr size_t kSmem = kStages * kStageBytes + 1024;
}  // namespace wgemm

template <bool TA>
__global__ void __launch_bounds__(wgemm::kThreads, 2)
    wgemm_f32_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, float* __restrict__ out, int Ma,
                     int Nb, int K, int rows_per_seg) {
  using namespace wgemm;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, seg = blockIdx.z;
  const int k_begin = seg * rows_per_seg;
  const int k_end = min(K, k_begin + rows_per_seg);
  const int n_k = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warpgroup; one thread issues
    if (threadIdx.x == 128) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages, k0 = k_begin + kt * kBK;
        if (kt >= kStages) wg::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        wg::mbar_arrive_expect_tx(&full[s], kStageBytes);
        if (TA) wg::tma_load_2d(st, &ta, &full[s], m0, k0);
        else wg::tma_load_2d(st, &ta, &full[s], k0, m0);
        wg::tma_load_2d(st + kBox, &tb, &full[s], n0, k0);
        wg::tma_load_2d(st + 2 * kBox, &tb, &full[s], n0 + 64, k0);
      }
    }
    return;
  }

  float d[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) d[i] = 0.f;
  const int lane = threadIdx.x % 32;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    wg::mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* at = smem + s * kStageBytes;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // a k-step: 32 bytes of a K-major row, or 16 rows
      wg::wgmma_m64n128k16_bf16_xn<TA ? 1 : 0>(
          d, wg::desc_sw128(at + (TA ? kk * 2048 : kk * 32), TA ? kBox : 16, 1024),
          wg::desc_sw128(at + kBox + kk * 2048, kBox, 1024));
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0 && lane == 0) wg::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(d);

  float* o = out + static_cast<int64_t>(seg) * Ma * Nb;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + (threadIdx.x / 32) * 16 + lane / 4 + 8 * hr;
    if (m >= Ma) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);  // Nb % 8 == 0: n + 1 < Nb with n
      if (n < Nb)
        *reinterpret_cast<float2*>(o + static_cast<int64_t>(m) * Nb + n) =
            make_float2(d[4 * j + 2 * hr], d[4 * j + 2 * hr + 1]);
    }
  }
}

// The LayerNorm backward per row, from dz [M, C] fp32: dx in bf16 (LN: with
// the statistics recomputed from x by the fast variance; else dx = dz), and
// per block of 64 rows (8 a warp) the partial column sums [dgamma | dbeta |
// db2] into part's row blockIdx.x (columns [0, 3C)), summed across the warps
// in order.
template <int C, bool LN>
__global__ void __launch_bounds__(256) ln_bwd_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gamma, const float* __restrict__ dz,
    const bf16* __restrict__ dy, bf16* __restrict__ dx, float* __restrict__ part, int M, int H,
    float eps) {
  constexpr int RN = C / 32;  // columns per lane: lane + 32 n
  __shared__ float red[8][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float pg[RN], pb[RN], pd[RN];
#pragma unroll
  for (int n = 0; n < RN; ++n) pg[n] = pb[n] = pd[n] = 0.f;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int64_t m = static_cast<int64_t>(blockIdx.x) * 64 + warp * 8 + i;
    if (m >= M) break;
    float d[RN];
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      d[n] = dz[m * C + lane + 32 * n];
      pd[n] += __bfloat162float(dy[m * C + lane + 32 * n]);
    }
    if constexpr (!LN) {
#pragma unroll
      for (int n = 0; n < RN; ++n) dx[m * C + lane + 32 * n] = __float2bfloat16(d[n]);
      continue;
    }
    float v[RN], s = 0.f, q = 0.f;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      v[n] = __bfloat162float(x[m * C + lane + 32 * n]);
      s += v[n];
      q += v[n] * v[n];
    }
    const float mu = warp_sum(s) / C;
    const float rstd = rsqrtf(warp_sum(q) / C - mu * mu + eps);
    float xh[RN], dxh[RN], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      xh[n] = (v[n] - mu) * rstd;
      dxh[n] = d[n] * __bfloat162float(gamma[lane + 32 * n]);
      s1 += dxh[n];
      s2 += dxh[n] * xh[n];
      pg[n] += d[n] * xh[n];
      pb[n] += d[n];
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int n = 0; n < RN; ++n)
      dx[m * C + lane + 32 * n] = __float2bfloat16((dxh[n] - m1 - xh[n] * m2) * rstd);
  }
  float* prow = part + static_cast<int64_t>(blockIdx.x) * (3 * C + H);
  auto sum_warps = [&](const float(&p)[RN], int k) {
    __syncthreads();  // red is free
#pragma unroll
    for (int n = 0; n < RN; ++n) red[warp][lane + 32 * n] = p[n];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += 256) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += red[w][c];
      prow[k * C + c] = t;
    }
  };
  sum_warps(pg, 0);
  sum_warps(pb, 1);
  sum_warps(pd, 2);
}

}  // namespace lnbwd

}  // namespace
}  // namespace mspi
