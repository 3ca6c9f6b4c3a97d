// The fused (LayerNorm +) MLP forward bodies of fp32 K2, rows 10 and 13
// (ln_mlp.cu; their bf16 calls run ln_mlp_sm90.cuh's wgmma body) and of the
// kernel labs (lnmlp_lab.cu, bf16 on the WMMA body below): y =
// fc2(act(fc1(norm(x)))) on token-major rows x [M, C].
//
// A variant (MlpVariant) fixes at compile time what the body computes:
//   LN    kLnNone: z = x; kLnTwoPass: K2's LayerNorm (mean, then the centred
//         second moment); kLnFastVar: var = E[x^2] - mu^2 from one pass (the
//         JAX package's _ln_f32, the labs' LN); kLnTensorStats: the same
//         statistics with the row sums taken on the tensor cores (bf16 only);
//   GELU  exact erf GELU between the products, or none;
//   BIAS  b1 and b2 added, or neither;
//   RES   the residual-folded epilogue shortcut + res_gamma * y (row 10);
//   PIPE  1, or the block's row tile split into PIPE groups whose fc1
//         products are issued before the previous group's activation (bf16
//         only; the labs' pipe2/pipe4).
//
// Numerics follow the TPU kernels: LayerNorm statistics in fp32, z rounded
// to the storage type before fc1, fc1 accumulated in fp32, h = act(u + b1)
// rounded to the storage type before fc2, fc2 accumulated in fp32, y
// rounded once on the way out. The GELU is the exact erff: the TPU runs a
// degree-8 (bf16) or degree-16 (fp32) polynomial fit of erf, within 7.7e-4
// and 2e-7 of it.
//
// What bounds it on the card: the two matmuls, 4*C*H flops per row against
// 2*C values read and written per row -- at C >= 96 the arithmetic (and the
// weights streaming from L2 once per row tile), not device memory.
//
// Design: one block per tile of rows. The normalised tile z [rows, C] stays
// in shared memory for the whole block; the hidden dimension is walked in
// chunks of HC = 64 units: u = z W1[chunk]^T, h = act(u + b1) into shared
// memory, y += h W2[:, chunk]^T. The [rows, C] fp32 accumulator stays in
// registers, so the hidden activation never reaches device memory and y
// is written once.
//   bf16: both matmuls on the tensor cores (WMMA 16x16x16, fp32
//         accumulate); weight fragments load straight from global memory
//         (L2/L1), each warp owning 16-column slices of y for every 16-row
//         tile of the block, so one weight fragment feeds 2 or 4 products.
//         64 rows per block for C <= 384, 32 above (register budget of the
//         accumulator).
//   fp32: 32 rows per block on the fp32 FMA pipes (tensor cores would round
//         to TF32), weights staged through shared memory, 4 rows x C/32
//         columns per thread.
// Shared memory is at most 164 KB (fp32, C = 768), inside the 227 KB a block
// may use.
#pragma once

#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace mspi {
namespace {

constexpr int TM = 32;       // rows per block
constexpr int HC = 64;       // hidden units per chunk
constexpr int KS = 32;       // W1 columns (input features) staged per step
constexpr int JS = 16;       // W2 columns (hidden units) staged per step
constexpr int THREADS = 256; // 8 warps

constexpr int kLnNone = 0;
constexpr int kLnTwoPass = 1;
constexpr int kLnFastVar = 2;
constexpr int kLnTensorStats = 3;

template <int LN_, bool GELU_ = true, bool BIAS_ = true, bool RES_ = false, int PIPE_ = 1>
struct MlpVariant {
  static constexpr int LN = LN_;
  static constexpr bool GELU = GELU_;
  static constexpr bool BIAS = BIAS_;
  static constexpr bool RES = RES_;
  static constexpr int PIPE = PIPE_;
};

// Pointers and sizes of one launch. g/be are read only with a LayerNorm,
// b1/b2 only with BIAS, sc/rg only with RES.
struct MlpArgs {
  const void *x, *g, *be, *w1, *b1, *w2, *b2, *sc, *rg;
  void* y;
  int M, H;
  float eps;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// The LayerNorm stage (LN != kLnTensorStats) of rows row0 .. row0+ROWS-1 of x
// into zs (row pitch ldz), one warp per row: fp32 statistics, the result
// rounded to the storage type T and stored as Z. Rows at or past M are zeros.
template <typename T, typename Z, int C, int ROWS, int LN>
__device__ __forceinline__ void layernorm_tile(const T* __restrict__ x,
                                               const T* __restrict__ gamma,
                                               const T* __restrict__ beta, Z* zs, int ldz,
                                               int64_t row0, int M, float eps) {
  static_assert(LN == kLnNone || LN == kLnTwoPass || LN == kLnFastVar, "LN stage");
  constexpr int PER = C / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int64_t m = row0 + r;
    Z* zr = zs + r * ldz;
    if (m >= M) {
      for (int c = lane; c < C; c += 32) zr[c] = from_f<Z>(0.f);
      continue;
    }
    const T* xr = x + m * C;
    float v[PER];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = to_f(xr[lane + 32 * i]);
      s += v[i];
      if constexpr (LN == kLnFastVar) q += v[i] * v[i];
    }
    if constexpr (LN == kLnNone) {
#pragma unroll
      for (int i = 0; i < PER; ++i) zr[lane + 32 * i] = from_f<Z>(v[i]);
    } else {
      const float mu = warp_sum(s) / C;
      float var;
      if constexpr (LN == kLnFastVar) {
        var = warp_sum(q) / C - mu * mu;
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) q += (v[i] - mu) * (v[i] - mu);
        var = warp_sum(q) / C;
      }
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        zr[c] = from_f<Z>(round_to<T>((v[i] - mu) * rstd * to_f(gamma[c]) + to_f(beta[c])));
      }
    }
  }
}

template <int C>
constexpr size_t ln_mlp_smem_floats() {
  return static_cast<size_t>(TM) * C        // zs: normalised rows
         + static_cast<size_t>(KS) * (HC + 1)  // w1s: W1 slice, padded pitch
         + static_cast<size_t>(TM) * HC        // hs: gelu(u) chunk
         + static_cast<size_t>(JS) * (C + 1);  // w2s: W2 slice, padded pitch
}

// y = acc + bias, or with RES the folded residual shortcut + res_gamma * y.
template <typename T, bool RES>
__device__ __forceinline__ T epilogue(float acc, float bias, const T* __restrict__ shortcut,
                                      const T* __restrict__ res_gamma, int64_t idx, int c) {
  const float v = acc + bias;
  if constexpr (RES) {
    return from_f<T>(__fadd_rn(to_f(shortcut[idx]), __fmul_rn(to_f(res_gamma[c]), v)));
  } else {
    return from_f<T>(v);
  }
}

template <typename T, int C, class V>
__global__ void __launch_bounds__(THREADS)
ln_mlp_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const T* __restrict__ beta, const T* __restrict__ w1,  // [H, C]
              const T* __restrict__ b1,                              // [H]
              const T* __restrict__ w2,                              // [C, H]
              const T* __restrict__ b2,                              // [C]
              const T* __restrict__ shortcut,                        // [M, C] if RES
              const T* __restrict__ res_gamma,                       // [C] if RES
              T* __restrict__ y, int M, int H, float eps) {
  static_assert(C % 32 == 0, "C must be a multiple of 32");
  static_assert(V::GELU && V::BIAS && V::PIPE == 1 && V::LN != kLnTensorStats,
                "the FMA-pipe body serves K2, row 10 and row 13");
  constexpr int RN = C / 32;  // output columns per thread
  extern __shared__ float smem[];
  float* zs = smem;
  float* w1s = zs + TM * C;
  float* hs = w1s + KS * (HC + 1);
  float* w2s = hs + TM * HC;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // 0..7; owns rows warp*4 .. warp*4+3
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TM;

  // 1. LayerNorm (or x itself) of the tile into shared memory.
  layernorm_tile<T, float, C, TM, V::LN>(x, gamma, beta, zs, C, row0, M, eps);
  __syncthreads();

  float acc[4][RN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[i][n] = 0.f;

  for (int j0 = 0; j0 < H; j0 += HC) {
    // 2. u = z W1[j0:j0+HC]^T; this thread: rows warp*4+i, units lane, lane+32.
    float u[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i][0] = u[i][1] = 0.f;
    for (int k0 = 0; k0 < C; k0 += KS) {
      for (int e = tid; e < KS * HC; e += THREADS) {
        const int j = e / KS, k = e % KS;  // consecutive threads: consecutive k
        w1s[k * (HC + 1) + j] =
            (j0 + j < H) ? to_f(w1[static_cast<int64_t>(j0 + j) * C + k0 + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KS; ++k) {
        const float wa = w1s[k * (HC + 1) + lane];
        const float wb = w1s[k * (HC + 1) + lane + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = zs[(warp * 4 + i) * C + k0 + k];
          u[i][0] = fmaf(a, wa, u[i][0]);
          u[i][1] = fmaf(a, wb, u[i][1]);
        }
      }
      __syncthreads();
    }
    // 3. h = gelu(u + b1), rounded to the storage type, into shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int j = j0 + lane + 32 * s;
        float h = 0.f;
        if (j < H) h = round_to<T>(gelu_erf(u[i][s] + to_f(b1[j])));
        hs[(warp * 4 + i) * HC + lane + 32 * s] = h;
      }
    __syncthreads();
    // 4. y += h W2[:, j0:j0+HC]^T; this thread: rows warp*4+i, cols lane+32n.
    for (int jj0 = 0; jj0 < HC; jj0 += JS) {
      for (int e = tid; e < JS * C; e += THREADS) {
        const int c = e / JS, jj = e % JS;
        const int j = j0 + jj0 + jj;
        w2s[jj * (C + 1) + c] = (j < H) ? to_f(w2[static_cast<int64_t>(c) * H + j]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < JS; ++jj) {
        float h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = hs[(warp * 4 + i) * HC + jj0 + jj];
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          const float w = w2s[jj * (C + 1) + lane + 32 * n];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(h[i], w, acc[i][n]);
        }
      }
      __syncthreads();
    }
  }

  // 5. y = acc + b2 (or the folded residual), written once.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = row0 + warp * 4 + i;
    if (m < M) {
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        const int c = lane + 32 * n;
        y[m * C + c] = epilogue<T, V::RES>(acc[i][n], to_f(b2[c]), shortcut, res_gamma,
                                            m * C + c, c);
      }
    }
  }
}

// ---- bf16: tensor cores ----------------------------------------------------

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int TC_LDU = HC + 4;  // pitch (floats) of the u tile
constexpr int TC_LDH = HC + 8;  // pitch (bf16) of the h tile

// 16-row tiles per block: 4 (64 rows) while the [64, C] fp32 accumulator
// fits in registers (C <= 384), else 2 (32 rows). More rows per block means
// each weight fragment read from L2 feeds more tensor-core products.
template <int C>
__host__ __device__ constexpr int tc_row_tiles() { return C <= 384 ? 4 : 2; }

template <int C>
constexpr size_t ln_mlp_tc_smem_bytes() {
  constexpr int ROWS = 16 * tc_row_tiles<C>();
  return static_cast<size_t>(ROWS) * (C + 8) * sizeof(bf16)  // zs
         + static_cast<size_t>(ROWS) * TC_LDU * sizeof(float)  // us
         + static_cast<size_t>(ROWS) * TC_LDH * sizeof(bf16)   // hs
         + static_cast<size_t>(THREADS / 32) * 256 * sizeof(float);  // epilogue
}

// kLnTensorStats: the raw bf16 tile into zs, then per 16-row tile the row
// sums S = X 1 (a ones fragment) and the Gram matrix Q = X X^T on the tensor
// cores with fp32 accumulation (bf16 x bf16 products are exact in fp32);
// row r has sum(x) = S[r][0] and sum(x^2) = Q[r][r]. mu = sum(x) / C and
// var = sum(x^2) / C - mu^2, as the lab's mxu_stats body computes them; z
// replaces x in place. `scratch` holds 2 x 256 floats per row tile.
template <int C, int ROWS>
__device__ __forceinline__ void tensor_stats_layernorm(const bf16* __restrict__ x,
                                                       const bf16* __restrict__ gamma,
                                                       const bf16* __restrict__ beta, bf16* zs,
                                                       float* scratch, int64_t row0, int M,
                                                       float eps) {
  constexpr int LDZ = C + 8;
  constexpr int RT = ROWS / 16;
  static_assert(RT * 512 <= (THREADS / 32) * 256, "statistics fit the epilogue scratch");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int64_t m = row0 + r;
    for (int c = lane; c < C; c += 32) zs[r * LDZ + c] = m < M ? x[m * C + c] : from_f<bf16>(0.f);
  }
  __syncthreads();
  if (warp < RT) {
    FragC s, q;
    wmma::fill_fragment(s, 0.f);
    wmma::fill_fragment(q, 0.f);
    FragB ones;
    wmma::fill_fragment(ones, from_f<bf16>(1.f));
    const bf16* tile = zs + warp * 16 * LDZ;
#pragma unroll
    for (int k = 0; k < C; k += 16) {
      FragA a;
      FragB xt;  // column-major B of element (k, n) = X[n][k]: X^T
      wmma::load_matrix_sync(a, tile + k, LDZ);
      wmma::load_matrix_sync(xt, tile + k, LDZ);
      wmma::mma_sync(s, a, ones, s);
      wmma::mma_sync(q, a, xt, q);
    }
    wmma::store_matrix_sync(scratch + warp * 512, s, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(scratch + warp * 512 + 256, q, 16, wmma::mem_row_major);
  }
  __syncthreads();
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    if (row0 + r >= M) continue;  // stays zero
    const float* st = scratch + (r / 16) * 512;
    const int i = r % 16;
    const float mu = st[i * 16] * (1.f / C);
    const float var = st[256 + i * 17] * (1.f / C) - mu * mu;
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < C; c += 32) {
      const float v = to_f(zs[r * LDZ + c]);
      zs[r * LDZ + c] = from_f<bf16>((v - mu) * rstd * to_f(gamma[c]) + to_f(beta[c]));
    }
  }
}

// h = act(u + b1) of rows [r_begin, r_end) of the chunk at j0, rounded to bf16.
template <class V>
__device__ __forceinline__ void activate(const float* us, bf16* hs, const bf16* __restrict__ b1,
                                         int j0, int r_begin, int r_end) {
  for (int e = threadIdx.x; e < (r_end - r_begin) * HC; e += THREADS) {
    const int r = r_begin + e / HC, j = e % HC;
    float v = us[r * TC_LDU + j];
    if constexpr (V::BIAS) v += to_f(b1[j0 + j]);
    if constexpr (V::GELU) v = gelu_erf(v);
    hs[r * TC_LDH + j] = from_f<bf16>(v);
  }
}

// Every WMMA load/store address is a multiple of 32 bytes: tile origins sit
// at multiples of 16 rows and 16 columns, all pitches are multiples of 8
// elements, and the wrapper passes 32-byte aligned operands.
template <int C, class V>
__global__ void __launch_bounds__(THREADS)
ln_mlp_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                 const bf16* __restrict__ beta, const bf16* __restrict__ w1,  // [H, C]
                 const bf16* __restrict__ b1,                                 // [H]
                 const bf16* __restrict__ w2,                                 // [C, H]
                 const bf16* __restrict__ b2,                                 // [C]
                 const bf16* __restrict__ shortcut,                           // [M, C] if RES
                 const bf16* __restrict__ res_gamma,                          // [C] if RES
                 bf16* __restrict__ y, int M, int H, float eps) {
  static_assert(HC == 64 && THREADS == 256, "tile layout below");
  constexpr int RT = tc_row_tiles<C>();   // 16-row tiles per block
  constexpr int ROWS = 16 * RT;
  constexpr int RPW = RT / 2;             // u row tiles per warp
  constexpr int LDZ = C + 8;
  constexpr int NCT = C / 16;             // 16-column tiles of y
  constexpr int CPW = (NCT + 7) / 8;      // ... per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);
  float* us = reinterpret_cast<float*>(zs + ROWS * LDZ);
  bf16* hs = reinterpret_cast<bf16*>(us + ROWS * TC_LDU);
  float* scratch = reinterpret_cast<float*>(hs + ROWS * TC_LDH);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;

  if constexpr (V::LN == kLnTensorStats)
    tensor_stats_layernorm<C, ROWS>(x, gamma, beta, zs, scratch, row0, M, eps);
  else
    layernorm_tile<bf16, bf16, C, ROWS, V::LN>(x, gamma, beta, zs, LDZ, row0, M, eps);
  __syncthreads();

  // y accumulators: every row tile, column tiles warp + 8*i
  FragC yacc[RT][CPW];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < CPW; ++i) wmma::fill_fragment(yacc[r][i], 0.f);

  for (int j0 = 0; j0 < H; j0 += HC) {
    if constexpr (V::PIPE == 1) {
      // u[ROWS, 64] = z W1[j0:j0+64]^T: warp -> column tile warp%4, row tiles
      // (warp/4)*RPW .. +RPW-1, one W1 fragment per k step for all of them
      const int ct = warp & 3, rt0 = (warp >> 2) * RPW;
      FragC u[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) wmma::fill_fragment(u[r], 0.f);
      const bf16* wp = w1 + static_cast<int64_t>(j0 + ct * 16) * C;
#pragma unroll 4
      for (int k = 0; k < C; k += 16) {
        FragB b;
        wmma::load_matrix_sync(b, wp + k, C);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, zs + (rt0 + r) * 16 * LDZ + k, LDZ);
          wmma::mma_sync(u[r], a, b, u[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        wmma::store_matrix_sync(us + (rt0 + r) * 16 * TC_LDU + ct * 16, u[r], TC_LDU,
                                wmma::mem_row_major);
      __syncthreads();
      activate<V>(us, hs, b1, j0, 0, ROWS);
      __syncthreads();
    } else {
      // The row tile in PIPE groups of GR row tiles: step p issues group p's
      // fc1 products (one u fragment per warp, warps < GT), then activates
      // group p - 1 while they run, then stores group p's u. The tensor
      // cores work on group p while the FP32 pipes take group p - 1's GELU.
      constexpr int GR = RT / V::PIPE;
      constexpr int GT = GR * 4;
      static_assert(RT % V::PIPE == 0 && GT <= 8, "one u fragment per warp and group");
#pragma unroll 1
      for (int p = 0; p <= V::PIPE; ++p) {
        const bool mine = p < V::PIPE && warp < GT;
        const int rt = p * GR + warp / 4, ct = warp & 3;
        FragC u;
        if (mine) {
          wmma::fill_fragment(u, 0.f);
          const bf16* wp = w1 + static_cast<int64_t>(j0 + ct * 16) * C;
#pragma unroll 4
          for (int k = 0; k < C; k += 16) {
            FragB b;
            FragA a;
            wmma::load_matrix_sync(b, wp + k, C);
            wmma::load_matrix_sync(a, zs + rt * 16 * LDZ + k, LDZ);
            wmma::mma_sync(u, a, b, u);
          }
        }
        if (p > 0) activate<V>(us, hs, b1, j0, (p - 1) * GR * 16, p * GR * 16);
        if (mine)
          wmma::store_matrix_sync(us + rt * 16 * TC_LDU + ct * 16, u, TC_LDU,
                                  wmma::mem_row_major);
        __syncthreads();
      }
    }
    // y += h W2[:, j0:j0+64]^T, one W2 fragment per column tile for all rows
#pragma unroll
    for (int jj = 0; jj < HC; jj += 16) {
      FragA a[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) wmma::load_matrix_sync(a[r], hs + r * 16 * TC_LDH + jj, TC_LDH);
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int ct = warp + 8 * i;
        if (ct < NCT) {
          FragB b;
          wmma::load_matrix_sync(b, w2 + static_cast<int64_t>(ct * 16) * H + j0 + jj, H);
#pragma unroll
          for (int r = 0; r < RT; ++r) wmma::mma_sync(yacc[r][i], a[r], b, yacc[r][i]);
        }
      }
    }
    __syncthreads();  // us and hs are rewritten by the next chunk
  }

  // y = acc + b2 (or the folded residual), through a per-warp 16x16 staging tile
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int ct = warp + 8 * i;
      if (ct >= NCT) continue;
      wmma::store_matrix_sync(sc, yacc[rt][i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int64_t m = row0 + rt * 16 + e / 16;
        const int c = ct * 16 + e % 16;
        if (m < M)
          y[m * C + c] = epilogue<bf16, V::RES>(sc[e], V::BIAS ? to_f(b2[c]) : 0.f, shortcut,
                                                res_gamma, m * C + c, c);
      }
      __syncwarp();
    }
}

template <typename T, int C, class V>
cudaError_t launch_ln_mlp(const MlpArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int rows = 16 * tc_row_tiles<C>();
    const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(a.M) + rows - 1) / rows);
    if (a.H % HC != 0) return cudaErrorInvalidValue;
    const size_t smem = ln_mlp_tc_smem_bytes<C>();
    cudaError_t err = allow_smem(ln_mlp_tc_kernel<C, V>, smem);
    if (err != cudaSuccess) return err;
    ln_mlp_tc_kernel<C, V><<<blocks, THREADS, smem, stream>>>(
        static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.g),
        static_cast<const bf16*>(a.be), static_cast<const bf16*>(a.w1),
        static_cast<const bf16*>(a.b1), static_cast<const bf16*>(a.w2),
        static_cast<const bf16*>(a.b2), static_cast<const bf16*>(a.sc),
        static_cast<const bf16*>(a.rg), static_cast<bf16*>(a.y), a.M, a.H, a.eps);
  } else {
    const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(a.M) + TM - 1) / TM);
    const size_t smem = ln_mlp_smem_floats<C>() * sizeof(float);
    cudaError_t err = allow_smem(ln_mlp_kernel<T, C, V>, smem);
    if (err != cudaSuccess) return err;
    ln_mlp_kernel<T, C, V><<<blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.g), static_cast<const T*>(a.be),
        static_cast<const T*>(a.w1), static_cast<const T*>(a.b1), static_cast<const T*>(a.w2),
        static_cast<const T*>(a.b2), static_cast<const T*>(a.sc), static_cast<const T*>(a.rg),
        static_cast<T*>(a.y), a.M, a.H, a.eps);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace mspi
