// Fused LayerNorm + MLP backward: the gradients of y = fc2(gelu(fc1(LN(x))))
// on token-major rows x [M, C], for dy [M, C].
//
// Replaces: mspi_tpu/ops/pallas/mlp.py::_ln_bwd_impl (kernel _ln_bwd_kernel),
// the backward of K2 in the MViT, SyncBlock and decoder MLPs.
//
// Numerics follow the TPU kernel: LayerNorm statistics recomputed from x in
// fp32 with the fast-variance formula (E[x^2] - mu^2); z rounded to the
// storage type T before fc1; exact erf GELU and GELU' in fp32; h, dy and du
// rounded to T where they enter a product; every product accumulated in
// fp32. dx is written in T; dgamma, dbeta, dW1, db1, dW2 and db2 are summed
// over all rows in fp32 and written in fp32 (the wrapper casts them to the
// parameter dtype).
//
// The TPU kernel carries the weight-gradient sums across its sequential
// grid in VMEM. Blocks on the card run in no order, so the sums over rows
// take two passes and a reduction, all deterministic:
//   A. row-tile pass: LN, then the hidden dimension in chunks of 64 units
//      as the forward walks it: u = z W1^T + b1, dh = dy W2,
//      du = dh * gelu'(u), dz += du W1, with the [rows, C] dz accumulator in
//      registers. It writes dx, the rounded z, h and du for pass B, and
//      per-tile partial column sums of dgamma, dbeta, db2 and db1.
//      bf16: the three products on the tensor cores (WMMA, fp32
//      accumulate), weight fragments straight from L2 as in the forward;
//      64 rows per block for C <= 384, 32 above. fp32: the FMA pipes, 32
//      rows per block (16 for C >= 512, shared memory).
//   B. A^T B pass: dW1 = du^T z and dW2 = dy^T h, one block per 64x64
//      output tile and row segment, fp32 partials per segment (bf16: WMMA
//      tensor cores; fp32: FMA pipes, since tensor cores would round to TF32).
//   C. a sum over segments and tiles of the fp32 partials.
//
// Also replaces mspi_tpu/ops/pallas/mlp.py::_bwd_impl (kernel _bwd_kernel), the
// backward of fused_mlp (row 13), with the LayerNorm compiled out (template
// flag LN = false): z is x itself, pass A writes dx = du_c W1 with no
// LayerNorm backward and no z copy, and pass B takes dW1 = du^T x. db1 comes
// from the fp32 du, as the TPU kernel sums it; the dgamma/dbeta columns of
// the partial sums are zeros.
//
// What bounds it on the card: 10*C*H flops per row (u, dh, dz in pass A;
// dW1, dW2 in pass B) against ~4*C + 4*H values read and written per row --
// the arithmetic, not device memory.

#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace mspi {
namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int HC = 64;        // hidden units per chunk
constexpr int KS = 32;        // input features staged per step
constexpr int JS = 16;        // hidden units staged per step of dz

// rows per block of pass A. fp32: the [rows, C] z and dy tiles and the W1
// stage must fit shared memory at C = 768. bf16: the [rows, C] fp32 dz
// accumulator must fit in registers.
__host__ __device__ constexpr int bwd_rows(int c) { return c <= 384 ? 32 : 16; }
__host__ __device__ constexpr int bwd_rows_tc(int c) { return c <= 384 ? 64 : 32; }

__device__ __forceinline__ float gelu_f(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * expf(-0.5f * v * v);
}

template <int C>
constexpr size_t rows_smem_floats() {
  constexpr int TM = bwd_rows(C);
  return static_cast<size_t>(TM) * C * 2      // zs, dys
         + static_cast<size_t>(KS) * (HC + 1) * 2  // w1s, w2s
         + static_cast<size_t>(TM) * HC * 2        // dus, dur
         + static_cast<size_t>(JS) * (C + 1)       // w1c
         + static_cast<size_t>(8) * C;             // red
}

// Pass A. part row of this tile: [dgamma | dbeta | db2 | db1], width 3C + H.
template <typename T, int C, bool LN>
__global__ void __launch_bounds__(THREADS)
ln_mlp_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ beta, const T* __restrict__ w1,  // [H, C]
                       const T* __restrict__ b1,                              // [H]
                       const T* __restrict__ w2,                              // [C, H]
                       const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ zc,
                       T* __restrict__ hc, T* __restrict__ duc, float* __restrict__ part,
                       int M, int H, float eps) {
  static_assert(C % 32 == 0, "C must be a multiple of 32");
  constexpr int TM = bwd_rows(C);
  constexpr int RPW = TM / 8;  // rows per warp
  constexpr int RN = C / 32;   // columns per lane
  extern __shared__ float smem[];
  float* zs = smem;                // [TM][C] z, rounded to T
  float* dys = zs + TM * C;        // [TM][C] dy
  float* w1s = dys + TM * C;       // [KS][HC+1] W1 slice, transposed
  float* w2s = w1s + KS * (HC + 1);  // [KS][HC+1] W2 slice
  float* dus = w2s + KS * (HC + 1);  // [TM][HC] du rounded to T
  float* dur = dus + TM * HC;      // [TM][HC] du in fp32
  float* w1c = dur + TM * HC;      // [JS][C+1] W1 rows of the chunk
  float* red = w1c + JS * (C + 1);  // [8][C] cross-warp column sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TM;
  const int P = 3 * C + H;
  float* prow = part + static_cast<int64_t>(blockIdx.x) * P;

  // 1. LN statistics (fast variance), z (x without LN) and dy into shared memory
  float mu[RPW], rstd[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    const int64_t m = row0 + r;
    mu[i] = 0.f;
    rstd[i] = 0.f;
    if (m >= M) {
      for (int c = lane; c < C; c += 32) zs[r * C + c] = dys[r * C + c] = 0.f;
      continue;
    }
    if constexpr (!LN) {
      for (int c = lane; c < C; c += 32) {
        zs[r * C + c] = to_f(x[m * C + c]);
        dys[r * C + c] = to_f(dy[m * C + c]);
      }
      continue;
    }
    float v[RN], s = 0.f, q = 0.f;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      v[n] = to_f(x[m * C + lane + 32 * n]);
      s += v[n];
      q += v[n] * v[n];
    }
    mu[i] = warp_sum(s) / C;
    const float var = warp_sum(q) / C - mu[i] * mu[i];
    rstd[i] = rsqrtf(var + eps);
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int c = lane + 32 * n;
      const float z = round_to<T>((v[n] - mu[i]) * rstd[i] * to_f(gamma[c]) + to_f(beta[c]));
      zs[r * C + c] = z;
      zc[m * C + c] = from_f<T>(z);
      dys[r * C + c] = to_f(dy[m * C + c]);
    }
  }
  __syncthreads();

  float dz[RPW][RN];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int n = 0; n < RN; ++n) dz[i][n] = 0.f;

  for (int j0 = 0; j0 < H; j0 += HC) {
    // 2. u = z W1[chunk]^T and dh = dy W2[:, chunk]: rows warp*RPW+i,
    //    units lane and lane+32
    float u[RPW][2], dh[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) u[i][0] = u[i][1] = dh[i][0] = dh[i][1] = 0.f;
    for (int k0 = 0; k0 < C; k0 += KS) {
      for (int e = tid; e < KS * HC; e += THREADS) {
        const int j = e / KS, k = e % KS;
        const bool ok = j0 + j < H;
        w1s[k * (HC + 1) + j] = ok ? to_f(w1[static_cast<int64_t>(j0 + j) * C + k0 + k]) : 0.f;
        w2s[k * (HC + 1) + j] = ok ? to_f(w2[static_cast<int64_t>(k0 + k) * H + j0 + j]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KS; ++k) {
        const float wa = w1s[k * (HC + 1) + lane], wb = w1s[k * (HC + 1) + lane + 32];
        const float va = w2s[k * (HC + 1) + lane], vb = w2s[k * (HC + 1) + lane + 32];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int r = warp * RPW + i;
          const float a = zs[r * C + k0 + k], d = dys[r * C + k0 + k];
          u[i][0] = fmaf(a, wa, u[i][0]);
          u[i][1] = fmaf(a, wb, u[i][1]);
          dh[i][0] = fmaf(d, va, dh[i][0]);
          dh[i][1] = fmaf(d, vb, dh[i][1]);
        }
      }
      __syncthreads();
    }
    // 3. h and du; h and du (rounded) out for pass B, du into shared memory
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int64_t m = row0 + r;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int j = lane + 32 * s;
        float du = 0.f, du_c = 0.f;
        if (j0 + j < H && m < M) {
          const float v = u[i][s] + to_f(b1[j0 + j]);
          hc[m * H + j0 + j] = from_f<T>(gelu_f(v));
          du = dh[i][s] * gelu_grad(v);
          du_c = round_to<T>(du);
          duc[m * H + j0 + j] = from_f<T>(du);
        }
        dus[r * HC + j] = du_c;
        dur[r * HC + j] = du;
      }
    }
    __syncthreads();
    if (tid < HC && j0 + tid < H) {  // db1 partial, from the unrounded du
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s += dur[r * HC + tid];
      prow[3 * C + j0 + tid] = s;
    }
    // 4. dz += du W1[chunk]: rows warp*RPW+i, columns lane+32n
    for (int jj0 = 0; jj0 < HC; jj0 += JS) {
      for (int e = tid; e < JS * C; e += THREADS) {
        const int jj = e / C, c = e % C;
        const int j = j0 + jj0 + jj;
        w1c[jj * (C + 1) + c] = (j < H) ? to_f(w1[static_cast<int64_t>(j) * C + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < JS; ++jj) {
        float d[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) d[i] = dus[(warp * RPW + i) * HC + jj0 + jj];
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          const float w = w1c[jj * (C + 1) + lane + 32 * n];
#pragma unroll
          for (int i = 0; i < RPW; ++i) dz[i][n] = fmaf(d[i], w, dz[i][n]);
        }
      }
      __syncthreads();
    }
  }

  // 5. LN backward per row (dx = dz without LN); column partials of dgamma
  //    and dbeta
  float pg[RN], pb[RN];
#pragma unroll
  for (int n = 0; n < RN; ++n) pg[n] = pb[n] = 0.f;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int64_t m = row0 + warp * RPW + i;
    if (m >= M) continue;
    if constexpr (!LN) {
#pragma unroll
      for (int n = 0; n < RN; ++n) dx[m * C + lane + 32 * n] = from_f<T>(dz[i][n]);
      continue;
    }
    float xh[RN], dxh[RN], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int c = lane + 32 * n;
      xh[n] = (to_f(x[m * C + c]) - mu[i]) * rstd[i];
      dxh[n] = dz[i][n] * to_f(gamma[c]);
      s1 += dxh[n];
      s2 += dxh[n] * xh[n];
      pg[n] += dz[i][n] * xh[n];
      pb[n] += dz[i][n];
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int n = 0; n < RN; ++n)
      dx[m * C + lane + 32 * n] = from_f<T>((dxh[n] - m1 - xh[n] * m2) * rstd[i]);
  }
#pragma unroll
  for (int n = 0; n < RN; ++n) red[warp * C + lane + 32 * n] = pg[n];
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * C + c];
    prow[c] = s;
    float t = 0.f;
    for (int r = 0; r < TM; ++r) t += dys[r * C + c];
    prow[2 * C + c] = t;
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < RN; ++n) red[warp * C + lane + 32 * n] = pb[n];
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * C + c];
    prow[C + c] = s;
  }
}

// ---- pass A on the tensor cores (bf16) ----------------------------------------

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBcol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBrow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int TC_LDU = HC + 4;  // fp32 pitch of the u and dh tiles
constexpr int TC_LDH = HC + 8;  // bf16 pitch of the du tile

template <int C>
constexpr size_t rows_tc_smem_bytes() {
  constexpr int ROWS = bwd_rows_tc(C);
  return static_cast<size_t>(ROWS) * (C + 8) * sizeof(bf16) * 2     // zs, dys
         + static_cast<size_t>(ROWS) * TC_LDU * sizeof(float) * 2    // us, dhs
         + static_cast<size_t>(ROWS) * TC_LDH * sizeof(bf16)         // dus
         + static_cast<size_t>(ROWS) * sizeof(float) * 2;            // mu, rstd
}

// Every WMMA address is a multiple of 32 bytes: tiles start at multiples of
// 16 rows and columns, pitches are multiples of 8 elements, and the wrapper
// passes 32-byte aligned operands.
template <int C, bool LN>
__global__ void __launch_bounds__(THREADS)
ln_mlp_bwd_rows_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                          const bf16* __restrict__ beta, const bf16* __restrict__ w1,  // [H, C]
                          const bf16* __restrict__ b1,                                 // [H]
                          const bf16* __restrict__ w2,                                 // [C, H]
                          const bf16* __restrict__ dy, bf16* __restrict__ dx,
                          bf16* __restrict__ zc, bf16* __restrict__ hc,
                          bf16* __restrict__ duc, float* __restrict__ part, int M, int H,
                          float eps) {
  static_assert(HC == 64 && THREADS == 256, "tile layout below");
  constexpr int ROWS = bwd_rows_tc(C);
  constexpr int RT = ROWS / 16;      // 16-row tiles per block
  constexpr int RPW = RT / 2;        // u / dh row tiles per warp
  constexpr int LDZ = C + 8;
  constexpr int LDD = C + 4;         // fp32 pitch of the staged dz
  constexpr int NCT = C / 16;        // 16-column tiles of dz
  constexpr int CPW = (NCT + 7) / 8; // ... per warp
  constexpr int RN = C / 32;
  static_assert(ROWS * LDD * sizeof(float) <= 2 * ROWS * LDZ * sizeof(bf16),
                "staged dz must fit over zs and dys");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LDZ] z rounded to bf16
  bf16* dys = zs + ROWS * LDZ;                   // [ROWS][LDZ] dy
  float* us = reinterpret_cast<float*>(dys + ROWS * LDZ);  // [ROWS][TC_LDU] u, then du
  float* dhs = us + ROWS * TC_LDU;                          // [ROWS][TC_LDU] dh
  bf16* dus = reinterpret_cast<bf16*>(dhs + ROWS * TC_LDU); // [ROWS][TC_LDH] du rounded
  float* mu_s = reinterpret_cast<float*>(dus + ROWS * TC_LDH);
  float* rstd_s = mu_s + ROWS;
  float* dzs = reinterpret_cast<float*>(smem_raw);  // [ROWS][LDD] after the chunk loop

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int P = 3 * C + H;
  float* prow = part + static_cast<int64_t>(blockIdx.x) * P;

  // 1. LN statistics (fast variance) per row, z (x without LN) and dy into
  //    shared memory
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int64_t m = row0 + r;
    if (m >= M) {
      for (int c = lane; c < C; c += 32) zs[r * LDZ + c] = dys[r * LDZ + c] = from_f<bf16>(0.f);
      if (lane == 0) mu_s[r] = rstd_s[r] = 0.f;
      continue;
    }
    if constexpr (!LN) {
      for (int c = lane; c < C; c += 32) {
        zs[r * LDZ + c] = x[m * C + c];
        dys[r * LDZ + c] = dy[m * C + c];
      }
      continue;
    }
    float v[RN], s = 0.f, q = 0.f;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      v[n] = to_f(x[m * C + lane + 32 * n]);
      s += v[n];
      q += v[n] * v[n];
    }
    const float mu = warp_sum(s) / C;
    const float rstd = rsqrtf(warp_sum(q) / C - mu * mu + eps);
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int c = lane + 32 * n;
      const bf16 z = from_f<bf16>((v[n] - mu) * rstd * to_f(gamma[c]) + to_f(beta[c]));
      zs[r * LDZ + c] = z;
      zc[m * C + c] = z;
      dys[r * LDZ + c] = dy[m * C + c];
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {  // db2 partial
    float t = 0.f;
    for (int r = 0; r < ROWS; ++r) t += to_f(dys[r * LDZ + c]);
    prow[2 * C + c] = t;
  }

  FragC dz[RT][CPW];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < CPW; ++i) wmma::fill_fragment(dz[r][i], 0.f);

  for (int j0 = 0; j0 < H; j0 += HC) {
    // 2. u = z W1[chunk]^T and dh = dy W2[:, chunk]: warp -> column tile
    //    warp%4, row tiles (warp/4)*RPW .. +RPW-1
    {
      const int ct = warp & 3, rt0 = (warp >> 2) * RPW;
      FragC u[RPW], d[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        wmma::fill_fragment(u[r], 0.f);
        wmma::fill_fragment(d[r], 0.f);
      }
      const bf16* w1p = w1 + static_cast<int64_t>(j0 + ct * 16) * C;  // (k, n) at [n*C + k]
      const bf16* w2p = w2 + j0 + ct * 16;                              // (k, n) at [k*H + n]
#pragma unroll 2
      for (int k = 0; k < C; k += 16) {
        FragBcol bw1;
        FragBrow bw2;
        wmma::load_matrix_sync(bw1, w1p + k, C);
        wmma::load_matrix_sync(bw2, w2p + static_cast<int64_t>(k) * H, H);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, zs + (rt0 + r) * 16 * LDZ + k, LDZ);
          wmma::mma_sync(u[r], a, bw1, u[r]);
          wmma::load_matrix_sync(a, dys + (rt0 + r) * 16 * LDZ + k, LDZ);
          wmma::mma_sync(d[r], a, bw2, d[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        wmma::store_matrix_sync(us + (rt0 + r) * 16 * TC_LDU + ct * 16, u[r], TC_LDU,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(dhs + (rt0 + r) * 16 * TC_LDU + ct * 16, d[r], TC_LDU,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    // 3. h and du; h and du (rounded) out for pass B; du in fp32 (for db1)
    //    over u, and rounded for the dz product
    for (int e = tid; e < ROWS * HC; e += THREADS) {
      const int r = e / HC, j = e % HC;
      const int64_t m = row0 + r;
      float du = 0.f;
      if (m < M) {
        const float v = us[r * TC_LDU + j] + to_f(b1[j0 + j]);
        hc[m * H + j0 + j] = from_f<bf16>(gelu_f(v));
        du = dhs[r * TC_LDU + j] * gelu_grad(v);
        duc[m * H + j0 + j] = from_f<bf16>(du);
      }
      us[r * TC_LDU + j] = du;
      dus[r * TC_LDH + j] = from_f<bf16>(du);
    }
    __syncthreads();
    if (tid < HC) {  // db1 partial, from the unrounded du
      float t = 0.f;
      for (int r = 0; r < ROWS; ++r) t += us[r * TC_LDU + tid];
      prow[3 * C + j0 + tid] = t;
    }
    // 4. dz += du W1[chunk]: one W1 fragment per column tile for all rows
#pragma unroll
    for (int jj = 0; jj < HC; jj += 16) {
      FragA a[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        wmma::load_matrix_sync(a[r], dus + r * 16 * TC_LDH + jj, TC_LDH);
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        const int ct = warp + 8 * i;
        if (ct < NCT) {
          FragBrow b;
          wmma::load_matrix_sync(b, w1 + static_cast<int64_t>(j0 + jj) * C + ct * 16, C);
#pragma unroll
          for (int r = 0; r < RT; ++r) wmma::mma_sync(dz[r][i], a[r], b, dz[r][i]);
        }
      }
    }
    __syncthreads();  // us, dhs and dus are rewritten by the next chunk
  }

  // 5. stage dz over zs / dys, then the LN backward per row (one warp each)
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int ct = warp + 8 * i;
      if (ct < NCT)
        wmma::store_matrix_sync(dzs + rt * 16 * LDD + ct * 16, dz[rt][i], LDD,
                                wmma::mem_row_major);
    }
  __syncthreads();
  if constexpr (!LN) {  // dx = dz; no dgamma, dbeta
    for (int e = tid; e < ROWS * C; e += THREADS) {
      const int r = e / C, c = e % C;
      if (row0 + r < M) dx[(row0 + r) * C + c] = from_f<bf16>(dzs[r * LDD + c]);
    }
    for (int c = tid; c < C; c += THREADS) prow[c] = prow[C + c] = 0.f;
  } else {
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      const int64_t m = row0 + r;
      if (m >= M) continue;
      const float mu = mu_s[r], rstd = rstd_s[r];
      float xh[RN], dxh[RN], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int n = 0; n < RN; ++n) {
        const int c = lane + 32 * n;
        xh[n] = (to_f(x[m * C + c]) - mu) * rstd;
        dxh[n] = dzs[r * LDD + c] * to_f(gamma[c]);
        s1 += dxh[n];
        s2 += dxh[n] * xh[n];
      }
      const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
      for (int n = 0; n < RN; ++n)
        dx[m * C + lane + 32 * n] = from_f<bf16>((dxh[n] - m1 - xh[n] * m2) * rstd);
    }
    for (int c = tid; c < C; c += THREADS) {  // dgamma, dbeta partials
      float pg = 0.f, pb = 0.f;
      for (int r = 0; r < ROWS && row0 + r < M; ++r) {
        const float d = dzs[r * LDD + c];
        pg += d * (to_f(x[(row0 + r) * C + c]) - mu_s[r]) * rstd_s[r];
        pb += d;
      }
      prow[c] = pg;
      prow[C + c] = pb;
    }
  }
}

// ---- pass B: part[s][m][n] = sum over rows r of segment s of A[r][m] B[r][n]

constexpr int AT = 64;  // output tile edge
constexpr int AR = 32;  // rows staged per step (fp32)
constexpr int AR_TC = 64;  // rows staged per step (bf16)

// fp32: FMA pipes, thread (ty, tx) owns outputs m = ty*4+i, n = tx*4+jj
__global__ void __launch_bounds__(THREADS)
atb_kernel_f32(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ part,
               int M, int Ma, int Nb, int rows_per_seg, int64_t seg_stride) {
  __shared__ __align__(16) float as[AR][AT + 4];
  __shared__ __align__(16) float bs[AR][AT + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * AT, m0 = blockIdx.y * AT, seg = blockIdx.z;
  const int r_begin = seg * rows_per_seg;
  const int r_end = min(M, r_begin + rows_per_seg);
  float acc[4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += AR) {
    for (int e = tid; e < AR * AT; e += THREADS) {
      const int r = e / AT, c = e % AT;
      const int64_t row = r0 + r;
      const bool ok = row < r_end;
      as[r][c] = (ok && m0 + c < Ma) ? A[row * Ma + m0 + c] : 0.f;
      bs[r][c] = (ok && n0 + c < Nb) ? B[row * Nb + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < AR; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&as[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + seg * seg_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= Ma) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Nb) out[static_cast<int64_t>(m) * Nb + n] = acc[i][j];
    }
  }
}

// bf16: WMMA 16x16x16, fp32 accumulate; warp w owns output tiles 2w, 2w+1
__global__ void __launch_bounds__(THREADS)
atb_kernel_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ part,
                int M, int Ma, int Nb, int rows_per_seg, int64_t seg_stride) {
  constexpr int LD = AT + 8;  // bf16 pitch (multiple of 8: WMMA)
  constexpr int LDO = AT + 4;
  constexpr int VEC = AT / 8;  // 16-byte vectors per staged row
  __shared__ __align__(32) unsigned char buf[2 * AR_TC * LD * sizeof(bf16)];
  bf16* as = reinterpret_cast<bf16*>(buf);  // [AR_TC][LD] rows of A
  bf16* bs = as + AR_TC * LD;               // [AR_TC][LD] rows of B
  float* os = reinterpret_cast<float*>(buf);  // [AT][LDO] after the row loop
  static_assert(AT * LDO * sizeof(float) <= sizeof(buf), "staging");
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n0 = blockIdx.x * AT, m0 = blockIdx.y * AT, seg = blockIdx.z;
  const int r_begin = seg * rows_per_seg;
  const int r_end = min(M, r_begin + rows_per_seg);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int r0 = r_begin; r0 < r_end; r0 += AR_TC) {
    // 16 bytes per load: Ma and Nb are multiples of 8 (the wrapper's widths)
    for (int e = tid; e < AR_TC * VEC; e += THREADS) {
      const int r = e / VEC, c = (e % VEC) * 8;
      const int64_t row = r0 + r;
      const bool ok = row < r_end;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (ok && m0 + c < Ma) va = *reinterpret_cast<const uint4*>(A + row * Ma + m0 + c);
      if (ok && n0 + c < Nb) vb = *reinterpret_cast<const uint4*>(B + row * Nb + n0 + c);
      *reinterpret_cast<uint4*>(as + r * LD + c) = va;
      *reinterpret_cast<uint4*>(bs + r * LD + c) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = warp * 2 + t, rt = tile >> 2, ct = tile & 3;
#pragma unroll
      for (int k = 0; k < AR_TC; k += 16) {
        // A^T: element (m, r) of the col-major fragment is as[r][m]
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, as + k * LD + rt * 16, LD);
        wmma::load_matrix_sync(b, bs + k * LD + ct * 16, LD);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int tile = warp * 2 + t, rt = tile >> 2, ct = tile & 3;
    wmma::store_matrix_sync(os + rt * 16 * LDO + ct * 16, acc[t], LDO, wmma::mem_row_major);
  }
  __syncthreads();
  float* out = part + seg * seg_stride;
  for (int e = tid; e < AT * AT; e += THREADS) {
    const int m = m0 + e / AT, n = n0 + e % AT;
    if (m < Ma && n < Nb) out[static_cast<int64_t>(m) * Nb + n] = os[(e / AT) * LDO + e % AT];
  }
}

// pass C: out[i] = sum over s of part[s * n + i]
__global__ void sum_segments_kernel(const float* __restrict__ part, int segments, int64_t n,
                                    float* __restrict__ out) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < segments; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

cudaError_t sum_segments(const float* part, int segments, int64_t n, float* out,
                         cudaStream_t stream) {
  const int64_t blocks = (n + 255) / 256;
  sum_segments_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      part, segments, n, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t atb(const T* A, const T* B, float* part, int M, int Ma, int Nb, int segments,
                int64_t seg_stride, cudaStream_t stream) {
  const int rows_per_seg = (M + segments - 1) / segments;
  const dim3 grid((Nb + AT - 1) / AT, (Ma + AT - 1) / AT, segments);
  if constexpr (std::is_same<T, bf16>::value)
    atb_kernel_bf16<<<grid, THREADS, 0, stream>>>(A, B, part, M, Ma, Nb, rows_per_seg,
                                                  seg_stride);
  else
    atb_kernel_f32<<<grid, THREADS, 0, stream>>>(A, B, part, M, Ma, Nb, rows_per_seg,
                                                 seg_stride);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *gamma, *beta, *w1, *b1, *w2, *dy;
  void *dx, *zc, *hc, *duc;
  float *col_part, *col_out, *w_part, *w_out;
  int M, H, segments;
  float eps;
};

template <typename T, int C, bool LN>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr bool kTc = std::is_same<T, bf16>::value;
  constexpr int TM = kTc ? bwd_rows_tc(C) : bwd_rows(C);
  const int tiles = (a.M + TM - 1) / TM;
  cudaError_t err;
  if constexpr (kTc) {
    if (a.H % HC != 0) return cudaErrorInvalidValue;
    const size_t smem = rows_tc_smem_bytes<C>();
    if ((err = allow_smem(ln_mlp_bwd_rows_tc_kernel<C, LN>, smem)) != cudaSuccess) return err;
    ln_mlp_bwd_rows_tc_kernel<C, LN><<<tiles, THREADS, smem, stream>>>(
        static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.gamma),
        static_cast<const bf16*>(a.beta), static_cast<const bf16*>(a.w1),
        static_cast<const bf16*>(a.b1), static_cast<const bf16*>(a.w2),
        static_cast<const bf16*>(a.dy), static_cast<bf16*>(a.dx), static_cast<bf16*>(a.zc),
        static_cast<bf16*>(a.hc), static_cast<bf16*>(a.duc), a.col_part, a.M, a.H, a.eps);
  } else {
    const size_t smem = rows_smem_floats<C>() * sizeof(float);
    if ((err = allow_smem(ln_mlp_bwd_rows_kernel<T, C, LN>, smem)) != cudaSuccess) return err;
    ln_mlp_bwd_rows_kernel<T, C, LN><<<tiles, THREADS, smem, stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.gamma),
        static_cast<const T*>(a.beta), static_cast<const T*>(a.w1),
        static_cast<const T*>(a.b1), static_cast<const T*>(a.w2), static_cast<const T*>(a.dy),
        static_cast<T*>(a.dx), static_cast<T*>(a.zc), static_cast<T*>(a.hc),
        static_cast<T*>(a.duc), a.col_part, a.M, a.H, a.eps);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t hcn = static_cast<int64_t>(a.H) * C;
  // dW1 [H, C] = du^T z (x without LN); dW2 [C, H] = dy^T h; both in one
  // partial buffer
  const void* z = LN ? a.zc : a.x;
  err = atb<T>(static_cast<const T*>(a.duc), static_cast<const T*>(z), a.w_part, a.M, a.H, C,
               a.segments, 2 * hcn, stream);
  if (err != cudaSuccess) return err;
  err = atb<T>(static_cast<const T*>(a.dy), static_cast<const T*>(a.hc), a.w_part + hcn, a.M, C,
               a.H, a.segments, 2 * hcn, stream);
  if (err != cudaSuccess) return err;
  err = sum_segments(a.w_part, a.segments, 2 * hcn, a.w_out, stream);
  if (err != cudaSuccess) return err;
  return sum_segments(a.col_part, tiles, 3 * C + a.H, a.col_out, stream);
}

template <typename T, bool LN>
cudaError_t dispatch_bwd(const BwdArgs& a, int C, cudaStream_t s) {
  switch (C) {
    case 96: return launch_bwd<T, 96, LN>(a, s);
    case 192: return launch_bwd<T, 192, LN>(a, s);
    case 384: return launch_bwd<T, 384, LN>(a, s);
    case 512: return launch_bwd<T, 512, LN>(a, s);
    case 768: return launch_bwd<T, 768, LN>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool LN>
cudaError_t dispatch_bwd_dtype(const BwdArgs& a, int C, int dtype, cudaStream_t s) {
  if (a.M <= 0 || a.segments <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32) return dispatch_bwd<float, LN>(a, C, s);
  if (dtype == kBFloat16) return dispatch_bwd<bf16, LN>(a, C, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mspi

// Rows per block of pass A at width C and dtype: the wrapper sizes col_part
// [ceil(M / rows), 3C + H] with it.
extern "C" int mspi_ln_mlp_bwd_rows(int C, int dtype) {
  return dtype == mspi::kBFloat16 ? mspi::bwd_rows_tc(C) : mspi::bwd_rows(C);
}

// x, dy, dx: [M, C]; gamma, beta: [C]; w1: [H, C]; b1: [H]; w2: [C, H], all of
// one dtype (0 fp32, 1 bf16), contiguous. Scratch: zc [M, C], hc and duc
// [M, H] in that dtype; col_part [tiles, 3C+H], w_part [segments, 2HC] fp32.
// Outputs in fp32: col_out [3C+H] = dgamma | dbeta | db2 | db1 and
// w_out [2HC] = dW1 [H, C] | dW2 [C, H]. Returns a cudaError_t code.
extern "C" int mspi_ln_mlp_bwd(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* dy,
                               void* dx, void* zc, void* hc, void* duc, float* col_part,
                               float* col_out, float* w_part, float* w_out, int M, int C, int H,
                               float eps, int segments, int dtype, void* stream) {
  const mspi::BwdArgs a{x, gamma, beta, w1, b1, w2, dy, dx, zc, hc, duc,
                        col_part, col_out, w_part, w_out, M, H, segments, eps};
  return mspi::dispatch_bwd_dtype<true>(a, C, dtype, static_cast<cudaStream_t>(stream));
}

// Row 14, the backward of y = fc2(gelu(fc1(x))): as mspi_ln_mlp_bwd without
// gamma, beta and the z scratch (dW1 takes x); col_out's dgamma and dbeta
// columns come back zero.
extern "C" int mspi_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* dy, void* dx, void* hc, void* duc, float* col_part,
                            float* col_out, float* w_part, float* w_out, int M, int C, int H,
                            int segments, int dtype, void* stream) {
  const mspi::BwdArgs a{x, nullptr, nullptr, w1, b1, w2, dy, dx, nullptr, hc, duc,
                        col_part, col_out, w_part, w_out, M, H, segments, 0.f};
  return mspi::dispatch_bwd_dtype<false>(a, C, dtype, static_cast<cudaStream_t>(stream));
}
