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
// bf16 runs ln_mlp_bwd_sm90.cuh's wgmma + TMA kernels. fp32 runs the FMA
// passes below (tensor cores would round to TF32). The TPU kernel carries the
// weight-gradient sums across its sequential grid in VMEM. Blocks on the card
// run in no order, so the sums over rows take two passes and a reduction, all
// deterministic:
//   A. row-tile pass: LN, then the hidden dimension in chunks of 64 units
//      as the forward walks it: u = z W1^T + b1, dh = dy W2,
//      du = dh * gelu'(u), dz += du W1, with the [rows, C] dz accumulator in
//      registers. It writes dx, the rounded z, h and du for pass B, and
//      per-tile partial column sums of dgamma, dbeta, db2 and db1. 32 rows
//      per block (16 for C >= 512, shared memory).
//   B. A^T B pass: dW1 = du^T z and dW2 = dy^T h, one block per 64x64
//      output tile and row segment, fp32 partials per segment.
//   C. a sum over segments and tiles of the fp32 partials.
//
// Also replaces mspi_tpu/ops/pallas/mlp.py::_bwd_impl (kernel _bwd_kernel), the
// backward of fused_mlp (row 13), with the LayerNorm compiled out (template
// flag LN = false): z is x itself, dx = du_c W1 with no LayerNorm backward
// and no z copy, and dW1 = du^T x. db1 comes from the fp32 du, as the TPU
// kernel sums it; the dgamma/dbeta columns of the partial sums are zeros.
//
// What bounds it on the card: 10*C*H flops per row (u, dh, dz; dW1, dW2)
// against ~4*C + 4*H values read and written per row -- the arithmetic, not
// device memory.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "ln_mlp_bwd_sm90.cuh"

namespace mspi {
namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int HC = 64;        // hidden units per chunk
constexpr int KS = 32;        // input features staged per step
constexpr int JS = 16;        // hidden units staged per step of dz

// rows per block of fp32 pass A: the [rows, C] z and dy tiles and the W1
// stage must fit shared memory at C = 768.
__host__ __device__ constexpr int bwd_rows(int c) { return c <= 384 ? 32 : 16; }

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

// ---- pass B: part[s][m][n] = sum over rows r of segment s of A[r][m] B[r][n]

constexpr int AT = 64;  // output tile edge
constexpr int AR = 32;  // rows staged per step (fp32)

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

// pass C, two sums in a fixed order of a [rows, n] fp32 partial over its rows.
// The segments' weight partials (a few rows, H C columns): one thread a
// column, the rows in order.
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

// The row tiles' column partials (up to M / 32 rows, 3 C + H columns): 32
// columns a block, 8 row groups of threads each summing every 8th row in
// order, then the groups in order.
__global__ void __launch_bounds__(256) colsum_kernel(const float* __restrict__ part,
                                                     int64_t rows, int64_t n,
                                                     float* __restrict__ out) {
  __shared__ float red[8][32];
  const int64_t c = blockIdx.x * 32ll + threadIdx.x % 32;
  const int rg = threadIdx.x / 32;
  float s = 0.f;
  if (c < n)
    for (int64_t r = rg; r < rows; r += 8) s += part[r * n + c];
  red[rg][threadIdx.x % 32] = s;
  __syncthreads();
  if (rg == 0 && c < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][threadIdx.x];
    out[c] = t;
  }
}

cudaError_t colsum(const float* part, int64_t rows, int64_t n, float* out, cudaStream_t stream) {
  colsum_kernel<<<static_cast<unsigned>((n + 31) / 32), 256, 0, stream>>>(part, rows, n, out);
  return cudaGetLastError();
}

cudaError_t atb_f32(const float* A, const float* B, float* part, int M, int Ma, int Nb,
                    int segments, int64_t seg_stride, cudaStream_t stream) {
  const int rows_per_seg = (M + segments - 1) / segments;
  const dim3 grid((Nb + AT - 1) / AT, (Ma + AT - 1) / AT, segments);
  atb_kernel_f32<<<grid, THREADS, 0, stream>>>(A, B, part, M, Ma, Nb, rows_per_seg, seg_stride);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *gamma, *beta, *w1, *b1, *w2, *dy;
  void *dx, *zc, *hc, *duc;
  float *dz, *col_part, *col_out, *w_part, *w_out;
  int M, H, segments, parts;  // parts: bf16's hidden parts of the row pass
  float eps;
};

// fp32: pass A on the FMA pipes, pass B, pass C.
template <int C, bool LN>
cudaError_t launch_bwd_f32(const BwdArgs& a, cudaStream_t stream) {
  constexpr int TM = bwd_rows(C);
  const int tiles = (a.M + TM - 1) / TM;
  const size_t smem = rows_smem_floats<C>() * sizeof(float);
  cudaError_t err = allow_smem(ln_mlp_bwd_rows_kernel<float, C, LN>, smem);
  if (err != cudaSuccess) return err;
  ln_mlp_bwd_rows_kernel<float, C, LN><<<tiles, THREADS, smem, stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.gamma),
      static_cast<const float*>(a.beta), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const float*>(a.w2),
      static_cast<const float*>(a.dy), static_cast<float*>(a.dx), static_cast<float*>(a.zc),
      static_cast<float*>(a.hc), static_cast<float*>(a.duc), a.col_part, a.M, a.H, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t hcn = static_cast<int64_t>(a.H) * C;
  // dW1 [H, C] = du^T z (x without LN); dW2 [C, H] = dy^T h; both in one
  // partial buffer
  const void* z = LN ? a.zc : a.x;
  err = atb_f32(static_cast<const float*>(a.duc), static_cast<const float*>(z), a.w_part, a.M,
                a.H, C, a.segments, 2 * hcn, stream);
  if (err != cudaSuccess) return err;
  err = atb_f32(static_cast<const float*>(a.dy), static_cast<const float*>(a.hc), a.w_part + hcn,
                a.M, C, a.H, a.segments, 2 * hcn, stream);
  if (err != cudaSuccess) return err;
  err = sum_segments(a.w_part, a.segments, 2 * hcn, a.w_out, stream);
  if (err != cudaSuccess) return err;
  return colsum(a.col_part, tiles, 3 * C + a.H, a.col_out, stream);
}

// bf16: ln_mlp_bwd_sm90.cuh's row pass, dz = du W1 and the LayerNorm
// backward, the weight products, then the fixed-order sums. x, dy, the
// weights, zc, hc and duc 16-byte aligned; H % 64 == 0.
template <int C, bool LN>
cudaError_t launch_bwd_sm90(const BwdArgs& a, cudaStream_t stream) {
  using F = lnbwd::Form<C>;
  using bf16 = __nv_bfloat16;
  if (a.H % lnbwd::kHC) return cudaErrorInvalidValue;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t M = a.M, H = a.H;
  CUtensorMap tw1, tw2, tdu, tz, tdy, th;
  cudaError_t err = wg::make_tma_2d(&tw1, kBf16, a.w1, H, C, 2 * C, 64, 64);  // w1 [H, C]
  if (err == cudaSuccess) err = wg::make_tma_2d(&tw2, kBf16, a.w2, C, H, 2 * H, 64, 64);
  if (err == cudaSuccess) err = wg::make_tma_2d(&tdu, kBf16, a.duc, M, H, 2 * H, 64, 64);
  if (err == cudaSuccess)
    err = wg::make_tma_2d(&tz, kBf16, LN ? a.zc : a.x, M, C, 2 * C, 64, 64);
  if (err == cudaSuccess) err = wg::make_tma_2d(&tdy, kBf16, a.dy, M, C, 2 * C, 64, 64);
  if (err == cudaSuccess) err = wg::make_tma_2d(&th, kBf16, a.hc, M, H, 2 * H, 64, 64);
  auto rows = lnbwd::ln_mlp_bwd_rows_sm90_kernel<C, LN>;
  if (err == cudaSuccess) err = allow_smem(rows, F::kSmem);
  constexpr size_t kGs = lnbwd::wgemm::kSmem;
  if (err == cudaSuccess) err = allow_smem(lnbwd::wgemm_f32_sm90_kernel<false>, kGs);
  if (err == cudaSuccess) err = allow_smem(lnbwd::wgemm_f32_sm90_kernel<true>, kGs);
  if (err != cudaSuccess) return err;
  const int tiles = (a.M + 63) / 64;  // col_part rows: 64 token rows each
  // A. u, dh -> h, du (and z), db1's partials
  if (a.parts < 1 || a.parts > a.H / lnbwd::kHC) return cudaErrorInvalidValue;
  rows<<<dim3(static_cast<unsigned>((M + F::BM - 1) / F::BM), a.parts), F::kThreads, F::kSmem,
         stream>>>(
      tw1, tw2, static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.gamma),
      static_cast<const bf16*>(a.beta), static_cast<const bf16*>(a.b1),
      static_cast<const bf16*>(a.dy), static_cast<bf16*>(a.zc), static_cast<bf16*>(a.hc),
      static_cast<bf16*>(a.duc), a.col_part, a.M, a.H, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // B. dz = du W1 (fp32), then the LayerNorm backward and the partials of
  // dgamma, dbeta and db2
  constexpr unsigned kG = lnbwd::wgemm::kThreads;
  const unsigned mt = static_cast<unsigned>((M + 63) / 64);
  lnbwd::wgemm_f32_sm90_kernel<false><<<dim3((C + 127) / 128, mt, 1), kG, kGs, stream>>>(
      tdu, tw1, a.dz, a.M, C, a.H, (a.H + 63) / 64 * 64);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  lnbwd::ln_bwd_rows_kernel<C, LN><<<tiles, 256, 0, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.gamma), a.dz,
      static_cast<const bf16*>(a.dy), static_cast<bf16*>(a.dx), a.col_part, a.M, a.H, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // C. dW1 [H, C] = du^T z, dW2 [C, H] = dy^T h per segment of whole 64-row
  // tiles, then the sums
  const int per = ((a.M + a.segments - 1) / a.segments + 63) / 64 * 64;
  const int64_t hcn = static_cast<int64_t>(a.H) * C;
  lnbwd::wgemm_f32_sm90_kernel<true><<<dim3((C + 127) / 128, (a.H + 63) / 64, a.segments), kG, kGs,
                                  stream>>>(tdu, tz, a.w_part, a.H, C, a.M, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  lnbwd::wgemm_f32_sm90_kernel<true><<<dim3((a.H + 127) / 128, (C + 63) / 64, a.segments), kG, kGs,
                                  stream>>>(tdy, th, a.w_part + a.segments * hcn, C, a.H, a.M,
                                            per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // w_part: dW1's segments, then dW2's
  err = sum_segments(a.w_part, a.segments, hcn, a.w_out, stream);
  if (err != cudaSuccess) return err;
  err = sum_segments(a.w_part + a.segments * hcn, a.segments, hcn, a.w_out + hcn, stream);
  if (err != cudaSuccess) return err;
  return colsum(a.col_part, tiles, 3 * C + a.H, a.col_out, stream);
}

template <bool LN>
cudaError_t dispatch_bwd(const BwdArgs& a, int C, int dtype, cudaStream_t s) {
  if (a.M <= 0 || a.segments <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    switch (C) {
      case 96: return launch_bwd_f32<96, LN>(a, s);
      case 192: return launch_bwd_f32<192, LN>(a, s);
      case 320: return launch_bwd_f32<320, LN>(a, s);
      case 384: return launch_bwd_f32<384, LN>(a, s);
      case 512: return launch_bwd_f32<512, LN>(a, s);
      case 768: return launch_bwd_f32<768, LN>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  switch (C) {
    case 96: return launch_bwd_sm90<96, LN>(a, s);
    case 192: return launch_bwd_sm90<192, LN>(a, s);
    case 320: return launch_bwd_sm90<320, LN>(a, s);
    case 384: return launch_bwd_sm90<384, LN>(a, s);
    case 512: return launch_bwd_sm90<512, LN>(a, s);
    case 768: return launch_bwd_sm90<768, LN>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mspi

// Rows per row of col_part at width C and dtype (fp32: pass A's rows per
// block; bf16: 64): the wrapper sizes col_part [ceil(M / rows), 3C + H] with
// it.
extern "C" int mspi_ln_mlp_bwd_rows(int C, int dtype) {
  return dtype == mspi::kBFloat16 ? 64 : mspi::bwd_rows(C);
}

// x, dy, dx: [M, C]; gamma, beta: [C]; w1: [H, C]; b1: [H]; w2: [C, H], all of
// one dtype (0 fp32, 1 bf16), contiguous. Scratch: zc [M, C], hc and duc
// [M, H] in that dtype; dz [M, C] fp32 (bf16 only); col_part [tiles, 3C+H],
// w_part [segments, 2HC] fp32. parts (bf16): the row pass's hidden parts,
// 1 to H / 64. Outputs in fp32: col_out [3C+H] = dgamma |
// dbeta | db2 | db1 and w_out [2HC] = dW1 [H, C] | dW2 [C, H]. Returns a
// cudaError_t code.
extern "C" int mspi_ln_mlp_bwd(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* dy,
                               void* dx, void* zc, void* hc, void* duc, float* dz,
                               float* col_part, float* col_out, float* w_part, float* w_out,
                               int M, int C, int H, float eps, int segments, int parts,
                               int dtype, void* stream) {
  const mspi::BwdArgs a{x, gamma, beta, w1, b1, w2, dy, dx, zc, hc, duc,
                        dz, col_part, col_out, w_part, w_out, M, H, segments, parts, eps};
  return mspi::dispatch_bwd<true>(a, C, dtype, static_cast<cudaStream_t>(stream));
}

// Row 14, the backward of y = fc2(gelu(fc1(x))): as mspi_ln_mlp_bwd without
// gamma, beta and the z scratch (dW1 takes x); col_out's dgamma and dbeta
// columns come back zero.
extern "C" int mspi_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* dy, void* dx, void* hc, void* duc, float* dz,
                            float* col_part, float* col_out, float* w_part, float* w_out, int M,
                            int C, int H, int segments, int parts, int dtype, void* stream) {
  const mspi::BwdArgs a{x, nullptr, nullptr, w1, b1, w2, dy, dx, nullptr, hc, duc,
                        dz, col_part, col_out, w_part, w_out, M, H, segments, parts, 0.f};
  return mspi::dispatch_bwd<false>(a, C, dtype, static_cast<cudaStream_t>(stream));
}
