// The fused (LayerNorm +) MLP forward body of fp32 K2, rows 10 and 13
// (ln_mlp.cu), y = fc2(gelu(fc1(LN(x)))) on token-major rows x [M, C], and
// the variants (MlpVariant) that it and the bf16 wgmma body
// (ln_mlp_sm90.cuh: K2, K3, rows 10 and 13, and the kernel labs' bodies in
// lnmlp_lab.cu) are compiled in.
//
// A variant fixes at compile time what the body computes:
//   LN    kLnNone: z = x; kLnTwoPass: K2's LayerNorm (mean, then the centred
//         second moment); kLnFastVar: var = E[x^2] - mu^2 from one pass (the
//         JAX package's _ln_f32, the labs' LN); kLnTensorStats: the same
//         statistics with the row sums taken on the tensor cores (the bf16
//         body only);
//   GELU  exact erf GELU between the products, or none;
//   BIAS  b1 and b2 added, or neither;
//   RES   the residual-folded epilogue shortcut + res_gamma * y (row 10);
//   PIPE  the bf16 body's GELU slices a hidden chunk between the next
//         chunk's fc1 products (the lab's pipe4: 4); 0, the form's own.
// This body takes K2's, row 10's and row 13's variants.
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
// Design: one block per tile of 32 rows on the fp32 FMA pipes (tensor cores
// would round to TF32). The normalised tile z [rows, C] stays in shared
// memory for the whole block; the hidden dimension is walked in chunks of
// HC = 64 units: u = z W1[chunk]^T, h = act(u + b1) into shared memory, y +=
// h W2[:, chunk]^T, weights staged through shared memory, 4 rows x C/32
// columns per thread. The [rows, C] fp32 accumulator stays in registers, so
// the hidden activation never reaches device memory and y is written once.
// Shared memory is at most 164 KB (C = 768), inside the 227 KB a block may
// use.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mspi {
namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 32;       // rows per block
constexpr int HC = 64;       // hidden units per chunk
constexpr int KS = 32;       // W1 columns (input features) staged per step
constexpr int JS = 16;       // W2 columns (hidden units) staged per step
constexpr int THREADS = 256; // 8 warps

constexpr int kLnNone = 0;
constexpr int kLnTwoPass = 1;
constexpr int kLnFastVar = 2;
constexpr int kLnTensorStats = 3;

template <int LN_, bool GELU_ = true, bool BIAS_ = true, bool RES_ = false, int PIPE_ = 0>
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

// The LayerNorm stage of rows row0 .. row0+ROWS-1 of x
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
  static_assert(V::GELU && V::BIAS && V::PIPE == 0 && V::LN != kLnTensorStats,
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

// The fp32 launch (ln_mlp.cu: fp32 K2, row 10 and row 13).
template <typename T, int C, class V>
cudaError_t launch_ln_mlp(const MlpArgs& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(a.M) + TM - 1) / TM);
  const size_t smem = ln_mlp_smem_floats<C>() * sizeof(float);
  cudaError_t err = allow_smem(ln_mlp_kernel<T, C, V>, smem);
  if (err != cudaSuccess) return err;
  ln_mlp_kernel<T, C, V><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), static_cast<const T*>(a.be),
      static_cast<const T*>(a.w1), static_cast<const T*>(a.b1), static_cast<const T*>(a.w2),
      static_cast<const T*>(a.b2), static_cast<const T*>(a.sc), static_cast<const T*>(a.rg),
      static_cast<T*>(a.y), a.M, a.H, a.eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mspi
