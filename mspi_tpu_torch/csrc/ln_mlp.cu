// Fused LayerNorm + MLP forward: y = fc2(gelu(fc1(LN(x)))) on token-major
// rows x [M, C].
//
// Replaces: mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp (kernel _ln_fwd_kernel),
// used by the MViT, SyncBlock and decoder ConvNextBlock3d MLPs. It also
// serves the call site of mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp_t
// (_ln_fwd_kernel_t), the ConvNeXt prior's LN+MLP: that kernel's [N, C, B*T]
// layout exists only for the TPU's batch-minor lane tiling, and what it
// computes is this kernel's forward with eps 1e-6, so the port's
// ConvNeXtBlock2d calls this kernel on its channels-last [B*T*H*W, C] tokens.
//
// Numerics follow the TPU kernel: LayerNorm statistics in fp32, the
// normalised z rounded to the storage type before fc1, fc1 accumulated in
// fp32, exact erf GELU, h rounded to the storage type before fc2, fc2
// accumulated in fp32, y rounded once on the way out. Residual, drop-path
// and layer-scale stay with the caller, except in the residual-folded form:
//
// Also replaces mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp_t_res
// (_ln_fwd_kernel_t_res, MSPI_PRIOR_FOLD_RES=1), the ConvNeXt prior's block
// tail shortcut + gamma * y. With a shortcut and a gamma (template flag RES,
// non-null pointers) the epilogue reads the shortcut and writes
// cast(float(shortcut) + float(gamma) * y) with y still in fp32, so y never
// reaches device memory; gamma comes in the storage type, as the JAX package
// passes gamma.astype(dt). Products and the sum are rounded separately
// (__fmul_rn/__fadd_rn, no contraction), as the plain version computes them.
//
// What bounds it on the card: the two matmuls, 4*C*H flops per row against
// 2*C values read and written per row -- at C >= 96 the arithmetic (and the
// weights streaming from L2 once per row tile), not device memory.
//
// Design: one block per tile of rows. The normalised tile z [rows, C] stays
// in shared memory for the whole block; the hidden dimension is walked in
// chunks of HC = 64 units: u = z W1[chunk]^T, h = gelu(u + b1) into shared
// memory, y += h W2[:, chunk]^T. The [rows, C] fp32 accumulator stays in
// registers, so the 4C hidden activation never reaches device memory and y
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

// LayerNorm of rows row0 .. row0+ROWS-1 of x into zs (row pitch ldz), one warp
// per row: fp32 statistics (two passes over registers), the result rounded to
// the storage type T and stored as Z. Rows at or past M are zeros.
template <typename T, typename Z, int C, int ROWS>
__device__ __forceinline__ void layernorm_tile(const T* __restrict__ x,
                                               const T* __restrict__ gamma,
                                               const T* __restrict__ beta, Z* zs, int ldz,
                                               int64_t row0, int M, float eps) {
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
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = to_f(xr[lane + 32 * i]);
      s += v[i];
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) q += (v[i] - mu) * (v[i] - mu);
    const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      zr[c] = from_f<Z>(round_to<T>((v[i] - mu) * rstd * to_f(gamma[c]) + to_f(beta[c])));
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

// y = acc + b2, or with RES the folded residual shortcut + res_gamma * y.
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

template <typename T, int C, bool RES>
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

  // 1. LayerNorm of the tile into shared memory.
  layernorm_tile<T, float, C, TM>(x, gamma, beta, zs, C, row0, M, eps);
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
        if (j < H) {
          const float v = u[i][s] + to_f(b1[j]);
          h = round_to<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
        }
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
        y[m * C + c] = epilogue<T, RES>(acc[i][n], to_f(b2[c]), shortcut, res_gamma,
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

// Every WMMA load/store address is a multiple of 32 bytes: tile origins sit
// at multiples of 16 rows and 16 columns, all pitches are multiples of 8
// elements, and the wrapper passes 32-byte aligned operands.
template <int C, bool RES>
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

  layernorm_tile<bf16, bf16, C, ROWS>(x, gamma, beta, zs, LDZ, row0, M, eps);
  __syncthreads();

  // y accumulators: every row tile, column tiles warp + 8*i
  FragC yacc[RT][CPW];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < CPW; ++i) wmma::fill_fragment(yacc[r][i], 0.f);

  for (int j0 = 0; j0 < H; j0 += HC) {
    // u[ROWS, 64] = z W1[j0:j0+64]^T: warp -> column tile warp%4, row tiles
    // (warp/4)*RPW .. +RPW-1, one W1 fragment per k step for all of them
    {
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
    }
    __syncthreads();
    // h = gelu(u + b1), rounded to bf16
    for (int e = tid; e < ROWS * HC; e += THREADS) {
      const int r = e / HC, j = e % HC;
      const float v = us[r * TC_LDU + j] + to_f(b1[j0 + j]);
      hs[r * TC_LDH + j] = from_f<bf16>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
    }
    __syncthreads();
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
        if (m < M) y[m * C + c] = epilogue<bf16, RES>(sc[e], to_f(b2[c]), shortcut, res_gamma,
                                                      m * C + c, c);
      }
      __syncwarp();
    }
}

template <typename T, int C, bool RES>
cudaError_t launch_ln_mlp(const void* x, const void* g, const void* be, const void* w1,
                          const void* b1, const void* w2, const void* b2, const void* sc,
                          const void* rg, void* y, int M, int H, float eps,
                          cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int rows = 16 * tc_row_tiles<C>();
    const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(M) + rows - 1) / rows);
    if (H % HC != 0) return cudaErrorInvalidValue;
    const size_t smem = ln_mlp_tc_smem_bytes<C>();
    cudaError_t err = allow_smem(ln_mlp_tc_kernel<C, RES>, smem);
    if (err != cudaSuccess) return err;
    ln_mlp_tc_kernel<C, RES><<<blocks, THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(be), static_cast<const bf16*>(w1),
        static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
        static_cast<const bf16*>(b2), static_cast<const bf16*>(sc),
        static_cast<const bf16*>(rg), static_cast<bf16*>(y), M, H, eps);
  } else {
    const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(M) + TM - 1) / TM);
    const size_t smem = ln_mlp_smem_floats<C>() * sizeof(float);
    cudaError_t err = allow_smem(ln_mlp_kernel<T, C, RES>, smem);
    if (err != cudaSuccess) return err;
    ln_mlp_kernel<T, C, RES><<<blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(be),
        static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<const T*>(sc), static_cast<const T*>(rg),
        static_cast<T*>(y), M, H, eps);
  }
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_res(const void* x, const void* g, const void* be, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* sc,
                       const void* rg, void* y, int M, int H, float eps, cudaStream_t s) {
  if (sc != nullptr) {
    if (rg == nullptr) return cudaErrorInvalidValue;
    return launch_ln_mlp<T, C, true>(x, g, be, w1, b1, w2, b2, sc, rg, y, M, H, eps, s);
  }
  return launch_ln_mlp<T, C, false>(x, g, be, w1, b1, w2, b2, sc, rg, y, M, H, eps, s);
}

template <typename T>
cudaError_t dispatch_c(const void* x, const void* g, const void* be, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* sc,
                       const void* rg, void* y, int M, int C, int H, float eps,
                       cudaStream_t s) {
  switch (C) {
    case 96: return launch_res<T, 96>(x, g, be, w1, b1, w2, b2, sc, rg, y, M, H, eps, s);
    case 192: return launch_res<T, 192>(x, g, be, w1, b1, w2, b2, sc, rg, y, M, H, eps, s);
    case 384: return launch_res<T, 384>(x, g, be, w1, b1, w2, b2, sc, rg, y, M, H, eps, s);
    case 512: return launch_res<T, 512>(x, g, be, w1, b1, w2, b2, sc, rg, y, M, H, eps, s);
    case 768: return launch_res<T, 768>(x, g, be, w1, b1, w2, b2, sc, rg, y, M, H, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mspi

// x, y: [M, C]; gamma, beta, b2: [C]; w1: [H, C]; b1: [H]; w2: [C, H]; all of
// one dtype (0 fp32, 1 bf16), contiguous. shortcut [M, C] and res_gamma [C]
// are both null (y = mlp(LN(x))) or both set (y = shortcut + res_gamma *
// mlp(LN(x)), row 10). Returns a cudaError_t code.
extern "C" int mspi_ln_mlp(const void* x, const void* gamma, const void* beta,
                           const void* w1, const void* b1, const void* w2, const void* b2,
                           const void* shortcut, const void* res_gamma, void* y, int M, int C,
                           int H, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kFloat32)
    return mspi::dispatch_c<float>(x, gamma, beta, w1, b1, w2, b2, shortcut, res_gamma, y, M,
                                   C, H, eps, s);
  if (dtype == mspi::kBFloat16)
    return mspi::dispatch_c<__nv_bfloat16>(x, gamma, beta, w1, b1, w2, b2, shortcut,
                                           res_gamma, y, M, C, H, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mspi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
