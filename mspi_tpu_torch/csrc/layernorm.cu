// LayerNorm alone over the channels of token-major rows x [M, C].
//
// Replaces: mspi_tpu/ops/pallas/mlp.py::fused_ln_t (kernel _ln_only_kernel_t),
// the ConvNeXt prior's stem and downsample LayerNorms with MSPI_PRIOR_LN_T=1.
// That kernel normalised the sublane axis of an [N, C, B*T] layout that
// existed only for the TPU's batch-minor lanes; the prior's tokens here are
// channels-last, so this kernel normalises rows.
//
// Numerics follow the TPU kernel: statistics in fp32 with var = E[x^2] -
// mu^2, y = (x - mu) * rsqrt(var + eps) * gamma + beta with each product
// and sum rounded on its own, one cast to the storage type.
//
// What bounds it on the card: device memory, one read and one write of x
// (about 10 flops per element against 4 or 8 bytes).
//
// Design: one warp per row, C / 32 values per lane held in registers (C is a
// template parameter), warp-shuffle sums, 8 rows per 256-thread block.
// Neighbouring lanes read neighbouring channels, so each load and store of a
// warp is contiguous.

#include <stdint.h>

#include "common.cuh"

namespace mspi {
namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_ROWS = LN_THREADS / 32;

template <typename T, int C>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                 const T* __restrict__ beta, T* __restrict__ y, int M, float eps) {
  constexpr int PER = C / 32;
  static_assert(C % 32 == 0, "C must be a multiple of 32");
  const int lane = threadIdx.x & 31;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * LN_ROWS + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* xr = x + m * C;
  float v[PER];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = to_f(xr[lane + 32 * i]);
    s = __fadd_rn(s, v[i]);
    q = __fadd_rn(q, __fmul_rn(v[i], v[i]));
  }
  const float mu = warp_sum(s) / C;
  const float var = __fsub_rn(warp_sum(q) / C, __fmul_rn(mu, mu));
  const float rstd = 1.f / sqrtf(__fadd_rn(var, eps));
  T* yr = y + m * C;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    yr[c] = from_f<T>(
        __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mu), rstd), to_f(gamma[c])), to_f(beta[c])));
  }
}

template <typename T, int C>
cudaError_t launch_layernorm(const void* x, const void* g, const void* b, void* y, int M,
                             float eps, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(M) + LN_ROWS - 1) / LN_ROWS);
  layernorm_kernel<T, C><<<blocks, LN_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(y), M, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_layernorm(const void* x, const void* g, const void* b, void* y, int M,
                               int C, float eps, cudaStream_t s) {
  switch (C) {
    case 96: return launch_layernorm<T, 96>(x, g, b, y, M, eps, s);
    case 192: return launch_layernorm<T, 192>(x, g, b, y, M, eps, s);
    case 384: return launch_layernorm<T, 384>(x, g, b, y, M, eps, s);
    case 768: return launch_layernorm<T, 768>(x, g, b, y, M, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mspi

// x, y: [M, C]; gamma, beta: [C]; all of one dtype (0 fp32, 1 bf16),
// contiguous. Returns a cudaError_t code.
extern "C" int mspi_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                              int M, int C, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kFloat32)
    return mspi::dispatch_layernorm<float>(x, gamma, beta, y, M, C, eps, s);
  if (dtype == mspi::kBFloat16)
    return mspi::dispatch_layernorm<__nv_bfloat16>(x, gamma, beta, y, M, C, eps, s);
  return cudaErrorInvalidValue;
}
