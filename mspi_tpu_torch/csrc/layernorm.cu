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
// (about 10 flops per element against 4 or 8 bytes). At the serving
// forward's shapes ([688128, 96] twice, [172032, 192], [43008, 384] in
// bf16) that is 727 MB, 0.217 ms at 3.35 TB/s.
//
// Design (layernorm_sm90_kernel; ops/kernels/layernorm.py::layernorm_form
// mirrors the form):
// - A row belongs to a group of LPR = C / 24 lanes (4, 8, 16 or 32 at C =
//   96, 192, 384, 768), each owning 24 channels as 16-byte chunks t, t +
//   LPR, ... of the row (3 of 8 bf16, 6 of 4 fp32), so a warp takes 32 / LPR
//   rows a step and each of its loads and stores covers whole 64-byte runs
//   of consecutive rows. The group's sums are xor-shuffles within it.
// - Persistent: a grid of as many blocks as fit on the SMs at once (2 of 256
//   threads, by __launch_bounds__: at 3, bf16 spilled ~100 bytes at 80
//   registers), each warp walking row steps warp, warp + all warps, ...; a
//   lane's channels never change, so its gamma and beta are read once into
//   registers.
// - The loads of the next DEPTH steps are in flight during a step's
//   arithmetic (2 in bf16, 1 in fp32, whose rows take twice the registers):
//   96 bytes a thread beside the stores, 48 KB an SM. x is read and y
//   written once, with the streaming cache hints (ld.global.cs,
//   st.global.cs): 3.5% faster per serving forward than plain loads and
//   stores, where a third step in flight was 2% slower and spilled (PERF.md).
// - x or y not 16-byte aligned (a view at an element offset): the same
//   walk with one element per load and store (VEC = false), chosen at
//   launch. Any M, rows past it neither read nor written.

#include <stdint.h>

#include "common.cuh"

namespace mspi {
namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_PER = 24;  // channels a lane

// The form at width C in storage type T: lanes per row, 16-byte chunks a
// lane, rows a warp step, resident blocks per SM, steps whose loads are in
// flight ahead of the one computed.
template <typename T, int C>
struct LnForm {
  static constexpr int EPV = 16 / sizeof(T);  // elements a 16-byte chunk
  static constexpr int LPR = C / LN_PER;
  static constexpr int ACC = LN_PER / EPV;
  static constexpr int RPW = 32 / LPR;
  static constexpr int BLOCKS = 2;
  static constexpr int DEPTH = sizeof(T) == 2 ? 2 : 1;
  static_assert(C % LN_PER == 0 && 32 % LPR == 0 && LPR <= 32, "a row on 2^k lanes");
};

// Element j of the lane's 24 channels in the raw chunks r: chunk j / EPV.
template <typename T, int ACC>
__device__ __forceinline__ float elem(const uint4 (&r)[ACC], int j) {
  return to_f(reinterpret_cast<const T*>(r)[j]);
}

// Row m's chunks of the lane (t: its place in the row's group) into r;
// zeros past M. VEC: 16-byte loads, else one element a load.
template <typename T, int C, bool VEC>
__device__ __forceinline__ void load_row(uint4 (&r)[LnForm<T, C>::ACC], const T* __restrict__ x,
                                         int64_t m, int M, int t) {
  using F = LnForm<T, C>;
#pragma unroll
  for (int i = 0; i < F::ACC; ++i) {
    const int64_t at = m * C + static_cast<int64_t>(t + F::LPR * i) * F::EPV;
    if constexpr (VEC) {
      r[i] = m < M ? __ldcs(reinterpret_cast<const uint4*>(x + at)) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      T* e = reinterpret_cast<T*>(&r[i]);
#pragma unroll
      for (int k = 0; k < F::EPV; ++k) e[k] = m < M ? x[at + k] : from_f<T>(0.f);
    }
  }
}

template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(LN_THREADS, LnForm<T, C>::BLOCKS)
    layernorm_sm90_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                          const T* __restrict__ beta, T* __restrict__ y, int M, float eps) {
  using F = LnForm<T, C>;
  constexpr int LPR = F::LPR, ACC = F::ACC, EPV = F::EPV, RPW = F::RPW, DEPTH = F::DEPTH;
  const int lane = threadIdx.x & 31, t = lane % LPR;
  const int64_t steps = (static_cast<int64_t>(M) + RPW - 1) / RPW;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (LN_THREADS / 32);
  int64_t step = (static_cast<int64_t>(blockIdx.x) * LN_THREADS + threadIdx.x) / 32;

  // the lane's gamma and beta in their storage type, one element a load
  // (the vectors need no alignment)
  uint4 g[ACC], b[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    T* ge = reinterpret_cast<T*>(&g[i]);
    T* be = reinterpret_cast<T*>(&b[i]);
#pragma unroll
    for (int k = 0; k < EPV; ++k) {
      ge[k] = gamma[(t + LPR * i) * EPV + k];
      be[k] = beta[(t + LPR * i) * EPV + k];
    }
  }

  // buf[0]: the step computed; buf[1..DEPTH]: the next steps' rows in flight
  uint4 buf[DEPTH + 1][ACC];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (step + d * warps < steps)
      load_row<T, C, VEC>(buf[d], x, (step + d * warps) * RPW + lane / LPR, M, t);
  for (; step < steps; step += warps) {
    const int64_t m = step * RPW + lane / LPR;
    if (step + DEPTH * warps < steps)
      load_row<T, C, VEC>(buf[DEPTH], x, (step + DEPTH * warps) * RPW + lane / LPR, M, t);
    const uint4(&cur)[ACC] = buf[0];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < LN_PER; ++j) {
      const float v = elem<T>(cur, j);
      s = __fadd_rn(s, v);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, o));
    }
    const float mu = s / C;
    const float var = __fsub_rn(q / C, __fmul_rn(mu, mu));
    const float rstd = 1.f / sqrtf(__fadd_rn(var, eps));
    if (m < M) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < EPV; ++k) {
          const int j = i * EPV + k;
          oe[k] = from_f<T>(__fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(elem<T>(cur, j), mu), rstd), elem<T>(g, j)),
              elem<T>(b, j)));
        }
        const int64_t at = m * C + static_cast<int64_t>(t + LPR * i) * EPV;
        if constexpr (VEC) {
          __stcs(reinterpret_cast<uint4*>(y + at), out);
        } else {
#pragma unroll
          for (int k = 0; k < EPV; ++k) y[at + k] = oe[k];
        }
      }
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
#pragma unroll
      for (int i = 0; i < ACC; ++i) buf[d][i] = buf[d + 1][i];
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int C, bool VEC>
cudaError_t launch_layernorm_form(const void* x, const void* g, const void* b, void* y, int M,
                                  float eps, cudaStream_t s) {
  using F = LnForm<T, C>;
  auto kernel = layernorm_sm90_kernel<T, C, VEC>;
  static int sms = 0, per_sm = 0;  // the grid's resident blocks, asked once per form
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LN_THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  const int64_t steps = (static_cast<int64_t>(M) + F::RPW - 1) / F::RPW;
  const int64_t need = (steps + LN_THREADS / 32 - 1) / (LN_THREADS / 32);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(need < resident ? need : resident);
  kernel<<<blocks, LN_THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                                       static_cast<const T*>(b), static_cast<T*>(y), M, eps);
  return cudaGetLastError();
}

// The 16-byte form when x and y both start 16 bytes aligned (every row then
// does: C * sizeof(T) is a multiple of 16), else the scalar one.
template <typename T, int C>
cudaError_t launch_layernorm(const void* x, const void* g, const void* b, void* y, int M,
                             float eps, cudaStream_t s) {
  if (aligned16(x) && aligned16(y))
    return launch_layernorm_form<T, C, true>(x, g, b, y, M, eps, s);
  return launch_layernorm_form<T, C, false>(x, g, b, y, M, eps, s);
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
// contiguous, at any alignment of their element type. Returns a cudaError_t
// code.
extern "C" int mspi_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                              int M, int C, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return M == 0 ? cudaSuccess : cudaErrorInvalidValue;
  if (dtype == mspi::kFloat32)
    return mspi::dispatch_layernorm<float>(x, gamma, beta, y, M, C, eps, s);
  if (dtype == mspi::kBFloat16)
    return mspi::dispatch_layernorm<__nv_bfloat16>(x, gamma, beta, y, M, C, eps, s);
  return cudaErrorInvalidValue;
}
