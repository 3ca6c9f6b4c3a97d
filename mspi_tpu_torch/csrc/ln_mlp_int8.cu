// Row 12's entry (mspi_ln_mlp_int8): the int8 LayerNorm + MLP forward of
// ln_mlp_int8_sm90.cuh (its numerics and design are described there) at the
// widths and storage types it is compiled for. The int8 lab's entry,
// mspi_mlp_int8_lab, is mlp_int8_lab.cu: the same body in its lab variant,
// in a translation unit of its own so that the two compile in parallel.
//
// Replaces: mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp_int8 (kernel
// _ln_fwd_kernel_q).

#include "ln_mlp_int8_sm90.cuh"

namespace mspi {
namespace {

template <typename T>
cudaError_t dispatch_int8(const void* x, const float* g, const float* be, const int8_t* w1q,
                          const float* s1, const float* b1, const int8_t* w2q,
                          const float* s2, const float* b2, void* y, int M, int C, int H,
                          float eps, cudaStream_t s) {
  switch (C) {
    case 256: return launch_int8_sm90<T, 256>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    case 320: return launch_int8_sm90<T, 320>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    case 384: return launch_int8_sm90<T, 384>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    case 512: return launch_int8_sm90<T, 512>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    case 768: return launch_int8_sm90<T, 768>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mspi

// x, y: [M, C] of one dtype (0 fp32, 1 bf16); gamma, beta, s2, b2: [C] fp32;
// w1q: [H, C] int8, s1, b1: [H] fp32; w2q: [C, H] int8; all contiguous, the
// int8 codes 16-byte aligned, x, y and the vectors 8-byte aligned; H % 128
// == 0. Returns a cudaError_t code.
extern "C" int mspi_ln_mlp_int8(const void* x, const void* gamma, const void* beta,
                                const void* w1q, const void* s1, const void* b1,
                                const void* w2q, const void* s2, const void* b2, void* y,
                                int M, int C, int H, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* q1 = static_cast<const int8_t*>(w1q);
  const auto* q2 = static_cast<const int8_t*>(w2q);
  const auto* sc1 = static_cast<const float*>(s1);
  const auto* sc2 = static_cast<const float*>(s2);
  const auto* bb1 = static_cast<const float*>(b1);
  const auto* bb2 = static_cast<const float*>(b2);
  const void* pairs[] = {x, y, s1, b1, s2, b2};  // read and written two elements at a time
  for (const void* p : pairs)
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(w1q) % 16 != 0 || reinterpret_cast<uintptr_t>(w2q) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (dtype == mspi::kFloat32)
    return mspi::dispatch_int8<float>(x, g, be, q1, sc1, bb1, q2, sc2, bb2, y, M, C, H, eps, s);
  if (dtype == mspi::kBFloat16)
    return mspi::dispatch_int8<__nv_bfloat16>(x, g, be, q1, sc1, bb1, q2, sc2, bb2, y, M, C, H,
                                              eps, s);
  return cudaErrorInvalidValue;
}

