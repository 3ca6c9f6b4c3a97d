// The int8 lab's mlp_int8w (tools/bench_int8.py::_mlp_call with
// _mlp_int8w_kernel): row 12's s8 wgmma + TMA body (ln_mlp_int8_sm90.cuh) in
// its lab variant (LAB: no LayerNorm, biases or GELU; the lab's divide-form
// quantisation; pass 2 once), at the lab's C = 96 and at row 12's widths
// 256, 384, 512 and 768, each in row 12's form at that width (Form<C>; C =
// 96 its three-consumer form). H % 64 == 0: where H % 128 == 64 the last
// step's 64 units take a W2 box that TMA fills with zeros past H, and a
// SHARED form's second consumer, whose units of that step lie past H, gives
// them the code 0.
//
// Replaces: tools/bench_int8.py::_mlp_call's int8 body. Its own translation
// unit, beside ln_mlp_int8.cu's row 12 entries, so that nvcc builds the two
// sets of instantiations in parallel.

#include "ln_mlp_int8_sm90.cuh"

namespace mspi {
namespace {

template <int C>
cudaError_t launch_lab(const void* x, const void* w1q, const void* s1, const void* w2q,
                       const void* s2, void* y, int M, int H, cudaStream_t stream) {
  return launch_int8_sm90<__nv_bfloat16, C, true>(
      x, nullptr, nullptr, static_cast<const int8_t*>(w1q), static_cast<const float*>(s1),
      nullptr, static_cast<const int8_t*>(w2q), static_cast<const float*>(s2), nullptr, y, M, H,
      0.f, stream);
}

}  // namespace
}  // namespace mspi

// x [M, C] bf16; w1q [H, C] int8 and s1 [H] fp32; w2q [C, H] int8 and s2 [C]
// fp32; y [M, C] bf16; contiguous, the codes 16-byte aligned, x, y and the
// scales 8-byte aligned; C in {96, 256, 384, 512, 768}, H % 64 == 0. Returns
// a cudaError_t code.
extern "C" int mspi_mlp_int8_lab(const void* x, const void* w1q, const void* s1,
                                 const void* w2q, const void* s2, void* y, int M, int C, int H,
                                 void* stream) {
  const void* pairs[] = {x, y, s1, s2};
  for (const void* p : pairs)
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(w1q) % 16 != 0 || reinterpret_cast<uintptr_t>(w2q) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return mspi::launch_lab<96>(x, w1q, s1, w2q, s2, y, M, H, s);
    case 256: return mspi::launch_lab<256>(x, w1q, s1, w2q, s2, y, M, H, s);
    case 384: return mspi::launch_lab<384>(x, w1q, s1, w2q, s2, y, M, H, s);
    case 512: return mspi::launch_lab<512>(x, w1q, s1, w2q, s2, y, M, H, s);
    case 768: return mspi::launch_lab<768>(x, w1q, s1, w2q, s2, y, M, H, s);
    default: return cudaErrorInvalidValue;
  }
}
