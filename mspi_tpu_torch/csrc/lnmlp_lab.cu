// The LN+MLP kernel lab: K2's bf16 wgmma + TMA body (ln_mlp_sm90.cuh) compiled
// in the variants that split its time into parts, at the lab's C = 96 only.
//
// Replaces: tools/bench_lnmlp.py::_call (its five Pallas bodies) and the
// bf16 body of tools/bench_int8.py::_mlp_call. Variant codes (the order of
// LAB_VARIANTS in ops/kernels/lab.py):
//   0 matmul       _k_matmul: (x W1^T + b1) -> bf16, then W2 + b2; no LN, no GELU
//   1 matmul_gelu  _k_matmul_gelu: the same with the GELU (row 13's variant)
//   2 ln_matmul    _k_ln_matmul: LN (var = E[x^2] - mu^2), then the two
//                  matmuls without the GELU
//   3 pipe2        _k_pipe, k = 2: the full LN+MLP on K2's own schedule at
//                  C = 96 (a chunk's GELU in two slices, one beside each W1
//                  box of the next chunk's fc1)
//   4 pipe4        _k_pipe, k = 4: the same function with the GELU in four
//                  slices, one beside each of four commit groups of fc1
//   5 mxu_stats    _k_mxu_stats: the full LN+MLP with the LN row sums taken on
//                  the tensor cores (X 1 and the diagonal of X X^T)
//   6 mlp_bf16     bench_int8.py::_mlp_bf16_kernel: x W1^T -> bf16 -> W2 ->
//                  bf16; no bias, no GELU
// The GELU is K2's erff, so that the split measures what K2 pays; the TPU
// bodies use the degree-16 fit of erf (within 2e-7 of it). pipe2 beside K2
// itself (kLnTwoPass, the same schedule) prices the one-pass LN.
//
// What bounds each variant on the card: the two matmuls' 4*C*H flops per row
// at the bf16 tensor-core rate against 2*C values read and written per row;
// at C = 96, H = 384 the operations, by a factor of 1.3.

#include "ln_mlp_sm90.cuh"

namespace mspi {
namespace {

using LabMatmul = MlpVariant<kLnNone, false>;
using LabMatmulGelu = MlpVariant<kLnNone>;
using LabLnMatmul = MlpVariant<kLnFastVar, false>;
using LabPipe2 = MlpVariant<kLnFastVar>;
using LabPipe4 = MlpVariant<kLnFastVar, true, true, false, 4>;
using LabMxuStats = MlpVariant<kLnTensorStats>;
using LabMlpBf16 = MlpVariant<kLnNone, false, false>;

constexpr int kLabC = 96;

}  // namespace
}  // namespace mspi

// x, y: [M, 96] bf16; gamma, beta, b2: [96]; w1: [H, 96]; b1: [H]; w2: [96, H],
// all bf16, contiguous, 32-byte aligned (gamma/beta unread without an LN,
// the biases unread by mlp_bf16); H % 64 == 0. Returns a cudaError_t code.
extern "C" int mspi_ln_mlp_lab(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* y, int M, int C, int H, float eps, int variant,
                               void* stream) {
  using mspi::kLabC;
  if (C != kLabC) return cudaErrorInvalidValue;
  const mspi::MlpArgs a{x, gamma, beta, w1, b1, w2, b2, nullptr, nullptr, y, M, H, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return mspi::launch_ln_mlp_sm90<kLabC, mspi::LabMatmul>(a, s);
    case 1: return mspi::launch_ln_mlp_sm90<kLabC, mspi::LabMatmulGelu>(a, s);
    case 2: return mspi::launch_ln_mlp_sm90<kLabC, mspi::LabLnMatmul>(a, s);
    case 3: return mspi::launch_ln_mlp_sm90<kLabC, mspi::LabPipe2>(a, s);
    case 4: return mspi::launch_ln_mlp_sm90<kLabC, mspi::LabPipe4>(a, s);
    case 5: return mspi::launch_ln_mlp_sm90<kLabC, mspi::LabMxuStats>(a, s);
    case 6: return mspi::launch_ln_mlp_sm90<kLabC, mspi::LabMlpBf16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
