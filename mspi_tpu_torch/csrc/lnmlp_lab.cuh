// The LN+MLP kernel lab: K2's bf16 wgmma + TMA body (ln_mlp_sm90.cuh) compiled
// in the variants that split its time into parts, at each of K2's widths C =
// 96, 192, 384, 512 and 768 (in K2's form at that width, Form<C, LN>).
//
// Replaces: tools/bench_lnmlp.py::_call (its five Pallas bodies) and the
// bf16 body of tools/bench_int8.py::_mlp_call. Variant codes (the order of
// LAB_VARIANTS in ops/kernels/lab.py):
//   0 matmul       _k_matmul: (x W1^T + b1) -> bf16, then W2 + b2; no LN, no GELU
//   1 matmul_gelu  _k_matmul_gelu: the same with the GELU (row 13's variant)
//   2 ln_matmul    _k_ln_matmul: LN (var = E[x^2] - mu^2), then the two
//                  matmuls without the GELU
//   3 pipe2        _k_pipe, k = 2: the full LN+MLP on K2's own schedule at
//                  the width (up to C = 192 a chunk's GELU in one slice
//                  beside each W1 box of the next chunk's fc1; above, one u,
//                  the GELU after its own fc1)
//   4 pipe4        _k_pipe, k = 4: the same function with each W1 box's fc1
//                  products in two commit groups and a GELU slice after each
//                  (4 slices a chunk at C = 96, 6 at 192); above C = 192,
//                  where the form holds one u, pipe2's schedule
//   5 mxu_stats    _k_mxu_stats: the full LN+MLP with the LN row sums taken on
//                  the tensor cores (X 1 and the diagonal of X X^T)
//   6 mlp_bf16     bench_int8.py::_mlp_bf16_kernel: x W1^T -> bf16 -> W2 ->
//                  bf16; no bias, no GELU
// The GELU is K2's erff, so that the split measures what K2 pays; the TPU
// bodies use the degree-16 fit of erf (within 2e-7 of it). pipe2 beside K2
// itself (kLnTwoPass, the same schedule) prices the one-pass LN.
//
// Each width is a translation unit of its own (lnmlp_lab.cu, which also
// holds the entry, at C = 96; lnmlp_lab_c<C>.cu), so that the parallel nvcc
// processes of the build take the 32 instantiations side by side.
//
// What bounds each variant on the card: the two matmuls' 4*C*H flops per row
// at the bf16 tensor-core rate against 2*C values read and written per row;
// at C = 96, H = 384 the operations, by a factor of 1.3.
#pragma once

#include "ln_mlp_sm90.cuh"

namespace mspi {

// One lab launch: x, y [M, C]; gamma, beta, b2 [C]; w1 [H, C]; b1 [H]; w2
// [C, H]; all bf16, contiguous, 32-byte aligned (gamma and beta unread
// without an LN, the biases unread by mlp_bf16); H % 64 == 0.
struct LabCall {
  const void *x, *gamma, *beta, *w1, *b1, *w2, *b2;
  void* y;
  int M, H;
  float eps;
  int variant;
  void* stream;
};

// The entry at each width, defined in that width's translation unit.
cudaError_t ln_mlp_lab_c96(const LabCall& c);
cudaError_t ln_mlp_lab_c192(const LabCall& c);
cudaError_t ln_mlp_lab_c384(const LabCall& c);
cudaError_t ln_mlp_lab_c512(const LabCall& c);
cudaError_t ln_mlp_lab_c768(const LabCall& c);

namespace {

using LabMatmul = MlpVariant<kLnNone, false>;
using LabMatmulGelu = MlpVariant<kLnNone>;
using LabLnMatmul = MlpVariant<kLnFastVar, false>;
using LabPipe2 = MlpVariant<kLnFastVar>;
// two GELU slices a W1 box where the form holds two u register sets
template <int C>
using LabPipe4 = MlpVariant<kLnFastVar, true, true, false,
                            lnsm90::Form<C>::PIPE ? 2 * lnsm90::Form<C>::KB : 0>;
using LabMxuStats = MlpVariant<kLnTensorStats>;
using LabMlpBf16 = MlpVariant<kLnNone, false, false>;

template <int C>
cudaError_t launch_ln_mlp_lab(const LabCall& c) {
  const MlpArgs a{c.x, c.gamma, c.beta, c.w1, c.b1, c.w2, c.b2, nullptr, nullptr, c.y, c.M, c.H,
                  c.eps};
  cudaStream_t s = static_cast<cudaStream_t>(c.stream);
  switch (c.variant) {
    case 0: return launch_ln_mlp_sm90<C, LabMatmul>(a, s);
    case 1: return launch_ln_mlp_sm90<C, LabMatmulGelu>(a, s);
    case 2: return launch_ln_mlp_sm90<C, LabLnMatmul>(a, s);
    case 3: return launch_ln_mlp_sm90<C, LabPipe2>(a, s);
    case 4: return launch_ln_mlp_sm90<C, LabPipe4<C>>(a, s);
    case 5: return launch_ln_mlp_sm90<C, LabMxuStats>(a, s);
    case 6: return launch_ln_mlp_sm90<C, LabMlpBf16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mspi
