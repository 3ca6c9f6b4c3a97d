// The LN+MLP kernel lab's entry (lnmlp_lab.cuh describes the variants) and
// its bodies at C = 96; the other widths are lnmlp_lab_c<C>.cu.

#include "lnmlp_lab.cuh"

cudaError_t mspi::ln_mlp_lab_c96(const LabCall& c) { return launch_ln_mlp_lab<96>(c); }

// x, y: [M, C] bf16; gamma, beta, b2: [C]; w1: [H, C]; b1: [H]; w2: [C, H],
// all bf16, contiguous, 32-byte aligned (gamma/beta unread without an LN,
// the biases unread by mlp_bf16); C in {96, 192, 384, 512, 768}, H % 64 ==
// 0. Returns a cudaError_t code.
extern "C" int mspi_ln_mlp_lab(const void* x, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* y, int M, int C, int H, float eps, int variant,
                               void* stream) {
  const mspi::LabCall c{x, gamma, beta, w1, b1, w2, b2, y, M, H, eps, variant, stream};
  switch (C) {
    case 96: return mspi::ln_mlp_lab_c96(c);
    case 192: return mspi::ln_mlp_lab_c192(c);
    case 384: return mspi::ln_mlp_lab_c384(c);
    case 512: return mspi::ln_mlp_lab_c512(c);
    case 768: return mspi::ln_mlp_lab_c768(c);
    default: return cudaErrorInvalidValue;
  }
}
