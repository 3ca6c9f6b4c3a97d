// Fused LayerNorm + MLP forward, y = fc2(gelu(fc1(LN(x)))), and the fused MLP
// without the LayerNorm, y = fc2(gelu(fc1(x))), on token-major rows x [M, C].
// The bodies are in ln_mlp_sm90.cuh (bf16) and ln_mlp.cuh (fp32).
//
// Replaces: mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp (kernel _ln_fwd_kernel),
// used by the MViT, UniFormer-B (C = 320 at stage 3), SyncBlock and decoder
// ConvNextBlock3d MLPs. It also
// serves the call site of mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp_t
// (_ln_fwd_kernel_t), the ConvNeXt prior's LN+MLP: that kernel's [N, C, B*T]
// layout exists only for the TPU's batch-minor lane tiling, and what it
// computes is this kernel's forward with eps 1e-6, so the port's
// ConvNeXtBlock2d calls this kernel on its channels-last [B*T*H*W, C] tokens.
//
// Also replaces mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp_t_res
// (_ln_fwd_kernel_t_res, MSPI_PRIOR_FOLD_RES=1), the ConvNeXt prior's block
// tail shortcut + gamma * y. With a shortcut and a gamma (variant flag RES,
// non-null pointers) the epilogue reads the shortcut and writes
// cast(float(shortcut) + float(gamma) * y) with y still in fp32, so y never
// reaches device memory; gamma comes in the storage type, as the JAX package
// passes gamma.astype(dt). Products and the sum are rounded separately
// (__fmul_rn/__fadd_rn, no contraction), as the plain version computes them.
//
// And replaces mspi_tpu/ops/pallas/mlp.py::fused_mlp (kernel _fwd_kernel),
// the fused MLP without a LayerNorm (mspi_mlp): the same body with the
// LayerNorm stage compiled out, the x tile going into the shared-memory
// tile that z fills otherwise. The JAX entry pads N to its row tile; here
// rows past M are guarded, as in K2.
//
// Bodies: bf16 runs ln_mlp_sm90.cuh's wgmma + TMA kernel (K2 and K3, row 10
// with RES, row 13 without LN); fp32 runs ln_mlp.cuh's FMA-pipe kernel. The
// kernel labs (lnmlp_lab.cu) run the wgmma body in variants of their own.

#include "ln_mlp.cuh"
#include "ln_mlp_sm90.cuh"

namespace mspi {
namespace {

using K2 = MlpVariant<kLnTwoPass>;
using K2Res = MlpVariant<kLnTwoPass, true, true, true>;
using Row13 = MlpVariant<kLnNone>;

// fp32: ln_mlp.cuh's FMA-pipe body
template <typename T, class V>
cudaError_t dispatch_c(const MlpArgs& a, int C, cudaStream_t s) {
  switch (C) {
    case 96: return launch_ln_mlp<T, 96, V>(a, s);
    case 192: return launch_ln_mlp<T, 192, V>(a, s);
    case 320: return launch_ln_mlp<T, 320, V>(a, s);
    case 384: return launch_ln_mlp<T, 384, V>(a, s);
    case 512: return launch_ln_mlp<T, 512, V>(a, s);
    case 768: return launch_ln_mlp<T, 768, V>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class V>
cudaError_t dispatch_sm90(const MlpArgs& a, int C, cudaStream_t s) {
  switch (C) {
    case 96: return launch_ln_mlp_sm90<96, V>(a, s);
    case 192: return launch_ln_mlp_sm90<192, V>(a, s);
    case 320: return launch_ln_mlp_sm90<320, V>(a, s);
    case 384: return launch_ln_mlp_sm90<384, V>(a, s);
    case 512: return launch_ln_mlp_sm90<512, V>(a, s);
    case 768: return launch_ln_mlp_sm90<768, V>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class V>
cudaError_t dispatch_dtype(const MlpArgs& a, int C, int dtype, cudaStream_t s) {
  if (dtype == kFloat32) return dispatch_c<float, V>(a, C, s);
  if (dtype == kBFloat16) return dispatch_sm90<V>(a, C, s);
  return cudaErrorInvalidValue;
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
  const mspi::MlpArgs a{x, gamma, beta, w1, b1, w2, b2, shortcut, res_gamma, y, M, H, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shortcut == nullptr) return mspi::dispatch_dtype<mspi::K2>(a, C, dtype, s);
  if (res_gamma == nullptr) return cudaErrorInvalidValue;
  return mspi::dispatch_dtype<mspi::K2Res>(a, C, dtype, s);
}

// Row 13: y = fc2(gelu(fc1(x))) with biases; x, y: [M, C]; w1: [H, C];
// b1: [H]; w2: [C, H]; b2: [C]; one dtype, contiguous.
extern "C" int mspi_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* y, int M, int C, int H, int dtype, void* stream) {
  const mspi::MlpArgs a{x, nullptr, nullptr, w1, b1, w2, b2, nullptr, nullptr, y, M, H, 0.f};
  return mspi::dispatch_dtype<mspi::Row13>(a, C, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mspi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
