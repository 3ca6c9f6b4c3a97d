// Multi-head self-attention on packed activations:
//   out[:, :, h] = softmax(q_h k_h^T / sqrt(D)) v_h   for each head h
// q [B, N, C] and kv [B, N, 2C] (k then v, each head-major in its lanes, as the
// split qkv linear emits them); out [B, N, C] packed the same way.
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::fused_self_attention
// (kernel _self_fwd_kernel), used by the 3 SyncBlock blocks (N = 672 + 36 =
// 708 tokens, C 512, 4 heads, D 128 on the flagship).
//
// The TPU kernel runs all heads of a query tile in one grid step on static
// lane slices. Here each (batch, head) is its own grid row and the flash
// body of flash_attention.cuh reads a head's D lanes in place through
// strides, so there are no per-head transpose copies; N = 708 is not a
// multiple of the 64-row tile and is masked in the kernel.

#include "flash_attention.cuh"

// lse: [B*heads, N] fp32 row log-sum-exp, written when not null.
extern "C" int mspi_self_attention(const void* q, const void* kv, void* out, float* lse,
                                   int B, int N, int C, int heads, int dtype, void* stream) {
  if (heads <= 0 || C % heads != 0) return cudaErrorInvalidValue;
  const int D = C / heads;
  mspi::AttnArgs a{};
  a.q = q;
  a.k = kv;
  a.v = static_cast<const char*>(kv) + static_cast<size_t>(C) *
                                           (dtype == mspi::kBFloat16 ? 2 : 4);
  a.rel = nullptr;
  a.out = out;
  a.lse = lse;
  const int64_t n = N;
  a.qs = {n * C, D, C};
  a.ks = {n * 2 * C, D, 2 * C};
  a.vs = {n * 2 * C, D, 2 * C};
  a.os = {n * C, D, C};
  a.rs = {0, 0, 0};
  a.heads = heads;
  a.nq = N;
  a.nk = N;
  a.scale = 1.f / sqrtf(static_cast<float>(D));
  return mspi::dispatch_flash_attention<mspi::kNoBias>(a, B, D, dtype,
                                               static_cast<cudaStream_t>(stream));
}
