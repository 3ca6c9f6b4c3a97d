// MViT pooled attention with the decomposed relative-position bias:
//   out = softmax(scale * q k^T + rel E^T) v   per (batch, head)
// q [B, H, Nq, D], k and v [B, H, Nk, D], rel [B, H, Nq, R], out [B, H, Nq, D].
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::fused_attention_rel
// (kernel _fwd_kernel_rel), used by all 16 MViTv2-S blocks.
//
// The TPU kernel holds a whole [TQ, Nk] score tile in VMEM and multiplies the
// 0/1 key expansion E [Nk, R] in as a second small matmul; at Nk = 2688 it
// needed a special VMEM budget. Here the keys are walked in tiles with an
// online softmax (flash_attention.cuh), so shared memory is independent of
// Nk, and the bias is rebuilt in registers from rel and the key's (t, h, w)
// index instead of a matmul with E.
//
// What bounds it on the card, and what the design does about it: see
// flash_attention.cuh. Shapes on the flagship (per clip, D = 96): Nq 43008 /
// Nk 672 / H 1 at block 0 down to 672 / 672 / H 8 at block 15, R 27 to 46.

#include "flash_attention.cuh"

// lse: [B*H, Nq] fp32 row log-sum-exp, written when not null (the training
// forward keeps it for attention_bwd.cu).
extern "C" int mspi_attention_rel(const void* q, const void* k, const void* v,
                                  const void* rel, void* out, float* lse, int B, int H,
                                  int Nq, int Nk, int D, int R, int kt, int kh, int kw,
                                  float scale, int dtype, void* stream) {
  mspi::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.rel = rel;
  a.out = out;
  a.lse = lse;
  const int64_t hq = static_cast<int64_t>(Nq) * D, hk = static_cast<int64_t>(Nk) * D;
  a.qs = {H * hq, hq, D};
  a.ks = {H * hk, hk, D};
  a.vs = {H * hk, hk, D};
  a.os = {H * hq, hq, D};
  const int64_t hr = static_cast<int64_t>(Nq) * R;
  a.rs = {H * hr, hr, R};
  a.heads = H;
  a.nq = Nq;
  a.nk = Nk;
  a.r = R;
  a.kt = kt;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  if (R != kt + kh + kw || kt * kh * kw != Nk) return cudaErrorInvalidValue;
  return mspi::dispatch_flash_attention<mspi::kRelBias>(a, B, D, dtype,
                                              static_cast<cudaStream_t>(stream));
}
