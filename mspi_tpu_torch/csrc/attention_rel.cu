// MViT pooled attention with the decomposed relative-position bias:
//   out = softmax(scale * q k^T + rel E^T) v   per (batch, head)
// q [B, H, Nq, D], k and v [B, H, Nk, D], rel [B, H, Nq, R], out [B, H, Nq, D].
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::fused_attention_rel
// (kernel _fwd_kernel_rel), used by all 16 MViTv2-S blocks.
//
// mspi_attention_rel_packed is the same kernel on MViT's packed token-major
// layout, with residual pooling's add in the epilogue:
//   out[:, :, h] = softmax(scale * q_h k_h^T + rel_h E^T) v_h  (+ q_h)
// q and out [B, Nq, H*D], k and v [B, Nk, H*D], rel [B, Nq, H*R]: head h is
// the lane slice [h*D, (h+1)*D) (rel: [h*R, (h+1)*R)), read in place through
// strides. Replaces ::fused_attention_rel_packed (kernel _rel_packed_kernel,
// MSPI_POOL_FAT=1 + MSPI_ATTN_PACKED=1: MViTv2-S blocks 1-15 at inference).
// The TPU kernel runs all heads of a query tile in one grid step on static
// lane slices and rebuilds q_aug/k_aug per head in VMEM; here each (batch,
// head) is a grid row as for K1, and only the strides and the epilogue
// (bias mode kRelBiasRes) differ, so K1's own path is untouched.
//
// The TPU kernel holds a whole [TQ, Nk] score tile in VMEM and multiplies the
// 0/1 key expansion E [Nk, R] in as a second small matmul; at Nk = 2688 it
// needed a special VMEM budget. Here the keys are walked in tiles with an
// online softmax, so shared memory is independent of Nk. In bf16 (K1 and
// row 8's training forward, bias mode kRelBias; row 8's inference,
// kRelBiasRes, whose epilogue adds q) the body is flash_attention_sm90.cuh's:
// rel E^T runs on the tensor cores beside Q K^T, with E's rows for a key
// tile built in shared memory from the keys' (t, h, w); rel's fragments stay
// in registers at R <= 48 and come from shared memory above. In fp32 the bias
// is rebuilt from rel and the key's (t, h, w) index on the FMA body
// (flash_attention.cuh).
//
// What bounds it on the card, and what the design does about it: see
// flash_attention_sm90.cuh. Shapes on the flagship (per clip, D = 96): Nq
// 43008 / Nk 672 / H 1 at block 0 down to 672 / 672 / H 8 at block 15, R 27
// to 46 at 224x384 (52 at 256x448).

#include "flash_attention_sm90.cuh"

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

// Token-major packed layout (see above). residual != 0 adds q to the output
// in the storage type; lse: [B*H, Nq] fp32, written when not null.
extern "C" int mspi_attention_rel_packed(const void* q, const void* k, const void* v,
                                         const void* rel, void* out, float* lse, int B,
                                         int H, int Nq, int Nk, int D, int R, int kt, int kh,
                                         int kw, float scale, int residual, int dtype,
                                         void* stream) {
  if (R != kt + kh + kw || kt * kh * kw != Nk) return cudaErrorInvalidValue;
  mspi::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.rel = rel;
  a.out = out;
  a.lse = lse;
  const int64_t C = static_cast<int64_t>(H) * D;
  a.qs = {Nq * C, D, C};
  a.ks = {Nk * C, D, C};
  a.vs = a.ks;
  a.os = a.qs;
  const int64_t HR = static_cast<int64_t>(H) * R;
  a.rs = {Nq * HR, R, HR};
  a.heads = H;
  a.nq = Nq;
  a.nk = Nk;
  a.r = R;
  a.kt = kt;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (residual)
    return mspi::dispatch_flash_attention<mspi::kRelBiasRes>(a, B, D, dtype, s);
  return mspi::dispatch_flash_attention<mspi::kRelBias>(a, B, D, dtype, s);
}
