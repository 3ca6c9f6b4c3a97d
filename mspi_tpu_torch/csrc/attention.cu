// MViT pooled attention on augmented lanes (MSPI_ATTN_RELK=0 in the JAX
// package):
//   out = softmax(q_aug k_aug^T) v   per (batch, head), no scale
// q_aug [B, H, Nq, Da] = [q * scale | rel_t | rel_h | rel_w] and k_aug
// [B, H, Nk, Da] = [k | E] (E the 0/1 expansion of the key's t, h, w index),
// built by the caller, so the rel-pos bias is part of the one contraction;
// v [B, H, Nk, Dv], out [B, H, Nq, Dv]. On MViTv2-S, Da = 96 + 27 = 123 or
// 96 + 46 = 142 and Dv = 96.
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::fused_attention (kernel
// _fwd_kernel), all 16 MViTv2-S blocks when the rel-pos kernel is off.
//
// The TPU kernel holds a whole [TQ, Nk] score tile in VMEM, one MXU lane tile
// wide in the contraction (123 or 142 lanes). Here it is the flash body of
// flash_attention.cuh with separate score and value widths: the rows of Da
// bf16 values (246 or 284 bytes) are not 16-byte aligned, so q_aug and k_aug
// are loaded one element at a time and zero-filled to DK = 128 or 144 lanes
// in shared memory (exact: the padded lanes add 0 to every score) instead of
// being padded by a copy in device memory.
//
// What bounds it on the card: 2*(Da + Dv) flops per (query, key) pair, read
// once per query tile; like K1 it sits far above the memory roofline, and the
// narrow loads of q_aug/k_aug add to the block's synchronised shared-memory
// work per key tile.

#include "flash_attention.cuh"

// lse: [B*H, Nq] fp32 row log-sum-exp, written when not null (the training
// forward keeps it for mspi_attention_bwd in attention_bwd.cu).
extern "C" int mspi_attention(const void* q, const void* k, const void* v, void* out,
                              float* lse, int B, int H, int Nq, int Nk, int Da, int Dv,
                              int dtype, void* stream) {
  mspi::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = lse;
  const int64_t hq = static_cast<int64_t>(Nq) * Da, hk = static_cast<int64_t>(Nk) * Da;
  const int64_t hv = static_cast<int64_t>(Nk) * Dv, ho = static_cast<int64_t>(Nq) * Dv;
  a.qs = {H * hq, hq, Da};
  a.ks = {H * hk, hk, Da};
  a.vs = {H * hv, hv, Dv};
  a.os = {H * ho, ho, Dv};
  a.heads = H;
  a.nq = Nq;
  a.nk = Nk;
  a.dk = Da;
  a.scale = 1.f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kFloat32) return mspi::launch_flash_attention_aug<float>(a, B, Dv, s);
  if (dtype == mspi::kBFloat16)
    return mspi::launch_flash_attention_aug<__nv_bfloat16>(a, B, Dv, s);
  return cudaErrorInvalidValue;
}
