// MViT pooled attention on augmented lanes (MSPI_ATTN_RELK=0 in the JAX
// package):
//   out = softmax(q_aug k_aug^T) v   per (batch, head), no scale
// q_aug [B, H, Nq, Da] = [q * scale | rel_t | rel_h | rel_w] and k_aug
// [B, H, Nk, Da] = [k | E] (E the 0/1 expansion of the key's t, h, w index),
// built by the caller, so the rel-pos bias is part of the one contraction;
// v [B, H, Nk, Dv], out [B, H, Nq, Dv]. On MViTv2-S, Da = 96 + R: 123 or 142
// at 224x384, 109 or 114 at --resolution 64 96, up to 148 at 256x448, 162 at
// 288x640, 180 at 448x768 and 184 at 512x768; Dv = 96.
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::fused_attention (kernel
// _fwd_kernel), all 16 MViTv2-S blocks when the rel-pos kernel is off.
//
// The TPU kernel holds a whole [TQ, Nk] score tile in VMEM, one MXU lane tile
// wide in the contraction. Here the score width is Da zero-filled to DK =
// 128, 144, 176, 192 or 256 lanes (aug_width in flash_attention.cuh; exact,
// the padded lanes add 0 to every score), or past Da 256 to a multiple of 64
// lanes that the wide form streams in 64-lane chunks, S summed over them
// (launch_flash_attention_aug_wide_sm90; fp32 flash_attention.cuh's
// flash_attention_aug_wide_f32_kernel). bf16 runs flash_attention_sm90.cuh's
// register-resident body with DK != DV: k_aug's unaligned rows are first
// copied once into zero-filled DK-lane rows in the caller's `pad` scratch, so
// its cp.async ring copies 16-byte rows; q_aug is read into registers once per
// block (at DK = 192 and 256 into shared memory, read by ldmatrix per key
// tile). fp32 runs flash_attention.cuh's FMA body, which loads both one
// element at a time into zero-filled rows in shared memory.
//
// What bounds it on the card: 2*(Da + Dv) flops per (query, key) pair against
// q, k, v read once per query tile: the tensor cores (bf16), the FMA pipes
// (fp32).

#include "flash_attention_sm90.cuh"

// lse: [B*H, Nq] fp32 row log-sum-exp, written when not null (the training
// forward keeps it for mspi_attention_bwd in attention_bwd.cu). pad: bf16
// only, 16-byte aligned scratch for the padded rows of DK = aug_width(Da)
// lanes: [B*H*Nk, DK] for k_aug's up to Da 256, [B*H*(Nq + Nk), DK] for
// q_aug's and k_aug's in the wide form; unused in fp32.
extern "C" int mspi_attention(const void* q, const void* k, const void* v, void* out,
                              float* lse, void* pad, int B, int H, int Nq, int Nk, int Da,
                              int Dv, int dtype, void* stream) {
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
  if (dtype == mspi::kFloat32) return mspi::launch_flash_attention_aug_f32(a, B, Dv, s);
  if (dtype != mspi::kBFloat16 || Dv != 96 || pad == nullptr) return cudaErrorInvalidValue;
  auto* p = static_cast<__nv_bfloat16*>(pad);
  switch (mspi::aug_width(Da)) {
    case 128: return mspi::launch_flash_attention_aug_sm90<128>(a, B, p, s);
    case 144: return mspi::launch_flash_attention_aug_sm90<144>(a, B, p, s);
    case 176: return mspi::launch_flash_attention_aug_sm90<176>(a, B, p, s);
    case 192: return mspi::launch_flash_attention_aug_sm90<192>(a, B, p, s);
    case 256: return mspi::launch_flash_attention_aug_sm90<256>(a, B, p, s);
    case 0: return cudaErrorInvalidValue;
    default: return mspi::launch_flash_attention_aug_wide_sm90(a, B, p, s);
  }
}
