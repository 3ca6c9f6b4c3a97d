// Window attention on packed qkv (VideoSwin's W-MSA / SW-MSA):
//   out[b, :, h] = softmax(q_s k^T + bias[h] (+ mask[b mod nW])) v
// for window b of B_ and head h; q_s = q * D^-0.5 rounded to the storage
// type. qkv [B_, N, 3C] in lane order (3, head, D), as the qkv linear emits
// it; bias [H, N, N]; mask [nW, N, N] of {0, -100} or null; out [B_, N, C],
// as the proj linear takes it.
//
// Replaces: mspi_tpu/ops/pallas/attention.py::fused_window_attention
// (_packed_fwd_impl, kernel _packed_fwd_kernel), run by all 24 VideoSwin-S
// blocks: N = 8*7*7 = 392 tokens, D = 32, H = 3 / 6 / 12 / 24 at stages 1-4,
// the odd blocks with the shift mask.
//
// The TPU kernel keeps the whole [H, N, N] bias resident in VMEM and a
// window's [N, N] scores per head, and unrolls the heads over static lane
// slices of a packed block (the per-head layout would pad D = 32 to 128
// lanes). Here each (window, head) is a grid row of the flash body in
// flash_attention.cuh (kDenseBias): a head's D lanes are read in place
// through strides (b = N*3C, h = D, n = 3C), so there are no per-head copies;
// query and key tiles of 64 over N = 392 are ragged (6*64 + 8) and masked;
// bias and mask are read from device memory per score (the stage-1 bf16 mask
// is 34 MB and stays mostly in the 50 MB L2).
//
// What bounds it on the card: 4*D flops per (query, key) pair, at D = 32 only
// 128, against 2 bytes of bias (+ 2 of mask) per pair read from L2: at
// D = 32 the score-tile traffic and the block's synchronisation, not the
// tensor cores, set the time.

#include "flash_attention.cuh"

// lse: [B*heads, N] fp32 row log-sum-exp, written when not null (the training
// forward keeps it for the backward in attention_bwd.cu).
extern "C" int mspi_window_attention(const void* qkv, const void* bias, const void* mask,
                                     void* out, float* lse, int B, int N, int C, int heads,
                                     int nw, int dtype, void* stream) {
  if (heads <= 0 || C % heads != 0) return cudaErrorInvalidValue;
  if (mask != nullptr && (nw <= 0 || B % nw != 0)) return cudaErrorInvalidValue;
  const mspi::AttnArgs a =
      mspi::window_attn_args(qkv, bias, mask, out, lse, N, C, heads, nw, dtype);
  return mspi::dispatch_flash_attention<mspi::kDenseBias>(a, B, C / heads, dtype,
                                                          static_cast<cudaStream_t>(stream));
}
