// Building blocks of the bf16 attention backwards that run register-resident
// on the tensor cores, on flash_attention_sm90.cuh's mma.sync fragments and
// cp.async ring: window_attention_bwd.cu (rows 16-17) and
// attention_rel_bwd_sm90.cu (row 5, K1's backward). Each pass is a block of
// 4 warps with 16 rows per warp and walks 64-row tiles of the other side
// through a 2-slot ring, one barrier per tile.
#pragma once

#include "flash_attention_sm90.cuh"

namespace mspi {
namespace sm90 {

constexpr int kBwdThreads = kWarps * 32;  // 4 warps of 16 rows
constexpr int kBwdTile = kBK;             // rows of every tile (queries or keys)

// The rows of batch entry (or window) b, head h of a bf16 operand with strides st.
__device__ __forceinline__ const bf16* at(const void* base, const AttnStrides& st, int b,
                                          int h) {
  return static_cast<const bf16*>(base) + b * st.b + h * st.h;
}

__device__ __forceinline__ float dot_bf16x8(uint4 x, uint4 y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    s += __low2float(a[j]) * __low2float(b[j]) + __high2float(a[j]) * __high2float(b[j]);
  return s;
}

// The dq passes' prologue for the thread's query rows qi = q + 8 hr (q =
// the block's first row + the thread's row0): delta = rowsum(dO * O) from the
// O and dO rows (stride `stride`, 16-byte aligned; a row's 4 threads take 8
// lanes each per 32) and lse * log2(e), both 0 past nq. lse and delta_out
// point at row 0 of the (batch, head); the quad's first thread writes delta
// for the dk/dv passes.
template <int D>
__device__ __forceinline__ void row_stats(const bf16* op, const bf16* dop, int64_t stride,
                                          const float* lse, float* delta_out, int q, int nq,
                                          float (&lse2)[2], float (&dlt)[2]) {
  static_assert(D % 32 == 0, "a quad takes D in steps of 32 lanes");
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q + 8 * hr;
    float s = 0.f;
    if (qi < nq) {
#pragma unroll
      for (int c = 8 * t4; c < D; c += 32)
        s += dot_bf16x8(__ldg(reinterpret_cast<const uint4*>(op + qi * stride + c)),
                        __ldg(reinterpret_cast<const uint4*>(dop + qi * stride + c)));
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dlt[hr] = s;
    lse2[hr] = 0.f;
    if (qi < nq) {
      lse2[hr] = lse[qi] * kLog2e;
      if (t4 == 0) delta_out[qi] = s;
    }
  }
}

}  // namespace sm90
}  // namespace mspi
