// The int8 tensor-core product of the int8 kernels (ln_mlp_int8.cu,
// gemm_lab.cu): mma.sync.m16n8k32 s8 x s8 -> s32 and its fragment loads.
#pragma once

#include <stdint.h>

namespace mspi {

// d += a * b on the tensor cores: A 16x32 s8 (row), B 32x8 s8 (col), D 16x8 s32.
// Lane (g = lane / 4, t = lane % 4) holds D rows g and g+8, columns 2t, 2t+1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The A fragment of m16n8k32 at column k of a row-major s8 tile: rows g and
// g+8 (r0, r1 point at them), bytes k + 4t .. +3 and k + 16 + 4t .. +3. The
// B fragment of column g is the same pair of words along that column's k.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* r0, const int8_t* r1,
                                       int k, int t) {
  a[0] = ld32(r0 + k + 4 * t);
  a[1] = ld32(r1 + k + 4 * t);
  a[2] = ld32(r0 + k + 16 + 4 * t);
  a[3] = ld32(r1 + k + 16 + 4 * t);
}

}  // namespace mspi
