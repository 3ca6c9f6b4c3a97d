// Hopper building blocks for kernels that feed the tensor cores through TMA:
// mbarriers, the 2-D TMA tile load, the wgmma shared-memory matrix
// descriptor (128-byte swizzle), wgmma's fences, and the bf16 and int8 wgmma
// of a 64-row tile with fp32 or s32 accumulators in registers. Used by
// gemm_lab.cu's bf16 and int8 GEMMs; written to be included by the later
// wgmma kernels.
//
// Tensor maps: cuTensorMapEncodeTiled belongs to the CUDA driver API. It is
// reached through the runtime's cudaGetDriverEntryPoint(ByVersion), so the
// library links against the CUDA runtime alone (no -lcuda). The maps are built
// on the host per call and passed by value as `const __grid_constant__
// CUtensorMap` kernel parameters.
//
// The shared-memory layouts follow the 128-byte swizzle that TMA writes and
// wgmma reads: a tile is stored in rows of 128 bytes (64 bf16), the 16-byte
// chunk c of row r at chunk c ^ (r % 8), in atoms of 8 rows (1024 bytes).
// Every tile starts 1024-byte aligned, so the descriptor's base offset is 0.
//   K-major (an operand whose k is contiguous: a [M, K] row-major): a TMA box
//     of 64 k by the tile's rows; one row of the box is one 128-byte row.
//     Descriptor: SBO = 1024 (the next 8 rows), LBO unused (1); a k-step of
//     16 advances the start address by 32 bytes inside the row.
//   int8 K-major: the same layout with 128 int8 k per 128-byte row; a
//     k-step of 32 advances the start address by 32 bytes. Int8 wgmma reads
//     both operands K-major only, so an int8 b [K, N] needs a K-major copy.
//   MN-major (an operand whose n is contiguous: b [K, N] row-major, read in
//     place with wgmma's transpose bit, which bf16 allows and int8 does not):
//     a TMA box of 64 n by 64 k; one k row of the box is one 128-byte row.
//     Descriptor: SBO = 1024 (the next 8 k rows), LBO = the bytes between
//     two boxes of 64 n (unused when N = 64); a k-step of 16 advances the
//     start address by 16 rows, 2048 bytes.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace mspi {
namespace wg {

// ---- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); a block
// barrier after it makes them visible to the other threads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------------

// The box of `map` at element coordinates (c0 innermost, c1) into shared
// memory at dst; its bytes complete a transaction on `bar`. Elements past
// the tensor's edge arrive as zeros and still count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------------

// The matrix descriptor of a 128-byte-swizzled tile at `p` (1024-byte
// aligned atoms; see the note above for lbo and sbo).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;  // layout: 128B swizzle
}

// Orders earlier register and shared-memory writes before the wgmma that
// follow (needed before the first wgmma on accumulators written otherwise).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warp are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in program order around the asynchronous
// wgmma: the compiler may not move their reads or writes across it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: bf16 in, fp32 accumulate; A
// K-major and B MN-major (transposed) through their descriptors, B's two
// 64-wide boxes LBO bytes apart. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1):
// d[4 j + {0, 1}] on the first row, d[4 j + {2, 3}] on the second, as
// mma.sync's m16n8 accumulators.
__device__ __forceinline__ void wgmma_m64n128k16_bf16_tn(float (&d)[64], uint64_t da,
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));  // scale-d: d += A B
}

// d[64 x 128] += A[64 x 32] B[32 x 128]: s8 in, s32 accumulate, both
// operands K-major through their descriptors (B as [128 n][k] rows). The
// accumulator layout is the bf16 form's: thread t holds rows 16 (t / 32) +
// (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) in d[4 j + {0, 1}]
// (first row) and d[4 j + {2, 3}] (second).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));  // scale-d: d += A B
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A warpgroup-wide register budget change (all four warps execute it):
// dec hands registers back to the SM, inc waits for them.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- host: tensor maps -------------------------------------------------------------

// cuTensorMapEncodeTiled's signature (CUDA 12.0 and later)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a row-major matrix [rows, cols] of `type` (cols contiguous,
// rows `row_bytes` apart, a multiple of 16; base 16-byte aligned) read in
// boxes of [box_rows, box_cols] with the 128-byte swizzle (box_cols elements
// <= 128 bytes); zeros past the edges.
inline cudaError_t make_tma_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                               uint64_t rows, uint64_t cols, uint64_t row_bytes,
                               uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace mspi
