// The int8 lab's GEMM: c = a b for a [M, K] and b [K, N], row-major.
//   bf16: bf16 x bf16 products accumulated in fp32, c rounded once to bf16;
//   int8: s8 x s8 products accumulated in s32, c cut to int8 by wrap-around
//         (the low byte), as the TPU kernel's astype(int8) of the s32 sum.
//
// Replaces: tools/bench_int8.py::_gemm (kernel _gemm_kernel), the raw GEMM
// rate of the int8 lab (gemm_bf16, gemm_int8) at [G, G] x [G, G], G = 1024 by
// default.
//
// What bounds it on the card: 2*M*N*K operations at the tensor cores' rate
// (989 TFLOP/s bf16, 1979 TOP/s int8) against 3 G^2 elements read and
// written; at G = 1024 the operations (2.2 us bf16, 1.1 us int8 against
// 1.9 us and 0.9 us of bytes).
//
// Design, a first simple tiling: a block owns a 128 x 128 tile of c and walks
// K, staging a 128-row slab of a and the matching slab of b in shared memory;
// 8 warps as 2 x 4, each a 64 x 32 sub-tile with its accumulators in
// registers.
//   bf16: WMMA 16x16x16 (BK = 32), fragments from shared memory, the fp32
//         sub-tile staged through shared memory for the bf16 store.
//   int8: mma.sync.m16n8k32 (BK = 64), the b slab transposed into shared
//         memory on the way in so that each B fragment is two words along k.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"
#include "int8_mma.cuh"

namespace mspi {
namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int GB = 128;      // tile edge of c
constexpr int G_THREADS = 256;
constexpr int BK16 = 32;     // bf16 k per stage
constexpr int LDA16 = BK16 + 8;  // bf16 pitches: multiples of 8 elements (WMMA)
constexpr int LDB16 = GB + 8;
constexpr int BK8 = 64;      // int8 k per stage
constexpr int LD8 = BK8 + 16;  // int8 pitch (bytes) of the a slab and the b^T slab

__global__ void __launch_bounds__(G_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, bf16* __restrict__ c,
                 int N, int K) {
  __shared__ __align__(32) bf16 as[GB * LDA16];
  __shared__ __align__(32) bf16 bs[BK16 * LDB16];
  __shared__ __align__(32) float stage[G_THREADS / 32][256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp sub-tile: rows wm*64, columns wn*32
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * GB;
  const int n0 = blockIdx.x * GB;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK16) {
    for (int e = threadIdx.x; e < GB * BK16 / 8; e += G_THREADS) {  // 16-byte loads
      const int r = e / (BK16 / 8), cc = (e % (BK16 / 8)) * 8;
      *reinterpret_cast<uint4*>(as + r * LDA16 + cc) =
          *reinterpret_cast<const uint4*>(a + (m0 + r) * K + k0 + cc);
    }
    for (int e = threadIdx.x; e < BK16 * GB / 8; e += G_THREADS) {
      const int r = e / (GB / 8), cc = (e % (GB / 8)) * 8;
      *reinterpret_cast<uint4*>(bs + r * LDB16 + cc) =
          *reinterpret_cast<const uint4*>(b + static_cast<int64_t>(k0 + r) * N + n0 + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * 64 + i * 16) * LDA16 + kk, LDA16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * LDB16 + wn * 32 + j * 16, LDB16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int64_t row = m0 + wm * 64 + i * 16 + e / 16;
        const int col = n0 + wn * 32 + j * 16 + e % 16;
        c[row * N + col] = from_f<bf16>(st[e]);
      }
      __syncwarp();
    }
}

__global__ void __launch_bounds__(G_THREADS)
gemm_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               int8_t* __restrict__ c, int N, int K) {
  __shared__ __align__(16) int8_t as[GB * LD8];  // [m][k]
  __shared__ __align__(16) int8_t bt[GB * LD8];  // [n][k]: b transposed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * GB;
  const int n0 = blockIdx.x * GB;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += BK8) {
    for (int e = threadIdx.x; e < GB * BK8 / 16; e += G_THREADS) {
      const int r = e / (BK8 / 16), cc = (e % (BK8 / 16)) * 16;
      *reinterpret_cast<uint4*>(as + r * LD8 + cc) =
          *reinterpret_cast<const uint4*>(a + (m0 + r) * K + k0 + cc);
    }
    for (int e = threadIdx.x; e < BK8 * GB / 16; e += G_THREADS) {
      const int r = e / (GB / 16), cc = (e % (GB / 16)) * 16;
      const uint4 v =
          *reinterpret_cast<const uint4*>(b + static_cast<int64_t>(k0 + r) * N + n0 + cc);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int i = 0; i < 16; ++i) bt[(cc + i) * LD8 + r] = vb[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK8; kk += 32) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r0 = as + (wm * 64 + i * 16 + g) * LD8;
        load_a(af[i], r0, r0 + 8 * LD8, kk, t);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* bp = bt + (wn * 32 + j * 8 + g) * LD8 + kk + 4 * t;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r0 = m0 + wm * 64 + i * 16 + g;
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      // the low byte of each s32 sum (wrap-around)
      c[r0 * N + col] = static_cast<int8_t>(acc[i][j][0] & 0xff);
      c[r0 * N + col + 1] = static_cast<int8_t>(acc[i][j][1] & 0xff);
      c[(r0 + 8) * N + col] = static_cast<int8_t>(acc[i][j][2] & 0xff);
      c[(r0 + 8) * N + col + 1] = static_cast<int8_t>(acc[i][j][3] & 0xff);
    }
}

}  // namespace
}  // namespace mspi

// a [M, K], b [K, N], c [M, N], row-major and contiguous, 16-byte aligned;
// dtype 1 bf16 (K % 32 == 0), 2 int8 (K % 64 == 0); M and N multiples of
// 128. Returns a cudaError_t code.
extern "C" int mspi_gemm_lab(const void* a, const void* b, void* c, int M, int N, int K,
                             int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % mspi::GB || N % mspi::GB) return cudaErrorInvalidValue;
  const dim3 grid(N / mspi::GB, M / mspi::GB);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kBFloat16) {
    if (K % mspi::BK16) return cudaErrorInvalidValue;
    mspi::gemm_bf16_kernel<<<grid, mspi::G_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(c), N, K);
  } else if (dtype == mspi::kInt8) {
    if (K % mspi::BK8) return cudaErrorInvalidValue;
    mspi::gemm_s8_kernel<<<grid, mspi::G_THREADS, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int8_t*>(c), N,
        K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
