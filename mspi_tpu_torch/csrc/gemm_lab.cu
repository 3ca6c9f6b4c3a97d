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
// written; at G = 1024 the operations: 2.1 GFLOP, 2.2 us of bf16 tensor-core
// time against 6 MiB, 1.9 us of bytes (int8: 1.1 us against 0.9 us).
//
// bf16, gemm_bf16_sm90_kernel: wgmma fed by TMA (sm90_wgmma.cuh).
// - A block owns a 64 x 128 tile of c: 128 blocks at G = 1024, one per SM
//   on 128 of the card's 132 (a 128 x 128 tile left 68 SMs idle). 128 x 64
//   with two consumer warpgroups of 64 rows ran 6% slower at G = 1024
//   (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// - Two warpgroups: a producer and a consumer. One thread of the producer
//   keeps a ring of 4 stages of 64-deep k tiles in flight (per stage a
//   [64, 64] box of a and two [64, 64] boxes of b, 24 KiB, by TMA with the
//   128-byte swizzle), each stage completing on its full mbarrier; the
//   producer warpgroup drops to 40 registers (setmaxnreg).
// - The consumer waits on a stage's full barrier, issues four
//   wgmma.m64n128k16 on it (a K-major, b read in place as the MN-major
//   operand through the transpose bit), commits, and once the previous
//   stage's group has completed (wait_group 1) each warp releases that
//   stage through its empty barrier, so the next stage's products queue
//   behind the running ones. K % 64 == 32 reads a half tile: TMA fills the
//   rest with zeros.
// - Epilogue: the fp32 accumulators are rounded to bf16 in registers and
//   stored as 4-byte pairs, a quad's four pairs one 16-byte run of a row.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 7.1 us of device time
// at G = 1024 against torch.matmul's 5.5 us, 380 us at G = 4096 against
// 171 us. The suspect is the traffic from L2: 64 x 128 tiles read a and b
// at 43 flops per byte, 48 MiB at G = 1024 and 8.5 TB/s at G = 4096. A
// cluster of two blocks sharing b by TMA multicast, a third less of it,
// ran 2.1-2.5x slower (each stage then waits for both blocks' releases).
//
// int8, gemm_s8_kernel, a first simple tiling: a block owns a 128 x 128 tile
// of c and walks K, staging a 128-row slab of a and the matching slab of b
// in shared memory; 8 warps as 2 x 4, each a 64 x 32 sub-tile with its
// accumulators in registers; mma.sync.m16n8k32 (BK = 64), the b slab
// transposed into shared memory on the way in so that each B fragment is
// two words along k.

#include <stdint.h>

#include "common.cuh"
#include "int8_mma.cuh"
#include "sm90_wgmma.cuh"

namespace mspi {
namespace {

using bf16 = __nv_bfloat16;

constexpr int GB = 128;      // M and N granularity; the int8 tile edge of c
constexpr int G_THREADS = 256;
constexpr int BK8 = 64;      // int8 k per stage
constexpr int LD8 = BK8 + 16;  // int8 pitch (bytes) of the a slab and the b^T slab

// the bf16 wgmma GEMM
namespace wgemm {
constexpr int kBM = 64;   // rows of c per block: one consumer warpgroup
constexpr int kBN = 128;  // columns: two 64-wide boxes of b per stage
constexpr int kBK = 64;   // k per stage: one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kThreads = 256;  // the consumer warpgroup, then the producer's
constexpr int kKAlign = 32;    // K granularity
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr uint32_t kBBox = kBK * 64 * 2;  // one [64 k, 64 n] box of b
constexpr uint32_t kStageBytes = kABytes + 2 * kBBox;
constexpr size_t kSmem = kStages * kStageBytes + 1024;  // + slack for 1024-byte alignment
static_assert(kABytes % 1024 == 0 && kBBox % 1024 == 0, "swizzle atoms stay aligned");
}  // namespace wgemm

// ta: a [M, K] in boxes of [kBM, kBK]; tb: b [K, N] in boxes of [kBK, 64].
__global__ void __launch_bounds__(wgemm::kThreads, 1)
    gemm_bf16_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, bf16* __restrict__ c, int N,
                          int K) {
  using namespace wgemm;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_k = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warpgroup; one thread issues
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 128) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) wg::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        wg::mbar_arrive_expect_tx(&full[s], kStageBytes);
        wg::tma_load_2d(st, &ta, &full[s], kt * kBK, m0);
        wg::tma_load_2d(st + kABytes, &tb, &full[s], n0, kt * kBK);
        wg::tma_load_2d(st + kABytes + kBBox, &tb, &full[s], n0 + 64, kt * kBK);
      }
    }
    return;
  }

  float d[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) d[i] = 0.f;
  const int lane = threadIdx.x % 32;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    wg::mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* at = smem + s * kStageBytes;
    const unsigned char* bt = at + kABytes;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // b's second box of 64 n: LBO
      wg::wgmma_m64n128k16_bf16_tn(d, wg::desc_sw128(at + kk * 32, 16, 1024),
                                   wg::desc_sw128(bt + kk * 16 * 128, kBBox, 1024));
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0 && lane == 0) wg::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(d);

  bf16* row = c + static_cast<int64_t>(m0 + (threadIdx.x / 32) * 16 + lane / 4) * N + n0 +
              2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(row + 8 * N + 8 * j) = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kBFloat16) {
    namespace W = mspi::wgemm;
    if (K % W::kKAlign) return cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    cudaError_t err = mspi::wg::make_tma_2d_bf16(&ta, a, M, K, 2ull * K, W::kBM, W::kBK);
    if (err == cudaSuccess)
      err = mspi::wg::make_tma_2d_bf16(&tb, b, K, N, 2ull * N, W::kBK, 64);
    if (err == cudaSuccess) err = mspi::allow_smem(mspi::gemm_bf16_sm90_kernel, W::kSmem);
    if (err != cudaSuccess) return err;
    mspi::gemm_bf16_sm90_kernel<<<dim3(N / W::kBN, M / W::kBM), W::kThreads, W::kSmem, s>>>(
        ta, tb, static_cast<__nv_bfloat16*>(c), N, K);
  } else if (dtype == mspi::kInt8) {
    if (K % mspi::BK8) return cudaErrorInvalidValue;
    mspi::gemm_s8_kernel<<<dim3(N / mspi::GB, M / mspi::GB), mspi::G_THREADS, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int8_t*>(c), N,
        K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
