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
// int8, gemm_s8_sm90_kernel<CONSUMERS>: int8 wgmma (m64n128k32, s32
// accumulators) fed by TMA, on gemm_bf16_sm90_kernel's plan.
// - Int8 wgmma reads b only K-major, so the call first makes bt = b^T [N, K]
//   in the caller's scratch by transpose_s8_kernel (64 x 64-byte tiles
//   through shared memory, 16-byte loads and stores), counted in its time:
//   2 N K bytes more, 2 G^2 beside the GEMM's 3 G^2 at G^3.
// - A block owns a (64 CONSUMERS) x 128 tile of c: one consumer warpgroup
//   per 64 rows and a producer warpgroup, whose one thread keeps a ring of 4
//   stages of 128-deep k tiles in flight (a [64 CONSUMERS, 128] box of a and
//   a [128, 128] box of bt per stage, one 128-byte swizzle row of int8 k per
//   row; 24 or 32 KiB) on full mbarriers; the producer drops to 40
//   registers (setmaxnreg). The caller picks CONSUMERS (ops/kernels/lab.py::
//   gemm_int8_block_m): 1 where 128-row tiles would leave SMs idle (128
//   blocks at 1024^3), else 2, which reads each bt box once for 128 rows.
// - Each consumer waits on a stage, issues four wgmma.m64n128k32 on it
//   (both descriptors K-major, 32 bytes of k apart), commits, and releases
//   the previous stage once its group has completed. K % 128 == 64 reads a
//   half box: TMA fills the rest with zeros, which add nothing.
// - Epilogue: each s32 sum cut to its low byte; a thread holds two adjacent
//   columns of two rows, so lane pairs swap one row's pair (one shuffle)
//   and each stores four bytes of one row at once.

#include <stdint.h>

#include "common.cuh"
#include "sm90_wgmma.cuh"

namespace mspi {
namespace {

using bf16 = __nv_bfloat16;

constexpr int GB = 128;  // M and N granularity

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

// the int8 wgmma GEMM
namespace igemm {
constexpr int kBN = 128;  // columns of c per block: rows of the bt box
constexpr int kBK = 128;  // k per stage: one 128-byte swizzle row of int8
constexpr int kStages = 4;
constexpr int kKAlign = 64;  // K granularity
constexpr uint32_t kBBytes = kBN * kBK;
constexpr int kTile = 64;  // transpose_s8_kernel's tile edge (bytes)

template <int CONSUMERS>
struct Shape {
  static constexpr int kBM = 64 * CONSUMERS;  // rows of c per block
  static constexpr int kThreads = 128 * (CONSUMERS + 1);
  static constexpr uint32_t kABytes = kBM * kBK;
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  static constexpr size_t kSmem = kStages * kStageBytes + 1024;  // + 1024-byte alignment
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0, "swizzle atoms stay aligned");
};
}  // namespace igemm

// bt [N, K] = b [K, N]^T, int8, K and N multiples of 64; grid (N / 64, K / 64).
__global__ void __launch_bounds__(256)
    transpose_s8_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt, int N, int K) {
  constexpr int E = igemm::kTile, LD = E + 4;
  __shared__ __align__(16) int8_t tile[E * LD];  // [k][n]
  const int n0 = blockIdx.x * E, k0 = blockIdx.y * E;
  const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
  const uint4 v = *reinterpret_cast<const uint4*>(b + static_cast<int64_t>(k0 + r) * N + n0 + c);
  const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) tile[r * LD + c + i] = vb[i];
  __syncthreads();
  uint32_t w[4];  // bt row n0 + r, columns k0 + c .. + 15
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      word |= static_cast<uint32_t>(static_cast<uint8_t>(tile[(c + 4 * q + i) * LD + r]))
              << (8 * i);
    w[q] = word;
  }
  *reinterpret_cast<uint4*>(bt + static_cast<int64_t>(n0 + r) * K + k0 + c) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// ta: a [M, K] in boxes of [64 CONSUMERS, 128]; tbt: bt [N, K] in boxes of
// [128, 128]; c [M, N] int8.
template <int CONSUMERS>
__global__ void __launch_bounds__(igemm::Shape<CONSUMERS>::kThreads, 1)
    gemm_s8_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tbt, int8_t* __restrict__ c, int N,
                        int K) {
  using namespace igemm;
  using Z = Shape<CONSUMERS>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.y * Z::kBM, n0 = blockIdx.x * kBN;
  const int n_k = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * CONSUMERS) {  // the producer warpgroup; one thread issues
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * CONSUMERS) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) wg::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * Z::kStageBytes;
        wg::mbar_arrive_expect_tx(&full[s], Z::kStageBytes);
        wg::tma_load_2d(st, &ta, &full[s], kt * kBK, m0);
        wg::tma_load_2d(st + Z::kABytes, &tbt, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  const int wgi = threadIdx.x / 128;  // this consumer's 64 rows
  int d[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) d[i] = 0;
  const int lane = threadIdx.x % 32;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    wg::mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* at = smem + s * Z::kStageBytes + wgi * 64 * kBK;
    const unsigned char* bt = smem + s * Z::kStageBytes + Z::kABytes;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wg::wgmma_m64n128k32_s8(d, wg::desc_sw128(at + kk * 32, 16, 1024),
                              wg::desc_sw128(bt + kk * 32, 16, 1024));
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0 && lane == 0) wg::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(d);

  // the thread's rows r, r + 8 and columns 8 j + 2 t4 (+1); the even lane of
  // a pair stores row r's four columns 8 j + 2 t4 .. + 3, the odd one row r + 8's
  // four columns 8 j + 2 (t4 - 1) .. + 3
  const int t4 = lane % 4;
  const bool even = t4 % 2 == 0;
  const int r = m0 + wgi * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4 + (even ? 0 : 8);
  int8_t* row = c + static_cast<int64_t>(r) * N + n0 + 2 * (t4 & ~1);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {  // the low byte of each s32 sum (wrap-around)
    const uint32_t lo = (d[4 * j] & 0xff) | (d[4 * j + 1] & 0xff) << 8;      // row r
    const uint32_t hi = (d[4 * j + 2] & 0xff) | (d[4 * j + 3] & 0xff) << 8;  // row r + 8
    const uint32_t got = __shfl_xor_sync(0xffffffffu, even ? hi : lo, 1);
    *reinterpret_cast<uint32_t*>(row + 8 * j) = even ? lo | got << 16 : got | hi << 16;
  }
}

template <int CONSUMERS>
cudaError_t launch_gemm_s8(const void* a, const void* b, void* c, void* bt, int M, int N, int K,
                           cudaStream_t stream) {
  using Z = igemm::Shape<CONSUMERS>;
  transpose_s8_kernel<<<dim3(N / igemm::kTile, K / igemm::kTile), 256, 0, stream>>>(
      static_cast<const int8_t*>(b), static_cast<int8_t*>(bt), N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tbt;
  err = wg::make_tma_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, M, K, K, Z::kBM, igemm::kBK);
  if (err == cudaSuccess)
    err = wg::make_tma_2d(&tbt, CU_TENSOR_MAP_DATA_TYPE_UINT8, bt, N, K, K, igemm::kBN,
                          igemm::kBK);
  if (err == cudaSuccess) err = allow_smem(gemm_s8_sm90_kernel<CONSUMERS>, Z::kSmem);
  if (err != cudaSuccess) return err;
  gemm_s8_sm90_kernel<CONSUMERS><<<dim3(N / igemm::kBN, M / Z::kBM), Z::kThreads, Z::kSmem,
                                   stream>>>(ta, tbt, static_cast<int8_t*>(c), N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mspi

// a [M, K], b [K, N], c [M, N], row-major and contiguous, 16-byte aligned;
// dtype 1 bf16 (K % 32 == 0), 2 int8 (K % 64 == 0); M and N multiples of
// 128. int8 also takes bt, an [N, K] int8 scratch (16-byte aligned) that
// the call fills with b^T, and block_m, the rows of c per block (64 or
// 128); bf16 ignores both. Returns a cudaError_t code.
extern "C" int mspi_gemm_lab(const void* a, const void* b, void* c, void* bt, int M, int N,
                             int K, int dtype, int block_m, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % mspi::GB || N % mspi::GB) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kBFloat16) {
    namespace W = mspi::wgemm;
    if (K % W::kKAlign) return cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    cudaError_t err = mspi::wg::make_tma_2d(&ta, kBf16, a, M, K, 2ull * K, W::kBM, W::kBK);
    if (err == cudaSuccess) err = mspi::wg::make_tma_2d(&tb, kBf16, b, K, N, 2ull * N, W::kBK, 64);
    if (err == cudaSuccess) err = mspi::allow_smem(mspi::gemm_bf16_sm90_kernel, W::kSmem);
    if (err != cudaSuccess) return err;
    mspi::gemm_bf16_sm90_kernel<<<dim3(N / W::kBN, M / W::kBM), W::kThreads, W::kSmem, s>>>(
        ta, tb, static_cast<__nv_bfloat16*>(c), N, K);
    return cudaGetLastError();
  }
  if (dtype == mspi::kInt8) {
    if (K % mspi::igemm::kKAlign || bt == nullptr || reinterpret_cast<uintptr_t>(bt) % 16)
      return cudaErrorInvalidValue;
    if (block_m == 64) return mspi::launch_gemm_s8<1>(a, b, c, bt, M, N, K, s);
    if (block_m == 128) return mspi::launch_gemm_s8<2>(a, b, c, bt, M, N, K, s);
  }
  return cudaErrorInvalidValue;
}
