// 7x7 depthwise 2-D convolution, stride 1, zero padding 3, plus a bias, on
// channels-last images:
//   y[n, h, w, c] = b[c] + sum over (i, j) of x[n, h+i-3, w+j-3, c] * k[i, j, c]
// x and y [N, H, W, C], k [7, 7, C], b [C], all in the storage type; fp32
// accumulation starting from the bias, over the taps in (i, j) order, one
// rounding at the end, as the TPU kernel sums them (it multiplies and adds
// separately; here each tap is one fused multiply-add).
//
// Replaces: tools/bench_dwconv.py::pallas_dwconv (kernel _dw_kernel), the kernel
// lab of the ConvNeXt blocks' conv_dw (the prior's `conv_dw`, which cuDNN
// serves in the model) at the four stage shapes of the flagship prior.
//
// The TPU kernel keeps a whole zero-bordered image in VMEM per grid step.
// Here a tile is 8 x TW outputs and 32 channels of one image, and its input
// is the (8 + 6) x (TW + 6) pixel halo around them, held in the storage type
// (bf16, TW = 32: 34 KB, 1.66 inputs per output). TW = 32 where W is a
// multiple of 32 (the lab's stage 0), else 16 (4 warps: fewer outputs
// outside the image at W = 48, 24, 12; 2.4 inputs per output), as measured
// (PERF.md). Persistent blocks walk a contiguous range of tiles (channel
// group outermost, so the taps change rarely) through a 2-slot ring: the
// next tile's halo arrives by 16-byte cp.async copies (a pixel's 32 channels
// are 64 contiguous bytes in NHWC; zero-filled outside the image and past C)
// while this tile is computed, with one barrier per tile. Warp w owns the 4
// x 8 outputs at rows 4 (w / (TW / 8)), columns 8 (w % (TW / 8)) of the
// tile, lane l channel l of the group: its 49 taps and its 32 fp32 sums stay
// in registers, and it reads each of the 10 input rows it needs once, 14
// pixels, from which the row's 7 taps feed every output row that row
// reaches: 1568 FMAs per 140 shared-memory reads. A warp whose outputs all
// lie outside the image skips them. A C that is not a multiple of the
// 16-byte vector (8 bf16, 4 fp32 channels) takes plain element loads
// instead of the copies.
//
// What bounds it on the card: 49 multiply-adds per output (98 flops at the
// fp32 pipes' 67 TFLOP/s) against 2 (bf16) bytes in and out. At the stage-0
// shape [128, 56, 96, 96] that is 6.5 GFLOP (97 us) against 132 MB in and out
// (79 us): the fp32 pipes, narrowly. The design keeps the FMA pipe's share of
// issued instructions near 85% (a shared-memory read and a bf16 unpack per
// 11 FMAs); 16 warps per SM at the 128-register cap (2 blocks at TW = 32,
// 4 at 16).

#include <stdint.h>

#include "common.cuh"

namespace mspi {
namespace {

constexpr int kK = 7, kP = 3;                 // kernel edge, padding
constexpr int kTH = 8, kCC = 32;              // tile rows, channels
constexpr int kOH = 4, kOW = 8;               // a warp's output rows, columns
constexpr int kSH = kTH + 2 * kP;             // the halo's rows
constexpr int kRowsIn = kOH + kK - 1, kColsIn = kOW + kK - 1;  // a warp's inputs: 10 x 14
static_assert(kCC == 32, "lane = channel");

// The tile of TW output columns in storage type T.
template <typename T, int TW>
struct Tile {
  static constexpr int kSW = TW + 2 * kP;                         // the halo's columns
  static constexpr int kThreads = 32 * (kTH / kOH) * (TW / kOW);  // 8 warps at TW = 32
  static constexpr int kBytes = sizeof(T) * kSH * kSW * kCC;
  static constexpr int kVec = 16 / sizeof(T);     // channels per 16-byte copy
  static constexpr int kChunks = kCC / kVec;      // copies per pixel
  static_assert(kBytes % 16 == 0, "16-byte slots");
};

template <typename T, int TW>
__global__ void __launch_bounds__(Tile<T, TW>::kThreads, 512 / Tile<T, TW>::kThreads)
    dwconv2d_sm90_kernel(const T* __restrict__ x, const T* __restrict__ k,
                         const T* __restrict__ b, T* __restrict__ y, int N, int H, int W, int C,
                         bool vec) {
  using Z = Tile<T, TW>;  // 16 warps per SM: 128 registers
  constexpr int kTW = TW, kSW = Z::kSW, kThreads = Z::kThreads;
  extern __shared__ __align__(16) unsigned char smem_dw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = (warp / (kTW / kOW)) * kOH, c0 = (warp % (kTW / kOW)) * kOW;  // in the tile
  const int ht = (H + kTH - 1) / kTH, wt = (W + kTW - 1) / kTW;
  const int per_group = N * ht * wt;
  const int64_t total = static_cast<int64_t>((C + kCC - 1) / kCC) * per_group;
  const int t_begin = static_cast<int>(total * blockIdx.x / gridDim.x);
  const int t_end = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x);
  struct Where {
    int g, n, h0, w0;
  };
  auto where = [&](int t) {
    const int g = t / per_group, rest = t % per_group;
    return Where{g, rest / (ht * wt), rest % (ht * wt) / wt * kTH, rest % wt * kTW};
  };

  // tile t's halo into slot si as one commit group (none past the range)
  auto issue = [&](int si, int t) {
    if (t < t_end) {
      const Where p = where(t);
      T* slot = reinterpret_cast<T*>(smem_dw + si * Z::kBytes);
      const T* img = x + static_cast<int64_t>(p.n) * H * W * C + p.g * kCC;
      const int cg = C - p.g * kCC;  // channels of this group in range
      if (vec) {
        for (int e = tid; e < kSH * kSW * Z::kChunks; e += kThreads) {
          const int px = e / Z::kChunks, cc = e % Z::kChunks * Z::kVec;
          const int hh = p.h0 - kP + px / kSW, ww = p.w0 - kP + px % kSW;
          const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && cc < cg;
          cp_async16(slot + px * kCC + cc,
                     ok ? img + (static_cast<int64_t>(hh) * W + ww) * C + cc : x, ok);
        }
      } else {
        for (int e = tid; e < kSH * kSW * kCC; e += kThreads) {
          const int px = e / kCC, cc = e % kCC;
          const int hh = p.h0 - kP + px / kSW, ww = p.w0 - kP + px % kSW;
          const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && cc < cg;
          slot[e] = ok ? img[(static_cast<int64_t>(hh) * W + ww) * C + cc] : from_f<T>(0.f);
        }
      }
    }
    cp_async_commit();
  };
  issue(0, t_begin);

  float tap[kK * kK], bias = 0.f;
  int g_taps = -1;  // the channel group whose taps are in registers
  for (int s = 0, t = t_begin; t < t_end; ++s, ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t's slot is full; every warp is done with t - 1's slot
    issue((s + 1) & 1, t + 1);
    const Where p = where(t);
    const int c = p.g * kCC + lane;
    if (p.g != g_taps) {
      g_taps = p.g;
#pragma unroll
      for (int i = 0; i < kK * kK; ++i) tap[i] = c < C ? to_f(k[i * C + c]) : 0.f;
      bias = c < C ? to_f(b[c]) : 0.f;
    }
    if (p.h0 + r0 >= H || p.w0 + c0 >= W) continue;  // this warp's outputs lie outside
    const T* tile = reinterpret_cast<const T*>(smem_dw + (s & 1) * Z::kBytes);
    float acc[kOH][kOW];
#pragma unroll
    for (int o = 0; o < kOH; ++o)
#pragma unroll
      for (int j = 0; j < kOW; ++j) acc[o][j] = bias;
    // input row r reaches output rows o = r - i for kernel rows i = 0..6:
    // for each output the taps arrive in (i, j) order
#pragma unroll
    for (int r = 0; r < kRowsIn; ++r) {
      float v[kColsIn];
      const T* row = tile + ((r0 + r) * kSW + c0) * kCC + lane;
#pragma unroll
      for (int j = 0; j < kColsIn; ++j) v[j] = to_f(row[j * kCC]);
#pragma unroll
      for (int o = 0; o < kOH; ++o) {
        const int i = r - o;
        if (i < 0 || i >= kK) continue;
#pragma unroll
        for (int dj = 0; dj < kK; ++dj)
#pragma unroll
          for (int j = 0; j < kOW; ++j)
            acc[o][j] = fmaf(v[j + dj], tap[i * kK + dj], acc[o][j]);
      }
    }
    if (c >= C) continue;
#pragma unroll
    for (int o = 0; o < kOH; ++o) {
      const int hh = p.h0 + r0 + o;
      if (hh >= H) break;
      T* yp = y + ((static_cast<int64_t>(p.n) * H + hh) * W + p.w0 + c0) * C + c;
#pragma unroll
      for (int j = 0; j < kOW; ++j)
        if (p.w0 + c0 + j < W) yp[static_cast<int64_t>(j) * C] = from_f<T>(acc[o][j]);
    }
  }
}

template <typename T, int TW>
cudaError_t launch_dwconv2d(const void* x, const void* k, const void* b, void* y, int N, int H,
                            int W, int C, cudaStream_t stream) {
  using Z = Tile<T, TW>;
  constexpr int kThreads = Z::kThreads;
  const int64_t tiles = static_cast<int64_t>((C + kCC - 1) / kCC) * N *
                        ((H + kTH - 1) / kTH) * ((W + TW - 1) / TW);
  if (tiles >= (int64_t{1} << 31)) return cudaErrorInvalidValue;  // int tile indices
  const bool vec = C % Z::kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = dwconv2d_sm90_kernel<T, TW>;
  const int smem = 2 * Z::kBytes;  // the ring
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<unsigned>(blocks < tiles ? blocks : tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(b),
      static_cast<T*>(y), N, H, W, C, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dwconv2d(const void* x, const void* k, const void* b, void* y, int N, int H,
                            int W, int C, cudaStream_t stream) {
  if (W % 32 == 0) return launch_dwconv2d<T, 32>(x, k, b, y, N, H, W, C, stream);
  return launch_dwconv2d<T, 16>(x, k, b, y, N, H, W, C, stream);
}

}  // namespace
}  // namespace mspi

// x, y [N, H, W, C] channels-last; k [7, 7, C]; b [C]; all in one storage type
// (0 fp32, 1 bf16), contiguous. Returns a cudaError_t code.
extern "C" int mspi_dwconv2d(const void* x, const void* k, const void* b, void* y, int N, int H,
                             int W, int C, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kFloat32) return mspi::launch_dwconv2d<float>(x, k, b, y, N, H, W, C, s);
  if (dtype == mspi::kBFloat16)
    return mspi::launch_dwconv2d<__nv_bfloat16>(x, k, b, y, N, H, W, C, s);
  return cudaErrorInvalidValue;
}
