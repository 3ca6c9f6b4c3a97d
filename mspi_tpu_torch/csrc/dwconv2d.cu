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
// Here a block owns an 8 x 16 spatial tile and 32 channels of one image and
// loads the tile with its 3-pixel halo ([14][22][32] fp32, 39 KB) into shared
// memory once. Thread (row, lane) owns channel lane of output row `row`,
// keeps its 49 taps and the bias in registers, and for each of the 7 input
// rows it needs holds one register copy of the 22 pixels, from which it
// accumulates its 16 outputs. Loads and stores run along C, so a warp
// touches 32 consecutive channels.
//
// What bounds it on the card: 49 multiply-adds per output (98 flops at the
// fp32 pipes' 67 TFLOP/s) against 2 (bf16) bytes in and out. At the stage-0
// shape [128, 56, 96, 96] that is 6.5 GFLOP (97 us) against 132 MB in and out
// (79 us): the fp32 pipes, narrowly.

#include <stdint.h>

#include "common.cuh"

namespace mspi {
namespace {

constexpr int kK = 7, kP = 3;                // kernel edge, padding
constexpr int kTH = 8, kTW = 16, kCC = 32;   // output tile rows, columns, channels
constexpr int kSH = kTH + 2 * kP, kSW = kTW + 2 * kP;  // with the halo
constexpr int kTile = kSH * kSW * kCC;
constexpr int kThreads = 32 * kTH;  // one warp per output row

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dwconv2d_kernel(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ b,
                    T* __restrict__ y, int H, int W, int C) {
  extern __shared__ __align__(16) float tile[];  // [kSH][kSW][kCC]
  const int tiles_w = (W + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / tiles_w) * kTH, w0 = (blockIdx.x % tiles_w) * kTW;
  const int c0 = blockIdx.y * kCC, n = blockIdx.z;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int c = c0 + lane;

  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int cc = e % kCC, pix = e / kCC;
    const int hh = h0 + pix / kSW - kP, ww = w0 + pix % kSW - kP;
    float v = 0.f;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + cc < C)
      v = to_f(x[((static_cast<int64_t>(n) * H + hh) * W + ww) * C + c0 + cc]);
    tile[e] = v;
  }
  float wr[kK * kK];
#pragma unroll
  for (int i = 0; i < kK * kK; ++i) wr[i] = c < C ? to_f(k[i * C + c]) : 0.f;
  const float bias = c < C ? to_f(b[c]) : 0.f;
  __syncthreads();

  float acc[kTW];
#pragma unroll
  for (int j = 0; j < kTW; ++j) acc[j] = bias;
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    float r[kSW];
#pragma unroll
    for (int j = 0; j < kSW; ++j) r[j] = tile[((row + i) * kSW + j) * kCC + lane];
#pragma unroll
    for (int dj = 0; dj < kK; ++dj) {
      const float wv = wr[i * kK + dj];
#pragma unroll
      for (int j = 0; j < kTW; ++j) acc[j] = fmaf(r[j + dj], wv, acc[j]);
    }
  }
  const int hh = h0 + row;
  if (hh < H && c < C) {
    T* yp = y + ((static_cast<int64_t>(n) * H + hh) * W) * C + c;
#pragma unroll
    for (int j = 0; j < kTW; ++j)
      if (w0 + j < W) yp[static_cast<int64_t>(w0 + j) * C] = from_f<T>(acc[j]);
  }
}

template <typename T>
cudaError_t launch_dwconv2d(const void* x, const void* k, const void* b, void* y, int N, int H,
                            int W, int C, cudaStream_t stream) {
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), (C + kCC - 1) / kCC, N);
  const size_t smem = sizeof(float) * kTile;  // 39,424 bytes: no opt-in needed
  dwconv2d_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(b),
      static_cast<T*>(y), H, W, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mspi

// x, y [N, H, W, C] channels-last; k [7, 7, C]; b [C]; all in one storage type
// (0 fp32, 1 bf16), contiguous. Returns a cudaError_t code.
extern "C" int mspi_dwconv2d(const void* x, const void* k, const void* b, void* y, int N, int H,
                             int W, int C, int dtype, void* stream) {
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kFloat32) return mspi::launch_dwconv2d<float>(x, k, b, y, N, H, W, C, s);
  if (dtype == mspi::kBFloat16)
    return mspi::launch_dwconv2d<__nv_bfloat16>(x, k, b, y, N, H, W, C, s);
  return cudaErrorInvalidValue;
}
