// Stride-1 SAME depthwise 3-D convolution on channels-last tokens, no bias:
//   y[n, t, h, w, c] = sum over (dt, dh, dw) of
//                      x[n, t+dt-1, h+dh-1, w+dw-1, c] * taps[(dt*3 + dh)*3 + dw, c]
// x and y [N, T, H, W, C], taps [27, C] (a 3x3x3 kernel per channel), all in
// the storage type; zeros outside the grid; fp32 accumulation over the taps
// in (dt, dh, dw) order, as the TPU kernel sums them.
//
// Replaces: mspi_tpu/ops/pallas/dwconv.py::fused_dwconv3d (kernel _kernel),
// MViT's stride-1 attention pools with MSPI_DWCONV=1: pool_q of the 13 blocks
// without a q stride and pool_k / pool_v of blocks 14-15 (17 per forward) on
// [B*heads, T, H, W, 96], or the same pools on the packed [B, T, H, W,
// heads*96] layout with the kernel tiled over the heads. The backward's dx is
// this kernel on dy with the taps flipped in t, h and w.
//
// The TPU kernel DMAs the three temporal slabs of one output slab [H, W, C]
// into VMEM by hand per (batch, t) step. Here a block owns an 8 x 16 spatial
// tile and 32 channels of one n and walks t, keeping a ring of three fp32
// slabs with a one-pixel halo ([10][18][32], 23 KB each) in shared memory:
// each input slab is loaded once per block (1.4x with the halo), not three
// times. Thread (row, lane) owns channel lane of output row `row` of the tile
// and its 27 taps in registers, and computes the row's 16 outputs from one
// register copy of each of the 9 slab rows it needs. Loads and stores run
// along C, channels-last, so a warp touches 32 consecutive channels.
//
// What bounds it on the card: bytes. 27 multiply-adds per output against 2
// (bf16) or 4 bytes in and out: at MViTv2-S's stage 1 (batch 8, bf16) it
// moves 66 MB in and 66 MB out, about 40 us at 3.35 TB/s.

#include "common.cuh"

#include <stdint.h>

namespace mspi {
namespace {

constexpr int kTH = 8, kTW = 16, kCC = 32;  // output tile rows, columns, channels
constexpr int kSH = kTH + 2, kSW = kTW + 2;  // slab rows and columns with the halo
constexpr int kSlab = kSH * kSW * kCC;
constexpr int kDwThreads = 32 * kTH;  // one warp per output row

template <typename T>
__device__ __forceinline__ void load_slab(const T* x, int n, int ts, int T_, int H, int W, int C,
                                          int h0, int w0, int c0, float* dst) {
  for (int e = threadIdx.x; e < kSlab; e += kDwThreads) {
    const int cc = e % kCC, pix = e / kCC;
    const int hh = h0 - 1 + pix / kSW, ww = w0 - 1 + pix % kSW;
    float v = 0.f;
    if (ts >= 0 && ts < T_ && hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + cc < C)
      v = to_f(x[((((static_cast<int64_t>(n) * T_ + ts) * H + hh) * W) + ww) * C + c0 + cc]);
    dst[e] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    dwconv3d_kernel(const T* x, const T* taps, T* y, int T_, int H, int W, int C) {
  extern __shared__ __align__(16) float ring[];  // [3][kSH][kSW][kCC]; slab ts in (ts + 1) % 3
  const int tiles_w = (W + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / tiles_w) * kTH, w0 = (blockIdx.x % tiles_w) * kTW;
  const int c0 = blockIdx.y * kCC, n = blockIdx.z;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int c = c0 + lane;
  float wr[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) wr[i] = c < C ? to_f(taps[i * C + c]) : 0.f;

  load_slab(x, n, -1, T_, H, W, C, h0, w0, c0, ring);          // slot 0: zeros
  load_slab(x, n, 0, T_, H, W, C, h0, w0, c0, ring + kSlab);   // slot 1
  for (int t = 0; t < T_; ++t) {
    load_slab(x, n, t + 1, T_, H, W, C, h0, w0, c0, ring + ((t + 2) % 3) * kSlab);
    __syncthreads();
    float acc[kTW];
#pragma unroll
    for (int j = 0; j < kTW; ++j) acc[j] = 0.f;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const float* s = ring + ((t + dt) % 3) * kSlab;  // slab t - 1 + dt
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        float r[kSW];
#pragma unroll
        for (int j = 0; j < kSW; ++j) r[j] = s[((row + dh) * kSW + j) * kCC + lane];
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float wv = wr[(dt * 3 + dh) * 3 + dw];
#pragma unroll
          for (int j = 0; j < kTW; ++j) acc[j] = fmaf(r[j + dw], wv, acc[j]);
        }
      }
    }
    const int hh = h0 + row;
    if (hh < H && c < C) {
      T* yp = y + (((static_cast<int64_t>(n) * T_ + t) * H + hh) * W) * C + c;
#pragma unroll
      for (int j = 0; j < kTW; ++j)
        if (w0 + j < W) yp[static_cast<int64_t>(w0 + j) * C] = from_f<T>(acc[j]);
    }
    __syncthreads();  // the next step overwrites slab t - 1
  }
}

template <typename T>
cudaError_t launch_dwconv3d(const void* x, const void* taps, void* y, int N, int T_, int H,
                            int W, int C, cudaStream_t stream) {
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), (C + kCC - 1) / kCC, N);
  const size_t smem = sizeof(float) * 3 * kSlab;
  cudaError_t err = allow_smem(dwconv3d_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dwconv3d_kernel<T><<<grid, kDwThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(taps), static_cast<T*>(y), T_, H, W, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mspi

// x, y [N, T, H, W, C] channels-last; taps [27, C] ((dt, dh, dw) row-major);
// all in one storage type. Returns a cudaError_t code.
extern "C" int mspi_dwconv3d(const void* x, const void* taps, void* y, int N, int T, int H,
                             int W, int C, int dtype, void* stream) {
  if (N <= 0 || N > 65535 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kFloat32) return mspi::launch_dwconv3d<float>(x, taps, y, N, T, H, W, C, s);
  if (dtype == mspi::kBFloat16)
    return mspi::launch_dwconv3d<__nv_bfloat16>(x, taps, y, N, T, H, W, C, s);
  return cudaErrorInvalidValue;
}
