// Stride-1 SAME depthwise 3-D convolution on channels-last tokens, no bias:
//   y[n, t, h, w, c] = sum over (dt, dh, dw) of
//                      x[n, t+dt-1, h+dh-1, w+dw-1, c] * taps[(dt*3 + dh)*3 + dw, c]
// x and y [N, T, H, W, C], taps [27, C] (a 3x3x3 kernel per channel), all in
// the storage type; zeros outside the grid; fp32 accumulation over the taps
// in (dt, dh, dw) order, as the TPU kernel sums them, one rounding at the end.
//
// Replaces: mspi_tpu/ops/pallas/dwconv.py::fused_dwconv3d (kernel _kernel),
// MViT's stride-1 attention pools with MSPI_DWCONV=1: pool_q of the 13 blocks
// without a q stride and pool_k / pool_v of blocks 14-15 (17 per forward) on
// [B*heads, T, H, W, 96], or the same pools on the packed [B, T, H, W,
// heads*96] layout with the kernel tiled over the heads. The backward's dx is
// this kernel on dy with the taps flipped in t, h and w.
//
// The TPU kernel DMAs the three temporal slabs of one output slab [H, W, C]
// into VMEM by hand per (batch, t) step. Here a step is one output slab t of
// a block tile (TH x TW pixels x 32 channels of one n) and needs input slabs
// t - 1, t and t + 1 with a one-pixel halo.
//
// bf16, dwconv3d_sm90_kernel<OH, OW> (C a multiple of 8, x 16-byte aligned):
// - Work: each (channel group, n, tile) walks T in chunks of `chunk`
//   consecutive t (ops/kernels/dwconv.py::dwconv3d_chunk: T halved until
//   there are 2.5 chunks per SM), the channel group outermost; the chunks
//   are split evenly over a persistent grid (at most the blocks that fit on
//   the SMs), and a block's share, whole chunks, runs as one or more runs of
//   consecutive t of one tile. So T is split across blocks wherever N x
//   groups x tiles would leave SMs idle (stages 3-4, and every pool at
//   batch 2), and a run starts on a chunk's edge: block shares that cut
//   chunks ran up to 14% slower, and splits finer or coarser than this
//   rule lost at some pool (PERF.md).
// - Halo slabs stay bf16 ([TH + 2][TW + 2][32], 11.25 KiB at 8 x 16) in a
//   4-slot cp.async ring: per step one barrier, then slab t + 2's copies are
//   issued into the slot that slab t - 2 left, while t is computed from t - 1,
//   t and t + 1. A run starts with its first three slabs (two more than a
//   step loads; one more barrier).
// - Copies are 16 bytes, 8 channels, zero-filled outside the grid and past C
//   (src-size 0): no per-element branch.
// - Lanes are channels: a pixel's 32 channels are 64 contiguous bytes of x,
//   so the halo copies coalesce and a warp's shared reads hit 16 distinct
//   words, one per two lanes, free of bank conflicts. A thread holds its
//   channel's 27 taps (reloaded only when the channel group changes) and the
//   OH x OW outputs of its warp's block in registers; it reads each of the
//   (OH + 2) rows of OW + 2 pixels of each slab once, and each value feeds
//   the up to 3 x 3 (dh, dw) taps of its outputs.
// - Block tiles of 2 x 2 warps, chosen per shape at launch (ops/kernels/
//   dwconv.py::dwconv3d_tile, the least padded area): 8 x 16 (warps of 4 x
//   8 outputs) and 14 x 12 (7 x 6). MViTv2-S's stage grids at 224x384 take
//   56 x 96 in 8 x 16 and 28 x 48, 14 x 24 in 14 x 12 without a padded
//   pixel, and 7 x 12 in one padded 8 x 16 tile: the exact 7 x 12 tile of 2
//   warps ran 5-30% slower there (PERF.md).
// fp32 (and bf16 with C off the 8-channel vector), dwconv3d_kernel<T>, the
// fp32-slab form: a block per 8 x 16 x 32-channel tile of one n walking t
// through three fp32 slabs loaded one element per thread and step.
//
// What bounds it on the card: bytes. 27 multiply-adds per output against 2
// (bf16) or 4 bytes in and out: at MViTv2-S's stage 1 (batch 8, bf16) it
// moves 66 MB in and 66 MB out, about 40 us at 3.35 TB/s; the 27 fp32 FMAs
// per output come to 0.67x that time at 67 TFLOP/s, so the FMA pipe's
// share of the issue slots sets how near it comes.

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

// ---- bf16: the cp.async ring of bf16 halo slabs -----------------------------

namespace dw3 {
constexpr int kCC = 32;        // channels per block: one per lane
constexpr int kSlots = 4;      // slabs t - 1, t, t + 1 in use and t + 2 in flight
}  // namespace dw3

// The block tile of 2 x 2 warps, each owning OH x OW outputs.
template <int OH, int OW>
struct Dw3Tile {
  static constexpr int WH = 2, WW = 2;                // warps along h, w
  static constexpr int kTH = OH * WH, kTW = OW * WW;  // output rows, columns
  static constexpr int kSH = kTH + 2, kSW = kTW + 2;  // slab rows, columns with the halo
  static constexpr int kThreads = 32 * WH * WW;
  static constexpr int kSlabBytes = sizeof(__nv_bfloat16) * kSH * kSW * dw3::kCC;
  static constexpr int kCopies = kSH * kSW * (dw3::kCC / 8);  // 16-byte copies per slab
  static constexpr int kSmem = dw3::kSlots * kSlabBytes;
  static constexpr int kMinBlocks = 512 / kThreads;  // 16 warps per SM: 128 registers
  static_assert(kSlabBytes % 16 == 0, "16-byte slots");
};

template <int OH, int OW>
__global__ void __launch_bounds__(Dw3Tile<OH, OW>::kThreads, Dw3Tile<OH, OW>::kMinBlocks)
    dwconv3d_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ taps, __nv_bfloat16* __restrict__ y,
                         int N, int T_, int H, int W, int C, int chunk) {
  using Z = Dw3Tile<OH, OW>;
  using bf16 = __nv_bfloat16;
  using dw3::kCC;
  constexpr int kTH = Z::kTH, kTW = Z::kTW, kSW = Z::kSW, kThreads = Z::kThreads;
  extern __shared__ __align__(16) unsigned char smem_dw3[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / Z::WW) * OH, wc = (warp % Z::WW) * OW;  // its outputs in the tile
  const int tw = (W + kTW - 1) / kTW, tiles = ((H + kTH - 1) / kTH) * tw;
  const int64_t per_group = static_cast<int64_t>(N) * tiles;
  // the block's chunks of `chunk` consecutive t, as step indices u T + t
  const int per_unit = (T_ + chunk - 1) / chunk;
  const int64_t chunks = (C + kCC - 1) / kCC * per_group * per_unit;
  auto step_of = [&](int64_t ch) {
    const int t0 = static_cast<int>(ch % per_unit) * chunk;
    return ch / per_unit * T_ + (t0 < T_ ? t0 : T_);
  };
  int64_t i = step_of(chunks * blockIdx.x / gridDim.x);
  const int64_t i_end = step_of(chunks * (blockIdx.x + 1) / gridDim.x);

  float tap[27];
  int g_taps = -1;  // the channel group whose taps are in registers
  int loads = 0;    // slabs issued so far: slab number j goes to slot j % kSlots
  while (i < i_end) {  // one run of consecutive t of one tile
    const int64_t u = i / T_;
    int t = static_cast<int>(i % T_);
    const int g = static_cast<int>(u / per_group), rest = static_cast<int>(u % per_group);
    const int n = rest / tiles, tile = rest % tiles;
    const int h0 = tile / tw * kTH, w0 = tile % tw * kTW;
    const int run = static_cast<int>(i_end - i < T_ - t ? i_end - i : T_ - t);
    const bf16* img = x + static_cast<int64_t>(n) * T_ * H * W * C + g * kCC;
    const int cg = C - g * kCC;  // channels of this group in range

    // slab ts (zeros outside 0 <= ts < T) into the next slot, one commit group
    auto issue = [&](int ts) {
      bf16* slot = reinterpret_cast<bf16*>(smem_dw3 + (loads % dw3::kSlots) * Z::kSlabBytes);
      const bool t_ok = ts >= 0 && ts < T_;
      const bf16* src = img + static_cast<int64_t>(t_ok ? ts : 0) * H * W * C;
      for (int e = tid; e < Z::kCopies; e += kThreads) {
        const int px = e >> 2, cc = (e & 3) * 8;
        const int hh = h0 - 1 + px / kSW, ww = w0 - 1 + px % kSW;
        const bool ok = t_ok && hh >= 0 && hh < H && ww >= 0 && ww < W && cc < cg;
        cp_async16(slot + px * kCC + cc,
                   ok ? src + (static_cast<int64_t>(hh) * W + ww) * C + cc : x, ok);
      }
      cp_async_commit();
      ++loads;
    };
    __syncthreads();  // every warp is done with the previous run's slots
    const int first = loads;  // slab t - 1 of this run
    issue(t - 1);
    issue(t);
    issue(t + 1);
    const int c = g * kCC + lane;
    if (g != g_taps) {
      g_taps = g;
#pragma unroll
      for (int k = 0; k < 27; ++k) tap[k] = c < C ? to_f(taps[k * C + c]) : 0.f;
    }
    for (int s = 0; s < run; ++s, ++t) {
      cp_async_wait<0>();
      __syncthreads();  // slab t + 1 is in; every warp is done with slab t - 2's slot
      if (s + 1 < run) issue(t + 2);
      if (h0 + wr >= H || w0 + wc >= W) continue;  // this warp's outputs lie outside
      float acc[OH][OW];
#pragma unroll
      for (int o = 0; o < OH; ++o)
#pragma unroll
        for (int q = 0; q < OW; ++q) acc[o][q] = 0.f;
      // input row r of the warp's (OH + 2) reaches output rows o = r - dh:
      // for each output the taps arrive in (dt, dh, dw) order
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const bf16* slab = reinterpret_cast<const bf16*>(
            smem_dw3 + ((first + s + dt) % dw3::kSlots) * Z::kSlabBytes);
#pragma unroll
        for (int r = 0; r < OH + 2; ++r) {
          float v[OW + 2];
          const bf16* row = slab + ((wr + r) * kSW + wc) * kCC + lane;
#pragma unroll
          for (int q = 0; q < OW + 2; ++q) v[q] = to_f(row[q * kCC]);
#pragma unroll
          for (int o = 0; o < OH; ++o) {
            const int dh = r - o;
            if (dh < 0 || dh > 2) continue;
#pragma unroll
            for (int dw = 0; dw < 3; ++dw)
#pragma unroll
              for (int q = 0; q < OW; ++q)
                acc[o][q] = fmaf(v[q + dw], tap[(dt * 3 + dh) * 3 + dw], acc[o][q]);
          }
        }
      }
      if (c >= C) continue;
#pragma unroll
      for (int o = 0; o < OH; ++o) {
        const int hh = h0 + wr + o;
        if (hh >= H) break;
        bf16* yp = y + ((static_cast<int64_t>(n) * T_ + t) * H + hh) * W * C +
                   static_cast<int64_t>(w0 + wc) * C + c;
#pragma unroll
        for (int q = 0; q < OW; ++q)
          if (w0 + wc + q < W) yp[static_cast<int64_t>(q) * C] = __float2bfloat16(acc[o][q]);
      }
    }
    i += run;
  }
}

template <int OH, int OW>
cudaError_t launch_dwconv3d_sm90(const void* x, const void* taps, void* y, int N, int T_, int H,
                                 int W, int C, int chunk, cudaStream_t stream) {
  using Z = Dw3Tile<OH, OW>;
  auto kernel = dwconv3d_sm90_kernel<OH, OW>;
  const int64_t tiles =
      static_cast<int64_t>((H + Z::kTH - 1) / Z::kTH) * ((W + Z::kTW - 1) / Z::kTW);
  const int64_t units = (C + dw3::kCC - 1) / dw3::kCC * N * tiles;
  if (units >= (int64_t{1} << 31) || chunk < 1) return cudaErrorInvalidValue;
  const int64_t chunks = units * ((T_ + chunk - 1) / chunk);
  cudaError_t err = allow_smem(kernel, Z::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Z::kThreads, Z::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<unsigned>(chunks < slots ? chunks : slots), Z::kThreads, Z::kSmem,
           stream>>>(static_cast<const __nv_bfloat16*>(x),
                     static_cast<const __nv_bfloat16*>(taps), static_cast<__nv_bfloat16*>(y),
                     N, T_, H, W, C, chunk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mspi

// x, y [N, T, H, W, C] channels-last; taps [27, C] ((dt, dh, dw) row-major);
// all in one storage type. tile: -1 runs dwconv3d_kernel, the fp32-slab form
// (fp32, or any bf16 shape); 0 and 1 the bf16 ring kernel with the block tile 8 x 16 or 14 x 12
// (ops/kernels/dwconv.py::DWCONV3D_TILES) and T in chunks of `chunk` t,
// which takes C a multiple of 8 and x 16-byte aligned. Returns a
// cudaError_t code.
extern "C" int mspi_dwconv3d(const void* x, const void* taps, void* y, int N, int T, int H,
                             int W, int C, int dtype, int tile, int chunk, void* stream) {
  if (N <= 0 || N > 65535 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile >= 0) {
    if (dtype != mspi::kBFloat16 || C % 8) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorMisalignedAddress;
    if (tile == 0) return mspi::launch_dwconv3d_sm90<4, 8>(x, taps, y, N, T, H, W, C, chunk, s);
    if (tile == 1) return mspi::launch_dwconv3d_sm90<7, 6>(x, taps, y, N, T, H, W, C, chunk, s);
    return cudaErrorInvalidValue;
  }
  if (dtype == mspi::kFloat32) return mspi::launch_dwconv3d<float>(x, taps, y, N, T, H, W, C, s);
  if (dtype == mspi::kBFloat16)
    return mspi::launch_dwconv3d<__nv_bfloat16>(x, taps, y, N, T, H, W, C, s);
  return cudaErrorInvalidValue;
}
