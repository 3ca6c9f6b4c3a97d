// Int8 LayerNorm + MLP forward (inference only): y = deq(q(gelu(deq(q(LN(x))
// W1q^T) + b1)) W2q^T) + b2 on token-major rows x [M, C].
//
// Replaces: mspi_tpu/ops/pallas/mlp.py::fused_ln_mlp_int8 (kernel
// _ln_fwd_kernel_q), which the JAX package runs with MSPI_QUANT=int8 for
// every transformer LN+MLP with C >= 256 at inference (the MViT and
// VideoSwin stage-3/4 blocks and the SyncBlock).
//
// Numerics follow the TPU kernel, in its order of operations:
//   LayerNorm statistics in fp32 with var = E[x^2] - mu^2, z kept in fp32;
//   z quantised per row: amax = max(max|z|, 1e-6), code = round(z * (127 /
//   amax)) half to even, scale sz = amax * (1/127);
//   u = fp32(int32 sum of zq * w1q) * (sz * s1) + b1 (the int32 -> fp32
//   conversion rounds to nearest);
//   h = gelu(u) with the degree-8 fast-erf polynomial (_ERF_COEF_FAST,
//   clamped at |z| = 4), whatever the storage type, as the TPU kernel does;
//   h quantised per row over the whole hidden width, as z;
//   y = fp32(int32 sum of hq * w2q) * (sh * s2) + b2, one cast to T.
// Every product and sum of the epilogues is rounded on its own
// (__fmul_rn / __fadd_rn, no contraction into FMAs), as the plain PyTorch
// version computes them. What still differs from it: the order of the LN
// sums and the square root (1/sqrtf), which may move an element across a
// rounding boundary and flip one int8 code on rare elements.
//
// What bounds it on the card: 4*C*H int8 operations per row against 2*C
// values read and written per row -- the tensor cores (int8 peak 1979 TOPS,
// twice bf16) and, in this first version, the weight fragments streamed
// from L2 per row tile.
//
// Design: one block of 8 warps per tile of R rows (64 for C <= 384, 32
// above: the [R, C] int32 accumulator of fc2 lives in registers). h has to
// be quantised per row over all H hidden units before fc2 can start, and the
// kernel never holds a whole [R, H] hidden tile. So it makes two passes over
// fc1: pass 1 computes u and h chunk by chunk (64 hidden units) and keeps
// only each row's running max of |h|; pass 2 recomputes the same u (integer
// products are exact, so h is bit-identical), quantises each chunk of h with
// the row's final scale into shared memory, and accumulates fc2 from it.
// fc1 thus runs twice: 1.5x the work of the two products, at int8 rates.
// Both products run on mma.sync.m16n8k32 s8 x s8 -> s32; A fragments come
// from shared memory (row pitches padded so a warp's 32 fragment loads hit
// 32 banks), B fragments straight from global memory (L2/L1), the int8
// weights in nn.Linear layout being exactly the column-major B operand.
// Static shared memory is at most 31 KB.
//
// Also replaces the int8 body of tools/bench_int8.py::_mlp_call
// (_mlp_int8w_kernel, the int8 lab's mlp_int8w; template flag LAB, bf16 at
// the lab's C = 96): the same two-pass body with the LayerNorm, the biases
// and the GELU compiled out and the lab's own quantisation, in its order of
// operations: per row scale = max(amax, 1e-6) * (1/127) and code =
// round(v / scale) half to even (a true division, where row 12 multiplies
// by 127 / amax); uf = fp32(acc) * sx * s1 (left to right), h = uf; y =
// fp32(acc) * sh * s2, one cast to T. The weight codes and per-channel
// scales are the lab's host quantisation (amax / 127, no floor). At C = 96
// the 12 eight-column tiles of y fall on warps 0-5.

#include <stdint.h>

#include "common.cuh"
#include "int8_mma.cuh"

namespace mspi {
namespace {

constexpr int Q_THREADS = 256;  // 8 warps
constexpr int Q_HC = 64;        // hidden units per chunk
constexpr int Q_LDH = Q_HC + 16;  // pitch (bytes) of the hq tile

// Constants rounded from their decimal through double to float, as Python
// floats reach the JAX kernel's fp32 arithmetic.
__constant__ float kErfFast[9] = {
    static_cast<float>(3.536022699613e-01), static_cast<float>(-1.745360228158e-01),
    static_cast<float>(1.282262975445e-01), static_cast<float>(-1.335568183591e-01),
    static_cast<float>(1.164849409594e-01), static_cast<float>(1.073632742169e-02),
    static_cast<float>(-7.948334927669e-03), static_cast<float>(-1.415578021638e-01),
    static_cast<float>(9.874117476355e-02)};
constexpr float kInvSqrt2 = static_cast<float>(0.70710678118654752440);
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kAmaxFloor = static_cast<float>(1e-6);

template <int C>
__host__ __device__ constexpr int q_rows() { return C <= 384 ? 64 : 32; }

__device__ __forceinline__ float erf_fast(float x) {
  const float z = fminf(fmaxf(x, -4.f), 4.f);
  const float u = __fadd_rn(__fmul_rn(__fmul_rn(z, z), 0.125f), -1.f);
  float r = kErfFast[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) r = __fadd_rn(__fmul_rn(r, u), kErfFast[i]);
  return __fmul_rn(z, r);
}

__device__ __forceinline__ float gelu_fast(float u) {
  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, erf_fast(__fmul_rn(u, kInvSqrt2))));
}

// u = fp32(acc) * (sz * s1) + b1, then h = gelu(u)
__device__ __forceinline__ float hidden(int acc, float sz, float s1, float b1) {
  return gelu_fast(__fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sz, s1)), b1));
}

// The lab's hidden value: uf = fp32(acc) * sx * s1, left to right.
__device__ __forceinline__ float hidden_lab(int acc, float sx, float s1) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), s1);
}

// The lab's per-row scale of a row with max |v| = amax.
__device__ __forceinline__ float lab_scale(float amax) {
  return __fmul_rn(fmaxf(amax, kAmaxFloor), kInv127);
}

__device__ __forceinline__ int8_t lab_code(float v, float scale) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(v, scale)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// fc1 over one hidden chunk for this warp: acc[n] = zq[m-tile rows] . w1q[j..]
// over all C, for the NT1 8-unit column tiles starting at hidden unit j0n.
template <int C, int NT1>
__device__ __forceinline__ void fc1_chunk(int (&acc)[NT1][4], const int8_t* z0,
                                          const int8_t* z1, const int8_t* __restrict__ w1q,
                                          int j0n, int g, int t) {
#pragma unroll
  for (int n = 0; n < NT1; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll 4
  for (int k = 0; k < C; k += 32) {
    uint32_t a[4];
    load_a(a, z0, z1, k, t);
#pragma unroll
    for (int n = 0; n < NT1; ++n) {
      const int8_t* w = w1q + static_cast<int64_t>(j0n + n * 8 + g) * C + k + 4 * t;
      mma_s8(acc[n], a, ldg32(w), ldg32(w + 16));
    }
  }
}

template <typename T, int C, bool LAB>
__global__ void __launch_bounds__(Q_THREADS)
ln_mlp_int8_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const int8_t* __restrict__ w1q,  // [H, C]
                   const float* __restrict__ s1, const float* __restrict__ b1,  // [H]
                   const int8_t* __restrict__ w2q,  // [C, H]
                   const float* __restrict__ s2, const float* __restrict__ b2,  // [C]
                   T* __restrict__ y, int M, int H, float eps) {
  constexpr int R = q_rows<C>();
  constexpr int MT = R / 16;      // 16-row tiles
  constexpr int WPM = 8 / MT;     // fc1: warps per row tile
  constexpr int NT1 = 8 / WPM;    // fc1: 8-unit column tiles per warp and chunk
  constexpr int NT2 = (C + 63) / 64;  // fc2: 8-column tiles of y per warp
  constexpr int LDZ = C + 16;     // pitch (bytes) of the zq tile
  constexpr int PER = C / 32;
  static_assert(C % 32 == 0 && MT * WPM == 8 && WPM * NT1 == 8, "tile layout");
  static_assert(LAB || C % 128 == 0, "row 12's widths");
  __shared__ __align__(16) int8_t zq[R * LDZ];
  __shared__ __align__(16) int8_t hq[R * Q_LDH];
  __shared__ float sz[R], inv_h[R], sh[R];
  __shared__ float part[R][WPM];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;

  // 1. LayerNorm in fp32 and the per-row quantisation of z, one warp per row.
  for (int r = warp; r < R; r += 8) {
    const int64_t m = row0 + r;
    int8_t* zr = zq + r * LDZ;
    if (m >= M) {
      for (int c = lane; c < C; c += 32) zr[c] = 0;
      if (lane == 0) sz[r] = 0.f;
      continue;
    }
    const T* xr = x + m * C;
    float v[PER];
    if constexpr (LAB) {  // the lab: x itself, quantised with a division
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[i] = to_f(xr[lane + 32 * i]);
        amax = fmaxf(amax, fabsf(v[i]));
      }
      const float scale = lab_scale(warp_max(amax));
#pragma unroll
      for (int i = 0; i < PER; ++i) zr[lane + 32 * i] = lab_code(v[i], scale);
      if (lane == 0) sz[r] = scale;
      continue;
    }
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = to_f(xr[lane + 32 * i]);
      s = __fadd_rn(s, v[i]);
      q = __fadd_rn(q, __fmul_rn(v[i], v[i]));
    }
    const float mu = warp_sum(s) / C;
    const float var = __fsub_rn(warp_sum(q) / C, __fmul_rn(mu, mu));
    const float rstd = 1.f / sqrtf(__fadd_rn(var, eps));
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mu), rstd), gamma[c]), beta[c]);
      amax = fmaxf(amax, fabsf(v[i]));
    }
    amax = fmaxf(warp_max(amax), kAmaxFloor);
    const float inv = 127.f / amax;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      zr[lane + 32 * i] = static_cast<int8_t>(__float2int_rn(__fmul_rn(v[i], inv)));
    if (lane == 0) sz[r] = __fmul_rn(amax, kInv127);
  }
  __syncthreads();

  // fc1 tiling: this warp's 16-row tile and its NT1 column tiles of a chunk
  const int mt = warp / WPM;
  const int n0 = (warp % WPM) * NT1 * 8;  // first hidden unit within a chunk
  const int ra = mt * 16 + g, rb = ra + 8;
  const int8_t* z0 = zq + ra * LDZ;
  const int8_t* z1 = zq + rb * LDZ;
  const float sza = sz[ra], szb = sz[rb];

  // 2. Pass 1: each row's max |h| over the whole hidden width.
  float ma = 0.f, mb = 0.f;
  for (int j0 = 0; j0 < H; j0 += Q_HC) {
    int acc[NT1][4];
    fc1_chunk<C, NT1>(acc, z0, z1, w1q, j0 + n0, g, t);
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n0 + n * 8 + 2 * t + (e & 1);
        const float sx = e < 2 ? sza : szb;
        const float h = fabsf(LAB ? hidden_lab(acc[n][e], sx, s1[j])
                                  : hidden(acc[n][e], sx, s1[j], b1[j]));
        if (e < 2) ma = fmaxf(ma, h); else mb = fmaxf(mb, h);
      }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
  }
  if (t == 0) {
    part[ra][warp % WPM] = ma;
    part[rb][warp % WPM] = mb;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += Q_THREADS) {
    float amax = part[r][0];
#pragma unroll
    for (int i = 1; i < WPM; ++i) amax = fmaxf(amax, part[r][i]);
    if constexpr (LAB) {
      sh[r] = lab_scale(amax);
    } else {
      amax = fmaxf(amax, kAmaxFloor);
      inv_h[r] = 127.f / amax;
      sh[r] = __fmul_rn(amax, kInv127);
    }
  }
  __syncthreads();

  // 3. Pass 2: recompute u and h per chunk, quantise h with its row's scale
  //    into shared memory, y += hq . w2q[:, chunk]. This warp owns y columns
  //    warp*NT2*8 .. +NT2*8-1 of every row tile.
  int yacc[MT][NT2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT2; ++n) yacc[m][n][0] = yacc[m][n][1] = yacc[m][n][2] = yacc[m][n][3] = 0;
  const float inva = LAB ? sh[ra] : inv_h[ra], invb = LAB ? sh[rb] : inv_h[rb];
  for (int j0 = 0; j0 < H; j0 += Q_HC) {
    int acc[NT1][4];
    fc1_chunk<C, NT1>(acc, z0, z1, w1q, j0 + n0, g, t);
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n0 + n * 8 + 2 * t + (e & 1);
        const float sx = e < 2 ? sza : szb;
        int8_t code;
        if constexpr (LAB) {  // inva / invb hold the rows' scales
          code = lab_code(hidden_lab(acc[n][e], sx, s1[j0 + jl]), e < 2 ? inva : invb);
        } else {
          const float h = hidden(acc[n][e], sx, s1[j0 + jl], b1[j0 + jl]);
          code = static_cast<int8_t>(__float2int_rn(__fmul_rn(h, e < 2 ? inva : invb)));
        }
        hq[(e < 2 ? ra : rb) * Q_LDH + jl] = code;
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < Q_HC; kk += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        load_a(a[m], hq + (m * 16 + g) * Q_LDH, hq + (m * 16 + g + 8) * Q_LDH, kk, t);
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        if (C % 64 != 0 && (warp * NT2 + n) * 8 >= C) continue;
        const int c = (warp * NT2 + n) * 8 + g;
        const int8_t* w = w2q + static_cast<int64_t>(c) * H + j0 + kk + 4 * t;
        const uint32_t bw0 = ldg32(w), bw1 = ldg32(w + 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_s8(yacc[m][n], a[m], bw0, bw1);
      }
    }
    __syncthreads();  // hq is rewritten by the next chunk
  }

  // 4. y = fp32(acc) * (sh * s2) + b2, one cast to T.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m * 16 + g + (e < 2 ? 0 : 8);
      const int64_t gm = row0 + r;
      if (gm >= M) continue;
      const float shr = sh[r];
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        if (C % 64 != 0 && (warp * NT2 + n) * 8 >= C) continue;
        const int c = (warp * NT2 + n) * 8 + 2 * t + (e & 1);
        const float v =
            LAB ? __fmul_rn(__fmul_rn(__int2float_rn(yacc[m][n][e]), shr), s2[c])
                : __fadd_rn(__fmul_rn(__int2float_rn(yacc[m][n][e]), __fmul_rn(shr, s2[c])),
                            b2[c]);
        y[gm * C + c] = from_f<T>(v);
      }
    }
}

template <typename T, int C, bool LAB = false>
cudaError_t launch_int8(const void* x, const float* g, const float* be, const int8_t* w1q,
                        const float* s1, const float* b1, const int8_t* w2q, const float* s2,
                        const float* b2, void* y, int M, int H, float eps, cudaStream_t s) {
  constexpr int R = q_rows<C>();
  if (H % Q_HC != 0) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(M) + R - 1) / R);
  ln_mlp_int8_kernel<T, C, LAB><<<blocks, Q_THREADS, 0, s>>>(
      static_cast<const T*>(x), g, be, w1q, s1, b1, w2q, s2, b2, static_cast<T*>(y), M, H,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_int8(const void* x, const float* g, const float* be, const int8_t* w1q,
                          const float* s1, const float* b1, const int8_t* w2q,
                          const float* s2, const float* b2, void* y, int M, int C, int H,
                          float eps, cudaStream_t s) {
  switch (C) {
    case 256: return launch_int8<T, 256>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    case 384: return launch_int8<T, 384>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    case 512: return launch_int8<T, 512>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    case 768: return launch_int8<T, 768>(x, g, be, w1q, s1, b1, w2q, s2, b2, y, M, H, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mspi

// x, y: [M, C] of one dtype (0 fp32, 1 bf16); gamma, beta, s2, b2: [C] fp32;
// w1q: [H, C] int8, s1, b1: [H] fp32; w2q: [C, H] int8; all contiguous, the
// int8 codes 16-byte aligned. Returns a cudaError_t code.
extern "C" int mspi_ln_mlp_int8(const void* x, const void* gamma, const void* beta,
                                const void* w1q, const void* s1, const void* b1,
                                const void* w2q, const void* s2, const void* b2, void* y,
                                int M, int C, int H, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* q1 = static_cast<const int8_t*>(w1q);
  const auto* q2 = static_cast<const int8_t*>(w2q);
  const auto* sc1 = static_cast<const float*>(s1);
  const auto* sc2 = static_cast<const float*>(s2);
  const auto* bb1 = static_cast<const float*>(b1);
  const auto* bb2 = static_cast<const float*>(b2);
  if (dtype == mspi::kFloat32)
    return mspi::dispatch_int8<float>(x, g, be, q1, sc1, bb1, q2, sc2, bb2, y, M, C, H, eps, s);
  if (dtype == mspi::kBFloat16)
    return mspi::dispatch_int8<__nv_bfloat16>(x, g, be, q1, sc1, bb1, q2, sc2, bb2, y, M, C, H,
                                              eps, s);
  return cudaErrorInvalidValue;
}

// The int8 lab's mlp_int8w: x [M, 96] bf16; w1q [H, 96] int8 and s1 [H] fp32;
// w2q [96, H] int8 and s2 [96] fp32; y [M, 96] bf16; contiguous, the codes
// 16-byte aligned. Returns a cudaError_t code.
extern "C" int mspi_mlp_int8_lab(const void* x, const void* w1q, const void* s1,
                                 const void* w2q, const void* s2, void* y, int M, int C, int H,
                                 void* stream) {
  if (C != 96) return cudaErrorInvalidValue;
  return mspi::launch_int8<__nv_bfloat16, 96, true>(
      x, nullptr, nullptr, static_cast<const int8_t*>(w1q), static_cast<const float*>(s1),
      nullptr, static_cast<const int8_t*>(w2q), static_cast<const float*>(s2), nullptr, y, M, H,
      0.f, static_cast<cudaStream_t>(stream));
}
