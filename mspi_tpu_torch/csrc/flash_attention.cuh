// Flash-style attention body shared by attention_rel.cu (MViT pooled attention
// with the decomposed relative-position bias, head-major or token-major with
// the residual epilogue), self_attention.cu (SyncBlock multi-head
// self-attention), attention.cu (MViT attention on augmented q/k lanes) and
// window_attention.cu (VideoSwin window attention with a dense bias and shift
// mask).
//
// One block computes BQ = 64 query rows of one (batch, head) and walks the
// keys in tiles of BK = 64 with an online softmax (fp32 running max and sum
// per row), so the [Nq, Nk] score matrix never reaches device memory and
// shared memory does not depend on Nk. Ragged query and key tiles are masked
// in the kernel: out-of-range queries are computed on zeros and not written,
// out-of-range keys get a score of -inf.
//
// Tensors are addressed through (batch, head, token) element strides with the
// head's D features contiguous, so the same body reads head-major [B, H, N, D]
// (MViT) and packed token-major [B, N, H*D] / [B, N, 2*H*D] (SyncBlock, the
// MViT packed layout) in place, without transpose copies.
//
// Score and value widths: the kernels are templated on DK, the width of the
// q k^T contraction, and DV, the width of v and out. They are equal except
// for the augmented-lane attention (q_aug = [q*scale | rel], k_aug = [k | E],
// Da = 96 + R lanes, DV = 96): its rows of Da elements need not be 16-byte
// (or, at an odd Da, 4-byte) aligned, and are zero-filled to DK = 128, 144,
// 176, 192 or 256 lanes (aug_width), which leaves the scores exact; past
// 256, to a multiple of 64 lanes taken in chunks (the wide form).
//
// The bias mode (template argument BIAS):
//   kNoBias:    S = scale * q k^T.
//   kRelBias:   the bias of query i and key j is rebuilt from the narrow
//               per-query projections rel [.., Nq, R] (R = kt + kh + kw,
//               columns t | h | w) and the key's row-major (t, h, w) index:
//                 bias = rel[i, t(j)] + rel[i, kt + h(j)] + rel[i, kt + kh + w(j)]
//               which equals rel . E^T for the 0/1 expansion E that the TPU
//               kernel multiplies in (mspi_tpu/models/mvit.py::_onehot_rows).
//   kDenseBias: S = q_s k^T + bias[h, i, j] (+ mask[b mod nw, i, j] when mask
//               is not null), both [.., Nq, Nk] contiguous in the storage
//               type (read from L2 per score by the fp32 body, in tiles
//               through shared memory by the sm90 body); q_s = q * qscale
//               rounded to the storage type as q is loaded, as the TPU
//               window kernel scales q before Q K^T (scale is then 1).
//   kRelBiasRes: kRelBias with the residual epilogue of MViT's residual
//               pooling: out = (o / l rounded to the storage type) + q, added
//               in the storage type (the token-major packed attention).
//
// Which body serves which mode and dtype:
//   bf16, every mode (K4, K1, row 8, row 15, and row 6's augmented lanes
//         with DK != DV): flash_attention_sm90.cuh
//         (flash_attention_sm90_kernel: mma.sync fragments in registers,
//         cp.async ring); launch_flash_attention routes the equal widths
//         there, attention.cu row 6;
//   fp32, every mode (flash_attention_kernel below): both products on the
//         fp32 FMA pipes (tensor cores would round to TF32), 4x4 register
//         tiles per thread; the augmented lanes load one element at a time
//         into zero-filled rows of DK lanes in shared memory.
// Thread layout of the fp32 body (256 threads): ty = tid / 16 owns query rows
// ty*4 .. ty*4+3, tx = tid % 16 owns keys tx*4 .. tx*4+3 of the score tile
// and output columns tx + 16*dd of the [64, D] accumulator. A row's 16
// owners sit in one half warp, so row max and row sum are 4 xor-shuffles.
//
// What bounds it on the card: 4*D flops per (query, key) pair; q, k, v and
// rel are read once per query tile, which at D = 96 and BQ = 64 keeps it far
// above the memory roofline: the fp32 pipes (67 TFLOP/s).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace mspi {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPitch = 68;  // padded row pitch (floats) of qs, ks and ps
constexpr int kAttnThreads = 256;

enum BiasMode : int { kNoBias = 0, kRelBias = 1, kDenseBias = 2, kRelBiasRes = 3 };

// The modes that rebuild the decomposed rel-pos bias.
__host__ __device__ constexpr bool rel_mode(int bias) {
  return bias == kRelBias || bias == kRelBiasRes;
}

struct AttnStrides {
  int64_t b, h, n;  // element strides of batch, head and token; features contiguous
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* rel;   // [.., Nq, R] with strides rs, or null
  const void* bias;  // kDenseBias: [heads, Nq, Nk]
  const void* mask;  // kDenseBias: [nw, Nq, Nk] for window b mod nw, or null
  void* out;
  float* lse;  // [batch * heads, Nq] row log-sum-exp for the backward, or null
  AttnStrides qs, ks, vs, rs, os;
  int heads, nq, nk;
  int dk;             // q and k row width when DK != DV (augmented lanes), <= DK
  int r, kt, kh, kw;  // rel width and key grid (rel modes only)
  int nw;             // mask windows (kDenseBias only)
  float scale;        // multiplies q k^T
  float qscale;       // kDenseBias: multiplies q as it is loaded, in the storage type
};

// kDenseBias: bias (+ mask) of query qi and key kj for window b, head h,
// added to s one term at a time as the TPU kernel adds them (0 past Nq).
template <typename T>
__device__ __forceinline__ float add_dense_bias(const AttnArgs& a, int b, int h, int qi, int kj,
                                                float s) {
  if (qi >= a.nq) return s;
  const int64_t at = static_cast<int64_t>(qi) * a.nk + kj;
  s += to_f(static_cast<const T*>(a.bias)[static_cast<int64_t>(h) * a.nq * a.nk + at]);
  if (a.mask != nullptr)
    s += to_f(static_cast<const T*>(a.mask)[static_cast<int64_t>(b % a.nw) * a.nq * a.nk + at]);
  return s;
}

// Scale, bias and mask the thread's 4x4 scores (rows q0+ty*4+i, keys
// k0+tx*4+jj), fold them into the running max m_run and sum l_run, and turn
// them into unnormalised probabilities; alpha[i] rescales row i's accumulator.
template <typename T, int BIAS>
__device__ __forceinline__ void softmax_update(const AttnArgs& a, const float* rels, int b,
                                               int h, int q0, int k0, int tx, int ty,
                                               float (&s)[4][4],
                                               float (&m_run)[4], float (&l_run)[4],
                                               float (&alpha)[4]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int kj = k0 + tx * 4 + jj;
    if (kj >= a.nk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][jj] = -INFINITY;
      continue;
    }
    int ct = 0, ch = 0, cw = 0;
    if (rel_mode(BIAS)) {
      ct = kj / (a.kh * a.kw);
      ch = a.kt + (kj / a.kw) % a.kh;
      cw = a.kt + a.kh + kj % a.kw;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = s[i][jj] * a.scale;
      if (rel_mode(BIAS)) {
        const float* rr = rels + (ty * 4 + i) * a.r;
        v += rr[ct] + rr[ch] + rr[cw];
      }
      if (BIAS == kDenseBias) v = add_dense_bias<T>(a, b, h, q0 + ty * 4 + i, kj, v);
      s[i][jj] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run[i], mx);  // finite: key k0 is in range
    alpha[i] = expf(m_run[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      s[i][jj] = expf(s[i][jj] - m_new);
      sum += s[i][jj];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_run[i] = l_run[i] * alpha[i] + sum;
    m_run[i] = m_new;
  }
}

// The block's rel rows [kBQ, R] into shared memory (fp32, zeros past Nq).
template <typename T, int BIAS>
__device__ __forceinline__ void load_rel_rows(const AttnArgs& a, int b, int h, int q0,
                                              float* rels) {
  if (!rel_mode(BIAS)) return;
  const T* rp = static_cast<const T*>(a.rel) + b * a.rs.b + h * a.rs.h;
  for (int e = threadIdx.x; e < kBQ * a.r; e += kAttnThreads) {
    const int r = e / a.r, c = e % a.r;
    const int i = q0 + r;
    rels[e] = (i < a.nq) ? to_f(rp[i * a.rs.n + c]) : 0.f;
  }
}

// out rows ty*4+i, columns tx+16*dd = o / l (kRelBiasRes: + q, in the
// storage type); with a.lse, also the rows' log-sum-exp m + log(l) (each
// row's 16 owners hold the same m and l).
template <typename T, int D, int BIAS>
__device__ __forceinline__ void store_rows(const AttnArgs& a, int b, int h, int q0, int tx,
                                           int ty, const float (&o)[4][D / 16],
                                           const float (&m_run)[4], const float (&l_run)[4]) {
  T* op = static_cast<T*>(a.out) + b * a.os.b + h * a.os.h;
  const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < a.nq) {
      const float inv = 1.f / l_run[i];
      if (a.lse != nullptr && tx == 0)
        a.lse[(static_cast<int64_t>(b) * a.heads + h) * a.nq + qi] = m_run[i] + logf(l_run[i]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const int c = tx + 16 * dd;
        T y = from_f<T>(o[i][dd] * inv);
        if (BIAS == kRelBiasRes) y = from_f<T>(to_f(y) + to_f(qp[qi * a.qs.n + c]));
        op[qi * a.os.n + c] = y;
      }
    }
  }
}

// ---- fp32: FMA pipes ---------------------------------------------------------

template <int DK, int DV>
constexpr size_t attn_smem_bytes(int r) {
  return (static_cast<size_t>(DK) * kPitch * 2  // qs, ks (transposed)
          + static_cast<size_t>(kBK) * DV       // vs
          + static_cast<size_t>(kBQ) * kPitch   // ps
          + static_cast<size_t>(kBQ) * r)       // rels
         * sizeof(float);
}

template <int DK, int DV, int BIAS>
__global__ void __launch_bounds__(kAttnThreads) flash_attention_kernel(AttnArgs a) {
  static_assert(DK % 16 == 0 && DV % 16 == 0, "widths must be multiples of 16");
  constexpr int DPT = DV / 16;  // output columns per thread
  constexpr bool kNarrow = DK != DV;  // augmented lanes: q/k rows of a.dk elements
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;             // [DK][kPitch]: qs[d][row]
  float* ks = qs + DK * kPitch;     // [DK][kPitch]: ks[d][key]
  float* vs = ks + DK * kPitch;     // [kBK][DV]
  float* ps = vs + kBK * DV;        // [kBQ][kPitch]
  float* rels = ps + kBQ * kPitch;  // [kBQ][R]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * kBQ;
  const float* qp = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kp = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;

  const float qscale = BIAS == kDenseBias ? a.qscale : 1.f;
  const int dk = kNarrow ? a.dk : DK;
  for (int e = tid; e < kBQ * DK; e += kAttnThreads) {
    const int r = e / DK, d = e % DK;
    const int i = q0 + r;
    qs[d * kPitch + r] = (i < a.nq && d < dk) ? qp[i * a.qs.n + d] * qscale : 0.f;
  }
  load_rel_rows<float, BIAS>(a, b, h, q0, rels);

  float m_run[4], l_run[4], o[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) o[i][dd] = 0.f;
  }

  for (int k0 = 0; k0 < a.nk; k0 += kBK) {
    __syncthreads();  // previous tile's ks / vs / ps reads are done
    if constexpr (kNarrow) {
      for (int e = tid; e < kBK * DK; e += kAttnThreads) {
        const int j = e / DK, d = e % DK;
        const int kj = k0 + j;
        ks[d * kPitch + j] = (kj < a.nk && d < dk) ? kp[kj * a.ks.n + d] : 0.f;
      }
      for (int e = tid; e < kBK * DV; e += kAttnThreads) {
        const int j = e / DV, d = e % DV;
        const int kj = k0 + j;
        vs[j * DV + d] = kj < a.nk ? vp[kj * a.vs.n + d] : 0.f;
      }
    } else {
      for (int e = tid; e < kBK * DK; e += kAttnThreads) {
        const int j = e / DK, d = e % DK;
        const int kj = k0 + j;
        const bool ok = kj < a.nk;
        ks[d * kPitch + j] = ok ? kp[kj * a.ks.n + d] : 0.f;
        vs[j * DV + d] = ok ? vp[kj * a.vs.n + d] : 0.f;
      }
    }
    __syncthreads();

    // scores s[i][jj] for rows ty*4+i, keys tx*4+jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kPitch + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * kPitch + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
    }

    float alpha[4];
    softmax_update<float, BIAS>(a, rels, b, h, q0, k0, tx, ty, s, m_run, l_run, alpha);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) o[i][dd] *= alpha[i];
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPitch + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // o += p v
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPitch + j];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float vv = vs[j * DV + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][dd] = fmaf(p[i], vv, o[i][dd]);
      }
    }
  }
  store_rows<float, DV, BIAS>(a, b, h, q0, tx, ty, o, m_run, l_run);
}

using bf16 = __nv_bfloat16;

// rows [t0, t0+64) of an operand whose rows hold `cols` <= D elements at any
// alignment (the augmented lanes), one element per load, into dst [64][ld]:
// zeros past `cols` and past n.
template <int D, int THREADS, typename T>
__device__ __forceinline__ void load_rows_narrow(const T* src, int64_t stride, int t0, int n,
                                                 int cols, T* dst, int ld) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * ld + c] = (t0 + r < n && c < cols) ? src[(t0 + r) * stride + c] : from_f<T>(0.f);
  }
}

// The bf16 body of equal score and value widths, defined in
// flash_attention_sm90.cuh (included by the sources that launch it).
template <int D, int BIAS>
cudaError_t launch_flash_attention_sm90(const AttnArgs& a, int batch, cudaStream_t stream);

template <typename T, int DK, int DV, int BIAS>
cudaError_t launch_flash_attention(const AttnArgs& a, int batch, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(DK == DV, "bf16 with DK != DV (row 6) runs launch_flash_attention_aug_sm90");
    return launch_flash_attention_sm90<DK, BIAS>(a, batch, stream);
  } else {
    const dim3 grid((a.nq + kBQ - 1) / kBQ, batch * a.heads);
    const size_t smem = attn_smem_bytes<DK, DV>(rel_mode(BIAS) ? a.r : 0);
    cudaError_t err = allow_smem(flash_attention_kernel<DK, DV, BIAS>, smem);
    if (err != cudaSuccess) return err;
    flash_attention_kernel<DK, DV, BIAS><<<grid, kAttnThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

// Head dims by bias mode: 96 and 128 (MViT, SyncBlock) without a dense bias,
// and 64 (UniFormer-B's stages 3-4, K4 only); 96 (MViT) with the residual
// epilogue, 32 (VideoSwin) with a dense bias.
template <typename T, int BIAS>
cudaError_t launch_flash_attention_d(const AttnArgs& a, int batch, int d, cudaStream_t s) {
  if constexpr (BIAS == kDenseBias) {
    if (d == 32) return launch_flash_attention<T, 32, 32, BIAS>(a, batch, s);
  } else if constexpr (BIAS == kRelBiasRes) {
    if (d == 96) return launch_flash_attention<T, 96, 96, BIAS>(a, batch, s);
  } else {
    if constexpr (BIAS == kNoBias) {
      if (d == 64) return launch_flash_attention<T, 64, 64, BIAS>(a, batch, s);
    }
    if (d == 96) return launch_flash_attention<T, 96, 96, BIAS>(a, batch, s);
    if (d == 128) return launch_flash_attention<T, 128, 128, BIAS>(a, batch, s);
  }
  return cudaErrorInvalidValue;
}

// The augmented lanes' score widths: q_aug / k_aug rows of Da = 96 + R lanes
// zero-filled to DK = 128 (Da <= 128: every R up to 32, MViTv2-S's Da 109
// and 114 at --resolution 64 96 among them), 144 (Da <= 144), 176 (Da <=
// 176), 192 (Da <= 192: MViTv2-S's 180 at --resolution 448 768 and 184 at
// 512 768) or 256 (Da <= 256: R up to 160, at 16 frames H / 16 + W / 16 <=
// 152, e.g. --resolution 1024 1408), each a compile-time form; past 256 the
// wide form, Da rounded up to a multiple of kAugChunk = 64 (Da 258 at
// --resolution 1024 1440, 320 at 1536 1920, 400 at 2048 2688), whose score
// width is a run-time value: q and k stream through shared memory in
// 64-lane chunks and S accumulates over them (attention.cu, the FMA body
// below, attention_aug_bwd_sm90.cu, attention_bwd.cu). 0 only for da <= 0.
// Row 6's forward and its backward (row 7 head-major) take the same form in
// fp32 and bf16; pooled_attention.py's aug_form mirrors it. Nothing but this
// choice depends on Da: q_aug's fragments, the pad copies and the fp32 loads
// all zero-fill past Da.
constexpr int kAugChunk = 64;
constexpr int kAugMaxFixed = 256;  // the widest compile-time form
__host__ __device__ constexpr int aug_width(int da) {
  return da <= 0     ? 0
         : da <= 128 ? 128
         : da <= 144 ? 144
         : da <= 176 ? 176
         : da <= 192 ? 192
         : da <= kAugMaxFixed ? 256
                              : (da + kAugChunk - 1) / kAugChunk * kAugChunk;
}

// fp32 row 6 in the wide form (Da > 256): flash_attention_kernel's
// threads and tiles with the score contraction in chunks of kAugChunk
// lanes: per key tile, each chunk of q and k (one element at a time, zeros
// past Da and past Nq / Nk) goes into transposed [64][kPitch] tiles and the
// thread's 4x4 scores accumulate over the chunks in registers, in the order
// the narrow body sums d = 0 .. Da - 1. q is read again per key tile (from
// L2), so shared memory does not grow with Da.
constexpr size_t attn_wide_f32_smem_bytes() {
  return (static_cast<size_t>(kAugChunk) * kPitch * 2  // qs, ks chunks (transposed)
          + static_cast<size_t>(kBK) * 96               // vs
          + static_cast<size_t>(kBQ) * kPitch)          // ps
         * sizeof(float);
}

template <int DV>
__global__ void __launch_bounds__(kAttnThreads) flash_attention_aug_wide_f32_kernel(AttnArgs a) {
  constexpr int DPT = DV / 16;
  extern __shared__ __align__(16) float smem_wide_f32[];
  float* qs = smem_wide_f32;          // [kAugChunk][kPitch]: qs[d][row]
  float* ks = qs + kAugChunk * kPitch;  // [kAugChunk][kPitch]: ks[d][key]
  float* vs = ks + kAugChunk * kPitch;  // [kBK][DV]
  float* ps = vs + kBK * DV;            // [kBQ][kPitch]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * kBQ;
  const float* qp = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kp = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;

  float m_run[4], l_run[4], o[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) o[i][dd] = 0.f;
  }
  for (int k0 = 0; k0 < a.nk; k0 += kBK) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int c0 = 0; c0 < a.dk; c0 += kAugChunk) {
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      for (int e = tid; e < kBQ * kAugChunk; e += kAttnThreads) {
        const int r = e / kAugChunk, d = e % kAugChunk;
        const int i = q0 + r, kj = k0 + r;
        const bool in_d = c0 + d < a.dk;
        qs[d * kPitch + r] = i < a.nq && in_d ? qp[i * a.qs.n + c0 + d] : 0.f;
        ks[d * kPitch + r] = kj < a.nk && in_d ? kp[kj * a.ks.n + c0 + d] : 0.f;
      }
      if (c0 == 0) {
        for (int e = tid; e < kBK * DV; e += kAttnThreads) {
          const int j = e / DV, d = e % DV;
          vs[j * DV + d] = k0 + j < a.nk ? vp[(k0 + j) * a.vs.n + d] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kAugChunk; ++d) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + d * kPitch + ty * 4);
        const float4 kv = *reinterpret_cast<const float4*>(ks + d * kPitch + tx * 4);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
      }
    }
    float alpha[4];
    softmax_update<float, kNoBias>(a, nullptr, b, h, q0, k0, tx, ty, s, m_run, l_run, alpha);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) o[i][dd] *= alpha[i];
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPitch + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPitch + j];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float vv = vs[j * DV + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][dd] = fmaf(p[i], vv, o[i][dd]);
      }
    }
  }
  store_rows<float, DV, kNoBias>(a, b, h, q0, tx, ty, o, m_run, l_run);
}

// fp32 augmented-lane attention on the FMA pipes: q/k rows of a.dk lanes
// (zero-filled to aug_width(a.dk) in shared memory, or in the wide form
// streamed in 64-lane chunks), v and out of dv = 96 lanes, no bias and no
// scale. bf16 runs flash_attention_sm90.cuh's body (attention.cu).
inline cudaError_t launch_flash_attention_aug_f32(const AttnArgs& a, int batch, int dv,
                                                  cudaStream_t s) {
  if (dv != 96) return cudaErrorInvalidValue;
  switch (aug_width(a.dk)) {
    case 0: return cudaErrorInvalidValue;
    case 128: return launch_flash_attention<float, 128, 96, kNoBias>(a, batch, s);
    case 144: return launch_flash_attention<float, 144, 96, kNoBias>(a, batch, s);
    case 176: return launch_flash_attention<float, 176, 96, kNoBias>(a, batch, s);
    case 192: return launch_flash_attention<float, 192, 96, kNoBias>(a, batch, s);
    case 256: return launch_flash_attention<float, 256, 96, kNoBias>(a, batch, s);
    default: {
      const dim3 grid((a.nq + kBQ - 1) / kBQ, batch * a.heads);
      const size_t smem = attn_wide_f32_smem_bytes();
      cudaError_t err = allow_smem(flash_attention_aug_wide_f32_kernel<96>, smem);
      if (err != cudaSuccess) return err;
      flash_attention_aug_wide_f32_kernel<96><<<grid, kAttnThreads, smem, s>>>(a);
      return cudaGetLastError();
    }
  }
}

template <int BIAS>
cudaError_t dispatch_flash_attention(const AttnArgs& a, int batch, int d, int dtype,
                                     cudaStream_t s) {
  if (dtype == kFloat32) return launch_flash_attention_d<float, BIAS>(a, batch, d, s);
  if (dtype == kBFloat16) return launch_flash_attention_d<__nv_bfloat16, BIAS>(a, batch, d, s);
  return cudaErrorInvalidValue;
}

// The window kernels' arguments (forward and backward): packed qkv [B_, N, 3C]
// in lane order (3, head, D) read in place, out [B_, N, C], a dense bias
// [heads, N, N] and mask [nw, N, N] or null; q_s = q * D^-0.5.
inline AttnArgs window_attn_args(const void* qkv, const void* bias, const void* mask, void* out,
                                 float* lse, int N, int C, int heads, int nw, int dtype) {
  const int D = C / heads;
  const size_t es = dtype == kBFloat16 ? 2 : 4;
  AttnArgs a{};
  a.q = qkv;
  a.k = static_cast<const char*>(qkv) + C * es;
  a.v = static_cast<const char*>(qkv) + 2 * C * es;
  a.bias = bias;
  a.mask = mask;
  a.nw = nw;
  a.out = out;
  a.lse = lse;
  const int64_t n = N;
  a.qs = {n * 3 * C, D, 3 * C};
  a.ks = a.qs;
  a.vs = a.qs;
  a.os = {n * C, D, C};
  a.heads = heads;
  a.nq = N;
  a.nk = N;
  a.scale = 1.f;
  a.qscale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return a;
}

// The window backward's last pass when dS is summed over the windows in
// groups: dbias = the sum of the groups' fp32 partials [groups, n], in group
// order, in the storage type.
template <typename T>
__global__ void window_dbias_reduce_kernel(const float* part, T* dbias, int groups, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int grp = 0; grp < groups; ++grp) s += part[grp * n + i];
    dbias[i] = from_f<T>(s);
  }
}

template <typename T>
cudaError_t launch_window_dbias_reduce(const float* part, void* dbias, int groups, int64_t n,
                                       cudaStream_t stream) {
  const int64_t blocks = (n + 255) / 256;
  window_dbias_reduce_kernel<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                                  stream>>>(part, static_cast<T*>(dbias), groups, n);
  return cudaGetLastError();
}

// The bf16 window backward (window_attention_bwd.cu): f from window_attn_args
// (out = the forward's O, lse its row log-sum-exp), dout [B_, N, C], dqkv
// [B_, N, 3C], dbias [heads, N, N]; delta [B_ * heads, N] and, with groups >
// 1, dbias_part [groups, heads, N, N] fp32 scratch.
cudaError_t window_attention_bwd_sm90(const AttnArgs& f, const void* dout, void* dqkv,
                                      void* dbias, float* delta, float* dbias_part, int groups,
                                      int windows, int C, cudaStream_t stream);

// The bf16 K1 backward (attention_rel_bwd_sm90.cu; passes dq + delta + drel,
// then dk + dv). f as mspi_attention_rel_bwd builds it (out = the forward's O,
// lse its row log-sum-exp); the gradients through f's strides (dq and dout
// f.qs, dk f.ks, dv f.vs, drel f.rs); delta [B*H, Nq] fp32 and rel_pad [B*H,
// Nq, 16 * max(2, ceil(R / 16))] bf16 scratch; with segments > 1 the dk / dv pass
// writes fp32 partials [segments, B*H, Nk, D] (unscaled) instead of dk and
// dv, for attn_bwd_reduce_kernel. Head dim 96; RS = 2..4 register-resident
// forms up to R = 64, the wide form (RS at run time) above.
struct RelBwdArgs {
  AttnArgs f;
  const void* dout;
  void *dq, *dk, *dv, *drel;
  float* delta;
  void* rel_pad;
  float *dk_part, *dv_part;
  int segments, qtiles_per_seg;
};
cudaError_t attention_rel_bwd_sm90(const RelBwdArgs& w, int batch, int d, cudaStream_t stream);
// The bf16 K4 backward (self_attention_bwd_sm90.cu; the same two passes
// without the rel chain, then its own reduce of the segments) on the same
// arguments: rel, drel and rel_pad unused, Nq = Nk; head dim 64, 96 or 128.
cudaError_t self_attention_bwd_sm90(const RelBwdArgs& w, int batch, int d, cudaStream_t stream);
// The bf16 backward of row 6's augmented lanes (attention_aug_bwd_sm90.cu):
// head-major q, dq [bh, nq, da]; k, dk [bh, nk, da]; v, dv [bh, nk, 96];
// dout [bh, nq, 96]; lse and delta [bh, nq] fp32; dk_part and dv_part
// [segments, bh, nk, DK | 96] fp32 (segments > 1); pad [bh, nq + nk, DK]
// bf16 scratch, DK = aug_width(da) (past 256: the wide form, DK a multiple
// of 64 at run time).
cudaError_t attention_aug_bwd_sm90(const void* q, const void* k, const void* v,
                                   const float* lse, const void* dout, void* dq, void* dk,
                                   void* dv, float* delta, float* dk_part, float* dv_part,
                                   void* pad, int segments, int bh, int nq, int nk, int da,
                                   cudaStream_t stream);

}  // namespace mspi
