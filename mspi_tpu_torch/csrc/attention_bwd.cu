// Attention backward for the flash forwards of flash_attention.cuh:
//   rel    (K1 attention_rel): S = scale * q k^T + rel E^T
//   self   (K4 self_attention): S = q k^T / sqrt(D), packed heads
//   aug    (attention, augmented lanes): S = q_aug k_aug^T, head-major, score
//          width Da != value width Dv, no scale
//   window (window_attention): S = q_s k^T + bias[h] (+ mask[b mod nW]), with
//          q_s = q * scale rounded to the storage type, packed qkv
// with P = softmax(S), O = P v, and dO given:
//   dv = P^T dO,  dP = dO v^T,  dS = P * (dP - rowsum(dO * O)),
//   dq = scale * dS k,  dk = scale * dS^T q (window: dS^T q_s),
//   drel = dS E   (rel only),  dbias = sum over windows of dS  (window only).
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::_bwd_impl_rel (kernel
// _bwd_kernel_rel, the backward of fused_attention_rel, 16 MViTv2-S blocks)
// and ::_bwd_impl (kernel _bwd_kernel, which fused_self_attention's backward
// runs on head-major copies; 3 SyncBlock blocks, and the backward of
// ::fused_attention on MViT's augmented lanes, 16 blocks with
// MSPI_ATTN_RELK=0). E takes no gradient.
// Also mspi_tpu/ops/pallas/attention.py::_packed_bwd_impl (kernel
// _packed_bwd_kernel, VideoSwin stages 1-2) and ::_bwd_impl_perhead (kernel
// _perhead_bwd_kernel, stages 3-4): the same function, which the TPU splits
// only because a resident fp32 [H, N, N] dbias does not fit in VMEM at 12
// and 24 heads; one entry serves every stage here, in fp32 through the
// passes below and in bf16 through window_attention_bwd.cu's
// register-resident passes. The mask takes no gradient.
//
// The TPU kernel recomputes a whole [TQ, Nk] probability tile per q-tile and
// carries dk/dv across its sequential grid in VMEM. Blocks on the card run in
// no order, so this is FlashAttention-2's split, without atomics:
//   1. delta: D_i = rowsum(dO_i * O_i) per query row (one warp per row);
//   2. dq pass: one block per 64-query tile walks the keys in tiles of 64,
//      rebuilds P = exp(S - lse) from the forward's row log-sum-exp and
//      accumulates dq; drel's columns (fp32: sums of dS over the keys that
//      share a t, h or w index, rebuilt from the key's row-major index as
//      the forward rebuilds the bias) accumulate in shared memory;
//   3. dkv pass: one block per 64-key tile and segment of query tiles walks
//      the queries and accumulates dk and dv; each segment writes fp32
//      partials (segments keep the card busy when Nk is small next to Nq);
//   4. reduce: sums the segments in a fixed order, scales dk, and writes dk
//      and dv in the storage type through their strides.
// The fp32 window backward sums dS over all B_ windows for dbias. The TPU
// carries a resident fp32 accumulator across its sequential grid; here,
// without atomics and in a fixed order:
//   2'. dq/dbias pass: one block per (64-query tile, head, group of windows)
//       walks its group's windows in order, writes each window's dq, and
//       keeps its [64 x N] fp32 dbias rows in shared memory (N <= 448), each
//       element owned by one thread; it writes them once, as a partial;
//   3'. the dkv pass above with one segment (windows x heads fill the card);
//   5.  a last pass sums the groups' partials in order into dbias.
// q, k, v, dO and the outputs are read and written in place through (batch,
// head, token) strides, so K4's packed [B, N, C] / [B, N, 2C] lanes and the
// windows' packed [B_, N, 3C] qkv need no head transposes.
// Every pass is templated on DK (q, k, dq, dk: the score width) and DV (v,
// dO, dv). The augmented lanes' rows of Da elements are loaded one element
// at a time and zero-filled to DK = Da rounded up to 16 in shared memory;
// only the first Da columns of dq and dk are written, and dk's partials are
// kept at width Da.
//   bf16 (self, aug): every product on the tensor cores (WMMA 16x16x16,
//         fp32 accumulate); P and dS rounded to bf16 where they enter a
//         product, as the TPU kernel rounds them to v's dtype. The bf16 rel
//         backward (K1) runs attention_rel_bwd_sm90.cu's register-resident
//         passes instead, and this file's reduce when it has segments.
//   fp32 (every mode, window included): the FMA pipes (tensor cores would
//         round to TF32).
// What bounds it on the card: 8*D flops per (query, key) pair in the two
// passes plus 2*D to recompute S -- the arithmetic; q, k, v, dO are read
// once per tile of the other side.

#include "flash_attention.cuh"

namespace mspi {
namespace {

constexpr int BM = 64;       // rows of every tile (queries or keys)
constexpr int THREADS = 256;
constexpr int LDS = BM + 4;  // fp32 pitch of the score-shaped tiles

struct BwdArgs {
  AttnArgs f;  // q, k, v, rel, out (= O), lse, strides, geometry, scale
  const void* dout;
  AttnStrides dos;
  void* dq;
  AttnStrides dqs;
  void* drel;      // strides f.rs
  float* delta;    // [B*H, Nq]
  float* dk_part;  // [segments, B*H, Nk, Da]
  float* dv_part;  // [segments, B*H, Nk, Dv]
  int segments, qtiles_per_seg;
  void* dk;
  AttnStrides dks;
  void* dv;
  AttnStrides dvs;
  float dq_scale, dk_scale;  // dq = dq_scale dS k, dk = dk_scale dS^T q
  void* dbias;               // window: [heads, Nq, Nk] in the storage type
  float* dbias_part;         // window: [groups, heads, Nq, Nk] fp32 scratch
  int windows;               // window: B_
};

using bf16 = __nv_bfloat16;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Operand tiles of width D in shared memory: fp32 as they are (pitch D+1),
// bf16 for WMMA (pitch D+8, a multiple of 8 elements; tiles start on 32-byte
// boundaries).
template <typename T, int D>
struct Path;
template <int D>
struct Path<float, D> {
  using Op = float;
  static constexpr int LD = D + 1;
  static constexpr int LDP = LDS;  // P and dS are the fp32 tiles themselves
  static constexpr bool kTc = false;
};
template <int D>
struct Path<bf16, D> {
  using Op = bf16;
  static constexpr int LD = D + 8;
  static constexpr int LDP = BM + 8;
  static constexpr bool kTc = true;
};

struct Layout {
  size_t q, dout, k, v, s, dp, p, ds, stage, rel, drel, kidx, lse, delta, dbias, total;
};

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 31) / 32 * 32;
  return here;
}

// Byte offsets of every shared-memory region (r = rel width, 0 without rel;
// wide = columns of the window dbias rows, 0 outside the dq/dbias pass).
template <typename T, int DK, int DV>
__host__ __device__ inline Layout layout(int r, int wide = 0) {
  using P = Path<T, DK>;
  const size_t op_k = sizeof(typename P::Op) * BM * P::LD;
  const size_t op_v = sizeof(typename P::Op) * BM * Path<T, DV>::LD;
  const size_t score = sizeof(float) * BM * LDS;
  const size_t prob = P::kTc ? sizeof(bf16) * BM * P::LDP : 0;
  Layout L;
  size_t at = 0;
  L.q = take(at, op_k);
  L.dout = take(at, op_v);
  L.k = take(at, op_k);
  L.v = take(at, op_v);
  L.s = take(at, score);
  L.dp = take(at, score);
  L.p = take(at, prob);
  L.ds = take(at, prob);
  L.stage = take(at, P::kTc ? sizeof(float) * 8 * 256 : 0);
  L.rel = take(at, sizeof(float) * BM * r);
  L.drel = take(at, sizeof(float) * BM * r);
  L.kidx = take(at, sizeof(int) * 3 * BM);
  L.lse = take(at, sizeof(float) * BM);
  L.delta = take(at, sizeof(float) * BM);
  L.dbias = take(at, sizeof(float) * BM * wide);
  L.total = at;
  return L;
}

// rows [t0, t0+64) of a token-major operand (row stride `stride`, D features
// contiguous) into dst [64][LD]; zeros past n. scale != 1 (fp32 only: the
// window backward's q_s) multiplies every value.
template <typename T, int D>
__device__ __forceinline__ void load_op(const T* src, int64_t stride, int t0, int n,
                                        typename Path<T, D>::Op* dst, float scale = 1.f) {
  constexpr int LD = Path<T, D>::LD;
  if constexpr (Path<T, D>::kTc) {
    load_rows_bf16<D, THREADS>(src, stride, t0, n, dst, LD);
  } else {
    for (int e = threadIdx.x; e < BM * D; e += THREADS) {
      const int r = e / D, d = e % D;
      dst[r * LD + d] = (t0 + r < n) ? src[(t0 + r) * stride + d] * scale : 0.f;
    }
  }
}

// load_op for q and k: rows of `cols` < D elements (the augmented lanes)
// take the narrow loader, zero-filled to D; full rows (cols == D) load_op.
template <typename T, int D>
__device__ __forceinline__ void load_qk(const T* src, int64_t stride, int t0, int n, int cols,
                                        typename Path<T, D>::Op* dst, float scale = 1.f) {
  if (cols < D)
    load_rows_narrow<D, THREADS>(src, stride, t0, n, cols, dst, Path<T, D>::LD);
  else
    load_op<T, D>(src, stride, t0, n, dst, scale);
}

// The factor load_op applies to q: the fp32 window backward's q_s, else none.
template <typename T, int BIAS>
__device__ __forceinline__ float q_load_scale(const AttnArgs& a) {
  static_assert(!(Path<T, 32>::kTc && BIAS == kDenseBias),
                "the bf16 window backward is window_attention_bwd.cu's");
  return BIAS == kDenseBias ? a.qscale : 1.f;
}

// C[64][LDS] = A[64][D] B[64][D]^T (rows of A against rows of B).
template <typename T, int D>
__device__ __forceinline__ void scores(const typename Path<T, D>::Op* A,
                                       const typename Path<T, D>::Op* B, float* C) {
  constexpr int LD = Path<T, D>::LD;
  if constexpr (Path<T, D>::kTc) {
    const int warp = threadIdx.x >> 5, rt = warp >> 1;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ct = (warp & 1) * 2 + c;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < D; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + rt * 16 * LD + d, LD);
        wmma::load_matrix_sync(b, B + ct * 16 * LD + d, LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + rt * 16 * LDS + ct * 16, acc, LDS, wmma::mem_row_major);
    }
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = A[(ty * 4 + i) * LD + d];
        bv[i] = B[(tx * 4 + i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(ty * 4 + i) * LDS + tx * 4 + j] = s[i][j];
  }
}

// A [64, D] fp32 accumulator held in registers across the loop of a pass:
// acc += op(A) B with op(A) = A [64][64] or, with TRANS, A^T; B [64][D].
template <typename T, int D>
struct Acc;

template <int D>
struct Acc<float, D> {
  static constexpr int LD = Path<float, D>::LD;
  float v[4][D / 16];  // rows ty*4+i, columns tx+16*dd

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) v[i][dd] = 0.f;
  }
  template <bool TRANS>
  __device__ __forceinline__ void add(const float* A, int lda, const float* B) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
    for (int j = 0; j < BM; ++j) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = TRANS ? A[j * lda + ty * 4 + i] : A[(ty * 4 + i) * lda + j];
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const float b = B[j * LD + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i][dd] = fmaf(a[i], b, v[i][dd]);
      }
    }
  }
  template <typename F>
  __device__ __forceinline__ void emit(float*, F&& f) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) f(ty * 4 + i, tx + 16 * dd, v[i][dd]);
  }
};

template <int D>
struct Acc<bf16, D> {
  static constexpr int LD = Path<bf16, D>::LD;
  static constexpr int NT = 4 * (D / 16);  // 16x16 tiles of the [64, D] sum
  static constexpr int NF = (NT + 7) / 8;  // tiles per warp: warp + 8*n
  FragC f[NF];

  // tile warp + 8*n exists (D = 144: 36 tiles, the fifth only in warps 0-3)
  __device__ __forceinline__ static bool owns(int t) { return NT % 8 == 0 || t < NT; }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < NF; ++n) wmma::fill_fragment(f[n], 0.f);
  }
  template <bool TRANS>
  __device__ __forceinline__ void add(const bf16* A, int lda, const bf16* B) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int t = warp + 8 * n, rt = t / (D / 16), ct = t % (D / 16);
      if (!owns(t)) continue;
#pragma unroll
      for (int j = 0; j < BM; j += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + j * LD + ct * 16, LD);
        if constexpr (TRANS) {
          // element (m, k) of the col-major fragment is A[j+k][rt*16+m]
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, A + j * lda + rt * 16, lda);
          wmma::mma_sync(f[n], a, b, f[n]);
        } else {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + rt * 16 * lda + j, lda);
          wmma::mma_sync(f[n], a, b, f[n]);
        }
      }
    }
  }
  // through the warp's 16x16 fp32 staging tile
  template <typename F>
  __device__ __forceinline__ void emit(float* stage, F&& fn) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* sc = stage + warp * 256;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int t = warp + 8 * n, rt = t / (D / 16), ct = t % (D / 16);
      if (!owns(t)) continue;
      wmma::store_matrix_sync(sc, f[n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) fn(rt * 16 + e / 16, ct * 16 + e % 16, sc[e]);
      __syncwarp();
    }
  }
};

// The rel columns t | h | w of keys k0 .. k0+63 (-1 past Nk).
__device__ __forceinline__ void key_columns(const AttnArgs& a, int k0, int* kidx) {
  for (int c = threadIdx.x; c < BM; c += THREADS) {
    const int kj = k0 + c;
    const bool ok = kj < a.nk;
    kidx[c] = ok ? kj / (a.kh * a.kw) : -1;
    kidx[BM + c] = ok ? a.kt + (kj / a.kw) % a.kh : -1;
    kidx[2 * BM + c] = ok ? a.kt + a.kh + kj % a.kw : -1;
  }
}

// drel[i, c] += the sum of dS[i, j] over the tile's keys j whose t, h or w
// index is column c, walked as index ranges of the row-major key grid: a t
// column owns one contiguous run of kh*kw keys, an h column runs of kw keys
// every kh*kw, a w column every kw-th key. Each (row, column) belongs to one
// thread, so the sum order is fixed.
__device__ __forceinline__ void accumulate_drel(const AttnArgs& a, int k0, const float* ds,
                                                float* drel) {
  const int k1 = min(a.nk, k0 + BM);
  const int khw = a.kh * a.kw;
  for (int e = threadIdx.x; e < BM * a.r; e += THREADS) {
    const int r = e / a.r, c = e % a.r;
    const float* row = ds + r * LDS - k0;  // row[j] for global key j
    float s = 0.f;
    if (c < a.kt) {
      for (int j = max(k0, c * khw); j < min(k1, (c + 1) * khw); ++j) s += row[j];
    } else if (c < a.kt + a.kh) {
      const int off = (c - a.kt) * a.kw;
      for (int base = (k0 / khw) * khw; base < k1; base += khw)
        for (int j = max(k0, base + off); j < min(k1, base + off + a.kw); ++j) s += row[j];
    } else {
      const int wc = c - a.kt - a.kh;
      for (int j = k0 + ((wc - k0 % a.kw) % a.kw + a.kw) % a.kw; j < k1; j += a.kw) s += row[j];
    }
    drel[e] += s;
  }
}

// lse and delta of query rows q0 .. q0+63 (0 past Nq).
__device__ __forceinline__ void load_row_stats(const BwdArgs& g, int bh, int q0, float* lse_s,
                                               float* delta_s) {
  const int nq = g.f.nq;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int qi = q0 + r;
    const int64_t at = static_cast<int64_t>(bh) * nq + qi;
    lse_s[r] = qi < nq ? g.f.lse[at] : 0.f;
    delta_s[r] = qi < nq ? g.delta[at] : 0.f;
  }
}

// ss (scores) -> P = exp(scale*s + bias - lse) and dps (dO v^T) -> dS, in
// place in fp32; the bf16 path also writes the rounded operand copies. With
// dbias (the window dq/dbias pass), dS also accumulates into dbias[r][k0+c]
// of the block's [64][ldb] rows; element (r, c) always belongs to thread
// (64 r + c) % THREADS, so the sum over windows has one fixed order.
template <typename T, int D, int BIAS>
__device__ __forceinline__ void probs_and_ds(const AttnArgs& a, int b, int h, int q0, int k0,
                                             const float* rels, const int* kidx,
                                             const float* lse_s, const float* delta_s,
                                             float* ss, float* dps,
                                             typename Path<T, D>::Op* pb,
                                             typename Path<T, D>::Op* dsb,
                                             float* dbias = nullptr, int ldb = 0) {
  constexpr int LDP = Path<T, D>::LDP;
  for (int e = threadIdx.x; e < BM * BM; e += THREADS) {
    const int r = e >> 6, c = e & 63;
    float p = 0.f, ds = 0.f;
    if (q0 + r < a.nq && k0 + c < a.nk) {
      float s = ss[r * LDS + c] * a.scale;
      if (BIAS == kRelBias) {
        const float* rr = rels + r * a.r;
        s += rr[kidx[c]] + rr[kidx[BM + c]] + rr[kidx[2 * BM + c]];
      }
      if (BIAS == kDenseBias) s = add_dense_bias<T>(a, b, h, q0 + r, k0 + c, s);
      p = expf(s - lse_s[r]);
      ds = p * (dps[r * LDS + c] - delta_s[r]);
      if (dbias != nullptr) dbias[r * ldb + k0 + c] += ds;
    }
    ss[r * LDS + c] = p;
    dps[r * LDS + c] = ds;
    if constexpr (Path<T, D>::kTc) {
      pb[r * LDP + c] = __float2bfloat16(p);
      dsb[r * LDP + c] = __float2bfloat16(ds);
    }
  }
}

template <typename T, int DK, int DV>
struct Tiles {
  using Op = typename Path<T, DK>::Op;
  Op *q, *dout, *k, *v, *p, *ds;
  float *s, *dp, *stage, *rel, *drel, *lse, *delta, *dbias;
  int* kidx;

  __device__ Tiles(unsigned char* base, int r, int wide = 0) {
    const Layout L = layout<T, DK, DV>(r, wide);
    q = reinterpret_cast<Op*>(base + L.q);
    dout = reinterpret_cast<Op*>(base + L.dout);
    k = reinterpret_cast<Op*>(base + L.k);
    v = reinterpret_cast<Op*>(base + L.v);
    s = reinterpret_cast<float*>(base + L.s);
    dp = reinterpret_cast<float*>(base + L.dp);
    if constexpr (Path<T, DK>::kTc) {
      p = reinterpret_cast<Op*>(base + L.p);
      ds = reinterpret_cast<Op*>(base + L.ds);
    } else {  // fp32: P and dS are used in place
      p = reinterpret_cast<Op*>(s);
      ds = reinterpret_cast<Op*>(dp);
    }
    stage = reinterpret_cast<float*>(base + L.stage);
    rel = reinterpret_cast<float*>(base + L.rel);
    drel = reinterpret_cast<float*>(base + L.drel);
    kidx = reinterpret_cast<int*>(base + L.kidx);
    lse = reinterpret_cast<float*>(base + L.lse);
    delta = reinterpret_cast<float*>(base + L.delta);
    dbias = reinterpret_cast<float*>(base + L.dbias);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) attn_bwd_delta_kernel(BwdArgs g, int D) {
  const AttnArgs& a = g.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * 8 + warp, bh = blockIdx.y;
  if (row >= a.nq) return;
  const int b = bh / a.heads, h = bh % a.heads;
  const T* o = static_cast<const T*>(a.out) + b * a.os.b + h * a.os.h + row * a.os.n;
  const T* d = static_cast<const T*>(g.dout) + b * g.dos.b + h * g.dos.h + row * g.dos.n;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(o[c]) * to_f(d[c]);
  s = warp_sum(s);
  if (lane == 0) g.delta[static_cast<int64_t>(bh) * a.nq + row] = s;
}

// Columns of q and k (and of dq and dk) that the tensors hold: Da for the
// augmented lanes (DK != DV), else all DK.
template <int DK, int DV>
__device__ __forceinline__ int qk_cols(const AttnArgs& a) {
  return DK != DV ? a.dk : DK;
}

template <typename T, int DK, int DV, int BIAS>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(BwdArgs g) {
  constexpr int LDP = Path<T, DK>::LDP;
  constexpr bool REL = BIAS == kRelBias;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  const AttnArgs& a = g.f;
  const int cols = qk_cols<DK, DV>(a);
  Tiles<T, DK, DV> t(smem_bwd, REL ? a.r : 0);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * BM;
  const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kp = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const T* dop = static_cast<const T*>(g.dout) + b * g.dos.b + h * g.dos.h;

  load_qk<T, DK>(qp, a.qs.n, q0, a.nq, cols, t.q, q_load_scale<T, BIAS>(a));
  load_op<T, DV>(dop, g.dos.n, q0, a.nq, t.dout);
  load_rel_rows<T, BIAS>(a, b, h, q0, t.rel);
  if (REL)
    for (int e = threadIdx.x; e < BM * a.r; e += THREADS) t.drel[e] = 0.f;
  load_row_stats(g, bh, q0, t.lse, t.delta);

  Acc<T, DK> dq;
  dq.zero();
  for (int k0 = 0; k0 < a.nk; k0 += BM) {
    __syncthreads();  // the previous tile's reads are done
    load_qk<T, DK>(kp, a.ks.n, k0, a.nk, cols, t.k);
    load_op<T, DV>(vp, a.vs.n, k0, a.nk, t.v);
    if (REL) key_columns(a, k0, t.kidx);
    __syncthreads();
    scores<T, DK>(t.q, t.k, t.s);
    scores<T, DV>(t.dout, t.v, t.dp);
    __syncthreads();
    probs_and_ds<T, DK, BIAS>(a, b, h, q0, k0, t.rel, t.kidx, t.lse, t.delta, t.s, t.dp, t.p,
                              t.ds);
    __syncthreads();
    dq.template add<false>(t.ds, LDP, t.k);  // dq += dS k
    if (REL) accumulate_drel(a, k0, t.dp, t.drel);
  }

  T* dqp = static_cast<T*>(g.dq) + b * g.dqs.b + h * g.dqs.h;
  const float scale = g.dq_scale;
  const int nq = a.nq;
  const int64_t dq_n = g.dqs.n;
  dq.emit(t.stage, [&](int r, int c, float v) {
    if (q0 + r < nq && c < cols) dqp[(q0 + r) * dq_n + c] = from_f<T>(v * scale);
  });
  if (REL) {
    T* drp = static_cast<T*>(g.drel) + b * a.rs.b + h * a.rs.h;
    for (int e = threadIdx.x; e < BM * a.r; e += THREADS) {
      const int r = e / a.r, c = e % a.r;
      if (q0 + r < nq) drp[(q0 + r) * a.rs.n + c] = from_f<T>(t.drel[e]);
    }
  }
}

template <typename T, int DK, int DV, int BIAS>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(BwdArgs g) {
  constexpr int LDP = Path<T, DK>::LDP;
  constexpr bool REL = BIAS == kRelBias;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  const AttnArgs& a = g.f;
  const int cols = qk_cols<DK, DV>(a);
  Tiles<T, DK, DV> t(smem_bwd, REL ? a.r : 0);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * BM, seg = blockIdx.z;
  const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kp = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const T* dop = static_cast<const T*>(g.dout) + b * g.dos.b + h * g.dos.h;

  load_qk<T, DK>(kp, a.ks.n, k0, a.nk, cols, t.k);
  load_op<T, DV>(vp, a.vs.n, k0, a.nk, t.v);
  if (REL) key_columns(a, k0, t.kidx);

  const int qtiles = (a.nq + BM - 1) / BM;
  const int qt0 = seg * g.qtiles_per_seg;
  const int qt1 = min(qtiles, qt0 + g.qtiles_per_seg);
  Acc<T, DK> dk;
  Acc<T, DV> dv;
  dk.zero();
  dv.zero();
  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();  // the previous tile's reads are done
    load_qk<T, DK>(qp, a.qs.n, q0, a.nq, cols, t.q, q_load_scale<T, BIAS>(a));
    load_op<T, DV>(dop, g.dos.n, q0, a.nq, t.dout);
    load_rel_rows<T, BIAS>(a, b, h, q0, t.rel);
    load_row_stats(g, bh, q0, t.lse, t.delta);
    __syncthreads();
    scores<T, DK>(t.q, t.k, t.s);
    scores<T, DV>(t.dout, t.v, t.dp);
    __syncthreads();
    probs_and_ds<T, DK, BIAS>(a, b, h, q0, k0, t.rel, t.kidx, t.lse, t.delta, t.s, t.dp, t.p,
                              t.ds);
    __syncthreads();
    dv.template add<true>(t.p, LDP, t.dout);  // dv += P^T dO
    dk.template add<true>(t.ds, LDP, t.q);    // dk += dS^T q
  }

  const int64_t bh_count = static_cast<int64_t>(gridDim.y);
  const int64_t row0 = (static_cast<int64_t>(seg) * bh_count + bh) * a.nk + k0;
  float* dkp = g.dk_part + row0 * cols;
  float* dvp = g.dv_part + row0 * DV;
  const int nk = a.nk;
  __syncthreads();  // the staging tiles alias nothing, but keep warps together
  dk.emit(t.stage, [&](int r, int c, float v) {
    if (k0 + r < nk && c < cols) dkp[r * cols + c] = v;
  });
  dv.emit(t.stage, [&](int r, int c, float v) {
    if (k0 + r < nk) dvp[r * DV + c] = v;
  });
}

// dk = dk_scale * sum over segments (width dkw), dv = sum over segments
// (width dvw), in a fixed order; one pass over both.
template <typename T>
__global__ void attn_bwd_reduce_kernel(BwdArgs g, int dkw, int dvw, int bh_count) {
  const AttnArgs& a = g.f;
  const int64_t rows = static_cast<int64_t>(bh_count) * a.nk;
  const int64_t nk_el = rows * dkw, n = nk_el + rows * dvw;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool is_k = i < nk_el;
    const int64_t e = is_k ? i : i - nk_el;
    const int w = is_k ? dkw : dvw;
    const int64_t per = is_k ? nk_el : rows * dvw;
    const float* part = is_k ? g.dk_part : g.dv_part;
    const int d = static_cast<int>(e % w);
    const int j = static_cast<int>((e / w) % a.nk);
    const int bh = static_cast<int>(e / (static_cast<int64_t>(w) * a.nk));
    const int b = bh / a.heads, h = bh % a.heads;
    float sum = 0.f;
    for (int s = 0; s < g.segments; ++s) sum += part[s * per + e];
    if (is_k)
      static_cast<T*>(g.dk)[b * g.dks.b + h * g.dks.h + j * g.dks.n + d] =
          from_f<T>(sum * g.dk_scale);
    else
      static_cast<T*>(g.dv)[b * g.dvs.b + h * g.dvs.h + j * g.dvs.n + d] = from_f<T>(sum);
  }
}

template <typename T>
cudaError_t launch_reduce(const BwdArgs& g, int dkw, int dvw, int bh, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(bh) * g.f.nk * (dkw + dvw);
  const int64_t blocks = (n + 255) / 256;
  attn_bwd_reduce_kernel<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                              stream>>>(g, dkw, dvw, bh);
  return cudaGetLastError();
}

template <typename T, int DK, int DV, int BIAS>
cudaError_t launch_bwd(BwdArgs g, int batch, cudaStream_t stream) {
  constexpr bool REL = BIAS == kRelBias;
  const AttnArgs& a = g.f;
  const int bh = batch * a.heads;
  const int qtiles = (a.nq + BM - 1) / BM, ktiles = (a.nk + BM - 1) / BM;
  g.qtiles_per_seg = (qtiles + g.segments - 1) / g.segments;
  attn_bwd_delta_kernel<T><<<dim3((a.nq + 7) / 8, bh), THREADS, 0, stream>>>(g, DV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = layout<T, DK, DV>(REL ? a.r : 0).total;
  if ((err = allow_smem(attn_bwd_dq_kernel<T, DK, DV, BIAS>, smem)) != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, DK, DV, BIAS><<<dim3(qtiles, bh), THREADS, smem, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_dkv_kernel<T, DK, DV, BIAS>, smem)) != cudaSuccess) return err;
  attn_bwd_dkv_kernel<T, DK, DV, BIAS><<<dim3(ktiles, bh, g.segments), THREADS, smem,
                                         stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce<T>(g, DK != DV ? a.dk : DK, DV, bh, stream);
}

template <int BIAS>
cudaError_t dispatch_bwd(const BwdArgs& g, int batch, int d, int dtype, cudaStream_t s) {
  if (g.segments <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    switch (d) {
      case 96: return launch_bwd<float, 96, 96, BIAS>(g, batch, s);
      case 128: return launch_bwd<float, 128, 128, BIAS>(g, batch, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if constexpr (BIAS != kRelBias) {  // bf16 rel: attention_rel_bwd_sm90.cu
    if (dtype == kBFloat16) {
      switch (d) {
        case 96: return launch_bwd<bf16, 96, 96, BIAS>(g, batch, s);
        case 128: return launch_bwd<bf16, 128, 128, BIAS>(g, batch, s);
        default: return cudaErrorInvalidValue;
      }
    }
  }
  return cudaErrorInvalidValue;
}

// The augmented lanes: q/k rows of g.f.dk lanes (zero-filled to DK = 128 or
// 144), v and dO of dv = 96 lanes, no bias.
template <typename T>
cudaError_t dispatch_bwd_aug(const BwdArgs& g, int batch, int dv, cudaStream_t s) {
  if (g.segments <= 0 || dv != 96 || g.f.dk <= 112 || g.f.dk > 144) return cudaErrorInvalidValue;
  if (g.f.dk <= 128) return launch_bwd<T, 128, 96, kNoBias>(g, batch, s);
  return launch_bwd<T, 144, 96, kNoBias>(g, batch, s);
}

// ---- window attention: fp32 dq/dbias pass ------------------------------------

// Columns of a block's dbias rows: Nk rounded up to whole key tiles.
__host__ __device__ inline int dbias_cols(int nk) { return (nk + BM - 1) / BM * BM; }

// One block per (64-query tile, head, group of windows): walks its windows in
// order, writes each window's dq, and sums dS over them into [64][ldb] fp32
// rows in shared memory, written once to the group's partial.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) window_bwd_dq_kernel(BwdArgs g) {
  constexpr int LDP = Path<T, D>::LDP;
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  const AttnArgs& a = g.f;
  const int ldb = dbias_cols(a.nk);
  Tiles<T, D, D> t(smem_bwd, 0, ldb);
  const int q0 = blockIdx.x * BM, h = blockIdx.y, grp = blockIdx.z;
  const int per = (g.windows + gridDim.z - 1) / gridDim.z;
  const int w0 = grp * per, w1 = min(g.windows, w0 + per);
  const float qscale = q_load_scale<T, kDenseBias>(a);
  const int nq = a.nq;
  const float dq_scale = g.dq_scale;
  for (int e = threadIdx.x; e < BM * ldb; e += THREADS) t.dbias[e] = 0.f;

  for (int b = w0; b < w1; ++b) {
    const int bh = b * a.heads + h;
    const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* kp = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
    const T* vp = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
    const T* dop = static_cast<const T*>(g.dout) + b * g.dos.b + h * g.dos.h;
    __syncthreads();  // the previous window's reads are done
    load_op<T, D>(qp, a.qs.n, q0, nq, t.q, qscale);
    load_op<T, D>(dop, g.dos.n, q0, nq, t.dout);
    load_row_stats(g, bh, q0, t.lse, t.delta);
    Acc<T, D> dq;
    dq.zero();
    for (int k0 = 0; k0 < a.nk; k0 += BM) {
      __syncthreads();
      load_op<T, D>(kp, a.ks.n, k0, a.nk, t.k);
      load_op<T, D>(vp, a.vs.n, k0, a.nk, t.v);
      __syncthreads();
      scores<T, D>(t.q, t.k, t.s);
      scores<T, D>(t.dout, t.v, t.dp);
      __syncthreads();
      probs_and_ds<T, D, kDenseBias>(a, b, h, q0, k0, nullptr, nullptr, t.lse, t.delta, t.s,
                                     t.dp, t.p, t.ds, t.dbias, ldb);
      __syncthreads();
      dq.template add<false>(t.ds, LDP, t.k);  // dq += dS k
    }
    T* dqp = static_cast<T*>(g.dq) + b * g.dqs.b + h * g.dqs.h;
    const int64_t dq_n = g.dqs.n;
    dq.emit(t.stage, [&](int r, int c, float v) {
      if (q0 + r < nq) dqp[(q0 + r) * dq_n + c] = from_f<T>(v * dq_scale);
    });
  }

  __syncthreads();
  const int nk = a.nk;
  float* part = g.dbias_part + (static_cast<int64_t>(grp) * a.heads + h) * nq * nk;
  for (int e = threadIdx.x; e < BM * nk; e += THREADS) {
    const int r = e / nk, c = e % nk;
    if (q0 + r < nq) part[static_cast<int64_t>(q0 + r) * nk + c] = t.dbias[r * ldb + c];
  }
}

template <typename T, int D>
cudaError_t launch_window_bwd(BwdArgs g, int groups, cudaStream_t stream) {
  const AttnArgs& a = g.f;
  const int bh = g.windows * a.heads;
  const int qtiles = (a.nq + BM - 1) / BM, ktiles = (a.nk + BM - 1) / BM;
  g.segments = 1;
  g.qtiles_per_seg = qtiles;
  attn_bwd_delta_kernel<T><<<dim3((a.nq + 7) / 8, bh), THREADS, 0, stream>>>(g, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_dq = layout<T, D, D>(0, dbias_cols(a.nk)).total;
  if ((err = allow_smem(window_bwd_dq_kernel<T, D>, smem_dq)) != cudaSuccess) return err;
  window_bwd_dq_kernel<T, D><<<dim3(qtiles, a.heads, groups), THREADS, smem_dq, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = layout<T, D, D>(0).total;
  if ((err = allow_smem(attn_bwd_dkv_kernel<T, D, D, kDenseBias>, smem)) != cudaSuccess)
    return err;
  attn_bwd_dkv_kernel<T, D, D, kDenseBias><<<dim3(ktiles, bh, 1), THREADS, smem, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_reduce<T>(g, D, D, bh, stream)) != cudaSuccess) return err;
  return launch_window_dbias_reduce<T>(g.dbias_part, g.dbias, groups,
                                       static_cast<int64_t>(a.heads) * a.nq * a.nk, stream);
}

}  // namespace
}  // namespace mspi

// K1 backward. q, dq [B,H,Nq,D]; k, v, dk, dv [B,H,Nk,D]; rel, drel
// [B,H,Nq,R]; out (the forward's O) and dout [B,H,Nq,D]; lse (from the
// forward) and delta (scratch) [B*H, Nq] fp32; dk_part, dv_part
// [segments, B*H, Nk, D] fp32 scratch; rel_pad (bf16 only: D = 96)
// [B*H, Nq, 16 * max(2, ceil(R / 16))] bf16 scratch. Returns a cudaError_t
// code.
extern "C" int mspi_attention_rel_bwd(const void* q, const void* k, const void* v,
                                      const void* rel, const void* out, float* lse,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      void* drel, float* delta, float* dk_part,
                                      float* dv_part, void* rel_pad, int segments, int B,
                                      int H, int Nq, int Nk, int D, int R, int kt, int kh,
                                      int kw, float scale, int dtype, void* stream) {
  if (R != kt + kh + kw || kt * kh * kw != Nk) return cudaErrorInvalidValue;
  mspi::BwdArgs g{};
  mspi::AttnArgs& a = g.f;
  a.q = q;
  a.k = k;
  a.v = v;
  a.rel = rel;
  a.out = const_cast<void*>(out);
  a.lse = lse;
  const int64_t hq = static_cast<int64_t>(Nq) * D, hk = static_cast<int64_t>(Nk) * D;
  const int64_t hr = static_cast<int64_t>(Nq) * R;
  a.qs = {H * hq, hq, D};
  a.ks = {H * hk, hk, D};
  a.vs = {H * hk, hk, D};
  a.os = {H * hq, hq, D};
  a.rs = {H * hr, hr, R};
  a.heads = H;
  a.nq = Nq;
  a.nk = Nk;
  a.r = R;
  a.kt = kt;
  a.kh = kh;
  a.kw = kw;
  a.scale = scale;
  g.dout = dout;
  g.dos = a.qs;
  g.dq = dq;
  g.dqs = a.qs;
  g.drel = drel;
  g.delta = delta;
  g.dk_part = dk_part;
  g.dv_part = dv_part;
  g.segments = segments;
  g.dk = dk;
  g.dks = a.ks;
  g.dv = dv;
  g.dvs = a.vs;
  g.dq_scale = scale;
  g.dk_scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kBFloat16) {
    mspi::RelBwdArgs w{};
    w.f = a;
    w.dout = dout;
    w.dq = dq;
    w.dk = dk;
    w.dv = dv;
    w.drel = drel;
    w.delta = delta;
    w.rel_pad = rel_pad;
    w.dk_part = dk_part;
    w.dv_part = dv_part;
    w.segments = segments;
    cudaError_t err = mspi::attention_rel_bwd_sm90(w, B, D, s);
    if (err != cudaSuccess || segments == 1) return err;
    return mspi::launch_reduce<__nv_bfloat16>(g, D, D, B * H, s);
  }
  return mspi::dispatch_bwd<mspi::kRelBias>(g, B, D, dtype, s);
}

// K4 backward on packed lanes. q, out, dout, dq [B,N,C]; kv, dkv [B,N,2C]
// (k then v, head-major lanes); lse and delta [B*heads, N] fp32; dk_part,
// dv_part [segments, B*heads, N, C/heads] fp32 scratch.
extern "C" int mspi_self_attention_bwd(const void* q, const void* kv, const void* out,
                                       float* lse, const void* dout, void* dq, void* dkv,
                                       float* delta, float* dk_part, float* dv_part,
                                       int segments, int B, int N, int C, int heads,
                                       int dtype, void* stream) {
  if (heads <= 0 || C % heads != 0) return cudaErrorInvalidValue;
  const int D = C / heads;
  const size_t es = dtype == mspi::kBFloat16 ? 2 : 4;
  mspi::BwdArgs g{};
  mspi::AttnArgs& a = g.f;
  a.q = q;
  a.k = kv;
  a.v = static_cast<const char*>(kv) + C * es;
  a.rel = nullptr;
  a.out = const_cast<void*>(out);
  a.lse = lse;
  const int64_t n = N;
  a.qs = {n * C, D, C};
  a.ks = {n * 2 * C, D, 2 * C};
  a.vs = {n * 2 * C, D, 2 * C};
  a.os = {n * C, D, C};
  a.rs = {0, 0, 0};
  a.heads = heads;
  a.nq = N;
  a.nk = N;
  a.scale = 1.f / sqrtf(static_cast<float>(D));
  g.dout = dout;
  g.dos = a.qs;
  g.dq = dq;
  g.dqs = a.qs;
  g.drel = nullptr;
  g.delta = delta;
  g.dk_part = dk_part;
  g.dv_part = dv_part;
  g.segments = segments;
  g.dk = dkv;
  g.dks = a.ks;
  g.dv = static_cast<char*>(dkv) + C * es;
  g.dvs = a.vs;
  g.dq_scale = a.scale;
  g.dk_scale = a.scale;
  return mspi::dispatch_bwd<mspi::kNoBias>(g, B, D, dtype, static_cast<cudaStream_t>(stream));
}

// Window attention backward on packed qkv. qkv, dqkv [B_, N, 3C] (lane order
// 3, head, D); bias, dbias [heads, N, N]; mask [nw, N, N] or null; out (the
// forward's O) and dout [B_, N, C]; lse (from the forward) and delta
// (scratch) [B_*heads, N] fp32; dbias_part [groups, heads, N, N] fp32
// scratch (bf16: only with groups > 1). fp32 (N <= 448): dk_part, dv_part
// [B_*heads, N, D] fp32 scratch. bf16 (window_attention_bwd.cu; N % 8 == 0):
// dk_part and dv_part unused.
extern "C" int mspi_window_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                         const void* out, float* lse, const void* dout,
                                         void* dqkv, void* dbias, float* delta,
                                         float* dk_part, float* dv_part, float* dbias_part,
                                         int groups, int B, int N, int C, int heads, int nw,
                                         int dtype, void* stream) {
  if (heads <= 0 || C % heads != 0 || groups <= 0) return cudaErrorInvalidValue;
  if (mask != nullptr && (nw <= 0 || B % nw != 0)) return cudaErrorInvalidValue;
  const int D = C / heads;
  if (D != 32) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kBFloat16)
    return mspi::window_attention_bwd_sm90(
        mspi::window_attn_args(qkv, bias, mask, const_cast<void*>(out), lse, N, C, heads, nw,
                               dtype),
        dout, dqkv, dbias, delta, dbias_part, groups, B, C, s);
  if (dtype != mspi::kFloat32 || N > 7 * mspi::BM) return cudaErrorInvalidValue;
  const size_t es = 4;
  mspi::BwdArgs g{};
  g.f = mspi::window_attn_args(qkv, bias, mask, const_cast<void*>(out), lse, N, C, heads,
                               nw, dtype);
  const mspi::AttnArgs& a = g.f;
  g.dout = dout;
  g.dos = a.os;
  g.dq = dqkv;
  g.dqs = a.qs;
  g.delta = delta;
  g.dk_part = dk_part;
  g.dv_part = dv_part;
  g.dk = static_cast<char*>(dqkv) + C * es;
  g.dks = a.qs;
  g.dv = static_cast<char*>(dqkv) + 2 * C * es;
  g.dvs = a.qs;
  g.dq_scale = a.qscale;
  g.dk_scale = 1.f;  // q_s already carries the scale
  g.dbias = dbias;
  g.dbias_part = dbias_part;
  g.windows = B;
  return mspi::launch_window_bwd<float, 32>(g, groups, s);
}

// Backward of the augmented-lane attention (head-major, scale 1): q, dq
// [B,H,Nq,Da]; k, dk [B,H,Nk,Da]; v, dv [B,H,Nk,Dv]; out (the forward's O)
// and dout [B,H,Nq,Dv]; lse (from the forward) and delta (scratch) [B*H, Nq]
// fp32; dk_part [segments, B*H, Nk, Da] and dv_part [segments, B*H, Nk, Dv]
// fp32 scratch. Da in (112, 144], Dv = 96. dk includes the k_aug lanes of E,
// which the caller drops.
extern "C" int mspi_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                  float* lse, const void* dout, void* dq, void* dk, void* dv,
                                  float* delta, float* dk_part, float* dv_part, int segments,
                                  int B, int H, int Nq, int Nk, int Da, int Dv, int dtype,
                                  void* stream) {
  mspi::BwdArgs g{};
  mspi::AttnArgs& a = g.f;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = const_cast<void*>(out);
  a.lse = lse;
  const int64_t hq = static_cast<int64_t>(Nq) * Da, hk = static_cast<int64_t>(Nk) * Da;
  const int64_t hv = static_cast<int64_t>(Nk) * Dv, ho = static_cast<int64_t>(Nq) * Dv;
  a.qs = {H * hq, hq, Da};
  a.ks = {H * hk, hk, Da};
  a.vs = {H * hv, hv, Dv};
  a.os = {H * ho, ho, Dv};
  a.heads = H;
  a.nq = Nq;
  a.nk = Nk;
  a.dk = Da;
  a.scale = 1.f;
  g.dout = dout;
  g.dos = a.os;
  g.dq = dq;
  g.dqs = a.qs;
  g.delta = delta;
  g.dk_part = dk_part;
  g.dv_part = dv_part;
  g.segments = segments;
  g.dk = dk;
  g.dks = a.ks;
  g.dv = dv;
  g.dvs = a.vs;
  g.dq_scale = 1.f;
  g.dk_scale = 1.f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mspi::kFloat32) return mspi::dispatch_bwd_aug<float>(g, B, Dv, s);
  if (dtype == mspi::kBFloat16) return mspi::dispatch_bwd_aug<__nv_bfloat16>(g, B, Dv, s);
  return cudaErrorInvalidValue;
}
