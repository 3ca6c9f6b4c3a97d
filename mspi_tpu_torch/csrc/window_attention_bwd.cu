// The bf16 backward of VideoSwin's window attention (window_attention.cu),
// register-resident on the tensor cores and fed by asynchronous copies:
//   S = q_s k^T + bias[h] (+ mask[b mod nW]),  P = softmax(S),  O = P v,
//   dv = P^T dO,  dP = dO v^T,  dS = P * (dP - rowsum(P * dP)),
//   dq = scale * dS k,  dk = dS^T q_s,  dbias = sum over the B_ windows of dS
// per window b and head h, with q_s = q * scale (scale = D^-0.5 rounded to
// bf16) rounded to bf16 as the plain version rounds it; packed qkv and dqkv
// [B_, N, 3C] (lane order 3, head, D), out and dout [B_, N, C], bias and
// dbias [heads, N, N], mask [nW, N, N]. The mask takes no gradient.
//
// Replaces: mspi_tpu/ops/pallas/attention.py::_packed_bwd_impl (kernel
// _packed_bwd_kernel, VideoSwin stages 1-2) and ::_bwd_impl_perhead (kernel
// _perhead_bwd_kernel, stages 3-4), one function that the TPU splits only
// because a resident fp32 [H, N, N] dbias does not fit in VMEM at 12 and 24
// heads. The TPU kernel walks the windows in its sequential grid and carries
// dk, dv and dbias in VMEM; blocks on the card run in no order, so the work
// is split into three passes, none with atomics, each a grid of blocks of 4
// warps with 16 rows per warp (m16n8k16 mma.sync, bf16 in, fp32 accumulate),
// 64-wide tiles through a 2-slot cp.async ring and one barrier per tile, as
// flash_attention_sm90.cuh's forward:
//   1. dq: one block per (64-query tile, window x head). q_s and dO stay in
//      registers as A fragments. The key tiles (K, V and the swizzled bias
//      and mask tiles through the ring) are walked twice. The first sweep
//      sums delta = rowsum(P * dP) in fp32 from S, P = exp(S - lse) and dP in
//      the accumulator fragments, as the TPU kernel takes it, and writes it
//      out for passes 2 and 3 (FlashAttention-2's rowsum(dO * O) taken from
//      the forward's bf16-rounded O moved dq and dk off the TPU kernel's by a
//      large share of their bf16 tolerance; PERF.md). The second forms dS,
//      rounds it to bf16 and repacks it into A fragments (as the forward
//      repacks P) for dq += dS K with K's B fragments from ldmatrix.trans. dq
//      is written once, scaled, in bf16. The first sweep costs the pass S and
//      dP once more.
//   2. dkv: one block per (64-key tile, window x head), each warp owning 16
//      keys whose K and V A fragments stay in registers. Per query tile
//      (q, dO, the bias and mask tiles, and the 64 queries' lse and delta
//      through the ring; q scaled to q_s in shared memory by the threads
//      that copied it) S^T = K q_s^T and dP^T = V dO^T land in the
//      accumulator layout that repacks into A fragments for dv += P^T dO and
//      dk += dS^T q_s; the bias and mask are read transposed from the
//      swizzled tiles. dk and dv are written once in bf16.
//   3. dbias: one block per (64-query tile, 64-key tile, head, group of
//      windows) keeps its 64 x 64 fp32 dbias tile in registers (32 per
//      thread), walks its group's windows in order (q, dO, K, V and the
//      mask tile through the ring; its bias tile from L1), recomputes dS and
//      adds it in fp32, as the TPU kernel and the plain version sum it. With
//      one group it writes dbias in bf16; with several, each group writes an
//      fp32 partial and window_dbias_reduce_kernel sums them in group order.
// Every output element has one writer and a fixed summation order, so two
// runs give bit-identical dqkv and dbias. Ragged tiles (N = 392 = 6 * 64 +
// 8) are zero-filled by the copies; P is 0 past N.
//
// What bounds it on the card: at D = 32 each (query, key) pair costs 10 * D
// flops across the passes against 2-4 bytes of bias and mask read once, so
// the bytes set the bound (PERF.md). The passes are latency-bound: the
// exponentials, the bias and mask reads and the barrier per tile. The dq and
// dbias passes fit the 128-register cap of 4 blocks per SM, the dkv pass the
// 168 of 3 (52, 53 and 56 KB of shared memory with the mask, 36, 37 and 40
// KB without).
// fp32 runs attention_bwd.cu's FMA passes instead.

#include "attention_bwd_sm90.cuh"

namespace mspi {
namespace {

using sm90::at;
using sm90::copy_rows;
using sm90::copy_tile;
using sm90::exp2_ftz;
using sm90::kLog2e;
using sm90::ldsm_x4;
using sm90::ldsm_x4_trans;
using sm90::load_a_frags;
using sm90::mma_bf16;
using sm90::scale_bf16x2;
using sm90::swz;

constexpr int kThreads = sm90::kBwdThreads;  // 4 warps of 16 rows
constexpr int kTile = sm90::kBwdTile;        // rows of every tile (queries or keys)
constexpr int kRing = sm90::kStages;         // ring slots

struct WindowBwdArgs {
  AttnArgs f;          // qkv (q, k, v), bias, mask, out = O, lse, strides, heads, nq = nk = N
  const bf16* dout;    // [B_, N, C], strides f.os
  bf16 *dq, *dk, *dv;  // the lanes of dqkv [B_, N, 3C], strides f.qs
  float* delta;        // [B_ * heads, N]
  void* dbias;         // [heads, N, N] bf16, written by pass 3 with one group
  float* dbias_part;   // [groups, heads, N, N] fp32, with more than one group
  int windows, groups;
};

// Byte sizes of the ring's regions at head dim D.
template <int D>
struct Bytes {
  static constexpr int LD = D + 8;                              // bf16 pitch of operand rows
  static constexpr int kOp = sizeof(bf16) * kTile * LD;         // one [64][D] operand tile
  static constexpr int kBias = sizeof(bf16) * kTile * kTile;    // one swizzled bias or mask tile
  static constexpr int kStats = 2 * sizeof(float) * kTile;      // 64 rows' lse and delta
  static int dq(bool masked) { return kRing * (2 * kOp + (masked ? 2 : 1) * kBias); }
  static int dkv(bool masked) { return kRing * (2 * kOp + (masked ? 2 : 1) * kBias + kStats); }
  static int dbias(bool masked) { return kRing * (4 * kOp + (masked ? 1 : 0) * kBias); }
  static_assert(kOp % 16 == 0 && kBias % 16 == 0, "16-byte regions");
};

// After this thread's copies of a [kTile][D + 8] q tile by copy_rows landed:
// multiply the chunks it copied by s, each product rounded to bf16 (q_s); the
// next barrier publishes them.
template <int D>
__device__ __forceinline__ void scale_own_rows(bf16* tile, float s) {
  constexpr int VEC = D / 8, RSTEP = kThreads / VEC;
  const int r0 = threadIdx.x / VEC, c = (threadIdx.x % VEC) * 8;
  if (r0 >= RSTEP) return;
#pragma unroll
  for (int r = r0; r < kTile; r += RSTEP) {
    uint32_t* p = reinterpret_cast<uint32_t*>(tile + r * (D + 8) + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = scale_bf16x2(p[j], s);
  }
}

// Two bf16 values of a word (x in the low half) added to v[0], v[1].
__device__ __forceinline__ void add_bf16x2(float* v, uint32_t w) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w);
  v[0] += __low2float(x);
  v[1] += __high2float(x);
}

// Pass 1: dq, and delta. Grid (query tiles, windows x heads).
template <int D>
__global__ void __launch_bounds__(kThreads, 4) window_bwd_dq_sm90_kernel(WindowBwdArgs w) {
  using Z = Bytes<D>;
  constexpr int KS = D / 16, ND = D / 8, LD = Z::LD;
  extern __shared__ __align__(128) unsigned char smem_wdq[];
  const AttnArgs& a = w.f;
  const bool masked = a.mask != nullptr;
  const int slot_bytes = 2 * Z::kOp + (masked ? 2 : 1) * Z::kBias;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, h = bh % a.heads, b = bh / a.heads;
  const int q0 = blockIdx.x * kTile;
  const int64_t nn = static_cast<int64_t>(a.nq) * a.nk;
  const bf16* bp = static_cast<const bf16*>(a.bias) + h * nn;
  const bf16* mp = masked ? static_cast<const bf16*>(a.mask) + (b % a.nw) * nn : nullptr;
  const bf16* kp = at(a.k, a.ks, b, h);
  const bf16* vp = at(a.v, a.vs, b, h);

  // key tile k0 (K, V, bias and mask tiles) into slot si as one commit group
  auto issue = [&](int si, int k0) {
    if (k0 < a.nk) {
      unsigned char* slot = smem_wdq + si * slot_bytes;
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot), kp, a.ks.n, k0, a.nk);
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot + Z::kOp), vp, a.vs.n, k0,
                                    a.nk);
      bf16* bt = reinterpret_cast<bf16*>(slot + 2 * Z::kOp);
      copy_tile<kTile, kThreads>(bt, bp, a.nq, a.nk, q0, k0);
      if (masked) copy_tile<kTile, kThreads>(bt + kTile * kTile, mp, a.nq, a.nk, q0, k0);
    }
    cp_async_commit();
  };
  issue(0, 0);

  const bool active = q0 + warp * 16 < a.nq;  // a row of this warp is in range
  const int row0 = warp * 16 + g;             // the thread's rows row0, row0 + 8
  uint32_t qf[KS][4], df[KS][4];
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};  // lse * log2(e), delta
  if (active) {
    load_a_frags(qf, at(a.q, a.qs, b, h), a.qs.n, q0 + warp * 16, a.nq);
    load_a_frags(df, at(w.dout, a.os, b, h), a.os.n, q0 + warp * 16, a.nq);
    const float qscale = round_to<bf16>(a.qscale);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) qf[ks][j] = scale_bf16x2(qf[ks][j], qscale);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + row0 + 8 * hr;
      lse2[hr] = qi < a.nq ? __ldg(a.lse + static_cast<int64_t>(bh) * a.nq + qi) * kLog2e : 0.f;
    }
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  // Two sweeps over the key tiles: the first sums delta = rowsum(P * dP) in
  // fp32 (the TPU kernel's delta), the second forms dS and dq from it.
  const int n_t = (a.nk + kTile - 1) / kTile;
  for (int t = 0; t < 2 * n_t; ++t) {
    const bool first = t < n_t;
    const int k0 = (first ? t : t - n_t) * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile t's slot is full; every warp is done with t - 1's slot
    issue((t + 1) % kRing, t + 1 < 2 * n_t ? (t + 1 < n_t ? t + 1 : t + 1 - n_t) * kTile : a.nk);
    if (!active) continue;
    if (t == n_t) {  // the first sweep is done: the quad's sums are the rows' delta
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dlt[hr] += __shfl_xor_sync(0xffffffffu, dlt[hr], 1);
        dlt[hr] += __shfl_xor_sync(0xffffffffu, dlt[hr], 2);
        const int qi = q0 + row0 + 8 * hr;
        if (t4 == 0 && qi < a.nq) w.delta[static_cast<int64_t>(bh) * a.nq + qi] = dlt[hr];
      }
    }
    const unsigned char* slot = smem_wdq + (t % kRing) * slot_bytes;
    const bf16* kt = reinterpret_cast<const bf16*>(slot);
    const bf16* vt = reinterpret_cast<const bf16*>(slot + Z::kOp);
    const bf16* bt = reinterpret_cast<const bf16*>(slot + 2 * Z::kOp);
    const int valid = a.nk - k0;  // keys of this tile in range (may exceed kTile)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys: two 8-key column tiles
      if (kk * 16 >= valid) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 2 * kk + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        if (n * 8 < valid) {  // S = q_s K^T, dP = dO V^T
#pragma unroll
          for (int k2 = 0; k2 < KS; k2 += 2) {
            uint32_t kb[4], vb[4];
            ldsm_x4(kb, kt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
            ldsm_x4(vb, vt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
            mma_bf16(s[j], qf[k2], kb[0], kb[1]);
            mma_bf16(s[j], qf[k2 + 1], kb[2], kb[3]);
            mma_bf16(dp[j], df[k2], vb[0], vb[1]);
            mma_bf16(dp[j], df[k2 + 1], vb[2], vb[3]);
          }
        }
        const int c = n * 8 + 2 * t4;  // the thread's key columns c, c + 1
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const bf16* br = bt + swz(row0 + 8 * hr, c);
          add_bf16x2(&s[j][2 * hr], *reinterpret_cast<const uint32_t*>(br));
          if (masked)
            add_bf16x2(&s[j][2 * hr], *reinterpret_cast<const uint32_t*>(br + kTile * kTile));
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // P = 0 past Nk; delta += P dP, or dS = P (dP - delta)
            const int i = 2 * hr + e;
            const float p = c + e < valid ? exp2_ftz(s[j][i] * kLog2e - lse2[hr]) : 0.f;
            if (first) dlt[hr] += p * dp[j][i];
            else s[j][i] = p * (dp[j][i] - dlt[hr]);
          }
        }
      }
      if (first) continue;
      // dq += dS K: dS (bf16) as the A fragment of these 16 keys
      const uint32_t da[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, kt + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
        mma_bf16(dq[dn], da, kb[0], kb[1]);
        mma_bf16(dq[dn + 1], da, kb[2], kb[3]);
      }
    }
  }
  if (!active) return;

  bf16* dqp = w.dq + b * a.qs.b + h * a.qs.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    if (qi >= a.nq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqp + qi * a.qs.n + n * 8 + 2 * t4) =
          pack_bf16(dq[n][2 * hr] * a.qscale, dq[n][2 * hr + 1] * a.qscale);
  }
}

// Pass 2: dk and dv. Grid (key tiles, windows x heads). 3 blocks per SM: its
// dk and dv (32 registers) on top of the dq pass's state spilled under the
// 128-register cap of 4.
template <int D>
__global__ void __launch_bounds__(kThreads, 3) window_bwd_dkv_sm90_kernel(WindowBwdArgs w) {
  using Z = Bytes<D>;
  constexpr int KS = D / 16, ND = D / 8, LD = Z::LD;
  extern __shared__ __align__(128) unsigned char smem_wdkv[];
  const AttnArgs& a = w.f;
  const bool masked = a.mask != nullptr;
  const int bias_at = 2 * Z::kOp, stats_at = bias_at + (masked ? 2 : 1) * Z::kBias;
  const int slot_bytes = stats_at + Z::kStats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, h = bh % a.heads, b = bh / a.heads;
  const int k0 = blockIdx.x * kTile;
  const int64_t nn = static_cast<int64_t>(a.nq) * a.nk;
  const bf16* bp = static_cast<const bf16*>(a.bias) + h * nn;
  const bf16* mp = masked ? static_cast<const bf16*>(a.mask) + (b % a.nw) * nn : nullptr;
  const bf16* qp = at(a.q, a.qs, b, h);
  const bf16* dop = at(w.dout, a.os, b, h);
  const float* lsep = a.lse + static_cast<int64_t>(bh) * a.nq;
  const float* dlp = w.delta + static_cast<int64_t>(bh) * a.nq;

  // query tile q0 (q, dO, bias and mask tiles, lse and delta) into slot si
  auto issue = [&](int si, int q0) {
    if (q0 < a.nq) {
      unsigned char* slot = smem_wdkv + si * slot_bytes;
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot), qp, a.qs.n, q0, a.nq);
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot + Z::kOp), dop, a.os.n, q0,
                                    a.nq);
      bf16* bt = reinterpret_cast<bf16*>(slot + bias_at);
      copy_tile<kTile, kThreads>(bt, bp, a.nq, a.nk, q0, k0);
      if (masked) copy_tile<kTile, kThreads>(bt + kTile * kTile, mp, a.nq, a.nk, q0, k0);
      if (tid < 2 * kTile / 4) {  // 16 threads per row of stats, 4 values each
        const int i = (tid % (kTile / 4)) * 4;
        const float* src = tid < kTile / 4 ? lsep : dlp;
        const bool ok = q0 + i < a.nq;  // Nq % 4 == 0
        cp_async16(reinterpret_cast<float*>(slot + stats_at) + (tid / (kTile / 4)) * kTile + i,
                   ok ? src + q0 + i : src, ok);
      }
    }
    cp_async_commit();
  };
  issue(0, 0);

  const bool active = k0 + warp * 16 < a.nk;  // a key of this warp is in range
  const int key0 = warp * 16 + g;             // the thread's keys key0, key0 + 8
  uint32_t kf[KS][4], vf[KS][4];
  if (active) {
    load_a_frags(kf, at(a.k, a.ks, b, h), a.ks.n, k0 + warp * 16, a.nk);
    load_a_frags(vf, at(a.v, a.vs, b, h), a.vs.n, k0 + warp * 16, a.nk);
  }
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float qscale = round_to<bf16>(a.qscale);

  const int n_t = (a.nq + kTile - 1) / kTile;
  for (int t = 0, q0 = 0; t < n_t; ++t, q0 += kTile) {
    cp_async_wait<0>();
    unsigned char* slot = smem_wdkv + (t % kRing) * slot_bytes;
    scale_own_rows<D>(reinterpret_cast<bf16*>(slot), qscale);  // q -> q_s
    __syncthreads();  // tile t's slot is full and scaled; t - 1's slot is free
    issue((t + 1) % kRing, q0 + kTile);
    if (!active) continue;
    const bf16* qt = reinterpret_cast<const bf16*>(slot);
    const bf16* dt = reinterpret_cast<const bf16*>(slot + Z::kOp);
    const bf16* bt = reinterpret_cast<const bf16*>(slot + bias_at);
    const float* lse_s = reinterpret_cast<const float*>(slot + stats_at);
    const float* dlt_s = lse_s + kTile;
    const int valid = a.nq - q0;  // queries of this tile in range (may exceed kTile)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries: two 8-query column tiles
      if (kk * 16 >= valid) break;
      float st[2][4], dpt[2][4];  // S^T, dP^T; then P^T, dS^T
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 2 * kk + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
        if (n * 8 < valid) {  // S^T = K q_s^T, dP^T = V dO^T
#pragma unroll
          for (int k2 = 0; k2 < KS; k2 += 2) {
            uint32_t qb[4], db[4];
            ldsm_x4(qb, qt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
            ldsm_x4(db, dt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
            mma_bf16(st[j], kf[k2], qb[0], qb[1]);
            mma_bf16(st[j], kf[k2 + 1], qb[2], qb[3]);
            mma_bf16(dpt[j], vf[k2], db[0], db[1]);
            mma_bf16(dpt[j], vf[k2 + 1], db[2], db[3]);
          }
        }
        const int c = n * 8 + 2 * t4;  // the thread's query columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * hr + e;
            const int at_bias = swz(c + e, key0 + 8 * hr);  // (query, key) of the tiles
            float s = st[j][i] + __bfloat162float(bt[at_bias]);
            if (masked) s += __bfloat162float(bt[kTile * kTile + at_bias]);
            const float p =
                c + e < valid ? exp2_ftz(s * kLog2e - (e ? l2.y : l2.x) * kLog2e) : 0.f;
            st[j][i] = p;
            dpt[j][i] = p * (dpt[j][i] - (e ? d2.y : d2.x));
          }
        }
      }
      // dv += P^T dO, dk += dS^T q_s: P^T and dS^T (bf16) as A fragments of
      // these 16 queries; dO's and q_s's B fragments from ldmatrix.trans
      const uint32_t pa[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
      const uint32_t da[4] = {pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
                              pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t ob[4], qb[4];
        ldsm_x4_trans(ob, dt + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
        ldsm_x4_trans(qb, qt + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
        mma_bf16(dv[dn], pa, ob[0], ob[1]);
        mma_bf16(dv[dn + 1], pa, ob[2], ob[3]);
        mma_bf16(dk[dn], da, qb[0], qb[1]);
        mma_bf16(dk[dn + 1], da, qb[2], qb[3]);
      }
    }
  }
  if (!active) return;

  bf16* dkp = w.dk + b * a.qs.b + h * a.qs.h;
  bf16* dvp = w.dv + b * a.qs.b + h * a.qs.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + key0 + 8 * hr;
    if (kj >= a.nk) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int64_t at_el = kj * a.qs.n + n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkp + at_el) = pack_bf16(dk[n][2 * hr], dk[n][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dvp + at_el) = pack_bf16(dv[n][2 * hr], dv[n][2 * hr + 1]);
    }
  }
}

// Pass 3: dbias. Grid (query tiles x key tiles, heads, groups of windows).
template <int D>
__global__ void __launch_bounds__(kThreads, 4) window_bwd_dbias_sm90_kernel(WindowBwdArgs w) {
  using Z = Bytes<D>;
  constexpr int KS = D / 16, NS = kTile / 8, LD = Z::LD;
  extern __shared__ __align__(128) unsigned char smem_wdb[];
  const AttnArgs& a = w.f;
  const bool masked = a.mask != nullptr;
  const int slot_bytes = 4 * Z::kOp + (masked ? 1 : 0) * Z::kBias;
  constexpr int E = Z::kOp / sizeof(bf16);  // elements of one operand tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int ktiles = (a.nk + kTile - 1) / kTile;
  const int q0 = blockIdx.x / ktiles * kTile, k0 = blockIdx.x % ktiles * kTile;
  const int h = blockIdx.y, grp = blockIdx.z;
  const int per = (w.windows + w.groups - 1) / w.groups;
  const int w0 = grp * per, w1 = min(w.windows, w0 + per);
  const int64_t nn = static_cast<int64_t>(a.nq) * a.nk;

  // window b's q, dO (query tile), K, V (key tile) and mask tile into slot si
  auto issue = [&](int si, int b) {
    if (b < w1) {
      bf16* slot = reinterpret_cast<bf16*>(smem_wdb + si * slot_bytes);
      copy_rows<kTile, D, kThreads>(slot, at(a.q, a.qs, b, h), a.qs.n, q0, a.nq);
      copy_rows<kTile, D, kThreads>(slot + E, at(w.dout, a.os, b, h), a.os.n, q0, a.nq);
      copy_rows<kTile, D, kThreads>(slot + 2 * E, at(a.k, a.ks, b, h), a.ks.n, k0, a.nk);
      copy_rows<kTile, D, kThreads>(slot + 3 * E, at(a.v, a.vs, b, h), a.vs.n, k0, a.nk);
      if (masked)
        copy_tile<kTile, kThreads>(slot + 4 * E,
                                   static_cast<const bf16*>(a.mask) + (b % a.nw) * nn, a.nq,
                                   a.nk, q0, k0);
    }
    cp_async_commit();
  };
  issue(0, w0);

  const bool active = q0 + warp * 16 < a.nq;
  const int row0 = warp * 16 + g;  // the thread's rows row0, row0 + 8
  const int valid = a.nk - k0;     // keys of this tile in range (may exceed kTile)
  // the bias rows of the thread's accumulator elements (columns k0 + 2 t4 +
  // 8 n), read per window through L1: held in registers they spilled
  const bf16* brow[2];
  bool rok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    rok[hr] = qi < a.nq;
    const int64_t row = rok[hr] ? qi : 0;
    brow[hr] = static_cast<const bf16*>(a.bias) + h * nn + row * a.nk + k0 + 2 * t4;
  }
  float acc[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float qscale = round_to<bf16>(a.qscale);

  for (int t = 0, b = w0; b < w1; ++t, ++b) {
    cp_async_wait<0>();
    bf16* slot = reinterpret_cast<bf16*>(smem_wdb + (t % kRing) * slot_bytes);
    scale_own_rows<D>(slot, qscale);  // q -> q_s
    __syncthreads();  // window t's slot is full and scaled; t - 1's slot is free
    issue((t + 1) % kRing, b + 1);
    if (!active) continue;
    const bf16* qt = slot;
    const bf16* dt = slot + E;
    const bf16* kt = slot + 2 * E;
    const bf16* vt = slot + 3 * E;
    const bf16* mt = slot + 4 * E;
    float lse2[2], dlt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + row0 + 8 * hr;
      const int64_t at_row = (static_cast<int64_t>(b) * a.heads + h) * a.nq + qi;
      lse2[hr] = qi < a.nq ? __ldg(a.lse + at_row) * kLog2e : 0.f;
      dlt[hr] = qi < a.nq ? __ldg(w.delta + at_row) : 0.f;
    }
    uint32_t qa[KS][4], da[KS][4];  // A fragments of q_s and dO, rows warp * 16 ..
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(qa[ks], qt + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      ldsm_x4(da[ks], dt + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if (n * 8 >= valid) break;
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k2 = 0; k2 < KS; k2 += 2) {  // S = q_s K^T, dP = dO V^T
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, kt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
        ldsm_x4(vb, vt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
        mma_bf16(s, qa[k2], kb[0], kb[1]);
        mma_bf16(s, qa[k2 + 1], kb[2], kb[3]);
        mma_bf16(dp, da[k2], vb[0], vb[1]);
        mma_bf16(dp, da[k2 + 1], vb[2], vb[3]);
      }
      const int c = n * 8 + 2 * t4;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        add_bf16x2(&s[2 * hr],
                   rok[hr] ? __ldg(reinterpret_cast<const uint32_t*>(brow[hr] + n * 8)) : 0u);
        if (masked)
          add_bf16x2(&s[2 * hr], *reinterpret_cast<const uint32_t*>(mt + swz(row0 + 8 * hr, c)));
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // dbias += dS = P (dP - delta), P = 0 past Nk
          const int i = 2 * hr + e;
          const float p = c + e < valid ? exp2_ftz(s[i] * kLog2e - lse2[hr]) : 0.f;
          acc[n][i] += p * (dp[i] - dlt[hr]);
        }
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    if (qi >= a.nq) continue;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int kj = k0 + n * 8 + 2 * t4;  // Nk % 8 == 0: kj + 1 is in range too
      if (kj >= a.nk) continue;
      const int64_t at_el = static_cast<int64_t>(h) * nn + static_cast<int64_t>(qi) * a.nk + kj;
      if (w.groups == 1)
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(w.dbias) + at_el) =
            pack_bf16(acc[n][2 * hr], acc[n][2 * hr + 1]);
      else
        *reinterpret_cast<float2*>(w.dbias_part + grp * a.heads * nn + at_el) =
            make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const WindowBwdArgs& w, cudaStream_t stream) {
  using Z = Bytes<D>;
  const AttnArgs& a = w.f;
  const bool masked = a.mask != nullptr;
  const int qtiles = (a.nq + kTile - 1) / kTile, ktiles = (a.nk + kTile - 1) / kTile;
  const int bh = w.windows * a.heads;
  int smem = Z::dq(masked);
  cudaError_t err = allow_smem(window_bwd_dq_sm90_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  window_bwd_dq_sm90_kernel<D><<<dim3(qtiles, bh), kThreads, smem, stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = Z::dkv(masked);
  if ((err = allow_smem(window_bwd_dkv_sm90_kernel<D>, smem)) != cudaSuccess) return err;
  window_bwd_dkv_sm90_kernel<D><<<dim3(ktiles, bh), kThreads, smem, stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = Z::dbias(masked);
  if ((err = allow_smem(window_bwd_dbias_sm90_kernel<D>, smem)) != cudaSuccess) return err;
  window_bwd_dbias_sm90_kernel<D><<<dim3(qtiles * ktiles, a.heads, w.groups), kThreads, smem,
                                    stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (w.groups == 1) return cudaSuccess;
  return launch_window_dbias_reduce<bf16>(w.dbias_part, w.dbias, w.groups,
                                          static_cast<int64_t>(a.heads) * a.nq * a.nk, stream);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

cudaError_t window_attention_bwd_sm90(const AttnArgs& f, const void* dout, void* dqkv,
                                      void* dbias, float* delta, float* dbias_part, int groups,
                                      int windows, int C, cudaStream_t stream) {
  // 16-byte rows of every operand the ring copies (qkv lanes, dO, bias, mask,
  // lse and delta), 4-byte bf16 pairs of dqkv and dbias, 8-byte fp32 pairs
  // of the partials
  if (f.nq != f.nk || f.nq % 8 != 0 || C % 8 != 0 || groups <= 0 ||
      (groups > 1 && (dbias_part == nullptr || !aligned(dbias_part, 8))))
    return cudaErrorInvalidValue;
  if (!aligned(f.q, 16) || !aligned(f.out, 16) || !aligned(dout, 16) || !aligned(f.bias, 16) ||
      (f.mask != nullptr && !aligned(f.mask, 16)) || !aligned(f.lse, 16) ||
      !aligned(delta, 16) || !aligned(dqkv, 4) || !aligned(dbias, 4))
    return cudaErrorMisalignedAddress;
  WindowBwdArgs w{};
  w.f = f;
  w.dout = static_cast<const bf16*>(dout);
  w.dq = static_cast<bf16*>(dqkv);
  w.dk = w.dq + C;
  w.dv = w.dq + 2 * C;
  w.delta = delta;
  w.dbias = dbias;
  w.dbias_part = dbias_part;
  w.windows = windows;
  w.groups = groups;
  if (C / f.heads == 32) return launch<32>(w, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mspi
