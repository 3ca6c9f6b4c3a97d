// The bf16 backward of row 6 (attention.cu: MViT attention on augmented q/k
// lanes, attn_relk=False), register-resident on the tensor cores and fed by
// asynchronous copies:
//   S = q_aug k_aug^T,  P = exp(S - lse),  O = P v  (no scale),
//   dv = P^T dO,  dP = dO v^T,  dS = P * (dP - rowsum(P * dP)),
//   dq = dS k_aug,  dk = dS^T q_aug
// per (batch, head) on head-major operands: q_aug, dq [B, H, Nq, Da]; k_aug,
// dk [B, H, Nk, Da]; v, dv [B, H, Nk, 96]; out, dout [B, H, Nq, 96]. The
// score width Da = 96 + R (q * scale, then the rel lanes; k, then the 0/1
// expansion E of the key grid) is any width: compile-time forms up to 256,
// the wide form past it (below); dk includes the k_aug lanes of E, which
// take a gradient the caller drops. lse is the forward's fp32
// row log-sum-exp. Numerics are the TPU kernel's: delta = rowsum(P * dP) in
// fp32, dS rounded to bf16 where it enters dq and dk, P where it enters dv.
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::_bwd_impl (kernel
// _bwd_kernel) under attn_relk=False, the 16 MViT blocks of the relk0
// training step. Entered through attention_bwd.cu's mspi_attention_bwd,
// whose fp32 branch keeps the FMA passes. The TPU kernel holds a whole
// [TQ, Nk] score tile and carries dk and dv across its sequential grid in
// VMEM; blocks on the card run in no order, so the work is
// self_attention_bwd_sm90.cu's passes with unequal score and value widths,
// none with atomics, each a grid of blocks of 4 warps with 16 rows per warp
// (m16n8k16 mma.sync, bf16 in, fp32 accumulate) and 64-row tiles of the
// other side through a 2-slot cp.async ring with one barrier per tile:
//   0. pad: Da-lane rows are not 16-byte aligned (Da is odd at 123), so
//      q_aug and k_aug are first copied once into zero-filled rows of DK =
//      128, 144, 176, 192 or 256 lanes (aug_width; flash_attention_sm90.cuh's
//      aug_pad_kernel); the zero lanes add nothing to S.
//   1. dq + delta: one block per (64-query tile, b x h). q and dO stay in
//      registers as A fragments; in the wide form (DK = 176, Da 145..176:
//      MViTv2-S's 148 at --resolution 256 448 and 162 at 288x640) q's 64
//      rows stay in shared memory instead and each warp reads its A
//      fragments by ldmatrix per key tile, since q's 44 registers beside
//      dq's 88 would leave too few; so do DK = 192 (Da 177..192: 180 at
//      --resolution 448 768, 184 at 512 768) and 256 (Da 193..256). At DK =
//      256 a block takes half of dq's columns (grid z), since dq's 128
//      registers would not fit beside the rest: each half computes S, dP and
//      delta again. The key tiles (K and V rows) are walked
//      twice: the first sweep sums delta = rowsum(P * dP) in fp32 and writes
//      it for pass 2; the second recomputes S and dP, forms dS, rounds it to
//      bf16 and repacks it into A fragments for dq += dS K (K's B fragments
//      by ldmatrix.trans). dq is written once in bf16, Da lanes.
//   2. dk + dv: one block per (64-key tile, b x h, segment of query tiles).
//      The block's K and V rows are copied once into shared memory and each
//      warp reads its A fragments by ldmatrix per use (dk and dv, 120
//      registers, leave no room for them in registers). Above DK = 176 a
//      block takes half of dk's columns (grid z = segments x 2; the first
//      half also dv), since dk's 96 or 128 registers beside dv's 48 would
//      spill: each half computes S^T and dP^T. Per query tile (q,
//      dO, lse and delta through the ring) S^T = K q^T and dP^T = V dO^T
//      land in the layout that repacks into A fragments for dv += P^T dO and
//      dk += dS^T q. With one segment dk and dv are written in bf16; with
//      more, fp32 partials [segments, B*H, Nk, DK | 96] that
//      aug_bwd_reduce_kernel sums in segment order.
// Every output element has one writer and a fixed summation order, so two
// runs give bit-identical dq, dk and dv. Ragged tiles are zero-filled by the
// copies and P is 0 past Nk.
//
// What bounds it on the card: 2 (3 DK + 2 96) flops per (query, key) pair
// (S twice, dP twice, dq, dk, dv; S and dP once more for delta) against q,
// k, v, dO read once per tile of the other side: the tensor cores, far from
// their peak at these tile sizes.

#include "attention_bwd_sm90.cuh"

namespace mspi {
namespace {

using sm90::copy_rows;
using sm90::exp2_ftz;
using sm90::kLog2e;
using sm90::ldsm_x2;
using sm90::ldsm_x4;
using sm90::ldsm_x4_trans;
using sm90::load_a_frags;
using sm90::mma_bf16;

constexpr int kThreads = sm90::kBwdThreads;
constexpr int kTile = sm90::kBwdTile;
constexpr int kRing = sm90::kStages;
constexpr int kDv = 96;  // v, dO and O lanes (MViT's head dim)

struct AugBwdArgs {
  const bf16 *q, *k;  // the padded rows [B*H, Nq | Nk, DK]
  const bf16* v;      // [B*H, Nk, 96]
  const bf16* dout;   // [B*H, Nq, 96]
  const float* lse;   // [B*H, Nq]
  float* delta;       // [B*H, Nq]
  bf16 *dq, *dk, *dv;  // [B*H, Nq | Nk, Da], [B*H, Nk, 96]
  float *dk_part, *dv_part;  // [segments, B*H, Nk, DK | 96]
  int nq, nk, da, segments, qtiles_per_seg;
};

// Byte sizes of the shared-memory regions at score width DK.
template <int DK>
struct AugBytes {
  static constexpr int LDK = DK + 8, LDV = kDv + 8;  // bf16 pitches of q/k and v/dO rows
  static constexpr int kOpK = sizeof(bf16) * kTile * LDK;  // one [64][DK] tile
  static constexpr int kOpV = sizeof(bf16) * kTile * LDV;  // one [64][96] tile
  static constexpr int kStats = 2 * sizeof(float) * kTile;  // 64 rows' lse and delta
  static constexpr bool kQShared = DK > 144;  // the wide forms: q's rows in shared memory
  // blocks that split dq's (dk's) columns: each takes DK / split of them
  static constexpr int kDqSplit = DK > 192 ? 2 : 1;
  static constexpr int kDkvSplit = DK > 176 ? 2 : 1;
  // the ring of (K, V) tiles, then (wide form) the block's q rows
  static constexpr int kDq = kRing * (kOpK + kOpV) + (kQShared ? kOpK : 0);
  static constexpr int kDkvSlot = kOpK + kOpV + kStats;     // q, dO, lse and delta
  static constexpr int kDkv = kRing * kDkvSlot + kOpK + kOpV;  // + the block's K and V rows
  static_assert(kOpK % 16 == 0 && kOpV % 16 == 0, "16-byte regions");
};

// d += A B^T over k-steps [0, KS) of one 8-row B column tile: A fragments
// af (rows of the warp), B's rows at `brow` (the tile's first row, pitch
// LD), two k-steps per ldmatrix.x4 and an x2 for an odd last one.
template <int KS, int LD>
__device__ __forceinline__ void mma_rows(float (&d)[4], const uint32_t (&af)[KS][4],
                                         const bf16* brow) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k2 = 0; k2 + 1 < KS; k2 += 2) {
    uint32_t b[4];
    ldsm_x4(b, brow + (lane & 7) * LD + k2 * 16 + (lane >> 3) * 8);
    mma_bf16(d, af[k2], b[0], b[1]);
    mma_bf16(d, af[k2 + 1], b[2], b[3]);
  }
  if constexpr (KS % 2 == 1) {
    uint32_t b[2];
    ldsm_x2(b, brow + (lane & 7) * LD + (KS - 1) * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16(d, af[KS - 1], b[0], b[1]);
  }
}

// Pass 1: delta, then dq. Grid (query tiles, B x H, dq's column splits).
template <int DK>
__global__ void __launch_bounds__(kThreads, 2) aug_bwd_dq_sm90_kernel(AugBwdArgs w) {
  using Z = AugBytes<DK>;
  constexpr int SPLIT = Z::kDqSplit;
  constexpr int KSK = DK / 16, KSV = kDv / 16, NDK = DK / 8 / SPLIT;  // dq's column tiles
  // the block's dq columns [c0, c0 + DK / SPLIT); the first split writes delta
  const int c0 = SPLIT == 1 ? 0 : static_cast<int>(blockIdx.z) * (DK / SPLIT);
  const bool writes_delta = SPLIT == 1 || blockIdx.z == 0;
  constexpr int LDK = Z::LDK, LDV = Z::LDV;
  constexpr bool kQShared = Z::kQShared;
  extern __shared__ __align__(128) unsigned char smem_adq[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const bf16* kp = w.k + static_cast<int64_t>(bh) * w.nk * DK;
  const bf16* vp = w.v + static_cast<int64_t>(bh) * w.nk * kDv;
  const int64_t rows = static_cast<int64_t>(bh) * w.nq;
  // the wide form: the block's q rows [64][LDK] after the ring, one commit
  // group of their own ahead of the ring's; the lane's row for ldmatrix
  bf16* qs = reinterpret_cast<bf16*>(smem_adq + kRing * (Z::kOpK + Z::kOpV));
  const bf16* qa_row = qs + (warp * 16 + (lane & 15)) * LDK + (lane >> 4) * 8;
  if constexpr (kQShared) {
    copy_rows<kTile, DK, kThreads>(qs, w.q + rows * DK, DK, q0, w.nq);
    cp_async_commit();
  }
  // key tile k0 (K and V rows) into slot si as one commit group; k0 >= Nk
  // commits an empty group
  auto issue = [&](int si, int k0) {
    if (k0 < w.nk) {
      unsigned char* slot = smem_adq + si * (Z::kOpK + Z::kOpV);
      copy_rows<kTile, DK, kThreads>(reinterpret_cast<bf16*>(slot), kp, DK, k0, w.nk);
      copy_rows<kTile, kDv, kThreads>(reinterpret_cast<bf16*>(slot + Z::kOpK), vp, kDv, k0,
                                      w.nk);
    }
    cp_async_commit();
  };
  issue(0, 0);

  const bool active = q0 + warp * 16 < w.nq;  // a row of this warp is in range
  const int row0 = warp * 16 + g;             // the thread's rows row0, row0 + 8
  uint32_t qf[kQShared ? 1 : KSK][4], df[KSV][4];
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};  // lse * log2(e), delta
  if (active) {
    if constexpr (!kQShared) load_a_frags(qf, w.q + rows * DK, DK, q0 + warp * 16, w.nq);
    load_a_frags(df, w.dout + rows * kDv, kDv, q0 + warp * 16, w.nq);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + row0 + 8 * hr;
      lse2[hr] = qi < w.nq ? __ldg(w.lse + rows + qi) * kLog2e : 0.f;
    }
  }
  float dq[NDK][4];
#pragma unroll
  for (int n = 0; n < NDK; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  // sweep 1 (t < n_t) sums delta, sweep 2 forms dS and dq from it
  const int n_t = (w.nk + kTile - 1) / kTile;
  for (int t = 0; t < 2 * n_t; ++t) {
    const bool first = t < n_t;
    const int k0 = (first ? t : t - n_t) * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile t's slot is full; every warp is done with t - 1's slot
    issue((t + 1) % kRing, t + 1 < 2 * n_t ? (t + 1 < n_t ? t + 1 : t + 1 - n_t) * kTile : w.nk);
    if (!active) continue;
    if (t == n_t) {  // the first sweep is done: the quad's sums are the rows' delta
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dlt[hr] += __shfl_xor_sync(0xffffffffu, dlt[hr], 1);
        dlt[hr] += __shfl_xor_sync(0xffffffffu, dlt[hr], 2);
        const int qi = q0 + row0 + 8 * hr;
        if (t4 == 0 && qi < w.nq && writes_delta) w.delta[rows + qi] = dlt[hr];
      }
    }
    const unsigned char* slot = smem_adq + (t % kRing) * (Z::kOpK + Z::kOpV);
    const bf16* kt = reinterpret_cast<const bf16*>(slot);
    const bf16* vt = reinterpret_cast<const bf16*>(slot + Z::kOpK);
    const int valid = w.nk - k0;  // keys of this tile in range (may exceed kTile)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys: two 8-key column tiles
      if (kk * 16 >= valid) break;
      uint32_t da[4];  // dS (bf16) as the A fragment of these 16 keys
      float s[2][4] = {}, dp[2][4] = {};  // S = q K^T, dP = dO V^T of both column tiles
      if constexpr (kQShared) {  // q's A fragments one k-step at a time by ldmatrix
#pragma unroll
        for (int ks = 0; ks < KSK; ++ks) {
          uint32_t qa[4];
          ldsm_x4(qa, qa_row + ks * 16);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t kb[2];
            ldsm_x2(kb, kt + ((2 * kk + j) * 8 + (lane & 7)) * LDK + ks * 16 +
                            ((lane >> 3) & 1) * 8);
            mma_bf16(s[j], qa, kb[0], kb[1]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_rows<KSK, LDK>(s[j], qf, kt + (2 * kk + j) * 8 * LDK);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_rows<KSV, LDV>(dp[j], df, vt + (2 * kk + j) * 8 * LDV);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = (2 * kk + j) * 8 + 2 * t4;  // the thread's key columns c, c + 1
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // P = 0 past Nk; delta += P dP, or dS = P (dP - delta)
          const int hr = i >> 1;
          const float pr = c + (i & 1) < valid ? exp2_ftz(s[j][i] * kLog2e - lse2[hr]) : 0.f;
          if (first) dlt[hr] += pr * dp[j][i];
          ds[i] = pr * (dp[j][i] - dlt[hr]);
        }
        da[2 * j] = pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      if (first) continue;
      // dq += dS K: K's rows of these keys by ldmatrix.trans
#pragma unroll
      for (int dn = 0; dn < NDK; dn += 2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, kt + (kk * 16 + (lane & 15)) * LDK + c0 + dn * 8 + (lane >> 4) * 8);
        mma_bf16(dq[dn], da, kb[0], kb[1]);
        mma_bf16(dq[dn + 1], da, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  // dq's Da lanes (2-byte stores: Da-lane rows have no alignment)
  bf16* dqp = w.dq + rows * w.da;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    if (qi >= w.nq) continue;
#pragma unroll
    for (int n = 0; n < NDK; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      if (col < w.da) dqp[qi * w.da + col] = __float2bfloat16(dq[n][2 * hr]);
      if (col + 1 < w.da) dqp[qi * w.da + col + 1] = __float2bfloat16(dq[n][2 * hr + 1]);
    }
  }
}

// Pass 2: dk and dv. Grid (key tiles, B x H, segments of query tiles x dk's
// column splits).
template <int DK>
__global__ void __launch_bounds__(kThreads, 2) aug_bwd_dkv_sm90_kernel(AugBwdArgs w) {
  using Z = AugBytes<DK>;
  constexpr int SPLIT = Z::kDkvSplit;
  constexpr int KSK = DK / 16, KSV = kDv / 16, NDK = DK / 8 / SPLIT, NDV = kDv / 8;
  constexpr int LDK = Z::LDK, LDV = Z::LDV;
  extern __shared__ __align__(128) unsigned char smem_adkv[];
  constexpr int dout_at = Z::kOpK, stats_at = Z::kOpK + Z::kOpV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile, seg = blockIdx.z / SPLIT;
  // the block's dk columns [c0, c0 + DK / SPLIT); the first split takes dv
  const int c0 = SPLIT == 1 ? 0 : static_cast<int>(blockIdx.z % SPLIT) * (DK / SPLIT);
  const bool takes_dv = SPLIT == 1 || blockIdx.z % SPLIT == 0;
  const int64_t qrows = static_cast<int64_t>(bh) * w.nq, krows = static_cast<int64_t>(bh) * w.nk;
  const bf16* qp = w.q + qrows * DK;
  const bf16* dop = w.dout + qrows * kDv;
  const float* lsep = w.lse + qrows;
  const float* dlp = w.delta + qrows;
  // the block's K [64][LDK] and V [64][LDV] rows after the ring, one commit
  // group of their own ahead of the ring's
  bf16* ks = reinterpret_cast<bf16*>(smem_adkv + kRing * Z::kDkvSlot);
  bf16* vs = ks + kTile * LDK;
  copy_rows<kTile, DK, kThreads>(ks, w.k + krows * DK, DK, k0, w.nk);
  copy_rows<kTile, kDv, kThreads>(vs, w.v + krows * kDv, kDv, k0, w.nk);
  cp_async_commit();

  // query tile q0 (q, dO, lse and delta) into slot si as one commit group;
  // q0 >= Nq (past the segment) commits an empty group
  auto issue = [&](int si, int q0) {
    if (q0 < w.nq) {
      unsigned char* slot = smem_adkv + si * Z::kDkvSlot;
      copy_rows<kTile, DK, kThreads>(reinterpret_cast<bf16*>(slot), qp, DK, q0, w.nq);
      copy_rows<kTile, kDv, kThreads>(reinterpret_cast<bf16*>(slot + dout_at), dop, kDv, q0,
                                      w.nq);
      const int i = tid % kTile;  // threads 0-63 copy lse, 64-127 delta
      const float* src = tid < kTile ? lsep : dlp;
      const bool ok = q0 + i < w.nq;
      cp_async4(reinterpret_cast<float*>(slot + stats_at) + tid, ok ? src + q0 + i : src, ok);
    }
    cp_async_commit();
  };
  const int qtiles = (w.nq + kTile - 1) / kTile;
  const int qt0 = seg * w.qtiles_per_seg, qt1 = min(qtiles, qt0 + w.qtiles_per_seg);
  issue(0, qt0 * kTile);

  const bool active = k0 + warp * 16 < w.nk;  // a key of this warp is in range
  const int key0 = warp * 16 + g;             // the thread's keys key0, key0 + 8
  // the lane's row of the resident K and V tiles for their A fragments
  const bf16* ka_row = ks + (warp * 16 + (lane & 15)) * LDK + (lane >> 4) * 8;
  const bf16* va_row = vs + (warp * 16 + (lane & 15)) * LDV + (lane >> 4) * 8;
  float dk[NDK][4], dv[NDV][4];
#pragma unroll
  for (int n = 0; n < NDK; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NDV; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;

  for (int t = 0, qt = qt0; qt < qt1; ++t, ++qt) {
    cp_async_wait<0>();
    __syncthreads();  // tile t's slot is full; every warp is done with t - 1's slot
    issue((t + 1) % kRing, qt + 1 < qt1 ? (qt + 1) * kTile : w.nq);  // w.nq: none
    if (!active) continue;
    const unsigned char* slot = smem_adkv + (t % kRing) * Z::kDkvSlot;
    const bf16* qt_s = reinterpret_cast<const bf16*>(slot);
    const bf16* dt = reinterpret_cast<const bf16*>(slot + dout_at);
    const float* lse_s = reinterpret_cast<const float*>(slot + stats_at);
    const float* dlt_s = lse_s + kTile;
    const int valid = w.nq - qt * kTile;  // queries of this tile in range (may exceed kTile)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries: two 8-query column tiles
      if (kk * 16 >= valid) break;
      // S^T = K q^T, dP^T = V dO^T of both column tiles, K's and V's A
      // fragments one k-step at a time from the resident rows
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int ks2 = 0; ks2 < KSK; ++ks2) {
        uint32_t ka[4];
        ldsm_x4(ka, ka_row + ks2 * 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t qb[2];
          ldsm_x2(qb, qt_s + ((2 * kk + j) * 8 + (lane & 7)) * LDK + ks2 * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(st[j], ka, qb[0], qb[1]);
        }
      }
#pragma unroll
      for (int ks2 = 0; ks2 < KSV; ++ks2) {
        uint32_t va[4];
        ldsm_x4(va, va_row + ks2 * 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t db[2];
          ldsm_x2(db, dt + ((2 * kk + j) * 8 + (lane & 7)) * LDV + ks2 * 16 +
                        ((lane >> 3) & 1) * 8);
          mma_bf16(dpt[j], va, db[0], db[1]);
        }
      }
      uint32_t pa[4], da[4];  // P^T and dS^T (bf16) as A fragments of these 16 queries
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = (2 * kk + j) * 8 + 2 * t4;  // the thread's query columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + c);
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // P^T, dS^T = P^T (dP^T - delta); 0 past Nq
          const int e = i & 1;
          p[i] = c + e < valid ? exp2_ftz((st[j][i] - (e ? l2.y : l2.x)) * kLog2e) : 0.f;
          ds[i] = p[i] * (dpt[j][i] - (e ? d2.y : d2.x));
        }
        pa[2 * j] = pack_bf16(p[0], p[1]);
        pa[2 * j + 1] = pack_bf16(p[2], p[3]);
        da[2 * j] = pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dv += P^T dO, dk += dS^T q: dO's and q's B fragments by ldmatrix.trans
      if (takes_dv) {
#pragma unroll
        for (int dn = 0; dn < NDV; dn += 2) {
          uint32_t ob[4];
          ldsm_x4_trans(ob, dt + (kk * 16 + (lane & 15)) * LDV + dn * 8 + (lane >> 4) * 8);
          mma_bf16(dv[dn], pa, ob[0], ob[1]);
          mma_bf16(dv[dn + 1], pa, ob[2], ob[3]);
        }
      }
#pragma unroll
      for (int dn = 0; dn < NDK; dn += 2) {
        uint32_t qb[4];
        ldsm_x4_trans(qb,
                      qt_s + (kk * 16 + (lane & 15)) * LDK + c0 + dn * 8 + (lane >> 4) * 8);
        mma_bf16(dk[dn], da, qb[0], qb[1]);
        mma_bf16(dk[dn + 1], da, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();  // an empty segment leaves its first copies in flight
  if (!active) return;

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + key0 + 8 * hr;
    if (kj >= w.nk) continue;
    const int64_t row = krows + kj;
    if (w.segments == 1) {  // dk's Da lanes by 2-byte stores; dv's as pairs
#pragma unroll
      for (int n = 0; n < NDK; ++n) {
        const int col = c0 + n * 8 + 2 * t4;
        if (col < w.da) w.dk[row * w.da + col] = __float2bfloat16(dk[n][2 * hr]);
        if (col + 1 < w.da) w.dk[row * w.da + col + 1] = __float2bfloat16(dk[n][2 * hr + 1]);
      }
      if (takes_dv) {
#pragma unroll
        for (int n = 0; n < NDV; ++n)
          *reinterpret_cast<uint32_t*>(w.dv + row * kDv + n * 8 + 2 * t4) =
              pack_bf16(dv[n][2 * hr], dv[n][2 * hr + 1]);
      }
    } else {
      const int64_t prow = static_cast<int64_t>(seg) * gridDim.y * w.nk + row;
#pragma unroll
      for (int n = 0; n < NDK; ++n)
        *reinterpret_cast<float2*>(w.dk_part + prow * DK + c0 + n * 8 + 2 * t4) =
            make_float2(dk[n][2 * hr], dk[n][2 * hr + 1]);
      if (takes_dv) {
#pragma unroll
        for (int n = 0; n < NDV; ++n)
          *reinterpret_cast<float2*>(w.dv_part + prow * kDv + n * 8 + 2 * t4) =
              make_float2(dv[n][2 * hr], dv[n][2 * hr + 1]);
      }
    }
  }
}

// With segments > 1: dk and dv = the sums of the segments' partials in
// segment order, into dk's Da lanes and dv's 96. One thread per 8 columns of
// a row: two 16-byte loads per segment.
template <int DK>
__global__ void __launch_bounds__(256) aug_bwd_reduce_kernel(AugBwdArgs w, int bh_count) {
  constexpr int VK = DK / 8, VV = kDv / 8;  // 8-column groups of a dk and a dv row
  const int64_t rows = static_cast<int64_t>(bh_count) * w.nk;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= rows * (VK + VV)) return;
  const bool is_v = i >= rows * VK;
  const int width = is_v ? kDv : DK;
  const int64_t e = is_v ? i - rows * VK : i;
  const int64_t row = e / (is_v ? VV : VK);
  const int c = static_cast<int>(e % (is_v ? VV : VK)) * 8;
  const float* part = (is_v ? w.dv_part : w.dk_part) + row * width + c;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sgm = 0; sgm < w.segments; ++sgm) {
    const float4 lo = *reinterpret_cast<const float4*>(part + sgm * rows * width);
    const float4 hi = *reinterpret_cast<const float4*>(part + sgm * rows * width + 4);
    acc[0] += lo.x, acc[1] += lo.y, acc[2] += lo.z, acc[3] += lo.w;
    acc[4] += hi.x, acc[5] += hi.y, acc[6] += hi.z, acc[7] += hi.w;
  }
  if (is_v) {
    *reinterpret_cast<uint4*>(w.dv + row * kDv + c) =
        make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                   pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + j < w.da) w.dk[row * w.da + c + j] = __float2bfloat16(acc[j]);
}

template <int DK>
cudaError_t launch(AugBwdArgs w, const bf16* q, const bf16* k, bf16* pad, int bh,
                   cudaStream_t stream) {
  using Z = AugBytes<DK>;
  // 0. q and k into zero-filled DK-lane rows
  bf16* qpad = pad;
  bf16* kpad = pad + static_cast<int64_t>(bh) * w.nq * DK;
  cudaError_t err = sm90::launch_aug_pad<DK>(q, qpad, static_cast<int64_t>(bh) * w.nq, w.da,
                                             stream);
  if (err == cudaSuccess)
    err = sm90::launch_aug_pad<DK>(k, kpad, static_cast<int64_t>(bh) * w.nk, w.da, stream);
  if (err != cudaSuccess) return err;
  w.q = qpad;
  w.k = kpad;
  const int qtiles = (w.nq + kTile - 1) / kTile, ktiles = (w.nk + kTile - 1) / kTile;
  w.qtiles_per_seg = (qtiles + w.segments - 1) / w.segments;
  if ((err = allow_smem(aug_bwd_dq_sm90_kernel<DK>, Z::kDq)) != cudaSuccess) return err;
  aug_bwd_dq_sm90_kernel<DK><<<dim3(qtiles, bh, Z::kDqSplit), kThreads, Z::kDq, stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(aug_bwd_dkv_sm90_kernel<DK>, Z::kDkv)) != cudaSuccess) return err;
  aug_bwd_dkv_sm90_kernel<DK><<<dim3(ktiles, bh, w.segments * Z::kDkvSplit), kThreads, Z::kDkv,
                                stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess || w.segments == 1) return err;
  const int64_t threads = static_cast<int64_t>(bh) * w.nk * (DK / 8 + kDv / 8);
  aug_bwd_reduce_kernel<DK><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      w, bh);
  return cudaGetLastError();
}

// ---- the wide form (Da > 256): score lanes in chunks, columns in splits ----
//
// The score width DK = aug_width(Da) is a run-time multiple of 64, so no
// operand row of DK lanes stays in registers or whole in shared memory.
// Both passes walk steps (tile of the other side, chunk c of kAugChunk = 64
// score lanes): each step's ring slot holds the block's own rows' chunk c and
// the tile's chunk c [64][72], and S (or S^T) accumulates over the chunks
// in registers. On a tile's last chunk the slot also holds what the rest of
// the step reads: V [64][104] (dq pass; the dk/dv pass holds V's A
// fragments in registers) or dO [64][104], lse and delta (dk/dv pass), and
// the tile's columns [c0, c0 + 128) of k (dq += dS k) or q (dk += dS^T q) as
// two [64][72] chunks. dq's and dk's columns split over blocks of at most
// kSplit = 128 (grid z; dk's first split also takes dv), each block
// recomputing S and dP. 96 and 97 KB of shared memory, 2 blocks per SM.
constexpr int kSplit = 128;  // dq's (dk's) columns a block takes in the wide form

struct WideBytes {
  static constexpr int LDC = kAugChunk + 8, LDV = kDv + 8;  // bf16 pitches
  static constexpr int kChunkTile = sizeof(bf16) * kTile * LDC;  // one [64][72] chunk tile
  static constexpr int kOpV = sizeof(bf16) * kTile * LDV;       // one [64][96] tile
  static constexpr int kStats = 2 * sizeof(float) * kTile;       // 64 rows' lse and delta
  // own chunk, the tile's chunk, V or dO, the split's columns (2 chunk tiles)
  static constexpr int kDqSlot = 2 * kChunkTile + kOpV + 2 * kChunkTile;
  static constexpr int kDkvSlot = kDqSlot + kStats;
  static constexpr int kDq = kRing * kDqSlot;
  static constexpr int kDkv = kRing * kDkvSlot;
  static_assert(kChunkTile % 16 == 0 && kOpV % 16 == 0, "16-byte regions");
  static_assert(kSplit == 2 * kAugChunk, "a split's columns are two chunk tiles");
};

// The wide dq pass: delta, then dq's columns [c0, c0 + 128). Grid (query
// tiles, B x H, dq's column splits); two sweeps over the key tiles as in
// aug_bwd_dq_sm90_kernel, each of nc chunk steps per tile.
__global__ void __launch_bounds__(kThreads, 2) aug_bwd_dq_wide_sm90_kernel(AugBwdArgs w, int dk) {
  using Z = WideBytes;
  constexpr int NS = kTile / 8, KSV = kDv / 16, NDQ = kSplit / 8;
  constexpr int LDC = Z::LDC, LDV = Z::LDV;
  extern __shared__ __align__(128) unsigned char smem_wdq[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int c0 = blockIdx.z * kSplit, ncol = min(kSplit, dk - c0);
  const bool writes_delta = blockIdx.z == 0;
  const int nc = dk / kAugChunk, n_t = (w.nk + kTile - 1) / kTile, steps = 2 * n_t * nc;
  const int64_t rows = static_cast<int64_t>(bh) * w.nq;
  const bf16* qp = w.q + rows * dk;
  const bf16* kp = w.k + static_cast<int64_t>(bh) * w.nk * dk;
  const bf16* vp = w.v + static_cast<int64_t>(bh) * w.nk * kDv;
  // step (sweep, tile t, chunk c) into slot si as one commit group; past the
  // last step an empty group
  auto issue = [&](int si, int step) {
    if (step < steps) {
      const int k0 = (step / nc) % n_t * kTile, c = step % nc;
      unsigned char* slot = smem_wdq + si * Z::kDqSlot;
      copy_rows<kTile, kAugChunk, kThreads>(reinterpret_cast<bf16*>(slot), qp + c * kAugChunk,
                                            dk, q0, w.nq);
      copy_rows<kTile, kAugChunk, kThreads>(reinterpret_cast<bf16*>(slot + Z::kChunkTile),
                                            kp + c * kAugChunk, dk, k0, w.nk);
      if (c == nc - 1) {
        unsigned char* rest = slot + 2 * Z::kChunkTile;
        copy_rows<kTile, kDv, kThreads>(reinterpret_cast<bf16*>(rest), vp, kDv, k0, w.nk);
        for (int half = 0; half < ncol / kAugChunk; ++half)
          copy_rows<kTile, kAugChunk, kThreads>(
              reinterpret_cast<bf16*>(rest + Z::kOpV + half * Z::kChunkTile),
              kp + c0 + half * kAugChunk, dk, k0, w.nk);
      }
    }
    cp_async_commit();
  };
  issue(0, 0);

  const bool active = q0 + warp * 16 < w.nq;  // a row of this warp is in range
  const int row0 = warp * 16 + g;             // the thread's rows row0, row0 + 8
  uint32_t df[KSV][4];
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};  // lse * log2(e), delta
  if (active) {
    load_a_frags(df, w.dout + rows * kDv, kDv, q0 + warp * 16, w.nq);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + row0 + 8 * hr;
      lse2[hr] = qi < w.nq ? __ldg(w.lse + rows + qi) * kLog2e : 0.f;
    }
  }
  float dq[NDQ][4], s[NS][4];
#pragma unroll
  for (int n = 0; n < NDQ; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // this step's slot is full; every warp is done with the last one's
    issue((step + 1) % kRing, step + 1);
    if (!active) continue;
    const int tile = step / nc, c = step % nc;  // tile: 0 .. 2 n_t - 1 over both sweeps
    const bool first = tile < n_t;
    if (tile == n_t && c == 0) {  // the first sweep is done: the quad's sums are delta
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dlt[hr] += __shfl_xor_sync(0xffffffffu, dlt[hr], 1);
        dlt[hr] += __shfl_xor_sync(0xffffffffu, dlt[hr], 2);
        const int qi = q0 + row0 + 8 * hr;
        if (t4 == 0 && qi < w.nq && writes_delta) w.delta[rows + qi] = dlt[hr];
      }
    }
    const int valid = w.nk - (tile % n_t) * kTile;  // keys of this tile in range
    const unsigned char* slot = smem_wdq + (step % kRing) * Z::kDqSlot;
    const bf16* qc = reinterpret_cast<const bf16*>(slot);
    const bf16* kc = reinterpret_cast<const bf16*>(slot + Z::kChunkTile);
    // S += q_c K_c^T, q's A fragments by ldmatrix
    const bf16* qa_row = qc + (warp * 16 + (lane & 15)) * LDC + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kAugChunk / 16; kk += 2) {
      uint32_t qa[4], qb[4];
      ldsm_x4(qa, qa_row + kk * 16);
      ldsm_x4(qb, qa_row + kk * 16 + 16);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (n * 8 < valid) {
          uint32_t kb[4];
          ldsm_x4(kb, kc + (n * 8 + (lane & 7)) * LDC + kk * 16 + (lane >> 3) * 8);
          mma_bf16(s[n], qa, kb[0], kb[1]);
          mma_bf16(s[n], qb, kb[2], kb[3]);
        }
      }
    }
    if (c != nc - 1) continue;
    const bf16* vt = reinterpret_cast<const bf16*>(slot + 2 * Z::kChunkTile);
    const bf16* kcols = reinterpret_cast<const bf16*>(slot + 2 * Z::kChunkTile + Z::kOpV);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys: two 8-key column tiles
      if (kk * 16 >= valid) break;
      float dp[2][4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_rows<KSV, LDV>(dp[j], df, vt + (2 * kk + j) * 8 * LDV);
      uint32_t da[4];  // dS (bf16) as the A fragment of these 16 keys
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (2 * kk + j) * 8 + 2 * t4;  // the thread's key columns
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // P = 0 past Nk; delta += P dP, or dS = P (dP - delta)
          const int hr = i >> 1;
          const float pr =
              col + (i & 1) < valid ? exp2_ftz(s[2 * kk + j][i] * kLog2e - lse2[hr]) : 0.f;
          if (first) dlt[hr] += pr * dp[j][i];
          ds[i] = pr * (dp[j][i] - dlt[hr]);
        }
        da[2 * j] = pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      if (first) continue;
      // dq += dS K[:, c0 + ..]: the split's K columns by ldmatrix.trans
#pragma unroll
      for (int dn = 0; dn < NDQ; dn += 2) {
        if (dn * 8 < ncol) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, kcols + (dn / 8) * (kTile * LDC) + (kk * 16 + (lane & 15)) * LDC +
                                (dn % 8) * 8 + (lane >> 4) * 8);
          mma_bf16(dq[dn], da, kb[0], kb[1]);
          mma_bf16(dq[dn + 1], da, kb[2], kb[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  }
  cp_async_wait<0>();
  if (!active) return;

  // dq's Da lanes of the split (2-byte stores: Da-lane rows have no alignment)
  bf16* dqp = w.dq + rows * w.da;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    if (qi >= w.nq) continue;
#pragma unroll
    for (int n = 0; n < NDQ; ++n) {
      const int col = c0 + n * 8 + 2 * t4;
      if (col < w.da) dqp[qi * w.da + col] = __float2bfloat16(dq[n][2 * hr]);
      if (col + 1 < w.da) dqp[qi * w.da + col + 1] = __float2bfloat16(dq[n][2 * hr + 1]);
    }
  }
}

// The wide dk/dv pass: dk's columns [c0, c0 + 128) and, in the first split,
// dv. Grid (key tiles, B x H, segments of query tiles x dk's column splits).
__global__ void __launch_bounds__(kThreads, 2) aug_bwd_dkv_wide_sm90_kernel(AugBwdArgs w,
                                                                            int dk) {
  using Z = WideBytes;
  constexpr int NS = kTile / 8, KSV = kDv / 16, NDK = kSplit / 8, NDV = kDv / 8;
  constexpr int LDC = Z::LDC, LDV = Z::LDV;
  extern __shared__ __align__(128) unsigned char smem_wdkv[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int splits = (dk + kSplit - 1) / kSplit, seg = blockIdx.z / splits;
  const int c0 = static_cast<int>(blockIdx.z % splits) * kSplit, ncol = min(kSplit, dk - c0);
  const bool takes_dv = c0 == 0;
  const int nc = dk / kAugChunk;
  const int64_t qrows = static_cast<int64_t>(bh) * w.nq, krows = static_cast<int64_t>(bh) * w.nk;
  const bf16* qp = w.q + qrows * dk;
  const bf16* kp = w.k + krows * dk;
  const bf16* dop = w.dout + qrows * kDv;
  const float* lsep = w.lse + qrows;
  const float* dlp = w.delta + qrows;
  const int qtiles = (w.nq + kTile - 1) / kTile;
  const int qt0 = seg * w.qtiles_per_seg, qt1 = min(qtiles, qt0 + w.qtiles_per_seg);
  const int steps = max(0, qt1 - qt0) * nc;
  // step (query tile, chunk c) into slot si: the block's K chunk, the
  // tile's q chunk; on the last chunk dO, q's split columns, lse and delta
  auto issue = [&](int si, int step) {
    if (step < steps) {
      const int q0 = (qt0 + step / nc) * kTile, c = step % nc;
      unsigned char* slot = smem_wdkv + si * Z::kDkvSlot;
      copy_rows<kTile, kAugChunk, kThreads>(reinterpret_cast<bf16*>(slot), kp + c * kAugChunk,
                                            dk, k0, w.nk);
      copy_rows<kTile, kAugChunk, kThreads>(reinterpret_cast<bf16*>(slot + Z::kChunkTile),
                                            qp + c * kAugChunk, dk, q0, w.nq);
      if (c == nc - 1) {
        unsigned char* rest = slot + 2 * Z::kChunkTile;
        copy_rows<kTile, kDv, kThreads>(reinterpret_cast<bf16*>(rest), dop, kDv, q0, w.nq);
        for (int half = 0; half < ncol / kAugChunk; ++half)
          copy_rows<kTile, kAugChunk, kThreads>(
              reinterpret_cast<bf16*>(rest + Z::kOpV + half * Z::kChunkTile),
              qp + c0 + half * kAugChunk, dk, q0, w.nq);
        const int i = tid % kTile;  // threads 0-63 copy lse, 64-127 delta
        const float* src = tid < kTile ? lsep : dlp;
        const bool ok = q0 + i < w.nq;
        cp_async4(reinterpret_cast<float*>(slot + Z::kDqSlot) + tid, ok ? src + q0 + i : src,
                  ok);
      }
    }
    cp_async_commit();
  };
  issue(0, 0);

  const bool active = k0 + warp * 16 < w.nk;  // a key of this warp is in range
  const int key0 = warp * 16 + g;             // the thread's keys key0, key0 + 8
  uint32_t vf[KSV][4];                        // V's A fragments of the warp's keys
  if (active) load_a_frags(vf, w.v + krows * kDv, kDv, k0 + warp * 16, w.nk);
  float dkacc[NDK][4], dv[NDV][4], st[NS][4];
#pragma unroll
  for (int n = 0; n < NDK; ++n) dkacc[n][0] = dkacc[n][1] = dkacc[n][2] = dkacc[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NDV; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // this step's slot is full; every warp is done with the last one's
    issue((step + 1) % kRing, step + 1);
    if (!active) continue;
    const int c = step % nc;
    const int valid = w.nq - (qt0 + step / nc) * kTile;  // queries of this tile in range
    const unsigned char* slot = smem_wdkv + (step % kRing) * Z::kDkvSlot;
    const bf16* kc = reinterpret_cast<const bf16*>(slot);
    const bf16* qc = reinterpret_cast<const bf16*>(slot + Z::kChunkTile);
    // S^T += K_c q_c^T, K's A fragments of the warp's 16 keys by ldmatrix
    const bf16* ka_row = kc + (warp * 16 + (lane & 15)) * LDC + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kAugChunk / 16; kk += 2) {
      uint32_t ka[4], kb2[4];
      ldsm_x4(ka, ka_row + kk * 16);
      ldsm_x4(kb2, ka_row + kk * 16 + 16);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (n * 8 < valid) {
          uint32_t qb[4];
          ldsm_x4(qb, qc + (n * 8 + (lane & 7)) * LDC + kk * 16 + (lane >> 3) * 8);
          mma_bf16(st[n], ka, qb[0], qb[1]);
          mma_bf16(st[n], kb2, qb[2], qb[3]);
        }
      }
    }
    if (c != nc - 1) continue;
    const bf16* dt = reinterpret_cast<const bf16*>(slot + 2 * Z::kChunkTile);
    const bf16* qcols = reinterpret_cast<const bf16*>(slot + 2 * Z::kChunkTile + Z::kOpV);
    const float* lse_s = reinterpret_cast<const float*>(slot + Z::kDqSlot);
    const float* dlt_s = lse_s + kTile;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries: two 8-query column tiles
      if (kk * 16 >= valid) break;
      float dpt[2][4] = {};  // dP^T = V dO^T of both column tiles
#pragma unroll
      for (int ks2 = 0; ks2 < KSV; ++ks2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t db[2];
          ldsm_x2(db, dt + ((2 * kk + j) * 8 + (lane & 7)) * LDV + ks2 * 16 +
                        ((lane >> 3) & 1) * 8);
          mma_bf16(dpt[j], vf[ks2], db[0], db[1]);
        }
      }
      uint32_t pa[4], da[4];  // P^T and dS^T (bf16) as A fragments of these 16 queries
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (2 * kk + j) * 8 + 2 * t4;  // the thread's query columns
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + col);
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // P^T, dS^T = P^T (dP^T - delta); 0 past Nq
          const int e = i & 1;
          p[i] = col + e < valid
                     ? exp2_ftz((st[2 * kk + j][i] - (e ? l2.y : l2.x)) * kLog2e)
                     : 0.f;
          ds[i] = p[i] * (dpt[j][i] - (e ? d2.y : d2.x));
        }
        pa[2 * j] = pack_bf16(p[0], p[1]);
        pa[2 * j + 1] = pack_bf16(p[2], p[3]);
        da[2 * j] = pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dv += P^T dO, dk += dS^T q[:, c0 + ..]: B fragments by ldmatrix.trans
      if (takes_dv) {
#pragma unroll
        for (int dn = 0; dn < NDV; dn += 2) {
          uint32_t ob[4];
          ldsm_x4_trans(ob, dt + (kk * 16 + (lane & 15)) * LDV + dn * 8 + (lane >> 4) * 8);
          mma_bf16(dv[dn], pa, ob[0], ob[1]);
          mma_bf16(dv[dn + 1], pa, ob[2], ob[3]);
        }
      }
#pragma unroll
      for (int dn = 0; dn < NDK; dn += 2) {
        if (dn * 8 < ncol) {
          uint32_t qb[4];
          ldsm_x4_trans(qb, qcols + (dn / 8) * (kTile * LDC) + (kk * 16 + (lane & 15)) * LDC +
                                (dn % 8) * 8 + (lane >> 4) * 8);
          mma_bf16(dkacc[dn], da, qb[0], qb[1]);
          mma_bf16(dkacc[dn + 1], da, qb[2], qb[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
  }
  cp_async_wait<0>();  // an empty segment leaves its first copies in flight
  if (!active) return;

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + key0 + 8 * hr;
    if (kj >= w.nk) continue;
    const int64_t row = krows + kj;
    if (w.segments == 1) {  // dk's Da lanes by 2-byte stores; dv's as pairs
#pragma unroll
      for (int n = 0; n < NDK; ++n) {
        const int col = c0 + n * 8 + 2 * t4;
        if (col < w.da) w.dk[row * w.da + col] = __float2bfloat16(dkacc[n][2 * hr]);
        if (col + 1 < w.da) w.dk[row * w.da + col + 1] = __float2bfloat16(dkacc[n][2 * hr + 1]);
      }
      if (takes_dv) {
#pragma unroll
        for (int n = 0; n < NDV; ++n)
          *reinterpret_cast<uint32_t*>(w.dv + row * kDv + n * 8 + 2 * t4) =
              pack_bf16(dv[n][2 * hr], dv[n][2 * hr + 1]);
      }
    } else {
      const int64_t prow = static_cast<int64_t>(seg) * gridDim.y * w.nk + row;
#pragma unroll
      for (int n = 0; n < NDK; ++n)
        if (n * 8 < ncol)
          *reinterpret_cast<float2*>(w.dk_part + prow * dk + c0 + n * 8 + 2 * t4) =
              make_float2(dkacc[n][2 * hr], dkacc[n][2 * hr + 1]);
      if (takes_dv) {
#pragma unroll
        for (int n = 0; n < NDV; ++n)
          *reinterpret_cast<float2*>(w.dv_part + prow * kDv + n * 8 + 2 * t4) =
              make_float2(dv[n][2 * hr], dv[n][2 * hr + 1]);
      }
    }
  }
}

// The wide form's sums of the segments' partials (dk rows of dk lanes, a
// run-time width), as aug_bwd_reduce_kernel.
__global__ void __launch_bounds__(256) aug_bwd_reduce_wide_kernel(AugBwdArgs w, int bh_count,
                                                                  int dk) {
  const int vk = dk / 8, vv = kDv / 8;  // 8-column groups of a dk and a dv row
  const int64_t rows = static_cast<int64_t>(bh_count) * w.nk;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= rows * (vk + vv)) return;
  const bool is_v = i >= rows * vk;
  const int width = is_v ? kDv : dk;
  const int64_t e = is_v ? i - rows * vk : i;
  const int64_t row = e / (is_v ? vv : vk);
  const int c = static_cast<int>(e % (is_v ? vv : vk)) * 8;
  const float* part = (is_v ? w.dv_part : w.dk_part) + row * width + c;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sgm = 0; sgm < w.segments; ++sgm) {
    const float4 lo = *reinterpret_cast<const float4*>(part + sgm * rows * width);
    const float4 hi = *reinterpret_cast<const float4*>(part + sgm * rows * width + 4);
    acc[0] += lo.x, acc[1] += lo.y, acc[2] += lo.z, acc[3] += lo.w;
    acc[4] += hi.x, acc[5] += hi.y, acc[6] += hi.z, acc[7] += hi.w;
  }
  if (is_v) {
    *reinterpret_cast<uint4*>(w.dv + row * kDv + c) =
        make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                   pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + j < w.da) w.dk[row * w.da + c + j] = __float2bfloat16(acc[j]);
}

cudaError_t launch_wide(AugBwdArgs w, const bf16* q, const bf16* k, bf16* pad, int bh,
                        cudaStream_t stream) {
  using Z = WideBytes;
  const int dk = aug_width(w.da);
  // 0. q and k into zero-filled dk-lane rows
  bf16* qpad = pad;
  bf16* kpad = pad + static_cast<int64_t>(bh) * w.nq * dk;
  cudaError_t err = sm90::launch_aug_pad_wide(q, qpad, static_cast<int64_t>(bh) * w.nq, w.da,
                                              dk, stream);
  if (err == cudaSuccess)
    err = sm90::launch_aug_pad_wide(k, kpad, static_cast<int64_t>(bh) * w.nk, w.da, dk, stream);
  if (err != cudaSuccess) return err;
  w.q = qpad;
  w.k = kpad;
  const int qtiles = (w.nq + kTile - 1) / kTile, ktiles = (w.nk + kTile - 1) / kTile;
  const int splits = (dk + kSplit - 1) / kSplit;
  w.qtiles_per_seg = (qtiles + w.segments - 1) / w.segments;
  if ((err = allow_smem(aug_bwd_dq_wide_sm90_kernel, Z::kDq)) != cudaSuccess) return err;
  aug_bwd_dq_wide_sm90_kernel<<<dim3(qtiles, bh, splits), kThreads, Z::kDq, stream>>>(w, dk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(aug_bwd_dkv_wide_sm90_kernel, Z::kDkv)) != cudaSuccess) return err;
  aug_bwd_dkv_wide_sm90_kernel<<<dim3(ktiles, bh, w.segments * splits), kThreads, Z::kDkv,
                                 stream>>>(w, dk);
  if ((err = cudaGetLastError()) != cudaSuccess || w.segments == 1) return err;
  const int64_t threads = static_cast<int64_t>(bh) * w.nk * (dk / 8 + kDv / 8);
  aug_bwd_reduce_wide_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      w, bh, dk);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

cudaError_t attention_aug_bwd_sm90(const void* q, const void* k, const void* v,
                                   const float* lse, const void* dout, void* dq, void* dk,
                                   void* dv, float* delta, float* dk_part, float* dv_part,
                                   void* pad, int segments, int bh, int nq, int nk, int da,
                                   cudaStream_t stream) {
  // 16-byte rows of v and dO (the ring's copies), of the padded rows and of
  // the partials; 4-byte pairs of dv and the lse and delta words
  if (segments <= 0 || aug_width(da) == 0 || pad == nullptr ||
      (segments > 1 && (dk_part == nullptr || dv_part == nullptr)))
    return cudaErrorInvalidValue;
  if (!aligned(v, 16) || !aligned(dout, 16) || !aligned(pad, 16) || !aligned(dv, 16) ||
      !aligned(lse, 4) || !aligned(delta, 4) ||
      (segments > 1 && (!aligned(dk_part, 16) || !aligned(dv_part, 16))))
    return cudaErrorMisalignedAddress;
  AugBwdArgs w{};
  w.v = static_cast<const bf16*>(v);
  w.dout = static_cast<const bf16*>(dout);
  w.lse = lse;
  w.delta = delta;
  w.dq = static_cast<bf16*>(dq);
  w.dk = static_cast<bf16*>(dk);
  w.dv = static_cast<bf16*>(dv);
  w.dk_part = dk_part;
  w.dv_part = dv_part;
  w.nq = nq;
  w.nk = nk;
  w.da = da;
  w.segments = segments;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  bf16* pb = static_cast<bf16*>(pad);
  switch (aug_width(da)) {
    case 128: return launch<128>(w, qb, kb, pb, bh, stream);
    case 144: return launch<144>(w, qb, kb, pb, bh, stream);
    case 176: return launch<176>(w, qb, kb, pb, bh, stream);
    case 192: return launch<192>(w, qb, kb, pb, bh, stream);
    case 256: return launch<256>(w, qb, kb, pb, bh, stream);
    default: return launch_wide(w, qb, kb, pb, bh, stream);
  }
}

}  // namespace mspi
