// The bf16 backward of K4 (self_attention.cu: SyncBlock's multi-head
// self-attention on packed lanes), register-resident on the tensor cores and
// fed by asynchronous copies:
//   S = scale q k^T,  P = exp(S - lse),  O = P v,  scale = 1 / sqrt(D),
//   dv = P^T dO,  dP = dO v^T,  dS = P * (dP - rowsum(dO * O)),
//   dq = scale dS k,  dk = scale dS^T q
// per (batch, head), read and written in place through K4's packed strides:
// q, out, dout, dq [B, N, C] and kv, dkv [B, N, 2C] (k then v, head-major
// lanes). lse is the forward's (flash_attention_sm90.cuh) fp32 row
// log-sum-exp. dS is rounded to bf16 where it enters a product, as the TPU
// kernel rounds it to v's dtype, and P where it enters dv.
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::_bwd_impl (kernel
// _bwd_kernel) as fused_self_attention's backward, the 3 SyncBlock blocks of
// both models' training step (N = 708, D = 128, 4 heads). Entered through
// attention_bwd.cu's mspi_self_attention_bwd, whose fp32 branch keeps the FMA
// passes; row 7's head-major form (row 6's backward, DK != DV) keeps the
// WMMA passes there. The TPU kernel holds a whole [TQ, Nk] score tile and
// carries dk and dv across its sequential grid in VMEM. Blocks on the card
// run in no order, so the work is attention_rel_bwd_sm90.cu's two passes
// without the rel chain, none with atomics, each a grid of blocks of 4 warps
// with 16 rows per warp (m16n8k16 mma.sync, bf16 in, fp32 accumulate) and
// 64-row tiles of the other side through a 2-slot cp.async ring with one
// barrier per tile:
//   1. dq + delta: one block per (64-query tile, b x h) of two groups of 4
//      warps, each group on the block's 64 rows and every other key tile
//      (a ring slot holds both groups' tiles), so that an SM runs 8 warps
//      where the grid has fewer blocks than SMs (96 at batch 2). q and dO
//      stay in registers as A fragments; the prologue computes delta =
//      rowsum(dO * O) and writes it for pass 2. Per key tile S and dP are
//      recomputed 16 keys at a time in accumulator fragments, and dS is
//      repacked into A fragments for dq += dS K (K's B fragments by
//      ldmatrix.trans). Group 1 hands its sums to group 0 through shared
//      memory, which adds them in that order and writes dq once, scaled, in
//      bf16.
//   2. dk + dv: one block per (64-key tile, b x h, segment of query tiles),
//      each warp owning 16 keys. Per query tile (q, dO, lse and delta
//      through the ring) S^T = scale K q^T and dP^T = V dO^T land in the
//      layout that repacks into A fragments for dv += P^T dO and dk += dS^T
//      q. With one segment dk (scaled) and dv are written in bf16; with more,
//      fp32 partials [segments, B*H, N, D] that self_bwd_reduce_kernel sums
//      in segment order, 8 columns a thread (the segments fill the card:
//      pooled_attention.self_bwd_segments).
// Every output element has one writer and a fixed summation order, so two
// runs give bit-identical dq, dk and dv. Ragged tiles are zero-filled by the
// copies and P is 0 past N.
//
// Registers set the form (pooled_attention.self_bwd_form mirrors it):
//   D = 64 (UniFormer-B's stages 3-4: N = 2688 and 672 at 224x384) and 96:
//     the dk/dv pass keeps its keys' K and V A fragments in registers (32 or
//     48) beside dk and dv (64 or 96), as row 5's passes do.
//   D = 128: K and V (64 registers) beside dk and dv (128) would pass the
//     255-register cap, so the block's 64 K and V rows are copied once into
//     shared memory and each warp reads its A fragments by ldmatrix per use,
//     two k-steps at a time, for both 8-query column tiles of a 16-query
//     step.
// The dq pass (q, dO and dq: 128 registers at D = 128) runs one block of 8
// warps per SM.
//
// What bounds it on the card: 10 D flops per (query, key) pair (S twice, dP
// twice, dq, dk, dv) against q, kv, dO read once per tile of the other side:
// the tensor cores, far from their peak at these tile sizes; at batch 2 the
// dq pass has 96 blocks for 132 SMs (PERF.md).

#include "attention_bwd_sm90.cuh"

namespace mspi {
namespace {

using sm90::at;
using sm90::copy_rows;
using sm90::exp2_ftz;
using sm90::kLog2e;
using sm90::ldsm_x4;
using sm90::ldsm_x4_trans;
using sm90::load_a_frags;
using sm90::mma_bf16;

constexpr int kThreads = sm90::kBwdThreads;
constexpr int kTile = sm90::kBwdTile;
constexpr int kRing = sm90::kStages;

// K and V A fragments of the dk/dv pass from shared memory above D = 96.
__host__ __device__ constexpr bool kv_in_smem(int d) { return d > 96; }

// Byte sizes of the shared-memory regions at head dim D.
template <int D>
struct SelfBytes {
  static constexpr int LD = D + 8;                          // bf16 pitch of operand rows
  static constexpr int kOp = sizeof(bf16) * kTile * LD;     // one [64][D] operand tile
  static constexpr int kStats = 2 * sizeof(float) * kTile;  // 64 rows' lse and delta
  static constexpr int kDq = kRing * 2 * 2 * kOp;  // the ring of two (K, V) tiles a slot
  static constexpr int kDkvSlot = 2 * kOp + kStats;         // q, dO, lse and delta
  static constexpr int kDkv = kRing * kDkvSlot + (kv_in_smem(D) ? 2 * kOp : 0);
  static_assert(kOp % 16 == 0, "16-byte regions");
};

// The dq pass: two groups of 4 warps on the block's 64 query rows, group g
// taking the key tiles t = g mod 2, each step's slot holding both tiles.
constexpr int kDqGroups = 2;
constexpr int kDqThreads = kDqGroups * kThreads;

// Pass 1: dq and delta. Grid (query tiles, B x H).
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1) self_bwd_dq_sm90_kernel(RelBwdArgs w) {
  using Z = SelfBytes<D>;
  constexpr int KS = D / 16, ND = D / 8, LD = Z::LD;
  extern __shared__ __align__(128) unsigned char smem_sdq[];
  const AttnArgs& a = w.f;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int grp = tid / kThreads, gtid = tid % kThreads, warp = gtid >> 5;
  const int bh = blockIdx.y, h = bh % a.heads, b = bh / a.heads;
  const int q0 = blockIdx.x * kTile;
  // key tiles 2 p and 2 p + 1 (K and V rows) into slot si as one commit group
  auto issue = [&](int si, int p) {
#pragma unroll
    for (int e = 0; e < kDqGroups; ++e) {
      const int k0 = (kDqGroups * p + e) * kTile;
      if (k0 < a.nk) {
        bf16* tile = reinterpret_cast<bf16*>(smem_sdq + (si * kDqGroups + e) * 2 * Z::kOp);
        copy_rows<kTile, D, kDqThreads>(tile, at(a.k, a.ks, b, h), a.ks.n, k0, a.nk);
        copy_rows<kTile, D, kDqThreads>(tile + kTile * LD, at(a.v, a.vs, b, h), a.vs.n, k0,
                                        a.nk);
      }
    }
    cp_async_commit();
  };
  issue(0, 0);

  const bool active = q0 + warp * 16 < a.nq;  // a row of this warp is in range
  const int row0 = warp * 16 + g;             // the thread's rows row0, row0 + 8
  uint32_t qf[KS][4], df[KS][4];
  // the rows' lse * log2(e) (x, y: rows row0, row0 + 8) and delta (z, w),
  // computed by group 0 (which writes delta for pass 2) for both groups
  __shared__ float4 row_stats[kThreads];
  if (active) {
    const bf16* dop = at(w.dout, a.os, b, h);
    load_a_frags(qf, at(a.q, a.qs, b, h), a.qs.n, q0 + warp * 16, a.nq);
    load_a_frags(df, dop, a.os.n, q0 + warp * 16, a.nq);
    if (grp == 0) {
      const int64_t rows = static_cast<int64_t>(bh) * a.nq;
      float lse2[2], dlt[2];
      sm90::row_stats<D>(at(a.out, a.os, b, h), dop, a.os.n, a.lse + rows, w.delta + rows,
                         q0 + row0, a.nq, lse2, dlt);
      row_stats[gtid] = make_float4(lse2[0], lse2[1], dlt[0], dlt[1]);
    }
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float scale2 = a.scale * kLog2e;

  const int n_t = (a.nk + kTile - 1) / kTile, n_p = (n_t + kDqGroups - 1) / kDqGroups;
  for (int p = 0; p < n_p; ++p) {
    cp_async_wait<0>();
    __syncthreads();  // step p's slot is full; every warp is done with p - 1's slot
    issue((p + 1) % kRing, p + 1);
    const int k0 = (kDqGroups * p + grp) * kTile;
    if (!active || k0 >= a.nk) continue;
    const bf16* kt =
        reinterpret_cast<const bf16*>(smem_sdq + ((p % kRing) * kDqGroups + grp) * 2 * Z::kOp);
    const bf16* vt = kt + kTile * LD;
    const int valid = a.nk - k0;  // keys of this tile in range (may exceed kTile)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys: two 8-key column tiles
      if (kk * 16 >= valid) break;
      uint32_t da[4];  // dS (bf16) as the A fragment of these 16 keys
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 2 * kk + j;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k2 = 0; k2 < KS; k2 += 2) {  // S = q K^T, dP = dO V^T
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, kt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
          ldsm_x4(vb, vt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
          mma_bf16(s, qf[k2], kb[0], kb[1]);
          mma_bf16(s, qf[k2 + 1], kb[2], kb[3]);
          mma_bf16(dp, df[k2], vb[0], vb[1]);
          mma_bf16(dp, df[k2 + 1], vb[2], vb[3]);
        }
        const int c = n * 8 + 2 * t4;  // the thread's key columns c, c + 1
        const float4 st = row_stats[gtid];
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // dS = P (dP - delta), P = 0 past N
          const float lse2 = i < 2 ? st.x : st.y, dlt = i < 2 ? st.z : st.w;
          const float pr = c + (i & 1) < valid ? exp2_ftz(s[i] * scale2 - lse2) : 0.f;
          ds[i] = pr * (dp[i] - dlt);
        }
        da[2 * j] = pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dq += dS K: K's rows of these keys by ldmatrix.trans
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, kt + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
        mma_bf16(dq[dn], da, kb[0], kb[1]);
        mma_bf16(dq[dn + 1], da, kb[2], kb[3]);
      }
    }
  }
  // group 1's sums into the ring (element e of its thread t at e * 128 + t),
  // then group 0 adds them to its own in that fixed order and writes dq
  cp_async_wait<0>();
  __syncthreads();
  float* stash = reinterpret_cast<float*>(smem_sdq);
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) stash[(4 * n + e) * kThreads + gtid] = dq[n][e];
  }
  __syncthreads();
  if (grp == 1 || !active) return;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] += stash[(4 * n + e) * kThreads + gtid];

  bf16* dqp = static_cast<bf16*>(w.dq) + b * a.qs.b + h * a.qs.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    if (qi >= a.nq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqp + qi * a.qs.n + n * 8 + 2 * t4) =
          pack_bf16(dq[n][2 * hr] * a.scale, dq[n][2 * hr + 1] * a.scale);
  }
}

// The A fragments of k-steps k2, k2 + 1 of the warp's 16 keys of one operand:
// from the registers (f) or, above D = 96, by ldmatrix from the block's
// resident rows at `row` (the lane's row, its 8-column half).
template <int D, int KS>
__device__ __forceinline__ void kv_frags(uint32_t (&x)[2][4], const uint32_t (&f)[KS][4],
                                         const bf16* row, int k2) {
  if constexpr (kv_in_smem(D)) {
    ldsm_x4(x[0], row + k2 * 16);
    ldsm_x4(x[1], row + k2 * 16 + 16);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[0][e] = f[k2][e];
      x[1][e] = f[k2 + 1][e];
    }
  }
}

// Pass 2: dk and dv. Grid (key tiles, B x H, segments of query tiles).
template <int D>
__global__ void __launch_bounds__(kThreads, 2) self_bwd_dkv_sm90_kernel(RelBwdArgs w) {
  using Z = SelfBytes<D>;
  constexpr bool SMEM_KV = kv_in_smem(D);
  constexpr int KS = D / 16, ND = D / 8, LD = Z::LD, FK = SMEM_KV ? 1 : KS;
  extern __shared__ __align__(128) unsigned char smem_sdkv[];
  const AttnArgs& a = w.f;
  constexpr int stats_at = 2 * Z::kOp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, h = bh % a.heads, b = bh / a.heads;
  const int k0 = blockIdx.x * kTile, seg = blockIdx.z;
  const bf16* qp = at(a.q, a.qs, b, h);
  const bf16* dop = at(w.dout, a.os, b, h);
  const float* lsep = a.lse + static_cast<int64_t>(bh) * a.nq;
  const float* dlp = w.delta + static_cast<int64_t>(bh) * a.nq;
  // above D = 96: the block's K and V rows [2][64][LD] after the ring
  bf16* kvs = reinterpret_cast<bf16*>(smem_sdkv + kRing * Z::kDkvSlot);
  if constexpr (SMEM_KV) {  // one commit group of their own, ahead of the ring's
    copy_rows<kTile, D, kThreads>(kvs, at(a.k, a.ks, b, h), a.ks.n, k0, a.nk);
    copy_rows<kTile, D, kThreads>(kvs + kTile * LD, at(a.v, a.vs, b, h), a.vs.n, k0, a.nk);
    cp_async_commit();
  }

  // query tile q0 (q, dO, lse and delta) into slot si as one commit group;
  // q0 >= N (past the segment) commits an empty group
  auto issue = [&](int si, int q0) {
    if (q0 < a.nq) {
      unsigned char* slot = smem_sdkv + si * Z::kDkvSlot;
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot), qp, a.qs.n, q0, a.nq);
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot + Z::kOp), dop, a.os.n, q0,
                                    a.nq);
      const int i = tid % kTile;  // threads 0-63 copy lse, 64-127 delta
      const float* src = tid < kTile ? lsep : dlp;
      const bool ok = q0 + i < a.nq;
      cp_async4(reinterpret_cast<float*>(slot + stats_at) + tid, ok ? src + q0 + i : src, ok);
    }
    cp_async_commit();
  };
  const int qtiles = (a.nq + kTile - 1) / kTile;
  const int qt0 = seg * w.qtiles_per_seg, qt1 = min(qtiles, qt0 + w.qtiles_per_seg);
  issue(0, qt0 * kTile);

  const bool active = k0 + warp * 16 < a.nk;  // a key of this warp is in range
  const int key0 = warp * 16 + g;             // the thread's keys key0, key0 + 8
  uint32_t kf[FK][4], vf[FK][4];              // D = 96: K's and V's A fragments
  if constexpr (!SMEM_KV) {
    if (active) {
      load_a_frags(kf, at(a.k, a.ks, b, h), a.ks.n, k0 + warp * 16, a.nk);
      load_a_frags(vf, at(a.v, a.vs, b, h), a.vs.n, k0 + warp * 16, a.nk);
    }
  }
  // the lane's row of the resident K and V tiles for their A fragments
  const bf16* ka_row = kvs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* va_row = ka_row + kTile * LD;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float scale2 = a.scale * kLog2e;

  for (int t = 0, qt = qt0; qt < qt1; ++t, ++qt) {
    cp_async_wait<0>();
    __syncthreads();  // tile t's slot is full; every warp is done with t - 1's slot
    issue((t + 1) % kRing, qt + 1 < qt1 ? (qt + 1) * kTile : a.nq);  // a.nq: none
    if (!active) continue;
    const unsigned char* slot = smem_sdkv + (t % kRing) * Z::kDkvSlot;
    const bf16* qt_s = reinterpret_cast<const bf16*>(slot);
    const bf16* dt = reinterpret_cast<const bf16*>(slot + Z::kOp);
    const float* lse_s = reinterpret_cast<const float*>(slot + stats_at);
    const float* dlt_s = lse_s + kTile;
    const int valid = a.nq - qt * kTile;  // queries of this tile in range (may exceed kTile)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries: two 8-query column tiles
      if (kk * 16 >= valid) break;
      // S^T = K q^T, dP^T = V dO^T of both column tiles, K's and V's A
      // fragments two k-steps at a time
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int k2 = 0; k2 < KS; k2 += 2) {
        uint32_t ka[2][4], va[2][4];
        kv_frags<D>(ka, kf, ka_row, k2);
        kv_frags<D>(va, vf, va_row, k2);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 2 * kk + j;
          uint32_t qb[4], db[4];
          ldsm_x4(qb, qt_s + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
          ldsm_x4(db, dt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
          mma_bf16(st[j], ka[0], qb[0], qb[1]);
          mma_bf16(st[j], ka[1], qb[2], qb[3]);
          mma_bf16(dpt[j], va[0], db[0], db[1]);
          mma_bf16(dpt[j], va[1], db[2], db[3]);
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
        for (int i = 0; i < 4; ++i) {  // P^T, dS^T = P^T (dP^T - delta); 0 past N
          const int e = i & 1;
          p[i] = c + e < valid
                     ? exp2_ftz(st[j][i] * scale2 - (e ? l2.y : l2.x) * kLog2e)
                     : 0.f;
          ds[i] = p[i] * (dpt[j][i] - (e ? d2.y : d2.x));
        }
        pa[2 * j] = pack_bf16(p[0], p[1]);
        pa[2 * j + 1] = pack_bf16(p[2], p[3]);
        da[2 * j] = pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dv += P^T dO, dk += dS^T q: dO's and q's B fragments by ldmatrix.trans
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t ob[4], qb[4];
        ldsm_x4_trans(ob, dt + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
        ldsm_x4_trans(qb, qt_s + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
        mma_bf16(dv[dn], pa, ob[0], ob[1]);
        mma_bf16(dv[dn + 1], pa, ob[2], ob[3]);
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
    if (kj >= a.nk) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t4;
      if (w.segments == 1) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(w.dk) + b * a.ks.b + h * a.ks.h +
                                     kj * a.ks.n + col) =
            pack_bf16(dk[n][2 * hr] * a.scale, dk[n][2 * hr + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(w.dv) + b * a.vs.b + h * a.vs.h +
                                     kj * a.vs.n + col) =
            pack_bf16(dv[n][2 * hr], dv[n][2 * hr + 1]);
      } else {
        const int64_t at_el =
            ((static_cast<int64_t>(seg) * gridDim.y + bh) * a.nk + kj) * D + col;
        *reinterpret_cast<float2*>(w.dk_part + at_el) =
            make_float2(dk[n][2 * hr], dk[n][2 * hr + 1]);
        *reinterpret_cast<float2*>(w.dv_part + at_el) =
            make_float2(dv[n][2 * hr], dv[n][2 * hr + 1]);
      }
    }
  }
}

// With segments > 1: dk = scale * sum of the segments' partials, dv = their
// sum, in segment order, into the packed bf16 lanes. One thread per 8
// columns of a row: two 16-byte loads per segment, one 16-byte store.
template <int D>
__global__ void __launch_bounds__(256) self_bwd_reduce_kernel(RelBwdArgs w, int bh_count) {
  constexpr int V = D / 8;  // 8-column groups of a row
  const AttnArgs& a = w.f;
  const int64_t rows = static_cast<int64_t>(bh_count) * a.nk;  // rows of dk (and of dv)
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= 2 * rows * V) return;
  const bool is_v = i >= rows * V;
  const int64_t row = (is_v ? i - rows * V : i) / V;
  const int c = static_cast<int>(i % V) * 8;
  const float* part = (is_v ? w.dv_part : w.dk_part) + row * D + c;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sgm = 0; sgm < w.segments; ++sgm) {
    const float4 lo = *reinterpret_cast<const float4*>(part + sgm * rows * D);
    const float4 hi = *reinterpret_cast<const float4*>(part + sgm * rows * D + 4);
    acc[0] += lo.x, acc[1] += lo.y, acc[2] += lo.z, acc[3] += lo.w;
    acc[4] += hi.x, acc[5] += hi.y, acc[6] += hi.z, acc[7] += hi.w;
  }
  const float sc = is_v ? 1.f : a.scale;
  const int bh = static_cast<int>(row / a.nk), j = static_cast<int>(row % a.nk);
  const int b = bh / a.heads, h = bh % a.heads;
  const AttnStrides& st = is_v ? a.vs : a.ks;
  bf16* out = static_cast<bf16*>(is_v ? w.dv : w.dk) + b * st.b + h * st.h + j * st.n + c;
  *reinterpret_cast<uint4*>(out) =
      make_uint4(pack_bf16(acc[0] * sc, acc[1] * sc), pack_bf16(acc[2] * sc, acc[3] * sc),
                 pack_bf16(acc[4] * sc, acc[5] * sc), pack_bf16(acc[6] * sc, acc[7] * sc));
}

template <int D>
cudaError_t launch(RelBwdArgs w, int batch, cudaStream_t stream) {
  using Z = SelfBytes<D>;
  const AttnArgs& a = w.f;
  const int bh = batch * a.heads;
  const int qtiles = (a.nq + kTile - 1) / kTile, ktiles = (a.nk + kTile - 1) / kTile;
  w.qtiles_per_seg = (qtiles + w.segments - 1) / w.segments;
  cudaError_t err = allow_smem(self_bwd_dq_sm90_kernel<D>, Z::kDq);
  if (err != cudaSuccess) return err;
  self_bwd_dq_sm90_kernel<D><<<dim3(qtiles, bh), kDqThreads, Z::kDq, stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(self_bwd_dkv_sm90_kernel<D>, Z::kDkv)) != cudaSuccess) return err;
  self_bwd_dkv_sm90_kernel<D><<<dim3(ktiles, bh, w.segments), kThreads, Z::kDkv, stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess || w.segments == 1) return err;
  const int64_t threads = 2 * static_cast<int64_t>(bh) * a.nk * (D / 8);
  self_bwd_reduce_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      w, bh);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

cudaError_t self_attention_bwd_sm90(const RelBwdArgs& w, int batch, int d,
                                    cudaStream_t stream) {
  const AttnArgs& a = w.f;
  // 16-byte rows of every operand the ring or the prologue reads in chunks
  // (q, k, v, out, dout), 4-byte pairs of dq, dk, dv and the lse and delta
  // words; with segments, 16-byte runs of the partials and of dk and dv
  if (w.segments <= 0 || a.nq != a.nk ||
      (w.segments > 1 && (!aligned(w.dk_part, 16) || !aligned(w.dv_part, 16) ||
                          !aligned(w.dk, 16) || !aligned(w.dv, 16))))
    return cudaErrorInvalidValue;
  if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16) || !aligned(a.out, 16) ||
      !aligned(w.dout, 16) || !aligned(w.dq, 4) || !aligned(w.dk, 4) || !aligned(w.dv, 4) ||
      !aligned(a.lse, 4) || !aligned(w.delta, 4))
    return cudaErrorMisalignedAddress;
  if (d == 64) return launch<64>(w, batch, stream);
  if (d == 96) return launch<96>(w, batch, stream);
  if (d == 128) return launch<128>(w, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mspi
