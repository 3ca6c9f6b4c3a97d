// The bf16 backward of K1 (attention_rel.cu: MViT pooled attention with the
// decomposed rel-pos bias), register-resident on the tensor cores and fed by
// asynchronous copies:
//   S = scale q k^T + rel E^T,  P = exp(S - lse),  O = P v,
//   dv = P^T dO,  dP = dO v^T,  dS = P * (dP - rowsum(dO * O)),
//   dq = scale dS k,  dk = scale dS^T q,  drel = dS E
// per (batch, head), head-major q, dq, out, dout [B, H, Nq, D], k, v, dk, dv
// [B, H, Nk, D], rel, drel [B, H, Nq, R]; E [Nk, R] is the 0/1 expansion of
// the key's (t, h, w) onto the rel columns t | h | w (no gradient). lse is
// the forward's (flash_attention_sm90.cuh) fp32 row log-sum-exp. dS is rounded
// to bf16 where it enters a product, as the TPU kernel rounds ds_c, and P
// where it enters dv.
//
// Replaces: mspi_tpu/ops/pallas/pooled_attention.py::_bwd_impl_rel (kernel
// _bwd_kernel_rel), the backward of all 16 MViTv2-S blocks, and of row 8
// after a layout change. Entered through attention_bwd.cu's
// mspi_attention_rel_bwd, whose fp32 branch keeps the FMA passes. The TPU
// kernel holds a whole [TQ, Nk] score tile and carries dk and dv across its
// sequential grid in VMEM, and takes drel as the last R lanes of ds_c @ [k |
// E]. Blocks on the card run in no order, so the work is three passes as
// window_attention_bwd.cu's, none with atomics, each a grid of blocks of 4
// warps with 16 rows per warp (m16n8k16 mma.sync, bf16 in, fp32 accumulate)
// and 64-row tiles through a 2-slot cp.async ring with one barrier per tile:
//   1. dq + delta + drel: one block per (64-query tile, b x h). q and dO stay
//      in registers as A fragments; the prologue computes delta =
//      rowsum(dO * O) and writes it out, and copies the block's rel rows to
//      shared memory at a pitch of 16 RS columns (2-byte loads: a row of R =
//      27 elements is not 16-byte aligned), and to the rel_pad scratch [B*H,
//      Nq, 16 RS] for pass 2. Per key tile, K and V come through the ring and
//      one thread per key writes its E row into the slot (from the key's (t,
//      h, w), walked without division, as the forward writes it). S is
//      recomputed in the forward's form (scale on the fp32 Q K^T accumulator,
//      plus rel E^T on a chain of its own), 16 keys at a time; S, P, dP and
//      dS live in accumulator fragments, and dS is repacked into A
//      fragments for dq += dS K (K's B fragments by ldmatrix.trans) and drel
//      += dS E (E's rows by ldmatrix.trans: E is exact in bf16). dq and drel
//      are written once, dq scaled, both in bf16.
//   2. dk + dv: one block per (64-key tile, b x h, segment of query tiles),
//      each warp owning 16 keys: their K and V rows are A fragments read once,
//      and their E rows A fragments built in registers from the keys'
//      coordinates. Per query tile (q, dO, rel_pad's 64 rows, lse and delta
//      through the ring) S^T = scale K q^T + E rel^T and dP^T = V dO^T land in
//      the layout that repacks into A fragments for dv += P^T dO and dk +=
//      dS^T q. With one segment dk (scaled) and dv are written in bf16; with
//      more, fp32 partials [segments, B*H, Nk, D] that attention_bwd.cu's
//      attn_bwd_reduce_kernel sums in segment order (segments keep the card
//      busy where Nk is small next to Nq: 22 key-tile blocks at MViTv2-S's
//      block 0, batch 2).
// Every output element has one writer and a fixed summation order, so two
// runs give bit-identical dq, dk, dv and drel. Ragged tiles are zero-filled
// by the copies and P is 0 past Nk (pass 1) and past Nq (pass 2).
//
// RS: rel's 16-column k-steps (R <= 16 RS), max(2, ceil(R / 16)): 2 at R =
// 27 (MViTv2-S's blocks with keys pooled to 8 x 7 x 12, 13 of 16 at
// 224x384), 3 at R = 46 (keys 8 x 14 x 24), 4 at R = 52 (256x448). The dq
// pass holds q, dO, dq and drel (8 RS registers) in registers: at RS = 2 it
// fits the 168-register cap of 3 blocks per SM; at RS = 3 it spilled there,
// so RS >= 3 runs 2 blocks per SM, as the dk/dv pass does (about 250
// registers: K, V, E, dk and dv).
//
// What bounds it on the card: 10 D flops per (query, key) pair (S twice, dP
// twice, dq, dk, dv; plus rel E^T twice and drel) against q, k, v, dO read
// once per tile of the other side: the tensor cores, far from their peak at
// these tile sizes; registers set the blocks per SM (PERF.md).

#include "attention_bwd_sm90.cuh"

namespace mspi {
namespace {

using sm90::at;
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

// Byte sizes of the shared-memory regions at head dim D and RS rel k-steps.
template <int D, int RS>
struct RelBytes {
  static constexpr int LD = D + 8;         // bf16 pitch of operand rows
  static constexpr int RP = 16 * RS;       // rel_pad's columns
  static constexpr int LDR = RP + 8;       // bf16 pitch of E's and rel's rows
  static constexpr int kOp = sizeof(bf16) * kTile * LD;   // one [64][D] operand tile
  static constexpr int kRel = sizeof(bf16) * kTile * LDR;  // one [64][LDR] E or rel tile
  static constexpr int kStats = 2 * sizeof(float) * kTile;  // 64 rows' lse and delta
  static constexpr int kDqSlot = 2 * kOp + kRel;            // K, V, E
  static constexpr int kDq = kRing * kDqSlot + kRel;        // the ring, the block's rel rows
  static constexpr int kDkvSlot = 2 * kOp + kRel + kStats;  // q, dO, rel, lse and delta
  static constexpr int kDkv = kRing * kDkvSlot;
  static_assert(kOp % 16 == 0 && kRel % 16 == 0, "16-byte regions");
};

// Blocks per SM that __launch_bounds__ asks for in the dq pass: 3 (168
// registers) at RS = 2, else 2 (255).
__host__ __device__ constexpr int dq_min_blocks(int rs) { return rs <= 2 ? 3 : 2; }

// Pass 1: dq, delta and drel. Grid (query tiles, B x H).
template <int D, int RS>
__global__ void __launch_bounds__(kThreads, dq_min_blocks(RS))
    rel_bwd_dq_sm90_kernel(RelBwdArgs w) {
  using Z = RelBytes<D, RS>;
  constexpr int KS = D / 16, ND = D / 8, LD = Z::LD, LDR = Z::LDR, RP = Z::RP;
  extern __shared__ __align__(128) unsigned char smem_rdq[];
  bf16* rels = reinterpret_cast<bf16*>(smem_rdq + kRing * Z::kDqSlot);  // [kTile][LDR]
  const AttnArgs& a = w.f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, h = bh % a.heads, b = bh / a.heads;
  const int q0 = blockIdx.x * kTile;
  __shared__ int2 key_thw[kTile];  // the E writers' key walks (one per thread < kTile)
  if (tid < kTile) key_thw[tid] = sm90::key_walk_start(a, tid);
  // key tile k0 (K, V and E's rows) into slot si as one commit group (K's
  // and V's rows found anew per tile: kept live across the loop, their
  // pointers spilled at RS = 2)
  auto issue = [&](int si, int k0) {
    if (k0 < a.nk) {
      unsigned char* slot = smem_rdq + si * Z::kDqSlot;
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot), at(a.k, a.ks, b, h), a.ks.n,
                                    k0, a.nk);
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot + Z::kOp), at(a.v, a.vs, b, h),
                                    a.vs.n, k0, a.nk);
      if (tid < kTile)
        sm90::write_e_row(reinterpret_cast<bf16*>(slot + 2 * Z::kOp) + tid * LDR, RP,
                          k0 + tid < a.nk, a, key_thw[tid]);
    }
    cp_async_commit();
  };
  issue(0, 0);

  // the block's rel rows at pitch LDR (zeros past R and Nq; plain stores,
  // seen after the first barrier) and at pitch RP into rel_pad for pass 2,
  // 8 columns per thread and step
  {
    const unsigned short* rp = reinterpret_cast<const unsigned short*>(at(a.rel, a.rs, b, h));
    uint4* pad = static_cast<uint4*>(w.rel_pad) + static_cast<int64_t>(bh) * a.nq * (RP / 8);
    for (int e = tid; e < kTile * (RP / 8); e += kThreads) {
      const int r = e / (RP / 8), c = e % (RP / 8) * 8, qi = q0 + r;
      uint32_t v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c2 = c + 2 * m;
        const uint32_t lo = qi < a.nq && c2 < a.r ? rp[qi * a.rs.n + c2] : 0u;
        const uint32_t hi = qi < a.nq && c2 + 1 < a.r ? rp[qi * a.rs.n + c2 + 1] : 0u;
        v[m] = lo | hi << 16;
      }
      const uint4 chunk = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(rels + r * LDR + c) = chunk;
      if (qi < a.nq) pad[qi * (RP / 8) + c / 8] = chunk;
    }
  }

  const bool active = q0 + warp * 16 < a.nq;  // a row of this warp is in range
  const int row0 = warp * 16 + g;             // the thread's rows row0, row0 + 8
  uint32_t qf[KS][4], df[KS][4];
  // the thread's lse * log2(e) (x, y: rows row0, row0 + 8) and delta (z, w),
  // in shared memory to spare four registers (each thread reads its own)
  __shared__ float4 own_stats[kThreads];
  if (active) {
    const bf16* dop = at(w.dout, a.os, b, h);
    load_a_frags(qf, at(a.q, a.qs, b, h), a.qs.n, q0 + warp * 16, a.nq);
    load_a_frags(df, dop, a.os.n, q0 + warp * 16, a.nq);
    const int64_t rows = static_cast<int64_t>(bh) * a.nq;
    float lse2[2], dlt[2];
    sm90::row_stats<D>(at(a.out, a.os, b, h), dop, a.os.n, a.lse + rows, w.delta + rows,
                       q0 + row0, a.nq, lse2, dlt);
    own_stats[tid] = make_float4(lse2[0], lse2[1], dlt[0], dlt[1]);
  }
  float dq[ND][4], dr[2 * RS][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * RS; ++n) dr[n][0] = dr[n][1] = dr[n][2] = dr[n][3] = 0.f;
  const bf16* ra_row = rels + (warp * 16 + (lane & 15)) * LDR + (lane >> 4) * 8;

  const int n_t = (a.nk + kTile - 1) / kTile;
  for (int t = 0, k0 = 0; t < n_t; ++t, k0 += kTile) {
    cp_async_wait<0>();
    __syncthreads();  // tile t's slot is full; every warp is done with t - 1's slot
    issue((t + 1) % kRing, k0 + kTile);
    if (!active) continue;
    const unsigned char* slot = smem_rdq + (t % kRing) * Z::kDqSlot;
    const bf16* kt = reinterpret_cast<const bf16*>(slot);
    const bf16* vt = reinterpret_cast<const bf16*>(slot + Z::kOp);
    const bf16* et = reinterpret_cast<const bf16*>(slot + 2 * Z::kOp);
    const int valid = a.nk - k0;  // keys of this tile in range (may exceed kTile)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys: two 8-key column tiles
      if (kk * 16 >= valid) break;
      uint32_t da[4];  // dS (bf16) as the A fragment of these 16 keys
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 2 * kk + j;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f},
              rb[4] = {0.f, 0.f, 0.f, 0.f};
        if (n * 8 < valid) {  // S = scale q K^T + rel E^T, dP = dO V^T
#pragma unroll
          for (int k2 = 0; k2 < KS; k2 += 2) {
            uint32_t kb[4], vb[4];
            ldsm_x4(kb, kt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
            ldsm_x4(vb, vt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
            mma_bf16(s, qf[k2], kb[0], kb[1]);
            mma_bf16(s, qf[k2 + 1], kb[2], kb[3]);
            mma_bf16(dp, df[k2], vb[0], vb[1]);
            mma_bf16(dp, df[k2 + 1], vb[2], vb[3]);
          }
#pragma unroll
          for (int ks = 0; ks < RS; ++ks) {
            if (ks * 16 < a.r) {
              uint32_t ra[4], eb[2];
              ldsm_x4(ra, ra_row + ks * 16);
              ldsm_x2(eb, et + (n * 8 + (lane & 7)) * LDR + ks * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(rb, ra, eb[0], eb[1]);
            }
          }
        }
        const int c = n * 8 + 2 * t4;  // the thread's key columns c, c + 1
        const float4 st = own_stats[tid];
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // dS = P (dP - delta), P = 0 past Nk
          const float lse2 = i < 2 ? st.x : st.y, dlt = i < 2 ? st.z : st.w;
          const float p =
              c + (i & 1) < valid ? exp2_ftz((s[i] * a.scale + rb[i]) * kLog2e - lse2) : 0.f;
          ds[i] = p * (dp[i] - dlt);
        }
        da[2 * j] = pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dq += dS K, drel += dS E: K's and E's rows of these keys by ldmatrix.trans
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, kt + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
        mma_bf16(dq[dn], da, kb[0], kb[1]);
        mma_bf16(dq[dn + 1], da, kb[2], kb[3]);
      }
#pragma unroll
      for (int dn = 0; dn < 2 * RS; dn += 2) {
        if (dn * 8 < a.r) {
          uint32_t eb[4];
          ldsm_x4_trans(eb, et + (kk * 16 + (lane & 15)) * LDR + dn * 8 + (lane >> 4) * 8);
          mma_bf16(dr[dn], da, eb[0], eb[1]);
          mma_bf16(dr[dn + 1], da, eb[2], eb[3]);
        }
      }
    }
  }
  if (!active) return;

  bf16* dqp = static_cast<bf16*>(w.dq) + b * a.qs.b + h * a.qs.h;
  bf16* drp = static_cast<bf16*>(w.drel) + b * a.rs.b + h * a.rs.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    if (qi >= a.nq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqp + qi * a.qs.n + n * 8 + 2 * t4) =
          pack_bf16(dq[n][2 * hr] * a.scale, dq[n][2 * hr + 1] * a.scale);
    // drel's rows of R elements need not be 4-byte aligned: one element at a time
#pragma unroll
    for (int n = 0; n < 2 * RS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t4 + e;
        if (c < a.r) drp[qi * a.rs.n + c] = __float2bfloat16(dr[n][2 * hr + e]);
      }
  }
}

// Pass 2: dk and dv. Grid (key tiles, B x H, segments of query tiles).
template <int D, int RS>
__global__ void __launch_bounds__(kThreads, 2) rel_bwd_dkv_sm90_kernel(RelBwdArgs w) {
  using Z = RelBytes<D, RS>;
  constexpr int KS = D / 16, ND = D / 8, LD = Z::LD, LDR = Z::LDR, RP = Z::RP;
  extern __shared__ __align__(128) unsigned char smem_rdkv[];
  const AttnArgs& a = w.f;
  constexpr int rel_at = 2 * Z::kOp, stats_at = rel_at + Z::kRel;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, h = bh % a.heads, b = bh / a.heads;
  const int k0 = blockIdx.x * kTile, seg = blockIdx.z;
  const bf16* qp = at(a.q, a.qs, b, h);
  const bf16* dop = at(w.dout, a.os, b, h);
  const bf16* relp = static_cast<const bf16*>(w.rel_pad) + static_cast<int64_t>(bh) * a.nq * RP;
  const float* lsep = a.lse + static_cast<int64_t>(bh) * a.nq;
  const float* dlp = w.delta + static_cast<int64_t>(bh) * a.nq;

  // query tile q0 (q, dO, rel_pad's rows, lse and delta) into slot si as one
  // commit group; q0 >= Nq (past the segment) commits an empty group
  auto issue = [&](int si, int q0) {
    if (q0 < a.nq) {
      unsigned char* slot = smem_rdkv + si * Z::kDkvSlot;
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot), qp, a.qs.n, q0, a.nq);
      copy_rows<kTile, D, kThreads>(reinterpret_cast<bf16*>(slot + Z::kOp), dop, a.os.n, q0,
                                    a.nq);
      copy_rows<kTile, RP, kThreads>(reinterpret_cast<bf16*>(slot + rel_at), relp, RP, q0,
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
  uint32_t kf[KS][4], vf[KS][4], ef[RS][4];
  if (active) {
    load_a_frags(kf, at(a.k, a.ks, b, h), a.ks.n, k0 + warp * 16, a.nk);
    load_a_frags(vf, at(a.v, a.vs, b, h), a.vs.n, k0 + warp * 16, a.nk);
  }
  // E's A fragments of the thread's keys: element (key, column c) is 1 at
  // the key's columns t, kt + h, kt + kh + w (0 past Nk); a0 / a2 key0 at
  // columns 2 t4 (+1) / 2 t4 + 8 (+9) of each k-step, a1 / a3 key0 + 8
  {
    int ct[2], chh[2], cw[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kj = k0 + key0 + 8 * hr;
      const bool ok = kj < a.nk;
      ct[hr] = ok ? kj / (a.kh * a.kw) : -1;
      chh[hr] = ok ? a.kt + (kj / a.kw) % a.kh : -1;
      cw[hr] = ok ? a.kt + a.kh + kj % a.kw : -1;
    }
#pragma unroll
    for (int ks = 0; ks < RS; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hr = j & 1, c = ks * 16 + 8 * (j >> 1) + 2 * t4;
        const bool lo = c == ct[hr] || c == chh[hr] || c == cw[hr];
        const bool hi = c + 1 == ct[hr] || c + 1 == chh[hr] || c + 1 == cw[hr];
        ef[ks][j] = (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);  // bf16 1.0
      }
  }
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0, qt = qt0; qt < qt1; ++t, ++qt) {
    cp_async_wait<0>();
    __syncthreads();  // tile t's slot is full; every warp is done with t - 1's slot
    issue((t + 1) % kRing, qt + 1 < qt1 ? (qt + 1) * kTile : a.nq);  // a.nq: none
    if (!active) continue;
    const unsigned char* slot = smem_rdkv + (t % kRing) * Z::kDkvSlot;
    const bf16* qt_s = reinterpret_cast<const bf16*>(slot);
    const bf16* dt = reinterpret_cast<const bf16*>(slot + Z::kOp);
    const bf16* rt = reinterpret_cast<const bf16*>(slot + rel_at);
    const float* lse_s = reinterpret_cast<const float*>(slot + stats_at);
    const float* dlt_s = lse_s + kTile;
    const int valid = a.nq - qt * kTile;  // queries of this tile in range (may exceed kTile)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries: two 8-query column tiles
      if (kk * 16 >= valid) break;
      uint32_t pa[4], da[4];  // P^T and dS^T (bf16) as A fragments of these 16 queries
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 2 * kk + j;
        float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f},
              rb[4] = {0.f, 0.f, 0.f, 0.f};
        if (n * 8 < valid) {  // S^T = scale K q^T + E rel^T, dP^T = V dO^T
#pragma unroll
          for (int k2 = 0; k2 < KS; k2 += 2) {
            uint32_t qb[4], db[4];
            ldsm_x4(qb, qt_s + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
            ldsm_x4(db, dt + (n * 8 + (lane & 7)) * LD + k2 * 16 + (lane >> 3) * 8);
            mma_bf16(st, kf[k2], qb[0], qb[1]);
            mma_bf16(st, kf[k2 + 1], qb[2], qb[3]);
            mma_bf16(dpt, vf[k2], db[0], db[1]);
            mma_bf16(dpt, vf[k2 + 1], db[2], db[3]);
          }
#pragma unroll
          for (int ks = 0; ks < RS; ++ks) {
            if (ks * 16 < a.r) {
              uint32_t rb2[2];
              ldsm_x2(rb2, rt + (n * 8 + (lane & 7)) * LDR + ks * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(rb, ef[ks], rb2[0], rb2[1]);
            }
          }
        }
        const int c = n * 8 + 2 * t4;  // the thread's query columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + c);
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // P^T, dS^T = P^T (dP^T - delta); 0 past Nq
          const int e = i & 1;
          p[i] = c + e < valid
                     ? exp2_ftz((st[i] * a.scale + rb[i]) * kLog2e - (e ? l2.y : l2.x) * kLog2e)
                     : 0.f;
          ds[i] = p[i] * (dpt[i] - (e ? d2.y : d2.x));
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

template <int D, int RS>
cudaError_t launch(RelBwdArgs w, int batch, cudaStream_t stream) {
  using Z = RelBytes<D, RS>;
  const AttnArgs& a = w.f;
  const int bh = batch * a.heads;
  const int qtiles = (a.nq + kTile - 1) / kTile, ktiles = (a.nk + kTile - 1) / kTile;
  w.qtiles_per_seg = (qtiles + w.segments - 1) / w.segments;
  cudaError_t err = allow_smem(rel_bwd_dq_sm90_kernel<D, RS>, Z::kDq);
  if (err != cudaSuccess) return err;
  rel_bwd_dq_sm90_kernel<D, RS><<<dim3(qtiles, bh), kThreads, Z::kDq, stream>>>(w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(rel_bwd_dkv_sm90_kernel<D, RS>, Z::kDkv)) != cudaSuccess) return err;
  rel_bwd_dkv_sm90_kernel<D, RS><<<dim3(ktiles, bh, w.segments), kThreads, Z::kDkv, stream>>>(w);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

cudaError_t attention_rel_bwd_sm90(const RelBwdArgs& w, int batch, int d, cudaStream_t stream) {
  const AttnArgs& a = w.f;
  // 16-byte rows of every operand the ring or the prologue reads in chunks
  // (q, k, v, out, dout, rel_pad), 4-byte pairs of dq, dk, dv and the
  // lse and delta words; the key grid's coordinates fit E's walk
  if (w.segments <= 0 || a.r <= 0 || a.kt >= 1024 || a.kh >= 1024 || a.kw >= 1024 ||
      (w.segments > 1 && (!aligned(w.dk_part, 8) || !aligned(w.dv_part, 8))))
    return cudaErrorInvalidValue;
  if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16) || !aligned(a.out, 16) ||
      !aligned(w.dout, 16) || !aligned(w.rel_pad, 16) || !aligned(w.dq, 4) ||
      !aligned(w.dk, 4) || !aligned(w.dv, 4) || !aligned(a.lse, 4) || !aligned(w.delta, 4))
    return cudaErrorMisalignedAddress;
  if (d == 96) {
    if (a.r <= 32) return launch<96, 2>(w, batch, stream);
    if (a.r <= 48) return launch<96, 3>(w, batch, stream);
    if (a.r <= 64) return launch<96, 4>(w, batch, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace mspi
