// The bf16 flash-attention forward of four bias modes, register-resident on
// the tensor cores and fed by asynchronous copies:
//   kNoBias     K4 (self_attention.cu: SyncBlock self-attention on packed
//               q and kv lanes, D = 128) and row 6 (attention.cu: MViT
//               attention on augmented q/k lanes, attn_relk=False: score
//               width D = 128, 144, 176, 192 or 256 zero-filled lanes,
//               value width DV = 96, no scale);
//   kRelBias    K1 (attention_rel.cu: MViT pooled attention with the
//               decomposed rel-pos bias, head-major; and row 8's training
//               forward on token-major strides);
//   kRelBiasRes row 8 at inference (attention_rel.cu: kRelBias on MViT's
//               packed token-major strides, + q in the epilogue);
//   kDenseBias  row 15 (window_attention.cu: VideoSwin W-MSA / SW-MSA with a
//               dense bias and the shift mask).
// Replaces, in bf16, flash_attention.cuh's WMMA body, which stored every
// score tile and every P V product to shared memory, synced the block four
// times per key tile and loaded K and V synchronously (row 6's unaligned
// q_aug / k_aug rows one element at a time); the fp32 FMA body stays there.
// The TPU kernels: pooled_attention.py::_self_fwd_kernel, ::_fwd_kernel
// (row 6), ::_fwd_kernel_rel, ::_rel_packed_kernel and
// attention.py::_packed_fwd_kernel.
//
// FlashAttention-2's structure on mma.sync (m16n8k16, bf16 in, fp32
// accumulate) and cp.async:
// - Each of the block's 4 warps owns 16 query rows (BQ = 64). Q's A
//   fragments are read from device memory once and stay in registers.
// - Per key tile of 64: S = Q K^T with K's B fragments from ldmatrix; scale,
//   bias and the online softmax (fp32 running max and sum) work on the
//   accumulator fragments, where a row lives on the 4 threads of
//   a quad (two xor-shuffles per row reduction); P is rounded to bf16 and
//   repacked from the m16n8 accumulator layout into m16n8k16 A fragments in
//   registers; O += P V with V's B fragments from ldmatrix.trans (O is
//   rescaled only when a row max of the warp moved). Nothing between the two
//   products touches shared memory.
// - K and V (and row 15's bias and mask tiles) arrive in a ring of 2 slots by
//   16-byte cp.async copies (zero-filled past the end); tile k+1 is in flight
//   while tile k is computed, and one barrier per tile releases the slot. K
//   and V rows are padded by 16 bytes and the bias and mask tiles
//   XOR-swizzled, so ldmatrix's row addresses and a quad's bias reads fall on
//   distinct banks.
// - K1's bias is rel E^T on the tensor cores, as the TPU kernel multiplies
//   it in, over any rel width R (zero-padded to a multiple of 16). Per key
//   tile one thread per key writes the key's row of the 0/1 expansion E
//   (ones at t, kt + h, kt + kh + w; the key's (t, h, w) advanced per tile
//   without division) into the slot, read with ldmatrix:
//     S = scale * Q K^T + rel E^T
//   rel's A fragments: at R <= 48 (every block of MViTv2-S at 224x384) RK =
//   3 k-steps stay in registers, read from device memory once; above (R =
//   52 at 256x448), RK = 0: the block's rel rows are copied to shared
//   memory once and each k-step's fragments are read with ldmatrix per key
//   tile, after Q K^T (1.1-1.2x slower per forward at R <= 48, PERF.md).
// - K4 is the rel mode without E and without rel: S = scale * Q K^T.
// - Row 6 is K4 with unequal widths and scale 1: q_aug and k_aug rows of Da
//   = 96 + R lanes (109 and 114 at 64x96, 123 and 142 at 224x384, 148 at
//   256x448, 162 at 288x640, 180 at 448x768, 184 at 512x768) are not
//   16-byte aligned (nor 4-byte at an odd Da). k_aug is first copied into
//   zero-filled rows of D = 128, 144, 176, 192 or 256 lanes (aug_pad_kernel,
//   one pass over the pooled keys), which the ring then copies by cp.async;
//   Q's A fragments are read from q_aug two bytes at a time, zeros past Da,
//   once per block. The odd last k-step of D = 144 and 176 takes
//   ldmatrix.x2. At D = 176 (11 k-steps, 44 registers of Q) the 32-key
//   sub-tiles keep 3 blocks per SM (the 2-slot ring is 72 KB). At D = 192
//   and 256 Q's fragments would take 48 and 64 registers: the block's q
//   rows are copied once (two bytes at a time, zeros past Da) into shared
//   memory beside the ring and each warp reads a k-step's fragments by
//   ldmatrix per key tile (101 KB a block, 2 per SM, at 192; 125 KB, 1 per
//   SM, at 256).
// - Row 15's bias [H, N, N] and mask [nW, N, N]: the [64, 64] tiles of the
//   block's queries and the key tile are copied into the slot beside K and V
//   (a slot holds a mask tile only when there is a mask). q_s = q * D^-0.5
//   is rounded to bf16 in the Q fragments, as the plain version does before
//   Q K^T.
// - Ragged edges: key columns past Nk score -inf on the last tile only, and
//   8-key column tiles wholly past it are skipped; a warp whose 16 rows all
//   lie past Nq only helps with the copies; rows past Nq are not stored.
// The output is O / l rounded to bf16 (kRelBiasRes: then + q, added in fp32
// and rounded to bf16 again, as the plain version adds the residual in q's
// dtype; q is read from device memory in the epilogue, so nothing more is
// live across the key loop) and, when asked for, the row log-sum-exp m +
// log(l) (natural log, fp32) that the backward kernels read.
//
// What bounds it on the card: K1 at D = 96 does 4 * 96 flops per (query,
// key) pair (plus rel E^T) against q, k, v and rel read once per query
// tile, far above the memory roofline: the tensor cores bound it. Row 15 at
// D = 32 does 128 flops per pair against 2-4 bytes of bias and mask: its
// bound is those bytes. K4 at D = 128 is bound by its operations like K1.
// None is near its bound: K1 runs 3 blocks of 4 warps per SM (67 KB of
// shared memory at R <= 48; 80 KB and 2 blocks at R = 52), row 15 4 blocks
// (36 KB, 52 KB with the mask), K4 3 blocks (68 KB), which leaves 3-4 warps
// per scheduler to hide the mma and softmax latencies (PERF.md).
// - K4 at D = 128 holds Q's fragments (32 registers) and O (64): it takes
//   S, the softmax and P V in sub-tiles of 32 keys (S in 16 registers) to
//   fit the 168 registers of 3 blocks per SM without a spill. That ran
//   1.42-1.44x faster than 64-key sub-tiles at 2 blocks per SM (its 384
//   blocks are one wave of 396 resident slots, not 1.45 of 264; NVIDIA
//   H100 80GB HBM3, 700 W, PERF.md). Q from shared memory instead of
//   registers would not give 3 blocks: Q's 16 KB beside the 68 KB ring is
//   3 x 86 KB, above the SM's 228 KB.
//
// Measured against this design in one chip call each (PERF.md): 8 warps
// (BQ 128), 3 ring slots, 32-key tiles and no register cap lost (fewer
// resident warps, or more barriers per key); so did K1's bias as three
// fp32 shared-memory reads per score, and row 15 as a walk in which a block
// keeps its [64, N] bias and mask rows resident and visits the ~8 windows
// that share them (3x slower: 100 KB of resident rows leave one block per SM).
#pragma once

#include <stdint.h>

#include "flash_attention.cuh"

namespace mspi {
namespace sm90 {

constexpr int kWarps = 4;   // 16 query rows each: BQ = 64
constexpr int kStages = 2;  // ring slots
constexpr int kBK = 64;     // keys per tile
constexpr int kRelRegK = 3;  // rel k-steps held in registers (R <= 48)
constexpr float kLog2e = 1.4426950408889634f;

// The blocks per SM that __launch_bounds__ asks for, which caps the
// registers at 65536 / (blocks * 128): 4 at D = 32 (128 registers; the
// shared memory also fits 4), 3 at D = 96 (168) and for K4 at D = 128 (its
// 68 KB ring fits 3), 2 for the other modes above D = 96, and 2 for K1's
// rel rows in shared memory (R > 48), whose 80 KB and more per block fit 2
// blocks per SM. Without it ptxas took up to 194 registers at D = 96 and
// 140 at D = 32, one block per SM fewer.
__host__ __device__ constexpr int min_blocks(int d, int bias, bool rel_rows) {
  return rel_rows ? 2 : d <= 32 ? 4 : d <= 96 || bias == kNoBias ? 3 : 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b: A 16x16 bf16 (row), B 16x8 bf16 (col), D 16x8 fp32. Lane
// (g = lane / 4, t = lane % 4) holds D rows g and g + 8, columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (denormal results flush to 0; they are probabilities < 2^-126)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Both bf16 values of a word times s, each product rounded to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float s) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return pack_bf16(__low2float(v) * s, __high2float(v) * s);
}

// The m16n8k16 A fragments of rows [r0, r0 + 16) of a bf16 operand (row
// stride `stride`, KS * 16 contiguous columns, rows 4-byte aligned), read
// from device memory once per block; zeros past n.
template <int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KS][4], const bf16* src,
                                             int64_t stride, int r0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a0..a3: rows g, g+8, g, g+8; columns +0, +0, +8, +8
    const int r = r0 + g + 8 * (j & 1);
    const uint32_t* row = reinterpret_cast<const uint32_t*>(src + r * stride);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      f[ks][j] = r < n ? __ldg(row + (ks * 16 + 8 * (j >> 1) + 2 * t) / 2) : 0u;
  }
}

// The same for K1's rel rows of R <= RK * 16 columns at any alignment
// (2-byte loads), zeros past R: the A operand of rel E^T.
template <int RK>
__device__ __forceinline__ void load_rel_frags(uint32_t (&f)[RK][4], const bf16* src,
                                               int64_t stride, int r0, int n, int R) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + g + 8 * (j & 1);
#pragma unroll
    for (int ks = 0; ks < RK; ++ks) {
      const int c = ks * 16 + 8 * (j >> 1) + 2 * t;
      const uint32_t lo = r < n && c < R ? s16[r * stride + c] : 0u;
      const uint32_t hi = r < n && c + 1 < R ? s16[r * stride + c + 1] : 0u;
      f[ks][j] = lo | hi << 16;
    }
  }
}

// Rows [t0, t0 + ROWS) of a bf16 operand with D contiguous features and a row
// stride of `stride` elements into dst [ROWS][D + 8]; zeros past n. A thread
// copies one 16-byte column chunk of every RSTEP-th row (threads past
// RSTEP * VEC idle), so its addresses advance by one add per row.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int64_t stride, int t0,
                                          int n) {
  constexpr int VEC = D / 8;
  constexpr int RSTEP = THREADS / VEC;
  const int r0 = threadIdx.x / VEC, c = (threadIdx.x % VEC) * 8;
  if (r0 >= RSTEP) return;
  const bf16* from = src + (t0 + r0) * stride + c;
#pragma unroll
  for (int j = 0; j < (ROWS + RSTEP - 1) / RSTEP; ++j) {
    const int r = r0 + j * RSTEP;
    if (ROWS % RSTEP != 0 && r >= ROWS) break;
    const bool ok = t0 + r < n;
    cp_async16(dst + r * (D + 8) + c, ok ? from : src, ok);
    from += RSTEP * stride;
  }
}

// Element (r, c) of a swizzled [rows][kBK] bf16 tile: the 16-byte chunk c / 8
// of row r sits at chunk (c / 8) ^ (r % 8), so a quad's 4-byte reads of
// rows g = 0..7 at the same columns fall on 32 distinct banks, unpadded.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBK + ((((c >> 3) ^ r) & (kBK / 8 - 1)) << 3) + (c & 7);
}

// The [ROWS, kBK] tile at (r0, c0) of a row-major [nr, nc] bf16 matrix into
// the swizzled dst [ROWS][kBK]; zeros past nr and nc (nc % 8 == 0).
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int nr, int nc, int r0,
                                          int c0) {
  constexpr int VEC = kBK / 8;
#pragma unroll
  for (int i = 0; i < (ROWS * VEC + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if ((ROWS * VEC) % THREADS != 0 && e >= ROWS * VEC) break;
    const int r = e / VEC, c = (e % VEC) * 8;
    const bool ok = r0 + r < nr && c0 + c < nc;
    cp_async16(dst + swz(r, c), ok ? src + static_cast<int64_t>(r0 + r) * nc + c0 + c : src,
               ok);
  }
}

// The rel modes' key walk: the (t, h, w) of the key a thread writes E's row
// for, advanced by kBK keys per tile without division. x holds the
// coordinates and y the per-tile steps, packed 10 bits each (t | h << 10 |
// w << 20; the launchers check kt, kh, kw < 1024).
__device__ __forceinline__ int pack3(int t, int h, int w) { return t | h << 10 | w << 20; }

// The walk of key j (< kBK) of the first tile.
__device__ __forceinline__ int2 key_walk_start(const AttnArgs& a, int j) {
  return make_int2(pack3(j / (a.kh * a.kw), (j / a.kw) % a.kh, j % a.kw),
                   pack3(kBK / (a.kh * a.kw), (kBK / a.kw) % a.kh, kBK % a.kw));
}

// The walked key's row of E at er (cols columns, a multiple of 8, 16-byte
// aligned): 1 at the key's columns t, kt + h, kt + kh + w, zeros elsewhere
// and everywhere when the key is past Nk (!in_range); then the walk moves on
// by kBK keys.
__device__ __forceinline__ void write_e_row(bf16* er, int cols, bool in_range,
                                            const AttnArgs& a, int2& thw) {
  for (int c = 0; c < cols; c += 8)
    *reinterpret_cast<uint4*>(er + c) = make_uint4(0u, 0u, 0u, 0u);
  const int jthw = thw.x, dthw = thw.y;
  int jt = jthw & 1023, jh = (jthw >> 10) & 1023, jw = jthw >> 20;
  if (in_range) {
    const bf16 one = __float2bfloat16(1.f);
    er[jt] = one;
    er[a.kt + jh] = one;
    er[a.kt + a.kh + jw] = one;
  }
  jw += dthw >> 20;  // key + kBK
  int carry = jw >= a.kw;
  jw -= carry * a.kw;
  jh += ((dthw >> 10) & 1023) + carry;
  carry = jh >= a.kh;
  jh -= carry * a.kh;
  jt += (dthw & 1023) + carry;
  thw.x = pack3(jt, jh, jw);
}

template <int D, int RK, int BIAS, int DV = D>
struct Layout {
  static constexpr bool kRel = rel_mode(BIAS);
  static constexpr bool kRelRows = kRel && RK == 0;  // rel rows in shared memory
  // row 6's widest forms (D = 192, 256): Q's A fragments (48 or 64
  // registers) would not fit beside O's 48 and S's 16 under the 168 of 3
  // blocks per SM, so the block's q rows stay in shared memory [BQ][LD] and
  // each k-step's fragments are read by ldmatrix per key tile
  static constexpr bool kQRows = D != DV && D > 176;
  static constexpr int BQ = 16 * kWarps;
  static constexpr int LD = D + 8;                        // bf16 pitch of k rows
  static constexpr int LDV = DV + 8;                      // bf16 pitch of v rows
  static constexpr size_t kK = sizeof(bf16) * kBK * LD;   // one K tile
  static constexpr size_t kV = sizeof(bf16) * kBK * LDV;  // one V tile
  static constexpr size_t kB = sizeof(bf16) * BQ * kBK;   // one (swizzled) bias or mask tile
  // the rel modes: the bf16 pitch of E's rows (and of the rel rows), R rounded
  // up to the 16 columns of a k-step (RK of them in registers) plus 8: rows
  // 16 bytes apart mod 128, so ldmatrix's 8 row addresses fall on distinct
  // banks
  __host__ __device__ static int rel_pitch(int r) {
    return (RK > 0 ? RK * 16 : (r + 15) / 16 * 16) + 8;
  }
  // ring slot: K, V, then E [kBK][ldr] (rel modes) or the bias tile and,
  // with a mask, the mask tile (kDenseBias); K and V alone (kNoBias)
  __host__ __device__ static int slot(int ldr, bool masked) {
    return static_cast<int>(kK + kV + (kRel                  ? sizeof(bf16) * kBK * ldr
                                       : BIAS == kDenseBias ? (masked ? 2 : 1) * kB
                                                            : 0));
  }
  // the ring, then (RK = 0) the block's rel rows [BQ][ldr] or (kQRows) its
  // q rows [BQ][LD]
  static size_t bytes(int ldr, bool masked) {
    return kStages * slot(ldr, masked) + (kRelRows ? sizeof(bf16) * BQ * ldr : 0) +
           (kQRows ? sizeof(bf16) * BQ * LD : 0);
  }
  static_assert(kK % 16 == 0 && kV % 16 == 0 && kB % 16 == 0, "16-byte regions");
};

// One block: BQ query rows of head blockIdx.y % heads and batch entry (or
// window) blockIdx.y / heads, over all key tiles of 64. RK: the rel modes'
// rel k-steps held in registers (R <= 16 * RK), or 0 for rel rows in shared
// memory (any R); 0 for kNoBias and kDenseBias. D is the score width (q and
// k), DV the value width (v and out): equal but for row 6's augmented lanes
// (kNoBias, D = 128, 144, 176, 192 or 256 zero-filled lanes, DV = 96), whose
// q rows of a.dk lanes (any alignment) are read into Q's fragments two bytes
// at a time (D = 192 and 256: into the block's q rows in shared memory,
// Layout::kQRows) and whose k rows come padded to D lanes (aug_pad_kernel).
template <int D, int RK, int BIAS, int DV = D>
__global__ void __launch_bounds__(kWarps * 32, min_blocks(D, BIAS, rel_mode(BIAS) && RK == 0))
    flash_attention_sm90_kernel(AttnArgs a) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "whole 16-lane k-steps");
  static_assert(D == DV || BIAS == kNoBias, "unequal widths: row 6, no bias");
  using L = Layout<D, RK, BIAS, DV>;
  constexpr int NT = kWarps * 32;
  constexpr int BQ = L::BQ, LD = L::LD, LDV = L::LDV;
  constexpr int KS = D / 16;   // k-steps of Q K^T (an odd last one by ldmatrix.x2)
  constexpr bool kAug = D != DV;
  // keys per sub-tile of S, softmax and P V: K4 (D = 128) and row 6 take 32,
  // so that S's fragments (16 registers) leave room under the 168 of 3
  // blocks per SM beside Q's (up to 44 at D = 176) and O's
  constexpr int SN = BIAS == kNoBias && D > 96 ? 32 : kBK;
  constexpr int NS = SN / 8;   // 8-key column tiles of S
  constexpr int ND = DV / 8;   // 8-wide column tiles of O
  constexpr bool kRel = L::kRel, kRelRows = L::kRelRows, kQRows = L::kQRows;
  static_assert(NT >= kBK, "one thread per key writes E's row");
  static_assert(!kQRows || KS % 2 == 0, "q rows in shared memory: whole k-step pairs");
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  unsigned char* ring = smem_sm90;
  const int ldr = kRel ? L::rel_pitch(a.r) : 0;
  const int rpad = ldr - 8;  // rel modes: E's columns, 16 per k-step
  const int slot_bytes = L::slot(ldr, a.mask != nullptr);
  bf16* rels = reinterpret_cast<bf16*>(ring + kStages * slot_bytes);  // RK = 0: [BQ][ldr]
  bf16* qrows = rels;  // kQRows: the block's q rows [BQ][LD] in the same place

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y % a.heads, b = blockIdx.y / a.heads;
  const int q0 = blockIdx.x * BQ;
  const bf16* bp = nullptr;
  const bf16* mp = nullptr;
  if constexpr (BIAS == kDenseBias) {
    const int64_t nn = static_cast<int64_t>(a.nq) * a.nk;
    bp = static_cast<const bf16*>(a.bias) + h * nn;
    if (a.mask != nullptr) mp = static_cast<const bf16*>(a.mask) + (b % a.nw) * nn;
  }
  auto operand = [&](const void* base, const AttnStrides& st) {
    return static_cast<const bf16*>(base) + b * st.b + h * st.h;
  };

  // rel modes: thread j < kBK writes E's rows of keys j, j + kBK, ... (its
  // key walk in shared memory, to spare two registers; each thread reads
  // only its own entry)
  __shared__ int2 key_thw[kRel ? kBK : 1];
  if (kRel && tid < kBK) key_thw[tid] = key_walk_start(a, tid);
  // the key tile at k0 into ring slot `si` as one commit group; past the
  // last tile an empty group keeps the count
  auto issue = [&](int si, int k0) {
    if (k0 < a.nk) {
      unsigned char* slot = ring + si * slot_bytes;
      copy_rows<kBK, D, NT>(reinterpret_cast<bf16*>(slot), operand(a.k, a.ks), a.ks.n, k0,
                            a.nk);
      copy_rows<kBK, DV, NT>(reinterpret_cast<bf16*>(slot + L::kK), operand(a.v, a.vs), a.vs.n,
                             k0, a.nk);
      if constexpr (kRel) {
        if (tid < kBK)
          write_e_row(reinterpret_cast<bf16*>(slot + L::kK + L::kV) + tid * ldr, rpad,
                      k0 + tid < a.nk, a, key_thw[tid]);
      } else if constexpr (BIAS == kDenseBias) {
        bf16* bt = reinterpret_cast<bf16*>(slot + L::kK + L::kV);
        copy_tile<BQ, NT>(bt, bp, a.nq, a.nk, q0, k0);
        if (mp != nullptr) copy_tile<BQ, NT>(bt + BQ * kBK, mp, a.nq, a.nk, q0, k0);
      }
    }
    cp_async_commit();
  };

  // RK = 0: the block's rel rows (2-byte loads: rows of R elements need
  // not be aligned), zeros past R and Nq; plain stores, seen after the
  // first barrier
  if constexpr (kRelRows) {
    const unsigned short* rp = reinterpret_cast<const unsigned short*>(operand(a.rel, a.rs));
    unsigned short* rt = reinterpret_cast<unsigned short*>(rels);
    for (int e = tid; e < BQ * rpad; e += NT) {
      const int r = e / rpad, c = e % rpad;
      rt[r * ldr + c] = q0 + r < a.nq && c < a.r ? rp[(q0 + r) * a.rs.n + c] : 0;
    }
  }
  // kQRows: the block's q rows of a.dk lanes (2-byte loads: any alignment),
  // zeros past Da and Nq; plain stores, seen after the first barrier
  if constexpr (kQRows) {
    const unsigned short* qp = reinterpret_cast<const unsigned short*>(operand(a.q, a.qs));
    unsigned short* qt = reinterpret_cast<unsigned short*>(qrows);
    for (int e = tid; e < BQ * D; e += NT) {
      const int r = e / D, c = e % D;
      qt[r * LD + c] = q0 + r < a.nq && c < a.dk ? qp[(q0 + r) * a.qs.n + c] : 0;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s, s * kBK);

  const bool active = q0 + warp * 16 < a.nq;  // a row of this warp is in range
  const int row0 = warp * 16 + g;             // the thread's rows row0, row0 + 8
  uint32_t qf[kQRows ? 1 : KS][4];
  uint32_t rf[RK > 0 ? RK : 1][4];  // rel's A fragments (RK > 0)
  if (active) {
    if constexpr (kQRows) {
      // Q's fragments come from the block's q rows, per key tile
    } else if constexpr (kAug) {  // q rows of a.dk lanes at any alignment, zeros past them
      load_rel_frags<KS>(qf, operand(a.q, a.qs), a.qs.n, q0 + warp * 16, a.nq, a.dk);
    } else {
      load_a_frags(qf, operand(a.q, a.qs), a.qs.n, q0 + warp * 16, a.nq);
    }
    if constexpr (kRel && RK > 0)
      load_rel_frags<RK>(rf, operand(a.rel, a.rs), a.rs.n, q0 + warp * 16, a.nq, a.r);
    if constexpr (BIAS == kDenseBias) {
      const float qscale = round_to<bf16>(a.qscale);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) qf[ks][j] = scale_bf16x2(qf[ks][j], qscale);
    }
  }
  float o[ND][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int n_t = (a.nk + kBK - 1) / kBK;
  for (int t = 0, k0 = 0; t < n_t; ++t, k0 += kBK) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t's slot is full; every warp is done with t - 1's slot
    issue((t + kStages - 1) % kStages, k0 + (kStages - 1) * kBK);
    if (!active) continue;
    const unsigned char* slot = ring + (t % kStages) * slot_bytes;
    const bf16* kt = reinterpret_cast<const bf16*>(slot);
    const bf16* vt = reinterpret_cast<const bf16*>(slot + L::kK);
    const bf16* xt = reinterpret_cast<const bf16*>(slot + L::kK + L::kV);  // E, or the bias tile
#pragma unroll
    for (int c0 = 0; c0 < kBK; c0 += SN) {  // sub-tiles of SN keys
      const int valid = a.nk - k0 - c0;  // keys of this sub-tile in range (may exceed SN)
      if (valid <= 0) break;
      const bf16* kc = kt + c0 * LD;
      const bf16* vc = vt + c0 * LDV;
      const bf16* ec = xt + (kRel ? c0 * ldr : 0);  // the rel modes' E rows

      // S = Q K^T (rel modes: scale * Q K^T + rel E^T), column tiles wholly
      // past Nk skipped
      float s[NS][4];
      if constexpr (kQRows) {
        // Q's A fragments of the warp's 16 rows one k-step at a time, each
        // against the sub-tile's column tiles
        const bf16* qa_row = qrows + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          uint32_t qa[4], qb[4];
          ldsm_x4(qa, qa_row + kk * 16);
          ldsm_x4(qb, qa_row + kk * 16 + 16);
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            if (n * 8 < valid) {
              uint32_t kb[4];
              ldsm_x4(kb, kc + (n * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 3) * 8);
              mma_bf16(s[n], qa, kb[0], kb[1]);
              mma_bf16(s[n], qb, kb[2], kb[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
          if (n * 8 < valid) {
#pragma unroll
            for (int kk = 0; kk + 1 < KS; kk += 2) {
              uint32_t kb[4];
              ldsm_x4(kb, kc + (n * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 3) * 8);
              mma_bf16(s[n], qf[kk], kb[0], kb[1]);
              mma_bf16(s[n], qf[kk + 1], kb[2], kb[3]);
            }
            if constexpr (KS % 2 == 1) {  // row 6 at D = 144, 176: the odd last k-step
              uint32_t kb[2];
              ldsm_x2(kb,
                      kc + (n * 8 + (lane & 7)) * LD + (KS - 1) * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(s[n], qf[KS - 1], kb[0], kb[1]);
            }
            if constexpr (kRel && RK > 0) {
              // + rel E^T, rel's fragments in registers, on a chain of its own
              float rb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int ks = 0; ks < RK; ++ks) {
                if (ks * 16 < a.r) {
                  uint32_t eb[2];
                  ldsm_x2(eb,
                          ec + (n * 8 + (lane & 7)) * ldr + ks * 16 + ((lane >> 3) & 1) * 8);
                  mma_bf16(rb, rf[ks], eb[0], eb[1]);
                }
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * a.scale + rb[e];
            } else if constexpr (BIAS != kDenseBias) {
#pragma unroll
              for (int e = 0; e < 4; ++e) s[n][e] *= a.scale;
            }
          }
        }
      }
      if constexpr (kRelRows) {
        // + rel E^T, rel's A fragments of the warp's 16 rows from shared
        // memory, one k-step at a time
        const bf16* ra_row = rels + (warp * 16 + (lane & 15)) * ldr + (lane >> 4) * 8;
        for (int c = 0; c < rpad; c += 16) {
          uint32_t ra[4];
          ldsm_x4(ra, ra_row + c);
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            if (n * 8 < valid) {
              uint32_t eb[2];
              ldsm_x2(eb, ec + (n * 8 + (lane & 7)) * ldr + c + ((lane >> 3) & 1) * 8);
              mma_bf16(s[n], ra, eb[0], eb[1]);
            }
          }
        }
      } else if constexpr (BIAS == kDenseBias) {
        // bias and mask, from the swizzled tiles
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int c = n * 8 + 2 * t4;  // the thread's key columns c, c + 1
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // rows row0 + 8 * hr
            const bf16* br = xt + swz(row0 + 8 * hr, c0 + c);
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(br);
            s[n][2 * hr] += __low2float(bb);
            s[n][2 * hr + 1] += __high2float(bb);
            if (mp != nullptr) {
              const __nv_bfloat162 mm = *reinterpret_cast<const __nv_bfloat162*>(br + BQ * kBK);
              s[n][2 * hr] += __low2float(mm);
              s[n][2 * hr + 1] += __high2float(mm);
            }
          }
        }
      }
      if (valid < SN) {  // the ragged last tile: -inf past Nk
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n * 8 + 2 * t4 + (e & 1) >= valid) s[n][e] = -INFINITY;
      }

      // online softmax per row (the quad's 4 threads hold a row's SN columns)
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hr], mx);  // finite: key k0 + c0 is in range
        const float m2 = m_new * kLog2e;
        alpha[hr] = m_new == m_run[hr] ? 1.f : exp2_ftz(m_run[hr] * kLog2e - m2);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          s[n][2 * hr] = exp2_ftz(s[n][2 * hr] * kLog2e - m2);
          s[n][2 * hr + 1] = exp2_ftz(s[n][2 * hr + 1] * kLog2e - m2);
          sum += s[n][2 * hr] + s[n][2 * hr + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[hr] = l_run[hr] * alpha[hr] + sum;
        m_run[hr] = m_new;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row max moved
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }

      // O += P V: P (bf16) from the S fragments of keys 16kk .. 16kk + 15
#pragma unroll
      for (int kk = 0; kk < SN / 16; ++kk) {
        if (kk * 16 < valid) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dn = 0; dn < ND; dn += 2) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, vc + (kk * 16 + (lane & 15)) * LDV + dn * 8 + (lane >> 4) * 8);
            mma_bf16(o[dn], pa, vb[0], vb[1]);
            mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
  }
  if (!active) return;

  // out rows = O / l in bf16 (kRelBiasRes: + q in bf16), and the rows' lse
  bf16* op = static_cast<bf16*>(a.out) + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    if (qi >= a.nq) continue;
    const float inv = 1.f / l_run[hr];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      uint32_t y = pack_bf16(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
      if constexpr (BIAS == kRelBiasRes) {
        const uint32_t qw = __ldg(reinterpret_cast<const uint32_t*>(
            operand(a.q, a.qs) + qi * a.qs.n + n * 8 + 2 * t4));
        const __nv_bfloat162 yv = *reinterpret_cast<const __nv_bfloat162*>(&y);
        const __nv_bfloat162 qv = *reinterpret_cast<const __nv_bfloat162*>(&qw);
        y = pack_bf16(__low2float(yv) + __low2float(qv), __high2float(yv) + __high2float(qv));
      }
      *reinterpret_cast<uint32_t*>(op + qi * a.os.n + n * 8 + 2 * t4) = y;
    }
    if (a.lse != nullptr && t4 == 0)
      a.lse[(static_cast<int64_t>(b) * a.heads + h) * a.nq + qi] = m_run[hr] + logf(l_run[hr]);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Row 6's q_aug / k_aug rows of da lanes (any alignment) into zero-filled
// rows of DK lanes, 8 lanes a thread: the 16-byte rows that the forward's
// ring (k) and the backward's passes (q and k) copy; the zero lanes add
// nothing to S.
template <int DK>
__global__ void __launch_bounds__(256) aug_pad_kernel(const bf16* __restrict__ src,
                                                      bf16* __restrict__ dst, int64_t rows,
                                                      int da) {
  constexpr int VEC = DK / 8;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= rows * VEC) return;
  const int64_t r = i / VEC;
  const int c = static_cast<int>(i % VEC) * 8;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src) + r * da;
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = c + 2 * e < da ? s[c + 2 * e] : 0u;
    const uint32_t hi = c + 2 * e + 1 < da ? s[c + 2 * e + 1] : 0u;
    w[e] = lo | hi << 16;
  }
  *reinterpret_cast<uint4*>(dst + r * DK + c) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int DK>
cudaError_t launch_aug_pad(const bf16* src, bf16* dst, int64_t rows, int da,
                           cudaStream_t stream) {
  const int64_t threads = rows * (DK / 8);
  if (threads > 0)
    aug_pad_kernel<DK><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        src, dst, rows, da);
  return cudaGetLastError();
}

// The wide form's pad (Da > 256): rows of da lanes (any alignment) into
// zero-filled rows of dk lanes, dk = aug_width(da) a multiple of 64 chosen at
// run time, 8 lanes a thread.
template <typename T>
__global__ void __launch_bounds__(256) aug_pad_wide_kernel(const T* __restrict__ src,
                                                           T* __restrict__ dst, int64_t rows,
                                                           int da, int dk) {
  const int vec = dk / 8;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= rows * vec) return;
  const int64_t r = i / vec;
  const int c = static_cast<int>(i % vec) * 8;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src) + r * da;
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = c + 2 * e < da ? s[c + 2 * e] : 0u;
    const uint32_t hi = c + 2 * e + 1 < da ? s[c + 2 * e + 1] : 0u;
    w[e] = lo | hi << 16;
  }
  *reinterpret_cast<uint4*>(dst + r * dk + c) = make_uint4(w[0], w[1], w[2], w[3]);
}

inline cudaError_t launch_aug_pad_wide(const bf16* src, bf16* dst, int64_t rows, int da,
                                       int dk, cudaStream_t stream) {
  const int64_t threads = rows * (dk / 8);
  if (threads > 0)
    aug_pad_wide_kernel<bf16><<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                                stream>>>(src, dst, rows, da, dk);
  return cudaGetLastError();
}

// Row 6's wide form in bf16 (Da > 256): the score width is a run-time
// multiple of kAugChunk = 64, so q and k cannot sit in registers or whole in
// shared memory. One block of 4 warps takes BQ = 64 query rows and walks the
// steps (key tile t, chunk c): each step's ring slot holds the block's q
// chunk c [64][72] and key tile t's k chunk c [64][72] (the padded rows,
// 16-byte cp.async copies), and on a tile's last chunk its V rows [64][104].
// S [16 rows x 64 keys] a warp accumulates over the chunks in registers
// (32), Q's A fragments by ldmatrix per step; after the last chunk the
// online softmax and O += P V run as in flash_attention_sm90_kernel with
// 64-key tiles. Registers do not grow with Da; q is read again per key
// tile, from L2. 62 KB of shared memory, 3 blocks per SM.
struct WideLayout {
  static constexpr int LDC = kAugChunk + 8;  // bf16 pitch of q and k chunk rows
  static constexpr int LDV = 96 + 8;         // bf16 pitch of v rows
  static constexpr int kQ = sizeof(bf16) * 16 * kWarps * LDC;
  static constexpr int kK = sizeof(bf16) * kBK * LDC;
  static constexpr int kV = sizeof(bf16) * kBK * LDV;
  static constexpr int kSlot = kQ + kK + kV;
  static constexpr int kBytes = kStages * kSlot;
  static_assert(kQ % 16 == 0 && kK % 16 == 0 && kV % 16 == 0, "16-byte regions");
};

template <int DV>
__global__ void __launch_bounds__(kWarps * 32, 3)
    flash_attention_aug_wide_sm90_kernel(AttnArgs a, int dk) {
  using L = WideLayout;
  constexpr int NT = kWarps * 32, BQ = 16 * kWarps, NS = kBK / 8, ND = DV / 8;
  constexpr int LDC = L::LDC, LDV = L::LDV;
  static_assert(DV + 8 == LDV, "v rows at the layout's pitch");
  extern __shared__ __align__(128) unsigned char smem_wide[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y % a.heads, b = blockIdx.y / a.heads;
  const int q0 = blockIdx.x * BQ;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const int nc = dk / kAugChunk, n_t = (a.nk + kBK - 1) / kBK, steps = n_t * nc;
  // step (t, c) into ring slot si as one commit group; past the last step
  // an empty group keeps the count
  auto issue = [&](int si, int step) {
    if (step < steps) {
      const int t = step / nc, c = step % nc;
      unsigned char* slot = smem_wide + si * L::kSlot;
      copy_rows<BQ, kAugChunk, NT>(reinterpret_cast<bf16*>(slot), qp + c * kAugChunk, a.qs.n,
                                   q0, a.nq);
      copy_rows<kBK, kAugChunk, NT>(reinterpret_cast<bf16*>(slot + L::kQ), kp + c * kAugChunk,
                                    a.ks.n, t * kBK, a.nk);
      if (c == nc - 1)
        copy_rows<kBK, DV, NT>(reinterpret_cast<bf16*>(slot + L::kQ + L::kK), vp, a.vs.n,
                               t * kBK, a.nk);
    }
    cp_async_commit();
  };
  issue(0, 0);

  const bool active = q0 + warp * 16 < a.nq;  // a row of this warp is in range
  const int row0 = warp * 16 + g;             // the thread's rows row0, row0 + 8
  float o[ND][4], s[NS][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // this step's slot is full; every warp is done with the last one's
    issue((step + 1) % kStages, step + 1);
    if (!active) continue;
    const int t = step / nc, c = step % nc;
    const int valid = a.nk - t * kBK;  // keys of this tile in range (may exceed kBK)
    const unsigned char* slot = smem_wide + (step % kStages) * L::kSlot;
    const bf16* qc = reinterpret_cast<const bf16*>(slot);
    const bf16* kc = reinterpret_cast<const bf16*>(slot + L::kQ);
    const bf16* vt = reinterpret_cast<const bf16*>(slot + L::kQ + L::kK);
    // S += q_c K_c^T, column tiles wholly past Nk skipped
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

    if (valid < kBK) {  // the ragged last tile: -inf past Nk
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + 2 * t4 + (e & 1) >= valid) s[n][e] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);  // finite: key t * kBK is in range
      const float m2 = m_new * kLog2e;
      alpha[hr] = m_new == m_run[hr] ? 1.f : exp2_ftz(m_run[hr] * kLog2e - m2);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * hr] = exp2_ftz(s[n][2 * hr] * kLog2e - m2);
        s[n][2 * hr + 1] = exp2_ftz(s[n][2 * hr + 1] * kLog2e - m2);
        sum += s[n][2 * hr] + s[n][2 * hr + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[hr] = l_run[hr] * alpha[hr] + sum;
      m_run[hr] = m_new;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    // O += P V: P (bf16) from the S fragments of keys 16kk .. 16kk + 15
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk * 16 < valid) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < ND; dn += 2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vt + (kk * 16 + (lane & 15)) * LDV + dn * 8 + (lane >> 4) * 8);
          mma_bf16(o[dn], pa, vb[0], vb[1]);
          mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  }
  cp_async_wait<0>();
  if (!active) return;

  // out rows = O / l in bf16, and the rows' lse
  bf16* op = static_cast<bf16*>(a.out) + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + row0 + 8 * hr;
    if (qi >= a.nq) continue;
    const float inv = 1.f / l_run[hr];
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(op + qi * a.os.n + n * 8 + 2 * t4) =
          pack_bf16(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
    if (a.lse != nullptr && t4 == 0)
      a.lse[(static_cast<int64_t>(b) * a.heads + h) * a.nq + qi] = m_run[hr] + logf(l_run[hr]);
  }
}

}  // namespace sm90

namespace sm90 {

template <int D, int RK, int BIAS, int DV = D>
cudaError_t launch(const AttnArgs& a, int batch, cudaStream_t stream) {
  using L = Layout<D, RK, BIAS, DV>;
  const size_t smem = L::bytes(rel_mode(BIAS) ? L::rel_pitch(a.r) : 0, a.mask != nullptr);
  const dim3 grid((a.nq + L::BQ - 1) / L::BQ, batch * a.heads);
  auto kernel = flash_attention_sm90_kernel<D, RK, BIAS, DV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace sm90

// Grid: x = query tiles of BQ, y = batch x heads (one block per batch entry
// and head). The rel modes keep rel's fragments in registers at R <= 48.
template <int D, int BIAS>
cudaError_t launch_flash_attention_sm90(const AttnArgs& a, int batch, cudaStream_t stream) {
  // every k and v row starts 16 bytes aligned and every q row 4 bytes:
  // base pointers and strides (and, for the dense bias, rows of Nk elements)
  bool ok = sm90::aligned16(a.k) && sm90::aligned16(a.v) &&
            reinterpret_cast<uintptr_t>(a.q) % 4 == 0 && a.qs.n % 2 == 0 &&
            a.qs.h % 2 == 0 && a.qs.b % 2 == 0 && a.ks.n % 8 == 0 && a.vs.n % 8 == 0 &&
            a.ks.h % 8 == 0 && a.vs.h % 8 == 0 && a.ks.b % 8 == 0 && a.vs.b % 8 == 0;
  if (BIAS == kDenseBias)
    ok = ok && sm90::aligned16(a.bias) && (a.mask == nullptr || sm90::aligned16(a.mask)) &&
         a.nk % 8 == 0;
  if (!ok) return cudaErrorMisalignedAddress;
  // the key grid's coordinates fit the 10-bit fields of E's writers
  if (rel_mode(BIAS) && (a.r <= 0 || a.kt >= 1024 || a.kh >= 1024 || a.kw >= 1024))
    return cudaErrorInvalidValue;
  if constexpr (rel_mode(BIAS)) {
    if (a.r <= 16 * sm90::kRelRegK) return sm90::launch<D, sm90::kRelRegK, BIAS>(a, batch, stream);
  }
  return sm90::launch<D, 0, BIAS>(a, batch, stream);
}

// Row 6 in bf16 (attention.cu): head-major q_aug [B, H, Nq, a.dk] read in
// place (its rows need not be aligned), k_aug [B, H, Nk, a.dk] first copied
// into `pad` [B*H*Nk, DK] (zero-filled rows of DK = aug_width(a.dk) lanes,
// 16-byte aligned), v [B, H, Nk, 96] 16-byte aligned rows; no bias, no scale.
// The same body as K4 with S in 32-key sub-tiles (kNoBias above D = 96).
template <int DK>
cudaError_t launch_flash_attention_aug_sm90(AttnArgs a, int batch, bf16* pad,
                                            cudaStream_t stream) {
  if (!sm90::aligned16(a.v) || !sm90::aligned16(pad) || a.vs.n % 8 != 0 ||
      a.vs.h % 8 != 0 || a.vs.b % 8 != 0 || reinterpret_cast<uintptr_t>(a.q) % 2 != 0)
    return cudaErrorMisalignedAddress;
  const int64_t per_head = static_cast<int64_t>(a.nk) * DK;
  cudaError_t err = sm90::launch_aug_pad<DK>(static_cast<const bf16*>(a.k), pad,
                                             static_cast<int64_t>(batch) * a.heads * a.nk, a.dk,
                                             stream);
  if (err != cudaSuccess) return err;
  a.k = pad;
  a.ks = {a.heads * per_head, per_head, DK};
  return sm90::launch<DK, 0, kNoBias, 96>(a, batch, stream);
}

// Row 6's wide form in bf16 (Da > 256, sm90::flash_attention_aug_wide_sm90_kernel):
// q_aug [B, H, Nq, a.dk] and k_aug [B, H, Nk, a.dk] are first copied into
// `pad` [B*H*(Nq + Nk), dk] (zero-filled rows of dk = aug_width(a.dk) lanes,
// q's rows, then k's), v [B, H, Nk, 96] 16-byte aligned rows.
inline cudaError_t launch_flash_attention_aug_wide_sm90(AttnArgs a, int batch, bf16* pad,
                                                        cudaStream_t stream) {
  if (!sm90::aligned16(a.v) || !sm90::aligned16(pad) || a.vs.n % 8 != 0 ||
      a.vs.h % 8 != 0 || a.vs.b % 8 != 0)
    return cudaErrorMisalignedAddress;
  const int dk = aug_width(a.dk);
  if (dk <= kAugMaxFixed) return cudaErrorInvalidValue;
  const int64_t bh = static_cast<int64_t>(batch) * a.heads;
  bf16* qpad = pad;
  bf16* kpad = pad + bh * a.nq * dk;
  cudaError_t err = sm90::launch_aug_pad_wide(static_cast<const bf16*>(a.q), qpad, bh * a.nq,
                                              a.dk, dk, stream);
  if (err == cudaSuccess)
    err = sm90::launch_aug_pad_wide(static_cast<const bf16*>(a.k), kpad, bh * a.nk, a.dk, dk,
                                    stream);
  if (err != cudaSuccess) return err;
  const int64_t hq = static_cast<int64_t>(a.nq) * dk, hk = static_cast<int64_t>(a.nk) * dk;
  a.q = qpad;
  a.qs = {a.heads * hq, hq, dk};
  a.k = kpad;
  a.ks = {a.heads * hk, hk, dk};
  constexpr int smem = sm90::WideLayout::kBytes;
  auto kernel = sm90::flash_attention_aug_wide_sm90_kernel<96>;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  kernel<<<dim3((a.nq + 63) / 64, static_cast<unsigned>(bh)), sm90::kWarps * 32, smem, stream>>>(
      a, dk);
  return cudaGetLastError();
}

}  // namespace mspi
