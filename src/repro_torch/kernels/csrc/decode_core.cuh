// The core of one-token GQA decode attention for Hopper (sm_90a), shared by
// K2 (decode_attention.cu, over the ring cache), K3 (paged_attention.cu,
// through block tables), K2q (decode_attention_quant.cu, over a ring of
// int8/fp8 codes) and K3q (paged_attention_quant.cu, over a quantized or
// mixed page pool): flash-decoding inside one launch.
//
// A launch's grid is (KVH, B, SPLIT); the SPLIT CTAs of one (KV head, batch
// row) pair form a thread-block cluster, and each takes every SPLIT-th tile
// of 64 slots: tile t (slots 64t .. 64t+63) goes to cluster rank t % SPLIT.
// The partition is a function of the slot index alone, never of L, the
// number of valid slots, the page size or the storage of a row, so a dense
// ring and a paged pool that hold the same positions in the same slots run
// the same arithmetic bit for bit (paged equals dense, native or int8), and
// a row of codes gives the bits of its dequantized row stored natively.
//
// A source says where a slot's K/V rows are: `row(slot)` is
//   >= 0   a native row (in T, rows `row_stride` elements apart from
//          `k_base`/`v_base`);
//   -1     an invalid slot: never read, its rows land as zeros;
//   <= -2  code row -2 - row of the `codes` (CodeRows: HD one-byte codes a
//          row, one f32 scale per row and KV head).
// `n_slots` bounds the slots. RingSlots reads slot_pos (a ring slot is its
// own row), PagedSlots the block table (a slot's pool row, by page id). A
// CTA first resolves its tiles' 64 slots to rows; a tile with no valid slot
// is skipped before any K/V load (its scores would all be -1e30: before the
// first valid tile exp(-1e30 - m) = 0 scales it away, after it it adds 0).
// Native rows are copied into shared memory in T by 16-byte cp.async
// copies, invalid rows land as zeros, into a ring of two stages, so a CTA's
// first two tiles are in flight before it computes the first; the rows of
// tile i + 2 are resolved into registers while tile i computes. K and V
// rows lie an odd number of 16-byte chunks apart, so eight rows' chunks at
// one column fall into eight different bank groups (for ldmatrix and for
// the lanes' 16-byte reads).
//
// A code row is copied by cp.async too, into its own row of the T ring:
// chunk c (codes 16c .. 16c + 15) lands where its 16 dequantized values
// will lie (byte 16c * sizeof(T)), and the row's scale in the 4 bytes after
// it, both by one thread. After its wait for the tile, that thread reads
// them back, dequantizes exactly as `dequantize_kv` does ((float(code) *
// scale) rounded to T, dequant.cuh) and writes the 16 values over them:
// each thread touches only what it copied itself, so the dequantization
// needs no barrier of its own and no shared memory beyond K2's, and the
// copies stay coalesced (four lanes a 64-byte row at hd 64). From there on
// a code row is a native row.
//
// An unscaled code row (K2q's and K3q's unscaled routes, over an unscaled
// storage cast: CodeRows<S, false>, S one of __half, __nv_bfloat16, float,
// __nv_fp8_e4m3, never T) has no scale. A store no wider than T goes the
// same way: chunk c (16 / sizeof(S) values) is copied by cp.async to where
// its values will lie, and the thread that copied it converts them in
// place (dequant.cuh::cast_chunk: each value exactly to f32, rounded to T
// once, as `ck.astype(q.dtype)`). A float store under bf16 (each chunk
// wider than its bf16 values) is loaded and converted by the thread that
// would copy it, into the ring's bf16 row, before the tile's barrier.
//
// A tile's products, by dtype. Both keep the numeric rules of the Pallas
// kernel: masked scores -1e30, the online softmax (m, l, acc) in f32, p
// rounded to the value dtype before the PV product, l summed from p before
// that rounding.
// - bfloat16: on the tensor cores, warp-level mma.sync m16n8k16 with f32
//   accumulators. The query heads are the rows of the products (rows past G
//   zero), and the CTA is four warps per 16 heads: warp w takes slots
//   16 (w % 4) .. +15 of every tile with an online softmax of its own, and
//   the four partials are merged at the end. S = q K^T reads K by ldmatrix
//   as it lies, the softmax runs on S's accumulator fragment (quad
//   shuffles), and P, rounded to bf16, is the register A operand of
//   O += P V, V read by ldmatrix.trans. Decode is byte-bound in FLOPs, but
//   on the CUDA cores the conversions, shuffles and shared-memory reads of
//   G warps that each redo the whole tile take as long as the bytes; here a
//   warp does its quarter of a tile in about a hundred instructions.
// - float32: on the CUDA cores, one warp per query head of the group
//   (G = H / KVH <= 32): each lane scores two slots (lane, lane + 32)
//   against q (f32 in shared memory) and owns HD/32 contiguous output dims.
//
// The combine, in the same launch: every CTA leaves (m, l, acc) per query
// head in its own shared memory and the cluster meets at a barrier; then
// rank r combines the r-th eighth of the G x HD outputs, reading the SPLIT
// partials through distributed shared memory in rank order: M = max m_s,
// out = sum exp(m_s - M) acc_s / sum exp(m_s - M) l_s; the
// cluster meets again before any CTA exits. A rank with no valid tile
// leaves m = -1e30, l = 0, acc = 0, so it adds nothing.
//
// A row with no valid slot at all (every rank's m still -1e30 once the
// cluster has met) gets what the TPU kernel and the plain version give it:
// a uniform softmax over its masked scores, the mean of V over every slot
// the plain version gathers (the whole ring for K2 and K2q; every table
// slot for K3 and K3q, an unallocated page read as page 0 of the pool's
// code region, or of the native one when it has none). Then each rank
// leaves the sum of V over its tiles' slots as its partial (``mean_of_v``:
// m 0, l the number of slots) and the combine divides; a row with a valid
// slot pays one read of the eight ranks' m's for it. The main pass keeps
// its registers: the sum runs after it, on plain loads. No scratch in
// device memory, no atomics, no second launch: the result does not depend
// on the order in which CTAs run, and each call is one kernel launch.
//
// Head dims 32, 64 and 128 on both routes, and 256 on the bf16 one
// (recurrentgemma-2b: 10 query heads on one KV head; K2 and K2q). At hd 256 a K or V
// row is 512 bytes (528 apart in shared memory), the two stages of 64 K and
// V rows take 135 KB and q and the partial of G 10 another 20 KB: one CTA
// of 128 threads a SM. The f32 route's two stages would take 266 KB, more
// than a CTA may have, so its wrappers refuse hd 256.
//
// What bounds it: bytes. A step reads each valid K/V row once for all G
// query heads that use it (a code row as hd bytes and a 4-byte scale), at
// 4 * hd FLOPs per (head, slot), two orders of magnitude below the card's
// ratio of FLOPs to bytes; the design spends its effort on having many
// copies in flight on many SMs (B * KVH * SPLIT CTAs) and on keeping each
// tile's instructions few.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "dequant.cuh"
#include "sm90.cuh"

namespace repro::decode {

constexpr int BL = 64;      // slots per tile
constexpr int SPLIT = 8;    // CTAs per cluster (the portable limit); tile t -> rank t % SPLIT
constexpr int STAGES = 2;   // the ring of K/V tiles
constexpr int INVALID = -1; // a source's row for a slot that is not read

// Ring slots (K2, K2q): a slot reads its own row when its position is
// visible to pos; with CODES that row is a code row. A row with no valid
// slot reads every slot below ``every_slots()``, each its own row
// (``every_row``).
template <bool CODES> struct RingSlots {
  const int* sp;  // this batch row's slot_pos (L,)
  int n_slots;    // L
  int pos, window;
  __device__ int row(int slot) const {
    if (slot >= n_slots) return INVALID;
    const int p = __ldg(sp + slot);
    const bool ok = p >= 0 && p <= pos && (window <= 0 || p > pos - window);
    return ok ? every_row(slot) : INVALID;
  }
  __device__ int every_slots() const { return n_slots; }
  __device__ int every_row(int slot) const { return CODES ? -2 - slot : slot; }
};

// Logical slots through a block table (K3, K3q): an id below Nn names a
// native page, one in [Nn, Nn + Nq) code page id - Nn, anything else is
// unallocated. Slot j lies at page row j % ps. A row with no valid slot
// reads every table slot (``every_slots()``), an unallocated page where the
// plain version's clamped gather reads it (``every_row``: code page
// clamp(id - Nn, 0, Nq - 1) when the pool has code pages, else native page
// clamp(id, 0, Nn - 1); page 0 of its region for -1).
struct PagedSlots {
  const int* bt;    // this batch row's block table (MP,)
  int n_slots;      // min(pos + 1, MP * ps): slots past pos or the table are invalid
  int Nn, Nq, ps;
  int table_slots;  // MP * ps
  __device__ int row(int slot) const {
    if (slot >= n_slots) return INVALID;
    const int page = __ldg(bt + slot / ps);
    if (page >= 0 && page < Nn) return page * ps + slot % ps;
    if (page >= Nn && page - Nn < Nq) return -2 - ((page - Nn) * ps + slot % ps);
    return INVALID;
  }
  __device__ int every_slots() const { return table_slots; }
  __device__ int every_row(int slot) const {
    const int page = __ldg(bt + slot / ps), r = slot % ps;
    if (page >= 0 && page < Nn) return page * ps + r;
    if (Nq) return -2 - (min(max(page - Nn, 0), Nq - 1) * ps + r);
    return min(max(page, 0), Nn - 1) * ps + r;
  }
};

// The code rows a source's rows <= -2 name (K2q, K3q): row r's HD codes at
// k/v + r * row_stride, its scales at ks/vs[r * scale_stride]. SCALED
// false: rows of an unscaled storage cast, HD values of C a row and no
// scales (ks, vs unread).
template <typename C, bool SCALED_ = true> struct CodeRows {
  static constexpr bool ON = true;
  static constexpr bool SCALED = SCALED_;
  using Code = C;
  const C* k;
  const C* v;
  const float* ks;
  const float* vs;
  size_t row_stride, scale_stride;
};
// No code rows (K2, K3).
struct NoCodes {
  static constexpr bool ON = false;
  static constexpr bool SCALED = true;
  using Code = uint8_t;
};

// Which products a dtype runs on, and its CTA: bf16 four warps per 16
// query heads, f32 one warp per query head.
template <typename T> struct Route {
  static constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int MAX_THREADS = MMA ? 256 : 1024;
  static int threads(int G) { return MMA ? 128 * ((G + 15) / 16) : 32 * G; }
  // The register cap of a kernel whose source names code rows
  // (__maxnreg__, in place of K2's __launch_bounds__(MAX_THREADS)): as many
  // CTAs of 128 threads a SM as their shared memory allows, five at hd <=
  // 64 (96 registers) and three at hd 128 (168); f32 CTAs of up to 1,024
  // threads 64. Left free, the dequantization's registers take a bf16
  // thread to 120 (four CTAs a SM), and the 64 clusters of K2q at B 8 no
  // longer run in one wave. At hd 256 (bf16 only) the O accumulator alone
  // is 128 registers and shared memory allows one CTA a SM: no cap below
  // the 255 a thread may have.
  static constexpr int code_regs(int hd) {
    return !MMA ? 64 : hd > 128 ? 255 : hd > 64 ? 168 : 96;
  }
};

// Shared memory in bytes: the K and V rings, the rows of each stage's
// slots, q (f32), and the partial (acc, m, l) that the combine reads.
template <typename T, int HD> struct Smem {
  static constexpr int CPR = HD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  static constexpr int ROW = (CPR + 1) * 16;            // bytes between K (and V) rows
  static constexpr int K_OFF = 0;                       // [stage][BL] rows
  static constexpr int V_OFF = K_OFF + STAGES * BL * ROW;
  static constexpr int ROWS_OFF = V_OFF + STAGES * BL * ROW;  // int [stage][BL]
  static constexpr int Q_OFF = ROWS_OFF + STAGES * BL * 4;    // f32 [G][HD]
  // then acc f32 [G][HD], m f32 [G], l f32 [G]
  static size_t bytes(int G) { return Q_OFF + (size_t)G * HD * 4 * 2 + (size_t)G * 8; }
};

// Smem<T, hd>::bytes(G) for a runtime hd (0 if hd is unsupported).
template <typename T> size_t smem_bytes(int hd, int G) {
  switch (hd) {
    case 32: return Smem<T, 32>::bytes(G);
    case 64: return Smem<T, 64>::bytes(G);
    case 128: return Smem<T, 128>::bytes(G);
    case 256: return Smem<T, 256>::bytes(G);  // above a CTA's limit for float32
    default: return 0;
  }
}

// The CUDA-core route (float32): warp g is query head g, lane `lane` scores
// slots lane and lane + 32 and owns output dims [lane * PER, lane * PER +
// PER). p needs no rounding: the value dtype is float32.
template <int HD> struct WarpPerHead {
  using S = Smem<float, HD>;
  static constexpr int CPR = S::CPR;  // 16-byte chunks (four values) per row
  static constexpr int PER = HD / 32;
  static_assert(PER == 1 || PER == 2 || PER == 4, "HD must be 32, 64, 128");
  int g, lane;
  float m, l, acc[PER];

  __device__ void init(const float* Qs, int G) {
    g = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    m = repro::NEG_INF;
    l = 0.f;
#pragma unroll
    for (int d = 0; d < PER; ++d) acc[d] = 0.f;
  }

  __device__ void tile(const char* Kt, const char* Vt, const int* R, const float* Qs,
                       float scale) {
    const float4* q4 = reinterpret_cast<const float4*>(Qs + g * HD);
    const float4* k0 = reinterpret_cast<const float4*>(Kt + lane * S::ROW);
    const float4* k1 = reinterpret_cast<const float4*>(Kt + (lane + 32) * S::ROW);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int c = 0; c < CPR; ++c) {
      const float4 q = q4[c], a = k0[c], b = k1[c];
      s0 = fmaf(q.x, a.x, s0), s1 = fmaf(q.x, b.x, s1);
      s0 = fmaf(q.y, a.y, s0), s1 = fmaf(q.y, b.y, s1);
      s0 = fmaf(q.z, a.z, s0), s1 = fmaf(q.z, b.z, s1);
      s0 = fmaf(q.w, a.w, s0), s1 = fmaf(q.w, b.w, s1);
    }
    s0 = R[lane] != INVALID ? s0 * scale : repro::NEG_INF;
    s1 = R[lane + 32] != INVALID ? s1 * scale : repro::NEG_INF;

    const float m_new = fmaxf(m, repro::warp_max(fmaxf(s0, s1)));
    const float alpha = expf(m - m_new);
    const float p0 = expf(s0 - m_new);
    const float p1 = expf(s1 - m_new);
    l = l * alpha + repro::warp_sum(p0 + p1);
    m = m_new;

#pragma unroll
    for (int d = 0; d < PER; ++d) acc[d] *= alpha;
    const float* vcol = reinterpret_cast<const float*>(Vt) + lane * PER;
    constexpr int VROW = S::ROW / 4;  // floats between V rows
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float pa = __shfl_sync(0xffffffffu, p0, j);
      const float pb = __shfl_sync(0xffffffffu, p1, j);
      float va[PER], vb[PER];
#pragma unroll
      for (int d = 0; d < PER; ++d) va[d] = vcol[j * VROW + d], vb[d] = vcol[(j + 32) * VROW + d];
#pragma unroll
      for (int d = 0; d < PER; ++d) {
        acc[d] = fmaf(pa, va[d], acc[d]);
        acc[d] = fmaf(pb, vb[d], acc[d]);
      }
    }
  }

  // The CTA's partial: each warp's own head.
  __device__ void partial(char* scratch, float* ACC, float* Ms, float* Ls, int G) const {
#pragma unroll
    for (int d = 0; d < PER; ++d) ACC[g * HD + lane * PER + d] = acc[d];
    if (lane == 0) {
      Ms[g] = m;
      Ls[g] = l;
    }
  }
};

// The tensor-core route (bf16): the CTA is four warps per 16 query heads.
// Warp w takes heads 16 (w / 4) .. +15 as the M rows of m16n8k16 products
// and slots 16 (w % 4) .. +15 of every tile, with an online softmax of its
// own (flash-decoding again, inside the CTA); lane t holds rows r0 = 16 (w
// / 4) + t / 4 and r1 = r0 + 8 and, of each 8-column block, the columns 2
// (t % 4), +1. A warp whose slots of a tile are all masked (the tile has a
// valid slot elsewhere) keeps m = -1e30 until it sees a valid slot, and a
// partial with m = -1e30 weighs exp(-1e30 - M) = 0 in every merge.
//
// At hd 256 the O accumulator alone is 128 f32 registers a thread, and q's
// fragments would add 64 more (a bf16 thread held 149 registers at hd 128),
// so there (QREG false) q's fragment of each k-step is packed again from
// the f32 q in shared memory as the tile's product needs it: eight 4-byte
// shared loads and four packs a k-step, against a tile's 64 rows of 512
// bytes of K and of V from device memory.
template <int HD> struct MmaHeads {
  using S = Smem<__nv_bfloat16, HD>;
  static constexpr int KC = HD / 16;  // 16-wide k-steps of q K^T; pairs of 8-dim blocks of O
  static constexpr bool QREG = KC <= 8;  // q's fragments held in registers (hd <= 128)
  int w, lane, cb, r0, r1, g;
  bool two_rows;          // rows r1 hold heads (G > r0's block + 8); else they are zeros
  uint32_t qa[QREG ? KC : 1][4];  // q as the A operand of S = q K^T (QREG)
  float o[2 * KC][4];     // O = P V, one accumulator per 8-dim block
  float m[2], l[2];

  // q's A fragment of k-step kc, from the f32 q in shared memory
  __device__ void q_frag(const float* Qs, int kc, uint32_t (&a)[4]) const {
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 4; ++h) {  // a[0]: r0 low, a[1]: r1 low, a[2]: r0 high, a[3]: r1 high
      const int r = (h & 1) ? r1 : r0;
      const int d = 16 * kc + 8 * (h >> 1) + c;
      a[h] = r < g ? repro::sm90::pack_bf16(Qs[r * HD + d], Qs[r * HD + d + 1]) : 0u;
    }
  }

  __device__ void init(const float* Qs, int G) {
    w = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    cb = w & 3;
    r0 = 16 * (w >> 2) + (lane >> 2);
    r1 = r0 + 8;
    g = G;
    two_rows = 16 * (w >> 2) + 8 < G;
    if constexpr (QREG) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) q_frag(Qs, kc, qa[kc]);
    }
#pragma unroll
    for (int b = 0; b < 2 * KC; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[b][e] = 0.f;
    m[0] = m[1] = repro::NEG_INF;
    l[0] = l[1] = 0.f;
  }
  __device__ void tile(const char* Kt, const char* Vt, const int* R, const float* Qs,
                       float scale) {
    const int mi = lane >> 3, ri = lane & 7, c = 2 * (lane & 3);
    const uint32_t kb = repro::sm90::smem_u32(Kt) + 16 * cb * S::ROW;  // this warp's 16 slots
    const uint32_t vb = repro::sm90::smem_u32(Vt) + 16 * cb * S::ROW;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    // S = q K^T: K rows are slots, hd contiguous, which is B's column-major layout
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t b[4], qf[4];
      if constexpr (QREG) {
#pragma unroll
        for (int h = 0; h < 4; ++h) qf[h] = qa[kc][h];
      } else {
        q_frag(Qs, kc, qf);
      }
      repro::sm90::ldmatrix_x4(b, kb + (8 * (mi >> 1) + ri) * S::ROW + (16 * kc + 8 * (mi & 1)) * 2);
      repro::sm90::mma_m16n8k16_bf16(s[0], qf, b[0], b[1]);
      repro::sm90::mma_m16n8k16_bf16(s[1], qf, b[2], b[3]);
    }
    // mask, scale and the online softmax on the fragment
    float mx0 = repro::NEG_INF, mx1 = repro::NEG_INF;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int2 ok = *reinterpret_cast<const int2*>(R + 16 * cb + 8 * nb + c);
      s[nb][0] = ok.x != INVALID ? s[nb][0] * scale : repro::NEG_INF;
      s[nb][1] = ok.y != INVALID ? s[nb][1] * scale : repro::NEG_INF;
      s[nb][2] = ok.x != INVALID ? s[nb][2] * scale : repro::NEG_INF;
      s[nb][3] = ok.y != INVALID ? s[nb][3] * scale : repro::NEG_INF;
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float alpha0 = expf(m[0] - mn0);
    const float alpha1 = two_rows ? expf(m[1] - mn1) : 1.f;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[4];  // P as the A operand of O += P V (this warp's 16 slots)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const float p0 = expf(s[nb][0] - mn0), p1 = expf(s[nb][1] - mn0);
      float p2 = 0.f, p3 = 0.f;
      if (two_rows) p2 = expf(s[nb][2] - mn1), p3 = expf(s[nb][3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[2 * nb] = repro::sm90::pack_bf16(p0, p1);  // p in bf16
      pa[2 * nb + 1] = repro::sm90::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    l[0] = l[0] * alpha0 + sum0;
    l[1] = l[1] * alpha1 + sum1;
    m[0] = mn0;
    m[1] = mn1;
    // O = alpha O + P V: V rows are slots, hd contiguous; ldmatrix.trans gives B
#pragma unroll
    for (int dp = 0; dp < KC; ++dp) {
      uint32_t b[4];
      repro::sm90::ldmatrix_x4_trans(b, vb + (8 * (mi & 1) + ri) * S::ROW + (16 * dp + 8 * (mi >> 1)) * 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* od = o[2 * dp + h];
        od[0] *= alpha0, od[1] *= alpha0, od[2] *= alpha1, od[3] *= alpha1;
        repro::sm90::mma_m16n8k16_bf16(o[2 * dp + h], pa, b[2 * h], b[2 * h + 1]);
      }
    }
  }

  // Merge the four warps' partials of each head (in slot-block order) into
  // the CTA's (ACC, Ms, Ls). The warps' partials go to ``scratch`` (the K/V
  // ring, free once every copy has landed: 16 G HD bytes fit there).
  __device__ void partial(char* scratch, float* ACC, float* Ms, float* Ls, int G) const {
    float* WACC = reinterpret_cast<float*>(scratch);  // [4][G][HD]
    float* WM = WACC + 4 * G * HD;                     // [4][G]
    float* WL = WM + 4 * G;                            // [4][G]
    const int c = 2 * (lane & 3);
    __syncthreads();  // every warp is done reading the ring
#pragma unroll
    for (int b = 0; b < 2 * KC; ++b) {
      float* a0 = WACC + (cb * G + r0) * HD + 8 * b + c;
      float* a1 = WACC + (cb * G + r1) * HD + 8 * b + c;
      if (r0 < G) a0[0] = o[b][0], a0[1] = o[b][1];
      if (r1 < G) a1[0] = o[b][2], a1[1] = o[b][3];
    }
    if ((lane & 3) == 0) {
      if (r0 < G) WM[cb * G + r0] = m[0], WL[cb * G + r0] = l[0];
      if (r1 < G) WM[cb * G + r1] = m[1], WL[cb * G + r1] = l[1];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
      const int h = idx / HD;
      float M = repro::NEG_INF;
#pragma unroll
      for (int k = 0; k < 4; ++k) M = fmaxf(M, WM[k * G + h]);
      float acc = 0.f, lsum = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float wk = expf(WM[k * G + h] - M);
        acc = fmaf(wk, WACC[k * G * HD + idx], acc);
        lsum = fmaf(wk, WL[k * G + h], lsum);
      }
      ACC[idx] = acc;
      if (idx % HD == 0) Ms[h] = M, Ls[h] = lsum;
    }
  }
};

// The partial of a row with no valid slot: this rank's tiles' slots (tile
// t = rank, rank + SPLIT, ... of 64, below src.every_slots()), each read
// at src.every_row, their V summed in f32 for each of the G heads (ACC),
// m = 0 and l = the number of slots (-1e30 and 0 for a rank with none), so
// the combine gives the mean. A thread takes 8 dims of every lanes-th slot
// (a code row dequantized and rounded to T as `dequantize_kv` does), and
// the lanes are summed in ``scratch`` (the K/V ring, free once the main
// pass is done).
template <typename T, int HD, typename Source, typename Codes>
__device__ __forceinline__ void mean_of_v(const Source& src, const Codes& codes,
                                          const T* __restrict__ v_base, size_t row_stride,
                                          int rank, int G, char* scratch, float* ACC,
                                          float* Ms, float* Ls) {
  constexpr int NCH = HD / 8;  // 8-dim chunks of a row
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lanes = nthreads / NCH, lane = tid / NCH, c = tid % NCH;
  const int n = src.every_slots();
  int cnt = 0;
  for (int t = rank; t * BL < n; t += SPLIT) cnt += min(BL, n - t * BL);
  float acc[8] = {};
#pragma unroll 4
  for (int k = lane; k < cnt; k += lanes) {
    const int row = src.every_row((rank + k / BL * SPLIT) * BL + k % BL);
    float f[8] = {};
    if (row >= 0) {
      const T* p = v_base + (size_t)row * row_stride + c * 8;
      if constexpr (std::is_same<T, float>::value) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
        f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
        f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
      } else {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = repro::to_f(h[e]);
      }
    } else if constexpr (Codes::ON) {
      const size_t qr = (size_t)(-2 - row);
      using C = typename Codes::Code;
      if constexpr (Codes::SCALED) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(codes.v + qr * codes.row_stride + c * 8));
        const float sc = __ldg(codes.vs + qr * codes.scale_stride);
        repro::codes8_to_f<C>(u, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = repro::to_f(repro::from_f<T>(f[e] * sc));
      } else {
        repro::vals8_to_f<C>(codes.v + qr * codes.row_stride + c * 8, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = repro::to_f(repro::from_f<T>(f[e]));
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += f[e];
  }
  float* part = reinterpret_cast<float*>(scratch);  // [lanes][HD]
#pragma unroll
  for (int e = 0; e < 8; ++e) part[lane * HD + c * 8 + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < HD; d += nthreads) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += part[l * HD + d];
    for (int h = 0; h < G; ++h) ACC[h * HD + d] = s;
  }
  for (int h = tid; h < G; h += nthreads) {
    Ms[h] = cnt ? 0.f : repro::NEG_INF;
    Ls[h] = (float)cnt;
  }
}

// Decode attention of the G query heads at ``q_grp`` (G x HD, contiguous)
// over the slots that ``src`` names, into ``out_grp`` (G x HD); ``codes``
// holds the code rows a source names (NoCodes: it names none, and k_base
// and v_base may be null when it names no native row). Called by every
// thread of every CTA of the cluster (Route<T>::threads(G) threads), with
// dynamic shared memory of Smem<T, HD>::bytes(G).
template <typename T, int HD, typename Source, typename Codes = NoCodes>
__device__ __forceinline__ void attend(const Source& src, int G, const T* __restrict__ q_grp,
                                       const T* __restrict__ k_base,
                                       const T* __restrict__ v_base, size_t row_stride,
                                       T* __restrict__ out_grp, float scale,
                                       const Codes& codes = Codes{}) {
  namespace cg = cooperative_groups;
  using S = Smem<T, HD>;
  using Heads = std::conditional_t<Route<T>::MMA, MmaHeads<HD>, WarpPerHead<HD>>;
  constexpr int CPR = S::CPR;
  constexpr int VEC = 16 / (int)sizeof(T);
  using C = typename Codes::Code;
  constexpr int CSZ = (int)sizeof(C);
  constexpr int CCH = HD * CSZ / 16;                    // 16-byte chunks of a code row
  constexpr int CODE_STEP = 16 / CSZ * (int)sizeof(T);  // bytes of a code chunk's values in T
  // a float store under bf16: each chunk is converted as it is loaded
  constexpr bool WIDE = Codes::ON && CSZ > (int)sizeof(T);
  static_assert(!WIDE || !Codes::SCALED, "codes are one byte");
  static_assert(HD % 32 == 0 && (HD * (int)sizeof(T)) % 16 == 0, "HD must be 32, 64, 128, 256");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  int* ROWS = reinterpret_cast<int*>(sm + S::ROWS_OFF);
  float* Qs = reinterpret_cast<float*>(sm + S::Q_OFF);
  float* ACC = Qs + G * HD;
  float* Ms = ACC + G * HD;
  float* Ls = Ms + G;

  // this rank's tiles: rank, rank + SPLIT, ... below ntiles
  const int ntiles = (src.n_slots + BL - 1) / BL;
  const int mine = ntiles > rank ? (ntiles - 1 - rank) / SPLIT + 1 : 0;

  // The rows of tile i's slots: thread tid resolves slots tid and
  // tid + nthreads (nthreads >= 32), into registers.
  auto fetch = [&](int i, int (&pre)[2]) {
    const int slot0 = (rank + i * SPLIT) * BL;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = tid + k * nthreads;
      pre[k] = i < mine && j < BL ? src.row(slot0 + j) : INVALID;
    }
  };
  // Store fetched rows as stage s's; true when the tile has a valid slot.
  auto publish = [&](int s, const int (&pre)[2]) {
    int any = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = tid + k * nthreads;
      if (j < BL) {
        ROWS[s * BL + j] = pre[k];
        any |= pre[k] != INVALID;
      }
    }
    return __syncthreads_or(any) != 0;
  };
  // Copy stage s's K and V rows into the ring: native rows as they are,
  // zeros for invalid ones (cp.async of 0 bytes from a valid address), code
  // rows as code chunks, each with the row's scale beside it.
  auto issue = [&](int s) {
    const uint32_t kb = repro::sm90::smem_u32(sm + S::K_OFF + s * BL * S::ROW);
    const uint32_t vb = repro::sm90::smem_u32(sm + S::V_OFF + s * BL * S::ROW);
    for (int i = tid; i < 2 * BL * CPR; i += nthreads) {
      const bool is_v = i >= BL * CPR;
      const int ii = is_v ? i - BL * CPR : i;
      const int r = ii / CPR, c = ii % CPR;
      const int row = ROWS[s * BL + r];
      const T* base = is_v ? v_base : k_base;
      const void* from = base + (row >= 0 ? (size_t)row * row_stride + c * VEC : 0);
      if constexpr (Codes::ON) {
        if (row < INVALID) continue;  // a code row: below
        if (row < 0) from = codes.k;  // k_base may be null: any valid address
      }
      repro::sm90::cp_async16((is_v ? vb : kb) + r * S::ROW + c * 16, from, row >= 0 ? 16 : 0);
    }
    if constexpr (Codes::ON) {
      for (int i = tid; i < 2 * BL * CCH; i += nthreads) {
        const bool is_v = i >= BL * CCH;
        const int ii = is_v ? i - BL * CCH : i;
        const int r = ii / CCH, c = ii % CCH;
        const int row = ROWS[s * BL + r];
        if (row >= INVALID) continue;
        const size_t qr = (size_t)(-2 - row);
        const C* from = (is_v ? codes.v : codes.k) + qr * codes.row_stride + c * (16 / CSZ);
        if constexpr (WIDE) {  // 4 floats rounded to bf16: 8 bytes of the row
          float f[4];
          repro::unpack<float>(f, __ldg(reinterpret_cast<const uint4*>(from)));
          *reinterpret_cast<uint2*>(sm + (is_v ? S::V_OFF : S::K_OFF) + (s * BL + r) * S::ROW +
                                    c * CODE_STEP) =
              make_uint2(repro::sm90::pack_bf16(f[0], f[1]), repro::sm90::pack_bf16(f[2], f[3]));
          continue;
        }
        const uint32_t dst = (is_v ? vb : kb) + r * S::ROW + c * CODE_STEP;
        repro::sm90::cp_async16(dst, from, 16);
        if constexpr (Codes::SCALED)
          repro::sm90::cp_async4(dst + 16, (is_v ? codes.vs : codes.ks) + qr * codes.scale_stride,
                                 4);
      }
    }
  };
  // Dequantize this thread's code chunks of stage s in place (the chunks
  // and scales its own issue(s) copied, landed for it after its wait).
  auto dequant = [&](int s) {
    if constexpr (Codes::ON && !WIDE) {
      for (int i = tid; i < 2 * BL * CCH; i += nthreads) {
        const bool is_v = i >= BL * CCH;
        const int ii = is_v ? i - BL * CCH : i;
        const int r = ii / CCH, c = ii % CCH;
        if (ROWS[s * BL + r] >= INVALID) continue;
        char* at = sm + (is_v ? S::V_OFF : S::K_OFF) + (s * BL + r) * S::ROW + c * CODE_STEP;
        const uint4 u = *reinterpret_cast<const uint4*>(at);
        if constexpr (!Codes::SCALED) {
          repro::cast_chunk<C, T>(u, at);
          continue;
        }
        const float sc = *reinterpret_cast<const float*>(at + 16);
        if constexpr (Route<T>::MMA) {  // the upper 8 values first: they cover the scale
          reinterpret_cast<uint4*>(at)[1] = repro::dequant8_bf16<C>(make_uint2(u.z, u.w), sc);
          reinterpret_cast<uint4*>(at)[0] = repro::dequant8_bf16<C>(make_uint2(u.x, u.y), sc);
        } else {
          float d[16];
          repro::store_dequant16<C, T>(d, u, sc);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            reinterpret_cast<float4*>(at)[e] = make_float4(d[4 * e], d[4 * e + 1], d[4 * e + 2],
                                                           d[4 * e + 3]);
        }
      }
    }
  };

  int pre0[2], pre1[2];
  fetch(0, pre0);
  fetch(1, pre1);
  repro::load_rows<T, HD>(Qs, HD, q_grp, HD, 0, G, G, tid, nthreads);
  bool any0 = publish(0, pre0);  // its barrier also publishes q
  if (any0) issue(0);
  repro::sm90::cp_async_commit();
  bool any1 = publish(1, pre1);
  if (any1) issue(1);
  repro::sm90::cp_async_commit();

  Heads heads;
  heads.init(Qs, G);

  for (int i = 0; i < mine; ++i) {
    const int s = i & 1;
    int pre[2];
    fetch(i + 2, pre);  // in flight while tile i computes
    repro::sm90::cp_async_wait<1>();  // tile i has landed (only i + 1's group may be pending)
    const bool any = s ? any1 : any0;
    if (any) dequant(s);
    __syncthreads();
    if (any)
      heads.tile(sm + S::K_OFF + s * BL * S::ROW, sm + S::V_OFF + s * BL * S::ROW,
                 ROWS + s * BL, Qs, scale);
    bool more = false;
    if (i + 2 < mine) {  // tile i + 2 takes stage s
      __syncthreads();   // every thread is done with stage s
      more = publish(s, pre);
      if (more) issue(s);
    }
    repro::sm90::cp_async_commit();  // possibly empty: keeps one group per tile
    if (s) any1 = more; else any0 = more;
  }
  repro::sm90::cp_async_wait<0>();

  // this rank's partial, then the combine: rank r takes the r-th eighth of
  // the G x HD outputs (G * HD is a multiple of 32)
  heads.partial(sm + S::K_OFF, ACC, Ms, Ls, G);
  cluster.sync();
  // no rank saw a valid slot: the mean of V over every slot (header)
  bool none = true;
#pragma unroll
  for (int r = 0; r < SPLIT; ++r) none &= cluster.map_shared_rank(Ms, r)[0] == repro::NEG_INF;
  if (none) {
    cluster.sync();  // every rank has read the m's before any rank rewrites its own
    mean_of_v<T, HD>(src, codes, v_base, row_stride, rank, G, sm + S::K_OFF, ACC, Ms, Ls);
    cluster.sync();
  }
  const int chunk = G * HD / SPLIT;
  for (int i = tid; i < chunk; i += nthreads) {
    const int idx = rank * chunk + i, h = idx / HD;
    float mr[SPLIT];
    float M = repro::NEG_INF;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) {
      mr[r] = cluster.map_shared_rank(Ms, r)[h];
      M = fmaxf(M, mr[r]);
    }
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) {
      const float w = expf(mr[r] - M);
      lsum = fmaf(w, cluster.map_shared_rank(Ls, r)[h], lsum);
      o = fmaf(w, cluster.map_shared_rank(ACC, r)[idx], o);
    }
    out_grp[idx] = repro::from_f<T>(o / lsum);
  }
  cluster.sync();  // every rank has read the partials before any CTA exits
}

}  // namespace repro::decode
