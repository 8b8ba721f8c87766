// The core of one-token GQA decode attention for Hopper (sm_90a), shared by
// K2 (decode_attention.cu, over the ring cache), K3 (paged_attention.cu,
// through block tables), K2q (decode_attention_quant.cu, over a ring of
// int8/fp8 codes) and K3q (paged_attention_quant.cu, over a quantized or
// mixed page pool): flash-decoding inside one launch.
//
// A launch's grid is (KVH, B, SPLIT); the SPLIT CTAs of one (KV head, batch
// row) pair form a thread-block cluster, and each takes every SPLIT-th tile
// of BL slots: tile t (slots BL t .. BL t + BL - 1) goes to cluster rank
// t % SPLIT. The partition is a function of the slot index alone, never of
// L, the number of valid slots, the page size or the storage of a row, so a
// dense ring and a paged pool that hold the same positions in the same
// slots run the same arithmetic bit for bit (paged equals dense, native or
// int8), and a row of codes gives the bits of its dequantized row stored
// natively.
//
// Routes (decode_attention.route; Geometry below):
//   route     q      hd             tile  split  stages  products
//   split8    bf16   32, 64, 128    64    8      2       mma.sync, four warps per 16 heads
//   split8    f32    32, 64, 128    64    8      2       CUDA cores, a warp per head
//   split16   bf16   256            32    16     2       mma.sync, warp pairs per 16 slots
//   split16   f32    256            32    16     2       CUDA cores, a warp per head
//
// split8 (granite-3-2b's hd 64, olmoe-1b-7b's hd 128; K2, K3, K2q, K3q):
// eight CTAs, the portable cluster size, and two stages of 64-slot tiles.
// split16 (recurrentgemma-2b's and paligemma-3b's hd 256 on one KV head; K2
// and K2q): one KV head at B 8 is 8 clusters, only 64 CTAs at split8 on 132
// SMs. split16 gives 128 CTAs in one wave; a cluster of 16 is a
// non-portable size. Every kernel on this core launches through
// launch_clusters, which sets the route's cluster size at launch. A bf16
// CTA stays under half of an SM's shared memory (87,632 bytes at a group of 10: the
// partial's accumulator lies in the V ring once the ring is read), so two
// fit an SM, a cluster fits on 8 SMs of one GPC, and the eighth batch row's
// cluster does not wait a wave for 16 free SMs. (A third stage would take a
// CTA past half: one CTA an SM, at most 7 clusters at once on an H100, and
// B 8 in two waves.) K3 and K3q take no hd 256: a later K3 at hd 256 must
// take split16 too (Geometry is a function of T and HD alone), so paged
// still equals dense.
//
// A source says where a slot's K/V rows are: `row(slot)` is
//   >= 0   a native row (in T, rows `row_stride` elements apart from
//          `k_base`/`v_base`);
//   -1     an invalid slot: never read, its rows land as zeros;
//   <= -2  code row -2 - row of the `codes` (CodeRows: HD one-byte codes a
//          row, one f32 scale per row and KV head).
// `n_slots` bounds the slots. RingSlots reads slot_pos (a ring slot is its
// own row), PagedSlots the block table (a slot's pool row, by page id). A
// CTA first resolves its tiles' slots to rows (all its first tiles' loads
// and q's issued before it waits for any); a tile with no valid slot
// is skipped before any K/V load (its scores would all be -1e30: before the
// first valid tile exp(-1e30 - m) = 0 scales it away, after it it adds 0).
// Native rows are copied into shared memory in T by 16-byte cp.async
// copies, invalid rows land as zeros, into a ring of STAGES stages, so a
// CTA's first STAGES tiles are in flight before it computes the first; the
// rows of tile i + STAGES are resolved into registers while tile i
// computes. K and V rows lie an odd number of 16-byte chunks apart, so
// eight rows' chunks at one column fall into eight different bank groups
// (for ldmatrix and for the lanes' 16-byte reads).
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
//   zero), and the CTA is four warps per 16 heads. split8: warp w takes
//   slots 16 (w % 4) .. +15 of every tile with an online softmax of its
//   own, and the four partials are merged at the end. split16 (MmaPairs):
//   the warps pair up over the two 16-slot blocks of a 32-slot tile; both
//   warps of a pair compute the same S and softmax, and each accumulates
//   P V for half of the 256 output dims (64 registers of O a thread, not
//   128), so K2q's kernel runs under a register cap of 128 with room for
//   its dequantization; q's fragments are packed once, in fragment order,
//   into shared memory (one 16-byte load a k-step), and the S products run
//   in two chains (even and odd k-steps). A split16 CTA is eight warps
//   whatever the group: at a group of up to 16 the four past its head
//   block compute nothing but share the copies, the dequantization and the
//   combine. S = q K^T reads K by ldmatrix
//   as it lies, the softmax runs on S's accumulator fragment (quad
//   shuffles), and P, rounded to bf16, is the register A operand of
//   O += P V, V read by ldmatrix.trans. Decode is byte-bound in FLOPs, but
//   on the CUDA cores the conversions, shuffles and shared-memory reads of
//   G warps that each redo the whole tile take as long as the bytes; here a
//   warp does its quarter of a tile in about a hundred instructions.
// - float32: on the CUDA cores, one warp per query head of the group
//   (G = H / KVH <= 32): each lane scores the slots lane (and lane + 32 in a
//   64-slot tile) against q (f32 in shared memory) and owns HD/32
//   contiguous output dims (8 at hd 256).
//
// The combine, in the same launch: rank r combines the r-th SPLIT-th of the
// G x HD outputs from the SPLIT partials (m, l, acc) per query head, in
// rank order: out = sum w_s acc_s, w_s = exp(m_s - M) / sum exp(m_t - M) l_t,
// M = max m_s. A rank with no valid tile leaves m = -1e30, l = 0, acc = 0,
// so it adds nothing. Every CTA pushes the r-th share of its partial, and
// its m and l, into rank r's shared memory (posted stores of distributed
// shared memory), the cluster meets once, and each rank combines what it
// was sent from its own shared memory, the weights computed once per
// (head, rank). No CTA reads another's, so none waits for another to
// exit. A CTA touches another's shared memory only once every CTA of the
// cluster has started: each arrives at the cluster barrier (relaxed) after
// its first copies are issued and waits there before its first push, which
// the main pass has long made true by then. Pulling the partials instead
// (each rank reading its share from the others) costs two round trips of
// distributed shared memory and a second barrier before exit (PERF.md).
//
// A row with no valid slot at all (every rank's m still -1e30 once the
// cluster has met) gets what the TPU kernel and the plain version give it:
// a uniform softmax over its masked scores, the mean of V over every slot
// the plain version gathers (the whole ring for K2 and K2q; every table
// slot for K3 and K3q, an unallocated page read as page 0 of the pool's
// code region, or of the native one when it has none). Then each rank
// leaves the sum of V over its tiles' slots as its partial (``mean_of_v``:
// m 0, l the number of slots) and the combine divides; a row with a valid
// slot pays one read of the ranks' m's for it. The main pass keeps its
// registers: the sum runs after it, on plain loads. No scratch in device
// memory, no atomics, no second launch: the result does not depend on the
// order in which CTAs run, and each call is one kernel launch.
//
// Shared memory at split8 (Smem): beside the rings and their rows, q
// (f32), the partial and the partials the others push, G x (12 HD + 8 SPLIT
// + 8) bytes (granite-3-2b's G 4 at hd 64 in bf16: 40,736 bytes in all,
// five CTAs an SM). At hd 256 (K2 and K2q): a bf16 row is 512 bytes (528
// apart), two stages of 32 K and V rows take 67,584 bytes, q's fragments
// 8 KB per 16 heads, the partials the other ranks push G x 1,152 bytes:
// 87,632 bytes at a group of 10 (121,344 at 32: one CTA a SM). An f32 row
// is 1,024 bytes (1,040 apart): two stages take 133,120 bytes, q and the
// pushed partials another 2,176 bytes a head: 203,264 bytes at a group of
// 32, within the 232,448 a CTA may have, so every group up to 32 runs in
// both dtypes.
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

constexpr int INVALID = -1;  // a source's row for a slot that is not read

// A source resolves a slot in two steps: ``load(slot)`` reads what the
// slot's row depends on (-1 past n_slots), ``row(slot, loaded)`` gives the
// row, so a CTA issues all its loads before it waits for any.
//
// Ring slots (K2, K2q): a slot reads its own row when its position is
// visible to pos; with CODES that row is a code row. A row with no valid
// slot reads every slot below ``every_slots()``, each its own row
// (``every_row``).
template <bool CODES> struct RingSlots {
  const int* sp;  // this batch row's slot_pos (L,)
  int n_slots;    // L
  int pos, window;
  __device__ int load(int slot) const { return slot < n_slots ? __ldg(sp + slot) : -1; }
  __device__ int row(int slot, int p) const {
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
  __device__ int load(int slot) const { return slot < n_slots ? __ldg(bt + slot / ps) : -1; }
  __device__ int row(int slot, int page) const {
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
  static int threads(int G) { return MMA ? 128 * ((G + 15) / 16) : 32 * G; }
  // The register cap of every kernel on this core (__maxnreg__): as many
  // CTAs of 128 threads a SM as their shared memory allows, five at hd <=
  // 64 (96 registers) and three at hd 128 (168); f32 CTAs of up to 1,024
  // threads 64. Left free, the dequantization's registers take a bf16
  // thread to 120, and K2's own to 112 (four CTAs a SM): the 64 clusters of
  // granite-3-2b's decode at B 8 then no longer fit the card at once, and
  // a second wave starts 7.8 us late. At hd 256 split16's warp pairs hold
  // 64 registers of O a thread: 128 leaves the dequantization room, and two
  // CTAs of up to 256 threads still fit an SM's registers.
  static constexpr int max_regs(int hd) {
    return !MMA ? 64 : hd > 128 ? 128 : hd > 64 ? 168 : 96;
  }
};

// A route's geometry (the header's table): slots a tile, CTAs a cluster,
// stages of the K/V ring. A function of T and HD alone, so every kernel on
// this core that takes a (T, HD) partitions slots the same way.
template <typename T, int HD> struct Geometry {
  static constexpr bool WIDE = HD > 128;  // split16
  static constexpr int BL = WIDE ? 32 : 64;
  static constexpr int SPLIT = WIDE ? 16 : 8;  // 8: the portable cluster size
  static constexpr int STAGES = 2;
  // q as packed bf16 fragments (split16 bf16) rather than f32 rows
  static constexpr bool QFRAG = WIDE && Route<T>::MMA;
  // threads a CTA: Route's, but split16 bf16 always runs eight warps, the
  // four past the group's head blocks (G <= 16) copying and dequantizing
  // tiles with the others and computing none
  static int threads(int G) { return QFRAG ? 256 : Route<T>::threads(G); }
};

// Shared memory in bytes: the K and V rings, the rows of each stage's
// slots, q, the partial (acc, m, l) and the partials the other ranks push.
template <typename T, int HD> struct Smem {
  using Gm = Geometry<T, HD>;
  static constexpr int CPR = HD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  static constexpr int ROW = (CPR + 1) * 16;            // bytes between K (and V) rows
  static constexpr int RING = Gm::STAGES * Gm::BL * ROW;  // bytes of the K (or V) ring
  static constexpr int K_OFF = 0;                       // [stage][BL] rows
  static constexpr int V_OFF = K_OFF + RING;
  static constexpr int ROWS_OFF = V_OFF + RING;         // int [stage][BL]
  static constexpr int Q_OFF = ROWS_OFF + Gm::STAGES * Gm::BL * 4;
  // q: f32 [G][HD], or (QFRAG) uint4 [G / 16][HD / 16][32], each lane's A
  // fragment of a k-step
  __host__ __device__ static size_t q_bytes(int G) {
    return Gm::QFRAG ? (size_t)((G + 15) / 16) * (HD / 16) * 32 * 16 : (size_t)G * HD * 4;
  }
  // acc f32 [G][HD]: after q; at split16 in the V ring (the main pass is
  // done with it when the partial is written; mean_of_v's scratch and the
  // warps' partials lie in the K ring; at split8 the four warps' partials
  // may fill both rings). After them the partials the other ranks push: m
  // f32 [SPLIT][G], l f32 [SPLIT][G], acc f32 [SPLIT][G HD / SPLIT] (this
  // rank's share of the outputs)
  __host__ __device__ static size_t acc_off(int G) { return Gm::WIDE ? V_OFF : Q_OFF + q_bytes(G); }
  __host__ __device__ static size_t recv_off(int G) {
    return Q_OFF + q_bytes(G) + (Gm::WIDE ? 0 : (size_t)G * HD * 4);
  }
  // then m f32 [G], l f32 [G]
  __host__ __device__ static size_t m_off(int G) {
    return recv_off(G) + (size_t)G * HD * 4 + (size_t)Gm::SPLIT * G * 8;
  }
  __host__ __device__ static size_t bytes(int G) { return m_off(G) + (size_t)G * 8; }
  static_assert(!Gm::WIDE || RING >= 32 * HD * 4, "acc of 32 heads fits the V ring");
};

// Smem<T, hd>::bytes(G) for a runtime hd (0 if hd is unsupported).
template <typename T> size_t smem_bytes(int hd, int G) {
  switch (hd) {
    case 32: return Smem<T, 32>::bytes(G);
    case 64: return Smem<T, 64>::bytes(G);
    case 128: return Smem<T, 128>::bytes(G);
    case 256: return Smem<T, 256>::bytes(G);
    default: return 0;
  }
}

// Geometry<T, hd>::threads(G) for a runtime hd (0 if hd is unsupported).
template <typename T> int cta_threads(int hd, int G) {
  switch (hd) {
    case 32: return Geometry<T, 32>::threads(G);
    case 64: return Geometry<T, 64>::threads(G);
    case 128: return Geometry<T, 128>::threads(G);
    case 256: return Geometry<T, 256>::threads(G);
    default: return 0;
  }
}

// The CUDA-core route (float32): warp g is query head g, lane `lane` scores
// slot lane of a 32-slot tile (split16), or slots lane and lane + 32 of a
// 64-slot one, and owns output dims [lane * PER, lane * PER + PER). p needs
// no rounding: the value dtype is float32.
template <int HD> struct WarpPerHead {
  using S = Smem<float, HD>;
  static constexpr int CPR = S::CPR;  // 16-byte chunks (four values) per row
  static constexpr int PER = HD / 32;
  static constexpr bool ONE = Geometry<float, HD>::BL == 32;  // one slot a lane
  static_assert(PER == 1 || PER == 2 || PER == 4 || PER == 8, "HD must be 32, 64, 128, 256");
  int g, lane;
  float m, l, acc[PER];

  __device__ static void load_q(float* Qs, const float* __restrict__ q_grp, int G, int tid,
                                int nthreads) {
    repro::load_rows<float, HD>(Qs, HD, q_grp, HD, 0, G, G, tid, nthreads);
  }

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
    if constexpr (ONE) {
      tile1(Kt, Vt, R, Qs, scale);
      return;
    }
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

  // A 32-slot tile: lane scores slot lane (four partial sums over the row,
  // then added), and every lane adds each slot's p times its 8 dims of V.
  __device__ void tile1(const char* Kt, const char* Vt, const int* R, const float* Qs,
                        float scale) {
    const float4* q4 = reinterpret_cast<const float4*>(Qs + g * HD);
    const float4* k0 = reinterpret_cast<const float4*>(Kt + lane * S::ROW);
    float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < CPR; ++c) {
      const float4 q = q4[c], a = k0[c];
      d4.x = fmaf(q.x, a.x, d4.x), d4.y = fmaf(q.y, a.y, d4.y);
      d4.z = fmaf(q.z, a.z, d4.z), d4.w = fmaf(q.w, a.w, d4.w);
    }
    const float s0 = R[lane] != INVALID ? ((d4.x + d4.y) + (d4.z + d4.w)) * scale
                                        : repro::NEG_INF;
    const float m_new = fmaxf(m, repro::warp_max(s0));
    const float alpha = expf(m - m_new);
    const float p0 = expf(s0 - m_new);
    l = l * alpha + repro::warp_sum(p0);
    m = m_new;
#pragma unroll
    for (int d = 0; d < PER; ++d) acc[d] *= alpha;
    const float4* vcol = reinterpret_cast<const float4*>(Vt + lane * PER * 4);
    constexpr int VROW4 = S::ROW / 16;  // float4s between V rows
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p0, j);
#pragma unroll
      for (int e = 0; e < PER / 4; ++e) {
        const float4 v = vcol[j * VROW4 + e];
        acc[4 * e] = fmaf(pj, v.x, acc[4 * e]);
        acc[4 * e + 1] = fmaf(pj, v.y, acc[4 * e + 1]);
        acc[4 * e + 2] = fmaf(pj, v.z, acc[4 * e + 2]);
        acc[4 * e + 3] = fmaf(pj, v.w, acc[4 * e + 3]);
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

// The tensor-core route of split8 (bf16, hd <= 128): the CTA is four
// warps per 16 query heads. Warp w takes heads 16 (w / 4) .. +15 as the M
// rows of m16n8k16 products and slots 16 (w % 4) .. +15 of every tile, with
// an online softmax of its own (flash-decoding again, inside the CTA); lane
// t holds rows r0 = 16 (w / 4) + t / 4 and r1 = r0 + 8 and, of each
// 8-column block, the columns 2 (t % 4), +1. A warp whose slots of a tile
// are all masked (the tile has a valid slot elsewhere) keeps m = -1e30
// until it sees a valid slot, and a partial with m = -1e30 weighs
// exp(-1e30 - M) = 0 in every merge. q's fragments are held in registers.
template <int HD> struct MmaHeads {
  using S = Smem<__nv_bfloat16, HD>;
  static constexpr int KC = HD / 16;  // 16-wide k-steps of q K^T; pairs of 8-dim blocks of O
  static_assert(KC <= 8, "split8's tensor-core route: HD <= 128");
  int w, lane, cb, r0, r1, g;
  bool two_rows;          // rows r1 hold heads (G > r0's block + 8); else they are zeros
  uint32_t qa[KC][4];     // q as the A operand of S = q K^T
  float o[2 * KC][4];     // O = P V, one accumulator per 8-dim block
  float m[2], l[2];

  __device__ static void load_q(float* Qs, const __nv_bfloat16* __restrict__ q_grp, int G,
                                int tid, int nthreads) {
    repro::load_rows<__nv_bfloat16, HD>(Qs, HD, q_grp, HD, 0, G, G, tid, nthreads);
  }

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
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) q_frag(Qs, kc, qa[kc]);
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
      uint32_t b[4];
      repro::sm90::ldmatrix_x4(b, kb + (8 * (mi >> 1) + ri) * S::ROW + (16 * kc + 8 * (mi & 1)) * 2);
      repro::sm90::mma_m16n8k16_bf16(s[0], qa[kc], b[0], b[1]);
      repro::sm90::mma_m16n8k16_bf16(s[1], qa[kc], b[2], b[3]);
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

// The tensor-core route of split16 (bf16, hd 256): four warps per 16 query
// heads, in two pairs. Warp w takes heads 16 (w / 4) .. +15 (rows r0, r1 as
// in MmaHeads), slots 16 sb .. +15 of every 32-slot tile (sb = w % 2) and
// output dims HD/2 dh .. +HD/2 - 1 (dh = (w / 2) % 2). Both warps of a pair
// (same heads, same sb) run the same S = q K^T over their 16 slots and the
// same online softmax, the same instructions on the same operands, so the
// same bits; each accumulates P V for its half of the dims: 64 registers
// of O a thread. q's fragments are packed once into shared memory in
// fragment order (load_q), one 16-byte load a k-step, not 64 registers.
// The two pairs' partials are merged at the end. The CTA's eight warps
// cover two head blocks; a warp whose block holds no head (G <= 16) skips
// the products.
template <int HD> struct MmaPairs {
  using S = Smem<__nv_bfloat16, HD>;
  static constexpr int KC = HD / 16;  // 16-wide k-steps of q K^T
  static constexpr int DP = HD / 32;  // 16-dim steps of this warp's half of O
  int lane, sb, dh, hb, r0, r1, g;
  bool two_rows;          // rows r1 hold heads; else they are zeros
  float o[2 * DP][4];     // this warp's half of O = P V, one accumulator per 8-dim block
  float m[2], l[2];

  // q (G x HD bf16 in device memory) as the A fragments of S = q K^T:
  // entry (16-head block, k-step kc, lane) holds the lane's four registers,
  // two adjacent bf16 of row r0 or r1 each (a 4-byte load, no rounding);
  // rows past G zeros.
  __device__ static void load_q(float* Qs, const __nv_bfloat16* __restrict__ q_grp, int G,
                                int tid, int nthreads) {
    uint4* Qf = reinterpret_cast<uint4*>(Qs);
    constexpr int U = 4;  // entries a thread loads before it stores any
    const int n = (G + 15) / 16 * KC * 32;
    for (int i0 = tid; i0 < n; i0 += U * nthreads) {
      uint32_t a[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * nthreads;
        const int ln = i % 32, kc = i / 32 % KC, blk = i / (32 * KC);
        const int ra = 16 * blk + ln / 4, d = 16 * kc + 2 * (ln % 4);
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // a[0]: r0 low, a[1]: r1 low, a[2]: r0 high, a[3]: r1 high
          const int r = ra + 8 * (h & 1);
          a[u][h] = i < n && r < G ? __ldg(reinterpret_cast<const uint32_t*>(
                                         q_grp + r * HD + d + 8 * (h >> 1)))
                                   : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * nthreads < n)
          Qf[i0 + u * nthreads] = make_uint4(a[u][0], a[u][1], a[u][2], a[u][3]);
    }
  }

  __device__ void init(const float* Qs, int G) {
    const int w = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    sb = w & 1;
    dh = (w >> 1) & 1;
    hb = w >> 2;
    r0 = 16 * hb + (lane >> 2);
    r1 = r0 + 8;
    g = G;
    two_rows = 16 * hb + 8 < G;
#pragma unroll
    for (int b = 0; b < 2 * DP; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[b][e] = 0.f;
    m[0] = m[1] = repro::NEG_INF;
    l[0] = l[1] = 0.f;
  }

  __device__ void tile(const char* Kt, const char* Vt, const int* R, const float* Qs,
                       float scale) {
    if (16 * hb >= g) return;  // a warp past the group's head blocks
    const int mi = lane >> 3, ri = lane & 7, c = 2 * (lane & 3);
    const uint32_t kb = repro::sm90::smem_u32(Kt) + 16 * sb * S::ROW;  // this pair's 16 slots
    const uint32_t vb = repro::sm90::smem_u32(Vt) + 16 * sb * S::ROW + dh * HD;  // its dims
    const uint4* qf4 = reinterpret_cast<const uint4*>(Qs) + hb * KC * 32 + lane;
    // S = q K^T: K rows are slots, hd contiguous, which is B's column-major
    // layout; the even and odd k-steps in two chains of products (sum[0],
    // sum[1]), added at the end, so that four products are in flight
    float sum[2][2][4] = {};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint4 qv = qf4[kc * 32];
      const uint32_t qf[4] = {qv.x, qv.y, qv.z, qv.w};
      uint32_t b[4];
      repro::sm90::ldmatrix_x4(b, kb + (8 * (mi >> 1) + ri) * S::ROW + (16 * kc + 8 * (mi & 1)) * 2);
      repro::sm90::mma_m16n8k16_bf16(sum[kc & 1][0], qf, b[0], b[1]);
      repro::sm90::mma_m16n8k16_bf16(sum[kc & 1][1], qf, b[2], b[3]);
    }
    float s[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = sum[0][nb][e] + sum[1][nb][e];
    // mask, scale and the online softmax on the fragment (as MmaHeads)
    float mx0 = repro::NEG_INF, mx1 = repro::NEG_INF;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int2 ok = *reinterpret_cast<const int2*>(R + 16 * sb + 8 * nb + c);
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
    uint32_t pa[4];  // P as the A operand of O += P V (this pair's 16 slots)
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
    // O = alpha O + P V over this warp's dims: ldmatrix.trans gives B
#pragma unroll
    for (int dp = 0; dp < DP; ++dp) {
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

  // Merge the two pairs' partials of each head into the CTA's (ACC, Ms,
  // Ls). ACC lies in the V ring (Smem::acc_off), free once every warp is
  // done reading the ring (the caller's barrier): the warps of pair 1 write
  // their O there and their m, l into ``scratch`` (the K ring), and the
  // warp of pair 0 with the same heads and dims reads them back at the same
  // positions and writes the merged values over them.
  __device__ void partial(char* scratch, float* ACC, float* Ms, float* Ls, int G) const {
    float* WM = reinterpret_cast<float*>(scratch);  // [G]: pair 1's m
    float* WL = WM + G;                             // [G]: pair 1's l
    const int c = 2 * (lane & 3), d0 = HD / 2 * dh;
    if (sb == 1) {
#pragma unroll
      for (int b = 0; b < 2 * DP; ++b) {
        float* a0 = ACC + r0 * HD + d0 + 8 * b + c;
        float* a1 = ACC + r1 * HD + d0 + 8 * b + c;
        if (r0 < G) a0[0] = o[b][0], a0[1] = o[b][1];
        if (r1 < G) a1[0] = o[b][2], a1[1] = o[b][3];
      }
      if (dh == 0 && (lane & 3) == 0) {
        if (r0 < G) WM[r0] = m[0], WL[r0] = l[0];
        if (r1 < G) WM[r1] = m[1], WL[r1] = l[1];
      }
    }
    __syncthreads();
    if (sb == 0) {
      float wa[2], wb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = i ? r1 : r0;
        const float mb = r < G ? WM[r] : repro::NEG_INF;
        const float M = fmaxf(m[i], mb);
        wa[i] = expf(m[i] - M);
        wb[i] = expf(mb - M);
        if (r < G && dh == 0 && (lane & 3) == 0) {
          Ms[r] = M;
          Ls[r] = fmaf(wa[i], l[i], wb[i] * WL[r]);
        }
      }
#pragma unroll
      for (int b = 0; b < 2 * DP; ++b) {
        float* a0 = ACC + r0 * HD + d0 + 8 * b + c;
        float* a1 = ACC + r1 * HD + d0 + 8 * b + c;
        if (r0 < G)
          a0[0] = fmaf(wa[0], o[b][0], wb[0] * a0[0]), a0[1] = fmaf(wa[0], o[b][1], wb[0] * a0[1]);
        if (r1 < G)
          a1[0] = fmaf(wa[1], o[b][2], wb[1] * a1[0]), a1[1] = fmaf(wa[1], o[b][3], wb[1] * a1[1]);
      }
    }
  }
};

// The partial of a row with no valid slot: this rank's tiles' slots (tile
// t = rank, rank + SPLIT, ... of BL, below src.every_slots()), each read
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
  constexpr int BL = Geometry<T, HD>::BL, SPLIT = Geometry<T, HD>::SPLIT;
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
// thread of every CTA of a cluster of Geometry<T, HD>::SPLIT CTAs
// (Geometry<T, HD>::threads(G) threads), with dynamic shared memory of
// Smem<T, HD>::bytes(G).
template <typename T, int HD, typename Source, typename Codes = NoCodes>
__device__ __forceinline__ void attend(const Source& src, int G, const T* __restrict__ q_grp,
                                       const T* __restrict__ k_base,
                                       const T* __restrict__ v_base, size_t row_stride,
                                       T* __restrict__ out_grp, float scale,
                                       const Codes& codes = Codes{}) {
  namespace cg = cooperative_groups;
  using S = Smem<T, HD>;
  using Gm = Geometry<T, HD>;
  constexpr int BL = Gm::BL, SPLIT = Gm::SPLIT, STAGES = Gm::STAGES;
  using Heads = std::conditional_t<Route<T>::MMA,
                                   std::conditional_t<Gm::WIDE, MmaPairs<HD>, MmaHeads<HD>>,
                                   WarpPerHead<HD>>;
  constexpr int CPR = S::CPR;
  constexpr int VEC = 16 / (int)sizeof(T);
  using C = typename Codes::Code;
  constexpr int CSZ = (int)sizeof(C);
  constexpr int CCH = HD * CSZ / 16;                    // 16-byte chunks of a code row
  constexpr int CODE_STEP = 16 / CSZ * (int)sizeof(T);  // bytes of a code chunk's values in T
  // a float store under bf16: each chunk is converted as it is loaded
  constexpr bool CONVERT = Codes::ON && CSZ > (int)sizeof(T);
  static_assert(!CONVERT || !Codes::SCALED, "codes are one byte");
  static_assert(HD % 32 == 0 && (HD * (int)sizeof(T)) % 16 == 0, "HD must be 32, 64, 128, 256");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  int* ROWS = reinterpret_cast<int*>(sm + S::ROWS_OFF);
  float* Qs = reinterpret_cast<float*>(sm + S::Q_OFF);
  float* ACC = reinterpret_cast<float*>(sm + S::acc_off(G));
  float* Ms = reinterpret_cast<float*>(sm + S::m_off(G));
  float* Ls = Ms + G;

  // this rank's tiles: rank, rank + SPLIT, ... below ntiles
  const int ntiles = (src.n_slots + BL - 1) / BL;
  const int mine = ntiles > rank ? (ntiles - 1 - rank) / SPLIT + 1 : 0;

  // What the rows of tile i's slots depend on: thread tid loads it for
  // slots tid and tid + nthreads (nthreads >= 32), into registers.
  auto fetch = [&](int i, int (&pre)[2]) {
    const int slot0 = (rank + i * SPLIT) * BL;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = tid + k * nthreads;
      pre[k] = i < mine && j < BL ? src.load(slot0 + j) : -1;
    }
  };
  // Store tile i's rows, from what fetch(i) loaded, as stage s's; true when
  // the tile has a valid slot.
  auto publish = [&](int s, int i, const int (&pre)[2]) {
    const int slot0 = (rank + i * SPLIT) * BL;
    int any = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = tid + k * nthreads;
      if (j < BL) {
        const int row = src.row(slot0 + j, pre[k]);
        ROWS[s * BL + j] = row;
        any |= row != INVALID;
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
        if constexpr (CONVERT) {  // 4 floats rounded to bf16: 8 bytes of the row
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
    if constexpr (Codes::ON && !CONVERT) {
      for (int i = tid; i < 2 * BL * CCH; i += nthreads) {
        const bool is_v = i >= BL * CCH;
        const int ii = is_v ? i - BL * CCH : i;
        const int r = ii / CCH, c = ii % CCH;
        if (ROWS[s * BL + r] >= INVALID) continue;
        char* at = sm + (is_v ? S::V_OFF : S::K_OFF) + (s * BL + r) * S::ROW + c * CODE_STEP;
        const uint4 u = *reinterpret_cast<const uint4*>(at);
        if constexpr (!Codes::SCALED) {
          repro::cast_chunk<C, T>(u, at);
        } else {
          const float sc = *reinterpret_cast<const float*>(at + 16);
          if constexpr (Route<T>::MMA) {  // the upper 8 values first: they cover the scale
            reinterpret_cast<uint4*>(at)[1] = repro::dequant8_bf16<C>(make_uint2(u.z, u.w), sc);
            reinterpret_cast<uint4*>(at)[0] = repro::dequant8_bf16<C>(make_uint2(u.x, u.y), sc);
          } else {
            float d[16];
            repro::store_dequant16<C, T>(d, u, sc);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              reinterpret_cast<float4*>(at)[e] = make_float4(d[4 * e], d[4 * e + 1],
                                                             d[4 * e + 2], d[4 * e + 3]);
          }
        }
      }
    }
  };

  // the first STAGES tiles in flight: their rows, q, then their copies
  int pre0[STAGES][2];
#pragma unroll
  for (int st = 0; st < STAGES; ++st) fetch(st, pre0[st]);
  Heads::load_q(Qs, q_grp, G, tid, nthreads);
  unsigned full = 0;  // bit s: stage s holds a tile with a valid slot
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    if (publish(st, st, pre0[st])) {  // the first barrier also publishes q
      full |= 1u << st;
      issue(st);
    }
    repro::sm90::cp_async_commit();
  }
  repro::sm90::cluster_arrive_relaxed();  // this CTA has started (waited for before the push)

  Heads heads;
  heads.init(Qs, G);

  for (int i = 0; i < mine; ++i) {
    const int s = i % STAGES;
    int pre[2];
    fetch(i + STAGES, pre);  // in flight while tile i computes
    repro::sm90::cp_async_wait<STAGES - 1>();  // tile i has landed (later tiles may be pending)
    const bool any = (full >> s) & 1u;
    if (any) dequant(s);
    __syncthreads();
    if (any)
      heads.tile(sm + S::K_OFF + s * BL * S::ROW, sm + S::V_OFF + s * BL * S::ROW,
                 ROWS + s * BL, Qs, scale);
    bool more = false;
    if (i + STAGES < mine) {  // tile i + STAGES takes stage s
      __syncthreads();        // every thread is done with stage s
      more = publish(s, i + STAGES, pre);
      if (more) issue(s);
    }
    repro::sm90::cp_async_commit();  // possibly empty: keeps one group per tile
    full = more ? full | 1u << s : full & ~(1u << s);
  }
  repro::sm90::cp_async_wait<0>();

  // this rank's partial, then the combine (header): every rank pushes the
  // r-th SPLIT-th of its partial (G * HD is a multiple of 4 SPLIT), and its
  // m and l, into rank r's shared memory (posted stores, no round trip);
  // once the cluster has met, each rank combines what it was sent
  const int chunk = G * HD / SPLIT;
  float* RM = reinterpret_cast<float*>(sm + S::recv_off(G));  // [SPLIT][G]
  float* RL = RM + SPLIT * G;                                   // [SPLIT][G]
  float* RACC = RL + SPLIT * G;                                 // [SPLIT][chunk]
  auto push = [&]() {
    __syncthreads();  // the partial is in ACC, Ms, Ls
    for (int j = tid; j < G * HD / 4; j += nthreads) {
      const int idx = 4 * j, r = idx / chunk;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(RACC, r) + rank * chunk + idx -
                                 r * chunk) = *reinterpret_cast<const float4*>(ACC + idx);
    }
    for (int j = tid; j < SPLIT * G; j += nthreads) {
      const int r = j / G, h = j - r * G;
      cluster.map_shared_rank(RM, r)[rank * G + h] = Ms[h];
      cluster.map_shared_rank(RL, r)[rank * G + h] = Ls[h];
    }
    cluster.sync();
  };
  if constexpr (Gm::WIDE) __syncthreads();  // ACC lies in the V ring: every warp is done with it
  heads.partial(sm + S::K_OFF, ACC, Ms, Ls, G);
  repro::sm90::cluster_wait();  // every CTA of the cluster has started
  push();
  // no rank saw a valid slot (every rank's m is -1e30): the mean of V over
  // every slot (header)
  bool none = true;
#pragma unroll
  for (int r = 0; r < SPLIT; ++r) none &= RM[r * G] == repro::NEG_INF;
  if (none) {
    cluster.sync();  // every rank has read its m's before any rank pushes again
    mean_of_v<T, HD>(src, codes, v_base, row_stride, rank, G, sm + S::K_OFF, ACC, Ms, Ls);
    push();
  }
  // the weight of rank r's partial in head h0 + hh of this share,
  // exp(m_r - M) / sum exp(m_s - M) l_s, once per (hh, r), in the K ring
  float* W = reinterpret_cast<float*>(sm + S::K_OFF);  // [heads of the share][SPLIT]
  const int h0 = rank * chunk / HD;
  const int nh = (rank * chunk + chunk - 1) / HD - h0 + 1;
  for (int t = tid; t < nh * SPLIT; t += nthreads) {
    const int h = h0 + t / SPLIT;
    float M = repro::NEG_INF;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) M = fmaxf(M, RM[r * G + h]);
    float lsum = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) lsum = fmaf(expf(RM[r * G + h] - M), RL[r * G + h], lsum);
    W[t] = expf(RM[(t % SPLIT) * G + h] - M) / lsum;
  }
  __syncthreads();
  for (int i = tid; i < chunk; i += nthreads) {
    const float* w = W + ((rank * chunk + i) / HD - h0) * SPLIT;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) o = fmaf(w[r], RACC[r * chunk + i], o);
    out_grp[rank * chunk + i] = repro::from_f<T>(o);
  }
  // no rank touches another's shared memory after the last barrier
}

// The launch of a kernel on this core: grid (KVH, B, SPLIT), one cluster of
// SPLIT = Geometry<T, HD>::SPLIT CTAs along z per (KV head, batch row),
// Geometry<T, HD>::threads(G) threads and Smem<T, HD>::bytes(G) of dynamic shared
// memory, through cudaLaunchKernelEx with the cluster dimension as a launch
// attribute (K2, K3, K2q and K3q alike; split16's 16 is a non-portable size
// the kernel is allowed, and its CTAs ask for the carveout that holds two of
// them an SM). Both work inside a CUDA graph capture.
template <typename T, int HD, typename... Params>
cudaError_t cluster_config(void (*kern)(Params...), int KVH, int B, int G, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  using Gm = Geometry<T, HD>;
  const size_t smem = Smem<T, HD>::bytes(G);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if constexpr (Gm::SPLIT > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = Gm::SPLIT;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(KVH, B, Gm::SPLIT);
  cfg.blockDim = dim3(Gm::threads(G));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of ``kern`` at group size G the card holds at once
// (cudaOccupancyMaxActiveClusters), into ``n``.
template <typename T, int HD, typename... Params>
cudaError_t max_clusters(void (*kern)(Params...), int G, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config<T, HD>(kern, 1, 1, G, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, reinterpret_cast<const void*>(kern), &cfg);
}

// Launch ``kern`` (cluster_config) with ``args``. The first launch at each
// group size asks max_clusters and remembers it in ``clusters[G]``; a card
// that holds no cluster of the route refuses the launch
// (cudaErrorLaunchOutOfResources) rather than running a narrower split.
template <typename T, int HD, typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kern)(Params...), int (&clusters)[33], int KVH, int B, int G,
                            cudaStream_t stream, Args... args) {
  if (clusters[G] == 0) {
    int n = 0;
    const cudaError_t err = max_clusters<T, HD>(kern, G, &n);
    if (err != cudaSuccess) return err;
    clusters[G] = n + 1;
  }
  if (clusters[G] == 1) return cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T, HD>(kern, KVH, B, G, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// Geometry<T, hd> as (tile, split, stages) into ``out``; false for an hd no
// route takes.
template <typename T> bool geometry(int hd, int* out) {
  auto put = [&](auto g) {
    using Gm = decltype(g);
    out[0] = Gm::BL, out[1] = Gm::SPLIT, out[2] = Gm::STAGES;
    return true;
  };
  switch (hd) {
    case 32: return put(Geometry<T, 32>{});
    case 64: return put(Geometry<T, 64>{});
    case 128: return put(Geometry<T, 128>{});
    case 256: return put(Geometry<T, 256>{});
    default: return false;
  }
}

}  // namespace repro::decode
