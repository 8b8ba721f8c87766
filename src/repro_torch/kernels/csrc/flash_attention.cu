// Causal (optionally windowed, ragged or prefix-LM) or non-causal GQA
// prefill attention for Hopper (sm_90a), over native or quantized K/V.
//
// Replaces the Pallas TPU kernels `_attn_kernel` and `_attn_kernel_ragged`
// (src/repro/kernels/flash_attention.py), K1 and K1r, and their
// `quantized=True` variants, K1q and K1rq. Layouts are the reference's:
//   q, out (B, Sq, H, hd)   k, v (B, Sk, KVH, hd)   seq_lens (B,) int32 or null
//   quantized: k, v int8 or float8_e4m3fn codes, k_scale, v_scale (B, Sk, KVH) f32
// Query head h reads KV head h / (H / KVH).
//
// Every route computes the TPU kernel's function: scores are (q.k) * scale
// in f32, masked keys score -1e30, the online softmax (m, l, acc) runs in
// f32, p is rounded to the value dtype before the PV product, the output is
// acc / max(l, 1e-30), KV tiles wholly above the diagonal, outside the
// window or at or beyond the row's length are skipped, and query rows at or
// beyond the row's length are written as zeros. Any Sq and Sk are accepted
// (the ragged tile edge is masked). The TPU kernel's sequential innermost
// grid axis over KV tiles becomes a loop inside the CTA.
//
// Prefix-LM (prefix_len > 0, causal, native K/V, no seq_lens; the
// reference's chunked_attention rule, which the TPU kernel lacks): key k is
// visible to query q if (k <= q and, under a window, k > q - window) or
// k < prefix_len, so every query sees the whole prefix (a VLM's image
// patches) bidirectionally. A q-tile's live keys become [0, max(its causal
// end, min(prefix_len, Sk))); with a window the visible keys are not
// contiguous, so the range starts at 0 and the mask hides the gap.
//
// Routes (flash_attention_route; KERNEL_ROUTE in chip_smoke.py):
//   route        q      K/V        hd
//   wide         bf16   native     128, 256
//   wgmma        bf16   native     32, 64
//   wgmma        bf16   codes      32, 64, 128
//   CUDA cores   f32    native     32, 64, 128, 256
//   CUDA cores   f32    codes      32, 64, 128
//
// wide (flash_attention_wide_kernel; olmoe-1b-7b's and qwen3-8b's hd 128,
// recurrentgemma-2b's hd 256). Warp-specialized and persistent: one CTA an
// SM walks work units blockIdx.x, + gridDim.x, ..., numbered with the
// q-tiles that have the most keys first. A unit is two 64-row q-tiles that
// share one K/V stream: where the group H / KVH is even, query heads 2u and
// 2u + 1 of one KV group at the same rows (same masks, same tiles); where it
// is 1 or odd, q-tiles 2u and 2u + 1 of one head (the union of their live
// ranges is streamed, each skips the tiles outside its own, and a lone last
// tile leaves consumer 1 idle). A CTA is three warpgroups. The producer
// (warpgroup 2) gives registers to the consumers (setmaxnreg: 40 and 232 of
// the launch's 168 a thread), and one of its threads loads each unit's Q
// tiles and then every K/V tile of its stream by TMA (128-byte boxes, 128B
// swizzle, rows past Sk read as zeros) into a ring of stages (two at hd
// 256, four at 128), each stage's arrival an mbarrier's transaction count
// and its release one arrival from each consumer warp on another; it runs
// on into the next unit while the consumers finish this one: a consumer
// frees its Q tile after its last QK^T (and at hd 128 Q has two sets), so
// the next unit's Q lands under this one's last tile. Consumers 0 and 1 own
// 64 rows and an O accumulator each and read every tile landed. A
// consumer's step is S = Q K^T (hd/16 wgmma m64n64k16; at hd 128 Q's A
// fragments stay in registers, at 256 they are read from shared memory),
// the online softmax on S's fragment in the log2 domain (p = 2^(c s - m),
// c = scale log2 e, on the SFU), and O += P V with P as the register A
// operand over the V tile as an MN-major B. The output is staged in the
// unit's last K/V stage once both consumers are done with it (consumer 0 in
// its K tile, 1 in its V tile) and leaves in 16-byte stores. Shared memory:
// hd 256 64 KB of Q and two 64 KB stages, 192 KB; hd 128 two 32 KB Q sets
// and four 32 KB stages, 192 KB.
//
// A ping-pong of the two consumers on named barriers (one's softmax under
// the other's products), an overlap of each consumer's softmax with its own
// previous PV, separate K and V rings and 128-key tiles at hd 128 were built
// and measured slower at every shape (PERF.md, PR 31): at these short causal
// ranges the cost is each consumer's chain of a tile's QK^T, softmax and PV,
// and every barrier added to it lengthened the chain.
//
// What bounds it: at recurrentgemma-2b's admission (B 8, S 512, 10 heads on
// one KV head, hd 256) the causal work is ~10.7 GFLOP against ~46 MB, and
// at olmoe-1b-7b's (16 heads on 16, hd 128) ~8.6 GFLOP against ~67 MB:
// both byte-bound on the tensor cores (13.8 and 20.0 us). The route stays
// well above that: two consumers an SM each run one tile at a time as a
// chain of QK^T, softmax and PV, the softmax as long as either product, so
// the tensor cores idle through the softmax; and when every SM loads at
// once a TMA load lands late.
//
// wgmma (flash_attention_kernel_wgmma; granite's hd 64 and every quantized
// K/V): the CTA is one warpgroup (64 query rows, wgmma's M), its tiles by
// 16-byte cp.async (rows past Sk zero-filled) in the swizzled layout of
// sm90.cuh, K/V in a ring of two stages (tile j + 1's copies issued before
// tile j's products), the same QK^T, softmax and PV as the wide route.
// Quantized codes and their scales take that ring instead, and the
// warpgroup dequantizes each tile (dequant.cuh's shared conversion: each
// code converted exactly, times its row and head's scale in f32, rounded to
// bf16, as the reference's `dequantize_kv`) into one bf16 K and V tile
// before its products. Before wgmma reads what threads wrote, every thread
// waits for its copies, fences the async proxy, and the CTA meets at a
// barrier. At granite's serving shapes (B 8, S 512, H 32 on 8 KV heads,
// hd 64: ~8.6 GFLOP against ~42 MB, ~12.5 us byte-bound) it is bound by
// issue: one warpgroup runs each tile as one chain of copies, products and
// softmax (chip_smoke.py's flash_anatomy phase).
//
// CUDA cores (flash_attention_kernel, f32 q): a tensor-core product in f32
// is TF32 and would break the f32 rule it is held to. Two threads share a
// query row: each scores half of a 64-key tile and owns half of the output
// dims, from f32 tiles in shared memory (at hd 256 215,296 bytes at QS = KS
// = 260, inside the 232,448 a CTA may have).
#include <cuda.h>
#include <dlfcn.h>

#include <type_traits>

#include "dequant.cuh"
#include "sm90.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
using repro::load_rows_dequant_range;
using repro::NEG_INF;
using repro::sm90::Tile;
using repro::to_f;

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 2 * BQ; // two threads per query row

// The live KV range [k_begin, k_end) of the 64-row q-tile at q0 (k_begin a
// multiple of 64): below the diagonal (or, with a prefix, below the larger
// of the diagonal and the prefix's end), inside the window (none with a
// prefix: the mask hides the gap), before the row's length ``klim``. Empty
// (k_end <= k_begin) for a tile with no live row.
__device__ __forceinline__ void live_keys(int q0, int klim, int causal, int window,
                                          int prefix_len, int& k_begin, int& k_end) {
  k_end = klim;
  if (causal) k_end = min(k_end, max(q0 + BQ, prefix_len));
  k_begin = window > 0 && prefix_len <= 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
}

// Whether key kp is visible to query qp: before the row's length, and below
// the diagonal (causal) and inside the window, or inside the prefix.
__device__ __forceinline__ bool visible(int kp, int qp, int klim, int causal, int window,
                                        int prefix_len) {
  bool ok = !causal || kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return kp < klim && (ok || kp < prefix_len);
}

template <int HD>
struct Smem {
  static constexpr int QS = HD + 4;  // padded strides (floats); multiples of 4 keep float4 aligned
  static constexpr int KS = HD + 4;
  static constexpr int VS = HD;
  static constexpr int PS = BK + 1;
  static constexpr int floats = BQ * QS + BK * KS + BK * VS + BQ * PS;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// C is the K/V element type: T for native K/V, or int8_t / __nv_fp8_e4m3
// codes with their scales (k_scale, v_scale; unused when C is T).
template <typename T, typename C, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const C* __restrict__ k,
                       const C* __restrict__ v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ seq_lens,
                       T* __restrict__ out, int Sq, int Sk, int H, int KVH,
                       int causal, int window, int prefix_len, float scale) {
  constexpr bool QUANT = !std::is_same<C, T>::value;
  using S = Smem<HD>;
  constexpr int HALF_K = BK / 2;
  constexpr int HALF_D = HD / 2;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * S::QS;
  float* Vs = Ks + BK * S::KS;
  float* Ps = Vs + BK * S::VS;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int r = tid >> 1;     // query row within the tile
  const int half = tid & 1;   // which half of the keys / output dims
  const int qpos = q0 + r;
  const bool ragged = seq_lens != nullptr;
  const int len = ragged ? seq_lens[b] : Sq;
  const int klim = ragged ? min(len, Sk) : Sk;  // keys at or beyond are masked

  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KVH * HD;
  const T* q_base = q + (size_t)b * Sq * q_stride + (size_t)h * HD;
  const C* k_base = k + (size_t)b * Sk * kv_stride + (size_t)kvh * HD;
  const C* v_base = v + (size_t)b * Sk * kv_stride + (size_t)kvh * HD;
  // scales (B, Sk, KVH): row s of this head at [s * KVH]
  const float* ks_base = QUANT ? k_scale + (size_t)b * Sk * KVH + kvh : nullptr;
  const float* vs_base = QUANT ? v_scale + (size_t)b * Sk * KVH + kvh : nullptr;
  T* o_base = out + (size_t)b * Sq * q_stride + (size_t)h * HD;

  if (ragged && q0 >= len) {  // every row of the tile is padding
    for (int i = tid; i < BQ * HD; i += THREADS) {
      const int rr = i / HD, c = i - rr * HD;
      if (q0 + rr < Sq) o_base[(size_t)(q0 + rr) * q_stride + c] = from_f<T>(0.f);
    }
    return;
  }

  load_rows<T, HD>(Qs, S::QS, q_base, q_stride, q0, BQ, Sq, tid, THREADS);

  int k_begin, k_end;
  live_keys(q0, klim, causal, window, prefix_len, k_begin, k_end);

  float m = NEG_INF, l = 0.f;
  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    if constexpr (QUANT) {
      load_rows_dequant_range<C, T, HD>(Ks, S::KS, k_base, kv_stride, ks_base, KVH, k0, BK,
                                        Sk, tid, THREADS);
      load_rows_dequant_range<C, T, HD>(Vs, S::VS, v_base, kv_stride, vs_base, KVH, k0, BK,
                                        Sk, tid, THREADS);
    } else {
      load_rows<T, HD>(Ks, S::KS, k_base, kv_stride, k0, BK, Sk, tid, THREADS);
      load_rows<T, HD>(Vs, S::VS, v_base, kv_stride, k0, BK, Sk, tid, THREADS);
    }
    __syncthreads();

    float sc[HALF_K];
#pragma unroll
    for (int jj = 0; jj < HALF_K; ++jj) sc[jj] = 0.f;
    const float* qrow = Qs + r * S::QS;
    const float* kblk = Ks + half * HALF_K * S::KS;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int jj = 0; jj < HALF_K; ++jj) {
        const float4 k4 = *reinterpret_cast<const float4*>(kblk + jj * S::KS + d);
        sc[jj] = fmaf(q4.x, k4.x, sc[jj]);
        sc[jj] = fmaf(q4.y, k4.y, sc[jj]);
        sc[jj] = fmaf(q4.z, k4.z, sc[jj]);
        sc[jj] = fmaf(q4.w, k4.w, sc[jj]);
      }
    }

    float tmax = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < HALF_K; ++jj) {
      const int kp = k0 + half * HALF_K + jj;
      sc[jj] = visible(kp, qpos, klim, causal, window, prefix_len) ? sc[jj] * scale : NEG_INF;
      tmax = fmaxf(tmax, sc[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float* prow = Ps + r * S::PS + half * HALF_K;
#pragma unroll
    for (int jj = 0; jj < HALF_K; ++jj) {
      const float p = expf(sc[jj] - m_new);
      psum += p;
      prow[jj] = to_f(from_f<T>(p));  // p in the value dtype, as the TPU kernel
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // both threads of a row live in one warp

#pragma unroll
    for (int i = 0; i < HALF_D; ++i) acc[i] *= alpha;
    const float* pr = Ps + r * S::PS;
    const float* vcol = Vs + half * HALF_D;
    for (int j = 0; j < BK; ++j) {
      const float pj = pr[j];
      const float* vr = vcol + j * S::VS;
#pragma unroll
      for (int i = 0; i < HALF_D; i += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr + i);
        acc[i] = fmaf(pj, v4.x, acc[i]);
        acc[i + 1] = fmaf(pj, v4.y, acc[i + 1]);
        acc[i + 2] = fmaf(pj, v4.z, acc[i + 2]);
        acc[i + 3] = fmaf(pj, v4.w, acc[i + 3]);
      }
    }
  }

  if (qpos < Sq) {
    const bool pad = ragged && qpos >= len;
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o_base + (size_t)qpos * q_stride + half * HALF_D;
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) orow[i] = from_f<T>(pad ? 0.f : acc[i] / denom);
  }
}

// ------------------------------------------------- bf16: wgmma kernel
using bf16 = __nv_bfloat16;
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == 64 && BK == 64 && WG_THREADS == 2 * BK, "wgmma's M, and the scale copy");

// Shared memory of the wgmma kernel, in bytes from a 1024-aligned base: the
// Q tile (reused for the output), the bf16 K and V tiles (two stages for
// native K/V, one for codes), and for codes a two-stage ring of K and V code
// tiles and their scales. Every tile starts on a 1024-byte boundary.
template <typename C, int HD>
struct WgSmem {
  static constexpr bool QUANT = !std::is_same<C, bf16>::value;
  static constexpr int TILE = BK * HD * 2;  // one bf16 tile of 64 rows
  static constexpr int STAGES = QUANT ? 1 : 2;
  static constexpr int CODES = BK * HD;     // one tile of one-byte codes
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int CODE_OFF = V_OFF + STAGES * TILE;         // [stage][K, V]
  static constexpr int SCALE_OFF = CODE_OFF + (QUANT ? 4 * CODES : 0);  // [stage][K, V][BK]
  static constexpr int END = SCALE_OFF + (QUANT ? 4 * BK * 4 : 0);
  static constexpr size_t bytes = END + 1024;  // slack to align the base
};

// 64 rows [row0, row0 + 64) of bf16 (HD values, rows ``stride`` apart)
// into the swizzled tile at shared address ``dst`` by 16-byte cp.async;
// rows at or past ``rows_total`` read nothing and land as zeros.
template <int HD>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src, size_t stride,
                                          int row0, int rows_total, int tid) {
  using L = repro::sm90::Tile<HD>;
  for (int i = tid; i < BK * L::CHUNKS; i += WG_THREADS) {
    const int r = i / L::CHUNKS, c = i % L::CHUNKS;
    const bool ok = row0 + r < rows_total;
    repro::sm90::cp_async16(dst + repro::sm90::tile_offset<HD>(BK, r, c),
                            src + (size_t)(ok ? row0 + r : 0) * stride + c * 8, ok ? 16 : 0);
  }
}

// The K and V tiles of keys [k0, k0 + 64) into one stage of the ring
// (``stage_base``: the base's shared address plus stage * TILE).
template <int HD>
__device__ __forceinline__ void copy_kv(uint32_t stage_base, const bf16* k, const bf16* v,
                                        size_t stride, int k0, int Sk, int tid) {
  using S = WgSmem<bf16, HD>;
  copy_tile<HD>(stage_base + S::K_OFF, k, stride, k0, Sk, tid);
  copy_tile<HD>(stage_base + S::V_OFF, v, stride, k0, Sk, tid);
}

// The K and V codes of keys [k0, k0 + 64) row-major into ``codes`` (K's
// tile, then V's) and their scales into ``scales`` (K's 64, then V's);
// keys at or past Sk land as code 0 with scale 0, a row of zeros.
template <typename C, int HD>
__device__ __forceinline__ void copy_codes(uint32_t codes, uint32_t scales, const C* k,
                                           const C* v, const float* ks, const float* vs,
                                           size_t stride, int KVH, int k0, int Sk, int tid) {
  constexpr int CCH = HD / 16;  // 16-byte chunks of codes per row
  for (int i = tid; i < BK * CCH; i += WG_THREADS) {
    const int r = i / CCH, c = i % CCH;
    const bool ok = k0 + r < Sk;
    const size_t src = (size_t)(ok ? k0 + r : 0) * stride + c * 16;
    repro::sm90::cp_async16(codes + r * HD + c * 16, k + src, ok ? 16 : 0);
    repro::sm90::cp_async16(codes + BK * HD + r * HD + c * 16, v + src, ok ? 16 : 0);
  }
  const int r = tid % BK, which = tid / BK;  // threads 0-63: K's scales, 64-127: V's
  const bool ok = k0 + r < Sk;
  repro::sm90::cp_async4(scales + (which * BK + r) * 4,
                         (which ? vs : ks) + (size_t)(ok ? k0 + r : 0) * KVH, ok ? 4 : 0);
}

// The codes of ring stage ``stage`` dequantized into the bf16 K and V tiles
// (dequant.cuh's conversion, so K1q rounds as K2q, K3q and K4q do).
template <typename C, int HD>
__device__ __forceinline__ void dequantize(uint8_t* smem, int stage, int tid) {
  using S = WgSmem<C, HD>;
  constexpr int CCH = HD / 16;
  const uint8_t* codes = smem + S::CODE_OFF + stage * 2 * S::CODES;
  const float* scales = reinterpret_cast<const float*>(smem + S::SCALE_OFF) + stage * 2 * BK;
  for (int i = tid; i < 2 * BK * CCH; i += WG_THREADS) {
    const int which = i / (BK * CCH), j = i % (BK * CCH);  // which 0: K, 1: V
    const int r = j / CCH, c = j % CCH;
    uint4 lo, hi;
    repro::dequant16_bf16<C>(
        *reinterpret_cast<const uint4*>(codes + which * S::CODES + r * HD + c * 16),
        scales[which * BK + r], lo, hi);
    uint8_t* tile = smem + (which ? S::V_OFF : S::K_OFF);
    *reinterpret_cast<uint4*>(tile + repro::sm90::tile_offset<HD>(BK, r, 2 * c)) = lo;
    *reinterpret_cast<uint4*>(tile + repro::sm90::tile_offset<HD>(BK, r, 2 * c + 1)) = hi;
  }
}

// O (+)= P V for one 16-key k-step over one column block of V (NPV columns).
template <int NPV>
__device__ __forceinline__ void pv_product(float (&o)[NPV / 2], const uint32_t (&p)[4],
                                           uint64_t v_desc) {
  if constexpr (NPV == 64)
    repro::sm90::wgmma_m64n64k16_rs_tb(o, p, v_desc, 1);
  else
    repro::sm90::wgmma_m64n32k16_rs_tb(o, p, v_desc, 1);
}

// S = Q K^T over one 64-key tile: HD/16 products of m64n64k16 with Q and
// K read from shared memory (K-major tiles of Tile<HD>'s layout). Issued
// and committed, not waited for.
template <int HD>
__device__ __forceinline__ void qk_issue(float (&s)[32], uint32_t q_tile, uint32_t k_tile) {
  using namespace repro::sm90;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = tile_offset<HD>(BK, 0, 2 * kk);  // k-step kk's 32 bytes of row 0
    wgmma_m64n64k16_ss(s, descriptor<HD>(q_tile + off), descriptor<HD>(k_tile + off), kk > 0);
  }
  wgmma_commit();
}

// One online-softmax step on S's accumulator fragment (s[4i + e] is row
// r0 + 8 * (e / 2) of the q-tile at q0, key k0 + 8i + c0 + e % 2): scale,
// mask (-1e30), new row maxima m, p = exp(s - m) in s, l (this thread's
// share of the rows' sums) and alpha, the factor the running output takes.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int q0, int r0,
                                               int c0, int klim, int causal, int window,
                                               int prefix_len, float scale) {
  const bool edge = k0 + BK > klim || (causal && k0 + BK - 1 > q0) ||
                    (window > 0 && k0 + window <= q0 + BQ - 1);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * scale;
      if (edge) {
        const int kp = k0 + 8 * i + c0 + (e & 1);
        const int qp = q0 + r0 + 8 * (e >> 1);
        x = visible(kp, qp, klim, causal, window, prefix_len) ? x : NEG_INF;
      }
      s[4 * i + e] = x;
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * hr], s[4 * i + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));  // the quad holds the row
    const float m_new = fmaxf(m[hr], mx);
    alpha[hr] = exp2f((m[hr] - m_new) * LOG2E);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f((s[4 * i + 2 * hr + e] - m_new) * LOG2E);
        psum += p;
        s[4 * i + 2 * hr + e] = p;
      }
    l[hr] = l[hr] * alpha[hr] + psum;
    m[hr] = m_new;
  }
}

// The wide route's online-softmax step, in the log2 domain: with c = scale *
// log2(e), x = c * s (masked: -1e30), m is the rows' running max of x and
// p = 2^(x - m) on the SFU. The same function as online_softmax up to
// rounding, one multiply a score fewer.
__device__ __forceinline__ void online_softmax_log2(float (&s)[32], float (&m)[2],
                                                    float (&l)[2], float (&alpha)[2], int k0,
                                                    int q0, int r0, int c0, int klim,
                                                    int causal, int window, int prefix_len,
                                                    float scale) {
  const float c = scale * LOG2E;
  const bool edge = k0 + BK > klim || (causal && k0 + BK - 1 > q0) ||
                    (window > 0 && k0 + window <= q0 + BQ - 1);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * c;
      if (edge) {
        const int kp = k0 + 8 * i + c0 + (e & 1);
        const int qp = q0 + r0 + 8 * (e >> 1);
        x = visible(kp, qp, klim, causal, window, prefix_len) ? x : NEG_INF;
      }
      s[4 * i + e] = x;
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(s[4 * i + 2 * hr], s[4 * i + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));  // the quad holds the row
    const float m_new = fmaxf(m[hr], mx);
    alpha[hr] = repro::sm90::ex2(m[hr] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = repro::sm90::ex2(s[4 * i + 2 * hr + e] - m_new);
        psum += p;
        s[4 * i + 2 * hr + e] = p;
      }
    l[hr] = l[hr] * alpha[hr] + psum;
    m[hr] = m_new;
  }
}

// This thread's A fragments of a 64-row Q tile (Tile<HD>'s layout) for the
// HD/16 k-steps of S = Q K^T: rows r0, r0 + 8, columns 16kk + c0 (+1) and
// 16kk + 8 + c0 (+1).
template <int HD>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[HD / 16][4], const uint8_t* q,
                                             int r0, int c0) {
  using repro::sm90::tile_offset;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      qa[kk][j] = *reinterpret_cast<const uint32_t*>(
          q + tile_offset<HD>(BQ, r0 + 8 * (j & 1), 2 * kk + (j >> 1)) + 2 * c0);
}

// S = Q K^T as qk_issue, with Q's A fragments in registers.
template <int HD>
__device__ __forceinline__ void qk_issue_rs(float (&s)[32], const uint32_t (&qa)[HD / 16][4],
                                            uint32_t k_tile) {
  using namespace repro::sm90;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n64k16_rs(s, qa[kk], descriptor<HD>(k_tile + tile_offset<HD>(BK, 0, 2 * kk)),
                       kk > 0);
  wgmma_commit();
}

// O = O * alpha + P V over one 64-key tile: P rounded to bf16 as the
// register A operand, 4 k-steps over the NB column blocks of the V tile
// (MN-major B). Issued, committed and waited for.
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / (Tile<HD>::SW / 2)][Tile<HD>::SW / 4],
                                        const float (&s)[32], const float (&alpha)[2],
                                        uint32_t v_tile) {
  using namespace repro::sm90;
  using L = Tile<HD>;
  constexpr int NPV = L::SW / 2, NB = HD / NPV;
  uint32_t p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NPV / 2; ++i) o[nb][i] *= alpha[(i >> 1) & 1];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)  // column block nb, key rows 16kk..16kk+15
      pv_product<NPV>(o[nb], p[kk], descriptor<HD>(v_tile + nb * BK * L::SW + 16 * kk * L::SW));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
}

// The normalized output of one warpgroup's 64 rows, as bf16, into the
// swizzled tile at ``os`` (rows ``pad_from`` and beyond are padding: zeros).
// ``l`` must hold the rows' full sums. RECIP: times 1 / l, not over l.
template <int HD, bool RECIP = false>
__device__ __forceinline__ void stage_output(
    uint8_t* os, const float (&o)[HD / (Tile<HD>::SW / 2)][Tile<HD>::SW / 4],
    const float (&l)[2], int r0, int c0, int pad_from) {
  using namespace repro::sm90;
  constexpr int NPV = Tile<HD>::SW / 2, NB = HD / NPV;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    const bool pad = r >= pad_from;
    const float denom = fmaxf(l[hr], 1e-30f);
    const float inv = 1.f / denom;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < NPV / 8; ++i) {
        const float x = o[nb][4 * i + 2 * hr], y = o[nb][4 * i + 2 * hr + 1];
        const float a = pad ? 0.f : RECIP ? x * inv : x / denom;
        const float c = pad ? 0.f : RECIP ? y * inv : y / denom;
        *reinterpret_cast<uint32_t*>(os + tile_offset<HD>(BQ, r, nb * NPV / 8 + i) + 2 * c0) =
            pack_bf16(a, c);
      }
  }
}

// A staged 64-row tile to rows q0.. of ``o_base`` (rows ``stride`` apart)
// in 16-byte stores, the rows below Sq only.
template <int HD>
__device__ __forceinline__ void store_tile(bf16* o_base, size_t stride, const uint8_t* os,
                                           int q0, int Sq, int tid) {
  using L = repro::sm90::Tile<HD>;
  for (int i = tid; i < BQ * L::CHUNKS; i += WG_THREADS) {
    const int r = i / L::CHUNKS, c = i % L::CHUNKS;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(o_base + (size_t)(q0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(os + repro::sm90::tile_offset<HD>(BQ, r, c));
  }
}

// C is the K/V element type: bf16, or int8_t / __nv_fp8_e4m3 codes with
// their scales (k_scale, v_scale; unused for bf16).
template <typename C, int HD>
__global__ void __launch_bounds__(WG_THREADS)
flash_attention_kernel_wgmma(const bf16* __restrict__ q, const C* __restrict__ k,
                             const C* __restrict__ v, const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ seq_lens, bf16* __restrict__ out, int Sq,
                             int Sk, int H, int KVH, int causal, int window, int prefix_len,
                             float scale) {
  using namespace repro::sm90;
  using S = WgSmem<C, HD>;
  using L = Tile<HD>;
  constexpr bool QUANT = S::QUANT;
  constexpr int NPV = L::SW / 2;  // columns of V one PV product covers (one column block)
  constexpr int NB = HD / NPV;    // column blocks of V
  extern __shared__ __align__(16) uint8_t wg_smem[];
  uint8_t* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane & 3);                 // and columns 8i + c0 + {0, 1}
  const bool ragged = seq_lens != nullptr;
  const int len = ragged ? seq_lens[b] : Sq;
  const int klim = ragged ? min(len, Sk) : Sk;  // keys at or beyond are masked

  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KVH * HD;
  const bf16* q_base = q + (size_t)b * Sq * q_stride + (size_t)h * HD;
  const C* k_base = k + (size_t)b * Sk * kv_stride + (size_t)kvh * HD;
  const C* v_base = v + (size_t)b * Sk * kv_stride + (size_t)kvh * HD;
  const float* ks_base = QUANT ? k_scale + (size_t)b * Sk * KVH + kvh : nullptr;
  const float* vs_base = QUANT ? v_scale + (size_t)b * Sk * KVH + kvh : nullptr;
  bf16* o_base = out + (size_t)b * Sq * q_stride + (size_t)h * HD;

  if (ragged && q0 >= len) {  // every row of the tile is padding
    for (int i = tid; i < BQ * L::CHUNKS; i += WG_THREADS) {
      const int r = i / L::CHUNKS, c = i % L::CHUNKS;
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(o_base + (size_t)(q0 + r) * q_stride + c * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  int k_begin, k_end;
  live_keys(q0, klim, causal, window, prefix_len, k_begin, k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  copy_tile<HD>(sbase + S::Q_OFF, q_base, q_stride, q0, Sq, tid);
  if (n_tiles > 0) {
    if constexpr (QUANT)
      copy_codes<C, HD>(sbase + S::CODE_OFF, sbase + S::SCALE_OFF, k_base, v_base, ks_base,
                        vs_base, kv_stride, KVH, k_begin, Sk, tid);
    else
      copy_kv<HD>(sbase, k_base, v_base, kv_stride, k_begin, Sk, tid);
  }
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of its rows' sums
  float o[NB][NPV / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NPV / 2; ++i) o[nb][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    const int stage = QUANT ? 0 : t & 1;
    cp_async_wait<0>();  // this thread's copies of tile t (and Q) have landed
    if constexpr (QUANT) {
      __syncthreads();  // tile t's codes are visible; tile t - 1's products are done
      if (t + 1 < n_tiles) {
        const int next = (t + 1) & 1;
        copy_codes<C, HD>(sbase + S::CODE_OFF + next * 2 * S::CODES,
                          sbase + S::SCALE_OFF + next * 2 * BK * 4, k_base, v_base, ks_base,
                          vs_base, kv_stride, KVH, k0 + BK, Sk, tid);
        cp_async_commit();
      }
      dequantize<C, HD>(smem, t & 1, tid);
    }
    fence_proxy_async();
    __syncthreads();  // tile t is visible to wgmma; every warp is past tile t - 1
    if constexpr (!QUANT) {
      if (t + 1 < n_tiles) {  // into the stage tile t - 1 used
        copy_kv<HD>(sbase + ((t + 1) & 1) * S::TILE, k_base, v_base, kv_stride, k0 + BK, Sk,
                    tid);
        cp_async_commit();
      }
    }

    float s[32];
    qk_issue<HD>(s, sbase + S::Q_OFF, sbase + S::K_OFF + stage * S::TILE);
    wgmma_wait<0>();
    fence_regs(s);
    float alpha[2];
    online_softmax(s, m, l, alpha, k0, q0, r0, c0, klim, causal, window, prefix_len, scale);
    pv_step<HD>(o, s, alpha, sbase + S::V_OFF + stage * S::TILE);
  }

  // Epilogue: normalize, zero the padding rows, stage the bf16 rows in the
  // Q tile, then 16-byte stores of the rows below Sq.
  cp_async_wait<0>();  // with no live tile, Q's copies may still be in flight
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  __syncthreads();  // every warp is past its last product: the Q tile is free
  stage_output<HD>(smem + S::Q_OFF, o, l, r0, c0, ragged ? len - q0 : BQ);
  __syncthreads();
  store_tile<HD>(o_base, q_stride, smem + S::Q_OFF, q0, Sq, tid);
}

// ------------------------------------- bf16 wide heads: warp-specialized
// Three warpgroups: consumers 0 and 1 (64 query rows each, their own O
// accumulator) and a producer (warpgroup 2), whose one thread loads both
// Q tiles and then each K/V tile by TMA into a ring of STAGES, every tile
// shared by both consumers. setmaxnreg moves the producer's registers to
// the consumers: 128 * 40 + 256 * 232 = 384 * 168, the launch count that
// __launch_bounds__(384, 1) gives (the launch checks it).
constexpr int WIDE_THREADS = 3 * WG_THREADS;
constexpr int WIDE_REGS = 168;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(WIDE_THREADS * WIDE_REGS ==
                  WG_THREADS * PRODUCER_REGS + 2 * WG_THREADS * CONSUMER_REGS,
              "the warpgroups' registers fill the launch's pool");
// named barriers (0 is __syncthreads'): each consumer's own, and both
// consumers' at a unit's end
constexpr int BAR_EPI = 1;   // + consumer
constexpr int BAR_BOTH = 3;

// Shared memory, in bytes from a 1024-aligned base: the two consumers' Q
// tiles (QBUF sets of them: at hd 128 the next unit's Q may land while this
// one runs), the ring of K and V tiles, the mbarriers (each Q set's full
// and empty, the ring's full and empty). hd 256: 64 + 2 x 64 KB; hd 128:
// 2 x 32 + 4 x 32 KB.
template <int HD>
struct WideSmem {
  static constexpr int TILE = BK * HD * 2;
  static constexpr int QBUF = HD >= 256 ? 1 : 2;
  static constexpr int STAGES = HD >= 256 ? 2 : 4;
  static constexpr int Q_OFF = 0;  // + (set * 2 + consumer) * TILE
  static constexpr int K_OFF = Q_OFF + 2 * QBUF * TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  static constexpr int END = BAR_OFF + 8 * (2 * QBUF + 2 * STAGES);
  static constexpr size_t bytes = END + 1024;  // slack to align the base
};

// A work unit: two 64-row q-tiles sharing one K/V stream. Pairing heads (a
// group of an even size: two query heads of one KV group at the same rows)
// or q-tiles (a group of 1 or odd: tiles 2u and 2u + 1 of one head, the
// second maybe past Sq). Units are numbered with the q-tiles that have the
// most keys first.
struct WideUnit {
  int b, kvh, h[2], q0[2];
  int kb[2], ke[2];     // each consumer's live keys
  bool rows[2], live[2];
  int k_begin, n_tiles;  // the union the producer streams, in 64-key tiles
  int len, klim;
};

__device__ __forceinline__ WideUnit wide_unit(int unit, const int* seq_lens, int B, int Sq,
                                              int Sk, int G, int causal, int window,
                                              int prefix_len, int n_qu, int n_hu,
                                              int pair_heads) {
  WideUnit u;
  const int qu = n_qu - 1 - unit / (n_hu * B);
  const int rem = unit % (n_hu * B);
  const int hu = rem % n_hu;
  u.b = rem / n_hu;
  if (pair_heads) {
    u.h[0] = 2 * hu, u.h[1] = 2 * hu + 1;
    u.q0[0] = u.q0[1] = qu * BQ;
  } else {
    u.h[0] = u.h[1] = hu;
    u.q0[0] = 2 * qu * BQ, u.q0[1] = (2 * qu + 1) * BQ;
  }
  u.kvh = u.h[0] / G;
  u.len = seq_lens != nullptr ? seq_lens[u.b] : Sq;
  u.klim = seq_lens != nullptr ? min(u.len, Sk) : Sk;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    u.rows[c] = u.q0[c] < Sq;
    live_keys(u.q0[c], u.klim, causal, window, prefix_len, u.kb[c], u.ke[c]);
    u.live[c] = u.rows[c] && u.q0[c] < u.len && u.ke[c] > u.kb[c];
  }
  u.k_begin = u.live[0] ? (u.live[1] ? min(u.kb[0], u.kb[1]) : u.kb[0]) : u.kb[1];
  const int k_end = u.live[0] ? (u.live[1] ? max(u.ke[0], u.ke[1]) : u.ke[0]) : u.ke[1];
  u.n_tiles = u.live[0] || u.live[1] ? (k_end - u.k_begin + BK - 1) / BK : 0;
  return u;
}

// Persistent: a CTA takes units blockIdx.x, + gridDim.x, ... (one CTA an
// SM), so the producer streams the next unit's Q and K/V while the
// consumers finish this one.
template <int HD>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_attention_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const int* __restrict__ seq_lens, bf16* __restrict__ out, int B,
                            int Sq, int Sk, int H, int KVH, int causal, int window,
                            int prefix_len, float scale, int pair_heads, int n_qu, int n_hu) {
  using namespace repro::sm90;
  using S = WideSmem<HD>;
  using L = Tile<HD>;
  constexpr int NPV = L::SW / 2, NB = HD / NPV;
  constexpr int BLOCKS = HD / 64;  // 128-byte column blocks: one TMA box each
  constexpr int BLOCK_BYTES = BK * 128;
  constexpr int RELEASERS = 2 * WG_THREADS / 32;  // one lane of each consumer warp
  constexpr bool Q_REGS = HD <= 128;  // Q's A fragments in registers (32 a thread)
  extern __shared__ __align__(16) uint8_t wide_smem[];
  uint8_t* smem = wide_smem + ((1024 - (smem_u32(wide_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t q_full = sbase + S::BAR_OFF;   // + 16 * set
  const uint32_t q_empty = q_full + 8;          // + 16 * set
  const uint32_t full_bar = q_full + 16 * S::QBUF;      // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * S::STAGES;  // + 8 * stage
  const int G = H / KVH;
  const int n_units = n_qu * n_hu * B;

  if (threadIdx.x == 0) {
    for (int qs = 0; qs < S::QBUF; ++qs) {
      mbar_init(q_full + 16 * qs, 1);
      mbar_init(q_empty + 16 * qs, RELEASERS);
    }
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, RELEASERS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {  // ------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG_THREADS) {
      int it = 0;  // tiles issued: the ring's position
      for (int unit = blockIdx.x, k = 0; unit < n_units; unit += gridDim.x, ++k) {
        const WideUnit u = wide_unit(unit, seq_lens, B, Sq, Sk, G, causal, window, prefix_len,
                                     n_qu, n_hu, pair_heads);
        const int qs = k % S::QBUF;  // this unit's Q set
        // the unit QBUF before has read the set for the last time
        if (k >= S::QBUF) mbar_wait(q_empty + 16 * qs, ((k / S::QBUF) - 1) & 1);
        // 0 bytes (no live consumer) completes the phase at once
        mbar_expect_tx(q_full + 16 * qs, (u.live[0] + u.live[1]) * S::TILE);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (u.live[c])
#pragma unroll
            for (int blk = 0; blk < BLOCKS; ++blk)
              tma_load_4d(sbase + S::Q_OFF + (qs * 2 + c) * S::TILE + blk * BLOCK_BYTES, &q_map,
                          q_full + 16 * qs, blk * 64, u.h[c], u.q0[c], u.b);
        for (int t = 0; t < u.n_tiles; ++t, ++it) {
          const int s = it % S::STAGES;
          if (it >= S::STAGES) mbar_wait(empty_bar + 8 * s, ((it / S::STAGES) - 1) & 1);
          const int k0 = u.k_begin + t * BK;
          mbar_expect_tx(full_bar + 8 * s, 2 * S::TILE);
#pragma unroll
          for (int blk = 0; blk < BLOCKS; ++blk) {
            tma_load_4d(sbase + S::K_OFF + s * S::TILE + blk * BLOCK_BYTES, &k_map,
                        full_bar + 8 * s, blk * 64, u.kvh, k0, u.b);
            tma_load_4d(sbase + S::V_OFF + s * S::TILE + blk * BLOCK_BYTES, &v_map,
                        full_bar + 8 * s, blk * 64, u.kvh, k0, u.b);
          }
        }
      }
    }
  } else {  // ---------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x - wg * WG_THREADS;
    const int lane = tid & 31;
    const int r0 = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows: r0 and r0 + 8
    const int c0 = 2 * (lane & 3);                 // and columns 8i + c0 + {0, 1}
    const size_t q_stride = (size_t)H * HD;
    int it = 0;  // tiles consumed: the ring's position
    for (int unit = blockIdx.x, k = 0; unit < n_units; unit += gridDim.x, ++k) {
      const WideUnit u = wide_unit(unit, seq_lens, B, Sq, Sk, G, causal, window, prefix_len,
                                   n_qu, n_hu, pair_heads);
      const int q0 = u.q0[wg];
      // this consumer's tiles of the unit's stream: [first, last]
      const int first = (u.kb[wg] - u.k_begin) / BK;
      const int last = u.live[wg] ? (u.ke[wg] - u.k_begin + BK - 1) / BK - 1 : -1;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};  // this thread's share of its rows' sums
      float o[NB][NPV / 2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < NPV / 2; ++i) o[nb][i] = 0.f;

      const int qs = k % S::QBUF;
      const uint32_t q_tile = sbase + S::Q_OFF + (qs * 2 + wg) * S::TILE;
      uint8_t* q_smem = smem + S::Q_OFF + (qs * 2 + wg) * S::TILE;
      mbar_wait(q_full + 16 * qs, (k / S::QBUF) & 1);
      if (!u.live[wg] && lane == 0) mbar_arrive(q_empty + 16 * qs);  // Q unread
      uint32_t qa[Q_REGS ? HD / 16 : 1][4];  // Q's fragments, at hd 128
      if constexpr (Q_REGS)
        if (u.live[wg]) load_q_frags<HD>(qa, q_smem, r0, c0);
      for (int t = 0; t < u.n_tiles; ++t, ++it) {
        const int k0 = u.k_begin + t * BK;
        const int s = it % S::STAGES;
        const bool mine = u.live[wg] && t >= first && t <= last;
        // a tile this consumer skips is waited for all the same before its
        // release, so every phase of the ring's barriers completes in order
        mbar_wait(full_bar + 8 * s, (it / S::STAGES) & 1);
        if (mine) {
          float sc[32];
          if constexpr (Q_REGS) qk_issue_rs<HD>(sc, qa, sbase + S::K_OFF + s * S::TILE);
          else qk_issue<HD>(sc, q_tile, sbase + S::K_OFF + s * S::TILE);
          wgmma_wait<0>();
          fence_regs(sc);
          if (t == last && lane == 0)
            mbar_arrive(q_empty + 16 * qs);  // Q read for the last time
          float alpha[2];
          online_softmax_log2(sc, m, l, alpha, k0, q0, r0, c0, u.klim, causal, window,
                              prefix_len, scale);
          pv_step<HD>(o, sc, alpha, sbase + S::V_OFF + s * S::TILE);
        }
        // this warp is done with stage s (the unit's last stage: after the
        // epilogue, which stages the output there)
        if (lane == 0 && t + 1 < u.n_tiles) mbar_arrive(empty_bar + 8 * s);
      }

      // The output leaves in 16-byte stores, staged in the unit's last K/V
      // stage once both consumers are done with it (consumer 0 in its K
      // tile, 1 in its V tile), so the next unit's Q may land meanwhile.
      // With no tile streamed, no row sees a key: zeros.
      bf16* o_base = out + (size_t)u.b * Sq * q_stride + (size_t)u.h[wg] * HD;
      if (u.n_tiles == 0) {
        if (u.rows[wg])
          for (int i = tid; i < BQ * L::CHUNKS; i += WG_THREADS) {
            const int r = i / L::CHUNKS, c = i % L::CHUNKS;
            if (q0 + r < Sq)
              *reinterpret_cast<uint4*>(o_base + (size_t)(q0 + r) * q_stride + c * 8) =
                  make_uint4(0u, 0u, 0u, 0u);
          }
        continue;
      }
      uint8_t* os = smem + (wg ? S::V_OFF : S::K_OFF) + ((it - 1) % S::STAGES) * S::TILE;
      named_sync(BAR_BOTH, 2 * WG_THREADS);
      if (u.rows[wg]) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
          l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
        }
        stage_output<HD, true>(os, o, l, r0, c0, u.len - q0);
        named_sync(BAR_EPI + wg, WG_THREADS);
        store_tile<HD>(o_base, q_stride, os, q0, Sq, tid);
      }
      fence_proxy_async();  // the staging's reads and writes before the stage's next TMA
      if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % S::STAGES));
    }
  }
}

// cuTensorMapEncodeTiled from the driver (libcuda), found once at run time:
// the library links against the CUDA runtime only.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The tensor map of a (B, S, heads, hd) bf16 tensor whose TMA box is 64
// values of one row (128 bytes, swizzled 128B as Tile<HD>'s column
// blocks) of one head, over 64 rows of one batch row; rows past S read 0.
bool wide_map(CUtensorMap* map, const void* base, int B, int S, int heads, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

template <int HD>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const int* seq_lens,
                        void* out, int B, int Sq, int Sk, int H, int KVH, int causal,
                        int window, int prefix_len, float scale, cudaStream_t stream) {
  auto kern = flash_attention_wide_kernel<HD>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  // setmaxnreg splits the launch's registers; another count would starve
  // the consumers' increase
  if (attr.numRegs != WIDE_REGS) return cudaErrorInvalidConfiguration;
  const size_t smem = WideSmem<HD>::bytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  CUtensorMap q_map, k_map, v_map;
  if (!wide_map(&q_map, q, B, Sq, H, HD) || !wide_map(&k_map, k, B, Sk, KVH, HD) ||
      !wide_map(&v_map, v, B, Sk, KVH, HD))
    return cudaErrorInvalidValue;
  const int G = H / KVH;
  const int pair_heads = G % 2 == 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int n_qu = pair_heads ? n_qt : (n_qt + 1) / 2;
  const int n_hu = pair_heads ? H / 2 : H;
  const long long units = (long long)n_qu * n_hu * B;
  const int sms = sm_count();
  if (units > 0x7fffffffll || sms <= 0) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  kern<<<grid, WIDE_THREADS, smem, stream>>>(q_map, k_map, v_map, seq_lens,
                                             static_cast<bf16*>(out), B, Sq, Sk, H, KVH, causal,
                                             window, prefix_len, scale, pair_heads, n_qu, n_hu);
  return cudaGetLastError();
}

// Which kernel serves q of one dtype at one head dim over native K/V or
// codes (the header's table): 0 the CUDA cores, 1 wgmma (one warpgroup a
// CTA), 2 the wide-head route; -1 refused.
enum Route { CUDA_CORES = 0, WGMMA = 1, WIDE = 2, REFUSED = -1 };

constexpr Route route_of(int hd, bool bf16_q, bool quantized) {
  if (hd != 32 && hd != 64 && hd != 128 && hd != 256) return REFUSED;
  if (hd == 256 && quantized) return REFUSED;  // no quantized path reaches hd 256
  if (!bf16_q) return CUDA_CORES;
  return !quantized && hd >= 128 ? WIDE : WGMMA;
}

template <typename T, typename C, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* seq_lens, void* out, int B, int Sq,
                   int Sk, int H, int KVH, int causal, int window, int prefix_len, float scale,
                   cudaStream_t stream) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  if constexpr (route_of(HD, BF16, !std::is_same<T, C>::value) == WIDE) {
    return launch_wide<HD>(q, k, v, seq_lens, out, B, Sq, Sk, H, KVH, causal, window,
                           prefix_len, scale, stream);
  } else {
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    if constexpr (BF16) {  // the tensor cores, one warpgroup a CTA
      auto kern = flash_attention_kernel_wgmma<C, HD>;
      const size_t smem = WgSmem<C, HD>::bytes;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kern<<<grid, WG_THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const C*>(k), static_cast<const C*>(v),
          k_scale, v_scale, seq_lens, static_cast<T*>(out), Sq, Sk, H, KVH, causal, window,
          prefix_len, scale);
    } else {  // f32: the CUDA cores
      auto kern = flash_attention_kernel<T, C, HD>;
      const size_t smem = Smem<HD>::bytes;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kern<<<grid, THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const C*>(k), static_cast<const C*>(v),
          k_scale, v_scale, seq_lens, static_cast<T*>(out), Sq, Sk, H, KVH, causal, window,
          prefix_len, scale);
    }
    return cudaGetLastError();
  }
}

template <typename T, typename C>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* seq_lens, void* out,
                        int B, int Sq, int Sk, int H, int KVH, int causal, int window,
                        int prefix_len, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, C, 32>(q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH, causal,
                              window, prefix_len, scale, s);
    case 64:
      return launch<T, C, 64>(q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH, causal,
                              window, prefix_len, scale, s);
    case 128:
      return launch<T, C, 128>(q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH, causal,
                               window, prefix_len, scale, s);
    case 256:  // native K/V only (recurrentgemma-2b's MQA); codes stop at 128
      if constexpr (std::is_same<T, C>::value)
        return launch<T, C, 256>(q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH, causal,
                                 window, prefix_len, scale, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_code(int is_fp8, int hd, const void* q, const void* k, const void* v,
                          const float* ks, const float* vs, const int* seq_lens, void* out,
                          int B, int Sq, int Sk, int H, int KVH, int causal, int window,
                          int prefix_len, float scale, cudaStream_t s) {
  if (is_fp8)
    return dispatch_hd<T, __nv_fp8_e4m3>(hd, q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H,
                                         KVH, causal, window, prefix_len, scale, s);
  return dispatch_hd<T, int8_t>(hd, q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH,
                                causal, window, prefix_len, scale, s);
}

bool bad_shape(int B, int Sq, int Sk, int H, int KVH) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0;
}

}  // namespace

// K1 / K1r, the one native-K/V entry point (sources before the prefix-LM
// mask named it flash_attention_fwd, without prefix_len).
// window <= 0 means no window; seq_lens may be null (dense prefill).
// prefix_len > 0: the prefix-LM mask (causal, no seq_lens; see the header).
// is_bf16: 1 for bfloat16 tensors, 0 for float32.
extern "C" cudaError_t flash_attention_prefix_fwd(const void* q, const void* k, const void* v,
                                                  const int* seq_lens, void* out, int B, int Sq,
                                                  int Sk, int H, int KVH, int hd, int causal,
                                                  int window, int prefix_len, int is_bf16,
                                                  float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH) || prefix_len < 0 ||
      (prefix_len > 0 && (!causal || seq_lens != nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k, v, nullptr, nullptr, seq_lens,
                                                     out, B, Sq, Sk, H, KVH, causal, window,
                                                     prefix_len, scale, s);
  return dispatch_hd<float, float>(hd, q, k, v, nullptr, nullptr, seq_lens, out, B, Sq, Sk, H,
                                   KVH, causal, window, prefix_len, scale, s);
}

// K1q / K1rq: k, v int8 (is_fp8 0) or float8_e4m3fn (is_fp8 1) codes with
// k_scale, v_scale (B, Sk, KVH) float32; q and out bfloat16 (is_bf16 1) or
// float32. The other arguments are flash_attention_prefix_fwd's.
extern "C" cudaError_t flash_attention_quant_fwd(const void* q, const void* k, const void* v,
                                                 const float* k_scale, const float* v_scale,
                                                 const int* seq_lens, void* out, int B,
                                                 int Sq, int Sk, int H, int KVH, int hd,
                                                 int causal, int window, int is_bf16,
                                                 int is_fp8, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH) || k_scale == nullptr || v_scale == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)  // no prefix: no path attends quantized K/V at prefill
    return dispatch_code<__nv_bfloat16>(is_fp8, hd, q, k, v, k_scale, v_scale, seq_lens, out,
                                        B, Sq, Sk, H, KVH, causal, window, 0, scale, s);
  return dispatch_code<float>(is_fp8, hd, q, k, v, k_scale, v_scale, seq_lens, out, B, Sq, Sk,
                              H, KVH, causal, window, 0, scale, s);
}

// The route that serves (hd, q's dtype, quantized K/V): 0 the CUDA cores,
// 1 wgmma (one warpgroup a CTA), 2 the wide-head route, -1 refused.
extern "C" int flash_attention_route(int hd, int is_bf16, int quantized) {
  return route_of(hd, is_bf16 != 0, quantized != 0);
}

template <int HD>
int smem_of(int is_bf16, int quantized) {
  switch (route_of(HD, is_bf16 != 0, quantized != 0)) {
    case CUDA_CORES: return (int)Smem<HD>::bytes;
    case WGMMA: return quantized ? (int)WgSmem<int8_t, HD>::bytes : (int)WgSmem<bf16, HD>::bytes;
    case WIDE: return (int)WideSmem<HD>::bytes;
    default: return 0;
  }
}

// Dynamic shared memory one CTA of the route that serves (hd, q's dtype,
// quantized K/V) takes (0 if refused). The f32 kernel stages the same
// float tiles over codes.
extern "C" int flash_attention_smem_bytes(int hd, int is_bf16, int quantized) {
  switch (hd) {
    case 32: return smem_of<32>(is_bf16, quantized);
    case 64: return smem_of<64>(is_bf16, quantized);
    case 128: return smem_of<128>(is_bf16, quantized);
    case 256: return smem_of<256>(is_bf16, quantized);
    default: return 0;
  }
}
