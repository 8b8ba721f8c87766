// Causal (optionally windowed, optionally ragged) GQA prefill attention for
// Hopper (sm_90a), over native or quantized K/V, written for clarity first.
//
// Replaces the Pallas TPU kernels `_attn_kernel` and `_attn_kernel_ragged`
// (src/repro/kernels/flash_attention.py), K1 and K1r, and their
// `quantized=True` variants, K1q and K1rq. Layouts are the reference's:
//   q, out (B, Sq, H, hd)   k, v (B, Sk, KVH, hd)   seq_lens (B,) int32 or null
//   quantized: k, v int8 or float8_e4m3fn codes, k_scale, v_scale (B, Sk, KVH) f32
// Query head h reads KV head h / (H / KVH).
//
// One CTA per (q-tile of 64 rows, head, batch row). The TPU kernel's
// sequential innermost grid axis over KV tiles becomes a loop inside the
// CTA, carrying the online-softmax state (m, l, acc) in registers in f32.
//
// Masking follows the TPU kernel: scores are (q.k) * scale in f32, masked
// keys score -1e30, the output is acc / max(l, 1e-30), p is rounded to the
// value dtype before the PV product, KV tiles wholly above the diagonal,
// outside the window, or at or beyond the row's length are skipped, and
// query rows at or beyond the row's length are written as zeros. Any Sq and
// Sk are accepted (the ragged tile edge is masked); hd must be 32, 64 or 128,
// or 256 over native K/V (recurrentgemma-2b's MQA heads).
//
// Quantized K/V (K1q, K1rq) change only the tile loads: each code is
// converted exactly, multiplied by its row and head's scale in f32 and
// rounded to q's dtype (dequant.cuh's shared conversion), as the
// reference's `dequantize_kv` and the Pallas kernel's per-tile dequant do.
// Everything after the load is K1's arithmetic.
//
// Two kernels, one per dtype of q:
//
// bf16 (flash_attention_kernel_wgmma): the CTA is one warpgroup (128
// threads; 64 query rows is wgmma's M). S = Q K^T is hd/16
// wgmma m64n64k16 products with Q and the K tile read from shared memory
// (K-major); the softmax runs on S's accumulator fragment (each thread holds
// two rows, quad shuffles reduce them); P, rounded to bf16, is the register
// A operand of O += P V, 4 k-steps of m64n{32,64}k16 with the V tile as an
// MN-major B. Q and the K/V tiles arrive by 16-byte cp.async copies
// (rows past Sk zero-filled) in the swizzled layout of sm90.cuh, K/V in a
// ring of two stages: tile j + 1's copies are issued before tile j's
// products. Quantized codes and their scales take that ring instead, and
// the warpgroup dequantizes each tile into one bf16 K and V tile before its
// products. Before wgmma reads what threads wrote, every thread waits for
// its copies, fences the async proxy, and the CTA meets at a barrier. The
// output leaves through shared memory in 16-byte stores.
//
// f32 (flash_attention_kernel): on the CUDA cores, since a tensor-core
// product in f32 is TF32 and would break the f32 rule it is held to. Two
// threads share a query row: each scores half of a 64-key tile and owns
// half of the output dims, from f32 tiles in shared memory.
//
// What bounds it: at the serving shapes (B 8, S 512, H 32 on 8 KV heads,
// hd 64, bf16) the causal work is ~8.6 GFLOP against ~42 MB, which the
// tensor cores make byte-bound (~12.5 us on an H100). The bf16 kernel stays
// above that, bound by issue: each CTA runs its tiles as one chain (wait
// for the copies, QK^T, wait, softmax, PV, wait) and one warpgroup has no
// other work for the gaps, so products, exponentials and copies take turns.
// chip_smoke.py's flash_anatomy phase shows it: time follows the tiles
// computed, four times the K/V bytes (no GQA) cost nothing, and the causal
// grid's diagonal tiles (masked halves computed, the masking path) and its
// triangular load (the last q-tile runs eight tiles, the first one) add to
// each tile's cost. Two warpgroups ping-ponging softmax and products, a
// persistent grid that starts the longest q-tiles first, and K/V shared
// across a KV group are the next levers.
//
// hd 256 (recurrentgemma-2b: 10 query heads on one KV head). bf16: a 64-row
// tile is 32 KB, so Q and two stages of K and V take 160 KB and one CTA fits
// an SM; the O accumulator is four 64-column blocks of V, 128 f32 registers
// a thread beside S's 32 (chip_smoke.py's build phase prints ptxas's
// registers and spills per instantiation). f32: the CUDA-core kernel's
// tiles take 215,296 bytes at QS = KS = 260, inside the 232,448 a CTA may
// have, and each thread holds 128 output dims.
#include <type_traits>

#include "dequant.cuh"
#include "sm90.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
using repro::load_rows_dequant_range;
using repro::NEG_INF;
using repro::to_f;

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 2 * BQ; // two threads per query row

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
                       int causal, int window, float scale) {
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

  // Live KV range of this q-tile: below the diagonal, inside the window,
  // before the row's length.
  int k_end = klim;
  if (causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

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
      bool ok = kp < klim;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      sc[jj] = ok ? sc[jj] * scale : NEG_INF;
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

// C is the K/V element type: bf16, or int8_t / __nv_fp8_e4m3 codes with
// their scales (k_scale, v_scale; unused for bf16).
template <typename C, int HD>
__global__ void __launch_bounds__(WG_THREADS)
flash_attention_kernel_wgmma(const bf16* __restrict__ q, const C* __restrict__ k,
                             const C* __restrict__ v, const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ seq_lens, bf16* __restrict__ out, int Sq,
                             int Sk, int H, int KVH, int causal, int window, float scale) {
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

  // Live KV range of this q-tile: below the diagonal, inside the window,
  // before the row's length.
  int k_end = klim;
  if (causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;
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

    // S = Q K^T
    float s[32];
    const uint32_t k_tile = sbase + S::K_OFF + stage * S::TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = tile_offset<HD>(BK, 0, 2 * kk);  // k-step kk's 32 bytes of row 0
      wgmma_m64n64k16_ss(s, descriptor<HD>(sbase + S::Q_OFF + off),
                         descriptor<HD>(k_tile + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale, mask, online softmax on the fragment: s[4i + e] is row
    // r0 + 8 * (e / 2), key k0 + 8i + c0 + e % 2
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
          bool ok = kp < klim;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          x = ok ? x : NEG_INF;
        }
        s[4 * i + e] = x;
      }
    float alpha[2];
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

    // O = O * alpha + P V, P rounded to bf16 as the A operand
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < NPV / 2; ++i) o[nb][i] *= alpha[(i >> 1) & 1];
    const uint32_t v_tile = sbase + S::V_OFF + stage * S::TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)  // column block nb, key rows 16kk..16kk+15
        pv_product<NPV>(o[nb], p[kk],
                        descriptor<HD>(v_tile + nb * BK * L::SW + 16 * kk * L::SW));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
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
  uint8_t* os = smem + S::Q_OFF;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    const bool pad = ragged && q0 + r >= len;
    const float denom = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < NPV / 8; ++i) {
        const float a = pad ? 0.f : o[nb][4 * i + 2 * hr] / denom;
        const float c = pad ? 0.f : o[nb][4 * i + 2 * hr + 1] / denom;
        *reinterpret_cast<uint32_t*>(os + tile_offset<HD>(BQ, r, nb * NPV / 8 + i) + 2 * c0) =
            pack_bf16(a, c);
      }
  }
  __syncthreads();
  for (int i = tid; i < BQ * L::CHUNKS; i += WG_THREADS) {
    const int r = i / L::CHUNKS, c = i % L::CHUNKS;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(o_base + (size_t)(q0 + r) * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(os + tile_offset<HD>(BQ, r, c));
  }
}

template <typename T, typename C, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* seq_lens, void* out, int B, int Sq,
                   int Sk, int H, int KVH, int causal, int window, float scale,
                   cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor cores
    auto kern = flash_attention_kernel_wgmma<C, HD>;
    const size_t smem = WgSmem<C, HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, WG_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(k), static_cast<const C*>(v), k_scale,
        v_scale, seq_lens, static_cast<T*>(out), Sq, Sk, H, KVH, causal, window, scale);
  } else {  // f32: the CUDA cores
    auto kern = flash_attention_kernel<T, C, HD>;
    const size_t smem = Smem<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(k), static_cast<const C*>(v), k_scale,
        v_scale, seq_lens, static_cast<T*>(out), Sq, Sk, H, KVH, causal, window, scale);
  }
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* seq_lens, void* out,
                        int B, int Sq, int Sk, int H, int KVH, int causal, int window,
                        float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, C, 32>(q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH, causal,
                              window, scale, s);
    case 64:
      return launch<T, C, 64>(q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH, causal,
                              window, scale, s);
    case 128:
      return launch<T, C, 128>(q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH, causal,
                               window, scale, s);
    case 256:  // native K/V only (recurrentgemma-2b's MQA); codes stop at 128
      if constexpr (std::is_same<T, C>::value)
        return launch<T, C, 256>(q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH, causal,
                                 window, scale, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_code(int is_fp8, int hd, const void* q, const void* k, const void* v,
                          const float* ks, const float* vs, const int* seq_lens, void* out,
                          int B, int Sq, int Sk, int H, int KVH, int causal, int window,
                          float scale, cudaStream_t s) {
  if (is_fp8)
    return dispatch_hd<T, __nv_fp8_e4m3>(hd, q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H,
                                         KVH, causal, window, scale, s);
  return dispatch_hd<T, int8_t>(hd, q, k, v, ks, vs, seq_lens, out, B, Sq, Sk, H, KVH,
                                causal, window, scale, s);
}

bool bad_shape(int B, int Sq, int Sk, int H, int KVH) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0;
}

}  // namespace

// window <= 0 means no window; seq_lens may be null (dense prefill).
// is_bf16: 1 for bfloat16 tensors, 0 for float32.
extern "C" cudaError_t flash_attention_fwd(const void* q, const void* k, const void* v,
                                           const int* seq_lens, void* out, int B, int Sq,
                                           int Sk, int H, int KVH, int hd, int causal,
                                           int window, int is_bf16, float scale,
                                           void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k, v, nullptr, nullptr, seq_lens,
                                                     out, B, Sq, Sk, H, KVH, causal, window,
                                                     scale, s);
  return dispatch_hd<float, float>(hd, q, k, v, nullptr, nullptr, seq_lens, out, B, Sq, Sk, H,
                                   KVH, causal, window, scale, s);
}

// K1q / K1rq: k, v int8 (is_fp8 0) or float8_e4m3fn (is_fp8 1) codes with
// k_scale, v_scale (B, Sk, KVH) float32; q and out bfloat16 (is_bf16 1) or
// float32. The other arguments are flash_attention_fwd's.
extern "C" cudaError_t flash_attention_quant_fwd(const void* q, const void* k, const void* v,
                                                 const float* k_scale, const float* v_scale,
                                                 const int* seq_lens, void* out, int B,
                                                 int Sq, int Sk, int H, int KVH, int hd,
                                                 int causal, int window, int is_bf16,
                                                 int is_fp8, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KVH) || k_scale == nullptr || v_scale == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_code<__nv_bfloat16>(is_fp8, hd, q, k, v, k_scale, v_scale, seq_lens, out,
                                        B, Sq, Sk, H, KVH, causal, window, scale, s);
  return dispatch_code<float>(is_fp8, hd, q, k, v, k_scale, v_scale, seq_lens, out, B, Sq, Sk,
                              H, KVH, causal, window, scale, s);
}

template <int HD>
int smem_of(int is_bf16, int quantized) {
  if (!is_bf16) return (int)Smem<HD>::bytes;
  return quantized ? (int)WgSmem<int8_t, HD>::bytes : (int)WgSmem<bf16, HD>::bytes;
}

// Dynamic shared memory one CTA takes for head dim hd (0 if unsupported;
// hd 256 over native K/V only):
// the f32 kernel's (is_bf16 0; the quantized kernel stages the same float
// tiles) or the bf16 wgmma kernel's over native (quantized 0) or code K/V.
extern "C" int flash_attention_smem_bytes(int hd, int is_bf16, int quantized) {
  switch (hd) {
    case 32: return smem_of<32>(is_bf16, quantized);
    case 64: return smem_of<64>(is_bf16, quantized);
    case 128: return smem_of<128>(is_bf16, quantized);
    case 256: return quantized ? 0 : smem_of<256>(is_bf16, quantized);
    default: return 0;
  }
}
