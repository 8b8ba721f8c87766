// The tensor-core core of chunked-prefill attention for Hopper (sm_90a),
// shared by K4 (chunk_attention.cu) and K4p/K4q (paged_chunk_attention.cu):
// everything but the tile load.
//
// One CTA per (tile of 64 chunk queries, head, batch row) is one warpgroup
// (128 threads; 64 query rows is wgmma's M). Q arrives once, and the K/V
// tiles of 64 key slots in a ring of two stages, by 16-byte cp.async copies
// in sm90.cuh's swizzled layout; beside each stage's tiles lies the key
// position of each of its 64 slots (-1: no key), which the mask reads. A
// source (the file's loader) issues the copies of tile t + 1 while tile t's
// QK^T runs on the tensor cores. Per tile: S = Q K^T is hd/16 wgmma
// m64n64k16 products from shared memory (K-major); the scale, the mask
// (a key is visible to query i when 0 <= its position <= pos0 + i) and
// the online softmax run on S's accumulator fragment, each thread holding
// two rows, quad shuffles reducing them; P, rounded to bf16, is the
// register A operand of O += P V (m64n{32,64}k16, the V tile MN-major), so
// P never touches shared memory. The output is O / max(l, 1e-30), zeros at
// and beyond `valid`, staged in the Q tile and written in 16-byte stores.
//
// Code rows (int8 or float8_e4m3fn with one f32 scale per row) take their
// own copies, into a code stage beside the bf16 ring, and the thread that
// copied a row's codes dequantizes them into the stage's bf16 tile
// (dequant.cuh::dequant16_bf16, so rounding is `dequantize_kv`'s) once they
// have landed. Before wgmma reads what threads wrote (cp.async copies,
// dequantized rows), every thread waits for its copies, fences the async
// proxy, and the CTA meets at a barrier (bar.red.or, which also tells the
// CTA whether the tile holds any key: a tile with none is skipped).
//
// Masked scores are -1e30. Where every key a row has seen so far is masked,
// its running max is still -1e30 and those keys get p = exp(0) = 1, as in
// the CUDA-core kernels and the Pallas one: a later tile with a visible
// key has alpha = exp(-1e30 - m) = 0 and erases them. The K/V of empty
// slots are finite (the tests fill them with +-1e30: |S| and |O| stay
// below 1e33), so 0 * O stays 0 and outputs stay finite; the card tests
// hold rows whose first tile is all masked (and a hole in a prefix) to
// the plain version, so p is not forced to 0 there.
#pragma once

#include <type_traits>

#include "dequant.cuh"
#include "sm90.cuh"

namespace repro::chunk {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // chunk queries per CTA (wgmma's M)
constexpr int BK = 64;        // key slots per tile
constexpr int THREADS = 128;  // one warpgroup; two threads per key slot of a tile
constexpr float LOG2E = 1.4426950408889634f;

// What a source put in one slot of a tile: nothing (zeros), a bf16 row, or
// codes to dequantize.
enum Row { NONE = 0, NATIVE = 1, CODES = 2 };

// Shared memory in bytes from a 1024-aligned base: the Q tile (reused for
// the output), the two-stage ring of bf16 K and V tiles and the key
// positions, and, for sources with code rows, two stages of K and V codes
// and their scales. Every bf16 tile starts on a 1024-byte boundary. A
// launch whose source can yield no code row may pass bytes_native.
template <int HD> struct Smem {
  static constexpr int TILE = BK * HD * 2;             // one bf16 tile of 64 rows
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + TILE;           // [stage]
  static constexpr int V_OFF = K_OFF + 2 * TILE;       // [stage]
  static constexpr int POS_OFF = V_OFF + 2 * TILE;     // [stage][BK] int
  static constexpr int CODE_OFF = POS_OFF + 2 * BK * 4;  // [stage][K, V][BK][HD] codes
  static constexpr int SCALE_OFF = CODE_OFF + 4 * BK * HD;  // [stage][K, V][BK] f32
  static constexpr int END = SCALE_OFF + 4 * BK * 4;
  static constexpr size_t bytes_native = CODE_OFF + 1024;  // slack to align the base
  static constexpr size_t bytes = END + 1024;

  __device__ static uint32_t k_tile(uint32_t base, int s) { return base + K_OFF + s * TILE; }
  __device__ static uint32_t v_tile(uint32_t base, int s) { return base + V_OFF + s * TILE; }
  __device__ static uint32_t pos(uint32_t base, int s) { return base + POS_OFF + s * BK * 4; }
  // which 0: K, 1: V
  __device__ static uint32_t codes(uint32_t base, int s, int which) {
    return base + CODE_OFF + (2 * s + which) * BK * HD;
  }
  __device__ static uint32_t scales(uint32_t base, int s, int which) {
    return base + SCALE_OFF + (2 * s + which) * BK * 4;
  }
};

// The 64-row tile of ``src`` rows [row0, row0 + 64) (HD bf16 values, rows
// ``stride`` apart) into the swizzled tile at shared address ``dst``; rows
// at or past ``rows_total`` read nothing and land as zeros.
template <int HD>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src, size_t stride, int row0,
                                          int rows_total, int tid) {
  using L = repro::sm90::Tile<HD>;
  for (int i = tid; i < BK * L::CHUNKS; i += THREADS) {
    const int r = i / L::CHUNKS, c = i % L::CHUNKS;
    const bool ok = row0 + r < rows_total;
    repro::sm90::cp_async16(dst + repro::sm90::tile_offset<HD>(BK, r, c),
                            src + (size_t)(ok ? row0 + r : 0) * stride + c * 8, ok ? 16 : 0);
  }
}

// Row r of the bf16 tile at ``tile`` from ``src`` (HD values); ``ok``
// false lands zeros (``src`` must still be a valid address).
template <int HD>
__device__ __forceinline__ void copy_row(uint32_t tile, int r, const bf16* src, bool ok) {
#pragma unroll
  for (int c = 0; c < repro::sm90::Tile<HD>::CHUNKS; ++c)
    repro::sm90::cp_async16(tile + repro::sm90::tile_offset<HD>(BK, r, c), src + c * 8,
                            ok ? 16 : 0);
}

// Row r's HD one-byte codes from ``src`` into the code tile at ``codes``
// (row-major, HD bytes a row) and its scale into ``scales``.
template <int HD>
__device__ __forceinline__ void copy_code_row(uint32_t codes, uint32_t scales, int r,
                                              const void* src, const float* scale) {
#pragma unroll
  for (int c = 0; c < HD / 16; ++c)
    repro::sm90::cp_async16(codes + r * HD + c * 16, static_cast<const uint8_t*>(src) + c * 16,
                            16);
  repro::sm90::cp_async4(scales + r * 4, scale, 4);
}

// Row r of stage ``s``'s K (which 0) or V (1) codes dequantized into the
// stage's bf16 tile, by the thread that copied them, after its copies have
// landed.
template <typename C, int HD>
__device__ __forceinline__ void dequant_row(uint8_t* smem, int s, int which, int r) {
  using S = Smem<HD>;
  const uint8_t* codes = smem + S::CODE_OFF + (2 * s + which) * BK * HD + r * HD;
  const float scale =
      reinterpret_cast<const float*>(smem + S::SCALE_OFF + (2 * s + which) * BK * 4)[r];
  uint8_t* tile = smem + (which ? S::V_OFF : S::K_OFF) + s * S::TILE;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    uint4 lo, hi;
    repro::dequant16_bf16<C>(*reinterpret_cast<const uint4*>(codes + c * 16), scale, lo, hi);
    *reinterpret_cast<uint4*>(tile + repro::sm90::tile_offset<HD>(BK, r, 2 * c)) = lo;
    *reinterpret_cast<uint4*>(tile + repro::sm90::tile_offset<HD>(BK, r, 2 * c + 1)) = hi;
  }
}

// Rows [q0, min(q0 + 64, C)) of the output (rows ``stride`` apart) as zeros.
template <int HD>
__device__ __forceinline__ void zero_rows(bf16* o, size_t stride, int q0, int C, int tid) {
  using L = repro::sm90::Tile<HD>;
  for (int i = tid; i < BQ * L::CHUNKS; i += THREADS) {
    const int r = i / L::CHUNKS, c = i % L::CHUNKS;
    if (q0 + r < C)
      *reinterpret_cast<uint4*>(o + (size_t)(q0 + r) * stride + c * 8) = make_uint4(0u, 0u, 0u, 0u);
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

// The chunk attention of one CTA. ``src.issue(smem, sbase, stage, k0, r,
// which)`` issues this thread's copies of slot r of the tile of key slots
// [k0, k0 + 64) into ``stage``: its K row (which 0; this thread also stores
// the slot's key position) or its V row (which 1). It returns the row's
// Row kind in ``kind`` and whether the slot holds a key (a tile in which no
// slot does is skipped). C is the code type the source's code rows hold.
//   q_base, o_base: this (batch row, head)'s q and output, rows q_stride apart
//   C_rows: chunk rows C; q0: the tile's first; nv: valid; qpos0: pos0 + q0
//   n_tiles: key tiles [0, 64 n_tiles) to visit
template <typename C, int HD, class Src>
__device__ __forceinline__ void attend(const Src& src, const bf16* q_base, bf16* o_base,
                                       size_t q_stride, int C_rows, int q0, int nv, int qpos0,
                                       int n_tiles, float scale) {
  using namespace repro::sm90;
  using S = Smem<HD>;
  using L = Tile<HD>;
  constexpr int NPV = L::SW / 2;  // columns of V one PV product covers (one column block)
  constexpr int NB = HD / NPV;    // column blocks of V
  extern __shared__ __align__(16) uint8_t chunk_smem[];
  uint8_t* smem = chunk_smem + ((1024 - (smem_u32(chunk_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane & 3);                 // and columns 8i + c0 + {0, 1}
  const int slot = tid >> 1, which = tid & 1;    // the tile slot and half this thread copies

  copy_tile<HD>(sbase + S::Q_OFF, q_base, q_stride, q0, C_rows, tid);
  int kind = NONE, has_key = 0;  // this thread's slot of the tile in flight
  if (n_tiles > 0) src.issue(smem, sbase, 0, 0, slot, which, kind, has_key);
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of its rows' sums
  float o[NB][NPV / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NPV / 2; ++i) o[nb][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const bool more = t + 1 < n_tiles;
    cp_async_wait<0>();  // this thread's copies of tile t (and Q) have landed
    if constexpr (!std::is_same<C, bf16>::value)
      if (kind == CODES) dequant_row<C, HD>(smem, stage, which, slot);
    fence_proxy_async();
    // tile t is visible to wgmma; every warp is past tile t - 1, so its stage is free
    if (!__syncthreads_or(has_key)) {  // no key in the tile: it adds nothing
      if (more) src.issue(smem, sbase, stage ^ 1, (t + 1) * BK, slot, which, kind, has_key);
      cp_async_commit();
      continue;
    }

    // S = Q K^T, and tile t + 1's copies while it runs
    float s[32];
    const uint32_t k_tile = S::k_tile(sbase, stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = tile_offset<HD>(BK, 0, 2 * kk);  // k-step kk's 32 bytes of row 0
      wgmma_m64n64k16_ss(s, descriptor<HD>(sbase + S::Q_OFF + off), descriptor<HD>(k_tile + off),
                         kk > 0);
    }
    wgmma_commit();
    if (more) src.issue(smem, sbase, stage ^ 1, (t + 1) * BK, slot, which, kind, has_key);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale, mask, online softmax on the fragment: s[4i + e] is row
    // r0 + 8 * (e / 2), key slot 8i + c0 + e % 2
    const int* pos = reinterpret_cast<const int*>(smem + S::POS_OFF) + stage * BK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int2 kp = *reinterpret_cast<const int2*>(pos + 8 * i + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = (e & 1) ? kp.y : kp.x;
        const bool ok = p >= 0 && p <= qpos0 + r0 + 8 * (e >> 1);
        s[4 * i + e] = ok ? s[4 * i + e] * scale : NEG_INF;
      }
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
    const uint32_t v_tile = S::v_tile(sbase, stage);
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

  // Epilogue: normalize, zero the rows at or beyond valid, stage the bf16
  // rows in the Q tile, then 16-byte stores of the rows below C.
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
    const bool pad = q0 + r >= nv;
    const float denom = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < NPV / 8; ++i) {
        const float a = pad ? 0.f : o[nb][4 * i + 2 * hr] / denom;
        const float b = pad ? 0.f : o[nb][4 * i + 2 * hr + 1] / denom;
        *reinterpret_cast<uint32_t*>(os + tile_offset<HD>(BQ, r, nb * NPV / 8 + i) + 2 * c0) =
            pack_bf16(a, b);
      }
  }
  __syncthreads();
  for (int i = tid; i < BQ * L::CHUNKS; i += THREADS) {
    const int r = i / L::CHUNKS, c = i % L::CHUNKS;
    if (q0 + r < C_rows)
      *reinterpret_cast<uint4*>(o_base + (size_t)(q0 + r) * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(os + tile_offset<HD>(BQ, r, c));
  }
}

}  // namespace repro::chunk
