// Dequantizing tile loads shared by the kernels that read int8 or
// float8_e4m3fn KV codes with one float32 scale per row and KV head (K1q,
// K4q, K4p; K2q and K3q through decode_core.cuh, which dequantizes codes
// already in shared memory): each code converts to float exactly, is multiplied by
// its scale in f32, and the product is rounded to the compute dtype T, as the
// reference's `dequantize_kv` and the Pallas kernels do.
//
// The unscaled routes (K2q, K3q, K4p over an unscaled storage cast: K/V
// stored as __half, __nv_bfloat16, float or __nv_fp8_e4m3 under another
// compute dtype) read their values with the loaders below: each stored
// value converts to float exactly and is rounded to T once, to nearest
// even, as the reference's `ck.astype(q.dtype)` rounds it. No scale is
// multiplied in.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

// The 8 one-byte codes of ``u`` as floats, exactly, into f[0..7] (code e
// is byte e % 4 of word e / 4, little-endian):
// - int8 with no conversion instruction (those issue at a quarter of the
//   FP32 rate): byte ^ 0x80 is code + 128 in [0, 255]; set as the low byte
//   of the float 2^23 (0x4B000000) it gives 2^23 + code + 128 exactly, and
//   taking 2^23 + 128 away is exact.
// - e4m3 two codes a conversion, to f16 (exact: every e4m3 value is an f16
//   value), then to f32.
template <typename C> __device__ __forceinline__ void codes8_to_f(uint2 u, float (&f)[8]);
template <> __device__ __forceinline__ void codes8_to_f<int8_t>(uint2 u, float (&f)[8]) {
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int e = 0; e < 8; ++e)  // bytes (code + 128, 0, 0, 0x4B)
    f[e] = __uint_as_float(__byte_perm(w[e / 4], 0x4B000000u, 0x7540u | (e % 4))) - 8388736.f;
}
template <> __device__ __forceinline__ void codes8_to_f<__nv_fp8_e4m3>(uint2 u, float (&f)[8]) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w[p / 2] >> (16 * (p % 2))), __NV_E4M3));
    const float2 x = __half22float2(h);
    f[2 * p] = x.x;
    f[2 * p + 1] = x.y;
  }
}

// The 16 bytes of ``u`` as floats, exactly, for the unscaled stores that
// common.cuh's unpack does not cover: 8 float16 or 16 e4m3 values.
template <> __device__ __forceinline__ void unpack<__half>(float* d, uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(reinterpret_cast<const __half2&>(w[i]));
    d[2 * i] = x.x;
    d[2 * i + 1] = x.y;
  }
}
template <> __device__ __forceinline__ void unpack<__nv_fp8_e4m3>(float* d, uint4 u) {
  float lo[8], hi[8];
  codes8_to_f<__nv_fp8_e4m3>(make_uint2(u.x, u.y), lo);
  codes8_to_f<__nv_fp8_e4m3>(make_uint2(u.z, u.w), hi);
#pragma unroll
  for (int e = 0; e < 8; ++e) d[e] = lo[e], d[8 + e] = hi[e];
}

// 8 consecutive stored values of S at ``p`` (8 * sizeof(S)-byte aligned)
// as floats, exactly.
template <typename S> __device__ __forceinline__ void vals8_to_f(const S* p, float (&f)[8]);
template <> __device__ __forceinline__ void vals8_to_f<__nv_fp8_e4m3>(const __nv_fp8_e4m3* p,
                                                                     float (&f)[8]) {
  codes8_to_f<__nv_fp8_e4m3>(__ldg(reinterpret_cast<const uint2*>(p)), f);
}
template <> __device__ __forceinline__ void vals8_to_f<__half>(const __half* p, float (&f)[8]) {
  unpack<__half>(f, __ldg(reinterpret_cast<const uint4*>(p)));
}
template <> __device__ __forceinline__ void vals8_to_f<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                     float (&f)[8]) {
  unpack<__nv_bfloat16>(f, __ldg(reinterpret_cast<const uint4*>(p)));
}
template <> __device__ __forceinline__ void vals8_to_f<float>(const float* p, float (&f)[8]) {
  unpack<float>(f, __ldg(reinterpret_cast<const uint4*>(p)));
  unpack<float>(f + 4, __ldg(reinterpret_cast<const uint4*>(p) + 1));
}

// One 16-byte chunk ``u`` of stored values of S (16 / sizeof(S) of them;
// S no wider than T) converted to T in place at ``at``: value e lands at
// byte e * sizeof(T), rounded once to nearest even. ``u`` was read from
// ``at`` before, so the values may overwrite it.
template <typename S, typename T>
__device__ __forceinline__ void cast_chunk(uint4 u, char* at) {
  constexpr int N = 16 / (int)sizeof(S);
  static_assert(sizeof(S) <= sizeof(T), "a wider store is converted as it is loaded");
  float f[16];
  unpack<S>(f, u);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < N / 4; ++e)
      reinterpret_cast<float4*>(at)[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                                                     f[4 * e + 3]);
  } else {
    uint32_t o[8];
#pragma unroll
    for (int p = 0; p < N / 2; ++p) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * p], f[2 * p + 1]);
      o[p] = reinterpret_cast<const uint32_t&>(h);
    }
#pragma unroll
    for (int e = 0; e < N / 8; ++e)
      reinterpret_cast<uint4*>(at)[e] = make_uint4(o[4 * e], o[4 * e + 1], o[4 * e + 2],
                                                   o[4 * e + 3]);
  }
}

// 8 stored values of S at ``p`` rounded to bf16 (nearest even), packed as
// the 16 bytes of 8 values of a bf16 row.
template <typename S>
__device__ __forceinline__ uint4 cast8_bf16(const S* p) {
  float f[8];
  vals8_to_f<S>(p, f);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    o[i] = reinterpret_cast<const uint32_t&>(h);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The 8 codes of ``u`` dequantized with ``scale`` and rounded to bf16, as
// the bytes of 8 values of a bf16 row (code 2i in the low half of word i):
// (float(code) * scale) in f32, rounded to bf16, as store_dequant16; two
// values a rounding instruction.
template <typename C>
__device__ __forceinline__ uint4 dequant8_bf16(uint2 u, float scale) {
  float f[8];
  codes8_to_f<C>(u, f);
  uint32_t o[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * p] * scale, f[2 * p + 1] * scale);
    o[p] = reinterpret_cast<const uint32_t&>(h);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The 16 one-byte codes of ``u`` dequantized with ``scale`` and rounded to
// T, as floats into d[0..15]: (float(code) * scale) in f32, rounded to T,
// the one rule every dequantizing load shares.
template <typename C, typename T>
__device__ __forceinline__ void store_dequant16(float* d, uint4 u, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float f[8];
    codes8_to_f<C>(h ? make_uint2(u.z, u.w) : make_uint2(u.x, u.y), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) d[8 * h + e] = to_f(from_f<T>(f[e] * scale));
  }
}

// The 16 codes of ``u`` dequantized and rounded as store_dequant16 does,
// kept as bf16: codes 0-7 in ``lo`` and 8-15 in ``hi`` (dequant8_bf16).
template <typename C>
__device__ __forceinline__ void dequant16_bf16(uint4 u, float scale, uint4& lo, uint4& hi) {
  lo = dequant8_bf16<C>(make_uint2(u.x, u.y), scale);
  hi = dequant8_bf16<C>(make_uint2(u.z, u.w), scale);
}

// The tile rows named by ``qrows`` (``nrows`` entries; >= 0: a row of the
// quantized codes, rows ``src_stride`` codes apart; below 0: a row left as
// it is, which another copy fills) as codes C with 16-byte loads, U in flight
// per thread, dequantized with the row's scale (``scales[row *
// scale_stride]``) and rounded to T exactly as `dequantize_kv` does, then
// stored as floats (rows ``dst_stride`` floats apart).
template <typename C, typename T, int HD>
__device__ __forceinline__ void load_rows_dequant(float* dst, int dst_stride,
                                                  const C* __restrict__ src,
                                                  size_t src_stride,
                                                  const float* __restrict__ scales,
                                                  int scale_stride, const int* qrows,
                                                  int nrows, int tid, int nthreads) {
  constexpr int VEC = 16;       // one-byte codes per 16-byte load
  constexpr int VPR = HD / VEC;
  constexpr int U = 4;
  const int nv = nrows * VPR;
  for (int base = tid; base < nv; base += U * nthreads) {
    uint4 buf[U];
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nthreads;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      sc[u] = 0.f;
      if (i < nv) {
        const int r = qrows[i / VPR];
        if (r >= 0) {
          buf[u] = __ldg(reinterpret_cast<const uint4*>(
              src + (size_t)r * src_stride + (i % VPR) * VEC));
          sc[u] = __ldg(scales + (size_t)r * scale_stride);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nthreads;
      if (i < nv && qrows[i / VPR] >= 0) {
        const int r = i / VPR;
        store_dequant16<C, T>(dst + r * dst_stride + (i - r * VPR) * VEC, buf[u], sc[u]);
      }
    }
  }
}

// Rows [row0, row0 + nrows) of the quantized codes (rows ``src_stride``
// codes apart, 16-byte aligned) with their scales (``scales[row *
// scale_stride]``), dequantized as load_rows_dequant does and stored as
// floats (rows ``dst_stride`` floats apart); rows at or beyond
// ``rows_total`` are zeros. The contiguous counterpart of
// load_rows_dequant, as common.cuh::load_rows is of load_rows_gather.
template <typename C, typename T, int HD>
__device__ __forceinline__ void load_rows_dequant_range(float* dst, int dst_stride,
                                                        const C* __restrict__ src,
                                                        size_t src_stride,
                                                        const float* __restrict__ scales,
                                                        int scale_stride, int row0, int nrows,
                                                        int rows_total, int tid, int nthreads) {
  constexpr int VEC = 16;
  constexpr int VPR = HD / VEC;
  constexpr int U = 4;
  const int nv = nrows * VPR;
  for (int base = tid; base < nv; base += U * nthreads) {
    uint4 buf[U];
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nthreads;
      const int r = row0 + i / VPR;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      sc[u] = 0.f;   // a row past the end: code 0 times 0 is a row of zeros
      if (i < nv && r < rows_total) {
        buf[u] = __ldg(reinterpret_cast<const uint4*>(
            src + (size_t)r * src_stride + (i % VPR) * VEC));
        sc[u] = __ldg(scales + (size_t)r * scale_stride);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nthreads;
      if (i < nv) {
        const int r = i / VPR;
        store_dequant16<C, T>(dst + r * dst_stride + (i - r * VPR) * VEC, buf[u], sc[u]);
      }
    }
  }
}

}  // namespace repro
