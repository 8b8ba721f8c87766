// Dequantizing tile loads shared by the kernels that read int8 or
// float8_e4m3fn KV codes with one float32 scale per row and KV head (K1q,
// K2q, K3q, K4q, K4p): each code converts to float exactly, is multiplied by
// its scale in f32, and the product is rounded to the compute dtype T, as the
// reference's `dequantize_kv` and the Pallas kernels do.
#pragma once

#include <cuda_fp8.h>

#include "common.cuh"

namespace repro {

// A one-byte code (the low 8 bits of ``byte``) as a float, exactly.
template <typename C> __device__ __forceinline__ float code_to_f(uint32_t byte);
template <> __device__ __forceinline__ float code_to_f<int8_t>(uint32_t byte) {
  return (float)(int)(signed char)(byte & 0xffu);
}
template <> __device__ __forceinline__ float code_to_f<__nv_fp8_e4m3>(uint32_t byte) {
  __nv_fp8_e4m3 c;
  c.__x = (__nv_fp8_storage_t)(byte & 0xffu);
  return static_cast<float>(c);
}

// The code in the low 8 bits of ``byte`` dequantized with ``scale`` and
// rounded to T: the one conversion every dequantizing load shares.
template <typename C, typename T>
__device__ __forceinline__ T dequant_code(uint32_t byte, float scale) {
  return from_f<T>(code_to_f<C>(byte) * scale);
}

// The 16 one-byte codes of ``u`` dequantized with ``scale`` and rounded to
// T, as floats into d[0..15].
template <typename C, typename T>
__device__ __forceinline__ void store_dequant16(float* d, uint4 u, float scale) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 16; ++e)  // little-endian: code e is byte e % 4 of word e / 4
    d[e] = to_f(dequant_code<C, T>(w[e / 4] >> (8 * (e % 4)), scale));
}

// The 16 codes of ``u`` dequantized and rounded as store_dequant16 does,
// kept as bf16: codes 0-7 in ``lo`` and 8-15 in ``hi``, code 2i in the low
// half of word i (the bytes of a row of a bf16 tile).
template <typename C>
__device__ __forceinline__ void dequant16_bf16(uint4 u, float scale, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t o[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {  // codes 2p and 2p + 1: bytes 2(p % 2) and up of word p / 2
    const uint32_t pair = w[p / 2] >> (16 * (p % 2));
    o[p] = (uint32_t)__bfloat16_as_ushort(dequant_code<C, __nv_bfloat16>(pair, scale)) |
           ((uint32_t)__bfloat16_as_ushort(dequant_code<C, __nv_bfloat16>(pair >> 8, scale))
            << 16);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
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
