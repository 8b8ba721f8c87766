// Dequantizing tile loads shared by the kernels that read int8 or
// float8_e4m3fn KV codes with one float32 scale per row and KV head (K3q,
// K4q, K4p): each code converts to float exactly, is multiplied by its
// scale in f32, and the product is rounded to the compute dtype T, as the
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
        const uint32_t w[4] = {buf[u].x, buf[u].y, buf[u].z, buf[u].w};
        float* d = dst + r * dst_stride + (i - r * VPR) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e)  // little-endian: code e is byte e % 4 of word e / 4
          d[e] = to_f(from_f<T>(code_to_f<C>(w[e / 4] >> (8 * (e % 4))) * sc[u]));
      }
    }
  }
}

}  // namespace repro
