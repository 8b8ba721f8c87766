// Helpers shared by the attention kernels: value conversions, warp
// reductions, and the tile copies from device memory into float shared
// memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;  // masked score, as in the TPU kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The 16 bytes of ``u`` as floats (4 float32 or 8 bfloat16 values, exact).
template <typename T> __device__ __forceinline__ void unpack(float* d, uint4 u);
template <> __device__ __forceinline__ void unpack<float>(float* d, uint4 u) {
  d[0] = __uint_as_float(u.x);
  d[1] = __uint_as_float(u.y);
  d[2] = __uint_as_float(u.z);
  d[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(float* d, uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    d[2 * i] = __uint_as_float(w[i] << 16);
    d[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copy rows [row0, row0 + nrows) of a tile of T (HD values per row, rows
// ``src_stride`` elements apart, 16-byte aligned) into float shared memory
// (rows ``dst_stride`` floats apart); rows at or beyond ``rows_total`` are
// zeros. Each thread issues U 16-byte loads before it stores any of them,
// so a tile costs a few memory latencies rather than one per element.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* __restrict__ src, size_t src_stride,
                                          int row0, int nrows, int rows_total, int tid,
                                          int nthreads) {
  constexpr int VEC = 16 / sizeof(T);  // values per 16-byte load
  constexpr int VPR = HD / VEC;        // loads per row
  constexpr int U = 4;
  const int nv = nrows * VPR;
  for (int base = tid; base < nv; base += U * nthreads) {
    uint4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nthreads;
      const int r = i / VPR;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nv && row0 + r < rows_total)
        buf[u] = __ldg(reinterpret_cast<const uint4*>(
            src + (size_t)(row0 + r) * src_stride + (i - r * VPR) * VEC));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nthreads;
      if (i < nv) {
        const int r = i / VPR;
        unpack<T>(dst + r * dst_stride + (i - r * VPR) * VEC, buf[u]);
      }
    }
  }
}

// Copy the tile rows named by ``rows`` (shared memory, ``nrows`` entries:
// the index of a row of ``src``, rows ``src_stride`` elements apart and
// 16-byte aligned, -1 for a row of zeros, or below -1 for a row left as it
// is, which another copy fills) into float shared memory (rows
// ``dst_stride`` floats apart), with the same 16-byte loads, U in flight per
// thread, as load_rows. A negative row is never read.
template <typename T, int HD>
__device__ __forceinline__ void load_rows_gather(float* dst, int dst_stride,
                                                 const T* __restrict__ src,
                                                 size_t src_stride, const int* rows,
                                                 int nrows, int tid, int nthreads) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  constexpr int U = 4;
  const int nv = nrows * VPR;
  for (int base = tid; base < nv; base += U * nthreads) {
    uint4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nthreads;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nv) {
        const int r = rows[i / VPR];
        if (r >= 0)
          buf[u] = __ldg(reinterpret_cast<const uint4*>(
              src + (size_t)r * src_stride + (i % VPR) * VEC));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nthreads;
      if (i < nv && rows[i / VPR] >= -1) {
        const int r = i / VPR;
        unpack<T>(dst + r * dst_stride + (i - r * VPR) * VEC, buf[u]);
      }
    }
  }
}

}  // namespace repro
