// The RG-LRU scan (K7) for Hopper (sm_90a): every state of
//   h_t = exp(log_a_t) * h_{t-1} + gated_t,   t = 0 .. S-1,   h_{-1} = h0
// over (B, S, R) float32, the recurrence of each RG-LRU block's prefill in
// recurrentgemma-2b (arXiv:2402.19427).
//
// It replaces no TPU kernel: the reference scans with
// jax.lax.associative_scan (src/repro/models/rglru.py:92-98), which XLA
// lowers itself, h0 folded into step 0. The port needs one all the same: a
// torch loop over t puts three nodes a step into every admission graph, and
// a pairwise (S x S x R) form needs gigabytes. Layouts are the reference's:
//   log_a, gated, out (B, S, R)   h0 (B, R) or null (zeros)   all float32
//
// One thread per (batch row, channel), sequential in t: channel r of row b
// is thread r % 128 of CTA (r / 128, b), so a warp's loads and stores at one
// step are 32 neighbouring floats (128 bytes). Each step is rounded as the
// plain version rounds it (ref.rglru_scan_ref): the product, then the sum,
// no fused multiply-add.
//
// What bounds it: bytes. At the admission shape (B 8, S 512, R 2560) it
// reads 84 MB and writes 42 MB, 3 FLOPs and an exp per element: ~38 us at
// 3.35 TB/s. The chain in t is serial, so the design keeps many loads in
// flight instead: each thread loads the next UNROLL steps of log_a and
// gated before it computes any of them (2 x 16 loads, 2.6 MB in flight
// over the 20,480 threads at that shape), and the stores go out behind.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ gated,
                  const float* __restrict__ h0, float* __restrict__ out, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t base = (size_t)b * S * R + r;
  const float* la = log_a + base;
  const float* g = gated + base;
  float* o = out + base;
  float h = h0 != nullptr ? __ldg(h0 + (size_t)b * R + r) : 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float a[UNROLL], x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      a[u] = __ldg(la + (size_t)(t + u) * R);
      x[u] = __ldg(g + (size_t)(t + u) * R);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(expf(a[u]), h), x[u]);
      o[(size_t)(t + u) * R] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(expf(__ldg(la + (size_t)t * R)), h), __ldg(g + (size_t)t * R));
    o[(size_t)t * R] = h;
  }
}

}  // namespace

// h0 may be null (a zero initial state). Returns the launch's cudaError_t.
extern "C" cudaError_t rglru_scan_fwd(const float* log_a, const float* gated, const float* h0,
                                      float* out, int B, int S, int R, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(log_a, gated, h0,
                                                                              out, S, R);
  return cudaGetLastError();
}
