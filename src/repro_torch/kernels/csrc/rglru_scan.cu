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
// Each channel is one serial chain in t, rounded as the plain version
// rounds it (ref.rglru_scan_ref): exp, the product, then the sum, no fused
// multiply-add, so the two agree bit for bit.
//
// What bounds it: bytes. At the admission shape (B 8, S 512, R 2560) it
// reads 84 MB and writes 42 MB, 3 FLOPs and an exp per element: ~38 us at
// 3.35 TB/s. The chain in t is serial, so the card streams only if many
// loads are in flight behind it. A CTA is one warp over 32 channels of one
// batch row (lane i: channel 32 * blockIdx.x + i), so B 8 x R 2560 is 640
// CTAs, about five on each of the 132 SMs in one wave. log_a and gated
// stream through a ring of STAGES stages of STEPS time steps in shared
// memory, STAGES - 1 stages ahead of the step a lane computes (~20 KB a
// CTA, ~100 KB an SM in flight), by 16-byte cp.async (a warp-wide copy is
// four steps' 128 bytes) where R is a multiple of 4, else each lane copies
// its own channel by 4-byte cp.async. The states go straight out, 128 bytes
// a warp a step, coalesced along R, as streaming stores. The ring's depth
// is not what bounds it (shallower and deeper rings read alike on the
// card); the copy width and the store hint were.
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int CH = 32;      // channels a CTA: one warp, a lane a channel
constexpr int STEPS = 16;   // time steps a stage
constexpr int STAGES = 6;   // stages of the ring

// VEC (R a multiple of 4, 16-byte aligned rows): lane j copies 16 bytes,
// channels 4 (j % 8) .. + 3 of step j / 8 + 4i, so one warp-wide copy is
// four steps' 128 bytes; else each lane copies its own channel, 4 bytes a
// step.
template <bool VEC>
__global__ void __launch_bounds__(CH)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ gated,
                  const float* __restrict__ h0, float* __restrict__ out, int S, int R) {
  using namespace repro::sm90;
  __shared__ __align__(16) float sa[STAGES][STEPS][CH];
  __shared__ __align__(16) float sg[STAGES][STEPS][CH];
  const int lane = threadIdx.x;
  const int r = blockIdx.x * CH + lane;
  const int b = blockIdx.y;
  const bool ok = r < R;
  const size_t row = (size_t)b * S * R;
  float* o = out + row + (ok ? r : 0);
  const int n = (S + STEPS - 1) / STEPS;
  // this lane's copies: channel c of steps u0, u0 + du, ... (VEC: 4 channels)
  const int c = VEC ? 4 * (lane & 7) : lane;
  const int u0 = VEC ? lane >> 3 : 0, du = VEC ? 4 : 1;
  const bool copy = blockIdx.x * CH + c < R;  // VEC: all 4 channels in or all out
  const float* la = log_a + row + (copy ? blockIdx.x * CH + c : 0);
  const float* g = gated + row + (copy ? blockIdx.x * CH + c : 0);

  // stage k % STAGES <- steps [k * STEPS, (k + 1) * STEPS); always one
  // commit group, empty past the end
  auto issue = [&](int k) {
    if (copy && k < n) {
      const int st = k % STAGES;
#pragma unroll
      for (int u = u0; u < STEPS; u += du) {
        const int t = k * STEPS + u;
        if (t < S) {
          if constexpr (VEC) {
            cp_async16(smem_u32(&sa[st][u][c]), la + (size_t)t * R, 16);
            cp_async16(smem_u32(&sg[st][u][c]), g + (size_t)t * R, 16);
          } else {
            cp_async4(smem_u32(&sa[st][u][c]), la + (size_t)t * R, 4);
            cp_async4(smem_u32(&sg[st][u][c]), g + (size_t)t * R, 4);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);

  float h = ok && h0 != nullptr ? __ldg(h0 + (size_t)b * R + r) : 0.f;
  for (int k = 0; k < n; ++k) {
    if constexpr (VEC) __syncwarp();  // every lane has read the stage step k - 1 used
    issue(k + STAGES - 1);            // into that stage
    cp_async_wait<STAGES - 1>();      // this lane's copies of stage k have landed
    if constexpr (VEC) __syncwarp();  // and every lane's
    const int st = k % STAGES;
    if (ok) {
      const int t0 = k * STEPS;
      if (t0 + STEPS <= S) {
#pragma unroll
        for (int u = 0; u < STEPS; ++u) {
          h = __fadd_rn(__fmul_rn(expf(sa[st][u][lane]), h), sg[st][u][lane]);
          __stcs(o + (size_t)(t0 + u) * R, h);  // streaming: written once, read later
        }
      } else {
        for (int u = 0; t0 + u < S; ++u) {
          h = __fadd_rn(__fmul_rn(expf(sa[st][u][lane]), h), sg[st][u][lane]);
          __stcs(o + (size_t)(t0 + u) * R, h);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA
}

}  // namespace

// h0 may be null (a zero initial state). Returns the launch's cudaError_t.
extern "C" cudaError_t rglru_scan_fwd(const float* log_a, const float* gated, const float* h0,
                                      float* out, int B, int S, int R, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((R + CH - 1) / CH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(log_a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gated) % 16 == 0;
  if (vec)
    rglru_scan_kernel<true><<<grid, CH, 0, s>>>(log_a, gated, h0, out, S, R);
  else
    rglru_scan_kernel<false><<<grid, CH, 0, s>>>(log_a, gated, h0, out, S, R);
  return cudaGetLastError();
}
