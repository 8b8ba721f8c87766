// Causal (optionally windowed, optionally ragged) GQA prefill attention for
// Hopper (sm_90a), written for clarity first.
//
// Replaces the Pallas TPU kernels `_attn_kernel` and `_attn_kernel_ragged`
// (src/repro/kernels/flash_attention.py). Layouts are the reference's:
//   q, out (B, Sq, H, hd)   k, v (B, Sk, KVH, hd)   seq_lens (B,) int32 or null
// Query head h reads KV head h / (H / KVH).
//
// One CTA per (q-tile of 64 rows, head, batch row). The TPU kernel's
// sequential innermost grid axis over KV tiles becomes a loop inside the
// CTA, carrying the online-softmax state (m, l, acc) in registers in f32.
// Two threads share a query row: each scores half of a 64-key tile and owns
// half of the output dims. Tiles are staged in shared memory as f32.
//
// Masking follows the TPU kernel: scores of masked keys are -1e30, the
// output is acc / max(l, 1e-30), p is rounded to the value dtype before the
// PV product, KV tiles wholly above the diagonal, outside the window, or at
// or beyond the row's length are skipped, and query rows at or beyond the
// row's length are written as zeros. Any Sq and Sk are accepted (the ragged
// tile edge is masked); hd must be 32, 64 or 128.
//
// What bounds it: at the serving shapes (B 8, S 512, H 32, hd 64) the
// causal work is ~8.6 GFLOP against ~42 MB of q/k/v/out, so the tensor
// cores would make it byte-bound (~12.5 us). This first version does the
// products on the CUDA cores in f32 FMAs from shared memory, so it is bound
// by FMA issue instead; moving QK^T and PV onto wgmma is the next step.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ seq_lens,
                       T* __restrict__ out, int Sq, int Sk, int H, int KVH,
                       int causal, int window, float scale) {
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
  const T* k_base = k + (size_t)b * Sk * kv_stride + (size_t)kvh * HD;
  const T* v_base = v + (size_t)b * Sk * kv_stride + (size_t)kvh * HD;
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
    load_rows<T, HD>(Ks, S::KS, k_base, kv_stride, k0, BK, Sk, tid, THREADS);
    load_rows<T, HD>(Vs, S::VS, v_base, kv_stride, k0, BK, Sk, tid, THREADS);
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seq_lens,
                   void* out, int B, int Sq, int Sk, int H, int KVH, int causal,
                   int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HD>;
  const size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      seq_lens, static_cast<T*>(out), Sq, Sk, H, KVH, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* seq_lens, void* out, int B, int Sq, int Sk, int H,
                        int KVH, int causal, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, seq_lens, out, B, Sq, Sk, H, KVH, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, seq_lens, out, B, Sq, Sk, H, KVH, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, seq_lens, out, B, Sq, Sk, H, KVH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no window; seq_lens may be null (dense prefill).
// is_bf16: 1 for bfloat16 tensors, 0 for float32.
extern "C" cudaError_t flash_attention_fwd(const void* q, const void* k, const void* v,
                                           const int* seq_lens, void* out, int B, int Sq,
                                           int Sk, int H, int KVH, int hd, int causal,
                                           int window, int is_bf16, float scale,
                                           void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, seq_lens, out, B, Sq, Sk, H, KVH, causal, window, scale, s);
  return dispatch_hd<float>(hd, q, k, v, seq_lens, out, B, Sq, Sk, H, KVH, causal, window, scale, s);
}

// Dynamic shared memory one CTA takes for head dim hd (0 if unsupported).
extern "C" int flash_attention_smem_bytes(int hd) {
  switch (hd) {
    case 32: return (int)Smem<32>::bytes;
    case 64: return (int)Smem<64>::bytes;
    case 128: return (int)Smem<128>::bytes;
    default: return 0;
  }
}
