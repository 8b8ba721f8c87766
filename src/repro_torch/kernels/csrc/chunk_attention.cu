// Chunked-prefill attention (continuous batching) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_chunk_kernel`
// (src/repro/kernels/chunk_attention.py), K4. Layouts are the reference's:
//   q, out (B, C, H, hd)   k, v (B, L, KVH, hd)   slot_pos (B, L) int32
//   pos0, valid (B,) int32
// Query head h reads KV head h / (H / KVH). Query i of row b sits at the
// absolute position pos0[b] + i; the row's cache already holds the chunk.
//
// One CTA per (tile of 64 chunk queries, head, batch row); the TPU
// kernel's sequential KV grid axis (VMEM scratch m, l, acc) becomes a loop
// inside the CTA with the online-softmax state in f32 registers. Masking
// follows the TPU kernel: a key is visible when 0 <= slot_pos <= pos0 + i,
// masked scores are -1e30, the output is acc / max(l, 1e-30), p is rounded
// to the value dtype before the PV product, and query rows at or beyond
// `valid` are written as zeros (a tile of such rows does nothing else).
// KV tiles wholly beyond the tile's last live query position are skipped:
// a chunk row's cache is position-ordered (slot j holds position j or
// nothing), so they hold only masked keys. Where pos0 + valid would pass L
// (a ring that wrapped) the loop visits every slot and the mask alone
// decides. Any C and L are accepted (ragged tile edges are masked); hd must
// be 32, 64 or 128.
//
// Two kernels, one per dtype of q:
//
// bf16 (chunk_attention_kernel_wgmma): chunk_core.cuh's tensor-core core,
// which K4p and K4q share, with this file's tile load: slot j of the tile
// is cache row j (zeros past L), its K row and slot_pos copied by one
// thread, its V row by the next, by cp.async into the ring's next stage
// while the current tile's QK^T runs.
//
// f32 (chunk_attention_kernel): on the CUDA cores, since a tensor-core
// product in f32 is TF32 and would break the f32 rule it is held to. Two
// threads share a query row: each scores half of a 64-key tile and owns
// half of the output dims, from f32 tiles in shared memory beside the
// tile's slot_pos.
//
// What bounds it: at the serving mix (B 8, C 128, H 32/8, hd 64, bf16) the
// call moves ~10-14 MB of q, live K/V and output for ~2 GFLOP, so the
// tensor cores would make it byte-bound (a few us). What held the CUDA-core
// kernel far above that was FMA issue per tile. On wgmma neither bytes nor
// FLOPs set the time but the chain: every CTA of the grid is resident at
// once, so the time is the longest CTA's walk over its tiles (8 tiles for
// a chunk at 384-511), each tile one warpgroup's copies, QK^T, softmax and
// PV in turn beside the other CTAs of its SM.
// chip_smoke.py's chunk_anatomy records the tiles, the chain and the time
// per tile; PERF.md holds the readings.
#include "chunk_core.cuh"
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
using repro::NEG_INF;
using repro::to_f;

constexpr int BQ = 64;          // chunk queries per CTA
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 2 * BQ; // two threads per query row

template <int HD>
struct Smem {
  static constexpr int QS = HD + 4;  // padded strides (floats); multiples of 4 keep float4 aligned
  static constexpr int KS = HD + 4;
  static constexpr int VS = HD;
  static constexpr int PS = BK + 1;
  static constexpr int floats = BQ * QS + BK * KS + BK * VS + BQ * PS;
  static constexpr size_t bytes = sizeof(float) * floats + sizeof(int) * BK;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ slot_pos,
                       const int* __restrict__ pos0, const int* __restrict__ valid,
                       T* __restrict__ out, int C, int L, int H, int KVH, float scale) {
  using S = Smem<HD>;
  constexpr int HALF_K = BK / 2;
  constexpr int HALF_D = HD / 2;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * S::QS;
  float* Vs = Ks + BK * S::KS;
  float* Ps = Vs + BK * S::VS;
  int* SPs = reinterpret_cast<int*>(Ps + BQ * S::PS);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int r = tid >> 1;     // query row within the tile
  const int half = tid & 1;   // which half of the keys / output dims
  const int qi = q0 + r;      // query row within the chunk
  const int nv = valid[b];
  const int p0 = pos0[b];
  const int qpos = p0 + qi;   // its absolute position

  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KVH * HD;
  const T* q_base = q + (size_t)b * C * q_stride + (size_t)h * HD;
  const T* k_base = k + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const T* v_base = v + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const int* sp_base = slot_pos + (size_t)b * L;
  T* o_base = out + (size_t)b * C * q_stride + (size_t)h * HD;

  if (q0 >= nv) {  // every row of the tile is padding (or the row is inactive)
    for (int i = tid; i < BQ * HD; i += THREADS) {
      const int rr = i / HD, c = i - rr * HD;
      if (q0 + rr < C) o_base[(size_t)(q0 + rr) * q_stride + c] = from_f<T>(0.f);
    }
    return;
  }

  load_rows<T, HD>(Qs, S::QS, q_base, q_stride, q0, BQ, C, tid, THREADS);

  // Live slots: up to the tile's last live query position, when the chunk
  // lies inside the cache without wrapping; otherwise all of them.
  const int last = p0 + min(q0 + BQ, nv);   // one past that position
  const int k_end = (p0 >= 0 && last <= L) ? last : L;

  float m = NEG_INF, l = 0.f;
  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V/P/slot_pos reads are done
    load_rows<T, HD>(Ks, S::KS, k_base, kv_stride, k0, BK, L, tid, THREADS);
    load_rows<T, HD>(Vs, S::VS, v_base, kv_stride, k0, BK, L, tid, THREADS);
    for (int i = tid; i < BK; i += THREADS) SPs[i] = (k0 + i < L) ? sp_base[k0 + i] : -1;
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
      const int sp = SPs[half * HALF_K + jj];
      sc[jj] = (sp >= 0 && sp <= qpos) ? sc[jj] * scale : NEG_INF;
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

  if (qi < C) {
    const bool pad = qi >= nv;
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o_base + (size_t)qi * q_stride + half * HALF_D;
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) orow[i] = from_f<T>(pad ? 0.f : acc[i] / denom);
  }
}

// ------------------------------------------------- bf16: wgmma kernel
namespace ck = repro::chunk;
using bf16 = __nv_bfloat16;

// K4's tile load: slot j of the tile is cache row j of this batch row (zeros
// and no key past L). The thread with ``which`` 0 copies the K row and its
// slot_pos, the one with ``which`` 1 the V row.
template <int HD>
struct CacheRows {
  const bf16* k;   // this (batch row, KV head)'s rows, ``stride`` apart
  const bf16* v;
  const int* sp;   // this batch row's slot_pos
  size_t stride;
  int L;

  __device__ __forceinline__ void issue(uint8_t* smem, uint32_t sbase, int s, int k0, int r,
                                        int which, int& kind, int& has_key) const {
    using S = ck::Smem<HD>;
    const int j = k0 + r;
    const bool ok = j < L;
    const bf16* row = (which ? v : k) + (size_t)(ok ? j : 0) * stride;
    ck::copy_row<HD>(which ? S::v_tile(sbase, s) : S::k_tile(sbase, s), r, row, ok);
    if (which == 0) {
      if (ok)
        repro::sm90::cp_async4(S::pos(sbase, s) + r * 4, sp + j, 4);
      else
        reinterpret_cast<int*>(smem + S::POS_OFF)[s * ck::BK + r] = -1;
    }
    kind = ok ? ck::NATIVE : ck::NONE;
    has_key = 1;  // K4 visits every tile of its live range
  }
};

template <int HD>
__global__ void __launch_bounds__(ck::THREADS)
chunk_attention_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const int* __restrict__ slot_pos,
                             const int* __restrict__ pos0, const int* __restrict__ valid,
                             bf16* __restrict__ out, int C, int L, int H, int KVH, float scale) {
  const int q0 = blockIdx.x * ck::BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int nv = valid[b];
  const int p0 = pos0[b];
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KVH * HD;
  const bf16* q_base = q + (size_t)b * C * q_stride + (size_t)h * HD;
  bf16* o_base = out + (size_t)b * C * q_stride + (size_t)h * HD;
  if (q0 >= nv) {  // every row of the tile is padding (or the row is inactive)
    ck::zero_rows<HD>(o_base, q_stride, q0, C, threadIdx.x);
    return;
  }
  // Live slots: up to the tile's last live query position, when the chunk
  // lies inside the cache without wrapping; otherwise all of them.
  const int last = p0 + min(q0 + ck::BQ, nv);  // one past that position
  const int k_end = (p0 >= 0 && last <= L) ? last : L;
  const CacheRows<HD> src{k + (size_t)b * L * kv_stride + (size_t)kvh * HD,
                          v + (size_t)b * L * kv_stride + (size_t)kvh * HD,
                          slot_pos + (size_t)b * L, kv_stride, L};
  ck::attend<bf16, HD>(src, q_base, o_base, q_stride, C, q0, nv, p0 + q0,
                       (k_end + ck::BK - 1) / ck::BK, scale);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* slot_pos,
                   const int* pos0, const int* valid, void* out, int B, int C, int L,
                   int H, int KVH, float scale, cudaStream_t stream) {
  const dim3 grid((C + BQ - 1) / BQ, H, B);
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor cores
    auto kern = chunk_attention_kernel_wgmma<HD>;
    const size_t smem = ck::Smem<HD>::bytes_native;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, ck::THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        slot_pos, pos0, valid, static_cast<bf16*>(out), C, L, H, KVH, scale);
  } else {  // f32: the CUDA cores
    auto kern = chunk_attention_kernel<T, HD>;
    const size_t smem = Smem<HD>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        slot_pos, pos0, valid, static_cast<T*>(out), C, L, H, KVH, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* slot_pos, const int* pos0, const int* valid, void* out,
                        int B, int C, int L, int H, int KVH, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, slot_pos, pos0, valid, out, B, C, L, H, KVH, scale, s);
    case 64: return launch<T, 64>(q, k, v, slot_pos, pos0, valid, out, B, C, L, H, KVH, scale, s);
    case 128: return launch<T, 128>(q, k, v, slot_pos, pos0, valid, out, B, C, L, H, KVH, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32.
extern "C" cudaError_t chunk_attention_fwd(const void* q, const void* k, const void* v,
                                           const int* slot_pos, const int* pos0,
                                           const int* valid, void* out, int B, int C,
                                           int L, int H, int KVH, int hd, int is_bf16,
                                           float scale, void* stream) {
  if (B <= 0 || C <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, slot_pos, pos0, valid, out, B, C, L, H, KVH, scale, s);
  return dispatch_hd<float>(hd, q, k, v, slot_pos, pos0, valid, out, B, C, L, H, KVH, scale, s);
}

template <int HD>
int smem_of(int is_bf16) {
  return is_bf16 ? (int)ck::Smem<HD>::bytes_native : (int)Smem<HD>::bytes;
}

// Dynamic shared memory one CTA takes for head dim hd (0 if unsupported):
// the bf16 wgmma kernel's (is_bf16 1) or the f32 CUDA-core kernel's.
extern "C" int chunk_attention_smem_bytes(int hd, int is_bf16) {
  switch (hd) {
    case 32: return smem_of<32>(is_bf16);
    case 64: return smem_of<64>(is_bf16);
    case 128: return smem_of<128>(is_bf16);
    default: return 0;
  }
}
