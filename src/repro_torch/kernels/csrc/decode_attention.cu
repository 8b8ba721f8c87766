// One-token GQA decode attention over the ring KV cache, for Hopper (sm_90a),
// written for clarity first.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (src/repro/kernels/decode_attention.py). Layouts are the reference's:
//   q, out (B, H, hd)   k, v (B, L, KVH, hd)   slot_pos (B, L) int32   pos (B,) int32
// A slot is valid when 0 <= slot_pos <= pos and, with a window,
// slot_pos > pos - window; validity comes from slot_pos alone, so a wrapped
// ring (pos >= L) and empty slots (-1) need nothing special.
//
// One CTA per (KV head, batch row) with one warp per query head of the
// group: all G heads that read one KV head share each K/V tile, so the
// cache is read once per KV head, as the TPU kernel's (G, hd) packing does.
// The CTA sweeps L in tiles of 64 slots with the online softmax (m, l, acc)
// in f32 registers; each lane scores two slots of a tile and owns hd/32
// output dims. Masked scores are -1e30, p is rounded to the value dtype
// before the PV product, and the output is acc / max(l, 1e-30).
//
// What bounds it: decode moves the whole cache once per step (B 8, L 1024,
// KVH 8, hd 64 in bf16: 16.8 MB, ~5 us at 3.35 TB/s) for a few MFLOP, so it
// is byte-bound. Each tile is fetched with 16-byte loads that are all in
// flight together, but a tile is computed only after it has arrived (no
// double buffering), and the grid (KVH, B) is 64 CTAs at B = 8, under half
// of the H100's 132 SMs; splitting L across CTAs (flash-decoding) with a
// second reduction pass is the first redesign.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
using repro::NEG_INF;
using repro::to_f;
using repro::warp_max;
using repro::warp_sum;

constexpr int BL = 64;  // cache slots per tile: two per lane

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) * ((size_t)G * HD + (size_t)BL * (HD + 1) + (size_t)BL * HD) +
         sizeof(int) * BL;
}

template <typename T, int HD>
__global__ void decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const int* __restrict__ slot_pos,
                                        const int* __restrict__ pos, T* __restrict__ out,
                                        int H, int KVH, int L, int window, float scale) {
  constexpr int KS = HD + 1;   // odd stride: lanes reading different slots hit different banks
  constexpr int PER = HD / 32; // output dims per lane
  const int G = blockDim.x >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (G, HD)
  float* Ks = Qs + G * HD;                      // (BL, KS)
  float* Vs = Ks + BL * KS;                     // (BL, HD)
  int* SPs = reinterpret_cast<int*>(Vs + BL * HD);

  const int p_now = pos[b];
  const size_t kv_stride = (size_t)KVH * HD;
  const T* q_grp = q + ((size_t)b * H + (size_t)kvh * G) * HD;  // G heads, contiguous
  const T* k_base = k + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const T* v_base = v + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const int* sp_base = slot_pos + (size_t)b * L;

  load_rows<T, HD>(Qs, HD, q_grp, HD, 0, G, G, tid, nthreads);

  float m = NEG_INF, l = 0.f;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  const float* qrow = Qs + g * HD;

  for (int l0 = 0; l0 < L; l0 += BL) {
    __syncthreads();  // the previous tile's reads are done
    load_rows<T, HD>(Ks, KS, k_base, kv_stride, l0, BL, L, tid, nthreads);
    load_rows<T, HD>(Vs, HD, v_base, kv_stride, l0, BL, L, tid, nthreads);
    for (int j = tid; j < BL; j += nthreads) SPs[j] = l0 + j < L ? sp_base[l0 + j] : -1;
    __syncthreads();

    float s0 = 0.f, s1 = 0.f;
    const float* k0r = Ks + lane * KS;
    const float* k1r = Ks + (lane + 32) * KS;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
      s0 = fmaf(qd, k0r[d], s0);
      s1 = fmaf(qd, k1r[d], s1);
    }
    const int sp0 = SPs[lane], sp1 = SPs[lane + 32];
    bool ok0 = sp0 >= 0 && sp0 <= p_now;
    bool ok1 = sp1 >= 0 && sp1 <= p_now;
    if (window > 0) {
      ok0 = ok0 && sp0 > p_now - window;
      ok1 = ok1 && sp1 > p_now - window;
    }
    s0 = ok0 ? s0 * scale : NEG_INF;
    s1 = ok1 ? s1 * scale : NEG_INF;

    const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
    const float alpha = expf(m - m_new);
    const float p0 = expf(s0 - m_new);
    const float p1 = expf(s1 - m_new);
    l = l * alpha + warp_sum(p0 + p1);
    m = m_new;
    const float p0r = to_f(from_f<T>(p0));  // p in the value dtype, as the TPU kernel
    const float p1r = to_f(from_f<T>(p1));

#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
    for (int j = 0; j < 32; ++j) {
      const float pa = __shfl_sync(0xffffffffu, p0r, j);
      const float pb = __shfl_sync(0xffffffffu, p1r, j);
      const float* va = Vs + j * HD + lane;
      const float* vb = Vs + (j + 32) * HD + lane;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        acc[i] = fmaf(pa, va[32 * i], acc[i]);
        acc[i] = fmaf(pb, vb[32 * i], acc[i]);
      }
    }
  }

  const float denom = fmaxf(l, 1e-30f);
  T* orow = out + ((size_t)b * H + (size_t)kvh * G + g) * HD;
#pragma unroll
  for (int i = 0; i < PER; ++i) orow[lane + 32 * i] = from_f<T>(acc[i] / denom);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* slot_pos,
                   const int* pos, void* out, int B, int H, int KVH, int L, int window,
                   float scale, cudaStream_t stream) {
  const int G = H / KVH;
  auto kern = decode_attention_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KVH, B);
  kern<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      slot_pos, pos, static_cast<T*>(out), H, KVH, L, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* slot_pos, const int* pos, void* out, int B, int H,
                        int KVH, int L, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no window. is_bf16: 1 for bfloat16 tensors, 0 for float32.
// The group size G = H / KVH must be at most 32 (one warp per query head).
extern "C" cudaError_t decode_attention_fwd(const void* q, const void* k, const void* v,
                                            const int* slot_pos, const int* pos, void* out,
                                            int B, int H, int KVH, int L, int hd,
                                            int window, int is_bf16, float scale,
                                            void* stream) {
  if (B <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > 32)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
  return dispatch_hd<float>(hd, q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
}

// Dynamic shared memory one CTA takes for head dim hd and group size G
// (0 if hd is unsupported).
extern "C" int decode_attention_smem_bytes(int hd, int G) {
  switch (hd) {
    case 32: return (int)smem_bytes<32>(G);
    case 64: return (int)smem_bytes<64>(G);
    case 128: return (int)smem_bytes<128>(G);
    default: return 0;
  }
}
