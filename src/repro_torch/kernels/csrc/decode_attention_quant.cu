// One-token GQA decode attention over a quantized ring KV cache, for Hopper
// (sm_90a), written for clarity first (K2q).
//
// No Pallas kernel to replace: the reference's `attn_decode`
// (src/repro/models/attention.py) dequantizes the whole ring in XLA, then
// takes an einsum softmax over it. Layouts are the reference's:
//   q, out (B, H, hd) bf16 or f32
//   k, v (B, L, KVH, hd) int8 or float8_e4m3fn codes
//   k_scale, v_scale (B, L, KVH) f32, one per token and KV head
//   slot_pos (B, L) int32 (-1 empty)   pos (B,) int32
// A slot is valid when 0 <= slot_pos <= pos and, with a window,
// slot_pos > pos - window, as in K2.
//
// The single-pass structure K2 had before it moved onto decode_core.cuh:
// one CTA per (KV head, batch row),
// one warp per query head of the group, 64-slot tiles with the online
// softmax in f32 registers, masked scores -1e30, p rounded to q's dtype
// before the PV product, output acc / max(l, 1e-30). What is new is the
// tile load: each ring row comes as codes (an int8 row at hd 64 is 64 bytes:
// four 16-byte loads) with its scale and is dequantized right after the
// load, exactly as `dequantize_kv` does (dequant.cuh). Once a tile with a
// valid slot has been seen, a tile with none is skipped: it would scale the
// state by exp(0) = 1 and add p = 0 exactly, so the skip changes no bit and
// saves its bytes (a ring that is mostly empty reads only its written
// part). Tiles before the first valid one run, so a row with no valid
// slot averages the ring as the plain version does (K2 writes zeros).
//
// The score and PV loops are K3q's (paged_attention_quant.cu) line for
// line, and a ring that has not wrapped holds position j at slot j as a
// paged row does, so a dense int8 ring and an all-int8 page pool holding
// the same codes give the same output bit for bit.
//
// What bounds it: bytes. A step reads each live tile's codes once (1 byte
// per element instead of 2 in bf16) plus 4 bytes of scale per row per KV
// head, for a few MFLOP. A tile is computed only after it has
// arrived, and the grid (KVH, B) leaves most SMs idle at B = 8.
#include "dequant.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
using repro::load_rows_dequant_range;
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

template <typename T, typename C, int HD>
__global__ void decode_attention_quant_kernel(
    const T* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ slot_pos, const int* __restrict__ pos, T* __restrict__ out, int H,
    int KVH, int L, int window, float scale) {
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
  int* OK = reinterpret_cast<int*>(Vs + BL * HD);  // slot valid?

  const int p_now = pos[b];
  const size_t kv_stride = (size_t)KVH * HD;
  const T* q_grp = q + ((size_t)b * H + (size_t)kvh * G) * HD;  // G heads, contiguous
  const C* k_base = k + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const C* v_base = v + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const float* ks_base = k_scale + (size_t)b * L * KVH + kvh;   // row l at [l * KVH]
  const float* vs_base = v_scale + (size_t)b * L * KVH + kvh;
  const int* sp_base = slot_pos + (size_t)b * L;

  load_rows<T, HD>(Qs, HD, q_grp, HD, 0, G, G, tid, nthreads);

  float m = NEG_INF, l = 0.f;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  const float* qrow = Qs + g * HD;
  bool seen = false;  // a tile with a valid slot has been taken (uniform over the CTA)

  for (int l0 = 0; l0 < L; l0 += BL) {
    __syncthreads();  // the previous tile's reads (and the q load) are done
    int any = 0;
    for (int j = tid; j < BL; j += nthreads) {
      const int sp = l0 + j < L ? sp_base[l0 + j] : -1;
      bool ok = sp >= 0 && sp <= p_now;
      if (window > 0) ok = ok && sp > p_now - window;
      OK[j] = ok;
      any |= ok;
    }
    any = __syncthreads_or(any);
    if (!any && seen) continue;  // adds exactly nothing: skipped
    seen = seen || any;
    load_rows_dequant_range<C, T, HD>(Ks, KS, k_base, kv_stride, ks_base, KVH, l0, BL, L, tid,
                                      nthreads);
    load_rows_dequant_range<C, T, HD>(Vs, HD, v_base, kv_stride, vs_base, KVH, l0, BL, L, tid,
                                      nthreads);
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
    s0 = OK[lane] ? s0 * scale : NEG_INF;
    s1 = OK[lane + 32] ? s1 * scale : NEG_INF;

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

template <typename T, typename C, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* slot_pos, const int* pos, void* out, int B,
                   int H, int KVH, int L, int window, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  auto kern = decode_attention_quant_kernel<T, C, HD>;
  const size_t smem = smem_bytes<HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KVH, B);
  kern<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k), static_cast<const C*>(v), ks, vs,
      slot_pos, pos, static_cast<T*>(out), H, KVH, L, window, scale);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const float* ks,
                        const float* vs, const int* slot_pos, const int* pos, void* out, int B,
                        int H, int KVH, int L, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, C, 32>(q, k, v, ks, vs, slot_pos, pos, out, B, H, KVH, L, window, scale,
                              s);
    case 64:
      return launch<T, C, 64>(q, k, v, ks, vs, slot_pos, pos, out, B, H, KVH, L, window, scale,
                              s);
    case 128:
      return launch<T, C, 128>(q, k, v, ks, vs, slot_pos, pos, out, B, H, KVH, L, window,
                               scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_code(int is_fp8, int hd, const void* q, const void* k, const void* v,
                          const float* ks, const float* vs, const int* slot_pos, const int* pos,
                          void* out, int B, int H, int KVH, int L, int window, float scale,
                          cudaStream_t s) {
  if (is_fp8)
    return dispatch_hd<T, __nv_fp8_e4m3>(hd, q, k, v, ks, vs, slot_pos, pos, out, B, H, KVH, L,
                                         window, scale, s);
  return dispatch_hd<T, int8_t>(hd, q, k, v, ks, vs, slot_pos, pos, out, B, H, KVH, L, window,
                                scale, s);
}

}  // namespace

// window <= 0 means no window. is_bf16: 1 for bfloat16 q and out, 0 for
// float32; is_fp8: 1 for float8_e4m3fn codes, 0 for int8. The group size
// G = H / KVH must be at most 32 (one warp per query head).
extern "C" cudaError_t decode_attention_quant_fwd(const void* q, const void* k, const void* v,
                                                  const float* k_scale, const float* v_scale,
                                                  const int* slot_pos, const int* pos,
                                                  void* out, int B, int H, int KVH, int L,
                                                  int hd, int window, int is_bf16, int is_fp8,
                                                  float scale, void* stream) {
  if (B <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > 32)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_code<__nv_bfloat16>(is_fp8, hd, q, k, v, k_scale, v_scale, slot_pos, pos,
                                        out, B, H, KVH, L, window, scale, s);
  return dispatch_code<float>(is_fp8, hd, q, k, v, k_scale, v_scale, slot_pos, pos, out, B, H,
                              KVH, L, window, scale, s);
}

// Dynamic shared memory one CTA takes for head dim hd and group size G
// (0 if hd is unsupported).
extern "C" int decode_attention_quant_smem_bytes(int hd, int G) {
  switch (hd) {
    case 32: return (int)smem_bytes<32>(G);
    case 64: return (int)smem_bytes<64>(G);
    case 128: return (int)smem_bytes<128>(G);
    default: return 0;
  }
}
