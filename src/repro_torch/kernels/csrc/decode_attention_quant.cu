// One-token GQA decode attention over a quantized ring KV cache, for Hopper
// (sm_90a) (K2q).
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
// The kernel is K2 (decode_attention.cu) over codes: decode_core.cuh's
// flash-decoding core with a ring source whose every valid slot is a code
// row. A cluster of SPLIT CTAs per (KV head, batch row), tile t of BL ring
// slots on rank t % SPLIT (K2's geometry at the same dtype and hd: split8
// or split16), tiles with no valid slot skipped before any load; a valid
// slot's codes (hd bytes) and scale are copied by cp.async and dequantized
// in shared memory exactly as `dequantize_kv` does ((float(code) * scale)
// rounded to q's dtype), by the thread that copied them, then the tile runs K2's arithmetic (bf16 products on the tensor
// cores, f32 on the CUDA cores) and the partials are combined through
// distributed shared memory in the same launch. So K2q over codes equals
// K2 over the dequantized ring bit for bit, and, as K3q (paged_attention_
// quant.cu) runs the same core, a dense int8 ring that has not wrapped
// equals an all-int8 page pool holding the same codes bit for bit. A row
// with no valid slot gets the mean of its dequantized ring's V, as from the
// plain version (a uniform softmax over masked scores).
//
// The unscaled route (decode_attention_cast_fwd) is the same kernel over a
// ring held under an unscaled storage cast (the reference's legacy
// `cache_dtype`: k, v (B, L, KVH, hd) as float16, bfloat16, float32 or
// float8_e4m3fn, in another dtype than q, and no scales): every valid slot
// is an unscaled code row, each value rounded to q's dtype as it lands
// (decode_core.cuh), as the reference's `ck.astype(q.dtype)` does; the
// arithmetic after that is K2's.
//
// Head dims 32, 64, 128 and 256 (recurrentgemma-2b's ring, quantized or
// cast: split16, as K2 at hd 256), in bf16 and f32.
//
// What bounds it: bytes. A step reads each valid slot's codes once (1 byte
// per element instead of 2 in bf16) plus 4 bytes of scale per row and KV
// head (B 8, L 1024, KVH 8, hd 64: 7.4 MB when every slot is valid, 2.2 us
// at 3.35 TB/s) for a few MFLOP; decode_core.cuh says what the design does
// about that.
#include "decode_core.cuh"

namespace {

namespace dc = repro::decode;

// SCALED false: the unscaled route (k_scale, v_scale unread). Launched in
// clusters of Geometry<T, HD>::SPLIT CTAs (dc::launch_clusters).
template <typename T, typename C, int HD, bool SCALED>
__global__ void __maxnreg__(dc::Route<T>::max_regs(HD))
decode_attention_quant_kernel(const T* __restrict__ q, const C* __restrict__ k,
                              const C* __restrict__ v, const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ slot_pos, const int* __restrict__ pos,
                              T* __restrict__ out, int H, int KVH, int L, int window,
                              float scale) {
  const int G = H / KVH;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const size_t kv_stride = (size_t)KVH * HD;
  const size_t grp = ((size_t)b * H + (size_t)kvh * G) * HD;  // G heads, contiguous
  const dc::RingSlots<true> src{slot_pos + (size_t)b * L, L, pos[b], window};
  const size_t row0 = (size_t)b * L;  // this batch row's first ring row
  const dc::CodeRows<C, SCALED> codes{k + row0 * kv_stride + (size_t)kvh * HD,
                                      v + row0 * kv_stride + (size_t)kvh * HD,
                                      SCALED ? k_scale + row0 * KVH + kvh : nullptr,
                                      SCALED ? v_scale + row0 * KVH + kvh : nullptr, kv_stride,
                                      (size_t)KVH};
  dc::attend<T, HD>(src, G, q + grp, nullptr, nullptr, 0, out + grp, scale, codes);
}

template <typename T, typename C, int HD, bool SCALED>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* slot_pos, const int* pos, void* out, int B,
                   int H, int KVH, int L, int window, float scale, cudaStream_t stream) {
  static int clusters[33];  // per group size: max_clusters + 1, 0 until asked
  return dc::launch_clusters<T, HD>(decode_attention_quant_kernel<T, C, HD, SCALED>, clusters,
                                    KVH, B, H / KVH, stream, static_cast<const T*>(q),
                                    static_cast<const C*>(k), static_cast<const C*>(v), ks, vs,
                                    slot_pos, pos, static_cast<T*>(out), H, KVH, L, window,
                                    scale);
}

template <typename T, typename C, bool SCALED>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const float* ks,
                        const float* vs, const int* slot_pos, const int* pos, void* out, int B,
                        int H, int KVH, int L, int window, float scale, cudaStream_t s) {
#define REPRO_LAUNCH(HD) \
  launch<T, C, HD, SCALED>(q, k, v, ks, vs, slot_pos, pos, out, B, H, KVH, L, window, scale, s)
  switch (hd) {
    case 32: return REPRO_LAUNCH(32);
    case 64: return REPRO_LAUNCH(64);
    case 128: return REPRO_LAUNCH(128);
    case 256: return REPRO_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}

template <typename T>
cudaError_t dispatch_code(int is_fp8, int hd, const void* q, const void* k, const void* v,
                          const float* ks, const float* vs, const int* slot_pos, const int* pos,
                          void* out, int B, int H, int KVH, int L, int window, float scale,
                          cudaStream_t s) {
  if (is_fp8)
    return dispatch_hd<T, __nv_fp8_e4m3, true>(hd, q, k, v, ks, vs, slot_pos, pos, out, B, H,
                                               KVH, L, window, scale, s);
  return dispatch_hd<T, int8_t, true>(hd, q, k, v, ks, vs, slot_pos, pos, out, B, H, KVH, L,
                                      window, scale, s);
}

// The unscaled route's storage types, by the code the wrappers pass
// (kernels/decode_attention.py::STORE_CODES); a store in q's own dtype is
// the native route (K2) and is refused here.
template <typename T>
cudaError_t dispatch_store(int store, int hd, const void* q, const void* k, const void* v,
                           const int* slot_pos, const int* pos, void* out, int B, int H,
                           int KVH, int L, int window, float scale, cudaStream_t s) {
#define REPRO_STORE(S)                                                                     \
  {                                                                                       \
    if constexpr (std::is_same<S, T>::value)                                              \
      return cudaErrorInvalidValue;                                                       \
    else                                                                                  \
      return dispatch_hd<T, S, false>(hd, q, k, v, nullptr, nullptr, slot_pos, pos, out, B, \
                                      H, KVH, L, window, scale, s);                       \
  }
  switch (store) {
    case 0: REPRO_STORE(__half)
    case 1: REPRO_STORE(__nv_bfloat16)
    case 2: REPRO_STORE(float)
    case 3: REPRO_STORE(__nv_fp8_e4m3)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_STORE
}

}  // namespace

// window <= 0 means no window. is_bf16: 1 for bfloat16 q and out, 0 for
// float32; is_fp8: 1 for float8_e4m3fn codes, 0 for int8. The group size
// G = H / KVH must be at most 32.
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

// Dynamic shared memory one CTA takes for head dim hd, group size G and
// dtype (is_bf16 as above; the code type does not change it); 0 if hd is
// unsupported.
extern "C" int decode_attention_quant_smem_bytes(int hd, int G, int is_bf16) {
  return (int)(is_bf16 ? dc::smem_bytes<__nv_bfloat16>(hd, G) : dc::smem_bytes<float>(hd, G));
}

// The unscaled route: k, v (B, L, KVH, hd) stored as ``store`` (0 float16,
// 1 bfloat16, 2 float32, 3 float8_e4m3fn; not q's dtype), each value
// rounded to q's dtype as it loads. Other arguments as decode_attention_
// quant_fwd's.
extern "C" cudaError_t decode_attention_cast_fwd(const void* q, const void* k, const void* v,
                                                 const int* slot_pos, const int* pos, void* out,
                                                 int B, int H, int KVH, int L, int hd,
                                                 int window, int is_bf16, int store, float scale,
                                                 void* stream) {
  if (B <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > 32)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_store<__nv_bfloat16>(store, hd, q, k, v, slot_pos, pos, out, B, H, KVH, L,
                                         window, scale, s);
  return dispatch_store<float>(store, hd, q, k, v, slot_pos, pos, out, B, H, KVH, L, window,
                               scale, s);
}
