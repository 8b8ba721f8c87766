// One-token GQA decode attention over the ring KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (src/repro/kernels/decode_attention.py). Layouts are the reference's:
//   q, out (B, H, hd)   k, v (B, L, KVH, hd)   slot_pos (B, L) int32   pos (B,) int32
// A slot is valid when 0 <= slot_pos <= pos and, with a window,
// slot_pos > pos - window; validity comes from slot_pos alone, so a wrapped
// ring (pos >= L) and empty slots (-1) need nothing special.
//
// The kernel is decode_core.cuh's flash-decoding core over a ring source: a
// cluster of SPLIT CTAs per (KV head, batch row), tile t of BL ring slots
// on rank t % SPLIT (the route's geometry: split8, 64-slot tiles on 8 CTAs
// at hd <= 128; split16, 32-slot tiles on 16 at hd 256), every K/V row read
// once for all G query heads that use it (bf16 products on the tensor
// cores, f32 on the CUDA cores), the partials combined through distributed
// shared memory in the same launch. A slot's row is the slot itself; a
// tile whose slot_pos entries hold no valid slot is skipped before any K/V
// load, and invalid slots of a valid tile are not read. A row with no
// valid slot gets the mean of its ring's V, as from the TPU kernel and the
// plain version (a uniform softmax over masked scores).
//
// What bounds it: bytes. A step reads the valid slots' K/V once (B 8, L
// 1024, KVH 8, hd 64 in bf16: 16.8 MB when every slot is valid, ~5 us at
// 3.35 TB/s) for a few MFLOP; decode_core.cuh says what the design does
// about that. Head dims 32, 64, 128 and 256 (recurrentgemma-2b,
// paligemma-3b), in bf16 and f32.
#include "decode_core.cuh"

namespace {

namespace dc = repro::decode;

// Launched in clusters of Geometry<T, HD>::SPLIT CTAs (dc::launch_clusters).
template <typename T, int HD>
__global__ void __maxnreg__(dc::Route<T>::max_regs(HD))
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ slot_pos,
                        const int* __restrict__ pos, T* __restrict__ out, int H, int KVH,
                        int L, int window, float scale) {
  const int G = H / KVH;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const size_t kv_stride = (size_t)KVH * HD;
  const size_t grp = ((size_t)b * H + (size_t)kvh * G) * HD;  // G heads, contiguous
  const dc::RingSlots<false> src{slot_pos + (size_t)b * L, L, pos[b], window};
  dc::attend<T, HD>(src, G, q + grp, k + (size_t)b * L * kv_stride + (size_t)kvh * HD,
                    v + (size_t)b * L * kv_stride + (size_t)kvh * HD, kv_stride, out + grp,
                    scale);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* slot_pos,
                   const int* pos, void* out, int B, int H, int KVH, int L, int window,
                   float scale, cudaStream_t stream) {
  static int clusters[33];  // per group size: max_clusters + 1, 0 until asked
  return dc::launch_clusters<T, HD>(decode_attention_kernel<T, HD>, clusters, KVH, B, H / KVH,
                                    stream, static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), slot_pos, pos, static_cast<T*>(out),
                                    H, KVH, L, window, scale);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* slot_pos, const int* pos, void* out, int B, int H,
                        int KVH, int L, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, slot_pos, pos, out, B, H, KVH, L, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T> int clusters_hd(int hd, int G) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 32: err = dc::max_clusters<T, 32>(decode_attention_kernel<T, 32>, G, &n); break;
    case 64: err = dc::max_clusters<T, 64>(decode_attention_kernel<T, 64>, G, &n); break;
    case 128: err = dc::max_clusters<T, 128>(decode_attention_kernel<T, 128>, G, &n); break;
    case 256: err = dc::max_clusters<T, 256>(decode_attention_kernel<T, 256>, G, &n); break;
  }
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// window <= 0 means no window. is_bf16: 1 for bfloat16 tensors, 0 for float32.
// The group size G = H / KVH must be at most 32.
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

// Dynamic shared memory one CTA takes for head dim hd, group size G and
// dtype (is_bf16 as above); 0 if hd is unsupported.
extern "C" int decode_attention_smem_bytes(int hd, int G, int is_bf16) {
  return (int)(is_bf16 ? dc::smem_bytes<__nv_bfloat16>(hd, G) : dc::smem_bytes<float>(hd, G));
}

// Threads a CTA takes at head dim hd, group size G and dtype (is_bf16 as
// above; K2q, K3 and K3q take K2's); 0 if hd is unsupported.
extern "C" int decode_attention_threads(int hd, int G, int is_bf16) {
  return is_bf16 ? dc::cta_threads<__nv_bfloat16>(hd, G) : dc::cta_threads<float>(hd, G);
}

// The route's geometry at head dim hd and dtype (decode_core.cuh's table):
// slots a tile, CTAs a cluster and stages into out[0..2]; -1 if no route
// takes hd (K2, K2q and K3 share it).
extern "C" int decode_attention_geometry(int hd, int is_bf16, int* out) {
  return (is_bf16 ? dc::geometry<__nv_bfloat16>(hd, out) : dc::geometry<float>(hd, out)) ? 0
                                                                                         : -1;
}

// How many clusters of K2's kernel at head dim hd, group size G and dtype
// the card holds at once (cudaOccupancyMaxActiveClusters); -1 on an error.
extern "C" int decode_attention_max_clusters(int hd, int G, int is_bf16) {
  if (G < 1 || G > 32) return -1;
  return is_bf16 ? clusters_hd<__nv_bfloat16>(hd, G) : clusters_hd<float>(hd, G);
}
