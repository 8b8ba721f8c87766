// One-token GQA decode attention over a quantized or mixed paged KV pool,
// for Hopper (sm_90a) (K3q).
//
// Replaces the quantized variant of the Pallas TPU kernel `_paged_kernel`
// (src/repro/kernels/paged_attention.py, `quantized=True`), and the mixed
// two-region gather of the reference's model path (`_pool_read` in
// src/repro/models/attention.py), which the Pallas kernel lacks. Layouts:
//   q, out (B, H, hd)                       bf16 or f32
//   k_pages, v_pages (N_n, ps, KVH, hd)     q's dtype; N_n may be 0
//   qk_pages, qv_pages (N_q, ps, KVH, hd)   int8 or float8_e4m3fn codes
//   k_scale, v_scale (N_q, ps, KVH)         f32, one per token and KV head
//   block_tables (B, MP) int32, -1 = unallocated   pos (B,) int32
// A table entry below N_n names a native page; one at or above it names
// quantized page id - N_n. Logical slot j of row b lives in page
// block_tables[b, j / ps] at page row j % ps and holds absolute position j.
// A slot is valid when its page is allocated (0 <= id < N_n + N_q) and
// j <= pos[b]; invalid slots are neither read nor scored.
//
// The kernel is K3 (paged_attention.cu) over a two-region pool:
// decode_core.cuh's flash-decoding core with a paged source that resolves
// each slot by its page id to a native pool row or a code row. A cluster of
// SPLIT CTAs per (KV head, batch row), logical tile t of 64 slots on rank
// t % SPLIT, tiles with no valid slot skipped before any load; native rows
// are copied by cp.async as K3 copies them, a code row's codes (hd bytes)
// and scale are copied by cp.async and dequantized in shared memory exactly
// as `dequantize_kv` and the Pallas kernel do ((float(code) * scale)
// rounded to q's dtype; int8 and e4m3 codes convert to float exactly), by
// the thread that copied them; then the tile runs K3's arithmetic and the
// partials are combined through distributed shared memory in the same
// launch. So K3q over an all-quantized pool equals K3 over the dequantized
// pool, and over a mixed pool K3 over the native pages followed by the
// dequantized ones, under the same table ids, bit for bit; and a dense
// int8 ring (K2q, same core) that has not wrapped equals an all-int8 pool
// holding the same codes. A row with no valid slot gets the mean of V over
// every table slot, an unallocated page read as quantized page 0, as from
// the plain version.
// So there K3q over a mixed pool reads another page than K3 over its
// dequantized concatenation, whose -1 reads native page 0.
//
// The unscaled route (paged_decode_attention_cast_fwd) is the same kernel
// over a pool held under an unscaled storage cast (the reference's legacy
// `cache_dtype`, whose pool has one region: k_pages, v_pages (N, ps, KVH,
// hd) as float16, bfloat16, float32 or float8_e4m3fn, in another dtype than
// q, and no scales): the kernel sees every page as an unscaled code page
// (N_n 0, N_q N), each value rounded to q's dtype as it lands
// (decode_core.cuh), as the reference's `kk.astype(q.dtype)` does.
//
// What bounds it: bytes. A step reads each valid row once: its codes (1
// byte per element instead of 2 in bf16) plus 4 bytes of scale per row and
// KV head on a quantized page, the row in q's dtype on a native one, for a
// few MFLOP; decode_core.cuh says what the design does about that.
#include "decode_core.cuh"

namespace {

namespace dc = repro::decode;

// SCALED false: the unscaled route (k_scale, v_scale unread).
// Launched in clusters of Geometry<T, HD>::SPLIT CTAs (dc::launch_clusters),
// as K2 at the same hd: paged equals dense.
template <typename T, typename C, int HD, bool SCALED>
__global__ void __maxnreg__(dc::Route<T>::max_regs(HD))
paged_decode_attention_quant_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const C* __restrict__ qk_pages, const C* __restrict__ qv_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ pos, T* __restrict__ out,
    int H, int KVH, int Nn, int Nq, int ps, int MP, float scale) {
  const int G = H / KVH;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row_stride = (size_t)KVH * HD;  // between pool rows, in elements
  const size_t grp = ((size_t)b * H + (size_t)kvh * G) * HD;  // G heads, contiguous
  const dc::PagedSlots src{block_tables + (size_t)b * MP, max(min(pos[b] + 1, MP * ps), 0), Nn,
                           Nq, ps, MP * ps};
  const dc::CodeRows<C, SCALED> codes{qk_pages + (size_t)kvh * HD, qv_pages + (size_t)kvh * HD,
                                      SCALED ? k_scale + kvh : nullptr,
                                      SCALED ? v_scale + kvh : nullptr, row_stride, (size_t)KVH};
  // with Nn == 0 the native pools are null and never read
  dc::attend<T, HD>(src, G, q + grp, Nn ? k_pages + (size_t)kvh * HD : nullptr,
                    Nn ? v_pages + (size_t)kvh * HD : nullptr, row_stride, out + grp, scale,
                    codes);
}

template <typename T, typename C, int HD, bool SCALED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qk,
                   const void* qv, const float* ks, const float* vs, const int* block_tables,
                   const int* pos, void* out, int B, int H, int KVH, int Nn, int Nq, int ps,
                   int MP, float scale, cudaStream_t stream) {
  static int clusters[33];  // per group size: max_clusters + 1, 0 until asked
  return dc::launch_clusters<T, HD>(
      paged_decode_attention_quant_kernel<T, C, HD, SCALED>, clusters, KVH, B, H / KVH, stream,
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const C*>(qk), static_cast<const C*>(qv), ks, vs, block_tables, pos,
      static_cast<T*>(out), H, KVH, Nn, Nq, ps, MP, scale);
}

template <typename T, typename C, bool SCALED>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* qk,
                        const void* qv, const float* ks, const float* vs,
                        const int* block_tables, const int* pos, void* out, int B, int H,
                        int KVH, int Nn, int Nq, int ps, int MP, float scale,
                        cudaStream_t s) {
#define REPRO_LAUNCH(HD)                                                                   \
  launch<T, C, HD, SCALED>(q, k, v, qk, qv, ks, vs, block_tables, pos, out, B, H, KVH, Nn, \
                           Nq, ps, MP, scale, s)
  switch (hd) {
    case 32: return REPRO_LAUNCH(32);
    case 64: return REPRO_LAUNCH(64);
    case 128: return REPRO_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}

template <typename T>
cudaError_t dispatch_code(int is_fp8, int hd, const void* q, const void* k, const void* v,
                          const void* qk, const void* qv, const float* ks, const float* vs,
                          const int* block_tables, const int* pos, void* out, int B, int H,
                          int KVH, int Nn, int Nq, int ps, int MP, float scale,
                          cudaStream_t s) {
  if (is_fp8)
    return dispatch_hd<T, __nv_fp8_e4m3, true>(hd, q, k, v, qk, qv, ks, vs, block_tables, pos,
                                               out, B, H, KVH, Nn, Nq, ps, MP, scale, s);
  return dispatch_hd<T, int8_t, true>(hd, q, k, v, qk, qv, ks, vs, block_tables, pos, out, B, H,
                                      KVH, Nn, Nq, ps, MP, scale, s);
}

// The unscaled route's storage types (0 float16, 1 bfloat16, 2 float32, 3
// float8_e4m3fn): the cast pool as the code region, no native pages. A
// store in q's own dtype is the native route (K3) and is refused here.
template <typename T>
cudaError_t dispatch_store(int store, int hd, const void* q, const void* k, const void* v,
                           const int* block_tables, const int* pos, void* out, int B, int H,
                           int KVH, int N, int ps, int MP, float scale, cudaStream_t s) {
#define REPRO_STORE(S)                                                                      \
  {                                                                                        \
    if constexpr (std::is_same<S, T>::value)                                               \
      return cudaErrorInvalidValue;                                                        \
    else                                                                                   \
      return dispatch_hd<T, S, false>(hd, q, nullptr, nullptr, k, v, nullptr, nullptr,       \
                                      block_tables, pos, out, B, H, KVH, 0, N, ps, MP, scale, \
                                      s);                                                  \
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

// is_bf16: 1 for bfloat16 q (and native pages), 0 for float32; is_fp8: 1 for
// float8_e4m3fn codes, 0 for int8. Nn (native pages) may be 0, with k_pages
// and v_pages then never read; Nq must be positive. G = H / KVH must be at
// most 32, and (Nn + Nq) * ps must fit an int.
extern "C" cudaError_t paged_decode_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages, const void* qk_pages,
    const void* qv_pages, const float* k_scale, const float* v_scale,
    const int* block_tables, const int* pos, void* out, int B, int H, int KVH, int Nn, int Nq,
    int ps, int MP, int hd, int is_bf16, int is_fp8, float scale, void* stream) {
  if (B <= 0 || Nn < 0 || Nq <= 0 || ps <= 0 || MP <= 0 || KVH <= 0 || H % KVH != 0 ||
      H / KVH > 32 || ((long long)Nn + Nq) * ps > 0x7fffffffLL ||
      (long long)MP * ps > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_code<__nv_bfloat16>(is_fp8, hd, q, k_pages, v_pages, qk_pages, qv_pages,
                                        k_scale, v_scale, block_tables, pos, out, B, H, KVH,
                                        Nn, Nq, ps, MP, scale, s);
  return dispatch_code<float>(is_fp8, hd, q, k_pages, v_pages, qk_pages, qv_pages, k_scale,
                              v_scale, block_tables, pos, out, B, H, KVH, Nn, Nq, ps, MP,
                              scale, s);
}

// Dynamic shared memory one CTA takes for head dim hd, group size G and
// dtype (is_bf16 as above; the code type does not change it); 0 if hd is
// unsupported.
extern "C" int paged_decode_attention_quant_smem_bytes(int hd, int G, int is_bf16) {
  return (int)(is_bf16 ? dc::smem_bytes<__nv_bfloat16>(hd, G) : dc::smem_bytes<float>(hd, G));
}

// The unscaled route: k_pages, v_pages (N, ps, KVH, hd) stored as
// ``store`` (0 float16, 1 bfloat16, 2 float32, 3 float8_e4m3fn; not q's
// dtype), each value rounded to q's dtype as it loads; a table id in [0, N)
// names a page, anything else is unallocated. Other arguments as
// paged_decode_attention_quant_fwd's.
extern "C" cudaError_t paged_decode_attention_cast_fwd(
    const void* q, const void* k_pages, const void* v_pages, const int* block_tables,
    const int* pos, void* out, int B, int H, int KVH, int N, int ps, int MP, int hd,
    int is_bf16, int store, float scale, void* stream) {
  if (B <= 0 || N <= 0 || ps <= 0 || MP <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > 32 ||
      (long long)N * ps > 0x7fffffffLL || (long long)MP * ps > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_store<__nv_bfloat16>(store, hd, q, k_pages, v_pages, block_tables, pos, out,
                                         B, H, KVH, N, ps, MP, scale, s);
  return dispatch_store<float>(store, hd, q, k_pages, v_pages, block_tables, pos, out, B, H, KVH,
                               N, ps, MP, scale, s);
}
