// One-token GQA decode attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (src/repro/kernels/paged_attention.py). Layouts are the reference's:
//   q, out (B, H, hd)   k_pages, v_pages (N, ps, KVH, hd)
//   block_tables (B, MP) int32, -1 = unallocated   pos (B,) int32
// Logical slot j of row b lives in page block_tables[b, j / ps] at page row
// j % ps and holds absolute position j (paged caches never wrap). A slot is
// valid when its page is allocated (0 <= id < N) and j <= pos[b]. Validity
// never comes from page contents: recycled pages are not zeroed, and rows
// of invalid slots are neither read nor scored.
//
// The kernel is decode_core.cuh's flash-decoding core over a paged source,
// the same core as K2 (decode_attention.cu): a cluster of SPLIT CTAs per
// (KV head, batch row), logical tile t of 64 slots on rank t % SPLIT (K2's
// geometry at the same dtype and hd), the partials combined through
// distributed shared memory in the same launch. A tile's slots resolve to
// pool rows through the block table, read on the device (64 / ps table
// entries per tile; any ps >= 1 works), and
// only valid rows are copied. This gather is what the reference's model
// path materializes as a (B, MP*ps, KVH, hd) copy (`_pool_read`); here it
// never leaves the CTA. Because K2 and K3 share the core, the split, the
// tile arithmetic and the combine order, a paged pool and a dense ring that
// has not wrapped, holding the same K/V at the same positions, give the
// same output bit for bit.
//
// Only tiles below pos + 1 are visited, and a tile with no valid slot is
// skipped. For a row with at least one valid slot this changes nothing:
// the TPU kernel's all-masked steps before the first valid one are rescaled
// away by exp(-1e30 - m) = 0, and those after it add exp(-1e30 - m) = 0.
// A row with NO valid slot (an inactive engine row has an all -1 table)
// gets what the TPU kernel and the plain version give it, a uniform
// softmax over masked scores: the mean of V over every table slot, an
// unallocated page read as page 0. The engine's free rows carry it into
// their MoE router, where it decides whose assignments fill an expert's
// capacity.
//
// What bounds it: bytes. One step reads the valid pages' K/V once (B 16,
// pos 128-1023, KVH 8, hd 64 in bf16: ~16 MB, ~5 us at 3.35 TB/s) for a
// few MFLOP; decode_core.cuh says what the design does about that.
#include "decode_core.cuh"

namespace {

namespace dc = repro::decode;

// Launched in clusters of Geometry<T, HD>::SPLIT CTAs (dc::launch_clusters),
// as K2 at the same hd: paged equals dense.
template <typename T, int HD>
__global__ void __maxnreg__(dc::Route<T>::max_regs(HD))
paged_decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ pos, T* __restrict__ out, int H,
                              int KVH, int N, int ps, int MP, float scale) {
  const int G = H / KVH;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const size_t grp = ((size_t)b * H + (size_t)kvh * G) * HD;  // G heads, contiguous
  const dc::PagedSlots src{block_tables + (size_t)b * MP, max(min(pos[b] + 1, MP * ps), 0), N, 0,
                          ps, MP * ps};
  dc::attend<T, HD>(src, G, q + grp, k_pages + (size_t)kvh * HD, v_pages + (size_t)kvh * HD,
                    (size_t)KVH * HD, out + grp, scale);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* block_tables,
                   const int* pos, void* out, int B, int H, int KVH, int N, int ps, int MP,
                   float scale, cudaStream_t stream) {
  static int clusters[33];  // per group size: max_clusters + 1, 0 until asked
  return dc::launch_clusters<T, HD>(paged_decode_attention_kernel<T, HD>, clusters, KVH, B,
                                    H / KVH, stream, static_cast<const T*>(q),
                                    static_cast<const T*>(k), static_cast<const T*>(v),
                                    block_tables, pos, static_cast<T*>(out), H, KVH, N, ps, MP,
                                    scale);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* block_tables, const int* pos, void* out, int B, int H,
                        int KVH, int N, int ps, int MP, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, block_tables, pos, out, B, H, KVH, N, ps, MP, scale, s);
    case 64: return launch<T, 64>(q, k, v, block_tables, pos, out, B, H, KVH, N, ps, MP, scale, s);
    case 128: return launch<T, 128>(q, k, v, block_tables, pos, out, B, H, KVH, N, ps, MP, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32. The group size G = H / KVH
// must be at most 32, and N * ps must fit an int
// (pool rows are indexed as page * ps + row).
extern "C" cudaError_t paged_decode_attention_fwd(const void* q, const void* k_pages,
                                                  const void* v_pages,
                                                  const int* block_tables, const int* pos,
                                                  void* out, int B, int H, int KVH, int N,
                                                  int ps, int MP, int hd, int is_bf16,
                                                  float scale, void* stream) {
  if (B <= 0 || N <= 0 || ps <= 0 || MP <= 0 || KVH <= 0 || H % KVH != 0 ||
      H / KVH > 32 || (long long)N * ps > 0x7fffffffLL || (long long)MP * ps > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, block_tables, pos, out, B, H,
                                      KVH, N, ps, MP, scale, s);
  return dispatch_hd<float>(hd, q, k_pages, v_pages, block_tables, pos, out, B, H, KVH, N,
                            ps, MP, scale, s);
}

// Dynamic shared memory one CTA takes for head dim hd, group size G and
// dtype (is_bf16 as above); 0 if hd is unsupported.
extern "C" int paged_decode_attention_smem_bytes(int hd, int G, int is_bf16) {
  return (int)(is_bf16 ? dc::smem_bytes<__nv_bfloat16>(hd, G) : dc::smem_bytes<float>(hd, G));
}
