// One-token GQA decode attention over the paged KV pool, for Hopper (sm_90a),
// written for clarity first.
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
// Same structure as K2 (decode_attention.cu): one CTA per (KV head, batch
// row), one warp per query head of the group, so every K/V row is read once
// for all G heads that use it; 64-slot tiles with the online softmax
// (m, l, acc) in f32 registers, masked scores -1e30, p rounded to the value
// dtype before the PV product, output acc / max(l, 1e-30). Each tile first
// resolves its 64 slots to pool rows through the block table, read on the
// device (64 / ps table entries per tile; any ps >= 1 works), then fetches
// the valid rows with 16-byte loads (common.cuh::load_rows_gather). This
// gather is what the reference's model path materializes as a
// (B, MP*ps, KVH, hd) copy (`_pool_read`); here it never leaves the CTA.
//
// The loop ends at the tile that holds pos, and a tile with no valid slot
// is skipped. For a row with at least one valid slot this changes nothing:
// the TPU kernel's all-masked steps before the first valid one are rescaled
// away by exp(-1e30 - m) = 0, and those after it add exp(-1e30 - m) = 0.
// A row with NO valid slot (an inactive engine row has an all -1 table)
// gets zeros here, where the TPU kernel and the plain version average page
// 0's V (a uniform softmax over masked scores). The engine discards those
// rows, and the checks compare only rows with a valid slot.
//
// What bounds it: bytes. One step reads the valid pages' K/V once (B 16,
// pos 128-1023, KVH 8, hd 64 in bf16: ~19 MB, ~6 us at 3.35 TB/s) for a
// few MFLOP. As in K2 a tile is computed only after it has arrived (no
// double buffering), and the grid is (KVH, B).
#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
using repro::load_rows_gather;
using repro::NEG_INF;
using repro::to_f;
using repro::warp_max;
using repro::warp_sum;

constexpr int BL = 64;  // logical slots per tile: two per lane

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) * ((size_t)G * HD + (size_t)BL * (HD + 1) + (size_t)BL * HD) +
         sizeof(int) * BL;
}

template <typename T, int HD>
__global__ void paged_decode_attention_kernel(const T* __restrict__ q,
                                              const T* __restrict__ k_pages,
                                              const T* __restrict__ v_pages,
                                              const int* __restrict__ block_tables,
                                              const int* __restrict__ pos,
                                              T* __restrict__ out, int H, int KVH, int N,
                                              int ps, int MP, float scale) {
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
  int* ROWS = reinterpret_cast<int*>(Vs + BL * HD);  // pool row of each tile slot, -1 invalid

  const size_t row_stride = (size_t)KVH * HD;   // between pool rows (page rows)
  const T* q_grp = q + ((size_t)b * H + (size_t)kvh * G) * HD;  // G heads, contiguous
  const T* k_base = k_pages + (size_t)kvh * HD;
  const T* v_base = v_pages + (size_t)kvh * HD;
  const int* bt = block_tables + (size_t)b * MP;
  // slots past pos or past the table are invalid: the loop stops there
  const int n_slots = min(pos[b] + 1, MP * ps);

  load_rows<T, HD>(Qs, HD, q_grp, HD, 0, G, G, tid, nthreads);

  float m = NEG_INF, l = 0.f;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  const float* qrow = Qs + g * HD;

  for (int l0 = 0; l0 < n_slots; l0 += BL) {
    __syncthreads();  // the previous tile's reads (and the q load) are done
    int any = 0;
    for (int j = tid; j < BL; j += nthreads) {
      const int slot = l0 + j;
      int r = -1;
      if (slot < n_slots) {
        const int page = bt[slot / ps];
        if (page >= 0 && page < N) r = page * ps + slot % ps;
      }
      ROWS[j] = r;
      any |= r >= 0;
    }
    if (!__syncthreads_or(any)) continue;  // no valid slot: the tile adds nothing
    load_rows_gather<T, HD>(Ks, KS, k_base, row_stride, ROWS, BL, tid, nthreads);
    load_rows_gather<T, HD>(Vs, HD, v_base, row_stride, ROWS, BL, tid, nthreads);
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
    s0 = ROWS[lane] >= 0 ? s0 * scale : NEG_INF;
    s1 = ROWS[lane + 32] >= 0 ? s1 * scale : NEG_INF;

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

  const float denom = fmaxf(l, 1e-30f);  // l = 0 (no valid slot): zeros
  T* orow = out + ((size_t)b * H + (size_t)kvh * G + g) * HD;
#pragma unroll
  for (int i = 0; i < PER; ++i) orow[lane + 32 * i] = from_f<T>(acc[i] / denom);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* block_tables,
                   const int* pos, void* out, int B, int H, int KVH, int N, int ps, int MP,
                   float scale, cudaStream_t stream) {
  const int G = H / KVH;
  auto kern = paged_decode_attention_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KVH, B);
  kern<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      block_tables, pos, static_cast<T*>(out), H, KVH, N, ps, MP, scale);
  return cudaGetLastError();
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
// must be at most 32 (one warp per query head), and N * ps must fit an int
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

// Dynamic shared memory one CTA takes for head dim hd and group size G
// (0 if hd is unsupported).
extern "C" int paged_decode_attention_smem_bytes(int hd, int G) {
  switch (hd) {
    case 32: return (int)smem_bytes<32>(G);
    case 64: return (int)smem_bytes<64>(G);
    case 128: return (int)smem_bytes<128>(G);
    default: return 0;
  }
}
