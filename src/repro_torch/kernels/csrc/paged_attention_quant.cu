// One-token GQA decode attention over a quantized or mixed paged KV pool,
// for Hopper (sm_90a), written for clarity first (K3q).
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
// K3's structure (paged_attention.cu) unchanged: one CTA per (KV head,
// row), one warp per query head of the group, 64-slot tiles with the online
// softmax in f32 registers, masked scores -1e30, p rounded to q's dtype
// before the PV product, output acc / max(l, 1e-30), zeros for a row with
// no valid slot. What is new is the tile load: each slot is resolved to a
// native or a quantized pool row, native rows are fetched as in K3, and
// quantized rows are fetched as codes (an int8 row at hd 64 is 64 bytes:
// four 16-byte loads) with their scale, then dequantized right after the
// load exactly as `dequantize_kv` and the Pallas kernel do:
// (float(code) * scale) rounded to q's dtype. int8 and e4m3 codes convert
// to float exactly.
//
// What bounds it: bytes. A step reads each valid row's codes once (1 byte
// per element instead of 2 in bf16) plus 4 bytes of scale per row per KV
// head, for a few MFLOP. As in K3 a tile is computed only after it has
// arrived, and the grid is (KVH, B).
#include "dequant.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
using repro::load_rows_dequant;
using repro::load_rows_gather;
using repro::NEG_INF;
using repro::to_f;
using repro::warp_max;
using repro::warp_sum;

constexpr int BL = 64;  // logical slots per tile: two per lane

// NROW entries: a native pool row (>= 0), an invalid slot (-1: zeros), or a
// slot of the quantized region (-2: left to dequant.cuh::load_rows_dequant by
// common.cuh::load_rows_gather)
constexpr int INVALID = -1;
constexpr int QUANT = -2;

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) * ((size_t)G * HD + (size_t)BL * (HD + 1) + (size_t)BL * HD) +
         2 * sizeof(int) * BL;
}

template <typename T, typename C, int HD>
__global__ void paged_decode_attention_quant_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const C* __restrict__ qk_pages, const C* __restrict__ qv_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ pos, T* __restrict__ out,
    int H, int KVH, int Nn, int Nq, int ps, int MP, float scale) {
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
  int* NROW = reinterpret_cast<int*>(Vs + BL * HD);  // native row, INVALID or QUANT
  int* QROW = NROW + BL;                             // quantized row, or -1

  const size_t row_stride = (size_t)KVH * HD;   // between pool rows, in elements
  const T* q_grp = q + ((size_t)b * H + (size_t)kvh * G) * HD;  // G heads, contiguous
  const T* k_base = k_pages + (size_t)kvh * HD;  // never read when Nn == 0
  const T* v_base = v_pages + (size_t)kvh * HD;
  const C* qk_base = qk_pages + (size_t)kvh * HD;
  const C* qv_base = qv_pages + (size_t)kvh * HD;
  const float* ks_base = k_scale + kvh;          // scales (N_q * ps, KVH)
  const float* vs_base = v_scale + kvh;
  const int* bt = block_tables + (size_t)b * MP;
  const int n_slots = min(pos[b] + 1, MP * ps);

  load_rows<T, HD>(Qs, HD, q_grp, HD, 0, G, G, tid, nthreads);

  float m = NEG_INF, l = 0.f;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  const float* qrow = Qs + g * HD;

  for (int l0 = 0; l0 < n_slots; l0 += BL) {
    __syncthreads();  // the previous tile's reads (and the q load) are done
    int any = 0, anyq = 0;
    for (int j = tid; j < BL; j += nthreads) {
      const int slot = l0 + j;
      int nr = INVALID, qr = -1;
      if (slot < n_slots) {
        const int page = bt[slot / ps];
        if (page >= 0 && page < Nn) {
          nr = page * ps + slot % ps;
        } else if (page >= Nn && page - Nn < Nq) {
          nr = QUANT;
          qr = (page - Nn) * ps + slot % ps;
        }
      }
      NROW[j] = nr;
      QROW[j] = qr;
      any |= nr != INVALID;
      anyq |= qr >= 0;
    }
    if (!__syncthreads_or(any)) continue;  // no valid slot: the tile adds nothing
    anyq = __syncthreads_or(anyq);
    load_rows_gather<T, HD>(Ks, KS, k_base, row_stride, NROW, BL, tid, nthreads);
    load_rows_gather<T, HD>(Vs, HD, v_base, row_stride, NROW, BL, tid, nthreads);
    if (anyq) {
      load_rows_dequant<C, T, HD>(Ks, KS, qk_base, row_stride, ks_base, KVH, QROW, BL, tid,
                                  nthreads);
      load_rows_dequant<C, T, HD>(Vs, HD, qv_base, row_stride, vs_base, KVH, QROW, BL, tid,
                                  nthreads);
    }
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
    s0 = NROW[lane] != INVALID ? s0 * scale : NEG_INF;
    s1 = NROW[lane + 32] != INVALID ? s1 * scale : NEG_INF;

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

template <typename T, typename C, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qk,
                   const void* qv, const float* ks, const float* vs, const int* block_tables,
                   const int* pos, void* out, int B, int H, int KVH, int Nn, int Nq, int ps,
                   int MP, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  auto kern = paged_decode_attention_quant_kernel<T, C, HD>;
  const size_t smem = smem_bytes<HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KVH, B);
  kern<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const C*>(qk), static_cast<const C*>(qv), ks, vs, block_tables, pos,
      static_cast<T*>(out), H, KVH, Nn, Nq, ps, MP, scale);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* qk,
                        const void* qv, const float* ks, const float* vs,
                        const int* block_tables, const int* pos, void* out, int B, int H,
                        int KVH, int Nn, int Nq, int ps, int MP, float scale,
                        cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, C, 32>(q, k, v, qk, qv, ks, vs, block_tables, pos, out, B, H, KVH, Nn,
                              Nq, ps, MP, scale, s);
    case 64:
      return launch<T, C, 64>(q, k, v, qk, qv, ks, vs, block_tables, pos, out, B, H, KVH, Nn,
                              Nq, ps, MP, scale, s);
    case 128:
      return launch<T, C, 128>(q, k, v, qk, qv, ks, vs, block_tables, pos, out, B, H, KVH, Nn,
                               Nq, ps, MP, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_code(int is_fp8, int hd, const void* q, const void* k, const void* v,
                          const void* qk, const void* qv, const float* ks, const float* vs,
                          const int* block_tables, const int* pos, void* out, int B, int H,
                          int KVH, int Nn, int Nq, int ps, int MP, float scale,
                          cudaStream_t s) {
  if (is_fp8)
    return dispatch_hd<T, __nv_fp8_e4m3>(hd, q, k, v, qk, qv, ks, vs, block_tables, pos, out,
                                         B, H, KVH, Nn, Nq, ps, MP, scale, s);
  return dispatch_hd<T, int8_t>(hd, q, k, v, qk, qv, ks, vs, block_tables, pos, out, B, H,
                                KVH, Nn, Nq, ps, MP, scale, s);
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

// Dynamic shared memory one CTA takes for head dim hd and group size G
// (0 if hd is unsupported).
extern "C" int paged_decode_attention_quant_smem_bytes(int hd, int G) {
  switch (hd) {
    case 32: return (int)smem_bytes<32>(G);
    case 64: return (int)smem_bytes<64>(G);
    case 128: return (int)smem_bytes<128>(G);
    default: return 0;
  }
}
