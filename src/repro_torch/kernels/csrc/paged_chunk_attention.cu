// Chunked-prefill attention over quantized K/V (K4q) and over a paged pool
// (K4p), for Hopper (sm_90a), written for clarity first.
//
// K4q replaces the quantized variant of the Pallas TPU kernel
// `_chunk_kernel` (src/repro/kernels/chunk_attention.py, `quantized=True`):
//   q, out (B, C, H, hd)            bf16 or f32
//   k, v (B, L, KVH, hd)            int8 or float8_e4m3fn codes
//   k_scale, v_scale (B, L, KVH)    f32, one per slot and KV head
//   slot_pos (B, L) int32           absolute position per slot, -1 empty
//   pos0, valid (B,) int32
// A key is visible to query i of row b when 0 <= slot_pos <= pos0[b] + i.
//
// K4p has no Pallas counterpart: it is the attention of the reference's
// `attn_chunk_paged` (src/repro/models/attention.py), which gathers the pool
// through the block tables (`_pool_read`, dequantizing quantized pages) and
// concatenates the native staging buffer before its einsum softmax. Here the
// kernel reads each key where it lies:
//   k_pages, v_pages (N_n, ps, KVH, hd)      q's dtype; N_n may be 0
//   qk_pages, qv_pages (N_q, ps, KVH, hd)    int8 or float8_e4m3fn codes; N_q may be 0
//   k_scale, v_scale (N_q, ps, KVH)          f32
//   block_tables (B, MP) int32, -1 = unallocated
//   stage_k, stage_v (B, S, KVH, hd)         q's dtype, or null (no staging)
//   base, pos0, valid (B,) int32
// Logical position j of row b is a key from exactly one source: with
// staging, j >= base[b] reads stage[b, j]; otherwise (or with no staging)
// page block_tables[b, j / ps] at row j % ps, native below N_n, quantized at
// id - N_n above it, and nothing for an unallocated page. A key is visible
// to query i when it has a source and j <= pos0[b] + i. With staging the
// pool serves only the prefix-cache hit [0, base): positions an earlier
// request wrote and the pool already rounded.
//
// Both are K4's kernel (chunk_attention.cu) with another tile load: one
// CTA per (tile of 64 chunk queries, head, row), the TPU kernel's
// sequential KV grid axis a loop inside the CTA with the online softmax in
// f32 registers, two threads per query row, masked scores -1e30, p rounded
// to the value dtype before the PV product, output acc / max(l, 1e-30), and
// zeros for query rows at or beyond `valid`. Each KV tile first resolves
// every slot to a source row and its key position, then fetches native and
// staging rows with common.cuh::load_rows_gather and code rows with
// dequant.cuh::load_rows_dequant, which dequantizes right after the load
// exactly as `dequantize_kv` does: (float(code) * scale) rounded to q's
// dtype. Tiles wholly beyond the tile's last live query position are
// skipped (the keys are position-ordered: K4p's key position is j, and K4q
// keeps K4's assumption that a chunk row's cache is position-ordered, with
// every slot visited where pos0 + valid would pass L), and so are tiles
// with no key at all. K4p's summation order is the pool's keys, then
// staging's, in position order; the reference sums the same keys in the
// same order, with masked ones between them.
//
// What bounds it: bytes on the tensor cores, as for K4 (q, the live K/V at
// one byte per code plus 4 bytes of scale per row and KV head, the output;
// a few MB at the chunked serve's mix). Like K4 it computes in f32 FMAs on
// the CUDA cores from shared memory, so FMA issue bounds it.
#include "dequant.cuh"

namespace {

using repro::from_f;
using repro::load_rows;
using repro::load_rows_dequant;
using repro::load_rows_gather;
using repro::NEG_INF;
using repro::to_f;

constexpr int BQ = 64;          // chunk queries per CTA
constexpr int BK = 64;          // key slots per KV tile
constexpr int THREADS = 2 * BQ; // two threads per query row

// Row lists of a tile (see load_rows_gather): a native or staging row (>= 0),
// zeros (-1), or a row left to another copy (-2).
constexpr int ZEROS = -1;
constexpr int OTHER = -2;

template <int HD>
struct Smem {
  static constexpr int QS = HD + 4;  // padded strides (floats); multiples of 4 keep float4 aligned
  static constexpr int KS = HD + 4;
  static constexpr int VS = HD;
  static constexpr int PS = BK + 1;
  static constexpr int floats = BQ * QS + BK * KS + BK * VS + BQ * PS;
  static constexpr size_t bytes = sizeof(float) * floats + 4 * sizeof(int) * BK;
};

// PAGED: K4p (``tables`` = block_tables (B, MP)); else K4q (``tables`` =
// slot_pos (B, L), with L passed as MP and the codes/scales as the quantized
// region, row b * L + j).
template <typename T, typename C, int HD, bool PAGED>
__global__ void __launch_bounds__(THREADS)
paged_chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages, const C* __restrict__ qk,
                             const C* __restrict__ qv, const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale, const int* __restrict__ tables,
                             const T* __restrict__ stage_k, const T* __restrict__ stage_v,
                             const int* __restrict__ base, const int* __restrict__ pos0,
                             const int* __restrict__ valid, T* __restrict__ out, int Cq, int H,
                             int KVH, int Nn, int Nq, int ps, int MP, int S, float scale) {
  using Sm = Smem<HD>;
  constexpr int HALF_K = BK / 2;
  constexpr int HALF_D = HD / 2;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * Sm::QS;
  float* Vs = Ks + BK * Sm::KS;
  float* Ps = Vs + BK * Sm::VS;
  int* KP = reinterpret_cast<int*>(Ps + BQ * Sm::PS);  // key position, -1: no key
  int* NROW = KP + BK;                                 // native pool row
  int* SROW = NROW + BK;                               // staging row
  int* QROW = SROW + BK;                               // code row, -1: none

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
  const bool staged = PAGED && stage_k != nullptr;
  const int b_base = staged ? base[b] : 0;

  const size_t q_stride = (size_t)H * HD;
  const size_t row_stride = (size_t)KVH * HD;   // between K/V rows of every source
  const T* q_base = q + (size_t)b * Cq * q_stride + (size_t)h * HD;
  const T* kn_base = k_pages + (size_t)kvh * HD;  // never read when no row is native
  const T* vn_base = v_pages + (size_t)kvh * HD;
  const T* ks_base = stage_k + (size_t)kvh * HD;  // never read without staging
  const T* vs_base = stage_v + (size_t)kvh * HD;
  const C* qk_base = qk + (size_t)kvh * HD;
  const C* qv_base = qv + (size_t)kvh * HD;
  const float* ksc = k_scale + kvh;               // scales (rows, KVH)
  const float* vsc = v_scale + kvh;
  const int* tb = tables + (size_t)b * MP;
  T* o_base = out + (size_t)b * Cq * q_stride + (size_t)h * HD;

  if (q0 >= nv) {  // every row of the tile is padding (or the row is inactive)
    for (int i = tid; i < BQ * HD; i += THREADS) {
      const int rr = i / HD, c = i - rr * HD;
      if (q0 + rr < Cq) o_base[(size_t)(q0 + rr) * q_stride + c] = from_f<T>(0.f);
    }
    return;
  }

  load_rows<T, HD>(Qs, Sm::QS, q_base, q_stride, q0, BQ, Cq, tid, THREADS);

  // One past the tile's last live query position: no later key is visible.
  const int last = p0 + min(q0 + BQ, nv);
  const int k_end = PAGED ? last : ((p0 >= 0 && last <= MP) ? last : MP);

  float m = NEG_INF, l = 0.f;
  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    int any = 0, anys = 0, anyq = 0;
    for (int jj = tid; jj < BK; jj += THREADS) {
      const int j = k0 + jj;
      int kp = -1, nr = ZEROS, sr = OTHER, qr = -1;
      if (PAGED) {
        if (j < k_end) {
          if (staged && j >= b_base) {
            if (j < S) {
              nr = OTHER;
              sr = b * S + j;
              kp = j;
            }
          } else if (j < MP * ps) {
            const int page = tb[j / ps];
            if (page >= 0 && page < Nn) {
              nr = page * ps + j % ps;
              kp = j;
            } else if (page >= Nn && page - Nn < Nq) {
              nr = OTHER;
              qr = (page - Nn) * ps + j % ps;
              kp = j;
            }
          }
        }
      } else if (j < MP) {
        nr = OTHER;
        qr = b * MP + j;
        kp = tb[j];
      }
      KP[jj] = kp;
      NROW[jj] = nr;
      SROW[jj] = sr;
      QROW[jj] = qr;
      any |= kp >= 0;
      anys |= sr >= 0;
      anyq |= qr >= 0;
    }
    if (!__syncthreads_or(any)) continue;  // no key in the tile: it adds nothing
    anys = __syncthreads_or(anys);
    anyq = __syncthreads_or(anyq);
    load_rows_gather<T, HD>(Ks, Sm::KS, kn_base, row_stride, NROW, BK, tid, THREADS);
    load_rows_gather<T, HD>(Vs, Sm::VS, vn_base, row_stride, NROW, BK, tid, THREADS);
    if (anys) {
      load_rows_gather<T, HD>(Ks, Sm::KS, ks_base, row_stride, SROW, BK, tid, THREADS);
      load_rows_gather<T, HD>(Vs, Sm::VS, vs_base, row_stride, SROW, BK, tid, THREADS);
    }
    if (anyq) {
      load_rows_dequant<C, T, HD>(Ks, Sm::KS, qk_base, row_stride, ksc, KVH, QROW, BK, tid,
                                  THREADS);
      load_rows_dequant<C, T, HD>(Vs, Sm::VS, qv_base, row_stride, vsc, KVH, QROW, BK, tid,
                                  THREADS);
    }
    __syncthreads();

    float sc[HALF_K];
#pragma unroll
    for (int jj = 0; jj < HALF_K; ++jj) sc[jj] = 0.f;
    const float* qrow = Qs + r * Sm::QS;
    const float* kblk = Ks + half * HALF_K * Sm::KS;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int jj = 0; jj < HALF_K; ++jj) {
        const float4 k4 = *reinterpret_cast<const float4*>(kblk + jj * Sm::KS + d);
        sc[jj] = fmaf(q4.x, k4.x, sc[jj]);
        sc[jj] = fmaf(q4.y, k4.y, sc[jj]);
        sc[jj] = fmaf(q4.z, k4.z, sc[jj]);
        sc[jj] = fmaf(q4.w, k4.w, sc[jj]);
      }
    }

    float tmax = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < HALF_K; ++jj) {
      const int kp = KP[half * HALF_K + jj];
      sc[jj] = (kp >= 0 && kp <= qpos) ? sc[jj] * scale : NEG_INF;
      tmax = fmaxf(tmax, sc[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float* prow = Ps + r * Sm::PS + half * HALF_K;
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
    const float* pr = Ps + r * Sm::PS;
    const float* vcol = Vs + half * HALF_D;
    for (int j = 0; j < BK; ++j) {
      const float pj = pr[j];
      const float* vr = vcol + j * Sm::VS;
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

  if (qi < Cq) {
    const bool pad = qi >= nv;
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o_base + (size_t)qi * q_stride + half * HALF_D;
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) orow[i] = from_f<T>(pad ? 0.f : acc[i] / denom);
  }
}

struct Args {
  const void *q, *k_pages, *v_pages, *qk, *qv;
  const float *k_scale, *v_scale;
  const int* tables;
  const void *stage_k, *stage_v;
  const int *base, *pos0, *valid;
  void* out;
  int B, Cq, H, KVH, Nn, Nq, ps, MP, S;
  float scale;
};

template <typename T, typename C, int HD, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = paged_chunk_attention_kernel<T, C, HD, PAGED>;
  const size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Cq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), static_cast<const C*>(a.qk),
      static_cast<const C*>(a.qv), a.k_scale, a.v_scale, a.tables,
      static_cast<const T*>(a.stage_k), static_cast<const T*>(a.stage_v), a.base, a.pos0,
      a.valid, static_cast<T*>(a.out), a.Cq, a.H, a.KVH, a.Nn, a.Nq, a.ps, a.MP, a.S, a.scale);
  return cudaGetLastError();
}

template <bool PAGED>
cudaError_t dispatch(const Args& a, int hd, int is_bf16, int is_fp8, cudaStream_t s) {
#define REPRO_HD(T, C)                                  \
  switch (hd) {                                         \
    case 32: return launch<T, C, 32, PAGED>(a, s);      \
    case 64: return launch<T, C, 64, PAGED>(a, s);      \
    case 128: return launch<T, C, 128, PAGED>(a, s);    \
    default: return cudaErrorInvalidValue;              \
  }
  if (is_bf16) {
    if (is_fp8) REPRO_HD(__nv_bfloat16, __nv_fp8_e4m3)
    REPRO_HD(__nv_bfloat16, int8_t)
  }
  if (is_fp8) REPRO_HD(float, __nv_fp8_e4m3)
  REPRO_HD(float, int8_t)
#undef REPRO_HD
  return cudaErrorInvalidValue;  // not reached: every case above returns
}

}  // namespace

// K4q. is_bf16: 1 for bfloat16 q, 0 for float32; is_fp8: 1 for float8_e4m3fn
// codes, 0 for int8. B * L must fit an int.
extern "C" cudaError_t chunk_attention_quant_fwd(const void* q, const void* k, const void* v,
                                                 const float* k_scale, const float* v_scale,
                                                 const int* slot_pos, const int* pos0,
                                                 const int* valid, void* out, int B, int C,
                                                 int L, int H, int KVH, int hd, int is_bf16,
                                                 int is_fp8, float scale, void* stream) {
  if (B <= 0 || C <= 0 || L <= 0 || KVH <= 0 || H % KVH != 0 ||
      (long long)B * L > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Args a{q, nullptr, nullptr, k, v, k_scale, v_scale, slot_pos, nullptr, nullptr, nullptr,
         pos0, valid, out, B, C, H, KVH, 0, B * L, 1, L, 0, scale};
  return dispatch<false>(a, hd, is_bf16, is_fp8, static_cast<cudaStream_t>(stream));
}

// K4p. Nn and Nq (native and quantized pages) may each be 0, but not both;
// a null k_pages/v_pages (Nn 0), qk_pages/qv_pages (Nq 0) or stage_k/stage_v
// (no staging, base unread) is never read. S is the staging buffers' rows per
// batch row. (Nn + Nq) * ps, MP * ps and B * S must fit an int.
extern "C" cudaError_t paged_chunk_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages, const void* qk_pages,
    const void* qv_pages, const float* k_scale, const float* v_scale, const int* block_tables,
    const void* stage_k, const void* stage_v, const int* base, const int* pos0,
    const int* valid, void* out, int B, int C, int H, int KVH, int Nn, int Nq, int ps, int MP,
    int S, int hd, int is_bf16, int is_fp8, float scale, void* stream) {
  if (B <= 0 || C <= 0 || KVH <= 0 || H % KVH != 0 || Nn < 0 || Nq < 0 || Nn + Nq <= 0 ||
      ps <= 0 || MP <= 0 || S < 0 || ((long long)Nn + Nq) * ps > 0x7fffffffLL ||
      (long long)MP * ps > 0x7fffffffLL || (long long)B * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Args a{q, k_pages, v_pages, qk_pages, qv_pages, k_scale, v_scale, block_tables, stage_k,
         stage_v, base, pos0, valid, out, B, C, H, KVH, Nn, Nq, ps, MP, S, scale};
  return dispatch<true>(a, hd, is_bf16, is_fp8, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one CTA takes for head dim hd (0 if unsupported).
extern "C" int paged_chunk_attention_smem_bytes(int hd) {
  switch (hd) {
    case 32: return (int)Smem<32>::bytes;
    case 64: return (int)Smem<64>::bytes;
    case 128: return (int)Smem<128>::bytes;
    default: return 0;
  }
}
