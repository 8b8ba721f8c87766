// Mamba-2 SSD chunked scan for Hopper (sm_90a), written for clarity first.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan.py).
// Layouts are the reference's:
//   x, y (B, S, H, P)   dt (B, S, H) f32   A (H,) f32   Bm, Cm (B, S, N) f32
//   init_state, state (B, H, P, N) f32
// Per head h the recurrence is h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,
// y_t = C_t . h_t, computed a chunk of Q steps at a time: with
// LA = cumsum(dt A) over the chunk,
//   y_q   = sum_{s<=q} (C_q . B_s) exp(LA_q - LA_s) dt_s x_s      (intra)
//         + exp(LA_q) C_q . state                               (inter)
//   state = exp(LA_{Q-1}) state + sum_s exp(LA_{Q-1} - LA_s) dt_s x_s B_s^T
//
// One CTA per (head, batch row). The TPU grid's sequential chunk axis (the
// state in VMEM scratch) becomes a loop inside the CTA with the state
// resident in shared memory, so the whole scan is one launch and the state
// never leaves the SM until the final store. Per chunk the CTA stages x, C
// and B^T in shared memory as f32, computes the cumulative log-decay LA
// (one sequential sum, in f32 whatever x's dtype), then walks the chunk's
// query rows in blocks of 32: the weight block W = (C B^T) exp(LA_q - LA_s)
// dt_s for s <= q (zero above the diagonal: the exponent is never formed
// there, so nothing overflows), then y for those rows, W x plus the inter
// term. Last, the state update, with x scaled in place by
// exp(LA_{Q-1} - LA_s) dt_s. Only differences of LA are exponentiated (LA
// itself reaches about -1e3 within a chunk at the full config, where
// exp(LA) is 0 in f32), and no ratio of two exponentials is formed.
//
// Everything stays in f32 until the one store of y in x's dtype, as the TPU
// kernel computes it (its plain version instead rounds W and the inter term
// to x's dtype, as the reference's `ssd_chunked` does).
//
// Any S is taken: the chunk past the sequence's end is masked (dt = 0 and
// x, B, C = 0 there, no stores), so the final state is the state after S
// steps, as the reference's dt = 0 padding gives it. A null init_state
// means a zero state. Q, P and N must be multiples of 4 (P of 8 for
// bfloat16 x, Q of 32 above 32), within the shared memory a CTA can have.
//
// What bounds it: at the full mamba2-130m prefill (B 8, S 512, H 24, P 64,
// N 128, Q 128) the call moves ~36 MB for ~6 GFLOP (the causal half of the
// C B^T and W x products), so on the tensor cores it would be byte-bound at
// ~11 us. This first kernel runs the products on the CUDA cores in f32 FMAs
// from shared memory (register tiles of 4x4 or 2x4 outputs, float4 operand
// loads), so FMA issue and the 192 CTAs of one wave and a half over 132
// SMs bound it. The weight block C B^T is the same for every head and is
// recomputed per head (a later redesign shares it); wgmma and TMA are later
// work.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::unpack;

constexpr int THREADS = 256;
constexpr int QB = 32;  // query rows per weight block

// Offsets (in floats) of the shared-memory arrays; every one is a multiple
// of 4, so float4 accesses stay aligned.
struct Layout {
  int Q, P, N, qb, ldb;
  int C, Bt, X, St, Wb, LA, DT, WS, DEC, total;
};

__host__ __device__ inline Layout make_layout(int Q, int P, int N) {
  Layout L;
  L.Q = Q;
  L.P = P;
  L.N = N;
  L.qb = Q < QB ? Q : QB;
  L.ldb = Q + 4;  // B^T row stride: the transposing stores hit distinct banks
  int o = 0;
  L.C = o;   o += Q * N;      // C   [q][n]
  L.Bt = o;  o += N * L.ldb;  // B^T [n][s]
  L.X = o;   o += Q * P;      // x   [s][p]
  L.St = o;  o += N * P;      // state^T [n][p]
  L.Wb = o;  o += L.qb * Q;   // weight block [q - q0][s]
  L.LA = o;  o += Q;          // cumulative log-decay
  L.DT = o;  o += Q;          // dt (0 past the sequence's end)
  L.WS = o;  o += Q;          // exp(LA_{Q-1} - LA_s) dt_s
  L.DEC = o; o += Q;          // exp(LA_q)
  L.total = o;
  return L;
}

// acc[r][c] += sum_{k < K} A[(i0 + r) * lda + k] * B[k * ldb + j0 + c], from
// shared memory with float4 loads; K, lda, ldb and j0 are multiples of 4.
template <int TR>
__device__ __forceinline__ void mma_nn(float (&acc)[TR][4], const float* A, int lda,
                                       const float* B, int ldb, int i0, int j0, int K) {
  for (int k = 0; k < K; k += 4) {
    float4 a[TR], b[4];
#pragma unroll
    for (int r = 0; r < TR; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (i0 + r) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      b[kk] = *reinterpret_cast<const float4*>(B + (k + kk) * ldb + j0);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float av[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[r][0] = fmaf(av[kk], b[kk].x, acc[r][0]);
        acc[r][1] = fmaf(av[kk], b[kk].y, acc[r][1]);
        acc[r][2] = fmaf(av[kk], b[kk].z, acc[r][2]);
        acc[r][3] = fmaf(av[kk], b[kk].w, acc[r][3]);
      }
    }
  }
}

// Rows [0, nrows) of a row-major tile of T, ``width`` values per row (a
// multiple of 16 / sizeof(T)), rows ``src_stride`` elements apart and
// 16-byte aligned, into float shared memory (rows ``width`` floats apart);
// rows at or beyond ``valid`` are zeros. Four 16-byte loads in flight per
// thread before any store.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t src_stride, int width, int nrows,
                                          int valid, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = 4;
  const int vpr = width / VEC;
  const int nv = nrows * vpr;
  for (int base = tid; base < nv; base += U * THREADS) {
    uint4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      const int r = i / vpr;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nv && r < valid)
        buf[u] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * src_stride +
                                                      (i - r * vpr) * VEC));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      if (i < nv) {
        const int r = i / vpr;
        unpack<T>(dst + r * width + (i - r * vpr) * VEC, buf[u]);
      }
    }
  }
}

// B rows [0, Q) (N floats each, rows N apart, 16-byte aligned) transposed
// into Bt [n][s] (rows ldb apart); rows at or beyond ``valid`` are zeros.
// Neighbouring threads take neighbouring rows s, so the scalar stores of a
// warp land in distinct banks.
__device__ __forceinline__ void load_bt(float* Bt, int ldb, const float* __restrict__ src,
                                        int Q, int N, int valid, int tid) {
  constexpr int U = 4;
  const int nv = Q * (N / 4);
  for (int base = tid; base < nv; base += U * THREADS) {
    float4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      const int s = i % Q;
      buf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nv && s < valid)
        buf[u] = __ldg(reinterpret_cast<const float4*>(src + (size_t)s * N + (i / Q) * 4));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      if (i < nv) {
        const int s = i % Q, n = (i / Q) * 4;
        Bt[n * ldb + s] = buf[u].x;
        Bt[(n + 1) * ldb + s] = buf[u].y;
        Bt[(n + 2) * ldb + s] = buf[u].z;
        Bt[(n + 3) * ldb + s] = buf[u].w;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ init_state,
                T* __restrict__ y, float* __restrict__ state_out, int S, int H, int P,
                int N, int Q) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L = make_layout(Q, P, N);
  float* Cs = sm + L.C;
  float* Bt = sm + L.Bt;
  float* X = sm + L.X;
  float* St = sm + L.St;
  float* Wb = sm + L.Wb;
  float* LA = sm + L.LA;
  float* DT = sm + L.DT;
  float* WS = sm + L.WS;
  float* DEC = sm + L.DEC;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const size_t row_stride = (size_t)H * P;   // between time steps of x and y
  const size_t st_off = ((size_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += THREADS) {  // state^T [n][p]
    const int p = i / N, n = i - p * N;
    St[n * P + p] = init_state ? init_state[st_off + i] : 0.f;
  }

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const int qv = min(Q, S - c0);  // real steps in this chunk
    __syncthreads();  // the previous chunk's reads of x, C, B^T are done

    const size_t t0 = (size_t)b * S + c0;  // first time step of the chunk
    load_tile<T>(X, x + t0 * row_stride + (size_t)h * P, row_stride, P, Q, qv, tid);
    load_tile<float>(Cs, Cm + t0 * N, N, N, Q, qv, tid);
    load_bt(Bt, L.ldb, Bm + t0 * N, Q, N, qv, tid);
    for (int s = tid; s < Q; s += THREADS) DT[s] = s < qv ? dt[(t0 + s) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {  // LA = cumsum(dt * A), in order
      float run = 0.f;
      for (int s = 0; s < Q; ++s) {
        run += DT[s] * a_h;
        LA[s] = run;
      }
    }
    __syncthreads();
    const float la_end = LA[Q - 1];
    for (int s = tid; s < Q; s += THREADS) {
      DEC[s] = expf(LA[s]);
      WS[s] = expf(la_end - LA[s]) * DT[s];
    }
    __syncthreads();

    for (int q0 = 0; q0 < Q; q0 += L.qb) {
      // the weight block: rows q0 .. q0 + qb - 1, columns s < q0 + qb
      const int J = q0 + L.qb;
      const int tj_n = J / 4;
      for (int t = tid; t < (L.qb / 4) * tj_n; t += THREADS) {
        const int i0 = (t / tj_n) * 4, j0 = (t % tj_n) * 4;
        const int qa = q0 + i0;
        float acc[4][4] = {};
        if (j0 <= qa + 3) mma_nn<4>(acc, Cs + q0 * N, N, Bt, L.ldb, i0, j0, N);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = qa + r;
          float4 w;
          float* wv = reinterpret_cast<float*>(&w);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int s = j0 + cc;
            wv[cc] = s <= q ? acc[r][cc] * expf(LA[q] - LA[s]) * DT[s] : 0.f;
          }
          *reinterpret_cast<float4*>(Wb + (i0 + r) * Q + j0) = w;
        }
      }
      __syncthreads();

      // y for those rows: W x + exp(LA_q) C_q . state, 2x4 outputs a thread
      const int pj_n = P / 4;
      for (int t = tid; t < (L.qb / 2) * pj_n; t += THREADS) {
        const int i0 = (t / pj_n) * 2, j0 = (t % pj_n) * 4;
        const int qa = q0 + i0;
        if (qa >= qv) continue;
        float intra[2][4] = {}, inter[2][4] = {};
        mma_nn<2>(intra, Wb, Q, X, P, i0, j0, (qa + 2 + 3) & ~3);
        mma_nn<2>(inter, Cs + q0 * N, N, St, P, i0, j0, N);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = qa + r;
          if (q >= qv) continue;
          T* yrow = y + (t0 + q) * row_stride + (size_t)h * P + j0;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            yrow[cc] = from_f<T>(intra[r][cc] + DEC[q] * inter[r][cc]);
        }
      }
      __syncthreads();  // before the next block overwrites Wb (and St's readers finish)
    }

    // the state: x scaled by exp(LA_{Q-1} - LA_s) dt_s, then
    // state^T[n][p] = exp(LA_{Q-1}) state^T[n][p] + sum_s B^T[n][s] xs[s][p]
    for (int i = tid; i < Q * P; i += THREADS) X[i] *= WS[i / P];
    __syncthreads();
    const float decay = expf(la_end);
    const int kq = (qv + 3) & ~3;
    const int sj_n = P / 4;
    for (int t = tid; t < (N / 4) * sj_n; t += THREADS) {
      const int i0 = (t / sj_n) * 4, j0 = (t % sj_n) * 4;
      float acc[4][4] = {};
      mma_nn<4>(acc, Bt, L.ldb, X, P, i0, j0, kq);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* srow = reinterpret_cast<float4*>(St + (i0 + r) * P + j0);
        const float4 old = *srow;
        *srow = make_float4(fmaf(decay, old.x, acc[r][0]), fmaf(decay, old.y, acc[r][1]),
                            fmaf(decay, old.z, acc[r][2]), fmaf(decay, old.w, acc[r][3]));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i - p * N;
    state_out[st_off + i] = St[n * P + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const float* Bm,
                   const float* Cm, const float* init_state, void* y, float* state_out,
                   int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  const size_t smem = sizeof(float) * (size_t)make_layout(Q, P, N).total;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, init_state, static_cast<T*>(y), state_out,
      S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// is_bf16: 1 for bfloat16 x and y, 0 for float32. init_state may be null
// (a zero state).
extern "C" cudaError_t ssd_scan_fwd(const void* x, const float* dt, const float* A,
                                    const float* Bm, const float* Cm,
                                    const float* init_state, void* y, float* state_out,
                                    int B, int S, int H, int P, int N, int Q, int is_bf16,
                                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q % 4 || (Q > QB && Q % QB) || N <= 0 ||
      N % 4 || P <= 0 || P % (is_bf16 ? 8 : 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init_state, y, state_out, B, S, H, P, N,
                                 Q, s);
  return launch<float>(x, dt, A, Bm, Cm, init_state, y, state_out, B, S, H, P, N, Q, s);
}

// Dynamic shared memory one CTA takes for chunk Q, head dim P, state N.
extern "C" int ssd_scan_smem_bytes(int Q, int P, int N) {
  return (int)(sizeof(float) * (size_t)make_layout(Q, P, N).total);
}
