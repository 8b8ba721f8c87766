// Mamba-2 SSD chunked scan for Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_scan.py:28).
// Layouts are the reference's:
//   x, y (B, S, H, P)   dt (B, S, H) f32   A (H,) f32   Bm, Cm (B, S, N) f32
//   init_state, state (B, H, P, N) f32
// Per head h the recurrence is h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,
// y_t = C_t . h_t, computed a chunk of Q steps at a time: with
// LA = cumsum(dt A) over the chunk,
//   y_q   = sum_{s<=q} (C_q . B_s) exp(LA_q - LA_s) dt_s x_s      (intra)
//         + exp(LA_q) C_q . state                               (inter)
//   state = exp(LA_{Q-1}) state + sum_s exp(LA_{Q-1} - LA_s) dt_s x_s B_s^T
// Only differences of LA are exponentiated (LA reaches about -1e3 within a
// chunk at the full config, where exp(LA) is 0 in f32), and no ratio of two
// exponentials is formed. Any S is taken: steps past the sequence's end are
// masked (dt = 0 and x, B, C = 0 there, no stores), so the final state is
// the state after S steps, as the reference's dt = 0 padding gives it. A
// null init_state means a zero state.
//
// The TPU kernel carries the state in VMEM across a sequential grid axis.
// On Hopper that order is what idles the card, so bf16 x runs the Mamba-2
// paper's GPU algorithm (arXiv:2405.21060 sec. 7) in three launches:
//
//  1. ssd_chunk_states_kernel, one CTA per (head group, chunk, batch row):
//     each chunk's own state contribution sum_s exp(LA_end - LA_s) dt_s x_s
//     B_s^T and its decay exp(LA_end), into scratch (B, nc, H, P, N) f32 and
//     (B, nc, H). The product contracts over the chunk's steps s, the rows
//     of both x and B, so it runs in bf16 on wgmma, where both operands may
//     be MN-major: A = (w_s B_s)^T from registers (B staged transposed), B =
//     the x tile. x is exact in bf16 and w_s B_s is split into three bf16
//     terms (hi + mid + lo, within 2^-27 of it), so the three products, each
//     exact in f32, keep the f32 accuracy the state's rule of 1e-4 needs:
//     the state seeds every Mamba-2 decode step.
//  2. ssd_state_passing_kernel, elementwise over P x N per (b, h) and
//     sequential over the chunks: state_c = decay_c state_{c-1} + contrib_c
//     from init_state (or zeros). It overwrites each contribution with the
//     state entering its chunk and writes the final state. O(nc), not
//     O(nc^2): long prompts scale.
//  3. ssd_chunk_outputs_kernel, one CTA per (head group, pair of 64-row
//     tiles of the chunk, chunk, batch row): G = C B^T once (TF32 wgmma, C
//     and B K-major along N as they lie, rounded to TF32 as they land),
//     kept in registers and shared by the CTA's heads; per head, y =
//     exp(LA_q) C . state_{c-1} (TF32 wgmma, the state tile read as it
//     lies) + W x with W = G exp(LA_q - LA_s) dt_s formed on G's
//     accumulator fragment while the first product runs, and rounded to
//     bf16 as the register A operand (the reference's own rounding of W),
//     x MN-major, as V is in K1. The decay is factored through each warp's
//     first row, so only its diagonal 16 x 16 block takes an exp per
//     element.
//
// No atomics: two launches give equal bits. The f32 state rule is
// sensitive to LA's summation order (the first port's first full-width run
// found 1.31x a 2e-5 rule from that order alone; its sequential sum kept
// the state at 0.11-0.26 of 1e-4), and a parallel scan failed the rule
// here, so phases 1 and 3 sum LA in the plain version's order, one thread
// a head, every head of the CTA at once (log_decays). Chunks under wgmma's
// 64 rows, and P and N, are padded to multiples of 64 with zeros; Q above
// 256 raises.
//
// What bounds it: at the full mamba2-130m prefill (B 8, S 512, H 24, P 64,
// N 128, Q 128) the call moves ~36 MB, and the scratch ~25 MB more out and
// back (mostly through L2), for ~4 GFLOP on the tensor cores, so bytes
// bound it at ~11-18 us. Phase 1 fits two CTAs an SM (~110 KB of shared
// memory) and phase 3 one (~220 KB); each sizes its head group at launch so
// that its grid is at most one wave over the card's SMs (at the serve's
// shape 256 and 128 CTAs), and prefetches the next head's tiles while the
// current head's products run. What is left is latency each CTA's heads
// take in turn: the next head's loads, the chained products, the stores.
//
// f32 x keeps the CUDA-core kernel of the first port (ssd_scan_kernel): TF32
// cannot hold K6's f32 rule. One CTA per (head, batch row) loops over the
// chunks with the state resident in shared memory, staging x, C and B^T as
// f32, LA summed in sequence by one thread, register tiles of f32 FMAs, and
// everything in f32 until the one store of y. Q, P and N must be multiples
// of 4 (Q of 32 above 32), within the shared memory a CTA can have.
#include "common.cuh"
#include "sm90.cuh"

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

// ====================================================================
// bf16: the chunk-parallel scan on the tensor cores
// ====================================================================
using bf16 = __nv_bfloat16;
using namespace repro::sm90;

constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int HG_MAX = 8;        // heads a CTA takes at most
constexpr int QP_MAX = 256;      // padded chunk rows at most
constexpr int SMEM_MAX = 232448; // dynamic shared memory a CTA can have

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Phase 1's shared memory in bytes from a 1024-aligned base: two x tiles
// (bf16, Qp rows of Pp, the 128B-swizzled layout of sm90.cuh), B^T [n][s]
// as f32 rows of Qp + 8 (the A fragments' float2 reads of a half-warp hit
// 32 banks), and each head's LA (then, in place, its weights w_s =
// exp(LA_end - LA_s) dt_s), dt and LA_end.
struct StatesLayout {
  int Qp, Pp, Np, ldb, x0, x1, bt, la, dt, end, bytes;
};

__host__ __device__ inline StatesLayout states_layout(int Q, int P, int N) {
  StatesLayout L;
  L.Qp = round_up(Q, 64);
  L.Pp = round_up(P, 64);
  L.Np = round_up(N, 64);
  L.ldb = L.Qp + 8;
  const int xt = L.Qp * L.Pp * 2;
  L.x0 = 0;
  L.x1 = xt;
  L.bt = 2 * xt;
  L.la = L.bt + L.Np * L.ldb * 4;
  L.dt = L.la + HG_MAX * L.Qp * 4;
  L.end = L.dt + HG_MAX * L.Qp * 4;
  L.bytes = L.end + HG_MAX * 4 + 1024;  // slack to align the base
  return L;
}

// Phase 3's shared memory in bytes from a 1024-aligned base: C rows of the
// CTA's two 64-row tiles (TF32, CR rows of Np), then a region that first
// holds B (TF32, Qp rows) for G and then ``nbuf`` buffers of one head's tiles
// (the entering state [p][n] TF32, Pp rows; x bf16, Qp rows), then LA, dt
// and LA_end of each head of the group, and a row of decay factors for
// each warp (T below).
struct OutputsLayout {
  int Qp, Pp, Np, CR, cs, bs, st, buf, la, dt, end, fac, bytes;
  // buffer k's state tile, and its x tile right after it
  __device__ uint32_t s_tile(uint32_t base, int k) const { return base + bs + k * buf; }
  __device__ uint32_t x_tile(uint32_t base, int k) const { return base + bs + k * buf + st; }
};

__host__ __device__ inline OutputsLayout outputs_layout(int Q, int P, int N, int nbuf) {
  OutputsLayout L;
  L.Qp = round_up(Q, 64);
  L.Pp = round_up(P, 64);
  L.Np = round_up(N, 64);
  L.CR = L.Qp == 64 ? 64 : 128;
  L.st = L.Pp * L.Np * 4;
  L.buf = L.st + L.Qp * L.Pp * 2;
  const int bt = L.Qp * L.Np * 4;
  L.cs = 0;
  L.bs = L.CR * L.Np * 4;
  L.la = L.bs + (nbuf * L.buf > bt ? nbuf * L.buf : bt);
  L.dt = L.la + HG_MAX * L.Qp * 4;
  L.end = L.dt + HG_MAX * L.Qp * 4;
  L.fac = L.end + HG_MAX * 4;
  L.bytes = L.fac + (TC_THREADS / 32) * L.Qp * 4 + 1024;
  return L;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The cumulative log-decay of each head of the group over the chunk's Qp
// steps: dt into DT[j][s] (0 at or past qv), then LA[j][s] = sum_{u <= s}
// dt_u A_h and LA_end[j], one thread a head, every head at once. The sum
// runs in sequence with each product rounded before it is added: the
// order of torch.cumsum over a chunk, so LA is the plain version's to the
// bit. LA reaches ~-1e3, where f32's spacing is 1.2e-4, and exp turns a
// difference in LA's rounding into a relative error of that size: a warp's
// parallel scan (each lane's steps in order, shuffles across the lanes) put
// the full-width final state beyond its f32 rule of 1e-4 on the card. Ends
// at a barrier.
__device__ __forceinline__ void log_decays(float* LA, float* DT, float* LA_end,
                                           const float* __restrict__ dt, const float* A,
                                           size_t t0, int H, int h0, int nh, int qv, int Qp,
                                           int tid) {
  for (int i = tid; i < nh * Qp; i += TC_THREADS) {  // neighbouring threads, neighbouring heads
    const int j = i % nh, s = i / nh;
    DT[j * Qp + s] = s < qv ? dt[(t0 + s) * H + h0 + j] : 0.f;
  }
  __syncthreads();
  if (tid < nh) {
    const float a = A[h0 + tid];
    const float* d = DT + tid * Qp;
    float* la = LA + tid * Qp;
    float run = 0.f;
    for (int s0 = 0; s0 < Qp; s0 += 16) {  // sixteen loads in flight before the sums
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        const float4 q = *reinterpret_cast<const float4*>(d + s0 + k);
        v[k] = q.x;
        v[k + 1] = q.y;
        v[k + 2] = q.z;
        v[k + 3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        run = __fadd_rn(run, __fmul_rn(v[k], a));
        la[s0 + k] = run;
      }
    }
    LA_end[tid] = run;
  }
  __syncthreads();
}

// Rows [0, R) of a chunk's x for one head (rows ``stride`` apart, P bf16
// values each) into the bf16 tile at ``dst`` (Pp / 64 column blocks of R
// rows); rows at or past qv and columns at or past P land as zeros.
__device__ __forceinline__ void copy_x(uint32_t dst, const bf16* src, size_t stride, int R,
                                       int Pp, int P, int qv, int tid) {
  const int cpr = Pp / 8;
  for (int i = tid; i < R * cpr; i += TC_THREADS) {
    const int r = i / cpr, c = i % cpr;
    const bool ok = r < qv && c * 8 < P;
    cp_async16(dst + tile_offset<64>(R, r, c), ok ? src + (size_t)r * stride + c * 8 : src,
               ok ? 16 : 0);
  }
}

// Rows [row0, row0 + R) of a row-major f32 array (N values a row) into the
// TF32 tile at ``dst`` (Np / 32 column blocks of R rows); rows at or past
// ``rows`` and columns at or past N land as zeros.
__device__ __forceinline__ void copy_f32(uint32_t dst, const float* src, int row0, int R, int Np,
                                         int N, int rows, int tid) {
  const int cpr = Np / 4;
  for (int i = tid; i < R * cpr; i += TC_THREADS) {
    const int r = i / cpr, c = i % cpr;
    const bool ok = row0 + r < rows && c * 4 < N;
    cp_async16(dst + tile_offset<64>(R, r, c), ok ? src + (size_t)(row0 + r) * N + c * 4 : src,
               ok ? 16 : 0);
  }
}

// The chunks copy_f32 gave this thread, rounded to TF32 in place once they
// have landed (the tensor cores would drop their low bits).
__device__ __forceinline__ void round_f32(uint8_t* tile, int R, int Np, int tid) {
  const int cpr = Np / 4;
  for (int i = tid; i < R * cpr; i += TC_THREADS) {
    float4* p = reinterpret_cast<float4*>(tile + tile_offset<64>(R, i / cpr, i % cpr));
    float4 v = *p;
    v.x = round_tf32(v.x);
    v.y = round_tf32(v.y);
    v.z = round_tf32(v.z);
    v.w = round_tf32(v.w);
    *p = v;
  }
}

// v as three bf16 terms, hi + mid + lo, each the nearest to what the ones
// before it leave (the remainders are exact in f32): within 2^-27 of v.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Phase 1. Grid (head groups of HG, chunks, batch rows); warpgroup w takes
// the 64-row tiles of the state's N rows w, w + 2, ... Per head and tile:
// contrib^T[n][p] = sum_s (w_s B_s[n]) x_s[p] over the 64-step blocks that
// hold real steps, each k-step three products (lo, mid, hi) of the split
// A fragment, built from B^T and w in shared memory.
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_chunk_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const float* __restrict__ Bm,
                        float* __restrict__ states, float* __restrict__ decay, int S, int H,
                        int P, int N, int Q, int HG) {
  extern __shared__ __align__(16) uint8_t ssd_smem[];
  uint8_t* smem = aligned_smem(ssd_smem);
  const uint32_t sbase = smem_u32(smem);
  const StatesLayout L = states_layout(Q, P, N);
  float* Bt = reinterpret_cast<float*>(smem + L.bt);
  float* WS = reinterpret_cast<float*>(smem + L.la);  // LA, then the weights in place
  float* DT = reinterpret_cast<float*>(smem + L.dt);
  float* LA_end = reinterpret_cast<float*>(smem + L.end);

  const int h0 = blockIdx.x * HG, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int nh = min(HG, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int qv = min(Q, S - c * Q);           // real steps in this chunk
  const size_t t0 = (size_t)b * S + c * Q;    // its first time step
  const size_t xs = (size_t)H * P;            // between time steps of x

  copy_x(sbase + L.x0, x + t0 * xs + (size_t)h0 * P, xs, L.Qp, L.Pp, P, qv, tid);
  cp_async_commit();

  // B^T [n][s]: neighbouring threads take neighbouring steps s, so the
  // transposing stores of a warp land in distinct banks
  {
    const float* src = Bm + t0 * N;
    const int nv = L.Qp * (L.Np / 4);
    for (int base = tid; base < nv; base += 4 * TC_THREADS) {
      float4 buf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * TC_THREADS, s = i % L.Qp, n = (i / L.Qp) * 4;
        buf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < nv && s < qv && n < N)
          buf[u] = __ldg(reinterpret_cast<const float4*>(src + (size_t)s * N + n));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * TC_THREADS, s = i % L.Qp, n = (i / L.Qp) * 4;
        if (i < nv) {
          Bt[n * L.ldb + s] = buf[u].x;
          Bt[(n + 1) * L.ldb + s] = buf[u].y;
          Bt[(n + 2) * L.ldb + s] = buf[u].z;
          Bt[(n + 3) * L.ldb + s] = buf[u].w;
        }
      }
    }
  }
  // each head's weights and decay
  log_decays(WS, DT, LA_end, dt, A, t0, H, h0, nh, qv, L.Qp, tid);
  for (int i = tid; i < nh * L.Qp; i += TC_THREADS)
    WS[i] = expf(LA_end[i / L.Qp] - WS[i]) * DT[i];
  if (tid < nh) decay[((size_t)b * nc + c) * H + h0 + tid] = expf(LA_end[tid]);

  const int r0 = 16 * (warp & 3) + (lane >> 2);  // this thread's fragment rows r0, r0 + 8
  const int cq = 2 * (lane & 3);                 // and columns 8i + cq + {0, 1}
  const int NT = L.Np / 64, PT = L.Pp / 64, nsb = (qv + 63) / 64;
  for (int j = 0; j < nh; ++j) {
    cp_async_wait<0>();  // this thread's copies of head j's x tile have landed
    fence_proxy_async();
    __syncthreads();     // x tile j, B^T and w are visible; every warp is past head j - 1
    if (j + 1 < nh)
      copy_x(sbase + ((j + 1) & 1 ? L.x1 : L.x0), x + t0 * xs + (size_t)(h0 + j + 1) * P, xs,
             L.Qp, L.Pp, P, qv, tid);
    cp_async_commit();
    const uint32_t xt = sbase + (j & 1 ? L.x1 : L.x0);
    const float* w = WS + j * L.Qp;
    float* out = states + (((size_t)b * nc + c) * H + h0 + j) * P * N;
    for (int mt = wg; mt < NT; mt += 2)
      for (int pb = 0; pb < PT; ++pb) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        for (int sb = 0; sb < nsb; ++sb) {
          // A fragment of k-step kk: a[f] holds row r0 + 8 (f & 1), steps
          // s, s + 1 with s = 64 sb + 16 kk + cq + 8 (f >> 1)
          uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int n = 64 * mt + r0 + 8 * (f & 1);
              const int s = 64 * sb + 16 * kk + cq + 8 * (f >> 1);
              const float2 bv = *reinterpret_cast<const float2*>(Bt + n * L.ldb + s);
              const float2 wv = *reinterpret_cast<const float2*>(w + s);
              split3(bv.x * wv.x, bv.y * wv.y, hi[kk][f], mid[kk][f], lo[kk][f]);
            }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t xd = descriptor<64>(xt + pb * L.Qp * 128 + (64 * sb + 16 * kk) * 128);
            wgmma_m64n64k16_rs_tb(acc, lo[kk], xd, 1);
            wgmma_m64n64k16_rs_tb(acc, mid[kk], xd, 1);
            wgmma_m64n64k16_rs_tb(acc, hi[kk], xd, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
        }
        // acc[4i + e] is state row n = 64 mt + r0 + 8 (e / 2), column p = 64 pb + 8i + cq + e % 2
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 64 * mt + r0 + 8 * (e >> 1), p = 64 * pb + 8 * i + cq + (e & 1);
            if (n < N && p < P) out[(size_t)p * N + n] = acc[4 * i + e];
          }
      }
  }
}

// Phase 2. Grid (P N / 1024, heads, batch rows), four state values a
// thread; each chunk's contribution is replaced by the state entering it.
__global__ void __launch_bounds__(256)
ssd_state_passing_kernel(float* __restrict__ states, const float* __restrict__ decay,
                         const float* __restrict__ init_state, float* __restrict__ state_out,
                         int nc, int H, int PN) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = (size_t)b * H + h;
  float4 run = init_state ? *reinterpret_cast<const float4*>(init_state + bh * PN + e)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {  // four chunks' loads in flight before the sums
    float4 v[4];
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + u < nc) {
        const size_t row = ((size_t)b * nc + c0 + u) * H + h;
        v[u] = *reinterpret_cast<const float4*>(states + row * PN + e);
        d[u] = decay[row];
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + u < nc) {
        const size_t row = ((size_t)b * nc + c0 + u) * H + h;
        *reinterpret_cast<float4*>(states + row * PN + e) = run;
        run = make_float4(fmaf(d[u], run.x, v[u].x), fmaf(d[u], run.y, v[u].y),
                          fmaf(d[u], run.z, v[u].z), fmaf(d[u], run.w, v[u].w));
      }
  }
  *reinterpret_cast<float4*>(state_out + bh * PN + e) = run;
}

// Phase 3. Grid (head groups of HG x pairs of 64-row tiles, chunks, batch
// rows); warpgroup w takes the chunk's rows [64 mt, 64 mt + 64), mt = 2 mp
// + w. G for those rows and the key blocks sb <= mt stays in registers
// (QT: the chunk's 64-row tiles) while the heads go by; each head's state
// and x tiles land in one buffer while the previous head's products run
// on the others (three buffers where they fit: the tiles of the next two
// heads are in flight). The state tile is read as it lies: the tensor
// cores take its TF32 bits (within 2^-10 of each value), well inside the
// bf16 rule.
//
// W's decay exp(LA_q - LA_s) is factored through the first row m of the
// 16 rows a warp holds: for s < m it is exp(LA_q - LA_m) (two a thread)
// times T_s = exp(LA_m - LA_s) dt_s (the warp's row of factors, m per
// lane), both exponents <= 0 since dt >= 0 and A <= 0 make LA
// non-increasing, so nothing overflows and a factor that underflows bounds
// a product smaller still. Only the warp's diagonal 16 x 16 block takes an
// exp per element (masked above the diagonal); the inter product runs on
// the tensor cores meanwhile.
template <int QT>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_chunk_outputs_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const float* __restrict__ Bm,
                         const float* __restrict__ Cm, const float* __restrict__ states,
                         bf16* __restrict__ y, int S, int H, int P, int N, int Q, int HG,
                         int nbuf) {
  extern __shared__ __align__(16) uint8_t ssd_smem[];
  uint8_t* smem = aligned_smem(ssd_smem);
  const uint32_t sbase = smem_u32(smem);
  const OutputsLayout L = outputs_layout(Q, P, N, nbuf);
  float* LA = reinterpret_cast<float*>(smem + L.la);
  float* DT = reinterpret_cast<float*>(smem + L.dt);
  float* LA_end = reinterpret_cast<float*>(smem + L.end);
  float* T = reinterpret_cast<float*>(smem + L.fac) + (threadIdx.x >> 5) * L.Qp;

  constexpr int MP = (QT + 1) / 2;
  const int mp = blockIdx.x % MP, h0 = (blockIdx.x / MP) * HG;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int nh = min(HG, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int mt = 2 * mp + wg;  // this warpgroup's 64-row tile of the chunk
  const bool active = mt < QT;
  const int qv = min(Q, S - c * Q);
  const size_t t0 = (size_t)b * S + c * Q;
  const size_t xs = (size_t)H * P;
  const int ksteps = L.Np / 8;

  copy_f32(sbase + L.cs, Cm + t0 * N, 128 * mp, L.CR, L.Np, N, qv, tid);
  copy_f32(sbase + L.bs, Bm + t0 * N, 0, L.Qp, L.Np, N, qv, tid);
  cp_async_commit();
  log_decays(LA, DT, LA_end, dt, A, t0, H, h0, nh, qv, L.Qp, tid);
  cp_async_wait<0>();
  round_f32(smem + L.cs, L.CR, L.Np, tid);
  round_f32(smem + L.bs, L.Qp, L.Np, tid);
  fence_proxy_async();
  __syncthreads();

  // G = C B^T for this tile's rows and the key blocks sb <= mt
  const uint32_t c_tile = sbase + L.cs + 64 * wg * 128;  // this tile's rows of C
  const uint32_t b_tile = sbase + L.bs;
  float g[QT][32];
  if (active) {
#pragma unroll
    for (int sb = 0; sb < QT; ++sb)
#pragma unroll
      for (int i = 0; i < 32; ++i) g[sb][i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int sb = 0; sb < QT; ++sb)
      if (sb <= mt)
        for (int kk = 0; kk < ksteps; ++kk)
          wgmma_m64n64k8_tf32_ss(g[sb],
                                 descriptor<64>(c_tile + tile_offset<64>(L.CR, 0, 2 * kk)),
                                 descriptor<64>(b_tile + tile_offset<64>(L.Qp, 64 * sb, 2 * kk)),
                                 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < QT; ++sb) fence_regs(g[sb]);
  }
  __syncthreads();  // every product has read B: its space takes the heads' tiles

  auto issue = [&](int j) {  // head j's tiles into buffer j % nbuf, one commit group
    copy_f32(L.s_tile(sbase, j % nbuf), states + (((size_t)b * nc + c) * H + h0 + j) * P * N, 0,
             L.Pp, L.Np, N, P, tid);
    copy_x(L.x_tile(sbase, j % nbuf), x + t0 * xs + (size_t)(h0 + j) * P, xs, L.Qp, L.Pp, P, qv,
           tid);
    cp_async_commit();
  };
  for (int j = 0; j < nbuf - 1 && j < nh; ++j) issue(j);
  const int r0 = 16 * (warp & 3) + (lane >> 2), cq = 2 * (lane & 3);
  const int qa = 64 * mt + r0, qb = qa + 8;  // this thread's chunk rows
  const int PT = L.Pp / 64;
  const int m = 64 * mt + 16 * (warp & 3);  // the first of this warp's 16 rows
  for (int j = 0; j < nh; ++j) {
    // this thread's copies of head j's tiles have landed (head j + 1's may not)
    if (nbuf > 2 && j + 1 < nh)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();     // head j's tiles are visible; every warp is past head j - 1
    if (j + nbuf - 1 < nh) issue(j + nbuf - 1);  // into head j - 1's buffer
    if (!active) continue;

    const float* la = LA + j * L.Qp;
    const float* dtj = DT + j * L.Qp;
    const uint32_t s_tile = L.s_tile(sbase, j % nbuf);
    const uint32_t x_tile = L.x_tile(sbase, j % nbuf);
    // inter for the first 64 columns of P: C_q . state, the state tile's
    // rows p as B (K-major along n); it runs while W is formed
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk)
      wgmma_m64n64k8_tf32_ss(acc, descriptor<64>(c_tile + tile_offset<64>(L.CR, 0, 2 * kk)),
                             descriptor<64>(s_tile + tile_offset<64>(L.Pp, 0, 2 * kk)), 1);
    wgmma_commit();

    const float la_m = la[m], la_a = la[qa], la_b = la[qb];
    for (int s = lane; s < m; s += 32) T[s] = expf(la_m - la[s]) * dtj[s];
    __syncwarp();
    const float ra = expf(la_a - la_m), rb = expf(la_b - la_m);
    // W's bf16 A fragments: g[sb][4i + e] is row qa + 8 (e / 2), step
    // s = 64 sb + 8i + cq + e % 2; W is 0 for s > q and past qv (dt = 0)
    uint32_t wf[QT][4][4];
#pragma unroll
    for (int sb = 0; sb < QT; ++sb) {
      if (sb > mt || 64 * sb >= qv) continue;
      float wv[32];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = 64 * sb + 8 * i + cq;
        if (s < m) {          // factored (the warp's columns before its rows)
          const float2 t = *reinterpret_cast<const float2*>(T + s);
          wv[4 * i] = g[sb][4 * i] * ra * t.x;
          wv[4 * i + 1] = g[sb][4 * i + 1] * ra * t.y;
          wv[4 * i + 2] = g[sb][4 * i + 2] * rb * t.x;
          wv[4 * i + 3] = g[sb][4 * i + 3] * rb * t.y;
        } else if (s < m + 16) {  // the diagonal block: one exp an element, masked
          const float2 ls = *reinterpret_cast<const float2*>(la + s);
          const float2 ds = *reinterpret_cast<const float2*>(dtj + s);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = (e & 2) ? qb : qa, se = s + (e & 1);
            const float lq = (e & 2) ? la_b : la_a;
            wv[4 * i + e] = se <= q ? g[sb][4 * i + e] * expf(lq - ((e & 1) ? ls.y : ls.x)) *
                                          ((e & 1) ? ds.y : ds.x)
                                    : 0.f;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) wv[4 * i + e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          wf[sb][kk][f] = pack_bf16(wv[8 * kk + 2 * f], wv[8 * kk + 2 * f + 1]);
    }
    const float ea = expf(la_a), eb = expf(la_b);
    bf16* yh = y + t0 * xs + (size_t)(h0 + j) * P;
    for (int pb = 0; pb < PT; ++pb) {
      if (pb > 0) {   // inter for these 64 columns of P
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        wgmma_fence();
        for (int kk = 0; kk < ksteps; ++kk)
          wgmma_m64n64k8_tf32_ss(acc, descriptor<64>(c_tile + tile_offset<64>(L.CR, 0, 2 * kk)),
                                 descriptor<64>(s_tile + tile_offset<64>(L.Pp, 64 * pb, 2 * kk)),
                                 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? eb : ea;
      // intra: + W x over the 64-step blocks that hold real steps
      wgmma_fence();
#pragma unroll
      for (int sb = 0; sb < QT; ++sb) {
        if (sb > mt || 64 * sb >= qv) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs_tb(
              acc, wf[sb][kk],
              descriptor<64>(x_tile + pb * L.Qp * 128 + (64 * sb + 16 * kk) * 128), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // y rows below qv, columns below P, as bf16 pairs
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int q = hr ? qb : qa, p = 64 * pb + 8 * i + cq;
          if (q < qv && p < P)
            *reinterpret_cast<uint32_t*>(yh + (size_t)q * xs + p) =
                pack_bf16(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
        }
    }
    __syncwarp();   // the warp's reads of T are done before the next head writes it
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Set ``kern``'s dynamic shared memory to ``smem`` and pick the heads a CTA
// takes: the fewest that bring the grid (``per_head`` CTAs for each head
// group of one) within one wave of the CTAs the card holds at once, at most
// HG_MAX. The choice moves no bit of the result: every head's arithmetic
// is the same whatever group it is in.
template <class K>
cudaError_t head_group(K kern, size_t smem, long per_head, int H, int& hg) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TC_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long slots = (long)sm_count() * per_sm;
  long want = (per_head * H + slots - 1) / slots;
  want = want < 1 ? 1 : want;
  hg = (int)(want < H ? (want < HG_MAX ? want : HG_MAX) : (H < HG_MAX ? H : HG_MAX));
  return cudaSuccess;
}

bool bf16_shape_ok(int B, int S, int H, int P, int N, int Q) {
  return B > 0 && S > 0 && H > 0 && Q > 0 && Q % 4 == 0 && (Q <= 32 || Q % 32 == 0) &&
         round_up(Q, 64) <= QP_MAX && N > 0 && N % 4 == 0 && P > 0 && P % 8 == 0;
}

template <int QT>
cudaError_t launch_outputs(const bf16* x, const float* dt, const float* A, const float* Bm,
                           const float* Cm, const float* states, bf16* y, int B, int S, int H,
                           int P, int N, int Q, cudaStream_t stream) {
  auto kern = ssd_chunk_outputs_kernel<QT>;
  const int nbuf = outputs_layout(Q, P, N, 3).bytes <= SMEM_MAX ? 3 : 2;
  const size_t smem = outputs_layout(Q, P, N, nbuf).bytes;
  const int nc = (S + Q - 1) / Q, MP = (QT + 1) / 2;
  int hg = 1;
  cudaError_t err = head_group(kern, smem, (long)B * nc * MP, H, hg);
  if (err != cudaSuccess) return err;
  kern<<<dim3(MP * ((H + hg - 1) / hg), nc, B), TC_THREADS, smem, stream>>>(
      x, dt, A, Bm, Cm, states, y, S, H, P, N, Q, hg, nbuf);
  return cudaGetLastError();
}

}  // namespace

// f32 x and y: the CUDA-core kernel. init_state may be null (a zero state).
extern "C" cudaError_t ssd_scan_f32_fwd(const float* x, const float* dt, const float* A,
                                        const float* Bm, const float* Cm,
                                        const float* init_state, float* y, float* state_out,
                                        int B, int S, int H, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q % 4 || (Q > QB && Q % QB) || N <= 0 ||
      N % 4 || P <= 0 || P % 4)
    return cudaErrorInvalidValue;
  return launch<float>(x, dt, A, Bm, Cm, init_state, y, state_out, B, S, H, P, N, Q,
                       static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one CTA of the f32 kernel takes for chunk Q, head
// dim P, state N.
extern "C" int ssd_scan_smem_bytes(int Q, int P, int N) {
  return (int)(sizeof(float) * (size_t)make_layout(Q, P, N).total);
}

// Phase 1 (bf16 x): states (B, nc, H, P, N) f32 gets each chunk's own
// state contribution, decay (B, nc, H) f32 its exp(LA_end).
extern "C" cudaError_t ssd_chunk_states_fwd(const void* x, const float* dt, const float* A,
                                            const float* Bm, float* states, float* decay, int B,
                                            int S, int H, int P, int N, int Q, void* stream) {
  if (!bf16_shape_ok(B, S, H, P, N, Q)) return cudaErrorInvalidValue;
  const size_t smem = states_layout(Q, P, N).bytes;
  const int nc = (S + Q - 1) / Q;
  int hg = 1;
  cudaError_t err = head_group(ssd_chunk_states_kernel, smem, (long)B * nc, H, hg);
  if (err != cudaSuccess) return err;
  ssd_chunk_states_kernel<<<dim3((H + hg - 1) / hg, nc, B), TC_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), dt, A, Bm, states, decay, S, H, P, N, Q, hg);
  return cudaGetLastError();
}

// Phase 2: states' contributions become the states entering each chunk, in
// place; state_out (B, H, P, N) gets the final state. init_state may be
// null (a zero state).
extern "C" cudaError_t ssd_state_passing_fwd(float* states, const float* decay,
                                             const float* init_state, float* state_out, int B,
                                             int nc, int H, int P, int N, void* stream) {
  if (B <= 0 || nc <= 0 || H <= 0 || P <= 0 || N <= 0 || (P * N) % 4) return cudaErrorInvalidValue;
  const int PN = P * N;
  ssd_state_passing_kernel<<<dim3((PN / 4 + 255) / 256, H, B), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(states, decay, init_state,
                                                                  state_out, nc, H, PN);
  return cudaGetLastError();
}

// Phase 3 (bf16 x and y): y from x, dt, A, B, C and the states entering
// each chunk.
extern "C" cudaError_t ssd_chunk_outputs_fwd(const void* x, const float* dt, const float* A,
                                             const float* Bm, const float* Cm,
                                             const float* states, void* y, int B, int S, int H,
                                             int P, int N, int Q, void* stream) {
  if (!bf16_shape_ok(B, S, H, P, N, Q)) return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (round_up(Q, 64) / 64) {
    case 1: return launch_outputs<1>(xb, dt, A, Bm, Cm, states, yb, B, S, H, P, N, Q, s);
    case 2: return launch_outputs<2>(xb, dt, A, Bm, Cm, states, yb, B, S, H, P, N, Q, s);
    case 3: return launch_outputs<3>(xb, dt, A, Bm, Cm, states, yb, B, S, H, P, N, Q, s);
    default: return launch_outputs<4>(xb, dt, A, Bm, Cm, states, yb, B, S, H, P, N, Q, s);
  }
}

// Dynamic shared memory of one CTA of phase 1 and of phase 3.
extern "C" int ssd_chunk_states_smem_bytes(int Q, int P, int N) {
  return states_layout(Q, P, N).bytes;
}
extern "C" int ssd_chunk_outputs_smem_bytes(int Q, int P, int N) {
  const int three = outputs_layout(Q, P, N, 3).bytes;
  return three <= SMEM_MAX ? three : outputs_layout(Q, P, N, 2).bytes;
}
