// Hopper (sm_90a) building blocks in inline PTX, shared by the kernels that
// run their products on the tensor cores: cp.async copies into shared
// memory, mbarriers, a named barrier, the cluster barrier's halves (the
// decode core's combine), setmaxnreg and TMA tensor loads (the
// warp-specialized pipeline of K1's wide-head route), the async-proxy
// fence, the shared-memory matrix descriptors and
// swizzled tile layout that wgmma reads, and the bf16 and TF32 wgmma
// products with f32 accumulators that those kernels issue; and the
// warp-level bf16 mma.sync product with its ldmatrix loads, for products
// too narrow for wgmma's 64 rows (the decode core's query heads).
//
// Tile layout. A tile is R rows of HD bf16 values (R a multiple of 8),
// stored as column blocks of SW bytes per row (SW = 128 when a row has 128
// bytes or more, else 64): block b holds bytes [b*SW, (b+1)*SW) of every
// row, rows SW bytes apart, and within it the 16-byte chunk c of row r sits
// at chunk position c ^ ((r*SW >> 7) & (SW/16 - 1)). That is the 128B (64B)
// swizzle that the hardware applies to address bits [4, 7) from bits
// [7, 10) when the block starts on a 1024-byte (512-byte) boundary, so a
// descriptor with SW's swizzle mode reads the tile as plain row-major
// blocks, and eight rows' chunks at one column fall into eight banks.
// Such a tile is K-major when rows are M or N and columns K (q and k rows,
// hd contiguous), and MN-major when rows are K and columns N (v rows).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro::sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ cp.async
// 16 bytes from global to shared memory, cached in L2 only; src_bytes 0
// reads nothing and writes 16 zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes, as cp_async16.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Order this thread's earlier shared-memory writes (plain stores, landed
// cp.async copies) before later reads by the async proxy, through which
// wgmma reads its operands. A barrier after it makes every thread's writes
// visible to the warpgroup's wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------- mbarrier
// A barrier in shared memory that completes a phase when ``count`` threads
// have arrived and every byte announced by expect_tx has landed. One thread
// inits; fence_mbarrier_init and a CTA barrier publish the init.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Arrive and announce ``bytes`` more of asynchronous copies (TMA) before the
// phase may complete.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Wait until the phase of parity ``parity`` has completed. The thread is
// suspended inside try_wait (up to the hint, 10 ms) instead of spinning, so
// a waiting warp takes no issue slots from the warps that compute. A wait
// that outlasts ~2^32 cycles (over a second) traps, so a broken pipeline
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity), "n"(10000000) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 32)) __trap();
  }
}

// ------------------------------------------------------- named barrier
// bar.sync: wait until ``n`` threads have reached barrier ``id`` (0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------ cluster barrier
// barrier.cluster in two halves: every thread of the cluster arrives, and
// a thread's wait returns once all have arrived. The relaxed arrive orders
// no memory; a pair of them tells a CTA that every CTA of its cluster has
// started, which distributed shared memory asks before a CTA touches
// another's. Not .aligned: a warp need not be converged at either half.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// ------------------------------------------------------------ setmaxnreg
// Hand registers from one warpgroup to another: every warp of the
// warpgroup executes it. The kernel's launch count times its threads is the
// pool the warpgroups share.
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ----------------------------------------------------------------- TMA
// One box of a 4-d tensor map (CUtensorMap in kernel parameter space) into
// shared memory at ``dst``, its bytes reported to the mbarrier ``bar``;
// coordinates innermost first, elements past the tensor's edge land as 0.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// ------------------------------------------------------- tile layout
template <int HD> struct Tile {
  static constexpr int SW = HD * 2 >= 128 ? 128 : 64;  // bytes per row of a column block
  static constexpr int CHUNKS = HD * 2 / 16;          // 16-byte chunks per row
  static constexpr int CPB = SW / 16;                 // chunks per row of a block
  static_assert(HD * 2 % SW == 0, "HD must be 32, 64, 128, ...");
};

// Byte offset of chunk c of row r in a tile of ``rows`` rows.
template <int HD>
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int c) {
  using L = Tile<HD>;
  const int block = c / L::CPB, cc = c % L::CPB;
  return (uint32_t)(block * rows * L::SW + r * L::SW +
                    ((cc ^ ((r * L::SW >> 7) & (L::CPB - 1))) << 4));
}

// The wgmma shared-memory matrix descriptor of an operand that starts at
// shared address ``addr`` inside a tile of Tile<HD>'s layout: 8-row groups
// SW * 8 bytes apart (the stride byte offset), SW's swizzle mode. The
// leading byte offset is unused: each product reads one column block.
template <int HD> __device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  constexpr int SW = Tile<HD>::SW;
  constexpr uint64_t mode = SW == 128 ? 1 : 2;  // 1: 128B swizzle, 2: 64B
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((SW * 8) >> 4) << 32) | (mode << 62);
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin accumulator registers at this point of the program: the compiler
// must not move their reads or writes across it (after wgmma_wait, before
// the next issue).
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Two floats as a bf16x2 register, ``lo`` in the low half (the lower
// column of an A fragment's pair), each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The m64nNk16 f32 accumulator fragment: thread t of the warpgroup holds,
// for each 8-column block i, d[4i + e] at row 16 * (t / 32) + (t % 32) / 4
// + 8 * (e / 2) and column 8i + 2 * (t % 4) + e % 2. A register A fragment
// of m64nNk16 has the same rows and, for the 16 columns of k-step kk, the
// pairs (d[8kk], d[8kk+1]), (d[8kk+2], d[8kk+3]), (d[8kk+4], d[8kk+5]),
// (d[8kk+6], d[8kk+7]) of a 64-column accumulator.

// D (+)= A B, m64n64k16: A (64 x 16) and B (16 x 64, K-major) in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (+)= A B, m64n64k16: A (64 x 16) from registers (the f32 accumulator
// fragment's layout, as bf16 pairs), B (16 x 64, K-major) in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// 2^x on the SFU (ex2.approx, results below 2^-126 flushed to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (+)= A B, m64n64k16: A (64 x 16) from registers (the f32 accumulator
// fragment's layout, as bf16 pairs), B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (+)= A B, m64n32k16: A (64 x 16) from registers (the f32 accumulator
// fragment's layout, as bf16 pairs), B (16 x 32) MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ----------------------------------------------------------------- TF32
// A TF32 tile is a tile of f32 values in the same layout: the 16-byte
// chunks of a row of 32 floats are those of a row of 64 bf16 values, so
// Tile<64>'s offsets and descriptor<64> serve it (128B swizzle). TF32
// products take both operands K-major; one k-step is 8 values, 32 bytes of
// a row, as a bf16 k-step is.

// x rounded to TF32 (10 mantissa bits, nearest, ties away), as an f32 whose
// low 13 bits are zero: what the tensor cores read of a staged operand.
__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// D (+)= A B, m64n64k8 in TF32: A (64 x 8) and B (8 x 64, K-major) in
// shared memory, both TF32 tiles.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}


// ------------------------------------------------------- mma.sync (one warp)
// Four 8 x 8 b16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8 (16 bytes); register j receives matrix j, lane
// t holding (row t / 4, columns 2 (t % 4), +1), or with .trans (rows
// 2 (t % 4), +1, column t / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// D += A B, m16n8k16 bf16 with f32 accumulators. Lane t holds A at rows
// t / 4 (a[0], a[2]) and t / 4 + 8 (a[1], a[3]), columns 2 (t % 4), +1
// (a[0], a[1]) and those + 8 (a[2], a[3]); B at rows (k) 2 (t % 4), +1
// (b0) and those + 8 (b1), column (n) t / 4; D at rows t / 4 (d[0], d[1])
// and t / 4 + 8 (d[2], d[3]), columns 2 (t % 4), +1.
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro::sm90
