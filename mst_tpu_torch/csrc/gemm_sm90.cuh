// The Hopper GEMM mainloop: C[BM x BN] tiles of A @ B for `sm_90a`, in two
// operand types: bf16 in with f32 accumulators, used by ln_gemm.cu and
// gemm_residual.cu (A K-major, B MN-major), gemm_dgrad.cu (A K-major, B
// K-major) and gemm_wgrad.cu (A MN-major, B MN-major); and int8 in with s32
// accumulators, used by ln_gemm_i8.cu and gemm_i8_residual.cu (A K-major,
// B K-major in two boxes).
// gemm_wgrad.cu's and ln_gemm_i8.cu's probes check each layout with a bare
// product.
//
// Design (one CTA per SM, persistent over the work units):
// - The operands are read by TMA with 128-byte swizzle; a stage holds
//   16 KB of A (BM output rows x 128 bytes of k) and 16 KB of B (128 bytes
//   of k x BN output columns): BK = 64 k of bf16, BK8 = 128 k of int8. A
//   and B come in one of these layouts each (`Major`):
//   A K-major: A [M, K] row-major, one box [BM rows][128 bytes] (the rows
//     of ln_gemm's h, of gemm_dgrad's dY, of the int8 codes);
//   A MN-major: A^T stored [K, M] row-major, two boxes [BK rows][64
//     columns], one per consumer warpgroup (gemm_wgrad's X^T: X [M_red, K]
//     is K-contiguous);
//   B MN-major: B [K, N] row-major, two boxes [BK rows][64 columns] at
//     any two column offsets the caller picks per unit (the flax Dense
//     layout; the two halves of one 128-column panel, or the h1 and h2
//     panels of a gated product), so no transposed copy is made;
//   B K-major: B^T stored [N, K] row-major, one box [BN rows][BK]
//     (gemm_dgrad's W^T: W [K_out, R] is R-contiguous);
//   B K-major pair: B^T [N, K] row-major, two boxes [64 rows][128 bytes]
//     at any two row offsets (ln_gemm_i8's and gemm_i8_residual's W^T,
//     made once with the int8 tree: 8-bit wgmma reads both operands
//     K-major only, and a gated tile takes its h1 and h2 panels); in
//     shared memory the two boxes lie as one [128 rows][128 bytes] K-major
//     box would.
// - A ring of STAGES stages with a full and an empty `mbarrier` each. One
//   producer warp (lane 0) issues the TMA loads, running ahead across
//   units, so the next unit's loads overlap this unit's epilogue.
// - Two consumer warpgroups, each 64 rows of the tile: per 32-byte k step
//   one `wgmma.mma_async` from shared memory, m64n128k16 bf16 (the
//   `imm-trans` bit set for an MN-major operand) or m64n128k32 s8, chosen
//   by the accumulators' type; one commit group per stage, one group left
//   in flight, the stage released once its group is done.
// - A work unit is an output tile and a range of the reduction (`Work`):
//   the whole of K for ln_gemm, gemm_residual, gemm_dgrad, ln_gemm_i8 and
//   gemm_i8_residual, one chunk of the M rows for gemm_wgrad. No split-K
//   within a unit and no atomics: every output is one sum in a fixed
//   order, so a run repeats bit for bit.
// The caller's kernel owns the epilogue: it reads the accumulators through
// `acc_row` / `acc_col` (the m64nNk16 D-fragment layout, the same for s32)
// after `consumer_tile` returns; the bf16 epilogues stage their tile with
// `stage` (or in place) and write it with `store`.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace mst {
namespace sm90 {

constexpr int BM = 128;                       // tile rows
constexpr int BN = 128;                       // tile columns (two 64-wide B boxes)
constexpr int BK = 64;                        // bf16 k per stage (one 128-byte swizzle row)
constexpr int BK8 = 128;                      // int8 k per stage (the same 128 bytes)
constexpr int KSTEPS = 4;                     // wgmma k steps of 32 bytes per stage
constexpr int STAGES = 5;                     // ring depth
constexpr int CONSUMERS = 2;                  // consumer warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BOX = BK * 64 * 2;            // 8 KB: [BK rows][64 columns] or [64 rows][128 B]
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BOX;
constexpr int ACC = BN / 2;                   // f32 or s32 accumulators per thread
constexpr int EPI_LD = BN + 8;                // epilogue staging stride (bf16)
constexpr int EPI_BYTES = 64 * EPI_LD * 2;    // one warpgroup's staging tile
// TMA and wgmma want the swizzled tiles at 1024-byte boundaries; the
// dynamic shared memory base is aligned up to one in the kernel.
constexpr size_t SMEM_BYTES =
    1024 + size_t(STAGES) * STAGE_BYTES + CONSUMERS * EPI_BYTES + 2 * STAGES * 8;

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Block until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 2D TMA load of the box at (c0 inner, c1 outer) into shared memory,
// completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t((smem_u32(p) & 0x3FFFF) >> 4)) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it sees no dependence through the wait).
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]; TA / TB: the `imm-trans-a` /
// `imm-trans-b` bits, 1 for an MN-major operand (ln_gemm: A K-major, B
// MN-major).
template <int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 128] += A[64 x 32] . B[32 x 128] in int8 with s32 accumulators,
// both operands K-major (8-bit wgmma has no transpose bits). No
// `.satfinite`: |d| <= K * 127^2 stays far inside s32 at every K the
// callers take.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// One 32-byte k step of the operand type the accumulators name: bf16
// m64n128k16 into f32, or s8 m64n128k32 into s32.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_step(float (&d)[ACC], uint64_t da, uint64_t db) {
  wgmma_m64n128k16<TA, TB>(d, da, db);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_step(int (&d)[ACC], uint64_t da, uint64_t db) {
  static_assert(TA == 0 && TB == 0, "8-bit wgmma reads both operands K-major");
  wgmma_m64n128k32_s8(d, da, db);
}

// ---- the D-fragment layout of m64nNk16 -----------------------------------
// Thread t of a warpgroup holds d[i] at row 16 * (t / 32) + (t % 32) / 4 +
// 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * (t % 4) + i % 2.

__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// ---- shared memory -------------------------------------------------------

struct Smem {
  unsigned char* stage;  // [STAGES][A | B box 0 | B box 1]
  bf16* epi;             // [CONSUMERS][64][EPI_LD]
  uint64_t* full;        // [STAGES]
  uint64_t* empty;       // [STAGES]
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Smem s;
  s.stage = base;
  s.epi = reinterpret_cast<bf16*>(base + size_t(STAGES) * STAGE_BYTES);
  s.full = reinterpret_cast<uint64_t*>(base + size_t(STAGES) * STAGE_BYTES +
                                       CONSUMERS * EPI_BYTES);
  s.empty = s.full + STAGES;
  return s;
}

// Thread 0 initialises the barriers; every thread must then sync.
__device__ __forceinline__ void init_barriers(const Smem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);                   // the producer's expect_tx
      mbar_init(&s.empty[i], CONSUMERS * 4);      // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// ---- operand layouts -----------------------------------------------------

enum Major : int { K_MAJOR = 0, MN_MAJOR = 1, K_MAJOR_PAIR = 2 };

// One work unit: output rows m0.. (A), the first columns (MN-major) or
// rows (K-major pair) of the two B boxes (K-major B reads one box of BN
// rows from c0), the first reduction index k0 and the number of k tiles.
struct Work {
  int m0, c0, c1, k0, nk;
};

// The stage's A (at `a`) and B (at `b`) for k tile `k` of unit w.
template <int AM, int BMJ>
__device__ __forceinline__ void load_stage(unsigned char* a, unsigned char* b,
                                           const CUtensorMap* ta, const CUtensorMap* tb,
                                           const Work& w, int k, uint64_t* bar) {
  if constexpr (AM == K_MAJOR) {
    tma_load_2d(a, ta, k, w.m0, bar);
  } else {  // A^T [K, M]: the two warpgroups' 64 rows, k rows down
    tma_load_2d(a, ta, w.m0, k, bar);
    tma_load_2d(a + B_BOX, ta, w.m0 + 64, k, bar);
  }
  if constexpr (BMJ == MN_MAJOR) {
    tma_load_2d(b, tb, w.c0, k, bar);
    tma_load_2d(b + B_BOX, tb, w.c1, k, bar);
  } else if constexpr (BMJ == K_MAJOR) {  // B^T [N, K]: BN rows from c0
    tma_load_2d(b, tb, k, w.c0, bar);
  } else {  // B^T [N, K]: 64 rows from c0, then 64 from c1
    tma_load_2d(b, tb, k, w.c0, bar);
    tma_load_2d(b + B_BOX, tb, k, w.c1, bar);
  }
}

// The shared-memory descriptors of k step kk (32 bytes: 16 bf16 or 32
// int8 deep) of the stage's A for warpgroup wg and of its B. K-major
// (either pair too; 128-byte rows, 8-row groups 1024 bytes apart): a k step
// is 32 bytes along the row, the leading byte offset unused. MN-major (rows of 64 MN values, one per k): the two 64-wide
// boxes 8 KB apart (LBO), 8-row k groups 1024 bytes apart (SBO), a k step
// 16 rows. SWAP exchanges LBO and SBO: a planted fault for the layout
// probes of gemm_wgrad.cu, never launched on a path.
template <int AM, bool SWAP>
__device__ __forceinline__ uint64_t desc_a(const unsigned char* a, int wg, int kk) {
  const unsigned char* p = a + wg * (64 * BK * 2) + (AM == K_MAJOR ? kk * 32 : kk * 16 * 128);
  const uint32_t lbo = AM == K_MAJOR ? 16 : B_BOX, sbo = 1024;
  return SWAP ? smem_desc(p, sbo, lbo) : smem_desc(p, lbo, sbo);
}
template <int BMJ, bool SWAP>
__device__ __forceinline__ uint64_t desc_b(const unsigned char* b, int kk) {
  const unsigned char* p = b + (BMJ != MN_MAJOR ? kk * 32 : kk * 16 * 128);
  const uint32_t lbo = BMJ != MN_MAJOR ? 16 : B_BOX, sbo = 1024;
  return SWAP ? smem_desc(p, sbo, lbo) : smem_desc(p, lbo, sbo);
}

// ---- the two roles -------------------------------------------------------

// The producer (lane 0 of the producer warp): the k tiles of every work
// unit this CTA owns, in the consumers' order; `unit(u)` gives unit u's
// `Work`; KS: k per stage (BK for bf16, BK8 for int8).
template <int AM = K_MAJOR, int BMJ = MN_MAJOR, int KS = BK, class Unit>
__device__ __forceinline__ void producer(const Smem& s, const CUtensorMap* ta,
                                         const CUtensorMap* tb, int units, Unit unit) {
  tma_prefetch(ta);
  tma_prefetch(tb);
  uint32_t it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Work w = unit(u);
    for (int kt = 0; kt < w.nk; ++kt, ++it) {
      const int st = it % STAGES;
      mbar_wait(&s.empty[st], ((it / STAGES) & 1) ^ 1);
      unsigned char* dst = s.stage + size_t(st) * STAGE_BYTES;
      mbar_expect_tx(&s.full[st], STAGE_BYTES);
      load_stage<AM, BMJ>(dst, dst + A_BYTES, ta, tb, w, w.k0 + kt * KS, &s.full[st]);
    }
  }
}

struct NoStageHook {
  __device__ __forceinline__ void operator()(const unsigned char*) const {}
};

// One consumer warpgroup's product for one work unit of nk k tiles: d = A[m0
// + 64 wg ..][:] . B[:, the unit's columns], ring counter `it` advanced past
// the unit; f32 accumulators for bf16 operands, s32 for int8 (`Acc`).
// `hook(b)` runs on each stage's B after its products are issued and
// before the stage is released (gemm_wgrad sums dY's columns there).
template <int AM = K_MAJOR, int BMJ = MN_MAJOR, bool SWAP = false, class Hook = NoStageHook,
          class Acc = float>
__device__ __forceinline__ void consumer_tile(const Smem& s, int wg, int nk, uint32_t& it,
                                              Acc (&d)[ACC], Hook hook = Hook()) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = Acc(0);
  fence_acc(d);
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int st = it % STAGES;
    mbar_wait(&s.full[st], (it / STAGES) & 1);
    const unsigned char* a = s.stage + size_t(st) * STAGE_BYTES;
    const unsigned char* b = a + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_step<AM, BMJ == MN_MAJOR>(d, desc_a<AM, SWAP>(a, wg, kk), desc_b<BMJ, SWAP>(b, kk));
    wgmma_commit();
    hook(b);
    if (prev >= 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&s.empty[prev]);
    }
    prev = st;
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(&s.empty[prev]);
  fence_acc(d);
}

// Sync the 128 threads of consumer warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Stage this thread's values v[i] of accumulators i < 4 * JN (JN column
// groups of 8), rounded to bf16, into the warpgroup's [64][EPI_LD] tile.
template <int JN>
__device__ __forceinline__ void stage(bf16* epi, int t, const float (&v)[ACC]) {
#pragma unroll
  for (int i = 0; i < 4 * JN; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(epi + acc_row(t, i) * EPI_LD + acc_col(t, i)) =
        __floats2bfloat162_rn(v[i], v[i + 1]);
}

// Store the staged [64][8 * CH] tile: row r to dst row m0 + r (if < M),
// the 16-byte chunk at tile column c to dst column col(c).
template <int CH, class Col>
__device__ __forceinline__ void store(const bf16* epi, int t, bf16* __restrict__ dst, int ld,
                                      int m0, int M, Col col) {
#pragma unroll
  for (int g = t; g < 64 * CH; g += 128) {
    const int r = g / CH, c = (g % CH) * 8;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(dst + size_t(m0 + r) * ld + col(c)) =
          *reinterpret_cast<const uint4*>(epi + r * EPI_LD + c);
  }
}

// This thread's share of the copies of rows m0 .. m0 + 63, columns n0 ..
// n0 + 127 of the bf16 [M, N] matrix src into the warpgroup's staging tile
// (gemm_residual's x or g, gemm_i8_residual's x, read while the product
// runs); rows past M copy row M - 1 (no output row past M is stored, and
// gemm_dls masks them out of its sums). One commit group.
__device__ __forceinline__ void load_slab(bf16* epi, int t, const bf16* __restrict__ src, int N,
                                          int m0, int n0, int M) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int g = t + 128 * j;
    const int r = g / 16, c = (g % 16) * 8;
    cp_async16(epi + r * EPI_LD + c, src + size_t(min(m0 + r, M - 1)) * N + n0 + c, 16);
  }
  cp_async_commit();
}

// f32 epilogues (gemm_dgrad, gemm_wgrad) stage a warpgroup's accumulators
// 64 columns at a time in its staging tile, as [64][EPI_LD_F] floats.
constexpr int EPI_LD_F = 68;  // 64 columns + 4
static_assert(64 * EPI_LD_F * 4 == EPI_BYTES, "the f32 half tile fills the staging tile");

// Stage this thread's accumulators of tile columns [64 h, 64 h + 64) into
// the warpgroup's f32 tile `epi` (columns relative to 64 h).
__device__ __forceinline__ void stage_f32_half(float* epi, int t, const float (&d)[ACC], int h) {
#pragma unroll
  for (int i = 0; i < ACC / 2; i += 2) {
    const int j = i + h * (ACC / 2);
    *reinterpret_cast<float2*>(epi + acc_row(t, j) * EPI_LD_F + acc_col(t, j) - 64 * h) =
        make_float2(d[j], d[j + 1]);
  }
}

// ---- host side -----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so
// the library links no -lcuda); NULL if the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major bf16 (elem_bytes 2) or int8 (1) [rows, cols]
// matrix read in boxes of [box_rows][box_cols] with 128-byte swizzle
// (box_cols * elem_bytes <= 128); rows past the end read as zeros. The encoding needs a current context, and a
// host thread in which nothing has run on the card yet (PyTorch's autograd
// worker before its first launch) has none: cudaSetDevice binds the
// current device's primary context first.
inline cudaError_t tma_map_2d(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                              uint32_t box_rows, uint32_t box_cols, int elem_bytes = 2) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map,
                         elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The current device's SM count.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// The persistent grid: one CTA per SM, or one per tile if there are fewer.
inline cudaError_t persistent_grid(int tiles, int* grid) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  *grid = tiles < sms ? tiles : sms;
  return cudaSuccess;
}

}  // namespace sm90
}  // namespace mst
