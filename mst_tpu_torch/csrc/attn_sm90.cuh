// The pieces the attention cores mhsa.cu and mhsa_bwd.cu share on `sm_90a`:
// the plan of key (or query) chunks of a slice, 3-D TMA boxes of one
// head's rows, the two wgmma forms they use, the swizzled [64][64] bf16
// boxes they read and stage into, and RoPE on a box in place.
//
// One warpgroup (128 threads) works on 64-row tiles of one (slice, head):
// the m64 of `wgmma`. The other operand of the head (K and V for query
// tiles; Q and dO for key tiles) lies in shared memory whole, one TMA box
// per chunk, each chunk on its own `mbarrier`, so the first chunk's
// products start while the later ones arrive; it is loaded once and serves
// every tile of the head, whose own boxes are double-buffered. A box is [64 rows][64
// columns] bf16 with 128-byte swizzle: row r at byte 128 r, its 16-byte
// chunk c at chunk c ^ (r % 8). Read by wgmma it is either K-major (the
// rows are the m or n index and the 64 columns the reduction: Q, K for
// q.k^T) or MN-major (the rows are the reduction: V for P.V), with the
// descriptors of gemm_sm90.cuh.
//
// The products:
// - `mma_ss`: d[64 x N] (+)= A[64 x 16] . B[16 x N], both from shared
//   memory, A and B K-major; N = 64 (a chunk of keys) or 16 (the tail of a
//   slice, see `Plan`);
// - `mma_rs`: d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (the
//   bf16 pairs of an earlier product's accumulators: the m64nNk16
//   D-fragment of 16 columns is the A fragment of a k step), B MN-major.
// So scores, probabilities and dS never leave the registers.
#pragma once

#include "gemm_sm90.cuh"

namespace mst {
namespace attn {

using sm90::mbar_wait;
using sm90::smem_desc;
using sm90::smem_u32;

constexpr int HD = 64;                 // head dim
constexpr int TILE = 64;               // rows a block owns: one wgmma m64 tile
constexpr int CHUNK = 64;              // rows of the other operand per TMA box
constexpr int TAIL = 16;               // width of a short last chunk
constexpr int THREADS = 128;           // one warpgroup
constexpr int MAX_S = 512;             // FUSED_MAX_TOKENS
constexpr int BOX_BYTES = CHUNK * HD * 2;  // 8 KB
constexpr int TAIL_BYTES = TAIL * HD * 2;  // 2 KB
constexpr int ALIGN = 1024;            // swizzled boxes at 1024-byte boundaries

// A slice of S rows walked in chunks: n64 chunks of 64 rows, then, where
// the last S % 64 rows are 16 or fewer, one chunk of 16 (`tail`): at S =
// 257 the 257th key costs an m64n16 product, 8 registers a thread and a 2
// KB box, not an m64n64 one, 32 and 8 KB. Every chunk is one TMA box (rows
// past S read as zeros, without a read of device memory); chunk b's box
// starts b * 8 KB into its operand's boxes, `operand_bytes` in all.
struct Plan {
  int n64, tail, boxes;
};

__host__ __device__ inline Plan plan(int S) {
  const int full = S / CHUNK, rest = S % CHUNK;
  Plan p;
  p.n64 = full + (rest > TAIL ? 1 : 0);
  p.tail = rest > 0 && rest <= TAIL ? 1 : 0;
  p.boxes = p.n64 + p.tail;
  return p;
}

__host__ __device__ inline size_t operand_bytes(const Plan& p) {
  return size_t(p.n64) * BOX_BYTES + size_t(p.tail) * TAIL_BYTES;
}

__host__ __device__ inline int tiles(int S) { return (S + TILE - 1) / TILE; }

// The tiles of a (slice, head) one block walks in turn: the fewest blocks
// of at most `most` tiles each, the tiles shared out evenly (S = 257: 5
// tiles, in one block of 5 or in blocks of 3 and 2). A block loads the
// other operand once for all of them; fewer tiles a block put more blocks
// in flight (measured on the H100: 5 for the forward, 3 for the backward).
__host__ __device__ inline int tiles_per_block(int S, int most) {
  const int blocks = (tiles(S) + most - 1) / most;
  return (tiles(S) + blocks - 1) / blocks;
}

// ---- PTX ------------------------------------------------------------------

// 3-D TMA load of the box at (c0 column, c1 row, c2 slice).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Order this thread's generic shared-memory accesses before later
// async-proxy ones (wgmma reads, TMA writes) of the same bytes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x by the special-function unit (`ex2.approx.ftz`): exp2f without its
// handling of results below 2^-126, which it flushes to zero; the few
// instructions it saves a score are a fifth of the softmax.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// Descriptors of k step kk (16 deep) of a [64][64] box: K-major (the step
// is 32 bytes along each 128-byte row) or MN-major (16 rows down).
__device__ __forceinline__ uint64_t desc_k(const unsigned char* box, int kk) {
  return smem_desc(box + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* box, int kk) {
  return smem_desc(box + kk * 16 * 128, BOX_BYTES, 1024);
}

// d[64 x 64] (+)= A . B, both K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 16] (+)= A . B, both K-major in shared memory (the tail chunk).
__device__ __forceinline__ void mma_ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A . B, A the bf16 pairs a[4] of this thread, B MN-major.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// r = the four 8 x 8 bf16 matrices at the rows this lane addresses,
// transposed (`ldmatrix .trans`): the B fragments of mma.sync m16n8k16 from
// a row-major [k][n] tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (64 x W, W = 64 or 16) = A . B^T over the head dim: the four k steps of
// a K-major A box and a K-major B box (the caller fences and commits).
template <int R>
__device__ __forceinline__ void product_t(float (&d)[R], const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) mma_ss(d, desc_k(a, kk), desc_k(b, kk), kk);
}

// ---- the D fragment of m64nNk16 -------------------------------------------
// Thread t of the warpgroup holds d[i] at row 16 (t / 32) + (t % 32) / 4 + 8
// ((i / 2) % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2 (gemm_sm90.cuh
// `acc_row` / `acc_col`): two rows, `lo` (i % 4 < 2) and `lo + 8`.
__device__ __forceinline__ int frag_col(int t, int i) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }
__device__ __forceinline__ bool frag_hi(int i) { return (i >> 1) & 1; }

// The A fragment of k step kc of a product whose k index runs over the
// columns of these accumulators: their bf16 pairs, columns 16 kc ..
// 16 kc + 15.
template <int R>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&d)[R], int kc) {
  a[0] = pack_bf16x2(d[8 * kc + 0], d[8 * kc + 1]);
  a[1] = pack_bf16x2(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack_bf16x2(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack_bf16x2(d[8 * kc + 6], d[8 * kc + 7]);
}

// The max and the sum over the 4 lanes of a row of the D fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum of v[0 .. N) as a balanced tree (N a power of two).
template <int N>
__device__ __forceinline__ float tree_sum(float (&v)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) v[k] += v[k + w];
  return v[0];
}

// Byte offset of the 16-byte chunk c of row r in a swizzled box.
__host__ __device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Stage the bf16 of this thread's 64 x 64 f32 values v (D fragment) into
// a box, unswizzled by the reader (`store_box`).
__device__ __forceinline__ void stage_box(unsigned char* box, int t, const float (&v)[32]) {
  const int lo = 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = lo + 8 * frag_hi(i), c = frag_col(t, i);
    *reinterpret_cast<uint32_t*>(box + swz(r, c >> 3) + (c & 7) * 2) =
        pack_bf16x2(v[i], v[i + 1]);
  }
}

// Rows r < rows of a staged box to dst + r * ld (bf16 elements), 16 bytes
// a thread at a time; the caller syncs the warpgroup between the two.
__device__ __forceinline__ void store_box(const unsigned char* box, int t, bf16* __restrict__ dst,
                                          size_t ld, int rows) {
#pragma unroll
  for (int g = t; g < TILE * 8; g += THREADS) {
    const int r = g >> 3, c = g & 7;
    if (r < rows)
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) =
          *reinterpret_cast<const uint4*>(box + swz(r, c));
  }
}

// RoPE on the box in place: row r is sequence position p0 + r (rows at or
// past S hold zeros and stay so); then this thread's writes are ordered
// before the wgmma reads. The caller syncs the warpgroup before those.
__device__ __forceinline__ void rope_box(unsigned char* box, int t, int p0, int S,
                                         const float* __restrict__ rcos,
                                         const float* __restrict__ rsin) {
#pragma unroll
  for (int g = t; g < TILE * 8; g += THREADS) {
    const int r = g >> 3, c = g & 7, p = p0 + r;
    if (p < S) {
      uint4* q = reinterpret_cast<uint4*>(box + swz(r, c));
      *q = rope8(*q, rcos + p * HD + c * 8, rsin + p * HD + c * 8);
    }
  }
  fence_async_smem();
}

// ---- host side ------------------------------------------------------------

// The TMA map of a row-major bf16 [slices, rows, cols] tensor read in
// [1][box_rows][64] boxes with 128-byte swizzle; rows past `rows` of a
// slice read as zeros (a 2-D map over [slices * rows, cols] would read the
// next slice's rows there). Binds the current device's context first, as
// `sm90::tma_map_2d` does.
inline cudaError_t tma_map_3d(CUtensorMap* map, const void* ptr, uint64_t slices, uint64_t rows,
                              uint64_t cols, uint32_t box_rows) {
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cols, rows, slices};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {HD, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace attn
}  // namespace mst
