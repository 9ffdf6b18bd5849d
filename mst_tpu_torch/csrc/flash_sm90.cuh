// The pieces flash_fwd.cu and flash_bwd.cu share on `sm_90a`: the work
// units of a persistent grid, 4-D TMA maps of a [B, H, S, 64] operand with
// any 16-byte strides, the shared-memory layout of a block, and its
// warp-specialised roles.
//
// A block owns one SM (384 threads, `setmaxnreg`): warpgroup 0 is the
// producer, warpgroups 1 and 2 are consumers of 64 rows each. A work unit
// is 128 rows of one (slice, head): a query tile (flash_fwd, dq) or a key
// tile (dk/dv), the tiles of a head on consecutive units, so the blocks
// in flight read the same few heads from L2. The producer's thread 0 loads
// each unit's own boxes into one of two unit buffers, then streams the other
// operand's 64-row boxes (K and V; Q and dO for dk/dv) through a ring of
// STAGES stages, each with a full and an empty `mbarrier`, running ahead
// into the next unit. A box is [64 rows][64] bf16 with 128-byte swizzle, as
// attn_sm90.cuh reads it (K-major for a product over the head dim,
// MN-major for one over the rows); rows past S of the (slice, head) read
// as zeros, without a read of device memory, because the map's row extent
// is S: the ragged tail needs no padding in device memory.
#pragma once

#include "attn_sm90.cuh"

namespace mst {
namespace flash {

using attn::BOX_BYTES;
using attn::HD;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int ROWS = 128;    // rows of a work unit: one per consumer warpgroup row
constexpr int BOX = 64;      // rows of a TMA box: a consumer's rows, a ring stage's
constexpr int CONSUMERS = 2;
constexpr int THREADS = (1 + CONSUMERS) * 128;  // the producer warpgroup + consumers
constexpr int STAGES = 8;    // ring depth
constexpr int LAUNCH_REGS = 168;    // 65,536 / THREADS, rounded down to 8
constexpr int PRODUCER_REGS = 40;   // after `setmaxnreg.dec`
constexpr int CONSUMER_REGS = 232;  // after `setmaxnreg.inc`
constexpr int ALIGN = 1024;  // swizzled boxes at 1024-byte boundaries
constexpr int VEC = 2 * BOX;  // dk/dv: a stage's f32 LSE and delta of its 64 queries
constexpr int BARS = 4 + 2 * STAGES;  // unit full / empty [2] each, ring full / empty
constexpr float LSE_PAD = 1e30f;      // the LSE of a query past S: p = exp2(s - 1e30) = 0
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <= LAUNCH_REGS * THREADS,
              "setmaxnreg moves registers within the block's allocation");

__host__ __device__ inline int tiles(int S) { return (S + ROWS - 1) / ROWS; }
__host__ __device__ inline int boxes(int S) { return (S + BOX - 1) / BOX; }

// Shared memory past the aligned base: two unit buffers of `unit_boxes`
// boxes each, the ring (two boxes a stage), with `vec` the ring's f32 LSE
// and delta rows, then the barriers.
struct Layout {
  size_t unit, ring, vec, bar, total;
};

__host__ __device__ inline Layout layout(int unit_boxes, bool vec) {
  Layout L;
  L.unit = 0;
  L.ring = L.unit + 2 * size_t(unit_boxes) * BOX_BYTES;
  L.vec = L.ring + size_t(STAGES) * 2 * BOX_BYTES;
  L.bar = L.vec + (vec ? size_t(STAGES) * VEC * sizeof(float) : 0);
  L.total = ALIGN + L.bar + BARS * sizeof(uint64_t);
  return L;
}

// The barriers of a block: ufull / uempty of the two unit buffers, full /
// empty of the ring stages.
struct Bars {
  uint64_t *ufull, *uempty, *full, *empty;
};

// Thread 0 initialises the barriers (the ring's full barrier counts
// `full_arrivals`: the producer's expect_tx, and for dk/dv the 32 lanes
// of the warp that stores the stage's LSE and delta); every thread then
// syncs.
__device__ __forceinline__ Bars carve(unsigned char* base, const Layout& L, int full_arrivals) {
  uint64_t* b = reinterpret_cast<uint64_t*>(base + L.bar);
  const Bars bars{b, b + 2, b + 4, b + 4 + STAGES};
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars.ufull[i], 1);
      mbar_init(&bars.uempty[i], CONSUMERS * 4);  // one arrive per consumer warp
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bars.full[i], full_arrivals);
      mbar_init(&bars.empty[i], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bars;
}

__device__ __forceinline__ unsigned char* aligned(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + ALIGN - 1) &
                                          ~uintptr_t(ALIGN - 1));
}

// Work unit u: tile `tile` (fastest) of head h of slice b.
struct Unit {
  int tile, h, b;
  size_t bh;  // b * H + h: the row of [B, H, S] f32 vectors
};

__device__ __forceinline__ Unit unit(int u, int T, int H) {
  const int bh = u / T;
  return Unit{u % T, bh % H, bh / H, size_t(bh)};
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 4-D TMA load of the box at row `row` of head h, slice b (column 0).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int row, int h,
                                            int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(h),
      "r"(b)
      : "memory");
}

// The producer's wait for a free slot: ring counter `it` of a ring of
// `depth` (the first pass finds every slot free).
__device__ __forceinline__ void wait_free(uint64_t* empty, uint32_t it, int depth) {
  mbar_wait(&empty[it % depth], ((it / depth) & 1) ^ 1);
}
__device__ __forceinline__ void wait_full(uint64_t* full, uint32_t it, int depth) {
  mbar_wait(&full[it % depth], (it / depth) & 1);
}

// The consumers' turns (ping-pong): warpgroup c issues a stage's products
// only in its turn, named barrier TURN_BAR + c, which the other warpgroup
// opens once it has issued its own; so one warpgroup's softmax runs while
// the tensor cores work on the other's products, instead of both
// warpgroups, woken by the same full barrier, computing in lockstep.
// Consumer 1 opens consumer 0's first turn; both take the same number of
// turns, and consumer 1 leaves its very last one unpassed.
constexpr int TURN_BAR = 3;  // 0: __syncthreads, 1 + c: wg_sync
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(TURN_BAR + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(TURN_BAR + (c ^ 1)) : "memory");
}

// A consumer warp's release of a slot (lane 0, after the warp's last read).
__device__ __forceinline__ void release(uint64_t* empty, uint32_t it, int depth) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % depth]);
}

// The 128 threads of consumer warpgroup c (named barrier 1 + c).
__device__ __forceinline__ void wg_sync(int c) { sm90::wg_sync(c); }

// Stage a consumer's f32 result (D fragment, 64 x 64) as bf16 in a box it
// has done reading, and store its rows r < rows to dst + r * ld.
__device__ __forceinline__ void store_result(unsigned char* box, int c, int t, const float (&v)[32],
                                             bf16* __restrict__ dst, long long ld, int rows) {
  attn::stage_box(box, t, v);
  wg_sync(c);
  attn::store_box(box, t, dst, size_t(ld), rows);
}

// Order the warpgroup's accesses of its unit boxes before their next TMA
// write, and release the unit buffer.
__device__ __forceinline__ void done_with_unit(const Bars& bars, int c, uint32_t ui) {
  attn::fence_async_smem();
  wg_sync(c);
  release(bars.uempty, ui, 2);
}

// ---- host side ------------------------------------------------------------

// The TMA map of a [B, H, S, 64] bf16 operand with element strides st =
// {slice, head, row} (multiples of 8, a unit column stride), read in [64
// rows][64] boxes with 128-byte swizzle. The row extent is S, so rows past
// S of a (slice, head) read as zeros whatever lies behind them (the next
// slice's rows of a packed qkv). Binds the current device's context first,
// as `sm90::tma_map_2d` does (PyTorch's autograd worker encodes the
// backward's maps before its first launch).
inline cudaError_t tma_map_4d(CUtensorMap* map, const void* ptr, const long long* st, int B, int H,
                              int S) {
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  // a dimension of extent 1 is never stepped: any legal stride will do
  const cuuint64_t strides[3] = {cuuint64_t(S > 1 ? st[2] * 2 : 16),
                                 cuuint64_t(H > 1 ? st[1] * 2 : 16),
                                 cuuint64_t(B > 1 ? st[0] * 2 : 16)};
  const cuuint32_t box[4] = {HD, BOX, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The shapes and strides every flash kernel takes: B, H, S >= 1, the units
// within int32, each stride a multiple of 8 elements (16 bytes).
inline bool shape_ok(const long long* strides, int n, int B, int H, int S) {
  if (B <= 0 || H <= 0 || S <= 0) return false;
  if ((long long)tiles(S) * H * B > INT32_MAX || (long long)B * H * S > INT32_MAX) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

// Refuse a kernel whose register allocation could not serve the
// `setmaxnreg` split (its `inc` would wait for registers that never come),
// raise its shared memory, and give the persistent grid: one block an SM,
// or one a unit where there are fewer.
template <class K>
cudaError_t prepare(K kernel, size_t smem, int units, int* grid) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if (fa.numRegs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS)
    return cudaErrorInvalidConfiguration;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return sm90::persistent_grid(units, grid);
}

// Launch geometry {rows of a unit, rows of a box, tiles, boxes, units,
// grid, threads, stages, dynamic shared memory bytes} of a kernel whose
// unit buffers hold `unit_boxes` boxes (`vec`: with the ring's LSE and
// delta rows).
inline cudaError_t geometry(int B, int H, int S, int unit_boxes, bool vec, int* geo) {
  const long long units = (long long)tiles(S) * H * B;
  if (B <= 0 || H <= 0 || S <= 0 || units > INT32_MAX) return cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = sm90::persistent_grid(int(units), &grid);
  if (err != cudaSuccess) return err;
  const int g[9] = {ROWS, BOX, tiles(S), boxes(S), int(units), grid, THREADS, STAGES,
                    int(layout(unit_boxes, vec).total)};
  for (int i = 0; i < 9; ++i) geo[i] = g[i];
  return cudaSuccess;
}

}  // namespace flash
}  // namespace mst
