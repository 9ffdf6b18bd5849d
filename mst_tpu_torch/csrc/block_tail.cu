// block_tail: everything of a ViT block after its attention core, in one
// launch, for whole rows:
//   x1  = bf16(x + (o @ wproj + bproj))
//   h   = bf16(LN2(x1))
//   a   = bf16(gelu_tanh(bf16(h @ w1 + b1)))
//   out = bf16(x1 + (a @ w2 + b2))
// x, o, out [M, 384] bf16; wproj [384, 384], w1 [384, 1536], w2 [1536, 384]
// bf16 (flax Dense layout); biases and LN2 scale / bias f32.
//
// Replaces the tail of `tools/bench_block_fusion.py` `_block_kernel` (:75,
// queue B row 17): the TPU program runs a whole ViT block per slice (LN1,
// qkv, `_mhsa`, proj, residual, LN2, fc1, GELU, fc2, residual) in VMEM. On
// the H100 a slice's qkv (592 KB at S = 257) exceeds the 232,448 bytes a
// block may hold, and attention needs every key of its slice, so the "one
// kernel per block" form is `ln_gemm` (LN1 + qkv) -> `mhsa` -> this
// kernel: 3 launches a block against the shipped layout's 5 (`ln_gemm` ->
// `mhsa` -> `gemm_residual` -> `ln_gemm` (GELU) -> `gemm_residual`, the
// tool's `_attn_kernel` :67 + `_mlp_kernel` :71). Everything after the
// attention core is row-local, so it fuses: x1 and the [rows, 1536] GELU
// hidden never reach device memory. The rounding points are the tool's
// `_mlp_half`, which rounds fc1 + b1 to bf16 before the GELU (the shipped
// `ln_gemm` takes the GELU of the f32 value and rounds once).
//
// Design (TMA + wgmma, gemm_sm90.cuh's barriers and descriptors): one
// persistent CTA per SM walks units of 64 whole rows (wgmma's m64), with a
// producer warpgroup (one thread issues every TMA load) and two consumer
// warpgroups that split the 384 output columns, 192 each (96 f32
// accumulators a thread, 32 more for a hidden chunk; `setmaxnreg` moves the
// producer's registers to them):
// - the unit's o and x tiles arrive by TMA as six [64][64] boxes each
//   (128-byte swizzle; rows past M read as zeros and are never stored);
// - the weights stay in the flax [K, N] layout, read as MN-major boxes
//   [64 k][64 columns]: the producer keeps each warpgroup's ring of two
//   24 KB stages (three boxes) full across units, in the consumers' order:
//   proj (6 stages of 64 k x 192 columns), then for each of the 12 hidden
//   chunks of 128 columns fc1 (2 stages of 192 k x the warpgroup's 64
//   columns) and fc2 (2 stages of 64 k x 192 columns);
// - proj: m64n192k16 into registers; its epilogue writes x1 over x in
//   shared memory (LN2's input and the last residual); LN2 (8 rows a warp,
//   two-pass f32 statistics) writes h over o's boxes, K-major for fc1;
// - fc1 -> fc2 per chunk: each warpgroup takes its 64 hidden columns
//   (m64n64k16 over K = 384), bf16(acc + b1) -> tanh GELU -> bf16 into its
//   box of a double-buffered [64][128] chunk, then `fence.proxy.async` and a
//   named barrier of the two warpgroups; both accumulate the chunk into
//   their fc2 accumulators (m64n192k16 over K = 128). The [64, 1536]
//   hidden never lies whole in shared or device memory;
// - the last epilogue writes out = bf16(x1 + acc + b2) over x1, then both
//   warpgroups store the tile as 16-byte rows.
// Shared memory: o / h 48 KB, x / x1 48 KB, the chunks 32 KB, the rings 96
// KB: 230,480 bytes with the alignment and barriers, one CTA an SM.
//
// Bound on the H100: at the tool's shape (M = 32,896 rows) the three
// products are 87 GFLOP on 2 x 25 MB of o and x in, 25 MB out and 2.7 MB of
// weights: 0.088 ms by FLOPs against 0.023 ms by bytes of device memory, so
// the tensor cores bound it. Every unit streams all 2.7 MB of weights from
// L2 (514 units: 1.4 GB of L2 reads), but on the card that streaming hides
// behind the consumers (a build that loads no weights runs no faster):
// what paces the kernel is their serial chain a chunk, fc1's products,
// then the GELU epilogue and the barrier while the tensor cores idle, then
// fc2's (PERF.md §6, row 17). A cluster of two CTAs with each
// weight stage multicast to both halves the L2 reads, but with rings two
// stages deep their lockstep made it slower; overlapping a chunk's GELU
// with the previous chunk's fc2 needs deeper rings than the shared memory
// leaves.
#include "attn_sm90.cuh"

namespace mst {
namespace {

namespace tail {

using attn::fence_async_smem;
using attn::fence_regs;
using attn::swz;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_desc;
using sm90::tma_load_2d;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int E = 384;                 // model width
constexpr int F = 1536;                // hidden width
constexpr int ROWS = 64;               // rows of a unit: wgmma's m64
constexpr int HALF = E / 2;            // output columns of a consumer warpgroup
constexpr int CHUNK = 128;             // hidden columns of a chunk, 64 a warpgroup
constexpr int CONSUMERS = 2;           // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + a producer warpgroup
// registers a thread after `setmaxnreg`: the producer's warpgroup gives
// its share to the consumers' 96 + 32 accumulators (128 x 24 + 256 x 240
// <= 65,536)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int BOX = 64 * 64 * 2;       // a [64][64] bf16 box, 128-byte swizzle
constexpr int TILE_BOXES = E / 64;     // a [64][384] tile as six boxes
constexpr int TILE_BYTES = TILE_BOXES * BOX;
// The weights stream in boxes of KB k rows x 64 columns, three a stage:
// the three 64-column groups of an n192 product, or three boxes stacked
// in k for fc1's n64. The two rings hold 96 KB (smaller stages, a deeper
// ring, ran slower on the card; PERF.md §6).
constexpr int KB = 64;                 // k rows of a weight box
constexpr int KSTEPS = KB / 16;        // wgmma k steps of a weight box
constexpr int WBOX = KB * 64 * 2;      // a weight box
constexpr int STAGE = 3 * WBOX;        // a warpgroup's ring stage
constexpr int RING = 48 * 1024 / STAGE;  // stages in a warpgroup's ring
constexpr int PROJ_STAGES = E / KB;    // proj: KB k x 192 columns each
constexpr int FC1_STAGES = E / (3 * KB);  // fc1 of a chunk: 3 KB k x 64 columns each
constexpr int FC2_STAGES = CHUNK / KB;    // fc2 of a chunk: KB k x 192 columns each
constexpr int CHUNKS = F / CHUNK;      // 12
constexpr int CHUNK_STAGES = FC1_STAGES + FC2_STAGES;
constexpr int UNIT_STAGES = PROJ_STAGES + CHUNKS * CHUNK_STAGES;
// shared memory past the 1 KB alignment: o, then h | x, then x1 | two
// chunk buffers of two boxes | the two rings | the barriers (tile full,
// tile empty, then each warpgroup's full and empty barriers)
constexpr size_t A_OFF = 0;
constexpr size_t X_OFF = A_OFF + TILE_BYTES;
constexpr size_t C_OFF = X_OFF + TILE_BYTES;
constexpr size_t R_OFF = C_OFF + 2 * 2 * BOX;
constexpr size_t B_OFF = R_OFF + size_t(CONSUMERS) * RING * STAGE;
constexpr int BARS = 2 + 2 * CONSUMERS * RING;
constexpr size_t SMEM_BYTES = 1024 + B_OFF + BARS * sizeof(uint64_t);  // 230,480

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A K-major, B MN-major (the
// `imm-trans-b` bit set).
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 192] += A[64 x 16] . B[16 x 192]: A K-major, B MN-major in three
// 64-column boxes 8 KB apart (the descriptor's leading byte offset).
__device__ __forceinline__ void mma_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// Reduction index k (a multiple of 16) of a K-major [64 rows][k] tile of
// [64][64] boxes (o / h, a chunk), and the k step kk (16 deep) of an
// MN-major stage (weight boxes stacked in k: a step is 16 rows, 2 KB; the
// three column boxes of an n192 stage WBOX apart).
__device__ __forceinline__ uint64_t desc_a(const unsigned char* tile, int k) {
  return smem_desc(tile + (k >> 6) * BOX + ((k & 63) >> 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_b(const unsigned char* stage, int kk) {
  return smem_desc(stage + kk * 2048, WBOX, 1024);
}

enum Weight : int { W_PROJ = 0, W_FC1 = 1, W_FC2 = 2 };

// Box j (of 3) of a unit's stage i for warpgroup w: its weight, first
// column and first k row.
struct BoxAt {
  int weight, col, row;
};

__device__ __forceinline__ BoxAt box_of(int w, int i, int j) {
  if (i < PROJ_STAGES) return {W_PROJ, w * HALF + 64 * j, KB * i};
  const int c = (i - PROJ_STAGES) / CHUNK_STAGES, r = (i - PROJ_STAGES) % CHUNK_STAGES;
  if (r < FC1_STAGES) return {W_FC1, c * CHUNK + w * 64, KB * (3 * r + j)};
  return {W_FC2, w * HALF + 64 * j, c * CHUNK + KB * (r - FC1_STAGES)};
}

// The TMA maps, 128-byte swizzle: o, x [M, 384] in [64][64] boxes, the
// weights wproj, w1, w2 in their [K, N] layout in [KB][64] boxes.
struct Maps {
  CUtensorMap o, x, w[3];
};

struct Ring {
  unsigned char* stage;  // this warpgroup's RING stages
  uint64_t* full;        // [RING]
  uint64_t* empty;       // [RING]
};

// A stage's slot is free again for this warp.
__device__ __forceinline__ void release(const Ring& ring, int st) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[st]);
}

// d += the product of the next n stages of a warpgroup's ring:
// issue(k, stage, d) issues stage k's wgmmas; one commit group a stage, one
// left in flight, each stage released once its group is done; `it` counts
// the ring's stages.
template <int R, class Issue>
__device__ __forceinline__ void product(const Ring& ring, int n, uint32_t& it, float (&d)[R],
                                        Issue issue) {
  int prev = -1;
  for (int k = 0; k < n; ++k, ++it) {
    const int st = it % RING;
    mbar_wait(&ring.full[st], (it / RING) & 1);
    wgmma_fence();
    issue(k, ring.stage + size_t(st) * STAGE, d);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release(ring, prev);
    }
    prev = st;
  }
  wgmma_wait<0>();
  release(ring, prev);
  fence_regs(d);
}

// gelu_tanh(v) = 0.5 v (1 + tanh u) with u = sqrt(2 / pi) (v + 0.044715
// v^3), the tool's form, taken as v sigmoid(2 u) (the same function): one
// ex2 and one fast division where tanhf spends ~20 instructions; within
// ~1e-6 of tanhf's value, far inside bf16's rounding of the result.
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return __fdividef(v, 1.0f + __expf(-2.0f * u));
}

// The bf16 pair at column col (0..383, even) of row r of a [64][384] tile
// of six swizzled boxes.
__device__ __forceinline__ __nv_bfloat162* tile_pair(unsigned char* tile, int r, int col) {
  return reinterpret_cast<__nv_bfloat162*>(tile + (col >> 6) * BOX + swz(r, (col & 63) >> 3) +
                                           (col & 7) * 2);
}

// Sync the two consumer warpgroups (named barrier 1; the producer
// warpgroup takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// Accumulators that start from the bias of their columns, col0 + the
// fragment's column (i, i + 1: two neighbouring columns of a row): the
// products then sum onto it (the plain version adds it after them, an
// order of f32 sums), so the epilogues load nothing: loads that ptxas
// hoists there sit beside the 128 accumulators and spill.
template <int R>
__device__ __forceinline__ void from_bias(float (&d)[R], const float* __restrict__ bias, int col0,
                                          int t) {
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col0 + sm90::acc_col(t, i)));
    d[i] = bv.x;
    d[i + 1] = bv.y;
  }
  fence_regs(d);
}

// x1 = bf16(x1 + d) in place at this thread's accumulators of warpgroup
// w's 192 columns.
__device__ __forceinline__ void add_residual(unsigned char* tile, const float (&d)[96], int w,
                                             int t) {
#pragma unroll
  for (int i = 0; i < 96; i += 2) {
    __nv_bfloat162* p = tile_pair(tile, sm90::acc_row(t, i), w * HALF + sm90::acc_col(t, i));
    const float2 xv = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(xv.x + d[i], xv.y + d[i + 1]);
  }
}

// LN2 of the 8 rows of consumer warp `warp` (0..7) of x1 into h (over o's
// boxes): two-pass f32 statistics, lane l holding columns 64 i + 2 l.
__device__ __forceinline__ void ln_rows(unsigned char* Xs, unsigned char* As,
                                        const float* __restrict__ ln_s,
                                        const float* __restrict__ ln_b, float eps, int warp,
                                        int lane) {
  float2 sc[TILE_BOXES], sh[TILE_BOXES];
#pragma unroll
  for (int i = 0; i < TILE_BOXES; ++i) {
    sc[i] = __ldg(reinterpret_cast<const float2*>(ln_s + 64 * i + 2 * lane));
    sh[i] = __ldg(reinterpret_cast<const float2*>(ln_b + 64 * i + 2 * lane));
  }
  for (int r = 8 * warp; r < 8 * warp + 8; ++r) {
    float2 v[TILE_BOXES];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < TILE_BOXES; ++i) {
      v[i] = __bfloat1622float2(*tile_pair(Xs, r, 64 * i + 2 * lane));
      sum += v[i].x + v[i].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / E;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < TILE_BOXES; ++i) {
      const float a = v[i].x - mean, b = v[i].y - mean;
      sq += a * a + b * b;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / E + eps);
#pragma unroll
    for (int i = 0; i < TILE_BOXES; ++i)
      *tile_pair(As, r, 64 * i + 2 * lane) =
          __floats2bfloat162_rn((v[i].x - mean) * rstd * sc[i].x + sh[i].x,
                                (v[i].y - mean) * rstd * sc[i].y + sh[i].y);
  }
}

// The consumer warpgroups' side of the kernel.
__device__ __forceinline__ void consume(unsigned char* As, unsigned char* Xs,
                                        unsigned char* Cs, uint64_t* tile_full,
                                        uint64_t* tile_empty, const Ring& ring,
                                        const float* __restrict__ bproj,
                                        const float* __restrict__ ln_s,
                                        const float* __restrict__ ln_b,
                                        const float* __restrict__ b1,
                                        const float* __restrict__ b2, bf16* __restrict__ out,
                                        int M, float eps) {
  const int w = threadIdx.x >> 7;   // consumer warpgroup: output columns 192 w ..
  const int t = threadIdx.x & 127;  // thread of the warpgroup
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = (M + ROWS - 1) / ROWS;
  uint32_t it = 0, k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int m0 = u * ROWS;
    mbar_wait(tile_full, k & 1);

    // proj: x1 = bf16(x + (bproj + o . wproj[:, 192 w ..])) over x
    float d[96];
    from_bias(d, bproj, w * HALF, t);
    product(ring, PROJ_STAGES, it, d, [&](int kt, const unsigned char* st, float (&acc)[96]) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_n192(acc, desc_a(As, KB * kt + 16 * kk), desc_b(st, kk));
    });
    add_residual(Xs, d, w, t);
    consumers_sync();  // x1 is whole, and proj is done with o
    ln_rows(Xs, As, ln_s, ln_b, eps, warp, lane);
    fence_async_smem();  // h is read by wgmma
    consumers_sync();

    // fc1 -> GELU -> fc2, one hidden chunk of 128 columns at a time
    from_bias(d, b2, w * HALF, t);
    for (int c = 0; c < CHUNKS; ++c) {
      float a[32];
      from_bias(a, b1, c * CHUNK + w * 64, t);
      product(ring, FC1_STAGES, it, a, [&](int s, const unsigned char* st, float (&acc)[32]) {
#pragma unroll
        for (int kk = 0; kk < 3 * KSTEPS; ++kk)
          mma_n64(acc, desc_a(As, 3 * KB * s + 16 * kk), desc_b(st, kk));
      });
#pragma unroll
      for (int i = 0; i < 32; ++i) a[i] = gelu_tanh(round_bf16(a[i]));
      // this warpgroup's 64 hidden columns: box w of the chunk's buffer,
      // K-major for fc2 (buffer c % 2: both warpgroups finished fc2 of chunk
      // c - 2 before the barrier of chunk c - 1)
      unsigned char* chunk = Cs + (c & 1) * 2 * BOX;
      attn::stage_box(chunk + w * BOX, t, a);
      fence_async_smem();
      consumers_sync();  // the chunk is whole
      product(ring, FC2_STAGES, it, d, [&](int s, const unsigned char* st, float (&acc)[96]) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          mma_n192(acc, desc_a(chunk, KB * s + 16 * kk), desc_b(st, kk));
      });
    }

    // out = bf16(x1 + (b2 + a . w2)) over x1, then the tile's rows < M
    add_residual(Xs, d, w, t);
    consumers_sync();
    for (int g = threadIdx.x; g < ROWS * (E / 8); g += CONSUMERS * 128) {
      const int r = g / (E / 8), ch = g % (E / 8);
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(out + size_t(m0 + r) * E + ch * 8) =
            *reinterpret_cast<const uint4*>(Xs + (ch >> 3) * BOX + swz(r, ch & 7));
    }
    // every read of the tiles is done before TMA refills them
    fence_async_smem();
    if (lane == 0) mbar_arrive(tile_empty);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
block_tail_kernel(const __grid_constant__ Maps maps, const float* __restrict__ bproj,
                  const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  bf16* __restrict__ out, int M, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* As = base + A_OFF;  // o, then h
  unsigned char* Xs = base + X_OFF;  // x, then x1, then out
  unsigned char* Cs = base + C_OFF;  // the two chunk buffers
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + B_OFF);
  uint64_t* tile_full = bar;
  uint64_t* tile_empty = bar + 1;
  auto ring_of = [&](int w) {
    return Ring{base + R_OFF + size_t(w) * RING * STAGE, bar + 2 + w * RING,
                bar + 2 + CONSUMERS * RING + w * RING};
  };
  const int units = (M + ROWS - 1) / ROWS;
  if (threadIdx.x == 0) {
    mbar_init(tile_full, 1);
    mbar_init(tile_empty, CONSUMERS * 4);  // one arrive a consumer warp
    for (int w = 0; w < CONSUMERS; ++w)
      for (int s = 0; s < RING; ++s) {
        mbar_init(&ring_of(w).full[s], 1);
        mbar_init(&ring_of(w).empty[s], 4);  // one arrive a warp of the warpgroup
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      sm90::tma_prefetch(&maps.o);
      sm90::tma_prefetch(&maps.x);
      for (int i = 0; i < 3; ++i) sm90::tma_prefetch(&maps.w[i]);
      uint32_t it = 0, k = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
        mbar_wait(tile_empty, (k & 1) ^ 1);
        mbar_expect_tx(tile_full, 2 * TILE_BYTES);
        for (int b = 0; b < TILE_BOXES; ++b) {
          tma_load_2d(As + b * BOX, &maps.o, 64 * b, u * ROWS, tile_full);
          tma_load_2d(Xs + b * BOX, &maps.x, 64 * b, u * ROWS, tile_full);
        }
        for (int i = 0; i < UNIT_STAGES; ++i, ++it)
          for (int w = 0; w < CONSUMERS; ++w) {
            const Ring r = ring_of(w);
            const int st = it % RING;
            mbar_wait(&r.empty[st], ((it / RING) & 1) ^ 1);
            mbar_expect_tx(&r.full[st], STAGE);
            for (int j = 0; j < 3; ++j) {
              const BoxAt at = box_of(w, i, j);
              tma_load_2d(r.stage + size_t(st) * STAGE + j * WBOX, &maps.w[at.weight], at.col,
                          at.row, &r.full[st]);
            }
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume(As, Xs, Cs, tile_full, tile_empty, ring_of(threadIdx.x >> 7), bproj, ln_s,
            ln_b, b1, b2, out, M, eps);
  }
}

// The persistent grid: one CTA an SM, or one a unit if there are fewer.
inline int grid_of(int M, int sms) {
  const int units = (M + ROWS - 1) / ROWS;
  return units < sms ? units : sms;
}

// The TMA maps: o and x in [64][64] boxes, the weights in [KB][64].
cudaError_t prepare(const void* o, const void* x, const void* wproj, const void* w1,
                    const void* w2, int M, Maps* maps) {
  cudaError_t err = sm90::tma_map_2d(&maps->o, o, M, E, 64, 64);
  if (err == cudaSuccess) err = sm90::tma_map_2d(&maps->x, x, M, E, 64, 64);
  if (err == cudaSuccess) err = sm90::tma_map_2d(&maps->w[W_PROJ], wproj, E, E, KB, 64);
  if (err == cudaSuccess) err = sm90::tma_map_2d(&maps->w[W_FC1], w1, E, F, KB, 64);
  if (err == cudaSuccess) err = sm90::tma_map_2d(&maps->w[W_FC2], w2, F, E, KB, 64);
  return err;
}

}  // namespace tail
}  // namespace
}  // namespace mst

// o, x [M, 384] bf16 (the attention core's output and the block's input),
// wproj [384, 384], w1 [384, 1536], w2 [1536, 384] bf16, bproj / ln_s /
// ln_b / b2 [384] and b1 [1536] f32 -> out [M, 384] bf16, any M >= 1. E
// and F must be 384 and 1536 (ViT-S, the tool's widths).
extern "C" int mst_block_tail(const void* o, const void* x, const void* wproj, const void* bproj,
                              const void* ln_s, const void* ln_b, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out, int M, int E_, int F_,
                              float eps, void* stream) {
  using namespace mst::tail;
  if (M <= 0 || E_ != E || F_ != F) return cudaErrorInvalidValue;
  Maps maps;
  int sms = 0;
  cudaError_t err = prepare(o, x, wproj, w1, w2, M, &maps);
  if (err == cudaSuccess) err = mst::sm90::sm_count(&sms);
  if (err == cudaSuccess) err = mst::allow_smem(block_tail_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  block_tail_kernel<<<grid_of(M, sms), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(bproj), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<mst::bf16*>(out), M, eps);
  return cudaGetLastError();
}

// The launch geometry of mst_block_tail at M rows on a card of `sms` SMs:
// geo = {rows a unit, units, CTAs, threads, consumer warpgroups, stages a
// warpgroup's ring holds, bytes a stage, stages a unit, dynamic shared
// memory bytes}, as the launch sets them
// (`bench_block_fusion.block_tail_launch` mirrors it).
extern "C" int mst_block_tail_geometry(int M, int sms, int* geo) {
  using namespace mst::tail;
  if (M <= 0 || sms <= 0) return cudaErrorInvalidValue;
  const int g[9] = {ROWS,    (M + ROWS - 1) / ROWS, grid_of(M, sms), THREADS,
                    CONSUMERS, RING, STAGE, UNIT_STAGES, static_cast<int>(SMEM_BYTES)};
  for (int i = 0; i < 9; ++i) geo[i] = g[i];
  return cudaSuccess;
}
