// gemm_i8_residual: out[M, N] = x + ls * (f32(A8 @ W8) [* row scale] *
// col scale + bias), int8 A and W, int32 accumulation, bf16 x and out.
//
// Replaces the second half of three Pallas kernels in
// mst_tpu/ops/fused_int8.py: the proj + LayerScale + residual of
// `_attn_i8_kernel` (K = E), the fc2 of `_mlp_i8_kernel` (K = 4E) and the
// w3 of `_swiglu_i8_kernel` (K = F, 4096 at giant2). As in the Pallas
// bodies the int32 sum becomes f32 (rounded to nearest), is multiplied by
// the token's scale (dynamic trees; NULL for static ones, whose scale was
// folded into the column scale), then by the column scale, the bias is
// added, then the LayerScale multiplies and the f32 value of x is added;
// one cast to bf16. Each product and sum rounds on its own (`__fmul_rn` /
// `__fadd_rn`, never contracted into an FMA), as the plain version's
// separate ops, so on the same codes the output is the plain version's bit
// for bit.
//
// Bound on the H100: at the ViT-S path shapes (M = 65,792, N = 384, K = 384
// or 1536) the 126-227 MB of codes, x and out (0.04-0.07 ms at 3.35 TB/s)
// outweigh the 19-78 G int8 operations; giant2's proj (K = N = 1536, 0.31
// T) and w3 (K = 4096, N = 1536, 0.83 T) are bound by the tensor cores at
// 1,979 TOP/s. The product is the persistent int8 TMA + wgmma mainloop of
// gemm_sm90.cuh, as `ln_gemm_i8`'s: 128 x 128 tiles, a stage 128 k deep,
// both operands K-major (8-bit wgmma reads no other layout), the weights as
// `q8t` = W8^T [N, K] (the K-major copy every int8 tree holds) in two
// 64-row boxes a stage (`K_MAJOR_PAIR`), the whole K in each unit, no
// split-K and no atomics, so a run repeats bit for bit. The epilogue is
// `gemm_residual`'s: before each unit's product every consumer thread
// starts `cp.async` copies of its share of the warpgroup's [64][128] slab
// of x into the warpgroup's staging tile (rows past M copied from row
// M - 1; the row scales past M likewise), so the read of x overlaps the
// product; after it each thread reads x at its accumulators' places,
// writes the bf16 result back in place, and the tile leaves as 16-byte row
// stores masked by row. TMA reads the codes' rows past M as zeros.
#include "gemm_sm90.cuh"

namespace mst {
namespace {

using namespace sm90;

// Output tiles of [M, N]: 128 x 128.
__host__ __device__ inline int i8_residual_tiles(int M, int N) {
  return ((M + BM - 1) / BM) * (N / BN);
}

// K whole 128-deep stages, N whole tiles.
inline bool i8_residual_shape_ok(int M, int K, int N) {
  return M > 0 && K >= BK8 && K % BK8 == 0 && N >= BN && N % BN == 0;
}

// Work unit `tile`: the output rows from m0, the two 64-row boxes of W^T
// at the tile's columns n0 and n0 + 64, the whole K.
__host__ __device__ inline Work i8_residual_work(int tile, int tiles_n, int nk) {
  const int n0 = (tile % tiles_n) * BN;
  return Work{(tile / tiles_n) * BM, n0, n0 + 64, 0, nk};
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_i8_residual_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, const float* __restrict__ rs,
                        const float* __restrict__ cs, const float* __restrict__ bias,
                        const float* __restrict__ ls, const bf16* __restrict__ x,
                        bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  init_barriers(s);
  __syncthreads();
  const int tiles_n = N / BN;
  const int tiles = i8_residual_tiles(M, N);
  const int nk = K / BK8;
  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warp
    if (threadIdx.x == CONSUMERS * 128)
      producer<K_MAJOR, K_MAJOR_PAIR, BK8>(
          s, &ta, &tb, tiles, [=](int tile) { return i8_residual_work(tile, tiles_n, nk); });
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  bf16* epi = s.epi + wg * 64 * EPI_LD;
  uint32_t it = 0;
  int d[ACC];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM + 64 * wg;
    const int n0 = (tile % tiles_n) * BN;
    wg_sync(wg);  // the previous unit's stores have read the staging tile
    load_slab(epi, t, x, N, m0, n0, M);
    consumer_tile<K_MAJOR, K_MAJOR_PAIR>(s, wg, nk, it, d);
    // the thread's two rows, acc_row(t, 0) and 8 below: their scales
    float rsc[2] = {1.0f, 1.0f};
    if (rs != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) rsc[h] = __ldg(rs + min(m0 + acc_row(t, 2 * h), M - 1));
    }
    cp_async_wait<0>();
    wg_sync(wg);  // every thread's copies of x have landed
    // accumulators i, i + 1 (row r) and i + 2, i + 3 (row r + 8) are the
    // same two neighbouring columns c, c + 1
#pragma unroll
    for (int i = 0; i < ACC; i += 4) {
      const int c = acc_col(t, i);
      const float2 cv = __ldg(reinterpret_cast<const float2*>(cs + n0 + c));
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + n0 + c));
      const float2 lv = ls != nullptr ? __ldg(reinterpret_cast<const float2*>(ls + n0 + c))
                                      : make_float2(1.0f, 1.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = i + 2 * h;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(epi + acc_row(t, j) * EPI_LD + c);
        const float2 xv = __bfloat1622float2(*p);
        float y0 = __int2float_rn(d[j]), y1 = __int2float_rn(d[j + 1]);
        if (rs != nullptr) {
          y0 = __fmul_rn(y0, rsc[h]);
          y1 = __fmul_rn(y1, rsc[h]);
        }
        y0 = __fadd_rn(__fmul_rn(y0, cv.x), bv.x);
        y1 = __fadd_rn(__fmul_rn(y1, cv.y), bv.y);
        if (ls != nullptr) {
          y0 = __fmul_rn(y0, lv.x);
          y1 = __fmul_rn(y1, lv.y);
        }
        *p = __floats2bfloat162_rn(__fadd_rn(xv.x, y0), __fadd_rn(xv.y, y1));
      }
    }
    wg_sync(wg);
    store<16>(epi, t, out, N, m0, M, [=](int c) { return n0 + c; });
  }
}

}  // namespace
}  // namespace mst

// a [M, K] int8 codes, wt = W8^T [N, K] int8 (K-major: `QDense.q8t`),
// row_scale [M] f32 (dynamic) or NULL (static), scale / bias [N] f32, ls
// [N] f32 or NULL (no LayerScale), x [M, N] bf16 -> out [M, N] bf16. Needs
// K % 128 == 0 and N % 128 == 0 (checked by the Python wrapper as well).
extern "C" int mst_gemm_i8_residual(const void* a, const void* wt, const void* row_scale,
                                    const void* scale, const void* bias, const void* ls,
                                    const void* x, void* out, int M, int K, int N,
                                    void* stream) {
  using namespace mst;
  using namespace mst::sm90;
  if (!i8_residual_shape_ok(M, K, N)) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err = tma_map_2d(&ta, a, M, K, BM, BK8, 1);
  if (err == cudaSuccess) err = tma_map_2d(&tb, wt, N, K, 64, BK8, 1);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(i8_residual_tiles(M, N), &grid);
  if (err == cudaSuccess) err = allow_smem(gemm_i8_residual_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_i8_residual_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const float*>(row_scale), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(ls),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), M, K, N);
  return cudaGetLastError();
}

// The launch geometry for codes [M, K] -> [M, N] on the current device:
// geo = {tiles, grid, threads, stages, dynamic shared memory bytes, k tiles
// of 128, the first W^T row of tile 0's second box}, as the launch sets
// them (`fused_int8.gemm_i8_residual_launch` mirrors it). The shapes the
// kernel refuses return cudaErrorInvalidValue.
extern "C" int mst_i8_residual_geometry(int M, int K, int N, int* geo) {
  using namespace mst;
  if (!i8_residual_shape_ok(M, K, N)) return cudaErrorInvalidValue;
  const int tiles = i8_residual_tiles(M, N);
  int grid = 0;
  const cudaError_t err = sm90::persistent_grid(tiles, &grid);
  if (err != cudaSuccess) return err;
  const int nk = K / sm90::BK8;
  const int g[7] = {tiles,
                    grid,
                    sm90::THREADS,
                    sm90::STAGES,
                    static_cast<int>(sm90::SMEM_BYTES),
                    nk,
                    i8_residual_work(0, N / sm90::BN, nk).c1};
  for (int i = 0; i < 7; ++i) geo[i] = g[i];
  return cudaSuccess;
}
