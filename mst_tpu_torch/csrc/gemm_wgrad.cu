// gemm_wgrad: dW[K, N] = A[M, K]^T @ B[M, N] and db[N] = sum_m B[m, N], in
// f32 from bf16 A and B.
//
// Replaces the weight- and bias-gradient accumulators of the two Pallas
// backward kernels in mst_tpu/ops/fused_block.py: `_attn_bwd_kernel`
// (dWproj = o^T gz with dbproj, dWqkv = h^T dqkv with dbqkv) and
// `_mlp_bwd_kernel` (dW2 = u^T gz with db2, dW1 = h^T da with db1). The TPU
// kernel carried these f32 sums in VMEM across its sequential grid over the
// slices. Blocks on the H100 run in no order, so the M = N*S rows are cut
// into `splits` chunks: block (n tile, k tile, split) sums its chunk into its
// own f32 partial tile, and a second pass (`sum_partials_kernel`) adds the
// partials in a fixed order, so the result repeats from run to run (no
// atomics).
//
// Bound on the H100: at the ViT-S path shapes (M = 65,792; K x N = 384 x
// 1152, 384 x 384, 1536 x 384, 384 x 1536) the product is 19-78 GFLOP
// against 50-250 MB of reads, compute bound on the tensor cores. The
// reduction axis is M, so the whole [K, N] output is only 9-72 tiles of
// 64 x 128: the split over M is what fills the 132 SMs. A and B stream
// through a cp.async double buffer in 32-row stages (rows past a chunk are
// zero-filled, so they add nothing); A^T is read straight from the
// row-major A tile as a column-major WMMA fragment. The column sums of B
// for the bias ride along in the blocks of the first k tile.
#include "common.cuh"

namespace mst {
namespace {

constexpr int BK = 64;        // rows of dW (the K axis) per block
constexpr int BN = 128;       // columns of dW per block
constexpr int BR = 32;        // rows of A / B (the reduction axis) per stage
constexpr int THREADS = 256;  // 8 warps as 2 (k) x 4 (n), 32x32 each
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

constexpr size_t A_STAGE = size_t(BR) * LDA;  // bf16 elements
constexpr size_t B_STAGE = size_t(BR) * LDB;
constexpr size_t PIPE_BYTES = 2 * (A_STAGE + B_STAGE) * sizeof(bf16);
constexpr size_t C_BYTES = size_t(BK) * LDC * sizeof(float);
constexpr size_t SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

__global__ void __launch_bounds__(THREADS)
gemm_wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                  float* __restrict__ dw_part, float* __restrict__ db_part, int M,
                  int K, int N, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);      // [2][BR][LDA]
  bf16* Bs = As + 2 * A_STAGE;                   // [2][BR][LDB]
  float* Cs = reinterpret_cast<float*>(smem);    // aliases the pipeline

  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BK;
  const int split = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const bool sum_b = blockIdx.y == 0;  // one k tile sums B's columns

  auto load_stage = [&](int st, int buf) {
    const int r0 = r_begin + st * BR;
    bf16* da = As + buf * A_STAGE;
    for (int c = tid; c < BR * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int m = r0 + r;
      const int mc = m < r_end ? m : r_begin;  // keep the address valid
      cp_async16(da + r * LDA + col, a + size_t(mc) * K + k0 + col, m < r_end ? 16 : 0);
    }
    bf16* db = Bs + buf * B_STAGE;
    for (int c = tid; c < BR * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const int m = r0 + r;
      const int mc = m < r_end ? m : r_begin;
      cp_async16(db + r * LDB + col, b + size_t(mc) * N + n0 + col, m < r_end ? 16 : 0);
    }
  };

  const int wm = warp >> 2;
  const int wn = warp & 3;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  float bsum = 0.0f;  // column n0 + tid of B, for tid < BN

  const int nst = r_end > r_begin ? (r_end - r_begin + BR - 1) / BR : 0;
  if (nst > 0) load_stage(0, 0);
  cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) load_stage(st + 1, (st + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ast = As + (st & 1) * A_STAGE;
    const bf16* Bst = Bs + (st & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      // A^T: rows k, columns m; the [m][k] tile read column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Ast + kk * LDA + wm * 32 + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bst + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (sum_b && tid < BN) {
#pragma unroll 8
      for (int r = 0; r < BR; ++r) bsum += __bfloat162float(Bst[r * LDB + tid]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  float* dst = dw_part + size_t(split) * K * N;
  for (int g = tid; g < BK * (BN / 4); g += THREADS) {
    const int r = g / (BN / 4), c = (g % (BN / 4)) * 4;
    *reinterpret_cast<float4*>(dst + size_t(k0 + r) * N + n0 + c) =
        *reinterpret_cast<const float4*>(Cs + r * LDC + c);
  }
  if (sum_b && tid < BN) db_part[size_t(split) * N + n0 + tid] = bsum;
}

}  // namespace
}  // namespace mst

// a [M, K] bf16, b [M, N] bf16 -> dw [K, N] f32 and db [N] f32. work:
// splits * (K * N + N) f32, splits = ceil(M / rows_per_split). Needs
// K % 64 == 0, N % 128 == 0, rows_per_split % 32 == 0.
extern "C" int mst_gemm_wgrad(const void* a, const void* b, void* dw, void* db,
                              void* work, int M, int K, int N, int rows_per_split,
                              void* stream) {
  using namespace mst;
  if (M <= 0 || K % BK != 0 || N % BN != 0 || rows_per_split <= 0 ||
      rows_per_split % BR != 0)
    return cudaErrorInvalidValue;
  const int splits = (M + rows_per_split - 1) / rows_per_split;
  if (splits > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dw_part = static_cast<float*>(work);
  float* db_part = dw_part + size_t(splits) * K * N;
  cudaError_t err = allow_smem(gemm_wgrad_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, K / BK, splits);
  gemm_wgrad_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), dw_part, db_part, M, K,
      N, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_partials(dw_part, static_cast<float*>(dw), splits, K * N, st);
  if (err != cudaSuccess) return err;
  return sum_partials(db_part, static_cast<float*>(db), splits, N, st);
}
