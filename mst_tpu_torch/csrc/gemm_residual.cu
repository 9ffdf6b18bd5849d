// gemm_residual: out[M, N] = x[M, N] + ls[N] * (a[M, K] @ W[K, N] + b[N]),
// bf16 in and out, epilogue in f32.
//
// Replaces the second half of two Pallas kernels in
// mst_tpu/ops/fused_block.py: the output projection + LayerScale + residual
// of `_attn_any_kernel` (K = E) and the fc2 + LayerScale + residual of
// `_mlp_kernel` (K = 4E). As in the Pallas bodies the product accumulates in
// f32, bias and LayerScale apply in f32, the residual is added to the f32
// value of x, and the sum is cast to bf16 once.
//
// Bound on the H100: at the ViT-S path shapes (M = 65,792, N = 384,
// K = 384 or 1536) the product is 19-78 GFLOP against 100-250 MB, compute
// bound on the tensor cores. The TPU kept the residual stream in VMEM
// between the product and the add; here the add rides the epilogue, so x is
// read once and y written once, and no f32 intermediate reaches device
// memory. A and W stream through a cp.async double buffer in 64x32 and
// 32x128 tiles; bf16 WMMA fragments (16x16x16, f32 accumulators) do the
// product; ragged rows are zero-filled by the copy and masked at the store.
#include "common.cuh"

namespace mst {
namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;  // 8 warps as 2 x 4, 32x32 each
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

constexpr size_t A_STAGE = size_t(BM) * LDA;  // bf16 elements
constexpr size_t B_STAGE = size_t(BK) * LDB;
constexpr size_t PIPE_BYTES = 2 * (A_STAGE + B_STAGE) * sizeof(bf16);
constexpr size_t C_BYTES = size_t(BM) * LDC * sizeof(float);
constexpr size_t SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

__global__ void __launch_bounds__(THREADS)
gemm_residual_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ ls,
                     const bf16* __restrict__ x, bf16* __restrict__ out, int M,
                     int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][BM][LDA]
  bf16* Bs = As + 2 * A_STAGE;               // [2][BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);  // aliases the pipeline

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  auto load_stage = [&](int kt, int buf) {
    bf16* da = As + buf * A_STAGE;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8);
      const int col = (c % (BK / 8)) * 8;
      const int m = m0 + r;
      const int mc = m < M ? m : M - 1;  // keep the address valid
      cp_async16(da + r * LDA + col, a + size_t(mc) * K + size_t(kt) * BK + col,
                 m < M ? 16 : 0);
    }
    bf16* db = Bs + buf * B_STAGE;
    const bf16* src = w + size_t(kt) * BK * N + n0;
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8);
      const int col = (c % (BN / 8)) * 8;
      cp_async16(db + r * LDB + col, src + size_t(r) * N + col, 16);
    }
  };

  const int wm = warp >> 2;
  const int wn = warp & 3;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ast = As + (kt & 1) * A_STAGE;
    const bf16* Bst = Bs + (kt & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Ast + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bst + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
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
  for (int g = tid; g < BM * (BN / 8); g += THREADS) {
    const int r = g / (BN / 8);
    const int c = (g % (BN / 8)) * 8;
    const int m = m0 + r;
    if (m >= M) continue;
    const size_t off = size_t(m) * N + n0 + c;
    float xv[8], v[8];
    unpack8_bf16(*reinterpret_cast<const uint4*>(x + off), xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float y = Cs[r * LDC + c + e] + bias[n0 + c + e];
      if (ls != nullptr) y *= ls[n0 + c + e];
      v[e] = xv[e] + y;
    }
    *reinterpret_cast<uint4*>(out + off) = pack8_bf16(v);
  }
}

}  // namespace
}  // namespace mst

// a [M, K] bf16, w [K, N] bf16 (flax Dense layout), bias [N] f32, ls [N] f32
// or NULL (no LayerScale), x [M, N] bf16 -> out [M, N] bf16. Needs
// K % 32 == 0 and N % 128 == 0.
extern "C" int mst_gemm_residual(const void* a, const void* w, const void* bias,
                                 const void* ls, const void* x, void* out, int M,
                                 int K, int N, void* stream) {
  using namespace mst;
  if (M <= 0 || K % BK != 0 || N % BN != 0 || (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gemm_residual_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_residual_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(ls),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), M, K, N);
  return cudaGetLastError();
}
