// gemm_i8_residual: out[M, N] = x + ls * (f32(A8 @ W8) [* row scale] *
// col scale + bias), int8 A and W, int32 accumulation, bf16 x and out.
//
// Replaces the second half of three Pallas kernels in
// mst_tpu/ops/fused_int8.py: the proj + LayerScale + residual of
// `_attn_i8_kernel` (K = E), the fc2 of `_mlp_i8_kernel` (K = 4E) and the
// w3 of `_swiglu_i8_kernel` (K = F, 4096 at giant2). As in the Pallas
// bodies the int32 sum becomes f32, is multiplied by the token's scale
// (dynamic trees; NULL for static ones, whose scale was folded into the
// column scale), then by the column scale, the bias is added, then the
// LayerScale multiplies and the f32 value of x is added; one cast to bf16.
// Each product and sum rounds on its own (no FMA), as the plain version's
// separate ops.
//
// Bound on the H100: at the ViT-S path shapes (M = 65,792, N = 384, K = 384
// or 1536) 19-78 G int8 operations against 75-150 MB, operations at
// 1,979 TOP/s; giant2's w3 (K = 4096, N = 1536) 0.83 T against 0.5 GB.
// `gemm_residual`'s design with int8 operands: A and W stream through a
// cp.async double buffer in 64 x 64 and 64 x 128 byte tiles, int8 WMMA
// fragments (16x16x16, int32 accumulators) do the product, the epilogue
// goes through shared memory; both tiles are kept as 16-wide panels so that
// every fragment starts at a 32-byte boundary (see ln_gemm_i8.cu). Ragged
// rows are zero-filled by the copy and masked at the store.
#include "common.cuh"

namespace mst {
namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 8 warps as 2 x 4, 32x32 each
constexpr int LDC = BN + 4;

using s8 = signed char;

constexpr size_t A_STAGE = size_t(BM) * BK;  // bytes: [BK / 16][BM][16]
constexpr size_t B_STAGE = size_t(BN) * BK;  // bytes: [BN / 16][BK][16]
constexpr size_t PIPE_BYTES = 2 * (A_STAGE + B_STAGE);
constexpr size_t C_BYTES = size_t(BM) * LDC * sizeof(int);
constexpr size_t SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

__global__ void __launch_bounds__(THREADS)
gemm_i8_residual_kernel(const s8* __restrict__ a, const s8* __restrict__ w,
                        const float* __restrict__ row_scale, const float* __restrict__ col_scale,
                        const float* __restrict__ bias, const float* __restrict__ ls,
                        const bf16* __restrict__ x, bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  s8* As = reinterpret_cast<s8*>(smem);    // [2][BK/16][BM][16]
  s8* Bs = As + 2 * A_STAGE;               // [2][BN/16][BK][16]
  int* Cs = reinterpret_cast<int*>(smem);  // aliases the pipeline

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  auto load_stage = [&](int kt, int buf) {
    s8* da = As + buf * A_STAGE;
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int r = c / (BK / 16);
      const int p = c % (BK / 16);
      const int m = m0 + r;
      const int mc = m < M ? m : M - 1;  // keep the address valid
      cp_async16(da + (p * BM + r) * 16, a + size_t(mc) * K + size_t(kt) * BK + p * 16,
                 m < M ? 16 : 0);
    }
    s8* db = Bs + buf * B_STAGE;
    const s8* src = w + size_t(kt) * BK * N + n0;
    for (int c = tid; c < BK * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16);
      const int p = c % (BN / 16);
      cp_async16(db + (p * BK + r) * 16, src + size_t(r) * N + p * 16, 16);
    }
  };

  const int wm = warp >> 2;
  const int wn = warp & 3;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const s8* Ast = As + (kt & 1) * A_STAGE;
    const s8* Bst = Bs + (kt & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, s8, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, s8, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Ast + ((kk >> 4) * BM + wm * 32 + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bst + ((wn * 2 + j) * BK + kk) * 16, 16);
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
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int g = tid; g < BM * (BN / 8); g += THREADS) {
    const int r = g / (BN / 8);
    const int c = (g % (BN / 8)) * 8;
    const int m = m0 + r;
    if (m >= M) continue;
    const size_t off = size_t(m) * N + n0 + c;
    const float rsv = row_scale != nullptr ? row_scale[m] : 1.0f;
    float xv[8], v[8];
    unpack8_bf16(*reinterpret_cast<const uint4*>(x + off), xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = n0 + c + e;
      float y = __int2float_rn(Cs[r * LDC + c + e]);
      if (row_scale != nullptr) y = __fmul_rn(y, rsv);
      y = __fadd_rn(__fmul_rn(y, col_scale[n]), bias[n]);
      if (ls != nullptr) y = __fmul_rn(y, ls[n]);
      v[e] = __fadd_rn(xv[e], y);
    }
    *reinterpret_cast<uint4*>(out + off) = pack8_bf16(v);
  }
}

}  // namespace
}  // namespace mst

// a [M, K] int8, w [K, N] int8 (flax Dense layout), row_scale [M] f32 or NULL
// (static), scale / bias [N] f32, ls [N] f32 or NULL (no LayerScale), x [M, N]
// bf16 -> out [M, N] bf16. Needs K % 64 == 0 and N % 128 == 0.
extern "C" int mst_gemm_i8_residual(const void* a, const void* w, const void* row_scale,
                                    const void* scale, const void* bias, const void* ls,
                                    const void* x, void* out, int M, int K, int N,
                                    void* stream) {
  using namespace mst;
  if (M <= 0 || K % BK != 0 || N % BN != 0 || (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gemm_i8_residual_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_i8_residual_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const s8*>(a), static_cast<const s8*>(w),
      static_cast<const float*>(row_scale), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(ls),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), M, K, N);
  return cudaGetLastError();
}
