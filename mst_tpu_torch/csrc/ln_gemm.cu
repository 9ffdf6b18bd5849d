// ln_gemm: out[M, N] = act(LN(x)[M, K] @ W[K, N] + b[N]), bf16 in and out.
//
// Replaces the first half of four Pallas kernels in
// mst_tpu/ops/fused_block.py: the LN + qkv projection of `_attn_any_kernel`
// and `_attn_train_kernel` (act = none) and the LN + fc1 + GELU of
// `_mlp_kernel` and `_mlp_train_kernel` (act = gelu tanh or exact erf).
// Rounding follows the Pallas bodies: LN statistics and the normalised row
// in f32, the row cast to bf16 before the product, f32 accumulation, bias
// and activation in f32, one cast to bf16 at the end (serving).
//
// Train mode (two optional outputs, NULL when serving): `h_out` [M, K]
// receives the normalised bf16 row the product used, which the backward
// needs for dW (the blocks of the first column tile write it from shared
// memory, so it costs one store and no recompute); with `out2` [M, N] set,
// `out` receives the pre-activation rounded to bf16 and `out2` the GELU of
// that ROUNDED value, as `_mlp_train_kernel` computes it (the serving body
// takes the GELU of the f32 value).
//
// Bound on the H100: at the ViT-S path shapes (M = 65,792 tokens, K = 384,
// N = 1152 or 1536) the product is ~58-78 GFLOP against ~130-250 MB of
// traffic, so it is compute bound on the tensor cores. The TPU kernel kept
// the whole [S, E] slice and the weights in VMEM; here one block owns a
// 64-row tile: it normalises the whole K-wide row tile once into shared
// memory (64 x K bf16, 49 KB at K = 384), so LN costs no extra pass over
// device memory, and streams W in 32 x 128 chunks through a cp.async double
// buffer. The product runs on bf16 WMMA fragments (16x16x16, f32
// accumulators); the epilogue goes through shared memory so that bias,
// activation and the 16-byte stores see plain row-major data. WGMMA/TMA are
// left for a later tuning pass.
#include "common.cuh"

namespace mst {
namespace {

constexpr int BM = 64;        // rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // W rows per pipeline stage
constexpr int THREADS = 256;  // 8 warps as 2 (rows) x 4 (cols), 32x32 each
constexpr int LDB = BN + 8;   // padded W stage stride (bf16)
constexpr int LDC = BN + 4;   // padded f32 epilogue stride

__host__ __device__ inline size_t a_region_bytes(int K) {
  const size_t a = size_t(BM) * (K + 8) * sizeof(bf16);
  const size_t c = size_t(BM) * LDC * sizeof(float);
  return a > c ? a : c;
}

__host__ __device__ inline size_t smem_bytes(int K) {
  return a_region_bytes(K) + size_t(2) * BK * LDB * sizeof(bf16);
}

__global__ void __launch_bounds__(THREADS)
ln_gemm_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out,
               bf16* __restrict__ h_out, bf16* __restrict__ out2, int M, int K,
               int N, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = K + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);                      // [BM][lda]
  float* Cs = reinterpret_cast<float*>(smem);                    // aliases As
  bf16* Bs = reinterpret_cast<bf16*>(smem + a_region_bytes(K));  // [2][BK][LDB]

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  auto load_b = [&](int kt, int buf) {
    bf16* dst = Bs + buf * BK * LDB;
    const bf16* src = w + size_t(kt) * BK * N + n0;
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8);
      const int col = (c % (BN / 8)) * 8;
      cp_async16(dst + r * LDB + col, src + size_t(r) * N + col, 16);
    }
  };

  // First W stage in flight while the LN prologue runs.
  load_b(0, 0);
  cp_async_commit();

  // LN prologue: one warp per row, two-pass mean / variance in f32.
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    bf16* arow = As + r * lda;
    if (m >= M) {
      for (int k = lane; k < K; k += 32) arow[k] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* xrow = x + size_t(m) * K;
    float sum = 0.0f;
    for (int k = lane; k < K; k += 32) sum += __bfloat162float(xrow[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / K;
    float sq = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float d = __bfloat162float(xrow[k]) - mean;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / K + eps);
    for (int k = lane; k < K; k += 32) {
      const float v = (__bfloat162float(xrow[k]) - mean) * rstd * ln_s[k] + ln_b[k];
      arow[k] = __float2bfloat16(v);
    }
  }
  __syncthreads();
  if (h_out != nullptr && blockIdx.x == 0) {
    for (int c = tid; c < BM * (K / 8); c += THREADS) {
      const int r = c / (K / 8), col = (c % (K / 8)) * 8;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(h_out + size_t(m0 + r) * K + col) =
            *reinterpret_cast<const uint4*>(As + r * lda + col);
    }
  }

  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = K / BK;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_b(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Bst = Bs + (kt & 1) * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * lda + kt * BK + kk, lda);
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

  // Epilogue through shared memory (the A tile is dead now).
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
    float v[8];
    const size_t off = size_t(m) * N + n0 + c;
    if (out2 == nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = apply_act(Cs[r * LDC + c + e] + bias[n0 + c + e], act);
      *reinterpret_cast<uint4*>(out + off) = pack8_bf16(v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Cs[r * LDC + c + e] + bias[n0 + c + e];
      const uint4 pre = pack8_bf16(v);
      *reinterpret_cast<uint4*>(out + off) = pre;
      unpack8_bf16(pre, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = apply_act(v[e], act);
      *reinterpret_cast<uint4*>(out2 + off) = pack8_bf16(v);
    }
  }
}

}  // namespace
}  // namespace mst

// x [M, K] bf16, ln_s / ln_b [K] f32, w [K, N] bf16 (row-major, the flax
// Dense layout), bias [N] f32 -> out [M, N] bf16; h_out [M, K] and out2
// [M, N] bf16 or NULL (train mode, above). Needs K % 32 == 0, K <= 1536 and
// N % 128 == 0 (checked by the Python wrapper as well).
extern "C" int mst_ln_gemm(const void* x, const void* ln_s, const void* ln_b,
                           const void* w, const void* bias, void* out,
                           void* h_out, void* out2, int M, int K, int N,
                           float eps, int act, void* stream) {
  using namespace mst;
  if (M <= 0 || K % BK != 0 || K > 1536 || N % BN != 0 || (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  cudaError_t err = allow_smem(ln_gemm_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  ln_gemm_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<bf16*>(h_out), static_cast<bf16*>(out2), M, K, N, eps, act);
  return cudaGetLastError();
}

// Readable name of a CUDA error code returned by the entry points above.
extern "C" const char* mst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
