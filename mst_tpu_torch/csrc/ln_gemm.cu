// ln_gemm: out[M, N] = act(LN(x)[M, K] @ W[K, N] + b[N]), bf16 in and out.
//
// Replaces the first half of six Pallas kernels in
// mst_tpu/ops/fused_block.py: the LN + qkv projection of `_attn_any_kernel`
// and `_attn_train_kernel` (act = none), the LN + fc1 + GELU of
// `_mlp_kernel` and `_mlp_train_kernel` (act = gelu tanh or exact erf), and
// the LN + w12 + SiLU gate of `_swiglu_kernel` and `_swiglu_train_kernel`
// (the gated mode below).
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
// Gated mode (`GATED`, entry point `mst_ln_gemm_swiglu`): W is w12 [K, 2F]
// and out is g [M, F] = bf16(silu(h1) * h2), h12 = LN(x) @ w12 + b12 in f32,
// h1 its first F columns, h2 its last F. A block owns 64 output columns n0..
// n0+63: its 128-column W stage holds columns [n0, n0+64) of w12 (h1) in its
// left half and [F+n0, F+n0+64) (h2) in its right half, so warps wn = 0-1
// accumulate h1 and wn = 2-3 h2 for the same 64 columns, and the epilogue
// pairs column c of the f32 tile with column c + 64. The shared-memory
// layout is the ungated one (215 KB at K = 1536, one block per SM); two
// separate 128-wide W stages would reach the 227 KB ceiling. The gate runs
// on the f32 h12 with an accurate expf, as `_swiglu_kernel` does (the XLA
// reference `_swiglu_ref` rounds h12 to bf16 first).
//
// Gated train mode (`_swiglu_train_kernel`, queue B row 6): with `h_out`
// and `out2` set, `h_out` receives the bf16 LN(x) as in the ungated train
// mode, `out2` = h12 [M, 2F] the pre-gate rounded to bf16 (h1 at column c,
// h2 at F + c), and the gate g runs on that ROUNDED h12 upcast to f32, as
// `_swiglu_train_kernel` computes it, so that the forward agrees bit for bit
// with what its backward reads. Shared memory is the gated layout; only the
// epilogue's stores grow.
//
// Bound on the H100: at the ViT-S path shapes (M = 65,792 tokens, K = 384,
// N = 1152 or 1536) the product is ~58-78 GFLOP against ~130-250 MB of
// traffic; at giant2's w12 (K = 1536, 2F = 8192) 1.66 TFLOP against
// ~0.77 GB. Both are compute bound on the tensor cores. The TPU kernel kept
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

// GATED: N is F (the width of out), w has 2N columns (see the file note).
template <bool GATED>
__global__ void __launch_bounds__(THREADS)
ln_gemm_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out,
               bf16* __restrict__ h_out, bf16* __restrict__ out2, int M, int K,
               int N, float eps, int act) {
  constexpr int BN_OUT = GATED ? BN / 2 : BN;  // output columns per block
  const int ldw = GATED ? 2 * N : N;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = K + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);                      // [BM][lda]
  float* Cs = reinterpret_cast<float*>(smem);                    // aliases As
  bf16* Bs = reinterpret_cast<bf16*>(smem + a_region_bytes(K));  // [2][BK][LDB]

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN_OUT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  auto load_b = [&](int kt, int buf) {
    bf16* dst = Bs + buf * BK * LDB;
    const bf16* src = w + size_t(kt) * BK * ldw;
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8);
      const int col = (c % (BN / 8)) * 8;
      // gated: the right half of the stage comes from the h2 columns
      const int wcol = (GATED && col >= BN / 2) ? N + n0 + col - BN / 2 : n0 + col;
      cp_async16(dst + r * LDB + col, src + size_t(r) * ldw + wcol, 16);
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
  if constexpr (GATED) {
    for (int g = tid; g < BM * (BN_OUT / 8); g += THREADS) {
      const int r = g / (BN_OUT / 8);
      const int c = (g % (BN_OUT / 8)) * 8;
      const int m = m0 + r;
      if (m >= M) continue;
      float h1[8], h2[8], v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        h1[e] = Cs[r * LDC + c + e] + bias[n0 + c + e];
        h2[e] = Cs[r * LDC + BN_OUT + c + e] + bias[N + n0 + c + e];
      }
      if (out2 != nullptr) {  // train: h12 rounded, the gate from it
        const uint4 p1 = pack8_bf16(h1), p2 = pack8_bf16(h2);
        bf16* hrow = out2 + size_t(m) * 2 * N + n0 + c;
        *reinterpret_cast<uint4*>(hrow) = p1;
        *reinterpret_cast<uint4*>(hrow + N) = p2;
        unpack8_bf16(p1, h1);
        unpack8_bf16(p2, h2);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = h1[e] * (1.0f / (1.0f + expf(-h1[e]))) * h2[e];
      *reinterpret_cast<uint4*>(out + size_t(m) * N + n0 + c) = pack8_bf16(v);
    }
  } else {
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
  cudaError_t err = allow_smem(ln_gemm_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  ln_gemm_kernel<false><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<bf16*>(h_out), static_cast<bf16*>(out2), M, K, N, eps, act);
  return cudaGetLastError();
}

// The gated mode: x [M, K] bf16, ln_s / ln_b [K] f32, w12 [K, 2F] bf16,
// b12 [2F] f32 -> g [M, F] bf16 = bf16(silu(h1) * h2); h_out [M, K] and h12
// [M, 2F] bf16, both or neither: the train mode (above). Needs K % 32 == 0,
// K <= 1536 and F % 64 == 0 (checked by the Python wrapper as well).
extern "C" int mst_ln_gemm_swiglu(const void* x, const void* ln_s, const void* ln_b,
                                  const void* w12, const void* b12, void* out,
                                  void* h_out, void* h12, int M, int K, int F, float eps,
                                  void* stream) {
  using namespace mst;
  if (M <= 0 || K % BK != 0 || K > 1536 || F <= 0 || F % (BN / 2) != 0 ||
      (M + BM - 1) / BM > 65535 || (h_out == nullptr) != (h12 == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  cudaError_t err = allow_smem(ln_gemm_kernel<true>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(F / (BN / 2), (M + BM - 1) / BM);
  ln_gemm_kernel<true><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w12),
      static_cast<const float*>(b12), static_cast<bf16*>(out), static_cast<bf16*>(h_out),
      static_cast<bf16*>(h12), M, K, F, eps, ACT_NONE);
  return cudaGetLastError();
}

// Readable name of a CUDA error code returned by the entry points above.
extern "C" const char* mst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
