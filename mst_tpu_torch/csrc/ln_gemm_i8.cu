// ln_gemm_i8: the int8 first half of the W8A8 serving sub-layers,
//   out[M, N] = epilogue(dequant(quant(LN(x))[M, K] @ W8[K, N])),
// x bf16, W8 int8 with a per-output-channel f32 scale, int32 accumulation.
//
// Replaces the LN + first product of three Pallas kernels in
// mst_tpu/ops/fused_int8.py: the LN + qkv of `_attn_i8_kernel` (out bf16),
// the LN + fc1 + GELU of `_mlp_i8_kernel` and, in the gated mode below, the
// LN + w12 + SiLU gate of `_swiglu_i8_kernel`. Rounding follows the Pallas
// bodies op by op (each product and sum rounds on its own, no FMA):
// - LN in f32: two-pass mean / variance, h = (x - mean) * rstd * ln_s + ln_b;
// - dynamic quantization (`_quant_rows`): scale = max(amax_row|h|, 1e-12) *
//   f32(1/127), q = rint(h * (1 / scale)) (round half to even, a product
//   with the correctly rounded reciprocal, as the JAX body multiplies);
//   static (`_quant_static`, the scale folded into ln_s / ln_b upstream):
//   q = clip(rint(h), -127, 127);
// - dequantization: f32(acc) [* row scale] * col scale + bias, in that order;
// - out_mode OUT_BF16: that value in bf16 (the qkv of `_mhsa`); OUT_F32: the
//   GELU (or gate) of it in f32, for `quant_rows` to quantize per token;
//   OUT_I8: the static quantization of it times `*a_inv` (the calibrated
//   hidden scale): clip(rint(u * a_inv), -127, 127).
//
// Gated mode (`mst_ln_gemm_i8_swiglu`): W8 is w12 [K, 2F]; a block owns 64
// gate columns n0..n0+63 and its 128-column W stage holds those columns of
// h1 (left) and of h2 (right), as `ln_gemm`'s GATED mode does; the epilogue
// computes g = h1 * sigmoid(h1) * h2 from the f32 dequantized h12.
//
// Bound on the H100: at the ViT-S path shapes (M = 65,792 tokens, K = 384,
// N = 1152 or 1536) 58-78 G int8 operations against 0.3-0.7 GB moved (the
// f32 GELU output dominates); giant2's w12 (K = 1536, 2F = 8192) 1.66 T
// operations against 1.3 GB. The int8 products are bound by operations at
// 1,979 TOP/s, the f32 outputs by bytes. The design is the one bf16
// `ln_gemm` had before its `ln_rows` + wgmma form (gemm_sm90.cuh): one
// block owns a 64-row tile and normalises and quantizes its whole K-wide row
// tile once into shared memory (64 x K int8 codes, 96 KB at K = 1536, half
// of the bf16 tile), then streams W8 in 64 x 128 chunks through a cp.async
// double buffer; the product runs on int8 WMMA fragments (16x16x16, int32
// accumulators), mma.sync underneath, which reaches only part of the int8
// peak: wgmma is later work. WMMA wants every fragment at a 32-byte
// boundary, which 16 x 16 int8 tiles of a row-major layout are not (they lie
// 16 bytes apart), so A and each W stage are kept as 16-wide panels: panel p
// is a contiguous [rows][16] byte matrix (ldm 16).
#include "common.cuh"

namespace mst {
namespace {

constexpr int BM = 64;        // rows per block
constexpr int BN = 128;       // W columns per block
constexpr int BK = 64;        // W rows per pipeline stage (4 panels deep)
constexpr int THREADS = 256;  // 8 warps as 2 (rows) x 4 (cols), 32x32 each
constexpr int LDC = BN + 4;   // padded int32 epilogue stride
constexpr size_t B_STAGE = size_t(BN) * BK;  // bytes: [BN / 16][BK][16]

enum OutMode : int { OUT_BF16 = 0, OUT_F32 = 1, OUT_I8 = 2 };

using s8 = signed char;

__host__ __device__ inline size_t a_region_bytes(int K) {
  const size_t a = size_t(BM) * K;  // [K / 16][BM][16] codes
  const size_t c = size_t(BM) * LDC * sizeof(int);
  return a > c ? a : c;
}

__host__ __device__ inline size_t smem_bytes(int K) {
  return a_region_bytes(K) + 2 * B_STAGE + BM * sizeof(float);
}

constexpr float INV127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ int clip127(int v) { return v < -127 ? -127 : (v > 127 ? 127 : v); }

// GATED: N is F (the width of out), w has 2N columns (see the file note).
template <bool GATED>
__global__ void __launch_bounds__(THREADS)
ln_gemm_i8_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const s8* __restrict__ w,
                  const float* __restrict__ col_scale, const float* __restrict__ bias,
                  const float* __restrict__ a_inv, void* __restrict__ out, int out_mode,
                  int dynamic, int M, int K, int N, float eps, int act) {
  constexpr int BN_OUT = GATED ? BN / 2 : BN;
  const int ldw = GATED ? 2 * N : N;
  extern __shared__ __align__(128) unsigned char smem[];
  s8* As = reinterpret_cast<s8*>(smem);                                   // [K/16][BM][16]
  int* Cs = reinterpret_cast<int*>(smem);                                 // aliases As
  s8* Bs = reinterpret_cast<s8*>(smem + a_region_bytes(K));               // [2][BN/16][BK][16]
  float* rs = reinterpret_cast<float*>(smem + a_region_bytes(K) + 2 * B_STAGE);  // [BM]

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN_OUT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  auto load_b = [&](int kt, int buf) {
    s8* dst = Bs + buf * B_STAGE;
    const s8* src = w + size_t(kt) * BK * ldw;
    for (int c = tid; c < BK * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16);
      const int p = c % (BN / 16);  // 16-column panel
      const int col = p * 16;
      // gated: the right half of the stage comes from the h2 columns
      const int wcol = (GATED && col >= BN / 2) ? N + n0 + col - BN / 2 : n0 + col;
      cp_async16(dst + (p * BK + r) * 16, src + size_t(r) * ldw + wcol, 16);
    }
  };

  load_b(0, 0);
  cp_async_commit();

  // LN + quantization prologue: one warp per row.
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= M) {
      for (int k = lane; k < K; k += 32) As[((k >> 4) * BM + r) * 16 + (k & 15)] = 0;
      if (lane == 0) rs[r] = 0.0f;
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
      const float d = __fsub_rn(__bfloat162float(xrow[k]), mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / K + eps);
    auto ln = [&](int k) {
      const float d = __fsub_rn(__bfloat162float(xrow[k]), mean);
      return __fadd_rn(__fmul_rn(__fmul_rn(d, rstd), ln_s[k]), ln_b[k]);
    };
    if (dynamic) {
      float amax = 0.0f;
      for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(ln(k)));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = __fmul_rn(fmaxf(amax, 1e-12f), INV127);
      const float inv = __frcp_rn(scale);
      for (int k = lane; k < K; k += 32)
        As[((k >> 4) * BM + r) * 16 + (k & 15)] = static_cast<s8>(__float2int_rn(__fmul_rn(ln(k), inv)));
      if (lane == 0) rs[r] = scale;
    } else {
      for (int k = lane; k < K; k += 32)
        As[((k >> 4) * BM + r) * 16 + (k & 15)] = static_cast<s8>(clip127(__float2int_rn(ln(k))));
    }
  }
  __syncthreads();

  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = K / BK;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_b(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const s8* Bst = Bs + (kt & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const s8* Ap = As + size_t((kt * BK + kk) >> 4) * BM * 16;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, s8, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, s8, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], Ap + (wm * 32 + i * 16) * 16, 16);
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

  // Epilogue through shared memory (the A tile is dead now).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  const float ainv = out_mode == OUT_I8 ? *a_inv : 0.0f;
  // dequantized column n of row r: f32(acc) [* row scale] * col scale + bias
  auto deq = [&](int r, int cs_col, int n) {
    float v = __int2float_rn(Cs[r * LDC + cs_col]);
    if (dynamic) v = __fmul_rn(v, rs[r]);
    return __fadd_rn(__fmul_rn(v, col_scale[n]), bias[n]);
  };
  for (int g = tid; g < BM * (BN_OUT / 8); g += THREADS) {
    const int r = g / (BN_OUT / 8);
    const int c = (g % (BN_OUT / 8)) * 8;
    const int m = m0 + r;
    if (m >= M) continue;
    float v[8];
    if constexpr (GATED) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float h1 = deq(r, c + e, n0 + c + e);
        const float h2 = deq(r, BN_OUT + c + e, N + n0 + c + e);
        v[e] = __fmul_rn(__fmul_rn(h1, 1.0f / (1.0f + expf(-h1))), h2);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = apply_act(deq(r, c + e, n0 + c + e), act);
    }
    const size_t off = size_t(m) * N + n0 + c;
    if (out_mode == OUT_BF16) {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + off) = pack8_bf16(v);
    } else if (out_mode == OUT_F32) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      union {
        uint2 u;
        s8 q[8];
      } pk;
#pragma unroll
      for (int e = 0; e < 8; ++e) pk.q[e] = static_cast<s8>(clip127(__float2int_rn(__fmul_rn(v[e], ainv))));
      *reinterpret_cast<uint2*>(static_cast<s8*>(out) + off) = pk.u;
    }
  }
}

template <bool GATED>
int launch(const void* x, const void* ln_s, const void* ln_b, const void* w, const void* scale,
           const void* bias, const void* a_inv, void* out, int out_mode, int dynamic, int M,
           int K, int N, float eps, int act, void* stream) {
  const size_t smem = smem_bytes(K);
  cudaError_t err = allow_smem(ln_gemm_i8_kernel<GATED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(GATED ? N / (BN / 2) : N / BN, (M + BM - 1) / BM);
  ln_gemm_i8_kernel<GATED><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const s8*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(a_inv), out, out_mode, dynamic, M, K, N, eps, act);
  return cudaGetLastError();
}

bool bad_args(int M, int K, int out_mode, const void* a_inv) {
  return M <= 0 || K % BK != 0 || K > 2048 || (M + BM - 1) / BM > 65535 || out_mode < OUT_BF16 ||
         out_mode > OUT_I8 || (out_mode == OUT_I8 && a_inv == nullptr);
}

}  // namespace
}  // namespace mst

// x [M, K] bf16, ln_s / ln_b [K] f32, w [K, N] int8 (the flax Dense layout),
// scale / bias [N] f32, a_inv [1] f32 or NULL -> out [M, N]: bf16 (OUT_BF16),
// f32 (OUT_F32) or int8 (OUT_I8, needs a_inv); `dynamic` quantizes LN(x) per
// row, else statically. Needs K % 64 == 0, K <= 2048 and N % 128 == 0
// (checked by the Python wrapper as well).
extern "C" int mst_ln_gemm_i8(const void* x, const void* ln_s, const void* ln_b, const void* w,
                              const void* scale, const void* bias, const void* a_inv, void* out,
                              int out_mode, int dynamic, int M, int K, int N, float eps, int act,
                              void* stream) {
  using namespace mst;
  if (bad_args(M, K, out_mode, a_inv) || N % BN != 0) return cudaErrorInvalidValue;
  return launch<false>(x, ln_s, ln_b, w, scale, bias, a_inv, out, out_mode, dynamic, M, K, N,
                       eps, act, stream);
}

// The gated mode: w12 [K, 2F] int8, scale / bias [2F] f32 -> g [M, F] in f32
// (OUT_F32) or int8 (OUT_I8, needs a_inv). Needs K % 64 == 0, K <= 2048 and
// F % 64 == 0.
extern "C" int mst_ln_gemm_i8_swiglu(const void* x, const void* ln_s, const void* ln_b,
                                     const void* w12, const void* scale, const void* bias,
                                     const void* a_inv, void* out, int out_mode, int dynamic,
                                     int M, int K, int F, float eps, void* stream) {
  using namespace mst;
  if (bad_args(M, K, out_mode, a_inv) || out_mode == OUT_BF16 || F <= 0 || F % (BN / 2) != 0)
    return cudaErrorInvalidValue;
  return launch<true>(x, ln_s, ln_b, w12, scale, bias, a_inv, out, out_mode, dynamic, M, K, F,
                      eps, ACT_NONE, stream);
}
