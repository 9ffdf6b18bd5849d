// ln_gemm_i8: the int8 first half of the W8A8 serving sub-layers,
//   out[M, N] = epilogue(dequant(quant(LN(x))[M, K] @ W8[K, N])),
// x bf16, W8 int8 with a per-output-channel f32 scale, int32 accumulation,
// as two kernels: `ln_quant_rows` (LN and quantization once per row: the
// codes [M, K] int8 and, for dynamic trees, a row scale [M] f32), then an
// int8 TMA + wgmma GEMM on the codes (`gemm_sm90.cuh`) with the
// dequantization epilogues.
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
// - dequantization: f32(acc) [* row scale] * col scale + bias, in that
//   order, the s32 -> f32 conversion rounded to nearest (|acc| exceeds 2^24
//   at K = 1536);
// - out_mode OUT_BF16: that value in bf16 (the qkv of `_mhsa`); OUT_F32: the
//   GELU (or gate) of it in f32, for `quant_rows` to quantize per token;
//   OUT_I8: the static quantization of it times `*a_inv` (the calibrated
//   hidden scale): clip(rint(u * a_inv), -127, 127).
//
// Gated mode (`mst_gemm_i8_swiglu`): W8 is w12 and a tile owns 64 gate
// columns n0..n0+63: its two W boxes are rows [n0, n0+64) of w12^T (h1) and
// [F+n0, F+n0+64) (h2), so the m64n128 accumulators hold h1 at tile column
// c and h2 at c + 64, which the D-fragment layout gives to the same thread
// (d[i] and d[i + 32]): the gate g = h1 * sigmoid(h1) * h2 runs in
// registers on the f32 dequantized values.
//
// Bound on the H100: `ln_quant_rows` moves 3 * M * K bytes (x in, codes
// out; 0.09 ms at giant2's M = 65,792, K = 1536). The product is bound by
// int8 operations at 1,979 TOP/s: 58-78 G at the ViT-S path shapes (M =
// 65,792 tokens, K = 384, N = 1152 or 1536; the f32 GELU output, 0.4 GB,
// is near that line), 1.66 T at giant2's w12 (K = 1536, 2F = 8192). The
// earlier kernel normalised and quantized a 64-row tile in every block of
// a row, once per 128 output columns, and multiplied on int8 WMMA
// fragments; here the rows are quantized once, and the GEMM is the
// persistent mainloop of gemm_sm90.cuh on int8 (128 x 128 tiles, a stage
// 128 k deep: one 128-byte swizzle row, four wgmma m64n128k32.s32.s8.s8).
// 8-bit wgmma reads both operands K-major only, so W8 is read as W8^T [N,
// K] (the `q8t` the int8 tree holds beside `q8`, made once when the tree is
// built), in two 64-row boxes per stage. TMA reads the codes' rows past M
// as zeros and the stores are masked by row; bf16 and int8 outputs are
// staged per warpgroup so that they leave in 16-byte rows.
#include "gemm_sm90.cuh"

namespace mst {
namespace {

using s8 = signed char;

enum OutMode : int { OUT_BF16 = 0, OUT_F32 = 1, OUT_I8 = 2 };

constexpr float INV127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ int clip127(int v) { return v < -127 ? -127 : (v > 127 ? 127 : v); }

// ---- ln_quant_rows -------------------------------------------------------

constexpr int QR_ROWS = 8;       // rows (warps) per block
constexpr int QR_MAX_K = 4096;   // 16 chunks of 8 a lane

// One warp per row: the row's 16-byte chunks of x stay in registers (at
// most CH per lane), so x is read once; mean, then the variance of the
// centred values, in f32; the amax pass and the code pass each compute h
// from them again (the same bits).
template <int CH>
__global__ void __launch_bounds__(32 * QR_ROWS)
ln_quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, s8* __restrict__ q,
                     float* __restrict__ scale, int M, int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * QR_ROWS + (threadIdx.x >> 5);
  if (m >= M) return;
  const int nc = K / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + size_t(m) * K);
  uint4 v[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (lane + 32 * i < nc) v[i] = __ldg(xr + lane + 32 * i);
  float f[8], sum = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (lane + 32 * i < nc) {
      unpack8_bf16(v[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += f[e];
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / K;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (lane + 32 * i < nc) {
      unpack8_bf16(v[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __fsub_rn(f[e], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / K + eps);
  // h of chunk i: (x - mean) * rstd * ln_s + ln_b, each op rounded alone
  auto ln8 = [&](int i, float (&h)[8]) {
    const int c = 8 * (lane + 32 * i);
    float s[8], b[8];
    *reinterpret_cast<float4*>(s) = __ldg(reinterpret_cast<const float4*>(ln_s + c));
    *reinterpret_cast<float4*>(s + 4) = __ldg(reinterpret_cast<const float4*>(ln_s + c + 4));
    *reinterpret_cast<float4*>(b) = __ldg(reinterpret_cast<const float4*>(ln_b + c));
    *reinterpret_cast<float4*>(b + 4) = __ldg(reinterpret_cast<const float4*>(ln_b + c + 4));
    unpack8_bf16(v[i], h);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      h[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(h[e], mean), rstd), s[e]), b[e]);
  };
  float mul = 1.0f;
  if (scale != nullptr) {
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (lane + 32 * i < nc) {
        ln8(i, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sc = __fmul_rn(fmaxf(amax, 1e-12f), INV127);
    mul = __frcp_rn(sc);
    if (lane == 0) scale[m] = sc;
  }
  uint2* qr = reinterpret_cast<uint2*>(q + size_t(m) * K);
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (lane + 32 * i < nc) {
      ln8(i, f);
      union {
        uint2 u;
        s8 c[8];
      } pk;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        pk.c[e] = static_cast<s8>(scale != nullptr ? __float2int_rn(__fmul_rn(f[e], mul))
                                                   : clip127(__float2int_rn(f[e])));
      qr[lane + 32 * i] = pk.u;
    }
}

template <int CH>
cudaError_t launch_quant(const void* x, const void* ln_s, const void* ln_b, void* q, void* scale,
                         int M, int K, float eps, cudaStream_t st) {
  ln_quant_rows_kernel<CH><<<(M + QR_ROWS - 1) / QR_ROWS, 32 * QR_ROWS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<s8*>(q), static_cast<float*>(scale), M, K,
      eps);
  return cudaGetLastError();
}

// ---- the int8 GEMM and its epilogues -------------------------------------

using namespace sm90;

constexpr int EPI_LD_B = BN + 16;  // int8 staging stride (bytes)
static_assert(64 * EPI_LD_B <= EPI_BYTES, "the int8 tile fits the staging tile");

__host__ __device__ inline int i8_tiles(int M, int N, bool gated) {
  return ((M + BM - 1) / BM) * (N / (gated ? BN / 2 : BN));
}

// Work unit `tile` of the [M, N] output (gated: N = F, 64 gate columns a
// tile, the h2 box F rows further down W^T).
__host__ __device__ inline Work i8_work(int tile, int tiles_n, int N, int nk, bool gated) {
  const int tn = tile % tiles_n;
  const int bn = gated ? BN / 2 : BN;
  return Work{(tile / tiles_n) * BM, tn * bn, gated ? N + tn * bn : tn * bn + 64, 0, nk};
}

// GATED: N is F (the width of out), W^T has 2N rows (see the file note).
template <bool GATED, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
gemm_i8_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const float* __restrict__ rs, const float* __restrict__ cs,
               const float* __restrict__ bias, const float* __restrict__ a_inv,
               void* __restrict__ out, int M, int K, int N, int act) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  init_barriers(s);
  __syncthreads();
  constexpr int BN_OUT = GATED ? BN / 2 : BN;  // output columns per tile
  const int tiles_n = N / BN_OUT;
  const int tiles = i8_tiles(M, N, GATED);
  const int nk = K / BK8;
  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warp
    if (threadIdx.x == CONSUMERS * 128)
      producer<K_MAJOR, K_MAJOR_PAIR, BK8>(
          s, &ta, &tb, tiles, [=](int tile) { return i8_work(tile, tiles_n, N, nk, GATED); });
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  unsigned char* epi = reinterpret_cast<unsigned char*>(s.epi) + wg * EPI_BYTES;
  const float ainv = MODE == OUT_I8 ? __ldg(a_inv) : 0.0f;
  uint32_t it = 0;
  int d[ACC];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    consumer_tile<K_MAJOR, K_MAJOR_PAIR>(s, wg, nk, it, d);
    const int m0 = (tile / tiles_n) * BM + 64 * wg;
    const int n0 = (tile % tiles_n) * BN_OUT;
    // tile column c -> column of W (and of the scales): the gated tile's
    // right half is the h2 panel
    auto wcol = [=](int c) { return GATED && c >= 64 ? N + n0 + c - 64 : n0 + c; };
    // the thread's two rows, acc_row(t, 0) and 8 below: their scales
    float rsc[2] = {1.0f, 1.0f};
    if (rs != nullptr) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = m0 + acc_row(t, 2 * j);
        rsc[j] = m < M ? __ldg(rs + m) : 0.0f;
      }
    }
    float v[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int col = wcol(acc_col(t, i));
      float u = __int2float_rn(d[i]);
      if (rs != nullptr) u = __fmul_rn(u, rsc[(i >> 1) & 1]);
      v[i] = __fadd_rn(__fmul_rn(u, __ldg(cs + col)), __ldg(bias + col));
    }
    if constexpr (GATED) {  // h1 in v[i], h2 in v[i + ACC / 2]
#pragma unroll
      for (int i = 0; i < ACC / 2; ++i)
        v[i] = __fmul_rn(__fmul_rn(v[i], 1.0f / (1.0f + expf(-v[i]))), v[i + ACC / 2]);
    } else {
#pragma unroll
      for (int i = 0; i < ACC; ++i) v[i] = apply_act(v[i], act);
    }
    wg_sync(wg);  // the previous tile's stores have read the staging tile
    if constexpr (MODE == OUT_BF16) {
      bf16* eb = reinterpret_cast<bf16*>(epi);
      stage<BN_OUT / 8>(eb, t, v);
      wg_sync(wg);
      store<BN_OUT / 8>(eb, t, static_cast<bf16*>(out), N, m0, M,
                        [=](int c) { return n0 + c; });
    } else if constexpr (MODE == OUT_F32) {
      float* ef = reinterpret_cast<float*>(epi);
      float* o = static_cast<float*>(out);
#pragma unroll
      for (int h = 0; h < BN_OUT / 64; ++h) {
        if (h) wg_sync(wg);
        stage_f32_half(ef, t, v, h);
        wg_sync(wg);
#pragma unroll
        for (int g = t; g < 64 * 16; g += 128) {
          const int r = g / 16, c = (g % 16) * 4;
          if (m0 + r < M)
            *reinterpret_cast<float4*>(o + size_t(m0 + r) * N + n0 + 64 * h + c) =
                *reinterpret_cast<const float4*>(ef + r * EPI_LD_F + c);
        }
      }
    } else {  // OUT_I8
#pragma unroll
      for (int i = 0; i < BN_OUT / 2; i += 2)
        *reinterpret_cast<char2*>(epi + acc_row(t, i) * EPI_LD_B + acc_col(t, i)) =
            make_char2(static_cast<s8>(clip127(__float2int_rn(__fmul_rn(v[i], ainv)))),
                       static_cast<s8>(clip127(__float2int_rn(__fmul_rn(v[i + 1], ainv)))));
      wg_sync(wg);
      constexpr int CHB = BN_OUT / 16;  // 16-byte chunks of a row
      s8* o = static_cast<s8*>(out);
#pragma unroll
      for (int g = t; g < 64 * CHB; g += 128) {
        const int r = g / CHB, c = (g % CHB) * 16;
        if (m0 + r < M)
          *reinterpret_cast<uint4*>(o + size_t(m0 + r) * N + n0 + c) =
              *reinterpret_cast<const uint4*>(epi + r * EPI_LD_B + c);
      }
    }
  }
}

template <bool GATED, int MODE>
cudaError_t launch_gemm(const void* a, const void* wt, const void* rs, const void* cs,
                        const void* bias, const void* a_inv, void* out, int M, int K, int N,
                        int act, cudaStream_t st) {
  CUtensorMap ta, tb;
  cudaError_t err = tma_map_2d(&ta, a, M, K, BM, BK8, 1);
  if (err == cudaSuccess) err = tma_map_2d(&tb, wt, GATED ? 2 * N : N, K, 64, BK8, 1);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(i8_tiles(M, N, GATED), &grid);
  if (err == cudaSuccess) err = allow_smem(gemm_i8_kernel<GATED, MODE>, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_i8_kernel<GATED, MODE><<<grid, THREADS, SMEM_BYTES, st>>>(
      ta, tb, static_cast<const float*>(rs), static_cast<const float*>(cs),
      static_cast<const float*>(bias), static_cast<const float*>(a_inv), out, M, K, N, act);
  return cudaGetLastError();
}

// The GEMM's shapes: K a whole number of 128-deep stages, N whole tiles
// (gated: F whole 64-column tiles).
inline bool gemm_shape_ok(int M, int K, int N, bool gated) {
  const int bn = gated ? BN / 2 : BN;
  return M > 0 && K >= BK8 && K % BK8 == 0 && N >= bn && N % bn == 0;
}

// The layout probe (`mst_gemm_i8_probe`): a bare int8 product c[M, N] s32 =
// a[M, K] . b[N, K]^T on this mainloop, for chip_smoke.py to hold against
// an exact product before any epilogue is trusted. SWAP exchanges the
// descriptors' leading and stride byte offsets: a planted fault that must
// fail (a wrong pair reads numbers that look plausible). No path of the
// package launches it.
template <bool SWAP>
__global__ void __launch_bounds__(THREADS, 1)
probe_i8_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                int* __restrict__ c, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  init_barriers(s);
  __syncthreads();
  const int tiles_n = N / BN;
  const int tiles = i8_tiles(M, N, false);
  const int nk = K / BK8;
  if (threadIdx.x >= CONSUMERS * 128) {
    if (threadIdx.x == CONSUMERS * 128)
      producer<K_MAJOR, K_MAJOR_PAIR, BK8>(
          s, &ta, &tb, tiles, [=](int tile) { return i8_work(tile, tiles_n, N, nk, false); });
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  uint32_t it = 0;
  int d[ACC];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    consumer_tile<K_MAJOR, K_MAJOR_PAIR, SWAP>(s, wg, nk, it, d);
    const int m0 = (tile / tiles_n) * BM + 64 * wg;
    const int n0 = (tile % tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int m = m0 + acc_row(t, i);
      if (m < M) c[size_t(m) * N + n0 + acc_col(t, i)] = d[i];
    }
  }
}

template <bool SWAP>
cudaError_t launch_probe(const void* a, const void* b, int* c, int M, int N, int K,
                         cudaStream_t st) {
  CUtensorMap ta, tb;
  cudaError_t err = tma_map_2d(&ta, a, M, K, BM, BK8, 1);
  if (err == cudaSuccess) err = tma_map_2d(&tb, b, N, K, 64, BK8, 1);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(i8_tiles(M, N, false), &grid);
  if (err == cudaSuccess) err = allow_smem(probe_i8_kernel<SWAP>, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  probe_i8_kernel<SWAP><<<grid, THREADS, SMEM_BYTES, st>>>(ta, tb, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mst

// x [M, K] bf16, ln_s / ln_b [K] f32 -> q [M, K] int8, the codes of LN(x):
// with `scale` [M] f32 set the dynamic per-row codes and scales, with it
// NULL the static codes clip(rint(LN(x)), -127, 127). Needs K % 8 == 0 and
// K <= 4096.
extern "C" int mst_ln_quant_rows(const void* x, const void* ln_s, const void* ln_b, void* q,
                                 void* scale, int M, int K, float eps, void* stream) {
  using namespace mst;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_lane = (K / 8 + 31) / 32;  // 16-byte chunks per lane
  if (M <= 0 || K <= 0 || K % 8 != 0 || K > QR_MAX_K) return cudaErrorInvalidValue;
  if (per_lane <= 2) return launch_quant<2>(x, ln_s, ln_b, q, scale, M, K, eps, st);
  if (per_lane <= 4) return launch_quant<4>(x, ln_s, ln_b, q, scale, M, K, eps, st);
  if (per_lane <= 6) return launch_quant<6>(x, ln_s, ln_b, q, scale, M, K, eps, st);
  if (per_lane <= 8) return launch_quant<8>(x, ln_s, ln_b, q, scale, M, K, eps, st);
  return launch_quant<16>(x, ln_s, ln_b, q, scale, M, K, eps, st);
}

// a [M, K] int8 codes, row_scale [M] f32 (dynamic) or NULL (static), wt =
// W8^T [N, K] int8 (K-major), scale / bias [N] f32, a_inv [1] f32 or NULL
// -> out [M, N]: bf16 (OUT_BF16), f32 (OUT_F32) or int8 (OUT_I8, needs
// a_inv), the activation `act` taken first. Needs K % 128 == 0 and
// N % 128 == 0 (checked by the Python wrapper as well).
extern "C" int mst_gemm_i8(const void* a, const void* wt, const void* row_scale,
                           const void* scale, const void* bias, const void* a_inv, void* out,
                           int out_mode, int M, int K, int N, int act, void* stream) {
  using namespace mst;
  if (!gemm_shape_ok(M, K, N, false) || (out_mode == OUT_I8 && a_inv == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_mode) {
    case OUT_BF16:
      return launch_gemm<false, OUT_BF16>(a, wt, row_scale, scale, bias, a_inv, out, M, K, N,
                                          act, st);
    case OUT_F32:
      return launch_gemm<false, OUT_F32>(a, wt, row_scale, scale, bias, a_inv, out, M, K, N,
                                         act, st);
    case OUT_I8:
      return launch_gemm<false, OUT_I8>(a, wt, row_scale, scale, bias, a_inv, out, M, K, N,
                                        act, st);
    default: return cudaErrorInvalidValue;
  }
}

// The gated mode: wt = w12^T [2F, K] int8, scale / bias [2F] f32 -> g [M,
// F] in f32 (OUT_F32) or int8 (OUT_I8, needs a_inv). Needs K % 128 == 0 and
// F % 64 == 0.
extern "C" int mst_gemm_i8_swiglu(const void* a, const void* wt, const void* row_scale,
                                  const void* scale, const void* bias, const void* a_inv,
                                  void* out, int out_mode, int M, int K, int F, void* stream) {
  using namespace mst;
  if (!gemm_shape_ok(M, K, F, true) || (out_mode == OUT_I8 && a_inv == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_mode) {
    case OUT_F32:
      return launch_gemm<true, OUT_F32>(a, wt, row_scale, scale, bias, a_inv, out, M, K, F,
                                        ACT_NONE, st);
    case OUT_I8:
      return launch_gemm<true, OUT_I8>(a, wt, row_scale, scale, bias, a_inv, out, M, K, F,
                                       ACT_NONE, st);
    default: return cudaErrorInvalidValue;
  }
}

// The launch geometry of the int8 GEMM for codes [M, K] -> N (gated: N = F)
// on the current device: geo = {tiles, grid, threads, stages, dynamic shared
// memory bytes, k tiles of 128, the first W^T row of tile 0's second box
// (gated: F, the h2 panel; else 64), ln_quant_rows's blocks}, as the
// launches set them (`fused_int8.ln_gemm_i8_launch` mirrors it). The shapes
// the GEMM refuses return cudaErrorInvalidValue.
extern "C" int mst_gemm_i8_geometry(int M, int K, int N, int gated, int* geo) {
  using namespace mst;
  if (!gemm_shape_ok(M, K, N, gated != 0)) return cudaErrorInvalidValue;
  const int tiles = i8_tiles(M, N, gated != 0);
  int grid = 0;
  const cudaError_t err = persistent_grid(tiles, &grid);
  if (err != cudaSuccess) return err;
  const int nk = K / sm90::BK8;
  const int g[8] = {tiles,
                    grid,
                    sm90::THREADS,
                    sm90::STAGES,
                    static_cast<int>(sm90::SMEM_BYTES),
                    nk,
                    i8_work(0, N / (gated ? sm90::BN / 2 : sm90::BN), N, nk, gated != 0).c1,
                    (M + QR_ROWS - 1) / QR_ROWS};
  for (int i = 0; i < 8; ++i) geo[i] = g[i];
  return cudaSuccess;
}

// a [M, K], b [N, K] int8 -> c [M, N] int32 = a . b^T on the int8 mainloop;
// swap != 0: the planted instance with LBO and SBO exchanged. Needs K %
// 128 == 0 and N % 128 == 0.
extern "C" int mst_gemm_i8_probe(const void* a, const void* b, void* c, int M, int N, int K,
                                 int swap, void* stream) {
  using namespace mst;
  if (!gemm_shape_ok(M, K, N, false)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(c);
  return swap ? launch_probe<true>(a, b, out, M, N, K, st)
              : launch_probe<false>(a, b, out, M, N, K, st);
}
