// ln_gemm: out[M, N] = act(LN(x)[M, K] @ W[K, N] + b[N]), bf16 in and out,
// as two kernels: `ln_rows` (LN once per row, h = bf16(LN(x)) [M, K]), then
// a TMA + wgmma GEMM on h (`gemm_sm90.cuh`) with the bias / activation /
// SiLU-gate epilogue.
//
// Replaces the first half of six Pallas kernels in
// mst_tpu/ops/fused_block.py: the LN + qkv projection of `_attn_any_kernel`
// (:326) and `_attn_train_kernel` (:424) (act = none), the LN + fc1 + GELU
// of `_mlp_kernel` (:400) and `_mlp_train_kernel` (:470) (act = gelu tanh or
// exact erf), and the LN + w12 + SiLU gate of `_swiglu_kernel` (:534) and
// `_swiglu_train_kernel` (:498) (the gated mode below). Those bodies
// normalise the slice in VMEM and feed the MXU from there; on the H100 the
// normalised rows make one round trip through device memory instead.
// Rounding follows the Pallas bodies: LN statistics and the normalised row
// in f32, the row cast to bf16 before the product, f32 accumulation, bias
// and activation in f32, one cast to bf16 at the end (serving).
//
// Train mode (`out2` set, or `h12` for the gated form): the wrapper keeps h,
// which the backward needs for dW; `out` receives the pre-activation rounded
// to bf16 and `out2` the GELU of that ROUNDED value, as `_mlp_train_kernel`
// computes it (the serving body takes the GELU of the f32 value).
//
// Gated mode (`mst_gemm_swiglu`): W is w12 [K, 2F] and out is g [M, F] =
// bf16(silu(h1) * h2), h12 = h @ w12 + b12 in f32, h1 its first F columns,
// h2 its last F. A tile owns 64 output columns n0..n0+63: its two B boxes
// are columns [n0, n0+64) of w12 (h1) and [F+n0, F+n0+64) (h2), so the
// m64n128 accumulators hold h1 at tile column c and h2 at c + 64, which the
// D-fragment layout gives to the same thread (d[i] and d[i + 32]): the gate
// runs in registers. It takes the f32 h12 with an accurate expf, as
// `_swiglu_kernel` does (the XLA reference `_swiglu_ref` rounds h12 to bf16
// first). Gated train mode (`_swiglu_train_kernel`, queue B row 6): `h12`
// [M, 2F] receives the pre-gate rounded to bf16 (h1 at column c, h2 at
// F + c), and the gate runs on that ROUNDED h12, so that the forward agrees
// bit for bit with what its backward reads.
//
// Bound on the H100: `ln_rows` moves 2 * M * K * 2 bytes (0.12 ms at
// giant2's M = 65,792, K = 1536). The product is compute bound on the
// tensor cores: ~58-78 GFLOP at ViT-S's qkv / fc1 (K = 384), 1.66 TFLOP at
// giant2's w12 (K = 1536, 2F = 8192). The GEMM's design (persistent CTAs,
// a 5-stage TMA ring, two wgmma consumer warpgroups, 128 x 128 tiles) is in
// gemm_sm90.cuh; its epilogue stages each warpgroup's bf16 tile in shared
// memory so that the stores are 16 bytes wide, masked by row (TMA reads
// the rows past M as zeros).
#include "gemm_sm90.cuh"

namespace mst {
namespace {

// ---- ln_rows -------------------------------------------------------------

constexpr int LN_ROWS = 8;  // rows (warps) per block

// One warp per row: the row's 16-byte chunks stay in registers (at most CH
// per lane), so x is read once; mean, then the variance of the centred
// values, in f32.
template <int CH>
__global__ void __launch_bounds__(32 * LN_ROWS)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, bf16* __restrict__ h, int M, int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
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
        const float d = f[e] - mean;
        sq += d * d;
      }
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / K + eps);
  uint4* hr = reinterpret_cast<uint4*>(h + size_t(m) * K);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane + 32 * i;
    if (c < nc) {
      float s[8], b[8];
      unpack8_bf16(v[i], f);
      *reinterpret_cast<float4*>(s) = __ldg(reinterpret_cast<const float4*>(ln_s + 8 * c));
      *reinterpret_cast<float4*>(s + 4) = __ldg(reinterpret_cast<const float4*>(ln_s + 8 * c + 4));
      *reinterpret_cast<float4*>(b) = __ldg(reinterpret_cast<const float4*>(ln_b + 8 * c));
      *reinterpret_cast<float4*>(b + 4) = __ldg(reinterpret_cast<const float4*>(ln_b + 8 * c + 4));
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = (f[e] - mean) * rstd * s[e] + b[e];
      hr[c] = pack8_bf16(f);
    }
  }
}

template <int CH>
cudaError_t launch_ln_rows(const void* x, const void* ln_s, const void* ln_b, void* h, int M,
                           int K, float eps, cudaStream_t st) {
  ln_rows_kernel<CH><<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(h), M, K, eps);
  return cudaGetLastError();
}

// ---- the GEMM and its epilogues -----------------------------------------

using namespace sm90;

// GATED: N is F (the width of out), w has 2N columns (see the file note);
// ACT: the activation of the ungated form.
template <bool GATED, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_ln_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const float* __restrict__ bias, bf16* __restrict__ out, bf16* __restrict__ out2,
               int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  init_barriers(s);
  __syncthreads();
  constexpr int BN_OUT = GATED ? BN / 2 : BN;  // output columns per tile
  const int tiles_n = N / BN_OUT;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int nk = K / BK;
  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warp
    if (threadIdx.x == CONSUMERS * 128)
      producer(s, &ta, &tb, tiles, [=](int tile) {
        const int tn = tile % tiles_n;
        return Work{(tile / tiles_n) * BM, tn * BN_OUT,
                    GATED ? N + tn * BN_OUT : tn * BN_OUT + 64, 0, nk};
      });
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  bf16* epi = s.epi + wg * 64 * EPI_LD;
  uint32_t it = 0;
  float d[ACC];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    consumer_tile(s, wg, nk, it, d);
    const int m0 = (tile / tiles_n) * BM + 64 * wg;
    const int n0 = (tile % tiles_n) * BN_OUT;
    // tile column c -> column of W (and of h12): the gated tile's right
    // half is the h2 panel
    auto wcol = [=](int c) { return GATED && c >= 64 ? N + n0 + c - 64 : n0 + c; };
#pragma unroll
    for (int i = 0; i < ACC; ++i) d[i] += __ldg(bias + wcol(acc_col(t, i)));
    wg_sync(wg);  // the previous tile's stores have read the staging tile
    // train (out2 set): the pre-activation (gated: h12, to out2) is stored
    // rounded, and the activation (gate) runs on the rounded value
    if (out2 != nullptr) {
      stage<16>(epi, t, d);
      wg_sync(wg);
      store<16>(epi, t, GATED ? out2 : out, GATED ? 2 * N : N, m0, M, wcol);
      wg_sync(wg);
#pragma unroll
      for (int i = 0; i < ACC; ++i) d[i] = round_bf16(d[i]);
    }
    if constexpr (GATED) {  // h1 in d[i], h2 in d[i + ACC / 2]
#pragma unroll
      for (int i = 0; i < ACC / 2; ++i)
        d[i] = d[i] * (1.0f / (1.0f + expf(-d[i]))) * d[i + ACC / 2];
      stage<8>(epi, t, d);
      wg_sync(wg);
      store<8>(epi, t, out, N, m0, M, [=](int c) { return n0 + c; });
    } else {
#pragma unroll
      for (int i = 0; i < ACC; ++i) d[i] = apply_act(d[i], ACT);
      stage<16>(epi, t, d);
      wg_sync(wg);
      store<16>(epi, t, out2 != nullptr ? out2 : out, N, m0, M, wcol);
    }
  }
}

// Output tiles of h [M, K] -> N (gated: N = F, 64 output columns a tile).
inline int gemm_tiles(int M, int N, bool gated) {
  return ((M + BM - 1) / BM) * (N / (gated ? BN / 2 : BN));
}

template <bool GATED, int ACT>
cudaError_t launch_gemm(const void* h, const void* w, const void* bias, void* out, void* out2,
                        int M, int K, int N, cudaStream_t st) {
  const int wcols = GATED ? 2 * N : N;
  CUtensorMap ta, tb;
  cudaError_t err = tma_map_2d(&ta, h, M, K, BM, BK);
  if (err == cudaSuccess) err = tma_map_2d(&tb, w, K, wcols, BK, 64);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(gemm_tiles(M, N, GATED), &grid);
  if (err == cudaSuccess) err = allow_smem(gemm_ln_kernel<GATED, ACT>, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_ln_kernel<GATED, ACT><<<grid, THREADS, SMEM_BYTES, st>>>(
      ta, tb, static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<bf16*>(out2),
      M, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mst

// x [M, K] bf16, ln_s / ln_b [K] f32 -> h [M, K] bf16 = bf16(LN(x)). Needs
// K % 8 == 0 and K <= 4096.
extern "C" int mst_ln_rows(const void* x, const void* ln_s, const void* ln_b, void* h, int M,
                           int K, float eps, void* stream) {
  using namespace mst;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_lane = (K / 8 + 31) / 32;  // 16-byte chunks per lane
  if (M <= 0 || K <= 0 || K % 8 != 0) return cudaErrorInvalidValue;
  if (per_lane <= 2) return launch_ln_rows<2>(x, ln_s, ln_b, h, M, K, eps, st);
  if (per_lane <= 4) return launch_ln_rows<4>(x, ln_s, ln_b, h, M, K, eps, st);
  if (per_lane <= 6) return launch_ln_rows<6>(x, ln_s, ln_b, h, M, K, eps, st);
  if (per_lane <= 8) return launch_ln_rows<8>(x, ln_s, ln_b, h, M, K, eps, st);
  if (per_lane <= 16) return launch_ln_rows<16>(x, ln_s, ln_b, h, M, K, eps, st);
  return cudaErrorInvalidValue;
}

// h [M, K] bf16 (the normalised rows), w [K, N] bf16 (row-major, the flax
// Dense layout), bias [N] f32 -> out [M, N] bf16 = act(h @ w + bias); with
// out2 [M, N] set, the train mode (above). Needs K % 64 == 0 and
// N % 128 == 0 (checked by the Python wrapper as well).
extern "C" int mst_gemm_act(const void* h, const void* w, const void* bias, void* out, void* out2,
                            int M, int K, int N, int act, void* stream) {
  using namespace mst;
  if (M <= 0 || K <= 0 || N <= 0 || K % sm90::BK != 0 || N % sm90::BN != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case ACT_NONE: return launch_gemm<false, ACT_NONE>(h, w, bias, out, out2, M, K, N, st);
    case ACT_GELU_TANH:
      return launch_gemm<false, ACT_GELU_TANH>(h, w, bias, out, out2, M, K, N, st);
    case ACT_GELU_ERF:
      return launch_gemm<false, ACT_GELU_ERF>(h, w, bias, out, out2, M, K, N, st);
    default: return cudaErrorInvalidValue;
  }
}

// The gated mode: h [M, K] bf16, w12 [K, 2F] bf16, b12 [2F] f32 -> g [M, F]
// bf16 = bf16(silu(h1) * h2); h12 [M, 2F] bf16 or NULL: the train mode
// (above). Needs K % 64 == 0 and F % 64 == 0 (checked by the Python wrapper
// as well).
extern "C" int mst_gemm_swiglu(const void* h, const void* w12, const void* b12, void* out,
                               void* h12, int M, int K, int F, void* stream) {
  using namespace mst;
  if (M <= 0 || K <= 0 || F <= 0 || K % sm90::BK != 0 || F % (sm90::BN / 2) != 0)
    return cudaErrorInvalidValue;
  return launch_gemm<true, ACT_NONE>(h, w12, b12, out, h12, M, K, F,
                                     static_cast<cudaStream_t>(stream));
}

// The GEMM's launch geometry for h [M, K] -> N (gated: N = F) on the
// current device: geo = {tiles, grid, threads, stages, dynamic shared
// memory bytes}, as `launch_gemm` sets them (`fused_block.ln_gemm_launch`
// mirrors it). The shapes the GEMM refuses return cudaErrorInvalidValue.
extern "C" int mst_gemm_geometry(int M, int K, int N, int gated, int* geo) {
  using namespace mst::sm90;
  if (M <= 0 || K <= 0 || N <= 0 || K % BK != 0 || N % (gated ? BN / 2 : BN) != 0)
    return cudaErrorInvalidValue;
  const int tiles = mst::gemm_tiles(M, N, gated != 0);
  int grid = 0;
  const cudaError_t err = persistent_grid(tiles, &grid);
  if (err != cudaSuccess) return err;
  geo[0] = tiles;
  geo[1] = grid;
  geo[2] = THREADS;
  geo[3] = STAGES;
  geo[4] = static_cast<int>(SMEM_BYTES);
  return cudaSuccess;
}

// Readable name of a CUDA error code returned by the entry points above.
extern "C" const char* mst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
