// gemm_dgrad: the input gradient of a Dense layer, dA[M, K] = dY[M, R] @
// W[K, R]^T (W in the flax layout [in, out] = [K, R]), bf16 in, f32
// accumulation, with one of three epilogues:
//
// - plain: out = bf16(dA) (do = gz @ Wproj^T in `_attn_bwd_kernel`);
// - gelu:  out = bf16(dA * act'(a)), a [M, K] the saved bf16 pre-activation
//          (da = du * gelu'(a) in `_mlp_bwd_kernel`);
// - ln:    the LayerNorm pullback plus the residual, for dh = dA, x [M, K]
//          the sub-layer input and g [M, K] its upstream gradient:
//          xhat, rstd recomputed from x; dxhat = dh * ln_s;
//          dx = bf16(rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + g),
//          and per-row-block partial column sums of dh * xhat (dln_s) and
//          dh (dln_b), added up afterwards by `sum_partials_kernel`
//          (the last step of both `_attn_bwd_kernel` and `_mlp_bwd_kernel`
//          in mst_tpu/ops/fused_block.py).
//
// Bound on the H100: at the ViT-S path shapes (M = 65,792; K x R = 384 x
// 384, 1536 x 384, 384 x 1152, 384 x 1536) the product is 19-78 GFLOP
// against 50-400 MB, compute bound on the tensor cores. The LN epilogue
// needs two means over each whole row, which the TPU kernel had in VMEM: here
// a block of the ln variant owns 32 whole rows of K = 384 (the f32 tile is
// 50 KB of shared memory), so the means, dx and the column partials come out
// of one pass with no f32 dh round trip through device memory. dY and W
// stream through a cp.async double buffer in 32-wide stages; W^T is read
// from the row-major W tile as a column-major WMMA fragment.
#include "common.cuh"

namespace mst {
namespace {

constexpr int BR = 32;        // reduction (R) per stage
constexpr int THREADS = 256;  // 8 warps
constexpr int LDA = BR + 8;
constexpr int LDW = BR + 8;
constexpr int LN_K = 384;     // row width of the ln variant (ViT-S)

enum Mode : int { PLAIN = 0, GELU = 1, LN = 2 };

struct Args {
  const bf16* dy;  // [M, R]
  const bf16* w;   // [K, R]
  bf16* out;       // [M, K]
  int M, R, K;
  const bf16* a;   // gelu: [M, K]
  int act;
  const bf16* x;   // ln: [M, K]
  const bf16* g;   // ln: [M, K]
  const float* lns;
  float eps;
  float* part;     // ln: [2][row blocks][K]
};

template <int BM, int BN>
struct Tile {
  static constexpr size_t A_STAGE = size_t(BM) * LDA;
  static constexpr size_t W_STAGE = size_t(BN) * LDW;
  static constexpr size_t PIPE = 2 * (A_STAGE + W_STAGE) * sizeof(bf16);
  static constexpr int LDC = BN + 4;
  static constexpr size_t C = size_t(BM) * LDC * sizeof(float);
  static constexpr size_t MAIN = PIPE > C ? PIPE : C;
  static constexpr size_t SMEM = MAIN + 2 * BM * sizeof(float);  // + row stats
};

// BM x BN output tile; warps as WM x WN, each (BM / WM) x (BN / WN).
template <int BM, int BN, int WM, int WN, int MODE>
__global__ void __launch_bounds__(THREADS) gemm_dgrad_kernel(Args p) {
  using T = Tile<BM, BN>;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int FM = WTM / 16, FN = WTN / 16;
  static_assert(WM * WN == THREADS / 32, "8 warps");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][BM][LDA]
  bf16* Ws = As + 2 * T::A_STAGE;            // [2][BN][LDW]
  float* Cs = reinterpret_cast<float*>(smem);  // aliases the pipeline

  const int M = p.M, R = p.R, K = p.K;
  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  auto load_stage = [&](int kt, int buf) {
    bf16* da = As + buf * T::A_STAGE;
    for (int c = tid; c < BM * (BR / 8); c += THREADS) {
      const int r = c / (BR / 8), col = (c % (BR / 8)) * 8;
      const int m = m0 + r;
      const int mc = m < M ? m : M - 1;
      cp_async16(da + r * LDA + col, p.dy + size_t(mc) * R + size_t(kt) * BR + col,
                 m < M ? 16 : 0);
    }
    bf16* dw = Ws + buf * T::W_STAGE;
    for (int c = tid; c < BN * (BR / 8); c += THREADS) {
      const int r = c / (BR / 8), col = (c % (BR / 8)) * 8;
      cp_async16(dw + r * LDW + col, p.w + size_t(k0 + r) * R + size_t(kt) * BR + col, 16);
    }
  };

  const int wm = warp / WN;
  const int wn = warp % WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = R / BR;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ast = As + (kt & 1) * T::A_STAGE;
    const bf16* Wst = Ws + (kt & 1) * T::W_STAGE;
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], Ast + (wm * WTM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        // W^T: rows r, columns k; the [k][r] tile read column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Wst + (wn * WTN + j * 16) * LDW + kk, LDW);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

  constexpr int LDC = T::LDC;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WTM + i * 16) * LDC + wn * WTN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  if constexpr (MODE != LN) {
    for (int g = tid; g < BM * (BN / 8); g += THREADS) {
      const int r = g / (BN / 8), c = (g % (BN / 8)) * 8;
      const int m = m0 + r;
      if (m >= M) continue;
      const size_t off = size_t(m) * K + k0 + c;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Cs[r * LDC + c + e];
      if constexpr (MODE == GELU) {
        float av[8];
        unpack8_bf16(*reinterpret_cast<const uint4*>(p.a + off), av);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= act_grad(av[e], p.act);
      }
      *reinterpret_cast<uint4*>(p.out + off) = pack8_bf16(v);
    }
  } else {
    // BN == K: the block holds whole rows. One warp per row: statistics of
    // x (two passes, as the forward), the two row means, dx.
    constexpr int PER = BN / 32;
    float* mean_s = reinterpret_cast<float*>(smem + T::MAIN);
    float* rstd_s = mean_s + BM;
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int m = m0 + r;
      if (m >= M) {
        if (lane == 0) mean_s[r] = rstd_s[r] = 0.0f;
        continue;
      }
      const bf16* xr = p.x + size_t(m) * K;
      float xv[PER];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        xv[i] = __bfloat162float(xr[lane + 32 * i]);
        sum += xv[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mean = sum / K;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float d = xv[i] - mean;
        sq += d * d;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float rstd = rsqrtf(sq / K + p.eps);
      float s1 = 0.0f, s2 = 0.0f;
      float dxh[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = lane + 32 * i;
        xv[i] = (xv[i] - mean) * rstd;  // xhat
        dxh[i] = Cs[r * LDC + k] * p.lns[k];
        s1 += dxh[i];
        s2 += dxh[i] * xv[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      const float m1 = s1 / K, m2 = s2 / K;
      const bf16* gr = p.g + size_t(m) * K;
      bf16* outr = p.out + size_t(m) * K;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int k = lane + 32 * i;
        const float dx = rstd * (dxh[i] - m1 - xv[i] * m2) + __bfloat162float(gr[k]);
        outr[k] = __float2bfloat16(dx);
      }
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
    __syncthreads();
    // Column partials over the block's rows: dln_s += dh * xhat, dln_b += dh.
    const size_t nb = gridDim.y;
    for (int c = tid; c < BN; c += THREADS) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int r = 0; r < BM && m0 + r < M; ++r) {
        const float dh = Cs[r * LDC + c];
        const float xh = (__bfloat162float(p.x[size_t(m0 + r) * K + c]) - mean_s[r]) * rstd_s[r];
        s1 += dh * xh;
        s2 += dh;
      }
      p.part[size_t(blockIdx.y) * K + c] = s1;
      p.part[(nb + blockIdx.y) * K + c] = s2;
    }
  }
}

template <int BM, int BN, int WM, int WN, int MODE>
cudaError_t launch(const Args& p, cudaStream_t st) {
  using T = Tile<BM, BN>;
  auto kernel = gemm_dgrad_kernel<BM, BN, WM, WN, MODE>;
  cudaError_t err = allow_smem(kernel, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(p.K / BN, (p.M + BM - 1) / BM);
  kernel<<<grid, THREADS, T::SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mst

// dy [M, R] bf16, w [K, R] bf16 -> out [M, K] bf16. Epilogue: ln when x is
// set (x, g [M, K] bf16, lns [K] f32, eps; K must be 384; work [2 *
// ceil(M / 32) * K] f32; dlns, dlnb [K] f32 out), else gelu when a is set
// (a [M, K] bf16, act), else plain. Needs R % 32 == 0 and K % 128 == 0.
extern "C" int mst_gemm_dgrad(const void* dy, const void* w, void* out, int M,
                              int R, int K, const void* a, int act, const void* x,
                              const void* g, const void* lns, float eps, void* work,
                              void* dlns, void* dlnb, void* stream) {
  using namespace mst;
  if (M <= 0 || R % BR != 0 || K % 128 != 0 || (M + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p{static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
         static_cast<bf16*>(out), M, R, K, static_cast<const bf16*>(a), act,
         static_cast<const bf16*>(x), static_cast<const bf16*>(g),
         static_cast<const float*>(lns), eps, static_cast<float*>(work)};
  if (x == nullptr)
    return a == nullptr ? launch<64, 128, 2, 4, PLAIN>(p, st)
                        : launch<64, 128, 2, 4, GELU>(p, st);
  if (K != LN_K || g == nullptr || lns == nullptr || work == nullptr ||
      dlns == nullptr || dlnb == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = launch<32, LN_K, 2, 4, LN>(p, st);
  if (err != cudaSuccess) return err;
  const int row_blocks = (M + 31) / 32;
  const float* part = static_cast<const float*>(work);
  err = sum_partials(part, static_cast<float*>(dlns), row_blocks, K, st);
  if (err != cudaSuccess) return err;
  return sum_partials(part + size_t(row_blocks) * K, static_cast<float*>(dlnb),
                      row_blocks, K, st);
}
