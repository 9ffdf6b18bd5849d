// gemm_dgrad: the input gradient of a Dense layer, dA[M, K] = dY[M, R] @
// W[K, R]^T (W in the flax layout [in, out] = [K, R]), bf16 in, f32
// accumulation, with one of five epilogues:
//
// - plain:  out = bf16(dA) (do = gz @ Wproj^T in `_attn_bwd_kernel`);
// - gelu:   out = bf16(dA * act'(a)), a [M, K] the saved bf16 pre-activation
//           (da = du * gelu'(a) in `_mlp_bwd_kernel`);
// - ln:     the LayerNorm pullback plus the residual, for dh = dA, x [M, K]
//           the sub-layer input and g [M, K] its upstream gradient:
//           xhat, rstd recomputed from x; dxhat = dh * ln_s;
//           dx = bf16(rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + g),
//           and per-row-block partial column sums of dh * xhat (dln_s) and
//           dh (dln_b), added up afterwards by `sum_partials_kernel`
//           (the last step of both `_attn_bwd_kernel` and `_mlp_bwd_kernel`
//           in mst_tpu/ops/fused_block.py);
// - swiglu: the SiLU gate's derivative (`_swiglu_train_bwd`, the XLA
//           backward of `_swiglu_train_kernel`): du = bf16(dA) [M, K = F]
//           (XLA's bf16 product gz @ w3^T), a = h12 [M, 2F] the saved bf16
//           pre-gate, and out = dh12 [M, 2F]: for column c, with h1 =
//           h12[c], h2 = h12[F + c], s = sigmoid(h1), silu = h1 * s,
//           dh1 = du * h2 * (s + silu * (1 - s)) at c, dh2 = du * silu at
//           F + c, in f32, one cast each;
// - f32:    out = dA in f32, for `ln_pullback` below.
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
//
// Wider rows (K = 768, 1024, 1536: ViT-B, ViT-L, giant2) do not fit that
// one pass: at K = 1536 the W double buffer alone would be 246 KB. There
// the GEMM writes dh in f32 (the f32 epilogue) and `ln_pullback_kernel`, one
// warp per row, does the ln epilogue's math from it: 2 x M x K x 4 bytes of
// round trip (0.81 GB at giant2's B = 8, ~0.24 ms at 3.35 TB/s) beside a
// 0.93 TFLOP product.
#include "common.cuh"

namespace mst {
namespace {

constexpr int BR = 32;        // reduction (R) per stage
constexpr int THREADS = 256;  // 8 warps
constexpr int LDA = BR + 8;
constexpr int LDW = BR + 8;
constexpr int LN_K = 384;     // row width of the ln variant (ViT-S)
constexpr int ACT_SWIGLU = 3;  // `act` code of the swiglu epilogue (fused_block.py)

enum Mode : int { PLAIN = 0, GELU = 1, LN = 2, SWIGLU = 3, F32 = 4 };

struct Args {
  const bf16* dy;  // [M, R]
  const bf16* w;   // [K, R]
  void* out;       // [M, K] bf16 (f32 in the f32 mode; [M, 2K] for swiglu)
  int M, R, K;
  const bf16* a;   // gelu: [M, K]; swiglu: h12 [M, 2K]
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
      if constexpr (MODE == F32) {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(p.out) + off);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else if constexpr (MODE == SWIGLU) {
        // h12 and dh12 are [M, 2K]: h1 / dh1 at column k, h2 / dh2 at K + k
        const size_t o1 = size_t(m) * 2 * K + k0 + c, o2 = o1 + K;
        float h1[8], h2[8], d1[8], d2[8];
        unpack8_bf16(*reinterpret_cast<const uint4*>(p.a + o1), h1);
        unpack8_bf16(*reinterpret_cast<const uint4*>(p.a + o2), h2);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float du = round_bf16(v[e]);
          const float sg = 1.0f / (1.0f + expf(-h1[e]));
          const float silu = h1[e] * sg;
          d1[e] = du * h2[e] * (sg + silu * (1.0f - sg));
          d2[e] = du * silu;
        }
        bf16* out = static_cast<bf16*>(p.out);
        *reinterpret_cast<uint4*>(out + o1) = pack8_bf16(d1);
        *reinterpret_cast<uint4*>(out + o2) = pack8_bf16(d2);
      } else {
        if constexpr (MODE == GELU) {
          float av[8];
          unpack8_bf16(*reinterpret_cast<const uint4*>(p.a + off), av);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] *= act_grad(av[e], p.act);
        }
        *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + off) = pack8_bf16(v);
      }
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
      bf16* outr = static_cast<bf16*>(p.out) + size_t(m) * K;
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

// The ln epilogue at any K % 32 == 0 up to 1536, from dh [M, K] f32: a block
// owns PB_ROWS rows (the fused route's 32, so both write the same partials
// layout), staged PB_CHUNK at a time in shared memory (96 KB at K = 1536,
// two blocks per SM). One warp per row holds its dh and x values in
// registers (two-pass statistics, the row means, dx); then one thread per
// column adds the chunk's dh * xhat and dh, rows in order, to its partials.
constexpr int PB_ROWS = 32;
constexpr int PB_CHUNK = 16;
constexpr int PB_MAX_K = 1536;
constexpr int PB_PER = PB_MAX_K / 32;        // row values per lane
constexpr int PB_COLS = PB_MAX_K / THREADS;  // columns per thread

inline size_t pullback_smem(int K) {
  return (size_t(PB_CHUNK) * K + 2 * PB_ROWS) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
ln_pullback_kernel(const float* __restrict__ dh, const bf16* __restrict__ x,
                   const bf16* __restrict__ g, const float* __restrict__ lns,
                   float eps, bf16* __restrict__ out, float* __restrict__ part,
                   int M, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ds = reinterpret_cast<float*>(smem);  // [PB_CHUNK][K]
  float* mean_s = ds + size_t(PB_CHUNK) * K;   // [PB_ROWS]
  float* rstd_s = mean_s + PB_ROWS;            // [PB_ROWS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * PB_ROWS;
  const int per = K / 32;
  float s1[PB_COLS], s2[PB_COLS];
#pragma unroll
  for (int j = 0; j < PB_COLS; ++j) s1[j] = s2[j] = 0.0f;

  for (int r0 = 0; r0 < PB_ROWS; r0 += PB_CHUNK) {
    for (int r = warp; r < PB_CHUNK; r += THREADS / 32) {
      const int m = m0 + r0 + r;
      if (m >= M) break;  // warp-uniform, and later rows lie further out
      const bf16* xr = x + size_t(m) * K;
      const float* dr = dh + size_t(m) * K;
      float xv[PB_PER], dv[PB_PER];
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < PB_PER; ++i) {
        if (i < per) {
          const int k = lane + 32 * i;
          xv[i] = __bfloat162float(xr[k]);
          dv[i] = dr[k];
          ds[r * K + k] = dv[i];
          sum += xv[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mean = sum / K;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < PB_PER; ++i) {
        if (i < per) {
          const float d = xv[i] - mean;
          sq += d * d;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float rstd = rsqrtf(sq / K + eps);
      float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
      for (int i = 0; i < PB_PER; ++i) {
        if (i < per) {
          const int k = lane + 32 * i;
          xv[i] = (xv[i] - mean) * rstd;  // xhat
          dv[i] = dv[i] * lns[k];         // dxhat
          t1 += dv[i];
          t2 += dv[i] * xv[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        t1 += __shfl_xor_sync(0xffffffffu, t1, o);
        t2 += __shfl_xor_sync(0xffffffffu, t2, o);
      }
      const float m1 = t1 / K, m2 = t2 / K;
      const bf16* gr = g + size_t(m) * K;
      bf16* outr = out + size_t(m) * K;
#pragma unroll
      for (int i = 0; i < PB_PER; ++i) {
        if (i < per) {
          const int k = lane + 32 * i;
          const float dx = rstd * (dv[i] - m1 - xv[i] * m2) + __bfloat162float(gr[k]);
          outr[k] = __float2bfloat16(dx);
        }
      }
      if (lane == 0) {
        mean_s[r0 + r] = mean;
        rstd_s[r0 + r] = rstd;
      }
    }
    __syncthreads();
    // Column partials of the chunk's rows: dln_s += dh * xhat, dln_b += dh.
#pragma unroll
    for (int j = 0; j < PB_COLS; ++j) {
      const int c = tid + j * THREADS;
      if (c >= K) continue;
      for (int r = 0; r < PB_CHUNK && m0 + r0 + r < M; ++r) {
        const float d = ds[r * K + c];
        const float xh = (__bfloat162float(x[size_t(m0 + r0 + r) * K + c]) - mean_s[r0 + r]) *
                         rstd_s[r0 + r];
        s1[j] += d * xh;
        s2[j] += d;
      }
    }
    __syncthreads();  // the next chunk overwrites ds
  }
  const size_t nb = gridDim.x;
#pragma unroll
  for (int j = 0; j < PB_COLS; ++j) {
    const int c = tid + j * THREADS;
    if (c >= K) continue;
    part[size_t(blockIdx.x) * K + c] = s1[j];
    part[(nb + blockIdx.x) * K + c] = s2[j];
  }
}

// The two column sums of the partials [2][row_blocks][K] into dlns, dlnb.
cudaError_t sum_ln_partials(const float* part, void* dlns, void* dlnb, int M, int K,
                            cudaStream_t st) {
  const int row_blocks = (M + 31) / 32;
  cudaError_t err = sum_partials(part, static_cast<float*>(dlns), row_blocks, K, st);
  if (err != cudaSuccess) return err;
  return sum_partials(part + size_t(row_blocks) * K, static_cast<float*>(dlnb), row_blocks,
                      K, st);
}

}  // namespace
}  // namespace mst

// dy [M, R] bf16, w [K, R] bf16 -> out [M, K] bf16. Epilogue: ln when x is
// set (x, g [M, K] bf16, lns [K] f32, eps; K must be 384; work [2 *
// ceil(M / 32) * K] f32; dlns, dlnb [K] f32 out), else swiglu when act is
// ACT_SWIGLU (a = h12 [M, 2K] bf16; out [M, 2K]), else gelu when a is set
// (a [M, K] bf16, act), else plain. Needs R % 32 == 0 and K % 128 == 0.
extern "C" int mst_gemm_dgrad(const void* dy, const void* w, void* out, int M,
                              int R, int K, const void* a, int act, const void* x,
                              const void* g, const void* lns, float eps, void* work,
                              void* dlns, void* dlnb, void* stream) {
  using namespace mst;
  if (M <= 0 || R % BR != 0 || K % 128 != 0 || (M + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p{static_cast<const bf16*>(dy), static_cast<const bf16*>(w), out, M, R, K,
         static_cast<const bf16*>(a), act, static_cast<const bf16*>(x),
         static_cast<const bf16*>(g), static_cast<const float*>(lns), eps,
         static_cast<float*>(work)};
  if (x == nullptr) {
    if (act == ACT_SWIGLU)
      return a == nullptr ? cudaErrorInvalidValue : launch<64, 128, 2, 4, SWIGLU>(p, st);
    return a == nullptr ? launch<64, 128, 2, 4, PLAIN>(p, st)
                        : launch<64, 128, 2, 4, GELU>(p, st);
  }
  if (K != LN_K || g == nullptr || lns == nullptr || work == nullptr ||
      dlns == nullptr || dlnb == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = launch<32, LN_K, 2, 4, LN>(p, st);
  if (err != cudaSuccess) return err;
  return sum_ln_partials(static_cast<const float*>(work), dlns, dlnb, M, K, st);
}

// The f32 mode: dy [M, R] bf16, w [K, R] bf16 -> out [M, K] f32 (dh of the
// wide LN route). Needs R % 32 == 0 and K % 128 == 0.
extern "C" int mst_gemm_dgrad_f32(const void* dy, const void* w, void* out, int M, int R,
                                  int K, void* stream) {
  using namespace mst;
  if (M <= 0 || R % BR != 0 || K % 128 != 0 || (M + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  Args p{static_cast<const bf16*>(dy), static_cast<const bf16*>(w), out, M, R, K};
  return launch<64, 128, 2, 4, F32>(p, static_cast<cudaStream_t>(stream));
}

// The ln epilogue from dh [M, K] f32: x, g [M, K] bf16, lns [K] f32, eps ->
// out = dx [M, K] bf16, dlns, dlnb [K] f32; work [2 * ceil(M / 32) * K] f32.
// Needs K % 32 == 0 and K <= 1536.
extern "C" int mst_ln_pullback(const void* dh, const void* x, const void* g,
                               const void* lns, float eps, void* out, void* work,
                               void* dlns, void* dlnb, int M, int K, void* stream) {
  using namespace mst;
  if (M <= 0 || K <= 0 || K % 32 != 0 || K > PB_MAX_K)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = pullback_smem(K);
  cudaError_t err = allow_smem(ln_pullback_kernel, bytes);
  if (err != cudaSuccess) return err;
  ln_pullback_kernel<<<(M + PB_ROWS - 1) / PB_ROWS, THREADS, bytes, st>>>(
      static_cast<const float*>(dh), static_cast<const bf16*>(x),
      static_cast<const bf16*>(g), static_cast<const float*>(lns), eps,
      static_cast<bf16*>(out), static_cast<float*>(work), M, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_ln_partials(static_cast<const float*>(work), dlns, dlnb, M, K, st);
}
