// gemm_dgrad: the input gradient of a Dense layer, dA[M, K] = dY[M, R] @
// W[K, R]^T (W in the flax layout [in, out] = [K, R]), bf16 in, f32
// accumulation, with one of four epilogues:
//
// - plain:  out = bf16(dA) (do = gz @ Wproj^T in `_attn_bwd_kernel`);
// - gelu:   out = bf16(dA * act'(a)), a [M, K] the saved bf16 pre-activation
//           (da = du * gelu'(a) in `_mlp_bwd_kernel`);
// - swiglu: the SiLU gate's derivative (`_swiglu_train_bwd`, the XLA
//           backward of `_swiglu_train_kernel`): du = bf16(dA) [M, K = F]
//           (XLA's bf16 product gz @ w3^T), a = h12 [M, 2F] the saved bf16
//           pre-gate, and out = dh12 [M, 2F]: for column c, with h1 =
//           h12[c], h2 = h12[F + c], s = sigmoid(h1), silu = h1 * s,
//           dh1 = du * h2 * (s + silu * (1 - s)) at c, dh2 = du * silu at
//           F + c, in f32, one cast each;
// - f32:    out = dA in f32: dh of the LN pullback, which
//           `ln_pullback_kernel` below takes from there (the last step of
//           both `_attn_bwd_kernel` and `_mlp_bwd_kernel` in
//           mst_tpu/ops/fused_block.py, and of the XLA backwards).
//
// Bound on the H100: at the path shapes the product is compute bound on
// the tensor cores (19-78 GFLOP against 50-400 MB at ViT-S, M = 65,792; 1.9
// TFLOP at giant2's w12). The GEMM is the persistent TMA + wgmma mainloop of
// gemm_sm90.cuh with A = dY (K-major, as ln_gemm's h) and B = W read as W^T
// in place: W [K, R] is R-contiguous, so each stage holds one K-major box
// of 128 W rows x 64 r, and no transposed copy of W is made. Rows of dY
// past M read as zeros (TMA) and the stores are masked by row.
//
// The epilogue stages each warpgroup's f32 accumulators in shared memory
// 64 columns at a time (the 17 KB staging tile of gemm_sm90.cuh), then
// each thread owns 8 consecutive columns of a row: the epilogue inputs
// (a, h12) are read and the outputs written as 16-byte rows, rounded as
// the plain version rounds (`_gemm_dgrad_ref`).
//
// The LN pullback needs two means over each whole row, which the TPU
// kernel had in VMEM; a 128 x 128 tile cannot hold a row of 384 or more.
// So at every width the GEMM writes dh in f32 and `ln_pullback_kernel`,
// one warp per row, does the pullback from it: 2 x M x K x 4 bytes of
// round trip (0.20 GB at ViT-S's M = 65,792, K = 384; 0.81 GB at giant2's
// K = 1536, ~0.06 / 0.24 ms at 3.35 TB/s).
#include "gemm_sm90.cuh"

namespace mst {
namespace {

using namespace sm90;

enum Mode : int { PLAIN = 0, GELU = 1, SWIGLU = 2, F32 = 3 };

template <int MODE>
__device__ __forceinline__ void epilogue8(float (&v)[8], void* __restrict__ out,
                                          const bf16* __restrict__ a, int act, int m, int col,
                                          int K) {
  const size_t off = size_t(m) * K + col;
  if constexpr (MODE == F32) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (MODE == SWIGLU) {
    // h12 and dh12 are [M, 2K]: h1 / dh1 at column k, h2 / dh2 at K + k
    const size_t o1 = size_t(m) * 2 * K + col, o2 = o1 + K;
    float h1[8], h2[8], d1[8], d2[8];
    unpack8_bf16(__ldg(reinterpret_cast<const uint4*>(a + o1)), h1);
    unpack8_bf16(__ldg(reinterpret_cast<const uint4*>(a + o2)), h2);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float du = round_bf16(v[e]);
      const float sg = 1.0f / (1.0f + expf(-h1[e]));
      const float silu = h1[e] * sg;
      d1[e] = du * h2[e] * (sg + silu * (1.0f - sg));
      d2[e] = du * silu;
    }
    bf16* o = static_cast<bf16*>(out);
    *reinterpret_cast<uint4*>(o + o1) = pack8_bf16(d1);
    *reinterpret_cast<uint4*>(o + o2) = pack8_bf16(d2);
  } else {
    if constexpr (MODE == GELU) {
      float av[8];
      unpack8_bf16(__ldg(reinterpret_cast<const uint4*>(a + off)), av);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= act_grad(av[e], act);
    }
    *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + off) = pack8_bf16(v);
  }
}

// Output tiles of dA [M, K]: 128 x 128.
__host__ __device__ inline int dgrad_tiles(int M, int K) { return ((M + BM - 1) / BM) * (K / BN); }

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
gemm_dgrad_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  void* __restrict__ out, const bf16* __restrict__ a, int act, int M, int R,
                  int K) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  init_barriers(s);
  __syncthreads();
  const int tiles_n = K / BN;
  const int tiles = dgrad_tiles(M, K);
  const int nk = R / BK;
  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warp
    if (threadIdx.x == CONSUMERS * 128)
      producer<K_MAJOR, K_MAJOR>(s, &ta, &tb, tiles, [=](int tile) {
        return Work{(tile / tiles_n) * BM, (tile % tiles_n) * BN, 0, 0, nk};
      });
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  float* epi = reinterpret_cast<float*>(s.epi) + wg * 64 * EPI_LD_F;
  uint32_t it = 0;
  float d[ACC];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    consumer_tile<K_MAJOR, K_MAJOR>(s, wg, nk, it, d);
    const int m0 = (tile / tiles_n) * BM + 64 * wg;
    const int n0 = (tile % tiles_n) * BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wg_sync(wg);  // the previous half's (or tile's) reads of the staging tile are done
      stage_f32_half(epi, t, d, h);
      wg_sync(wg);
#pragma unroll
      for (int g = t; g < 64 * 8; g += 128) {
        const int r = g / 8, c = (g % 8) * 8;
        if (m0 + r >= M) continue;
        float v[8];
        *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(epi + r * EPI_LD_F + c);
        *reinterpret_cast<float4*>(v + 4) =
            *reinterpret_cast<const float4*>(epi + r * EPI_LD_F + c + 4);
        epilogue8<MODE>(v, out, a, act, m0 + r, n0 + 64 * h + c, K);
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const void* dy, const void* w, void* out, const void* a, int act, int M, int R,
                   int K, cudaStream_t st) {
  CUtensorMap ta, tb;
  cudaError_t err = tma_map_2d(&ta, dy, M, R, BM, BK);
  if (err == cudaSuccess) err = tma_map_2d(&tb, w, K, R, BN, BK);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(dgrad_tiles(M, K), &grid);
  if (err == cudaSuccess) err = allow_smem(gemm_dgrad_kernel<MODE>, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_dgrad_kernel<MODE><<<grid, THREADS, SMEM_BYTES, st>>>(
      ta, tb, out, static_cast<const bf16*>(a), act, M, R, K);
  return cudaGetLastError();
}

inline bool dgrad_shape_ok(int M, int R, int K) {
  return M > 0 && R > 0 && K > 0 && R % BK == 0 && K % BN == 0;
}

// The LN pullback at any K % 32 == 0 up to 1536, from dh [M, K] f32: a block
// owns PB_ROWS rows, staged PB_CHUNK at a time in shared memory (96 KB at K = 1536,
// two blocks per SM). One warp per row holds its dh and x values in
// registers (two-pass statistics, the row means, dx); then one thread per
// column adds the chunk's dh * xhat and dh, rows in order, to its partials.
constexpr int PB_THREADS = 256;  // 8 warps
constexpr int PB_ROWS = 32;
constexpr int PB_CHUNK = 16;
constexpr int PB_MAX_K = 1536;
constexpr int PB_PER = PB_MAX_K / 32;        // row values per lane
constexpr int PB_COLS = PB_MAX_K / PB_THREADS;  // columns per thread

inline size_t pullback_smem(int K) {
  return (size_t(PB_CHUNK) * K + 2 * PB_ROWS) * sizeof(float);
}

__global__ void __launch_bounds__(PB_THREADS)
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
    for (int r = warp; r < PB_CHUNK; r += PB_THREADS / 32) {
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
      const int c = tid + j * PB_THREADS;
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
    const int c = tid + j * PB_THREADS;
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

// dy [M, R] bf16, w [K, R] bf16 -> out [M, K] = dy @ w^T with the epilogue
// `mode` (0 plain, 1 gelu with a [M, K] bf16 and act, 2 swiglu with a =
// h12 [M, 2K] bf16 and out [M, 2K], 3 f32 with out f32). Needs R % 64 == 0
// and K % 128 == 0 (checked by the Python wrapper as well).
extern "C" int mst_gemm_dgrad(const void* dy, const void* w, void* out, const void* a, int M,
                              int R, int K, int mode, int act, void* stream) {
  using namespace mst;
  if (!dgrad_shape_ok(M, R, K)) return cudaErrorInvalidValue;
  if ((mode == GELU || mode == SWIGLU) && a == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case PLAIN: return launch<PLAIN>(dy, w, out, a, act, M, R, K, st);
    case GELU: return launch<GELU>(dy, w, out, a, act, M, R, K, st);
    case SWIGLU: return launch<SWIGLU>(dy, w, out, a, act, M, R, K, st);
    case F32: return launch<F32>(dy, w, out, a, act, M, R, K, st);
    default: return cudaErrorInvalidValue;
  }
}

// The GEMM's launch geometry for dy [M, R] -> dA [M, K] on the current
// device: geo = {work units (output tiles), grid, threads, stages, dynamic
// shared memory bytes, splits of the reduction, rows per split, workspace
// bytes}, as `launch` sets them (`fused_block.gemm_dgrad_launch` mirrors
// it). The shapes the GEMM refuses return cudaErrorInvalidValue.
extern "C" int mst_dgrad_geometry(int M, int R, int K, long long* geo) {
  using namespace mst;
  if (!dgrad_shape_ok(M, R, K)) return cudaErrorInvalidValue;
  const int tiles = dgrad_tiles(M, K);
  int grid = 0;
  const cudaError_t err = persistent_grid(tiles, &grid);
  if (err != cudaSuccess) return err;
  const long long g[8] = {tiles, grid, THREADS, STAGES, static_cast<long long>(SMEM_BYTES),
                          1, R, 0};
  for (int i = 0; i < 8; ++i) geo[i] = g[i];
  return cudaSuccess;
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
  ln_pullback_kernel<<<(M + PB_ROWS - 1) / PB_ROWS, PB_THREADS, bytes, st>>>(
      static_cast<const float*>(dh), static_cast<const bf16*>(x),
      static_cast<const bf16*>(g), static_cast<const float*>(lns), eps,
      static_cast<bf16*>(out), static_cast<float*>(work), M, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_ln_partials(static_cast<const float*>(work), dlns, dlnb, M, K, st);
}
