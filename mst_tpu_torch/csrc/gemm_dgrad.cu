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
// So at every width the GEMM writes dh in f32 and `ln_pullback_kernel`
// (below) does the pullback from it. It is bound by bytes: dh f32, x and g
// bf16 in, dx bf16 out, 10 x M x K bytes (0.25 GB at ViT-S's M = 65,792, K
// = 384, 0.075 ms at 3.35 TB/s; 1.01 GB at giant2's K = 1536, 0.30 ms).
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

// ---- the LN pullback ----------------------------------------------------
//
// From dh [M, K] f32 at any K % 32 == 0 up to 1536, in two kernels:
// `ln_pullback_kernel`, one bandwidth-bound pass over the rows, then
// `ln_pullback_sum_kernel`, one fixed-order pass over its partials.
//
// Pass 1: a persistent grid of PB_BLOCKS_PER_SM blocks an SM, PB_WARPS warps
// each. A row belongs to a group of WR warps (1 up to K = 384, 2 up to 768,
// 4 up to 1536, so that a lane holds at most 3 chunks); group w of the grid
// takes rows w, w + G, w + 2G, ... (G groups in the grid), one row at a
// time, and issues the next row's loads before this row's reductions.
// Thread l of a group owns the same columns of every row: chunk j is
// columns 4 (l + 32 WR j) .. + 3, read as one float4 of dh and 8 bytes (4
// bf16) each of x and g, written as 8 bytes of dx. So the row stays in
// registers for its statistics (mean, then the variance of the centred
// values, in f32), its two means (of dxhat and of dxhat * xhat) and dx, and
// the column sums dln_s += dh * xhat, dln_b += dh add up in registers over
// the group's rows: dh and x are read once. A group of several warps adds
// its warps' sums of each reduction in warp order through shared memory
// (one named barrier each). At the end each block adds its groups' column
// sums in group order into one partial row [2][K] (dln_s, then dln_b).
// Pass 2: each column of the [grid][2][K] partials summed over the blocks
// in a fixed order (strided lanes, then the lanes in order, as
// `sum_partials_kernel`). No float atomics: a run repeats bit for bit.
constexpr int PB_WARPS = 8;
constexpr int PB_THREADS = 32 * PB_WARPS;
constexpr int PB_BLOCKS_PER_SM = 2;
constexpr int PB_MAX_K = 1536;
constexpr int PS_WARPS = 8;  // the second pass: 32 columns a block

// Warps a row and chunks of 4 columns a lane: the instance K needs.
struct PbShape {
  int wr, ch;
};
inline PbShape pb_shape(int K) {
  const int wr = K <= 384 ? 1 : K <= 768 ? 2 : 4;
  const int ch = (K + 128 * wr - 1) / (128 * wr);
  return PbShape{wr, ch < 2 ? 2 : ch};
}

// Shared memory: the groups' column sums [PB_WARPS / WR][2][K].
inline size_t pullback_smem(int K) {
  return size_t(PB_WARPS / pb_shape(K).wr) * 2 * K * sizeof(float);
}

// One row's operands of a lane: dh, x and g at its chunks.
template <int CH>
struct PbRow {
  float4 d[CH];
  uint2 x[CH], g[CH];
};

template <int WR, int CH>
__device__ __forceinline__ void pb_load(PbRow<CH>& r, const float* __restrict__ dh,
                                        const bf16* __restrict__ x, const bf16* __restrict__ g,
                                        int m, int K, int tr) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = 4 * (tr + 32 * WR * j);
    if (c < K) {
      const size_t o = size_t(m) * K + c;
      r.d[j] = __ldcs(reinterpret_cast<const float4*>(dh + o));
      r.x[j] = __ldg(reinterpret_cast<const uint2*>(x + o));
      r.g[j] = __ldcs(reinterpret_cast<const uint2*>(g + o));
    }
  }
}

__device__ __forceinline__ void unpack4_bf16(uint2 r, float* v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// The group's sums of NV warp sums v (every lane holds its warp's), added
// in warp order through the group's slot xch [NV][WR]; named barrier 1 +
// the group's index.
template <int WR, int NV>
__device__ __forceinline__ void group_sum(float (&v)[NV], float* xch, int wr, int lane,
                                          int gi) {
  if constexpr (WR > 1) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < NV; ++q) xch[q * WR + wr] = v[q];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gi), "r"(32 * WR) : "memory");
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < WR; ++w) t += xch[q * WR + w];
      v[q] = t;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int WR, int CH>
__global__ void __launch_bounds__(PB_THREADS, PB_BLOCKS_PER_SM)
ln_pullback_kernel(const float* __restrict__ dh, const bf16* __restrict__ x,
                   const bf16* __restrict__ g, const float* __restrict__ lns, float eps,
                   bf16* __restrict__ out, float* __restrict__ part, int M, int K) {
  constexpr int GROUPS = PB_WARPS / WR;
  extern __shared__ __align__(16) float red[];  // [GROUPS][2][K]
  __shared__ float xch[GROUPS][3][2 * WR];      // each reduction's warp sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = warp / WR, wr = warp % WR, tr = 32 * wr + lane;
  const int G = gridDim.x * GROUPS;
  auto live = [&](int j) { return 4 * (tr + 32 * WR * j) < K; };
  float s1[CH][4], s2[CH][4];
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s1[j][e] = s2[j][e] = 0.0f;
  PbRow<CH> cur, nxt;
  int m = blockIdx.x * GROUPS + gi;
  if (m < M) pb_load<WR>(cur, dh, x, g, m, K, tr);
  for (; m < M; m += G) {
    if (m + G < M) pb_load<WR>(nxt, dh, x, g, m + G, K, tr);
    float xv[CH][4], dv[CH][4];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (live(j)) {
        unpack4_bf16(cur.x[j], xv[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += xv[j][e];
      }
    float v1[1] = {warp_sum(sum)};
    group_sum<WR>(v1, xch[gi][0], wr, lane, gi);
    const float mean = v1[0] / K;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (live(j)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = xv[j][e] - mean;
          sq += d * d;
        }
      }
    v1[0] = warp_sum(sq);
    group_sum<WR>(v1, xch[gi][1], wr, lane, gi);
    const float rstd = rsqrtf(v1[0] / K + eps);
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (live(j)) {
        const float dr[4] = {cur.d[j].x, cur.d[j].y, cur.d[j].z, cur.d[j].w};
        const float4 l4 = __ldg(reinterpret_cast<const float4*>(lns + 4 * (tr + 32 * WR * j)));
        const float ls[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xv[j][e] = (xv[j][e] - mean) * rstd;  // xhat
          dv[j][e] = dr[e] * ls[e];             // dxhat
          s1[j][e] += dr[e] * xv[j][e];
          s2[j][e] += dr[e];
        }
      }
    float t[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (live(j)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          t[0] += dv[j][e];
          t[1] += dv[j][e] * xv[j][e];
        }
      }
    t[0] = warp_sum(t[0]);
    t[1] = warp_sum(t[1]);
    group_sum<WR>(t, xch[gi][2], wr, lane, gi);
    const float m1 = t[0] / K, m2 = t[1] / K;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (live(j)) {
        float gv[4];
        unpack4_bf16(cur.g[j], gv);
        uint2 o;
        *reinterpret_cast<__nv_bfloat162*>(&o.x) = __floats2bfloat162_rn(
            rstd * (dv[j][0] - m1 - xv[j][0] * m2) + gv[0],
            rstd * (dv[j][1] - m1 - xv[j][1] * m2) + gv[1]);
        *reinterpret_cast<__nv_bfloat162*>(&o.y) = __floats2bfloat162_rn(
            rstd * (dv[j][2] - m1 - xv[j][2] * m2) + gv[2],
            rstd * (dv[j][3] - m1 - xv[j][3] * m2) + gv[3]);
        *reinterpret_cast<uint2*>(out + size_t(m) * K + 4 * (tr + 32 * WR * j)) = o;
      }
    cur = nxt;
  }
  // the block's partial row: its groups' sums added in group order
#pragma unroll
  for (int j = 0; j < CH; ++j)
    if (live(j)) {
      const int c = 4 * (tr + 32 * WR * j);
      *reinterpret_cast<float4*>(red + size_t(gi) * 2 * K + c) =
          make_float4(s1[j][0], s1[j][1], s1[j][2], s1[j][3]);
      *reinterpret_cast<float4*>(red + size_t(gi) * 2 * K + K + c) =
          make_float4(s2[j][0], s2[j][1], s2[j][2], s2[j][3]);
    }
  __syncthreads();
  for (int l = threadIdx.x; l < 2 * K; l += PB_THREADS) {
    float u = 0.0f;
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) u += red[size_t(q) * 2 * K + l];
    part[size_t(blockIdx.x) * 2 * K + l] = u;
  }
}

// dlns[l] (l < K) and dlnb[l - K] (l >= K) = sum over the P partial rows
// [P][2K], in a fixed order: each block owns 32 columns, its warps stride
// over the rows, then the warps' sums are added in order.
__global__ void __launch_bounds__(32 * PS_WARPS)
ln_pullback_sum_kernel(const float* __restrict__ part, float* __restrict__ dlns,
                       float* __restrict__ dlnb, int P, int K) {
  __shared__ float sred[PS_WARPS][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int l = blockIdx.x * 32 + tx, L = 2 * K;
  float s = 0.0f;
  if (l < L) {
#pragma unroll 4
    for (int p = ty; p < P; p += PS_WARPS) s += part[size_t(p) * L + l];
  }
  sred[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && l < L) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < PS_WARPS; ++i) t += sred[i][tx];
    if (l < K)
      dlns[l] = t;
    else
      dlnb[l - K] = t;
  }
}

// The pullback's launch: the instance, the persistent grid (no more blocks
// than give each group a row) and the second pass's blocks.
struct PbPlan {
  PbShape shape;
  int grid, sum_blocks;
};

inline PbPlan pb_plan(int M, int K, int sms) {
  PbPlan p;
  p.shape = pb_shape(K);
  const int groups = PB_WARPS / p.shape.wr;
  const int need = (M + groups - 1) / groups;
  p.grid = need < sms * PB_BLOCKS_PER_SM ? need : sms * PB_BLOCKS_PER_SM;
  p.sum_blocks = (2 * K + 31) / 32;
  return p;
}

inline bool pullback_shape_ok(int M, int K) {
  return M > 0 && K > 0 && K % 32 == 0 && K <= PB_MAX_K;
}

template <int WR, int CH>
cudaError_t launch_pullback(const void* dh, const void* x, const void* g, const void* lns,
                            float eps, void* out, float* part, int grid, int M, int K,
                            cudaStream_t st) {
  const size_t bytes = pullback_smem(K);
  const cudaError_t err = allow_smem(ln_pullback_kernel<WR, CH>, bytes);
  if (err != cudaSuccess) return err;
  ln_pullback_kernel<WR, CH><<<grid, PB_THREADS, bytes, st>>>(
      static_cast<const float*>(dh), static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const float*>(lns), eps, static_cast<bf16*>(out), part, M, K);
  return cudaGetLastError();
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

// The LN pullback from dh [M, K] f32: x, g [M, K] bf16, lns [K] f32, eps ->
// out = dx [M, K] bf16, dlns, dlnb [K] f32; work: f32 scratch of at least
// the workspace `mst_ln_pullback_geometry` reports. Needs K % 32 == 0 and
// K <= 1536.
extern "C" int mst_ln_pullback(const void* dh, const void* x, const void* g,
                               const void* lns, float eps, void* out, void* work,
                               long long work_bytes, void* dlns, void* dlnb, int M, int K,
                               void* stream) {
  using namespace mst;
  if (!pullback_shape_ok(M, K)) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const PbPlan p = pb_plan(M, K, sms);
  if (work == nullptr || work_bytes < 4LL * p.grid * 2 * K) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(work);
  const int inst = 10 * p.shape.wr + p.shape.ch;
  switch (inst) {
#define MST_PB(WR, CH)                                                                   \
  case 10 * WR + CH:                                                                     \
    err = launch_pullback<WR, CH>(dh, x, g, lns, eps, out, part, p.grid, M, K, st); \
    break;
    MST_PB(1, 2) MST_PB(1, 3) MST_PB(2, 2) MST_PB(2, 3) MST_PB(4, 2) MST_PB(4, 3)
#undef MST_PB
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  ln_pullback_sum_kernel<<<p.sum_blocks, 32 * PS_WARPS, 0, st>>>(
      part, static_cast<float*>(dlns), static_cast<float*>(dlnb), p.grid, K);
  return cudaGetLastError();
}

// The pullback's launch geometry for dh [M, K] on the current device: geo =
// {grid, threads, warps a row, chunks of 4 columns a lane, dynamic shared
// memory bytes, workspace bytes ([grid][2][K] f32 partials), second-pass
// blocks, second-pass threads}, as `mst_ln_pullback` sets them
// (`fused_block.ln_pullback_launch` mirrors it). The shapes it refuses
// return cudaErrorInvalidValue.
extern "C" int mst_ln_pullback_geometry(int M, int K, long long* geo) {
  using namespace mst;
  if (!pullback_shape_ok(M, K)) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const PbPlan p = pb_plan(M, K, sms);
  const long long g[8] = {p.grid, PB_THREADS, p.shape.wr, p.shape.ch,
                          static_cast<long long>(pullback_smem(K)), 4LL * p.grid * 2 * K,
                          p.sum_blocks, 32 * PS_WARPS};
  for (int i = 0; i < 8; ++i) geo[i] = g[i];
  return cudaSuccess;
}
