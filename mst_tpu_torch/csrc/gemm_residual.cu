// gemm_residual: out[M, N] = x[M, N] + ls[N] * (a[M, K] @ W[K, N] + b[N]),
// bf16 in and out, epilogue in f32.
//
// Replaces the second half of six Pallas kernels in
// mst_tpu/ops/fused_block.py: the output projection + LayerScale + residual
// of `_attn_any_kernel` / `_attn_train_kernel` (K = E) and the fc2 / w3 +
// LayerScale + residual of `_mlp_kernel` / `_mlp_train_kernel` (K = 4E) and
// `_swiglu_kernel` / `_swiglu_train_kernel` (K = F). As in the Pallas
// bodies the product accumulates in f32, bias and LayerScale apply in f32,
// the residual is added to the f32 value of x, and the sum is cast to bf16
// once.
//
// Without x (x = NULL at the entry point) it is the plain product out =
// ls * (a @ W + b): the qkv product of the softmax experiment
// `tools/bench_attn_softmax.py` `make_kernel` (:34, queue B row 18), which
// has no LayerNorm before it (zero bias there).
//
// gemm_dls (the same product, another epilogue) is the LayerScale step of
// the backward kernels `_attn_bwd_kernel` / `_mlp_bwd_kernel` and of the XLA
// `_swiglu_train_bwd`: it recomputes z = a @ W + b in f32, writes gz =
// bf16(g * ls), and sums g * z over each warpgroup's 64 rows into a partial
// row of dls, which `sum_partials_kernel` then adds up over the row blocks
// in a fixed order.
//
// Bound on the H100: at M = 65,792 the ViT-S products and ViT-B's proj
// (19-78 GFLOP against 150-300 MB) are bound by bytes, the others (ViT-B's
// fc2, ViT-L's, giant2's proj and w3: 138-828 GFLOP) by the tensor cores.
// The product is the persistent TMA + wgmma GEMM of gemm_sm90.cuh, as
// ln_gemm's (A = a K-major, W [K, N] read MN-major in place, 128 x 128
// tiles, rows of a past M read as zeros). The TPU kept the residual stream
// in VMEM between the product and the add; here the add rides the
// epilogue, so x is read once and y written once, and no f32 intermediate
// reaches device memory:
// - before each unit's product, every consumer thread starts `cp.async`
//   copies of its share of the warpgroup's [64][128] slab of x (gemm_dls:
//   of g) into the warpgroup's bf16 staging tile, rows past M copied from
//   row M - 1, so the read overlaps the product;
// - after the product each thread reads x at its accumulators' places,
//   writes the bf16 result back into the same places, and the tile leaves
//   as 16-byte row stores (`store`);
// - gemm_dls keeps g * z in the accumulators, masked to 0 for rows past M
//   (a's rows there are zeros but b and the copied g are not), writes
//   gz as above, then sums each column over the 64 rows in a fixed order:
//   each thread's two rows (r, r + 8), then the warp's 8 row pairs by a
//   butterfly over the lanes 4, 8 and 16 apart, then the 4 warps' sums in
//   order through the staging tile.
#include "gemm_sm90.cuh"

namespace mst {
namespace {

using namespace sm90;

// The epilogues: the residual sum, the product alone (x = NULL), and the
// LayerScale step of the backward.
enum Mode : int { RESIDUAL = 0, PRODUCT = 1, DLS = 2 };

// Output tiles of [M, N]: 128 x 128.
__host__ __device__ inline int residual_tiles(int M, int N) {
  return ((M + BM - 1) / BM) * (N / BN);
}

inline bool residual_shape_ok(int M, int K, int N) {
  return M > 0 && K >= BK && N >= BN && K % BK == 0 && N % BN == 0;
}

// MODE as above; LS: apply the LayerScale (gemm_dls always does). x is g
// for DLS and out is gz; work [ceil(M / 64)][N] receives DLS's partials.
template <int MODE, bool LS>
__device__ __forceinline__ void residual_body(const CUtensorMap* ta, const CUtensorMap* tb,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ ls,
                                              const bf16* __restrict__ x, bf16* __restrict__ out,
                                              float* __restrict__ work, int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  init_barriers(s);
  __syncthreads();
  const int tiles_n = N / BN;
  const int tiles = residual_tiles(M, N);
  const int nk = K / BK;
  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warp
    if (threadIdx.x == CONSUMERS * 128)
      producer(s, ta, tb, tiles, [=](int tile) {
        const int n0 = (tile % tiles_n) * BN;
        return Work{(tile / tiles_n) * BM, n0, n0 + 64, 0, nk};
      });
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  bf16* epi = s.epi + wg * 64 * EPI_LD;
  uint32_t it = 0;
  float d[ACC];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM + 64 * wg;
    const int n0 = (tile % tiles_n) * BN;
    wg_sync(wg);  // the previous unit's reads of the staging tile are done
    if constexpr (MODE != PRODUCT) load_slab(epi, t, x, N, m0, n0, M);
    consumer_tile(s, wg, nk, it, d);
    if constexpr (MODE != PRODUCT) {
      cp_async_wait<0>();
      wg_sync(wg);  // every thread's copies have landed
    }
    // each thread's accumulators i, i + 1 are two neighbouring columns of
    // one row; the staging tile holds x (g) at the same places
#pragma unroll
    for (int i = 0; i < ACC; i += 2) {
      const int r = acc_row(t, i), c = acc_col(t, i);
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + n0 + c));
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(epi + r * EPI_LD + c);
      float y0 = d[i] + bv.x, y1 = d[i + 1] + bv.y;
      if constexpr (MODE == DLS) {
        const float2 lv = __ldg(reinterpret_cast<const float2*>(ls + n0 + c));
        const float2 gv = __bfloat1622float2(*p);
        const bool live = m0 + r < M;
        d[i] = live ? gv.x * y0 : 0.0f;
        d[i + 1] = live ? gv.y * y1 : 0.0f;
        *p = __floats2bfloat162_rn(gv.x * lv.x, gv.y * lv.y);
      } else {
        if constexpr (LS) {
          const float2 lv = __ldg(reinterpret_cast<const float2*>(ls + n0 + c));
          y0 *= lv.x;
          y1 *= lv.y;
        }
        if constexpr (MODE == RESIDUAL) {
          const float2 xv = __bfloat1622float2(*p);
          y0 = xv.x + y0;
          y1 = xv.y + y1;
        }
        *p = __floats2bfloat162_rn(y0, y1);
      }
    }
    wg_sync(wg);
    store<16>(epi, t, out, N, m0, M, [=](int c) { return n0 + c; });
    if constexpr (MODE == DLS) {
      // column sums of g * z over the 64 rows: rows r and r + 8, then the
      // warp's 8 row pairs (lanes 4, 8, 16 apart), then the warps in order
      float* part = reinterpret_cast<float*>(epi);  // [4 warps][BN]
      const int lane = t & 31, warp = t >> 5;
      wg_sync(wg);  // the store has read the staging tile
#pragma unroll
      for (int i = 0; i < ACC; i += 4) {
        float s0 = d[i] + d[i + 2], s1 = d[i + 1] + d[i + 3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (lane < 4)
          *reinterpret_cast<float2*>(part + warp * BN + acc_col(t, i)) = make_float2(s0, s1);
      }
      wg_sync(wg);
      if (m0 < M)
        work[size_t(m0 / 64) * N + n0 + t] =
            ((part[t] + part[BN + t]) + part[2 * BN + t]) + part[3 * BN + t];
    }
  }
}

template <int MODE, bool LS>
__global__ void __launch_bounds__(THREADS, 1)
gemm_residual_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const float* __restrict__ bias, const float* __restrict__ ls,
                     const bf16* __restrict__ x, bf16* __restrict__ out, int M, int K, int N) {
  residual_body<MODE, LS>(&ta, &tb, bias, ls, x, out, nullptr, M, K, N);
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_dls_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const float* __restrict__ bias, const float* __restrict__ ls,
                const bf16* __restrict__ g, bf16* __restrict__ gz, float* __restrict__ work,
                int M, int K, int N) {
  residual_body<DLS, true>(&ta, &tb, bias, ls, g, gz, work, M, K, N);
}

// The TMA maps of a [M, K] (128 x 64 boxes) and w [K, N] (64 x 64 boxes),
// and the persistent grid.
cudaError_t prepare(const void* a, const void* w, int M, int K, int N, CUtensorMap* ta,
                    CUtensorMap* tb, int* grid) {
  cudaError_t err = tma_map_2d(ta, a, M, K, BM, BK);
  if (err == cudaSuccess) err = tma_map_2d(tb, w, K, N, BK, 64);
  if (err == cudaSuccess) err = persistent_grid(residual_tiles(M, N), grid);
  return err;
}

template <int MODE, bool LS>
cudaError_t launch_residual(const void* a, const void* w, const void* bias, const void* ls,
                            const void* x, void* out, int M, int K, int N, cudaStream_t st) {
  CUtensorMap ta, tb;
  int grid = 0;
  cudaError_t err = prepare(a, w, M, K, N, &ta, &tb, &grid);
  if (err == cudaSuccess) err = allow_smem(gemm_residual_kernel<MODE, LS>, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_residual_kernel<MODE, LS><<<grid, THREADS, SMEM_BYTES, st>>>(
      ta, tb, static_cast<const float*>(bias), static_cast<const float*>(ls),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mst

// a [M, K] bf16, w [K, N] bf16 (flax Dense layout), bias [N] f32, ls [N] f32
// or NULL (no LayerScale), x [M, N] bf16 or NULL (no residual) -> out [M, N]
// bf16. Needs K % 64 == 0 and N % 128 == 0 (checked by the Python wrapper as
// well).
extern "C" int mst_gemm_residual(const void* a, const void* w, const void* bias,
                                 const void* ls, const void* x, void* out, int M,
                                 int K, int N, void* stream) {
  using namespace mst;
  if (!residual_shape_ok(M, K, N)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x != nullptr)
    return ls != nullptr ? launch_residual<RESIDUAL, true>(a, w, bias, ls, x, out, M, K, N, st)
                         : launch_residual<RESIDUAL, false>(a, w, bias, ls, x, out, M, K, N, st);
  return ls != nullptr ? launch_residual<PRODUCT, true>(a, w, bias, ls, x, out, M, K, N, st)
                       : launch_residual<PRODUCT, false>(a, w, bias, ls, x, out, M, K, N, st);
}

// a [M, K] bf16, w [K, N] bf16, bias [N] f32, ls [N] f32, g [M, N] bf16 ->
// gz [M, N] bf16 = g * ls and dls [N] f32 = sum_m g * (a @ w + bias).
// work: ceil(M / 64) * N f32 (the per-64-row partials). Needs K % 64 == 0
// and N % 128 == 0.
extern "C" int mst_gemm_dls(const void* a, const void* w, const void* bias,
                            const void* ls, const void* g, void* gz, void* work,
                            void* dls, int M, int K, int N, void* stream) {
  using namespace mst;
  if (!residual_shape_ok(M, K, N)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  int grid = 0;
  cudaError_t err = prepare(a, w, M, K, N, &ta, &tb, &grid);
  if (err == cudaSuccess) err = allow_smem(gemm_dls_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_dls_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      ta, tb, static_cast<const float*>(bias), static_cast<const float*>(ls),
      static_cast<const bf16*>(g), static_cast<bf16*>(gz), static_cast<float*>(work), M, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(static_cast<const float*>(work), static_cast<float*>(dls),
                      (M + 63) / 64, N, st);
}

// The launch geometry of both kernels for a [M, K] -> [M, N] on the current
// device: geo = {tiles, grid, threads, stages, dynamic shared memory bytes,
// rows of gemm_dls's work (one per 64 rows of a)}, as the launches set them
// (`fused_block.gemm_residual_launch` mirrors it). The shapes the kernels
// refuse return cudaErrorInvalidValue.
extern "C" int mst_residual_geometry(int M, int K, int N, int* geo) {
  using namespace mst;
  if (!residual_shape_ok(M, K, N)) return cudaErrorInvalidValue;
  const int tiles = residual_tiles(M, N);
  int grid = 0;
  const cudaError_t err = sm90::persistent_grid(tiles, &grid);
  if (err != cudaSuccess) return err;
  const int g[6] = {tiles, grid, sm90::THREADS, sm90::STAGES,
                    static_cast<int>(sm90::SMEM_BYTES), (M + 63) / 64};
  for (int i = 0; i < 6; ++i) geo[i] = g[i];
  return cudaSuccess;
}
