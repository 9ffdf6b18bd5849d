// gemm_wgrad: dW[K, N] = A[M, K]^T @ B[M, N] and db[N] = sum_m B[m, N], in
// f32 from bf16 A and B.
//
// Replaces the weight- and bias-gradient accumulators of the two Pallas
// backward kernels in mst_tpu/ops/fused_block.py: `_attn_bwd_kernel`
// (dWproj = o^T gz with dbproj, dWqkv = h^T dqkv with dbqkv) and
// `_mlp_bwd_kernel` (dW2 = u^T gz with db2, dW1 = h^T da with db1). The TPU
// kernel carried these f32 sums in VMEM across its sequential grid over the
// slices.
//
// Bound on the H100: at the path shapes the product is compute bound on the
// tensor cores (19-78 GFLOP against 50-250 MB of reads at ViT-S, M =
// 65,792; 1.66 TFLOP at giant2's w12). The GEMM is the persistent TMA +
// wgmma mainloop of gemm_sm90.cuh with A = X^T read in place (X [M, K] is
// K-contiguous, so A is MN-major: two boxes of [64 rows of M][64 columns
// of K] per stage, one per consumer warpgroup) and B = dY [M, N] (MN-major,
// as ln_gemm's weights); the reduction runs over M.
//
// Schedule: the [K, N] output is only 9-72 tiles of 128 x 128 at ViT-S, so
// the M rows are cut into `splits` chunks of `rows` (a multiple of 64, at
// most MAX_ROWS: one f32 accumulator's error grows with the rows it adds),
// and the persistent CTAs walk (split, tile) work units, split-major so
// that the units in flight read the same rows. Enough splits are taken to
// fill whole waves of the card's SMs. With one split dW is written
// directly; with more, each unit writes an f32 partial tile and
// `sum_partials_kernel` adds the partials in a fixed order (no atomics, the
// same bits on every run). Rows past M read as zeros (TMA), so a ragged
// last chunk adds nothing.
//
// db rides in the same pass: in the units of the first row of tiles, each
// consumer thread adds 8 columns of 4 rows of every stage's dY box (read
// from the swizzled shared tile before the stage is released), the
// warpgroup's 8 row groups are added in order through shared memory, and
// each warpgroup writes a partial row, added up with the other partials
// afterwards: no second read of dY.
#include "gemm_sm90.cuh"

namespace mst {
namespace {

using namespace sm90;

constexpr int MAX_ROWS = 8192;  // the longest accumulation chain (rows)

// The schedule of dW [K, N] over M rows on `sms` SMs.
struct Plan {
  int tiles, splits, rows, units, grid;
  long long workspace;  // bytes: dW partials (splits > 1) and db partials
};

inline Plan plan(int M, int K, int N, int sms) {
  Plan p;
  p.tiles = (K / BM) * (N / BN);
  const int need = (M + MAX_ROWS - 1) / MAX_ROWS;       // splits the chain limit needs
  const int waves = (need * p.tiles + sms - 1) / sms;   // whole waves of units
  const int fill = static_cast<int>(static_cast<long long>(waves) * sms / p.tiles);
  const int splits = fill > need ? fill : need;
  p.rows = ((M + splits - 1) / splits + BK - 1) / BK * BK;
  p.splits = (M + p.rows - 1) / p.rows;
  p.units = p.tiles * p.splits;
  p.grid = p.units < sms ? p.units : sms;
  p.workspace = 4LL * ((p.splits > 1 ? static_cast<long long>(p.splits) * K * N : 0) +
                       2LL * p.splits * N);
  return p;
}

inline bool wgrad_shape_ok(int M, int K, int N) {
  return M > 0 && K > 0 && N > 0 && K % BM == 0 && N % BN == 0;
}

// db: this thread's 8 columns (chunk t % 16 of the 128) of rows 32 wg + 4 q
// .. + 3 (q = t / 16) of each stage's two swizzled dY boxes.
struct ColumnSums {
  float (&acc)[8];
  int wg, t;
  bool on;
  __device__ __forceinline__ void operator()(const unsigned char* b) const {
    if (!on) return;
    const int j = t & 15, box = j >> 3, jj = j & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 32 * wg + 4 * (t >> 4) + i;
      float f[8];
      unpack8_bf16(*reinterpret_cast<const uint4*>(b + box * B_BOX + r * 128 +
                                                   ((jj ^ (r & 7)) << 4)),
                   f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += f[e];
    }
  }
};

__global__ void __launch_bounds__(THREADS, 1)
gemm_wgrad_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  float* __restrict__ dw, float* __restrict__ db_part, int M, int K, int N,
                  int rows, int splits) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  init_barriers(s);
  __syncthreads();
  const int tiles_n = N / BN;
  const int tiles = (K / BM) * tiles_n;
  const int units = tiles * splits;
  auto unit = [=](int u) {
    const int split = u / tiles, tile = u % tiles, k0 = split * rows;
    const int end = min(M, k0 + rows);
    const int tn = tile % tiles_n;
    return Work{(tile / tiles_n) * BM, tn * BN, tn * BN + 64, k0, (end - k0 + BK - 1) / BK};
  };
  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warp
    if (threadIdx.x == CONSUMERS * 128) producer<MN_MAJOR, MN_MAJOR>(s, &ta, &tb, units, unit);
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  float* epi = reinterpret_cast<float*>(s.epi) + wg * 64 * EPI_LD_F;
  uint32_t it = 0;
  float d[ACC];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Work w = unit(u);
    const int split = u / tiles;
    float bs[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) bs[e] = 0.0f;
    const bool sum_b = w.m0 == 0;  // the first row of tiles sums dY's columns
    consumer_tile<MN_MAJOR, MN_MAJOR>(s, wg, w.nk, it, d, ColumnSums{bs, wg, t, sum_b});
    wg_sync(wg);  // the previous unit's reads of the staging tile are done
    if (sum_b) {
      // the warpgroup's 8 row groups of each column, added in order
#pragma unroll
      for (int e = 0; e < 8; ++e) epi[(t >> 4) * 128 + (t & 15) * 8 + e] = bs[e];
      wg_sync(wg);
      float c = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) c += epi[q * 128 + t];
      db_part[(size_t(split) * 2 + wg) * N + w.c0 + t] = c;
      wg_sync(wg);
    }
    float* dst = dw + (splits > 1 ? size_t(split) * K * N : 0);
    const int r0 = w.m0 + 64 * wg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h) wg_sync(wg);
      stage_f32_half(epi, t, d, h);
      wg_sync(wg);
#pragma unroll
      for (int g = t; g < 64 * 16; g += 128) {
        const int r = g / 16, c = (g % 16) * 4;
        *reinterpret_cast<float4*>(dst + size_t(r0 + r) * N + w.c0 + 64 * h + c) =
            *reinterpret_cast<const float4*>(epi + r * EPI_LD_F + c);
      }
    }
  }
}

// Layout probes of the mainloop (`mst_gemm_probe`): a bare product per
// operand layout, C[M, N] f32 = A . B, for the card-side checks of
// chip_smoke.py, which hold each against torch.matmul before any epilogue
// is trusted. A wrong leading / stride byte offset in a shared-memory
// descriptor gives errors that still look like numbers, so each layout also
// has a planted instance with the two offsets swapped, which must fail. No
// path of the package launches these.
// LAYOUT 1 (gemm_dgrad's): a [M, K], b [N, K] -> c = a . b^T (B K-major).
// LAYOUT 2 (gemm_wgrad's): a [K, M], b [K, N] -> c = a^T . b (A MN-major).
template <int LAYOUT, bool SWAP>
__global__ void __launch_bounds__(THREADS, 1)
probe_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             float* __restrict__ c, int M, int N, int K) {
  constexpr int AM = LAYOUT == 2 ? MN_MAJOR : K_MAJOR;
  constexpr int BMJ = LAYOUT == 2 ? MN_MAJOR : K_MAJOR;
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw);
  init_barriers(s);
  __syncthreads();
  const int tiles_n = N / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int nk = K / BK;
  if (threadIdx.x >= CONSUMERS * 128) {
    if (threadIdx.x == CONSUMERS * 128)
      producer<AM, BMJ>(s, &ta, &tb, tiles, [=](int tile) {
        const int n0 = (tile % tiles_n) * BN;
        return Work{(tile / tiles_n) * BM, n0, n0 + 64, 0, nk};
      });
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  uint32_t it = 0;
  float d[ACC];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    consumer_tile<AM, BMJ, SWAP>(s, wg, nk, it, d);
    const int m0 = (tile / tiles_n) * BM + 64 * wg;
    const int n0 = (tile % tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int m = m0 + acc_row(t, i);
      if (m < M) c[size_t(m) * N + n0 + acc_col(t, i)] = d[i];
    }
  }
}

template <int LAYOUT, bool SWAP>
cudaError_t launch_probe(const void* a, const void* b, float* c, int M, int N, int K,
                         cudaStream_t st) {
  CUtensorMap ta, tb;
  cudaError_t err = LAYOUT == 2 ? tma_map_2d(&ta, a, K, M, BK, 64) : tma_map_2d(&ta, a, M, K, BM, BK);
  if (err == cudaSuccess)
    err = LAYOUT == 2 ? tma_map_2d(&tb, b, K, N, BK, 64) : tma_map_2d(&tb, b, N, K, BN, BK);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid(((M + BM - 1) / BM) * (N / BN), &grid);
  if (err == cudaSuccess) err = allow_smem(probe_kernel<LAYOUT, SWAP>, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  probe_kernel<LAYOUT, SWAP><<<grid, THREADS, SMEM_BYTES, st>>>(ta, tb, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mst

// a [M, K] bf16, b [M, N] bf16 -> dw [K, N] f32 and db [N] f32; work: f32
// scratch of work_bytes, at least the workspace `mst_wgrad_geometry`
// reports. Needs K % 128 == 0 and N % 128 == 0 (checked by the Python
// wrapper as well).
extern "C" int mst_gemm_wgrad(const void* a, const void* b, void* dw, void* db, void* work,
                              long long work_bytes, int M, int K, int N, void* stream) {
  using namespace mst;
  if (!wgrad_shape_ok(M, K, N)) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan p = plan(M, K, N, sms);
  if (work == nullptr || work_bytes < p.workspace) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(work);
  float* db_part = part + (p.splits > 1 ? size_t(p.splits) * K * N : 0);
  CUtensorMap ta, tb;
  err = tma_map_2d(&ta, a, M, K, BK, 64);
  if (err == cudaSuccess) err = tma_map_2d(&tb, b, M, N, BK, 64);
  if (err == cudaSuccess) err = allow_smem(gemm_wgrad_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_wgrad_kernel<<<p.grid, THREADS, SMEM_BYTES, st>>>(
      ta, tb, p.splits > 1 ? part : static_cast<float*>(dw), db_part, M, K, N, p.rows, p.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.splits > 1) {
    err = sum_partials(part, static_cast<float*>(dw), p.splits, K * N, st);
    if (err != cudaSuccess) return err;
  }
  return sum_partials(db_part, static_cast<float*>(db), 2 * p.splits, N, st);
}

// The launch geometry for a [M, K], b [M, N] on the current device: geo =
// {work units, grid, threads, stages, dynamic shared memory bytes, splits,
// rows per split, workspace bytes}, as `mst_gemm_wgrad` sets them
// (`fused_block.gemm_wgrad_launch` mirrors it). The shapes the kernel
// refuses return cudaErrorInvalidValue.
extern "C" int mst_wgrad_geometry(int M, int K, int N, long long* geo) {
  using namespace mst;
  if (!wgrad_shape_ok(M, K, N)) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan p = plan(M, K, N, sms);
  const long long g[8] = {p.units, p.grid, THREADS, STAGES, static_cast<long long>(SMEM_BYTES),
                          p.splits, p.rows, p.workspace};
  for (int i = 0; i < 8; ++i) geo[i] = g[i];
  return 0;
}

// layout 1: a [M, K], b [N, K] bf16 -> c [M, N] f32 = a . b^T; layout 2:
// a [K, M], b [K, N] bf16 -> c = a^T . b; swap != 0: the planted instance
// with LBO and SBO exchanged. Needs K % 64 == 0, N % 128 == 0 and, for
// layout 2, M % 128 == 0.
extern "C" int mst_gemm_probe(const void* a, const void* b, void* c, int M, int N, int K,
                              int layout, int swap, void* stream) {
  using namespace mst;
  if (M <= 0 || K <= 0 || N <= 0 || K % sm90::BK != 0 || N % sm90::BN != 0 ||
      (layout == 2 && M % sm90::BM != 0))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  if (layout == 1)
    return swap ? launch_probe<1, true>(a, b, out, M, N, K, st)
                : launch_probe<1, false>(a, b, out, M, N, K, st);
  if (layout == 2)
    return swap ? launch_probe<2, true>(a, b, out, M, N, K, st)
                : launch_probe<2, false>(a, b, out, M, N, K, st);
  return cudaErrorInvalidValue;
}
