// block_tail: everything of a ViT block after its attention core, in one
// launch, for a tile of whole rows:
//   x1  = bf16(x + (o @ wproj + bproj))
//   h   = bf16(LN2(x1))
//   a   = bf16(gelu_tanh(bf16(h @ w1 + b1)))
//   out = bf16(x1 + (a @ w2 + b2))
// x, o, out [M, 384] bf16; wproj [384, 384], w1 [384, 1536], w2 [1536, 384]
// bf16 (flax Dense layout); biases and LN2 scale / bias f32.
//
// Replaces the tail of `tools/bench_block_fusion.py` `_block_kernel` (:75,
// queue B row 17): the TPU program runs a whole ViT block per slice (LN1,
// qkv, `_mhsa`, proj, residual, LN2, fc1, GELU, fc2, residual) in VMEM. On
// the H100 a slice's qkv (592 KB at S = 257) exceeds the 232,448 bytes a
// block may hold, and attention needs every key of its slice, so the "one
// kernel per block" form is `ln_gemm` (LN1 + qkv) -> `mhsa` -> this
// kernel: 3 launches a block against the shipped layout's 5 (`ln_gemm` ->
// `mhsa` -> `gemm_residual` -> `ln_gemm` (GELU) -> `gemm_residual`, the
// tool's `_attn_kernel` :67 + `_mlp_kernel` :71). Everything after the
// attention core is row-local, so it fuses: x1 and the [rows, 1536] GELU
// hidden never reach device memory. The rounding points are the tool's
// `_mlp_half`, which rounds fc1 + b1 to bf16 before the GELU (the shipped
// `ln_gemm` takes the GELU of the f32 value and rounds once).
//
// Bound on the H100: at the tool's shape (M = 32,896 rows) the three
// products are 87 GFLOP on 2 x 25 MB of o and x in, 25 MB out and 2.7 MB of
// weights: 0.088 ms by FLOPs against 0.023 ms by bytes, so the tensor cores
// bound it. The split layout moves the [M, 1536] hidden out and back (2 x
// 101 MB) and x1 out and back twice (75 MB) more. One block owns BM = 32
// whole rows (LN2 needs all 384 columns): in shared memory the o tile, then
// h, in one [32][392] bf16 tile; x1 [32][392] bf16; the hidden [32][1544]
// bf16 (96.5 KB); an f32 [32][388] epilogue tile; and a double-buffered
// cp.async stage of 16 weight rows x 384 columns, 223,744 bytes in all, one
// block per SM. The products are bf16 WMMA (16x16x16, f32 accumulators): 8
// warps as 2 (16 rows) x 4 (96 columns, six fragments); fc1 runs as four
// 384-column chunks. Every weight row is read by every block from L2 (2.7 MB
// a block): the occupancy of 8 warps per SM and that re-read are what a
// faster form (wgmma, a persistent grid, BM = 64 over two SMs with a
// cluster) would attack.
#include "common.cuh"

namespace mst {
namespace {

constexpr int BM = 32;        // rows per block
constexpr int E = 384;        // model width
constexpr int F = 1536;       // hidden width
constexpr int BK = 16;        // weight rows per pipeline stage
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (96-column groups)
constexpr int LDE = E + 8;    // bf16 stride of the E-wide tiles and stages
constexpr int LDF = F + 8;    // bf16 stride of the hidden
constexpr int LDC = E + 4;    // f32 stride of the epilogue tile
constexpr int FRAGS = E / 4 / 16;  // 6 accumulators per warp

constexpr size_t A_OFF = 0;                                    // o, then h
constexpr size_t X_OFF = A_OFF + size_t(BM) * LDE * 2;         // x1
constexpr size_t H_OFF = X_OFF + size_t(BM) * LDE * 2;         // hidden
constexpr size_t C_OFF = H_OFF + size_t(BM) * LDF * 2;         // f32 tile
constexpr size_t W_OFF = C_OFF + size_t(BM) * LDC * 4;         // stages
constexpr size_t SMEM_BYTES = W_OFF + size_t(2) * BK * LDE * 2;  // 223,744

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc (this warp's 16 x 96 part of the [32 x 384] result) = A[32 x K] .
// W[K, col0 .. col0 + 384), A in shared memory (stride lda), W in device
// memory (row stride ldw), streamed through the two stages at Ws. Every
// thread calls it; on return the stages are free.
template <int K>
__device__ __forceinline__ void tile_gemm(Acc (&acc)[FRAGS], const bf16* As, int lda,
                                          const bf16* __restrict__ w, int ldw, int col0,
                                          bf16* Ws, int wm, int wn) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < FRAGS; ++j) wmma::fill_fragment(acc[j], 0.0f);
  auto load = [&](int kt, int buf) {
    bf16* dst = Ws + buf * BK * LDE;
    const bf16* src = w + size_t(kt) * BK * ldw + col0;
    for (int c = tid; c < BK * (E / 8); c += THREADS) {
      const int r = c / (E / 8), col = (c % (E / 8)) * 8;
      cp_async16(dst + r * LDE + col, src + size_t(r) * ldw + col, 16);
    }
  };
  constexpr int nk = K / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Wst = Ws + (kt & 1) * BK * LDE;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, As + wm * 16 * lda + kt * BK, lda);
#pragma unroll
    for (int j = 0; j < FRAGS; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Wst + wn * (E / 4) + j * 16, LDE);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_acc(float* Cs, Acc (&acc)[FRAGS], int wm, int wn) {
#pragma unroll
  for (int j = 0; j < FRAGS; ++j)
    wmma::store_matrix_sync(Cs + wm * 16 * LDC + wn * (E / 4) + j * 16, acc[j], LDC,
                            wmma::mem_row_major);
}

__global__ void __launch_bounds__(THREADS)
block_tail_kernel(const bf16* __restrict__ o, const bf16* __restrict__ x,
                  const bf16* __restrict__ wproj, const float* __restrict__ bproj,
                  const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                  const bf16* __restrict__ w1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ b2,
                  bf16* __restrict__ out, int M, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + A_OFF);
  bf16* Xs = reinterpret_cast<bf16*>(smem + X_OFF);
  bf16* Hs = reinterpret_cast<bf16*>(smem + H_OFF);
  float* Cs = reinterpret_cast<float*>(smem + C_OFF);
  bf16* Ws = reinterpret_cast<bf16*>(smem + W_OFF);

  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  // The o tile; rows past M are zero-filled (and never stored).
  for (int c = tid; c < BM * (E / 8); c += THREADS) {
    const int r = c / (E / 8), col = (c % (E / 8)) * 8;
    const int m = m0 + r;
    cp_async16(As + r * LDE + col, o + size_t(m < M ? m : M - 1) * E + col, m < M ? 16 : 0);
  }
  cp_async_commit();

  Acc acc[FRAGS];
  // proj + bias + residual -> x1
  tile_gemm<E>(acc, As, LDE, wproj, E, 0, Ws, wm, wn);
  store_acc(Cs, acc, wm, wn);
  __syncthreads();
  for (int g = tid; g < BM * (E / 8); g += THREADS) {
    const int r = g / (E / 8), c = (g % (E / 8)) * 8;
    const int m = m0 + r;
    float v[8];
    if (m < M) {
      float xv[8];
      unpack8_bf16(*reinterpret_cast<const uint4*>(x + size_t(m) * E + c), xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = xv[e] + (Cs[r * LDC + c + e] + bproj[c + e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.0f;
    }
    *reinterpret_cast<uint4*>(Xs + r * LDE + c) = pack8_bf16(v);
  }
  __syncthreads();

  // LN2, one warp per row, two-pass statistics in f32 -> h over the o tile
  for (int r = warp; r < BM; r += THREADS / 32) {
    const bf16* xr = Xs + r * LDE;
    float sum = 0.0f;
    for (int k = lane; k < E; k += 32) sum += __bfloat162float(xr[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / E;
    float sq = 0.0f;
    for (int k = lane; k < E; k += 32) {
      const float d = __bfloat162float(xr[k]) - mean;
      sq += d * d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rstd = rsqrtf(sq / E + eps);
    for (int k = lane; k < E; k += 32)
      As[r * LDE + k] =
          __float2bfloat16((__bfloat162float(xr[k]) - mean) * rstd * ln_s[k] + ln_b[k]);
  }
  __syncthreads();

  // fc1 in four 384-column chunks: hidden = bf16(gelu(bf16(h @ w1 + b1)))
  for (int chunk = 0; chunk < F / E; ++chunk) {
    const int col0 = chunk * E;
    tile_gemm<E>(acc, As, LDE, w1, F, col0, Ws, wm, wn);
    store_acc(Cs, acc, wm, wn);
    __syncthreads();
    for (int g = tid; g < BM * (E / 8); g += THREADS) {
      const int r = g / (E / 8), c = (g % (E / 8)) * 8;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = apply_act(round_bf16(Cs[r * LDC + c + e] + b1[col0 + c + e]), ACT_GELU_TANH);
      *reinterpret_cast<uint4*>(Hs + r * LDF + col0 + c) = pack8_bf16(v);
    }
    __syncthreads();
  }

  // fc2 + bias + residual on x1
  tile_gemm<F>(acc, Hs, LDF, w2, E, 0, Ws, wm, wn);
  store_acc(Cs, acc, wm, wn);
  __syncthreads();
  for (int g = tid; g < BM * (E / 8); g += THREADS) {
    const int r = g / (E / 8), c = (g % (E / 8)) * 8;
    const int m = m0 + r;
    if (m >= M) continue;
    float xv[8], v[8];
    unpack8_bf16(*reinterpret_cast<const uint4*>(Xs + r * LDE + c), xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = xv[e] + (Cs[r * LDC + c + e] + b2[c + e]);
    *reinterpret_cast<uint4*>(out + size_t(m) * E + c) = pack8_bf16(v);
  }
}

}  // namespace
}  // namespace mst

// o, x [M, 384] bf16 (the attention core's output and the block's input),
// wproj [384, 384], w1 [384, 1536], w2 [1536, 384] bf16, bproj / ln_s /
// ln_b / b2 [384] and b1 [1536] f32 -> out [M, 384] bf16. E and F must be
// 384 and 1536 (ViT-S, the tool's widths).
extern "C" int mst_block_tail(const void* o, const void* x, const void* wproj, const void* bproj,
                              const void* ln_s, const void* ln_b, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out, int M, int E_, int F_,
                              float eps, void* stream) {
  using namespace mst;
  if (M <= 0 || E_ != E || F_ != F) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(block_tail_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  block_tail_kernel<<<(M + BM - 1) / BM, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(x), static_cast<const bf16*>(wproj),
      static_cast<const float*>(bproj), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), M, eps);
  return cudaGetLastError();
}
