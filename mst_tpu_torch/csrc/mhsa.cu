// mhsa: per-slice, per-head softmax attention over a packed qkv block.
// qkv [N*S, 3E] bf16 (columns [q | k | v], head h at h*64 inside each)
// -> o [N*S, E] bf16 (head h at columns h*64).
//
// Replaces the attention core of `_attn_any_kernel` (plain flags) and of
// `_attn_train_kernel` / `_mhsa(want_lse=True)` in
// mst_tpu/ops/fused_block.py. Same math and the same rounding
// points as the Pallas body: s = q.k^T * (log2(e) / sqrt(hd)) in f32,
// p = exp2(s - rowmax), l = rowsum(p) of the f32 p, P cast to bf16 before
// the P.V product (f32 accumulation), and the normalisation o = (P.V) / l
// applied to the [S, hd] output instead of to P, then cast to bf16. With
// `lse` set (training; NULL when serving) each row's base-2 log-sum-exp
// b = m + log2(l), in the scaled units of the softmax, goes to
// lse[(n * S + q) * heads + h] (JAX's [N, S, heads] layout), from which the
// backward (mhsa_bwd.cu) rebuilds p = exp2(s - b) in one pass.
//
// Bound on the H100: at S = 257, hd = 64 one (slice, head) is ~17 MFLOP of
// tensor-core work on ~100 KB of q/k/v, and the [S, S] scores are the
// largest intermediate. The TPU held them in VMEM; here one block owns a
// (slice, head, 64-query tile): K and V of the head (S <= 512 rows, zero
// padded to a multiple of 16) and the tile's f32 score rows all live in
// shared memory (158 KB at S = 257), so neither scores nor probabilities
// touch device memory. The softmax runs one warp per row; P is written back
// as bf16 over the first half of its own f32 score row, so no second
// buffer is needed. The ragged edge (keys j >= S) is masked in the softmax
// and the zero padding keeps P.V exact. At S > 400 the query tile drops to
// 32 rows to stay under the 227 KB shared-memory ceiling.
#include "common.cuh"

namespace mst {
namespace {

constexpr int HD = 64;         // head dim (every DINOv2 ViT size)
constexpr int THREADS = 256;   // 8 warps
constexpr int LDQ = HD + 8;    // bf16 stride of Q / K / V rows
constexpr int LDO = HD + 4;    // f32 stride of the output staging tile
constexpr int MAX_S = 512;     // FUSED_MAX_TOKENS
constexpr int PER_LANE = MAX_S / 32;

__host__ __device__ inline int pad16(int s) { return (s + 15) & ~15; }

struct Layout {
  size_t q, k, v, s, l, total;  // byte offsets
};

__host__ __device__ inline Layout layout(int bq, int S) {
  const int sp = pad16(S);
  Layout L;
  const size_t qb = size_t(bq) * LDQ * sizeof(bf16);
  size_t kb = size_t(sp) * LDQ * sizeof(bf16);
  const size_t ob = size_t(bq) * LDO * sizeof(float);  // staged in K's place
  if (ob > kb) kb = ob;
  const size_t vb = size_t(sp) * LDQ * sizeof(bf16);
  const size_t sb = size_t(bq) * (sp + 4) * sizeof(float);
  L.q = 0;
  L.k = L.q + qb;
  L.v = L.k + kb;
  L.s = L.v + vb;
  L.l = L.s + sb;
  L.total = L.l + size_t(bq) * sizeof(float);
  return L;
}

template <int BQ>
__global__ void __launch_bounds__(THREADS)
mhsa_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
            float* __restrict__ lse, int S, int E, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(BQ, S);
  const int sp = pad16(S);
  const int lds = sp + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  float* Os = reinterpret_cast<float*>(smem + L.k);  // reuses K after scores
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Ls = reinterpret_cast<float*>(smem + L.l);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row3 = size_t(3) * E;
  const bf16* base = qkv + size_t(n) * S * row3 + h * HD;

  // Load Q tile, K and V of this head; zero rows past S.
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < BQ * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    const int q = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * LDQ + col) =
        q < S ? *reinterpret_cast<const uint4*>(base + q * row3 + col) : zero;
  }
  for (int c = tid; c < sp * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    uint4 kv = zero, vv = zero;
    if (r < S) {
      kv = *reinterpret_cast<const uint4*>(base + r * row3 + E + col);
      vv = *reinterpret_cast<const uint4*>(base + r * row3 + 2 * E + col);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDQ + col) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LDQ + col) = vv;
  }
  __syncthreads();

  // Scores S = Q K^T * scale, f32, [BQ][sp].
  const int tiles_n = sp / 16;
  for (int t = warp; t < (BQ / 16) * tiles_n; t += THREADS / 32) {
    const int ti = t / tiles_n, tj = t % tiles_n;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qs + ti * 16 * LDQ + kk, LDQ);
      wmma::load_matrix_sync(fb, Ks + tj * 16 * LDQ + kk, LDQ);  // K^T
      wmma::mma_sync(acc, fa, fb, acc);
    }
#pragma unroll
    for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= scale;
    wmma::store_matrix_sync(Ss + ti * 16 * lds + tj * 16, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  // Softmax rows: exp2 against the row max, f32 row sum; P goes back as
  // bf16 over the first half of the same row (all reads precede the writes).
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float* srow = Ss + r * lds;
    float v[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < S ? srow[j] : -INFINITY;
      mx = fmaxf(mx, v[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.0f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < S ? exp2f(v[i] - mx) : 0.0f;
      l += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      if (j < sp) prow[j] = __float2bfloat16(v[i]);
    }
    if (lane == 0) {
      Ls[r] = l;
      if (lse != nullptr && q0 + r < S)
        lse[(size_t(n) * S + q0 + r) * gridDim.y + h] = mx + log2f(l);
    }
  }
  __syncthreads();

  // O = P V (P as bf16 rows of stride 2 * lds elements), staged in f32.
  const int ldp = 2 * lds;
  const bf16* Ps = reinterpret_cast<const bf16*>(Ss);
  for (int t = warp; t < (BQ / 16) * (HD / 16); t += THREADS / 32) {
    const int ti = t / (HD / 16), tj = t % (HD / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < sp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, Ps + ti * 16 * ldp + kk, ldp);
      wmma::load_matrix_sync(fb, Vs + kk * LDQ + tj * 16, LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(Os + ti * 16 * LDO + tj * 16, acc, LDO, wmma::mem_row_major);
  }
  __syncthreads();

  for (int g = tid; g < BQ * (HD / 8); g += THREADS) {
    const int r = g / (HD / 8), c = (g % (HD / 8)) * 8;
    const int q = q0 + r;
    if (q >= S) continue;
    float v[8];
    const float l = Ls[r];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Os[r * LDO + c + e] / l;
    *reinterpret_cast<uint4*>(out + (size_t(n) * S + q) * E + h * HD + c) = pack8_bf16(v);
  }
}

constexpr size_t SMEM_CAP = 227 * 1024;

}  // namespace
}  // namespace mst

// qkv [N*S, 3E] bf16 -> out [N*S, E] bf16, and lse [N*S, num_heads] f32
// or NULL; E == num_heads * 64, S <= 512. scale = log2(e) / sqrt(64).
extern "C" int mst_mhsa(const void* qkv, void* out, void* lse, int N, int S,
                        int E, int num_heads, float scale, void* stream) {
  using namespace mst;
  if (N <= 0 || N > 65535 || S <= 0 || S > MAX_S || num_heads <= 0 ||
      num_heads > 65535 || E != num_heads * HD)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  float* b = static_cast<float*>(lse);
  const Layout l64 = layout(64, S);
  cudaError_t err;
  if (l64.total <= SMEM_CAP) {
    err = allow_smem(mhsa_kernel<64>, l64.total);
    if (err != cudaSuccess) return err;
    dim3 grid((S + 63) / 64, num_heads, N);
    mhsa_kernel<64><<<grid, THREADS, l64.total, st>>>(in, o, b, S, E, scale);
  } else {
    const Layout l32 = layout(32, S);
    err = allow_smem(mhsa_kernel<32>, l32.total);
    if (err != cudaSuccess) return err;
    dim3 grid((S + 31) / 32, num_heads, N);
    mhsa_kernel<32><<<grid, THREADS, l32.total, st>>>(in, o, b, S, E, scale);
  }
  return cudaGetLastError();
}
