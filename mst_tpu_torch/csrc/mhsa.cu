// mhsa: per-slice, per-head softmax attention over a packed qkv block.
// qkv [N*S, 3E] bf16 (columns [q | k | v], head h at h*64 inside each)
// -> o [N*S, E] bf16 (head h at columns h*64).
//
// Replaces the attention core of `_attn_any_kernel` and of
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
//
// The explainability outputs (the flags `want_row`, `carry` and `abnar` of
// `_attn_any_kernel`, sub-layers `fused_attention_sublayer_with_row`
// :1479, `_rollout` :1535, `_abnar` :1503) are read from the f32 p and l
// while a warp holds its row in registers (P.V reads only P's bf16 copy),
// so the probabilities never reach device memory:
// - row: the block with q0 == 0 writes row 0's p / l, [N, heads, S] f32;
// - carry: new[j] = sum_q carry[q] * (1 / l_q) * p[q, j]. The sum crosses
//   the query tiles, so each lane keeps its warp's rows' sum in registers,
//   the 8 warps are added in shared memory (in V's place, free after P.V),
//   each block writes one partial [S] per (tile, slice, head), and
//   `sum_partials` adds the tiles in a fixed order: no float atomics, so
//   two runs give the same bits;
// - abnar: the head mean crosses the head blocks, so its kernel is another
//   grid, one block per (64-, 32- or 16-query tile, slice) that runs the
//   heads one after the other and keeps the f32 head sum sum_h p / l of its
//   rows in shared memory (69,632 bytes at BQ = 64, S = 257; 228,096 bytes
//   in all, under the 232,448 a block may have; BQ = 32 up to S = 416, and
//   BQ = 16 above, up to S = 512: 215,616 bytes at S = 512), summed in
//   head order as the Pallas body does; its epilogue adds I,
//   row-normalises and writes each row of the [N, S, S] f32 factor once.
//   Per-head partials in device memory with a second pass would write and
//   read 406 MB more per block at N = 256.
//
// RoPE (the `has_rope` flag of `_attn_any_kernel`, sub-layers
// `fused_attention_sublayer_rope` :1435 and `_rope_with_row` :1582, the
// rope_cos of `_rollout` / `_abnar`, and `_attn_train_kernel`'s rope; the
// DINOv3 encoder) is the template flag ROPE of both kernels: q and k are
// rotated where `attend` loads them into shared memory, pair by pair in f32
// from the bf16 qkv and the [S, 64] f32 cos / sin tables (`rope8` in
// common.cuh), and stored as bf16, which is where `_mhsa` rounds them. The
// tables (51 KB each at S = 201) are read per element, as the Pallas body
// reads them, and stay in L2; shared memory does not grow, and the LSE,
// row, carry and Abnar outputs read the softmax of the rotated scores as
// before. The kernels without ROPE carry no code of it.
#include "common.cuh"

namespace mst {
namespace {

constexpr int HD = 64;         // head dim (every DINOv2 ViT size)
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
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

// Shared memory of the Abnar kernel: the attention layout, then the f32
// head sum [BQ][pad16(S)] at a 16-byte boundary.
__host__ __device__ inline size_t abnar_sum_offset(int bq, int S) {
  return (layout(bq, S).total + 15) & ~size_t(15);
}

__host__ __device__ inline size_t abnar_bytes(int bq, int S) {
  return abnar_sum_offset(bq, S) + size_t(bq) * pad16(S) * sizeof(float);
}

// One (query tile, head, slice): loads (q and k rotated by the [S, 64]
// f32 tables rcos / rsin when ROPE), scores, softmax, P.V, o written.
// `on_row(r, v, l, mx)` runs in the softmax for each row r of the tile,
// with the warp's lanes holding v[i] = p[r, lane + 32 i] (f32, 0 past S)
// in registers, the row sum l and the row max mx: the f32 probabilities,
// of which P.V reads only the bf16 copy. On return every thread has passed
// the barrier after P.V, so V's shared memory is free; Q, K (the output
// staging), the scores and l are not.
template <int BQ, bool ROPE, class RowFn>
__device__ __forceinline__ void attend(const bf16* __restrict__ qkv,
                                       bf16* __restrict__ out,
                                       const float* __restrict__ rcos,
                                       const float* __restrict__ rsin,
                                       unsigned char* smem, int n, int h,
                                       int q0, int S, int E, float scale,
                                       RowFn&& on_row) {
  const Layout L = layout(BQ, S);
  const int sp = pad16(S);
  const int lds = sp + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  float* Os = reinterpret_cast<float*>(smem + L.k);  // reuses K after scores
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Ls = reinterpret_cast<float*>(smem + L.l);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row3 = size_t(3) * E;
  const bf16* base = qkv + size_t(n) * S * row3 + h * HD;

  // Load Q tile, K and V of this head (q and k rotated with ROPE); zero
  // rows past S.
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < BQ * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    const int q = q0 + r;
    uint4 qv = zero;
    if (q < S) {
      qv = *reinterpret_cast<const uint4*>(base + q * row3 + col);
      if (ROPE) qv = rope8(qv, rcos + q * HD + col, rsin + q * HD + col);
    }
    *reinterpret_cast<uint4*>(Qs + r * LDQ + col) = qv;
  }
  for (int c = tid; c < sp * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    uint4 kv = zero, vv = zero;
    if (r < S) {
      kv = *reinterpret_cast<const uint4*>(base + r * row3 + E + col);
      vv = *reinterpret_cast<const uint4*>(base + r * row3 + 2 * E + col);
      if (ROPE) kv = rope8(kv, rcos + r * HD + col, rsin + r * HD + col);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDQ + col) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LDQ + col) = vv;
  }
  __syncthreads();

  // Scores S = Q K^T * scale, f32, [BQ][sp].
  const int tiles_n = sp / 16;
  for (int t = warp; t < (BQ / 16) * tiles_n; t += WARPS) {
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
  for (int r = warp; r < BQ; r += WARPS) {
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
    if (lane == 0) Ls[r] = l;
    on_row(r, v, l, mx);
  }
  __syncthreads();

  // O = P V (P as bf16 rows of stride 2 * lds elements), staged in f32.
  const int ldp = 2 * lds;
  const bf16* Ps = reinterpret_cast<const bf16*>(Ss);
  for (int t = warp; t < (BQ / 16) * (HD / 16); t += WARPS) {
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

// Grid (query tiles, heads, N). lse: NULL when not wanted. ROW: row [N,
// heads, S] out. CARRY: carry [N, heads, S] in, part [tiles, N, heads, S]
// out. ROPE: rcos / rsin [S, 64] f32 in. All are template flags, so the
// plain kernel carries no code of theirs.
template <int BQ, bool ROW, bool CARRY, bool ROPE>
__global__ void __launch_bounds__(THREADS)
mhsa_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
            float* __restrict__ lse, float* __restrict__ row,
            const float* __restrict__ carry, float* __restrict__ part,
            const float* __restrict__ rcos, const float* __restrict__ rsin, int S,
            int E, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, H = gridDim.y;
  const int n = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t nh = size_t(n) * H + h;
  float cacc[PER_LANE];  // CARRY: sum over this warp's rows of r_q * p[q, j]
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) cacc[i] = 0.0f;

  attend<BQ, ROPE>(qkv, out, rcos, rsin, smem, n, h, q0, S, E, scale,
                   [&](int r, const float (&v)[PER_LANE], float l, float mx) {
    const int q = q0 + r;  // rows q >= S are the ragged tile's zero rows
    if (lse != nullptr && lane == 0 && q < S)
      lse[(size_t(n) * S + q) * H + h] = mx + log2f(l);
    if (ROW && q == 0) {
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int j = lane + 32 * i;
        if (j < S) row[nh * S + j] = v[i] / l;
      }
    }
    if (CARRY && q < S) {
      const float c = carry[nh * S + q] * (1.0f / l);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) cacc[i] += c * v[i];
    }
  });
  if (!CARRY) return;

  // The 8 warps' sums, in V's place (free after P.V), added in warp order.
  const int sp = pad16(S);
  float* red = reinterpret_cast<float*>(smem + layout(BQ, S).v);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int j = lane + 32 * i;
    if (j < sp) red[warp * sp + j] = cacc[i];
  }
  __syncthreads();
  float* dst = part + (size_t(blockIdx.x) * gridDim.z * H + nh) * S;
  for (int j = threadIdx.x; j < S; j += THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * sp + j];
    dst[j] = s;
  }
}

// Grid (query tiles, N): the heads one after the other, o of each written
// as by mhsa_kernel, then the factor rownorm(sum_h p_h / l_h / H + I) of
// the tile's rows into factor [N, S, S] f32.
template <int BQ, bool ROPE>
__global__ void __launch_bounds__(THREADS)
mhsa_abnar_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                  float* __restrict__ factor, const float* __restrict__ rcos,
                  const float* __restrict__ rsin, int S, int E, int H,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sp = pad16(S);
  float* A = reinterpret_cast<float*>(smem + abnar_sum_offset(BQ, S));
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int h = 0; h < H; ++h) {
    attend<BQ, ROPE>(qkv, out, rcos, rsin, smem, n, h, q0, S, E, scale,
                     [&](int r, const float (&v)[PER_LANE], float l, float) {
      float* a = A + r * sp;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int j = lane + 32 * i;
        if (j < sp) a[j] = h == 0 ? v[i] / l : a[j] + v[i] / l;
      }
    });
    __syncthreads();  // the next head's loads overwrite what o's write reads
  }

  // Each warp reads back the rows it summed (the softmax's row assignment).
  const float inv_h = 1.0f / H;
  for (int r = warp; r < BQ; r += WARPS) {
    const int q = q0 + r;
    if (q >= S) break;  // warp-uniform, and later rows lie further out
    const float* a = A + r * sp;
    float v[PER_LANE];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < S ? a[j] * inv_h + (j == q ? 1.0f : 0.0f) : 0.0f;
      sum += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float* dst = factor + (size_t(n) * S + q) * S;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      if (j < S) dst[j] = v[i] / sum;
    }
  }
}

constexpr size_t SMEM_CAP = 227 * 1024;

// The attention kernel, then (CARRY) the fixed-order sum of its per-tile
// partials into new_carry [N, heads, S].
template <int BQ, bool ROW, bool CARRY, bool ROPE>
cudaError_t launch(const bf16* qkv, bf16* out, float* lse, float* row,
                   const float* carry, float* part, float* new_carry,
                   const float* rcos, const float* rsin, int N, int S, int E,
                   int H, float scale, cudaStream_t st) {
  const size_t bytes = layout(BQ, S).total;
  cudaError_t err = allow_smem(mhsa_kernel<BQ, ROW, CARRY, ROPE>, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (S + BQ - 1) / BQ;
  dim3 grid(tiles, H, N);
  mhsa_kernel<BQ, ROW, CARRY, ROPE><<<grid, THREADS, bytes, st>>>(
      qkv, out, lse, row, carry, part, rcos, rsin, S, E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !CARRY) return err;
  return sum_partials(part, new_carry, tiles, N * H * S, st);
}

template <int BQ, bool ROPE>
cudaError_t launch_flags(const bf16* qkv, bf16* out, float* lse, float* row,
                         const float* carry, float* part, float* new_carry,
                         const float* rcos, const float* rsin, int N, int S,
                         int E, int H, float scale, cudaStream_t st) {
  if (carry != nullptr)
    return row != nullptr
               ? launch<BQ, true, true, ROPE>(qkv, out, lse, row, carry, part, new_carry,
                                              rcos, rsin, N, S, E, H, scale, st)
               : launch<BQ, false, true, ROPE>(qkv, out, lse, row, carry, part, new_carry,
                                               rcos, rsin, N, S, E, H, scale, st);
  return row != nullptr
             ? launch<BQ, true, false, ROPE>(qkv, out, lse, row, carry, part, new_carry,
                                             rcos, rsin, N, S, E, H, scale, st)
             : launch<BQ, false, false, ROPE>(qkv, out, lse, row, carry, part, new_carry,
                                              rcos, rsin, N, S, E, H, scale, st);
}

template <int BQ>
cudaError_t launch_rope(const bf16* qkv, bf16* out, float* lse, float* row,
                        const float* carry, float* part, float* new_carry,
                        const float* rcos, const float* rsin, int N, int S, int E,
                        int H, float scale, cudaStream_t st) {
  return rcos != nullptr
             ? launch_flags<BQ, true>(qkv, out, lse, row, carry, part, new_carry, rcos,
                                      rsin, N, S, E, H, scale, st)
             : launch_flags<BQ, false>(qkv, out, lse, row, carry, part, new_carry, rcos,
                                       rsin, N, S, E, H, scale, st);
}

template <int BQ, bool ROPE>
cudaError_t launch_abnar(const bf16* qkv, bf16* out, float* factor, const float* rcos,
                         const float* rsin, int N, int S, int E, int H, float scale,
                         cudaStream_t st) {
  const size_t bytes = abnar_bytes(BQ, S);
  cudaError_t err = allow_smem(mhsa_abnar_kernel<BQ, ROPE>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, N);
  mhsa_abnar_kernel<BQ, ROPE><<<grid, THREADS, bytes, st>>>(qkv, out, factor, rcos, rsin,
                                                            S, E, H, scale);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t launch_abnar_rope(const bf16* qkv, bf16* out, float* factor,
                              const float* rcos, const float* rsin, int N, int S,
                              int E, int H, float scale, cudaStream_t st) {
  return rcos != nullptr
             ? launch_abnar<BQ, true>(qkv, out, factor, rcos, rsin, N, S, E, H, scale, st)
             : launch_abnar<BQ, false>(qkv, out, factor, rcos, rsin, N, S, E, H, scale, st);
}

}  // namespace
}  // namespace mst

// qkv [N*S, 3E] bf16 -> out [N*S, E] bf16; E == num_heads * 64, S <= 512,
// scale = log2(e) / sqrt(64). Each other output is NULL when not wanted:
// lse [N*S, num_heads] f32; row [N, num_heads, S] f32; carry [N,
// num_heads, S] f32 in with carry_part (room for [ceil(S / 32), N,
// num_heads, S] f32) and new_carry [N, num_heads, S] f32 out; abnar [N, S,
// S] f32 (alone: no lse, row or carry with it). rope_cos and
// rope_sin, [S, 64] f32 each, both or neither: RoPE on q and k.
extern "C" int mst_mhsa(const void* qkv, void* out, void* lse, void* row,
                        const void* carry, void* carry_part, void* new_carry,
                        void* abnar, const void* rope_cos, const void* rope_sin,
                        int N, int S, int E, int num_heads, float scale,
                        void* stream) {
  using namespace mst;
  if (N <= 0 || N > 65535 || S <= 0 || S > MAX_S || num_heads <= 0 ||
      num_heads > 65535 || E != num_heads * HD ||
      (carry == nullptr) != (carry_part == nullptr) ||
      (carry == nullptr) != (new_carry == nullptr) ||
      (rope_cos == nullptr) != (rope_sin == nullptr) ||
      size_t(N) * num_heads * S > size_t(INT32_MAX))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  float* b = static_cast<float*>(lse);
  float* rw = static_cast<float*>(row);
  const float* c = static_cast<const float*>(carry);
  float* part = static_cast<float*>(carry_part);
  float* nc = static_cast<float*>(new_carry);
  const float* rc = static_cast<const float*>(rope_cos);
  const float* rs = static_cast<const float*>(rope_sin);
  if (abnar != nullptr) {
    if (lse != nullptr || row != nullptr || carry != nullptr) return cudaErrorInvalidValue;
    float* f = static_cast<float*>(abnar);
    if (abnar_bytes(64, S) <= SMEM_CAP)
      return launch_abnar_rope<64>(in, o, f, rc, rs, N, S, E, num_heads, scale, st);
    if (abnar_bytes(32, S) <= SMEM_CAP)
      return launch_abnar_rope<32>(in, o, f, rc, rs, N, S, E, num_heads, scale, st);
    if (abnar_bytes(16, S) <= SMEM_CAP)
      return launch_abnar_rope<16>(in, o, f, rc, rs, N, S, E, num_heads, scale, st);
    return cudaErrorInvalidValue;
  }
  return layout(64, S).total <= SMEM_CAP
             ? launch_rope<64>(in, o, b, rw, c, part, nc, rc, rs, N, S, E, num_heads, scale,
                               st)
             : launch_rope<32>(in, o, b, rw, c, part, nc, rc, rs, N, S, E, num_heads, scale,
                               st);
}
