// attn_variants: bf16 attention cores over a packed qkv [N*S, 3E] (columns
// [q | k | v], head h at h*64 inside each) -> o [N*S, E], head dim 64, in
// the forms two experiments of the JAX package compare.
//
// Replaces the attention core inside two experiment kernels of the repo's
// `tools/` scripts (queue B rows 18 and 21):
// - `tools/bench_attn_softmax.py` `make_kernel` (:34), variants A-E of the
//   per-head softmax (the kernel also runs the qkv and proj products; here
//   those are `gemm_residual.cu` launches around this core):
//   A: s * (1/sqrt(64)), p = exp(s - m), P = bf16(p / l), o = P.V;
//   B: as A with o = (bf16(p).V) / l;
//   C: s * (log2(e)/sqrt(64)), p = exp2(s - m), P = bf16(p / l), o = P.V;
//   D: C with o = (bf16(p).V) / l: the math of `mhsa.cu`, and its code
//      (this file keeps mhsa.cu's tiles, fragment order and per-lane sums,
//      so D gives mhsa's bits);
//   E: D with d = bf16(s - m) and p = exp2(d) taken in bf16 (`h2exp2` on
//      pairs, the ex2.approx bf16x2 instruction on sm_90), l summed from
//      the f32 of the bf16 p.
//   l is the f32 row sum of the f32 p (of the bf16 p in E); o is rounded
//   to bf16 once.
// - `tools/bench_attn_split_cls.py` `_kernel` (:104): `_mhsa_base` (:46) is
//   variant D here; `_mhsa_split` (:64) is the split-CLS layout below.
//
// Bound on the H100: at the tools' shape (N = 128, S = 257, 6 heads) the
// core is 13 GFLOP of tensor-core work on 101 MB of qkv and o, so 0.03 ms
// by bytes and 0.013 ms by FLOPs; the exponentials (50.7 M at one per
// score) are the third limit: the SFU does 16 per SM per clock, ~3.9 T/s
// on 132 SMs at ~1.83 GHz, 0.013 ms. The design is mhsa.cu's: one block
// per (64-query tile, head, slice) holds K and V of the head and the
// tile's f32 score rows in shared memory (158 KB at S = 257), one warp per
// softmax row, P written back as bf16 over its own score row, WMMA bf16
// products (mma.sync underneath) with f32 accumulators. The variants
// differ only in the softmax row and the output division. `p_out` (a
// check, NULL when timed) receives the bf16 P operand of P.V of every
// row, [N, heads, S, S].
//
// Split-CLS (row 21): S = 1 + P patches with P % 64 == 0. The patch
// queries 1..P run in exact 64-row tiles over the patch keys 1..P in exact
// 16-key tiles (no padded score column); the CLS key is a strip: s_pc =
// q_p . k_c, a 64-wide dot per row taken by the row's warp (2 products a
// lane, then a butterfly), m = max(rowmax(s_pp), s_pc), l = sum(p_pp) +
// p_pc, o_p = (bf16(p_pp).V_p + p_pc * v_c) / l with the CLS term in f32,
// as the tool has it. The CLS query row (one per slice and head) goes over
// all S keys in a second kernel, one warp per (slice, head): the lanes
// take the keys for the scores, then the 64 output columns for P.V. Split
// and base round at different points, so each is held to its own plain
// version.
#include "common.cuh"

namespace mst {
namespace {

constexpr int HD = 64;
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;        // query rows per block
constexpr int LDQ = HD + 8;   // bf16 stride of Q / K / V rows
constexpr int LDO = HD + 4;   // f32 stride of the output staging tile
constexpr int MAX_S = 512;
constexpr int PER_LANE = MAX_S / 32;
constexpr size_t SMEM_CAP = 227 * 1024;

enum Variant : int { VAR_A = 0, VAR_B = 1, VAR_C = 2, VAR_D = 3, VAR_E = 4 };

__host__ __device__ inline int pad16(int s) { return (s + 15) & ~15; }

struct Layout {
  size_t q, k, v, s, l, c, total;  // byte offsets
};

// mhsa.cu's layout over `keys` key rows; the split kernel adds c: the CLS
// key and value in f32 and each row's p_pc ([3][64] f32).
__host__ __device__ inline Layout layout(int keys, bool split) {
  const int sp = pad16(keys);
  Layout L;
  const size_t qb = size_t(BQ) * LDQ * sizeof(bf16);
  size_t kb = size_t(sp) * LDQ * sizeof(bf16);
  const size_t ob = size_t(BQ) * LDO * sizeof(float);  // staged in K's place
  if (ob > kb) kb = ob;
  const size_t vb = size_t(sp) * LDQ * sizeof(bf16);
  const size_t sb = size_t(BQ) * (sp + 4) * sizeof(float);
  L.q = 0;
  L.k = L.q + qb;
  L.v = L.k + kb;
  L.s = L.v + vb;
  L.l = L.s + sb;
  L.c = L.l + size_t(BQ) * sizeof(float);
  L.total = L.c + (split ? size_t(3) * HD * sizeof(float) : 0);
  return L;
}

// One (64-query tile, head, slice) of variant V: queries q0.. (row q of a
// slice), keys 0..S-1.
template <int V>
__global__ void __launch_bounds__(THREADS)
variant_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, bf16* __restrict__ p_out,
               int S, int E, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(S, false);
  const int sp = pad16(S);
  const int lds = sp + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  float* Os = reinterpret_cast<float*>(smem + L.k);  // reuses K after scores
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Ls = reinterpret_cast<float*>(smem + L.l);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, H = gridDim.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row3 = size_t(3) * E;
  const bf16* base = qkv + size_t(n) * S * row3 + h * HD;

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

  // Softmax rows, one warp each; P goes back as bf16 over the first half
  // of its own f32 row (all reads precede the writes).
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
    if constexpr (V == VAR_E) {
      // d = bf16(s - m), p = exp2(d) in bf16, two keys per instruction
#pragma unroll
      for (int i = 0; i < PER_LANE; i += 2) {
        const int j0 = lane + 32 * i, j1 = j0 + 32;
        const __nv_bfloat162 p2 = h2exp2(__floats2bfloat162_rn(v[i] - mx, v[i + 1] - mx));
        v[i] = j0 < S ? __low2float(p2) : 0.0f;
        v[i + 1] = j1 < S ? __high2float(p2) : 0.0f;
        l += v[i];
        l += v[i + 1];
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int j = lane + 32 * i;
        if (j < S) v[i] = (V == VAR_A || V == VAR_B) ? expf(v[i] - mx) : exp2f(v[i] - mx);
        else v[i] = 0.0f;
        l += v[i];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(srow);
    const int q = q0 + r;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      if (j < sp) {
        const bf16 pb = __float2bfloat16((V == VAR_A || V == VAR_C) ? v[i] / l : v[i]);
        prow[j] = pb;
        if (p_out != nullptr && q < S && j < S)
          p_out[((size_t(n) * H + h) * S + q) * S + j] = pb;
      }
    }
    if (lane == 0) Ls[r] = l;
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
    for (int e = 0; e < 8; ++e)
      v[e] = (V == VAR_A || V == VAR_C) ? Os[r * LDO + c + e] : Os[r * LDO + c + e] / l;
    *reinterpret_cast<uint4*>(out + (size_t(n) * S + q) * E + h * HD + c) = pack8_bf16(v);
  }
}

// Split-CLS, the patch queries: one block per (64-query tile of the P
// patches, head, slice); the patch keys are rows 1..P of the slice.
__global__ void __launch_bounds__(THREADS)
split_patch_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int S, int E,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int P = S - 1;
  const Layout L = layout(P, true);
  const int lds = P + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  float* Os = reinterpret_cast<float*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  float* kc = reinterpret_cast<float*>(smem + L.c);  // CLS key, f32
  float* vc = kc + HD;                               // CLS value, f32
  float* pc = vc + HD;                               // p_pc of each row

  const int q0 = 1 + blockIdx.x * BQ;  // slice row of the tile's first query
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row3 = size_t(3) * E;
  const bf16* base = qkv + size_t(n) * S * row3 + h * HD;

  for (int c = tid; c < BQ * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(Qs + r * LDQ + col) =
        *reinterpret_cast<const uint4*>(base + (q0 + r) * row3 + col);
  }
  for (int c = tid; c < P * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    const bf16* src = base + (1 + r) * row3;
    *reinterpret_cast<uint4*>(Ks + r * LDQ + col) = *reinterpret_cast<const uint4*>(src + E + col);
    *reinterpret_cast<uint4*>(Vs + r * LDQ + col) =
        *reinterpret_cast<const uint4*>(src + 2 * E + col);
  }
  if (tid < HD) {
    kc[tid] = __bfloat162float(base[E + tid]);
    vc[tid] = __bfloat162float(base[2 * E + tid]);
  }
  __syncthreads();

  const int tiles_n = P / 16;
  for (int t = warp; t < (BQ / 16) * tiles_n; t += WARPS) {
    const int ti = t / tiles_n, tj = t % tiles_n;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qs + ti * 16 * LDQ + kk, LDQ);
      wmma::load_matrix_sync(fb, Ks + tj * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
#pragma unroll
    for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= scale;
    wmma::store_matrix_sync(Ss + ti * 16 * lds + tj * 16, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  for (int r = warp; r < BQ; r += WARPS) {
    float* srow = Ss + r * lds;
    // the CLS strip: s_pc = (q . k_c) * scale
    const float2 qv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(Qs + r * LDQ + 2 * lane));
    float spc = qv.x * kc[2 * lane] + qv.y * kc[2 * lane + 1];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) spc += __shfl_xor_sync(0xffffffffu, spc, o);
    spc *= scale;
    float v[PER_LANE];
    float mx = spc;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < P ? srow[j] : -INFINITY;
      mx = fmaxf(mx, v[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.0f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < P ? exp2f(v[i] - mx) : 0.0f;
      l += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    const float ppc = exp2f(spc - mx);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      if (j < P) prow[j] = __float2bfloat16(v[i]);
    }
    if (lane == 0) {
      Ls[r] = l + ppc;
      pc[r] = ppc;
    }
  }
  __syncthreads();

  const int ldp = 2 * lds;
  const bf16* Ps = reinterpret_cast<const bf16*>(Ss);
  for (int t = warp; t < (BQ / 16) * (HD / 16); t += WARPS) {
    const int ti = t / (HD / 16), tj = t % (HD / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < P; kk += 16) {
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
    float v[8];
    const float l = Ls[r], ppc = pc[r];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (Os[r * LDO + c + e] + ppc * vc[c + e]) / l;
    *reinterpret_cast<uint4*>(out + (size_t(n) * S + q0 + r) * E + h * HD + c) = pack8_bf16(v);
  }
}

// Split-CLS, the CLS query rows: one warp per (slice, head) over all S
// keys, K and V read from device memory (L2) row by row.
__global__ void __launch_bounds__(THREADS)
split_cls_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int S, int E,
                 int H, float scale) {
  __shared__ float qs[WARPS][HD];
  __shared__ float ps[WARPS][MAX_S];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int idx = blockIdx.x * WARPS + warp;  // n * H + h
  if (idx >= N * H) return;                   // warp-uniform; no block barrier below
  const int n = idx / H, h = idx % H;
  const size_t row3 = size_t(3) * E;
  const bf16* base = qkv + size_t(n) * S * row3 + h * HD;
  const float2 q2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base + 2 * lane));
  qs[warp][2 * lane] = q2.x;
  qs[warp][2 * lane + 1] = q2.y;
  __syncwarp();

  float s[PER_LANE];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int j = lane + 32 * i;
    s[i] = -INFINITY;
    if (j < S) {
      const bf16* krow = base + j * row3 + E;
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < HD; c += 8) {
        float kv[8];
        unpack8_bf16(*reinterpret_cast<const uint4*>(krow + c), kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) d += qs[warp][c + e] * kv[e];
      }
      s[i] = d * scale;
    }
    mx = fmaxf(mx, s[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float l = 0.0f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int j = lane + 32 * i;
    if (j < S) {
      const float p = exp2f(s[i] - mx);
      l += p;
      ps[warp][j] = round_bf16(p);  // P.V reads P as bf16
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  __syncwarp();
  float a0 = 0.0f, a1 = 0.0f;  // output columns 2 lane, 2 lane + 1
  for (int j = 0; j < S; ++j) {
    const float2 vv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(base + j * row3 + 2 * E + 2 * lane));
    a0 += ps[warp][j] * vv.x;
    a1 += ps[warp][j] * vv.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(out + size_t(n) * S * E + h * HD + 2 * lane) =
      __floats2bfloat162_rn(a0 / l, a1 / l);
}

template <int V>
cudaError_t launch_variant(const bf16* qkv, bf16* out, bf16* p_out, int N, int S, int E, int H,
                           float scale, cudaStream_t st) {
  const size_t bytes = layout(S, false).total;
  cudaError_t err = allow_smem(variant_kernel<V>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, N);
  variant_kernel<V><<<grid, THREADS, bytes, st>>>(qkv, out, p_out, S, E, scale);
  return cudaGetLastError();
}

bool bad_shape(int N, int S, int E, int H) {
  return N <= 0 || N > 65535 || S <= 0 || S > MAX_S || H <= 0 || H > 65535 || E != H * HD;
}

}  // namespace
}  // namespace mst

// qkv [N*S, 3E] bf16 -> out [N*S, E] bf16 in softmax form `variant` (0-4:
// A-E above); p_out [N, H, S, S] bf16 or NULL. scale: 1/sqrt(64) for A and
// B, log2(e)/sqrt(64) for C, D and E. Needs E == 64 * num_heads and the
// 64-query layout under 227 KB (S <= 400).
extern "C" int mst_attn_variant(const void* qkv, void* out, void* p_out, int N, int S, int E,
                                int num_heads, int variant, float scale, void* stream) {
  using namespace mst;
  if (bad_shape(N, S, E, num_heads) || layout(S, false).total > SMEM_CAP)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  bf16* p = static_cast<bf16*>(p_out);
  switch (variant) {
    case VAR_A: return launch_variant<VAR_A>(in, o, p, N, S, E, num_heads, scale, st);
    case VAR_B: return launch_variant<VAR_B>(in, o, p, N, S, E, num_heads, scale, st);
    case VAR_C: return launch_variant<VAR_C>(in, o, p, N, S, E, num_heads, scale, st);
    case VAR_D: return launch_variant<VAR_D>(in, o, p, N, S, E, num_heads, scale, st);
    case VAR_E: return launch_variant<VAR_E>(in, o, p, N, S, E, num_heads, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// The split-CLS core: qkv [N*S, 3E] bf16 -> out [N*S, E] bf16, S = 1 + P
// with P % 64 == 0, scale = log2(e)/sqrt(64). Two launches: the patch
// tiles, then the CLS rows.
extern "C" int mst_attn_split_cls(const void* qkv, void* out, int N, int S, int E,
                                  int num_heads, float scale, void* stream) {
  using namespace mst;
  const int P = S - 1;
  if (bad_shape(N, S, E, num_heads) || P <= 0 || P % BQ != 0 ||
      layout(P, true).total > SMEM_CAP)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  const size_t bytes = layout(P, true).total;
  cudaError_t err = allow_smem(split_patch_kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(P / BQ, num_heads, N);
  split_patch_kernel<<<grid, THREADS, bytes, st>>>(in, o, S, E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = N * num_heads;
  split_cls_kernel<<<(warps + WARPS - 1) / WARPS, THREADS, 0, st>>>(in, o, N, S, E, num_heads,
                                                                     scale);
  return cudaGetLastError();
}
