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
//   D: C with o = (bf16(p).V) / l: the math of `mhsa.cu`, in its order
//      (attn_softmax_sm90.cuh's EXP_2 form and mhsa's body), so D gives
//      mhsa's bits;
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
// on 132 SMs at ~1.83 GHz, 0.013 ms.
//
// Variants A-E (`variant_kernel<V, TWO>`) are mhsa.cu's forward on
// attn_sm90.cuh, the form of the softmax a template hook:
// - one block, one warpgroup, per (head, slice) walks up to 5 of the head's
//   64-query tiles (`tiles_per_block`): thread 0 starts TMA loads of every
//   64-key box of K and V of the head at once, each box pair on its own
//   mbarrier, from a 3-D map over [N, S, 3E] (keys past S of a slice read
//   as zeros), and of the Q tiles into two boxes, the tile after next
//   streaming in while one runs; K and V are read from device memory once
//   per (head, slice), not once per query tile;
// - the scores are wgmma m64n64k16 products (Q and K K-major in shared
//   memory) into registers, and one m64n16 for a last chunk of <= 16 keys;
// - one pass for S <= 272: every score of a thread's two rows in
//   registers, the row max over the 4 lanes of a row, then the variant's
//   exponential in place and l; A and C divide p by l (known before P.V in
//   this form); P.V by mma.sync m16n8k16 per warp from P's bf16 pairs and
//   V's boxes by `ldmatrix .trans`. Above 272 two passes over the resident
//   chunks: m (and l, rescaled when m grows, except in E, whose l sums the
//   bf16 p of pass 2), then the scores again, p against the final max, P.V
//   by register-A wgmma;
// - o (divided by l in B, D, E) is staged through the tile's Q box and
//   leaves as 16-byte row stores.
// Neither scores nor probabilities reach shared or device memory, except
// `p_out` (a check, NULL when timed): the bf16 P operand of P.V of every
// row, [N, heads, S, S], written from the registers. A block holds two 8
// KB Q boxes and the K and V boxes (84 KB at S = 257: two blocks an SM;
// 145 KB at S = 512).
//
// Split-CLS (row 21), still on its first (WMMA) design: S = 1 +
// P patches with P % 64 == 0. The patch
// queries 1..P run in exact 64-row tiles over the patch keys 1..P in exact
// 16-key tiles (no padded score column); the CLS key is a strip: s_pc =
// q_p . k_c, a 64-wide dot per row taken by the row's warp (2 products a
// lane, then a butterfly), m = max(rowmax(s_pp), s_pc), l = sum(p_pp) +
// p_pc, o_p = (bf16(p_pp).V_p + p_pc * v_c) / l with the CLS term in f32,
// as the tool has it. The CLS query row (one per slice and head) goes over
// all S keys in a second kernel, one warp per (slice, head): the lanes
// take the keys for the scores, then the 64 output columns for P.V. Split
// and base round at different points, so each is held to its own plain
// version. One block per (64-query tile, head, slice) holds K and V of the
// head and the tile's f32 score rows in shared memory, one warp per
// softmax row, WMMA bf16 products with f32 accumulators.
#include "attn_softmax_sm90.cuh"

namespace mst {
namespace {

namespace split {

constexpr int HD = 64;
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;        // query rows per block
constexpr int LDQ = HD + 8;   // bf16 stride of Q / K / V rows
constexpr int LDO = HD + 4;   // f32 stride of the output staging tile
constexpr int MAX_S = 512;
constexpr int PER_LANE = MAX_S / 32;
constexpr size_t SMEM_CAP = 227 * 1024;

__host__ __device__ inline int pad16(int s) { return (s + 15) & ~15; }

struct Layout {
  size_t q, k, v, s, l, c, total;  // byte offsets
};

// The patch kernel's layout over `keys` key rows, with c: the CLS key and
// value in f32 and each row's p_pc ([3][64] f32).
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

bool bad_shape(int N, int S, int E, int H) {
  return N <= 0 || N > 65535 || S <= 0 || S > MAX_S || H <= 0 || H > 65535 || E != H * HD;
}

}  // namespace split

// ---- variants A-E on TMA + wgmma ------------------------------------------

using namespace attn;

enum Variant : int { VAR_A = 0, VAR_B = 1, VAR_C = 2, VAR_D = 3, VAR_E = 4 };

// The exponential form of a variant, whether P is rounded as bf16(p / l)
// (A, C: o = P.V) or as bf16(p) with o = (P.V) / l (B, D, E), and whether
// the two-pass body keeps l in pass 1 (every form but E's, whose l sums
// pass 2's bf16 p).
__host__ __device__ constexpr int form_of(int v) {
  return v <= VAR_B ? EXP_E : v == VAR_E ? EXP_2_BF16 : EXP_2;
}
__host__ __device__ constexpr bool norm_p(int v) { return v == VAR_A || v == VAR_C; }
__host__ __device__ constexpr bool l_first(int v) { return v != VAR_E; }

// Shared memory (bytes past the 1024-byte aligned base): two Q boxes (this
// tile's and the next's), the K boxes, the V boxes, then the barriers (0,
// 1: the Q boxes; 2 + b: K and V of chunk b).
struct Layout {
  size_t q, k, v, bar, total;
};

__host__ __device__ inline Layout layout(int S) {
  const Plan p = plan(S);
  Layout L;
  L.q = 0;
  L.k = L.q + 2 * BOX_BYTES;
  L.v = L.k + operand_bytes(p);
  L.bar = L.v + operand_bytes(p);
  L.total = ALIGN + L.bar + size_t(2 + p.boxes) * sizeof(uint64_t);
  return L;
}

struct Args {
  bf16* out;
  bf16* p_out;
  int S, E, H;
  float scale;
};

// The check's copy of P (bf16, [N, heads, S, S]) from this thread's
// registers: a chunk's keys key0 .., the slice-head row block nh.
template <int R>
__device__ __forceinline__ void write_p(const float (&p)[R], int key0, const Rows& c,
                                        const Args& a, size_t nh) {
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int j = key0 + frag_col(c.t, i);
    const int q = frag_hi(i) ? c.qb : c.qa;
    if (q < a.S) {
      bf16* dst = a.p_out + (nh * a.S + q) * a.S + j;
      if (j < a.S) dst[0] = __float2bfloat16(p[i]);
      if (j + 1 < a.S) dst[1] = __float2bfloat16(p[i + 1]);
    }
  }
}

// Grid (heads x tile groups, N): a block walks a group of up to MOST_TILES
// query tiles of a (head, slice), K and V loaded once; the Q box of the
// tile after next streams in while this one runs. TWO: the two-pass body
// (S > ONE_PASS_MAX).
template <int V, bool TWO>
__global__ void __launch_bounds__(THREADS)
variant_kernel(const __grid_constant__ CUtensorMap t64, const __grid_constant__ CUtensorMap t16,
               Args a) {
  constexpr int F = form_of(V);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  const Plan P = plan(a.S);
  const Layout L = layout(a.S);
  unsigned char* Kb = base + L.k;
  unsigned char* Vb = base + L.v;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L.bar);

  const int t = threadIdx.x;
  const int n = blockIdx.y;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const int groups = (tiles(a.S) + tpb - 1) / tpb;
  const int g = blockIdx.x % groups;
  const int h = blockIdx.x / groups;
  const int units = min(tpb, tiles(a.S) - g * tpb);
  const size_t nh = size_t(n) * a.H + h;
  // thread 0: unit u's Q box into buffer u % 2
  auto load_q = [&](int u) {
    unsigned char* q = base + L.q + (u & 1) * BOX_BYTES;
    sm90::mbar_expect_tx(&bar[u & 1], BOX_BYTES);
    tma_load_3d(q, &t64, h * HD, (g * tpb + u) * TILE, n, &bar[u & 1]);
  };
  if (t == 0) {
    for (int i = 0; i < 2 + P.boxes; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::tma_prefetch(&t64);
    sm90::tma_prefetch(&t16);
    load_q(0);
    for (int b = 0; b < P.boxes; ++b) {
      const bool full = b < P.n64;
      const CUtensorMap* m = full ? &t64 : &t16;
      sm90::mbar_expect_tx(&bar[2 + b], 2 * (full ? BOX_BYTES : TAIL_BYTES));
      tma_load_3d(Kb + b * BOX_BYTES, m, a.E + h * HD, b * CHUNK, n, &bar[2 + b]);
      tma_load_3d(Vb + b * BOX_BYTES, m, 2 * a.E + h * HD, b * CHUNK, n, &bar[2 + b]);
    }
    if (units > 1) load_q(1);
  }
  __syncthreads();

  for (int u = 0; u < units; ++u) {
    const Rows c = rows_of(t, (g * tpb + u) * TILE);
    unsigned char* Qb = base + L.q + (u & 1) * BOX_BYTES;
    const uint32_t qpar = (u >> 1) & 1;
    // a warp whose 16 rows all lie past S (the last tile of S = 257) skips
    // the softmax: its q rows are zeros, so s = 0, and nothing of it is
    // stored
    const bool live = c.q0 + 16 * c.warp < a.S;

    float acc[32];
    zero(acc);
    float l0 = 0.0f, l1 = 0.0f, m0 = -INFINITY, m1 = -INFINITY;
    mbar_wait(&bar[u & 1], qpar);
    if constexpr (!TWO) {
      // every score of the tile's rows in registers: 4 chunks of 64 keys and
      // a tail of 16; one commit group a chunk, at most two in flight
      float s[4][32], st[8];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < P.n64) {
          mbar_wait(&bar[2 + b], 0);
          scores(s[b], Qb, Kb + b * BOX_BYTES);
          wgmma_wait<1>();
        }
      if (P.tail) {
        mbar_wait(&bar[2 + P.n64], 0);
        scores(st, Qb, Kb + P.n64 * BOX_BYTES);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < 4; ++b) fence_regs(s[b]);
      fence_regs(st);
      if (live) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < P.n64) {
            if ((b + 1) * CHUNK <= a.S)
              scale_mask<F, false>(s[b], b * CHUNK, t, a.S, a.scale, m0, m1);
            else
              scale_mask<F>(s[b], b * CHUNK, t, a.S, a.scale, m0, m1);
          }
        if (P.tail) scale_mask<F>(st, P.n64 * CHUNK, t, a.S, a.scale, m0, m1);
        m0 = quad_max(m0);
        m1 = quad_max(m1);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < P.n64) exp_rows<F>(s[b], m0, m1, l0, l1);
        if (P.tail) exp_rows<F>(st, m0, m1, l0, l1);
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        if constexpr (norm_p(V)) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (b < P.n64) normalize(s[b], l0, l1);
          if (P.tail) normalize(st, l0, l1);
        }
        if (a.p_out != nullptr) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (b < P.n64) write_p(s[b], b * CHUNK, c, a, nh);
          if (P.tail) write_p(st, P.n64 * CHUNK, c, a, nh);
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < P.n64) pv_sync(acc, s[b], Vb + b * BOX_BYTES, c.lane);
      if (P.tail) pv_sync(acc, st, Vb + P.n64 * BOX_BYTES, c.lane);
    } else {
      // pass 1: m (and l, rescaled when m grows) chunk by chunk
      float s[32], st[8];
      for (int b = 0; b < P.n64; ++b) {
        mbar_wait(&bar[2 + b], 0);
        scores(s, Qb, Kb + b * BOX_BYTES);
        wgmma_wait<0>();
        fence_regs(s);
        online<F, l_first(V)>(s, b * CHUNK, c, a.S, a.scale, m0, m1, l0, l1);
      }
      if (P.tail) {
        mbar_wait(&bar[2 + P.n64], 0);
        scores(st, Qb, Kb + P.n64 * BOX_BYTES);
        wgmma_wait<0>();
        fence_regs(st);
        online<F, l_first(V)>(st, P.n64 * CHUNK, c, a.S, a.scale, m0, m1, l0, l1);
      }
      if (l_first(V)) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
      }
      // pass 2: the scores again, p against the final max, P.V
      for (int b = 0; b < P.n64; ++b) {
        scores(s, Qb, Kb + b * BOX_BYTES);
        wgmma_wait<0>();  // also the previous chunk's P.V
        fence_regs(s);
        fence_regs(acc);
        probs<F, !l_first(V)>(s, b * CHUNK, c, a.S, a.scale, m0, m1, l0, l1);
        if (norm_p(V)) normalize(s, l0, l1);
        if (a.p_out != nullptr) write_p(s, b * CHUNK, c, a, nh);
        pv(acc, s, Vb + b * BOX_BYTES);
      }
      if (P.tail) {
        scores(st, Qb, Kb + P.n64 * BOX_BYTES);
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(acc);
        probs<F, !l_first(V)>(st, P.n64 * CHUNK, c, a.S, a.scale, m0, m1, l0, l1);
        if (norm_p(V)) normalize(st, l0, l1);
        if (a.p_out != nullptr) write_p(st, P.n64 * CHUNK, c, a, nh);
        pv(acc, st, Vb + P.n64 * BOX_BYTES);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (!l_first(V)) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
      }
    }

    // o (= acc / l but in A and C) through this unit's Q box (the scores
    // are done with it)
    if (!norm_p(V)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = acc[i] / (frag_hi(i) ? l1 : l0);
    }
    stage_box(Qb, t, acc);
    __syncthreads();
    store_box(Qb, t, a.out + (size_t(n) * a.S + c.q0) * a.E + h * HD, a.E,
              min(TILE, a.S - c.q0));
    // every read of this unit's Q box is done before TMA refills it
    fence_async_smem();
    __syncthreads();
    if (t == 0 && u + 2 < units) load_q(u + 2);
  }
}

template <int V, bool TWO>
cudaError_t launch_variant(const CUtensorMap& t64, const CUtensorMap& t16, const Args& a, int N,
                           cudaStream_t st) {
  const size_t bytes = layout(a.S).total;
  auto kernel = variant_kernel<V, TWO>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const dim3 grid(a.H * ((tiles(a.S) + tpb - 1) / tpb), N);
  kernel<<<grid, THREADS, bytes, st>>>(t64, t16, a);
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch(const CUtensorMap& t64, const CUtensorMap& t16, const Args& a, int N,
                     cudaStream_t st) {
  return a.S > ONE_PASS_MAX ? launch_variant<V, true>(t64, t16, a, N, st)
                            : launch_variant<V, false>(t64, t16, a, N, st);
}

}  // namespace
}  // namespace mst

// qkv [N*S, 3E] bf16 -> out [N*S, E] bf16 in softmax form `variant` (0-4:
// A-E above); p_out [N, H, S, S] bf16 or NULL. scale: 1/sqrt(64) for A and
// B, log2(e)/sqrt(64) for C, D and E. Needs E == 64 * num_heads and
// 1 <= S <= 512.
extern "C" int mst_attn_variant(const void* qkv, void* out, void* p_out, int N, int S, int E,
                                int num_heads, int variant, float scale, void* stream) {
  using namespace mst;
  if (split::bad_shape(N, S, E, num_heads) || variant < VAR_A || variant > VAR_E)
    return cudaErrorInvalidValue;
  CUtensorMap t64, t16;
  cudaError_t err = tma_map_3d(&t64, qkv, N, S, 3 * size_t(E), CHUNK);
  if (err == cudaSuccess) err = tma_map_3d(&t16, qkv, N, S, 3 * size_t(E), TAIL);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<bf16*>(out), static_cast<bf16*>(p_out), S, E, num_heads, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case VAR_A: return dispatch<VAR_A>(t64, t16, a, N, st);
    case VAR_B: return dispatch<VAR_B>(t64, t16, a, N, st);
    case VAR_C: return dispatch<VAR_C>(t64, t16, a, N, st);
    case VAR_D: return dispatch<VAR_D>(t64, t16, a, N, st);
    default: return dispatch<VAR_E>(t64, t16, a, N, st);
  }
}

// The launch geometry of mst_attn_variant at sequence length S (1 <= S <=
// 512): geo = {query tile rows, query tiles, tiles a block walks, threads,
// passes, 64-key chunks, tail chunks of 16, dynamic shared memory bytes},
// as the launch sets them (`bench_attn_softmax.variant_launch` mirrors it).
extern "C" int mst_attn_variant_geometry(int S, int* geo) {
  using namespace mst;
  if (S <= 0 || S > MAX_S) return cudaErrorInvalidValue;
  const Plan p = plan(S);
  const int g[8] = {TILE, tiles(S), tiles_per_block(S, MOST_TILES), THREADS,
                    S > ONE_PASS_MAX ? 2 : 1, p.n64, p.tail, static_cast<int>(layout(S).total)};
  for (int i = 0; i < 8; ++i) geo[i] = g[i];
  return cudaSuccess;
}

// The split-CLS core: qkv [N*S, 3E] bf16 -> out [N*S, E] bf16, S = 1 + P
// with P % 64 == 0, scale = log2(e)/sqrt(64). Two launches: the patch
// tiles, then the CLS rows.
extern "C" int mst_attn_split_cls(const void* qkv, void* out, int N, int S, int E,
                                  int num_heads, float scale, void* stream) {
  using namespace mst;
  const int P = S - 1;
  if (split::bad_shape(N, S, E, num_heads) || P <= 0 || P % split::BQ != 0 ||
      split::layout(P, true).total > split::SMEM_CAP)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  const size_t bytes = split::layout(P, true).total;
  cudaError_t err = allow_smem(split::split_patch_kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(P / split::BQ, num_heads, N);
  split::split_patch_kernel<<<grid, split::THREADS, bytes, st>>>(in, o, S, E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = N * num_heads;
  split::split_cls_kernel<<<(warps + split::WARPS - 1) / split::WARPS, split::THREADS, 0, st>>>(
      in, o, N, S, E, num_heads, scale);
  return cudaGetLastError();
}
