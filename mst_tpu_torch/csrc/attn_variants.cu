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
// Split-CLS (row 21, `split_cls_kernel<TWO>`): S = 1 + P patches, P % 64
// == 0, 64 <= P <= 384, on the same pieces (the tool's `_mhsa_split` math,
// `split_ref`'s order):
// - one block, one warpgroup, per (head, slice) walks up to 5 of the P / 64
//   exact patch query tiles (slice rows 1 + 64 u ..); thread 0 starts TMA
//   loads of the P / 64 exact 64-row boxes of the patch keys and values
//   (the 3-D map's box at row 1 + 64 b: no 16-key tail, no padded score
//   column) and of the Q tiles into two boxes, the tile after next
//   streaming in; K and V are read once per (head, slice);
// - s_pp = q_p . k_p^T by wgmma m64n64k16 into registers; the CLS key is a
//   strip, s_pc = (q_p . k_c) * scale, an f32 dot per row: the 4 lanes of
//   a row's quad each take 16 of the 64 columns from the swizzled Q box,
//   then two shuffles; m = max(rowmax(s_pp), s_pc), p = ex2(s - m) (the
//   EXP_2 form), l = sum(p_pp) + p_pc, o_p = (bf16(p_pp).V_p + p_pc v_c) /
//   l with the CLS term in f32, rounded to bf16 once. P.V by mma.sync from
//   P's registers (one pass, P <= 256), or the two-pass body with
//   register-A wgmma (P = 320, 384), as variant D's;
// - the CLS query row of the (slice, head) is taken by the block of its
//   first tile group after its tiles, from the K and V boxes already in
//   shared memory and the CLS key and value (f32): the 128 threads score
//   all S keys, the max and sum go through shared memory, then each warp
//   sums bf16(p_c) v over a quarter of the keys for the 64 columns, o_c =
//   (sum) / sum(p_c); no wgmma there (it runs under a branch);
// - no score or probability reaches shared or device memory but the CLS
//   row's S probabilities. At S = 257 a block holds 86,384 bytes: two an
//   SM. Split and base round at different points, so each is held to its
//   own plain version.
// What bounds it at the tool's shape (N = 128, S = 257, 6 heads): the same
// as variants A-E, 0.03 ms by bytes; it drops D's fifth query tile (one
// valid row of 64) and its 16-key tail. On the card it takes D's time
// (PERF.md §6 row 21): both are paced by one warpgroup's serial chain a
// tile (scores, softmax, P.V; two blocks an SM, held there by the one-pass
// body's 224 registers), which the dropped tile and tail do not shorten,
// and the CLS row's tail adds back a little.
#include "attn_softmax_sm90.cuh"

namespace mst {
namespace {

bool bad_shape(int N, int S, int E, int H) {
  return N <= 0 || N > 65535 || S <= 0 || S > attn::MAX_S || H <= 0 || H > 65535 ||
         E != H * attn::HD;
}

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


// ---- split-CLS on TMA + wgmma ---------------------------------------------

namespace split {

constexpr int MAX_P = 384;               // the longest patch run taken (the earlier kernel's cap)
constexpr int ONE_PASS_P = 4 * CHUNK;    // 256: P.V from the registers of one pass
constexpr int CLS_KEYS = (MAX_P + 1 + THREADS - 1) / THREADS;  // keys a thread scores: 4
// The f32 area (floats): the CLS key, value and query, the CLS row's bf16
// probabilities, the four warps' P.V partials, the max and sum of each warp.
constexpr int KC = 0;
constexpr int VC = KC + HD;
constexpr int QC = VC + HD;
constexpr int PC = QC + HD;
constexpr int PART = PC + MAX_P + 8;
constexpr int RED = PART + 4 * HD;
constexpr int F32_BYTES = (RED + 8) * 4;

__host__ __device__ inline int boxes(int S) { return (S - 1) / CHUNK; }

// Shared memory (bytes past the 1024-byte aligned base): two Q boxes, the
// patch K boxes, the patch V boxes, the f32 area, the barriers (0, 1: the
// Q boxes; 2 + b: K and V of box b).
__host__ __device__ inline Layout layout(int S) {
  const int nb = boxes(S);
  Layout L;
  L.q = 0;
  L.k = L.q + 2 * BOX_BYTES;
  L.v = L.k + size_t(nb) * BOX_BYTES;
  L.bar = L.v + size_t(nb) * BOX_BYTES + F32_BYTES;
  L.total = ALIGN + L.bar + size_t(2 + nb) * sizeof(uint64_t);
  return L;
}

__host__ __device__ inline bool bad_length(int S) {
  const int P = S - 1;
  return P < CHUNK || P % CHUNK != 0 || P > MAX_P;
}

// The CLS query row of a (slice, head) over all S keys: key 0 from the f32
// CLS key and value, keys 1.. from the patch boxes. Every thread of the
// block calls it (no wgmma: it runs in one block of a (head, slice) only).
__device__ __forceinline__ void cls_row(const unsigned char* Kb, const unsigned char* Vb,
                                        float* f, bf16* __restrict__ out, int S, float scale,
                                        int t) {
  const float* kc = f + KC;
  const float* vc = f + VC;
  const float* qc = f + QC;
  float* pc = f + PC;
  float* part = f + PART;
  float* red = f + RED;
  const int warp = t >> 5, lane = t & 31;
  float s[CLS_KEYS];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < CLS_KEYS; ++i) {
    const int j = t + THREADS * i;
    s[i] = -INFINITY;
    if (j < S) {
      float d = 0.0f;
      if (j == 0) {
#pragma unroll
        for (int e = 0; e < HD; ++e) d += qc[e] * kc[e];
      } else {
        const unsigned char* box = Kb + ((j - 1) / CHUNK) * BOX_BYTES;
        const int r = (j - 1) % CHUNK;
#pragma unroll
        for (int ch = 0; ch < HD / 8; ++ch) {
          float kv[8];
          unpack8_bf16(*reinterpret_cast<const uint4*>(box + swz(r, ch)), kv);
#pragma unroll
          for (int e = 0; e < 8; ++e) d += qc[8 * ch + e] * kv[e];
        }
      }
      s[i] = d * scale;
    }
    mx = fmaxf(mx, s[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  float l = 0.0f;
#pragma unroll
  for (int i = 0; i < CLS_KEYS; ++i) {
    const int j = t + THREADS * i;
    if (j < S) {
      const float p = ex2(s[i] - mx);
      l += p;
      pc[j] = round_bf16(p);  // P.V reads P as bf16
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) red[4 + warp] = l;
  __syncthreads();
  // warp w sums keys w, w + 4, ..; lane c the columns 2c, 2c + 1 (a warp
  // reads one whole 128-byte row of V a key)
  float a0 = 0.0f, a1 = 0.0f;
  for (int j = warp; j < S; j += 4) {
    float2 v;
    if (j == 0) {
      v = make_float2(vc[2 * lane], vc[2 * lane + 1]);
    } else {
      const unsigned char* box = Vb + ((j - 1) / CHUNK) * BOX_BYTES;
      v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          box + swz((j - 1) % CHUNK, lane >> 2) + (lane & 3) * 4));
    }
    a0 += pc[j] * v.x;
    a1 += pc[j] * v.y;
  }
  part[warp * HD + 2 * lane] = a0;
  part[warp * HD + 2 * lane + 1] = a1;
  __syncthreads();
  if (warp == 0) {
    l = (red[4] + red[5]) + (red[6] + red[7]);
    const float o0 = (part[2 * lane] + part[HD + 2 * lane]) +
                     (part[2 * HD + 2 * lane] + part[3 * HD + 2 * lane]);
    const float o1 = (part[2 * lane + 1] + part[HD + 2 * lane + 1]) +
                     (part[2 * HD + 2 * lane + 1] + part[3 * HD + 2 * lane + 1]);
    *reinterpret_cast<__nv_bfloat162*>(out + 2 * lane) = __floats2bfloat162_rn(o0 / l, o1 / l);
  }
}

struct Args {
  const bf16* qkv;
  bf16* out;
  int S, E, H;
  float scale;
};

// Grid (heads x tile groups, N): a block walks a group of up to MOST_TILES
// patch query tiles of a (head, slice), the patch K and V loaded once; the
// block of group 0 then takes the CLS query row. TWO: the two-pass body (P
// > ONE_PASS_P).
template <bool TWO>
__global__ void __launch_bounds__(THREADS)
split_cls_kernel(const __grid_constant__ CUtensorMap t64, Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  const int nb = boxes(a.S);
  const Layout L = layout(a.S);
  unsigned char* Kb = base + L.k;
  unsigned char* Vb = base + L.v;
  float* f = reinterpret_cast<float*>(base + L.v + size_t(nb) * BOX_BYTES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L.bar);

  const int t = threadIdx.x;
  const int n = blockIdx.y;
  const int tpb = tiles_per_block(a.S - 1, MOST_TILES);
  const int groups = (nb + tpb - 1) / tpb;
  const int g = blockIdx.x % groups;
  const int h = blockIdx.x / groups;
  const int units = min(tpb, nb - g * tpb);
  const bf16* row0 = a.qkv + size_t(n) * a.S * 3 * a.E + h * HD;  // the CLS row's q of head h
  // thread 0: unit u's Q box (slice rows 1 + 64 (g tpb + u) ..) into buffer u % 2
  auto load_q = [&](int u) {
    unsigned char* q = base + L.q + (u & 1) * BOX_BYTES;
    sm90::mbar_expect_tx(&bar[u & 1], BOX_BYTES);
    tma_load_3d(q, &t64, h * HD, 1 + (g * tpb + u) * TILE, n, &bar[u & 1]);
  };
  if (t == 0) {
    for (int i = 0; i < 2 + nb; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::tma_prefetch(&t64);
    load_q(0);
    for (int b = 0; b < nb; ++b) {
      sm90::mbar_expect_tx(&bar[2 + b], 2 * BOX_BYTES);
      tma_load_3d(Kb + b * BOX_BYTES, &t64, a.E + h * HD, 1 + b * CHUNK, n, &bar[2 + b]);
      tma_load_3d(Vb + b * BOX_BYTES, &t64, 2 * a.E + h * HD, 1 + b * CHUNK, n, &bar[2 + b]);
    }
    if (units > 1) load_q(1);
  }
  if (t < HD) {
    f[KC + t] = __bfloat162float(row0[a.E + t]);
    f[VC + t] = __bfloat162float(row0[2 * a.E + t]);
    f[QC + t] = __bfloat162float(row0[t]);
  }
  __syncthreads();

  for (int u = 0; u < units; ++u) {
    const int q0 = 1 + (g * tpb + u) * TILE;
    const Rows c = rows_of(t, 0);  // rows qa, qb of the tile
    unsigned char* Qb = base + L.q + (u & 1) * BOX_BYTES;
    mbar_wait(&bar[u & 1], (u >> 1) & 1);

    // the CLS strip: this lane's 16 columns of rows qa and qb, then the quad
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ch = 2 * (c.lane & 3) + k;
      float qa[8], qb[8];
      unpack8_bf16(*reinterpret_cast<const uint4*>(Qb + swz(c.qa, ch)), qa);
      unpack8_bf16(*reinterpret_cast<const uint4*>(Qb + swz(c.qb, ch)), qb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sa += qa[e] * f[KC + 8 * ch + e];
        sb += qb[e] * f[KC + 8 * ch + e];
      }
    }
    sa = quad_sum(sa) * a.scale;
    sb = quad_sum(sb) * a.scale;

    float acc[32];
    zero(acc);
    float l0 = 0.0f, l1 = 0.0f, m0 = sa, m1 = sb;
    if constexpr (!TWO) {
      // every score of the tile's rows in registers: up to 4 boxes of 64
      // keys, one commit group a box, at most two in flight
      float s[4][32];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < nb) {
          mbar_wait(&bar[2 + b], 0);
          scores(s[b], Qb, Kb + b * BOX_BYTES);
          wgmma_wait<1>();
        }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < 4; ++b) fence_regs(s[b]);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < nb) scale_mask<EXP_2, false>(s[b], 0, t, CHUNK, a.scale, m0, m1);
      m0 = quad_max(m0);
      m1 = quad_max(m1);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < nb) exp_rows<EXP_2>(s[b], m0, m1, l0, l1);
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < nb) pv_sync(acc, s[b], Vb + b * BOX_BYTES, c.lane);
    } else {
      // pass 1: m (from s_pc up) and l, rescaled when m grows, box by box
      float s[32];
      for (int b = 0; b < nb; ++b) {
        mbar_wait(&bar[2 + b], 0);
        scores(s, Qb, Kb + b * BOX_BYTES);
        wgmma_wait<0>();
        fence_regs(s);
        online<EXP_2, true>(s, 0, c, CHUNK, a.scale, m0, m1, l0, l1);
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      // pass 2: the scores again, p against the final max, P.V
      for (int b = 0; b < nb; ++b) {
        scores(s, Qb, Kb + b * BOX_BYTES);
        wgmma_wait<0>();  // also the previous box's P.V
        fence_regs(s);
        fence_regs(acc);
        probs<EXP_2, false>(s, 0, c, CHUNK, a.scale, m0, m1, l0, l1);
        pv(acc, s, Vb + b * BOX_BYTES);
      }
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // o_p = (P.V + p_pc v_c) / l, the CLS term in f32, then through this
    // unit's Q box (the scores are done with it)
    const float pa = ex2(sa - m0), pb = ex2(sb - m1);
    const float la = l0 + pa, lb = l1 + pb;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = frag_hi(i);
      acc[i] = __fadd_rn(acc[i], __fmul_rn(hi ? pb : pa, f[VC + frag_col(t, i)])) / (hi ? lb : la);
    }
    stage_box(Qb, t, acc);
    __syncthreads();
    store_box(Qb, t, a.out + (size_t(n) * a.S + q0) * a.E + h * HD, a.E, TILE);
    // every read of this unit's Q box is done before TMA refills it
    fence_async_smem();
    __syncthreads();
    if (t == 0 && u + 2 < units) load_q(u + 2);
  }
  if (g == 0) cls_row(Kb, Vb, f, a.out + size_t(n) * a.S * a.E + h * HD, a.S, a.scale, t);
}

template <bool TWO>
cudaError_t launch_split(const CUtensorMap& t64, const Args& a, int N, cudaStream_t st) {
  const size_t bytes = layout(a.S).total;
  auto kernel = split_cls_kernel<TWO>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int tpb = tiles_per_block(a.S - 1, MOST_TILES);
  const dim3 grid(a.H * ((boxes(a.S) + tpb - 1) / tpb), N);
  kernel<<<grid, THREADS, bytes, st>>>(t64, a);
  return cudaGetLastError();
}

}  // namespace split

}  // namespace
}  // namespace mst

// qkv [N*S, 3E] bf16 -> out [N*S, E] bf16 in softmax form `variant` (0-4:
// A-E above); p_out [N, H, S, S] bf16 or NULL. scale: 1/sqrt(64) for A and
// B, log2(e)/sqrt(64) for C, D and E. Needs E == 64 * num_heads and
// 1 <= S <= 512.
extern "C" int mst_attn_variant(const void* qkv, void* out, void* p_out, int N, int S, int E,
                                int num_heads, int variant, float scale, void* stream) {
  using namespace mst;
  if (bad_shape(N, S, E, num_heads) || variant < VAR_A || variant > VAR_E)
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
  if (S <= 0 || S > attn::MAX_S) return cudaErrorInvalidValue;
  const Plan p = plan(S);
  const int g[8] = {TILE, tiles(S), tiles_per_block(S, MOST_TILES), THREADS,
                    S > ONE_PASS_MAX ? 2 : 1, p.n64, p.tail, static_cast<int>(layout(S).total)};
  for (int i = 0; i < 8; ++i) geo[i] = g[i];
  return cudaSuccess;
}

// The split-CLS core: qkv [N*S, 3E] bf16 -> out [N*S, E] bf16, S = 1 + P
// with P % 64 == 0 and 64 <= P <= 384, scale = log2(e)/sqrt(64). One
// launch: the patch tiles, then the CLS rows.
extern "C" int mst_attn_split_cls(const void* qkv, void* out, int N, int S, int E,
                                  int num_heads, float scale, void* stream) {
  using namespace mst;
  if (bad_shape(N, S, E, num_heads) || split::bad_length(S)) return cudaErrorInvalidValue;
  CUtensorMap t64;
  const cudaError_t err = tma_map_3d(&t64, qkv, N, S, 3 * size_t(E), CHUNK);
  if (err != cudaSuccess) return err;
  const split::Args a{static_cast<const bf16*>(qkv), static_cast<bf16*>(out), S, E, num_heads,
                      scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S - 1 > split::ONE_PASS_P ? split::launch_split<true>(t64, a, N, st)
                                   : split::launch_split<false>(t64, a, N, st);
}

// The launch geometry of mst_attn_split_cls at sequence length S (S = 1 +
// P, P % 64 == 0, 64 <= P <= 384): geo = {query tile rows, patch query
// tiles, tiles a block walks, threads, passes, patch key boxes of 64,
// dynamic shared memory bytes}, as the launch sets them
// (`bench_attn_split_cls.split_launch` mirrors it).
extern "C" int mst_attn_split_cls_geometry(int S, int* geo) {
  using namespace mst;
  if (S <= 0 || S > attn::MAX_S || split::bad_length(S)) return cudaErrorInvalidValue;
  const int nb = split::boxes(S);
  const int g[7] = {TILE, nb, tiles_per_block(S - 1, MOST_TILES), THREADS,
                    S - 1 > split::ONE_PASS_P ? 2 : 1, nb,
                    static_cast<int>(split::layout(S).total)};
  for (int i = 0; i < 7; ++i) geo[i] = g[i];
  return cudaSuccess;
}
