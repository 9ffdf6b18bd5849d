// mhsa: per-slice, per-head softmax attention over a packed qkv block.
// qkv [N*S, 3E] bf16 (columns [q | k | v], head h at h*64 inside each)
// -> o [N*S, E] bf16 (head h at columns h*64).
//
// Replaces the attention core of `_attn_any_kernel` and of
// `_attn_train_kernel` / `_mhsa(want_lse=True)` in
// mst_tpu/ops/fused_block.py (`_mhsa` :207). Same math and the same
// rounding points as the Pallas body: s = q.k^T * (log2(e) / sqrt(hd)) in
// f32, p = exp2(s - m) against the row's final max m, l = rowsum(p) of the
// f32 p, P cast to bf16 before the P.V product (f32 sums), and o = (P.V) /
// l, cast to bf16. With `lse` set (training; NULL when serving) each row's
// base-2 log-sum-exp b = m + log2(l) goes to lse[(n * S + q) * heads + h]
// (JAX's [N, S, heads] layout), from which the backward (mhsa_bwd.cu)
// rebuilds p = exp2(s - b) in one pass.
//
// Bound on the H100: at ViT-S B=8, [256 slices, 6 heads, S = 257, hd 64],
// the two products are 26 GFLOP (26 us at 989 TFLOP/s) against 202 MB of
// qkv and o (60 us at 3.35 TB/s): bound by bytes, if the scores stay on
// chip. What held the WMMA kernel back was the [64][sp] f32 score rows in
// shared memory and four phases without overlap; on the card the limit
// proved to be instructions issued per score (8 warps an SM). The design
// (attn_sm90.cuh):
// - one block, one warpgroup, per (head, slice) walks up to 5 of the head's
//   64-query tiles (`tiles_per_block`): thread 0 starts TMA loads of every
//   64-key box of K and V of the head at once, each box pair on its own
//   mbarrier, from a 3-D map over [N, S, 3E] (keys past S of a slice read
//   as zeros, not the next slice's), and of the Q tiles into two boxes, the
//   tile after next streaming in while one runs;
// - the scores are wgmma m64n64k16 products (Q and K K-major in shared
//   memory) into registers, one commit group a chunk, and one m64n16 for a
//   last chunk of <= 16 keys (the 257th key of ViT-S costs 8 registers a
//   thread and a 2 KB box, not 32 and 8 KB);
// - one pass where a row fits the registers (S <= 272: 4 x 32 + 8 f32 a
//   thread): all scores, the final row max over the 4 lanes of a row, p in
//   place (`ex2.approx.ftz`; only the last chunk masked), l, the hooks,
//   then P.V by mma.sync m16n8k16 per warp: P's bf16 pairs are its A
//   fragments in place and V's B fragments come from its boxes by
//   `ldmatrix .trans`. With register-A wgmma here ptxas serialized every
//   wgmma of the kernel for want of registers (136 live scores); the
//   synchronous product keeps the score products asynchronous. A warp
//   whose 16 rows all lie past S skips the softmax.
//   Above 272 (C3's S = 442 / 512) two passes over the resident chunks,
//   P.V by register-A wgmma: the first keeps m and l (l rescaled when m
//   grows, the only summation order the plain version does not share:
//   within f32 rounding), the second recomputes each chunk's scores, takes
//   p = exp2(s - m) and runs P.V. No online softmax: the output hooks
//   below read the final p / l, and bf16(p) is rounded at the final max as
//   in JAX;
// - o = acc / l is staged through the tile's Q box (free once the scores
//   are done) and leaves as 16-byte row stores.
// Neither scores nor probabilities reach shared or device memory. A block
// holds two 8 KB Q boxes and the K and V boxes (95 KB at S = 257: two
// blocks an SM; 157 KB at S = 512).
//
// The explainability outputs (the flags `want_row`, `carry` and `abnar` of
// `_attn_any_kernel`, sub-layers `fused_attention_sublayer_with_row`
// :1479, `_rollout` :1535, `_abnar` :1503) read the f32 p and l in the
// registers before P is rounded for P.V:
// - row: the tile with q0 == 0 writes row 0's p / l, [N, heads, S] f32;
// - carry: new[j] = sum_q carry[q] * (1 / l_q) * p[q, j]. Each thread adds
//   its two rows, a butterfly over the lanes 4, 8 and 16 apart adds the
//   warp's, the 4 warps are added in order through shared memory, each
//   tile writes one partial [S] per (tile, slice, head), and
//   `sum_partials` adds the tiles in a fixed order: no float atomics, so
//   two runs give the same bits;
// - abnar: the head mean crosses the heads, so its kernel is another grid,
//   one block per (64-query tile, slice), that walks the heads on the same
//   body (o of each written as above) and adds p / l of each head, in head
//   order as the Pallas body does, at places its threads own: one-pass, in
//   shared memory, a slot per score register and thread ([136][128] f32,
//   70 KB); two-pass, in the rows of the [N, S, S] f32 factor itself. Its
//   epilogue adds I, row-normalises (the row sums over the 4 lanes of a
//   row) and writes each element once. The 64-row tile serves every
//   S <= 512.
//
// RoPE (the `has_rope` flag of `_attn_any_kernel`, sub-layers
// `fused_attention_sublayer_rope` :1435 and `_rope_with_row` :1582, the
// rope_cos of `_rollout` / `_abnar`, and `_attn_train_kernel`'s rope; the
// DINOv3 encoder) is the template flag ROPE: once a box of Q or K has
// landed, the warpgroup rotates it in place, pair by pair in f32 from the
// bf16 values and the [S, 64] f32 cos / sin tables (`rope8` in common.cuh),
// stored as bf16, which is where `_mhsa` rounds them; then a proxy fence
// orders those writes before the wgmma reads. The tables stay in L2. The
// kernels without ROPE carry no code of it.
#include "attn_sm90.cuh"

namespace mst {
namespace {

using namespace attn;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int ONE_PASS_MAX = 4 * CHUNK + TAIL;  // 272: a row's scores fit the registers
constexpr int MOST_TILES = 5;                   // query tiles a block walks, at most
constexpr int WARPS = THREADS / 32;
constexpr int RED_LD = MAX_S;  // f32 stride of a warp's carry sums

// Shared memory (bytes past the 1024-byte aligned base): two Q boxes (this
// tile's and the next's), the K boxes, the V boxes, the carry's [4
// warps][512] f32 sums, then the barriers (0, 1: the Q boxes; 2 + b: K and
// V of chunk b); the one-pass Abnar kernel then its f32 head sum, one slot
// per score register and thread ([136][128], each thread's own).
struct Layout {
  size_t q, k, v, red, bar, asum, total;
};

constexpr int ASUM_REGS = 4 * CHUNK / 2 + TAIL / 2;  // 136: a one-pass thread's scores

__host__ __device__ inline Layout layout(int S, bool abnar = false) {
  const Plan p = plan(S);
  Layout L;
  L.q = 0;
  L.k = L.q + 2 * BOX_BYTES;
  L.v = L.k + operand_bytes(p);
  L.red = L.v + operand_bytes(p);
  L.bar = L.red + size_t(WARPS) * RED_LD * sizeof(float);
  L.asum = L.bar + size_t(2 + p.boxes) * sizeof(uint64_t);
  const bool smem_sum = abnar && S <= ONE_PASS_MAX;
  L.total = ALIGN + L.asum + (smem_sum ? size_t(ASUM_REGS) * THREADS * sizeof(float) : 0);
  return L;
}

struct Args {
  bf16* out;
  float* lse;
  float* row;
  const float* carry;
  float* part;
  float* factor;
  const float* rcos;
  const float* rsin;
  int S, E, H;
  float scale;
};

// What a block knows of its unit (tile, head, slice) and its thread.
struct Ctx {
  int t, warp, lane, q0, h, n, qa, qb;  // qa / qb: this thread's two rows
  size_t nh;                            // slice-head index n * H + h
};

// Scale a chunk's scores in place, with MASK the keys past S to -inf (a
// chunk that ends at or before S needs none); fold their row maxima into
// m0 / m1 (this thread's share of rows qa / qb).
template <bool MASK = true, int R>
__device__ __forceinline__ void scale_mask(float (&s)[R], int key0, const Ctx& c, const Args& a,
                                           float& m0, float& m1) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool in = !MASK || key0 + frag_col(c.t, i) < a.S;
    s[i] = in ? s[i] * a.scale : -INFINITY;
    if (frag_hi(i))
      m1 = fmaxf(m1, s[i]);
    else
      m0 = fmaxf(m0, s[i]);
  }
}

// p = exp2(s - m) in place; adds this thread's share of the chunk's two row
// sums to l0 / l1, each summed as a tree (the column pairs, then their
// halves) rather than in one running sum: nearer the plain version's
// pairwise sum, so o's bf16 rounding (o = (P.V) / l) matches it more often.
template <int R>
__device__ __forceinline__ void exp_rows(float (&s)[R], float m0, float m1, float& l0,
                                         float& l1) {
  float a[R / 4], b[R / 4];  // rows lo, hi: the pair of columns of each group
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {
    s[4 * k] = ex2(s[4 * k] - m0);
    s[4 * k + 1] = ex2(s[4 * k + 1] - m0);
    s[4 * k + 2] = ex2(s[4 * k + 2] - m1);
    s[4 * k + 3] = ex2(s[4 * k + 3] - m1);
    a[k] = s[4 * k] + s[4 * k + 1];
    b[k] = s[4 * k + 2] + s[4 * k + 3];
  }
  l0 += tree_sum(a);
  l1 += tree_sum(b);
}

// Pass 1 of the two-pass body on a chunk: fold its row maxima into m0 / m1
// (over the quad) and rescale this thread's share of l to the new max.
template <int R>
__device__ __forceinline__ void online(float (&s)[R], int key0, const Ctx& c, const Args& a,
                                       float& m0, float& m1, float& l0, float& l1) {
  float x0 = -INFINITY, x1 = -INFINITY;
  scale_mask(s, key0, c, a, x0, x1);
  x0 = fmaxf(m0, quad_max(x0));
  x1 = fmaxf(m1, quad_max(x1));
  l0 *= ex2(m0 - x0);
  l1 *= ex2(m1 - x1);
  exp_rows(s, x0, x1, l0, l1);
  m0 = x0;
  m1 = x1;
}

// Pass 2: p = exp2(s - m) of a chunk against the final max.
template <int R>
__device__ __forceinline__ void probs(float (&s)[R], int key0, const Ctx& c, const Args& a,
                                      float m0, float m1) {
  float x0 = -INFINITY, x1 = -INFINITY, y0 = 0.0f, y1 = 0.0f;
  scale_mask(s, key0, c, a, x0, x1);
  exp_rows(s, m0, m1, y0, y1);
}

// The output hooks on a chunk's f32 p (keys key0 .., score registers e0
// .. of the one-pass body), with l0 / l1 the row sums: the CLS row, this
// block's share of the carry (into `red`), the Abnar head sum (head hh of
// the serial loop; in `asum` for the one-pass body, else in the factor
// rows themselves).
template <bool ROW, bool CARRY, bool ABNAR, bool TWO, int R>
__device__ __forceinline__ void hooks(const float (&p)[R], int key0, int e0, const Ctx& c,
                                      const Args& a, float l0, float l1, float c0, float c1,
                                      float* red, float* asum, int hh) {
  if (ROW && c.q0 == 0 && c.warp == 0 && (c.lane >> 2) == 0) {  // row 0 is qa here
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = key0 + frag_col(c.t, i);
      if (!frag_hi(i) && j < a.S) a.row[c.nh * a.S + j] = p[i] / l0;
    }
  }
  if (CARRY) {
    // per column: rows qa, qb of the thread (c0 = carry / l, 0 past S),
    // then the warp's 8 row pairs by a butterfly over lanes 4, 8, 16 apart
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      float v0 = c0 * p[i] + c1 * p[i + 2], v1 = c0 * p[i + 1] + c1 * p[i + 3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, o);
        v1 += __shfl_xor_sync(0xffffffffu, v1, o);
      }
      if (c.lane < 4) {
        float* r = red + c.warp * RED_LD + key0 + frag_col(c.t, i);
        r[0] = v0;
        r[1] = v1;
      }
    }
  }
  if (ABNAR) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = key0 + frag_col(c.t, i);
      const int q = frag_hi(i) ? c.qb : c.qa;
      float* f = TWO ? a.factor + (size_t(c.n) * a.S + q) * a.S + j
                     : asum + (e0 + i) * THREADS + c.t;
      if (!TWO || (j < a.S && q < a.S)) {
        const float v = p[i] / (frag_hi(i) ? l1 : l0);
        *f = hh == 0 ? v : *f + v;
      }
    }
  }
}

// acc += bf16(p) . V over a chunk's keys: the A fragments are packed,
// fenced, then the products issued (one commit group; the caller waits).
// Every 16-key step runs, those past S too: their p and V rows are zeros,
// and a wgmma under a branch would be serialized.
template <int R>
__device__ __forceinline__ void pv(float (&acc)[32], const float (&p)[R],
                                   const unsigned char* vbox) {
  uint32_t a[R / 8][4];
#pragma unroll
  for (int kc = 0; kc < R / 8; ++kc) frag_a(a[kc], p, kc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < R / 8; ++kc) mma_rs(acc, a[kc], desc_mn(vbox, kc));
  wgmma_commit();
}

// acc += bf16(p) . V over a chunk's keys by mma.sync m16n8k16, each warp
// its 16 rows: p's bf16 pairs are the A fragments (the wgmma D fragment of a
// warp is the m16n8 C fragment of each 8-column group), V's B fragments
// come from its swizzled box by `ldmatrix .trans`. Synchronous: the
// one-pass body's scores leave ptxas no registers to keep register-A
// wgmmas in flight, and it would serialize every wgmma of the kernel.
template <int R>
__device__ __forceinline__ void pv_sync(float (&acc)[32], const float (&p)[R],
                                        const unsigned char* vbox, int lane) {
#pragma unroll
  for (int kc = 0; kc < R / 8; ++kc) {
    uint32_t a[4];
    frag_a(a, p, kc);
    const int row = 16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, vbox + swz(row, 2 * np + (lane >> 4)));
      mma_16816(*reinterpret_cast<float(*)[4]>(&acc[8 * np]), a, b[0], b[1]);
      mma_16816(*reinterpret_cast<float(*)[4]>(&acc[8 * np + 4]), a, b[2], b[3]);
    }
  }
}

// A chunk's scores, q.k^T over the head dim: one commit group.
template <int R>
__device__ __forceinline__ void scores(float (&s)[R], const unsigned char* qbox,
                                       const unsigned char* kbox) {
  wgmma_fence();
  product_t(s, qbox, kbox);
  wgmma_commit();
}

// Grid (heads x tile groups, N): a block walks a group of up to MOST_TILES
// query tiles of a (head, slice), K and V loaded once; or, with ABNAR,
// grid (query tiles, N): one block per (tile, slice) walks the heads, K and
// V of each loaded in turn. A unit is one (tile, head); the Q box of the
// unit after next streams in while this one runs. TWO: the two-pass body (S > ONE_PASS_MAX). ROW,
// CARRY, ROPE, ABNAR: the outputs and the rotation (template flags, so the
// plain kernel carries no code of theirs); lse: NULL when not wanted.
template <bool TWO, bool ROW, bool CARRY, bool ROPE, bool ABNAR>
__global__ void __launch_bounds__(THREADS)
mhsa_kernel(const __grid_constant__ CUtensorMap t64, const __grid_constant__ CUtensorMap t16,
            Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  const Plan P = plan(a.S);
  const Layout L = layout(a.S, ABNAR);
  unsigned char* Kb = base + L.k;
  float* asum = reinterpret_cast<float*>(base + L.asum);
  unsigned char* Vb = base + L.v;
  float* red = reinterpret_cast<float*>(base + L.red);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L.bar);

  Ctx c;
  c.t = threadIdx.x;
  c.warp = c.t >> 5;
  c.lane = c.t & 31;
  c.n = blockIdx.y;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const int groups = (tiles(a.S) + tpb - 1) / tpb;
  const int g = blockIdx.x % groups;
  const int units = ABNAR ? a.H : min(tpb, tiles(a.S) - g * tpb);
  auto head_of = [&](int u) { return ABNAR ? u : int(blockIdx.x) / groups; };
  auto q0_of = [&](int u) { return (ABNAR ? int(blockIdx.x) : g * tpb + u) * TILE; };
  // thread 0: unit u's Q box into buffer u % 2; K and V of head h
  auto load_q = [&](int u) {
    unsigned char* q = base + L.q + (u & 1) * BOX_BYTES;
    sm90::mbar_expect_tx(&bar[u & 1], BOX_BYTES);
    tma_load_3d(q, &t64, head_of(u) * HD, q0_of(u), c.n, &bar[u & 1]);
  };
  auto load_kv = [&](int h) {
    for (int b = 0; b < P.boxes; ++b) {
      const bool full = b < P.n64;
      const CUtensorMap* m = full ? &t64 : &t16;
      sm90::mbar_expect_tx(&bar[2 + b], 2 * (full ? BOX_BYTES : TAIL_BYTES));
      tma_load_3d(Kb + b * BOX_BYTES, m, a.E + h * HD, b * CHUNK, c.n, &bar[2 + b]);
      tma_load_3d(Vb + b * BOX_BYTES, m, 2 * a.E + h * HD, b * CHUNK, c.n, &bar[2 + b]);
    }
  };
  if (c.t == 0) {
    for (int i = 0; i < 2 + P.boxes; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::tma_prefetch(&t64);
    sm90::tma_prefetch(&t16);
    load_q(0);
    load_kv(head_of(0));
    if (units > 1) load_q(1);
  }
  __syncthreads();

  for (int u = 0; u < units; ++u) {
    c.h = head_of(u);
    c.q0 = q0_of(u);
    c.nh = size_t(c.n) * a.H + c.h;
    c.qa = c.q0 + 16 * c.warp + (c.lane >> 2);
    c.qb = c.qa + 8;
    unsigned char* Qb = base + L.q + (u & 1) * BOX_BYTES;
    const uint32_t qpar = (u >> 1) & 1, kvpar = ABNAR ? (u & 1) : 0;
    const bool fresh_kv = ABNAR || u == 0;  // K and V new in this unit
    // a warp whose 16 rows all lie past S (the last tile of S = 257) skips
    // the softmax: its q rows are zeros, so s = 0, and nothing of it is
    // stored (CARRY still adds its zero share)
    const bool live = c.q0 + 16 * c.warp < a.S;
    if (ROPE) {  // rotate q and k where they land
      mbar_wait(&bar[u & 1], qpar);
      rope_box(Qb, c.t, c.q0, a.S, a.rcos, a.rsin);
      if (fresh_kv)
        for (int b = 0; b < P.boxes; ++b) {
          mbar_wait(&bar[2 + b], kvpar);
          rope_box(Kb + b * BOX_BYTES, c.t, b * CHUNK, a.S, a.rcos, a.rsin);
        }
      __syncthreads();
    }

    float acc[32];
    zero(acc);
    float l0 = 0.0f, l1 = 0.0f, m0 = -INFINITY, m1 = -INFINITY;
    float c0 = 0.0f, c1 = 0.0f;  // CARRY: carry / l of rows qa, qb (0 past S)
    mbar_wait(&bar[u & 1], qpar);
    if constexpr (!TWO) {
      // every score of the tile's rows in registers: 4 chunks of 64 keys and
      // a tail of 16
      float s[4][32], st[8];
      // one commit group a chunk, at most two in flight: more would hold
      // more descriptors and accumulators than ptxas keeps for an
      // unserialized pipeline
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < P.n64) {
          mbar_wait(&bar[2 + b], kvpar);
          scores(s[b], Qb, Kb + b * BOX_BYTES);
          wgmma_wait<1>();
        }
      if (P.tail) {
        mbar_wait(&bar[2 + P.n64], kvpar);
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
              scale_mask<false>(s[b], b * CHUNK, c, a, m0, m1);
            else
              scale_mask(s[b], b * CHUNK, c, a, m0, m1);
          }
        if (P.tail) scale_mask(st, P.n64 * CHUNK, c, a, m0, m1);
        m0 = quad_max(m0);
        m1 = quad_max(m1);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < P.n64) exp_rows(s[b], m0, m1, l0, l1);
        if (P.tail) exp_rows(st, m0, m1, l0, l1);
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
      }
      if (CARRY) {
        c0 = c.qa < a.S ? a.carry[c.nh * a.S + c.qa] * (1.0f / l0) : 0.0f;
        c1 = c.qb < a.S ? a.carry[c.nh * a.S + c.qb] * (1.0f / l1) : 0.0f;
      }
      // the hooks read every chunk's f32 p; then P's bf16 pairs (half the
      // registers: the products in flight must keep theirs) are the A
      // operand of every P.V product, issued at once
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < P.n64)
          hooks<ROW, CARRY, ABNAR, TWO>(s[b], b * CHUNK, b * 32, c, a, l0, l1, c0, c1, red,
                                        asum, u);
      if (P.tail)
        hooks<ROW, CARRY, ABNAR, TWO>(st, P.n64 * CHUNK, P.n64 * 32, c, a, l0, l1, c0, c1,
                                      red, asum, u);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < P.n64) pv_sync(acc, s[b], Vb + b * BOX_BYTES, c.lane);
      if (P.tail) pv_sync(acc, st, Vb + P.n64 * BOX_BYTES, c.lane);
    } else {
      // pass 1: m and l chunk by chunk (l rescaled when m grows)
      float s[32], st[8];
      for (int b = 0; b < P.n64; ++b) {
        mbar_wait(&bar[2 + b], kvpar);
        scores(s, Qb, Kb + b * BOX_BYTES);
        wgmma_wait<0>();
        fence_regs(s);
        online(s, b * CHUNK, c, a, m0, m1, l0, l1);
      }
      if (P.tail) {
        mbar_wait(&bar[2 + P.n64], kvpar);
        scores(st, Qb, Kb + P.n64 * BOX_BYTES);
        wgmma_wait<0>();
        fence_regs(st);
        online(st, P.n64 * CHUNK, c, a, m0, m1, l0, l1);
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      if (CARRY) {
        c0 = c.qa < a.S ? a.carry[c.nh * a.S + c.qa] * (1.0f / l0) : 0.0f;
        c1 = c.qb < a.S ? a.carry[c.nh * a.S + c.qb] * (1.0f / l1) : 0.0f;
      }
      // pass 2: the scores again, p against the final max, hooks, P.V
      for (int b = 0; b < P.n64; ++b) {
        scores(s, Qb, Kb + b * BOX_BYTES);
        wgmma_wait<0>();  // also the previous chunk's P.V
        fence_regs(s);
        fence_regs(acc);
        probs(s, b * CHUNK, c, a, m0, m1);
        hooks<ROW, CARRY, ABNAR, TWO>(s, b * CHUNK, 0, c, a, l0, l1, c0, c1, red, asum, u);
        pv(acc, s, Vb + b * BOX_BYTES);
      }
      if (P.tail) {
        scores(st, Qb, Kb + P.n64 * BOX_BYTES);
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(acc);
        probs(st, P.n64 * CHUNK, c, a, m0, m1);
        hooks<ROW, CARRY, ABNAR, TWO>(st, P.n64 * CHUNK, 0, c, a, l0, l1, c0, c1, red, asum,
                                      u);
        pv(acc, st, Vb + P.n64 * BOX_BYTES);
      }
      wgmma_wait<0>();
      fence_regs(acc);
    }

    // LSE, then o = acc / l through this unit's Q box (the scores are done
    // with it)
    if (a.lse != nullptr && (c.lane & 3) == 0) {
      if (c.qa < a.S) a.lse[(size_t(c.n) * a.S + c.qa) * a.H + c.h] = m0 + log2f(l0);
      if (c.qb < a.S) a.lse[(size_t(c.n) * a.S + c.qb) * a.H + c.h] = m1 + log2f(l1);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = acc[i] / (frag_hi(i) ? l1 : l0);
    stage_box(Qb, c.t, acc);
    __syncthreads();
    store_box(Qb, c.t, a.out + (size_t(c.n) * a.S + c.q0) * a.E + c.h * HD, a.E,
              min(TILE, a.S - c.q0));
    if (CARRY) {  // the 4 warps' column sums in order: this tile's partial
      float* dst = a.part + (size_t(c.q0 / TILE) * gridDim.y * a.H + c.nh) * a.S;
      for (int j = c.t; j < a.S; j += THREADS)
        dst[j] = ((red[j] + red[RED_LD + j]) + red[2 * RED_LD + j]) + red[3 * RED_LD + j];
    }
    // every read of this unit's boxes (and of `red`) is done before TMA
    // refills them
    fence_async_smem();
    __syncthreads();
    if (c.t == 0) {
      if (u + 2 < units) load_q(u + 2);
      if (ABNAR && u + 1 < units) load_kv(head_of(u + 1));
    }
  }
  if (!ABNAR) return;

  // rownorm(sum_h p_h / l_h / H + I) of the rows this thread owns: their
  // sums over the 4 lanes of a row, then each element once
  const float inv_h = 1.0f / a.H;
  float sum0 = 0.0f, sum1 = 0.0f;
  auto each = [&](auto&& fn) {  // fn(head sum, row hi, q, j) at each place
    for (int b = 0; b < P.boxes; ++b) {
      const int width = b < P.n64 ? CHUNK : TAIL;
      for (int i = 0; i < width / 2; ++i) {
        const int j = b * CHUNK + frag_col(c.t, i);
        const int q = frag_hi(i) ? c.qb : c.qa;
        if (j < a.S && q < a.S) {
          float* f = a.factor + (size_t(c.n) * a.S + q) * a.S + j;
          fn(TWO ? *f : asum[(32 * b + i) * THREADS + c.t], frag_hi(i), q, j, f);
        }
      }
    }
  };
  each([&](float x, bool hi, int q, int j, float*) {
    const float v = x * inv_h + (j == q ? 1.0f : 0.0f);
    if (hi)
      sum1 += v;
    else
      sum0 += v;
  });
  sum0 = quad_sum(sum0);
  sum1 = quad_sum(sum1);
  each([&](float x, bool hi, int q, int j, float* f) {
    *f = (x * inv_h + (j == q ? 1.0f : 0.0f)) / (hi ? sum1 : sum0);
  });
}

template <bool TWO, bool ROW, bool CARRY, bool ROPE, bool ABNAR>
cudaError_t launch(const CUtensorMap& t64, const CUtensorMap& t16, const Args& a, float* new_carry,
                   int N, cudaStream_t st) {
  const size_t bytes = layout(a.S, ABNAR).total;
  auto kernel = mhsa_kernel<TWO, ROW, CARRY, ROPE, ABNAR>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const dim3 grid = ABNAR ? dim3(tiles(a.S), N) : dim3(a.H * ((tiles(a.S) + tpb - 1) / tpb), N);
  kernel<<<grid, THREADS, bytes, st>>>(t64, t16, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !CARRY) return err;
  // the fixed-order sum of the per-tile partials into new_carry [N, heads, S]
  return sum_partials(a.part, new_carry, tiles(a.S), N * a.H * a.S, st);
}

template <bool TWO, bool ROPE>
cudaError_t dispatch(const CUtensorMap& t64, const CUtensorMap& t16, const Args& a,
                     float* nc, int N, cudaStream_t st) {
  if (a.factor != nullptr) return launch<TWO, false, false, ROPE, true>(t64, t16, a, nc, N, st);
  if (a.carry != nullptr)
    return a.row != nullptr ? launch<TWO, true, true, ROPE, false>(t64, t16, a, nc, N, st)
                            : launch<TWO, false, true, ROPE, false>(t64, t16, a, nc, N, st);
  return a.row != nullptr ? launch<TWO, true, false, ROPE, false>(t64, t16, a, nc, N, st)
                          : launch<TWO, false, false, ROPE, false>(t64, t16, a, nc, N, st);
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
      (abnar != nullptr && (lse != nullptr || row != nullptr || carry != nullptr)) ||
      size_t(N) * num_heads * S > size_t(INT32_MAX))
    return cudaErrorInvalidValue;
  CUtensorMap t64, t16;
  cudaError_t err = tma_map_3d(&t64, qkv, N, S, 3 * size_t(E), CHUNK);
  if (err == cudaSuccess) err = tma_map_3d(&t16, qkv, N, S, 3 * size_t(E), TAIL);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<bf16*>(out),         static_cast<float*>(lse),
               static_cast<float*>(row),        static_cast<const float*>(carry),
               static_cast<float*>(carry_part), static_cast<float*>(abnar),
               static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin),
               S, E, num_heads, scale};
  float* nc = static_cast<float*>(new_carry);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = S > ONE_PASS_MAX;
  if (rope_cos != nullptr)
    return two ? dispatch<true, true>(t64, t16, a, nc, N, st)
               : dispatch<false, true>(t64, t16, a, nc, N, st);
  return two ? dispatch<true, false>(t64, t16, a, nc, N, st)
             : dispatch<false, false>(t64, t16, a, nc, N, st);
}

// The launch geometry of mst_mhsa at sequence length S (1 <= S <= 512):
// geo = {query tile rows, query tiles, tiles a block walks, threads,
// passes, 64-key chunks, tail chunks of 16, f32 score registers a thread
// keeps, dynamic shared memory bytes, those of the Abnar kernel}, as the
// launches set them (`fused_block.mhsa_launch` mirrors it).
extern "C" int mst_mhsa_geometry(int S, int* geo) {
  using namespace mst;
  if (S <= 0 || S > MAX_S) return cudaErrorInvalidValue;
  const Plan p = plan(S);
  const bool two = S > ONE_PASS_MAX;
  const int g[10] = {TILE, tiles(S), tiles_per_block(S, MOST_TILES), THREADS, two ? 2 : 1,
                     p.n64, p.tail,
                     two ? CHUNK / 2 : p.n64 * (CHUNK / 2) + p.tail * (TAIL / 2),
                     static_cast<int>(layout(S).total), static_cast<int>(layout(S, true).total)};
  for (int i = 0; i < 10; ++i) geo[i] = g[i];
  return cudaSuccess;
}
