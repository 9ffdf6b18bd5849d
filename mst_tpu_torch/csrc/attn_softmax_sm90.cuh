// The softmax of a 64-query tile in registers, with the exponential forms
// of the `tools/` attention cores (attn_variants.cu, attn_i8.cu) as a
// compile-time hook, on the pieces of attn_sm90.cuh.
//
// The body is mhsa.cu's forward (its `scale_mask`, `exp_rows`, `online`,
// `probs`, `pv` and `pv_sync`, in its order): a warpgroup holds the f32
// scores of its 64 rows in the m64nNk16 D fragment, two rows a thread
// (`qa` = 16 warp + lane / 4 and `qb` = qa + 8), a row's columns spread
// over the 4 lanes of a quad; the row max and sum are taken over the quad.
// The form EXP_2 is mhsa's exactly (ex2.approx.ftz on s - m, the row sums
// as trees), so a core that runs it in mhsa's order gives mhsa's bits.
// mhsa.cu keeps its own copy: it is on every user path, and its code stays
// as it is.
//
// The forms (the exponential of d = s - m, and what l sums):
// - EXP_E: e^d by `__expf` (ex2.approx.ftz of d log2(e): the exponential
//   a kernel takes, one multiply more than EXP_2; relative error ~1e-6 at
//   these d, far inside P's bf16 rounding) (variants A and B of
//   tools/bench_attn_softmax.py);
// - EXP_2: 2^d by ex2.approx.ftz (C, D; attn_i8's B);
// - EXP_2_BF16: 2^bf16(d) in bf16, two keys a `h2exp2` (ex2.approx.ftz.
//   bf16x2), l the sum of the f32 of the bf16 p (E);
// - EXP_2_CODES: 2^(d + log2(127)) in [0, 127], each op rounded on its own
//   (`__fmul_rn` for the scale, `__fsub_rn`, `__fadd_rn`) as the plain
//   version's separate tensor ops, so that rint(p) gives its codes except
//   where p lies at a .5 tie (attn_i8's C). By ex2.approx.ftz: exp2f (and
//   torch.exp2 on the card) is ex2.approx.f32, which differs from it only
//   below 2^-126, where the code is 0 either way and l >= 127 absorbs the
//   term; its subnormal handling cost the one-pass body its registers.
#pragma once

#include "attn_sm90.cuh"

namespace mst {
namespace attn {

using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int ONE_PASS_MAX = 4 * CHUNK + TAIL;  // 272: a row's scores fit the registers
constexpr int MOST_TILES = 5;                   // query tiles a block walks, at most
constexpr float LOG2_127 = 6.988684686772166f;

enum Exp : int { EXP_E = 0, EXP_2 = 1, EXP_2_BF16 = 2, EXP_2_CODES = 3 };

// This thread's place in its block's current unit (64-query tile, head,
// slice): rows qa, qb of the slice.
struct Rows {
  int t, warp, lane, q0, qa, qb;
};

__host__ __device__ inline Rows rows_of(int t, int q0) {
  Rows c;
  c.t = t;
  c.warp = t >> 5;
  c.lane = t & 31;
  c.q0 = q0;
  c.qa = q0 + 16 * c.warp + (c.lane >> 2);
  c.qb = c.qa + 8;
  return c;
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Scale a chunk's scores in place, with MASK the keys past S to -inf (a
// chunk that ends at or before S needs none); fold their row maxima into
// m0 / m1 (this thread's share of rows qa / qb).
template <int F, bool MASK = true, int R>
__device__ __forceinline__ void scale_mask(float (&s)[R], int key0, int t, int S, float scale,
                                           float& m0, float& m1) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool in = !MASK || key0 + frag_col(t, i) < S;
    const float x = F == EXP_2_CODES ? __fmul_rn(s[i], scale) : s[i] * scale;
    s[i] = in ? x : -INFINITY;
    if (frag_hi(i))
      m1 = fmaxf(m1, s[i]);
    else
      m0 = fmaxf(m0, s[i]);
  }
}

// The exponential of d = s - m in form F (not EXP_2_BF16, which takes pairs).
template <int F>
__device__ __forceinline__ float exp_of(float s, float m) {
  if constexpr (F == EXP_E) return __expf(s - m);
  if constexpr (F == EXP_2) return ex2(s - m);
  return ex2(__fadd_rn(__fsub_rn(s, m), LOG2_127));
}

// p = exp(s - m) in place in form F; adds this thread's share of the
// chunk's two row sums to l0 / l1, each summed as a tree (the column pairs,
// then their halves), as mhsa.cu does.
template <int F, int R>
__device__ __forceinline__ void exp_rows(float (&s)[R], float m0, float m1, float& l0,
                                         float& l1) {
  float a[R / 4], b[R / 4];  // rows lo, hi: the pair of columns of each group
#pragma unroll
  for (int k = 0; k < R / 4; ++k) {
    if constexpr (F == EXP_2_BF16) {
      const __nv_bfloat162 p0 =
          h2exp2(__floats2bfloat162_rn(s[4 * k] - m0, s[4 * k + 1] - m0));
      const __nv_bfloat162 p1 =
          h2exp2(__floats2bfloat162_rn(s[4 * k + 2] - m1, s[4 * k + 3] - m1));
      s[4 * k] = __low2float(p0);
      s[4 * k + 1] = __high2float(p0);
      s[4 * k + 2] = __low2float(p1);
      s[4 * k + 3] = __high2float(p1);
    } else {
      s[4 * k] = exp_of<F>(s[4 * k], m0);
      s[4 * k + 1] = exp_of<F>(s[4 * k + 1], m0);
      s[4 * k + 2] = exp_of<F>(s[4 * k + 2], m1);
      s[4 * k + 3] = exp_of<F>(s[4 * k + 3], m1);
    }
    a[k] = s[4 * k] + s[4 * k + 1];
    b[k] = s[4 * k + 2] + s[4 * k + 3];
  }
  l0 += tree_sum(a);
  l1 += tree_sum(b);
}

// Pass 1 of the two-pass body on a chunk: fold its row maxima into m0 / m1
// (over the quad); with SUM_L also rescale this thread's share of l to the
// new max and add the chunk's (mhsa's order; the forms that divide o by l
// at the end may leave l to pass 2 instead).
template <int F, bool SUM_L, int R>
__device__ __forceinline__ void online(float (&s)[R], int key0, const Rows& c, int S, float scale,
                                       float& m0, float& m1, float& l0, float& l1) {
  float x0 = -INFINITY, x1 = -INFINITY;
  scale_mask<F>(s, key0, c.t, S, scale, x0, x1);
  x0 = fmaxf(m0, quad_max(x0));
  x1 = fmaxf(m1, quad_max(x1));
  if constexpr (SUM_L) {
    if constexpr (F == EXP_E) {
      l0 *= __expf(m0 - x0);
      l1 *= __expf(m1 - x1);
    } else {
      l0 *= ex2(m0 - x0);
      l1 *= ex2(m1 - x1);
    }
    exp_rows<F>(s, x0, x1, l0, l1);
  }
  m0 = x0;
  m1 = x1;
}

// Pass 2: p = exp(s - m) of a chunk against the final max; with SUM_L its
// share of l is added to l0 / l1.
template <int F, bool SUM_L, int R>
__device__ __forceinline__ void probs(float (&s)[R], int key0, const Rows& c, int S, float scale,
                                      float m0, float m1, float& l0, float& l1) {
  float x0 = -INFINITY, x1 = -INFINITY, y0 = 0.0f, y1 = 0.0f;
  scale_mask<F>(s, key0, c.t, S, scale, x0, x1);
  exp_rows<F>(s, m0, m1, SUM_L ? l0 : y0, SUM_L ? l1 : y1);
}

// p / l in place (the forms that round P = bf16(p / l)): q = p * (1 / l)
// and one correction q + (p - q l) / l, which rounds as p / l does but
// for rare ties, in 3 instructions where an IEEE division takes ~10 and a
// branch (136 a thread in the one-pass body).
template <int R>
__device__ __forceinline__ void normalize(float (&p)[R], float l0, float l1) {
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float l = frag_hi(i) ? l1 : l0, r = frag_hi(i) ? r1 : r0;
    const float q = __fmul_rn(p[i], r);
    p[i] = __fmaf_rn(__fmaf_rn(-q, l, p[i]), r, q);
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

}  // namespace attn
}  // namespace mst
