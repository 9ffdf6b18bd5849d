// flash_fwd: softmax attention over q, k, v [B, H, S, 64] bf16 (element
// strides per slice, head and row; unit column stride) -> o [B, H, S, 64]
// bf16, and with `lse` set (training) the base-2 log-sum-exp rows [B, H, S]
// f32 that flash_bwd.cu rebuilds p from.
//
// Replaces both forwards of mst_tpu/ops/attention.py: `_fwd_single_kernel`
// :152 (the whole sequence in VMEM, S <= SINGLE_BLOCK_MAX_KV = 1536) and
// `_fwd_kernel` :96 (the blocked online softmax above it), both launched
// from `_flash_fwd` :204. Same math and rounding points:
//   s = q.k^T * (sm_scale * log2(e)) in f32, keys j >= S set to -inf;
//   m_new = max(m_prev, rowmax(s)), alpha = exp2(m_prev - m_new);
//   p = exp2(s - m_new) in f32, l = alpha * l + rowsum(p) of the f32 p;
//   acc = alpha * acc + bf16(p) . v with f32 sums;
//   o = acc * (1 / l), rounded to bf16; lse = m + log2(l).
// The JAX LSE is natural-log (the base-2 one / log2(e)); this one stays in
// base 2, which only the port's backward reads. The split at 1536 exists
// because a TPU program keeps its blocks in VMEM; here one kernel covers
// every S.
//
// Bound on the H100: at [256, 6, 1370, 64] (serving, B = 8 x 32 slices)
// the two products are 4 S^2 hd B H = 738 GFLOP, 0.75 ms at 989 TFLOP/s,
// against 1.08 GB of q, k, v and o (0.32 ms at 3.35 TB/s): bound by the
// tensor cores, and as near by the exp2 unit (a 64 x 64 tile's 4,096 exp2
// take the SM's 16-a-cycle unit as long as its two products take the
// tensor cores). So the tensor cores must be fed while the other
// warpgroup's softmax runs (flash_sm90.cuh): one block an SM, a producer
// warpgroup (40 registers) keeping K and V boxes in flight through an
// 8-stage ring by TMA, two consumer warpgroups (232 registers) on 64 query
// rows each of a 128-row tile. Per 64-key stage j a consumer runs
//   s = q.k^T by wgmma from shared memory (Q and K K-major, m64n64k16 x 4)
//   into 32 f32 registers a thread; masks keys past S (last stage only);
//   the online softmax over the 4 lanes of a row (`ex2.approx.ftz`, the
//   scale folded into one FMA a score);
//   acc = alpha * acc + bf16(p) . v by register-A wgmma (P's bf16 pairs are
//   the A fragments in place, V MN-major).
// A consumer issues the scores of stage j and P.V of stage j - 1 in one
// turn, so the softmax of stage j runs while that P.V does; and the two
// consumers take turns (flash_sm90.cuh `turn_wait`), so one's softmax runs
// while the tensor cores work on the other's products. A stage is released
// once its P.V is done. Neither scores nor probabilities touch shared or
// device memory. o = acc / l leaves through the warpgroup's Q box as
// 16-byte row stores. Measured on the card, each consumer's serial chain
// (scores, softmax, P packed) bounds it at about SDPA's time: without the
// softmax the products run in 55% of it; neither the K / V traffic, the
// exp2 unit nor the ring depth limits it.
#include "flash_sm90.cuh"

namespace mst {
namespace {

using namespace flash;
using attn::desc_mn;
using attn::frag_a;
using attn::frag_col;
using attn::frag_hi;
using attn::quad_max;
using attn::quad_sum;
using attn::tree_sum;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

struct Args {
  bf16* o;
  long long osb, osh, oss;
  float* lse;
  int B, H, S;
  float scale;  // sm_scale * log2(e), > 0
};

// The online softmax of one stage's scores s (keys key0 ..) for this
// thread's rows lo / hi: s becomes p, the running max m (scaled units) and
// this thread's share of l move on, and al0 / al1 get the factor the
// accumulators must take before this stage's P.V.
__device__ __forceinline__ void online_softmax(float (&s)[32], int key0, int t, const Args& a,
                                               float& m0, float& m1, float& l0, float& l1,
                                               float& al0, float& al1) {
  if (key0 + BOX > a.S) {  // the last stage: keys past S (zero-filled) get p = 0
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (key0 + frag_col(t, i) >= a.S) s[i] = -INFINITY;
  }
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (frag_hi(i))
      x1 = fmaxf(x1, s[i]);
    else
      x0 = fmaxf(x0, s[i]);
  }
  // scale > 0, so the max of the scaled scores is the scaled max
  const float n0 = fmaxf(m0, quad_max(x0) * a.scale);
  const float n1 = fmaxf(m1, quad_max(x1) * a.scale);
  al0 = attn::ex2(m0 - n0);
  al1 = attn::ex2(m1 - n1);
  float r0[8], r1[8];  // the column pairs of rows lo and hi
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[4 * k] = attn::ex2(fmaf(s[4 * k], a.scale, -n0));
    s[4 * k + 1] = attn::ex2(fmaf(s[4 * k + 1], a.scale, -n0));
    s[4 * k + 2] = attn::ex2(fmaf(s[4 * k + 2], a.scale, -n1));
    s[4 * k + 3] = attn::ex2(fmaf(s[4 * k + 3], a.scale, -n1));
    r0[k] = s[4 * k] + s[4 * k + 1];
    r1[k] = s[4 * k + 2] + s[4 * k + 3];
  }
  l0 = al0 * l0 + tree_sum(r0);
  l1 = al1 * l1 + tree_sum(r1);
  m0 = n0;
  m1 = n1;
}

__device__ __forceinline__ void rescale(float (&acc)[32], float al0, float al1) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= frag_hi(i) ? al1 : al0;
}

// acc += bf16(p) . V (p: this thread's packed A fragments), one commit group.
__device__ __forceinline__ void pv(float (&acc)[32], const uint32_t (&p)[4][4],
                                   const unsigned char* vbox) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) attn::mma_rs(acc, p[kc], desc_mn(vbox, kc));
  wgmma_commit();
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned(smem_raw);
  const Layout L = layout(2, false);
  const Bars bars = carve(base, L, 1);
  const int T = tiles(a.S), nk = boxes(a.S), units = T * a.H * a.B;
  const int role = threadIdx.x / 128;

  if (role == 0) {  // the producer: Q of each unit, then its K and V boxes
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
    uint32_t it = 0, ui = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
      const Unit w = unit(u, T, a.H);
      wait_free(bars.uempty, ui, 2);
      unsigned char* q = base + L.unit + (ui & 1) * 2 * BOX_BYTES;
      mbar_expect_tx(&bars.ufull[ui & 1], 2 * BOX_BYTES);
      tma_load_4d(q, &tq, w.tile * ROWS, w.h, w.b, &bars.ufull[ui & 1]);
      tma_load_4d(q + BOX_BYTES, &tq, w.tile * ROWS + BOX, w.h, w.b, &bars.ufull[ui & 1]);
      for (int j = 0; j < nk; ++j, ++it) {
        const int st = it % STAGES;
        wait_free(bars.empty, it, STAGES);
        unsigned char* kv = base + L.ring + st * 2 * BOX_BYTES;
        mbar_expect_tx(&bars.full[st], 2 * BOX_BYTES);
        tma_load_4d(kv, &tk, j * BOX, w.h, w.b, &bars.full[st]);
        tma_load_4d(kv + BOX_BYTES, &tv, j * BOX, w.h, w.b, &bars.full[st]);
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int c = role - 1, t = threadIdx.x & 127;
  const int lo = 16 * (t >> 5) + ((t & 31) >> 2);  // this thread's rows lo, lo + 8
  auto stage = [&](uint32_t i) { return base + L.ring + (i % STAGES) * 2 * BOX_BYTES; };
  if (c == 1) turn_pass(c);  // consumer 0 takes the first turn
  uint32_t it = 0, ui = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
    const Unit w = unit(u, T, a.H);
    const int r0 = w.tile * ROWS + c * BOX;  // this warpgroup's first row
    unsigned char* qbox = base + L.unit + ((ui & 1) * 2 + c) * BOX_BYTES;
    float acc[32];
    attn::zero(acc);
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, al0, al1;
    uint32_t p[4][4];
    float s[32];
    wait_full(bars.ufull, ui, 2);
    // turn 0: the scores of stage 0
    wait_full(bars.full, it, STAGES);
    turn_wait(c);
    wgmma_fence();
    attn::product_t(s, qbox, stage(it));
    wgmma_commit();
    turn_pass(c);
    wgmma_wait<0>();
    attn::fence_regs(s);
    online_softmax(s, 0, t, a, m0, m1, l0, l1, al0, al1);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) frag_a(p[kc], s, kc);
    // turn j: the scores of stage j beside P.V of stage j - 1; the softmax
    // of stage j runs while that P.V does
    for (int j = 1; j < nk; ++j) {
      rescale(acc, al0, al1);
      wait_full(bars.full, it + j, STAGES);
      turn_wait(c);
      wgmma_fence();
      attn::product_t(s, qbox, stage(it + j));
      wgmma_commit();
      pv(acc, p, stage(it + j - 1) + BOX_BYTES);
      turn_pass(c);
      wgmma_wait<1>();
      attn::fence_regs(s);
      online_softmax(s, j * BOX, t, a, m0, m1, l0, l1, al0, al1);
      wgmma_wait<0>();
      attn::fence_regs(acc);
      release(bars.empty, it + j - 1, STAGES);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) frag_a(p[kc], s, kc);
    }
    // the last turn: P.V of the last stage
    rescale(acc, al0, al1);
    turn_wait(c);
    wgmma_fence();
    pv(acc, p, stage(it + nk - 1) + BOX_BYTES);
    if (c == 0 || u + int(gridDim.x) < units) turn_pass(c);
    wgmma_wait<0>();
    attn::fence_regs(acc);
    release(bars.empty, it + nk - 1, STAGES);
    it += nk;

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (a.lse != nullptr && (t & 3) == 0) {
      float* row = a.lse + w.bh * a.S;
      if (r0 + lo < a.S) row[r0 + lo] = m0 + log2f(fmaxf(l0, 1e-30f));
      if (r0 + lo + 8 < a.S) row[r0 + lo + 8] = m1 + log2f(fmaxf(l1, 1e-30f));
    }
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f, inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= frag_hi(i) ? inv1 : inv0;
    store_result(qbox, c, t, acc, a.o + w.b * a.osb + w.h * a.osh + r0 * a.oss, a.oss,
                 min(BOX, a.S - r0));
    done_with_unit(bars, c, ui);
  }
}

}  // namespace
}  // namespace mst

// q, k, v, o: [B, H, S, 64] bf16 with the element strides strides[3 i ..
// 3 i + 2] (slice, head, row) of tensor i in the order q, k, v, o (host
// memory), each a multiple of 8, the column stride 1, the pointers 16-byte
// aligned; lse: [B, H, S] f32 or NULL; scale = sm_scale * log2(e) > 0.
extern "C" int mst_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const long long* strides, int B, int H, int S, float scale,
                             void* stream) {
  using namespace mst;
  using namespace mst::flash;
  if (!shape_ok(strides, 12, B, H, S) || !(scale > 0.0f)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tma_map_4d(&tq, q, strides, B, H, S);
  if (err == cudaSuccess) err = tma_map_4d(&tk, k, strides + 3, B, H, S);
  if (err == cudaSuccess) err = tma_map_4d(&tv, v, strides + 6, B, H, S);
  if (err != cudaSuccess) return err;
  const size_t smem = layout(2, false).total;
  int grid = 0;
  err = prepare(flash_fwd_kernel, smem, tiles(S) * H * B, &grid);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<bf16*>(o), strides[9], strides[10], strides[11],
               static_cast<float*>(lse), B, H, S, scale};
  flash_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// The launch geometry of mst_flash_fwd (part 0), mst_flash_bwd_dq (1) and
// mst_flash_bwd_dkv (2) on this device: geo = {rows of a unit, rows of a
// box, tiles, boxes, units, grid, threads, stages, dynamic shared memory
// bytes} (`ops/attention.flash_launch` mirrors it).
extern "C" int mst_flash_geometry(int B, int H, int S, int part, int* geo) {
  using namespace mst::flash;
  if (part < 0 || part > 2) return cudaErrorInvalidValue;
  return geometry(B, H, S, part == 0 ? 2 : 4, part == 2, geo);
}
