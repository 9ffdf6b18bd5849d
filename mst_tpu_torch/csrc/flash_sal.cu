// flash_sal: the saliency outputs of the composed attention above 512 tokens,
// from the q, k [B, H, S, 64] bf16 (element strides per slice, head and row;
// unit column stride) and the base-2 LSE rows [B, H, S] f32 that
// flash_fwd.cu wrote for the same attention (`want_lse`):
//   p[q, k] = exp2(s[q, k] - lse[q]),  s = q.k^T * (sm_scale * log2(e))
// in f32, the softmax rows of each head, rebuilt tile by tile; no [S, S]
// matrix of a head reaches device memory.
//
// Replaces no TPU kernel: above 512 tokens the JAX package serves saliency
// on its flax path (mst_tpu/train/predictor.py:108-135), whose attention
// (`attention_reference`, mst_tpu/models/layers.py:147-150) sows every
// block's per-head [N, H, S, S] f32 probabilities, which XLA then reduces
// (mst_tpu/ops/saliency.py `plane_attention` :44, `attention_cls_rollout`
// :89, `attention_rollout` :119). At 518 px and B = 8 (N = 256 slices, 6
// heads, S = 1370) one block's probabilities are 11.5 GB and the rollout
// modes sow twelve of them, more than the card holds. flash_fwd's single
// online-softmax pass cannot give normalised probabilities, so these two
// kernels rebuild them from its LSE, as the dk/dv kernel of flash_bwd.cu
// does:
//
// - mst_flash_carry: the rollout carry r' [B, H, S] f32, r'[k] = sum_q
//   r[q] p[q, k] per head (the reference `get_attention_cls` chain's CLS
//   row moved one block on; with the same r for every head, one step of
//   the Abnar rollout's row, `ops/attention.abnar_rollout_row`). A unit is
//   a key tile of 128 keys of one (slice, head), the shape of flash_bwd.cu's
//   dk/dv kernel: each consumer warpgroup owns 64 of its keys, their K box
//   loaded once by TMA; the queries stream through a ring of SAL_STAGES
//   64-row Q boxes that both consumers share, so Q leaves L2 once per 128
//   keys. The producer warpgroup's warp 0 issues the TMA loads; its warps
//   1-3 in turn copy a stage's LSE values and carry weights (0 past S)
//   beside it by cp.async, the copies completing on the stage's full
//   barrier. Per stage s^T = k.q^T by wgmma from shared memory (m64n64k16 x
//   4, both operands K-major) into 32 f32 registers a thread, issued one
//   stage ahead of the reduction, so the tensor cores run stage j + 1 while
//   the exp2 unit runs stage j; then p^T = exp2(s^T - lse) and each
//   thread's two keys' sums weighted by r in query order, then the 4 lanes
//   of a row: a fixed order with no float atomics, so two runs give the
//   same bits. The ROW form (template flag) is the CLS row of the last
//   block: the first stage alone, and only the column of query 0 goes
//   through the exp2 unit.
// - mst_flash_abnar: the row normaliser [B, S] f32 of the block's Abnar &
//   Zuidema factor rownorm(mean_h p_h + I): rs[q] = 1 + (1 / H) sum_h
//   sum_k p_h[q, k], the row sums in f32, then the head sum in head order,
//   times 1 / H, plus 1. Only the CLS row of the factors' product is ever
//   read, so the rollout moves that row back through the blocks
//   (`abnar_rollout_row`: w = v / rs, v' = mean_h carry_h(w) + w, one
//   mst_flash_carry a block) and no factor is written. A unit is a query
//   tile of 128 rows of one slice, 64 a consumer; it walks the heads in
//   order, its Q boxes of head h in a double-buffered unit buffer and the K
//   rows of head h through the ring, 128 a stage, s = q.k^T by wgmma
//   (m64n128k16 x 4) as above, keys past S (read as zeros) masked in the
//   last stage.
//
// Both kernels are persistent (one block an SM walks the units, the
// producer running ahead into the next unit, so one unit's reduction
// overlaps the next one's loads), 384 threads with `setmaxnreg`, the
// blocks of flash_sm90.cuh; rows past S of a (slice, head) read as zeros
// (the TMA map's row extent is S).
//
// Bound on the H100 at [256, 6, 1370, 64] (518 px, B = 8): the carry's
// scores are 2 S^2 hd B H = 369 GFLOP (0.37 ms at 989 TFLOP/s) against
// 0.56 GB of q, k, LSE and carry (0.17 ms): bound by the products. The
// exp2 unit is the nearer floor: 2.88 G exp2 at 16 a clock on 132 SMs,
// about 0.8 ms at 1.6-1.7 GHz; each score costs one FMA, one exp2 and one
// FMA or add, so the design keeps that unit fed (scores a stage ahead, two
// consumers). Measured on the card: 128-row stages beat 64-row ones in the
// row normaliser (the carry's 64 scores a thread a stage at 128 rows spill
// under `setmaxnreg`), and a 2^x polynomial on the FMA pipes for a quarter
// of the scores made both kernels slower. The CLS row reads K once, 0.27
// GB (0.08 ms): bound by bytes. The row normaliser runs the same 369 GFLOP
// and exp2 over 0.55 GB read and 1.4 MB written: the same bounds as the
// carry.
#include "flash_sm90.cuh"

namespace mst {
namespace {

using namespace flash;
using attn::frag_col;
using attn::frag_hi;
using attn::quad_sum;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int CARRY_N = 64;    // rows of a carry ring stage (queries): one TMA box
constexpr int ABNAR_N = 128;   // rows of a row-normaliser ring stage (keys): two boxes
constexpr int SAL_STAGES = 8;  // ring depth
constexpr int SAL_BARS = 4 + 2 * SAL_STAGES;  // unit full / empty [2] each, ring full / empty
__host__ __device__ inline int sal_stages(int S, int n) { return (S + n - 1) / n; }

// 4-byte global -> shared copy; src_bytes = 0 writes a zero without a read.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm90::smem_u32(smem_dst)),
               "l"(gmem_src), "r"(src_bytes)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async copies are done
// (`.noinc`: the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(sm90::smem_u32(bar))
               : "memory");
}

// Where a carry stage keeps the LSE of its query q (0 .. CARRY_N - 1); the
// weight lies 2 floats on. The pair of queries q, q + 1 (q even) of a
// D-fragment column pair is one float4 {lse q, lse q + 1, w q, w q + 1}, so
// a thread reads its 16 queries' values in 8 vector loads.
__host__ __device__ constexpr int vec_at(int q) { return 2 * q - (q & 1); }

// Shared memory past the aligned base: two unit buffers of two boxes (one
// a consumer), the ring of SAL_STAGES stages of CARRY_N or ABNAR_N rows,
// with the carry's f32 LSE and weight rows (2 CARRY_N a stage, `vec_at`),
// then the barriers.
struct SalLayout {
  size_t unit, ring, vec, bar, total;
};

__host__ __device__ inline SalLayout sal_layout(bool carry) {
  SalLayout L;
  L.unit = 0;
  L.ring = L.unit + 2 * 2 * size_t(BOX_BYTES);
  L.vec = L.ring + size_t(SAL_STAGES) * (carry ? CARRY_N : ABNAR_N) * HD * 2;
  L.bar = L.vec + (carry ? size_t(SAL_STAGES) * 2 * CARRY_N * sizeof(float) : 0);
  L.total = ALIGN + L.bar + SAL_BARS * sizeof(uint64_t);
  return L;
}

// Thread 0 initialises the barriers (the ring's full barrier counts
// `full_arrivals`); every thread then syncs.
__device__ __forceinline__ Bars sal_carve(unsigned char* base, const SalLayout& L,
                                          int full_arrivals) {
  uint64_t* b = reinterpret_cast<uint64_t*>(base + L.bar);
  const Bars bars{b, b + 2, b + 4, b + 4 + SAL_STAGES};
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars.ufull[i], 1);
      mbar_init(&bars.uempty[i], CONSUMERS * 4);  // one arrive per consumer warp
    }
    for (int i = 0; i < SAL_STAGES; ++i) {
      mbar_init(&bars.full[i], full_arrivals);
      mbar_init(&bars.empty[i], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bars;
}

// d = own . stage^T over the head dim, 64 rows by 64 or 128, both K-major:
// m64n64k16 (attn_sm90.cuh) or m64n128k16, which always accumulates.
__device__ __forceinline__ void scores(float (&d)[32], const unsigned char* own,
                                       const unsigned char* stage) {
  wgmma_fence();
  attn::product_t(d, own, stage);
}
__device__ __forceinline__ void scores(float (&d)[64], const unsigned char* own,
                                       const unsigned char* stage) {
  attn::zero(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    sm90::wgmma_m64n128k16<0, 0>(d, attn::desc_k(own, kk), attn::desc_k(stage, kk));
}

// The scores of n ring stages (it, it + 1, ...) against this warpgroup's
// own box: d = own . ring^T over the head dim (both K-major) by wgmma into
// one of two register sets, stage j + 1's product issued before stage j's
// `reduce(s, j)` (which only reads s), each stage released once reduced.
// The steady loop issues unconditionally and has nothing in flight across
// its back edge, and the tail is peeled: ptxas then keeps the products
// asynchronous (it serializes them where it cannot tell which register set
// a product in flight writes).
template <int N, class Reduce>
__device__ __forceinline__ void stream_scores(const unsigned char* own, const Bars& bars,
                                              const unsigned char* ring, uint32_t it, int n,
                                              Reduce&& reduce) {
  float s0[N / 2], s1[N / 2];
  auto issue = [&](float (&s)[N / 2], int j) {
    wait_full(bars.full, it + j, SAL_STAGES);
    scores(s, own, ring + ((it + j) % SAL_STAGES) * (N * HD * 2));
    wgmma_commit();
  };
  auto done = [&](const float (&s)[N / 2], int j) {
    reduce(s, j);
    release(bars.empty, it + j, SAL_STAGES);
  };
  issue(s0, 0);
  wgmma_wait<0>();
  attn::fence_regs(s0);
  int j = 0;
  for (; j + 2 < n; j += 2) {  // s0 holds stage j; stages j + 1, j + 2 exist
    issue(s1, j + 1);
    done(s0, j);
    wgmma_wait<0>();
    attn::fence_regs(s1);
    issue(s0, j + 2);
    done(s1, j + 1);
    wgmma_wait<0>();
    attn::fence_regs(s0);
  }
  if (j + 1 < n) {  // the last two stages
    issue(s1, j + 1);
    done(s0, j);
    wgmma_wait<0>();
    attn::fence_regs(s1);
    done(s1, j + 1);
  } else {
    done(s0, j);
  }
}

struct CarryArgs {
  const float* lse;    // [B, H, S]
  const float* carry;  // [B, H, S]; unused by the ROW form
  float* out;          // [B, H, S]
  int B, H, S;
  float scale;  // sm_scale * log2(e), > 0
};

// Unit buffer: [k0, k1] (consumer c owns the keys of box c). Ring stage:
// CARRY_N queries (one box), and their f32 LSE and weights in the ring's
// vectors. Thread t of a consumer holds keys lo and lo + 8 of its box (the
// rows of the D fragment), queries frag_col(t, i) of each stage.
template <bool ROW>
__global__ void __launch_bounds__(THREADS, 1)
flash_sal_carry_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk, const CarryArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned(smem_raw);
  const SalLayout L = sal_layout(true);
  // the ring's full barrier: expect_tx and the copies of a vector warp's lanes
  const Bars bars = sal_carve(base, L, 1 + 32);
  float* vec = reinterpret_cast<float*>(base + L.vec);
  const int T = tiles(a.S), nq = ROW ? 1 : sal_stages(a.S, CARRY_N), units = T * a.H * a.B;
  const int role = threadIdx.x / 128;

  if (role == 0) {
    reg_dealloc<PRODUCER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 && lane != 0) return;
    if (warp == 0) {  // thread 0: the TMA loads
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tk);
      uint32_t it = 0, ui = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
        const Unit w = unit(u, T, a.H);
        wait_free(bars.uempty, ui, 2);
        unsigned char* ub = base + L.unit + (ui & 1) * 2 * BOX_BYTES;
        uint64_t* bar = &bars.ufull[ui & 1];
        mbar_expect_tx(bar, 2 * BOX_BYTES);
        for (int c = 0; c < CONSUMERS; ++c)
          tma_load_4d(ub + c * BOX_BYTES, &tk, w.tile * ROWS + c * BOX, w.h, w.b, bar);
        for (int j = 0; j < nq; ++j, ++it) {
          const int st = it % SAL_STAGES;
          wait_free(bars.empty, it, SAL_STAGES);
          mbar_expect_tx(&bars.full[st], BOX_BYTES);
          tma_load_4d(base + L.ring + st * BOX_BYTES, &tq, j * CARRY_N, w.h, w.b,
                      &bars.full[st]);
        }
      }
      return;
    }
    // warps 1-3: every third stage's LSE and carry weights, copied from
    // device memory by cp.async, each lane's copies completing on the
    // stage's full barrier (no registers hold them, and the warp goes on
    // to its next stage at once). A query past S reads as 0 in both (its
    // q row is zeros, so p = 2^0 = 1 and weight 0: it adds 0); the ROW form
    // reads only the LSE of query 0, so it copies no weights.
    const uint32_t total = uint32_t((units - blockIdx.x + gridDim.x - 1) / gridDim.x) * nq;
    for (uint32_t g = warp - 1; g < total; g += 3) {
      const Unit w = unit(blockIdx.x + int(g / nq) * gridDim.x, T, a.H);
      const float* lse = a.lse + w.bh * a.S;
      const float* carry = ROW ? nullptr : a.carry + w.bh * a.S;
      const int st = g % SAL_STAGES;
      wait_free(bars.empty, g, SAL_STAGES);
      float* v = vec + st * 2 * CARRY_N;
#pragma unroll
      for (int e = 0; e < CARRY_N / 32; ++e) {
        const int q = int(g % nq) * CARRY_N + 32 * e + lane;
        const bool in = q < a.S;
        cp_async4(v + vec_at(32 * e + lane), lse + (in ? q : 0), in ? 4 : 0);
        if (!ROW) cp_async4(v + vec_at(32 * e + lane) + 2, carry + (in ? q : 0), in ? 4 : 0);
      }
      cp_async_arrive(&bars.full[st]);
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int c = role - 1, t = threadIdx.x & 127;
  const int lo = 16 * (t >> 5) + ((t & 31) >> 2);
  const unsigned char* ring = base + L.ring;
  uint32_t it = 0, ui = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
    const Unit w = unit(u, T, a.H);
    const unsigned char* kbox = base + L.unit + ((ui & 1) * 2 + c) * BOX_BYTES;
    float acc0 = 0.0f, acc1 = 0.0f;  // keys lo and lo + 8
    wait_full(bars.ufull, ui, 2);
    auto reduce = [&](const float (&s)[CARRY_N / 2], int j) {
      const float* v = vec + ((it + j) % SAL_STAGES) * 2 * CARRY_N;
      if constexpr (ROW) {  // query 0 is column 0: i = 0 (key lo), 2 (lo + 8) of lane t % 4 = 0
        if ((t & 3) == 0) {
          acc0 = attn::ex2(fmaf(s[0], a.scale, -v[0]));
          acc1 = attn::ex2(fmaf(s[2], a.scale, -v[0]));
        }
      } else {
        // column pair g: queries 8 g + 2 (t % 4) + {0, 1}, scores 4 g + {0, 1}
        // (key lo) and 4 g + {2, 3} (key lo + 8)
#pragma unroll
        for (int g = 0; g < CARRY_N / 8; ++g) {
          const float4 lw = *reinterpret_cast<const float4*>(v + vec_at(frag_col(t, 4 * g)));
          acc0 = fmaf(lw.z, attn::ex2(fmaf(s[4 * g], a.scale, -lw.x)), acc0);
          acc0 = fmaf(lw.w, attn::ex2(fmaf(s[4 * g + 1], a.scale, -lw.y)), acc0);
          acc1 = fmaf(lw.z, attn::ex2(fmaf(s[4 * g + 2], a.scale, -lw.x)), acc1);
          acc1 = fmaf(lw.w, attn::ex2(fmaf(s[4 * g + 3], a.scale, -lw.y)), acc1);
        }
      }
    };
    stream_scores<CARRY_N>(kbox, bars, ring, it, nq, reduce);
    it += nq;
    acc0 = quad_sum(acc0);
    acc1 = quad_sum(acc1);
    if ((t & 3) == 0) {
      const int key = w.tile * ROWS + c * BOX + lo;
      float* out = a.out + w.bh * a.S;
      if (key < a.S) out[key] = acc0;
      if (key + 8 < a.S) out[key + 8] = acc1;
    }
    done_with_unit(bars, c, ui);
  }
}

struct AbnarArgs {
  const float* lse;  // [B, H, S]
  float* out;        // [B, S]
  int B, H, S;
  float scale;  // sm_scale * log2(e), > 0
  float inv_h;  // 1 / H in f32
};

// Unit u: query tile u % T of slice u / T, its heads in order. Unit buffer
// (one per head of the unit): [q0, q1] (consumer c owns the rows of box c).
// Ring stage: ABNAR_N keys of the current head (two boxes). Thread t of a consumer holds
// rows lo and lo + 8 of its box, keys frag_col(t, i) of each stage.
__global__ void __launch_bounds__(THREADS, 1)
flash_sal_abnar_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk, const AbnarArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned(smem_raw);
  const SalLayout L = sal_layout(false);
  const Bars bars = sal_carve(base, L, 1);
  const int T = tiles(a.S), nk = sal_stages(a.S, ABNAR_N), units = T * a.B;
  const int role = threadIdx.x / 128;

  if (role == 0) {  // the producer: per head, its Q boxes, then its K boxes
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    uint32_t it = 0, ui = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tile = u % T, b = u / T;
      for (int h = 0; h < a.H; ++h, ++ui) {
        wait_free(bars.uempty, ui, 2);
        unsigned char* ub = base + L.unit + (ui & 1) * 2 * BOX_BYTES;
        uint64_t* bar = &bars.ufull[ui & 1];
        mbar_expect_tx(bar, 2 * BOX_BYTES);
        for (int c = 0; c < CONSUMERS; ++c)
          tma_load_4d(ub + c * BOX_BYTES, &tq, tile * ROWS + c * BOX, h, b, bar);
        for (int j = 0; j < nk; ++j, ++it) {
          const int st = it % SAL_STAGES;
          wait_free(bars.empty, it, SAL_STAGES);
          mbar_expect_tx(&bars.full[st], ABNAR_N * HD * 2);
          for (int x = 0; x < ABNAR_N / BOX; ++x)
            tma_load_4d(base + L.ring + st * (ABNAR_N * HD * 2) + x * BOX_BYTES, &tk,
                        j * ABNAR_N + x * BOX, h, b, &bars.full[st]);
        }
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int c = role - 1, t = threadIdx.x & 127;
  const int lo = 16 * (t >> 5) + ((t & 31) >> 2);
  const unsigned char* ring = base + L.ring;
  uint32_t it = 0, ui = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u % T, b = u / T;
    const int ra = tile * ROWS + c * BOX + lo, rb = ra + 8;
    float hs0 = 0.0f, hs1 = 0.0f;  // rows ra, rb: the head sum of their row sums
    for (int h = 0; h < a.H; ++h, ++ui) {
      const unsigned char* qbox = base + L.unit + ((ui & 1) * 2 + c) * BOX_BYTES;
      const float* lse = a.lse + (size_t(b) * a.H + h) * a.S;
      const float l0 = ra < a.S ? lse[ra] : 0.0f, l1 = rb < a.S ? lse[rb] : 0.0f;
      float p0 = 0.0f, p1 = 0.0f;  // this thread's share of the rows' sums
      wait_full(bars.ufull, ui, 2);
      auto reduce = [&](const float (&s)[ABNAR_N / 2], int j) {
        if (j * ABNAR_N + ABNAR_N <= a.S) {
#pragma unroll
          for (int i = 0; i < ABNAR_N / 2; ++i) {
            const float p = attn::ex2(fmaf(s[i], a.scale, -(frag_hi(i) ? l1 : l0)));
            if (frag_hi(i))
              p1 += p;
            else
              p0 += p;
          }
        } else {  // the last stage: keys past S (zero-filled) get p = 0
          const int keys = a.S - j * ABNAR_N;
#pragma unroll
          for (int i = 0; i < ABNAR_N / 2; ++i) {
            const float p = frag_col(t, i) < keys
                                ? attn::ex2(fmaf(s[i], a.scale, -(frag_hi(i) ? l1 : l0)))
                                : 0.0f;
            if (frag_hi(i))
              p1 += p;
            else
              p0 += p;
          }
        }
      };
      stream_scores<ABNAR_N>(qbox, bars, ring, it, nk, reduce);
      it += nk;
      hs0 += quad_sum(p0);
      hs1 += quad_sum(p1);
      done_with_unit(bars, c, ui);
    }
    if ((t & 3) == 0) {
      float* out = a.out + size_t(b) * a.S;
      if (ra < a.S) out[ra] = __fadd_rn(__fmul_rn(hs0, a.inv_h), 1.0f);
      if (rb < a.S) out[rb] = __fadd_rn(__fmul_rn(hs1, a.inv_h), 1.0f);
    }
  }
}

bool sal_maps(CUtensorMap* m, const void* q, const void* k, const long long* strides, int B,
              int H, int S, cudaError_t* err) {
  *err = tma_map_4d(&m[0], q, strides, B, H, S);
  if (*err == cudaSuccess) *err = tma_map_4d(&m[1], k, strides + 3, B, H, S);
  return *err == cudaSuccess;
}

}  // namespace
}  // namespace mst

// q, k: [B, H, S, 64] bf16 with element strides strides[3 i .. 3 i + 2]
// (slice, head, row; host memory) of q then k, multiples of 8, 16-byte
// aligned; lse, carry, out: [B, H, S] f32 contiguous (carry unused, may be
// NULL, with `row` set); scale = sm_scale * log2(e) > 0. row != 0: the
// CLS row p[0] of each head; else the carry sum_q carry[q] p[q, k].
extern "C" int mst_flash_carry(const void* q, const void* k, const void* lse, const void* carry,
                               void* out, const long long* strides, int B, int H, int S,
                               float scale, int row, void* stream) {
  using namespace mst;
  using namespace mst::flash;
  if (!shape_ok(strides, 6, B, H, S) || !(scale > 0.0f) || (!row && carry == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap m[2];
  cudaError_t err;
  if (!sal_maps(m, q, k, strides, B, H, S, &err)) return err;
  const size_t smem = sal_layout(true).total;
  const CarryArgs a{static_cast<const float*>(lse), static_cast<const float*>(carry),
                    static_cast<float*>(out), B, H, S, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int grid = 0;
  if (row) {
    err = prepare(flash_sal_carry_kernel<true>, smem, tiles(S) * H * B, &grid);
    if (err != cudaSuccess) return err;
    flash_sal_carry_kernel<true><<<grid, THREADS, smem, st>>>(m[0], m[1], a);
  } else {
    err = prepare(flash_sal_carry_kernel<false>, smem, tiles(S) * H * B, &grid);
    if (err != cudaSuccess) return err;
    flash_sal_carry_kernel<false><<<grid, THREADS, smem, st>>>(m[0], m[1], a);
  }
  return cudaGetLastError();
}

// q, k, lse as mst_flash_carry; out: [B, S] f32 contiguous, the row
// normaliser 1 + (1 / H) sum_h sum_k p_h[q, k] of each slice's Abnar factor.
extern "C" int mst_flash_abnar(const void* q, const void* k, const void* lse, void* out,
                               const long long* strides, int B, int H, int S, float scale,
                               void* stream) {
  using namespace mst;
  using namespace mst::flash;
  if (!shape_ok(strides, 6, B, H, S) || !(scale > 0.0f)) return cudaErrorInvalidValue;
  CUtensorMap m[2];
  cudaError_t err;
  if (!sal_maps(m, q, k, strides, B, H, S, &err)) return err;
  const size_t smem = sal_layout(false).total;
  int grid = 0;
  err = prepare(flash_sal_abnar_kernel, smem, tiles(S) * B, &grid);
  if (err != cudaSuccess) return err;
  const AbnarArgs a{static_cast<const float*>(lse), static_cast<float*>(out), B, H, S, scale,
                    1.0f / float(H)};
  flash_sal_abnar_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(m[0], m[1],
                                                                                   a);
  return cudaGetLastError();
}

// The launch geometry of mst_flash_carry's ROW form (part 0), its carry
// form (1) and mst_flash_abnar (2) on this device: geo = {rows of a unit,
// rows of a box, tiles, units, grid, threads, ring stages, dynamic shared
// memory bytes, ring stages a unit streams} (`ops/attention.flash_sal_launch`
// mirrors it).
extern "C" int mst_flash_sal_geometry(int B, int H, int S, int part, int* geo) {
  using namespace mst;
  using namespace mst::flash;
  if (part < 0 || part > 2 || B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  const long long units = (long long)tiles(S) * (part == 2 ? 1 : H) * B;
  if (units > INT32_MAX) return cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = sm90::persistent_grid(int(units), &grid);
  if (err != cudaSuccess) return err;
  const int g[9] = {ROWS, BOX, tiles(S), int(units), grid, THREADS, SAL_STAGES,
                    int(sal_layout(part != 2).total),
                    part == 0 ? 1
                    : part == 1 ? sal_stages(S, CARRY_N)
                                : H * sal_stages(S, ABNAR_N)};
  for (int i = 0; i < 9; ++i) geo[i] = g[i];
  return cudaSuccess;
}
