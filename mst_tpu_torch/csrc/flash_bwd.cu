// flash_bwd: the backward of flash_fwd.cu, from the saved q, k, v [B, H, S,
// 64] bf16, o, the upstream gradient do and the base-2 LSE rows [B, H, S]
// f32 -> dq, dk, dv [B, H, S, 64] bf16 (every operand with its own element
// strides per slice, head and row; unit column stride).
//
// Replaces the backwards of mst_tpu/ops/attention.py: `_bwd_single_kernel`
// :305 (dq, dk, dv in one program, S <= 1536), `_bwd_dq_kernel` :340 and
// `_bwd_dkv_kernel` :372 (the blocked pair above 1536), all launched from
// `_flash_bwd` :412, with their math and rounding points:
//   p = exp2(s - lse), s = q.k^T * (sm_scale * log2(e)), keys >= S masked;
//   dv = bf16(bf16(p)^T . do);  dp = do . v^T;  delta = rowsum(do * o);
//   ds = bf16(p * (dp - delta) * sm_scale);  dq = bf16(ds . k);
//   dk = bf16(ds^T . q)
// with f32 sums. JAX computes delta in XLA (:412); here the dq kernel does,
// for its query rows, and writes it for the dk/dv kernel.
//
// The pair follows the blocked Pallas pair, which is deterministic: no
// float atomics, so two runs give the same bits, and one pair serves every
// S (the single-program kernel is a VMEM artifact). Both kernels have the
// shape of flash_fwd.cu (flash_sm90.cuh: one block an SM, a producer
// warpgroup feeding an 8-stage TMA ring, two consumer warpgroups of 64 rows
// of a 128-row unit, `setmaxnreg`):
//   dq kernel:    a unit is a query tile: its q and do boxes; the ring
//                 streams k and v. Per 64-key stage s = q.k^T and dp =
//                 do.v^T by wgmma from shared memory, p and ds in
//                 registers, dq += bf16(ds) . k by register-A wgmma (k read
//                 MN-major). delta = rowsum(do * o) of the unit's rows is
//                 summed from device memory (16 columns a lane, then the 4
//                 lanes of a row) while its boxes land.
//   dk/dv kernel: a unit is a key tile: its k and v boxes; the ring streams
//                 q and do, with the stage's 64 LSE and delta values stored
//                 into shared memory by the producer's warps 1-3 in turn (+1e30
//                 and 0 past S: a query past S has p = 0). Per stage s^T =
//                 k.q^T and dp^T = v.do^T, then dv += bf16(p^T) . do and dk
//                 += bf16(ds^T) . q, both from registers (q, do MN-major).
// As in flash_fwd.cu a consumer issues the two score-side products of stage
// j beside the register-A products of stage j - 1 in one turn, and the two
// consumers take turns, so p and ds of one stage are formed while the
// tensor cores run the other products.
// Each kernel forms s and dp, so the pair runs seven S^2 hd products where
// the function needs five (s, dp, dv, dq, dk); that buys no cross-block
// sum. Rows past S read as zeros (the TMA map's row extent is S): a key
// past S scores 0 and is masked in the dq kernel; a query past S has zero
// q and do rows and the LSE +1e30 in the dk/dv kernel, so the ragged edge
// adds nothing, and nothing past S is written. Results leave through a
// box their warpgroup has done reading, as 16-byte row stores.
//
// Bound on the H100: at [64, 6, 1370, 64] (the B = 2 train step) the
// function's five products are 10 S^2 hd B H = 461 GFLOP, 0.47 ms at 989
// TFLOP/s, against 0.54 GB of operands (0.16 ms at 3.35 TB/s):
// compute-bound; the pair's seven products are 646 GFLOP.
#include "flash_sm90.cuh"

namespace mst {
namespace {

using namespace flash;
using attn::desc_mn;
using attn::frag_a;
using attn::frag_col;
using attn::frag_hi;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

struct Out {  // one [B, H, S, 64] bf16 output
  bf16* p;
  long long sb, sh, ss;
  __device__ __forceinline__ bf16* rows(const Unit& w, int r0) const {
    return p + w.b * sb + w.h * sh + r0 * ss;
  }
};

struct In {  // one [B, H, S, 64] bf16 input read from device memory
  const bf16* p;
  long long sb, sh, ss;
};

struct Args {
  In o, dout;        // the dq kernel's delta
  Out d0, d1;        // dq (dq kernel); dk, dv (dk/dv kernel)
  const float* lse;  // [B, H, S]
  float* delta;      // [B, H, S]: written by the dq kernel, read by dk/dv
  int B, H, S;
  float scale;     // sm_scale * log2(e), > 0
  float sm_scale;
};

// Two products of one stage into registers, one commit group (the caller
// waits): d0 = a0 . b0^T and d1 = a1 . b1^T over the head dim (all four
// boxes K-major).
__device__ __forceinline__ void two_products(float (&d0)[32], float (&d1)[32],
                                             const unsigned char* a0, const unsigned char* b0,
                                             const unsigned char* a1, const unsigned char* b1) {
  attn::product_t(d0, a0, b0);
  attn::product_t(d1, a1, b1);
  wgmma_commit();
}

// acc += A . B over a stage's 64 rows, A this thread's packed fragments, B
// MN-major (the caller commits).
__device__ __forceinline__ void rs(float (&acc)[32], const uint32_t (&a)[4][4],
                                   const unsigned char* box) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) attn::mma_rs(acc, a[kc], desc_mn(box, kc));
}

__device__ __forceinline__ void pack(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) frag_a(a[kc], d, kc);
}

// delta = rowsum(do * o) in f32 of row r (0 past S): 16 columns a lane of
// the quad, then the 4 lanes.
__device__ __forceinline__ float row_delta(const Args& a, const Unit& w, int r, int quad) {
  float sum = 0.0f;
  if (r < a.S) {
    const bf16* o = a.o.p + w.b * a.o.sb + w.h * a.o.sh + r * a.o.ss + quad * 16;
    const bf16* d = a.dout.p + w.b * a.dout.sb + w.h * a.dout.sh + r * a.dout.ss + quad * 16;
#pragma unroll
    for (int c = 0; c < 16; c += 8) {
      float ov[8], dv[8];
      unpack8_bf16(*reinterpret_cast<const uint4*>(o + c), ov);
      unpack8_bf16(*reinterpret_cast<const uint4*>(d + c), dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += dv[e] * ov[e];
    }
  }
  return attn::quad_sum(sum);
}

// Unit buffer: [q0, q1, do0, do1] (consumer c reads q c and do c). Ring
// stage: [k, v].
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned(smem_raw);
  const Layout L = layout(4, false);
  const Bars bars = carve(base, L, 1);
  const int T = tiles(a.S), nk = boxes(a.S), units = T * a.H * a.B;
  const int role = threadIdx.x / 128;

  if (role == 0) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    sm90::tma_prefetch(&tq);
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
    sm90::tma_prefetch(&tdo);
    uint32_t it = 0, ui = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
      const Unit w = unit(u, T, a.H);
      wait_free(bars.uempty, ui, 2);
      unsigned char* ub = base + L.unit + (ui & 1) * 4 * BOX_BYTES;
      uint64_t* bar = &bars.ufull[ui & 1];
      mbar_expect_tx(bar, 4 * BOX_BYTES);
      for (int c = 0; c < CONSUMERS; ++c) {
        tma_load_4d(ub + c * BOX_BYTES, &tq, w.tile * ROWS + c * BOX, w.h, w.b, bar);
        tma_load_4d(ub + (2 + c) * BOX_BYTES, &tdo, w.tile * ROWS + c * BOX, w.h, w.b, bar);
      }
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
  const int lo = 16 * (t >> 5) + ((t & 31) >> 2);
  auto stage = [&](uint32_t i) { return base + L.ring + (i % STAGES) * 2 * BOX_BYTES; };
  if (c == 1) turn_pass(c);  // consumer 0 takes the first turn
  uint32_t it = 0, ui = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
    const Unit w = unit(u, T, a.H);
    const int r0 = w.tile * ROWS + c * BOX;
    const int ra = r0 + lo, rb = ra + 8;
    // delta and the LSE of rows ra, rb while the boxes land
    const float dl0 = row_delta(a, w, ra, t & 3), dl1 = row_delta(a, w, rb, t & 3);
    const float* lse = a.lse + w.bh * a.S;
    const float b0 = ra < a.S ? lse[ra] : 0.0f, b1 = rb < a.S ? lse[rb] : 0.0f;
    if ((t & 3) == 0) {
      if (ra < a.S) a.delta[w.bh * a.S + ra] = dl0;
      if (rb < a.S) a.delta[w.bh * a.S + rb] = dl1;
    }
    unsigned char* ub = base + L.unit + (ui & 1) * 4 * BOX_BYTES;
    unsigned char* qbox = ub + c * BOX_BYTES;
    const unsigned char* dobox = ub + (2 + c) * BOX_BYTES;
    // ds = p (dp - delta) sm_scale of stage j in dp, p = exp2(s - lse)
    auto grads = [&](float (&s)[32], float (&dp)[32], int j) {
      const int key0 = j * BOX;
      if (key0 + BOX > a.S) {  // the last stage: keys past S get p = 0
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (key0 + frag_col(t, i) >= a.S) s[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = frag_hi(i);
        const float p = attn::ex2(fmaf(s[i], a.scale, -(hi ? b1 : b0)));
        dp[i] = p * (dp[i] - (hi ? dl1 : dl0)) * a.sm_scale;
      }
    };
    float dq[32], s[32], dp[32];
    uint32_t ds[4][4];
    attn::zero(dq);
    wait_full(bars.ufull, ui, 2);
    // turn 0: s and dp of stage 0
    wait_full(bars.full, it, STAGES);
    turn_wait(c);
    wgmma_fence();
    two_products(s, dp, qbox, stage(it), dobox, stage(it) + BOX_BYTES);
    turn_pass(c);
    wgmma_wait<0>();
    attn::fence_regs(s);
    attn::fence_regs(dp);
    grads(s, dp, 0);
    pack(ds, dp);
    // turn j: s and dp of stage j beside dq += ds . k of stage j - 1
    for (int j = 1; j < nk; ++j) {
      wait_full(bars.full, it + j, STAGES);
      turn_wait(c);
      wgmma_fence();
      two_products(s, dp, qbox, stage(it + j), dobox, stage(it + j) + BOX_BYTES);
      rs(dq, ds, stage(it + j - 1));
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<1>();
      attn::fence_regs(s);
      attn::fence_regs(dp);
      grads(s, dp, j);
      wgmma_wait<0>();
      attn::fence_regs(dq);
      release(bars.empty, it + j - 1, STAGES);
      pack(ds, dp);
    }
    // the last turn: dq += ds . k of the last stage
    turn_wait(c);
    wgmma_fence();
    rs(dq, ds, stage(it + nk - 1));
    wgmma_commit();
    if (c == 0 || u + int(gridDim.x) < units) turn_pass(c);
    wgmma_wait<0>();
    attn::fence_regs(dq);
    release(bars.empty, it + nk - 1, STAGES);
    it += nk;
    store_result(qbox, c, t, dq, a.d0.rows(w, r0), a.d0.ss, min(BOX, a.S - r0));
    done_with_unit(bars, c, ui);
  }
}

// Unit buffer: [k0, k1, v0, v1] (consumer c reads k c and v c). Ring stage:
// [q, do], and its f32 [LSE 64 | delta 64] in the ring's vectors.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned(smem_raw);
  const Layout L = layout(4, true);
  const Bars bars = carve(base, L, 1 + 32);  // expect_tx and the lanes of a vector warp
  float* vec = reinterpret_cast<float*>(base + L.vec);
  const int T = tiles(a.S), nq = boxes(a.S), units = T * a.H * a.B;
  const int role = threadIdx.x / 128;

  if (role == 0) {
    reg_dealloc<PRODUCER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 && lane != 0) return;
    if (warp == 0) {  // thread 0: the TMA loads
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      sm90::tma_prefetch(&tdo);
    }
    uint32_t it = 0, ui = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
      const Unit w = unit(u, T, a.H);
      if (warp == 0) {
        wait_free(bars.uempty, ui, 2);
        unsigned char* ub = base + L.unit + (ui & 1) * 4 * BOX_BYTES;
        uint64_t* bar = &bars.ufull[ui & 1];
        mbar_expect_tx(bar, 4 * BOX_BYTES);
        for (int c = 0; c < CONSUMERS; ++c) {
          tma_load_4d(ub + c * BOX_BYTES, &tk, w.tile * ROWS + c * BOX, w.h, w.b, bar);
          tma_load_4d(ub + (2 + c) * BOX_BYTES, &tv, w.tile * ROWS + c * BOX, w.h, w.b, bar);
        }
      }
      const float* lse = a.lse + w.bh * a.S;
      const float* delta = a.delta + w.bh * a.S;
      for (int j = 0; j < nq; ++j, ++it) {
        const int st = it % STAGES;
        if (warp == 0) {
          wait_free(bars.empty, it, STAGES);
          unsigned char* qd = base + L.ring + st * 2 * BOX_BYTES;
          mbar_expect_tx(&bars.full[st], 2 * BOX_BYTES);
          tma_load_4d(qd, &tq, j * BOX, w.h, w.b, &bars.full[st]);
          tma_load_4d(qd + BOX_BYTES, &tdo, j * BOX, w.h, w.b, &bars.full[st]);
        } else if (int(it % 3) == warp - 1) {
          // warps 1-3 in turn: the stage's LSE (+1e30 past S) and delta
          // (0), three stages' loads in flight at once
          wait_free(bars.empty, it, STAGES);
          float* v = vec + st * VEC;
#pragma unroll
          for (int e = 0; e < BOX; e += 32) {
            const int q = j * BOX + e + lane;
            v[e + lane] = q < a.S ? lse[q] : LSE_PAD;
            v[BOX + e + lane] = q < a.S ? delta[q] : 0.0f;
          }
          mbar_arrive(&bars.full[st]);
        }
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int c = role - 1, t = threadIdx.x & 127;
  auto stage = [&](uint32_t i) { return base + L.ring + (i % STAGES) * 2 * BOX_BYTES; };
  // p^T = exp2(s^T - lse) in s and ds^T = p^T (dp^T - delta) sm_scale in dp
  // of ring stage i: its columns are queries, their LSE (+1e30 past S) and
  // delta in the stage's vectors, a pair at a time
  auto grads = [&](float (&s)[32], float (&dp)[32], uint32_t i) {
    const float* v = vec + (i % STAGES) * VEC;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int q = frag_col(t, e);
      const float2 lq = *reinterpret_cast<const float2*>(v + q);
      const float2 dq = *reinterpret_cast<const float2*>(v + BOX + q);
      s[e] = attn::ex2(fmaf(s[e], a.scale, -lq.x));
      s[e + 1] = attn::ex2(fmaf(s[e + 1], a.scale, -lq.y));
      dp[e] = s[e] * (dp[e] - dq.x) * a.sm_scale;
      dp[e + 1] = s[e + 1] * (dp[e + 1] - dq.y) * a.sm_scale;
    }
  };
  if (c == 1) turn_pass(c);  // consumer 0 takes the first turn
  uint32_t it = 0, ui = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++ui) {
    const Unit w = unit(u, T, a.H);
    const int r0 = w.tile * ROWS + c * BOX;  // this warpgroup's first key
    unsigned char* ub = base + L.unit + (ui & 1) * 4 * BOX_BYTES;
    unsigned char* kbox = ub + c * BOX_BYTES;
    unsigned char* vbox = ub + (2 + c) * BOX_BYTES;
    float dk[32], dv[32], s[32], dp[32];
    uint32_t pa[4][4], da[4][4];
    attn::zero(dk);
    attn::zero(dv);
    wait_full(bars.ufull, ui, 2);
    // turn 0: s^T and dp^T of stage 0
    wait_full(bars.full, it, STAGES);
    turn_wait(c);
    wgmma_fence();
    two_products(s, dp, kbox, stage(it), vbox, stage(it) + BOX_BYTES);
    turn_pass(c);
    wgmma_wait<0>();
    attn::fence_regs(s);
    attn::fence_regs(dp);
    grads(s, dp, it);
    pack(pa, s);
    pack(da, dp);
    // turn j: s^T and dp^T of stage j beside dv += p^T . do and dk += ds^T
    // . q of stage j - 1
    for (int j = 1; j < nq; ++j) {
      wait_full(bars.full, it + j, STAGES);
      turn_wait(c);
      wgmma_fence();
      two_products(s, dp, kbox, stage(it + j), vbox, stage(it + j) + BOX_BYTES);
      rs(dv, pa, stage(it + j - 1) + BOX_BYTES);
      rs(dk, da, stage(it + j - 1));
      wgmma_commit();
      turn_pass(c);
      wgmma_wait<1>();
      attn::fence_regs(s);
      attn::fence_regs(dp);
      grads(s, dp, it + j);
      wgmma_wait<0>();
      attn::fence_regs(dk);
      attn::fence_regs(dv);
      release(bars.empty, it + j - 1, STAGES);
      pack(pa, s);
      pack(da, dp);
    }
    // the last turn: dv and dk of the last stage
    turn_wait(c);
    wgmma_fence();
    rs(dv, pa, stage(it + nq - 1) + BOX_BYTES);
    rs(dk, da, stage(it + nq - 1));
    wgmma_commit();
    if (c == 0 || u + int(gridDim.x) < units) turn_pass(c);
    wgmma_wait<0>();
    attn::fence_regs(dk);
    attn::fence_regs(dv);
    release(bars.empty, it + nq - 1, STAGES);
    it += nq;
    store_result(kbox, c, t, dk, a.d0.rows(w, r0), a.d0.ss, min(BOX, a.S - r0));
    store_result(vbox, c, t, dv, a.d1.rows(w, r0), a.d1.ss, min(BOX, a.S - r0));
    done_with_unit(bars, c, ui);
  }
}

bool maps(CUtensorMap* m, const void* q, const void* k, const void* v, const void* dout,
          const long long* sq, const long long* sk, const long long* sv, const long long* sd,
          int B, int H, int S, cudaError_t* err) {
  *err = tma_map_4d(&m[0], q, sq, B, H, S);
  if (*err == cudaSuccess) *err = tma_map_4d(&m[1], k, sk, B, H, S);
  if (*err == cudaSuccess) *err = tma_map_4d(&m[2], v, sv, B, H, S);
  if (*err == cudaSuccess) *err = tma_map_4d(&m[3], dout, sd, B, H, S);
  return *err == cudaSuccess;
}

In in_view(const void* p, const long long* s) {
  return In{static_cast<const bf16*>(p), s[0], s[1], s[2]};
}

Out out_view(void* p, const long long* s) { return Out{static_cast<bf16*>(p), s[0], s[1], s[2]}; }

}  // namespace
}  // namespace mst

// q, k, v, o, do, dq: [B, H, S, 64] bf16 with element strides strides[3 i
// .. 3 i + 2] (slice, head, row; host memory) in that order, multiples of
// 8, the pointers 16-byte aligned; lse: [B, H, S] f32 (base 2,
// flash_fwd.cu); delta: [B, H, S] f32 out. scale = sm_scale * log2(e) > 0.
extern "C" int mst_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* delta, void* dq,
                                const long long* strides, int B, int H, int S, float scale,
                                float sm_scale, void* stream) {
  using namespace mst;
  using namespace mst::flash;
  if (!shape_ok(strides, 18, B, H, S) || !(scale > 0.0f)) return cudaErrorInvalidValue;
  CUtensorMap m[4];
  cudaError_t err;
  if (!maps(m, q, k, v, dout, strides, strides + 3, strides + 6, strides + 12, B, H, S, &err))
    return err;
  const size_t smem = layout(4, false).total;
  int grid = 0;
  err = prepare(flash_bwd_dq_kernel, smem, tiles(S) * H * B, &grid);
  if (err != cudaSuccess) return err;
  const Args a{in_view(o, strides + 9),   in_view(dout, strides + 12),
               out_view(dq, strides + 15), Out{nullptr, 0, 0, 0},
               static_cast<const float*>(lse), static_cast<float*>(delta), B, H, S, scale,
               sm_scale};
  flash_bwd_dq_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

// q, k, v, do, dk, dv: [B, H, S, 64] bf16 with element strides strides[3 i
// .. 3 i + 2] in that order; lse and delta [B, H, S] f32 (delta from
// mst_flash_bwd_dq).
extern "C" int mst_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 const long long* strides, int B, int H, int S, float scale,
                                 float sm_scale, void* stream) {
  using namespace mst;
  using namespace mst::flash;
  if (!shape_ok(strides, 18, B, H, S) || !(scale > 0.0f)) return cudaErrorInvalidValue;
  CUtensorMap m[4];
  cudaError_t err;
  if (!maps(m, q, k, v, dout, strides, strides + 3, strides + 6, strides + 9, B, H, S, &err))
    return err;
  const size_t smem = layout(4, true).total;
  int grid = 0;
  err = prepare(flash_bwd_dkv_kernel, smem, tiles(S) * H * B, &grid);
  if (err != cudaSuccess) return err;
  const Args a{In{nullptr, 0, 0, 0},
               In{nullptr, 0, 0, 0},
               out_view(dk, strides + 12),
               out_view(dv, strides + 15),
               static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)),
               B, H, S, scale, sm_scale};
  flash_bwd_dkv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}
