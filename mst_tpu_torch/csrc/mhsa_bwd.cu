// mhsa_bwd: the attention core of the backward, per slice and head, from the
// forward's saved residuals: qkv [N*S, 3E] bf16, o [N*S, E] bf16, the
// upstream gradient do [N*S, E] bf16 and the base-2 log-sum-exp rows
// lse [N*S, heads] f32 written by mhsa.cu -> dqkv [N*S, 3E] bf16.
//
// Replaces the per-head loop of `_attn_bwd_kernel` in
// mst_tpu/ops/fused_block.py (:680, core :767-805), with its math and
// rounding points:
//   s = q k^T * (log2(e) / sqrt(hd)),  p = exp2(s - b)   (f32, normalised)
//   dv = bf16(bf16(p)^T do),  dp = do v^T,  delta = rowdot(do, o)
//   ds = bf16((dp - delta) * p / sqrt(hd))   (p in f32 here)
//   dq = bf16(ds k),  dk = bf16(ds^T q)
// Nothing of [S, S] goes to shared or device memory: p is rebuilt from the
// saved b in one exp2 pass, in registers.
//
// Bound on the H100: at ViT-S B=8 ([256, 6, 257, 64]) the five products
// are 65 GFLOP (66 us at 989 TFLOP/s) against 406 MB of operands (121 us at
// 3.35 TB/s): bound by bytes if every operand of a head is read from L2
// by the blocks that share it. The WMMA pair kept two f32 [32][sp] score
// blocks per block in shared memory and read every fragment from there.
// The TPU kernel held a whole slice in VMEM; here dq sums over keys and
// dk, dv over queries, so the work is split in two kernels (no float
// atomics: the same bits on repeat). A block is one warpgroup on a (head,
// slice) that walks up to 3 of its 64-row tiles (`tiles_per_block`), with
// the operand it walks over resident in shared memory, loaded once by TMA
// in boxes on their own mbarriers (3-D maps over [N, S, *]: rows past S of
// a slice read as zeros), and the tile's own boxes double-buffered, as
// mhsa.cu (attn_sm90.cuh):
//   dq kernel:  query tiles - the q and do tiles, every box of k and v
//               (106 KB at S = 257: two blocks an SM); per key chunk s =
//               q k^T and dp = do v^T by wgmma into registers, ds there, dq
//               += bf16(ds) k with ds as the register A operand and k read
//               MN-major; also writes delta (rowdot in the D-fragment rows,
//               summed over the 4 lanes of a row) for the next kernel;
//   dkv kernel: key tiles - the k and v tiles, every box of q and do, and
//               the LSE and delta of every query; per query chunk s^T =
//               k q^T and dp^T = v do^T, then dv += bf16(p^T) do and dk +=
//               bf16(ds^T) q, both from registers.
// Both compute s and dp, so the pair runs seven S^2 hd products where one
// kernel would run five; that buys no [S, S] round trip and no cross-block
// sum. Chunks are those of mhsa.cu (a last chunk of <= 16 rows is an
// m64n16 product: the 257th row). Keys past S get p = 0; queries past S
// have zero q and do rows and are masked too, so the ragged edge adds
// nothing to any sum (every 16-row step of a chunk runs: a wgmma under a
// branch is serialized), and nothing past S is written. The f32 results are
// staged as bf16 through a dead box and leave as 16-byte row stores.
//
// RoPE (`has_rope` of `_attn_bwd_kernel`, :754-766 and :806-814; the DINOv3
// train step) is the template flag ROPE of both kernels. The saved qkv is
// pre-rope, as in JAX, so each kernel rotates q and k in their boxes as
// they land (`rope_box`: the dq kernel its q tile and all of k, the dk/dv
// kernel its k tile and all of q), which recomputes the forward's bf16
// rotated values; the adjoint takes dq and dk back through the rotation on
// the f32 accumulators before the bf16 store (`rope_adjoint8`'s pair rule,
// with JAX's bf16 rounding of dq_r * sin); dv is not rotated.
#include "attn_sm90.cuh"

namespace mst {
namespace {

using namespace attn;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

// Shared memory of both kernels (past the 1024-byte aligned base): the two
// tile operands' boxes, double-buffered ([buffer][operand]), the boxes of
// the two whole-slice operands, the f32 LSE and delta of every query (the
// dk/dv kernel's), then the barriers (0, 1: the tile buffers; 2 + b: the
// two boxes of chunk b).
struct Layout {
  size_t tiles, all0, all1, vec, bar, total;
};

__host__ __device__ inline Layout layout(int S) {
  const Plan p = plan(S);
  Layout L;
  L.tiles = 0;
  L.all0 = L.tiles + 4 * BOX_BYTES;
  L.all1 = L.all0 + operand_bytes(p);
  L.vec = L.all1 + operand_bytes(p);
  L.bar = L.vec + 2 * size_t(p.boxes) * CHUNK * sizeof(float);
  L.total = ALIGN + L.bar + size_t(2 + p.boxes) * sizeof(uint64_t);
  return L;
}

struct Args {
  const bf16* o;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dqkv;
  const float* rcos;
  const float* rsin;
  int S, E, H;
  float scale_log2, scale;
};

constexpr int MOST_TILES = 3;  // tiles a block walks, at most

// The TMA maps: qkv and do in boxes of 64 rows and of 16 (the tail).
struct Maps {
  CUtensorMap qkv64, qkv16, do64, do16;
};

// The carved shared memory of a block and its barriers.
struct Smem {
  unsigned char *tiles, *all0, *all1;
  float* vec;
  uint64_t* bar;
  // operand i (0, 1) of the tile of unit u
  __device__ __forceinline__ unsigned char* tile(int u, int i) const {
    return tiles + ((u & 1) * 2 + i) * BOX_BYTES;
  }
};

__device__ __forceinline__ Smem carve(unsigned char* raw, const Layout& L, const Plan& P) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  Smem s{base + L.tiles, base + L.all0, base + L.all1, reinterpret_cast<float*>(base + L.vec),
         reinterpret_cast<uint64_t*>(base + L.bar)};
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + P.boxes; ++i) sm90::mbar_init(&s.bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return s;
}

// Thread 0: the two tile boxes of unit u (rows r0 of maps m0, m1 at
// columns c0, c1) on barrier u % 2.
__device__ __forceinline__ void load_tile(const Smem& s, int u, int r0, const CUtensorMap* m0,
                                          int c0, const CUtensorMap* m1, int c1, int n) {
  sm90::mbar_expect_tx(&s.bar[u & 1], 2 * BOX_BYTES);
  tma_load_3d(s.tile(u, 0), m0, c0, r0, n, &s.bar[u & 1]);
  tma_load_3d(s.tile(u, 1), m1, c1, r0, n, &s.bar[u & 1]);
}

// Thread 0: every chunk of the two whole-slice operands (columns a0 of
// qkv or do, a1 likewise; `do0` / `do1` pick do's maps) on barriers 2 + b.
__device__ __forceinline__ void load_all(const Smem& s, const Plan& P, const Maps& m, bool do0,
                                         int a0, bool do1, int a1, int n) {
  for (int b = 0; b < P.boxes; ++b) {
    const bool full = b < P.n64;
    const CUtensorMap* m0 = do0 ? (full ? &m.do64 : &m.do16) : (full ? &m.qkv64 : &m.qkv16);
    const CUtensorMap* m1 = do1 ? (full ? &m.do64 : &m.do16) : (full ? &m.qkv64 : &m.qkv16);
    sm90::mbar_expect_tx(&s.bar[2 + b], 2 * (full ? BOX_BYTES : TAIL_BYTES));
    tma_load_3d(s.all0 + b * BOX_BYTES, m0, a0, b * CHUNK, n, &s.bar[2 + b]);
    tma_load_3d(s.all1 + b * BOX_BYTES, m1, a1, b * CHUNK, n, &s.bar[2 + b]);
  }
}

// The adjoint of the rotation on this thread's f32 accumulators of rows
// ra, rb (positions; none past S is stored), `rope_adjoint8`'s pair rule.
__device__ __forceinline__ void rope_adjoint_frag(float (&d)[32], int t, int ra, int rb, int S,
                                                  const float* __restrict__ rcos,
                                                  const float* __restrict__ rsin) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = frag_hi(i) ? rb : ra, c = frag_col(t, i);
    if (r >= S) continue;
    const float2 cs = *reinterpret_cast<const float2*>(rcos + r * HD + c);
    const float2 sn = *reinterpret_cast<const float2*>(rsin + r * HD + c);
    const float y0 = round_bf16(__fmul_rn(d[i], sn.x));
    const float y1 = round_bf16(__fmul_rn(d[i + 1], sn.y));
    d[i] = __fadd_rn(__fmul_rn(d[i], cs.x), y1);
    d[i + 1] = __fsub_rn(__fmul_rn(d[i + 1], cs.y), y0);
  }
}

// With ROPE: rotate the tile box of unit u (operand 0, rows r0 ..) as it
// lands, and on the first unit every whole-slice box of all0; the caller
// syncs.
template <bool ROPE>
__device__ __forceinline__ void rotate(const Smem& s, const Plan& P, int t, int u, int r0,
                                       const Args& a) {
  if (!ROPE) return;
  mbar_wait(&s.bar[u & 1], (u >> 1) & 1);
  rope_box(s.tile(u, 0), t, r0, a.S, a.rcos, a.rsin);
  if (u == 0)
    for (int b = 0; b < P.boxes; ++b) {
      mbar_wait(&s.bar[2 + b], 0);
      rope_box(s.all0 + b * BOX_BYTES, t, b * CHUNK, a.S, a.rcos, a.rsin);
    }
}

// One key chunk b of the dq kernel (R / 2 keys wide): s, dp, ds in
// registers, then dq += bf16(ds) k (one commit group; the next chunk's
// wait, or the caller's, completes it).
template <int R>
__device__ __forceinline__ void dq_chunk(float (&dq)[32], const Smem& s, int u, int b, int t,
                                         const Args& a, float b0, float b1, float dl0,
                                         float dl1) {
  const unsigned char* kbox = s.all0 + b * BOX_BYTES;
  const int key0 = b * CHUNK;
  float sc[R], dp[R];
  wgmma_fence();
  product_t(sc, s.tile(u, 0), kbox);
  product_t(dp, s.tile(u, 1), s.all1 + b * BOX_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool hi = frag_hi(i);
    const float p =
        key0 + frag_col(t, i) < a.S ? ex2(sc[i] * a.scale_log2 - (hi ? b1 : b0)) : 0.0f;
    dp[i] = (dp[i] - (hi ? dl1 : dl0)) * p * a.scale;
  }
  uint32_t ad[R / 8][4];
#pragma unroll
  for (int kc = 0; kc < R / 8; ++kc) frag_a(ad[kc], dp, kc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < R / 8; ++kc) mma_rs(dq, ad[kc], desc_mn(kbox, kc));
  wgmma_commit();
}

// Grid (heads x tile groups, N): a block walks up to MOST_TILES query tiles
// of a (head, slice), k and v loaded once. Also writes delta [N*S, heads].
template <bool ROPE>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_dq_kernel(const __grid_constant__ Maps m, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const Plan P = plan(a.S);
  const Smem s = carve(smem_raw, layout(a.S), P);
  const int t = threadIdx.x, lane = t & 31, quad = lane & 3;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const int groups = (tiles(a.S) + tpb - 1) / tpb;
  const int h = blockIdx.x / groups, t0 = (blockIdx.x % groups) * tpb, n = blockIdx.y;
  const int units = min(tpb, tiles(a.S) - t0);
  if (t == 0) {
    load_tile(s, 0, t0 * TILE, &m.qkv64, h * HD, &m.do64, h * HD, n);
    load_all(s, P, m, false, a.E + h * HD, false, 2 * a.E + h * HD, n);
    if (units > 1) load_tile(s, 1, (t0 + 1) * TILE, &m.qkv64, h * HD, &m.do64, h * HD, n);
  }
  for (int u = 0; u < units; ++u) {
    const int q0 = (t0 + u) * TILE;
    const int qa = q0 + 16 * (t >> 5) + (lane >> 2), qb = qa + 8;
    // delta = rowdot(do, o) in f32 of rows qa, qb: 16 columns a lane, then
    // the 4 lanes of the row, while the boxes land
    float dl0 = 0.0f, dl1 = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = r ? qb : qa;
      float sum = 0.0f;
      if (q < a.S) {
        const size_t off = (size_t(n) * a.S + q) * a.E + h * HD + quad * 16;
#pragma unroll
        for (int c = 0; c < 16; c += 8) {
          float ov[8], dv[8];
          unpack8_bf16(*reinterpret_cast<const uint4*>(a.o + off + c), ov);
          unpack8_bf16(*reinterpret_cast<const uint4*>(a.dout + off + c), dv);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += dv[e] * ov[e];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      (r ? dl1 : dl0) = sum;
      if (quad == 0 && q < a.S) a.delta[(size_t(n) * a.S + q) * a.H + h] = sum;
    }
    const float b0 = qa < a.S ? a.lse[(size_t(n) * a.S + qa) * a.H + h] : 0.0f;
    const float b1 = qb < a.S ? a.lse[(size_t(n) * a.S + qb) * a.H + h] : 0.0f;
    rotate<ROPE>(s, P, t, u, q0, a);
    if (ROPE) __syncthreads();

    float dq[32];
    zero(dq);
    mbar_wait(&s.bar[u & 1], (u >> 1) & 1);
    for (int b = 0; b < P.n64; ++b) {
      mbar_wait(&s.bar[2 + b], 0);
      dq_chunk<32>(dq, s, u, b, t, a, b0, b1, dl0, dl1);
    }
    if (P.tail) {
      mbar_wait(&s.bar[2 + P.n64], 0);
      dq_chunk<8>(dq, s, u, P.n64, t, a, b0, b1, dl0, dl1);
    }
    wgmma_wait<0>();
    fence_regs(dq);
    if (ROPE) rope_adjoint_frag(dq, t, qa, qb, a.S, a.rcos, a.rsin);
    stage_box(s.tile(u, 0), t, dq);  // the q box: its last reader was the last s
    __syncthreads();
    const size_t row3 = size_t(3) * a.E;
    store_box(s.tile(u, 0), t, a.dqkv + (size_t(n) * a.S + q0) * row3 + h * HD, row3,
              min(TILE, a.S - q0));
    fence_async_smem();
    __syncthreads();
    if (t == 0 && u + 2 < units)
      load_tile(s, u + 2, q0 + 2 * TILE, &m.qkv64, h * HD, &m.do64, h * HD, n);
  }
}

// One query chunk b of the dk/dv kernel (R / 2 queries wide): s^T, dp^T,
// p^T and ds^T in registers, then dv += bf16(p^T) do and dk += bf16(ds^T) q
// (one commit group).
template <int R>
__device__ __forceinline__ void dkv_chunk(float (&dk)[32], float (&dv)[32], const Smem& s,
                                          const Plan& P, int u, int b, int t, const Args& a) {
  const unsigned char* qbox = s.all0 + b * BOX_BYTES;
  const unsigned char* dobox = s.all1 + b * BOX_BYTES;
  const float* lse = s.vec;
  const float* delta = s.vec + P.boxes * CHUNK;
  const int qc0 = b * CHUNK;
  float sc[R], dp[R];
  wgmma_fence();
  product_t(sc, s.tile(u, 0), qbox);
  product_t(dp, s.tile(u, 1), dobox);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int q = qc0 + frag_col(t, i);
    const float p = q < a.S ? ex2(sc[i] * a.scale_log2 - lse[q]) : 0.0f;
    sc[i] = p;
    dp[i] = (dp[i] - delta[q]) * p * a.scale;
  }
  uint32_t ap[R / 8][4], ad[R / 8][4];
#pragma unroll
  for (int kc = 0; kc < R / 8; ++kc) {
    frag_a(ap[kc], sc, kc);
    frag_a(ad[kc], dp, kc);
  }
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < R / 8; ++kc) {
    mma_rs(dv, ap[kc], desc_mn(dobox, kc));
    mma_rs(dk, ad[kc], desc_mn(qbox, kc));
  }
  wgmma_commit();
}

// Grid (heads x tile groups, N): a block walks up to MOST_TILES key tiles
// of a (head, slice), q, do and the LSE and delta of every query loaded
// once.
template <bool ROPE>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_dkv_kernel(const __grid_constant__ Maps m, Args a) {
  extern __shared__ unsigned char smem_raw[];
  const Plan P = plan(a.S);
  const Smem s = carve(smem_raw, layout(a.S), P);
  const int t = threadIdx.x, lane = t & 31;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const int groups = (tiles(a.S) + tpb - 1) / tpb;
  const int h = blockIdx.x / groups, t0 = (blockIdx.x % groups) * tpb, n = blockIdx.y;
  const int units = min(tpb, tiles(a.S) - t0);
  if (t == 0) {
    load_tile(s, 0, t0 * TILE, &m.qkv64, a.E + h * HD, &m.qkv64, 2 * a.E + h * HD, n);
    load_all(s, P, m, false, h * HD, true, h * HD, n);
    if (units > 1)
      load_tile(s, 1, (t0 + 1) * TILE, &m.qkv64, a.E + h * HD, &m.qkv64, 2 * a.E + h * HD, n);
  }
  // the LSE and delta of every query (0 past S: those queries are masked)
  for (int j = t; j < P.boxes * CHUNK; j += THREADS) {
    const size_t idx = (size_t(n) * a.S + j) * a.H + h;
    s.vec[j] = j < a.S ? a.lse[idx] : 0.0f;
    s.vec[P.boxes * CHUNK + j] = j < a.S ? a.delta[idx] : 0.0f;
  }
  __syncthreads();
  for (int u = 0; u < units; ++u) {
    const int k0 = (t0 + u) * TILE;
    const int ka = k0 + 16 * (t >> 5) + (lane >> 2), kb = ka + 8;
    rotate<ROPE>(s, P, t, u, k0, a);
    if (ROPE) __syncthreads();

    float dk[32], dv[32];
    zero(dk);
    zero(dv);
    mbar_wait(&s.bar[u & 1], (u >> 1) & 1);
    for (int b = 0; b < P.n64; ++b) {
      mbar_wait(&s.bar[2 + b], 0);
      dkv_chunk<32>(dk, dv, s, P, u, b, t, a);
    }
    if (P.tail) {
      mbar_wait(&s.bar[2 + P.n64], 0);
      dkv_chunk<8>(dk, dv, s, P, u, P.n64, t, a);
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    if (ROPE) rope_adjoint_frag(dk, t, ka, kb, a.S, a.rcos, a.rsin);
    // dk through the k box, dv through the v box (their last reads are done)
    stage_box(s.tile(u, 0), t, dk);
    stage_box(s.tile(u, 1), t, dv);
    __syncthreads();
    const size_t row3 = size_t(3) * a.E;
    bf16* dst = a.dqkv + (size_t(n) * a.S + k0) * row3 + h * HD;
    const int rows = min(TILE, a.S - k0);
    store_box(s.tile(u, 0), t, dst + a.E, row3, rows);
    store_box(s.tile(u, 1), t, dst + 2 * a.E, row3, rows);
    fence_async_smem();
    __syncthreads();
    if (t == 0 && u + 2 < units)
      load_tile(s, u + 2, k0 + 2 * TILE, &m.qkv64, a.E + h * HD, &m.qkv64, 2 * a.E + h * HD, n);
  }
}

template <bool ROPE>
cudaError_t launch_pair(const Maps& m, const Args& a, int N, cudaStream_t st) {
  const size_t smem = layout(a.S).total;
  cudaError_t err = allow_smem(mhsa_bwd_dq_kernel<ROPE>, smem);
  if (err == cudaSuccess) err = allow_smem(mhsa_bwd_dkv_kernel<ROPE>, smem);
  if (err != cudaSuccess) return err;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const dim3 grid(a.H * ((tiles(a.S) + tpb - 1) / tpb), N);
  mhsa_bwd_dq_kernel<ROPE><<<grid, THREADS, smem, st>>>(m, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mhsa_bwd_dkv_kernel<ROPE><<<grid, THREADS, smem, st>>>(m, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mst

// qkv [N*S, 3E], o, dout [N*S, E] bf16, lse [N*S, heads] f32 -> dqkv
// [N*S, 3E] bf16. delta: [N*S, heads] f32 scratch, written by the dq kernel
// and read by the dk/dv kernel (both launched here, in that order).
// rope_cos / rope_sin: [S, 64] f32 each, both or neither (NULL): the
// forward's RoPE on q and k, recomputed from the pre-rope qkv.
// E == num_heads * 64, S <= 512. scale_log2 = log2(e) / sqrt(64) (the
// forward's), scale = 1 / sqrt(64).
extern "C" int mst_mhsa_bwd(const void* qkv, const void* o, const void* dout,
                            const void* lse, void* delta, void* dqkv, const void* rope_cos,
                            const void* rope_sin, int N, int S, int E, int num_heads,
                            float scale_log2, float scale, void* stream) {
  using namespace mst;
  if (N <= 0 || N > 65535 || S <= 0 || S > MAX_S || num_heads <= 0 ||
      num_heads > 65535 || E != num_heads * HD ||
      (rope_cos == nullptr) != (rope_sin == nullptr))
    return cudaErrorInvalidValue;
  Maps m;
  cudaError_t err = tma_map_3d(&m.qkv64, qkv, N, S, 3 * size_t(E), CHUNK);
  if (err == cudaSuccess) err = tma_map_3d(&m.qkv16, qkv, N, S, 3 * size_t(E), TAIL);
  if (err == cudaSuccess) err = tma_map_3d(&m.do64, dout, N, S, E, CHUNK);
  if (err == cudaSuccess) err = tma_map_3d(&m.do16, dout, N, S, E, TAIL);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const bf16*>(o),         static_cast<const bf16*>(dout),
               static_cast<const float*>(lse),      static_cast<float*>(delta),
               static_cast<bf16*>(dqkv),            static_cast<const float*>(rope_cos),
               static_cast<const float*>(rope_sin), S, E, num_heads, scale_log2, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rope_cos != nullptr ? launch_pair<true>(m, a, N, st) : launch_pair<false>(m, a, N, st);
}

// The launch geometry of both kernels of mst_mhsa_bwd at sequence length S
// (1 <= S <= 512): geo = {tile rows, tiles, tiles a block walks, threads,
// 64-row chunks, tail chunks of 16, dynamic shared memory bytes}
// (`fused_block.mhsa_launch` mirrors it).
extern "C" int mst_mhsa_bwd_geometry(int S, int* geo) {
  using namespace mst;
  if (S <= 0 || S > MAX_S) return cudaErrorInvalidValue;
  const Plan p = plan(S);
  const int g[7] = {TILE, tiles(S), tiles_per_block(S, MOST_TILES), THREADS, p.n64, p.tail,
                    static_cast<int>(layout(S).total)};
  for (int i = 0; i < 7; ++i) geo[i] = g[i];
  return cudaSuccess;
}
