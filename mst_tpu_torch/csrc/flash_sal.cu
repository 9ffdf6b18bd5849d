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
//   row moved one block on). A unit is a key tile of 64 keys of one
//   (slice, head), the shape of flash_bwd.cu's dk/dv kernel: its K tile
//   is loaded once into shared memory and into the A fragments of each
//   warp's 16 keys; the query tiles stream through a two-stage cp.async
//   ring with their 64 LSE values (+1e30 past S: p = 0) and carry weights
//   (0 past S), where that kernel keeps delta. Per stage s^T = k.q^T by
//   mma.sync m16n8k16 (bf16, f32 sums), p^T = exp2(s^T - lse) and the
//   weighted row sum by r in registers, each thread its two keys in query
//   order, then the 4 lanes of a row: a fixed order with no float atomics,
//   so two runs give the same bits. The ROW form (template flag) is the
//   CLS row of the last block: r one-hot at CLS and the first query tile
//   alone, so it reads K once.
// - mst_flash_abnar: the Abnar & Zuidema factor [B, S, S] f32 of the block,
//   rownorm(mean_h p_h + I), the rule of `mhsa_abnar` (mhsa.cu; the JAX
//   `_mhsa_ref` form and `attention_rollout`): the heads summed in head
//   order, times 1 / H, plus I, each row divided by its sum. A unit is a
//   query tile of 64 rows of one slice: the Q tiles of every head and
//   their LSE stay in shared memory, the K tiles of each (key tile, head)
//   stream through the ring. A row's sum needs every key of it, and a row
//   of 1370 f32 does not fit on chip, so the unit walks its keys twice:
//   the first pass sums each row (each thread its columns, then the 4
//   lanes of a row), the second recomputes the same values and writes
//   each element of the factor once. Keys past S are masked (their K rows
//   read as zeros, which would score 0), rows past S not written.
//
// Bound on the H100 at [256, 6, 1370, 64] (518 px, B = 8): the carry's
// scores are 2 S^2 hd B H = 369 GFLOP (0.37 ms at 989 TFLOP/s) against
// 0.54 GB of q and k (0.16 ms): bound by the products, and as near by the
// exp2 unit (2.9 G exp2). The CLS row reads K once, 0.27 GB (0.08 ms).
// The Abnar factor writes 1.92 GB and reads 0.54 GB (0.73 ms at 3.35
// TB/s) against the same 369 GFLOP: bound by bytes; its second pass runs
// the scores again rather than read back a row-sum-less factor (5.8 GB
// of traffic). Both are first versions on mma.sync: a block of 4 warps,
// a tile of 64 rows, no TMA or wgmma yet.
#include "common.cuh"

namespace mst {
namespace {

constexpr int SAL_TILE = 64;       // rows of a tile: 4 warps of 16
constexpr int SAL_THREADS = 128;   // 4 warps
constexpr int SAL_HD = 64;         // head dim
constexpr int SAL_TILE_BYTES = SAL_TILE * SAL_HD * 2;  // 8 KB, swizzled
constexpr int SAL_VEC = 2 * SAL_TILE;  // a stage's f32 [LSE 64 | weights 64]
constexpr float SAL_LSE_PAD = 1e30f;   // a query past S: p = exp2(s - 1e30) = 0
// The carry kernel's static shared memory: the K tile, two Q stages and
// their vectors.
constexpr int SAL_CARRY_SMEM = 3 * SAL_TILE_BYTES + 2 * SAL_VEC * 4;

struct View {  // a [B, H, S, 64] bf16 operand
  const bf16* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const bf16* head(int b, int h) const { return p + b * sb + h * sh; }
};

__host__ __device__ inline int sal_tiles(int S) { return (S + SAL_TILE - 1) / SAL_TILE; }

// Byte offset of the 16-byte chunk c of row r in a tile: row r at byte
// 128 r, its chunk c at chunk c ^ (r % 8), so the 8 rows an ldmatrix reads
// fall in 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The four 8 x 8 bf16 matrices at the rows this lane addresses
// (`ldmatrix`, not transposed): lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 2^x by the special-function unit, as flash_fwd.cu takes it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 .. r0 + 63 of one (slice, head) into a swizzled tile by cp.async
// (the caller commits); rows at or past S are zero-filled without a read.
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* head, long long ss,
                                          int r0, int S) {
#pragma unroll
  for (int g = threadIdx.x; g < SAL_TILE * 8; g += SAL_THREADS) {
    const int r = g >> 3, c = g & 7, row = r0 + r;
    const bool in = row < S;
    cp_async16(tile + swz(r, c), head + (in ? row * ss + c * 8 : 0), in ? 16 : 0);
  }
}

// The A fragments (m16k16, 4 k steps over the head dim) of the 16 rows
// of warp w of a tile.
__device__ __forceinline__ void a_frags(uint32_t (&f)[4][4], const unsigned char* tile, int w,
                                        int lane) {
  const int r = w * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(f[kk], tile + swz(r, 2 * kk + (lane >> 4)));
}

// c[16 x 8] = A . B^T over the head dim, B the 8 rows nb * 8 .. of a tile
// (its rows are the n index: `ldmatrix` of the row-major tile gives the
// col-major B fragments as they are).
__device__ __forceinline__ void scores8(float (&c)[4], const uint32_t (&a)[4][4],
                                        const unsigned char* tile, int nb, int lane) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
  for (int kp = 0; kp < 2; ++kp) {
    uint32_t b[4];
    ldsm_x4(b, tile + swz(nb * 8 + (lane & 7), 4 * kp + (lane >> 3)));
    mma_16816(c, a[2 * kp], b[0], b[1]);
    mma_16816(c, a[2 * kp + 1], b[2], b[3]);
  }
}

struct CarryArgs {
  View q, k;
  const float* lse;    // [B, H, S]
  const float* carry;  // [B, H, S]; unused by the ROW form
  float* out;          // [B, H, S]
  int B, H, S;
  float scale;  // sm_scale * log2(e), > 0
};

// Unit u: key tile u % T of (slice, head) u / T. Warp w owns keys tile *
// 64 + 16 w .. + 15; lane (g, t) of it the keys 16 w + g and + 8 and, in
// each 8-query group, the queries 2 t and 2 t + 1.
template <bool ROW>
__global__ void __launch_bounds__(SAL_THREADS) flash_sal_carry_kernel(const CarryArgs a) {
  __shared__ __align__(128) unsigned char kt[SAL_TILE_BYTES];
  __shared__ __align__(128) unsigned char qt[2][SAL_TILE_BYTES];
  __shared__ float vec[2][SAL_VEC];
  const int T = sal_tiles(a.S);
  const int tile = blockIdx.x % T;
  const int bh = blockIdx.x / T;
  const int h = bh % a.H, b = bh / a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qh = a.q.head(b, h);
  const float* lse = a.lse + size_t(bh) * a.S;
  const float* carry = ROW ? nullptr : a.carry + size_t(bh) * a.S;
  const int nq = ROW ? 1 : T;  // the ROW form: the first query tile alone

  // query tile j into stage j % 2, with its LSE and carry weights
  auto stage_in = [&](int j) {
    const int st = j & 1;
    load_tile(qt[st], qh, a.q.ss, j * SAL_TILE, a.S);
    cp_async_commit();
    if (threadIdx.x < SAL_TILE) {
      const int qi = j * SAL_TILE + threadIdx.x;
      vec[st][threadIdx.x] = qi < a.S ? lse[qi] : SAL_LSE_PAD;
      vec[st][SAL_TILE + threadIdx.x] =
          ROW ? (qi == 0 ? 1.0f : 0.0f) : (qi < a.S ? carry[qi] : 0.0f);
    }
  };
  load_tile(kt, a.k.head(b, h), a.k.ss, tile * SAL_TILE, a.S);
  cp_async_commit();
  stage_in(0);

  uint32_t kf[4][4];
  float acc0 = 0.0f, acc1 = 0.0f;  // keys g and g + 8 of the warp
  for (int j = 0; j < nq; ++j) {
    if (j + 1 < nq) {
      stage_in(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) a_frags(kf, kt, warp, lane);
    const unsigned char* qs = qt[j & 1];
    const float* lv = vec[j & 1];
    const float* rv = vec[j & 1] + SAL_TILE;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float c[4];
      scores8(c, kf, qs, nb, lane);
      const int q0 = nb * 8 + 2 * t4;
      const float l0 = lv[q0], l1 = lv[q0 + 1], r0 = rv[q0], r1 = rv[q0 + 1];
      acc0 += r0 * ex2(fmaf(c[0], a.scale, -l0)) + r1 * ex2(fmaf(c[1], a.scale, -l1));
      acc1 += r0 * ex2(fmaf(c[2], a.scale, -l0)) + r1 * ex2(fmaf(c[3], a.scale, -l1));
    }
    __syncthreads();  // the stage is read before it is refilled
  }
  acc0 += __shfl_xor_sync(0xffffffffu, acc0, 1);
  acc0 += __shfl_xor_sync(0xffffffffu, acc0, 2);
  acc1 += __shfl_xor_sync(0xffffffffu, acc1, 1);
  acc1 += __shfl_xor_sync(0xffffffffu, acc1, 2);
  if (t4 == 0) {
    const int key = tile * SAL_TILE + warp * 16 + g;
    float* out = a.out + size_t(bh) * a.S;
    if (key < a.S) out[key] = acc0;
    if (key + 8 < a.S) out[key + 8] = acc1;
  }
}

struct AbnarArgs {
  View q, k;
  const float* lse;  // [B, H, S]
  float* out;        // [B, S, S]
  int B, H, S;
  float scale;  // sm_scale * log2(e), > 0
  float inv_h;  // 1 / H in f32
};

// Dynamic shared memory of the Abnar kernel: the Q tiles of the H heads,
// two K stages, the heads' LSE of the unit's 64 rows.
__host__ __device__ inline size_t abnar_smem(int H) {
  return size_t(H) * SAL_TILE_BYTES + 2 * SAL_TILE_BYTES + size_t(H) * SAL_TILE * 4;
}

// Unit u: query tile u % T of slice u / T. Warp w owns rows 16 w .. + 15
// of it; lane (g, t) the rows 16 w + g and + 8 and, in each 8-key group,
// the keys 2 t and 2 t + 1. Step i of a pass: key tile i / H, head i % H.
__global__ void __launch_bounds__(SAL_THREADS) flash_sal_abnar_kernel(const AbnarArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, S = a.S, T = sal_tiles(S);
  unsigned char* qs = smem;
  unsigned char* ks = smem + size_t(H) * SAL_TILE_BYTES;
  float* ls = reinterpret_cast<float*>(ks + 2 * SAL_TILE_BYTES);
  const int tile = blockIdx.x % T, b = blockIdx.x / T;
  const int r0 = tile * SAL_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  for (int h = 0; h < H; ++h) load_tile(qs + h * SAL_TILE_BYTES, a.q.head(b, h), a.q.ss, r0, S);
  for (int i = threadIdx.x; i < H * SAL_TILE; i += SAL_THREADS) {
    const int h = i / SAL_TILE, r = r0 + i % SAL_TILE;
    ls[i] = r < S ? a.lse[(size_t(b) * H + h) * S + r] : 0.0f;
  }
  const int steps = T * H;  // per pass
  auto fetch = [&](int i) {
    const int j = (i % steps) / H, h = i % H;
    load_tile(ks + (i & 1) * SAL_TILE_BYTES, a.k.head(b, h), a.k.ss, j * SAL_TILE, S);
    cp_async_commit();  // the Q tiles ride in the first group
  };
  fetch(0);
  const int rowa = r0 + warp * 16 + g, rowb = rowa + 8;
  float ab[32];  // the head sum of key group nb at [4 nb .. 4 nb + 3]
  float rs0 = 0.0f, rs1 = 0.0f;  // rows a, b: this thread's share, then the row's sum
  for (int i = 0; i < 2 * steps; ++i) {
    const int pass = i / steps, j = (i % steps) / H, h = i % H;
    if (i + 1 < 2 * steps) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t qf[4][4];
    a_frags(qf, qs + h * SAL_TILE_BYTES, warp, lane);
    const unsigned char* kh = ks + (i & 1) * SAL_TILE_BYTES;
    const float la = ls[h * SAL_TILE + warp * 16 + g], lb = ls[h * SAL_TILE + warp * 16 + g + 8];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float c[4];
      scores8(c, qf, kh, nb, lane);
      const float p[4] = {ex2(fmaf(c[0], a.scale, -la)), ex2(fmaf(c[1], a.scale, -la)),
                          ex2(fmaf(c[2], a.scale, -lb)), ex2(fmaf(c[3], a.scale, -lb))};
#pragma unroll
      for (int e = 0; e < 4; ++e) ab[4 * nb + e] = h == 0 ? p[e] : __fadd_rn(ab[4 * nb + e], p[e]);
    }
    if (h == H - 1) {  // key tile j's factor values: mean_h p + I, 0 past S
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * SAL_TILE + nb * 8 + 2 * t4 + (e & 1);
          const int row = e & 2 ? rowb : rowa;
          const float v = col < S ? __fadd_rn(__fmul_rn(ab[4 * nb + e], a.inv_h),
                                              row == col ? 1.0f : 0.0f)
                                  : 0.0f;
          if (pass == 0) {
            if (e & 2)
              rs1 += v;
            else
              rs0 += v;
          } else if (row < S && col < S) {
            a.out[(size_t(b) * S + row) * S + col] = __fdiv_rn(v, e & 2 ? rs1 : rs0);
          }
        }
      }
      if (pass == 0 && j == T - 1) {  // the rows' sums over the 4 lanes
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
      }
    }
    __syncthreads();  // the stage is read before it is refilled
  }
}

bool views_ok(const long long* st, const void* q, const void* k, int B, int H, int S) {
  if (B <= 0 || H <= 0 || S <= 0) return false;
  if ((long long)sal_tiles(S) * H * B > INT32_MAX) return false;
  for (int i = 0; i < 6; ++i)
    if (st[i] % 8 != 0) return false;
  return (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)) % 16 == 0;
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
  if (!views_ok(strides, q, k, B, H, S) || !(scale > 0.0f) || (!row && carry == nullptr))
    return cudaErrorInvalidValue;
  const CarryArgs a{View{static_cast<const bf16*>(q), strides[0], strides[1], strides[2]},
                    View{static_cast<const bf16*>(k), strides[3], strides[4], strides[5]},
                    static_cast<const float*>(lse),
                    static_cast<const float*>(carry),
                    static_cast<float*>(out),
                    B, H, S, scale};
  const int grid = sal_tiles(S) * H * B;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row)
    flash_sal_carry_kernel<true><<<grid, SAL_THREADS, 0, st>>>(a);
  else
    flash_sal_carry_kernel<false><<<grid, SAL_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// q, k, lse as mst_flash_carry; out: [B, S, S] f32 contiguous, the factor
// rownorm(mean_h p_h + I) of each slice. H * 8.25 KB + 16 KB of shared
// memory: H <= 25.
extern "C" int mst_flash_abnar(const void* q, const void* k, const void* lse, void* out,
                               const long long* strides, int B, int H, int S, float scale,
                               void* stream) {
  using namespace mst;
  if (!views_ok(strides, q, k, B, H, S) || !(scale > 0.0f)) return cudaErrorInvalidValue;
  const size_t smem = abnar_smem(H);
  cudaError_t err = allow_smem(flash_sal_abnar_kernel, smem);
  if (err != cudaSuccess) return err;
  const AbnarArgs a{View{static_cast<const bf16*>(q), strides[0], strides[1], strides[2]},
                    View{static_cast<const bf16*>(k), strides[3], strides[4], strides[5]},
                    static_cast<const float*>(lse),
                    static_cast<float*>(out),
                    B, H, S, scale, 1.0f / float(H)};
  flash_sal_abnar_kernel<<<sal_tiles(S) * B, SAL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaGetLastError();
}

// The launch geometry of mst_flash_carry's ROW form (part 0), its carry
// form (1) and mst_flash_abnar (2): geo = {rows of a tile, threads, tiles,
// blocks, the tiles of the other operand a block walks (Abnar: (key
// tile, head) steps of both passes), shared memory bytes}
// (`ops/attention.flash_sal_launch` mirrors it).
extern "C" int mst_flash_sal_geometry(int B, int H, int S, int part, int* geo) {
  using namespace mst;
  if (part < 0 || part > 2 || B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  const long long T = sal_tiles(S);
  const long long blocks = part == 2 ? T * B : T * H * B;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const int g[6] = {SAL_TILE, SAL_THREADS, int(T), int(blocks),
                    part == 0 ? 1 : part == 1 ? int(T) : int(2 * T * H),
                    part == 2 ? int(abnar_smem(H)) : SAL_CARRY_SMEM};
  for (int i = 0; i < 6; ++i) geo[i] = g[i];
  return cudaSuccess;
}
