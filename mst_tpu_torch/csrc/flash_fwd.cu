// flash_fwd: softmax attention over q, k, v [B, H, S, 64] bf16 (element
// strides per batch, head and row; unit column stride) -> o [B, H, S, 64]
// bf16, and with `lse` set (training) the base-2 log-sum-exp rows [B, H, S]
// f32 that flash_bwd.cu rebuilds p from.
//
// Replaces both forwards of mst_tpu/ops/attention.py: `_fwd_single_kernel`
// :152 (the whole sequence in VMEM, S <= SINGLE_BLOCK_MAX_KV = 1536) and
// `_fwd_kernel` :96 (the blocked online softmax above it), both launched
// from `_flash_fwd` :204. Same math and rounding points:
//   s = q.k^T * (sm_scale * log2(e)) in f32, keys j >= S set to NEG_INF;
//   m_new = max(m_prev, rowmax(s)), alpha = exp2(m_prev - m_new);
//   p = exp2(s - m_new) in f32, l = alpha * l + rowsum(p) of the f32 p;
//   acc = alpha * acc + bf16(p) . v with f32 sums;
//   o = acc * (l > 0 ? 1 / l : 0), rounded to bf16; lse = m + log2(l).
// The JAX LSE is natural-log (the base-2 one / log2(e)); this one stays in
// base 2, which only the port's backward reads.
//
// The split at 1536 exists because a TPU program keeps its blocks in VMEM;
// on the H100 one kernel covers every S. One block of 4 warps owns one
// (b, h, 64-query tile), each warp 16 query rows; it walks the keys in
// tiles of 64, double-buffered in shared memory by cp.async (Q 9 KB, K and
// V 2 x 9 KB each: 46 KB, so four blocks fit an SM). Keys past S are
// zero-filled by the copy and masked in the softmax, so nothing is padded
// in device memory (the `_pad_to` copies of the blocked Pallas path). The
// scores, p and the output stay in registers: mma.sync m16n8k16 leaves
// each lane two rows' worth of columns, the row max and sum are reduced
// over the 4 lanes of a row by shuffles, and the f32 accumulators of P,
// packed to bf16, are the a fragments of the P.V product (common.cuh
// `mma_16816`). Neither scores nor probabilities touch device memory.
//
// Bound on the H100: at [256, 6, 1370, 64] (serving, B = 8 x 32 slices)
// the two products are 4 S^2 hd B H = 738 GFLOP of tensor-core work, 0.75
// ms at 989 TFLOP/s, against 1.08 GB of q, k, v and o (0.32 ms at 3.35
// TB/s): compute-bound. mma.sync reaches a part of the wgmma rate; wgmma
// and TMA are later work.
#include "common.cuh"

namespace mst {
namespace {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int LDT = HD + 8;   // bf16 row stride of the shared tiles
constexpr int TILE = BQ * LDT;
constexpr float NEG_INF = -1e30f;

struct View {  // one [B, H, S, 64] operand
  const bf16* p;
  long long sb, sh, ss;
};

// Rows [r0, r0 + 64) of head (b, h) into a [64][LDT] shared tile, 16 bytes
// per cp.async, rows >= S zero-filled (no global read).
__device__ inline void load_tile(bf16* dst, const View& v, int b, int h, int r0, int S, int tid) {
  const bf16* base = v.p + b * v.sb + h * v.sh;
  for (int c = tid; c < BQ * (HD / 8); c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int row = r0 + r;
    const bool in = row < S;
    cp_async16(dst + r * LDT + col, in ? base + row * v.ss + col : v.p, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(View q, View k, View v, bf16* __restrict__ o, long long osb, long long osh,
                 long long oss, float* __restrict__ lse, int H, int S, int tiles,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE;      // 2 stages
  bf16* Vs = Ks + 2 * TILE;  // 2 stages

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int q0 = tile * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;  // this warp's rows in the tile
  const int nkt = (S + BK - 1) / BK;

  load_tile(Qs, q, b, h, q0, S, tid);
  load_tile(Ks, k, b, h, 0, S, tid);
  load_tile(Vs, v, b, h, 0, S, tid);
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows g and g + 8
  float l0 = 0.0f, l1 = 0.0f;        // this lane's part of their sums

  for (int j = 0; j < nkt; ++j) {
    const int st = j & 1;
    if (j + 1 < nkt) {  // the next tile streams in while this one is used
      load_tile(Ks + (st ^ 1) * TILE, k, b, h, (j + 1) * BK, S, tid);
      load_tile(Vs + (st ^ 1) * TILE, v, b, h, (j + 1) * BK, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * TILE;
    const bf16* Vt = Vs + st * TILE;

    // s = Q K^T over the tile's 64 keys: 8 n-tiles of 8 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      frag_a(a, Qs, LDT, r0, kk, g, t);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        frag_b_t(b0, b1, Kt, LDT, n * 8, kk, g, t);
        mma_16816(s[n], a, b0, b1);
      }
    }

    // Scale, mask the ragged edge, online softmax of rows g and g + 8.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = j * BK + n * 8 + 2 * t + e < S;
        s[n][e] = in ? s[n][e] * scale : NEG_INF;
        s[n][2 + e] = in ? s[n][2 + e] * scale : NEG_INF;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = exp2f(s[n][e] - mn0);
        s[n][2 + e] = exp2f(s[n][2 + e] - mn1);
        ps0 += s[n][e];
        ps1 += s[n][2 + e];
      }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // acc += bf16(P) V: keys 16 kc .. 16 kc + 15 are n-tiles 2 kc, 2 kc + 1.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, Vt, LDT, kc * 16, n * 8, g, t);
        mma_16816(acc[n], a, b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled two iterations on
  }
  cp_async_wait<0>();

  // The row sums over the 4 lanes of a row, then o = acc / l in bf16.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  const int qa = q0 + r0 + g, qb = qa + 8;
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (qa < S)
      *reinterpret_cast<uint32_t*>(ob + qa * oss + col) =
          pack_bf16x2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (qb < S)
      *reinterpret_cast<uint32_t*>(ob + qb * oss + col) =
          pack_bf16x2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + size_t(bh) * S;
    if (qa < S) lrow[qa] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (qb < S) lrow[qb] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
}

constexpr size_t SMEM = 5 * TILE * sizeof(bf16);  // Q, 2 K, 2 V

}  // namespace
}  // namespace mst

// q, k, v, o: [B, H, S, 64] bf16 with the element strides strides[3 i ..
// 3 i + 2] (batch, head, row) of tensor i in the order q, k, v, o (host
// memory), each a multiple of 8, the column stride 1; lse: [B, H, S] f32 or
// NULL; scale = sm_scale * log2(e).
extern "C" int mst_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const long long* strides, int B, int H, int S, float scale,
                             void* stream) {
  using namespace mst;
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  const long long tiles = (S + BQ - 1) / BQ;
  if (tiles * B * H > INT32_MAX || (long long)B * H * S > INT32_MAX) return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_kernel, SMEM);
  if (err != cudaSuccess) return err;
  const View vq{static_cast<const bf16*>(q), strides[0], strides[1], strides[2]};
  const View vk{static_cast<const bf16*>(k), strides[3], strides[4], strides[5]};
  const View vv{static_cast<const bf16*>(v), strides[6], strides[7], strides[8]};
  flash_fwd_kernel<<<unsigned(tiles * B * H), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      vq, vk, vv, static_cast<bf16*>(o), strides[9], strides[10], strides[11],
      static_cast<float*>(lse), H, S, int(tiles), scale);
  return cudaGetLastError();
}
