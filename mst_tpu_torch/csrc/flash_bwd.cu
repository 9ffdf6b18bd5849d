// flash_bwd: the backward of flash_fwd.cu, from the saved q, k, v [B, H, S,
// 64] bf16, o, the upstream gradient do and the base-2 LSE rows [B, H, S]
// f32 -> dq, dk, dv [B, H, S, 64] bf16 (every operand with its own element
// strides per batch, head and row; unit column stride).
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
// for its query tile, and writes it for the dk/dv kernel.
//
// The split follows the blocked Pallas pair, which is deterministic: no
// float atomics, so two runs give the same bits, and the one pair serves
// every S (the single-program kernel is a VMEM artifact):
//   dq kernel:   one block of 4 warps per (b, h, 64-query tile); q, do in
//                shared memory, the 64-key tiles of k and v double-buffered
//                by cp.async (54 KB); s, dp and dq in registers;
//   dk/dv kernel: one block per (b, h, 64-key tile); k, v in shared memory,
//                the 64-query tiles of q and do (with their LSE and delta)
//                double-buffered; s^T, dp^T, dk and dv in registers.
// Each kernel forms s and dp, so the pair runs seven S^2 hd products where
// one program would run five; that buys no cross-block sum. As in
// flash_fwd.cu the accumulators of one mma.sync product, packed to bf16,
// are the a fragments of the next (P for dv, ds for dq and dk). Rows past S
// are zero-filled by the copies; their p is 0 (keys masked, queries given
// LSE +1e30 as the Pallas padding does), so the ragged edge adds nothing,
// and nothing past S is written.
//
// Bound on the H100: at [64, 6, 1370, 64] (the B = 2 train step) the
// seven products are 14 S^2 hd B H = 646 GFLOP, 0.65 ms at 989 TFLOP/s,
// against 0.54 GB of operands (0.16 ms at 3.35 TB/s): compute-bound.
#include "common.cuh"

namespace mst {
namespace {

constexpr int HD = 64;
constexpr int BT = 64;        // rows per block and per streamed tile
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int LDT = HD + 8;
constexpr int TILE = BT * LDT;
constexpr float NEG_INF = -1e30f;
static_assert(BT == HD, "a tile's 64 rows are also the 8 n-tiles of its products");

struct View {
  const bf16* p;
  long long sb, sh, ss;
};

struct OutView {
  bf16* p;
  long long sb, sh, ss;
};

__device__ inline void load_tile(bf16* dst, const View& v, int b, int h, int r0, int S, int tid) {
  const bf16* base = v.p + b * v.sb + h * v.sh;
  for (int c = tid; c < BT * (HD / 8); c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int row = r0 + r;
    const bool in = row < S;
    cp_async16(dst + r * LDT + col, in ? base + row * v.ss + col : v.p, in ? 16 : 0);
  }
}

__device__ inline void zero(float (&x)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.0f;
}

// acc[n] (16 rows x 64 columns) = A[r0 .. r0 + 16][:] . B^T where A and B
// are [64][LDT] row-major shared tiles (rows of B are the columns of acc).
__device__ inline void product_t(float (&acc)[HD / 8][4], const bf16* A, const bf16* B, int r0,
                                 int g, int t) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];
    frag_a(a, A, LDT, r0, kk, g, t);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t b0, b1;
      frag_b_t(b0, b1, B, LDT, n * 8, kk, g, t);
      mma_16816(acc[n], a, b0, b1);
    }
  }
}

// acc[n] += bf16(X) . B, X the 16 x 64 f32 accumulators of a product (its
// columns are the k of this one), B a [64][LDT] row-major tile over k.
__device__ inline void product_acc(float (&acc)[HD / 8][4], const float (&x)[HD / 8][4],
                                   const bf16* B, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const uint32_t a[4] = {pack_bf16x2(x[2 * kc][0], x[2 * kc][1]),
                           pack_bf16x2(x[2 * kc][2], x[2 * kc][3]),
                           pack_bf16x2(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                           pack_bf16x2(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t b0, b1;
      frag_b(b0, b1, B, LDT, kc * 16, n * 8, g, t);
      mma_16816(acc[n], a, b0, b1);
    }
  }
}

// Rows g and g + 8 of a warp's 16 x 64 f32 accumulators, in bf16.
__device__ inline void store_rows(const OutView& out, int b, int h, int ra, int S,
                                  const float (&x)[HD / 8][4], int t) {
  bf16* base = out.p + b * out.sb + h * out.sh;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(base + ra * out.ss + col) = pack_bf16x2(x[n][0], x[n][1]);
    if (ra + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (ra + 8) * out.ss + col) = pack_bf16x2(x[n][2], x[n][3]);
  }
}

// Grid: one block per (b, h, 64-query tile). Also writes delta [B, H, S].
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(View q, View k, View v, View o, View dout, OutView dq,
                    const float* __restrict__ lse, float* __restrict__ delta, int H, int S,
                    int tiles, float scale, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + TILE;      // do
  bf16* Ks = Ds + TILE;      // 2 stages
  bf16* Vs = Ks + 2 * TILE;  // 2 stages
  float* Lrow = reinterpret_cast<float*>(Vs + 2 * TILE);  // [64] lse
  float* Drow = Lrow + BT;                                 // [64] delta

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int q0 = tile * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int nkt = (S + BT - 1) / BT;

  load_tile(Qs, q, b, h, q0, S, tid);
  load_tile(Ds, dout, b, h, q0, S, tid);
  load_tile(Ks, k, b, h, 0, S, tid);
  load_tile(Vs, v, b, h, 0, S, tid);
  cp_async_commit();

  // delta = rowsum(do * o) of the tile's rows: two threads per row, 32
  // columns each, straight from device memory while the copies run.
  {
    const int r = tid >> 1, c0 = (tid & 1) * 32;
    const int row = q0 + r;
    float sum = 0.0f;
    if (row < S) {
      const bf16* orow = o.p + b * o.sb + h * o.sh + row * o.ss + c0;
      const bf16* drow = dout.p + b * dout.sb + h * dout.sh + row * dout.ss + c0;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        float ov[8], dv[8];
        unpack8_bf16(*reinterpret_cast<const uint4*>(orow + c), ov);
        unpack8_bf16(*reinterpret_cast<const uint4*>(drow + c), dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += ov[e] * dv[e];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) {
      Drow[r] = sum;
      Lrow[r] = row < S ? lse[size_t(bh) * S + row] : 0.0f;
      if (row < S) delta[size_t(bh) * S + row] = sum;
    }
  }
  __syncthreads();
  const float lse0 = Lrow[r0 + g], lse1 = Lrow[r0 + g + 8];
  const float dl0 = Drow[r0 + g], dl1 = Drow[r0 + g + 8];

  float acc[HD / 8][4];
  zero(acc);
  for (int j = 0; j < nkt; ++j) {
    const int st = j & 1;
    if (j + 1 < nkt) {
      load_tile(Ks + (st ^ 1) * TILE, k, b, h, (j + 1) * BT, S, tid);
      load_tile(Vs + (st ^ 1) * TILE, v, b, h, (j + 1) * BT, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * TILE;
    const bf16* Vt = Vs + st * TILE;

    float p[HD / 8][4], dp[HD / 8][4];
    product_t(p, Qs, Kt, r0, g, t);  // s
    product_t(dp, Ds, Vt, r0, g, t);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = j * BT + n * 8 + 2 * t + e < S;
        const float pa = exp2f((in ? p[n][e] * scale : NEG_INF) - lse0);
        const float pb = exp2f((in ? p[n][2 + e] * scale : NEG_INF) - lse1);
        dp[n][e] = pa * (dp[n][e] - dl0) * sm_scale;  // ds
        dp[n][2 + e] = pb * (dp[n][2 + e] - dl1) * sm_scale;
      }
    product_acc(acc, dp, Kt, g, t);  // dq += bf16(ds) k
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows(dq, b, h, q0 + r0 + g, S, acc, t);
}

// Grid: one block per (b, h, 64-key tile).
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(View q, View k, View v, View dout, OutView dk, OutView dv,
                     const float* __restrict__ lse, const float* __restrict__ delta, int H,
                     int S, int tiles, float scale, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;      // 2 stages
  bf16* Ds = Qs + 2 * TILE;  // 2 stages (do)
  float* Lrow = reinterpret_cast<float*>(Ds + 2 * TILE);  // [2][64] lse
  float* Drow = Lrow + 2 * BT;                             // [2][64] delta

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int k0 = tile * BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int nqt = (S + BT - 1) / BT;
  const float* lse_bh = lse + size_t(bh) * S;
  const float* delta_bh = delta + size_t(bh) * S;
  // keys of this lane's rows past S get p = 0
  const bool ka_in = k0 + r0 + g < S, kb_in = k0 + r0 + g + 8 < S;

  load_tile(Ks, k, b, h, k0, S, tid);
  load_tile(Vs, v, b, h, k0, S, tid);
  load_tile(Qs, q, b, h, 0, S, tid);
  load_tile(Ds, dout, b, h, 0, S, tid);
  cp_async_commit();
  if (tid < BT) {  // queries past S: LSE +1e30 (p = 0), delta 0
    Lrow[tid] = tid < S ? lse_bh[tid] : 1e30f;
    Drow[tid] = tid < S ? delta_bh[tid] : 0.0f;
  }

  float dka[HD / 8][4], dva[HD / 8][4];
  zero(dka);
  zero(dva);
  for (int i = 0; i < nqt; ++i) {
    const int st = i & 1;
    if (i + 1 < nqt) {
      const int n0 = (i + 1) * BT;
      load_tile(Qs + (st ^ 1) * TILE, q, b, h, n0, S, tid);
      load_tile(Ds + (st ^ 1) * TILE, dout, b, h, n0, S, tid);
      if (tid < BT) {
        const int row = n0 + tid;
        Lrow[(st ^ 1) * BT + tid] = row < S ? lse_bh[row] : 1e30f;
        Drow[(st ^ 1) * BT + tid] = row < S ? delta_bh[row] : 0.0f;
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + st * TILE;
    const bf16* Dt = Ds + st * TILE;
    const float* L = Lrow + st * BT;
    const float* D = Drow + st * BT;

    // p^T: rows are this block's keys, columns the tile's queries.
    float p[HD / 8][4];
    product_t(p, Ks, Qt, r0, g, t);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lq = L[n * 8 + 2 * t + e];
        p[n][e] = exp2f((ka_in ? p[n][e] * scale : NEG_INF) - lq);
        p[n][2 + e] = exp2f((kb_in ? p[n][2 + e] * scale : NEG_INF) - lq);
      }
    product_acc(dva, p, Dt, g, t);  // dv += bf16(p)^T do
    float dp[HD / 8][4];
    product_t(dp, Vs, Dt, r0, g, t);  // dp^T = v do^T
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = D[n * 8 + 2 * t + e];
        dp[n][e] = p[n][e] * (dp[n][e] - dl) * sm_scale;  // ds^T
        dp[n][2 + e] = p[n][2 + e] * (dp[n][2 + e] - dl) * sm_scale;
      }
    product_acc(dka, dp, Qt, g, t);  // dk += bf16(ds)^T q
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows(dk, b, h, k0 + r0 + g, S, dka, t);
  store_rows(dv, b, h, k0 + r0 + g, S, dva, t);
}

constexpr size_t SMEM = 6 * TILE * sizeof(bf16) + 4 * BT * sizeof(float);

bool strides_ok(const long long* s, int n) {
  for (int i = 0; i < n; ++i)
    if (s[i] % 8) return false;
  return true;
}

View in_view(const void* p, const long long* s) {
  return View{static_cast<const bf16*>(p), s[0], s[1], s[2]};
}

OutView out_view(void* p, const long long* s) {
  return OutView{static_cast<bf16*>(p), s[0], s[1], s[2]};
}

}  // namespace
}  // namespace mst

// q, k, v, o, do, dq: [B, H, S, 64] bf16 with element strides strides[3 i
// .. 3 i + 2] (batch, head, row; host memory) in that order, multiples of
// 8; lse: [B, H, S] f32 (base 2, flash_fwd.cu); delta: [B, H, S] f32 out.
// scale = sm_scale * log2(e).
extern "C" int mst_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* delta, void* dq,
                                const long long* strides, int B, int H, int S, float scale,
                                float sm_scale, void* stream) {
  using namespace mst;
  if (B <= 0 || H <= 0 || S <= 0 || !strides_ok(strides, 18)) return cudaErrorInvalidValue;
  const long long tiles = (S + BT - 1) / BT;
  if (tiles * B * H > INT32_MAX || (long long)B * H * S > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel, SMEM);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<<<unsigned(tiles * B * H), THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      in_view(q, strides), in_view(k, strides + 3), in_view(v, strides + 6),
      in_view(o, strides + 9), in_view(dout, strides + 12), out_view(dq, strides + 15),
      static_cast<const float*>(lse), static_cast<float*>(delta), H, S, int(tiles), scale,
      sm_scale);
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
  if (B <= 0 || H <= 0 || S <= 0 || !strides_ok(strides, 18)) return cudaErrorInvalidValue;
  const long long tiles = (S + BT - 1) / BT;
  if (tiles * B * H > INT32_MAX || (long long)B * H * S > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel, SMEM);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<<<unsigned(tiles * B * H), THREADS, SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      in_view(q, strides), in_view(k, strides + 3), in_view(v, strides + 6),
      in_view(dout, strides + 9), out_view(dk, strides + 12), out_view(dv, strides + 15),
      static_cast<const float*>(lse), static_cast<const float*>(delta), H, S, int(tiles), scale,
      sm_scale);
  return cudaGetLastError();
}
