// mhsa_bwd: the attention core of the backward, per slice and head, from the
// forward's saved residuals: qkv [N*S, 3E] bf16, o [N*S, E] bf16, the
// upstream gradient do [N*S, E] bf16 and the base-2 log-sum-exp rows
// lse [N*S, heads] f32 written by mhsa.cu -> dqkv [N*S, 3E] bf16.
//
// Replaces the per-head loop of `_attn_bwd_kernel` in
// mst_tpu/ops/fused_block.py, with its math and rounding points:
//   s = q k^T * (log2(e) / sqrt(hd)),  p = exp2(s - b)   (f32, normalised)
//   dv = bf16(bf16(p)^T do),  dp = do v^T,  delta = rowdot(do, o)
//   ds = bf16((dp - delta) * p / sqrt(hd))   (p in f32 here)
//   dq = bf16(ds k),  dk = bf16(ds^T q)
// Nothing of [S, S] goes to device memory: p is rebuilt from the saved b in
// one exp2 pass.
//
// The TPU kernel held a whole slice in VMEM. On the H100 dq sums over keys
// and dk, dv over queries, so the work is split in two kernels, each of
// whose blocks owns a 32-row tile and sums over the other axis from shared
// memory (158-160 KB at S = 257, hd = 64; 16-row tiles above S = 400):
//   dq kernel:  (slice, head, 32 queries) - q, do tiles, all of k and v, the
//               f32 score rows s and dp; also writes delta for the next one;
//   dkv kernel: (slice, head, 32 keys) - k, v tiles, all of q and do, the
//               transposed score rows s^T and dp^T.
// Both compute s and dp, so the pair runs seven [S, S] x hd products where
// one fused kernel would run five; that buys no [S, S] round trip and no
// cross-block sum. Keys or queries past S are zero-filled and get
// p = ds = 0, so the ragged edge adds nothing to any sum. Bound on the H100:
// tensor-core FLOPs (~91 GFLOP for the pair at N = 256, S = 257, 6 heads)
// and the shared-memory traffic of the WMMA fragment loads.
//
// RoPE (`has_rope` of `_attn_bwd_kernel`, :754-766 and :806-814; the DINOv3
// train step) is the template flag ROPE of both kernels. The saved qkv is
// pre-rope, as in JAX, so each kernel rotates q and k where it loads them
// (`rope8`: the dq kernel its q tile and all of k, the dk/dv kernel its k
// tile and all of q), which recomputes the forward's bf16 rotated values;
// the rest of the body runs on them unchanged. The adjoint takes dq and dk
// back through the rotation in the f32 staging epilogue before the bf16
// store (`rope_adjoint8`, with JAX's bf16 rounding of dq_r * sin); dv is
// not rotated. The [S, 64] f32 tables are read per element and stay in L2.
#include "common.cuh"

namespace mst {
namespace {

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int LDQ = HD + 8;   // bf16 stride of q / k / v / do rows
constexpr int LDO = HD + 4;   // f32 stride of the output staging tiles
constexpr int MAX_S = 512;
constexpr int PER_LANE = MAX_S / 32;
constexpr size_t SMEM_CAP = 227 * 1024;

__host__ __device__ inline int pad16(int s) { return (s + 15) & ~15; }
__host__ __device__ inline size_t maxz(size_t a, size_t b) { return a > b ? a : b; }

// Shared layout of both kernels: two bf16 tiles of BT rows, two bf16
// whole-sequence blocks of sp rows, two f32 [BT][sp + 4] score blocks, two
// f32 vectors. The output staging reuses dead space: the dq kernel's tile
// goes over the score rows s, the dk/dv kernel's two tiles over q.
struct Layout {
  size_t t0, t1, all0, all1, s, d, v0, v1, total;
};

__host__ __device__ inline Layout layout(int bt, int S) {
  const int sp = pad16(S);
  const size_t tile = size_t(bt) * LDQ * sizeof(bf16);
  const size_t all = size_t(sp) * LDQ * sizeof(bf16);
  const size_t stage = 2 * size_t(bt) * LDO * sizeof(float);
  // f32 score rows of stride sp + 4; at least LDO wide, because the dq
  // kernel stages its output tile in the first block
  const size_t sc = size_t(bt) * (sp + 4 > LDO ? sp + 4 : LDO) * sizeof(float);
  Layout L;
  L.t0 = 0;
  L.t1 = L.t0 + tile;
  L.all0 = L.t1 + tile;
  L.all1 = L.all0 + maxz(all, stage);
  L.s = L.all1 + all;
  L.d = L.s + sc;
  const size_t vec = size_t(sp > bt ? sp : bt) * sizeof(float);
  L.v0 = L.d + sc;
  L.v1 = L.v0 + vec;
  L.total = L.v1 + vec;
  return L;
}

// rows [r0, r0 + rows) of one head into shared memory, zero past S; with
// ROPE each row rotated by its row of the [S, 64] f32 tables rcos / rsin.
template <bool ROPE = false>
__device__ inline void load_rows(bf16* dst, const bf16* src, size_t stride, int r0,
                                 int rows, int S, int tid, const float* rcos = nullptr,
                                 const float* rsin = nullptr) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < rows * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    const int q = r0 + r;
    uint4 v = zero;
    if (q < S) {
      v = *reinterpret_cast<const uint4*>(src + q * stride + col);
      if (ROPE) v = rope8(v, rcos + q * HD + col, rsin + q * HD + col);
    }
    *reinterpret_cast<uint4*>(dst + r * LDQ + col) = v;
  }
}

// dst[BT][ld] (f32) = A[BT] . B[sp]^T over hd, times mul, for two pairs at
// once (which = 0: (a0, b0) -> dst0, 1: (a1, b1) -> dst1).
template <int BT>
__device__ inline void scores(const bf16* a0, const bf16* b0, float* dst0, float mul0,
                              const bf16* a1, const bf16* b1, float* dst1, int sp,
                              int ld, int warp) {
  const int tiles_n = sp / 16;
  const int per = (BT / 16) * tiles_n;
  for (int t = warp; t < 2 * per; t += THREADS / 32) {
    const int which = t / per, tt = t % per;
    const int ti = tt / tiles_n, tj = tt % tiles_n;
    const bf16* A = which ? a1 : a0;
    const bf16* B = which ? b1 : b0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + ti * 16 * LDQ + kk, LDQ);
      wmma::load_matrix_sync(fb, B + tj * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    if (which == 0)
      for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= mul0;
    wmma::store_matrix_sync((which ? dst1 : dst0) + ti * 16 * ld + tj * 16, acc, ld,
                            wmma::mem_row_major);
  }
}

template <int BQ, bool ROPE>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ o,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ delta, bf16* __restrict__ dqkv,
                   const float* __restrict__ rcos, const float* __restrict__ rsin, int S,
                   int E, float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(BQ, S);
  const int sp = pad16(S), lds = sp + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.t0);
  bf16* DOs = reinterpret_cast<bf16*>(smem + L.t1);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.all0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.all1);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Ds = reinterpret_cast<float*>(smem + L.d);
  float* Bs = reinterpret_cast<float*>(smem + L.v0);
  float* DLs = reinterpret_cast<float*>(smem + L.v1);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row3 = size_t(3) * E;
  const bf16* base = qkv + size_t(n) * S * row3 + h * HD;
  const bf16* dobase = dout + size_t(n) * S * E + h * HD;
  const bf16* obase = o + size_t(n) * S * E + h * HD;

  load_rows<ROPE>(Qs, base, row3, q0, BQ, S, tid, rcos, rsin);
  load_rows(DOs, dobase, E, q0, BQ, S, tid);
  load_rows<ROPE>(Ks, base + E, row3, 0, sp, S, tid, rcos, rsin);
  load_rows(Vs, base + 2 * E, row3, 0, sp, S, tid);
  // delta = rowdot(do, o) in f32 and the saved b, one warp per query row.
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int q = q0 + r;
    float dl = 0.0f, b = 0.0f;
    if (q < S) {
      const float2 d2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dobase + size_t(q) * E + 2 * lane));
      const float2 o2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(obase + size_t(q) * E + 2 * lane));
      dl = d2.x * o2.x + d2.y * o2.y;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dl += __shfl_xor_sync(0xffffffffu, dl, off);
      b = lse[(size_t(n) * S + q) * H + h];
    }
    if (lane == 0) {
      DLs[r] = dl;
      Bs[r] = b;
      if (q < S) delta[(size_t(n) * S + q) * H + h] = dl;
    }
  }
  __syncthreads();

  scores<BQ>(Qs, Ks, Ss, scale_log2, DOs, Vs, Ds, sp, lds, warp);  // s, dp
  __syncthreads();

  // ds = (dp - delta) * exp2(s - b) * scale, bf16 over the first half of
  // dp's own row (each warp reads its whole row before writing it).
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const float* srow = Ss + r * lds;
    float* drow = Ds + r * lds;
    const float b = Bs[r], dl = DLs[r];
    float v[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < S ? (drow[j] - dl) * exp2f(srow[j] - b) * scale : 0.0f;
    }
    __syncwarp();
    bf16* dsrow = reinterpret_cast<bf16*>(drow);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      if (j < sp) dsrow[j] = __float2bfloat16(v[i]);
    }
  }
  __syncthreads();

  // dq = ds k (k rotated with ROPE), staged in f32 over the (dead) score
  // rows; with ROPE the adjoint of the rotation before the bf16 store.
  const bf16* DSs = reinterpret_cast<const bf16*>(Ds);
  const int ldp = 2 * lds;
  float* Os = Ss;
  for (int t = warp; t < (BQ / 16) * (HD / 16); t += THREADS / 32) {
    const int ti = t / (HD / 16), tj = t % (HD / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < sp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, DSs + ti * 16 * ldp + kk, ldp);
      wmma::load_matrix_sync(fb, Ks + kk * LDQ + tj * 16, LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(Os + ti * 16 * LDO + tj * 16, acc, LDO, wmma::mem_row_major);
  }
  __syncthreads();
  for (int g = tid; g < BQ * (HD / 8); g += THREADS) {
    const int r = g / (HD / 8), c = (g % (HD / 8)) * 8;
    const int q = q0 + r;
    if (q >= S) continue;
    float v[8];
    const float* d = Os + r * LDO + c;
    if (ROPE) rope_adjoint8(d, rcos + q * HD + c, rsin + q * HD + c, v);
    *reinterpret_cast<uint4*>(dqkv + (size_t(n) * S + q) * row3 + h * HD + c) =
        pack8_bf16(ROPE ? v : d);
  }
}

template <int BKV, bool ROPE>
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dqkv, const float* __restrict__ rcos,
                    const float* __restrict__ rsin, int S, int E, float scale_log2,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(BKV, S);
  const int sp = pad16(S), lds = sp + 4;
  bf16* Kt = reinterpret_cast<bf16*>(smem + L.t0);
  bf16* Vt = reinterpret_cast<bf16*>(smem + L.t1);
  bf16* Qa = reinterpret_cast<bf16*>(smem + L.all0);
  bf16* DOa = reinterpret_cast<bf16*>(smem + L.all1);
  float* Ss = reinterpret_cast<float*>(smem + L.s);   // s^T [key][query]
  float* Ds = reinterpret_cast<float*>(smem + L.d);   // dp^T
  float* Bq = reinterpret_cast<float*>(smem + L.v0);  // b per query
  float* DLq = reinterpret_cast<float*>(smem + L.v1);  // delta per query

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, n = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row3 = size_t(3) * E;
  const bf16* base = qkv + size_t(n) * S * row3 + h * HD;
  const bf16* dobase = dout + size_t(n) * S * E + h * HD;

  load_rows<ROPE>(Kt, base + E, row3, k0, BKV, S, tid, rcos, rsin);
  load_rows(Vt, base + 2 * E, row3, k0, BKV, S, tid);
  load_rows<ROPE>(Qa, base, row3, 0, sp, S, tid, rcos, rsin);
  load_rows(DOa, dobase, E, 0, sp, S, tid);
  for (int j = tid; j < sp; j += THREADS) {
    const size_t idx = (size_t(n) * S + j) * H + h;
    Bq[j] = j < S ? lse[idx] : 0.0f;
    DLq[j] = j < S ? delta[idx] : 0.0f;
  }
  __syncthreads();

  scores<BKV>(Kt, Qa, Ss, scale_log2, Vt, DOa, Ds, sp, lds, warp);  // s^T, dp^T
  __syncthreads();

  // p^T and ds^T, both bf16 over the first half of their own rows.
  for (int r = warp; r < BKV; r += THREADS / 32) {
    float* srow = Ss + r * lds;
    float* drow = Ds + r * lds;
    float pv[PER_LANE], dv[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      pv[i] = j < S ? exp2f(srow[j] - Bq[j]) : 0.0f;
      dv[i] = j < S ? (drow[j] - DLq[j]) * pv[i] * scale : 0.0f;
    }
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(srow);
    bf16* dsrow = reinterpret_cast<bf16*>(drow);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      if (j < sp) {
        prow[j] = __float2bfloat16(pv[i]);
        dsrow[j] = __float2bfloat16(dv[i]);
      }
    }
  }
  __syncthreads();

  // dv = p^T do and dk = ds^T q, [BKV x 64] each: tile t < per is dv, the
  // rest dk; each warp keeps its BKV / 16 tiles in registers until q and do
  // are dead, then stages them in q's place.
  constexpr int per = (BKV / 16) * (HD / 16);
  constexpr int NT = 2 * per / (THREADS / 32);
  const int ldp = 2 * lds;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int t = warp + i * (THREADS / 32);
    const int which = t / per, tt = t % per;
    const int ti = tt / (HD / 16), tj = tt % (HD / 16);
    const bf16* A = reinterpret_cast<const bf16*>(which ? Ds : Ss);
    const bf16* B = which ? Qa : DOa;
    wmma::fill_fragment(acc[i], 0.0f);
    for (int kk = 0; kk < sp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, A + ti * 16 * ldp + kk, ldp);
      wmma::load_matrix_sync(fb, B + kk * LDQ + tj * 16, LDQ);
      wmma::mma_sync(acc[i], fa, fb, acc[i]);
    }
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem + L.all0);  // [2][BKV][LDO]
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int t = warp + i * (THREADS / 32);
    const int which = t / per, tt = t % per;
    const int ti = tt / (HD / 16), tj = tt % (HD / 16);
    wmma::store_matrix_sync(stage + (which * BKV + ti * 16) * LDO + tj * 16, acc[i], LDO,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int g = tid; g < 2 * BKV * (HD / 8); g += THREADS) {
    const int which = g / (BKV * (HD / 8)), gg = g % (BKV * (HD / 8));
    const int r = gg / (HD / 8), c = (gg % (HD / 8)) * 8;
    const int key = k0 + r;
    if (key >= S) continue;
    // which 0: dv -> columns 2E + h*64; which 1: dk -> E + h*64 (with ROPE
    // through the rotation's adjoint first)
    const size_t col = (which ? size_t(E) : size_t(2) * E) + h * HD + c;
    const float* d = stage + (which * BKV + r) * LDO + c;
    float v[8];
    if (ROPE && which) rope_adjoint8(d, rcos + key * HD + c, rsin + key * HD + c, v);
    *reinterpret_cast<uint4*>(dqkv + (size_t(n) * S + key) * row3 + col) =
        pack8_bf16(ROPE && which ? v : d);
  }
}

template <int BT, bool ROPE>
cudaError_t launch_pair(const bf16* qkv, const bf16* o, const bf16* dout, const float* lse,
                        float* delta, bf16* dqkv, const float* rcos, const float* rsin,
                        int N, int S, int E, int H, float scale_log2, float scale,
                        cudaStream_t st) {
  const size_t smem = layout(BT, S).total;
  cudaError_t err = allow_smem(mhsa_bwd_dq_kernel<BT, ROPE>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(mhsa_bwd_dkv_kernel<BT, ROPE>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BT - 1) / BT, H, N);
  mhsa_bwd_dq_kernel<BT, ROPE><<<grid, THREADS, smem, st>>>(qkv, o, dout, lse, delta, dqkv,
                                                             rcos, rsin, S, E, scale_log2,
                                                             scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mhsa_bwd_dkv_kernel<BT, ROPE><<<grid, THREADS, smem, st>>>(qkv, dout, lse, delta, dqkv,
                                                              rcos, rsin, S, E, scale_log2,
                                                              scale);
  return cudaGetLastError();
}

template <int BT>
cudaError_t launch_rope(const bf16* qkv, const bf16* o, const bf16* dout, const float* lse,
                        float* delta, bf16* dqkv, const float* rcos, const float* rsin,
                        int N, int S, int E, int H, float scale_log2, float scale,
                        cudaStream_t st) {
  return rcos != nullptr
             ? launch_pair<BT, true>(qkv, o, dout, lse, delta, dqkv, rcos, rsin, N, S, E, H,
                                     scale_log2, scale, st)
             : launch_pair<BT, false>(qkv, o, dout, lse, delta, dqkv, rcos, rsin, N, S, E,
                                      H, scale_log2, scale, st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* ov = static_cast<const bf16*>(o);
  const bf16* d = static_cast<const bf16*>(dout);
  const float* b = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16* out = static_cast<bf16*>(dqkv);
  const float* rc = static_cast<const float*>(rope_cos);
  const float* rs = static_cast<const float*>(rope_sin);
  if (layout(32, S).total <= SMEM_CAP)
    return launch_rope<32>(q, ov, d, b, dl, out, rc, rs, N, S, E, num_heads, scale_log2,
                           scale, st);
  return launch_rope<16>(q, ov, d, b, dl, out, rc, rs, N, S, E, num_heads, scale_log2,
                         scale, st);
}
