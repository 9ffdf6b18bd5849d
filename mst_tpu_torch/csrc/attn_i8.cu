// attn_i8: the attention core of a W8A8 attention sub-layer with int8
// scores (variant B) or int8 scores and context (variant C), head dim 64.
//
// Replaces the attention core of `tools/bench_attn_i8.py` `make_kernel`
// (:57), variants B and C (queue B row 19; `tools/debug_attn_i8.py` :53
// launches the same kernels). The rest of that kernel runs on the shipped
// W8A8 kernels: `ln_gemm_i8.cu` makes the codes of q, k (and v) from the
// static qkv product, `quant_rows.cu` and `gemm_i8_residual.cu` the proj.
// Variant A is the shipped chain with `mhsa.cu` as its core. The math, as
// the tool has it, with scale = log2(e) / sqrt(64):
//   s = f32(int32(qq . kq^T)) * scale, m = rowmax(s);
//   B: p = exp2(s - m), l = sum p (f32), o = (bf16(p) . v) / l, v bf16;
//   C: p = exp2((s - m) + log2(127)) in [0, 127], l = sum p (f32, the
//      unrounded p), pq = rint(p) (half to even), o = f32(int32(pq . vq)) / l;
// o is rounded to bf16 once. Each int32 sum is exact (|qq . kq| <= 64 *
// 127^2, |pq . vq| <= S * 127^2, both < 2^24, so the f32 conversion is too).
//
// Bound on the H100: one (slice, head) at S = 257 is 8.5 M int8 operations
// per product on ~50 KB of codes; at the tool's shapes one product is 13 G
// int8 operations (ViT-S, N = 256, 6 heads) or 6.5 G (giant2, N = 32, 24
// heads) on 63-152 MB of codes, v and o, so bytes bound it (0.019-0.045 ms)
// ahead of the int8 tensor cores (<= 0.013 ms at 1,979 TOP/s) and the
// exponentials (<= 0.026 ms at ~3.9 T/s). The design is mhsa.cu's: one block
// per (64-query tile, head, slice) holds the head's codes and the tile's f32
// score rows in shared memory, one warp per softmax row, P written back over
// its own score row (bf16 for B, int8 for C). The products are
// `mma.sync.m16n8k32.s8.s8.s32` from padded shared tiles: the A fragment of
// m16n8k32 holds 4 consecutive k bytes per register at the byte offsets of
// the bf16 m16n8k16 fragment (common.cuh), and the .col B operand wants 4
// consecutive k of one column per register, which K's rows give for q . k^T.
// For C's pq . vq the k axis is the key axis, so v is staged transposed
// (vt[d][j], int8) by the loads: ldmatrix moves 16-bit elements and cannot
// transpose bytes. P is read back from shared memory into A fragments, so
// nothing is repacked across lanes. B's P . V is the bf16 WMMA product of
// mhsa.cu. Keys are padded to a multiple of 32 (one k step) with zero codes.
#include "common.cuh"

namespace mst {
namespace {

using s8 = signed char;

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;
constexpr int LD8 = HD + 16;  // byte stride of the Q / K code rows
constexpr int LDV = HD + 8;   // bf16 stride of V rows (variant B)
constexpr int LDO = HD + 4;   // f32 stride of B's output staging
constexpr int MAX_S = 512;
constexpr int PER_LANE = MAX_S / 32;
constexpr size_t SMEM_CAP = 227 * 1024;
constexpr float LOG2_127 = 6.988684686772166f;

enum Variant : int { VAR_B = 1, VAR_C = 2 };

__host__ __device__ inline int pad32(int s) { return (s + 31) & ~31; }

struct Layout {
  size_t q, k, v, s, l, total;
};

__host__ __device__ inline Layout layout(int S, bool int8_pv) {
  const int sp = pad32(S);
  Layout L;
  L.q = 0;
  size_t kb = size_t(sp) * LD8;
  const size_t ob = size_t(BQ) * LDO * sizeof(float);  // B stages o in K's place
  if (!int8_pv && ob > kb) kb = ob;
  L.k = L.q + size_t(BQ) * LD8;
  L.v = L.k + ((kb + 15) & ~size_t(15));
  const size_t vb = int8_pv ? size_t(HD) * (sp + 16) : size_t(sp) * LDV * sizeof(bf16);
  L.s = L.v + ((vb + 15) & ~size_t(15));
  L.l = L.s + size_t(BQ) * (sp + 4) * sizeof(float);
  L.total = L.l + size_t(BQ) * sizeof(float);
  return L;
}

__device__ __forceinline__ uint32_t ld_b32(const s8* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c[16 x 8] += a[16 x 32] . b[32 x 8], int8 in, int32 sums.
__device__ __forceinline__ void mma_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16), k bytes [k0, k0 + 32) of a row-major
// int8 tile X of row stride ld bytes (lane g = l / 4, t = l % 4).
__device__ __forceinline__ void frag_a8(uint32_t (&a)[4], const s8* X, int ld, int r0, int k0,
                                        int g, int t) {
  a[0] = ld_b32(X + (r0 + g) * ld + k0 + 4 * t);
  a[1] = ld_b32(X + (r0 + g + 8) * ld + k0 + 4 * t);
  a[2] = ld_b32(X + (r0 + g) * ld + k0 + 16 + 4 * t);
  a[3] = ld_b32(X + (r0 + g + 8) * ld + k0 + 16 + 4 * t);
}

// B fragment of B[k0 .. k0 + 32][n0 .. n0 + 8] with B[k][n] = Y[n][k] (Y
// row-major over n, row stride ld bytes).
__device__ __forceinline__ void frag_b8(uint32_t& b0, uint32_t& b1, const s8* Y, int ld, int n0,
                                        int k0, int g, int t) {
  b0 = ld_b32(Y + (n0 + g) * ld + k0 + 4 * t);
  b1 = ld_b32(Y + (n0 + g) * ld + k0 + 16 + 4 * t);
}

// One (64-query tile, head, slice). INT8_PV = false: variant B, qk holds
// the q and k codes ([M, 2E]) and v is bf16 [M, E]; true: variant C, qk
// holds all of q, k, v as codes ([M, 3E]) and v is unused.
template <bool INT8_PV>
__global__ void __launch_bounds__(THREADS)
attn_i8_kernel(const s8* __restrict__ qk, const bf16* __restrict__ v, bf16* __restrict__ out,
               int S, int E, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(S, INT8_PV);
  const int sp = pad32(S);
  const int lds = sp + 4;
  s8* Qs = reinterpret_cast<s8*>(smem + L.q);
  s8* Ks = reinterpret_cast<s8*>(smem + L.k);
  float* Os = reinterpret_cast<float*>(smem + L.k);  // B: reuses K after scores
  s8* Vt = reinterpret_cast<s8*>(smem + L.v);        // C: [HD][sp + 16]
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);    // B: [sp][LDV]
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  const int ldvt = sp + 16;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t ldq = size_t(INT8_PV ? 3 : 2) * E;  // bytes per code row
  const s8* base = qk + size_t(n) * S * ldq + h * HD;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < BQ * (HD / 16); c += THREADS) {
    const int r = c / (HD / 16), col = (c % (HD / 16)) * 16;
    const int q = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * LD8 + col) =
        q < S ? *reinterpret_cast<const uint4*>(base + q * ldq + col) : zero;
  }
  for (int c = tid; c < sp * (HD / 16); c += THREADS) {
    const int r = c / (HD / 16), col = (c % (HD / 16)) * 16;
    *reinterpret_cast<uint4*>(Ks + r * LD8 + col) =
        r < S ? *reinterpret_cast<const uint4*>(base + r * ldq + E + col) : zero;
    if constexpr (INT8_PV) {
      // v codes transposed: vt[d][j]
      union {
        uint4 u;
        s8 b[16];
      } raw;
      raw.u = r < S ? *reinterpret_cast<const uint4*>(base + r * ldq + 2 * E + col) : zero;
#pragma unroll
      for (int e = 0; e < 16; ++e) Vt[(col + e) * ldvt + r] = raw.b[e];
    }
  }
  if constexpr (!INT8_PV) {
    const bf16* vb = v + size_t(n) * S * E + h * HD;
    for (int c = tid; c < sp * (HD / 8); c += THREADS) {
      const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
      *reinterpret_cast<uint4*>(Vs + r * LDV + col) =
          r < S ? *reinterpret_cast<const uint4*>(vb + size_t(r) * E + col) : zero;
    }
  }
  __syncthreads();

  // Scores s = f32(qq . kq^T) * scale, [BQ][sp] f32, one 16 x 8 tile at a
  // time (two k steps of 32 over the head dim).
  const int tiles_n = sp / 8;
  for (int tt = warp; tt < (BQ / 16) * tiles_n; tt += WARPS) {
    const int ti = tt / tiles_n, tj = tt % tiles_n;
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < HD; kk += 32) {
      uint32_t a[4], b0, b1;
      frag_a8(a, Qs, LD8, ti * 16, kk, g, t4);
      frag_b8(b0, b1, Ks, LD8, tj * 8, kk, g, t4);
      mma_16832(c, a, b0, b1);
    }
    float* s0 = Ss + (ti * 16 + g) * lds + tj * 8 + 2 * t4;
    float* s1 = s0 + 8 * lds;
    s0[0] = __int2float_rn(c[0]) * scale;
    s0[1] = __int2float_rn(c[1]) * scale;
    s1[0] = __int2float_rn(c[2]) * scale;
    s1[1] = __int2float_rn(c[3]) * scale;
  }
  __syncthreads();

  for (int r = warp; r < BQ; r += WARPS) {
    float* srow = Ss + r * lds;
    float pv[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      pv[i] = j < S ? srow[j] : -INFINITY;
      mx = fmaxf(mx, pv[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.0f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      pv[i] = j < S ? (INT8_PV ? exp2f((pv[i] - mx) + LOG2_127) : exp2f(pv[i] - mx)) : 0.0f;
      l += pv[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    __syncwarp();
    if constexpr (INT8_PV) {
      s8* prow = reinterpret_cast<s8*>(srow);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int j = lane + 32 * i;
        if (j < sp) prow[j] = static_cast<s8>(__float2int_rn(pv[i]));
      }
    } else {
      bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int j = lane + 32 * i;
        if (j < sp) prow[j] = __float2bfloat16(pv[i]);
      }
    }
    if (lane == 0) Ls[r] = l;
  }
  __syncthreads();

  if constexpr (INT8_PV) {
    // o = f32(pq . vq) / l from register accumulators, 16 x 8 tiles.
    const s8* Pq = reinterpret_cast<const s8*>(Ss);
    const int ldp = lds * 4;  // bytes per score row
    for (int tt = warp; tt < (BQ / 16) * (HD / 8); tt += WARPS) {
      const int ti = tt / (HD / 8), tj = tt % (HD / 8);
      int c[4] = {0, 0, 0, 0};
      for (int kk = 0; kk < sp; kk += 32) {
        uint32_t a[4], b0, b1;
        frag_a8(a, Pq, ldp, ti * 16, kk, g, t4);
        frag_b8(b0, b1, Vt, ldvt, tj * 8, kk, g, t4);
        mma_16832(c, a, b0, b1);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = ti * 16 + g + 8 * hh;
        const int q = q0 + r;
        if (q >= S) continue;
        const float l = Ls[r];
        const __nv_bfloat162 o2 = __floats2bfloat162_rn(__int2float_rn(c[2 * hh]) / l,
                                                        __int2float_rn(c[2 * hh + 1]) / l);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t(n) * S + q) * E + h * HD + tj * 8 +
                                           2 * t4) = o2;
      }
    }
  } else {
    // o = (bf16(p) . V) / l, the bf16 WMMA product of mhsa.cu.
    const int ldp = 2 * lds;
    const bf16* Ps = reinterpret_cast<const bf16*>(Ss);
    for (int tt = warp; tt < (BQ / 16) * (HD / 16); tt += WARPS) {
      const int ti = tt / (HD / 16), tj = tt % (HD / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < sp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + ti * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(fb, Vs + kk * LDV + tj * 16, LDV);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + ti * 16 * LDO + tj * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncthreads();
    for (int gg = tid; gg < BQ * (HD / 8); gg += THREADS) {
      const int r = gg / (HD / 8), c = (gg % (HD / 8)) * 8;
      const int q = q0 + r;
      if (q >= S) continue;
      float o8[8];
      const float l = Ls[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] = Os[r * LDO + c + e] / l;
      *reinterpret_cast<uint4*>(out + (size_t(n) * S + q) * E + h * HD + c) = pack8_bf16(o8);
    }
  }
}

template <bool INT8_PV>
cudaError_t launch(const s8* qk, const bf16* v, bf16* out, int N, int S, int E, int H,
                   float scale, cudaStream_t st) {
  const size_t bytes = layout(S, INT8_PV).total;
  if (bytes > SMEM_CAP) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attn_i8_kernel<INT8_PV>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, N);
  attn_i8_kernel<INT8_PV><<<grid, THREADS, bytes, st>>>(qk, v, out, S, E, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mst

// variant 1 (B): codes [N*S, 2E] int8 (q | k), v [N*S, E] bf16; variant 2
// (C): codes [N*S, 3E] int8 (q | k | v), v NULL. -> out [N*S, E] bf16;
// scale = log2(e)/sqrt(64). Needs E == 64 * num_heads and S <= 512.
extern "C" int mst_attn_i8(const void* codes, const void* v, void* out, int N, int S, int E,
                           int num_heads, int variant, float scale, void* stream) {
  using namespace mst;
  if (N <= 0 || N > 65535 || S <= 0 || S > MAX_S || num_heads <= 0 || num_heads > 65535 ||
      E != num_heads * HD || (variant == VAR_B) != (v != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const s8* q8 = static_cast<const s8*>(codes);
  bf16* o = static_cast<bf16*>(out);
  if (variant == VAR_B)
    return launch<false>(q8, static_cast<const bf16*>(v), o, N, S, E, num_heads, scale, st);
  if (variant == VAR_C) return launch<true>(q8, nullptr, o, N, S, E, num_heads, scale, st);
  return cudaErrorInvalidValue;
}
