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
// exponentials (<= 0.026 ms at ~3.9 T/s).
//
// The design is attn_variants.cu's (mhsa.cu's forward; the softmax of
// attn_softmax_sm90.cuh):
// - one block, one warpgroup, per (head, slice) walks up to 5 of the head's
//   64-query tiles; thread 0 starts TMA loads of every K (and V) box of the
//   head once, each pair on its own mbarrier, and double-buffers the Q
//   boxes. The codes come from a 3-D map over [N, S, 2E] (B) or [N, S, 3E]
//   (C) in K-major boxes of [64 rows][64 bytes] with 64-byte swizzle (16-
//   byte chunk c of row r at chunk c ^ ((r / 2) % 4)), a 16-row box for a
//   tail of <= 16 keys; keys past S read as zero codes, so they add
//   nothing to any sum;
// - the scores are int8 wgmma m64n64k32 (and m64n16k32 for the tail) into
//   s32 registers, two k steps over the 64-byte head dim, then s =
//   f32(s32) * scale;
// - one pass for S <= 272, two above (as attn_variants.cu); B's P.V is
//   variant D's (mma.sync m16n8k16 from P's bf16 pairs and the bf16 V boxes
//   by `ldmatrix .trans`; register-A wgmma in the two-pass body);
// - C's P.V is int8 mma.sync m16n8k32 with both operands key-major. TMA
//   cannot transpose bytes and `ldmatrix .trans` moves 16-bit elements, so
//   V's codes are transposed on chip once per (head, slice), as soon as
//   their boxes land: 4 x 4 byte blocks by `prmt` into Vt [64 d][keys
//   rounded up to 32, + 16 bytes of pad, so the rows of an `ldmatrix`
//   phase hit distinct banks]; its B fragments are `ldmatrix` (not .trans)
//   of Vt. (A pre-pass kernel would write and read V's codes once more in
//   device memory; the transpose is ~9 steps a thread per head.) The P
//   codes reach the A fragment with no lane exchange: a thread's scores
//   hold columns 2t, 2t+1 of each 8-column group and its A registers k
//   positions 4t .. 4t+3 of a k step, so Vt's columns take the keys in the
//   order that makes each A register four of the thread's own codes (P.V
//   sums over the keys, so P's columns and V's rows may be permuted
//   together; `transpose_v`). A code is the low byte of p + 1.5 * 2^23
//   (rint's rounding, by an add); each chunk's products follow its codes,
//   so that the 136 f32 p die chunk by chunk; the exponential's rounding
//   points are the plain version's, so that pq = rint(p) is its codes
//   (attn_softmax_sm90.cuh, EXP_2_CODES);
// - o = acc / l is staged through an 8 KB box and leaves as 16-byte row
//   stores. `p_out` (C only; a check, NULL when timed) receives the codes
//   pq from the A fragments the products read, [N, heads, S, S] int8.
// A block holds two 4 KB Q boxes, the 8 KB staging box, the K boxes, the
// V boxes (bf16 for B) and for C Vt: 70 KB (C) and 68 KB (B) at S = 257,
// three blocks an SM; 114 KB at S = 512.
#include "attn_softmax_sm90.cuh"

namespace mst {
namespace {

using namespace attn;
using s8 = signed char;

enum Variant : int { VAR_B = 1, VAR_C = 2 };

constexpr int BOX8 = CHUNK * HD;   // 4 KB: [64 rows][64 codes]
constexpr int TAIL8 = TAIL * HD;   // 1 KB: [16 rows][64 codes]
constexpr int SW64_GROUP = 8 * HD; // 512: 8 rows of the 64-byte swizzle

__host__ __device__ inline size_t codes_bytes(const Plan& p) {
  return size_t(p.n64) * BOX8 + size_t(p.tail) * TAIL8;
}
// Vt's keys (the chunks' keys rounded up to a 32-key k step) and its row
// stride: 16 times an odd number of bytes.
__host__ __device__ inline int vt_keys(const Plan& p) {
  return (p.n64 * CHUNK + p.tail * TAIL + 31) & ~31;
}
__host__ __device__ inline int vt_ld(const Plan& p) { return vt_keys(p) + 16; }

// Shared memory (bytes past the 1024-byte aligned base): two Q boxes of
// codes, o's bf16 staging box, the K boxes, the V boxes (C: codes; B: bf16
// boxes of attn_sm90.cuh), C's Vt, then the barriers (0, 1: the Q boxes;
// 2 + b: K and V of chunk b).
struct Layout {
  size_t q, o, k, v, vt, bar, total;
};

__host__ __device__ inline Layout layout(int S, bool int8_pv) {
  const Plan p = plan(S);
  Layout L;
  L.q = 0;
  L.o = L.q + 2 * BOX8;
  L.k = L.o + BOX_BYTES;
  L.v = L.k + codes_bytes(p);
  L.vt = L.v + (int8_pv ? codes_bytes(p) : operand_bytes(p));
  L.bar = L.vt + (int8_pv ? size_t(HD) * vt_ld(p) : 0);
  L.total = ALIGN + L.bar + size_t(2 + p.boxes) * sizeof(uint64_t);
  return L;
}

struct Args {
  bf16* out;
  void* p_out;
  int S, E, H;
  float scale;
};

// ---- PTX ------------------------------------------------------------------

// The descriptor of k step kk (32 bytes) of a K-major [rows][64 bytes] box
// with 64-byte swizzle: 8-row groups 512 bytes apart, layout type 2 (B64).
__device__ __forceinline__ uint64_t desc8(const unsigned char* box, int kk) {
  return uint64_t((smem_u32(box + kk * 32) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(SW64_GROUP >> 4) << 32) | (uint64_t(2) << 62);
}

// d[64 x 64] (+)= A[64 x 32] . B[32 x 64], int8 both K-major, s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 16] (+)= A[64 x 32] . B[32 x 16] (the tail chunk).
__device__ __forceinline__ void mma_s8(int (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// c[16 x 8] += a[16 x 32] . b[32 x 8], int8 in, int32 sums. Lane l, g = l /
// 4, t = l % 4: a[0] = A[g][4t .. 4t+3], a[1] = A[g+8][4t ..], a[2] =
// A[g][16+4t ..], a[3] = A[g+8][16+4t ..]; b0 = B[4t .. 4t+3][g], b1 =
// B[16+4t ..][g]; c as m16n8k16's.
__device__ __forceinline__ void mma_16832(int* c, const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// r = the four 8 x 16-byte matrices at the rows this lane addresses
// (`ldmatrix`, not transposed): lane l's word of matrix i is row l / 4,
// bytes 4 (l % 4) .. +3.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// s (64 x W) = qq . kq^T over the head dim: two k steps of 32 codes, one
// commit group. The s32 sums land in the registers of s (their bits), and
// `to_f32` converts them there: with separate int and float arrays ptxas
// kept both and spilled the one-pass body.
template <int R>
__device__ __forceinline__ void scores8(float (&s)[R], const unsigned char* qbox,
                                        const unsigned char* kbox) {
  int (&si)[R] = reinterpret_cast<int (&)[R]>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk) mma_s8(si, desc8(qbox, kk), desc8(kbox, kk), kk);
  wgmma_commit();
}

// 1.5 * 2^23: a float whose ulp is 1, and whose bits hold an integer added
// to them in their low bits (|x| < 2^22).
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// The s32 scores as f32 in place: x + MAGIC's bits is the float MAGIC + x,
// less MAGIC it is x exactly (|x| <= 64 * 127^2 < 2^20), by an integer and
// a float add where I2F runs at a quarter of their rate.
template <int R>
__device__ __forceinline__ void to_f32(float (&s)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    s[i] = __fsub_rn(__int_as_float(__float_as_int(s[i]) + MAGIC_BITS), MAGIC);
}

// Byte b of row r of a [rows][64 bytes] box with 64-byte swizzle.
__host__ __device__ __forceinline__ int sw64(int r, int b) {
  return r * HD + ((((b >> 4) ^ ((r >> 1) & 3)) << 4) | (b & 15));
}

// The k positions of P.V inside a chunk: the m16n8k32 A fragment of a
// thread holds k positions 4t .. 4t+3 (and 16 + 4t ..) of each 32-deep k
// step; its scores hold columns 8j + 2t, 8j + 2t + 1 of the chunk. P.V sums
// over the keys, so P's columns and V's rows may be permuted together:
// column 8j + o sits at k position 32 (j / 4) + 16 ((j / 2) % 2) + 4 (o / 2)
// + 2 (j % 2) + o % 2, and every A register is a thread's own four codes
// (`codes_a`), with no lane exchange. Vt[d][k] holds V's code of the key
// at k position k (zeros past the chunks' keys), 4 k positions x 4 columns
// d a step: the keys 8j + 2u, + 1, 8 (j + 1) + 2u, + 1 (j even), whose 4
// words turn into the 4 words of 4 columns by 8 byte permutes.
__device__ __forceinline__ void transpose_v(unsigned char* vt, const unsigned char* vbox,
                                            const Plan& P, int t) {
  const int keys = vt_keys(P), ld = vt_ld(P);
  const int covered = P.n64 * CHUNK + P.tail * TAIL;
  for (int u = t; u < (keys / 4) * (HD / 4); u += THREADS) {
    const int k0 = 4 * (u / (HD / 4)), d0 = 4 * (u % (HD / 4));
    const int r = k0 % CHUNK;  // = 32 kc + 16 h + 4 uu
    const int j0 = k0 - r + 8 * (4 * (r / 32) + 2 * ((r / 16) & 1)) + 2 * ((r / 4) & 3);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + (i & 1) + 8 * (i >> 1);
      w[i] = j < covered ? *reinterpret_cast<const uint32_t*>(
                               vbox + (j / CHUNK) * BOX8 + sw64(j % CHUNK, d0))
                         : 0u;
    }
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    unsigned char* dst = vt + d0 * ld + k0;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + ld) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * ld) = __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * ld) = __byte_perm(t1, t3, 0x7632);
  }
}

// The codes rint(p) of four values in [0, 127] as the bytes of one word:
// p + MAGIC rounds to the integer MAGIC + rint(p) (half to even), whose low
// byte is the code; no F2I, which runs at a quarter of the add's rate.
__device__ __forceinline__ uint32_t codes4(float p0, float p1, float p2, float p3) {
  const uint32_t r0 = __float_as_uint(__fadd_rn(p0, MAGIC));
  const uint32_t r1 = __float_as_uint(__fadd_rn(p1, MAGIC));
  const uint32_t r2 = __float_as_uint(__fadd_rn(p2, MAGIC));
  const uint32_t r3 = __float_as_uint(__fadd_rn(p3, MAGIC));
  return __byte_perm(__byte_perm(r0, r1, 0x0040), __byte_perm(r2, r3, 0x0040), 0x5410);
}

// The A fragments of m16n8k32 for the codes rint(p) of a chunk, from this
// thread's p in the f32 accumulator layout, in the k positions of
// `transpose_v` (R = 32: 64 keys, two k steps; R = 8: the 16-key tail, one
// k step whose second 16 positions are zero codes): register 0 / 1 of k
// step kc, rows qa / qb, holds columns 8 (4 kc) + 2t, + 1 and 8 (4 kc + 1) +
// 2t, + 1; register 2 / 3 the groups 4 kc + 2, 4 kc + 3.
template <int R>
__device__ __forceinline__ void codes_a(uint32_t (&fr)[(R + 8) / 16][4], const float (&p)[R]) {
#pragma unroll
  for (int kc = 0; kc < (R + 8) / 16; ++kc) {
    const int i = 16 * kc;
    fr[kc][0] = codes4(p[i], p[i + 1], p[i + 4], p[i + 5]);
    fr[kc][1] = codes4(p[i + 2], p[i + 3], p[i + 6], p[i + 7]);
    if constexpr (R > 8) {
      fr[kc][2] = codes4(p[i + 8], p[i + 9], p[i + 12], p[i + 13]);
      fr[kc][3] = codes4(p[i + 10], p[i + 11], p[i + 14], p[i + 15]);
    } else {
      fr[kc][2] = fr[kc][3] = 0u;
    }
  }
}

// acc += pq . vq over a chunk's keys key0 .., each warp its 16 rows, by
// mma.sync m16n8k32 from the chunk's A fragments (`codes_a`) and Vt's B
// fragments by `ldmatrix`.
template <int KC>
__device__ __forceinline__ void pv_codes(int (&acc)[32], const uint32_t (&fr)[KC][4],
                                         const unsigned char* vt, int ld, int key0, int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const unsigned char* row = vt + (lane & 7) * ld + key0 + 32 * kc + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, row + (16 * np + ((lane >> 4) & 1) * 8) * ld);
      mma_16832(&acc[8 * np], fr[kc], b[0], b[1]);
      mma_16832(&acc[8 * np + 4], fr[kc], b[2], b[3]);
    }
  }
}

// The check's copy of C's codes from a chunk's A fragments (`codes_a`):
// keys key0 .., the slice-head row block nh. Byte e of register r of k step
// kc holds row qa (r even) or qb, column 8 (4 kc + 2 (r / 2) + e / 2) + 2t +
// e % 2.
template <int KC>
__device__ __forceinline__ void write_codes(const uint32_t (&fr)[KC][4], int key0, const Rows& c,
                                            const Args& a, size_t nh) {
  s8* p = static_cast<s8*>(a.p_out);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = (r & 1) ? c.qb : c.qa;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = key0 + 8 * (4 * kc + 2 * (r >> 1) + (e >> 1)) + 2 * (c.t & 3) + (e & 1);
        if (q < a.S && j < a.S)
          p[(nh * a.S + q) * a.S + j] = static_cast<s8>(fr[kc][r] >> (8 * e));
      }
    }
}

// Grid (heads x tile groups, N), as attn_variants.cu. INT8_PV: variant C
// (q, k, v codes in one map; v64 / v16 unused), else B (v64 / v16: bf16 V
// [N, S, E]). TWO: the two-pass body (S > ONE_PASS_MAX). P_OUT (C only):
// the check's copy of the codes, a flag of its own so that the timed
// kernel carries none of its code.
template <bool INT8_PV, bool TWO, bool P_OUT>
__global__ void __launch_bounds__(THREADS)
attn_i8_kernel(const __grid_constant__ CUtensorMap c64, const __grid_constant__ CUtensorMap c16,
               const __grid_constant__ CUtensorMap v64, const __grid_constant__ CUtensorMap v16,
               Args a) {
  constexpr int F = INT8_PV ? EXP_2_CODES : EXP_2;
  constexpr bool L_FIRST = !INT8_PV;  // C divides by l at the end: pass 2 sums it
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  const Plan P = plan(a.S);
  const Layout L = layout(a.S, INT8_PV);
  unsigned char* Ob = base + L.o;
  unsigned char* Kb = base + L.k;
  unsigned char* Vb = base + L.v;
  unsigned char* Vt = base + L.vt;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L.bar);
  const int ld = vt_ld(P);

  const int t = threadIdx.x;
  const int n = blockIdx.y;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const int groups = (tiles(a.S) + tpb - 1) / tpb;
  const int g = blockIdx.x % groups;
  const int h = blockIdx.x / groups;
  const int units = min(tpb, tiles(a.S) - g * tpb);
  const size_t nh = size_t(n) * a.H + h;
  auto load_q = [&](int u) {
    unsigned char* q = base + L.q + (u & 1) * BOX8;
    sm90::mbar_expect_tx(&bar[u & 1], BOX8);
    tma_load_3d(q, &c64, h * HD, (g * tpb + u) * TILE, n, &bar[u & 1]);
  };
  if (t == 0) {
    for (int i = 0; i < 2 + P.boxes; ++i) sm90::mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::tma_prefetch(&c64);
    sm90::tma_prefetch(&c16);
    if (!INT8_PV) {
      sm90::tma_prefetch(&v64);
      sm90::tma_prefetch(&v16);
    }
    load_q(0);
    for (int b = 0; b < P.boxes; ++b) {
      const bool full = b < P.n64;
      const int kbytes = full ? BOX8 : TAIL8;
      const int vbytes = INT8_PV ? kbytes : (full ? BOX_BYTES : TAIL_BYTES);
      sm90::mbar_expect_tx(&bar[2 + b], kbytes + vbytes);
      tma_load_3d(Kb + b * BOX8, full ? &c64 : &c16, a.E + h * HD, b * CHUNK, n, &bar[2 + b]);
      if (INT8_PV)
        tma_load_3d(Vb + b * BOX8, full ? &c64 : &c16, 2 * a.E + h * HD, b * CHUNK, n,
                    &bar[2 + b]);
      else
        tma_load_3d(Vb + b * BOX_BYTES, full ? &v64 : &v16, h * HD, b * CHUNK, n, &bar[2 + b]);
    }
    if (units > 1) load_q(1);
  }
  __syncthreads();

  if (INT8_PV) {  // V's codes transposed once, as soon as every box has landed
    for (int b = 0; b < P.boxes; ++b) mbar_wait(&bar[2 + b], 0);
    transpose_v(Vt, Vb, P, t);
    __syncthreads();
  }

  for (int u = 0; u < units; ++u) {
    const Rows c = rows_of(t, (g * tpb + u) * TILE);
    unsigned char* Qb = base + L.q + (u & 1) * BOX8;
    const uint32_t qpar = (u >> 1) & 1;
    // a warp whose 16 rows all lie past S skips the softmax (s = 0 there;
    // nothing of it is stored)
    const bool live = c.q0 + 16 * c.warp < a.S;

    float accf[32];
    int acci[32];
    zero(accf);
#pragma unroll
    for (int i = 0; i < 32; ++i) acci[i] = 0;
    float l0 = 0.0f, l1 = 0.0f, m0 = -INFINITY, m1 = -INFINITY;
    mbar_wait(&bar[u & 1], qpar);
    if constexpr (!TWO) {
      float s[4][32], st[8];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < P.n64) {
          mbar_wait(&bar[2 + b], 0);
          scores8(s[b], Qb, Kb + b * BOX8);
          wgmma_wait<1>();
        }
      if (P.tail) {
        mbar_wait(&bar[2 + P.n64], 0);
        scores8(st, Qb, Kb + P.n64 * BOX8);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < 4; ++b) fence_regs(s[b]);
      fence_regs(st);
#pragma unroll
      for (int b = 0; b < 4; ++b) to_f32(s[b]);
      to_f32(st);
      if (live) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < P.n64) {
            if ((b + 1) * CHUNK <= a.S)
              scale_mask<F, false>(s[b], b * CHUNK, t, a.S, a.scale, m0, m1);
            else
              scale_mask<F>(s[b], b * CHUNK, t, a.S, a.scale, m0, m1);
          }
        if (P.tail) scale_mask<F>(st, P.n64 * CHUNK, t, a.S, a.scale, m0, m1);
        m0 = quad_max(m0);
        m1 = quad_max(m1);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < P.n64) exp_rows<F>(s[b], m0, m1, l0, l1);
        if (P.tail) exp_rows<F>(st, m0, m1, l0, l1);
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
      }
      if constexpr (INT8_PV) {
        // each chunk's codes into A fragments, then its products
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < P.n64) {
            uint32_t fr[2][4];
            codes_a(fr, s[b]);
            if (P_OUT && live) write_codes(fr, b * CHUNK, c, a, nh);
            pv_codes(acci, fr, Vt, ld, b * CHUNK, c.lane);
          }
        if (P.tail) {
          uint32_t ft[1][4];
          codes_a(ft, st);
          if (P_OUT && live) write_codes(ft, P.n64 * CHUNK, c, a, nh);
          pv_codes(acci, ft, Vt, ld, P.n64 * CHUNK, c.lane);
        }
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < P.n64) pv_sync(accf, s[b], Vb + b * BOX_BYTES, c.lane);
        if (P.tail) pv_sync(accf, st, Vb + P.n64 * BOX_BYTES, c.lane);
      }
    } else {
      // pass 1: m (B: and l, rescaled when m grows) chunk by chunk
      float s[32], st[8];
      for (int b = 0; b < P.n64; ++b) {
        mbar_wait(&bar[2 + b], 0);
        scores8(s, Qb, Kb + b * BOX8);
        wgmma_wait<0>();
        fence_regs(s);
        to_f32(s);
        online<F, L_FIRST>(s, b * CHUNK, c, a.S, a.scale, m0, m1, l0, l1);
      }
      if (P.tail) {
        mbar_wait(&bar[2 + P.n64], 0);
        scores8(st, Qb, Kb + P.n64 * BOX8);
        wgmma_wait<0>();
        fence_regs(st);
        to_f32(st);
        online<F, L_FIRST>(st, P.n64 * CHUNK, c, a.S, a.scale, m0, m1, l0, l1);
      }
      if (L_FIRST) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
      }
      // pass 2: the scores again, p against the final max, P.V
      for (int b = 0; b < P.n64; ++b) {
        scores8(s, Qb, Kb + b * BOX8);
        wgmma_wait<0>();  // B: also the previous chunk's P.V
        fence_regs(s);
        fence_regs(accf);
        to_f32(s);
        probs<F, !L_FIRST>(s, b * CHUNK, c, a.S, a.scale, m0, m1, l0, l1);
        if constexpr (INT8_PV) {
          uint32_t fr[2][4];
          codes_a(fr, s);
          if (P_OUT) write_codes(fr, b * CHUNK, c, a, nh);
          pv_codes(acci, fr, Vt, ld, b * CHUNK, c.lane);
        } else {
          pv(accf, s, Vb + b * BOX_BYTES);
        }
      }
      if (P.tail) {
        scores8(st, Qb, Kb + P.n64 * BOX8);
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(accf);
        to_f32(st);
        probs<F, !L_FIRST>(st, P.n64 * CHUNK, c, a.S, a.scale, m0, m1, l0, l1);
        if constexpr (INT8_PV) {
          uint32_t ft[1][4];
          codes_a(ft, st);
          if (P_OUT) write_codes(ft, P.n64 * CHUNK, c, a, nh);
          pv_codes(acci, ft, Vt, ld, P.n64 * CHUNK, c.lane);
        } else {
          pv(accf, st, Vb + P.n64 * BOX_BYTES);
        }
      }
      wgmma_wait<0>();
      fence_regs(accf);
      if (!L_FIRST) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
      }
    }

    // o = acc / l through the staging box
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      o[i] = (INT8_PV ? __int2float_rn(acci[i]) : accf[i]) / (frag_hi(i) ? l1 : l0);
    stage_box(Ob, t, o);
    __syncthreads();
    store_box(Ob, t, a.out + (size_t(n) * a.S + c.q0) * a.E + h * HD, a.E,
              min(TILE, a.S - c.q0));
    // every read of this unit's Q box (and of the staging box) is done
    // before TMA refills it
    fence_async_smem();
    __syncthreads();
    if (t == 0 && u + 2 < units) load_q(u + 2);
  }
}

// The TMA map of row-major int8 codes [slices, rows, cols] read in
// [1][box_rows][64] boxes with 64-byte swizzle; rows past `rows` of a slice
// read as zeros. Binds the current device's context first (a fresh host
// thread has none).
inline cudaError_t tma_map_codes(CUtensorMap* map, const void* ptr, uint64_t slices,
                                 uint64_t rows, uint64_t cols, uint32_t box_rows) {
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {cols, rows, slices};
  const cuuint64_t strides[2] = {cols, rows * cols};
  const cuuint32_t box[3] = {HD, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool INT8_PV, bool TWO, bool P_OUT = false>
cudaError_t launch(const CUtensorMap& c64, const CUtensorMap& c16, const CUtensorMap& v64,
                   const CUtensorMap& v16, const Args& a, int N, cudaStream_t st) {
  const size_t bytes = layout(a.S, INT8_PV).total;
  auto kernel = attn_i8_kernel<INT8_PV, TWO, P_OUT>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int tpb = tiles_per_block(a.S, MOST_TILES);
  const dim3 grid(a.H * ((tiles(a.S) + tpb - 1) / tpb), N);
  kernel<<<grid, THREADS, bytes, st>>>(c64, c16, v64, v16, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mst

// variant 1 (B): codes [N*S, 2E] int8 (q | k), v [N*S, E] bf16; variant 2
// (C): codes [N*S, 3E] int8 (q | k | v), v NULL. -> out [N*S, E] bf16;
// p_out NULL, or for C [N, num_heads, S, S] int8: the codes pq;
// scale = log2(e)/sqrt(64). Needs E == 64 * num_heads and 1 <= S <= 512.
extern "C" int mst_attn_i8(const void* codes, const void* v, void* out, void* p_out, int N,
                           int S, int E, int num_heads, int variant, float scale, void* stream) {
  using namespace mst;
  if (N <= 0 || N > 65535 || S <= 0 || S > MAX_S || num_heads <= 0 || num_heads > 65535 ||
      E != num_heads * HD || (variant != VAR_B && variant != VAR_C) ||
      (variant == VAR_B) != (v != nullptr) || (variant == VAR_B && p_out != nullptr))
    return cudaErrorInvalidValue;
  const bool c8 = variant == VAR_C;
  CUtensorMap c64, c16, v64, v16;
  const uint64_t cols = (c8 ? 3 : 2) * uint64_t(E);
  cudaError_t err = tma_map_codes(&c64, codes, N, S, cols, CHUNK);
  if (err == cudaSuccess) err = tma_map_codes(&c16, codes, N, S, cols, TAIL);
  if (err == cudaSuccess && !c8) err = tma_map_3d(&v64, v, N, S, E, CHUNK);
  if (err == cudaSuccess && !c8) err = tma_map_3d(&v16, v, N, S, E, TAIL);
  if (err != cudaSuccess) return err;
  if (c8) v64 = v16 = c64;
  const Args a{static_cast<bf16*>(out), p_out, S, E, num_heads, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = S > ONE_PASS_MAX;
  if (c8 && p_out != nullptr)
    return two ? launch<true, true, true>(c64, c16, v64, v16, a, N, st)
               : launch<true, false, true>(c64, c16, v64, v16, a, N, st);
  if (c8)
    return two ? launch<true, true>(c64, c16, v64, v16, a, N, st)
               : launch<true, false>(c64, c16, v64, v16, a, N, st);
  return two ? launch<false, true>(c64, c16, v64, v16, a, N, st)
             : launch<false, false>(c64, c16, v64, v16, a, N, st);
}

// The launch geometry of mst_attn_i8 at sequence length S (1 <= S <= 512)
// and variant (1: B, 2: C): geo = {query tile rows, query tiles, tiles a
// block walks, threads, passes, 64-key chunks, tail chunks of 16, Vt's row
// stride in bytes (0 for B), dynamic shared memory bytes}, as the launch
// sets them (`bench_attn_i8.i8_launch` mirrors it).
extern "C" int mst_attn_i8_geometry(int S, int variant, int* geo) {
  using namespace mst;
  if (S <= 0 || S > MAX_S || (variant != VAR_B && variant != VAR_C))
    return cudaErrorInvalidValue;
  const Plan p = plan(S);
  const bool c8 = variant == VAR_C;
  const int g[9] = {TILE, tiles(S), tiles_per_block(S, MOST_TILES), THREADS,
                    S > ONE_PASS_MAX ? 2 : 1, p.n64, p.tail, c8 ? vt_ld(p) : 0,
                    static_cast<int>(layout(S, c8).total)};
  for (int i = 0; i < 9; ++i) geo[i] = g[i];
  return cudaSuccess;
}
