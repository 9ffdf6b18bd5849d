// quant_rows: per-token int8 quantization of a [M, K] activation, bf16 or f32
// in, int8 codes out (with an f32 scale per row in the dynamic mode).
//
// Replaces the in-kernel `_quant_rows` / `_quant_static` calls of the Pallas
// kernels in mst_tpu/ops/fused_int8.py on the inputs of the second product:
// the attention output o (bf16, from `mhsa`) of `_attn_i8_kernel`, and the
// f32 GELU output of `_mlp_i8_kernel` / gate output of `_swiglu_i8_kernel`
// (dynamic trees only: static ones quantize the hidden in `ln_gemm_i8`'s
// epilogue). Rounding as the JAX body: dynamic, scale = max(amax_row |v|,
// 1e-12) * f32(1/127), q = rint(v * (1 / scale)) (round half to even);
// static (the scale folded into the v-columns upstream), q = clip(rint(v),
// -127, 127).
//
// Bound on the H100: bytes. At the path shapes (M = 65,792; K = 384 or 1536
// bf16, 1536 or 4096 f32) it reads 50 MB - 1.1 GB and writes a quarter to a
// half of that. The amax of a row has to be final before any of its codes
// is written, so a row that is read from device memory once must wait on
// chip. Design:
// - Persistent blocks, QR_BLOCKS_PER_SM an SM, each walking over groups of
//   whole rows (group g, g + grid, ...). A group is `rows` consecutive rows
//   of at most one stage's bytes (at most QR_MAX_ROWS: smaller groups keep
//   the codes written after the last copy lands short), or one row of up
//   to QR_STAGES stages; its rows are contiguous in memory, so each stage
//   is one `cp.async.bulk` (1D TMA) of up to QR_STAGE bytes completing on
//   the stage's full `mbarrier` (expect_tx).
// - A ring of QR_STAGES stages. One producer warp (lane 0) runs ahead
//   across groups: it refills a stage as soon as the eight consumer warps
//   have released it (its empty barrier), so the next groups' copies are
//   in flight while this group's codes are written; a block keeps up to
//   QR_RING bytes in flight.
// - Consumers, eight warps. Dynamic: first each row's amax from the staged
//   copy, the warps in teams of `wpr`, a team a row (the plan picks the
//   team size that gives the busiest warp the fewest vector steps; a
//   team's partials meet in shared memory behind a named barrier), the
//   scale written once per row and its reciprocal kept in shared memory;
//   then, after one barrier of the eight warps, the codes: a group's rows
//   are contiguous in the ring and in q, so the warps sweep its vectors of
//   VEC consecutive values flat, each read from shared memory again and
//   stored as one 16-byte (VEC = 8: 8-byte) store. Static: the sweep alone.
//   A lane reads its 16-byte chunks in an order rotated by its lane, so
//   the eight lanes of a shared-memory phase hit eight distinct bank
//   groups. Codes round half to even by an add of 1.5 * 2^23 and a byte
//   permute, not a float-to-int conversion per value.
// - A row wider than the whole ring (above 24,576 f32 / 49,152 bf16
//   values; no model path) cannot wait on chip: it streams through the
//   ring chunk by chunk, twice in the dynamic mode (amax, then codes).
// Every other row is read from device memory exactly once.

#include "gemm_sm90.cuh"

namespace mst {
namespace {

constexpr int QR_WARPS = 8;                        // consumer warps
constexpr int QR_THREADS = 32 * QR_WARPS + 32;     // + one producer warp
constexpr int QR_STAGE = 32768;                    // bytes of one ring stage (32 KB)
constexpr int QR_STAGES = 3;                       // ring depth
constexpr int QR_RING = QR_STAGE * QR_STAGES;
constexpr int QR_BLOCKS_PER_SM = 2;
constexpr int QR_MAX_ROWS = 16;                    // rows of a group, at most
// the ring, then the full and empty barriers, the teams' amax partials
// [2][QR_WARPS] (double-buffered by row) and the group's row multipliers
// [2][QR_MAX_ROWS] (double-buffered by group)
constexpr size_t QR_SMEM =
    QR_RING + 2 * QR_STAGES * 8 + 2 * QR_WARPS * 4 + 2 * QR_MAX_ROWS * 4;
// named barriers: 1 + team for a team's amax, QR_ALL for the consumers
constexpr int QR_ALL = 1 + QR_WARPS;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);

// The launch plan of one shape (`mst_quant_rows_geometry` reports it).
struct QrPlan {
  long long rb;  // bytes of one row
  int rows;      // rows of a group
  int chunks;    // stages of a full group
  int passes;    // reads of a group: 2 for a dynamic row wider than the ring
  int streamed;  // 1: the row goes through the ring chunk by chunk
  int wpr;       // consumer warps a row
  int groups;    // ceil(M / rows)
  int grid;      // persistent blocks
  int vec;       // values a thread quantizes at a time: 16, or 8 if K % 16
};

inline QrPlan qr_plan(int M, int K, int esize, bool is_static, int sms) {
  QrPlan p;
  p.vec = K % 16 == 0 ? 16 : 8;
  p.rb = static_cast<long long>(K) * esize;
  if (p.rb <= QR_STAGE) {
    long long fit = QR_STAGE / p.rb;
    fit = fit < QR_MAX_ROWS ? fit : QR_MAX_ROWS;
    p.rows = static_cast<int>(fit < M ? fit : M);
    p.chunks = 1;
  } else {
    p.rows = 1;
    p.chunks = static_cast<int>((p.rb + QR_STAGE - 1) / QR_STAGE);
  }
  p.streamed = p.chunks > QR_STAGES;
  p.passes = p.streamed && !is_static ? 2 : 1;
  const int vpr = K / p.vec;
  p.wpr = QR_WARPS;
  if (!p.streamed) {
    long long best = -1;
    for (int w = 1; w <= QR_WARPS; w *= 2) {
      const int teams = QR_WARPS / w;
      const long long steps = static_cast<long long>((p.rows + teams - 1) / teams) *
                              ((vpr + 32 * w - 1) / (32 * w));
      if (best < 0 || steps < best) best = steps, p.wpr = w;
    }
  }
  p.groups = (M + p.rows - 1) / p.rows;
  const int cap = sms * QR_BLOCKS_PER_SM;
  p.grid = p.groups < cap ? p.groups : cap;
  return p;
}

// 1D bulk copy (TMA) of `bytes` (a multiple of 16) from global to shared
// memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(sm90::smem_u32(dst)), "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// The 16-byte chunk of a staged vector as f32 values (8 bf16 or 4 f32).
__device__ __forceinline__ void load_chunk(const unsigned char* p, const bf16*, float* v) {
  unpack8_bf16(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void load_chunk(const unsigned char* p, const float*, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

template <typename T, int VEC>
struct Vec {
  static constexpr int BYTES = VEC * int(sizeof(T));  // 16, 32 or 64
  static constexpr int NC = BYTES / 16;               // 16-byte chunks
  static constexpr int EPC = 16 / int(sizeof(T));     // values a chunk
  static constexpr int WPC = EPC / 4;                 // code words a chunk
};

// The chunk a lane reads first: lanes L and L + 8 / NC of one 8-lane
// shared-memory phase start NC-apart chunks, so the phase's eight 16-byte
// reads fall in eight bank groups.
template <int NC>
__device__ __forceinline__ int lane_rot(int lane) {
  return (lane / (8 / NC)) & (NC - 1);
}

// max |v| over the 16-byte chunk at p (bf16: on pairs, exact).
__device__ __forceinline__ float amax_chunk(const unsigned char* p, const bf16*) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  const __nv_bfloat162 m =
      __hmax2(__hmax2(__habs2(h[0]), __habs2(h[1])), __hmax2(__habs2(h[2]), __habs2(h[3])));
  return fmaxf(__low2float(m), __high2float(m));
}
__device__ __forceinline__ float amax_chunk(const unsigned char* p, const float*) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(a.z), fabsf(a.w)));
}

// max |v| over the VEC staged values at p.
template <typename T, int VEC>
__device__ __forceinline__ float amax_vec(const unsigned char* p, int rot) {
  using V = Vec<T, VEC>;
  float a = 0.0f;
#pragma unroll
  for (int c = 0; c < V::NC; ++c)
    a = fmaxf(a, amax_chunk(p + 16 * ((c + rot) & (V::NC - 1)), static_cast<const T*>(nullptr)));
  return a;
}

// Four codes as one word, byte e the code of v[e]: round half to even by
// adding 1.5 * 2^23 (the sum lies where the f32 step is 1, so the add
// rounds v to an integer as __float2int_rn does; |v| <= 127.5 here), whose
// low byte is then the code's two's complement. Dynamic: rint(v * mul);
// static: rint(clip(v, -127, 127)) = clip(rint(v), -127, 127).
template <bool STATIC>
__device__ __forceinline__ uint32_t code4(const float* v, float mul) {
  constexpr float MAGIC = 12582912.0f;
  uint32_t b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = STATIC ? fminf(fmaxf(v[e], -127.0f), 127.0f) : __fmul_rn(v[e], mul);
    b[e] = __float_as_uint(__fadd_rn(x, MAGIC));
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// The codes of the VEC staged values at p, stored at dst (16 or 8 bytes).
template <typename T, int VEC, bool STATIC>
__device__ __forceinline__ void store_codes(const unsigned char* p, int rot, float mul,
                                            signed char* dst) {
  using V = Vec<T, VEC>;
  constexpr int MASK = V::NC - 1;
  uint32_t w[V::NC][V::WPC];
#pragma unroll
  for (int c = 0; c < V::NC; ++c) {
    float v[V::EPC];
    load_chunk(p + 16 * ((c + rot) & MASK), static_cast<const T*>(nullptr), v);
#pragma unroll
    for (int j = 0; j < V::WPC; ++j) w[c][j] = code4<STATIC>(v + 4 * j, mul);
  }
  // step c read chunk (c + rot) & MASK: chunk k's words are w[(k - rot) & MASK]
  uint32_t o[V::NC * V::WPC];
#pragma unroll
  for (int k = 0; k < V::NC; ++k)
#pragma unroll
    for (int j = 0; j < V::WPC; ++j) {
      uint32_t x = w[k][j];
#pragma unroll
      for (int r = 1; r < V::NC; ++r)
        if (rot == r) x = w[(k - r + V::NC) & MASK][j];
      o[k * V::WPC + j] = x;
    }
  if constexpr (VEC == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
}

// The max of `a` over the team of `wpr` warps this warp belongs to.
__device__ __forceinline__ float team_max(float a, float* red, int& par, int warp, int wpr) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  if (wpr == 1) return a;
  float* slot = red + par * QR_WARPS;
  if ((threadIdx.x & 31) == 0) slot[warp] = a;
  const int team = warp / wpr;
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(32 * wpr) : "memory");
  a = slot[team * wpr];
  for (int i = 1; i < wpr; ++i) a = fmaxf(a, slot[team * wpr + i]);
  par ^= 1;  // a teammate may still read this slot until the next row's barrier
  return a;
}

__device__ __forceinline__ void row_scale(float amax, float& mul, float* scale, long long row,
                                          bool first) {
  const float s = __fmul_rn(fmaxf(amax, 1e-12f), INV127);
  mul = __frcp_rn(s);
  if (first) scale[row] = s;
}

template <typename T, int VEC, bool STATIC>
__global__ void __launch_bounds__(QR_THREADS, QR_BLOCKS_PER_SM)
quant_rows_ring_kernel(const T* __restrict__ src, signed char* __restrict__ q,
                       float* __restrict__ scale, int M, int K, QrPlan p) {
  using V = Vec<T, VEC>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + QR_RING);
  uint64_t* empty = full + QR_STAGES;
  float* red = reinterpret_cast<float*>(empty + QR_STAGES);
  float* muls = red + 2 * QR_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < QR_STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);          // the producer's expect_tx
      sm90::mbar_init(&empty[i], QR_WARPS);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == QR_WARPS) {  // the producer
    if (lane == 0) {
      const unsigned char* base = reinterpret_cast<const unsigned char*>(src);
      uint32_t it = 0;
      for (int g = blockIdx.x; g < p.groups; g += gridDim.x) {
        const long long r0 = static_cast<long long>(g) * p.rows;
        const long long bytes = (M - r0 < p.rows ? M - r0 : p.rows) * p.rb;
        for (int pass = 0; pass < p.passes; ++pass)
          for (long long off = 0; off < bytes; off += QR_STAGE, ++it) {
            const int st = it % QR_STAGES;
            sm90::mbar_wait(&empty[st], ((it / QR_STAGES) & 1) ^ 1);
            const uint32_t n = static_cast<uint32_t>(bytes - off < QR_STAGE ? bytes - off
                                                                            : QR_STAGE);
            sm90::mbar_expect_tx(&full[st], n);
            bulk_load(ring + size_t(st) * QR_STAGE, base + r0 * p.rb + off, n, &full[st]);
          }
      }
    }
    return;
  }

  const int wpr = p.wpr, teams = QR_WARPS / wpr, team = warp / wpr;
  const int tt = (warp % wpr) * 32 + lane, tn = 32 * wpr;  // thread in team, team size
  const int vpr = K / VEC;
  const int rot = lane_rot<V::NC>(lane);
  const float inv_vpr = 1.0f / static_cast<float>(vpr);
  int par = 0, gpar = 0;
  uint32_t it = 0;
  for (int g = blockIdx.x; g < p.groups; g += gridDim.x) {
    const long long r0 = static_cast<long long>(g) * p.rows;
    const int rows = static_cast<int>(M - r0 < p.rows ? M - r0 : p.rows);
    if (!p.streamed) {
      // the whole group resident: its stages from it % QR_STAGES on
      const int nch = static_cast<int>((rows * p.rb + QR_STAGE - 1) / QR_STAGE);
      for (int c = 0; c < nch; ++c)
        sm90::mbar_wait(&full[(it + c) % QR_STAGES], ((it + c) / QR_STAGES) & 1);
      const uint32_t s0 = (it % QR_STAGES) * QR_STAGE;
      auto at = [&](uint32_t off) {
        const uint32_t x = s0 + off;
        return ring + (x >= QR_RING ? x - QR_RING : x);
      };
      // the amax of each row (a team a row), its multiplier to shared memory
      float* mul_g = muls + (gpar ^= 1) * QR_MAX_ROWS;
      if constexpr (!STATIC) {
        for (int r = team; r < rows; r += teams) {
          const uint32_t row_off = static_cast<uint32_t>(r * p.rb);
          float a = 0.0f;
          for (int v = tt; v < vpr; v += tn)
            a = fmaxf(a, amax_vec<T, VEC>(at(row_off + v * V::BYTES), rot));
          float mul;
          row_scale(team_max(a, red, par, warp, wpr), mul, scale, r0 + r, tt == 0);
          if (tt == 0) mul_g[r] = mul;
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(QR_ALL), "r"(32 * QR_WARPS) : "memory");
      }
      // the codes: the group's rows are contiguous in the ring and in q, so
      // the consumers take its vectors in one flat sweep; row = v / vpr by
      // (v + 0.5) * f32(1 / vpr), exact while v / vpr < 16 and vpr < 2^18
      const int nvec = rows * vpr;
      signed char* qg = q + size_t(r0) * K;
      for (int v = threadIdx.x; v < nvec; v += 32 * QR_WARPS) {
        float mul = 1.0f;
        if constexpr (!STATIC)
          mul = mul_g[rows == 1 ? 0
                                : __float2int_rz(__fmul_rn(__fadd_rn(float(v), 0.5f), inv_vpr))];
        store_codes<T, VEC, STATIC>(at(v * V::BYTES), rot, mul, qg + size_t(v) * VEC);
      }
      __syncwarp();
      if (lane == 0)
        for (int c = 0; c < nch; ++c) sm90::mbar_arrive(&empty[(it + c) % QR_STAGES]);
      it += nch;
    } else {
      // one row wider than the ring, one chunk at a time (wpr = QR_WARPS)
      float mul = 1.0f;
      signed char* qrow = q + size_t(r0) * K;
      for (int pass = 0; pass < p.passes; ++pass) {
        const bool codes = pass == p.passes - 1;
        float a = 0.0f;
        for (int c = 0; c < p.chunks; ++c, ++it) {
          const int st = it % QR_STAGES;
          sm90::mbar_wait(&full[st], (it / QR_STAGES) & 1);
          const unsigned char* stage = ring + size_t(st) * QR_STAGE;
          const long long left = p.rb - static_cast<long long>(c) * QR_STAGE;
          const int nv = static_cast<int>((left < QR_STAGE ? left : QR_STAGE) / V::BYTES);
          const int v0 = c * (QR_STAGE / V::BYTES);
          for (int v = tt; v < nv; v += tn) {
            if (codes)
              store_codes<T, VEC, STATIC>(stage + v * V::BYTES, rot, mul,
                                          qrow + size_t(v0 + v) * VEC);
            else
              a = fmaxf(a, amax_vec<T, VEC>(stage + v * V::BYTES, rot));
          }
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[st]);
        }
        if (!codes) row_scale(team_max(a, red, par, warp, wpr), mul, scale, r0, tt == 0);
      }
    }
  }
}

template <typename T, int VEC, bool STATIC>
cudaError_t launch(const void* src, void* q, void* scale, int M, int K, const QrPlan& p,
                   cudaStream_t st) {
  const cudaError_t err = allow_smem(quant_rows_ring_kernel<T, VEC, STATIC>, QR_SMEM);
  if (err != cudaSuccess) return err;
  quant_rows_ring_kernel<T, VEC, STATIC><<<p.grid, QR_THREADS, QR_SMEM, st>>>(
      static_cast<const T*>(src), static_cast<signed char*>(q), static_cast<float*>(scale), M,
      K, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const void* src, void* q, void* scale, int M, int K, const QrPlan& p,
                       cudaStream_t st) {
  const bool is_static = scale == nullptr;
  if (p.vec == 16)
    return is_static ? launch<T, 16, true>(src, q, scale, M, K, p, st)
                     : launch<T, 16, false>(src, q, scale, M, K, p, st);
  return is_static ? launch<T, 8, true>(src, q, scale, M, K, p, st)
                   : launch<T, 8, false>(src, q, scale, M, K, p, st);
}

}  // namespace
}  // namespace mst

// src [M, K] bf16 (is_f32 = 0) or f32 (is_f32 = 1), 16-byte aligned -> q
// [M, K] int8 and, if `scale` is not NULL, the per-row scale [M] f32
// (dynamic); with `scale` NULL the static codes clip(rint(v), -127, 127).
// Needs K % 8 == 0; `sms`: the card's SM count (the persistent grid).
extern "C" int mst_quant_rows(const void* src, int is_f32, void* q, void* scale, int M, int K,
                              int sms, void* stream) {
  using namespace mst;
  if (M <= 0 || K <= 0 || K % 8 != 0 || sms <= 0) return cudaErrorInvalidValue;
  const QrPlan p = qr_plan(M, K, is_f32 ? 4 : 2, scale == nullptr, sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_vec<float>(src, q, scale, M, K, p, st)
                : launch_vec<bf16>(src, q, scale, M, K, p, st);
}

// The launch plan for src [M, K] (is_f32, is_static) on a card of `sms`
// SMs: geo = {grid, threads, dynamic shared memory bytes, rows of a group,
// stages of a full group, passes, streamed, warps a row, groups, values a
// thread quantizes at a time, stage bytes, stages}, as `mst_quant_rows`
// sets them (`fused_int8.quant_rows_launch` mirrors it). The shapes it
// refuses return cudaErrorInvalidValue.
extern "C" int mst_quant_rows_geometry(int M, int K, int is_f32, int is_static, int sms,
                                       int* geo) {
  using namespace mst;
  if (M <= 0 || K <= 0 || K % 8 != 0 || sms <= 0) return cudaErrorInvalidValue;
  const QrPlan p = qr_plan(M, K, is_f32 ? 4 : 2, is_static != 0, sms);
  const int g[12] = {p.grid,   QR_THREADS, static_cast<int>(QR_SMEM), p.rows,
                     p.chunks, p.passes,   p.streamed,                p.wpr,
                     p.groups, p.vec,      QR_STAGE,                  QR_STAGES};
  for (int i = 0; i < 12; ++i) geo[i] = g[i];
  return cudaSuccess;
}
