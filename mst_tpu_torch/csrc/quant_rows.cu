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
// Bound on the H100: bytes. At the ViT-S path shapes (M = 65,792, K = 384
// bf16 or 1536 f32) it reads 50-400 MB and writes a quarter to a half of
// that; giant2's gate output (K = 4096 f32) 1.1 GB. One warp owns a row and
// reads it twice (the amax, then the codes; the second pass finds it in L1
// or L2), 8 values a lane per step with 16-byte loads, 8-byte stores.
#include "common.cuh"

namespace mst {
namespace {

constexpr int WARPS = 8;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  unpack8_bf16(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
quant_rows_kernel(const T* __restrict__ src, signed char* __restrict__ q,
                  float* __restrict__ scale, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* row = src + size_t(m) * K;
  signed char* qrow = q + size_t(m) * K;
  float v[8];
  float mul = 1.0f;
  if (scale != nullptr) {
    float amax = 0.0f;
    for (int k = lane * 8; k < K; k += 256) {
      load8(row + k, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = __fmul_rn(fmaxf(amax, 1e-12f), INV127);
    mul = __frcp_rn(s);
    if (lane == 0) scale[m] = s;
  }
  for (int k = lane * 8; k < K; k += 256) {
    load8(row + k, v);
    union {
      uint2 u;
      signed char c[8];
    } pk;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int c;
      if (scale != nullptr) {
        c = __float2int_rn(__fmul_rn(v[e], mul));
      } else {
        c = __float2int_rn(v[e]);
        c = c < -127 ? -127 : (c > 127 ? 127 : c);
      }
      pk.c[e] = static_cast<signed char>(c);
    }
    *reinterpret_cast<uint2*>(qrow + k) = pk.u;
  }
}

}  // namespace
}  // namespace mst

// src [M, K] bf16 (is_f32 = 0) or f32 (is_f32 = 1) -> q [M, K] int8 and, if
// `scale` is not NULL, the per-row scale [M] f32 (dynamic); with `scale`
// NULL the static codes clip(rint(v), -127, 127). Needs K % 8 == 0.
extern "C" int mst_quant_rows(const void* src, int is_f32, void* q, void* scale, int M, int K,
                              void* stream) {
  using namespace mst;
  if (M <= 0 || K <= 0 || K % 8 != 0) return cudaErrorInvalidValue;
  const int blocks = (M + WARPS - 1) / WARPS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32)
    quant_rows_kernel<float><<<blocks, 32 * WARPS, 0, st>>>(
        static_cast<const float*>(src), static_cast<signed char*>(q),
        static_cast<float*>(scale), M, K);
  else
    quant_rows_kernel<bf16><<<blocks, 32 * WARPS, 0, st>>>(
        static_cast<const bf16*>(src), static_cast<signed char*>(q),
        static_cast<float*>(scale), M, K);
  return cudaGetLastError();
}
