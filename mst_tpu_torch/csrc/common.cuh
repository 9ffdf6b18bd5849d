// Shared helpers for the hand-written Hopper kernels of mst_tpu_torch.
//
// Every kernel in this directory takes bf16 activations and weights, keeps
// its sums in f32, and is launched through a plain C entry point (bound with
// ctypes by mst_tpu_torch/ops/_build.py) that returns cudaGetLastError().
// The W8A8 kernels (ln_gemm_i8.cu, quant_rows.cu, gemm_i8_residual.cu) take
// int8 codes with f32 scales instead and keep their product sums in int32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mst {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Activation codes shared with the Python wrappers (fused_block.py).
enum Act : int { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_ERF = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_GELU_TANH) {
    // jax.nn.gelu(approximate=True)
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    return v * (0.5f * (1.0f + tanhf(k0 * (v + 0.044715f * v * v * v))));
  }
  if (act == ACT_GELU_ERF) {
    // jax.nn.gelu(approximate=False)
    return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
  }
  return v;
}

// d apply_act(v, act) / dv, the closed form of the flavour the forward used
// (the JAX backward takes it by a JVP of the same function).
__device__ __forceinline__ float act_grad(float v, int act) {
  if (act == ACT_GELU_TANH) {
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;
    const float t = tanhf(k0 * (v + k1 * v * v * v));
    return 0.5f * (1.0f + t) + 0.5f * v * (1.0f - t * t) * k0 * (1.0f + 3.0f * k1 * v * v);
  }
  if (act == ACT_GELU_ERF) {
    // Phi(v) + v * phi(v)
    return 0.5f * (1.0f + erff(v * 0.7071067811865476f)) +
           v * 0.3989422804014327f * expf(-0.5f * v * v);
  }
  return 1.0f;
}

// 16-byte global -> shared copy that bypasses L1; src_bytes = 0 zero-fills
// the destination (ragged row edge) without reading global memory.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src,
                                           int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Pack 8 f32 values into 8 bf16 (one 16-byte store).
__device__ __forceinline__ uint4 pack8_bf16(const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return r;
}

__device__ __forceinline__ void unpack8_bf16(uint4 r, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// bf16 rounding of an f32 value, back in f32 (round to nearest even).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Interleaved-pair RoPE of 8 bf16 values of one row (columns c..c+7, c a
// multiple of 8), with that row's f32 cos / sin at the same columns:
//   t'[2j]   = t[2j]   * cos[2j]   - t[2j+1] * sin[2j]
//   t'[2j+1] = t[2j+1] * cos[2j+1] + t[2j]   * sin[2j+1]
// in f32, rounded to bf16: `_mhsa`'s q * cos + (q @ P) * sin of
// mst_tpu/ops/fused_block.py, where the pair-swap product (q @ P)[2j] =
// -q[2j+1], (q @ P)[2j+1] = q[2j] is exact. Each product and sum rounds on
// its own (no contraction to an FMA), as the plain version's separate ops.
__device__ __forceinline__ uint4 rope8(uint4 raw, const float* __restrict__ cs,
                                       const float* __restrict__ sn) {
  float t[8], r[8], c[8], s[8];
  unpack8_bf16(raw, t);
  *reinterpret_cast<float4*>(c) = *reinterpret_cast<const float4*>(cs);
  *reinterpret_cast<float4*>(c + 4) = *reinterpret_cast<const float4*>(cs + 4);
  *reinterpret_cast<float4*>(s) = *reinterpret_cast<const float4*>(sn);
  *reinterpret_cast<float4*>(s + 4) = *reinterpret_cast<const float4*>(sn + 4);
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    r[j] = __fsub_rn(__fmul_rn(t[j], c[j]), __fmul_rn(t[j + 1], s[j]));
    r[j + 1] = __fadd_rn(__fmul_rn(t[j + 1], c[j + 1]), __fmul_rn(t[j], s[j + 1]));
  }
  return pack8_bf16(r);
}

// The adjoint of `rope8` on 8 f32 gradients d of the rotated values, with
// the JAX backward's rounding point (`_attn_bwd_kernel`: dq = dq_r * cos -
// bf16(dq_r * sin) @ P):
//   out[2j]   = d[2j]   * cos[2j]   + bf16(d[2j+1] * sin[2j+1])
//   out[2j+1] = d[2j+1] * cos[2j+1] - bf16(d[2j]   * sin[2j])
__device__ __forceinline__ void rope_adjoint8(const float* d, const float* __restrict__ cs,
                                              const float* __restrict__ sn, float* out) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const float y0 = round_bf16(__fmul_rn(d[j], sn[j]));
    const float y1 = round_bf16(__fmul_rn(d[j + 1], sn[j + 1]));
    out[j] = __fadd_rn(__fmul_rn(d[j], cs[j]), y1);
    out[j + 1] = __fsub_rn(__fmul_rn(d[j + 1], cs[j + 1]), y0);
  }
}

// Register-level bf16 tensor-core product (mhsa.cu's one-pass P.V), PTX
// `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`: c[16 x 8] += a[16 x 16] .
// b[16 x 8]. Lane l of the warp, g = l / 4, t = l % 4, holds
//   a: a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1], a[2] = A[g][2t+8, 2t+9],
//      a[3] = A[g+8][2t+8, 2t+9] (two bf16 each, the lower column in the low
//      half);
//   b: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   c: c[0], c[1] = C[g][2t, 2t+1], c[2], c[3] = C[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one bf16 pair (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Set a kernel's dynamic shared-memory ceiling (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

namespace {

// out[l] = sum_p part[p * L + l] for l < L: the second pass of the backward
// kernels' split reductions. Each block owns 32 consecutive l (coalesced
// loads); its 8 warps stride over p and are summed in a fixed order, so the
// result repeats bit for bit from run to run (no atomics). A template so that
// a source that does not use it instantiates nothing.
template <int WARPS = 8>
__global__ void __launch_bounds__(32 * WARPS)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int P, int L) {
  __shared__ float red[WARPS][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int l = blockIdx.x * 32 + tx;
  float s = 0.0f;
  if (l < L)
    for (int p = ty; p < P; p += WARPS) s += part[size_t(p) * L + l];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && l < L) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) t += red[i][tx];
    out[l] = t;
  }
}

template <int WARPS = 8>
cudaError_t sum_partials(const float* part, float* out, int P, int L, cudaStream_t st) {
  sum_partials_kernel<WARPS><<<(L + 31) / 32, 32 * WARPS, 0, st>>>(part, out, P, L);
  return cudaGetLastError();
}

}  // namespace

}  // namespace mst
