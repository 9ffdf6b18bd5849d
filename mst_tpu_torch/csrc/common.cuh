// Shared helpers for the hand-written Hopper kernels of mst_tpu_torch.
//
// Every kernel in this directory takes bf16 activations and weights, keeps
// its sums in f32, and is launched through a plain C entry point (bound with
// ctypes by mst_tpu_torch/ops/_build.py) that returns cudaGetLastError().
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

// Set a kernel's dynamic shared-memory ceiling (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mst
