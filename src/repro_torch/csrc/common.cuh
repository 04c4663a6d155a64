// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel computes in fp32 and stores in the tensor's own dtype
// (float32 or bfloat16).  Conversions use the IEEE intrinsics
// (round-to-nearest-even, the same rounding as torch's .to(bfloat16));
// the build uses no --use_fast_math, so expf/tanhf/division stay IEEE.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from the Python wrappers
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// large negative score for masked positions, finite so that
// exp(m_old - m_new) never evaluates inf - inf
#define REPRO_NEG_INF (-1e30f)

// Allows `bytes` of dynamic shared memory for `kernel` (needed above
// 48 KB) and reports the error code of the attribute call.  `allowed` is
// the caller's record for this kernel (a static in its launcher): the
// attribute is raised only when a launch needs more than any launch before
// it, so steady-state launches (and launches captured in a CUDA graph)
// make no attribute call.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}
