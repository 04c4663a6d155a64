// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel computes in fp32 and stores in the tensor's own dtype
// (float32 or bfloat16).  Conversions use the IEEE intrinsics
// (round-to-nearest-even, the same rounding as torch's .to(bfloat16));
// the build uses no --use_fast_math, so expf/tanhf/division stay IEEE.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <utility>

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

// ---- programmatic dependent launch (PDL) ------------------------------------
// A kernel launched with the attribute (launch_kernel(..., pdl = true))
// may start while the kernel before it on the stream is still running
// (once that kernel has triggered, or its blocks have exited).  It must
// call griddep_wait() before it reads anything the previous kernels wrote
// and before it writes anything they may still read; everything after the
// wait sees their writes.  Each kernel of the library that is launched so
// waits first, then triggers its own dependents: a dependent launched
// early sits in its wait until this grid has finished, so the launch
// latency of the next kernel overlaps this one.  Both instructions are
// no-ops in a kernel launched without the attribute.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Whether launch_kernel sets the attribute where it is asked for (on
// unless repro_set_pdl(0) was called: the measurement of a kernel with and
// without it).  One flag for the whole library: an inline function's
// static is shared across its translation units.
inline bool& pdl_flag() {
  static bool on = true;
  return on;
}

// kernel<<<grid, block, smem, s>>>(args...), with programmatic stream
// serialization allowed when `pdl` (and the flag) is set; returns the
// launch's error code.
template <typename Kernel, typename... Args>
static cudaError_t launch_kernel(bool pdl, Kernel kernel, dim3 grid,
                                 dim3 block, size_t smem, cudaStream_t s,
                                 Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl && pdl_flag() ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}
