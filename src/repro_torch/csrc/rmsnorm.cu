// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w, fp32 math, stored
// in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py:rms_norm_2d.
//
// Bound on the H100: memory.  Each row of D elements is read, reduced and
// written once (plus the weight, which stays in L1/L2); the arithmetic is
// a few operations per byte.  Design: one block per row, 16-byte vector
// loads (8 bf16 or 4 fp32 per thread per load, neighbouring threads on
// neighbouring addresses), an fp32 sum of squares reduced by warp
// shuffles and then across warps through shared memory, then a second
// pass over the row (L1/L2-resident at D = 4096) that scales and stores.
// The TPU kernel's `rows = ROWS if R % ROWS == 0 else 1` tiling is a VMEM
// artifact and does not carry over: every row is its own block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  const T* xr = x + static_cast<long long>(blockIdx.x) * D;
  T* yr = y + static_cast<long long>(blockIdx.x) * D;
  // the wrapper passes 16-byte aligned base pointers; rows stay aligned
  // when D is a multiple of the vector width
  const bool vec = (D % V) == 0;

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * V; i < D; i += kThreads * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* xv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(xv[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = block_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);

  if (vec) {
    for (int i = threadIdx.x * V; i < D; i += kThreads * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const uint4 wraw = *reinterpret_cast<const uint4*>(w + i);
      const T* xv = reinterpret_cast<const T*>(&raw);
      const T* wv = reinterpret_cast<const T*>(&wraw);
      uint4 out;
      T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        ov[j] = from_f32<T>((to_f32(xv[j]) * r) * to_f32(wv[j]));
      *reinterpret_cast<uint4*>(yr + i) = out;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads)
      yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
  }
}

}  // namespace

// x, y: (rows, D) contiguous; w: (D,), all of one dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                                 int rows, int D, float eps, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (dtype == DT_BF16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), D, eps);
  } else if (dtype == DT_F32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), D, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
