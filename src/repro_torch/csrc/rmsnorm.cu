// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w, fp32 math, stored
// in x's dtype; and its backward (below), which the TPU kernel never had.
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
                   T* __restrict__ y, float* __restrict__ rstd, int D,
                   float eps) {
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
  // the training path keeps r for the backward; serving passes null
  if (rstd != nullptr && threadIdx.x == 0) rstd[blockIdx.x] = r;

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

// x, y: (rows, D) contiguous; w: (D,), all of one dtype; rstd: (rows,)
// float32 or null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                                 void* rstd, int rows, int D, float eps,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (dtype == DT_BF16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(rstd), D, eps);
  } else if (dtype == DT_F32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), static_cast<float*>(rstd), D, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.  With g = dL/dy and r = rsqrt(mean(x^2) + eps) per row:
//   dx = r * (g * w) - x * r^3 * mean(g * w * x)
//   dw = sum over rows of g * x * r
// dx: one block per row, as the forward, reading r from the forward's
// saved rstd (the serving path passes no rstd and runs no backward).  dw
// in two passes and no float atomics, so the result does not depend on the
// order blocks run in: per-block float32 partial sums over kRowsPerBlock
// rows, then one thread per column adds the partials in a fixed order.
// Bound: memory (x and g read once for dx and once more for dw, dx
// written once; the partials are 1/kRowsPerBlock of that).
// ---------------------------------------------------------------------------
namespace {

constexpr int kRowsPerBlock = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
                          const T* __restrict__ w,
                          const float* __restrict__ rstd,
                          T* __restrict__ dx, int D) {
  const long long base = static_cast<long long>(blockIdx.x) * D;
  const T* gr = g + base;
  const T* xr = x + base;
  T* dxr = dx + base;
  const float r = rstd[blockIdx.x];
  float dot = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads)
    dot += to_f32(gr[i]) * to_f32(w[i]) * to_f32(xr[i]);
  dot = block_sum(dot);
  const float c = r * r * r * (dot / static_cast<float>(D));
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float gw = to_f32(gr[i]) * to_f32(w[i]);
    dxr[i] = from_f32<T>(r * gw - to_f32(xr[i]) * c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_dw_partial_kernel(const T* __restrict__ g,
                                  const T* __restrict__ x,
                                  const float* __restrict__ rstd,
                                  float* __restrict__ partial, int rows,
                                  int D) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= D) return;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int r1 = min(rows, r0 + kRowsPerBlock);
  float acc = 0.f;
  for (int row = r0; row < r1; ++row) {
    const long long off = static_cast<long long>(row) * D + col;
    acc += to_f32(g[off]) * to_f32(x[off]) * rstd[row];
  }
  partial[static_cast<long long>(blockIdx.y) * D + col] = acc;
}

template <typename T>
__global__ void rmsnorm_bwd_dw_reduce_kernel(const float* __restrict__ partial,
                                             T* __restrict__ dw, int nparts,
                                             int D) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= D) return;
  float acc = 0.f;
  for (int p = 0; p < nparts; ++p)
    acc += partial[static_cast<long long>(p) * D + col];
  dw[col] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const void* w,
                       const void* rstd, void* dx, void* dw, void* partial,
                       int rows, int D, cudaStream_t s) {
  rmsnorm_bwd_dx_kernel<T><<<rows, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<const float*>(rstd),
      static_cast<T*>(dx), D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nparts = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  dim3 grid((D + kThreads - 1) / kThreads, nparts);
  rmsnorm_bwd_dw_partial_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const float*>(rstd), static_cast<float*>(partial), rows,
      D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dw_reduce_kernel<T><<<(D + kThreads - 1) / kThreads, kThreads,
                                    0, s>>>(
      static_cast<const float*>(partial), static_cast<T*>(dw), nparts, D);
  return cudaGetLastError();
}

}  // namespace

// Number of float32 partial rows the backward needs as scratch: the
// wrapper allocates (repro_rmsnorm_bwd_parts(rows), D).
extern "C" int repro_rmsnorm_bwd_parts(int rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

// g, x, dx: (rows, D); w, dw: (D,), all of one dtype; rstd: (rows,)
// float32 from the forward; partial: (repro_rmsnorm_bwd_parts(rows), D)
// float32 scratch.
extern "C" int repro_rmsnorm_bwd(const void* g, const void* x, const void* w,
                                 const void* rstd, void* dx, void* dw,
                                 void* partial, int rows, int D, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (dtype == DT_BF16)
    return launch_bwd<__nv_bfloat16>(g, x, w, rstd, dx, dw, partial, rows,
                                     D, s);
  if (dtype == DT_F32)
    return launch_bwd<float>(g, x, w, rstd, dx, dw, partial, rows, D, s);
  return cudaErrorInvalidValue;
}
