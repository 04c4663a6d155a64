// Checkpoint codec: int8 block quantization and its inverse.
//
// Replaces the TPU kernels src/repro/kernels/ckpt_codec/kernel.py:
// quantize_blocks (_quant_kernel) and dequantize_blocks (_dequant_kernel).
//
// The leaf is viewed flat as blocks of 256 elements.  Per block:
//   scale = amax / 127,  q = clip(rint(x / max(scale, 1e-12)), -127, 127)
// and the inverse is q * scale.  IEEE division (no --use_fast_math) and
// rintf (round half to even) make the payload byte-identical to the host
// codec (core/codec.py Int8BlockCodec.encode, numpy's rint).
//
// Bound on the H100: memory.  Quantize reads the leaf once (4 or 2 bytes
// an element) and writes 1 byte an element plus 4 bytes a block; the
// arithmetic is a few operations per element.  Design: one warp per
// 256-element block, eight elements a lane read with 16-byte loads
// (bfloat16 and float32 leaves are read as they are and upcast in
// registers, so no float32 copy of a leaf exists), amax reduced by warp
// shuffles, 8 int8 a lane stored as one 8-byte store.  The ragged last
// block is zero-filled in registers.  Scales are written as (NB,); the
// TPU kernel's (NB, 128) lane broadcast was a layout artefact.
// Dequantize: one thread per 4 elements, a 4-byte load of int8 and a
// 16-byte store of float32.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kPerLane = kBlock / 32;       // 8 elements a lane
constexpr int kWarps = 8;                   // blocks per CUDA block

template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ x, long long i0,
                                      long long n, float* v);

template <>
__device__ __forceinline__ void load8<float>(const float* __restrict__ x,
                                             long long i0, long long n,
                                             float* v) {
  if (i0 + kPerLane <= n) {
    const float4 a = *reinterpret_cast<const float4*>(x + i0);
    const float4 b = *reinterpret_cast<const float4*>(x + i0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      v[j] = i0 + j < n ? x[i0 + j] : 0.f;
  }
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ x, long long i0, long long n,
    float* v) {
  if (i0 + kPerLane <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] = __bfloat162float(h[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      v[j] = i0 + j < n ? __bfloat162float(x[i0 + j]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, long long n, long long nb) {
  const int lane = threadIdx.x & 31;
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;
  const long long i0 = blk * kBlock + lane * kPerLane;
  float v[kPerLane];
  load8<T>(x, i0, n, v);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax / 127.0f;
  const float safe = fmaxf(scale, 1e-12f);
  union {
    int8_t b[kPerLane];
    uint2 u;
  } out;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float r = fminf(fmaxf(rintf(v[j] / safe), -127.f), 127.f);
    out.b[j] = static_cast<int8_t>(r);
  }
  *reinterpret_cast<uint2*>(q + i0) = out.u;
  if (lane == 0) scales[blk] = scale;
}

__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  float* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t * 4 < n; t += stride) {
    const long long i0 = t * 4;
    // 4 elements never straddle a 256-element block
    const float s = scales[i0 / kBlock];
    const char4 c = *reinterpret_cast<const char4*>(q + i0);
    const float4 o = make_float4(c.x * s, c.y * s, c.z * s, c.w * s);
    if (i0 + 4 <= n) {
      *reinterpret_cast<float4*>(y + i0) = o;
    } else {
      const float ov[4] = {o.x, o.y, o.z, o.w};
      for (int j = 0; i0 + j < n; ++j) y[i0 + j] = ov[j];
    }
  }
}

}  // namespace

// x: n contiguous elements (float32 or bfloat16, 16-byte aligned);
// q: (nb, 256) int8 with nb = ceil(n / 256); scales: (nb,) float32.
// Returns the cudaError_t of the launch.
extern "C" int repro_ckpt_quantize(const void* x, void* q, void* scales,
                                   long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  const long long nb = (n + kBlock - 1) / kBlock;
  const long long grid = (nb + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    quantize_kernel<float><<<static_cast<unsigned>(grid), kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, nb);
  } else if (dtype == DT_BF16) {
    quantize_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(grid), kWarps * 32, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
            static_cast<float*>(scales), n, nb);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// q: (nb, 256) int8 (4-byte aligned); scales: (nb,) float32;
// y: the first n <= nb * 256 decoded elements, float32 (16-byte aligned).
extern "C" int repro_ckpt_dequantize(const void* q, const void* scales,
                                     void* y, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  const long long quads = (n + 3) / 4;
  const int threads = 256;
  long long grid = (quads + threads - 1) / threads;
  if (grid > 65536 * 16) grid = 65536 * 16;    // grid-stride beyond this
  dequantize_kernel<<<static_cast<unsigned>(grid), threads, 0, s>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(y), n);
  return cudaGetLastError();
}
